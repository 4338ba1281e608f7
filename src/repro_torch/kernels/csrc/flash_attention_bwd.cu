// Flash-attention backward for Hopper (sm_90a), causal / sliding-window, GQA.
//
// Replaces `_flash_vjp_bwd` in src/repro/kernels/flash_attention.py
// (:140-163), which is not a Pallas kernel: on the TPU the gradient is
// recomputed in XLA through `ref._mha_fwd_blocks` and `ref._mha_bwd_blocks`.
// Same function as the plain version `repro_torch.kernels.ref.mha_bwd`: from
// q, k, v, the forward's o and lse and the output's gradient do,
//     P = exp(q k^T * scale - lse) (0 where masked),  dP = do v^T,
//     delta = rowsum(do * o),  dS = P * (dP - delta),
//     dv = P^T do,  dk = dS^T q * scale,  dq = dS k * scale,
// with dk and dv summed over the `rep` query heads of each kv head.  Sums are
// f32; each output is rounded once to the input type.
//
// What bounds it on an H100: at S=4096 (h2o-danube-3-4b training: H=32,
// KV=8, dh=120) the causal half of the five products is 322 GFLOP against
// ~158 MB read and written: ~2000 FLOP a byte, far above the ~295 FLOP/B
// ridge, so it is bound by operations (0.33 ms at the bf16 tensor-core
// peak), and the products belong on the tensor cores at their full rate:
// `wgmma`, fed by TMA.
//
// bf16 (every model path): `wg::dkdv_kernel` and `wg::dq_kernel`, every
// product a `wgmma` m64n64k16 or m64n32k16 bf16 -> f32 (hopper.cuh); a block is
// one or two consumer warpgroups and a producer warpgroup.
//  * Loads: one producer thread issues TMA loads (4-D tensor maps over [B, S,
//    heads, dh] with the caller's strides, built on the host through the
//    runtime's driver entry point, so the library needs no -lcuda) of 64-row
//    tiles in 64-column panels, 128-byte swizzled as `wgmma`'s descriptors
//    read them; columns past dh (dh 120 in a 128-wide tile) and rows past S
//    arrive as zeros.  The block's resident tiles (K and V in dk/dv; q and do
//    in dq) come once; the streamed ones go round a ring of two stages behind
//    `mbarrier`s: q and do with their rows' lse and delta (1-D maps over the
//    flat [B H Sq] arrays, 68 values from a 16-byte boundary, as TMA wants
//    a box to start), or K and V.  Every shape the wrapper takes goes through
//    TMA: rows start on 16-byte boundaries, so every stride is a multiple of
//    16 bytes (a broadcast stride of 0 too).  `setmaxnreg` hands the producer
//    warpgroup's registers to the consumers; the block's work is worked out
//    after it, as a value live across `setmaxnreg` must fit the producer's
//    24 registers (it spilled there).
//  * P and dS are split into bf16 hi + lo in all three products that take
//    them: dv = P^T_hi do + P^T_lo do, dk = dS^T_hi q + dS^T_lo q, dq = dS_hi
//    k + dS_lo k.  Emulated on the CPU (tests/test_torch_kernels.py), the
//    split holds dq, dk and dv to one bf16 ulp (`ref.grad_tolerance_ratio` <=
//    1), and P or dS rounded once to bf16 (FlashAttention-2's choice) in any
//    one of the three products misses it there; the tests assert both, and
//    that the order of sums below holds it too.  The accumulator of S^T (dP^T,
//    S, dP) becomes the register A operand of the next product, as bf16 hi and
//    lo: two `wgmma`s against one B operand read MN-major from shared memory.
//  * The tensor cores add products into their f32 accumulator by
//    truncation, not rounding.  dv of the first keys at S=4096 sums ~16K
//    rows in one accumulator: where that sum cancels it drifted to 2.4 of the
//    tolerance on an H100.  So the products of each step (64 q rows in dk/dv,
//    64 keys in dq) are summed from 0 in a fresh accumulator, one 64-column
//    panel at a time, and added into the f32 registers by a rounding add
//    (`product_into`).
//  * `wg::dkdv_kernel`: a block per (64-key tile, kv head, batch, head part),
//    key tile 0 (under a causal mask the one that sees the most rows) first,
//    one block an SM.  Its two consumer warpgroups split the products, not
//    the columns: warpgroup 0 forms S^T = K q^T, P^T (masked) and dv += P^T
//    do, warpgroup 1 dP^T = V do^T, dS^T = P^T (dP^T - delta) and dk += dS^T
//    q; P^T passes between them in f32 through two shared buffers behind
//    named barriers.  Each holds one 64 x dh_pad f32 accumulator (128
//    registers a thread at dh 256), and neither keeps a product's A
//    fragments live across another product: that is what spilled when one
//    warpgroup held dk, dv and P^T's hi and lo through dP^T.  12 dh_pad FLOP
//    a (query, key) pair, no product formed twice.
//  * GQA heads split across blocks: a group's rep query heads go in
//    `head_parts` parts, the least divisor of rep that gives the pass
//    TARGET_BLOCKS blocks (paligemma-3b's 8 heads on one kv head at S=4096:
//    4 parts, 256 blocks; danube's 512 tiles: 1).  With more than one part
//    each block writes f32 partials of dk and dv and `head_sum_kernel` sums
//    them in part order and rounds once: no atomics, the same gradients bit
//    for bit on every call.
//  * `wg::dq_kernel`: a block per (q tile, head, batch), the longest causal
//    tiles first; resident q and do, streamed K and V; S, dP, dS = P (dP -
//    delta), dq += dS k, each consumer warpgroup owning 64 rows and all of
//    dq's columns.  Up to dh 128 one warpgroup (64-row tiles, 64-key steps)
//    and two blocks an SM; at dh 256 two warpgroups (128-row tiles: their
//    resident q and do take 128 KiB, so 32-key steps), each with dq for all
//    256 columns in 128 registers a thread beside S and dP (16 each).  8
//    dh_pad FLOP a (query, key) pair, S and dP formed once.
//  * Each warpgroup waits for its own products before it goes on; what
//    overlaps the tensor cores' work is the other warpgroups' (the other
//    half of a dk/dv block, the second dq block).  A schedule that issued the
//    next step's scores before a step's products, measured on the card, was
//    slower.
//  * Tiles wholly above the causal diagonal or left of the window are never
//    loaded; only tiles that cross the diagonal, the window's edge, Sq or Sk
//    are masked element by element, by selects (with a branch an element the
//    dk/dv pass was measured slower).  dh runs in the narrowest of a 64, 128
//    or 256 wide tile (dh=120's tail is never written).  A row with no
//    visible key gets dq = 0 (the plain version gives it the uniform P of its
//    masked keys: such rows never occur on a causal path).
//  * A wait of the producer that lasts ~10 s traps, so a pipeline fault ends
//    the launch with an error rather than hanging the card.
//
// f32: `simt::dkdv_kernel` and `simt::dq_kernel`, f32 FMAs on the CUDA cores
// (67 TFLOP/s peak), tiles staged in shared memory as f32, P and dS through
// shared memory.  No model path runs attention in f32 on the card, and it
// meets the f32 tolerance (1e-4), so this path keeps the first version's
// design; at dh 256 its dk/dv kernel owns half of the columns, and both
// take one block an SM (213 and 204 KiB of tiles).
//
// Both: `delta_kernel` first (delta [B,H,Sq] f32, one warp per row).  q, k,
// v, o and do are read in their [B, S, heads, dh] layout through the strides
// given; ragged S and q_offset are masked here.
#include <climits>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// strides in elements, (batch, seq, head) of q, k, v, do, dk, dv, dq, o in that order
struct Strides {
    int64_t v[24];
};

// four consecutive elements as f32; rows start on 16-byte boundaries
__device__ __forceinline__ float4 ld4(const float* p) { return load4(p); }

__device__ __forceinline__ float4 ld4(const bf16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ bool visible(int key, int qpos, int Sk, int causal, int window) {
    return key < Sk && (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
}

// delta[(b * H + h) * Sq + i] = sum_d do[b,i,h,d] * o[b,i,h,d]; one warp per row
template <typename T>
__global__ void delta_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                             float* __restrict__ delta, int B, int Sq, int H, int dh,
                             int64_t osb, int64_t oss, int64_t osh,
                             int64_t dsb, int64_t dss, int64_t dsh) {
    const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (row >= (int64_t)B * H * Sq) return;
    const int i = row % Sq, h = (row / Sq) % H, b = row / ((int64_t)Sq * H);
    const T* orow = o + b * osb + i * oss + h * osh;
    const T* drow = dO + b * dsb + i * dss + h * dsh;
    float acc = 0.f;
    for (int d = lane * 4; d < dh; d += 128) acc = dot4(ld4(orow + d), ld4(drow + d), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) delta[row] = acc;
}

template <typename T>
cudaError_t launch_delta(const T* o, const T* dO, float* delta, int B, int Sq, int H, int dh,
                         const Strides& st, cudaStream_t stream) {
    const int64_t* s = st.v;
    const int64_t rows = (int64_t)B * H * Sq;
    delta_kernel<T><<<(unsigned)((rows * 32 + 255) / 256), 256, 0, stream>>>(
        o, dO, delta, B, Sq, H, dh, s[21], s[22], s[23], s[9], s[10], s[11]);
    return cudaGetLastError();
}

namespace simt {

constexpr int NT = 256;  // threads of the dk/dv and dq kernels: 16 x 16, thread (ty, tx)

__device__ __forceinline__ float comp(float4 a, int u) {
    return u == 0 ? a.x : u == 1 ? a.y : u == 2 ? a.z : a.w;
}

// rows [row0, row0 + ROWS) of a [rows, dh] matrix -> shared [ROWS][DHP + 4] f32;
// rows at or past `nrows` and columns at or past dh are zero-filled
template <int DHP, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int64_t row_stride,
                                          int row0, int nrows, int dh) {
    constexpr int D4 = DHP / 4, LD = DHP + 4;
    for (int i = threadIdx.x; i < ROWS * D4; i += NT) {
        const int r = i / D4, d = (i % D4) * 4;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row0 + r < nrows && d < dh) x = ld4(src + (int64_t)(row0 + r) * row_stride + d);
        *reinterpret_cast<float4*>(dst + r * LD + d) = x;
    }
}

// output column parts of the dk/dv kernel: at dh 256 its 64 + 64 f32 a
// thread of dk and dv for all 256 columns would leave no registers, so each
// block owns half of them (and computes S and dP over all of them)
template <int DHP>
__host__ __device__ constexpr int col_parts() { return DHP > 128 ? 2 : 1; }

namespace dkdv {

constexpr int BK = 64;  // keys per block
constexpr int BQ = 32;  // q rows per step of the loop
constexpr int LDT = BQ + 4;

template <int DHP>
constexpr int smem_floats() { return (2 * BK + 2 * BQ) * (DHP + 4) + 2 * BK * LDT + 2 * BQ; }

template <int DHP>
__global__ void __launch_bounds__(NT, 1)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            const float* __restrict__ dO, const float* __restrict__ lse,
            const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
            int Sq, int Sk, int H, int rep, int dh, const Strides st,
            float scale, int causal, int window, int q_offset) {
    constexpr int PARTS = col_parts<DHP>();
    constexpr int LD = DHP + 4, NJ = DHP / PARTS / 64;  // this block's float4 column groups
    extern __shared__ float4 smem4[];
    float* Ks = reinterpret_cast<float*>(smem4);  // [BK][LD]
    float* Vs = Ks + BK * LD;                       // [BK][LD]
    float* Qs = Vs + BK * LD;                       // [BQ][LD]
    float* dOs = Qs + BQ * LD;                      // [BQ][LD]
    float* Pt = dOs + BQ * LD;                      // [BK][LDT]: P transposed
    float* dSt = Pt + BK * LDT;                     // [BK][LDT]: dS transposed
    float* lse_s = dSt + BK * LDT;                  // [BQ]
    float* del_s = lse_s + BQ;                      // [BQ]

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    // key tile 0 first: under a causal mask it sees the most rows
    const int k0 = blockIdx.x / PARTS * BK, c0 = blockIdx.x % PARTS * (DHP / PARTS);
    const int g = blockIdx.y, b = blockIdx.z;
    const float* kb = k + b * st.v[3] + g * st.v[5];
    const float* vb = v + b * st.v[6] + g * st.v[8];
    load_rows<DHP, BK>(Ks, kb, st.v[4], k0, Sk, dh);
    load_rows<DHP, BK>(Vs, vb, st.v[7], k0, Sk, dh);

    // rows that can see a key of [k0, k0 + BK): qpos >= k0 (causal) and
    // qpos < k0 + BK - 1 + window (window), qpos = q_offset + row
    int i_lo = 0, i_hi = Sq;
    if (causal) i_lo = max(0, k0 - q_offset);
    if (window > 0) i_hi = min(Sq, k0 + BK - 1 + window - q_offset);
    const int qt_begin = i_lo / BQ, qt_end = i_hi > i_lo ? (i_hi + BQ - 1) / BQ : qt_begin;

    float acc_k[4][NJ][4], acc_v[4][NJ][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc_k[i][j][e] = acc_v[i][j][e] = 0.f;

    for (int r = 0; r < rep; ++r) {
        const int h = g * rep + r;
        const float* qb = q + b * st.v[0] + h * st.v[2];
        const float* db = dO + b * st.v[9] + h * st.v[11];
        const float* lse_h = lse + ((int64_t)b * H + h) * Sq;
        const float* del_h = delta + ((int64_t)b * H + h) * Sq;
        for (int qt = qt_begin; qt < qt_end; ++qt) {
            const int q0 = qt * BQ;
            __syncthreads();  // the previous step's tiles are no longer read
            load_rows<DHP, BQ>(Qs, qb, st.v[1], q0, Sq, dh);
            load_rows<DHP, BQ>(dOs, db, st.v[10], q0, Sq, dh);
            if (tid < BQ) {
                const bool in = q0 + tid < Sq;
                lse_s[tid] = in ? lse_h[q0 + tid] : 0.f;
                del_s[tid] = in ? del_h[q0 + tid] : 0.f;
            }
            __syncthreads();

            // S and dP of rows ty + 16 i against keys tx + 16 j
            float s[2][4], dp[2][4];
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
            for (int d = 0; d < DHP; d += 4) {
                float4 a[2], c[4];
#pragma unroll
                for (int i = 0; i < 2; ++i)
                    a[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LD + d]);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    c[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) s[i][j] = dot4(a[i], c[j], s[i][j]);
            }
#pragma unroll 4
            for (int d = 0; d < DHP; d += 4) {
                float4 a[2], c[4];
#pragma unroll
                for (int i = 0; i < 2; ++i)
                    a[i] = *reinterpret_cast<const float4*>(&dOs[(ty + 16 * i) * LD + d]);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    c[j] = *reinterpret_cast<const float4*>(&Vs[(tx + 16 * j) * LD + d]);
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) dp[i][j] = dot4(a[i], c[j], dp[i][j]);
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int rr = ty + 16 * i, row = q0 + rr;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int kk = tx + 16 * j;
                    const bool ok = row < Sq && visible(k0 + kk, q_offset + row, Sk, causal, window);
                    const float p = ok ? expf(s[i][j] * scale - lse_s[rr]) : 0.f;
                    Pt[kk * LDT + rr] = p;
                    dSt[kk * LDT + rr] = p * (dp[i][j] - del_s[rr]);
                }
            }
            __syncthreads();

            // dv[key][d] += sum_q P dO, dk[key][d] += sum_q dS Q: keys ty + 16 i, columns c0 + tx * 4 + 64 j
#pragma unroll 2
            for (int qq = 0; qq < BQ; qq += 4) {
                float4 pk[4], sk[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    pk[i] = *reinterpret_cast<const float4*>(&Pt[(ty + 16 * i) * LDT + qq]);
                    sk[i] = *reinterpret_cast<const float4*>(&dSt[(ty + 16 * i) * LDT + qq]);
                }
#pragma unroll
                for (int u = 0; u < 4; ++u) {
#pragma unroll
                    for (int j = 0; j < NJ; ++j) {
                        const float4 w = *reinterpret_cast<const float4*>(
                            &dOs[(qq + u) * LD + c0 + tx * 4 + 64 * j]);
                        const float4 x = *reinterpret_cast<const float4*>(
                            &Qs[(qq + u) * LD + c0 + tx * 4 + 64 * j]);
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            const float pu = comp(pk[i], u), su = comp(sk[i], u);
                            acc_v[i][j][0] = fmaf(pu, w.x, acc_v[i][j][0]);
                            acc_v[i][j][1] = fmaf(pu, w.y, acc_v[i][j][1]);
                            acc_v[i][j][2] = fmaf(pu, w.z, acc_v[i][j][2]);
                            acc_v[i][j][3] = fmaf(pu, w.w, acc_v[i][j][3]);
                            acc_k[i][j][0] = fmaf(su, x.x, acc_k[i][j][0]);
                            acc_k[i][j][1] = fmaf(su, x.y, acc_k[i][j][1]);
                            acc_k[i][j][2] = fmaf(su, x.z, acc_k[i][j][2]);
                            acc_k[i][j][3] = fmaf(su, x.w, acc_k[i][j][3]);
                        }
                    }
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty + 16 * i;
        if (key >= Sk) continue;
        float* krow = dk + b * st.v[12] + (int64_t)key * st.v[13] + g * st.v[14];
        float* vrow = dv + b * st.v[15] + (int64_t)key * st.v[16] + g * st.v[17];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int d = c0 + tx * 4 + 64 * j;
            if (d >= dh) continue;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                store1(krow + d + e, acc_k[i][j][e] * scale);
                store1(vrow + d + e, acc_v[i][j][e]);
            }
        }
    }
}

}  // namespace dkdv

namespace dq {

constexpr int BQ = 64;  // q rows per block
constexpr int BK = 32;  // keys per step of the loop
constexpr int LDP = BK + 4;

template <int DHP>
constexpr int smem_floats() { return (2 * BQ + 2 * BK) * (DHP + 4) + BQ * LDP; }

// 256 wide its tiles take 204 KiB of shared memory: one block an SM
template <int DHP>
__global__ void __launch_bounds__(NT, DHP > 128 ? 1 : 2)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ dO, const float* __restrict__ lse,
          const float* __restrict__ delta, float* __restrict__ dq,
          int Sq, int Sk, int H, int rep, int dh, const Strides st,
          float scale, int causal, int window, int q_offset) {
    constexpr int LD = DHP + 4, NJ = DHP / 64;
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][LD]
    float* dOs = Qs + BQ * LD;                      // [BQ][LD]
    float* Ks = dOs + BQ * LD;                      // [BK][LD]
    float* Vs = Ks + BK * LD;                       // [BK][LD]
    float* dS = Vs + BK * LD;                       // [BQ][LDP]

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
    const int h = blockIdx.y, b = blockIdx.z, g = h / rep;
    const int q0 = qt * BQ, qa0 = q_offset + q0;
    const float* kb = k + b * st.v[3] + g * st.v[5];
    const float* vb = v + b * st.v[6] + g * st.v[8];
    load_rows<DHP, BQ>(Qs, q + b * st.v[0] + h * st.v[2], st.v[1], q0, Sq, dh);
    load_rows<DHP, BQ>(dOs, dO + b * st.v[9] + h * st.v[11], st.v[10], q0, Sq, dh);
    float lse_r[4], del_r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        const int64_t at = ((int64_t)b * H + h) * Sq + row;
        lse_r[i] = row < Sq ? lse[at] : 0.f;
        del_r[i] = row < Sq ? delta[at] : 0.f;
    }

    // keys [k_lo, k_hi) are the only ones any row of this tile can see
    int k_lo = 0, k_hi = Sk;
    if (causal) k_hi = min(Sk, qa0 + BQ);
    if (window > 0) k_lo = max(0, qa0 - window + 1);
    const int kt_begin = k_lo / BK, kt_end = (k_hi + BK - 1) / BK;

    float acc[4][NJ][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();  // the previous tile's K/V/dS are no longer read
        load_rows<DHP, BK>(Ks, kb, st.v[4], k0, Sk, dh);
        load_rows<DHP, BK>(Vs, vb, st.v[7], k0, Sk, dh);
        __syncthreads();

        // S and dP of rows ty + 16 i against keys tx + 16 j
        float s[4][2], dp[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
        for (int d = 0; d < DHP; d += 4) {
            float4 a[4], c[2];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                a[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LD + d]);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                c[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) s[i][j] = dot4(a[i], c[j], s[i][j]);
        }
#pragma unroll 4
        for (int d = 0; d < DHP; d += 4) {
            float4 a[4], c[2];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                a[i] = *reinterpret_cast<const float4*>(&dOs[(ty + 16 * i) * LD + d]);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                c[j] = *reinterpret_cast<const float4*>(&Vs[(tx + 16 * j) * LD + d]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) dp[i][j] = dot4(a[i], c[j], dp[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int rr = ty + 16 * i, row = q0 + rr;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int kk = tx + 16 * j;
                const bool ok = row < Sq && visible(k0 + kk, q_offset + row, Sk, causal, window);
                const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
                dS[rr * LDP + kk] = p * (dp[i][j] - del_r[i]);
            }
        }
        __syncthreads();

        // dq[rows ty + 16 i][cols tx * 4 + 64 j ..] += dS K
#pragma unroll 2
        for (int kk = 0; kk < BK; kk += 4) {
            float4 p[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                p[i] = *reinterpret_cast<const float4*>(&dS[(ty + 16 * i) * LDP + kk]);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    const float4 w =
                        *reinterpret_cast<const float4*>(&Ks[(kk + u) * LD + tx * 4 + 64 * j]);
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const float pu = comp(p[i], u);
                        acc[i][j][0] = fmaf(pu, w.x, acc[i][j][0]);
                        acc[i][j][1] = fmaf(pu, w.y, acc[i][j][1]);
                        acc[i][j][2] = fmaf(pu, w.z, acc[i][j][2]);
                        acc[i][j][3] = fmaf(pu, w.w, acc[i][j][3]);
                    }
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= Sq) continue;
        float* qrow = dq + b * st.v[18] + (int64_t)row * st.v[19] + h * st.v[20];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int d = tx * 4 + 64 * j;
            if (d >= dh) continue;
#pragma unroll
            for (int e = 0; e < 4; ++e) store1(qrow + d + e, acc[i][j][e] * scale);
        }
    }
}

}  // namespace dq

template <int DHP>
cudaError_t launch(const float* q, const float* k, const float* v, const float* o, const float* dO,
                   const float* lse, float* delta, float* dq, float* dk, float* dv,
                   int B, int Sq, int Sk, int H, int KV, int dh, const Strides& st,
                   float scale, int causal, int window, int q_offset, cudaStream_t stream) {
    cudaError_t err = launch_delta(o, dO, delta, B, Sq, H, dh, st, stream);
    if (err != cudaSuccess) return err;

    const int smem_kv = dkdv::smem_floats<DHP>() * (int)sizeof(float);
    err = cudaFuncSetAttribute(dkdv::dkdv_kernel<DHP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
    if (err != cudaSuccess) return err;
    if (Sk > 0) {
        dim3 grid((Sk + dkdv::BK - 1) / dkdv::BK * col_parts<DHP>(), KV, B);
        dkdv::dkdv_kernel<DHP><<<grid, NT, smem_kv, stream>>>(
            q, k, v, dO, lse, delta, dk, dv, Sq, Sk, H, H / KV, dh, st, scale, causal,
            window, q_offset);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }

    const int smem_q = dq::smem_floats<DHP>() * (int)sizeof(float);
    err = cudaFuncSetAttribute(dq::dq_kernel<DHP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + dq::BQ - 1) / dq::BQ, H, B);
    dq::dq_kernel<DHP><<<grid, NT, smem_q, stream>>>(
        q, k, v, dO, lse, delta, dq, Sq, Sk, H, H / KV, dh, st, scale, causal, window,
        q_offset);
    return cudaGetLastError();
}

}  // namespace simt

namespace wg {

constexpr int ROWS = 64;   // rows of a warpgroup's resident tile: keys (dk/dv), q rows (dq); wgmma's M
constexpr int XROWS = 64;  // rows of a streamed tile: q rows (dk/dv), keys (dq up to dh 128)
constexpr int STAGES = 2;  // streamed tiles in flight
constexpr int PANEL = ROWS * 128;  // bytes of one 64-column panel of a 64-row tile
// The streamed q rows' lse and delta come by TMA from their flat [B H Sq]
// arrays, in boxes that start on a 16-byte boundary: XROWS + 4 values from
// the multiple of 4 at or below the tile's first, in a row of LROW.
constexpr int LBOX = XROWS + 4, LROW = 96;
// blocks the dk/dv pass aims at when it splits a group's query heads
// (`head_parts`): about two for each of the card's 132 SMs
constexpr int TARGET_BLOCKS = 256;

// The dq pass's consumer warpgroups, each owning 64 q rows and all of dq's
// columns: one up to dh 128, two at dh 256, where a block's resident q and
// do (128 rows) leave room for streamed tiles of 32 keys only (`dq_keys`).
template <int DHP>
__host__ __device__ constexpr int dq_groups() { return DHP > 128 ? 2 : 1; }
template <int DHP>
__host__ __device__ constexpr int dq_keys() { return DHP > 128 ? 32 : XROWS; }

// Threads, blocks an SM and registers a thread of the dk/dv pass (DQ false:
// two consumer warpgroups, one forming S^T, P^T and dv, the other dP^T, dS^T
// and dk) and of the dq pass: the consumer warpgroups, then a producer
// warpgroup whose registers `setmaxnreg` hands to them.  The launch's
// registers are the SM's 65536 shared by its blocks (ptxas gives each kernel
// exactly that count, 8 a thread at a time).  Two blocks an SM where a block
// has one consumer warpgroup (the dq pass up to dh 128), one elsewhere: the
// dk/dv pass at dh 64 ran faster at two, but its consumers spilled in the 104
// registers that left them.
template <int DHP, bool DQ>
struct Cfg {
    static constexpr int NWG = DQ ? dq_groups<DHP>() : 2;  // consumer warpgroups
    static constexpr int RROWS = DQ ? ROWS * NWG : ROWS;  // resident rows
    static constexpr int XR = DQ ? dq_keys<DHP>() : XROWS;  // streamed rows
    static constexpr int THREADS = 128 * (NWG + 1);
    static constexpr int MIN_BLOCKS = NWG == 1 ? 2 : 1;
    static constexpr int LAUNCH_REGS = (65536 / (MIN_BLOCKS * THREADS)) & ~7;
    static constexpr int PRODUCER_REGS = 24;
    static constexpr int SHARE = (LAUNCH_REGS * (NWG + 1) - PRODUCER_REGS) / NWG & ~7;
    static constexpr int CONSUMER_REGS = SHARE < 240 ? SHARE : 240;
};

// Shared memory, offsets from a 1024-aligned base: the resident tiles R0, R1
// (K, V in dk/dv; q, do in dq), STAGES pairs of streamed tiles X0, X1 (q, do;
// K, V), in dk/dv the streamed q rows' lse and delta and two buffers of P^T
// (f32, from the warpgroup that forms it to the one that forms dS^T), the
// mbarriers.
template <int DHP, bool DQ>
struct Smem {
    // bf16 tiles of DHP / 64 panels: resident, and streamed
    static constexpr int TILE_R = Cfg<DHP, DQ>::RROWS * DHP * 2;
    static constexpr int TILE = Cfg<DHP, DQ>::XR * DHP * 2;
    static constexpr int R0 = 0, R1 = TILE_R, X = 2 * TILE_R;
    static constexpr int L = X + 2 * STAGES * TILE;  // f32 [STAGES][LROW]
    static constexpr int D = L + (DQ ? 0 : STAGES * LROW * 4);
    static constexpr int P = D + (DQ ? 0 : STAGES * LROW * 4);  // f32 [2][ROWS * XROWS]
    static constexpr int BAR = P + (DQ ? 0 : 2 * ROWS * XROWS * 4);  // resident, full, empty
    static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;  // + the base's alignment
};
static_assert(Smem<256, false>::BYTES <= 232448 && Smem<256, true>::BYTES <= 232448,
              "one block fits an SM at dh 256");

struct Params {
    int B, Sq, Sk, H, KV, dh, parts;
    float scale;
    int causal, window, q_offset;
    bf16* out0;     // dk (dk/dv), dq (dq)
    bf16* out1;     // dv (dk/dv)
    float* part0;   // dk/dv with parts > 1: f32 partials [parts, B, Sk, KV, dh] of dk
    float* part1;   // and of dv
    int64_t os0[3], os1[3];  // (batch, seq, head) strides of out0, out1
};

// A block's work: its resident rows from r0 (64 a consumer warpgroup) of head
// rh, batch b; its streamed tiles, n_x tiles from x_begin for each of the
// heads of its part `part` from h_first (dk/dv), or for one head (dq); kv
// head g.
struct Work {
    int b, g, rh, part, r0, h_first, x_begin, n_x, n_steps;
};

template <int DHP, bool DQ>
__device__ __forceinline__ Work block_work(const Params& p, int idx) {
    constexpr int RR = Cfg<DHP, DQ>::RROWS, XR = Cfg<DHP, DQ>::XR;
    Work w;
    const int rep = p.H / p.KV;
    if (!DQ) {
        // kv heads, parts and batches fastest, key tiles in order: tile 0,
        // which under a causal mask sees the most rows, first
        w.g = w.rh = idx % p.KV;
        idx /= p.KV;
        w.part = idx % p.parts;
        idx /= p.parts;
        w.b = idx % p.B;
        w.r0 = idx / p.B * ROWS;
        const int n_heads = rep / p.parts;
        w.h_first = w.g * rep + w.part * n_heads;
        // rows that can see a key of [r0, r0 + 64): qpos >= r0 (causal) and
        // qpos < r0 + 63 + window (window), qpos = q_offset + row
        int i_lo = 0, i_hi = p.Sq;
        if (p.causal) i_lo = max(0, w.r0 - p.q_offset);
        if (p.window > 0) i_hi = min(p.Sq, w.r0 + ROWS - 1 + p.window - p.q_offset);
        w.x_begin = i_lo / XROWS;
        w.n_x = i_hi > i_lo ? (i_hi + XROWS - 1) / XROWS - w.x_begin : 0;
        w.n_steps = n_heads * w.n_x;
    } else {
        // heads and batches fastest, q tiles longest causal first
        w.rh = w.h_first = idx % p.H;
        idx /= p.H;
        w.b = idx % p.B;
        w.r0 = ((p.Sq + RR - 1) / RR - 1 - idx / p.B) * RR;
        w.g = w.rh / rep;
        w.part = 0;
        // keys [k_lo, k_hi) are the only ones any row of this tile can see
        const int qa0 = p.q_offset + w.r0;
        int k_lo = 0, k_hi = p.Sk;
        if (p.causal) k_hi = min(p.Sk, qa0 + RR);
        if (p.window > 0) k_lo = max(0, qa0 - p.window + 1);
        w.x_begin = k_lo / XR;
        w.n_x = max(0, (k_hi + XR - 1) / XR - w.x_begin);
        w.n_steps = w.n_x;
    }
    return w;
}

// The producer: one thread loads the resident tiles, then keeps the
// streamed tiles (with their rows' lse and delta in dk/dv) in flight.
template <int DHP, bool DQ>
__device__ __forceinline__ void produce(const CUtensorMap* map_r0, const CUtensorMap* map_r1,
                                        const CUtensorMap* map_x0, const CUtensorMap* map_x1,
                                        const CUtensorMap* map_lse,
                                        const CUtensorMap* map_delta, const Params& p,
                                        const Work& w, uint32_t base) {
    using S = Smem<DHP, DQ>;
    constexpr int PR = Cfg<DHP, DQ>::RROWS * 128, PX = Cfg<DHP, DQ>::XR * 128;  // panels
    const uint32_t bar_res = base + S::BAR, bar_full = bar_res + 8;
    const uint32_t bar_empty = bar_full + 8 * STAGES;
    mbar_arrive_expect_tx(bar_res, 2 * S::TILE_R);
#pragma unroll
    for (int pn = 0; pn < DHP / 64; ++pn) {
        tma_load_4d(base + S::R0 + pn * PR, map_r0, bar_res, 64 * pn, w.r0, w.rh, w.b);
        tma_load_4d(base + S::R1 + pn * PR, map_r1, bar_res, 64 * pn, w.r0, w.rh, w.b);
    }
    for (int it = 0; it < w.n_steps; ++it) {
        const int s = it % STAGES;
        mbar_wait_or_trap(bar_empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        const int xh = DQ ? w.g : w.h_first + it / w.n_x;  // head of the streamed tile
        const int x0 = (w.x_begin + it % w.n_x) * Cfg<DHP, DQ>::XR;
        const uint32_t full = bar_full + 8 * s, xs = base + S::X + 2 * s * S::TILE;
        mbar_arrive_expect_tx(full, 2 * S::TILE + (DQ ? 0 : 2 * LBOX * 4));
#pragma unroll
        for (int pn = 0; pn < DHP / 64; ++pn) {
            tma_load_4d(xs + pn * PX, map_x0, full, 64 * pn, x0, xh, w.b);
            tma_load_4d(xs + S::TILE + pn * PX, map_x1, full, 64 * pn, x0, xh, w.b);
        }
        if (!DQ) {
            // the rows' lse and delta; past Sq they belong to the next head
            // (or read as zeros past the end), for rows that are masked
            const int at = ((w.b * p.H + xh) * p.Sq + x0) & ~3;
            tma_load_1d(base + S::L + s * LROW * 4, map_lse, full, at);
            tma_load_1d(base + S::D + s * LROW * 4, map_delta, full, at);
        }
    }
    // the last stages released: a consumer that never got its tiles traps here
    for (int it = max(0, w.n_steps - STAGES); it < w.n_steps; ++it)
        mbar_wait_or_trap(bar_empty + 8 * (it % STAGES), (it / STAGES) & 1);
}

// c = A B^T over the DHP columns of two tiles, both K-major: A 64 rows of the
// resident tile at `a` (its panels PA bytes apart), B the N rows of a
// streamed one at `b` (panels PB apart); issued and committed
template <int DHP, int N, int PA = PANEL, int PB = PANEL>
__device__ __forceinline__ void scores(float (&c)[N / 8][4], uint32_t a, uint32_t b) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DHP / 16; ++ks) {
        // each k-step's descriptors made as it is issued, not all up front
        const uint64_t da = sw128_desc(opaque(a) + (ks / 4) * PA + (ks % 4) * 32);
        const uint64_t db = sw128_desc(opaque(b) + (ks / 4) * PB + (ks % 4) * 32);
        if constexpr (N == 64)
            wgmma_m64n64_ss(c, da, db, ks > 0);
        else
            wgmma_m64n32_ss(c, da, db, ks > 0);
    }
    wgmma_commit();
}

// acc[c] += (hi + lo) B over the 16 KS rows of a streamed tile, B its
// 64-column panel c from `b` (MN-major; panels PB bytes apart).  The tensor
// cores add into their f32 accumulator by truncation, so the 2 KS products of
// each panel are summed from 0 in a fresh accumulator and added into `acc` by
// a rounding f32 add: a sum over thousands of rows in one accumulator drifts
// by several bf16 ulps where it cancels.
template <int NC, int KS = 4, int PB = PANEL>
__device__ __forceinline__ void product_into(float (&acc)[NC][8][4], uint32_t (&hi)[KS][4],
                                             uint32_t (&lo)[KS][4], uint32_t b) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
        float part[8][4];
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < KS; ++t) {
            const uint64_t d = sw128_desc(opaque(b) + c * PB + t * 16 * 128);
            wgmma_m64n64_rs_t(part, hi[t], d, t > 0);
            wgmma_m64n64_rs_t(part, lo[t], d, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_hold(part);
        wgmma_hold(hi);
        wgmma_hold(lo);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[c][j][e] += part[j][e];
        wgmma_hold(acc[c]);  // the sum done here, before the next panel's products
    }
}

// Named barriers of the dk/dv pass's two consumer warpgroups: buffer i of P^T
// written (P_FULL + i) and read (P_EMPTY + i); 0 is __syncthreads'.
constexpr int P_FULL = 1, P_EMPTY = 3;

// Barriers set up by thread 0, then the producer warpgroup's registers go to
// the consumers and its first thread produces.  Returns true for a consumer,
// which then works out the block's work itself, false for the producer
// warpgroup (whose threads are done); `base` is the 1024-aligned shared base.
template <int DHP, bool DQ>
__device__ __forceinline__ bool start_block(
        const CUtensorMap* map_r0, const CUtensorMap* map_r1, const CUtensorMap* map_x0,
        const CUtensorMap* map_x1, const CUtensorMap* map_lse, const CUtensorMap* map_delta,
        const Params& p, uint32_t base) {
    using C = Cfg<DHP, DQ>;
    using S = Smem<DHP, DQ>;
    if (threadIdx.x == 0) {
        mbar_init(base + S::BAR, 1);
#pragma unroll
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(base + S::BAR + 8 + 8 * s, 1);
            mbar_init(base + S::BAR + 8 * (1 + STAGES + s), 128 * C::NWG);
        }
        fence_barrier_init();
    }
    __syncthreads();
    if (threadIdx.x >= 128 * C::NWG) {
        setmaxnreg_dec<C::PRODUCER_REGS>();
        if (threadIdx.x == 128 * C::NWG) {
            // the block's work worked out after the split, so that nothing
            // but the barriers is live across `setmaxnreg`
            const Work w = block_work<DHP, DQ>(p, blockIdx.x);
            if (w.n_steps > 0)
                produce<DHP, DQ>(map_r0, map_r1, map_x0, map_x1, map_lse, map_delta, p, w, base);
        }
        return false;
    }
    setmaxnreg_inc<C::CONSUMER_REGS>();
    return true;
}

// One consumer warpgroup of the dk/dv pass: DV true forms S^T, P^T and dv;
// false dP^T, dS^T and dk.  P^T passes from the first to the second through
// two buffers in shared memory.
template <int DHP, bool DV>
__device__ __forceinline__ void dkdv_group(const Params& p, const Work& w, uint32_t base) {
    using S = Smem<DHP, false>;
    constexpr int NC = DHP / 64;  // 64-column panels of dk and dv
    const int wl = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, tw = threadIdx.x & 127;
    // this thread's keys: kr and kr + 8 of the tile; q rows kq, kq + 1 of each
    // 8-row n-tile
    const int kr = wl * 16 + (lane >> 2), kq = 2 * (lane & 3);
    float acc[NC][8][4];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.f;
    const uint32_t bar_full = base + S::BAR + 8, bar_empty = bar_full + 8 * STAGES;
    if (w.n_steps > 0) mbar_wait(base + S::BAR, 0);
    for (int it = 0; it < w.n_steps; ++it) {
        const int s = it % STAGES, pb = it & 1;
        mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
        const uint32_t q_st = base + S::X + 2 * s * S::TILE, do_st = q_st + S::TILE;
        const int xr0 = (w.x_begin + it % w.n_x) * XROWS;  // the q tile's first row
        // the rows' lse and delta in their stage, `lo4` values in
        const int lo4 = ((w.b * p.H + w.h_first + it / w.n_x) * p.Sq + xr0) & 3;
        // this thread's 8 float4 of buffer pb of P^T, 128 threads apart
        const uint32_t pt = base + S::P + (pb * (ROWS * XROWS / 4) + tw) * 16;
        // S^T = K q^T (DV) or dP^T = V do^T
        float sc[8][4];
        scores<DHP, 64>(sc, base + (DV ? S::R0 : S::R1), DV ? q_st : do_st);
        wgmma_wait<0>();
        wgmma_hold(sc);
        if (DV) {
            // P^T = exp(S^T scale - lse); only tiles across the diagonal, the
            // window's edge, Sq or Sk are masked element by element
            const uint32_t Lt = base + S::L + (s * LROW + lo4) * 4;
            const int qa0 = p.q_offset + xr0;
            const bool edge = xr0 + XROWS > p.Sq || w.r0 + ROWS > p.Sk ||
                              (p.causal && w.r0 + ROWS - 1 > qa0) ||
                              (p.window > 0 && w.r0 <= qa0 + XROWS - 1 - p.window);
            auto exp_tile = [&](auto masked) {
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const int qr = 8 * j + kq;  // tile row of elements 0, 2; qr + 1 of 1, 3
                    const float l0 = lds_f32(Lt + 4 * qr), l1 = lds_f32(Lt + 4 * qr + 4);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float pv = __expf(fmaf(sc[j][e], p.scale, -((e & 1) ? l1 : l0)));
                        const int qpos = qa0 + qr + (e & 1);
                        sc[j][e] = !decltype(masked)::value ||
                                           ((qr + (e & 1) + xr0 < p.Sq) &
                                            visible_sel(w.r0 + kr + 4 * (e & 2), qpos, p.Sk,
                                                        p.causal, p.window))
                                       ? pv
                                       : 0.f;
                    }
                }
            };
            if (edge)
                exp_tile(std::true_type{});
            else
                exp_tile(std::false_type{});
            // P^T to the other warpgroup, once it has read this buffer's last one
            if (it >= 2) named_sync(P_EMPTY + pb, 256);
#pragma unroll
            for (int j = 0; j < 8; ++j)
                sts_f32x4(pt + j * 128 * 16, sc[j][0], sc[j][1], sc[j][2], sc[j][3]);
            named_arrive(P_FULL + pb, 256);
        } else {
            // dS^T = P^T (dP^T - delta)
            const uint32_t Dt = base + S::D + (s * LROW + lo4) * 4;
            named_sync(P_FULL + pb, 256);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const float4 pv = lds_f32x4(pt + j * 128 * 16);
                const float d0 = lds_f32(Dt + 4 * (8 * j + kq));
                const float d1 = lds_f32(Dt + 4 * (8 * j + kq) + 4);
                sc[j][0] = pv.x * (sc[j][0] - d0);
                sc[j][1] = pv.y * (sc[j][1] - d1);
                sc[j][2] = pv.z * (sc[j][2] - d0);
                sc[j][3] = pv.w * (sc[j][3] - d1);
            }
            if (it + 2 < w.n_steps) named_arrive(P_EMPTY + pb, 256);
        }
        // dv += P^T_hi do + P^T_lo do, or dk += dS^T_hi q + dS^T_lo q, one
        // 64-column panel at a time: the other warpgroup's products and
        // transforms are what overlap this one's
        uint32_t hi[4][4], lo[4][4];
#pragma unroll
        for (int t = 0; t < 4; ++t) acc_to_a_split(sc, t, hi[t], lo[t]);
        product_into<NC>(acc, hi, lo, DV ? do_st : q_st);
        mbar_arrive(bar_empty + 8 * s);
    }

    // dv or dk: bf16, or f32 partials that `head_sum_kernel` sums where the
    // group's heads are split in parts
    const float mul = DV ? 1.f : p.scale;
    const int64_t os_key = DV ? p.os1[1] : p.os0[1];
    bf16* out = DV ? p.out1 + w.b * p.os1[0] + w.g * p.os1[2] : p.out0 + w.b * p.os0[0] + w.g * p.os0[2];
    float* pout = (DV ? p.part1 : p.part0) +
                  (((int64_t)w.part * p.B + w.b) * p.Sk * p.KV + w.g) * p.dh;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int key = w.r0 + kr + 8 * hr;
        if (key >= p.Sk) continue;
        if (p.parts == 1) {
            bf16* orow = out + (int64_t)key * os_key;
#pragma unroll
            for (int c = 0; c < NC; ++c)
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const int d = 64 * c + 8 * j + kq;
                    if (d < p.dh)
                        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
                            acc[c][j][2 * hr] * mul, acc[c][j][2 * hr + 1] * mul);
                }
        } else {
            float* prow = pout + (int64_t)key * p.KV * p.dh;
#pragma unroll
            for (int c = 0; c < NC; ++c)
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const int d = 64 * c + 8 * j + kq;
                    if (d < p.dh)
                        *reinterpret_cast<float2*>(prow + d) =
                            make_float2(acc[c][j][2 * hr], acc[c][j][2 * hr + 1]);
                }
        }
    }
}

// dk/dv (see the note at the top): the block owns 64 keys of one kv head
// (resident K, V) and walks the q tiles of its part of the group's query
// heads (streamed q, do, lse, delta).  Warpgroup 0 forms S^T, P^T and dv,
// warpgroup 1 dP^T, dS^T and dk.
template <int DHP>
__global__ void __launch_bounds__(Cfg<DHP, false>::THREADS, Cfg<DHP, false>::MIN_BLOCKS)
dkdv_kernel(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
            const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
            const __grid_constant__ CUtensorMap map_lse,
            const __grid_constant__ CUtensorMap map_delta, const Params p) {
    extern __shared__ uint8_t smem_wg[];
    const uint32_t base = (smem_addr(smem_wg) + 1023) & ~1023u;
    if (!start_block<DHP, false>(&map_k, &map_v, &map_q, &map_do, &map_lse, &map_delta, p, base))
        return;
    const Work w = block_work<DHP, false>(p, blockIdx.x);
    if (threadIdx.x < 128)
        dkdv_group<DHP, true>(p, w, base);
    else
        dkdv_group<DHP, false>(p, w, base);
}

// dq (see the note at the top): the block owns 64 q rows of one head for each
// consumer warpgroup (resident q and do, with the rows' lse and delta in
// registers) and walks key tiles (streamed K and V); warpgroup wg owns rows
// [r0 + 64 wg, r0 + 64 wg + 64) and all of dq's columns.
template <int DHP>
__global__ void __launch_bounds__(Cfg<DHP, true>::THREADS, Cfg<DHP, true>::MIN_BLOCKS)
dq_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
          const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
          const float* __restrict__ lse, const float* __restrict__ delta, const Params p) {
    using C = Cfg<DHP, true>;
    using S = Smem<DHP, true>;
    constexpr int NC = DHP / 64;        // 64-column panels of dq
    constexpr int XR = C::XR;           // keys a step
    constexpr int NJ = XR / 8, KS = XR / 16;
    constexpr int PR = C::RROWS * 128, PX = XR * 128;  // panels of the two tiles
    extern __shared__ uint8_t smem_wg[];
    const uint32_t base = (smem_addr(smem_wg) + 1023) & ~1023u;
    if (!start_block<DHP, true>(&map_q, &map_do, &map_k, &map_v, nullptr, nullptr, p, base))
        return;
    const Work w = block_work<DHP, true>(p, blockIdx.x);
    const int wl = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int r0 = w.r0 + ROWS * (threadIdx.x >> 7);  // this warpgroup's first row
    // this warpgroup's rows of the resident tiles
    const uint32_t q_rows = base + S::R0 + (threadIdx.x >> 7) * ROWS * 128;
    // this thread's rows: kr and kr + 8 of the warpgroup's; keys kq, kq + 1
    // of each 8-key n-tile
    const int kr = wl * 16 + (lane >> 2), kq = 2 * (lane & 3);
    float acc[NC][8][4];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.f;
    float lse_r[2], del_r[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int row = r0 + kr + 8 * hr;
        const int64_t at = ((int64_t)w.b * p.H + w.rh) * p.Sq + row;
        lse_r[hr] = row < p.Sq ? lse[at] : 0.f;
        del_r[hr] = row < p.Sq ? delta[at] : 0.f;
    }

    const uint32_t bar_full = base + S::BAR + 8, bar_empty = bar_full + 8 * STAGES;
    const int qa0 = p.q_offset + r0;
    if (w.n_steps > 0) mbar_wait(base + S::BAR, 0);
    for (int it = 0; it < w.n_steps; ++it) {
        const int s = it % STAGES;
        mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
        const uint32_t k_st = base + S::X + 2 * s * S::TILE, v_st = k_st + S::TILE;
        const int k0 = (w.x_begin + it) * XR;  // the key tile's first key
        // S = q K^T and dP = do V^T; dS = P (dP - delta), P = exp(S scale -
        // lse), 0 where masked; split hi + lo
        const bool edge = k0 + XR > p.Sk || (p.causal && k0 + XR - 1 > qa0) ||
                          (p.window > 0 && k0 <= qa0 + ROWS - 1 - p.window);
        float sc[NJ][4], dp[NJ][4];
        scores<DHP, XR, PR, PX>(sc, q_rows, k_st);
        scores<DHP, XR, PR, PX>(dp, q_rows + S::TILE_R, v_st);
        wgmma_wait<0>();
        wgmma_hold(sc);
        wgmma_hold(dp);
        // only tiles across the diagonal, the window's edge or Sk are masked
        // element by element
        auto ds_tile = [&](auto masked) {
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int hr = e >> 1;
                    const float pv = __expf(fmaf(sc[j][e], p.scale, -lse_r[hr]));
                    const bool ok = !decltype(masked)::value ||
                                    visible_sel(k0 + 8 * j + kq + (e & 1), qa0 + kr + 8 * hr,
                                                p.Sk, p.causal, p.window);
                    dp[j][e] = (ok ? pv : 0.f) * (dp[j][e] - del_r[hr]);
                }
        };
        if (edge)
            ds_tile(std::true_type{});
        else
            ds_tile(std::false_type{});
        uint32_t hi[KS][4], lo[KS][4];
#pragma unroll
        for (int t = 0; t < KS; ++t) acc_to_a_split(dp, t, hi[t], lo[t]);
        // dq += dS_hi K + dS_lo K
        product_into<NC, KS, PX>(acc, hi, lo, k_st);
        mbar_arrive(bar_empty + 8 * s);
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int row = r0 + kr + 8 * hr;
        if (row >= p.Sq) continue;
        bf16* orow = p.out0 + w.b * p.os0[0] + (int64_t)row * p.os0[1] + w.rh * p.os0[2];
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int d = 64 * c + 8 * j + kq;
                if (d < p.dh)
                    *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
                        acc[c][j][2 * hr] * p.scale, acc[c][j][2 * hr + 1] * p.scale);
            }
    }
}

// dk, dv = the sums over parts, in order, of the dk/dv pass's f32 partials
// [parts, B, Sk, KV, dh], each rounded once (dk times scale); four
// consecutive elements a thread
__global__ void head_sum_kernel(const float* __restrict__ pk, const float* __restrict__ pv,
                                bf16* __restrict__ dk, bf16* __restrict__ dv, int parts, int B,
                                int Sk, int KV, int dh, Strides st, float scale) {
    const int64_t n = (int64_t)B * Sk * KV * dh;
    const int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
    if (e >= n) return;
    const int d = e % dh;
    const int64_t row = e / dh;
    const int g = row % KV, key = (row / KV) % Sk, b = row / ((int64_t)KV * Sk);
    float4 sk = load4(pk + e), sv = load4(pv + e);
    for (int i = 1; i < parts; ++i) {
        const float4 xk = load4(pk + i * n + e), xv = load4(pv + i * n + e);
        sk = make_float4(sk.x + xk.x, sk.y + xk.y, sk.z + xk.z, sk.w + xk.w);
        sv = make_float4(sv.x + xv.x, sv.y + xv.y, sv.z + xv.z, sv.w + xv.w);
    }
    bf16* ko = dk + b * st.v[12] + (int64_t)key * st.v[13] + g * st.v[14] + d;
    bf16* vo = dv + b * st.v[15] + (int64_t)key * st.v[16] + g * st.v[17] + d;
    *reinterpret_cast<__nv_bfloat162*>(ko) = __floats2bfloat162_rn(sk.x * scale, sk.y * scale);
    *reinterpret_cast<__nv_bfloat162*>(ko + 2) = __floats2bfloat162_rn(sk.z * scale, sk.w * scale);
    *reinterpret_cast<__nv_bfloat162*>(vo) = __floats2bfloat162_rn(sv.x, sv.y);
    *reinterpret_cast<__nv_bfloat162*>(vo + 2) = __floats2bfloat162_rn(sv.z, sv.w);
}

// Parts into which the dk/dv pass splits each group's rep query heads, one
// block each: the least divisor of rep that gives the pass TARGET_BLOCKS
// blocks (or rep).
int head_parts(int B, int Sk, int KV, int rep) {
    if (B <= 0 || Sk <= 0 || KV <= 0 || rep <= 0) return 1;
    const long long tiles = (long long)((Sk + ROWS - 1) / ROWS) * KV * B;
    for (int parts = 1; parts < rep; ++parts)
        if (rep % parts == 0 && tiles * parts >= TARGET_BLOCKS) return parts;
    return rep;
}

template <int DHP>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dO,
                   const float* lse, float* delta, bf16* dq, bf16* dk, bf16* dv, float* scratch,
                   int parts, int B, int Sq, int Sk, int H, int KV, int dh, const Strides& st,
                   float scale, int causal, int window, int q_offset, cudaStream_t stream) {
    cudaError_t err = launch_delta(o, dO, delta, B, Sq, H, dh, st, stream);
    if (err != cudaSuccess) return err;
    const int64_t* s = st.v;
    CUtensorMap mq{}, mdo{}, mk{}, mv{}, ml{}, md{};
    if (!make_map_bf16(&mq, q, B, Sq, H, dh, s[0], s[1], s[2], XROWS) ||
        !make_map_bf16(&mdo, dO, B, Sq, H, dh, s[9], s[10], s[11], XROWS) ||
        !make_map_f32_flat(&ml, lse, (int64_t)B * H * Sq, LBOX) ||
        !make_map_f32_flat(&md, delta, (int64_t)B * H * Sq, LBOX))
        return cudaErrorInvalidValue;
    if (Sk > 0 && (!make_map_bf16(&mk, k, B, Sk, KV, dh, s[3], s[4], s[5], XROWS) ||
                   !make_map_bf16(&mv, v, B, Sk, KV, dh, s[6], s[7], s[8], XROWS)))
        return cudaErrorInvalidValue;
    Params p{B, Sq, Sk, H, KV, dh, parts, scale, causal, window, q_offset,
             dk, dv, scratch,
             parts > 1 ? scratch + (int64_t)parts * B * Sk * KV * dh : nullptr,
             {s[12], s[13], s[14]}, {s[15], s[16], s[17]}};
    if (Sk > 0) {
        using C = Cfg<DHP, false>;
        const int smem = Smem<DHP, false>::BYTES;
        err = cudaFuncSetAttribute(dkdv_kernel<DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem);
        if (err != cudaSuccess) return err;
        const unsigned blocks = (unsigned)((Sk + ROWS - 1) / ROWS) * KV * B * parts;
        dkdv_kernel<DHP><<<blocks, C::THREADS, smem, stream>>>(mk, mv, mq, mdo, ml, md, p);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
        if (parts > 1) {
            const int64_t quads = (int64_t)B * Sk * KV * dh / 4;
            head_sum_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, stream>>>(
                p.part0, p.part1, dk, dv, parts, B, Sk, KV, dh, st, scale);
            err = cudaGetLastError();
            if (err != cudaSuccess) return err;
        }
    }
    p.out0 = dq;
    p.out1 = nullptr;
    p.parts = 1;
    for (int i = 0; i < 3; ++i) p.os0[i] = s[18 + i];
    using C = Cfg<DHP, true>;
    // the dq pass's boxes: its resident q and do, its key tiles
    if (!make_map_bf16(&mq, q, B, Sq, H, dh, s[0], s[1], s[2], C::RROWS) ||
        !make_map_bf16(&mdo, dO, B, Sq, H, dh, s[9], s[10], s[11], C::RROWS))
        return cudaErrorInvalidValue;
    if (Sk > 0 && (!make_map_bf16(&mk, k, B, Sk, KV, dh, s[3], s[4], s[5], C::XR) ||
                   !make_map_bf16(&mv, v, B, Sk, KV, dh, s[6], s[7], s[8], C::XR)))
        return cudaErrorInvalidValue;
    const int smem = Smem<DHP, true>::BYTES;
    err = cudaFuncSetAttribute(dq_kernel<DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const unsigned blocks = (unsigned)((Sq + C::RROWS - 1) / C::RROWS) * H * B;
    dq_kernel<DHP><<<blocks, C::THREADS, smem, stream>>>(mq, mdo, mk, mv, lse, delta, p);
    return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// Dynamic shared memory of one block of the bf16 dk/dv kernel (which = 0) or
// the bf16 dq kernel (which = 1) at head dim dh, in bytes (0 where no kernel
// takes dh): the kernels of every model path (the f32 kernels' is
// `simt::*::smem_floats` * 4).
extern "C" int repro_flash_attention_bwd_smem_bytes(int which, int dh) {
    const bool dq = which == 1;
    switch (head_dim_tile(dh)) {
        case 64: return dq ? wg::Smem<64, true>::BYTES : wg::Smem<64, false>::BYTES;
        case 128: return dq ? wg::Smem<128, true>::BYTES : wg::Smem<128, false>::BYTES;
        case 256: return dq ? wg::Smem<256, true>::BYTES : wg::Smem<256, false>::BYTES;
        default: return 0;
    }
}

// Tiles of the bf16 kernels: keys per block of the dk/dv kernel (which = 0),
// q rows per consumer warpgroup of the dq kernel (which = 1), q rows per step
// of the dk/dv kernel's loop (which = 2), streamed tiles in flight in either
// (which = 3).  The dq kernel's block rows and key steps depend on dh:
// `repro_flash_attention_bwd_dq_tile`.
extern "C" int repro_flash_attention_bwd_tile(int which) {
    switch (which) {
        case 0: case 1: return wg::ROWS;
        case 2: return wg::XROWS;
        case 3: return wg::STAGES;
        default: return 0;
    }
}

// Blocks or warpgroups that share one tile of the bf16 kernels at head dim
// dh, each owning a part of the output columns and forming S and dP over all
// of them: 1 at every dh (0 where no kernel takes dh).  No kernel splits the
// columns: the dk/dv kernel's two warpgroups split the products, the dq
// kernel's own 64 rows each (`repro_flash_attention_bwd_dq_tile`).
extern "C" int repro_flash_attention_bwd_col_parts(int dh) { return head_dim_tile(dh) ? 1 : 0; }

// Tiles of the bf16 dq kernel at head dim dh: q rows a block (which = 0; 64
// for each of its consumer warpgroups) and keys a step of its loop (which =
// 1); 0 where no kernel takes dh.
extern "C" int repro_flash_attention_bwd_dq_tile(int dh, int which) {
    switch (head_dim_tile(dh)) {
        case 64: return which == 0 ? wg::Cfg<64, true>::RROWS : wg::Cfg<64, true>::XR;
        case 128: return which == 0 ? wg::Cfg<128, true>::RROWS : wg::Cfg<128, true>::XR;
        case 256: return which == 0 ? wg::Cfg<256, true>::RROWS : wg::Cfg<256, true>::XR;
        default: return 0;
    }
}

// Registers a thread of the bf16 dk/dv kernel (which = 0) or dq kernel (which
// = 1) at head dim dh: at launch (role 0, what ptxas must report), of the
// producer warp (1) and of the consumer warpgroups (2) after `setmaxnreg`;
// threads a block (role 3) and blocks an SM (role 4).
extern "C" int repro_flash_attention_bwd_regs(int which, int dh, int role) {
    auto get = [role](auto cfg) {
        using C = decltype(cfg);
        const int v[5] = {C::LAUNCH_REGS, C::PRODUCER_REGS, C::CONSUMER_REGS, C::THREADS,
                          C::MIN_BLOCKS};
        return role >= 0 && role < 5 ? v[role] : 0;
    };
    const bool dq = which == 1;
    switch (head_dim_tile(dh)) {
        case 64: return dq ? get(wg::Cfg<64, true>{}) : get(wg::Cfg<64, false>{});
        case 128: return dq ? get(wg::Cfg<128, true>{}) : get(wg::Cfg<128, false>{});
        case 256: return dq ? get(wg::Cfg<256, true>{}) : get(wg::Cfg<256, false>{});
        default: return 0;
    }
}

// Parts into which the bf16 dk/dv kernel splits each group's rep = H / KV
// query heads, one block each, at a batch B, Sk keys and KV kv heads: the
// wrapper allocates 2 * parts * B * Sk * KV * dh f32 of scratch where it is
// above 1.
extern "C" int repro_flash_attention_bwd_head_parts(int B, int Sk, int KV, int rep) {
    return wg::head_parts(B, Sk, KV, rep);
}

// q, o, do [B,Sq,H,dh]; k, v [B,Sk,KV,dh]; lse [B,H,Sq] f32 contiguous (the
// forward's); delta [B,H,Sq] f32 scratch; dq [B,Sq,H,dh], dk and dv
// [B,Sk,KV,dh] outputs; in bf16, head_parts as
// `repro_flash_attention_bwd_head_parts` gives it and, where it is above 1,
// scratch of 2 * head_parts * B * Sk * KV * dh f32 (the f32 kernels take
// neither).  strides: 24 int64 in elements, (batch, seq, head) of q, k, v,
// do, dk, dv, dq, o in that order.  dtype: 0 = f32, 1 = bf16; rows start on
// 16-byte boundaries; in bf16 dh is a multiple of 8; dh is at most 256.
// window <= 0 means no window.  device is the CUDA ordinal of the tensors and
// the stream.  Returns cudaError_t.
extern "C" int repro_flash_attention_bwd(
        const void* q, const void* k, const void* v, const void* o, const void* dO,
        const float* lse, float* delta, void* dq, void* dk, void* dv, float* scratch,
        int head_parts, int dtype, int B, int Sq, int Sk, int H, int KV, int dh,
        const int64_t* strides, float scale, int causal, int window, int q_offset, int device,
        void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    Strides st;
    for (int i = 0; i < 24; ++i) st.v[i] = strides[i];
    if (dh <= 0 || dh > REPRO_MAX_HEAD_DIM || dh % 4 || KV <= 0 || H % KV)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);  // this library's runtime keeps its own
    if (err != cudaSuccess) return (int)err;
    if (Sq <= 0 || B <= 0) return (int)cudaSuccess;
    if (dtype == REPRO_F32) {
        auto c = [](const void* p) { return static_cast<const float*>(p); };
        auto m = [](void* p) { return static_cast<float*>(p); };
        switch (head_dim_tile(dh)) {
            case 64: return simt::launch<64>(c(q), c(k), c(v), c(o), c(dO), lse, delta, m(dq),
                                             m(dk), m(dv), B, Sq, Sk, H, KV, dh, st, scale,
                                             causal, window, q_offset, s);
            case 128: return simt::launch<128>(c(q), c(k), c(v), c(o), c(dO), lse, delta, m(dq),
                                               m(dk), m(dv), B, Sq, Sk, H, KV, dh, st, scale,
                                               causal, window, q_offset, s);
            default: return simt::launch<256>(c(q), c(k), c(v), c(o), c(dO), lse, delta, m(dq),
                                              m(dk), m(dv), B, Sq, Sk, H, KV, dh, st, scale,
                                              causal, window, q_offset, s);
        }
    }
    if (dtype == REPRO_BF16) {
        if (dh % 8 || head_parts < 1 || (H / KV) % head_parts ||
            (head_parts > 1 && scratch == nullptr))
            return (int)cudaErrorInvalidValue;
        auto c = [](const void* p) { return static_cast<const bf16*>(p); };
        auto m = [](void* p) { return static_cast<bf16*>(p); };
        switch (head_dim_tile(dh)) {
            case 64: return wg::launch<64>(c(q), c(k), c(v), c(o), c(dO), lse, delta, m(dq),
                                           m(dk), m(dv), scratch, head_parts, B, Sq, Sk, H, KV,
                                           dh, st, scale, causal, window, q_offset, s);
            case 128: return wg::launch<128>(c(q), c(k), c(v), c(o), c(dO), lse, delta, m(dq),
                                             m(dk), m(dv), scratch, head_parts, B, Sq, Sk, H, KV,
                                             dh, st, scale, causal, window, q_offset, s);
            default: return wg::launch<256>(c(q), c(k), c(v), c(o), c(dO), lse, delta, m(dq),
                                            m(dk), m(dv), scratch, head_parts, B, Sq, Sk, H, KV,
                                            dh, st, scale, causal, window, q_offset, s);
        }
    }
    return (int)cudaErrorInvalidValue;
}
