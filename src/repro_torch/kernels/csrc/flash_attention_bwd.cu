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
// peak) and the products belong on the tensor cores.
//
// bf16 (every model path): the tensor-core kernels `tc::dkdv_kernel` and
// `tc::dq_kernel`, every product `mma.sync.m16n8k16` bf16 -> f32 with
// operands from `ldmatrix` (`.trans` where the contraction runs over the
// rows of a tile), as in the forward (flash_attention.cu; the building
// blocks are in common.cuh).
//  * P and dS are split into bf16 hi + lo in all three products that take
//    them: dv = P^T_hi do + P^T_lo do, dk = dS^T_hi q + dS^T_lo q, dq = dS_hi
//    k + dS_lo k.  Emulated on the CPU (tests/test_torch_kernels.py: B=1
//    S=512 H=8 KV=2, dh 128 and 120, causal, window none and 100; products
//    of two bf16 values are exact in f32), the split holds dq, dk and dv to
//    one bf16 ulp (`ref.grad_tolerance_ratio` <= 1), and P or dS rounded once
//    to bf16 (FlashAttention-2's choice) in any one of the three products
//    misses it there; the test asserts both.  S, dP, P
//    and dS live in f32 registers: the accumulator fragments of S and dP
//    become the A fragments of the next products, so P and dS never touch
//    shared memory.
//  * The tensor cores add products into their f32 accumulator by
//    truncation, not rounding.  dv of the first keys at S=4096 sums ~16K
//    rows in one accumulator, ~2000 mma adds: where that sum cancels it
//    drifted to 2.4 of the tolerance on an H100.  So the products of each step of q
//    rows (dk/dv) or each key tile (dq) are summed from 0 in a fresh
//    accumulator and added into the f32 registers by a rounding add
//    (`product_into`).
//  * `tc::dkdv_kernel`: one block of 4 warps per (64-key tile, kv head,
//    batch), each warp owning 16 keys, key tile 0 (under a causal mask the
//    one that sees the most rows) first.  The block walks the rep query
//    heads of its group and, for each, the 32-row q tiles that can see a
//    key of its tile, so GQA is summed inside the block, with no atomics.
//    q and do tiles with their rows of lse and delta stream through two
//    `cp.async` stages; K and V stay in shared memory and are read with
//    `ldmatrix` for each step.  Key-major, per step of q rows: S^T = K Q^T,
//    P^T split hi + lo, dv += P^T do; then dP^T = V do^T, dS^T = P^T (dP^T -
//    delta) with P^T taken as hi + lo (2^-17 of P, below dS's own split), so
//    the f32 P^T and dP^T are never live together, dk += dS^T q.
//    Registers: dk and dv take 64 + 64 f32 a thread at dh=128, half of the
//    255; with 32-row steps or a fully unrolled k-step loop ptxas (nvcc
//    12.9) spills, so at dh=128 a step is 16 rows and the loop
//    is unrolled by 4 (`q_rows`, `ks_unroll`), which ptxas keeps in 255
//    registers with no spill.
//  * Deterministic: no atomics, so the dq pass recomputes S and dP.  The
//    tensor cores execute 12 dh_pad FLOP a (query, key) pair of every tile
//    pair visited in dk/dv (S^T, dP^T, dv twice, dk twice) and 8 dh_pad in
//    dq (S, dP, dq twice): 20 x 128 against the 10 dh that the function
//    needs, ~698 GFLOP against 322 at the shape above (derived from the
//    tiles, chip_smoke.py logs it).
//  * Tiles wholly above the causal diagonal or left of the window are never
//    loaded; only tiles that cross the diagonal, the window's edge, Sq or Sk
//    are masked element by element.  dh runs in the narrowest of a 64, 128
//    or 256 wide tile, zero-padded (dh=120's tail is never written).
//  * dh 256 (gemma-7b): dk and dv for all 256 columns would take 256 f32 a
//    thread, more than the 255 registers.  So each tile has two blocks
//    (grid y, `col_parts`), each owning one half of the output columns of
//    dk and dv (of dq in the dq kernel): both compute S and dP over all 256
//    columns from shared memory and accumulate only their own half.  Each
//    output column is written by exactly one block: still no atomics,
//    still deterministic, the same sums in the same order as a 256-wide
//    accumulator would take.  The price: S and dP are computed twice, (8 +
//    8) dh_pad FLOP a pair in dk/dv and (8 + 4) in dq, 28 x 256 against the
//    10 dh needed; shared memory (133 KiB dk/dv, 198 KiB dq) leaves one block
//    of 4 warps an SM.
//
// f32: `simt::dkdv_kernel` and `simt::dq_kernel`, f32 FMAs on the CUDA cores
// (67 TFLOP/s peak), tiles staged in shared memory as f32, P and dS through
// shared memory.  No model path runs attention in f32 on the card, and it
// meets the f32 tolerance (1e-4), so this path keeps the first version's
// design; at dh 256 its dk/dv kernel owns half of the columns as the bf16
// one does, and both take one block an SM (213 and 204 KiB of tiles).
//
// Both: `delta_kernel` first (delta [B,H,Sq] f32, one warp per row).  q, k,
// v, o and do are read in their [B, S, heads, dh] layout through the strides
// given; ragged S and q_offset are masked here.  A row with no visible key
// gets dq = 0 (the plain version gives it the uniform P of its masked keys:
// such rows never occur on a causal path).
#include <climits>

#include "common.cuh"

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

namespace tc {

constexpr int NT = 128;  // 4 warps of 16 rows (keys in dk/dv, q rows in dq)

// output column parts of the dk/dv and dq kernels, the blocks' grid y: at dh
// 256 a thread's dk and dv (or dq and the S and dP fragments) for all 256
// columns would not fit its 255 registers, so each block owns half of the
// columns and computes S and dP over all of them
template <int DHP>
__host__ __device__ constexpr int col_parts() { return DHP > 128 ? 2 : 1; }

// acc[n] += sum over t of (hi[t] + lo[t]) B_t, n over the NO 8-column tiles,
// with B_t rows [16 t, 16 t + 16) of a shared bf16 tile of row stride LDS,
// read by `ldmatrix.trans` from `b` (this lane's shared address of row 0,
// column 0).  The tensor cores add into their f32 accumulator by
// truncation, so the 2 T products of each pair of tiles are summed from 0 in
// a fresh accumulator and added into `acc` by a rounding f32 add: a sum over
// thousands of rows in one mma accumulator drifts by several bf16 ulps
// where it cancels.
template <int NO, int T, int LDS>
__device__ __forceinline__ void product_into(float (&acc)[NO][4], const uint32_t (&hi)[T][4],
                                             const uint32_t (&lo)[T][4], uint32_t b) {
#pragma unroll
    for (int n = 0; n < NO; n += 2) {
        float part[2][4] = {};
#pragma unroll
        for (int t = 0; t < T; ++t) {
            uint32_t f[4];
            ldsm4_trans(f, b + 2 * (t * 16 * LDS + n * 8));
            mma_bf16(part[0], hi[t], f[0], f[1]);
            mma_bf16(part[0], lo[t], f[0], f[1]);
            mma_bf16(part[1], hi[t], f[2], f[3]);
            mma_bf16(part[1], lo[t], f[2], f[3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            acc[n][e] += part[0][e];
            acc[n + 1][e] += part[1][e];
        }
    }
}

// the sum of the two bf16 pairs packed in x and y, as f32
__device__ __forceinline__ float2 bf16x2_sum(uint32_t x, uint32_t y) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y));
    return make_float2(a.x + b.x, a.y + b.y);
}

namespace dkdv {

constexpr int BK = 64;  // keys per block
constexpr int BQ = 32;  // q rows per stage of the loop
// q rows of S^T and dP^T in registers at a time, and the unrolling of the
// k-step loop that forms them, by the tile width (see the note at the top)
template <int DHP>
__host__ __device__ constexpr int q_rows() { return DHP > 64 ? 16 : 32; }
template <int DHP>
__host__ __device__ constexpr int ks_unroll() { return DHP > 64 ? 4 : DHP / 16; }

// K, V; two stages of q, do; two stages of lse, delta
template <int DHP>
constexpr int smem_bytes() {
    return (2 * BK + 4 * BQ) * bf16_lds<DHP>() * (int)sizeof(bf16) + 4 * BQ * (int)sizeof(float);
}

template <int DHP>
__global__ void __launch_bounds__(NT, 2)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ dO, const float* __restrict__ lse,
            const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
            int B, int Sq, int Sk, int H, int KV, int dh, const Strides st,
            float scale, int causal, int window, int q_offset) {
    constexpr int LDS = bf16_lds<DHP>();
    constexpr int KS = DHP / 16;  // k-steps (over dh) of S^T and dP^T
    constexpr int DOUT = DHP / col_parts<DHP>();  // this block's columns of dk and dv
    constexpr int NO = DOUT / 8;  // their n-tiles (8 columns)
    constexpr int QH = q_rows<DHP>();
    constexpr int NS = QH / 8;    // n-tiles (8 q rows) of S^T and dP^T
    constexpr int TILE = BQ * LDS;
    extern __shared__ uint4 smem_tc[];
    bf16* Ks = reinterpret_cast<bf16*>(smem_tc);        // [BK][LDS]
    bf16* Vs = Ks + BK * LDS;                            // [BK][LDS]
    bf16* Qs = Vs + BK * LDS;                            // [2][BQ][LDS]
    bf16* dOs = Qs + 2 * TILE;                           // [2][BQ][LDS]
    float* Ls = reinterpret_cast<float*>(dOs + 2 * TILE);  // [2][BQ]: lse
    float* Ds = Ls + 2 * BQ;                               // [2][BQ]: delta

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    // kv heads and batches fastest, key tiles in order: tile 0, which under a
    // causal mask sees the most rows, is scheduled first
    const int g = blockIdx.x % KV, b = (blockIdx.x / KV) % B, kt = blockIdx.x / (KV * B);
    const int k0 = kt * BK, rep = H / KV;
    const int c0 = col_parts<DHP>() > 1 ? blockIdx.y * DOUT : 0;  // this block's first column

    // rows that can see a key of [k0, k0 + BK): qpos >= k0 (causal) and
    // qpos < k0 + BK - 1 + window (window), qpos = q_offset + row
    int i_lo = 0, i_hi = Sq;
    if (causal) i_lo = max(0, k0 - q_offset);
    if (window > 0) i_hi = min(Sq, k0 + BK - 1 + window - q_offset);
    const int qt_begin = i_lo / BQ;
    const int n_qt = i_hi > i_lo ? (i_hi + BQ - 1) / BQ - qt_begin : 0;
    const int n_steps = rep * n_qt;  // (query head, q tile) steps

    // this thread's keys: rows kr and kr + 8 of its warp's 16; columns kq, kq + 1 of a fragment
    const int kr = warp * 16 + (lane >> 2), kq = 2 * (lane & 3);
    // key k0 + kr + 8 hr is visible from the query positions [vis[2 hr], vis[2 hr + 1]]
    // (causal: from itself; window: up to window - 1 after it; rows < Sq; none if >= Sk)
    int vis[4];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int key = k0 + kr + 8 * hr;
        vis[2 * hr] = causal ? key : INT_MIN;
        const int last = q_offset + Sq - 1;  // the last query position
        vis[2 * hr + 1] = key >= Sk ? INT_MIN
                          : window > 0 && window <= last ? min(last, key + window - 1) : last;
    }
    float acc_k[NO][4], acc_v[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

    // q, do, lse and delta of step (head g rep + r, q tile qt) into stage `stage`
    auto load_step = [&](int r, int qt, int stage) {
        const int h = g * rep + r, q0 = qt * BQ;
        load_tile_bf16<DHP, BQ, NT>(Qs + stage * TILE, q + b * st.v[0] + h * st.v[2], st.v[1],
                                    q0, Sq, dh, tid);
        load_tile_bf16<DHP, BQ, NT>(dOs + stage * TILE, dO + b * st.v[9] + h * st.v[11],
                                    st.v[10], q0, Sq, dh, tid);
        if (tid < BQ) {
            const bool ok = q0 + tid < Sq;
            const int64_t at = ((int64_t)b * H + h) * Sq + q0 + tid;
            cp_async4(smem_addr(Ls + stage * BQ + tid), ok ? lse + at : lse, ok);
            cp_async4(smem_addr(Ds + stage * BQ + tid), ok ? delta + at : delta, ok);
        }
    };

    // this lane's ldmatrix addresses in shared memory: A fragments of K and V
    // (rows are keys), B fragments of q and do, row-major (rows along n) and
    // transposed (rows along k), at row 0 of a stage
    const uint32_t ka_addr = smem_addr(Ks + (warp * 16 + (lane & 15)) * LDS + (lane >> 4) * 8);
    const uint32_t va_addr = ka_addr + 2 * BK * LDS;
    const uint32_t b_lane = 2 * (((lane & 7) + (lane >> 4) * 8) * LDS + ((lane >> 3) & 1) * 8);
    // the products' B operands start at this block's first column
    const uint32_t r_lane = 2 * (((lane & 7) + ((lane >> 3) & 1) * 8) * LDS + (lane >> 4) * 8 + c0);

    if (n_steps > 0) {
        // group 0: K, V and the first step
        load_tile_bf16<DHP, BK, NT>(Ks, k + b * st.v[3] + g * st.v[5], st.v[4], k0, Sk, dh, tid);
        load_tile_bf16<DHP, BK, NT>(Vs, v + b * st.v[6] + g * st.v[8], st.v[7], k0, Sk, dh, tid);
        load_step(0, qt_begin, 0);
        cp_async_commit();
    }

    for (int it = 0, r = 0, qt = qt_begin; it < n_steps; ++it) {
        const int stage = it & 1;
        const int q0 = qt * BQ, qa0 = q_offset + q0;
        if (++qt == qt_begin + n_qt) qt = qt_begin, ++r;  // (r, qt) is now the next step
        if (it + 1 < n_steps) load_step(r, qt, stage ^ 1);  // into the other stage
        cp_async_commit();
        cp_async_wait<1>();  // this step has landed
        __syncthreads();

        const uint32_t q_st = smem_addr(Qs + stage * TILE), do_st = smem_addr(dOs + stage * TILE);
        const float* Lt = Ls + stage * BQ;
        const float* Dt = Ds + stage * BQ;
        const bool edge = q0 + BQ > Sq || k0 + BK > Sk || (causal && k0 + BK - 1 > qa0) ||
                          (window > 0 && k0 <= qa0 + BQ - 1 - window);

#pragma unroll 1
        for (int hq = 0; hq < BQ; hq += QH) {
            // fragments c[j] hold q rows hq + 8 j + kq (+1) of keys kr ([0..1]) and kr + 8 ([2..3])
            const uint32_t b_off = b_lane + 2 * hq * LDS, r_off = r_lane + 2 * hq * LDS;
            uint32_t hi[QH / 16][4], lo[QH / 16][4];
            {
                // S^T = K Q^T; P^T = exp(S^T scale - lse), 0 where masked, split hi + lo
                float s[NS][4];
                mma_abt<KS, NS, LDS, ks_unroll<DHP>()>(s, ka_addr, q_st + b_off);
#pragma unroll
                for (int j = 0; j < NS; ++j) {
                    const int qr = hq + 8 * j + kq;  // tile row of elements 0, 2; qr + 1 of 1, 3
                    const float2 l2 = *reinterpret_cast<const float2*>(Lt + qr);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        float p = __expf(fmaf(s[j][e], scale, -((e & 1) ? l2.y : l2.x)));
                        if (edge) {
                            const int qpos = qa0 + qr + (e & 1);
                            if (qpos < vis[e & 2] || qpos > vis[(e & 2) + 1]) p = 0.f;
                        }
                        s[j][e] = p;
                    }
                }
#pragma unroll
                for (int t = 0; t < QH / 16; ++t) acc_to_a_split(s, t, hi[t], lo[t]);
            }
            // dv += P^T_hi dO + P^T_lo dO
            product_into<NO, QH / 16, LDS>(acc_v, hi, lo, do_st + r_off);
            {
                // dP^T = V dO^T; dS^T = P^T (dP^T - delta) with P^T = hi + lo (the f32
                // P^T is not kept: 2^-17 of it, below dS's own split), split hi + lo
                float dp[NS][4];
                mma_abt<KS, NS, LDS, ks_unroll<DHP>()>(dp, va_addr, do_st + b_off);
#pragma unroll
                for (int j = 0; j < NS; ++j) {
                    const float2 d2 = *reinterpret_cast<const float2*>(Dt + hq + 8 * j + kq);
#pragma unroll
                    for (int hr = 0; hr < 2; ++hr) {
                        const float2 p = bf16x2_sum(hi[j / 2][(j & 1) * 2 + hr],
                                                    lo[j / 2][(j & 1) * 2 + hr]);
                        dp[j][2 * hr] = p.x * (dp[j][2 * hr] - d2.x);
                        dp[j][2 * hr + 1] = p.y * (dp[j][2 * hr + 1] - d2.y);
                    }
                }
#pragma unroll
                for (int t = 0; t < QH / 16; ++t) acc_to_a_split(dp, t, hi[t], lo[t]);
            }
            // dk += dS^T_hi Q + dS^T_lo Q
            product_into<NO, QH / 16, LDS>(acc_k, hi, lo, q_st + r_off);
        }
        __syncthreads();  // every warp is done with this stage before it is refilled
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int key = k0 + kr + 8 * hr;
        if (key >= Sk) continue;
        bf16* krow = dk + b * st.v[12] + (int64_t)key * st.v[13] + g * st.v[14];
        bf16* vrow = dv + b * st.v[15] + (int64_t)key * st.v[16] + g * st.v[17];
#pragma unroll
        for (int n = 0; n < NO; ++n) {
            const int d = c0 + n * 8 + kq;
            if (d >= dh) continue;
            *reinterpret_cast<__nv_bfloat162*>(krow + d) =
                __floats2bfloat162_rn(acc_k[n][2 * hr] * scale, acc_k[n][2 * hr + 1] * scale);
            *reinterpret_cast<__nv_bfloat162*>(vrow + d) =
                __floats2bfloat162_rn(acc_v[n][2 * hr], acc_v[n][2 * hr + 1]);
        }
    }
}

}  // namespace dkdv

namespace dq {

constexpr int BQ = 64;  // q rows per block
constexpr int BK = 64;  // keys per KV tile

// q, do; two stages of K and V
template <int DHP>
constexpr int smem_bytes() { return (2 * BQ + 4 * BK) * bf16_lds<DHP>() * (int)sizeof(bf16); }

template <int DHP>
__global__ void __launch_bounds__(NT, 2)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ dO, const float* __restrict__ lse,
          const float* __restrict__ delta, bf16* __restrict__ dq,
          int B, int Sq, int Sk, int H, int KV, int dh, const Strides st,
          float scale, int causal, int window, int q_offset) {
    constexpr int LDS = bf16_lds<DHP>();
    constexpr int KS = DHP / 16;  // k-steps (over dh) of S and dP
    constexpr int DOUT = DHP / col_parts<DHP>();  // this block's columns of dq
    constexpr int NO = DOUT / 8;  // their n-tiles (8 columns)
    constexpr int NS = BK / 8;    // n-tiles (8 keys) of S and dP
    constexpr int TILE = BK * LDS;
    extern __shared__ uint4 smem_tc[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_tc);  // [BQ][LDS]
    bf16* dOs = Qs + BQ * LDS;                     // [BQ][LDS]
    bf16* Ks = dOs + BQ * LDS;                     // [2][BK][LDS]
    bf16* Vs = Ks + 2 * TILE;                      // [2][BK][LDS]

    __builtin_assume(threadIdx.x < NT);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    // heads and batches fastest, q tiles longest causal first
    const int h = blockIdx.x % H, b = (blockIdx.x / H) % B;
    const int qt = (Sq + BQ - 1) / BQ - 1 - blockIdx.x / (H * B);
    const int g = h / (H / KV);
    const int q0 = qt * BQ, qa0 = q_offset + q0;
    const int c0 = col_parts<DHP>() > 1 ? blockIdx.y * DOUT : 0;  // this block's first column
    const bf16* kb = k + b * st.v[3] + g * st.v[5];
    const bf16* vb = v + b * st.v[6] + g * st.v[8];

    // keys [k_lo, k_hi) are the only ones any row of this tile can see
    int k_lo = 0, k_hi = Sk;
    if (causal) k_hi = min(Sk, qa0 + BQ);
    if (window > 0) k_lo = max(0, qa0 - window + 1);
    const int kt_begin = k_lo / BK;
    const int n_tiles = max(0, (k_hi + BK - 1) / BK - kt_begin);

    // group 0: q, do and the first K/V tile
    load_tile_bf16<DHP, BQ, NT>(Qs, q + b * st.v[0] + h * st.v[2], st.v[1], q0, Sq, dh, tid);
    load_tile_bf16<DHP, BQ, NT>(dOs, dO + b * st.v[9] + h * st.v[11], st.v[10], q0, Sq, dh, tid);
    if (n_tiles > 0) {
        load_tile_bf16<DHP, BK, NT>(Ks, kb, st.v[4], kt_begin * BK, Sk, dh, tid);
        load_tile_bf16<DHP, BK, NT>(Vs, vb, st.v[7], kt_begin * BK, Sk, dh, tid);
    }
    cp_async_commit();

    // this thread's rows of the tile: r and r + 8 of its warp's 16
    const int r_lo = warp * 16 + (lane >> 2), kq = 2 * (lane & 3);
    float lse_r[2], del_r[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int row = q0 + r_lo + 8 * hr;
        const int64_t at = ((int64_t)b * H + h) * Sq + row;
        lse_r[hr] = row < Sq ? lse[at] : 0.f;
        del_r[hr] = row < Sq ? delta[at] : 0.f;
    }
    float acc[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    // this lane's ldmatrix addresses in shared memory: A fragments of q and
    // do, B fragments of K and V row-major (rows along n) and of K
    // transposed (rows along k), at row 0 of a stage
    const uint32_t qa_addr = smem_addr(Qs + (warp * 16 + (lane & 15)) * LDS + (lane >> 4) * 8);
    const uint32_t oa_addr = qa_addr + 2 * BQ * LDS;
    const uint32_t b_lane = 2 * (((lane & 7) + (lane >> 4) * 8) * LDS + ((lane >> 3) & 1) * 8);
    // the product's B operand starts at this block's first column
    const uint32_t r_lane = 2 * (((lane & 7) + ((lane >> 3) & 1) * 8) * LDS + (lane >> 4) * 8 + c0);
    for (int it = 0; it < n_tiles; ++it) {
        const int k0 = (kt_begin + it) * BK;
        const uint32_t k_st = smem_addr(Ks + (it & 1) * TILE), v_st = smem_addr(Vs + (it & 1) * TILE);
        if (it + 1 < n_tiles) {  // the next tile, into the other stage
            load_tile_bf16<DHP, BK, NT>(Ks + ((it + 1) & 1) * TILE, kb, st.v[4], k0 + BK, Sk, dh,
                                        tid);
            load_tile_bf16<DHP, BK, NT>(Vs + ((it + 1) & 1) * TILE, vb, st.v[7], k0 + BK, Sk, dh,
                                        tid);
        }
        cp_async_commit();
        cp_async_wait<1>();  // this tile (and, at it = 0, q and do) has landed
        __syncthreads();

        // S = Q K^T and dP = dO V^T: s[j] holds keys k0 + 8 j + kq (+1) of rows r_lo ([0..1]) and r_lo + 8 ([2..3])
        float s[NS][4], dp[NS][4];
        mma_abt<KS, NS, LDS, (DHP > 128 ? 8 : KS)>(s, qa_addr, k_st + b_lane);
        mma_abt<KS, NS, LDS, (DHP > 128 ? 8 : KS)>(dp, oa_addr, v_st + b_lane);

        // dS = P (dP - delta) into dp, P = exp(S scale - lse)
        const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > qa0) ||
                          (window > 0 && k0 <= qa0 + BQ - 1 - window);
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int hr = e >> 1;
                float p = __expf(fmaf(s[j][e], scale, -lse_r[hr]));
                if (edge) {
                    const int key = k0 + 8 * j + kq + (e & 1);
                    if (!visible(key, qa0 + r_lo + 8 * hr, Sk, causal, window)) p = 0.f;
                }
                dp[j][e] = p * (dp[j][e] - del_r[hr]);
            }

        // dq += dS_hi K + dS_lo K over this tile's keys
        uint32_t hi[BK / 16][4], lo[BK / 16][4];
#pragma unroll
        for (int t = 0; t < BK / 16; ++t) acc_to_a_split(dp, t, hi[t], lo[t]);
        product_into<NO, BK / 16, LDS>(acc, hi, lo, k_st + r_lane);
        __syncthreads();  // every warp is done with this stage before it is refilled
    }
    if (n_tiles == 0) cp_async_wait<0>();  // q and do were loaded for nothing

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int row = q0 + r_lo + 8 * hr;
        if (row >= Sq) continue;
        bf16* qrow = dq + b * st.v[18] + (int64_t)row * st.v[19] + h * st.v[20];
#pragma unroll
        for (int n = 0; n < NO; ++n) {
            const int d = c0 + n * 8 + kq;
            if (d < dh)
                *reinterpret_cast<__nv_bfloat162*>(qrow + d) =
                    __floats2bfloat162_rn(acc[n][2 * hr] * scale, acc[n][2 * hr + 1] * scale);
        }
    }
}

}  // namespace dq

template <int DHP>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dO,
                   const float* lse, float* delta, bf16* dq, bf16* dk, bf16* dv,
                   int B, int Sq, int Sk, int H, int KV, int dh, const Strides& st,
                   float scale, int causal, int window, int q_offset, cudaStream_t stream) {
    cudaError_t err = launch_delta(o, dO, delta, B, Sq, H, dh, st, stream);
    if (err != cudaSuccess) return err;

    const int smem_kv = dkdv::smem_bytes<DHP>();
    err = cudaFuncSetAttribute(dkdv::dkdv_kernel<DHP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
    if (err != cudaSuccess) return err;
    if (Sk > 0) {
        const unsigned blocks = (unsigned)((Sk + dkdv::BK - 1) / dkdv::BK) * KV * B;
        dkdv::dkdv_kernel<DHP><<<dim3(blocks, col_parts<DHP>()), NT, smem_kv, stream>>>(
            q, k, v, dO, lse, delta, dk, dv, B, Sq, Sk, H, KV, dh, st, scale, causal, window,
            q_offset);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }

    const int smem_q = dq::smem_bytes<DHP>();
    err = cudaFuncSetAttribute(dq::dq_kernel<DHP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
    if (err != cudaSuccess) return err;
    const unsigned blocks = (unsigned)((Sq + dq::BQ - 1) / dq::BQ) * H * B;
    dq::dq_kernel<DHP><<<dim3(blocks, col_parts<DHP>()), NT, smem_q, stream>>>(
        q, k, v, dO, lse, delta, dq, B, Sq, Sk, H, KV, dh, st, scale, causal, window, q_offset);
    return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Dynamic shared memory of one block of the bf16 dk/dv kernel (which = 0) or
// the bf16 dq kernel (which = 1) at head dim dh, in bytes (0 where no kernel
// takes dh): the kernels of every model path (the f32 kernels' is
// `simt::*::smem_floats` * 4).
extern "C" int repro_flash_attention_bwd_smem_bytes(int which, int dh) {
    switch (head_dim_tile(dh)) {
        case 64: return which == 0 ? tc::dkdv::smem_bytes<64>() : tc::dq::smem_bytes<64>();
        case 128: return which == 0 ? tc::dkdv::smem_bytes<128>() : tc::dq::smem_bytes<128>();
        case 256: return which == 0 ? tc::dkdv::smem_bytes<256>() : tc::dq::smem_bytes<256>();
        default: return 0;
    }
}

// Tiles of the bf16 kernels: keys per block of the dk/dv kernel (which = 0),
// q rows per block of the dq kernel (which = 1), q rows per step of the dk/dv
// kernel's loop (which = 2).
extern "C" int repro_flash_attention_bwd_tile(int which) {
    return which == 0 ? tc::dkdv::BK : which == 1 ? tc::dq::BQ : tc::dkdv::BQ;
}

// Blocks that share one tile of the bf16 dk/dv and dq kernels at head dim dh,
// each owning a part of the output columns and computing S and dP over all of
// them: 1 up to 128, 2 above (0 where no kernel takes dh).
extern "C" int repro_flash_attention_bwd_col_parts(int dh) {
    switch (head_dim_tile(dh)) {
        case 64: return tc::col_parts<64>();
        case 128: return tc::col_parts<128>();
        case 256: return tc::col_parts<256>();
        default: return 0;
    }
}

// q, o, do [B,Sq,H,dh]; k, v [B,Sk,KV,dh]; lse [B,H,Sq] f32 contiguous (the
// forward's); delta [B,H,Sq] f32 scratch; dq [B,Sq,H,dh], dk and dv
// [B,Sk,KV,dh] outputs.  strides: 24 int64 in elements, (batch, seq, head) of
// q, k, v, do, dk, dv, dq, o in that order.  dtype: 0 = f32, 1 = bf16; rows
// start on 16-byte boundaries; in bf16 dh is a multiple of 8; dh is at most
// 256.  window <= 0 means no window.  device is the CUDA ordinal of the
// tensors and the stream.  Returns cudaError_t.
extern "C" int repro_flash_attention_bwd(
        const void* q, const void* k, const void* v, const void* o, const void* dO,
        const float* lse, float* delta, void* dq, void* dk, void* dv, int dtype,
        int B, int Sq, int Sk, int H, int KV, int dh, const int64_t* strides, float scale,
        int causal, int window, int q_offset, int device, void* stream) {
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
        if (dh % 8) return (int)cudaErrorInvalidValue;
        auto c = [](const void* p) { return static_cast<const bf16*>(p); };
        auto m = [](void* p) { return static_cast<bf16*>(p); };
        switch (head_dim_tile(dh)) {
            case 64: return tc::launch<64>(c(q), c(k), c(v), c(o), c(dO), lse, delta, m(dq),
                                           m(dk), m(dv), B, Sq, Sk, H, KV, dh, st, scale, causal,
                                           window, q_offset, s);
            case 128: return tc::launch<128>(c(q), c(k), c(v), c(o), c(dO), lse, delta, m(dq),
                                             m(dk), m(dv), B, Sq, Sk, H, KV, dh, st, scale,
                                             causal, window, q_offset, s);
            default: return tc::launch<256>(c(q), c(k), c(v), c(o), c(dO), lse, delta, m(dq),
                                            m(dk), m(dv), B, Sq, Sk, H, KV, dh, st, scale, causal,
                                            window, q_offset, s);
        }
    }
    return (int)cudaErrorInvalidValue;
}
