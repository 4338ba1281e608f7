// Flash-attention forward for Hopper (sm_90a), causal / sliding-window, GQA.
//
// Replaces the TPU kernel `_fa_kernel` in src/repro/kernels/flash_attention.py
// (launched by `_flash_fwd2`).  Same function as the plain version
// `repro_torch.kernels.ref.mha`: softmax(q k^T * scale + mask) v with the
// online-softmax statistics (m, l, acc) held in f32 and the output
// normalised once at the end, l clamped at 1e-30.
//
// What bounds it on an H100: at S=4096 (llama3-8b prefill: H=32, KV=8,
// dh=128) the causal half of the two products is ~137 GFLOP against ~67 MB
// of q/k/v/o, i.e. ~2000 FLOP per byte, far above the ~295 FLOP/B ridge:
// it is bound by arithmetic, so the products belong on the tensor cores.
//
// bf16 (every model path): the tensor-core kernel `tc::flash_fwd_kernel`.
//  * One block of 4 warps per (64-row q tile, head h, batch b); each warp
//    owns 16 q rows.  A loop inside the block walks the KV tiles of 64 keys
//    (the TPU grid's sequential axis), longest causal q tiles first.
//  * Both products are `mma.sync.m16n8k16` bf16 -> f32 with operands from
//    `ldmatrix` (`.trans` for V).  Q's fragments are loaded once into
//    registers.  The S accumulator fragment is the A fragment of P.V, so S
//    and P never leave the registers.  Softmax in f32 with `__expf`
//    (ex2.approx: a few f32 ulps, far inside the bf16 tolerance).
//  * P is not rounded once to bf16 (FlashAttention-2's choice): that moves
//    the output by tens of bf16 ulps against the plain version, which keeps
//    P in f32.  P is split into bf16 P_hi = bf16(P) and P_lo = bf16(P -
//    P_hi), and P.V = P_hi.V + P_lo.V, two products on the same V
//    fragments: P carries ~16 bits, and the output agrees with the plain
//    version to one bf16 ulp (tests/test_torch_kernels.py emulates this).
//    The price: P.V costs two products, so the tensor cores execute 1.5x the
//    FLOPs the function needs.
//  * K/V tiles stay bf16 in shared memory (rows padded by 16 B, so the 8
//    row addresses of an `ldmatrix` fall in 8 distinct bank groups), in two
//    stages filled by 16-byte `cp.async` (zero-filled past S and past dh):
//    tile t+1 is in flight while tile t is multiplied.  Q is staged in K's
//    second stage until it is in registers: 68 KB a block at dh=128.  The
//    registers (228 a thread at dh=128) let two blocks share an SM.
//  * KV tiles wholly above the causal diagonal or left of the window are
//    never loaded (the TPU kernel's `relevant` test); only tiles that cross
//    the diagonal, the window's edge or S are masked element by element.
//  Rows must start on 16-byte boundaries and dh must be a multiple of 8
//  (the wrapper checks both); dh up to 64 runs a 64-wide tile, up to 128 a
//  128-wide one, zero-padded (e.g. dh=120, whose tail is never written).
//
// f32: `simt::flash_fwd_kernel`, f32 FMAs on the CUDA cores (67 TFLOP/s
// peak), one block per 64-row q tile walking KV tiles of 32 keys.  The f32
// tolerance (1e-5 absolute) is below what TF32 tensor cores can give, and no
// model path runs attention in f32 on the card, so this path keeps the
// first version's design.
//
// Both: GQA by index (head h reads kv head h / rep, K/V never repeated);
// q, k, v and o are read and written in their [B, S, heads, dh] layout
// through the strides given; ragged S is masked here (no fallback).  A row
// that has no unmasked key in any tile the block visits gets 0; one whose
// keys are all masked in visited tiles gets the mean of their V, as in the
// plain version (NEG_INF is finite).
#include "common.cuh"

namespace {

namespace simt {

constexpr int BQ = 64;   // q rows per block
constexpr int BK = 32;   // keys per KV tile
constexpr int NT = 256;  // threads: 16 x 16, thread (ty, tx)
constexpr int LDP = BK + 4;

template <int DHP>
constexpr int smem_floats() { return BQ * (DHP + 4) + 2 * BK * (DHP + 4) + BQ * LDP; }

template <int DHP>
__global__ void __launch_bounds__(NT, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int Sq, int Sk, int rep, int dh,
                 int64_t qsb, int64_t qss, int64_t qsh,
                 int64_t ksb, int64_t kss, int64_t ksh,
                 int64_t vsb, int64_t vss, int64_t vsh,
                 int64_t osb, int64_t oss, int64_t osh,
                 float scale, int causal, int window, int q_offset) {
    constexpr int LDQ = DHP + 4;   // padded row stride of the q/k/v tiles
    constexpr int NJ = DHP / 64;   // float4 column groups of acc per thread
    constexpr int D4 = DHP / 4;
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][LDQ]
    float* Ks = Qs + BQ * LDQ;                     // [BK][LDQ]
    float* Vs = Ks + BK * LDQ;                     // [BK][LDQ]
    float* Ps = Vs + BK * LDQ;                     // [BQ][LDP]

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
    const int h = blockIdx.y, b = blockIdx.z, g = h / rep;
    const int q0 = qt * BQ;
    const int qa0 = q_offset + q0;  // absolute position of the tile's first row

    const float* qb = q + b * qsb + h * qsh;
    const float* kb = k + b * ksb + g * ksh;
    const float* vb = v + b * vsb + g * vsh;

    for (int i = tid; i < BQ * D4; i += NT) {
        const int r = i / D4, d = (i % D4) * 4;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q0 + r < Sq && d < dh) x = load4(qb + (q0 + r) * qss + d);
        *reinterpret_cast<float4*>(&Qs[r * LDQ + d]) = x;
    }

    // keys [k_lo, k_hi) are the only ones any row of this tile can see
    int k_lo = 0, k_hi = Sk;
    if (causal) k_hi = min(Sk, qa0 + BQ);
    if (window > 0) k_lo = max(0, qa0 - window + 1);
    const int kt_begin = k_lo / BK, kt_end = (k_hi + BK - 1) / BK;

    float m_r[4], l_r[4], acc[4][NJ][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m_r[i] = REPRO_NEG_INF;
        l_r[i] = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();  // the previous tile's K/V/P are no longer read
        for (int i = tid; i < BK * D4; i += NT) {
            const int r = i / D4, d = (i % D4) * 4;
            float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
            if (k0 + r < Sk && d < dh) {
                kx = load4(kb + (k0 + r) * kss + d);
                vx = load4(vb + (k0 + r) * vss + d);
            }
            *reinterpret_cast<float4*>(&Ks[r * LDQ + d]) = kx;
            *reinterpret_cast<float4*>(&Vs[r * LDQ + d]) = vx;
        }
        __syncthreads();

        // scores of rows ty + 16 i against keys tx + 16 j
        float s[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
        for (int d = 0; d < DHP; d += 4) {
            float4 a[4], c[2];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                a[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LDQ + d]);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                c[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LDQ + d]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    float t = s[i][j];
                    t = fmaf(a[i].x, c[j].x, t);
                    t = fmaf(a[i].y, c[j].y, t);
                    t = fmaf(a[i].z, c[j].z, t);
                    t = fmaf(a[i].w, c[j].w, t);
                    s[i][j] = t;
                }
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qpos = qa0 + ty + 16 * i;
            float mx = REPRO_NEG_INF;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int key = k0 + tx + 16 * j;
                const bool ok = key < Sk && (!causal || key <= qpos) &&
                                (window <= 0 || key > qpos - window);
                s[i][j] = ok ? s[i][j] * scale : REPRO_NEG_INF;
                mx = fmaxf(mx, s[i][j]);
            }
            // the 16 threads of a row are lanes 0-15 or 16-31 of one warp
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m_r[i], mx);
            const float alpha = expf(m_r[i] - m_new);
            const float p0 = expf(s[i][0] - m_new), p1 = expf(s[i][1] - m_new);
            float sum = p0 + p1;
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            l_r[i] = l_r[i] * alpha + sum;
            m_r[i] = m_new;
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][e] *= alpha;
            Ps[(ty + 16 * i) * LDP + tx] = p0;
            Ps[(ty + 16 * i) * LDP + tx + 16] = p1;
        }
        __syncthreads();

        // acc[rows ty + 16 i][cols tx*4 + 64 j ..] += P V
#pragma unroll 2
        for (int kk = 0; kk < BK; kk += 4) {
            float4 p[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                p[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * LDP + kk]);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    const float4 w =
                        *reinterpret_cast<const float4*>(&Vs[(kk + u) * LDQ + tx * 4 + 64 * j]);
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const float pu = u == 0 ? p[i].x : u == 1 ? p[i].y : u == 2 ? p[i].z : p[i].w;
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
        const float l = fmaxf(l_r[i], 1e-30f);
        float* orow = o + b * osb + row * oss + h * osh;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int d = tx * 4 + 64 * j;
            if (d >= dh) continue;
#pragma unroll
            for (int e = 0; e < 4; ++e) store1(orow + d + e, acc[i][j][e] / l);
        }
    }
}

template <int DHP>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int Sq, int Sk, int H, int KV, int dh, const int64_t* st,
                   float scale, int causal, int window, int q_offset, cudaStream_t stream) {
    const size_t smem = smem_floats<DHP>() * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DHP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + BQ - 1) / BQ, H, B);
    flash_fwd_kernel<DHP><<<grid, NT, smem, stream>>>(
        q, k, v, o, Sq, Sk, H / KV, dh, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], st[9], st[10], st[11], scale, causal, window, q_offset);
    return cudaGetLastError();
}

}  // namespace simt

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BQ = 64;   // q rows per block: 4 warps of 16 rows
constexpr int BK = 64;   // keys per KV tile
constexpr int NT = 128;

// padded row stride of a tile, in elements
template <int DHP>
__host__ __device__ constexpr int lds() { return DHP + 8; }

template <int DHP>
constexpr int smem_bytes() { return 4 * BK * lds<DHP>() * (int)sizeof(bf16); }

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ void ldsm4_trans(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
    return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) = hi + lo with hi = bf16(x) and lo = bf16(x - hi), packed in pairs
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    hi = bits(h);
    lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// rows [row0, row0 + ROWS) of a [rows, dh] matrix -> a padded shared tile;
// rows at or past `nrows` and columns at or past dh are zero-filled
template <int DHP, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int64_t row_stride,
                                          int row0, int nrows, int dh, int tid) {
    constexpr int CPR = DHP / 8;  // 16-byte chunks per row
    static_assert(ROWS * CPR % NT == 0, "whole chunks per thread");
#pragma unroll
    for (int j = 0; j < ROWS * CPR / NT; ++j) {
        const int i = tid + j * NT;
        const int r = i / CPR, c = (i % CPR) * 8;
        const bool ok = row0 + r < nrows && c < dh;
        const bf16* p = ok ? src + (int64_t)(row0 + r) * row_stride + c : src;
        cp_async16(smem_addr(dst + r * lds<DHP>() + c), p, ok);
    }
}

template <int DHP>
__global__ void __launch_bounds__(NT, 2)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 int Sq, int Sk, int rep, int dh,
                 int64_t qsb, int64_t qss, int64_t qsh,
                 int64_t ksb, int64_t kss, int64_t ksh,
                 int64_t vsb, int64_t vss, int64_t vsh,
                 int64_t osb, int64_t oss, int64_t osh,
                 float scale, int causal, int window, int q_offset) {
    constexpr int LDS = lds<DHP>();
    constexpr int KS = DHP / 16;     // k-steps of Q K^T
    constexpr int NO = DHP / 8;      // n-tiles (8 columns) of the output
    constexpr int NS = BK / 8;       // n-tiles (8 keys) of S
    constexpr int TILE = BK * LDS;   // elements of one K or V stage
    static_assert(BQ == BK, "Q is staged in a K stage");
    extern __shared__ uint4 smem_tc[];
    bf16* Ks = reinterpret_cast<bf16*>(smem_tc);  // [2][BK][LDS]
    bf16* Vs = Ks + 2 * TILE;                      // [2][BK][LDS]

    // the block is NT threads; told so, nvcc 12.9 allocates 228 registers at
    // dh=128 instead of 255 (chip_smoke.py's [build] phase checks the count)
    __builtin_assume(threadIdx.x < NT);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
    const int h = blockIdx.y, b = blockIdx.z, g = h / rep;
    const int q0 = qt * BQ;
    const int qa0 = q_offset + q0;  // absolute position of the tile's first row

    const bf16* qb = q + b * qsb + h * qsh;
    const bf16* kb = k + b * ksb + g * ksh;
    const bf16* vb = v + b * vsb + g * vsh;

    // keys [k_lo, k_hi) are the only ones any row of this tile can see
    int k_lo = 0, k_hi = Sk;
    if (causal) k_hi = min(Sk, qa0 + BQ);
    if (window > 0) k_lo = max(0, qa0 - window + 1);
    const int kt_begin = k_lo / BK;
    const int n_tiles = max(0, (k_hi + BK - 1) / BK - kt_begin);

    // group 0: Q; group 1: the first K/V tile
    // Q: K's second stage, until Q is in registers
    bf16* Qs = Ks + TILE;
    load_tile<DHP, BQ>(Qs, qb, qss, q0, Sq, dh, tid);
    cp_async_commit();
    if (n_tiles > 0) {
        load_tile<DHP, BK>(Ks, kb, kss, kt_begin * BK, Sk, dh, tid);
        load_tile<DHP, BK>(Vs, vb, vss, kt_begin * BK, Sk, dh, tid);
    }
    cp_async_commit();

    // this thread's rows of the tile: r and r + 8 of its warp's 16
    const int r_lo = warp * 16 + (lane >> 2);
    const int qpos0 = qa0 + r_lo, qpos1 = qpos0 + 8;
    const int kq = 2 * (lane & 3);  // first of this thread's two columns of a fragment

    float m_r[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, l_r[2] = {0.f, 0.f};
    float acc[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    uint32_t qf[KS][4];
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
        ldsm4(qf[ks], smem_addr(Qs + (warp * 16 + (lane & 15)) * LDS + ks * 16 + (lane >> 4) * 8));
    __syncthreads();  // Q's stage is refilled by the first iteration

    for (int it = 0; it < n_tiles; ++it) {
        const int k0 = (kt_begin + it) * BK;
        const bf16* Kt = Ks + (it & 1) * TILE;
        const bf16* Vt = Vs + (it & 1) * TILE;
        if (it + 1 < n_tiles) {  // the next tile, into the other stage
            load_tile<DHP, BK>(Ks + ((it + 1) & 1) * TILE, kb, kss, k0 + BK, Sk, dh, tid);
            load_tile<DHP, BK>(Vs + ((it + 1) & 1) * TILE, vb, vss, k0 + BK, Sk, dh, tid);
        }
        cp_async_commit();
        cp_async_wait<1>();  // this tile has landed
        __syncthreads();

        // S = Q K^T: s[j] holds keys k0 + 8 j + kq (+1) of rows r_lo ([0..1]) and r_lo + 8 ([2..3])
        float s[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
            for (int ks = 0; ks < KS; ks += 2) {
                uint32_t kf[4];
                ldsm4(kf, smem_addr(Kt + (j * 8 + (lane & 7)) * LDS + ks * 16 + (lane >> 3) * 8));
                mma(s[j], qf[ks], kf[0], kf[1]);
                mma(s[j], qf[ks + 1], kf[2], kf[3]);
            }
        }

        const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > qa0) ||
                          (window > 0 && k0 <= qa0 + BQ - 1 - window);
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s[j][e] *= scale;
                if (edge) {
                    const int key = k0 + 8 * j + kq + (e & 1);
                    const int qpos = e < 2 ? qpos0 : qpos1;
                    const bool ok = key < Sk && (!causal || key <= qpos) &&
                                    (window <= 0 || key > qpos - window);
                    if (!ok) s[j][e] = REPRO_NEG_INF;
                }
            }

        // online softmax; the four threads of a quad share a row
        float al[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            float mx = REPRO_NEG_INF;
#pragma unroll
            for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m_r[hr], mx);
            const float alpha = __expf(m_r[hr] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < NS; ++j) {
                s[j][2 * hr] = __expf(s[j][2 * hr] - m_new);
                s[j][2 * hr + 1] = __expf(s[j][2 * hr + 1] - m_new);
                sum += s[j][2 * hr] + s[j][2 * hr + 1];
            }
            l_r[hr] = l_r[hr] * alpha + sum;  // this thread's share; the quad's summed at the end
            m_r[hr] = m_new;
            al[hr] = alpha;
        }
#pragma unroll
        for (int n = 0; n < NO; ++n) {
            acc[n][0] *= al[0];
            acc[n][1] *= al[0];
            acc[n][2] *= al[1];
            acc[n][3] *= al[1];
        }

        // acc += P_hi V + P_lo V, 16 keys a step
#pragma unroll
        for (int t = 0; t < BK / 16; ++t) {
            uint32_t ph[4], pl[4];
            split_bf16(s[2 * t][0], s[2 * t][1], ph[0], pl[0]);
            split_bf16(s[2 * t][2], s[2 * t][3], ph[1], pl[1]);
            split_bf16(s[2 * t + 1][0], s[2 * t + 1][1], ph[2], pl[2]);
            split_bf16(s[2 * t + 1][2], s[2 * t + 1][3], ph[3], pl[3]);
#pragma unroll
            for (int n = 0; n < NO; n += 2) {
                uint32_t vf[4];
                ldsm4_trans(vf, smem_addr(Vt + (t * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                                          n * 8 + (lane >> 4) * 8));
                mma(acc[n], ph, vf[0], vf[1]);
                mma(acc[n], pl, vf[0], vf[1]);
                mma(acc[n + 1], ph, vf[2], vf[3]);
                mma(acc[n + 1], pl, vf[2], vf[3]);
            }
        }
        __syncthreads();  // every warp is done with this stage before it is refilled
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        float l = l_r[hr];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        l = fmaxf(l, 1e-30f);
        const int row = q0 + r_lo + 8 * hr;
        if (row >= Sq) continue;
        bf16* orow = o + b * osb + row * oss + h * osh;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
            const int d = n * 8 + kq;
            if (d < dh)
                *reinterpret_cast<__nv_bfloat162*>(orow + d) =
                    __floats2bfloat162_rn(acc[n][2 * hr] / l, acc[n][2 * hr + 1] / l);
        }
    }
}

template <int DHP>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                   int B, int Sq, int Sk, int H, int KV, int dh, const int64_t* st,
                   float scale, int causal, int window, int q_offset, cudaStream_t stream) {
    const int smem = smem_bytes<DHP>();
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DHP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + BQ - 1) / BQ, H, B);
    flash_fwd_kernel<DHP><<<grid, NT, smem, stream>>>(
        q, k, v, o, Sq, Sk, H / KV, dh, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], st[9], st[10], st[11], scale, causal, window, q_offset);
    return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Keys per KV tile of the kernel for dtype (0 = f32, 1 = bf16).
extern "C" int repro_flash_attention_kv_tile(int dtype) {
    return dtype == REPRO_BF16 ? tc::BK : simt::BK;
}

// Query rows per block of the kernel for dtype (0 = f32, 1 = bf16).
extern "C" int repro_flash_attention_q_tile(int dtype) {
    return dtype == REPRO_BF16 ? tc::BQ : simt::BQ;
}

// Dynamic shared memory of one block for dtype and head dim dh, in bytes.
extern "C" int repro_flash_attention_smem_bytes(int dtype, int dh) {
    if (dtype == REPRO_BF16) return dh <= 64 ? tc::smem_bytes<64>() : tc::smem_bytes<128>();
    return (dh <= 64 ? simt::smem_floats<64>() : simt::smem_floats<128>()) * (int)sizeof(float);
}

// q [B,Sq,H,dh], k/v [B,Sk,KV,dh], o [B,Sq,H,dh]; strides in elements as
// (batch, seq, head) for q, k, v, o in that order; the head dim is unit-stride.
// dtype: 0 = f32, 1 = bf16.  Every row starts on a 16-byte boundary, and in
// bf16 dh is a multiple of 8.  window <= 0 means no window.  device is the
// CUDA ordinal the tensors and the stream belong to.  Returns cudaError_t.
extern "C" int repro_flash_attention_fwd(
        const void* q, const void* k, const void* v, void* o, int dtype,
        int B, int Sq, int Sk, int H, int KV, int dh,
        int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
        int64_t vsb, int64_t vss, int64_t vsh, int64_t osb, int64_t oss, int64_t osh,
        float scale, int causal, int window, int q_offset, int device, void* stream) {
    const int64_t st[12] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dh <= 0 || dh > 128 || dh % 4 || H % KV) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);  // this library's runtime keeps its own
    if (err != cudaSuccess) return (int)err;
    if (Sq <= 0 || B <= 0) return (int)cudaSuccess;
    if (dtype == REPRO_F32) {
        const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
                    *fv = static_cast<const float*>(v);
        float* fo = static_cast<float*>(o);
        return dh <= 64 ? simt::launch<64>(fq, fk, fv, fo, B, Sq, Sk, H, KV, dh, st, scale,
                                           causal, window, q_offset, s)
                        : simt::launch<128>(fq, fk, fv, fo, B, Sq, Sk, H, KV, dh, st, scale,
                                            causal, window, q_offset, s);
    }
    if (dtype == REPRO_BF16) {
        if (dh % 8) return (int)cudaErrorInvalidValue;
        using tc::bf16;
        const bf16 *bq = static_cast<const bf16*>(q), *bk = static_cast<const bf16*>(k),
                   *bv = static_cast<const bf16*>(v);
        bf16* bo = static_cast<bf16*>(o);
        return dh <= 64 ? tc::launch<64>(bq, bk, bv, bo, B, Sq, Sk, H, KV, dh, st, scale, causal,
                                         window, q_offset, s)
                        : tc::launch<128>(bq, bk, bv, bo, B, Sq, Sk, H, KV, dh, st, scale,
                                          causal, window, q_offset, s);
    }
    return (int)cudaErrorInvalidValue;
}
