// Flash-attention forward for Hopper (sm_90a), causal / sliding-window, GQA.
//
// Replaces the TPU kernel `_fa_kernel` in src/repro/kernels/flash_attention.py
// (launched by `_flash_fwd2`).  Same function as the plain version
// `repro_torch.kernels.ref.mha`: softmax(q k^T * scale + mask) v with the
// online-softmax statistics (m, l, acc) held in f32 and the output
// normalised once at the end, l clamped at 1e-30.  Given an `lse` pointer it
// also writes each row's log-sum-exp m + log(l) [B,H,Sq] f32, as
// `ref.mha_fwd_lse` does: the input of the backward kernels
// (flash_attention_bwd.cu).  Serving passes none and writes nothing more.
//
// What bounds it on an H100: at S=4096 (llama3-8b prefill: H=32, KV=8,
// dh=128) the causal half of the two products is ~137 GFLOP against ~67 MB
// of q/k/v/o, i.e. ~2000 FLOP per byte, far above the ~295 FLOP/B ridge:
// it is bound by arithmetic, so the products belong on the tensor cores at
// their full rate: `wgmma`, fed by TMA.
//
// bf16 (every model path): `wg::flash_fwd_kernel`, both products `wgmma`
// bf16 -> f32 (hopper.cuh), in a block of one producer warpgroup and two
// consumer warpgroups (FlashAttention-3's shape).
//  * A block owns a 128-row q tile of one head (64 rows a consumer
//    warpgroup) and walks the KV tiles its rows can see, the TPU grid's
//    sequential axis; the longest causal tiles first.  Where a grid of
//    128-row blocks would not fill one wave of the card's 132 SMs (B H
//    ceil(Sq / 128) < 132: the model-axis shares of a few heads) the blocks
//    take 64 rows and one consumer warpgroup, twice as many.
//  * Loads: one producer thread issues TMA loads (4-D tensor maps over [B, S,
//    heads, dh] with the caller's strides, hopper.cuh) of 64-column panels,
//    128-byte swizzled as `wgmma`'s descriptors read them; columns past dh
//    (dh 120 in a 128-wide tile) and rows past S arrive as zeros.  Q comes
//    once; K and V go round a ring of two stages behind full and empty
//    `mbarrier`s.  KV tiles of 128 keys up to dh 128, 64 at dh 256, where
//    Q's 128 rows and the two stages take 192 KiB of shared memory.
//    `setmaxnreg` hands the producer warpgroup's registers to the consumers
//    (24 and 240 a thread; one consumer warpgroup keeps the launch's 255);
//    the block's work is worked out after it.
//  * S = Q K^T: `wgmma` with both operands K-major in shared memory, formed
//    once over every column of the head at every head dim.  The softmax runs
//    in registers on the accumulator (each warp 16 rows, a row over the 4
//    threads of a quad) in base 2: P = exp2(S c - m c), c = scale log2(e),
//    one FFMA and one `ex2.approx` (a few f32 ulps) an element.  Only tiles
//    that cross the diagonal, the window's edge or S are masked element by
//    element, by selects.
//  * P is not rounded once to bf16 (FlashAttention-2's and SDPA's choice):
//    that moves the output by tens of bf16 ulps against the plain version,
//    which keeps P in f32.  P is split into bf16 P_hi = bf16(P) and P_lo =
//    bf16(P - P_hi), register A operands of O += P_hi V + P_lo V, two
//    `wgmma`s a 16-key step over every output column at once (V MN-major in
//    shared memory): P carries ~16 bits, and the output agrees with the plain
//    version to one bf16 ulp (tests/test_torch_kernels.py emulates this).
//    The price: P.V costs two products, so the tensor cores execute 1.5x the
//    FLOPs the function needs.  The tensor cores add into O by truncation;
//    O is rescaled and normalised by l, and over 4096 keys that moves it by
//    far less than the tolerance (emulated in the same test).
//  * Overlap: the two consumer warpgroups take turns on the tensor cores
//    (named barriers, FlashAttention-3's ping-pong).  In its turn a
//    warpgroup issues the previous tile's P.V and then this tile's S; its
//    softmax and split run under the other warpgroup's products.
//    FlashAttention-3's other overlap, S of the next tile issued beside
//    this tile's P.V so that a warpgroup's own softmax runs under its
//    products, keeps S, P's hi + lo and O live at once (192 registers at dh
//    128 and 256): on an H100 it spilled 12-16 B and ran 13-18 % slower at
//    dh 128 and 256 than the turns alone (3 % faster at dh 64).
//  * A row whose visited keys are all masked has P = 0 (its max taken as 0
//    in the exponent), so a row with no visible key gets 0 and lse
//    NEG_INF + log(1e-30).  A wait of the producer that lasts ~10 s traps,
//    so a pipeline fault ends the launch with an error rather than hanging
//    the card.
//  Rows must start on 16-byte boundaries and dh must be a multiple of 8
//  (the wrapper checks both); dh runs in the narrowest of a 64, 128 or 256
//  wide tile, zero-padded (e.g. dh=120, whose tail is never written).
//
// f32: `simt::flash_fwd_kernel`, f32 FMAs on the CUDA cores (67 TFLOP/s
// peak), one block per 64-row q tile walking KV tiles of 32 keys (at dh 256
// 139 KiB of shared memory, one block an SM).  The f32 tolerance (1e-5
// absolute) is below what TF32 tensor cores can give, and no model path
// runs attention in f32 on the card, so this path keeps the first version's
// design.  A row whose keys are all masked in the tiles it visits gets the
// mean of their V, as in the plain version (NEG_INF is finite).
//
// Both: GQA by index (head h reads kv head h / rep, K/V never repeated);
// q, k, v and o are read and written in their [B, S, heads, dh] layout
// through the strides given; ragged S and q_offset are masked here (no
// fallback).  A row that has no tile to visit gets 0.
#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace simt {

constexpr int BQ = 64;   // q rows per block
constexpr int BK = 32;   // keys per KV tile
constexpr int NT = 256;  // threads: 16 x 16, thread (ty, tx)
constexpr int LDP = BK + 4;

template <int DHP>
constexpr int smem_floats() { return BQ * (DHP + 4) + 2 * BK * (DHP + 4) + BQ * LDP; }

// 256 wide the tiles take 139 KiB of shared memory: one block an SM
template <int DHP>
__global__ void __launch_bounds__(NT, DHP > 128 ? 1 : 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
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
        if (lse != nullptr && tx == 0) lse[((int64_t)b * gridDim.y + h) * Sq + row] = m_r[i] + logf(l);
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
cudaError_t launch(const float* q, const float* k, const float* v, float* o, float* lse,
                   int B, int Sq, int Sk, int H, int KV, int dh, const int64_t* st,
                   float scale, int causal, int window, int q_offset, cudaStream_t stream) {
    const size_t smem = smem_floats<DHP>() * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DHP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + BQ - 1) / BQ, H, B);
    flash_fwd_kernel<DHP><<<grid, NT, smem, stream>>>(
        q, k, v, o, lse, Sq, Sk, H / KV, dh, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], st[9], st[10], st[11], scale, causal, window, q_offset);
    return cudaGetLastError();
}

}  // namespace simt

namespace wg {

using bf16 = __nv_bfloat16;
constexpr int ROWS = 64;    // q rows of a consumer warpgroup: wgmma's M
constexpr int STAGES = 2;   // K/V tiles in flight
constexpr int SMS = 132;    // an H100 SXM's SMs (tests/test_torch_kernels.py mirrors it)
constexpr int SCHED = 1;    // named barriers SCHED + wg: consumer warpgroup wg's turn to issue

// Keys per KV tile at head-dim tile DHP: 128 up to 128 wide, 64 at 256.
template <int DHP>
__host__ __device__ constexpr int kv_tile() { return DHP > 128 ? 64 : 128; }

// Consumer warpgroups a block: two (128-row blocks), or one where a grid of
// 128-row blocks would not fill one wave of the card's SMs.
inline int consumer_groups(int B, int Sq, int H) {
    return (long long)B * H * ((Sq + 2 * ROWS - 1) / (2 * ROWS)) < SMS ? 1 : 2;
}

// Threads and registers a thread of a block of NWG consumer warpgroups and a
// producer warpgroup whose registers `setmaxnreg` hands to them, one block an
// SM (a grid of one-warpgroup blocks is under two waves by choice).  At
// launch each thread has the SM's 65536 registers shared by the block's
// threads, 8 at a time and at most 255: ptxas must give the kernel exactly
// that count.  Two plans: 384 threads launch at 168 and the producer's drop
// to 24 lift the consumers to 240; 256 threads launch at 255, which already
// cover the one consumer warpgroup, so only the producer's drop.  Shared
// memory, offsets from a 1024-aligned base: Q [DHP / 64 panels][BQ rows],
// STAGES pairs of K and V [DHP / 64][BK], the mbarriers (Q, full, empty).
template <int DHP, int NWG>
struct Cfg {
    static_assert(NWG == 1 || NWG == 2, "one or two consumer warpgroups");
    static constexpr int BK = kv_tile<DHP>();
    static constexpr int BQ = ROWS * NWG;  // q rows a block
    static constexpr int THREADS = 128 * (NWG + 1);
    static constexpr int LAUNCH_REGS = NWG == 2 ? 168 : 255;
    static constexpr int PRODUCER_REGS = 24;
    static constexpr int CONSUMER_REGS = NWG == 2 ? 240 : 255;
    static_assert(LAUNCH_REGS == 255 ||
                      (LAUNCH_REGS % 8 == 0 && (LAUNCH_REGS + 8) * THREADS > 65536),
                  "the launch takes all it can, 8 a thread at a time, at most 255");
    static_assert(LAUNCH_REGS * THREADS <= 65536, "the launch's registers fit the SM");
    static_assert(PRODUCER_REGS + NWG * CONSUMER_REGS <= (NWG + 1) * LAUNCH_REGS,
                  "setmaxnreg hands out no more registers than the block has");
    static constexpr int TILE_Q = BQ * DHP * 2, TILE = BK * DHP * 2;  // bytes
    static constexpr int PQ = BQ * 128, PX = BK * 128;  // bytes of a 64-column panel
    static constexpr int X = TILE_Q, BAR = X + 2 * STAGES * TILE;
    static constexpr int SMEM = BAR + 8 * (1 + 2 * STAGES) + 1024;  // + the base's alignment
    static_assert(SMEM <= 232448, "a block fits an SM");
};

struct Params {
    int B, Sq, Sk, H, KV, dh;
    float scale, scale_log2;  // scale, and scale * log2(e)
    int causal, window, q_offset;
    bf16* o;
    float* lse;
    int64_t os[3];  // (batch, seq, head) strides of o
};

// A block's work: q rows [r0, r0 + BQ) of head h, batch b; n_tiles KV tiles
// from tile kt_begin.  Heads and batches fastest, q tiles longest causal first.
struct Work {
    int b, h, r0, kt_begin, n_tiles;
};

template <int DHP, int NWG>
__device__ __forceinline__ Work block_work(const Params& p, int idx) {
    using C = Cfg<DHP, NWG>;
    Work w;
    w.h = idx % p.H;
    idx /= p.H;
    w.b = idx % p.B;
    w.r0 = ((p.Sq + C::BQ - 1) / C::BQ - 1 - idx / p.B) * C::BQ;
    // keys [k_lo, k_hi) are the only ones any row of this tile can see
    const int qa0 = p.q_offset + w.r0;
    int k_lo = 0, k_hi = p.Sk;
    if (p.causal) k_hi = min(p.Sk, qa0 + C::BQ);
    if (p.window > 0) k_lo = max(0, qa0 - p.window + 1);
    w.kt_begin = k_lo / C::BK;
    w.n_tiles = max(0, (k_hi + C::BK - 1) / C::BK - w.kt_begin);
    return w;
}

// The producer: one thread loads the block's Q, then keeps K and V in flight.
template <int DHP, int NWG>
__device__ __forceinline__ void produce(const CUtensorMap* map_q, const CUtensorMap* map_k,
                                        const CUtensorMap* map_v, const Params& p,
                                        const Work& w, uint32_t base) {
    using C = Cfg<DHP, NWG>;
    const uint32_t bar_q = base + C::BAR, bar_full = bar_q + 8;
    const uint32_t bar_empty = bar_full + 8 * STAGES;
    const int g = w.h / (p.H / p.KV);
    mbar_arrive_expect_tx(bar_q, C::TILE_Q);
#pragma unroll
    for (int pn = 0; pn < DHP / 64; ++pn)
        tma_load_4d(base + pn * C::PQ, map_q, bar_q, 64 * pn, w.r0, w.h, w.b);
    for (int it = 0; it < w.n_tiles; ++it) {
        const int s = it % STAGES;
        mbar_wait_or_trap(bar_empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        const int k0 = (w.kt_begin + it) * C::BK;
        const uint32_t full = bar_full + 8 * s, kst = base + C::X + 2 * s * C::TILE;
        mbar_arrive_expect_tx(full, 2 * C::TILE);
#pragma unroll
        for (int pn = 0; pn < DHP / 64; ++pn) {
            tma_load_4d(kst + pn * C::PX, map_k, full, 64 * pn, k0, g, w.b);
            tma_load_4d(kst + C::TILE + pn * C::PX, map_v, full, 64 * pn, k0, g, w.b);
        }
    }
    // the last stages released: a consumer that never got its tiles traps here
    for (int it = max(0, w.n_tiles - STAGES); it < w.n_tiles; ++it)
        mbar_wait_or_trap(bar_empty + 8 * (it % STAGES), (it / STAGES) & 1);
}

// c = A B^T over the DHP columns of two tiles, both K-major: A the 64 rows of
// a warpgroup's Q at `a` (panels PA bytes apart), B the N keys of a K tile at
// `b` (panels PB apart); issued and committed
template <int DHP, int N, int PA, int PB>
__device__ __forceinline__ void scores(float (&c)[N / 8][4], uint32_t a, uint32_t b) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DHP / 16; ++ks) {
        // each k-step's descriptors made as it is issued, not all up front
        const uint64_t da = sw128_desc(opaque(a) + (ks / 4) * PA + (ks % 4) * 32);
        const uint64_t db = sw128_desc(opaque(b) + (ks / 4) * PB + (ks % 4) * 32);
        if constexpr (N == 128)
            wgmma_m64n128_ss(c, da, db, ks > 0);
        else
            wgmma_m64n64_ss(c, da, db, ks > 0);
    }
    wgmma_commit();
}

// o += (hi + lo) V over the 16 KS keys of a V tile at `v` (MN-major, its
// 64-column panels PX bytes apart), every output column in one `wgmma` a
// k-step and part; issued and committed
template <int DHP, int KS, int PX>
__device__ __forceinline__ void pv(float (&o)[DHP / 8][4], const uint32_t (&hi)[KS][4],
                                   const uint32_t (&lo)[KS][4], uint32_t v) {
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < KS; ++t) {
        const uint64_t d = sw128_desc_mn(opaque(v) + t * 16 * 128, PX);
        if constexpr (DHP == 256) {
            wgmma_m64n256_rs_t(o, hi[t], d, 1);
            wgmma_m64n256_rs_t(o, lo[t], d, 1);
        } else if constexpr (DHP == 128) {
            wgmma_m64n128_rs_t(o, hi[t], d, 1);
            wgmma_m64n128_rs_t(o, lo[t], d, 1);
        } else {
            wgmma_m64n64_rs_t(o, hi[t], d, 1);
            wgmma_m64n64_rs_t(o, lo[t], d, 1);
        }
    }
    wgmma_commit();
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// The online softmax of one tile's scores, in place: sc (S) becomes P =
// exp2(S c - m c), c = scale log2(e), with m each row's running max of S over
// its visible keys (0 in the exponent while it has none, so P = 0 there);
// masked elements (in MASK tiles only) are NEG_INF before the max.  l, the
// rows' running sums, are this thread's share, the quad's summed at the end;
// alpha is the factor of the rows' earlier sums.
template <bool MASK, int NS>
__device__ __forceinline__ void softmax_tile(float (&sc)[NS][4], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const Params& p, int k0,
                                             int qpos0, int kq) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int qpos = qpos0 + 8 * hr;
        float mx = m[hr];
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                float& x = sc[j][2 * hr + e];
                if (MASK)
                    x = visible_sel(k0 + 8 * j + kq + e, qpos, p.Sk, p.causal, p.window) ? x
                                                                                    : REPRO_NEG_INF;
                mx = fmaxf(mx, x);
            }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mc = mx == REPRO_NEG_INF ? 0.f : mx * p.scale_log2;
        alpha[hr] = ex2(fmaf(m[hr], p.scale_log2, -mc));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                float& x = sc[j][2 * hr + e];
                x = ex2(fmaf(x, p.scale_log2, -mc));
                sum += x;
            }
        l[hr] = l[hr] * alpha[hr] + sum;
        m[hr] = mx;
    }
}

// One consumer warpgroup: q rows [r0 + 64 wg, + 64) of the block and every
// output column.  In its turn on the tensor cores a warpgroup issues P.V of
// the previous KV tile (its P in registers) and, once that is done, S of the
// next, and waits for it; it passes the turn on before its softmax and the
// split of P into bf16 hi + lo, which run under the other warpgroup's
// products.  No branch separates a `wgmma` from its wait: a register of an
// asynchronous product live across a branch makes ptxas serialize every
// `wgmma` of the kernel.
template <int DHP, int NWG>
__device__ __forceinline__ void consume(const Params& p, const Work& w, uint32_t base) {
    using C = Cfg<DHP, NWG>;
    constexpr int BK = C::BK, NS = BK / 8, KS = BK / 16, NO = DHP / 8;
    constexpr bool TURNS = NWG == 2;
    const int wgi = threadIdx.x >> 7, wl = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int r0 = w.r0 + ROWS * wgi;  // this warpgroup's first row
    const uint32_t q_rows = base + wgi * ROWS * 128;  // its rows of Q's panels
    // this thread's rows: kr and kr + 8 of the warpgroup's; columns kq, kq + 1
    // of each 8-column n-tile
    const int kr = wl * 16 + (lane >> 2), kq = 2 * (lane & 3);
    const int qa0 = p.q_offset + r0;
    const uint32_t bar_full = base + C::BAR + 8, bar_empty = bar_full + 8 * STAGES;
    float o[NO][4];
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
    float sc[NS][4];
    uint32_t hi[KS][4], lo[KS][4];
    const int n = w.n_tiles;
    auto k_tile = [&](int it) { return base + C::X + 2 * (it % STAGES) * C::TILE; };
    auto turn = [&] {
        if (TURNS) named_sync(SCHED + wgi, 256);
    };
    auto next_turn = [&] {
        if (TURNS) named_arrive(SCHED + 1 - wgi, 256);
    };
    // O = alpha O + (P_hi + P_lo) V of tile it, the stage then released
    auto add_pv = [&](int it) {
#pragma unroll
        for (int j = 0; j < NO; ++j) {
            o[j][0] *= alpha[0];
            o[j][1] *= alpha[0];
            o[j][2] *= alpha[1];
            o[j][3] *= alpha[1];
        }
        pv<DHP, KS, C::PX>(o, hi, lo, k_tile(it) + C::TILE);
        wgmma_wait<0>();
        wgmma_hold(o);
        wgmma_hold(hi);
        wgmma_hold(lo);
        mbar_arrive(bar_empty + 8 * (it % STAGES));
    };
    // S of tile it, the turn passed on, then its softmax and P split; only
    // tiles across the diagonal, the window's edge or Sk are masked
    auto s_tile = [&](int it) {
        mbar_wait(bar_full + 8 * (it % STAGES), (it / STAGES) & 1);
        scores<DHP, BK, C::PQ, C::PX>(sc, q_rows, k_tile(it));
        next_turn();
        wgmma_wait<0>();
        wgmma_hold(sc);
        const int k0 = (w.kt_begin + it) * BK;
        if (k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > qa0) ||
            (p.window > 0 && k0 <= qa0 + ROWS - 1 - p.window))
            softmax_tile<true>(sc, m, l, alpha, p, k0, qa0 + kr, kq);
        else
            softmax_tile<false>(sc, m, l, alpha, p, k0, qa0 + kr, kq);
#pragma unroll
        for (int t = 0; t < KS; ++t) acc_to_a_split(sc, t, hi[t], lo[t]);
    };
    if (n > 0) {
        mbar_wait(base + C::BAR, 0);
        if (TURNS && wgi == 1) named_arrive(SCHED, 256);  // warpgroup 0 issues first
        turn();
        s_tile(0);
        for (int it = 1; it < n; ++it) {
            turn();
            add_pv(it - 1);
            s_tile(it);
        }
        turn();
        add_pv(n - 1);
        next_turn();
    }

    const float ln_scale = p.scale;  // m is in S's units; lse in the scaled scores'
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        float lr = l[hr];
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        lr = fmaxf(lr, 1e-30f);
        const int row = r0 + kr + 8 * hr;
        if (row >= p.Sq) continue;
        if (p.lse != nullptr && (lane & 3) == 0)
            p.lse[((int64_t)w.b * p.H + w.h) * p.Sq + row] =
                (m[hr] == REPRO_NEG_INF ? REPRO_NEG_INF : m[hr] * ln_scale) + logf(lr);
        bf16* orow = p.o + w.b * p.os[0] + (int64_t)row * p.os[1] + w.h * p.os[2];
#pragma unroll
        for (int j = 0; j < NO; ++j) {
            const int d = 8 * j + kq;
            if (d < p.dh)
                *reinterpret_cast<__nv_bfloat162*>(orow + d) =
                    __floats2bfloat162_rn(o[j][2 * hr] / lr, o[j][2 * hr + 1] / lr);
        }
    }
    // warpgroup 1's last turn passes to nobody: warpgroup 0 takes it here
    if (TURNS && n > 0 && wgi == 0) named_sync(SCHED, 256);
}

// See the note at the top.  Thread 0 sets up the barriers; then the last
// warpgroup's registers go to the consumers and its first thread produces.
template <int DHP, int NWG>
__global__ void __launch_bounds__(Cfg<DHP, NWG>::THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, const Params p) {
    using C = Cfg<DHP, NWG>;
    extern __shared__ uint8_t smem_fa[];
    const uint32_t base = (smem_addr(smem_fa) + 1023) & ~1023u;
    if (threadIdx.x == 0) {
        mbar_init(base + C::BAR, 1);
#pragma unroll
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(base + C::BAR + 8 + 8 * s, 1);
            mbar_init(base + C::BAR + 8 * (1 + STAGES + s), 128 * NWG);
        }
        fence_barrier_init();
    }
    __syncthreads();
    if (threadIdx.x >= 128 * NWG) {
        setmaxnreg_dec<C::PRODUCER_REGS>();
        if (threadIdx.x == 128 * NWG) {
            // the block's work worked out after the split, so that nothing
            // but the barriers is live across `setmaxnreg`
            const Work w = block_work<DHP, NWG>(p, blockIdx.x);
            if (w.n_tiles > 0) produce<DHP, NWG>(&map_q, &map_k, &map_v, p, w, base);
        }
        return;
    }
    if constexpr (C::CONSUMER_REGS > C::LAUNCH_REGS) setmaxnreg_inc<C::CONSUMER_REGS>();
    consume<DHP, NWG>(p, block_work<DHP, NWG>(p, blockIdx.x), base);
}

template <int DHP, int NWG>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                   int B, int Sq, int Sk, int H, int KV, int dh, const int64_t* st,
                   float scale, int causal, int window, int q_offset, cudaStream_t stream) {
    using C = Cfg<DHP, NWG>;
    CUtensorMap mq{}, mk{}, mv{};
    if (!make_map_bf16(&mq, q, B, Sq, H, dh, st[0], st[1], st[2], C::BQ))
        return cudaErrorInvalidValue;
    if (Sk > 0 && (!make_map_bf16(&mk, k, B, Sk, KV, dh, st[3], st[4], st[5], C::BK) ||
                   !make_map_bf16(&mv, v, B, Sk, KV, dh, st[6], st[7], st[8], C::BK)))
        return cudaErrorInvalidValue;
    const Params p{B, Sq, Sk, H, KV, dh, scale, scale * 1.4426950408889634f, causal, window,
                   q_offset, o, lse, {st[9], st[10], st[11]}};
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DHP, NWG>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    const unsigned blocks = (unsigned)((Sq + C::BQ - 1) / C::BQ) * H * B;
    flash_fwd_kernel<DHP, NWG><<<blocks, C::THREADS, C::SMEM, stream>>>(mq, mk, mv, p);
    return cudaGetLastError();
}

template <int DHP>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                   int B, int Sq, int Sk, int H, int KV, int dh, const int64_t* st,
                   float scale, int causal, int window, int q_offset, cudaStream_t stream) {
    if (consumer_groups(B, Sq, H) == 1)
        return launch<DHP, 1>(q, k, v, o, lse, B, Sq, Sk, H, KV, dh, st, scale, causal, window,
                              q_offset, stream);
    return launch<DHP, 2>(q, k, v, o, lse, B, Sq, Sk, H, KV, dh, st, scale, causal, window,
                          q_offset, stream);
}

// f(Cfg<DHP, NWG>{}) at head dim dh and nwg consumer warpgroups; 0 where no
// kernel takes them
template <typename F>
int with_cfg(int dh, int nwg, F f) {
    if (nwg != 1 && nwg != 2) return 0;
    switch (head_dim_tile(dh)) {
        case 64: return nwg == 1 ? f(Cfg<64, 1>{}) : f(Cfg<64, 2>{});
        case 128: return nwg == 1 ? f(Cfg<128, 1>{}) : f(Cfg<128, 2>{});
        case 256: return nwg == 1 ? f(Cfg<256, 1>{}) : f(Cfg<256, 2>{});
        default: return 0;
    }
}

}  // namespace wg

}  // namespace

// Keys per KV tile of the kernel for dtype (0 = f32, 1 = bf16) at head dim
// dh (0 where no kernel takes dh).
extern "C" int repro_flash_attention_kv_tile(int dtype, int dh) {
    if (!head_dim_tile(dh)) return 0;
    if (dtype != REPRO_BF16) return simt::BK;
    return wg::with_cfg(dh, 2, [](auto c) { return decltype(c)::BK; });
}

// Query rows per block of the kernel for dtype (0 = f32, 1 = bf16) at head
// dim dh and the grid of a call's B, Sq and H: in bf16 128, or 64 where a
// grid of 64-row blocks fits one wave of the card's SMs (0 where no kernel
// takes dh).
extern "C" int repro_flash_attention_q_tile(int dtype, int dh, int B, int Sq, int H) {
    if (!head_dim_tile(dh)) return 0;
    if (dtype != REPRO_BF16) return simt::BQ;
    return wg::ROWS * wg::consumer_groups(B, Sq, H);
}

// Dynamic shared memory of one block for dtype at head dim dh, in bf16 of a
// block of q_rows (64 or 128) rows, in bytes (0 where no kernel takes them).
extern "C" int repro_flash_attention_smem_bytes(int dtype, int dh, int q_rows) {
    if (dtype != REPRO_BF16) {
        switch (head_dim_tile(dh)) {
            case 64: return simt::smem_floats<64>() * (int)sizeof(float);
            case 128: return simt::smem_floats<128>() * (int)sizeof(float);
            case 256: return simt::smem_floats<256>() * (int)sizeof(float);
            default: return 0;
        }
    }
    if (q_rows % wg::ROWS) return 0;
    return wg::with_cfg(dh, q_rows / wg::ROWS, [](auto c) { return decltype(c)::SMEM; });
}

// The bf16 kernel's plan at head dim dh with blocks of q_rows (64 or 128)
// rows: registers a thread at launch (role 0, what ptxas must report), of the
// producer warpgroup (1) and of each consumer warpgroup (2) after
// `setmaxnreg`; threads a block (3).  0 where no kernel takes them.
extern "C" int repro_flash_attention_regs(int dh, int q_rows, int role) {
    if (q_rows % wg::ROWS) return 0;
    return wg::with_cfg(dh, q_rows / wg::ROWS, [role](auto c) {
        using C = decltype(c);
        const int v[4] = {C::LAUNCH_REGS, C::PRODUCER_REGS, C::CONSUMER_REGS, C::THREADS};
        return role >= 0 && role < 4 ? v[role] : 0;
    });
}

// q [B,Sq,H,dh], k/v [B,Sk,KV,dh], o [B,Sq,H,dh]; lse [B,H,Sq] f32, contiguous,
// or null: where given, each row's log-sum-exp m + log(max(l, 1e-30)) of its
// scaled, masked scores (the backward's input); strides in elements as
// (batch, seq, head) for q, k, v, o in that order; the head dim is unit-stride.
// dtype: 0 = f32, 1 = bf16.  Every row starts on a 16-byte boundary, and in
// bf16 dh is a multiple of 8; dh is at most 256.  window <= 0 means no window.
// device is the CUDA ordinal the tensors and the stream belong to.  Returns
// cudaError_t.
extern "C" int repro_flash_attention_fwd(
        const void* q, const void* k, const void* v, void* o, float* lse, int dtype,
        int B, int Sq, int Sk, int H, int KV, int dh,
        int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
        int64_t vsb, int64_t vss, int64_t vsh, int64_t osb, int64_t oss, int64_t osh,
        float scale, int causal, int window, int q_offset, int device, void* stream) {
    const int64_t st[12] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dh <= 0 || dh > REPRO_MAX_HEAD_DIM || dh % 4 || H % KV) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);  // this library's runtime keeps its own
    if (err != cudaSuccess) return (int)err;
    if (Sq <= 0 || B <= 0) return (int)cudaSuccess;
    if (dtype == REPRO_F32) {
        const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
                    *fv = static_cast<const float*>(v);
        float* fo = static_cast<float*>(o);
        switch (head_dim_tile(dh)) {
            case 64: return simt::launch<64>(fq, fk, fv, fo, lse, B, Sq, Sk, H, KV, dh, st, scale,
                                             causal, window, q_offset, s);
            case 128: return simt::launch<128>(fq, fk, fv, fo, lse, B, Sq, Sk, H, KV, dh, st,
                                               scale, causal, window, q_offset, s);
            default: return simt::launch<256>(fq, fk, fv, fo, lse, B, Sq, Sk, H, KV, dh, st,
                                              scale, causal, window, q_offset, s);
        }
    }
    if (dtype == REPRO_BF16) {
        if (dh % 8) return (int)cudaErrorInvalidValue;
        using wg::bf16;
        const bf16 *bq = static_cast<const bf16*>(q), *bk = static_cast<const bf16*>(k),
                   *bv = static_cast<const bf16*>(v);
        bf16* bo = static_cast<bf16*>(o);
        switch (head_dim_tile(dh)) {
            case 64: return wg::launch<64>(bq, bk, bv, bo, lse, B, Sq, Sk, H, KV, dh, st, scale,
                                           causal, window, q_offset, s);
            case 128: return wg::launch<128>(bq, bk, bv, bo, lse, B, Sq, Sk, H, KV, dh, st, scale,
                                             causal, window, q_offset, s);
            default: return wg::launch<256>(bq, bk, bv, bo, lse, B, Sq, Sk, H, KV, dh, st, scale,
                                            causal, window, q_offset, s);
        }
    }
    return (int)cudaErrorInvalidValue;
}
