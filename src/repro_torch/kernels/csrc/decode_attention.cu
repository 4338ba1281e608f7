// Flash-decode for Hopper (sm_90a): one query token against a KV cache,
// split over the cache (flash-decoding's split-K) and merged in a second pass.
//
// Replaces the TPU kernel `_decode_kernel` in
// src/repro/kernels/decode_attention.py (launched by `_decode_fwd`).  Same
// function as the plain version `repro_torch.kernels.ref.decode_attention`:
// the [rep, dh] bundle of query heads that share one kv head is scored
// against the cache under the [B, C] validity mask, softmax in f32, l
// clamped at 1e-30.
//
// What bounds it on an H100: every cache byte is used for one
// multiply-add per query head of the bundle (rep = 4 for llama3-8b), i.e.
// ~4 FLOP per bf16 element, far below the ~295 FLOP/B ridge: it is bound by
// reading K and V from HBM (B=8, C=4096, KV=8, dh=128: ~134 MB, ~0.04 ms at
// 3.35 TB/s).  What the bf16 design (`tma::`) does about the bytes:
//  * one block per (split, kv head, batch); the split is chosen from the
//    shape (`tma::plan`) so that the grid is one wave of BLOCKS_PER_SM
//    blocks on each of an H100's 132 SMs: paligemma-3b's one kv head at B=8
//    takes 16 splits where B*KV = 128 (gemma, seamless) takes one;
//  * one producer warp reads each tile's mask bytes (a tile is TK slots,
//    32 KB of K and V: 32 slots at dh 256, 64 at 128, 128 at 64), and its
//    first lane puts the tile's K and V into a ring of STAGES stages in
//    shared memory by TMA (4-D tensor maps with the caller's strides,
//    128-byte swizzle; columns past dh and slots past C read as zeros),
//    behind full and empty mbarriers; a tile with no valid slot is not
//    read: its stage is marked full with no bytes, its mask words zero;
//  * NCW consumer warps take the tiles in turn, each owning STAGES / NCW
//    stages of the ring, so that 128 KB of K and V stay in flight on an SM;
//    each reads every K/V tile once for the whole bundle: warps of HG head
//    groups of 8 heads (HG = 2 above rep 8) read the same stage;
//  * every product is on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//    accumulate): S^T = K Q^T with the tile's slots as M and the group's 8
//    heads as N (Q^T in registers, K by ldmatrix), then O^T += V^T P^T with
//    the head dim as M (V^T by ldmatrix.trans), P^T taken from S^T's
//    accumulator by movmatrix.  P is split into bf16 hi + lo (P rounded
//    once to bf16 would be off by ~2^-9 of each weight, far past one ulp of
//    the output), and each tile's P.V is summed in a fresh accumulator
//    before an f32 add to O;
//  * each warp keeps its own online softmax (m, l, O) over its tiles; the
//    block's warps merge in shared memory (the ring, free by then) in a
//    fixed order and write unnormalised (acc, m, l) partials in f32, or,
//    where one split takes the whole cache, the outputs themselves.
// The combine pass merges the splits of each head with the split-K rescale
// in a fixed order (no atomics: a launch gives the same bits every run);
// its 512 threads take the splits in 8 groups with every load of a group
// independent of the merge before it.  A split with no valid slot
// contributes (acc, m, l) = (0, NEG_INF, 0); if no slot at all is valid the
// output is 0.
//
// The f32 path (`simt::`) runs on the CUDA cores: K and V straight into
// registers, one 64-slot tile a warp, 256-slot splits, then the same
// combine pass.
//
// With residuals (`lse`, `o32` set in `repro_decode_attention_fwd`, as the
// autograd forward runs it) the combine pass also writes each head's
// log-sum-exp m + log l and its output in f32 before the rounding to the
// input type: the decode backward's P and delta = do . o come from them.
// The rounded output is the same either way.
//
// The stats variant (`repro_decode_attention_stats`) runs the same pass 1
// and a combine pass that writes the merged (acc [B,KV,R,dh], m, l [B,KV,R])
// in f32 without dividing acc by l: the partials of one shard of a cache
// that context-parallel decode merges over the rails (the plain version's
// `return_stats=True`).  A shard with no valid slot gives (0, NEG_INF, 0),
// whose weight exp(NEG_INF - m_global) is 0 in any merge with a valid slot.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// Where the merged splits go: the normalised output (out, its batch and head
// strides) and, where lse is set, the residuals (lse, o32); or, where acc is
// set, the merged stats (acc, m, l).
struct Outputs {
    void* out;
    int64_t osb, osh;
    float *lse, *o32;
    float *acc, *m, *l;
};

// Element d of head h = g * rep + r of batch b (row = b * H + h, the same
// as (b * KV + g) * rep + r) from its merged (a, m, l): stats acc[row, d] = a
// (and m[row], l[row] at d = 0); else out[b, 0, h, d] = a / max(l, 1e-30),
// and where lse is set o32[row, d] the same in f32 and lse[row] = m + log
// max(l, 1e-30) (at d = 0).
template <typename T>
__device__ __forceinline__ void finish(const Outputs& o, int b, int h, int64_t row, int dh,
                                       int d, float a, float m, float l) {
    if (o.acc != nullptr) {
        o.acc[row * dh + d] = a;
        if (d == 0) {
            o.m[row] = m;
            o.l[row] = l;
        }
        return;
    }
    const float lc = fmaxf(l, 1e-30f), out = a / lc;
    store1(static_cast<T*>(o.out) + b * o.osb + h * o.osh + d, out);
    if (o.lse != nullptr) {
        o.o32[row * dh + d] = out;
        if (d == 0) o.lse[row] = m + logf(lc);
    }
}

namespace simt {

constexpr int SPLIT = 256;        // cache slots per block of pass 1
constexpr int TK = 64;            // slots per warp tile (mask granularity)
constexpr int NW = SPLIT / TK;    // warps per block
constexpr int NT = 32 * NW;
constexpr int MAXR = 8;           // query heads per block

// 16 bytes of a row, loaded raw and widened to f32 where they are used
__device__ __forceinline__ uint4 load16(const void* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
}

// x[at ..] = the 4 f32 elements of u
template <int N>
__device__ __forceinline__ void widen(const uint4& u, float (&x)[N], int at, float) {
    x[at] = __uint_as_float(u.x);
    x[at + 1] = __uint_as_float(u.y);
    x[at + 2] = __uint_as_float(u.z);
    x[at + 3] = __uint_as_float(u.w);
}

template <typename T>
__host__ __device__ constexpr int elems16() { return 16 / (int)sizeof(T); }

// 16-byte loads of one cache row a lane makes: 1, or 2 in f32 at dh 256
// (64 lanes' worth of a row)
template <typename T, int DHP>
__host__ __device__ constexpr int row_chunks() {
    return DHP / elems16<T>() > 32 ? DHP / elems16<T>() / 32 : 1;
}
// blocks an SM the registers are sized for: four (128 registers a thread)
// where a lane's rows of the R heads fit, else two (255; at dh 256 from
// R = 4, where 128 spill), and one at R = 8
template <typename T, int DHP, int R>
__host__ __device__ constexpr int min_blocks() {
    return R >= 8 ? 1 : row_chunks<T, DHP>() > 1 || (R >= 4 && DHP > 128) ? 2 : 4;
}
// row loads of K (and of V) in flight per lane
template <typename T, int DHP, int R>
__host__ __device__ constexpr int loads_in_flight() {
    return R >= 8 || row_chunks<T, DHP>() > 1 ? 2 : 4;
}

// R query heads of one kv head over the slots [split * SPLIT, + SPLIT)
template <typename T, int DHP, int R>
__global__ void __launch_bounds__(NT, (min_blocks<T, DHP, R>()))
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, const uint8_t* __restrict__ valid,
                      float* __restrict__ acc_out, float* __restrict__ m_out,
                      float* __restrict__ l_out, int C, int KV, int rep, int dh, int nsplit,
                      int64_t qsb, int64_t qsh, int64_t ksb, int64_t ksc, int64_t ksh,
                      int64_t vsb, int64_t vsc, int64_t vsh, int64_t msb, int64_t msc,
                      float scale) {
    constexpr int E = elems16<T>();      // elements per lane load
    constexpr int CH = row_chunks<T, DHP>();  // 16-byte loads of a row per lane
    constexpr int LPR = DHP / (E * CH);  // lanes per cache row
    constexpr int CE = CH * E;           // a lane's elements of a row
    constexpr int RPW = 32 / LPR;        // rows per warp load
    constexpr int U = loads_in_flight<T, DHP, R>();  // row loads of K (and of V) per lane
    constexpr int BATCH = U * RPW;       // rows per online-softmax step of a warp
    static_assert(TK % BATCH == 0, "whole batches per tile");
    __shared__ float Wm[NW][R], Wl[NW][R];
    __shared__ float Wacc[NW][R][DHP];

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int split = blockIdx.x, b = blockIdx.z;
    const int ngrp = (rep + R - 1) / R;
    const int g = blockIdx.y / ngrp, h0 = (blockIdx.y % ngrp) * R;  // kv head, first q head
    const int nr = min(R, rep - h0);
    // this lane's row of a warp load, and its columns: E from col + c * LPR * E, c < CH
    const int col = (lane % LPR) * E, rsub = lane / LPR;
    bool col_ok[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) col_ok[c] = col + c * LPR * E < dh;
    const T* kb = kc + b * ksb + g * ksh + col;
    const T* vb = vc + b * vsb + g * vsh + col;
    const uint8_t* mb = valid + b * msb;

    float qr[R][CE], m[R], l[R], acc[R][CE];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        m[r] = REPRO_NEG_INF;
        l[r] = 0.f;
#pragma unroll
        for (int e = 0; e < CE; ++e) qr[r][e] = acc[r][e] = 0.f;
#pragma unroll
        for (int c = 0; c < CH; ++c)
            if (r < nr && col_ok[c])
                widen(load16(q + b * qsb + (g * rep + h0 + r) * qsh + col + c * LPR * E), qr[r],
                      c * E, T());
    }

    const int t0 = split * SPLIT + warp * TK;  // this warp's tile
    uint64_t tmask = 0;                        // bit i: slot t0 + i is valid
    if (t0 < C) {
        const bool v0 = t0 + lane < C && mb[(t0 + lane) * msc] != 0;
        const bool v1 = t0 + 32 + lane < C && mb[(t0 + 32 + lane) * msc] != 0;
        tmask = __ballot_sync(0xffffffffu, v0) |
                ((uint64_t)__ballot_sync(0xffffffffu, v1) << 32);
    }

    for (int i0 = 0; tmask != 0 && i0 < TK; i0 += BATCH) {
        uint4 kraw[U][CH], vraw[U][CH];
        bool ok[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int i = i0 + u * RPW + rsub;
            ok[u] = (tmask >> i) & 1;  // also false past C
#pragma unroll
            for (int c = 0; c < CH; ++c) {
                kraw[u][c] = vraw[u][c] = make_uint4(0u, 0u, 0u, 0u);  // zero in either type
                if (ok[u] && col_ok[c]) {
                    kraw[u][c] = load16(kb + (int64_t)(t0 + i) * ksc + c * LPR * E);
                    vraw[u][c] = load16(vb + (int64_t)(t0 + i) * vsc + c * LPR * E);
                }
            }
        }
        float s[U][R];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            float kf[CE];
#pragma unroll
            for (int c = 0; c < CH; ++c)
                widen(kraw[u][c], kf, c * E, T());
#pragma unroll
            for (int r = 0; r < R; ++r) {
                float d = 0.f;
#pragma unroll
                for (int e = 0; e < CE; ++e) d = fmaf(qr[r][e], kf[e], d);
                s[u][r] = d;
            }
        }
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)  // over the lanes of a row
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
                for (int r = 0; r < R; ++r) s[u][r] += __shfl_xor_sync(0xffffffffu, s[u][r], off);
        float p[U][R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            float mx = REPRO_NEG_INF;
#pragma unroll
            for (int u = 0; u < U; ++u) {
                s[u][r] = ok[u] ? s[u][r] * scale : REPRO_NEG_INF;
                mx = fmaxf(mx, s[u][r]);
            }
#pragma unroll
            for (int off = LPR; off < 32; off <<= 1)  // over the rows of a warp load
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[r], mx);
            const float alpha = expf(m[r] - m_new);
            m[r] = m_new;
            l[r] *= alpha;
#pragma unroll
            for (int e = 0; e < CE; ++e) acc[r][e] *= alpha;
#pragma unroll
            for (int u = 0; u < U; ++u) {
                p[u][r] = expf(s[u][r] - m_new);
                l[r] += p[u][r];
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            float vf[CE];
#pragma unroll
            for (int c = 0; c < CH; ++c)
                widen(vraw[u][c], vf, c * E, T());
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
                for (int e = 0; e < CE; ++e) acc[r][e] = fmaf(p[u][r], vf[e], acc[r][e]);
        }
    }

    // the warp's rows of each load into one (m is already the warp's)
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
        for (int r = 0; r < R; ++r) {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
#pragma unroll
            for (int e = 0; e < CE; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], off);
        }
    if (lane < LPR) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
            for (int e = 0; e < CE; ++e) Wacc[warp][r][col + (e / E) * LPR * E + e % E] = acc[r][e];
    }
    if (lane == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
            Wm[warp][r] = m[r];
            Wl[warp][r] = l[r];
        }
    }
    __syncthreads();

    // merge the warps: the block's (acc, m, l) for each head of the bundle
    const int64_t part = ((int64_t)(b * KV + g) * nsplit + split) * rep + h0;
    for (int i = tid; i < nr * dh; i += NT) {
        const int r = i / dh, d = i % dh;
        float mg = REPRO_NEG_INF;
#pragma unroll
        for (int w = 0; w < NW; ++w) mg = fmaxf(mg, Wm[w][r]);
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) a += Wacc[w][r][d] * expf(Wm[w][r] - mg);
        acc_out[(part + r) * dh + d] = a;
        if (d == 0) {
            float ls = 0.f;
#pragma unroll
            for (int w = 0; w < NW; ++w) ls += Wl[w][r] * expf(Wm[w][r] - mg);
            m_out[part + r] = mg;
            l_out[part + r] = ls;
        }
    }
}

// query heads per pass-1 block for a bundle of rep: 2, 4 or 8 (rep 1, as
// gemma-7b's 16 heads on 16 kv heads, runs the 2-head kernel with one head
// live)
int heads_per_block(int rep) {
    int r = 2;
    while (r < rep && r < MAXR) r *= 2;
    return r;
}

template <int DHP, int R>
cudaError_t launch_r(const void* q, const void* kc, const void* vc, const void* valid,
                     float* acc_p, float* m_p, float* l_p, int B, int C, int H, int KV, int dh,
                     const int64_t* st, float scale, cudaStream_t stream) {
    const int rep = H / KV;
    const int nsplit = (C + SPLIT - 1) / SPLIT;
    const int ngrp = (rep + R - 1) / R;
    decode_partial_kernel<float, DHP, R><<<dim3(nsplit, KV * ngrp, B), NT, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(kc),
        static_cast<const float*>(vc), static_cast<const uint8_t*>(valid), acc_p, m_p, l_p, C,
        KV, rep, dh, nsplit, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        st[9], scale);
    return cudaGetLastError();
}

template <int DHP>
cudaError_t launch(const void* q, const void* kc, const void* vc, const void* valid,
                   float* acc_p, float* m_p, float* l_p, int B, int C, int H, int KV, int dh,
                   const int64_t* st, float scale, cudaStream_t stream) {
    switch (heads_per_block(H / KV)) {
        case 2: return launch_r<DHP, 2>(q, kc, vc, valid, acc_p, m_p, l_p, B, C, H, KV, dh, st,
                                        scale, stream);
        case 4: return launch_r<DHP, 4>(q, kc, vc, valid, acc_p, m_p, l_p, B, C, H, KV, dh, st,
                                        scale, stream);
        default: return launch_r<DHP, 8>(q, kc, vc, valid, acc_p, m_p, l_p, B, C, H, KV, dh, st,
                                         scale, stream);
    }
}

}  // namespace simt

namespace tma {

using bf16 = __nv_bfloat16;
constexpr int SMS = 132;          // an H100 SXM's SMs (tests/test_torch_kernels.py mirrors it)
constexpr int STAGE_BYTES = 32768;  // K and V of one tile
constexpr int NCW = 4;            // consumer warps of a head group: warp w takes tiles w, w + NCW..
constexpr int STAGES = 4;         // ring stages, STAGES / NCW owned by each consumer warp
constexpr int GROUP = 8;          // heads of a head group: mma.sync's N
constexpr int MERGE = 1;          // named barrier of the consumer warps
static_assert(STAGES % NCW == 0, "a consumer warp owns whole stages");

// Slots of a tile at head-dim tile DHP: 32 KB of K and V (32 at 256, 64 at
// 128, 128 at 64).
template <int DHP>
__host__ __device__ constexpr int tile_slots() { return STAGE_BYTES / (4 * DHP); }

// A block of HG head groups at head-dim tile DHP: NCW * HG consumer warps
// and the producer warp (the last).  Shared memory, offsets from a
// 1024-aligned base: STAGES pairs of K and V tiles [DHP / 64 panels][TK
// slots] (the merge's f32 (m, l, O) of every consumer warp reuses them once
// the ring has drained), each stage's mask words, the full and empty
// mbarriers.
template <int DHP, int HG>
struct Cfg {
    static constexpr int TK = tile_slots<DHP>();
    static_assert(TK % 32 == 0 && TK <= 256, "whole mask words, a TMA box of at most 256 rows");
    static constexpr int WORDS = TK / 32;             // mask words of a tile
    static constexpr int MT = TK / 16;                // 16-slot m-tiles of S^T
    static constexpr int KS = DHP / 16;               // 16-column k-steps of S^T, m-tiles of O^T
    static constexpr int CONSUMERS = 32 * NCW * HG;
    static constexpr int THREADS = CONSUMERS + 32;
    static constexpr int PANEL = TK * 128;            // bytes of a 64-column panel of a tile
    static constexpr int TILE = TK * DHP * 2;         // bytes of a K (or V) tile
    static_assert(2 * TILE == STAGE_BYTES, "a stage is one tile of K and one of V");
    static constexpr int LDW = DHP + 4;               // row stride of the merge's O, in floats
    static constexpr int MERGE_BYTES = NCW * HG * GROUP * (LDW + 2) * 4;
    static_assert(MERGE_BYTES <= STAGES * STAGE_BYTES, "the merge fits the drained ring");
    static constexpr int MASK = STAGES * STAGE_BYTES;
    static constexpr int BAR = MASK + (STAGES * WORDS * 4 + 7) / 8 * 8;
    static constexpr int SMEM = BAR + 16 * STAGES + 1024;  // + the base's alignment
    // blocks an SM's 228 KB of shared memory hold (1 KB of it reserved a block)
    static constexpr int BLOCKS_PER_SM = 233472 / (SMEM + 1024);
    static_assert(BLOCKS_PER_SM >= 1, "a block fits an SM");
};

struct Params {
    const bf16* q;
    const uint8_t* valid;
    float *acc_p, *m_p, *l_p;  // the partials, where nsplit > 1
    Outputs o;                 // written directly where nsplit = 1
    int C, KV, rep, dh, nsplit, tiles;  // tiles: a split's
    int64_t qsb, qsh, msb, msc;
    float scale;
};

// The split of a call's shape: `tiles` tiles of `tk` slots a split, `nsplit`
// splits; the grid one wave of BLOCKS_PER_SM blocks on each SM (fewer splits
// where B * KV already fills it; one split where it takes more).
struct Plan {
    int tk, tiles, nsplit;
};

template <int DHP>
Plan plan(int B, int C, int KV) {
    using Cf = Cfg<DHP, 1>;  // a second head group changes neither the tile nor the smem
    static_assert(Cfg<DHP, 2>::BLOCKS_PER_SM == Cf::BLOCKS_PER_SM, "one plan for both");
    const int tiles = (C + Cf::TK - 1) / Cf::TK;
    const int64_t bg = (int64_t)B * KV;
    const int most =
        (int)std::min<int64_t>(tiles, std::max<int64_t>(1, Cf::BLOCKS_PER_SM * SMS / bg));
    const int per = (tiles + most - 1) / most;
    return {Cf::TK, per, (tiles + per - 1) / per};
}

// The plan at head dim dh (all 0 where no kernel takes dh).
inline Plan plan_at(int B, int C, int KV, int dh) {
    switch (head_dim_tile(dh)) {
        case 64: return plan<64>(B, C, KV);
        case 128: return plan<128>(B, C, KV);
        case 256: return plan<256>(B, C, KV);
        default: return {0, 0, 0};
    }
}

// 8 x 8 b16 matrix transposed across the warp (fragment layout in and out)
__device__ __forceinline__ uint32_t movtrans(uint32_t x) {
    uint32_t y;
    asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
    return y;
}

// The producer warp: each tile's mask bytes (read a tile ahead), then its
// first lane waits for the tile's stage to be released, writes the mask
// words there and loads K and V by TMA, or marks a tile with no valid slot
// full with no bytes.
template <int DHP, int HG>
__device__ __forceinline__ void produce(const CUtensorMap* map_k, const CUtensorMap* map_v,
                                        const Params& p, uint32_t base, uint32_t* words,
                                        int t_first, int nt, int g, int b) {
    using Cf = Cfg<DHP, HG>;
    const int lane = threadIdx.x & 31;
    const uint32_t bar_full = base + Cf::BAR, bar_empty = bar_full + 8 * STAGES;
    const uint8_t* mb = p.valid + b * p.msb;
    auto slot_ok = [&](int i, int j) {
        const int c = (t_first + i) * Cf::TK + 32 * j + lane;
        return c < p.C && mb[(int64_t)c * p.msc] != 0;
    };
    bool next[Cf::WORDS];
#pragma unroll
    for (int j = 0; j < Cf::WORDS; ++j) next[j] = slot_ok(0, j);
    for (int i = 0; i < nt; ++i) {
        uint32_t w[Cf::WORDS], any = 0;
#pragma unroll
        for (int j = 0; j < Cf::WORDS; ++j) {
            w[j] = __ballot_sync(0xffffffffu, next[j]);
            any |= w[j];
        }
        if (i + 1 < nt) {
#pragma unroll
            for (int j = 0; j < Cf::WORDS; ++j) next[j] = slot_ok(i + 1, j);
        }
        if (lane == 0) {
            const int s = i % STAGES;
            mbar_wait_or_trap(bar_empty + 8 * s, ((i / STAGES) & 1) ^ 1);
#pragma unroll
            for (int j = 0; j < Cf::WORDS; ++j) words[s * Cf::WORDS + j] = w[j];
            const uint32_t full = bar_full + 8 * s;
            if (any) {
                const uint32_t kst = base + s * STAGE_BYTES;
                const int slot0 = (t_first + i) * Cf::TK;
                mbar_arrive_expect_tx(full, STAGE_BYTES);
#pragma unroll
                for (int pn = 0; pn < DHP / 64; ++pn) {
                    tma_load_4d(kst + pn * Cf::PANEL, map_k, full, 64 * pn, slot0, g, b);
                    tma_load_4d(kst + Cf::TILE + pn * Cf::PANEL, map_v, full, 64 * pn, slot0, g,
                                b);
                }
            } else {
                mbar_arrive(full);
            }
        }
        __syncwarp();
    }
    // the last stages released: a consumer that never got its tiles traps here
    if (lane == 0)
        for (int i = max(0, nt - STAGES); i < nt; ++i)
            mbar_wait_or_trap(bar_empty + 8 * (i % STAGES), (i / STAGES) & 1);
}

// See the note at the top.  Thread 0 sets up the barriers; the last warp
// produces, the others consume.
template <int DHP, int HG>
__global__ void __launch_bounds__(Cfg<DHP, HG>::THREADS, 1)
decode_tma_kernel(const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, const Params p) {
    using Cf = Cfg<DHP, HG>;
    constexpr int TK = Cf::TK, MT = Cf::MT, KS = Cf::KS;
    extern __shared__ uint8_t smem_dec[];
    const uint32_t raw = smem_addr(smem_dec);
    const uint32_t base = (raw + 1023) & ~1023u;
    uint8_t* gbase = smem_dec + (base - raw);  // the same bytes by generic address
    uint32_t* words = reinterpret_cast<uint32_t*>(gbase + Cf::MASK);
    const uint32_t bar_full = base + Cf::BAR, bar_empty = bar_full + 8 * STAGES;
    if (threadIdx.x == 0) {
#pragma unroll
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(bar_full + 8 * s, 1);
            mbar_init(bar_empty + 8 * s, 32 * HG);
        }
        fence_barrier_init();
    }
    __syncthreads();
    const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
    const int t_first = split * p.tiles;
    const int nt = min(p.tiles, (p.C + TK - 1) / TK - t_first);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp == NCW * HG) {
        produce<DHP, HG>(&map_k, &map_v, p, base, words, t_first, nt, g, b);
        return;
    }
    const int sw = warp % NCW, hg = warp / NCW;
    // this thread's heads (n) in S^T and O^T: 2 (lane % 4) and + 1 of the
    // group; its rows (m): lane / 4 and + 8 of each 16
    const int hq = lane >> 2, hc = 2 * (lane & 3);
    // Q^T as the B fragments of each k-step: head hq of the group, columns
    // 16 ks + hc (+ 1) and + 8; zero past dh and for the group's padding heads
    uint32_t qf[KS][2];
    {
        const int r = hg * GROUP + hq;
        const bf16* qrow = p.q + b * p.qsb + (int64_t)(g * p.rep + r) * p.qsh;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int d = 16 * ks + 8 * h + hc;
                qf[ks][h] = r < p.rep && d < p.dh
                                ? *reinterpret_cast<const uint32_t*>(qrow + d) : 0u;
            }
    }
    float o[KS][4];
#pragma unroll
    for (int j = 0; j < KS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, l[2] = {0.f, 0.f};
    // this lane's ldmatrix row and matrix
    const int rr = lane & 7, mi = lane >> 3;

    for (int i = sw; i < nt; i += NCW) {
        const int s = i % STAGES;
        mbar_wait(bar_full + 8 * s, (i / STAGES) & 1);
        uint32_t w[Cf::WORDS], any = 0;
#pragma unroll
        for (int j = 0; j < Cf::WORDS; ++j) {
            w[j] = words[s * Cf::WORDS + j];
            any |= w[j];
        }
        if (any) {
            const uint32_t kst = base + s * STAGE_BYTES, vst = kst + Cf::TILE;
            // S^T = K Q^T: 16 slots by the group's 8 heads an m-tile
            float sc[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int e = 0; e < 4; ++e) sc[mt][e] = 0.f;
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
                if (16 * ks >= p.dh) break;
                const uint32_t panel = kst + (ks / 4) * Cf::PANEL +
                                       ((((2 * (ks % 4) + (mi >> 1)) ^ rr)) << 4);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    uint32_t a[4];
                    ldsm4(a, panel + (16 * mt + rr + 8 * (mi & 1)) * 128);
                    mma_bf16(sc[mt], a, qf[ks][0], qf[ks][1]);
                }
            }
            // the online softmax of the tile's valid slots, per head
            float mx[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int row = 16 * mt + 8 * (e >> 1);  // a multiple of 8: one word
                    const bool ok = (w[row >> 5] >> ((row & 31) + hq)) & 1u;
                    sc[mt][e] = ok ? sc[mt][e] * p.scale : REPRO_NEG_INF;
                    mx[e & 1] = fmaxf(mx[e & 1], sc[mt][e]);
                }
            float alpha[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
                for (int off = 4; off < 32; off <<= 1)
                    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], off));
                const float m_new = fmaxf(m[h], mx[h]);
                alpha[h] = expf(m[h] - m_new);
                m[h] = m_new;
                l[h] *= alpha[h];
            }
            // P = exp(S - m) split into bf16 hi + lo, transposed into the B
            // fragments (16 slots by 8 heads) of each k-step of P.V
            uint32_t phi[MT][2], plo[MT][2];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    sc[mt][e] = expf(sc[mt][e] - m[e & 1]);
                    l[e & 1] += sc[mt][e];
                }
                uint32_t hi, lo;
                split_bf16(sc[mt][0], sc[mt][1], hi, lo);
                phi[mt][0] = movtrans(hi);
                plo[mt][0] = movtrans(lo);
                split_bf16(sc[mt][2], sc[mt][3], hi, lo);
                phi[mt][1] = movtrans(hi);
                plo[mt][1] = movtrans(lo);
            }
            // O^T = alpha O^T + V^T (P_hi + P_lo)^T: 16 columns by 8 heads an
            // m-tile, the tile's sum in a fresh accumulator
#pragma unroll
            for (int dm = 0; dm < KS; ++dm) {
                if (16 * dm >= p.dh) break;
                const uint32_t panel = vst + (dm / 4) * Cf::PANEL +
                                       ((((2 * (dm % 4) + (mi & 1)) ^ rr)) << 4);
                float f[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                for (int kt = 0; kt < MT; ++kt) {
                    uint32_t a[4];
                    ldsm4_trans(a, panel + (16 * kt + rr + 8 * (mi >> 1)) * 128);
                    mma_bf16(f, a, phi[kt][0], phi[kt][1]);
                    mma_bf16(f, a, plo[kt][0], plo[kt][1]);
                }
#pragma unroll
                for (int e = 0; e < 4; ++e) o[dm][e] = fmaf(o[dm][e], alpha[e & 1], f[e]);
            }
        }
        mbar_arrive(bar_empty + 8 * s);
    }

    // the warp's l over its rows; then every consumer warp's (m, l, O) into
    // the drained ring and merged in warp order
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) l[h] += __shfl_xor_sync(0xffffffffu, l[h], off);
    named_sync(MERGE, Cf::CONSUMERS);
    float* wacc = reinterpret_cast<float*>(gbase);           // [warp][GROUP][LDW]
    float* wm = wacc + NCW * HG * GROUP * Cf::LDW;           // [warp][GROUP]
    float* wl = wm + NCW * HG * GROUP;
    if (lane < 4) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            wm[warp * GROUP + hc + h] = m[h];
            wl[warp * GROUP + hc + h] = l[h];
        }
    }
#pragma unroll
    for (int dm = 0; dm < KS; ++dm)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            wacc[(warp * GROUP + hc + (e & 1)) * Cf::LDW + 16 * dm + hq + 8 * (e >> 1)] = o[dm][e];
    named_sync(MERGE, Cf::CONSUMERS);
    const int64_t part = ((int64_t)(b * p.KV + g) * p.nsplit + split) * p.rep;
    for (int i = threadIdx.x; i < p.rep * p.dh; i += Cf::CONSUMERS) {
        const int r = i / p.dh, d = i % p.dh;
        const int w0 = (r / GROUP) * NCW, hr = r % GROUP;
        float mg = REPRO_NEG_INF;
#pragma unroll
        for (int w = 0; w < NCW; ++w) mg = fmaxf(mg, wm[(w0 + w) * GROUP + hr]);
        float a = 0.f, ls = 0.f;
#pragma unroll
        for (int w = 0; w < NCW; ++w) {
            const int x = (w0 + w) * GROUP + hr;
            const float e = expf(wm[x] - mg);
            a += wacc[x * Cf::LDW + d] * e;
            ls += wl[x] * e;
        }
        if (p.nsplit == 1) {
            finish<bf16>(p.o, b, g * p.rep + r, part + r, p.dh, d, a, mg, ls);
        } else {
            p.acc_p[(part + r) * p.dh + d] = a;
            if (d == 0) {
                p.m_p[part + r] = mg;
                p.l_p[part + r] = ls;
            }
        }
    }
}

template <int DHP, int HG>
cudaError_t launch(const void* q, const void* kc, const void* vc, const void* valid,
                   const Outputs& o, float* acc_p, float* m_p, float* l_p, int B, int C, int H,
                   int KV, int dh, const int64_t* st, float scale, cudaStream_t stream) {
    using Cf = Cfg<DHP, HG>;
    CUtensorMap mk{}, mv{};
    if (!make_map_bf16(&mk, kc, B, C, KV, dh, st[2], st[3], st[4], Cf::TK) ||
        !make_map_bf16(&mv, vc, B, C, KV, dh, st[5], st[6], st[7], Cf::TK))
        return cudaErrorInvalidValue;
    const Plan pl = plan<DHP>(B, C, KV);
    const Params p{static_cast<const bf16*>(q), static_cast<const uint8_t*>(valid), acc_p, m_p,
                   l_p, o, C, KV, H / KV, dh, pl.nsplit, pl.tiles, st[0], st[1], st[8], st[9],
                   scale};
    cudaError_t err = cudaFuncSetAttribute(decode_tma_kernel<DHP, HG>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, Cf::SMEM);
    if (err != cudaSuccess) return err;
    decode_tma_kernel<DHP, HG><<<dim3(pl.nsplit, KV, B), Cf::THREADS, Cf::SMEM, stream>>>(
        mk, mv, p);
    return cudaGetLastError();
}

// head groups of a bundle of rep
inline int groups(int rep) { return rep > GROUP ? 2 : 1; }

// f(Cfg<DHP, HG>{}) at head dim dh and a bundle of rep; 0 where no kernel
// takes them
template <typename F>
int with_cfg(int rep, int dh, F f) {
    const bool two = groups(rep) == 2;
    switch (head_dim_tile(dh)) {
        case 64: return two ? f(Cfg<64, 2>{}) : f(Cfg<64, 1>{});
        case 128: return two ? f(Cfg<128, 2>{}) : f(Cfg<128, 1>{});
        case 256: return two ? f(Cfg<256, 2>{}) : f(Cfg<256, 1>{});
        default: return 0;
    }
}

}  // namespace tma

// Threads of a combine block: CP groups of 64, group q merging the splits
// q, q + CP, ... in turn, its lane c the columns c, c + 64, ...; every load
// of a group's splits is independent of the merge before it.
constexpr int CT = 512;
constexpr int CP = CT / 64;

// Head r of kv head g, batch b: the splits' partials merged with the split-K
// rescale in a fixed order (each group's splits in turn, then the groups in
// turn), written by `finish`.
template <typename T>
__global__ void __launch_bounds__(CT)
decode_combine_kernel(const float* __restrict__ acc_p, const float* __restrict__ m_p,
                      const float* __restrict__ l_p, const Outputs o, int rep, int dh,
                      int nsplit) {
    constexpr int NK = REPRO_MAX_HEAD_DIM / 64;
    __shared__ float part[CP][REPRO_MAX_HEAD_DIM], pm[CP], pl[CP];
    const int r = blockIdx.x, g = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
    const int64_t base = (int64_t)(b * gridDim.y + g) * nsplit;
    const int q = tid / 64, c = tid % 64;
    float mq = REPRO_NEG_INF, lq = 0.f, a[NK] = {};
#pragma unroll 4
    for (int s = q; s < nsplit; s += CP) {
        const int64_t i = (base + s) * rep + r;
        const float ms = m_p[i], ls = l_p[i];
        float x[NK];
#pragma unroll
        for (int k = 0; k < NK; ++k) x[k] = c + 64 * k < dh ? acc_p[i * dh + c + 64 * k] : 0.f;
        const float mn = fmaxf(mq, ms), wa = expf(mq - mn), ws = expf(ms - mn);
        lq = lq * wa + ls * ws;
#pragma unroll
        for (int k = 0; k < NK; ++k) a[k] = a[k] * wa + x[k] * ws;
        mq = mn;
    }
    if (c == 0) {
        pm[q] = mq;
        pl[q] = lq;
    }
#pragma unroll
    for (int k = 0; k < NK; ++k)
        if (c + 64 * k < dh) part[q][c + 64 * k] = a[k];
    __syncthreads();
    float mg = REPRO_NEG_INF, l = 0.f, w[CP];
#pragma unroll
    for (int k = 0; k < CP; ++k) mg = fmaxf(mg, pm[k]);
#pragma unroll
    for (int k = 0; k < CP; ++k) {
        w[k] = expf(pm[k] - mg);
        l += pl[k] * w[k];
    }
    const int64_t row = (int64_t)(b * gridDim.y + g) * rep + r;
    for (int d = tid; d < dh; d += CT) {
        float t = 0.f;
#pragma unroll
        for (int k = 0; k < CP; ++k) t += part[k][d] * w[k];
        finish<T>(o, b, g * rep + r, row, dh, d, t, mg, l);
    }
}

// (slots a split, splits) of pass 1 at a call's shape
void split_of(int dtype, int B, int C, int KV, int dh, int& slots, int& nsplit) {
    if (dtype == REPRO_F32) {
        slots = simt::SPLIT;
        nsplit = (C + slots - 1) / slots;
        return;
    }
    const tma::Plan p = tma::plan_at(B, C, KV, dh);
    slots = p.tiles * p.tk;
    nsplit = p.nsplit;
}

// Checks the shapes, then runs both passes for the dtype and head-dim tile.
cudaError_t run(const void* q, const void* kc, const void* vc, const void* valid,
                const Outputs& o, void* acc_p, void* m_p, void* l_p, int dtype, int B, int C,
                int H, int KV, int dh, const int64_t* st, float scale, int device,
                cudaStream_t s) {
    if (dh <= 0 || dh > REPRO_MAX_HEAD_DIM || dh % 4 || KV <= 0 || H % KV ||
        H / KV > 2 * simt::MAXR || C <= 0 || (dtype == REPRO_BF16 && dh % 8) ||
        (dtype != REPRO_F32 && dtype != REPRO_BF16))
        return cudaErrorInvalidValue;
    if (B <= 0) return cudaSuccess;
    cudaError_t err = cudaSetDevice(device);  // this library's runtime keeps its own
    if (err != cudaSuccess) return err;
    float* a = static_cast<float*>(acc_p);
    float* m = static_cast<float*>(m_p);
    float* l = static_cast<float*>(l_p);
    const int rep = H / KV;
    if (dtype == REPRO_F32) {
        switch (head_dim_tile(dh)) {
            case 64: err = simt::launch<64>(q, kc, vc, valid, a, m, l, B, C, H, KV, dh, st, scale,
                                            s); break;
            case 128: err = simt::launch<128>(q, kc, vc, valid, a, m, l, B, C, H, KV, dh, st,
                                              scale, s); break;
            default: err = simt::launch<256>(q, kc, vc, valid, a, m, l, B, C, H, KV, dh, st,
                                             scale, s); break;
        }
    } else {
        const bool two = tma::groups(rep) == 2;
        switch (head_dim_tile(dh)) {
            case 64: err = two ? tma::launch<64, 2>(q, kc, vc, valid, o, a, m, l, B, C, H, KV,
                                                    dh, st, scale, s)
                               : tma::launch<64, 1>(q, kc, vc, valid, o, a, m, l, B, C, H, KV,
                                                    dh, st, scale, s); break;
            case 128: err = two ? tma::launch<128, 2>(q, kc, vc, valid, o, a, m, l, B, C, H, KV,
                                                      dh, st, scale, s)
                                : tma::launch<128, 1>(q, kc, vc, valid, o, a, m, l, B, C, H, KV,
                                                      dh, st, scale, s); break;
            default: err = two ? tma::launch<256, 2>(q, kc, vc, valid, o, a, m, l, B, C, H, KV,
                                                     dh, st, scale, s)
                               : tma::launch<256, 1>(q, kc, vc, valid, o, a, m, l, B, C, H, KV,
                                                     dh, st, scale, s); break;
        }
    }
    if (err != cudaSuccess) return err;
    int slots, nsplit;
    split_of(dtype, B, C, KV, dh, slots, nsplit);
    if (dtype == REPRO_F32)
        decode_combine_kernel<float><<<dim3(rep, KV, B), CT, 0, s>>>(a, m, l, o, rep, dh,
                                                                      nsplit);
    else if (nsplit > 1)  // one split: pass 1 wrote the outputs
        decode_combine_kernel<__nv_bfloat16><<<dim3(rep, KV, B), CT, 0, s>>>(a, m, l, o, rep,
                                                                              dh, nsplit);
    return cudaGetLastError();
}

}  // namespace

// Splits of pass 1 (the partials' nsplit) for dtype (0 = f32, 1 = bf16) at a
// call's shape; 0 where no kernel takes it.
extern "C" int repro_decode_num_splits(int dtype, int B, int C, int H, int KV, int dh) {
    int slots = 0, nsplit = 0;
    if (B > 0 && C > 0 && KV > 0 && head_dim_tile(dh)) split_of(dtype, B, C, KV, dh, slots, nsplit);
    return nsplit;
}

// Cache slots per split (one pass-1 block) at the same shape.
extern "C" int repro_decode_split(int dtype, int B, int C, int H, int KV, int dh) {
    int slots = 0, nsplit = 0;
    if (B > 0 && C > 0 && KV > 0 && head_dim_tile(dh)) split_of(dtype, B, C, KV, dh, slots, nsplit);
    return slots;
}

// Most query heads per kv head the kernel takes.
extern "C" int repro_decode_max_rep() { return 2 * simt::MAXR; }

// The pass-1 kernel's plan for dtype at a bundle of rep and head dim dh:
// slots of a tile (role 0: the mask's and, in bf16, TMA's granularity),
// ring stages (1: 0 in f32, which loads to registers), threads a block (2),
// shared memory of a block in bytes (3: f32 static, bf16 dynamic), blocks an
// SM the shared memory holds (4: the bf16 plan's wave).  0 where no kernel
// takes them.
extern "C" int repro_decode_plan(int dtype, int rep, int dh, int role) {
    if (rep <= 0 || rep > 2 * simt::MAXR || !head_dim_tile(dh)) return 0;
    if (dtype == REPRO_F32) {
        const int r = simt::heads_per_block(rep);
        const int v[5] = {simt::TK, 0, simt::NT,
                          simt::NW * r * (head_dim_tile(dh) + 2) * (int)sizeof(float), 0};
        return role >= 0 && role < 5 ? v[role] : 0;
    }
    if (dtype != REPRO_BF16) return 0;
    return tma::with_cfg(rep, dh, [role](auto c) {
        using Cf = decltype(c);
        const int v[5] = {Cf::TK, tma::STAGES, Cf::THREADS, Cf::SMEM, Cf::BLOCKS_PER_SM};
        return role >= 0 && role < 5 ? v[role] : 0;
    });
}

// q [B,1,H,dh]; k/v cache [B,C,KV,dh]; valid [B,C] uint8; out [B,1,H,dh].
// Strides in elements: q (batch, head), k and v (batch, slot, head), valid
// (batch, slot), out (batch, head); the head dim is unit-stride and every
// row starts on a 16-byte boundary; dh is a multiple of 8 (bf16) or 4
// (f32), at most 256.  acc_p [B,KV,nsplit,rep,dh], m_p and l_p
// [B,KV,nsplit,rep] are f32 scratch with nsplit =
// repro_decode_num_splits(dtype, B, C, H, KV, dh).  lse [B,H] and o32
// [B,H,dh], contiguous f32, are the residuals of the backward, written where
// lse is not null.  dtype: 0 = f32, 1 = bf16.  device is the CUDA ordinal
// the tensors and the stream belong to.
extern "C" int repro_decode_attention_fwd(
        const void* q, const void* kc, const void* vc, const void* valid, void* out,
        void* lse, void* o32, void* acc_p, void* m_p, void* l_p, int dtype, int B, int C,
        int H, int KV, int dh, int64_t qsb, int64_t qsh, int64_t ksb, int64_t ksc,
        int64_t ksh, int64_t vsb, int64_t vsc, int64_t vsh, int64_t msb, int64_t msc,
        int64_t osb, int64_t osh, float scale, int device, void* stream) {
    const int64_t st[10] = {qsb, qsh, ksb, ksc, ksh, vsb, vsc, vsh, msb, msc};
    const Outputs o = {out, osb, osh, static_cast<float*>(lse),
                       lse != nullptr ? static_cast<float*>(o32) : nullptr,
                       nullptr, nullptr, nullptr};
    return (int)run(q, kc, vc, valid, o, acc_p, m_p, l_p, dtype, B, C, H, KV, dh, st, scale,
                    device, static_cast<cudaStream_t>(stream));
}

// The stats variant: the inputs, strides and scratch of
// repro_decode_attention_fwd; in place of out, acc [B,KV,rep,dh], m and l
// [B,KV,rep], contiguous f32, the merged unnormalised partials.
extern "C" int repro_decode_attention_stats(
        const void* q, const void* kc, const void* vc, const void* valid, void* acc,
        void* m, void* l, void* acc_p, void* m_p, void* l_p, int dtype, int B, int C, int H,
        int KV, int dh, int64_t qsb, int64_t qsh, int64_t ksb, int64_t ksc, int64_t ksh,
        int64_t vsb, int64_t vsc, int64_t vsh, int64_t msb, int64_t msc, float scale,
        int device, void* stream) {
    const int64_t st[10] = {qsb, qsh, ksb, ksc, ksh, vsb, vsc, vsh, msb, msc};
    const Outputs o = {nullptr, 0, 0, nullptr, nullptr, static_cast<float*>(acc),
                       static_cast<float*>(m), static_cast<float*>(l)};
    return (int)run(q, kc, vc, valid, o, acc_p, m_p, l_p, dtype, B, C, H, KV, dh, st, scale,
                    device, static_cast<cudaStream_t>(stream));
}
