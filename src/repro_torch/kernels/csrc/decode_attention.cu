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
// 3.35 TB/s).  The tensor cores buy nothing here; all arithmetic is f32 on
// the CUDA cores.  What the design does about the bytes:
//  * K and V go from HBM straight into registers: each lane loads 16 bytes
//    (8 bf16 or 4 f32) of a row, so a warp load covers whole rows (two
//    128-wide bf16 rows, or one 256-wide; at dh 256 in f32 a lane loads two
//    16-byte pieces of one row), and nothing is staged in shared memory;
//  * each lane keeps its columns of the bundle's query vectors in
//    registers; a score is a shuffle reduction over the lanes of one row,
//    and P.V accumulates in registers;
//  * a warp loads U rows of K and U of V per lane before it uses any of
//    them, so every warp keeps 2U 16-byte loads in flight;
//  * softmax is online across batches of rows (one rescale per batch), so
//    no scores are kept; a row the mask excludes is not read;
//  * the cache is split into SPLIT = 256 slots per block of 4 warps, one
//    64-slot tile per warp, so B*KV*splits blocks (1024 at B=8, KV=8,
//    C=4096) keep all 132 SMs streaming; a 64-slot tile whose mask is all
//    false is not read at all; the warps merge in shared memory, pass 1
//    writes unnormalised (acc, m, l) partials in f32 and pass 2 merges the
//    splits with the split-K rescale and normalises;
//  * a block serves up to 8 query heads of a bundle; rep = 16 takes two
//    blocks per split, each reading the split's K/V.
// A split with no valid slot contributes (acc, m, l) = (0, NEG_INF, 0);
// if no slot at all is valid the output is 0.
//
// With residuals (`lse`, `o32` set in `repro_decode_attention_fwd`, as the
// autograd forward runs it) the combine pass also writes each head's
// log-sum-exp m + log l and its output in f32 before the rounding to the
// input type: the decode backward's P and delta = do . o come from them.
// The rounded output is the same either way.
//
// The stats variant (`repro_decode_attention_stats`) runs the same pass 1
// and a second pass that writes the merged (acc [B,KV,R,dh], m, l [B,KV,R])
// in f32 without dividing acc by l: the partials of one shard of a cache
// that context-parallel decode merges over the rails (the plain version's
// `return_stats=True`).  A shard with no valid slot gives (0, NEG_INF, 0),
// whose weight exp(NEG_INF - m_global) is 0 in any merge with a valid slot.
#include "common.cuh"

namespace {

constexpr int SPLIT = 256;        // cache slots per block of pass 1
constexpr int TK = 64;            // slots per warp tile (mask granularity)
constexpr int NW = SPLIT / TK;    // warps per block
constexpr int NT = 32 * NW;
constexpr int MAXR = 8;           // query heads per block

// 16 bytes of a row, loaded raw and widened to f32 where they are used
__device__ __forceinline__ uint4 load16(const void* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
}

// x[at ..] = the 4 f32 or 8 bf16 elements of u, as f32
template <int N>
__device__ __forceinline__ void widen(const uint4& u, float (&x)[N], int at, float) {
    x[at] = __uint_as_float(u.x);
    x[at + 1] = __uint_as_float(u.y);
    x[at + 2] = __uint_as_float(u.z);
    x[at + 3] = __uint_as_float(u.w);
}

template <int N>
__device__ __forceinline__ void widen(const uint4& u, float (&x)[N], int at, __nv_bfloat16) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        x[at + 2 * i] = f.x;
        x[at + 2 * i + 1] = f.y;
    }
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

// out[b, 0, g*rep + r, :] = merge over splits of the partials (split-K
// combine); where lse is set, also lse[b, h] = m + log l and o32[b, h, :] =
// the output in f32 (h = g*rep + r, both contiguous)
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ acc_p,
                                      const float* __restrict__ m_p,
                                      const float* __restrict__ l_p, T* __restrict__ out,
                                      float* __restrict__ lse, float* __restrict__ o32,
                                      int rep, int dh, int nsplit, int64_t osb, int64_t osh) {
    const int r = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
    const int64_t base = (int64_t)(b * gridDim.y + g) * nsplit;
    float mg = REPRO_NEG_INF;
    for (int s = 0; s < nsplit; ++s) mg = fmaxf(mg, m_p[(base + s) * rep + r]);
    float l = 0.f;
    for (int s = 0; s < nsplit; ++s)
        l += l_p[(base + s) * rep + r] * expf(m_p[(base + s) * rep + r] - mg);
    l = fmaxf(l, 1e-30f);
    const int64_t h = (int64_t)b * gridDim.y * rep + g * rep + r;
    if (lse != nullptr && threadIdx.x == 0) lse[h] = mg + logf(l);
    T* orow = out + b * osb + (g * rep + r) * osh;
    for (int d = threadIdx.x; d < dh; d += blockDim.x) {
        float a = 0.f;
        for (int s = 0; s < nsplit; ++s) {
            const int64_t i = (base + s) * rep + r;
            a += acc_p[i * dh + d] * expf(m_p[i] - mg);
        }
        const float o = a / l;
        store1(orow + d, o);
        if (o32 != nullptr) o32[h * dh + d] = o;
    }
}

// Threads of a stats-combine block: CP groups of 64, each summing every
// CP-th split, so a long cache (128 splits at 32768 slots) is not one
// serial loop of dependent loads.
constexpr int CT = 512;
constexpr int CP = CT / 64;

// The max (MAX) or the sum of v over the block's threads, in every thread.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float o = __shfl_xor_sync(0xffffffffu, v, off);
        v = MAX ? fmaxf(v, o) : v + o;
    }
    __syncthreads();  // red may still be read by the previous reduction
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    v = lane < CT / 32 ? red[lane] : (MAX ? REPRO_NEG_INF : 0.f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float o = __shfl_xor_sync(0xffffffffu, v, off);
        v = MAX ? fmaxf(v, o) : v + o;
    }
    return v;
}

// acc[b, g, r, :], m[b, g, r], l[b, g, r] = the partials merged over the
// splits with the split-K rescale, unnormalised (f32)
__global__ void __launch_bounds__(CT)
decode_stats_combine_kernel(const float* __restrict__ acc_p, const float* __restrict__ m_p,
                            const float* __restrict__ l_p, float* __restrict__ acc,
                            float* __restrict__ m, float* __restrict__ l, int rep, int dh,
                            int nsplit) {
    __shared__ float red[CT / 32];
    __shared__ float part[CP][REPRO_MAX_HEAD_DIM];
    const int r = blockIdx.x, g = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
    const int64_t base = (int64_t)(b * gridDim.y + g) * nsplit;
    const int64_t row = (int64_t)(b * gridDim.y + g) * rep + r;
    float mx = REPRO_NEG_INF;
    for (int s = tid; s < nsplit; s += CT) mx = fmaxf(mx, m_p[(base + s) * rep + r]);
    const float mg = block_reduce<true>(mx, red);
    float ls = 0.f;
    for (int s = tid; s < nsplit; s += CT)
        ls += l_p[(base + s) * rep + r] * expf(m_p[(base + s) * rep + r] - mg);
    ls = block_reduce<false>(ls, red);
    if (tid == 0) {
        m[row] = mg;
        l[row] = ls;
    }
    // group q sums the splits q, q + CP, ...; its lane c the columns c, c + 64, ...
    const int q = tid / 64, c = tid % 64;
    float a[REPRO_MAX_HEAD_DIM / 64] = {};
    for (int s = q; s < nsplit; s += CP) {
        const int64_t i = (base + s) * rep + r;
        const float w = expf(m_p[i] - mg);
#pragma unroll
        for (int k = 0; k < REPRO_MAX_HEAD_DIM / 64; ++k)
            if (c + 64 * k < dh) a[k] += acc_p[i * dh + c + 64 * k] * w;
    }
#pragma unroll
    for (int k = 0; k < REPRO_MAX_HEAD_DIM / 64; ++k)
        if (c + 64 * k < dh) part[q][c + 64 * k] = a[k];
    __syncthreads();
    for (int d = tid; d < dh; d += CT) {
        float t = 0.f;
#pragma unroll
        for (int k = 0; k < CP; ++k) t += part[k][d];
        acc[row * dh + d] = t;
    }
}

// Where pass 2 writes: the normalised output (out, its batch and head
// strides) and, where lse is set, the residuals (lse, o32); or, where acc
// is set, the merged stats (acc, m, l).
struct Outputs {
    void* out;
    int64_t osb, osh;
    float *lse, *o32;
    float *acc, *m, *l;
};

// query heads per pass-1 block for a bundle of rep: 2, 4 or 8 (rep 1, as
// gemma-7b's 16 heads on 16 kv heads, runs the 2-head kernel with one head
// live)
int heads_per_block(int rep) {
    int r = 2;
    while (r < rep && r < MAXR) r *= 2;
    return r;
}

template <typename T, int DHP, int R>
cudaError_t launch_r(const void* q, const void* kc, const void* vc, const void* valid,
                     const Outputs& o, float* acc_p, float* m_p, float* l_p, int B, int C, int H,
                     int KV, int dh, const int64_t* st, float scale, cudaStream_t stream) {
    const int rep = H / KV;
    const int nsplit = (C + SPLIT - 1) / SPLIT;
    const int ngrp = (rep + R - 1) / R;
    decode_partial_kernel<T, DHP, R><<<dim3(nsplit, KV * ngrp, B), NT, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
        static_cast<const uint8_t*>(valid), acc_p, m_p, l_p, C, KV, rep, dh, nsplit,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (o.acc != nullptr)
        decode_stats_combine_kernel<<<dim3(rep, KV, B), CT, 0, stream>>>(
            acc_p, m_p, l_p, o.acc, o.m, o.l, rep, dh, nsplit);
    else
        decode_combine_kernel<T><<<dim3(rep, KV, B), 128, 0, stream>>>(
            acc_p, m_p, l_p, static_cast<T*>(o.out), o.lse, o.o32, rep, dh, nsplit, o.osb,
            o.osh);
    return cudaGetLastError();
}

template <typename T, int DHP>
cudaError_t launch(const void* q, const void* kc, const void* vc, const void* valid,
                   const Outputs& o, float* acc_p, float* m_p, float* l_p, int B, int C, int H,
                   int KV, int dh, const int64_t* st, float scale, cudaStream_t stream) {
    switch (heads_per_block(H / KV)) {
        case 2: return launch_r<T, DHP, 2>(q, kc, vc, valid, o, acc_p, m_p, l_p, B, C, H, KV,
                                           dh, st, scale, stream);
        case 4: return launch_r<T, DHP, 4>(q, kc, vc, valid, o, acc_p, m_p, l_p, B, C, H, KV,
                                           dh, st, scale, stream);
        default: return launch_r<T, DHP, 8>(q, kc, vc, valid, o, acc_p, m_p, l_p, B, C, H,
                                            KV, dh, st, scale, stream);
    }
}

// Checks the shapes, then runs both passes for the dtype and head-dim tile.
cudaError_t run(const void* q, const void* kc, const void* vc, const void* valid,
                const Outputs& o, void* acc_p, void* m_p, void* l_p, int dtype, int B, int C,
                int H, int KV, int dh, const int64_t* st, float scale, int device,
                cudaStream_t s) {
    if (dh <= 0 || dh > REPRO_MAX_HEAD_DIM || dh % 4 || H % KV || H / KV > 2 * MAXR ||
        C <= 0 || (dtype == REPRO_BF16 && dh % 8))
        return cudaErrorInvalidValue;
    if (B <= 0) return cudaSuccess;
    cudaError_t err = cudaSetDevice(device);  // this library's runtime keeps its own
    if (err != cudaSuccess) return err;
    float* a = static_cast<float*>(acc_p);
    float* m = static_cast<float*>(m_p);
    float* l = static_cast<float*>(l_p);
    if (dtype == REPRO_F32) {
        switch (head_dim_tile(dh)) {
            case 64: return launch<float, 64>(q, kc, vc, valid, o, a, m, l, B, C, H, KV, dh, st,
                                              scale, s);
            case 128: return launch<float, 128>(q, kc, vc, valid, o, a, m, l, B, C, H, KV, dh,
                                                st, scale, s);
            default: return launch<float, 256>(q, kc, vc, valid, o, a, m, l, B, C, H, KV, dh,
                                               st, scale, s);
        }
    }
    if (dtype == REPRO_BF16) {
        using bf16 = __nv_bfloat16;
        switch (head_dim_tile(dh)) {
            case 64: return launch<bf16, 64>(q, kc, vc, valid, o, a, m, l, B, C, H, KV, dh, st,
                                             scale, s);
            case 128: return launch<bf16, 128>(q, kc, vc, valid, o, a, m, l, B, C, H, KV, dh,
                                               st, scale, s);
            default: return launch<bf16, 256>(q, kc, vc, valid, o, a, m, l, B, C, H, KV, dh,
                                              st, scale, s);
        }
    }
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int repro_decode_num_splits(int C) { return (C + SPLIT - 1) / SPLIT; }

// Cache slots per split (one pass-1 block).
extern "C" int repro_decode_split() { return SPLIT; }

// Most query heads per kv head the kernel takes.
extern "C" int repro_decode_max_rep() { return 2 * MAXR; }

// Static shared memory of one pass-1 block (the warps' merge), in bytes.
extern "C" int repro_decode_attention_smem_bytes(int rep, int dh) {
    return NW * heads_per_block(rep) * (head_dim_tile(dh) + 2) * (int)sizeof(float);
}

// q [B,1,H,dh]; k/v cache [B,C,KV,dh]; valid [B,C] uint8; out [B,1,H,dh].
// Strides in elements: q (batch, head), k and v (batch, slot, head), valid
// (batch, slot), out (batch, head); the head dim is unit-stride and every
// row starts on a 16-byte boundary; dh is a multiple of 8 (bf16) or 4
// (f32), at most 256.  acc_p [B,KV,nsplit,rep,dh], m_p and l_p
// [B,KV,nsplit,rep] are f32 scratch with nsplit = repro_decode_num_splits(C).
// lse [B,H] and o32 [B,H,dh], contiguous f32, are the residuals of the
// backward, written where lse is not null.  dtype: 0 = f32, 1 = bf16.
// device is the CUDA ordinal the tensors and the stream belong to.
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
