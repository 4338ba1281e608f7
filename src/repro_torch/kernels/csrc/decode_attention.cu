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
//    128-wide bf16 rows), and nothing is staged in shared memory;
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

__device__ __forceinline__ void widen(const uint4& u, float (&x)[4], float) {
    x[0] = __uint_as_float(u.x);
    x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z);
    x[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void widen(const uint4& u, float (&x)[8], __nv_bfloat16) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        x[2 * i] = f.x;
        x[2 * i + 1] = f.y;
    }
}

template <typename T>
__host__ __device__ constexpr int elems16() { return 16 / (int)sizeof(T); }

// R query heads of one kv head over the slots [split * SPLIT, + SPLIT)
template <typename T, int DHP, int R>
__global__ void __launch_bounds__(NT, R >= 8 ? 1 : 4)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, const uint8_t* __restrict__ valid,
                      float* __restrict__ acc_out, float* __restrict__ m_out,
                      float* __restrict__ l_out, int C, int KV, int rep, int dh, int nsplit,
                      int64_t qsb, int64_t qsh, int64_t ksb, int64_t ksc, int64_t ksh,
                      int64_t vsb, int64_t vsc, int64_t vsh, int64_t msb, int64_t msc,
                      float scale) {
    constexpr int E = elems16<T>();      // elements per lane load
    constexpr int LPR = DHP / E;         // lanes per cache row
    constexpr int RPW = 32 / LPR;        // rows per warp load
    constexpr int U = R >= 8 ? 2 : 4;    // row loads of K (and of V) in flight per lane
    constexpr int BATCH = U * RPW;       // rows per online-softmax step of a warp
    static_assert(TK % BATCH == 0, "whole batches per tile");
    __shared__ float Wm[NW][R], Wl[NW][R];
    __shared__ float Wacc[NW][R][DHP];

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int split = blockIdx.x, b = blockIdx.z;
    const int ngrp = (rep + R - 1) / R;
    const int g = blockIdx.y / ngrp, h0 = (blockIdx.y % ngrp) * R;  // kv head, first q head
    const int nr = min(R, rep - h0);
    const int col = (lane % LPR) * E, rsub = lane / LPR;  // this lane's columns and row
    const bool col_ok = col < dh;
    const T* kb = kc + b * ksb + g * ksh + col;
    const T* vb = vc + b * vsb + g * vsh + col;
    const uint8_t* mb = valid + b * msb;

    float qr[R][E], m[R], l[R], acc[R][E];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        m[r] = REPRO_NEG_INF;
        l[r] = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) qr[r][e] = acc[r][e] = 0.f;
        if (r < nr && col_ok)
            widen(load16(q + b * qsb + (g * rep + h0 + r) * qsh + col), qr[r], T());
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
        uint4 kraw[U], vraw[U];
        bool ok[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int i = i0 + u * RPW + rsub;
            ok[u] = (tmask >> i) & 1;  // also false past C
            kraw[u] = vraw[u] = make_uint4(0u, 0u, 0u, 0u);  // zero in either type
            if (ok[u] && col_ok) {
                kraw[u] = load16(kb + (int64_t)(t0 + i) * ksc);
                vraw[u] = load16(vb + (int64_t)(t0 + i) * vsc);
            }
        }
        float s[U][R];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            float kf[E];
            widen(kraw[u], kf, T());
#pragma unroll
            for (int r = 0; r < R; ++r) {
                float d = 0.f;
#pragma unroll
                for (int e = 0; e < E; ++e) d = fmaf(qr[r][e], kf[e], d);
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
            for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
#pragma unroll
            for (int u = 0; u < U; ++u) {
                p[u][r] = expf(s[u][r] - m_new);
                l[r] += p[u][r];
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            float vf[E];
            widen(vraw[u], vf, T());
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
                for (int e = 0; e < E; ++e) acc[r][e] = fmaf(p[u][r], vf[e], acc[r][e]);
        }
    }

    // the warp's rows of each load into one (m is already the warp's)
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
        for (int r = 0; r < R; ++r) {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
#pragma unroll
            for (int e = 0; e < E; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], off);
        }
    if (lane < LPR) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
            for (int e = 0; e < E; ++e) Wacc[warp][r][col + e] = acc[r][e];
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

// out[b, 0, g*rep + r, :] = merge over splits of the partials (split-K combine)
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ acc_p,
                                      const float* __restrict__ m_p,
                                      const float* __restrict__ l_p, T* __restrict__ out,
                                      int rep, int dh, int nsplit, int64_t osb, int64_t osh) {
    const int r = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
    const int64_t base = (int64_t)(b * gridDim.y + g) * nsplit;
    float mg = REPRO_NEG_INF;
    for (int s = 0; s < nsplit; ++s) mg = fmaxf(mg, m_p[(base + s) * rep + r]);
    float l = 0.f;
    for (int s = 0; s < nsplit; ++s)
        l += l_p[(base + s) * rep + r] * expf(m_p[(base + s) * rep + r] - mg);
    l = fmaxf(l, 1e-30f);
    T* orow = out + b * osb + (g * rep + r) * osh;
    for (int d = threadIdx.x; d < dh; d += blockDim.x) {
        float a = 0.f;
        for (int s = 0; s < nsplit; ++s) {
            const int64_t i = (base + s) * rep + r;
            a += acc_p[i * dh + d] * expf(m_p[i] - mg);
        }
        store1(orow + d, a / l);
    }
}

// query heads per pass-1 block for a bundle of rep: 2, 4 or 8 (rep 1 runs
// the 2-head kernel with one head live; every model config has rep >= 2)
int heads_per_block(int rep) {
    int r = 2;
    while (r < rep && r < MAXR) r *= 2;
    return r;
}

template <typename T, int DHP, int R>
cudaError_t launch_r(const void* q, const void* kc, const void* vc, const void* valid,
                     void* out, float* acc_p, float* m_p, float* l_p, int B, int C, int H,
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
    decode_combine_kernel<T><<<dim3(rep, KV, B), 128, 0, stream>>>(
        acc_p, m_p, l_p, static_cast<T*>(out), rep, dh, nsplit, st[10], st[11]);
    return cudaGetLastError();
}

template <typename T, int DHP>
cudaError_t launch(const void* q, const void* kc, const void* vc, const void* valid,
                   void* out, float* acc_p, float* m_p, float* l_p, int B, int C, int H,
                   int KV, int dh, const int64_t* st, float scale, cudaStream_t stream) {
    switch (heads_per_block(H / KV)) {
        case 2: return launch_r<T, DHP, 2>(q, kc, vc, valid, out, acc_p, m_p, l_p, B, C, H, KV,
                                           dh, st, scale, stream);
        case 4: return launch_r<T, DHP, 4>(q, kc, vc, valid, out, acc_p, m_p, l_p, B, C, H, KV,
                                           dh, st, scale, stream);
        default: return launch_r<T, DHP, 8>(q, kc, vc, valid, out, acc_p, m_p, l_p, B, C, H,
                                            KV, dh, st, scale, stream);
    }
}

}  // namespace

extern "C" int repro_decode_num_splits(int C) { return (C + SPLIT - 1) / SPLIT; }

// Cache slots per split (one pass-1 block).
extern "C" int repro_decode_split() { return SPLIT; }

// Most query heads per kv head the kernel takes.
extern "C" int repro_decode_max_rep() { return 2 * MAXR; }

// Static shared memory of one pass-1 block (the warps' merge), in bytes.
extern "C" int repro_decode_attention_smem_bytes(int rep, int dh) {
    const int r = heads_per_block(rep), dhp = dh <= 64 ? 64 : 128;
    return NW * r * (dhp + 2) * (int)sizeof(float);
}

// q [B,1,H,dh]; k/v cache [B,C,KV,dh]; valid [B,C] uint8; out [B,1,H,dh].
// Strides in elements: q (batch, head), k and v (batch, slot, head), valid
// (batch, slot), out (batch, head); the head dim is unit-stride and every
// row starts on a 16-byte boundary; dh is a multiple of 8 (bf16) or 4
// (f32).  acc_p [B,KV,nsplit,rep,dh], m_p and l_p [B,KV,nsplit,rep] are f32
// scratch with nsplit = repro_decode_num_splits(C).  dtype: 0 = f32, 1 =
// bf16.  device is the CUDA ordinal the tensors and the stream belong to.
extern "C" int repro_decode_attention_fwd(
        const void* q, const void* kc, const void* vc, const void* valid, void* out,
        void* acc_p, void* m_p, void* l_p, int dtype, int B, int C, int H, int KV, int dh,
        int64_t qsb, int64_t qsh, int64_t ksb, int64_t ksc, int64_t ksh,
        int64_t vsb, int64_t vsc, int64_t vsh, int64_t msb, int64_t msc,
        int64_t osb, int64_t osh, float scale, int device, void* stream) {
    const int64_t st[12] = {qsb, qsh, ksb, ksc, ksh, vsb, vsc, vsh, msb, msc, osb, osh};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dh <= 0 || dh > 128 || dh % 4 || H % KV || H / KV > repro_decode_max_rep() || C <= 0 ||
        (dtype == REPRO_BF16 && dh % 8))
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaSuccess;
    cudaError_t err = cudaSetDevice(device);  // this library's runtime keeps its own
    if (err != cudaSuccess) return (int)err;
    float* a = static_cast<float*>(acc_p);
    float* m = static_cast<float*>(m_p);
    float* l = static_cast<float*>(l_p);
    if (dtype == REPRO_F32)
        return dh <= 64 ? launch<float, 64>(q, kc, vc, valid, out, a, m, l, B, C, H, KV, dh, st,
                                            scale, s)
                        : launch<float, 128>(q, kc, vc, valid, out, a, m, l, B, C, H, KV, dh,
                                             st, scale, s);
    if (dtype == REPRO_BF16)
        return dh <= 64 ? launch<__nv_bfloat16, 64>(q, kc, vc, valid, out, a, m, l, B, C, H, KV,
                                                    dh, st, scale, s)
                        : launch<__nv_bfloat16, 128>(q, kc, vc, valid, out, a, m, l, B, C, H,
                                                     KV, dh, st, scale, s);
    return (int)cudaErrorInvalidValue;
}
