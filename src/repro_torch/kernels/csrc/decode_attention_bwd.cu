// Gradient of flash-decode for Hopper (sm_90a): dq, dk_cache and dv_cache of
// one query token against a masked KV cache, from the cotangent of the output.
//
// Replaces `_decode_vjp_bwd` in src/repro/kernels/decode_attention.py (XLA:
// it recomputes through `ref.decode_attention`'s VJP; Pallas has no AD rule).
// Same function as the plain version `repro_torch.kernels.ref.decode_attention_bwd`
// (autograd through `ref.decode_attention`): for each query head h of kv head g,
//   s_c = scale q_h . k_c over the valid slots c, p_c = softmax(s)_c,
//   dp_c = do_h . v_c, delta = sum_c p_c dp_c (= do_h . o_h), ds_c = p_c (dp_c - delta),
//   dv_c = sum_h p_c do_h,  dk_c = scale sum_h ds_c q_h,  dq_h = scale sum_c ds_c k_c,
// the sums over h running over the rep query heads that share kv head g.  A
// masked slot gets dk = dv = 0 exactly; the mask gets no cotangent.
//
// What bounds it on an H100: like the forward it does a few FLOPs per cache
// element (about 8 rep a (slot, dim): two dot products and three updates per
// head), far below the ~295 FLOP/B ridge, so it is bound by bytes: K and V
// read once and dK and dV written once (B=8, C=4096, KV=8, dh=128 bf16:
// 4 x 67.1 MB, ~0.080 ms at 3.35 TB/s).  All arithmetic is f32 on the CUDA
// cores.  The design, simple first:
//  * pass 1 (`decode_bwd_stats_kernel`), one block of 4 warps per (batch,
//    kv head, 256-slot split), the forward's split: each warp walks its
//    64-slot tile one row at a time (a lane owns dh_tile / 32 columns) and
//    keeps, for each head of the group, an online (m, l, t) with
//    t = sum exp(s - m) dp; the warps merge in shared memory and write the
//    split's partials.  It reads K and V once (a 64-slot tile whose mask is
//    all false is not read);
//  * pass 2 (`decode_bwd_kernel`), the same grid: every block first merges
//    all splits' partials of its heads (the same fixed order in every block)
//    into M, 1 / L and delta = T / L, then walks its slots again: P, dP and dS
//    for the rep heads, dV and dK of the slot summed over the heads inside
//    the warp (no atomics) and written once, dq accumulated in registers.
//    The warps' dq are merged in shared memory in warp order and written as
//    the split's partial (f32).  Where a lane's dq of all heads would not
//    fit its registers (dh > 128 at rep 16; rep 8 in f32) further sweeps
//    re-read the split's K and V for the dq of the next heads;
//  * pass 3 (`decode_bwd_dq_kernel`) sums the splits' dq partials in split
//    order and writes dq in the input type.
// So K and V are read twice, and the bytes are ~1.5x the bound; q and do are
// staged in shared memory as f32 for all rep heads (at most 16 x 256).
#include "common.cuh"

namespace {

constexpr int SPLIT = 256;        // cache slots per block (the forward's split)
constexpr int TK = 64;            // slots per warp tile (mask granularity)
constexpr int NW = SPLIT / TK;    // warps per block
constexpr int NT = 32 * NW;
constexpr int MAXREP = 16;        // the forward's repro_decode_max_rep

// Elements of a row one lane loads in one piece: at most 16 bytes.
template <typename T, int CE>
__host__ __device__ constexpr int piece_elems() {
    return CE * (int)sizeof(T) < 16 ? CE : 16 / (int)sizeof(T);
}

// x[at ..] = the one f32 or two bf16 elements of the 32-bit word w, as f32
template <int N>
__device__ __forceinline__ void widen(uint32_t w, float (&x)[N], int at, float) {
    x[at] = __uint_as_float(w);
}

template <int N>
__device__ __forceinline__ void widen(uint32_t w, float (&x)[N], int at, __nv_bfloat16) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
    x[at] = f.x;
    x[at + 1] = f.y;
}

// the 32-bit word of x[at ..] rounded to T
template <int N>
__device__ __forceinline__ uint32_t narrow(const float (&x)[N], int at, float) {
    return __float_as_uint(x[at]);
}

template <int N>
__device__ __forceinline__ uint32_t narrow(const float (&x)[N], int at, __nv_bfloat16) {
    return bf16x2_bits(__floats2bfloat162_rn(x[at], x[at + 1]));
}

// x = the CE elements [col, col + CE) of the row at p (p points at col), as
// f32; a piece at or past dh reads as zeros.  Every row starts on a 16-byte
// boundary, so each piece is aligned to its size.
template <typename T, int CE>
__device__ __forceinline__ void load_row(const T* p, int col, int dh, float (&x)[CE]) {
    constexpr int PE = piece_elems<T, CE>();
    constexpr int EW = 4 / (int)sizeof(T);        // elements a 32-bit word
    constexpr int NWD = PE / EW;                  // words a piece
#pragma unroll
    for (int j = 0; j < CE / PE; ++j) {
        uint32_t w[NWD];
#pragma unroll
        for (int i = 0; i < NWD; ++i) w[i] = 0u;
        if (col + j * PE < dh) {
            const void* src = p + j * PE;
            if constexpr (NWD == 4) {
                const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
                w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
            } else if constexpr (NWD == 2) {
                const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
                w[0] = u.x, w[1] = u.y;
            } else {
                w[0] = __ldg(reinterpret_cast<const uint32_t*>(src));
            }
        }
#pragma unroll
        for (int i = 0; i < NWD; ++i) widen(w[i], x, j * PE + i * EW, T());
    }
}

// The row at p (at col) = x rounded to T; pieces at or past dh are not written.
template <typename T, int CE>
__device__ __forceinline__ void store_row(T* p, int col, int dh, const float (&x)[CE]) {
    constexpr int PE = piece_elems<T, CE>();
    constexpr int EW = 4 / (int)sizeof(T);
    constexpr int NWD = PE / EW;
#pragma unroll
    for (int j = 0; j < CE / PE; ++j) {
        if (col + j * PE >= dh) continue;
        uint32_t w[NWD];
#pragma unroll
        for (int i = 0; i < NWD; ++i) w[i] = narrow(x, j * PE + i * EW, T());
        void* dst = p + j * PE;
        if constexpr (NWD == 4) {
            *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        } else if constexpr (NWD == 2) {
            *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
        } else {
            *reinterpret_cast<uint32_t*>(dst) = w[0];
        }
    }
}

// x = s[col, col + CE) of a shared f32 row
template <int CE>
__device__ __forceinline__ void lds_row(const float* s, float (&x)[CE]) {
    if constexpr (CE % 4 == 0) {
#pragma unroll
        for (int j = 0; j < CE; j += 4) {
            const float4 f = *reinterpret_cast<const float4*>(s + j);
            x[j] = f.x, x[j + 1] = f.y, x[j + 2] = f.z, x[j + 3] = f.w;
        }
    } else {
#pragma unroll
        for (int j = 0; j < CE; j += 2) {
            const float2 f = *reinterpret_cast<const float2*>(s + j);
            x[j] = f.x, x[j + 1] = f.y;
        }
    }
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Rows of K (and of V) a lane loads before it uses any: two where the
// lane's registers allow.
template <int R, int CE>
__host__ __device__ constexpr int rows_in_flight() { return R * CE >= 64 ? 1 : 2; }

// The query heads of kv head g and their cotangents, as f32 [R][DHP] in
// shared memory; columns past dh and heads past rep are zeros.
template <typename T, int DHP, int R>
__device__ __forceinline__ void stage_heads(float (*qs)[DHP], float (*dos)[DHP], const T* q,
                                            const T* dout, int b, int g, int rep, int dh,
                                            int64_t qsb, int64_t qsh, int64_t dsb,
                                            int64_t dsh) {
    for (int i = threadIdx.x; i < R * DHP; i += NT) {
        const int r = i / DHP, d = i % DHP;
        const bool ok = r < rep && d < dh;
        const int h = g * rep + r;
        qs[r][d] = ok ? to_f32(q[b * qsb + h * qsh + d]) : 0.f;
        dos[r][d] = ok ? to_f32(dout[b * dsb + h * dsh + d]) : 0.f;
    }
}

// Bit i: slot t0 + i is valid (and below C).
__device__ __forceinline__ uint64_t tile_mask(const uint8_t* mb, int64_t msc, int t0, int C,
                                              int lane) {
    if (t0 >= C) return 0;
    const bool v0 = t0 + lane < C && mb[(int64_t)(t0 + lane) * msc] != 0;
    const bool v1 = t0 + 32 + lane < C && mb[(int64_t)(t0 + 32 + lane) * msc] != 0;
    return __ballot_sync(0xffffffffu, v0) | ((uint64_t)__ballot_sync(0xffffffffu, v1) << 32);
}

// After every HG heads of an unrolled loop over R: a warp barrier, which
// no shared-memory load is moved across, so the compiler does not load the
// rows of all R heads ahead (at R = 16 and a 256-wide tile, 256 registers).
constexpr int HG = 4;
template <int R>
__device__ __forceinline__ void head_group_fence(int r) {
    if (R > HG && r % HG == HG - 1 && r + 1 < R) __syncwarp();
}

// s[r] = q_r . k and dp[r] = do_r . v over the whole warp (every lane gets
// the totals), k and v this lane's columns of one row
template <int DHP, int R, int CE>
__device__ __forceinline__ void scores(const float (*qs)[DHP], const float (*dos)[DHP], int col,
                                       const float (&kf)[CE], const float (&vf)[CE],
                                       float (&s)[R], float (&dp)[R]) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
        float qv[CE], dv[CE];
        lds_row(&qs[r][col], qv);
        lds_row(&dos[r][col], dv);
        float a = 0.f, c = 0.f;
#pragma unroll
        for (int e = 0; e < CE; ++e) {
            a = fmaf(qv[e], kf[e], a);
            c = fmaf(dv[e], vf[e], c);
        }
        s[r] = a;
        dp[r] = c;
        head_group_fence<R>(r);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < R; ++r) {
            s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
            dp[r] += __shfl_xor_sync(0xffffffffu, dp[r], off);
        }
}

// Pass 1: for each head of kv head g, the split's (m, l, t): the largest
// score, sum exp(s - m) and sum exp(s - m) dp over its valid slots.
template <typename T, int DHP, int R>
__global__ void __launch_bounds__(NT, 1)
decode_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const uint8_t* __restrict__ valid,
                        const T* __restrict__ dout, float* __restrict__ m_out,
                        float* __restrict__ l_out, float* __restrict__ t_out, int C, int KV,
                        int rep, int dh, int nsplit, int64_t qsb, int64_t qsh, int64_t ksb,
                        int64_t ksc, int64_t ksh, int64_t vsb, int64_t vsc, int64_t vsh,
                        int64_t msb, int64_t msc, int64_t dsb, int64_t dsh, float scale) {
    constexpr int CE = DHP / 32;
    constexpr int U = rows_in_flight<R, CE>();
    __shared__ __align__(16) float qs[R][DHP];
    __shared__ __align__(16) float dos[R][DHP];
    __shared__ float Wm[NW][R], Wl[NW][R], Wt[NW][R];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
    const int col = lane * CE;
    stage_heads<T, DHP, R>(qs, dos, q, dout, b, g, rep, dh, qsb, qsh, dsb, dsh);
    __syncthreads();

    const int t0 = split * SPLIT + warp * TK;
    const uint64_t tmask = tile_mask(valid + b * msb, msc, t0, C, lane);
    const T* kb = kc + b * ksb + g * ksh + col;
    const T* vb = vc + b * vsb + g * vsh + col;
    // every lane holds each row's scores of all R heads after the warp's
    // reduction; lane r keeps the running (m, l, t) of head r % R
    const int hr = lane % R;
    float m = REPRO_NEG_INF, l = 0.f, t = 0.f;

    for (int i0 = 0; tmask != 0 && i0 < TK; i0 += U) {
        float kf[U][CE], vf[U][CE];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int i = i0 + u;
            if ((tmask >> i) & 1) {
                load_row<T, CE>(kb + (int64_t)(t0 + i) * ksc, col, dh, kf[u]);
                load_row<T, CE>(vb + (int64_t)(t0 + i) * vsc, col, dh, vf[u]);
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (!((tmask >> (i0 + u)) & 1)) continue;  // warp-uniform
            float s[R], dp[R];
            scores<DHP, R, CE>(qs, dos, col, kf[u], vf[u], s, dp);
            float sc = 0.f, dpv = 0.f;
#pragma unroll
            for (int r = 0; r < R; ++r)
                if (r == hr) sc = s[r], dpv = dp[r];
            sc *= scale;
            const float m_new = fmaxf(m, sc);
            const float alpha = expf(m - m_new);
            const float p = expf(sc - m_new);
            l = fmaf(l, alpha, p);
            t = fmaf(t, alpha, p * dpv);
            m = m_new;
        }
    }
    if (lane < R) Wm[warp][lane] = m, Wl[warp][lane] = l, Wt[warp][lane] = t;
    __syncthreads();
    if (tid < rep) {
        const int r = tid;
        float mg = REPRO_NEG_INF;
#pragma unroll
        for (int w = 0; w < NW; ++w) mg = fmaxf(mg, Wm[w][r]);
        float ls = 0.f, ts = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
            const float e = expf(Wm[w][r] - mg);
            ls += Wl[w][r] * e;
            ts += Wt[w][r] * e;
        }
        const int64_t part = ((int64_t)(b * KV + g) * nsplit + split) * rep + r;
        m_out[part] = mg;
        l_out[part] = ls;
        t_out[part] = ts;
    }
}

// Heads whose dq one sweep of pass 2 keeps in registers: all R where a
// lane's dq of them is at most 64 values (48 in f32, whose rows take twice
// the load registers), else 32 values' worth: R = 16 at a 256-wide tile
// takes four sweeps, R = 8 at 256 in f32 two.
template <typename T, int R, int CE>
__host__ __device__ constexpr int dq_heads() {
    return R * CE <= (sizeof(T) == 4 ? 48 : 64) ? R : 32 / CE;
}

// Pass 2: dK and dV of the split's slots, and the split's dq partial.  The
// first sweep over the slots writes dK and dV and keeps dq of the first
// dq_heads(); each further sweep (dh > 128 at R = 16, or R = 8 in f32)
// reads the split's K and V again for the dq of the next heads.
template <typename T, int DHP, int R>
__global__ void __launch_bounds__(NT, 1)
decode_bwd_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                  const uint8_t* __restrict__ valid, const T* __restrict__ dout,
                  const float* __restrict__ m_p, const float* __restrict__ l_p,
                  const float* __restrict__ t_p, T* __restrict__ dk, T* __restrict__ dv,
                  float* __restrict__ dq_p, int C, int KV, int rep, int dh, int nsplit,
                  int64_t qsb, int64_t qsh, int64_t ksb, int64_t ksc, int64_t ksh, int64_t vsb,
                  int64_t vsc, int64_t vsh, int64_t msb, int64_t msc, int64_t dsb, int64_t dsh,
                  int64_t dksb, int64_t dksc, int64_t dksh, int64_t dvsb, int64_t dvsc,
                  int64_t dvsh, float scale) {
    constexpr int CE = DHP / 32;
    constexpr int U = rows_in_flight<R, CE>();
    constexpr int RQ = dq_heads<T, R, CE>();
    constexpr int NSW = R / RQ;
    __shared__ __align__(16) float qs[R][DHP];
    __shared__ __align__(16) float dos[R][DHP];
    __shared__ __align__(16) float dqs[RQ][DHP];
    __shared__ float Ms[R], invL[R], Dl[R];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
    const int col = lane * CE;
    stage_heads<T, DHP, R>(qs, dos, q, dout, b, g, rep, dh, qsb, qsh, dsb, dsh);
    if (tid < R) {
        // every split's partials of head tid, merged in split order: P's
        // shift M, 1 / L and delta = T / L.  A head past rep (the block's
        // heads are rep rounded up to a power of two) has s = 0 (its staged
        // q is zero): M = 0 and 1 / L = 0 make its P exactly 0, where the
        // empty merge's M = -inf would make exp(s - M) * 0 = inf * 0 = NaN
        const int r = tid;
        float mg = REPRO_NEG_INF, ls = 0.f, ts = 0.f;
        if (r < rep) {
            const int64_t base = (int64_t)(b * KV + g) * nsplit * rep + r;
            for (int s = 0; s < nsplit; ++s) mg = fmaxf(mg, m_p[base + (int64_t)s * rep]);
            for (int s = 0; s < nsplit; ++s) {
                const float e = expf(m_p[base + (int64_t)s * rep] - mg);
                ls += l_p[base + (int64_t)s * rep] * e;
                ts += t_p[base + (int64_t)s * rep] * e;
            }
        }
        const float lc = fmaxf(ls, 1e-30f);  // the forward's clamp of l
        Ms[r] = r < rep ? mg : 0.f;
        invL[r] = r < rep ? 1.f / lc : 0.f;
        Dl[r] = r < rep ? ts / lc : 0.f;
    }
    __syncthreads();

    const int t0 = split * SPLIT + warp * TK;
    const uint64_t tmask = tile_mask(valid + b * msb, msc, t0, C, lane);
    const T* kb = kc + b * ksb + g * ksh + col;
    const T* vb = vc + b * vsb + g * vsh + col;
    T* dkb = dk + b * dksb + g * dksh + col;
    T* dvb = dv + b * dvsb + g * dvsh + col;
    const float zero[CE] = {};
    const int64_t part = ((int64_t)(b * KV + g) * nsplit + split) * rep;

#pragma unroll
    for (int sw = 0; sw < NSW; ++sw) {
        if (sw * RQ >= rep) break;  // this sweep's heads are all past rep
        float dq[RQ][CE];
#pragma unroll
        for (int r = 0; r < RQ; ++r)
#pragma unroll
            for (int e = 0; e < CE; ++e) dq[r][e] = 0.f;
        for (int i0 = 0; i0 < TK && t0 + i0 < C && (sw == 0 || tmask != 0); i0 += U) {
            float kf[U][CE], vf[U][CE];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int i = i0 + u;
                if ((tmask >> i) & 1) {
                    load_row<T, CE>(kb + (int64_t)(t0 + i) * ksc, col, dh, kf[u]);
                    load_row<T, CE>(vb + (int64_t)(t0 + i) * vsc, col, dh, vf[u]);
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int c = t0 + i0 + u;
                if (c >= C) break;
                if (!((tmask >> (i0 + u)) & 1)) {  // a masked slot: exact zeros
                    if (sw == 0) {
                        store_row<T, CE>(dkb + (int64_t)c * dksc, col, dh, zero);
                        store_row<T, CE>(dvb + (int64_t)c * dvsc, col, dh, zero);
                    }
                    continue;
                }
                float s[R], dp[R];
                scores<DHP, R, CE>(qs, dos, col, kf[u], vf[u], s, dp);
                float dkr[CE], dvr[CE];
#pragma unroll
                for (int e = 0; e < CE; ++e) dkr[e] = dvr[e] = 0.f;
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const bool mine = r >= sw * RQ && r < (sw + 1) * RQ;
                    if (sw > 0 && !mine) continue;
                    const float p = expf(s[r] * scale - Ms[r]) * invL[r];
                    const float ds = p * (dp[r] - Dl[r]);
                    if (sw == 0) {
                        float qv[CE], dov[CE];
                        lds_row(&qs[r][col], qv);
                        lds_row(&dos[r][col], dov);
#pragma unroll
                        for (int e = 0; e < CE; ++e) {
                            dvr[e] = fmaf(p, dov[e], dvr[e]);
                            dkr[e] = fmaf(ds, qv[e], dkr[e]);
                        }
                    }
                    if (mine) {
#pragma unroll
                        for (int e = 0; e < CE; ++e)
                            dq[r - sw * RQ][e] = fmaf(ds, kf[u][e], dq[r - sw * RQ][e]);
                    }
                    head_group_fence<R>(r);
                }
                if (sw == 0) {
#pragma unroll
                    for (int e = 0; e < CE; ++e) dkr[e] *= scale;
                    store_row<T, CE>(dkb + (int64_t)c * dksc, col, dh, dkr);
                    store_row<T, CE>(dvb + (int64_t)c * dvsc, col, dh, dvr);
                }
            }
        }
        // the warps' dq of this sweep's heads into dqs, in warp order, then
        // the split's partial of those heads
#pragma unroll
        for (int w = 0; w < NW; ++w) {
            if (warp == w) {
#pragma unroll
                for (int r = 0; r < RQ; ++r)
#pragma unroll
                    for (int e = 0; e < CE; ++e)
                        dqs[r][col + e] = w == 0 ? dq[r][e] : dqs[r][col + e] + dq[r][e];
            }
            __syncthreads();
        }
        for (int i = tid; i < RQ * dh; i += NT) {
            const int r = i / dh, d = i % dh;
            if (sw * RQ + r < rep) dq_p[(part + sw * RQ + r) * dh + d] = dqs[r][d];
        }
        __syncthreads();  // dqs is written again by the next sweep
    }
}

// Pass 3: dq[b, 0, g * rep + r, :] = scale * the splits' partials summed in
// split order
template <typename T>
__global__ void decode_bwd_dq_kernel(const float* __restrict__ dq_p, T* __restrict__ dq,
                                     int rep, int dh, int nsplit, int64_t osb, int64_t osh,
                                     float scale) {
    const int r = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
    const int64_t base = (int64_t)(b * gridDim.y + g) * nsplit;
    T* orow = dq + b * osb + (g * rep + r) * osh;
    for (int d = threadIdx.x; d < dh; d += blockDim.x) {
        float a = 0.f;
        for (int s = 0; s < nsplit; ++s) a += dq_p[((base + s) * rep + r) * dh + d];
        store1(orow + d, a * scale);
    }
}

// The query heads a block holds for a group of rep: 1, 2, 4, 8 or 16.
int heads_per_block(int rep) {
    int r = 1;
    while (r < rep) r *= 2;
    return r;
}

struct Args {
    const void *q, *kc, *vc, *valid, *dout;
    void *dq, *dk, *dv;
    float *m_p, *l_p, *t_p, *dq_p;
    int B, C, H, KV, dh;
    const int64_t* st;  // q (b, h), k (b, c, h), v (b, c, h), valid (b, c), do (b, h),
                        // dq (b, h), dk (b, c, h), dv (b, c, h)
    float scale;
};

template <typename T, int DHP, int R>
cudaError_t launch_r(const Args& a, cudaStream_t stream) {
    const int rep = a.H / a.KV;
    const int nsplit = (a.C + SPLIT - 1) / SPLIT;
    const int64_t* st = a.st;
    const dim3 grid(nsplit, a.KV, a.B);
    const T* q = static_cast<const T*>(a.q);
    const T* kc = static_cast<const T*>(a.kc);
    const T* vc = static_cast<const T*>(a.vc);
    const uint8_t* valid = static_cast<const uint8_t*>(a.valid);
    const T* dout = static_cast<const T*>(a.dout);
    decode_bwd_stats_kernel<T, DHP, R><<<grid, NT, 0, stream>>>(
        q, kc, vc, valid, dout, a.m_p, a.l_p, a.t_p, a.C, a.KV, rep, a.dh, nsplit, st[0], st[1],
        st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], a.scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    decode_bwd_kernel<T, DHP, R><<<grid, NT, 0, stream>>>(
        q, kc, vc, valid, dout, a.m_p, a.l_p, a.t_p, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.dq_p, a.C, a.KV, rep, a.dh, nsplit, st[0], st[1], st[2], st[3],
        st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[14], st[15], st[16],
        st[17], st[18], st[19], a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    decode_bwd_dq_kernel<T><<<dim3(rep, a.KV, a.B), 128, 0, stream>>>(
        a.dq_p, static_cast<T*>(a.dq), rep, a.dh, nsplit, st[12], st[13], a.scale);
    return cudaGetLastError();
}

template <typename T, int DHP>
cudaError_t launch(const Args& a, cudaStream_t s) {
    switch (heads_per_block(a.H / a.KV)) {
        case 1: return launch_r<T, DHP, 1>(a, s);
        case 2: return launch_r<T, DHP, 2>(a, s);
        case 4: return launch_r<T, DHP, 4>(a, s);
        case 8: return launch_r<T, DHP, 8>(a, s);
        default: return launch_r<T, DHP, 16>(a, s);
    }
}

template <typename T>
cudaError_t launch_dh(const Args& a, cudaStream_t s) {
    switch (head_dim_tile(a.dh)) {
        case 64: return launch<T, 64>(a, s);
        case 128: return launch<T, 128>(a, s);
        default: return launch<T, 256>(a, s);
    }
}

}  // namespace

// q, do, dq [B,1,H,dh]; k, v, dk, dv [B,C,KV,dh]; valid [B,C] uint8.
// Strides in elements, 20 of them in `st`: q (batch, head), k and v (batch,
// slot, head), valid (batch, slot), do (batch, head), dq (batch, head), dk
// and dv (batch, slot, head); the head dim is unit-stride and every row
// starts on a 16-byte boundary; dh is a multiple of 8 (bf16) or 4 (f32), at
// most 256; H / KV at most 16.  m_p, l_p, t_p [B,KV,nsplit,rep] and dq_p
// [B,KV,nsplit,rep,dh] are f32 scratch with nsplit = repro_decode_bwd_num_splits(C).
// dtype: 0 = f32, 1 = bf16.  device is the CUDA ordinal of the tensors and
// the stream.
extern "C" int repro_decode_attention_bwd(
        const void* q, const void* kc, const void* vc, const void* valid, const void* dout,
        void* dq, void* dk, void* dv, void* m_p, void* l_p, void* t_p, void* dq_p, int dtype,
        int B, int C, int H, int KV, int dh, const int64_t* st, float scale, int device,
        void* stream) {
    if (dh <= 0 || dh > REPRO_MAX_HEAD_DIM || dh % 4 || KV <= 0 || H % KV ||
        H / KV > MAXREP || C <= 0 || (dtype == REPRO_BF16 && dh % 8))
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaSuccess;
    cudaError_t err = cudaSetDevice(device);  // this library's runtime keeps its own
    if (err != cudaSuccess) return (int)err;
    const Args a = {q, kc, vc, valid, dout, dq, dk, dv, static_cast<float*>(m_p),
                    static_cast<float*>(l_p), static_cast<float*>(t_p),
                    static_cast<float*>(dq_p), B, C, H, KV, dh, st, scale};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == REPRO_F32) return (int)launch_dh<float>(a, s);
    if (dtype == REPRO_BF16) return (int)launch_dh<__nv_bfloat16>(a, s);
    return (int)cudaErrorInvalidValue;
}

extern "C" int repro_decode_bwd_num_splits(int C) { return (C + SPLIT - 1) / SPLIT; }

// Cache slots per block of passes 1 and 2.
extern "C" int repro_decode_bwd_split() { return SPLIT; }

// Most query heads per kv head the kernel takes.
extern "C" int repro_decode_bwd_max_rep() { return MAXREP; }
