// Flash-attention backward for Hopper (sm_90a), causal / sliding-window, GQA.
//
// Replaces `_flash_vjp_bwd` in src/repro/kernels/flash_attention.py, which is
// not a Pallas kernel: on the TPU the gradient is recomputed in XLA through
// `ref._mha_fwd_blocks` and `ref._mha_bwd_blocks`.  Same function as the plain
// version `repro_torch.kernels.ref.mha_bwd`: from q, k, v, the forward's o and
// lse and the output's gradient do,
//     P = exp(q k^T * scale - lse) (0 where masked),  dP = do v^T,
//     delta = rowsum(do * o),  dS = P * (dP - delta),
//     dv = P^T do,  dk = dS^T q * scale,  dq = dS k * scale,
// with dk and dv summed over the `rep` query heads of each kv head.  Every
// product and sum is f32; each output is rounded once to the input type.
//
// What bounds it on an H100: at S=4096 (h2o-danube-3-4b training: H=32,
// KV=8, dh=120) the causal half of the five products is ~322 GFLOP (2.5x the
// forward's) against ~100 MB moved: arithmetic, ~0.33 ms at the bf16
// tensor-core peak.  This first version runs f32 FMAs on the CUDA cores (67
// TFLOP/s peak), so it is far from that bound; the tensor-core redesign is
// later work.  It keeps P and dS in f32 in the products that form dv and dk:
// P rounded to bf16 before P^T do moves dv by tens of bf16 ulps against the
// plain version, which the forward kernel avoids by splitting P into hi + lo.
//
// Three kernels, deterministic (no atomics):
//  * `delta_kernel`: delta [B,H,Sq] f32, one warp per row.
//  * `dkdv_kernel`: one block per (64-key tile, kv head, batch).  K and V stay
//    in shared memory; a loop walks the rep query heads and, for each, the
//    32-row q tiles that can see a key of the tile (causal: rows at or after
//    the tile; window: rows within `window` of it), recomputing P and dS and
//    accumulating dk and dv in registers.
//  * `dq_kernel`: one block per (64-row q tile, head, batch), walking the
//    32-key tiles that the rows can see (the forward's loop), accumulating dq.
// Tiles are staged in shared memory as f32 (bf16 inputs converted on load),
// rows padded by 16 B; threads form a 16 x 16 grid as in the forward's f32
// kernel.  dh up to 64 runs a 64-wide tile, up to 128 a 128-wide one,
// zero-padded (dh=120's tail is never written).  Ragged S and q_offset are
// masked element by element at the tiles that cross an edge.  A row with no
// visible key gets dq = 0 (the plain version gives it the uniform P of its
// masked keys: such rows never occur on a causal path).
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int NT = 256;  // threads of the dk/dv and dq kernels: 16 x 16, thread (ty, tx)

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

__device__ __forceinline__ float comp(float4 a, int u) {
    return u == 0 ? a.x : u == 1 ? a.y : u == 2 ? a.z : a.w;
}

// rows [row0, row0 + ROWS) of a [rows, dh] matrix -> shared [ROWS][DHP + 4] f32;
// rows at or past `nrows` and columns at or past dh are zero-filled
template <int DHP, int ROWS, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int64_t row_stride,
                                          int row0, int nrows, int dh) {
    constexpr int D4 = DHP / 4, LD = DHP + 4;
    for (int i = threadIdx.x; i < ROWS * D4; i += NT) {
        const int r = i / D4, d = (i % D4) * 4;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row0 + r < nrows && d < dh) x = ld4(src + (int64_t)(row0 + r) * row_stride + d);
        *reinterpret_cast<float4*>(dst + r * LD + d) = x;
    }
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

namespace dkdv {

constexpr int BK = 64;  // keys per block
constexpr int BQ = 32;  // q rows per step of the loop
constexpr int LDT = BQ + 4;

template <int DHP>
constexpr int smem_floats() { return (2 * BK + 2 * BQ) * (DHP + 4) + 2 * BK * LDT + 2 * BQ; }

template <typename T, int DHP>
__global__ void __launch_bounds__(NT, 1)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dO, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
            int Sq, int Sk, int H, int rep, int dh, const Strides st,
            float scale, int causal, int window, int q_offset) {
    constexpr int LD = DHP + 4, NJ = DHP / 64;
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
    const int k0 = blockIdx.x * BK;  // key tile 0 first: under a causal mask it sees the most rows
    const int g = blockIdx.y, b = blockIdx.z;
    const T* kb = k + b * st.v[3] + g * st.v[5];
    const T* vb = v + b * st.v[6] + g * st.v[8];
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
        const T* qb = q + b * st.v[0] + h * st.v[2];
        const T* db = dO + b * st.v[9] + h * st.v[11];
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

            // dv[key][d] += sum_q P dO, dk[key][d] += sum_q dS Q: keys ty + 16 i, columns tx * 4 + 64 j
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
                            &dOs[(qq + u) * LD + tx * 4 + 64 * j]);
                        const float4 x = *reinterpret_cast<const float4*>(
                            &Qs[(qq + u) * LD + tx * 4 + 64 * j]);
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
        T* krow = dk + b * st.v[12] + (int64_t)key * st.v[13] + g * st.v[14];
        T* vrow = dv + b * st.v[15] + (int64_t)key * st.v[16] + g * st.v[17];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int d = tx * 4 + 64 * j;
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

template <typename T, int DHP>
__global__ void __launch_bounds__(NT, 2)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dO, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq,
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
    const T* kb = k + b * st.v[3] + g * st.v[5];
    const T* vb = v + b * st.v[6] + g * st.v[8];
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
        T* qrow = dq + b * st.v[18] + (int64_t)row * st.v[19] + h * st.v[20];
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

template <typename T, int DHP>
cudaError_t launch(const T* q, const T* k, const T* v, const T* o, const T* dO,
                   const float* lse, float* delta, T* dq, T* dk, T* dv,
                   int B, int Sq, int Sk, int H, int KV, int dh, const Strides& st,
                   float scale, int causal, int window, int q_offset, cudaStream_t stream) {
    const int64_t* s = st.v;
    const int64_t rows = (int64_t)B * H * Sq;
    delta_kernel<T><<<(unsigned)((rows * 32 + 255) / 256), 256, 0, stream>>>(
        o, dO, delta, B, Sq, H, dh, s[21], s[22], s[23], s[9], s[10], s[11]);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    const int smem_kv = dkdv::smem_floats<DHP>() * (int)sizeof(float);
    err = cudaFuncSetAttribute(dkdv::dkdv_kernel<T, DHP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
    if (err != cudaSuccess) return err;
    if (Sk > 0) {
        dim3 grid((Sk + dkdv::BK - 1) / dkdv::BK, KV, B);
        dkdv::dkdv_kernel<T, DHP><<<grid, NT, smem_kv, stream>>>(
            q, k, v, dO, lse, delta, dk, dv, Sq, Sk, H, H / KV, dh, st, scale, causal,
            window, q_offset);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }

    const int smem_q = dq::smem_floats<DHP>() * (int)sizeof(float);
    err = cudaFuncSetAttribute(dq::dq_kernel<T, DHP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + dq::BQ - 1) / dq::BQ, H, B);
    dq::dq_kernel<T, DHP><<<grid, NT, smem_q, stream>>>(
        q, k, v, dO, lse, delta, dq, Sq, Sk, H, H / KV, dh, st, scale, causal, window,
        q_offset);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o, const void* dO,
                     const float* lse, float* delta, void* dq, void* dk, void* dv,
                     int B, int Sq, int Sk, int H, int KV, int dh, const Strides& st,
                     float scale, int causal, int window, int q_offset, cudaStream_t stream) {
    auto c = [](const void* p) { return static_cast<const T*>(p); };
    auto m = [](void* p) { return static_cast<T*>(p); };
    if (dh <= 64)
        return launch<T, 64>(c(q), c(k), c(v), c(o), c(dO), lse, delta, m(dq), m(dk), m(dv), B,
                             Sq, Sk, H, KV, dh, st, scale, causal, window, q_offset, stream);
    return launch<T, 128>(c(q), c(k), c(v), c(o), c(dO), lse, delta, m(dq), m(dk), m(dv), B, Sq,
                          Sk, H, KV, dh, st, scale, causal, window, q_offset, stream);
}

}  // namespace

// Dynamic shared memory of one block of the dk/dv kernel (which = 0) or the
// dq kernel (which = 1) at head dim dh, in bytes.
extern "C" int repro_flash_attention_bwd_smem_bytes(int which, int dh) {
    const int f = which == 0 ? (dh <= 64 ? dkdv::smem_floats<64>() : dkdv::smem_floats<128>())
                             : (dh <= 64 ? dq::smem_floats<64>() : dq::smem_floats<128>());
    return f * (int)sizeof(float);
}

// Keys per block of the dk/dv kernel (which = 0) or q rows per block of the
// dq kernel (which = 1).
extern "C" int repro_flash_attention_bwd_tile(int which) {
    return which == 0 ? dkdv::BK : dq::BQ;
}

// q, o, do [B,Sq,H,dh]; k, v [B,Sk,KV,dh]; lse [B,H,Sq] f32 contiguous (the
// forward's); delta [B,H,Sq] f32 scratch; dq [B,Sq,H,dh], dk and dv
// [B,Sk,KV,dh] outputs.  strides: 24 int64 in elements, (batch, seq, head) of
// q, k, v, do, dk, dv, dq, o in that order.  dtype: 0 = f32, 1 = bf16; rows
// start on 16-byte boundaries; in bf16 dh is a multiple of 8.  window <= 0
// means no window.  device is the CUDA ordinal of the tensors and the stream.  Returns
// cudaError_t.
extern "C" int repro_flash_attention_bwd(
        const void* q, const void* k, const void* v, const void* o, const void* dO,
        const float* lse, float* delta, void* dq, void* dk, void* dv, int dtype,
        int B, int Sq, int Sk, int H, int KV, int dh, const int64_t* strides, float scale,
        int causal, int window, int q_offset, int device, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    Strides st;
    for (int i = 0; i < 24; ++i) st.v[i] = strides[i];
    if (dh <= 0 || dh > 128 || dh % 4 || KV <= 0 || H % KV) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);  // this library's runtime keeps its own
    if (err != cudaSuccess) return (int)err;
    if (Sq <= 0 || B <= 0) return (int)cudaSuccess;
    if (dtype == REPRO_F32)
        return (int)dispatch<float>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, Sq, Sk, H, KV, dh,
                                    st, scale, causal, window, q_offset, s);
    if (dtype == REPRO_BF16) {
        if (dh % 8) return (int)cudaErrorInvalidValue;
        return (int)dispatch<bf16>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, Sq, Sk, H, KV, dh,
                                   st, scale, causal, window, q_offset, s);
    }
    return (int)cudaErrorInvalidValue;
}
