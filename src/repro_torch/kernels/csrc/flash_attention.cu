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
// it is bound by arithmetic.  What the design does about it: the [S, S]
// score matrix never leaves the SM (scores and probabilities live in
// registers and shared memory), K/V tiles are read once per 64-row q tile
// and shared by all of its rows, and KV tiles wholly above the causal
// diagonal or wholly left of the window are never loaded (the TPU kernel's
// `relevant` test).  This first version does the products with f32 FMAs on
// the CUDA cores (67 TFLOP/s peak), not on the tensor cores; moving them to
// bf16 mma/wgmma tiles is later work.
//
// Layout: one thread block per (q tile of 64 rows, head h, batch b); a loop
// inside the block walks the KV tiles of 32 keys (the TPU grid's sequential
// axis).  GQA: head h reads kv head h / rep, K/V are never repeated.  q, k,
// v and o are read and written in their [B, S, heads, dh] layout through
// the strides given; ragged S is masked here (no fallback), and a head dim
// below 128 that is a multiple of 4 (e.g. 120) is zero-padded to a 64- or
// 128-wide tile whose tail is never written.  A row that has no unmasked
// key at all (only possible with a window and q_offset beyond Sk) gets 0.
#include "common.cuh"

namespace {

constexpr int BQ = 64;   // q rows per block
constexpr int BK = 32;   // keys per KV tile
constexpr int NT = 256;  // threads: 16 x 16, thread (ty, tx)
constexpr int LDP = BK + 4;

template <int DHP>
constexpr int smem_floats() { return BQ * (DHP + 4) + 2 * BK * (DHP + 4) + BQ * LDP; }

template <typename T, int DHP>
__global__ void __launch_bounds__(NT, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
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

    const T* qb = q + b * qsb + h * qsh;
    const T* kb = k + b * ksb + g * ksh;
    const T* vb = v + b * vsb + g * vsh;

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
        T* orow = o + b * osb + row * oss + h * osh;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int d = tx * 4 + 64 * j;
            if (d >= dh) continue;
#pragma unroll
            for (int e = 0; e < 4; ++e) store1(orow + d + e, acc[i][j][e] / l);
        }
    }
}

template <typename T, int DHP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int KV, int dh, const int64_t* st,
                   float scale, int causal, int window, int q_offset,
                   cudaStream_t stream) {
    const size_t smem = smem_floats<DHP>() * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DHP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + BQ - 1) / BQ, H, B);
    flash_fwd_kernel<T, DHP><<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), Sq, Sk, H / KV, dh,
        st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], st[9], st[10], st[11],
        scale, causal, window, q_offset);
    return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block for head dim dh, in bytes.
extern "C" int repro_flash_attention_smem_bytes(int dh) {
    return (dh <= 64 ? smem_floats<64>() : smem_floats<128>()) * (int)sizeof(float);
}

// q [B,Sq,H,dh], k/v [B,Sk,KV,dh], o [B,Sq,H,dh]; strides in elements as
// (batch, seq, head) for q, k, v, o in that order; the head dim is unit-stride.
// dtype: 0 = f32, 1 = bf16.  window <= 0 means no window.  device is the CUDA
// ordinal the tensors and the stream belong to.  Returns cudaError_t.
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
        return dh <= 64 ? launch<float, 64>(q, k, v, o, B, Sq, Sk, H, KV, dh, st, scale, causal,
                                            window, q_offset, s)
                        : launch<float, 128>(q, k, v, o, B, Sq, Sk, H, KV, dh, st, scale,
                                             causal, window, q_offset, s);
    }
    if (dtype == REPRO_BF16) {
        return dh <= 64 ? launch<__nv_bfloat16, 64>(q, k, v, o, B, Sq, Sk, H, KV, dh, st, scale,
                                                    causal, window, q_offset, s)
                        : launch<__nv_bfloat16, 128>(q, k, v, o, B, Sq, Sk, H, KV, dh, st,
                                                     scale, causal, window, q_offset, s);
    }
    return (int)cudaErrorInvalidValue;
}
