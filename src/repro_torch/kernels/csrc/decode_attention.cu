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
// 3.35 TB/s).  What the design does about it:
//  * K and V are read exactly once, by 8-byte (bf16) or 16-byte (f32)
//    vector loads, coalesced along dh, with all rep query heads of the
//    bundle served from each loaded tile (no repeated K/V);
//  * the cache is split into chunks of 256 slots, one thread block each,
//    so B*KV*chunks blocks keep every SM streaming even when B*KV (64 at
//    the smoke shape) is below the 132 SMs; pass 1 writes unnormalised
//    (acc, m, l) partials in f32, pass 2 merges them with the split-K
//    rescale and normalises;
//  * a 64-slot tile whose mask is all false is not read at all, so a
//    cache that is mostly empty costs only its valid tiles.
// A chunk with no valid slot contributes (acc, m, l) = (0, NEG_INF, 0);
// if no slot at all is valid the output is 0.
#include "common.cuh"

namespace {

constexpr int CHUNK = 256;  // cache slots per block of pass 1
constexpr int TK = 64;      // slots per tile staged in shared memory
constexpr int NT = 256;
constexpr int MAXI = 8;     // rep <= 16 (two or four rep groups per block)

// q bundle, scores of a chunk, one K/V tile, and m, l of the bundle, in f32
size_t partial_smem_bytes(int rep, int dhp) {
    return (size_t)(rep * dhp + rep * CHUNK + TK * (dhp + 1) + 2 * rep) * sizeof(float);
}

template <typename T, int DHP>
__global__ void __launch_bounds__(NT)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, const uint8_t* __restrict__ valid,
                      float* __restrict__ acc_out, float* __restrict__ m_out,
                      float* __restrict__ l_out, int C, int rep, int dh, int nsplit,
                      int64_t qsb, int64_t qsh, int64_t ksb, int64_t ksc, int64_t ksh,
                      int64_t vsb, int64_t vsc, int64_t vsh, int64_t msb, int64_t msc,
                      float scale) {
    constexpr int LDT = DHP + 1;     // padded: lanes on consecutive slots hit distinct banks
    constexpr int NRG = NT / DHP;    // rep groups in the P.V pass
    constexpr int D4 = DHP / 4;
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);  // [rep][DHP]
    float* Ss = Qs + rep * DHP;                    // [rep][CHUNK] scores, then p
    float* Ts = Ss + rep * CHUNK;                  // [TK][LDT] K or V tile
    float* Ms = Ts + TK * LDT;                     // [rep]
    float* Ls = Ms + rep;                          // [rep]

    const int tid = threadIdx.x;
    const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
    const int c0 = split * CHUNK;
    const int n = min(CHUNK, C - c0);
    const T* kb = kc + b * ksb + g * ksh;
    const T* vb = vc + b * vsb + g * vsh;
    const uint8_t* mb = valid + b * msb;

    for (int i = tid; i < rep * D4; i += NT) {
        const int r = i / D4, d = (i % D4) * 4;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (d < dh) x = load4(q + b * qsb + (g * rep + r) * qsh + d);
        *reinterpret_cast<float4*>(&Qs[r * DHP + d]) = x;
    }

    // ---- scores: s[r][t] = q_r . k_t * scale, NEG_INF where masked ----
    bool any_valid = false;
    for (int t0 = 0; t0 < n; t0 += TK) {
        const int nt = min(TK, n - t0);
        const bool mine = tid < nt && mb[(c0 + t0 + tid) * msc] != 0;
        const bool tile_valid = __syncthreads_or(mine);  // also fences Ts reuse
        any_valid |= tile_valid;
        if (!tile_valid) {
            for (int i = tid; i < rep * TK; i += NT) {
                const int r = i / TK, t = i % TK;
                if (t < nt) Ss[r * CHUNK + t0 + t] = REPRO_NEG_INF;
            }
            continue;
        }
        for (int i = tid; i < TK * D4; i += NT) {
            const int t = i / D4, d = (i % D4) * 4;
            float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
            if (t < nt && d < dh) x = load4(kb + (c0 + t0 + t) * ksc + d);
            float* dst = &Ts[t * LDT + d];
            dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
        }
        __syncthreads();
        for (int i = tid; i < rep * TK; i += NT) {
            const int r = i / TK, t = i % TK;
            if (t >= nt) continue;
            const float* qr = &Qs[r * DHP];
            const float* kt = &Ts[t * LDT];
            float s = 0.f;
#pragma unroll 8
            for (int d = 0; d < DHP; ++d) s = fmaf(qr[d], kt[d], s);
            const bool ok = mb[(c0 + t0 + t) * msc] != 0;
            Ss[r * CHUNK + t0 + t] = ok ? s * scale : REPRO_NEG_INF;
        }
    }
    __syncthreads();

    const int64_t part = ((int64_t)(b * gridDim.y + g) * nsplit + split) * rep;
    if (!__syncthreads_or(any_valid)) {
        for (int i = tid; i < rep * dh; i += NT) acc_out[part * dh + i] = 0.f;
        for (int r = tid; r < rep; r += NT) {
            m_out[part + r] = REPRO_NEG_INF;
            l_out[part + r] = 0.f;
        }
        return;
    }

    // ---- per head of the bundle: m = max s, p = exp(s - m), l = sum p ----
    const int warp = tid >> 5, lane = tid & 31;
    for (int r = warp; r < rep; r += NT / 32) {
        float* sr = &Ss[r * CHUNK];
        float mx = REPRO_NEG_INF;
        for (int t = lane; t < n; t += 32) mx = fmaxf(mx, sr[t]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        float sum = 0.f;
        for (int t = lane; t < n; t += 32) {
            const float p = expf(sr[t] - mx);
            sr[t] = p;
            sum += p;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
            Ms[r] = mx;
            Ls[r] = sum;
        }
    }

    // ---- acc[r][d] = sum_t p[r][t] v[t][d]; thread owns d and rep group rg ----
    const int d = tid % DHP, rg = tid / DHP;
    float acc[MAXI];
#pragma unroll
    for (int i = 0; i < MAXI; ++i) acc[i] = 0.f;
    for (int t0 = 0; t0 < n; t0 += TK) {
        const int nt = min(TK, n - t0);
        const bool mine = tid < nt && mb[(c0 + t0 + tid) * msc] != 0;
        if (!__syncthreads_or(mine)) continue;  // every p of this tile is 0
        for (int i = tid; i < TK * D4; i += NT) {
            const int t = i / D4, dd = (i % D4) * 4;
            float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
            if (t < nt && dd < dh) x = load4(vb + (c0 + t0 + t) * vsc + dd);
            float* dst = &Ts[t * LDT + dd];
            dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
        }
        __syncthreads();
        for (int t = 0; t < nt; ++t) {
            const float w = Ts[t * LDT + d];
#pragma unroll
            for (int i = 0; i < MAXI; ++i) {
                const int r = rg + NRG * i;
                if (r < rep) acc[i] = fmaf(Ss[r * CHUNK + t0 + t], w, acc[i]);
            }
        }
    }

    if (d < dh) {
#pragma unroll
        for (int i = 0; i < MAXI; ++i) {
            const int r = rg + NRG * i;
            if (r < rep) acc_out[(part + r) * dh + d] = acc[i];
        }
    }
    for (int r = tid; r < rep; r += NT) {
        m_out[part + r] = Ms[r];
        l_out[part + r] = Ls[r];
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

template <typename T, int DHP>
cudaError_t launch(const void* q, const void* kc, const void* vc, const void* valid,
                   void* out, float* acc_p, float* m_p, float* l_p, int B, int C, int H,
                   int KV, int dh, const int64_t* st, float scale, cudaStream_t stream) {
    const int rep = H / KV;
    const int nsplit = (C + CHUNK - 1) / CHUNK;
    const size_t smem = partial_smem_bytes(rep, DHP);
    cudaError_t err = cudaFuncSetAttribute(decode_partial_kernel<T, DHP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    decode_partial_kernel<T, DHP><<<dim3(nsplit, KV, B), NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
        static_cast<const uint8_t*>(valid), acc_p, m_p, l_p, C, rep, dh, nsplit,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    decode_combine_kernel<T><<<dim3(rep, KV, B), 128, 0, stream>>>(
        acc_p, m_p, l_p, static_cast<T*>(out), rep, dh, nsplit, st[10], st[11]);
    return cudaGetLastError();
}

}  // namespace

extern "C" int repro_decode_num_splits(int C) { return (C + CHUNK - 1) / CHUNK; }

// Most query heads per kv head that one pass-1 block holds in its registers.
extern "C" int repro_decode_max_rep() { return 2 * MAXI; }

// Dynamic shared memory of one pass-1 block, in bytes.
extern "C" int repro_decode_attention_smem_bytes(int rep, int dh) {
    return (int)partial_smem_bytes(rep, dh <= 64 ? 64 : 128);
}

// q [B,1,H,dh]; k/v cache [B,C,KV,dh]; valid [B,C] uint8; out [B,1,H,dh].
// Strides in elements: q (batch, head), k and v (batch, slot, head), valid
// (batch, slot), out (batch, head); the head dim is unit-stride.  acc_p
// [B,KV,nsplit,rep,dh], m_p and l_p [B,KV,nsplit,rep] are f32 scratch with
// nsplit = repro_decode_num_splits(C).  dtype: 0 = f32, 1 = bf16.  device is
// the CUDA ordinal the tensors and the stream belong to.
extern "C" int repro_decode_attention_fwd(
        const void* q, const void* kc, const void* vc, const void* valid, void* out,
        void* acc_p, void* m_p, void* l_p, int dtype, int B, int C, int H, int KV, int dh,
        int64_t qsb, int64_t qsh, int64_t ksb, int64_t ksc, int64_t ksh,
        int64_t vsb, int64_t vsc, int64_t vsh, int64_t msb, int64_t msc,
        int64_t osb, int64_t osh, float scale, int device, void* stream) {
    const int64_t st[12] = {qsb, qsh, ksb, ksc, ksh, vsb, vsc, vsh, msb, msc, osb, osh};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dh <= 0 || dh > 128 || dh % 4 || H % KV || H / KV > repro_decode_max_rep() || C <= 0)
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
