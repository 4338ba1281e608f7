// Mamba-2 SSD chunk scan for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel `_ssd_kernel` in src/repro/kernels/ssd_scan.py
// (launched by `_ssd_fwd`).  Same function as the plain version
// `repro_torch.kernels.ref.ssd_chunked`: for each (b, h), over the chunks
// of L positions in order, with cs the cumulative sum of dA = dt * a[h]
// inside the chunk and state the [P, N] state entering it,
//
//   y      = (C B^T * exp(cs_i - cs_j) [i >= j] * dt_j) X + (C state^T) * exp(cs_i)
//   state' = exp(cs_last) * state + (X * dt * exp(cs_last - cs))^T B
//
// and the state after the last chunk is the second output.  Head h reads
// group h / (H / G).  Every exponent is a difference cs_i - cs_j with
// i >= j, or cs itself, so it is never positive (a < 0, dt >= 0): no exp
// of a positive sum, as in the TPU kernel (cs reaches about -200 inside a
// chunk of mamba2-370m).
//
// What bounds it on an H100: at the prefill shape of mamba2-370m (B=1,
// S=32768, H=32, P=64, N=128, G=1, L=64) the function moves ~576 MB (x and
// y f32, B, C, dt) and needs ~39 GFLOP of f32 products (C B^T once per
// group and chunk, the causal halves); at the 67 TFLOP/s of f32 outside
// the tensor cores that is ~0.58 ms against ~0.17 ms for the bytes, so it
// is bound by arithmetic as long as the products run on the CUDA cores.
//
// Design.  The TPU kernel walks the chunks on a sequential grid axis and
// keeps the state in VMEM scratch; Hopper blocks run in no order, so here
// one block owns a (b, h, slice of PS = 16 rows of P) and loops over the
// chunks itself, with its [N, PS] slice of the state in shared memory.
// The rows p of the state are independent given B, C and dt, so the
// slices need no communication; that gives B*H*P/16 = 128 blocks at the
// prefill shape (132 SMs), where one block per (b, h) would give 32.  The
// price: each of a head's 4 blocks recomputes C B^T (64x64x128 FMAs per
// chunk, ~60 % of a block's products).  C and B of a chunk are held
// transposed ([N][L]) in dynamic shared memory (~100 KB at N=128, L=64,
// above the 48 KB of static shared memory), so that the 4x4 register tiles
// of C B^T read four consecutive positions with one float4; W is kept
// transposed and the state as [N][PS] for the same reason in the y and
// state phases.  With one block of 8 warps per SM nothing else hides the
// loads' latency, so each thread loads the next chunk's C, B, x and dt
// into registers while the block computes the current one.  Products are
// f32 FMAs on the CUDA cores; tensor cores (TF32 or bf16 wgmma) and a
// shared C B^T pass are later work.
//
// Layout: x [B,S,H,P], dt [B,S,H], B/C [B,S,G,N], y [B,S,H,P], h_init and
// state [B,H,P,N] are read and written through the strides given (x, B and
// C may be slices of the conv output [B,S,channels]); the last dim of each
// is unit-stride.  Positions >= S (a ragged last chunk) are read as x = B =
// C = dt = 0, which leaves the state exactly as the plain version's
// zero-padding with dt = 0 does, and their y is not written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PS = 16;      // state rows p per block
constexpr int NT = 256;     // threads: 16 x 16
constexpr int MAX_L = 64;   // chunk length
constexpr int MAX_N = 128;  // state width
constexpr int MAX_P = 64;   // head width

__host__ __device__ constexpr int row_ct(int L) { return L + 4; }  // row stride of Ct/Bt

__host__ __device__ constexpr size_t smem_floats(int L, int N) {
    return 2 * (size_t)N * row_ct(L)   // Ct, Bt  [N][L + 4]
           + (size_t)L * row_ct(L)     // Wt      [L][L + 4]
           + 2 * (size_t)L * PS        // Xs, Xw  [L][PS]
           + (size_t)N * PS            // Sst     [N][PS], the state transposed
           + 3 * (size_t)L;            // cs, dts, wd
}

struct Strides {
    int64_t xb, xs, xh, db, ds, dh, bb, bs, bg, cb, cs, cg, yb, ys, yh,
            hb, hh, hp, sb, sh, sp;
};

// One chunk's inputs as one thread holds them, with lane = tid % 32 and
// warp = tid / 32: C and B at rows s = warp + 8 ks and columns n = lane +
// 32 kn of the chunk's [L][N]; x at rows s = tid / 16 + 16 k and column
// p = tid % 16 of its [L][PS]; threads 0..31 hold dt at positions tid and
// tid + 32.  Positions >= S read as 0.
constexpr int KS = MAX_L / (NT / 32), KN = MAX_N / 32, KX = MAX_L / (NT / PS);
struct Chunk {
    float c[KS][KN], b[KS][KN], x[KX], d[2];
};

__device__ __forceinline__ void fetch_chunk(Chunk& f, const float* cb, const float* bb,
                                            const float* xb, const float* db, int s0, int S,
                                            int L, int N, int p_left, const Strides& sd,
                                            int tid) {
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
        const int s = warp + 8 * ks;
        const bool row = s < L && s0 + s < S;
        const float* crow = cb + (int64_t)(s0 + s) * sd.cs;
        const float* brow = bb + (int64_t)(s0 + s) * sd.bs;
#pragma unroll
        for (int kn = 0; kn < KN; ++kn) {
            const int n = lane + 32 * kn;
            f.c[ks][kn] = row && n < N ? crow[n] : 0.f;
            f.b[ks][kn] = row && n < N ? brow[n] : 0.f;
        }
    }
#pragma unroll
    for (int k = 0; k < KX; ++k) {
        const int s = (tid >> 4) + 16 * k, p = tid & 15;
        f.x[k] = s < L && s0 + s < S && p < p_left ? xb[(int64_t)(s0 + s) * sd.xs + p] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        const int s = tid + 32 * k;
        f.d[k] = tid < 32 && s < L && s0 + s < S ? db[(int64_t)(s0 + s) * sd.ds] : 0.f;
    }
}

// C and B transposed to [N][LC], x to [L][PS], dt to [L].
__device__ __forceinline__ void store_chunk(const Chunk& f, float* Ct, float* Bt, float* Xs,
                                            float* dts, int L, int N, int LC, int tid) {
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
        const int s = warp + 8 * ks;
#pragma unroll
        for (int kn = 0; kn < KN; ++kn) {
            const int n = lane + 32 * kn;
            if (s < L && n < N) {
                Ct[n * LC + s] = f.c[ks][kn];
                Bt[n * LC + s] = f.b[ks][kn];
            }
        }
    }
#pragma unroll
    for (int k = 0; k < KX; ++k) {
        const int s = (tid >> 4) + 16 * k;
        if (s < L) Xs[s * PS + (tid & 15)] = f.x[k];
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        const int s = tid + 32 * k;
        if (tid < 32 && s < L) dts[s] = f.d[k];
    }
}

__global__ void __launch_bounds__(NT)
ssd_chunk_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ a, const float* __restrict__ bm,
                      const float* __restrict__ cm, const float* __restrict__ h_init,
                      float* __restrict__ y, float* __restrict__ st,
                      int S, int H, int P, int G, int N, int L, Strides sd) {
    extern __shared__ float4 smem4[];
    const int LC = row_ct(L);
    float* Ct = reinterpret_cast<float*>(smem4);  // [N][LC]: C of the chunk, transposed
    float* Bt = Ct + N * LC;                       // [N][LC]
    float* Wt = Bt + N * LC;                       // [L][LC]: masked, decayed (C B^T * dt)^T
    float* Xs = Wt + L * LC;                       // [L][PS]: x
    float* Xw = Xs + L * PS;                       // [L][PS]: x * wd
    float* Sst = Xw + L * PS;                      // [N][PS]: state rows p0.. transposed
    float* cs = Sst + N * PS;                      // [L] cumulative dA
    float* dts = cs + L;                           // [L] dt
    float* wd = dts + L;                           // [L] dt * exp(cs_last - cs)

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
    const int g = h / (H / G);
    const float a_h = a[h];

    const float* xb = x + b * sd.xb + h * sd.xh + p0;
    const float* db = dt + b * sd.db + h * sd.dh;
    const float* bb = bm + b * sd.bb + g * sd.bg;
    const float* cb = cm + b * sd.cb + g * sd.cg;
    float* yb = y + b * sd.yb + h * sd.yh + p0;

    for (int i = tid; i < N * PS; i += NT) {
        const int n = i / PS, p = i % PS;
        float v = 0.f;
        if (h_init != nullptr && p0 + p < P) v = h_init[b * sd.hb + h * sd.hh + (p0 + p) * sd.hp + n];
        Sst[n * PS + p] = v;
    }

    // The chunk's C, B, x and dt are loaded into registers one chunk ahead,
    // so that their loads are in flight while the block computes the
    // previous chunk; each thread holds the same elements of every chunk.
    Chunk next;
    fetch_chunk(next, cb, bb, xb, db, 0, S, L, N, P - p0, sd, tid);
    const int nc = (S + L - 1) / L;
    for (int c = 0; c < nc; ++c) {
        __syncthreads();  // the previous chunk's tiles and state are no longer read
        store_chunk(next, Ct, Bt, Xs, dts, L, N, LC, tid);
        __syncthreads();
        const int s0 = c * L;
        if (c + 1 < nc) fetch_chunk(next, cb, bb, xb, db, s0 + L, S, L, N, P - p0, sd, tid);

        // ---- cumulative dA and the decay weights, by warp 0 ----
        if (tid < 32) {
            const int s_a = tid, s_b = tid + 32;
            const float d_a = s_a < L ? dts[s_a] : 0.f, d_b = s_b < L ? dts[s_b] : 0.f;
            float v_a = d_a * a_h, v_b = d_b * a_h;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {  // inclusive scans of both halves
                const float u_a = __shfl_up_sync(0xffffffffu, v_a, off);
                const float u_b = __shfl_up_sync(0xffffffffu, v_b, off);
                if (tid >= off) { v_a += u_a; v_b += u_b; }
            }
            v_b += __shfl_sync(0xffffffffu, v_a, 31);
            const float last = L > 32 ? __shfl_sync(0xffffffffu, v_b, L - 33)
                                      : __shfl_sync(0xffffffffu, v_a, L - 1);
            if (s_a < L) { cs[s_a] = v_a; wd[s_a] = d_a * expf(last - v_a); }
            if (s_b < L) { cs[s_b] = v_b; wd[s_b] = d_b * expf(last - v_b); }
        }
        __syncthreads();

        // ---- Wt[j][i] = C B^T * exp(cs_i - cs_j) * dt_j on and below the diagonal ----
        {
            const int i0 = ty * 4, j0 = tx * 4;
            if (i0 < L && j0 < L) {
                float acc[4][4] = {};
                if (j0 <= i0 + 3) {  // a tile wholly above the diagonal stays 0
#pragma unroll 4
                    for (int n = 0; n < N; ++n) {
                        const float4 cv = *reinterpret_cast<const float4*>(&Ct[n * LC + i0]);
                        const float4 bv = *reinterpret_cast<const float4*>(&Bt[n * LC + j0]);
                        const float ci[4] = {cv.x, cv.y, cv.z, cv.w};
                        const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
                        for (int r = 0; r < 4; ++r)
#pragma unroll
                            for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(ci[r], bj[q], acc[r][q]);
                    }
                }
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        const int i = i0 + r, j = j0 + q;
                        Wt[j * LC + i] = i >= j ? acc[r][q] * expf(cs[i] - cs[j]) * dts[j] : 0.f;
                    }
            }
            for (int i = tid; i < L * PS; i += NT) Xw[i] = Xs[i] * wd[i / PS];
        }
        __syncthreads();

        // ---- y = W X + exp(cs) * (C state^T): rows i0..i0+3 = 4 ty.., column p = tx ----
        if (ty * 4 < L) {
            const int i0 = ty * 4;
            float intra[4] = {}, inter[4] = {};
            for (int j = 0; j < min(L, i0 + 4); ++j) {  // Wt is 0 above the diagonal
                const float4 w = *reinterpret_cast<const float4*>(&Wt[j * LC + i0]);
                const float xv = Xs[j * PS + tx];
                intra[0] = fmaf(w.x, xv, intra[0]);
                intra[1] = fmaf(w.y, xv, intra[1]);
                intra[2] = fmaf(w.z, xv, intra[2]);
                intra[3] = fmaf(w.w, xv, intra[3]);
            }
#pragma unroll 4
            for (int n = 0; n < N; ++n) {
                const float4 c = *reinterpret_cast<const float4*>(&Ct[n * LC + i0]);
                const float sv = Sst[n * PS + tx];
                inter[0] = fmaf(c.x, sv, inter[0]);
                inter[1] = fmaf(c.y, sv, inter[1]);
                inter[2] = fmaf(c.z, sv, inter[2]);
                inter[3] = fmaf(c.w, sv, inter[3]);
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = i0 + r;
                if (s0 + i < S && p0 + tx < P)
                    yb[(int64_t)(s0 + i) * sd.ys + tx] = intra[r] + inter[r] * expf(cs[i]);
            }
        }
        __syncthreads();  // every read of the entering state is done

        // ---- state' = exp(cs_last) state + Xw^T B: rows n = ty + 16 r, column p = tx ----
        {
            constexpr int R = MAX_N / 16;
            float acc[R] = {};
            for (int s = 0; s < L; s += 4) {
                const float xw[4] = {Xw[s * PS + tx], Xw[(s + 1) * PS + tx],
                                     Xw[(s + 2) * PS + tx], Xw[(s + 3) * PS + tx]};
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const int n = ty + 16 * r;
                    if (n < N) {
                        const float4 bv = *reinterpret_cast<const float4*>(&Bt[n * LC + s]);
                        acc[r] = fmaf(xw[0], bv.x, acc[r]);
                        acc[r] = fmaf(xw[1], bv.y, acc[r]);
                        acc[r] = fmaf(xw[2], bv.z, acc[r]);
                        acc[r] = fmaf(xw[3], bv.w, acc[r]);
                    }
                }
            }
            const float decay = expf(cs[L - 1]);
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int n = ty + 16 * r;
                if (n < N) Sst[n * PS + tx] = decay * Sst[n * PS + tx] + acc[r];
            }
        }
    }
    __syncthreads();
    for (int i = tid; i < N * PS; i += NT) {
        const int n = i / PS, p = i % PS;
        if (p0 + p < P) st[b * sd.sb + h * sd.sh + (p0 + p) * sd.sp + n] = Sst[n * PS + p];
    }
}

}  // namespace

// Dynamic shared memory of one block for chunk L and state width N, in bytes.
extern "C" int repro_ssd_scan_smem_bytes(int L, int N) {
    return (int)(smem_floats(L, N) * sizeof(float));
}

// The limits of the kernel: chunk L a multiple of 4 in [4, 64], P in
// [1, 64], N in [1, 128].  The wrapper reads them from here.
extern "C" int repro_ssd_scan_limits(int* max_l, int* max_p, int* max_n) {
    *max_l = MAX_L;
    *max_p = MAX_P;
    *max_n = MAX_N;
    return 0;
}

// x [B,S,H,P], dt [B,S,H], a [H] (contiguous), bm/cm [B,S,G,N], h_init
// [B,H,P,N] or null, y [B,S,H,P], st [B,H,P,N]; all f32.  Strides in
// elements: (batch, seq, head) for x, dt, y; (batch, seq, group) for bm, cm;
// (batch, head, row) for h_init and st; the last dim is unit-stride.
// device is the CUDA ordinal of the tensors and the stream.  Returns
// cudaError_t.
extern "C" int repro_ssd_scan_fwd(
        const float* x, const float* dt, const float* a, const float* bm, const float* cm,
        const float* h_init, float* y, float* st,
        int B, int S, int H, int P, int G, int N, int L,
        int64_t xsb, int64_t xss, int64_t xsh, int64_t dsb, int64_t dss, int64_t dsh,
        int64_t bsb, int64_t bss, int64_t bsg, int64_t csb, int64_t css, int64_t csg,
        int64_t ysb, int64_t yss, int64_t ysh, int64_t hsb, int64_t hsh, int64_t hsp,
        int64_t ssb, int64_t ssh, int64_t ssp, int device, void* stream) {
    if (B < 0 || S < 0 || H <= 0 || G <= 0 || H % G || P <= 0 || P > MAX_P || N <= 0 ||
        N > MAX_N || L < 4 || L > MAX_L || L % 4)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);  // this library's runtime keeps its own
    if (err != cudaSuccess) return (int)err;
    if (B == 0) return (int)cudaSuccess;
    const size_t smem = smem_floats(L, N) * sizeof(float);
    err = cudaFuncSetAttribute(ssd_chunk_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const Strides sd{xsb, xss, xsh, dsb, dss, dsh, bsb, bss, bsg, csb, css, csg,
                     ysb, yss, ysh, hsb, hsh, hsp, ssb, ssh, ssp};
    dim3 grid((P + PS - 1) / PS, H, B);
    ssd_chunk_scan_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
        x, dt, a, bm, cm, h_init, y, st, S, H, P, G, N, L, sd);
    return (int)cudaGetLastError();
}
