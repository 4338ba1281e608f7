// Gradient of the Mamba-2 SSD chunk scan for Hopper (sm_90a), f32 in and out.
//
// Replaces the backward of the TPU kernel's custom VJP, `_ssd_vjp_bwd` in
// src/repro/kernels/ssd_scan.py, which XLA recomputes through the VJP of the
// oracle `ssd_chunked`.  Same function as the plain version
// `repro_torch.kernels.ref.ssd_chunked_bwd`.  For each (b, h) and each chunk
// of L positions, with cs the in-chunk cumulative sum of dA = dt * a_h, u_j =
// dt_j x_j, S the state entering the chunk and G the cotangent of the state
// leaving it (for the last chunk, d(final state)), the forward is
//
//   y_i = sum_{j<=i} (C_i . B_j) e^{cs_i - cs_j} u_j + e^{cs_i} S C_i
//   S'  = e^{cs_last} S + sum_j e^{cs_last - cs_j} u_j (x) B_j
//
// and, with E_ij = e^{cs_i - cs_j} [i >= j], A = (C B^T) o E and Mq_ij =
// E_ij (dy_i . u_j), the backward:
//
//   dS   = e^{cs_last} G + sum_i e^{cs_i} dy_i (x) C_i     (carried in reverse)
//   du_j = sum_i A_ij dy_i + e^{cs_last - cs_j} G B_j;   dx = dt du
//   dC_i = sum_j Mq_ij B_j + e^{cs_i} S^T dy_i
//   dB_j = sum_i Mq_ij C_i + e^{cs_last - cs_j} G^T u_j
//   d(dA)_k = sum_{i>=k, j<k} M_ij + sum_{i>=k} e^{cs_i} C_i . (S^T dy_i)
//             + sum_{j<k} T_j + e^{cs_last} <G, S>,
//          M = (C B^T) o Mq,  T_j = e^{cs_last - cs_j} u_j . (G B_j)
//   ddt  = x . du + a_h d(dA);   da_h = sum over b and s of dt d(dA)
//
// and dB, dC summed over the H/G heads of a group; dh_init is the dS of the
// first chunk.  d(dA) is the reverse cumulative sum of the decays' gradient
// dcs (+M_ij at i and -M_ij at j, -T_j at j and +sum_j T_j at the last
// position), but taken as above: a pair (i, j) with both ends past k, and
// M's diagonal, cancel exactly there and are never added, where the
// difference of the two cumulative sums would leave their rounding (at
// jamba's a = -(1..128), where M is almost all diagonal, 6.6x the
// tolerance on da on an H100).  Every exponent is a difference cs_i - cs_j with i >= j, or
// cs itself, so it is never positive (a < 0, dt >= 0).
//
// What bounds it on an H100: at mamba2-370m's training shape (B=1, S=4096,
// H=32, P=64, N=128, G=1, L=64: 64 chunks) the function reads x, dy, dt, B,
// C and d(final state) and writes dx, ddt, dB, dC, ~111 MB (0.033 ms at
// 3.35 TB/s), and needs ~14 GFLOP of products, the entering states
// recomputed (0.028 ms at the 495 TFLOP/s of TF32): bytes, by a little.
//
// Design: five passes on one stream; every chunk of every head is a block of
// its own, so a call fills the card with B * H * nc blocks (2048 at the
// training shape), and the two sequential recurrences over the chunks
// (states forward, their cotangents in reverse) are elementwise passes:
//
//   1. ssd_bwd_local_kernel, one block per (b, h, chunk): the chunk's cs
//      (a warp scan), its local state sum_j e^{cs_last - cs_j} u_j (x) B_j,
//      its local state cotangent sum_i e^{cs_i} dy_i (x) C_i and its decay
//      e^{cs_last}, into a workspace [B, H, nc, P, N] each (67 MB each at
//      the training shape).
//   2. ssd_bwd_scan_kernel, one thread per (b, h, p, n): forward over the
//      chunks, each local state replaced by the state entering its chunk
//      (from h_init or 0); then in reverse, each local cotangent replaced by
//      the cotangent of the state leaving its chunk (from d(final state));
//      the last carried cotangent is dh_init.  A segment is one chunk.
//   3. ssd_bwd_chunk_kernel, one block per (b, h, chunk): from the chunk's
//      tiles, S and G, the products above; dx and ddt written, dB and dC per
//      head into the workspace, da as one partial sum per block.
//   4. ssd_bwd_group_kernel: dB and dC summed over each group's heads.
//   5. ssd_bwd_da_kernel: da summed over its partials, one warp a head.
//
// Sums across blocks go through a second pass in a fixed order, never
// atomics, so a gradient is the same from run to run.
//
// Products: f32 FMAs on the CUDA cores from shared memory (no tensor
// cores), each thread a 4 x 4 or 4 x 8 register tile whose operands are
// read four at a time (float4) and broadcast within a warp or spread over
// distinct banks (tile rows 4 mod 32 floats apart).  Pass 3 holds C, B, S
// and G ([64][132] each), x, dy, A and Mq ([64][68]) in 207 KB of shared
// memory: one block of 8 warps an SM, which is what bounds it, with C B^T
// computed per head (not once per group) and every tile recomputed from
// device memory rather than from the forward.  What it trades away for
// simplicity: the tensor cores (3xTF32 as in the forward) and occupancy.
// At the training shape a call takes 2.19 ms of device time on an H100 SXM
// (chip_smoke.py), 1.43 of it in pass 3, 0.43 in pass 1, 0.27 in pass 2.
//
// Layout: x, dy [B,S,H,P], dt [B,S,H], B/C [B,S,G,N], h_init, dstate
// [B,H,P,N] are read through the strides given (x, B and C may be slices of
// the conv output), unit-stride in the last dim; the gradients are written
// contiguous.  Positions >= S (a ragged last chunk) are read as x = dy = B
// = C = dt = 0, as the plain version's zero-padding with dt = 0, and their
// gradients are not written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;              // threads of passes 1, 2, 3 and 4: 8 warps
constexpr int MAX_L = 64;            // chunk length
constexpr int MAX_P = 64;            // head width
constexpr int MAX_N = 128;           // state width
constexpr int LDN = MAX_N + 4;       // rows along n: 4 mod 32 floats apart
constexpr int LDP = MAX_P + 4;       // rows along p
constexpr int LDL = MAX_L + 4;       // rows along j
constexpr int SCAN_BATCH = 8;        // chunks whose loads pass 2 starts together

// Shared memory of passes 1 and 3, in floats.
constexpr int SMEM_LOCAL = 2 * MAX_L * LDP + 2 * MAX_L * LDN + 5 * MAX_L;
constexpr int SCALARS = 9 * MAX_L + 8;  // see ssd_bwd_chunk_kernel
constexpr int SMEM_CHUNK = 2 * MAX_L * LDN + 2 * MAX_P * LDN + 2 * MAX_L * LDP + 2 * MAX_L * LDL +
                           SCALARS;

struct Strides {
    int64_t xb, xs, xh, db, ds, dh, bb, bs, bg, cb, cs, cg, yb, ys, yh, hb, hh, hp, gb, gh, gp;
};

struct Shape {
    int B, S, H, P, G, N, L, nc;
};

// The workspace: entering states, cotangents leaving, decays and da partials
// per (b, h, chunk); dB and dC per head over the padded sequence.
struct Work {
    float *st, *ct, *dec, *dap, *dbh, *dch;
};

Work carve(float* ws, const Shape& sh) {
    const int64_t states = (int64_t)sh.B * sh.H * sh.nc * sh.P * sh.N;
    const int64_t chunks = (int64_t)sh.B * sh.H * sh.nc;
    const int64_t heads = (int64_t)sh.B * sh.nc * sh.L * sh.H * sh.N;
    Work w;
    w.st = ws;
    w.ct = w.st + states;
    w.dec = w.ct + states;
    w.dap = w.dec + chunks;
    w.dbh = w.dap + chunks;
    w.dch = w.dbh + heads;
    return w;
}

int64_t workspace_floats(const Shape& sh) {
    return 2 * (int64_t)sh.B * sh.H * sh.nc * sh.P * sh.N + 2 * (int64_t)sh.B * sh.H * sh.nc +
           2 * (int64_t)sh.B * sh.nc * sh.L * sh.H * sh.N;
}

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at4(const float4& v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// The sum over the 16 lanes of a half-warp, in a fixed order.
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// Rows [0, R) x columns [0, C) of a shared tile (rows ld floats apart):
// element (r, c) is src[r * rs + c] where r < vr and c < vc, else 0.
template <int R, int C>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, int64_t rs,
                                          int vr, int vc) {
    for (int e = threadIdx.x; e < R * C; e += blockDim.x) {
        const int r = e / C, c = e % C;
        dst[r * ld + c] = r < vr && c < vc ? src[r * rs + c] : 0.f;
    }
}

// Warp 0: cs (the inclusive cumulative sum of dA = dt * a_h, the products
// rounded to f32 and summed in f64) as an f32 pair hi + lo, and dt, at the
// chunk's MAX_L positions; positions >= valid have dt = 0, so cs stays at
// its last value there.  A decay e^{cs_i - cs_j} takes its exponent as
// (hi_i - hi_j) + (lo_i - lo_j) (decay_exp), within an f32 ulp of the
// exponent however large cs grows: from a single f32 cs its error is an ulp
// of cs itself (3e-5 where cs reaches -330 within a chunk at jamba's a =
// -128), which read 0.7 of the tolerance on ddt and 1.2 on da on an H100.
__device__ __forceinline__ void chunk_scan(float* cs, float* csl, float* dts, const float* dtp,
                                           int64_t ds, float ah, int valid) {
    const int lane = threadIdx.x & 31;
    const float d0 = lane < valid ? dtp[lane * ds] : 0.f;
    const float d1 = lane + 32 < valid ? dtp[(lane + 32) * ds] : 0.f;
    double v0 = (double)(d0 * ah), v1 = (double)(d1 * ah);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const double u0 = __shfl_up_sync(0xffffffffu, v0, off);
        const double u1 = __shfl_up_sync(0xffffffffu, v1, off);
        if (lane >= off) {
            v0 += u0;
            v1 += u1;
        }
    }
    v1 += __shfl_sync(0xffffffffu, v0, 31);
    const float h0 = (float)v0, h1 = (float)v1;
    cs[lane] = h0;
    cs[lane + 32] = h1;
    csl[lane] = (float)(v0 - (double)h0);
    csl[lane + 32] = (float)(v1 - (double)h1);
    dts[lane] = d0;
    dts[lane + 32] = d1;
}

// The exponent cs_i - cs_j of a decay, from chunk_scan's hi + lo pairs.
__device__ __forceinline__ float decay_exp(const float* cs, const float* csl, int i, int j) {
    return (cs[i] - cs[j]) + (csl[i] - csl[j]);
}

// ---- pass 1: each chunk's local state, local state cotangent and decay ----

__global__ void __launch_bounds__(NT)
ssd_bwd_local_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const float* __restrict__ bm,
                     const float* __restrict__ cm, const float* __restrict__ dy, Work w,
                     Shape sh, Strides sd) {
    extern __shared__ float4 smem4[];
    float* Xs = reinterpret_cast<float*>(smem4);  // [MAX_L][LDP]
    float* DYs = Xs + MAX_L * LDP;                 // [MAX_L][LDP]
    float* Bs = DYs + MAX_L * LDP;                 // [MAX_L][LDN]
    float* Cs = Bs + MAX_L * LDN;                  // [MAX_L][LDN]
    float* cs = Cs + MAX_L * LDN;
    float* csl = cs + MAX_L;
    float* dts = csl + MAX_L;
    float* win = dts + MAX_L;   // e^{cs_i}
    float* wout = win + MAX_L;  // dt_j e^{cs_last - cs_j}
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, g = h / (sh.H / sh.G);
    const int s0 = c * sh.L, valid = min(sh.L, sh.S - s0);

    load_tile<MAX_L, MAX_P>(Xs, LDP, x + b * sd.xb + h * sd.xh + s0 * sd.xs, sd.xs, valid, sh.P);
    load_tile<MAX_L, MAX_P>(DYs, LDP, dy + b * sd.yb + h * sd.yh + s0 * sd.ys, sd.ys, valid,
                            sh.P);
    load_tile<MAX_L, MAX_N>(Bs, LDN, bm + b * sd.bb + g * sd.bg + s0 * sd.bs, sd.bs, valid, sh.N);
    load_tile<MAX_L, MAX_N>(Cs, LDN, cm + b * sd.cb + g * sd.cg + s0 * sd.cs, sd.cs, valid, sh.N);
    if (threadIdx.x < 32)
        chunk_scan(cs, csl, dts, dt + b * sd.db + h * sd.dh + (int64_t)s0 * sd.ds, sd.ds, a[h],
                   valid);
    __syncthreads();
    if (threadIdx.x < MAX_L) {
        const int i = threadIdx.x;
        win[i] = expf(cs[i]);
        wout[i] = dts[i] * expf(decay_exp(cs, csl, sh.L - 1, i));
    }
    __syncthreads();

    // this thread's rows p0..p0+3 and columns n0..n0+3, 64+n0..64+n0+3
    const int p0 = 4 * (threadIdx.x >> 4), n0 = 4 * (threadIdx.x & 15);
    float fs[4][8] = {}, bs[4][8] = {};
    for (int l = 0; l < sh.L; ++l) {
        const float4 xv = ld4(Xs + l * LDP + p0), yv = ld4(DYs + l * LDP + p0);
        const float4 b0 = ld4(Bs + l * LDN + n0), b1 = ld4(Bs + l * LDN + 64 + n0);
        const float4 c0 = ld4(Cs + l * LDN + n0), c1 = ld4(Cs + l * LDN + 64 + n0);
        const float wo = wout[l], wi = win[l];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const float xr = at4(xv, r) * wo, yr = at4(yv, r) * wi;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                fs[r][k] += xr * at4(b0, k);
                fs[r][k + 4] += xr * at4(b1, k);
                bs[r][k] += yr * at4(c0, k);
                bs[r][k + 4] += yr * at4(c1, k);
            }
        }
    }
    const int64_t blk = ((int64_t)b * sh.H + h) * sh.nc + c;
    float* so = w.st + blk * sh.P * sh.N;
    float* co = w.ct + blk * sh.P * sh.N;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int p = p0 + r;
        if (p >= sh.P) continue;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const int n = (k < 4 ? n0 : 64 + n0 - 4) + k;
            if (n < sh.N) {
                so[p * sh.N + n] = fs[r][k];
                co[p * sh.N + n] = bs[r][k];
            }
        }
    }
    if (threadIdx.x == 0) w.dec[blk] = expf(cs[sh.L - 1]);
}

// ---- pass 2: the states entering and the cotangents leaving each chunk ----

__global__ void __launch_bounds__(NT)
ssd_bwd_scan_kernel(const float* __restrict__ h_init, const float* __restrict__ dstate,
                    float* __restrict__ dh_init, Work w, Shape sh, Strides sd) {
    const int i = blockIdx.x * NT + threadIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int pn = sh.P * sh.N;
    if (i >= pn) return;
    const int p = i / sh.N, n = i - p * sh.N;
    const int64_t bh = (int64_t)b * sh.H + h;
    const float* dec = w.dec + bh * sh.nc;
    float* st = w.st + bh * sh.nc * pn + i;
    float* ct = w.ct + bh * sh.nc * pn + i;
    // each batch's loads start before its stores: a thread walks the
    // chunks in order, and one load at a time left it waiting on each
    float s = h_init != nullptr ? h_init[b * sd.hb + h * sd.hh + p * sd.hp + n] : 0.f;
    for (int c0 = 0; c0 < sh.nc; c0 += SCAN_BATCH) {
        float local[SCAN_BATCH], d[SCAN_BATCH];
#pragma unroll
        for (int k = 0; k < SCAN_BATCH; ++k)
            if (c0 + k < sh.nc) {
                local[k] = st[(int64_t)(c0 + k) * pn];
                d[k] = dec[c0 + k];
            }
#pragma unroll
        for (int k = 0; k < SCAN_BATCH; ++k)
            if (c0 + k < sh.nc) {
                st[(int64_t)(c0 + k) * pn] = s;
                s = local[k] + d[k] * s;
            }
    }
    float gc = dstate[b * sd.gb + h * sd.gh + p * sd.gp + n];
    for (int c1 = sh.nc - 1; c1 >= 0; c1 -= SCAN_BATCH) {
        float local[SCAN_BATCH], d[SCAN_BATCH];
#pragma unroll
        for (int k = 0; k < SCAN_BATCH; ++k)
            if (c1 - k >= 0) {
                local[k] = ct[(int64_t)(c1 - k) * pn];
                d[k] = dec[c1 - k];
            }
#pragma unroll
        for (int k = 0; k < SCAN_BATCH; ++k)
            if (c1 - k >= 0) {
                ct[(int64_t)(c1 - k) * pn] = gc;
                gc = d[k] * gc + local[k];
            }
    }
    if (dh_init != nullptr) dh_init[bh * pn + i] = gc;
}

// ---- pass 3: the gradients of one chunk of one head ----

__global__ void __launch_bounds__(NT, 1)
ssd_bwd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const float* __restrict__ bm,
                     const float* __restrict__ cm, const float* __restrict__ dy,
                     float* __restrict__ dx, float* __restrict__ ddt, Work w, Shape sh,
                     Strides sd) {
    extern __shared__ float4 smem4[];
    float* Cs = reinterpret_cast<float*>(smem4);  // [MAX_L][LDN]
    float* Bs = Cs + MAX_L * LDN;                  // [MAX_L][LDN]
    float* Ss = Bs + MAX_L * LDN;                  // [MAX_P][LDN]: the entering state
    float* Gs = Ss + MAX_P * LDN;                  // [MAX_P][LDN]: the cotangent leaving
    float* Xs = Gs + MAX_P * LDN;                  // [MAX_L][LDP]
    float* DYs = Xs + MAX_L * LDP;                 // [MAX_L][LDP]
    float* As = DYs + MAX_L * LDP;                 // [MAX_L][LDL]: (C B^T) o E
    float* Mqs = As + MAX_L * LDL;                 // [MAX_L][LDL]: E o (dy u^T)
    float* cs = Mqs + MAX_L * LDL;
    float* csl = cs + MAX_L;
    float* dts = csl + MAX_L;
    float* ein = dts + MAX_L;    // e^{cs_i}
    float* eout = ein + MAX_L;   // e^{cs_last - cs_j}
    float* straddle = eout + MAX_L;  // sum_{i>=k, j<k} M_ij
    float* inter = straddle + MAX_L;  // e^{cs_i} C_i . (S^T dy_i)
    float* tj = inter + MAX_L;        // T_j
    float* xdu = tj + MAX_L;          // x_j . du_j
    float* red = xdu + MAX_L;         // [8]: per-warp partial sums of <G, S>
    float* Ms = Ss;  // [MAX_L][LDL]: M, then its rows' prefix sums, before S is loaded
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, g = h / (sh.H / sh.G);
    const int L = sh.L, s0 = c * L, valid = min(L, sh.S - s0);
    const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
    const int n4 = (sh.N + 3) & ~3, p4 = (sh.P + 3) & ~3;
    const int64_t blk = ((int64_t)b * sh.H + h) * sh.nc + c;

    load_tile<MAX_L, MAX_N>(Cs, LDN, cm + b * sd.cb + g * sd.cg + s0 * sd.cs, sd.cs, valid, sh.N);
    load_tile<MAX_L, MAX_N>(Bs, LDN, bm + b * sd.bb + g * sd.bg + s0 * sd.bs, sd.bs, valid, sh.N);
    load_tile<MAX_P, MAX_N>(Gs, LDN, w.ct + blk * sh.P * sh.N, sh.N, sh.P, sh.N);
    load_tile<MAX_L, MAX_P>(Xs, LDP, x + b * sd.xb + h * sd.xh + s0 * sd.xs, sd.xs, valid, sh.P);
    load_tile<MAX_L, MAX_P>(DYs, LDP, dy + b * sd.yb + h * sd.yh + s0 * sd.ys, sd.ys, valid,
                            sh.P);
    const float ah = a[h];
    if (threadIdx.x < 32)
        chunk_scan(cs, csl, dts, dt + b * sd.db + h * sd.dh + (int64_t)s0 * sd.ds, sd.ds, ah,
                   valid);
    __syncthreads();
    const float last = cs[L - 1];
    if (threadIdx.x < MAX_L) {
        ein[threadIdx.x] = expf(cs[threadIdx.x]);
        eout[threadIdx.x] = expf(decay_exp(cs, csl, L - 1, threadIdx.x));
    }

    // (a) rows i = 4 tr + r, columns j = tc + 16 q: C B^T and dy x^T, then
    // A = (C B^T) o E, Mq = (dy x^T) dt_j o E and M = (C B^T) o Mq below the
    // diagonal
    {
        float cb[4][4] = {}, q[4][4] = {};
        for (int k = 0; k < n4; k += 4) {
            float4 cv[4], bv[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) cv[r] = ld4(Cs + (4 * tr + r) * LDN + k);
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = ld4(Bs + (tc + 16 * j) * LDN + k);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int j = 0; j < 4; ++j) cb[r][j] += dot4(cv[r], bv[j]);
        }
        for (int k = 0; k < p4; k += 4) {
            float4 yv[4], xv[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) yv[r] = ld4(DYs + (4 * tr + r) * LDP + k);
#pragma unroll
            for (int j = 0; j < 4; ++j) xv[j] = ld4(Xs + (tc + 16 * j) * LDP + k);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int j = 0; j < 4; ++j) q[r][j] += dot4(yv[r], xv[j]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int i = 4 * tr + r;
#pragma unroll
            for (int jq = 0; jq < 4; ++jq) {
                const int j = tc + 16 * jq;
                float av = 0.f, mq = 0.f;
                if (j <= i && i < L) {
                    const float e = expf(decay_exp(cs, csl, i, j));
                    av = cb[r][jq] * e;
                    mq = q[r][jq] * dts[j] * e;
                }
                As[i * LDL + j] = av;
                Mqs[i * LDL + j] = mq;
                Ms[i * LDL + j] = j < i ? cb[r][jq] * mq : 0.f;
            }
        }
    }
    __syncthreads();  // A, Mq and M are in
    // the straddling sums: each row of M to its exclusive prefix sums over j,
    // then straddle[k] = sum over rows i >= k of row i's prefix at k
    if (threadIdx.x < MAX_L) {
        float* row = Ms + threadIdx.x * LDL;
        float run = 0.f;
        for (int j = 0; j < MAX_L; ++j) {
            const float m = row[j];
            row[j] = run;
            run += m;
        }
    }
    __syncthreads();
    if (threadIdx.x < MAX_L) {
        float sk = 0.f;
        for (int i = threadIdx.x; i < MAX_L; ++i) sk += Ms[i * LDL + threadIdx.x];
        straddle[threadIdx.x] = sk;
    }
    __syncthreads();  // M's region is free: the entering state goes there
    load_tile<MAX_P, MAX_N>(Ss, LDN, w.st + blk * sh.P * sh.N, sh.N, sh.P, sh.N);

    // (b) rows j = 4 tr + r, columns p = tc + 16 q: du = A^T dy + e^{cs_last -
    // cs_j} G B_j; dx = dt du; x . du and T_j summed over p
    {
        const int jlo = 4 * tr;
        float du[4][4] = {}, wg[4][4] = {};
        for (int i = jlo; i < L; ++i) {
            const float4 av = ld4(As + i * LDL + jlo);
            float yv[4];
#pragma unroll
            for (int pq = 0; pq < 4; ++pq) yv[pq] = DYs[i * LDP + tc + 16 * pq];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int pq = 0; pq < 4; ++pq) du[r][pq] += at4(av, r) * yv[pq];
        }
        for (int k = 0; k < n4; k += 4) {
            float4 bv[4], gv[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) bv[r] = ld4(Bs + (jlo + r) * LDN + k);
#pragma unroll
            for (int pq = 0; pq < 4; ++pq) gv[pq] = ld4(Gs + (tc + 16 * pq) * LDN + k);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int pq = 0; pq < 4; ++pq) wg[r][pq] += dot4(bv[r], gv[pq]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int j = jlo + r;
            const float eo = eout[j], dtj = dts[j];
            float t = 0.f, xd = 0.f;
#pragma unroll
            for (int pq = 0; pq < 4; ++pq) {
                const int p = tc + 16 * pq;
                const float xv = Xs[j * LDP + p];
                const float d = du[r][pq] + eo * wg[r][pq];
                t += xv * wg[r][pq];
                xd += xv * d;
                if (j < valid && p < sh.P)
                    dx[(((int64_t)b * sh.S + s0 + j) * sh.H + h) * sh.P + p] = dtj * d;
            }
            t = half_warp_sum(t);
            xd = half_warp_sum(xd);
            if (tc == 0) {
                tj[j] = t * dtj * eo;
                xdu[j] = xd;
            }
        }
    }

    __syncthreads();  // the entering state is in

    // (c) rows i = 4 tr + r, columns n = 4 tc + k and 64 + 4 tc + k:
    // dC = Mq B + e^{cs_i} S^T dy_i (per head), and C_i . (S^T dy_i)
    const int n0 = 4 * tc;
    const int64_t sp = (int64_t)sh.nc * L;  // the padded sequence of the per-head sums
    {
        const int ilo = 4 * tr, jend = min(L, ilo + 4);
        float acc[4][8] = {}, z[4][8] = {};
        for (int j = 0; j < jend; ++j) {
            const float4 b0 = ld4(Bs + j * LDN + n0), b1 = ld4(Bs + j * LDN + 64 + n0);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const float mq = Mqs[(ilo + r) * LDL + j];
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    acc[r][k] += mq * at4(b0, k);
                    acc[r][k + 4] += mq * at4(b1, k);
                }
            }
        }
        for (int p = 0; p < sh.P; ++p) {
            const float4 s0v = ld4(Ss + p * LDN + n0), s1v = ld4(Ss + p * LDN + 64 + n0);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const float yv = DYs[(ilo + r) * LDP + p];
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    z[r][k] += yv * at4(s0v, k);
                    z[r][k + 4] += yv * at4(s1v, k);
                }
            }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int i = ilo + r;
            const float ei = ein[i];
            const float4 c0 = ld4(Cs + i * LDN + n0), c1 = ld4(Cs + i * LDN + 64 + n0);
            float t = 0.f;
            float* out = w.dch + (((int64_t)b * sp + s0 + i) * sh.H + h) * sh.N;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                const int n = (k < 4 ? n0 : 64 + n0 - 4) + k;
                t += (k < 4 ? at4(c0, k) : at4(c1, k - 4)) * z[r][k];
                if (i < valid && n < sh.N) out[n] = acc[r][k] + ei * z[r][k];
            }
            t = half_warp_sum(t);
            if (tc == 0) inter[i] = ei * t;
        }
    }

    // (d) rows j = 4 tr + r: dB = Mq^T C + e^{cs_last - cs_j} G^T u_j (per head)
    {
        const int jlo = 4 * tr;
        float acc[4][8] = {}, v[4][8] = {};
        for (int i = jlo; i < L; ++i) {
            const float4 mq = ld4(Mqs + i * LDL + jlo);
            const float4 c0 = ld4(Cs + i * LDN + n0), c1 = ld4(Cs + i * LDN + 64 + n0);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    acc[r][k] += at4(mq, r) * at4(c0, k);
                    acc[r][k + 4] += at4(mq, r) * at4(c1, k);
                }
        }
        float dtr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) dtr[r] = dts[jlo + r];
        for (int p = 0; p < sh.P; ++p) {
            const float4 g0 = ld4(Gs + p * LDN + n0), g1 = ld4(Gs + p * LDN + 64 + n0);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const float u = Xs[(jlo + r) * LDP + p] * dtr[r];
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    v[r][k] += u * at4(g0, k);
                    v[r][k + 4] += u * at4(g1, k);
                }
            }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int j = jlo + r;
            if (j >= valid) continue;
            const float eo = eout[j];
            float* out = w.dbh + (((int64_t)b * sp + s0 + j) * sh.H + h) * sh.N;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                const int n = (k < 4 ? n0 : 64 + n0 - 4) + k;
                if (n < sh.N) out[n] = acc[r][k] + eo * v[r][k];
            }
        }
    }

    // (e) <G, S>
    {
        float s = 0.f;
        for (int e = threadIdx.x; e < MAX_P * MAX_N; e += NT) {
            const int p = e / MAX_N, n = e % MAX_N;
            s += Gs[p * LDN + n] * Ss[p * LDN + n];
        }
        s = warp_sum(s);
        if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
    }
    __syncthreads();  // every term of d(dA) is in

    // (f) warp 0: d(dA) = the straddling sums of M, the reverse cumulative sum
    // of the inter-chunk terms, the exclusive prefix sum of T and e^{cs_last}
    // <G, S>; ddt and da's partial
    if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        float gs = 0.f;
#pragma unroll
        for (int k = 0; k < NT / 32; ++k) gs += red[k];
        float v[2] = {inter[lane], inter[lane + 32]};  // reverse inclusive scan
        // T shifted by one position, so that its inclusive scan is the exclusive one
        float t[2] = {lane > 0 ? tj[lane - 1] : 0.f, tj[lane + 31]};
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float u0 = __shfl_down_sync(0xffffffffu, v[0], off);
            const float u1 = __shfl_down_sync(0xffffffffu, v[1], off);
            const float w0 = __shfl_up_sync(0xffffffffu, t[0], off);
            const float w1 = __shfl_up_sync(0xffffffffu, t[1], off);
            if (lane + off < 32) {
                v[0] += u0;
                v[1] += u1;
            }
            if (lane >= off) {
                t[0] += w0;
                t[1] += w1;
            }
        }
        v[0] += __shfl_sync(0xffffffffu, v[1], 0);
        t[1] += __shfl_sync(0xffffffffu, t[0], 31);
        const float eg = expf(last) * gs;
#pragma unroll
        for (int hlf = 0; hlf < 2; ++hlf) {
            const int k = lane + 32 * hlf;
            v[hlf] += straddle[k] + t[hlf] + eg;
        }
        float dap = 0.f;
#pragma unroll
        for (int hlf = 0; hlf < 2; ++hlf) {
            const int k = lane + 32 * hlf;
            dap += dts[k] * v[hlf];
            if (k < valid) ddt[((int64_t)b * sh.S + s0 + k) * sh.H + h] = xdu[k] + ah * v[hlf];
        }
        dap = warp_sum(dap);
        if (lane == 0) w.dap[blk] = dap;
    }
}

// ---- pass 4: dB and dC summed over the heads of each group ----

__global__ void __launch_bounds__(NT)
ssd_bwd_group_kernel(float* __restrict__ db, float* __restrict__ dc, Work w, Shape sh) {
    const int64_t e = (int64_t)blockIdx.x * NT + threadIdx.x;
    if (e >= (int64_t)sh.B * sh.S * sh.G * sh.N) return;
    const int n = (int)(e % sh.N);
    int64_t r = e / sh.N;
    const int gi = (int)(r % sh.G);
    r /= sh.G;
    const int s = (int)(r % sh.S), b = (int)(r / sh.S);
    const int rep = sh.H / sh.G;
    const int64_t off = (((int64_t)b * sh.nc * sh.L + s) * sh.H + gi * rep) * sh.N + n;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < rep; ++k) {
        sb += w.dbh[off + (int64_t)k * sh.N];
        sc += w.dch[off + (int64_t)k * sh.N];
    }
    db[e] = sb;
    dc[e] = sc;
}

// ---- pass 5: da, one warp a head ----

__global__ void __launch_bounds__(32) ssd_bwd_da_kernel(float* __restrict__ da, Work w, Shape sh) {
    const int h = blockIdx.x, lane = threadIdx.x;
    float s = 0.f;
    for (int k = lane; k < sh.B * sh.nc; k += 32) {
        const int b = k / sh.nc, c = k - b * sh.nc;
        s += w.dap[((int64_t)b * sh.H + h) * sh.nc + c];
    }
    s = warp_sum(s);
    if (lane == 0) da[h] = s;
}

bool valid_shape(int B, int S, int H, int P, int G, int N, int L) {
    return B >= 0 && S >= 0 && H > 0 && G > 0 && H % G == 0 && P > 0 && P <= MAX_P && N > 0 &&
           N <= MAX_N && L >= 4 && L <= MAX_L && L % 4 == 0;
}

}  // namespace

// Dynamic shared memory of passes 1 and 3 (0, 1) in bytes.
extern "C" int repro_ssd_scan_bwd_smem_bytes(int pass) {
    return pass == 0 ? SMEM_LOCAL * 4 : pass == 1 ? SMEM_CHUNK * 4 : -1;
}

// The limits of the kernel: chunk L a multiple of 4 in [4, 64], P in
// [1, 64], N in [1, 128] (those of the forward).
extern "C" int repro_ssd_scan_bwd_limits(int* max_l, int* max_p, int* max_n) {
    *max_l = MAX_L;
    *max_p = MAX_P;
    *max_n = MAX_N;
    return 0;
}

// The scratch a call needs, in floats.  Returns cudaError_t.
extern "C" int repro_ssd_scan_bwd_workspace(int B, int S, int H, int P, int G, int N, int L,
                                             int64_t* ws_floats) {
    if (!valid_shape(B, S, H, P, G, N, L)) return (int)cudaErrorInvalidValue;
    *ws_floats = workspace_floats(Shape{B, S, H, P, G, N, L, (S + L - 1) / L});
    return 0;
}

// x [B,S,H,P], dt [B,S,H], a [H] (contiguous), bm/cm [B,S,G,N], h_init
// [B,H,P,N] or null, dy [B,S,H,P], dstate [B,H,P,N]; gradients dx [B,S,H,P],
// ddt [B,S,H], da [H], db/dc [B,S,G,N], dh_init [B,H,P,N] (null where h_init
// is), contiguous; ws scratch of ws_floats floats
// (repro_ssd_scan_bwd_workspace); all f32.  Strides in elements: (batch,
// seq, head) for x, dt, dy; (batch, seq, group) for bm, cm; (batch, head,
// row) for h_init and dstate; the last dim is unit-stride.  device is the
// CUDA ordinal of the tensors and the stream.  Returns cudaError_t.
extern "C" int repro_ssd_scan_bwd(
        const float* x, const float* dt, const float* a, const float* bm, const float* cm,
        const float* h_init, const float* dy, const float* dstate, float* dx, float* ddt,
        float* da, float* db, float* dc, float* dh_init, float* ws, int64_t ws_floats, int B,
        int S, int H, int P, int G, int N, int L, int64_t xsb, int64_t xss, int64_t xsh,
        int64_t dsb, int64_t dss, int64_t dsh, int64_t bsb, int64_t bss, int64_t bsg,
        int64_t csb, int64_t css, int64_t csg, int64_t ysb, int64_t yss, int64_t ysh,
        int64_t hsb, int64_t hsh, int64_t hsp, int64_t gsb, int64_t gsh, int64_t gsp, int device,
        void* stream) {
    if (!valid_shape(B, S, H, P, G, N, L) || (h_init == nullptr) != (dh_init == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);  // this library's runtime keeps its own
    if (err != cudaSuccess) return (int)err;
    if (B == 0) return (int)cudaSuccess;
    const Shape sh{B, S, H, P, G, N, L, (S + L - 1) / L};
    if (ws_floats < workspace_floats(sh) || ((uintptr_t)ws & 15)) return (int)cudaErrorInvalidValue;
    const Strides sd{xsb, xss, xsh, dsb, dss, dsh, bsb, bss, bsg, csb, css, csg,
                     ysb, yss, ysh, hsb, hsh, hsp, gsb, gsh, gsp};
    const Work w = carve(ws, sh);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaFuncSetAttribute(ssd_bwd_local_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_LOCAL * 4);
    cudaFuncSetAttribute(ssd_bwd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_CHUNK * 4);
    const dim3 chunks(sh.nc, H, B);
    if (sh.nc > 0)
        ssd_bwd_local_kernel<<<chunks, NT, SMEM_LOCAL * 4, s>>>(x, dt, a, bm, cm, dy, w, sh, sd);
    ssd_bwd_scan_kernel<<<dim3((P * N + NT - 1) / NT, H, B), NT, 0, s>>>(h_init, dstate, dh_init,
                                                                         w, sh, sd);
    if (sh.nc > 0) {
        ssd_bwd_chunk_kernel<<<chunks, NT, SMEM_CHUNK * 4, s>>>(x, dt, a, bm, cm, dy, dx, ddt, w,
                                                                sh, sd);
        const int64_t n_out = (int64_t)B * S * G * N;
        ssd_bwd_group_kernel<<<(unsigned)((n_out + NT - 1) / NT), NT, 0, s>>>(db, dc, w, sh);
    }
    ssd_bwd_da_kernel<<<H, 32, 0, s>>>(da, w, sh);
    return (int)cudaGetLastError();
}
