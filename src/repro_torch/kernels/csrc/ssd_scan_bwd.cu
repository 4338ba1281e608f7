// Gradient of the Mamba-2 SSD chunk scan for Hopper (sm_90a), f32 in and out,
// every matrix product on the TF32 tensor cores in 3xTF32.
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
// What the design meets instead: 3xTF32 makes each product three mma.sync,
// 44.5 GFLOP of tiles a call (31.4 in pass 3, 12.9 in pass 1), whose
// fragments every warp loads from shared memory and splits itself; and the
// workspace (entering states and cotangents, dB and dC per head: 268 MB at
// the training shape), which passes 2 and 4 stream through.
//
// Design: five passes on one stream; every chunk of every head is a block of
// its own, so a call fills the card with B * H * nc blocks (2048 at the
// training shape), and the two sequential recurrences over the chunks
// (states forward, their cotangents in reverse) are elementwise passes:
//
//   1. ssd_bwd_local_kernel, one block of 8 warps per (b, h, chunk): the
//      chunk's cs (a warp scan), its local state sum_j e^{cs_last - cs_j}
//      u_j (x) B_j and local state cotangent sum_i e^{cs_i} dy_i (x) C_i
//      (four warps each, [P x N] products of depth L) and its decay
//      e^{cs_last}, into a workspace [B, H, nc, P, N] each; the block of
//      each group's first head also writes the chunk's C B^T [64 x 64] (1 MB
//      at the training shape, read back from L2): once per (b, group,
//      chunk), not once per head.  105 KiB of shared memory: two blocks an SM.
//   2. ssd_bwd_scan_kernel, one thread per (b, h, p, n): over the chunks,
//      each local state replaced by the state entering its chunk (from
//      h_init or 0) and, in reverse in the same loop, each local cotangent
//      by the cotangent of the state leaving its chunk (from d(final
//      state)); the last carried cotangent is dh_init.  A segment is one
//      chunk.
//   3. ssd_bwd_chunk_kernel, one block of 8 warps per (b, h, chunk): warps w
//      and w + 4 own rows 16w..16w+15, both as positions i (Q = dy x^T, Mq,
//      M, dC) and as positions j (du, dB), each half of every product's
//      column tiles, so that the causal products balance over a step (row
//      tile w does 2w + 2 of the 8 column tiles of an i-product and 8 - 2w
//      of a j-product).  First from x, dy and C B^T: Mq and M, A in place of
//      C B^T, the intra-chunk du = A^T dy, the straddling sums of M; then
//      over N in steps of 32 columns (C, B, S and G staged per step): du +=
//      (e^{cs_last - cs_j} B) G^T, and per step dB and dC (inter-chunk
//      product first, then the intra-chunk one into the same accumulators),
//      T, the C . (S^T dy) terms and <G, S>; dx and ddt written, dB and dC
//      per head into the workspace, da as one partial sum per block.
//      94 KiB of shared memory: two blocks an SM, each loading while the
//      other computes.
//   4. ssd_bwd_group_kernel: dB and dC summed over each group's heads.
//   5. ssd_bwd_da_kernel: da summed over its partials, one warp a head.
//
// Passes 1 and 3 have an instantiation for mamba2-370m's head (L, P and N at
// their largest, 16-byte rows) with every bound known to the compiler.  Sums
// across blocks go through a second pass in a fixed order, never atomics,
// so a gradient is the same from run to run.
//
// Products: mma.sync m16n8k8 TF32 with f32 accumulation, each f32 operand
// split into TF32 hi + lo and each product lo.hi + hi.lo + hi.hi (3xTF32,
// tf32.cuh, as the forward); plain TF32 in any one product misses the
// tolerance at mamba2-370m's head (tests/test_torch_ssm.py emulates both).
// Where a factor scales an operand's rows (e^{cs_i} dy, e^{cs_last - cs_j}
// B, dt_j e^{cs_last - cs_j} x) it is applied before the split.  Decays,
// scans, dt and the decays' gradient stay f32 on the CUDA cores.  Each
// shared tile's row stride is 4 or 8 mod 32 floats, and each product takes
// its fragments' k in the order (t, t + 4 or 2t, 2t + 1) that keeps both
// operands' loads free of bank conflicts.
//
// Measured on an H100 SXM at 700 W (chip_smoke.py, the training shape): a
// call takes 0.753 ms of device time (4.4 % of the bound): pass 1 0.153,
// pass 2 0.152, pass 3 0.394, pass 4 0.052.  The passes' tiles run at ~59
// TFLOP/s (12 % of the TF32 peak), the forward's at ~109.  Why was not
// measured (no hardware counters on that machine); the candidates are the
// phases of pass 3 that split between i- and j-rows around barriers (a row
// tile's share of a causal product there is 1 to 4 times another's) and
// fewer independent products per warp than the forward's.
// scripts/ssd_full_build_ab.py --kernel bwd times the generic passes 1 and
// 3 against the FULL ones.
//
// What it still trades away: C B^T, x, dy and the n-steps of every head
// are loaded by its own block (heads of a group share only L2), dB and dC
// go through the per-head workspace and pass 4, and the n-steps are not
// double-buffered (the other block on the SM overlaps them).  wgmma, the
// next step for the products, takes TF32 operands K-major only (no
// transpose for 32-bit types): A^T dy, Mq^T C, (wout x) G, Mq B, dy S and
// the local products read an operand across its rows, so they would need
// transposed copies in shared memory (16-32 KiB more per tile), which the
// second block an SM could not afford at 94 KiB; a block of several heads of
// one group, with C B^T, C and B staged once for them and dB and dC summed
// over them before they are written, would pay for that space and drop
// pass 4.
//
// Layout: x, dy [B,S,H,P], dt [B,S,H], B/C [B,S,G,N], h_init, dstate
// [B,H,P,N] are read through the strides given (x, B and C may be slices of
// the conv output), unit-stride in the last dim; the gradients are written
// contiguous.  Positions >= S (a ragged last chunk) are read as x = dy = B
// = C = dt = 0, as the plain version's zero-padding with dt = 0, and their
// gradients are not written.  Rows that do not start on a 16-byte boundary
// are copied 4 bytes at a time.
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "tf32.cuh"

namespace {

constexpr int NT = 256;              // threads of passes 1, 2 and 4: 8 warps
constexpr int NT_CHUNK = 256;        // threads of pass 3: 8 warps, two to a row tile
constexpr int MAX_L = 64;            // chunk length
constexpr int MAX_P = 64;            // head width
constexpr int MAX_N = 128;           // state width
constexpr int NB = 32;               // columns of N a step of pass 3
constexpr int SCAN_BATCH = 16;       // chunks whose loads pass 2 starts together

// Row strides (floats).  A tile read along its rows' axis by 8-byte loads,
// or across its rows with the fragment's k = t, t + 4, has a stride of 8
// mod 32; one read across its rows with k = 2t, 2t + 1, or along them one
// float at a time with k = t, t + 4, a stride of 4 mod 32.
constexpr int LD1_P = MAX_P + 8;     // pass 1: x, dy
constexpr int LD1_N = MAX_N + 8;     // pass 1: B, C
constexpr int LDT = MAX_L + 8;       // pass 3: x, dy, Mq, C B^T (then A)
constexpr int LDM = MAX_L + 4;       // pass 3: M (rows read as float4)
constexpr int LDC = NB + 8;          // pass 3: an n-step of C
constexpr int LDB = NB + 4;          // pass 3: an n-step of B, S and G

// Shared memory of passes 1 and 3, in floats.
constexpr int SMEM_LOCAL = 2 * MAX_L * LD1_P + 2 * MAX_L * LD1_N + 5 * MAX_L;
constexpr int TILE = MAX_L * LDT;
constexpr int NSTAGE = MAX_L * LDC + 3 * MAX_L * LDB;  // C, B, S, G of an n-step
static_assert(TILE + MAX_L * LDM <= NSTAGE, "C B^T and M fit where the n-steps go");
constexpr int SCALARS = 12 * MAX_L + NT_CHUNK / 32;  // see ssd_bwd_chunk_kernel
constexpr int SMEM_CHUNK = 3 * TILE + NSTAGE + SCALARS;

struct Strides {
    int64_t xb, xs, xh, db, ds, dh, bb, bs, bg, cb, cs, cg, yb, ys, yh, hb, hh, hp, gb, gh, gp;
};

struct Shape {
    int B, S, H, P, G, N, L, nc;
    bool vec;  // every x, dy, B and C row starts on a 16-byte boundary, P, N % 4 == 0
};

// The workspace: C B^T per (b, group, chunk), padded to 64 x 64; entering
// states and cotangents leaving per (b, h, chunk); dB and dC per head over
// the padded sequence; decays and da partials per (b, h, chunk).
struct Work {
    float *cb, *st, *ct, *dbh, *dch, *dec, *dap;
};

Work carve(float* ws, const Shape& sh) {
    const int64_t cbs = (int64_t)sh.B * sh.G * sh.nc * MAX_L * MAX_L;
    const int64_t states = (int64_t)sh.B * sh.H * sh.nc * sh.P * sh.N;
    const int64_t heads = (int64_t)sh.B * sh.nc * sh.L * sh.H * sh.N;
    const int64_t chunks = (int64_t)sh.B * sh.H * sh.nc;
    Work w;
    w.cb = ws;
    w.st = w.cb + cbs;
    w.ct = w.st + states;
    w.dbh = w.ct + states;
    w.dch = w.dbh + heads;
    w.dec = w.dch + heads;
    w.dap = w.dec + chunks;
    return w;
}

int64_t workspace_floats(const Shape& sh) {
    return (int64_t)sh.B * sh.G * sh.nc * MAX_L * MAX_L +
           2 * (int64_t)sh.B * sh.H * sh.nc * sh.P * sh.N +
           2 * (int64_t)sh.B * sh.nc * sh.L * sh.H * sh.N + 2 * (int64_t)sh.B * sh.H * sh.nc;
}

// The sum over the 4 lanes of a quad (one row of an mma fragment), in a fixed order.
__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
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

// ---- pass 1: each chunk's local state, local state cotangent and decay; C B^T ----

template <bool FULL>
__global__ void __launch_bounds__(NT, 2)
ssd_bwd_local_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const float* __restrict__ bm,
                     const float* __restrict__ cm, const float* __restrict__ dy, Work w,
                     Shape sh, Strides sd) {
    extern __shared__ float4 smem4[];
    float* Xs = reinterpret_cast<float*>(smem4);  // [MAX_L][LD1_P]
    float* DYs = Xs + MAX_L * LD1_P;               // [MAX_L][LD1_P]
    float* Bs = DYs + MAX_L * LD1_P;               // [MAX_L][LD1_N]
    float* Cs = Bs + MAX_L * LD1_N;                // [MAX_L][LD1_N]
    float* cs = Cs + MAX_L * LD1_N;
    float* csl = cs + MAX_L;
    float* dts = csl + MAX_L;
    float* win = dts + MAX_L;   // e^{cs_i}
    float* wout = win + MAX_L;  // dt_j e^{cs_last - cs_j}
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, rep = sh.H / sh.G, g = h / rep;
    const int L = FULL ? MAX_L : sh.L, P = FULL ? MAX_P : sh.P, N = FULL ? MAX_N : sh.N;
    const bool vec = FULL || sh.vec;
    const int s0 = c * L, valid = min(L, sh.S - s0);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gq = lane >> 2, tq = lane & 3;

    load_tile_zf<MAX_L, MAX_P, NT>(Xs, LD1_P, x + b * sd.xb + h * sd.xh + s0 * sd.xs, sd.xs,
                                   valid, P, vec);
    load_tile_zf<MAX_L, MAX_P, NT>(DYs, LD1_P, dy + b * sd.yb + h * sd.yh + s0 * sd.ys, sd.ys,
                                   valid, P, vec);
    load_tile_zf<MAX_L, MAX_N, NT>(Bs, LD1_N, bm + b * sd.bb + g * sd.bg + s0 * sd.bs, sd.bs,
                                   valid, N, vec);
    load_tile_zf<MAX_L, MAX_N, NT>(Cs, LD1_N, cm + b * sd.cb + g * sd.cg + s0 * sd.cs, sd.cs,
                                   valid, N, vec);
    cp_async_commit();
    if (warp == 0)
        chunk_scan(cs, csl, dts, dt + b * sd.db + h * sd.dh + (int64_t)s0 * sd.ds, sd.ds, a[h],
                   valid);
    cp_async_wait<0>();
    __syncthreads();
    if (threadIdx.x < MAX_L) {
        const int i = threadIdx.x;
        win[i] = expf(cs[i]);
        wout[i] = dts[i] * expf(decay_exp(cs, csl, L - 1, i));
    }
    __syncthreads();

    // warps 0-3 the local state (Xw^T B), warps 4-7 the local cotangent
    // (DYw^T C); warp w owns rows p = 16 (w % 4).. and every column n.  A(p,
    // j) = w_j X[j][p] and B(j, n) are read across their rows, k = t, t + 4.
    const int64_t blk = ((int64_t)b * sh.H + h) * sh.nc + c;
    const int p0 = 16 * (warp & 3), l8 = (L + 7) & ~7;
    if (p0 < P) {
        const bool cot = warp >= 4;
        const float* As = cot ? DYs : Xs;
        const float* Bt = cot ? Cs : Bs;
        const float* sc = cot ? win : wout;
        float acc[MAX_N / 8][4] = {};
        for (int k0 = 0; k0 < l8; k0 += 8) {
            const float s_a = sc[k0 + tq], s_b = sc[k0 + tq + 4];
            const float* xa = As + (k0 + tq) * LD1_P + p0 + gq;
            Frag<4> fa;
            fa.set(0, s_a * xa[0]);
            fa.set(1, s_a * xa[8]);
            fa.set(2, s_b * xa[4 * LD1_P]);
            fa.set(3, s_b * xa[4 * LD1_P + 8]);
#pragma unroll
            for (int nt = 0; nt < MAX_N / 8; ++nt)
                if (8 * nt < N) {
                    const float* bb = Bt + (k0 + tq) * LD1_N + 8 * nt + gq;
                    Frag<2> fb;
                    fb.set(0, bb[0]);
                    fb.set(1, bb[4 * LD1_N]);
                    mma3(acc[nt], fa, fb);
                }
        }
        float* out = (cot ? w.ct : w.st) + blk * P * N;
#pragma unroll
        for (int nt = 0; nt < MAX_N / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int p = p0 + gq + 8 * (e >> 1), n = 8 * nt + 2 * tq + (e & 1);
                if (p < P && n < N) out[p * N + n] = acc[nt][e];
            }
    }
    if (threadIdx.x == 0) w.dec[blk] = expf(cs[L - 1]);

    // C B^T of the chunk, once per group: warp w owns rows i = 16 (w % 4)..
    // and columns j = 32 (w / 4)..; C and B read along their rows (k = 2t, 2t + 1)
    if (h % rep != 0) return;
    const int i0 = 16 * (warp & 3), j0 = 32 * (warp >> 2), n8 = (N + 7) & ~7;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < n8; k0 += 8) {
        const float* ca = Cs + (i0 + gq) * LD1_N + k0 + 2 * tq;
        Frag<4> fa;
        fa.set2(0, 2, ld2(ca));
        fa.set2(1, 3, ld2(ca + 8 * LD1_N));
#pragma unroll
        for (int jt = 0; jt < 4; ++jt) {
            Frag<2> fb;  // B(n, j) = B[j][n]
            fb.set2(0, 1, ld2(Bs + (j0 + 8 * jt + gq) * LD1_N + k0 + 2 * tq));
            mma3(acc[jt], fa, fb);
        }
    }
    float* cbo = w.cb + (((int64_t)b * sh.G + g) * sh.nc + c) * MAX_L * MAX_L;
#pragma unroll
    for (int jt = 0; jt < 4; ++jt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int i = i0 + gq + 8 * hf, j = j0 + 8 * jt + 2 * tq;
            *reinterpret_cast<float2*>(cbo + i * MAX_L + j) =
                make_float2(acc[jt][2 * hf], acc[jt][2 * hf + 1]);
        }
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
    // the states forward and the cotangents in reverse, in one loop: each
    // batch's loads (of both) start before its stores, since a thread walks
    // the chunks in order and one load at a time left it waiting on each
    float s = h_init != nullptr ? h_init[b * sd.hb + h * sd.hh + p * sd.hp + n] : 0.f;
    float gc = dstate[b * sd.gb + h * sd.gh + p * sd.gp + n];
    for (int c0 = 0; c0 < sh.nc; c0 += SCAN_BATCH) {
        float ls[SCAN_BATCH], ds[SCAN_BATCH], lc[SCAN_BATCH], dc[SCAN_BATCH];
#pragma unroll
        for (int k = 0; k < SCAN_BATCH; ++k)
            if (c0 + k < sh.nc) {
                const int cf = c0 + k, cr = sh.nc - 1 - cf;
                ls[k] = st[(int64_t)cf * pn];
                ds[k] = dec[cf];
                lc[k] = ct[(int64_t)cr * pn];
                dc[k] = dec[cr];
            }
#pragma unroll
        for (int k = 0; k < SCAN_BATCH; ++k)
            if (c0 + k < sh.nc) {
                const int cf = c0 + k, cr = sh.nc - 1 - cf;
                st[(int64_t)cf * pn] = s;
                s = ls[k] + ds[k] * s;
                ct[(int64_t)cr * pn] = gc;
                gc = dc[k] * gc + lc[k];
            }
    }
    if (dh_init != nullptr) dh_init[bh * pn + i] = gc;
}

// ---- pass 3: the gradients of one chunk of one head ----

template <bool FULL>
__global__ void __launch_bounds__(NT_CHUNK, 2)
ssd_bwd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const float* __restrict__ bm,
                     const float* __restrict__ cm, const float* __restrict__ dy,
                     float* __restrict__ dx, float* __restrict__ ddt, Work w, Shape sh,
                     Strides sd) {
    extern __shared__ float4 smem4[];
    float* Xs = reinterpret_cast<float*>(smem4);  // [MAX_L][LDT]
    float* DYs = Xs + TILE;                        // [MAX_L][LDT]
    float* Mqs = DYs + TILE;                       // [MAX_L][LDT]: E o (dy x^T) dt_j
    float* stage = Mqs + TILE;
    float* As = stage;                             // [MAX_L][LDT]: C B^T, then A in place
    float* Ms = stage + TILE;                      // [MAX_L][LDM]: M, then its rows' prefixes
    float* Cn = stage;                             // n-step: C [MAX_L][LDC]
    float* Bn = Cn + MAX_L * LDC;                  // B [MAX_L][LDB]
    float* Gn = Bn + MAX_L * LDB;                  // G [MAX_P][LDB]: the cotangent leaving
    float* Sn = Gn + MAX_P * LDB;                  // S [MAX_P][LDB]: the entering state
    float* cs = stage + NSTAGE;
    float* csl = cs + MAX_L;
    float* dts = csl + MAX_L;
    float* ein = dts + MAX_L;         // e^{cs_i}
    float* eout = ein + MAX_L;        // e^{cs_last - cs_j}
    float* straddle = eout + MAX_L;      // sum_{i>=k, j<k} M_ij
    float* inter = straddle + MAX_L;     // [2][MAX_L]: e^{cs_i} C_i . (S^T dy_i), by column half
    float* tj = inter + 2 * MAX_L;       // [2][MAX_L]: T_j, by column half
    float* xdu = tj + 2 * MAX_L;         // [2][MAX_L]: x_j . du_j, by column half
    float* red = xdu + 2 * MAX_L;        // [8]: per-warp partial sums of <G, S>
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, g = h / (sh.H / sh.G);
    const int L = FULL ? MAX_L : sh.L, P = FULL ? MAX_P : sh.P, N = FULL ? MAX_N : sh.N;
    // the workspace's state rows start on 16-byte boundaries where N % 4 == 0
    const bool vec = FULL || sh.vec, vec_ws = FULL || N % 4 == 0;
    const int s0 = c * L, valid = min(L, sh.S - s0);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gq = lane >> 2, tq = lane & 3;
    // this warp's rows, as positions i and as positions j, and its half of
    // the column tiles of each product (tiles hf, hf + 2, ...)
    const int hf = warp >> 2, r0 = 16 * (warp & 3);
    const bool mine = r0 < L;
    const int l8 = (L + 7) & ~7, p8 = (P + 7) & ~7;
    const int64_t blk = ((int64_t)b * sh.H + h) * sh.nc + c;

    load_tile_zf<MAX_L, MAX_P, NT_CHUNK>(Xs, LDT, x + b * sd.xb + h * sd.xh + s0 * sd.xs, sd.xs,
                                         valid, P, vec);
    load_tile_zf<MAX_L, MAX_P, NT_CHUNK>(DYs, LDT, dy + b * sd.yb + h * sd.yh + s0 * sd.ys,
                                         sd.ys, valid, P, vec);
    load_tile_zf<MAX_L, MAX_L, NT_CHUNK>(
            As, LDT, w.cb + (((int64_t)b * sh.G + g) * sh.nc + c) * MAX_L * MAX_L, MAX_L,
            MAX_L, MAX_L, true);
    cp_async_commit();
    const float ah = a[h];
    if (warp == 0)
        chunk_scan(cs, csl, dts, dt + b * sd.db + h * sd.dh + (int64_t)s0 * sd.ds, sd.ds, ah,
                   valid);
    else if (threadIdx.x < 32 + MAX_L) {  // rows no warp owns stay 0
        const int k = threadIdx.x - 32;
        straddle[k] = inter[k] = inter[MAX_L + k] = tj[k] = tj[MAX_L + k] = xdu[k] =
                xdu[MAX_L + k] = 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    if (threadIdx.x < MAX_L) {
        ein[threadIdx.x] = expf(cs[threadIdx.x]);
        eout[threadIdx.x] = expf(decay_exp(cs, csl, L - 1, threadIdx.x));
    }

    // (a) rows i: Q = dy x^T (k = 2t, 2t + 1), column tiles j0 <= i only;
    // Mq = Q dt_j E, M = (C B^T) o Mq below the diagonal, A = (C B^T) o E
    // in place of C B^T
    if (mine) {
        const int qend = min(r0 / 8 + 2, l8 / 8);
        float q[MAX_L / 16][4] = {};  // column tiles 2u + hf
        for (int k0 = 0; k0 < p8; k0 += 8) {
            const float* ya = DYs + (r0 + gq) * LDT + k0 + 2 * tq;
            Frag<4> fa;
            fa.set2(0, 2, ld2(ya));
            fa.set2(1, 3, ld2(ya + 8 * LDT));
#pragma unroll
            for (int u = 0; u < MAX_L / 16; ++u)
                if (2 * u + hf < qend) {
                    Frag<2> fb;  // B(p, j) = x[j][p]
                    fb.set2(0, 1, ld2(Xs + (16 * u + 8 * hf + gq) * LDT + k0 + 2 * tq));
                    mma3(q[u], fa, fb);
                }
        }
#pragma unroll
        for (int u = 0; u < MAX_L / 16; ++u)
#pragma unroll
            for (int rh = 0; rh < 2; ++rh) {
                const int jt = 2 * u + hf, i = r0 + gq + 8 * rh, j = 8 * jt + 2 * tq;
                float mq[2] = {0.f, 0.f}, m[2] = {0.f, 0.f}, av[2] = {0.f, 0.f};
                if (jt < qend) {
                    const float2 cb = ld2(As + i * LDT + j);
#pragma unroll
                    for (int e = 0; e < 2; ++e)
                        if (j + e <= i && i < L) {
                            const float ex = expf(decay_exp(cs, csl, i, j + e));
                            const float cbe = e ? cb.y : cb.x;
                            mq[e] = q[u][2 * rh + e] * dts[j + e] * ex;
                            av[e] = cbe * ex;
                            if (j + e < i) m[e] = cbe * mq[e];
                        }
                }
                *reinterpret_cast<float2*>(Mqs + i * LDT + j) = make_float2(mq[0], mq[1]);
                *reinterpret_cast<float2*>(Ms + i * LDM + j) = make_float2(m[0], m[1]);
                *reinterpret_cast<float2*>(As + i * LDT + j) = make_float2(av[0], av[1]);
            }
    }
    __syncthreads();  // Mq, M and A are in

    // (b) rows j: du = A^T dy, i >= j (k = t, t + 4), this warp's column tiles of p
    float du[MAX_P / 16][4] = {};  // column tiles p = 8 (2u + hf)..
    if (mine) {
        for (int k0 = r0; k0 < l8; k0 += 8) {
            const float* aa = As + (k0 + tq) * LDT + r0 + gq;  // A(j, i) = A[i][j]
            Frag<4> fa;
            fa.set(0, aa[0]);
            fa.set(1, aa[8]);
            fa.set(2, aa[4 * LDT]);
            fa.set(3, aa[4 * LDT + 8]);
#pragma unroll
            for (int u = 0; u < MAX_P / 16; ++u)
                if (8 * (2 * u + hf) < P) {
                    const float* yb = DYs + (k0 + tq) * LDT + 16 * u + 8 * hf + gq;  // B(i, p)
                    Frag<2> fb;
                    fb.set(0, yb[0]);
                    fb.set(1, yb[4 * LDT]);
                    mma3(du[u], fa, fb);
                }
        }
    }
    // the straddling sums: each row of M to its exclusive prefix sums over j,
    // then straddle[k] = sum over rows i >= k of row i's prefix at k
    if (threadIdx.x < L) {
        float4* row = reinterpret_cast<float4*>(Ms + threadIdx.x * LDM);
        float run = 0.f;
#pragma unroll 4
        for (int q4 = 0; q4 < MAX_L / 4; ++q4) {
            const float4 m = row[q4];
            float4 o;
            o.x = run;
            run += m.x;
            o.y = run;
            run += m.y;
            o.z = run;
            run += m.z;
            o.w = run;
            run += m.w;
            row[q4] = o;
        }
    }
    __syncthreads();
    if (threadIdx.x < L) {
        float sk = 0.f;
        for (int i = threadIdx.x; i < L; ++i) sk += Ms[i * LDM + threadIdx.x];
        straddle[threadIdx.x] = sk;
    }
    __syncthreads();  // the stage is free for the n-steps

    // (c) per step of NB columns of N: du += (e^{cs_last - cs_j} B) G^T; dB =
    // (wout x) G (then T) + Mq^T C; dC = (e^{cs_i} dy) S (then C . (S^T dy))
    // + Mq B; <G, S>
    const int ja = r0 + gq, jb = ja + 8;  // this lane's rows (i or j)
    const float eo_a = eout[ja], eo_b = eout[jb];
    const float wo_a = eo_a * dts[ja], wo_b = eo_b * dts[jb];
    const float ei_a = ein[ja], ei_b = ein[jb];
    const int64_t sp = (int64_t)sh.nc * L;  // the padded sequence of the per-head sums
    const float* cbase = cm + b * sd.cb + g * sd.cg + s0 * sd.cs;
    const float* bbase = bm + b * sd.bb + g * sd.bg + s0 * sd.bs;
    const float* gbase = w.ct + blk * P * N;
    const float* sbase = w.st + blk * P * N;
    float tsum[2] = {0.f, 0.f}, isum[2] = {0.f, 0.f}, gsum = 0.f;
    for (int nb = 0; nb < N; nb += NB) {
        const int ncols = min(NB, N - nb), n8 = (ncols + 7) & ~7;
        load_tile_zf<MAX_L, NB, NT_CHUNK>(Cn, LDC, cbase + nb, sd.cs, valid, ncols, vec);
        load_tile_zf<MAX_L, NB, NT_CHUNK>(Bn, LDB, bbase + nb, sd.bs, valid, ncols, vec);
        load_tile_zf<MAX_P, NB, NT_CHUNK>(Gn, LDB, gbase + nb, N, P, ncols, vec_ws);
        load_tile_zf<MAX_P, NB, NT_CHUNK>(Sn, LDB, sbase + nb, N, P, ncols, vec_ws);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();  // the step is in
        if (mine) {
            // du += (eout B) G^T: A(j, n), B(n, p) = G[p][n], both along rows (k = t, t + 4)
            for (int k0 = 0; k0 < n8; k0 += 8) {
                const float* ba = Bn + ja * LDB + k0 + tq;
                Frag<4> fa;
                fa.set(0, eo_a * ba[0]);
                fa.set(1, eo_b * ba[8 * LDB]);
                fa.set(2, eo_a * ba[4]);
                fa.set(3, eo_b * ba[8 * LDB + 4]);
#pragma unroll
                for (int u = 0; u < MAX_P / 16; ++u)
                    if (8 * (2 * u + hf) < P) {
                        const float* gb = Gn + (16 * u + 8 * hf + gq) * LDB + k0 + tq;
                        Frag<2> fb;
                        fb.set(0, gb[0]);
                        fb.set(1, gb[4]);
                        mma3(du[u], fa, fb);
                    }
            }
            // dB rows j: (wout x) G (k = 2t, 2t + 1), T_j += B_j . that, then + Mq^T C
            // (k = t, t + 4)
            float acc[NB / 16][4] = {};  // column tiles n = nb + 8 (2u + hf)..
            for (int k0 = 0; k0 < p8; k0 += 8) {
                const float2 xa = ld2(Xs + ja * LDT + k0 + 2 * tq);
                const float2 xb = ld2(Xs + jb * LDT + k0 + 2 * tq);
                Frag<4> fa;
                fa.set2(0, 2, make_float2(wo_a * xa.x, wo_a * xa.y));
                fa.set2(1, 3, make_float2(wo_b * xb.x, wo_b * xb.y));
#pragma unroll
                for (int u = 0; u < NB / 16; ++u)
                    if (8 * (2 * u + hf) < ncols) {
                        const int nt = 2 * u + hf;
                        const float* gb = Gn + (k0 + 2 * tq) * LDB + 8 * nt + gq;  // B(p, n)
                        Frag<2> fb;
                        fb.set(0, gb[0]);
                        fb.set(1, gb[LDB]);
                        mma3(acc[u], fa, fb);
                    }
            }
#pragma unroll
            for (int u = 0; u < NB / 16; ++u) {
                const int n = 16 * u + 8 * hf + 2 * tq;
                const float2 b0 = ld2(Bn + ja * LDB + n), b1 = ld2(Bn + jb * LDB + n);
                tsum[0] += b0.x * acc[u][0] + b0.y * acc[u][1];
                tsum[1] += b1.x * acc[u][2] + b1.y * acc[u][3];
            }
            for (int k0 = r0; k0 < l8; k0 += 8) {
                const float* ma = Mqs + (k0 + tq) * LDT + ja;  // A(j, i) = Mq[i][j]
                Frag<4> fa;
                fa.set(0, ma[0]);
                fa.set(1, ma[8]);
                fa.set(2, ma[4 * LDT]);
                fa.set(3, ma[4 * LDT + 8]);
#pragma unroll
                for (int u = 0; u < NB / 16; ++u)
                    if (8 * (2 * u + hf) < ncols) {
                        const int nt = 2 * u + hf;
                        const float* cb = Cn + (k0 + tq) * LDC + 8 * nt + gq;  // B(i, n)
                        Frag<2> fb;
                        fb.set(0, cb[0]);
                        fb.set(1, cb[4 * LDC]);
                        mma3(acc[u], fa, fb);
                    }
            }
#pragma unroll
            for (int u = 0; u < NB / 16; ++u)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int j = e < 2 ? ja : jb, n = nb + 16 * u + 8 * hf + 2 * tq + (e & 1);
                    if (j < valid && n < N)
                        w.dbh[(((int64_t)b * sp + s0 + j) * sh.H + h) * N + n] = acc[u][e];
                }
            // dC rows i: (ein dy) S (k = 2t, 2t + 1), the C . (S^T dy) terms,
            // then + Mq B (k = 2t, 2t + 1), j <= i
#pragma unroll
            for (int u = 0; u < NB / 16; ++u)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
            for (int k0 = 0; k0 < p8; k0 += 8) {
                const float2 ya = ld2(DYs + ja * LDT + k0 + 2 * tq);
                const float2 yb = ld2(DYs + jb * LDT + k0 + 2 * tq);
                Frag<4> fa;
                fa.set2(0, 2, make_float2(ei_a * ya.x, ei_a * ya.y));
                fa.set2(1, 3, make_float2(ei_b * yb.x, ei_b * yb.y));
#pragma unroll
                for (int u = 0; u < NB / 16; ++u)
                    if (8 * (2 * u + hf) < ncols) {
                        const int nt = 2 * u + hf;
                        const float* sb = Sn + (k0 + 2 * tq) * LDB + 8 * nt + gq;  // B(p, n)
                        Frag<2> fb;
                        fb.set(0, sb[0]);
                        fb.set(1, sb[LDB]);
                        mma3(acc[u], fa, fb);
                    }
            }
#pragma unroll
            for (int u = 0; u < NB / 16; ++u) {
                const int n = 16 * u + 8 * hf + 2 * tq;
                const float2 c0 = ld2(Cn + ja * LDC + n), c1 = ld2(Cn + jb * LDC + n);
                isum[0] += c0.x * acc[u][0] + c0.y * acc[u][1];
                isum[1] += c1.x * acc[u][2] + c1.y * acc[u][3];
            }
            const int jend = min(l8, r0 + 16);
            for (int k0 = 0; k0 < jend; k0 += 8) {
                const float* ma = Mqs + ja * LDT + k0 + 2 * tq;  // A(i, j) = Mq[i][j]
                Frag<4> fa;
                fa.set2(0, 2, ld2(ma));
                fa.set2(1, 3, ld2(ma + 8 * LDT));
#pragma unroll
                for (int u = 0; u < NB / 16; ++u)
                    if (8 * (2 * u + hf) < ncols) {
                        const int nt = 2 * u + hf;
                        const float* bb = Bn + (k0 + 2 * tq) * LDB + 8 * nt + gq;  // B(j, n)
                        Frag<2> fb;
                        fb.set(0, bb[0]);
                        fb.set(1, bb[LDB]);
                        mma3(acc[u], fa, fb);
                    }
            }
#pragma unroll
            for (int u = 0; u < NB / 16; ++u)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int i = e < 2 ? ja : jb, n = nb + 16 * u + 8 * hf + 2 * tq + (e & 1);
                    if (i < valid && n < N)
                        w.dch[(((int64_t)b * sp + s0 + i) * sh.H + h) * N + n] = acc[u][e];
                }
        }
        for (int e = threadIdx.x; e < MAX_P * NB; e += NT_CHUNK) {
            const int p = e / NB, n = e % NB;
            gsum += Gn[p * LDB + n] * Sn[p * LDB + n];
        }
        __syncthreads();  // every read of the step is done
    }

    // (d) rows j: dx = dt du, x . du; T_j and the C . (S^T dy) terms per row
    if (mine) {
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
            const int j = rh ? jb : ja;
            const float dtj = dts[j];
            float xd = 0.f;
#pragma unroll
            for (int u = 0; u < MAX_P / 16; ++u) {
                const int p = 16 * u + 8 * hf + 2 * tq;
                const float2 xv = ld2(Xs + j * LDT + p);
                const float d0 = du[u][2 * rh], d1 = du[u][2 * rh + 1];
                xd += xv.x * d0 + xv.y * d1;
                if (j < valid) {
                    float* o = dx + (((int64_t)b * sh.S + s0 + j) * sh.H + h) * P + p;
                    if (p < P) o[0] = dtj * d0;
                    if (p + 1 < P) o[1] = dtj * d1;
                }
            }
            xd = quad_sum(xd);
            const float t = quad_sum(tsum[rh]), it = quad_sum(isum[rh]);
            if (tq == 0) {
                xdu[hf * MAX_L + j] = xd;
                tj[hf * MAX_L + j] = t;
                inter[hf * MAX_L + j] = it;
            }
        }
    }
    gsum = warp_sum(gsum);
    if (lane == 0) red[warp] = gsum;
    __syncthreads();  // every term of d(dA) is in

    // (e) warp 0: d(dA) = the straddling sums of M, the reverse cumulative sum
    // of the inter-chunk terms, the exclusive prefix sum of T and e^{cs_last}
    // <G, S>; ddt and da's partial
    if (warp == 0) {
        float gs = 0.f;
#pragma unroll
        for (int k = 0; k < NT_CHUNK / 32; ++k) gs += red[k];
        // the column halves' partial sums, in a fixed order
        const auto both = [](const float* v, int k) { return v[k] + v[MAX_L + k]; };
        float v[2] = {both(inter, lane), both(inter, lane + 32)};  // reverse inclusive scan
        // T shifted by one position, so that its inclusive scan is the exclusive one
        float t[2] = {lane > 0 ? both(tj, lane - 1) : 0.f, both(tj, lane + 31)};
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
        const float eg = expf(cs[L - 1]) * gs;
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
            if (k < valid)
                ddt[((int64_t)b * sh.S + s0 + k) * sh.H + h] = both(xdu, k) + ah * v[hlf];
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
    *ws_floats = workspace_floats(Shape{B, S, H, P, G, N, L, (S + L - 1) / L, false});
    return 0;
}

// x [B,S,H,P], dt [B,S,H], a [H] (contiguous), bm/cm [B,S,G,N], h_init
// [B,H,P,N] or null, dy [B,S,H,P], dstate [B,H,P,N]; gradients dx [B,S,H,P],
// ddt [B,S,H], da [H], db/dc [B,S,G,N], dh_init [B,H,P,N] (null where h_init
// is), contiguous; ws scratch of ws_floats floats, 16-byte aligned
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
    auto al16 = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
    const int64_t strides = xsb | xss | xsh | ysb | yss | ysh | bsb | bss | bsg | csb | css | csg;
    const bool vec = P % 4 == 0 && N % 4 == 0 && al16(x) && al16(dy) && al16(bm) && al16(cm) &&
                     strides % 4 == 0;
    const Shape sh{B, S, H, P, G, N, L, (S + L - 1) / L, vec};
    if (ws_floats < workspace_floats(sh) || !al16(ws)) return (int)cudaErrorInvalidValue;
    const Strides sd{xsb, xss, xsh, dsb, dss, dsh, bsb, bss, bsg, csb, css, csg,
                     ysb, yss, ysh, hsb, hsh, hsp, gsb, gsh, gsp};
    const Work w = carve(ws, sh);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    for (auto k : {ssd_bwd_local_kernel<false>, ssd_bwd_local_kernel<true>})
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LOCAL * 4);
    for (auto k : {ssd_bwd_chunk_kernel<false>, ssd_bwd_chunk_kernel<true>})
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_CHUNK * 4);
    // mamba2-370m's head (L, P and N at their largest, 16-byte rows): the
    // passes with every bound known to the compiler
    const bool full = L == MAX_L && P == MAX_P && N == MAX_N && vec;
    const dim3 chunks(sh.nc, H, B);
    if (sh.nc > 0) {
        if (full)
            ssd_bwd_local_kernel<true><<<chunks, NT, SMEM_LOCAL * 4, s>>>(x, dt, a, bm, cm, dy, w,
                                                                          sh, sd);
        else
            ssd_bwd_local_kernel<false><<<chunks, NT, SMEM_LOCAL * 4, s>>>(x, dt, a, bm, cm, dy, w,
                                                                           sh, sd);
    }
    ssd_bwd_scan_kernel<<<dim3((P * N + NT - 1) / NT, H, B), NT, 0, s>>>(h_init, dstate, dh_init,
                                                                         w, sh, sd);
    if (sh.nc > 0) {
        if (full)
            ssd_bwd_chunk_kernel<true><<<chunks, NT_CHUNK, SMEM_CHUNK * 4, s>>>(
                    x, dt, a, bm, cm, dy, dx, ddt, w, sh, sd);
        else
            ssd_bwd_chunk_kernel<false><<<chunks, NT_CHUNK, SMEM_CHUNK * 4, s>>>(
                    x, dt, a, bm, cm, dy, dx, ddt, w, sh, sd);
        const int64_t n_out = (int64_t)B * S * G * N;
        ssd_bwd_group_kernel<<<(unsigned)((n_out + NT - 1) / NT), NT, 0, s>>>(db, dc, w, sh);
    }
    ssd_bwd_da_kernel<<<H, 32, 0, s>>>(da, w, sh);
    return (int)cudaGetLastError();
}
