// Gradient of the Mamba-2 SSD chunk scan for Hopper (sm_90a), f32 in and out,
// every matrix product on the TF32 tensor cores by `wgmma` in 3xTF32.
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
// What the design meets instead: 3xTF32 runs each product three times, on
// 64-row tiles padded past the chunk, P and N, and the workspace (the state
// entering and the cotangent leaving each chunk, written once by pass 1 and
// read once by pass 3, 134 MB at the training shape; dB and dC per head,
// 134 MB more) goes through device memory between the passes.
//
// Design: five passes on one stream.  The two recurrences over the chunks
// (states forward, their cotangents in reverse) are carried by blocks that
// walk a segment of `cps` chunks in order; the plan (`plan`, from the shape
// and the SM count) cuts the nc chunks into nseg segments so that pass 1's
// 2 * B * H * nseg blocks fill the card in whole waves (2 segments of 32
// chunks at the training shape, 128 blocks; 16 of 4 at its H=4 share; one
// of 64 at jamba's H=128, with no combine and no correction):
//
//   1. ssd_bwd_walk_kernel, two kinds of block in one grid, each two
//      warpgroups per (b, h, segment): a state walker goes forward over the
//      segment's chunks, its carry R (zero, or h_init for segment 0) in
//      registers: R stored as the state entering chunk c, then R <-
//      e^{cs_last} R + the chunk's local state sum_j e^{cs_last - cs_j} u_j
//      (x) B_j, that product in a fresh accumulator and the carry update an
//      f32 FMA (the tensor cores' adds truncate, so the carry never enters
//      them); a cotangent walker goes in reverse, its carry (zero, or
//      d(final state) for the last segment) stored as the cotangent leaving
//      chunk c, then Gamma <- e^{cs_last} Gamma + sum_i e^{cs_i} dy_i (x)
//      C_i.  Each warpgroup holds one 64-row tile of N (N > 64) or half of P
//      (N <= 64).  The block first tables every chunk's row scales (wout or
//      ein) and decay, the warps taking the chunks in turn; then a chunk is
//      one barrier: its raw x or dy and B or C have come by TMA into a ring
//      of three stages (each refilled two chunks ahead), its transposed
//      operand is built into one of two buffers, its 24 `wgmma`s are issued
//      at once, and the carry's stores to the workspace run under them
//      (stores before the build's proxy fence waited for the stores to
//      drain).  Also per chunk the decay walked so far, D_c (from the
//      segment's start into c, states, in `dec`) and D'_c (from c's end to
//      the segment's end, cotangents, in `dap` until pass 3 overwrites it
//      with its da partial); and per segment the totals for the combine in
//      the slots a walk from zero leaves free: the state a segment reaches
//      in the first slot of the next (whose walk starts from zero), the
//      cotangent it reaches in the last slot of the previous, its total
//      decay in `dec` at its first chunk (segment 0's cotangent total goes
//      to dh_init).  C B^T [64 x 64] (1 MB at the training shape, read back
//      from L2) once per (b, group, chunk), spread over the group's 2 * rep
//      walkers of the segment, each taking chunks wk, wk + 2 rep, ... before
//      its walk, under the walk's first loads and the table (in the
//      transposed buffers and the last stage, which is loaded after), the
//      two warpgroups each over half of N, summed in a fixed order.
//   2. ssd_bwd_combine_kernel, one thread per (b, h, p, n), only where the
//      plan has several segments: over the nseg - 1 boundaries in order,
//      S(k + 1) = D(k) S(k) + R_end(k) and, in reverse, G(k) = D(k + 1) G(k +
//      1) + Gamma_start(k + 1), each written in place of its total: the true
//      state entering each segment and cotangent leaving it; dh_init = D(0)
//      G(0) + Gamma_start(0).
//   3. ssd_bwd_chunk_kernel, two warpgroups per (b, h, chunk): from x, dy
//      and C B^T, Q = dy x^T and from it Mq, M and A; the intra-chunk du =
//      A^T dy and the straddling sums of M; then over N in steps of 64
//      columns (C, B, S and G loaded a step, and inside a segment S(k) and
//      G(k) from L2: S_c = R_c + D_c S(k) past a segment's first chunk, G_c =
//      Gamma_c + D'_c G(k) before its last, formed in shared memory as the
//      tiles land): du += (e^{cs_last - cs_j} B) G^T (each warpgroup half of
//      du's columns), dB (warpgroup 0) and dC (warpgroup 1), each
//      inter-chunk product first, T or the C . (S^T dy) terms from it, then
//      the intra-chunk product into the same accumulator, and <G, S>; dx and
//      ddt written, dB and dC per head into the workspace, da as one partial
//      sum per block.
//   4. ssd_bwd_group_kernel: dB and dC summed over each group's heads.
//   5. ssd_bwd_da_kernel: da summed over its partials, one warp a head.
//
// Sums across blocks go through a later pass in a fixed order, never
// atomics, so a gradient is the same from run to run.  With one segment the
// carries are those of a scan over every chunk to the bit (the same
// products and FMAs in the same order).
//
// Products of passes 1 and 3: `wgmma` m64nNk8 .tf32, A from registers and B
// from shared memory.  TF32 `wgmma` takes its shared operand K-major only
// (no transpose for 32-bit types), so each product is laid out with its
// shared operand running along k, and where neither factor does, the
// transpose of the output is formed (rows n: N runs in 64-row tiles):
//
//   pass 1:  st^T [n][p] = B^T [n][j] . (wout x)^T [p][j]   (A: B across its rows)
//            ct^T [n][p] = C^T [n][i] . (ein dy)^T [p][i]    (A: C across its rows)
//            CB [i][j]   = C [i][n] . B [j][n]               (A: C along its rows;
//                                                        each warpgroup half of n)
//   pass 3:  Q [i][j]    = dy [i][p] . x [j][p]              (A: dy)
//            du^T [p][j] = dy^T [p][i] . A^T [j][i]          (A: dy across its rows)
//                        + G [p][n] . (eout B) [j][n]        (A: G)
//            dB^T [n][j] = G^T [n][p] . (wout x) [j][p]  + C^T [n][i] . Mq^T [j][i]
//            dC^T [n][i] = S^T [n][p] . (ein dy) [i][p]  + B^T [n][j] . Mq [i][j]
//
// with ein = e^{cs_i}, eout = e^{cs_last - cs_j}, wout = dt_j eout.  Each
// shared operand is written as a TF32 hi tile and a lo tile (`tf32_split`:
// hi by truncation, lo = x - hi) and a product is lo.hi + hi.lo + hi.hi,
// ~2^-20 of the f32 one; a register operand is split where it is read.
// Where a factor scales an operand's rows (e^{cs_i} dy, e^{cs_last - cs_j}
// B, dt_j e^{cs_last - cs_j} x) it is applied before the split.  Pass 3
// forms Mq, Mq^T and A^T from Q's accumulator in the orientations their
// products read.  Decays, scans, dt, the carries and the decays' gradient
// stay f32 on the CUDA cores.  No branch sits between a product's issue and
// its wait (pass 1's work under its products stores under predicates); pass
// 1 splits every k-step's A fragments up front and issues its products at
// once, pass 3 keeps a ring of two k-steps' A fragments a product.
//
// Loads: x, dy, B and C by TMA (4-D f32 maps over the caller's strides,
// 128-byte swizzle, boxes of 32 columns by L rows), and C B^T, S, G, S(k)
// and G(k) from the workspace by TMA too, completing mbarriers; where a row
// of x, dy, B or C is not 16-byte aligned, or N % 4 != 0, every thread
// copies the same tiles by 4-byte cp.async instead.  Rows past the chunk,
// P or N are zero in every tile (TMA's out-of-bounds fill or cleared before
// the load), so the 64-row tiles pad a short chunk as a ragged last chunk
// is padded (dt = 0).  In pass 3 step 0's G is loaded at the start and its
// S once x is built from, so that both come in under Q, the formation of Mq
// and A and du's intra-chunk product; C, B, S(k) and G(k) come from L2,
// S(k) and G(k) into the (eout B) tiles' room before those are built.
// Shared memory (N = 128): pass 1 225 KB (three stages of raw x or dy and
// B or C, 48 KB each, two buffers of the transposed operand's hi + lo and
// the table of row scales), pass 3 224 KB (the hi + lo tiles of Mq, Mq^T,
// wout x and ein dy, 128 KB, for the whole chunk; 96 KB that hold the raw
// x, dy, C B^T and x's hi + lo, then A^T, then each n-step's S, C, B, (eout
// B)'s hi + lo and G), so one block an
// SM, 256 threads with up to 255 registers (pass 3 uses them all: the next
// step's S and G loaded under the intra-chunk products spilled).  Pass 3's
// Q rows are permuted across the warps and its Q, du^T columns interleaved
// across the warpgroups (8-row groups 2048 bytes apart in the descriptor),
// so that the causal formation of Mq and A, a select per element, has the
// same work in every warp.  The `// phase: NAME` ... `// end of phase:
// NAME` comments mark the spans of each pass.
//
// What it still trades away: pass 3's block loads x, dy, C B^T, S and G
// and stores dB and dC per head with nothing else on its SM to overlap them
// (a second block would need 448 KB), so the loads at a block's start, the
// next n-step's and the stores are waits; inside a segment pass 3 also
// loads S(k) or G(k) an n-step and corrects its tiles (its instantiation
// with the correction compiled in runs a few per cent slower even where
// there is none, so a one-segment plan takes the other); the 64-row tiles
// pad N = 16 (jamba) four times over in the transposed products; dB and dC
// still go through the per-head workspace and pass 4, and the per-chunk
// states and cotangents through device memory once each way (pass 1 to
// pass 3); a walk is serial, so a block's fixed work (its first loads, the
// table, C B^T) weighs on a plan of short segments.
//
// Layout: x, dy [B,S,H,P], dt [B,S,H], B/C [B,S,G,N], h_init, dstate
// [B,H,P,N] are read through the strides given (x, B and C may be slices of
// the conv output), unit-stride in the last dim; the gradients are written
// contiguous.  Positions >= S (a ragged last chunk) are read as x = dy = B
// = C = dt = 0, as the plain version's zero-padding with dt = 0, and their
// gradients are not written.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int NT = 256;              // threads of passes 2 and 4: 8 warps
constexpr int THREADS = 256;         // threads of passes 1 and 3: two warpgroups
constexpr int MAX_L = 64;            // chunk length: wgmma's M and a tile's rows
constexpr int MAX_P = 64;            // head width
constexpr int MAX_N = 128;           // state width
constexpr int NB = 64;               // columns of N a step of pass 3
constexpr int STAGES = 3;            // chunks of raw tiles in flight in pass 1
constexpr int COMBINE_BATCH = 8;     // segment boundaries whose loads pass 2 starts together
constexpr int WALK_SETUP = 2;        // a pass-1 block's set-up, in chunks of its walk (the plan)
constexpr int MAX_CPS = 64;          // chunks a segment: pass 1 tables their row scales
constexpr int RING = 2;              // A fragments in flight a product: k-steps
constexpr int PANEL = MAX_L * 128;   // bytes of a 64-row panel of 32 floats
constexpr int TILE = 2 * PANEL;      // a 64 x 64 f32 tile: 16 KB
constexpr int BARS = 32;                   // bytes of the mbarriers
constexpr int SMALL = BARS + 6 * MAX_L * 4;  // the barriers; cs, cs lo, dt and three of 64

// Pass 1 at NTL 64-row tiles of N (1: N <= 64, 2: N <= 128), offsets in
// bytes from a 1024-aligned base (the barriers below it): the stages' raw x
// or dy [j][p], then their raw B or C [j][n], then two buffers of (wout
// x)^T or (ein dy)^T hi and lo [p][j] (chunks in turn), then the walk's row
// scales [chunk][64] and decays [chunk].  C B^T, before the walk, takes B
// [j][n] in the first transposed buffer (its hi in place, its lo in the last
// stage's raw B tile) and C, then the second warpgroup's partial, in the
// second.
template <int NTL>
struct WalkCfg {
    static constexpr int XR = 0, BR = STAGES * TILE, XT = BR + STAGES * NTL * TILE;
    static constexpr int WV = XT + 4 * TILE, DEC = WV + MAX_CPS * MAX_L * 4;
    static constexpr int TILES = DEC + MAX_CPS * 4;
    static constexpr int SMEM = BARS + 1024 + TILES;  // + aligning the base to 1024
    static_assert(NTL * TILE <= STAGES * TILE && NTL * TILE <= 2 * TILE, "C B^T's B fits");
    static_assert(SMEM <= 232448, "a block fits an SM");
};

// Pass 3, offsets in bytes from a 1024-aligned base: for the whole chunk Mq
// hi, lo [i][j], Mq^T [j][i], (wout x) [j][p], (ein dy) [i][p]; then six
// tiles E that hold, before the n-steps, raw x [j][p], dy [i][p], C B^T
// [i][j] (then M) and x's hi, lo [j][p] (then A^T's [j][i]), and in the
// n-steps a step's S [p][n] (in x's place, loaded once x is built from), C
// [i][n], B [j][n], (eout B)'s hi, lo [j][n] (S(seg) and G(seg) there
// before they are built) and G [p][n] (in the sixth, loaded at the start);
// and last the partial sums.
struct ChunkCfg {
    static constexpr int MQ = 0, MQT = 2 * TILE, WX = 4 * TILE, EDY = 6 * TILE, E = 8 * TILE;
    static constexpr int XR = E, DYR = E + TILE, CBR = E + 2 * TILE, XHL = E + 3 * TILE;
    static constexpr int SS = E, CS = E + TILE, BS = E + 2 * TILE, EB = E + 3 * TILE;
    static constexpr int GS = E + 5 * TILE;
    static constexpr int TILES = E + 6 * TILE;
    static constexpr int SMEM = SMALL + 1008 + TILES;
    static_assert(SMEM <= 232448, "a block fits an SM");
};

struct Strides {
    int64_t xb, xs, xh, db, ds, dh, bb, bs, bg, cb, cs, cg, yb, ys, yh, hb, hh, hp, gb, gh, gp;
};

struct Shape {
    int B, S, H, P, G, N, L, nc;
    bool vec;       // every x, dy, B and C row starts on a 16-byte boundary, P, N % 4 == 0
    int cps, nseg;  // the plan: segments of cps chunks (the last may be shorter)
};

// The workspace: C B^T per (b, group, chunk), padded to 64 x 64; entering
// states and cotangents leaving per (b, h, chunk) (and the segments' totals
// in the slots of the chunks where a walk starts from zero); dB and dC per
// head over the padded sequence; per (b, h, chunk) the decay from its
// segment's start into the chunk (the segment's total at its first chunk),
// and the decay from the chunk's end to its segment's end, then da's
// partial.
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// A warp's cs (the inclusive cumulative sum of dA = dt * a_h, the products
// rounded to f32 and summed in f64) as an f32 pair hi + lo, at positions
// lane and lane + 32 from this lane's dt there; positions past the chunk
// have dt = 0, so cs stays at its last value there.  A decay e^{cs_i - cs_j}
// takes its exponent as (hi_i - hi_j) + (lo_i - lo_j) (decay_exp), within an
// f32 ulp of the exponent however large cs grows: from a single f32 cs its
// error is an ulp of cs itself (3e-5 where cs reaches -330 within a chunk at
// jamba's a = -128), which read 0.7 of the tolerance on ddt and 1.2 on da on
// an H100.
__device__ __forceinline__ void cs_scan(float d0, float d1, float ah, float& h0, float& h1,
                                        float& l0, float& l1) {
    const int lane = threadIdx.x & 31;
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
    h0 = (float)v0;
    h1 = (float)v1;
    l0 = (float)(v0 - (double)h0);
    l1 = (float)(v1 - (double)h1);
}

// Warp 0 (pass 3): cs, cs lo and dt at the chunk's MAX_L positions.
__device__ __forceinline__ void chunk_scan(float* cs, float* csl, float* dts, const float* dtp,
                                           int64_t ds, float ah, int valid) {
    const int lane = threadIdx.x & 31;
    const float d0 = lane < valid ? dtp[lane * ds] : 0.f;
    const float d1 = lane + 32 < valid ? dtp[(lane + 32) * ds] : 0.f;
    float h0, h1, l0, l1;
    cs_scan(d0, d1, ah, h0, h1, l0, l1);
    cs[lane] = h0;
    cs[lane + 32] = h1;
    csl[lane] = l0;
    csl[lane + 32] = l1;
    dts[lane] = d0;
    dts[lane + 32] = d1;
}

// The exponent cs_i - cs_j of a decay, from chunk_scan's hi + lo pairs.
__device__ __forceinline__ float decay_exp(const float* cs, const float* csl, int i, int j) {
    return (cs[i] - cs[j]) + (csl[i] - csl[j]);
}

// ---- passes 1 and 3: tiles, loads and products ----

// Byte offset of element (r, c) of a 128-byte-swizzled tile of 64-row
// panels of 32 columns, as TMA writes it.
__device__ __forceinline__ uint32_t swz(int r, int c) {
    return (c >> 5) * PANEL + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// Descriptor of k-step kk (8 columns) of a K-major operand of 64-row panels at `tile`.
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int kk) {
    return sw128_desc(opaque(tile) + (kk >> 2) * PANEL + (kk & 3) * 32);
}

// a[0] = hi, a[1] = lo of the four values
__device__ __forceinline__ void split4(uint32_t (&a)[2][4], float v0, float v1, float v2,
                                       float v3) {
    tf32_split(v0, a[0][0], a[1][0]);
    tf32_split(v1, a[0][1], a[1][1]);
    tf32_split(v2, a[0][2], a[1][2]);
    tf32_split(v3, a[0][3], a[1][3]);
}

__device__ __forceinline__ float4 as_float4(const uint32_t (&a)[4]) {
    return make_float4(__uint_as_float(a[0]), __uint_as_float(a[1]), __uint_as_float(a[2]),
                       __uint_as_float(a[3]));
}

// d (+)= (a_hi + a_lo)(b_hi + b_lo) without lo.lo, small terms first; the
// first product overwrites d where !accumulate.  Issued, not committed.
template <int NB8>
__device__ __forceinline__ void mma3(float (&d)[NB8][4], const uint32_t (&a)[2][4], uint32_t b_hi,
                                     uint32_t b_lo, int kk, int accumulate) {
    wgmma_tf32<NB8>(d, a[1], kdesc(b_hi, kk), accumulate);
    wgmma_tf32<NB8>(d, a[0], kdesc(b_lo, kk), 1);
    wgmma_tf32<NB8>(d, a[0], kdesc(b_hi, kk), 1);
}

// Clear what a TMA load of `np` panels of `rows` rows leaves untouched in a
// tile of `total` panels at generic address `p` (rows past the chunk or P,
// panels past P or N).
__device__ __forceinline__ void zero_uncovered(uint8_t* p, int rows, int np, int total) {
    if (rows >= MAX_L && np >= total) return;
    for (int e = threadIdx.x; e < total * (PANEL / 16); e += THREADS) {
        const int pc = e / (PANEL / 16), r = (e >> 3) & (MAX_L - 1);
        if (pc >= np || r >= rows)
            *reinterpret_cast<float4*>(p + e * 16) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

// The whole tile of `np` panels at `dst` from global rows `ld` floats apart:
// element (r, c) is src[r * ld + c] where r < rows and c < cols, else zero.
// 4-byte cp.async by every thread of the block.
__device__ __forceinline__ void copy_tile(uint32_t dst, const float* src, int64_t ld, int rows,
                                          int cols, int np) {
    const int width = 32 * np;
    for (int e = threadIdx.x; e < MAX_L * width; e += THREADS) {
        const int r = e / width, c = e - r * width;
        const bool ok = r < rows && c < cols;
        cp_async4(dst + swz(r, c), ok ? src + r * ld + c : src, ok);
    }
}

// The tensor maps of one call: x, dy [B,S,H,P] and B, C [B,S,G,N] in boxes
// of L rows; the workspace's C B^T [.,64,64] and states and cotangents
// [.,P,N] in boxes of 64 and P rows.
struct Maps {
    CUtensorMap x, dy, b, c, cb, st, ct;
};

// ---- pass 1: the walks over each segment's chunks; C B^T ----

// A global store under a predicate, in PTX: no branch where a product is
// in flight (ptxas serializes every `wgmma` of a kernel where a
// branch sits between one's issue and its wait).
__device__ __forceinline__ void stg_if(float* p, float v, bool pred) {
    asm volatile(
        "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n@q st.global.f32 [%0], %1;\n}\n" ::"l"(p),
        "f"(v), "r"((int)pred)
        : "memory");
}

// The row scales and decay of a chunk, by one warp from dt already loaded
// (d0, d1: positions lane and lane + 32): cs as chunk_scan forms it (f64,
// kept as an f32 hi + lo pair), then wv = e^{cs_i} (ein, the cotangents) or
// dt_j e^{cs_last - cs_j} (wout, the states), and e^{cs_last}.
__device__ __forceinline__ void walk_scales(float* wv, float* dec, float d0, float d1, float ah,
                                            int L, bool ein) {
    const int lane = threadIdx.x & 31;
    float h0, h1, l0, l1;
    cs_scan(d0, d1, ah, h0, h1, l0, l1);
    // cs and cs lo at the chunk's last position, L - 1
    const int src = (L - 1) & 31;
    const float hl = __shfl_sync(0xffffffffu, L > 32 ? h1 : h0, src);
    const float ll = __shfl_sync(0xffffffffu, L > 32 ? l1 : l0, src);
    wv[lane] = ein ? expf(h0) : d0 * expf((hl - h0) + (ll - l0));
    wv[lane + 32] = ein ? expf(h1) : d1 * expf((hl - h1) + (ll - l1));
    if (lane == 0) *dec = expf(hl);
}

// Block (2 seg + kind, h, b): kind 0 walks the segment's chunks forward
// carrying the state, kind 1 in reverse carrying the state's cotangent.
// Warpgroup wg holds the carry's rows n of its 64-row tile (NTL = 2) or, at
// NTL = 1, its 32 columns p.  First every chunk's row scales and decay (the
// warps in turn); then a chunk: wait for its raw tiles, build its transposed
// operand (one barrier), issue its product's 24 `wgmma`s, and while they run
// store the carry entering it; then the carry update.
template <int NTL>
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_walk_kernel(const __grid_constant__ Maps maps, const float* __restrict__ x,
                    const float* __restrict__ dt, const float* __restrict__ a,
                    const float* __restrict__ bm, const float* __restrict__ cm,
                    const float* __restrict__ dy, const float* __restrict__ h_init,
                    const float* __restrict__ dstate, float* __restrict__ dh_init, Work w,
                    Shape sh, Strides sd) {
    using K = WalkCfg<NTL>;
    constexpr int NB8 = NTL == 2 ? 8 : 4;  // the product's 8-column tiles of p
    extern __shared__ float4 smem_bwd[];
    uint8_t* smem = reinterpret_cast<uint8_t*>(smem_bwd);
    const uint32_t small = smem_addr(smem_bwd);
    const uint32_t base = (small + BARS + 1023) & ~1023u;
    // shared memory at address ad as a C++ lvalue
    auto sf = [&](uint32_t ad) -> float& { return *reinterpret_cast<float*>(smem + (ad - small)); };
    auto sf4 = [&](uint32_t ad) -> float4& {
        return *reinterpret_cast<float4*>(smem + (ad - small));
    };
    const uint32_t bar_cb = small + 8 * STAGES;  // stage s's barrier at small + 8 s
    float* wtab = reinterpret_cast<float*>(smem + (base - small) + K::WV);  // [t][64]
    float* dtab = reinterpret_cast<float*>(smem + (base - small) + K::DEC);  // [t]
    const int kind = blockIdx.x & 1, seg = blockIdx.x >> 1, h = blockIdx.y, b = blockIdx.z;
    const int rep = sh.H / sh.G, g = h / rep;
    const int L = sh.L, P = sh.P, N = sh.N;
    const int c0 = seg * sh.cps, n = min(sh.nc, c0 + sh.cps) - c0;
    const int tid = threadIdx.x, wg = tid >> 7, wq = (tid >> 5) & 3, lane = tid & 31;
    const int gq = lane >> 2, tq = lane & 3;
    const int npx = (P + 31) >> 5, npn = (N + 31) >> 5;
    const bool tma = sh.vec;
    const int64_t bh = (int64_t)b * sh.H + h;
    const float ah = a[h];
    // this thread's carry elements: rows n nr (+ 8), columns p pc + 8 cc (+ 1)
    const int nr = (NTL == 2 ? 64 * wg : 0) + 16 * wq + gq;
    const int pc = (NTL == 2 ? 0 : 32 * wg) + 2 * tq;
    // the walk's tensors: x and B forward, dy and C in reverse
    const CUtensorMap* mxy = kind ? &maps.dy : &maps.x;
    const CUtensorMap* mbc = kind ? &maps.c : &maps.b;
    const float* xyp = kind ? dy + b * sd.yb + h * sd.yh : x + b * sd.xb + h * sd.xh;
    const int64_t xys = kind ? sd.ys : sd.xs;
    const float* bcp = kind ? cm + b * sd.cb + g * sd.cg : bm + b * sd.bb + g * sd.bg;
    const int64_t bcs = kind ? sd.cs : sd.bs;
    const float* dtp = dt + b * sd.db + h * sd.dh;
    auto chunk_of = [&](int t) { return kind ? c0 + n - 1 - t : c0 + t; };
    // chunk t's raw tiles into stage t % STAGES, completing its barrier
    auto load = [&](int t) {
        const int st = t % STAGES, s0 = chunk_of(t) * L;
        const uint32_t bar = small + 8 * st, xr = base + K::XR + st * TILE;
        const uint32_t br = base + K::BR + st * NTL * TILE;
        if (tma) {
            if (tid == 0) {
                mbar_arrive_expect_tx(bar, (npx + npn) * L * 128);
                for (int q = 0; q < npx; ++q)
                    tma_load_4d(xr + q * PANEL, mxy, bar, 32 * q, s0, h, b);
                for (int q = 0; q < npn; ++q)
                    tma_load_4d(br + q * PANEL, mbc, bar, 32 * q, s0, g, b);
            }
        } else {
            const int valid = min(L, sh.S - s0);
            copy_tile(xr, xyp + (int64_t)s0 * xys, xys, valid, P, 2);
            copy_tile(br, bcp + (int64_t)s0 * bcs, bcs, valid, N, 2 * NTL);
            cp_async_mbar_arrive_noinc(bar);
        }
    };
    // C B^T of chunk c, before the walk: B into the first transposed buffer
    // (its hi in place, its lo into the last stage's raw B tile, zero where
    // that tile's B or C is), C into the second (then the second
    // warpgroup's partial)
    const uint32_t cbb = base + K::XT, cbc = base + K::XT + 2 * TILE;
    const uint32_t cbl = base + K::BR + (STAGES - 1) * NTL * TILE;
    auto load_cb = [&](int c) {
        const int s0 = c * L;
        if (tma) {
            zero_uncovered(smem + (cbb - small), L, npn, 2 * NTL);
            zero_uncovered(smem + (cbc - small), L, npn, 2 * NTL);
            fence_proxy_async();  // the zeros, for the product (the loads fill the rest)
            if (tid == 0) {
                mbar_arrive_expect_tx(bar_cb, 2 * npn * L * 128);
                for (int q = 0; q < npn; ++q) {
                    tma_load_4d(cbb + q * PANEL, &maps.b, bar_cb, 32 * q, s0, g, b);
                    tma_load_4d(cbc + q * PANEL, &maps.c, bar_cb, 32 * q, s0, g, b);
                }
            }
        } else {
            const int valid = min(L, sh.S - s0);
            copy_tile(cbb, bm + b * sd.bb + g * sd.bg + (int64_t)s0 * sd.bs, sd.bs, valid, N,
                      2 * NTL);
            copy_tile(cbc, cm + b * sd.cb + g * sd.cg + (int64_t)s0 * sd.cs, sd.cs, valid, N,
                      2 * NTL);
            cp_async_mbar_arrive_noinc(bar_cb);
        }
    };

    if (tid == 0) {
        for (int st = 0; st <= STAGES; ++st) mbar_init(small + 8 * st, tma ? 1 : THREADS);
        fence_barrier_init();
        if (tma)
            for (const CUtensorMap* m : {&maps.x, &maps.dy, &maps.b, &maps.c})
                prefetch_tensormap(m);
    }
    if (tma)
        for (int st = 0; st < STAGES; ++st) {
            zero_uncovered(smem + (base - small) + K::XR + st * TILE, L, npx, 2);
            zero_uncovered(smem + (base - small) + K::BR + st * NTL * TILE, L, npn, 2 * NTL);
        }
    fence_proxy_async();
    __syncthreads();
    // this block's share of the segment's C B^T: chunks c0 + wk + 2 rep k
    const int wk = kind * rep + h % rep;
    if (wk < n) load_cb(c0 + wk);
    for (int t = 0; t < min(n, STAGES - 1); ++t) load(t);
    // phase: walk scan
    // every chunk's row scales and decay, in walk order: warp w the chunks
    // w, w + 8, ..., four chunks' dt loads in flight at once
    for (int t0 = tid >> 5; t0 < n; t0 += 4 * (THREADS / 32)) {
        float d[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int t = t0 + u * (THREADS / 32);
            const int s0 = chunk_of(min(t, n - 1)) * L, valid = t < n ? min(L, sh.S - s0) : 0;
            const float* q = dtp + (int64_t)s0 * sd.ds;
            d[u][0] = lane < valid ? q[lane * sd.ds] : 0.f;
            d[u][1] = lane + 32 < valid ? q[(lane + 32) * sd.ds] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int t = t0 + u * (THREADS / 32);
            if (t < n) walk_scales(wtab + t * MAX_L, dtab + t, d[u][0], d[u][1], ah, L, kind);
        }
    }
    // end of phase: walk scan
    // the carry: zero, or h_init (the states of segment 0) or d(final state)
    // (the cotangents of the last segment)
    float carry[NB8][4];
    {
        const float* from = kind ? (seg == sh.nseg - 1 ? dstate + b * sd.gb + h * sd.gh : nullptr)
                                 : (seg == 0 && h_init != nullptr ? h_init + b * sd.hb + h * sd.hh
                                                                  : nullptr);
        const int64_t fp = kind ? sd.gp : sd.hp;
#pragma unroll
        for (int cc = 0; cc < NB8; ++cc)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int nn = nr + 8 * (e >> 1), p = pc + 8 * cc + (e & 1);
                carry[cc][e] = from != nullptr && p < P && nn < N ? from[p * fp + nn] : 0.f;
            }
    }
    // the carry into a [P][N] slot, each store under a predicate
    auto store = [&](float* out, bool want) {
#pragma unroll
        for (int cc = 0; cc < NB8; ++cc)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int nn = nr + 8 * (e >> 1), p = pc + 8 * cc + (e & 1);
                stg_if(out + p * N + nn, carry[cc][e], want && p < P && nn < N);
            }
    };
    __syncthreads();  // the table is in

    // phase: walk cb
    // C B^T of this block's chunks of the segment, under the walk's first loads
    for (int j = wk, k = 0; j < n; j += 2 * rep, ++k) {
        if (k > 0) load_cb(c0 + j);
        mbar_wait_or_trap(bar_cb, k & 1);
        // B hi in place and lo apart, [j][n]
        for (int off = tid * 16; off < NTL * TILE; off += THREADS * 16) {
            const float4 v = sf4(cbb + off);
            uint32_t s2[2][4];
            split4(s2, v.x, v.y, v.z, v.w);
            sf4(cbb + off) = as_float4(s2[0]);
            sf4(cbl + off) = as_float4(s2[1]);
        }
        fence_proxy_async();
        __syncthreads();
        // [i][j] over this warpgroup's half of n (k-steps 4 NTL wg ..): A = C
        // along its rows, every k-step's A split up front, one commit
        float cb[8][4];
        {
            uint32_t af[4 * NTL][2][4];
            const int i = 16 * wq + gq;
#pragma unroll
            for (int kk = 0; kk < 4 * NTL; ++kk) {
                const int nn = 32 * NTL * wg + 8 * kk + tq;
                split4(af[kk], sf(cbc + swz(i, nn)), sf(cbc + swz(i + 8, nn)),
                       sf(cbc + swz(i, nn + 4)), sf(cbc + swz(i + 8, nn + 4)));
            }
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4 * NTL; ++kk)
                mma3<8>(cb, af[kk], cbb, cbl, kk + 4 * NTL * wg, kk > 0);
            wgmma_commit();
            wgmma_wait<0>();
            wgmma_hold(cb);
#pragma unroll
            for (int kk = 0; kk < 4 * NTL; ++kk) wgmma_hold(af[kk]);
        }
        // warpgroup 1's partial through shared memory (C's tile, once both
        // warpgroups have read it), added to warpgroup 0's
        __syncthreads();
        float* ex = reinterpret_cast<float*>(smem + (cbc - small));
        if (wg == 1) {
#pragma unroll
            for (int cc = 0; cc < 8; ++cc)
#pragma unroll
                for (int e = 0; e < 4; ++e) ex[(cc * 4 + e) * 128 + (tid & 127)] = cb[cc][e];
        }
        __syncthreads();
        if (wg == 0) {
            float* cbo = w.cb + (((int64_t)b * sh.G + g) * sh.nc + c0 + j) * MAX_L * MAX_L;
#pragma unroll
            for (int cc = 0; cc < 8; ++cc)
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int i = 16 * wq + gq + 8 * hf, jj = 8 * cc + 2 * tq;
                    *reinterpret_cast<float2*>(cbo + i * MAX_L + jj) = make_float2(
                            cb[cc][2 * hf] + ex[(cc * 4 + 2 * hf) * 128 + tid],
                            cb[cc][2 * hf + 1] + ex[(cc * 4 + 2 * hf + 1) * 128 + tid]);
                }
        }
        __syncthreads();  // both warpgroups are done with the tiles
    }
    // end of phase: walk cb
    if (STAGES - 1 < n) load(STAGES - 1);  // the last stage, free of C B^T now

    float dprod = 1.f;  // the decays walked: D_c (states) or D'_c (cotangents)
    for (int t = 0; t < n; ++t) {
        const int c = chunk_of(t), st = t % STAGES;
        const uint32_t xt = base + K::XT + (t & 1) * 2 * TILE;
        const int64_t blk = bh * sh.nc + c;
        const float dec = dtab[t];
        const float* wv = wtab + t * MAX_L;
        mbar_wait_or_trap(small + 8 * st, (t / STAGES) & 1);
        // phase: walk build
        // (wout x)^T or (ein dy)^T hi and lo, [p][j]: four j of one p a
        // store, the loads all out before the stores
        {
            const uint32_t xr = base + K::XR + st * TILE;
            float v[4][4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int item = tid + k * THREADS, p = item & (MAX_P - 1), j4 = (item >> 6) * 4;
#pragma unroll
                for (int q = 0; q < 4; ++q) v[k][q] = wv[j4 + q] * sf(xr + swz(j4 + q, p));
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int item = tid + k * THREADS, p = item & (MAX_P - 1), j4 = (item >> 6) * 4;
                const uint32_t off = swz(p, j4);
                uint32_t s2[2][4];
                split4(s2, v[k][0], v[k][1], v[k][2], v[k][3]);
                sf4(xt + off) = as_float4(s2[0]);
                sf4(xt + TILE + off) = as_float4(s2[1]);
            }
        }
        // end of phase: walk build
        fence_proxy_async();
        // every warp has built chunk t and read chunk t - 1's raw tiles: the
        // stage of chunk t - 1 takes chunk t + 2
        __syncthreads();
        if (t >= 1 && t + 2 < n) load(t + 2);
        // the chunk's local state^T or cotangent^T [n][p] in a fresh
        // accumulator: A = B or C across its rows (n = nr, nr + 8; k = j),
        // every k-step's A split up front and the 24 products issued at once
        float acc[NB8][4];
        uint32_t af[MAX_L / 8][2][4];
        // phase: walk local
        {
            const uint32_t araw = base + K::BR + st * NTL * TILE;
            const uint32_t bop = xt + (NTL == 2 ? 0 : wg * 32 * 128);
#pragma unroll
            for (int kk = 0; kk < MAX_L / 8; ++kk) {
                const int j = 8 * kk + tq;
                split4(af[kk], sf(araw + swz(j, nr)), sf(araw + swz(j, nr + 8)),
                       sf(araw + swz(j + 4, nr)), sf(araw + swz(j + 4, nr + 8)));
            }
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < MAX_L / 8; ++kk)
                mma3<NB8>(acc, af[kk], bop, bop + TILE, kk, kk > 0);
            wgmma_commit();
        }
        // end of phase: walk local
        // phase: walk store
        // under the product: the state entering chunk c or the cotangent
        // leaving it to its slot, but where the walk started from zero (that
        // slot takes a segment's total); the decay walked into c
        store((kind ? w.ct : w.st) + blk * P * N, t > 0 || seg == (kind ? sh.nseg - 1 : 0));
        stg_if((kind ? w.dap : w.dec) + blk, dprod, t > 0 && tid == 0);
        // end of phase: walk store
        wgmma_wait<0>();
        wgmma_hold(acc);
#pragma unroll
        for (int kk = 0; kk < MAX_L / 8; ++kk) wgmma_hold(af[kk]);
        // phase: walk carry
#pragma unroll
        for (int cc = 0; cc < NB8; ++cc)
#pragma unroll
            for (int e = 0; e < 4; ++e) carry[cc][e] = fmaf(dec, carry[cc][e], acc[cc][e]);
        dprod *= dec;
        // end of phase: walk carry
    }
    // the segment's totals: the state it reaches into the next segment's
    // first slot, and its total decay; the cotangent it reaches into the
    // previous segment's last slot, or for segment 0 into dh_init (pass 2
    // adds the later segments' part where there are several)
    if (kind == 0) {
        store(w.st + (bh * sh.nc + c0 + n) * P * N, seg < sh.nseg - 1);
        if (tid == 0) w.dec[bh * sh.nc + c0] = dprod;
    } else if (seg > 0) {
        store(w.ct + (bh * sh.nc + c0 - 1) * P * N, true);
    } else if (dh_init != nullptr) {
        store(dh_init + bh * P * N, true);
    }
}

// ---- pass 2: the combine over the segments' boundaries ----

// One thread per (b, h, p, n): the states entering segments 1.. nseg - 1
// forward and the cotangents leaving segments nseg - 2 .. 0 in reverse, each
// in place of the total pass 1 left in its slot; dh_init.  With no chunks,
// dh_init is d(final state).
__global__ void __launch_bounds__(NT)
ssd_bwd_combine_kernel(const float* __restrict__ dstate, float* __restrict__ dh_init, Work w,
                       Shape sh, Strides sd) {
    const int i = blockIdx.x * NT + threadIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int pn = sh.P * sh.N;
    if (i >= pn) return;
    const int64_t bh = (int64_t)b * sh.H + h;
    if (sh.nc == 0) {
        const int p = i / sh.N, n = i - p * sh.N;
        if (dh_init != nullptr)
            dh_init[bh * pn + i] = dstate[b * sd.gb + h * sd.gh + p * sd.gp + n];
        return;
    }
    const float* dec = w.dec + bh * sh.nc;  // a segment's total decay at its first chunk
    float* st = w.st + bh * sh.nc * pn + i;
    float* ct = w.ct + bh * sh.nc * pn + i;
    const int cps = sh.cps, nb = sh.nseg - 1;
    // each batch's loads (of both) start before its stores
    float s = 0.f, gc = 0.f;
    for (int k0 = 0; k0 < nb; k0 += COMBINE_BATCH) {
        float ls[COMBINE_BATCH], ds[COMBINE_BATCH], lc[COMBINE_BATCH], dc[COMBINE_BATCH];
#pragma unroll
        for (int u = 0; u < COMBINE_BATCH; ++u)
            if (k0 + u < nb) {
                const int kf = k0 + u + 1, kr = nb - 1 - (k0 + u);  // entered; left
                ls[u] = st[(int64_t)kf * cps * pn];
                ds[u] = dec[(kf - 1) * cps];
                lc[u] = ct[((int64_t)(kr + 1) * cps - 1) * pn];
                dc[u] = dec[(kr + 1) * cps];
            }
#pragma unroll
        for (int u = 0; u < COMBINE_BATCH; ++u)
            if (k0 + u < nb) {
                const int kf = k0 + u + 1, kr = nb - 1 - (k0 + u);
                s = fmaf(ds[u], s, ls[u]);
                st[(int64_t)kf * cps * pn] = s;
                gc = fmaf(dc[u], gc, lc[u]);
                ct[((int64_t)(kr + 1) * cps - 1) * pn] = gc;
            }
    }
    if (dh_init != nullptr) dh_init[bh * pn + i] = fmaf(dec[0], gc, dh_init[bh * pn + i]);
}

// ---- pass 3: the gradients of one chunk of one head ----

// Descriptor of k-step kk of this warpgroup's 32 rows of a K-major operand
// of 64-row panels at `tile`: the 8-row groups wg, wg + 2, wg + 4, wg + 6
// (a stride of 2048 bytes between them), so that row r of the product's N
// is row 16 (r / 8) + 8 wg + r % 8 of the tile.
__device__ __forceinline__ uint64_t kdesc_wg(uint32_t tile, int kk, int wg) {
    const uint32_t addr = opaque(tile) + wg * 1024 + (kk >> 2) * PANEL + (kk & 3) * 32;
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
           ((uint64_t)(2048 >> 4) << 32) | (1ull << 62);
}

template <int NB8>
__device__ __forceinline__ void mma3_wg(float (&d)[NB8][4], const uint32_t (&a)[2][4],
                                        uint32_t b_hi, uint32_t b_lo, int kk, int wg,
                                        int accumulate) {
    wgmma_tf32<NB8>(d, a[1], kdesc_wg(b_hi, kk, wg), accumulate);
    wgmma_tf32<NB8>(d, a[0], kdesc_wg(b_lo, kk, wg), 1);
    wgmma_tf32<NB8>(d, a[0], kdesc_wg(b_hi, kk, wg), 1);
}

// SEG: the plan has several segments, so that S and G are corrected inside
// them (without, the correction's code is not compiled in).
template <bool SEG>
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_chunk_kernel(const __grid_constant__ Maps maps, const float* __restrict__ x,
                     const float* __restrict__ dt, const float* __restrict__ a,
                     const float* __restrict__ bm, const float* __restrict__ cm,
                     const float* __restrict__ dy, float* __restrict__ dx,
                     float* __restrict__ ddt, Work w, Shape sh, Strides sd) {
    using K = ChunkCfg;
    extern __shared__ float4 smem_bwd[];
    uint8_t* smem = reinterpret_cast<uint8_t*>(smem_bwd);
    const uint32_t small = smem_addr(smem_bwd);
    const uint32_t base = (small + SMALL + 1023) & ~1023u;
    auto sf = [&](uint32_t ad) -> float& { return *reinterpret_cast<float*>(smem + (ad - small)); };
    auto sf2 = [&](uint32_t ad) -> float2& {
        return *reinterpret_cast<float2*>(smem + (ad - small));
    };
    auto sf4 = [&](uint32_t ad) -> float4& {
        return *reinterpret_cast<float4*>(smem + (ad - small));
    };
    uint8_t* tiles = smem + (base - small);
    float* cs = reinterpret_cast<float*>(smem + BARS);
    float* csl = cs + MAX_L;
    float* dts = csl + MAX_L;
    float* ein = dts + MAX_L;        // e^{cs_i}
    float* eout = ein + MAX_L;       // e^{cs_last - cs_j}
    float* straddle = eout + MAX_L;  // sum_{i>=k, j<k} M_ij
    // the chunk's x, dy and C B^T; each step's S and G; each step's C and B
    const uint32_t bar_ld = small, bar_sg = small + 8, bar_cb = small + 16;
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, g = h / (sh.H / sh.G);
    const int L = sh.L, P = sh.P, N = sh.N, s0 = c * L, valid = min(L, sh.S - s0);
    const int tid = threadIdx.x, wg = tid >> 7, wq = (tid >> 5) & 3, lane = tid & 31;
    const int gq = lane >> 2, tq = lane & 3;
    const int npx = (P + 31) >> 5, npn0 = (min(N, NB) + 31) >> 5;
    const bool tma = sh.vec;
    const int64_t blk = ((int64_t)b * sh.H + h) * sh.nc + c;
    const int64_t cbk = ((int64_t)b * sh.G + g) * sh.nc + c;  // this chunk's C B^T
    // inside a segment pass 1 walked from zero: S_c = R_c + D_c S(seg) past
    // the segment's first chunk (S(seg) in the first chunk's slot), G_c =
    // Gamma_c + D'_c G(seg) before its last (G(seg) in the last chunk's
    // slot); 0 where no correction is due (or the decay is 0: it adds nothing)
    const int seg = c / sh.cps, cf = seg * sh.cps, cl = min(sh.nc, cf + sh.cps) - 1;
    const float dsc = SEG && seg > 0 && c > cf ? w.dec[blk] : 0.f;
    const float dgc = SEG && seg < sh.nseg - 1 && c < cl ? w.dap[blk] : 0.f;
    const int64_t sp = (int64_t)sh.nc * L;  // the padded sequence of the per-head sums
    const float* cbase = cm + b * sd.cb + g * sd.cg + (int64_t)s0 * sd.cs;
    const float* bbase = bm + b * sd.bb + g * sd.bg + (int64_t)s0 * sd.bs;
    // this thread's columns j of Q, du^T: 16 cc + 8 wg + 2 tq (+ 1), and of
    // dB^T and dC^T: 8 cc + 2 tq (+ 1); its rows i of Q (Q's rows permuted so
    // that every warp holds rows of every part of the causal triangle): iq and
    // iq + 32; its rows p of du^T and n of dB^T, dC^T: 16 wq + gq (+ 8)
    const int iq = 16 * (gq >> 2) + 4 * wq + (gq & 3), r0 = 16 * wq + gq;

    // the loads of step st's S and G (the chunk's S and G, from the workspace)
    // and of its C and B, each completing its barrier; TMA by thread 0 or
    // cp.async by every thread
    auto load_sg = [&](int nb) {
        const int npn = (min(NB, N - nb) + 31) >> 5;
        if (tma) {
            if (tid == 0) {
                mbar_arrive_expect_tx(bar_sg, npn * 128 * 2 * P);
                for (int pc = 0; pc < npn; ++pc) {
                    tma_load_4d(base + K::SS + pc * PANEL, &maps.st, bar_sg, nb + 32 * pc, 0,
                                (int)blk, 0);
                    tma_load_4d(base + K::GS + pc * PANEL, &maps.ct, bar_sg, nb + 32 * pc, 0,
                                (int)blk, 0);
                }
            }
        } else {
            copy_tile(base + K::SS, w.st + blk * P * N + nb, N, P, min(NB, N - nb), 2);
            copy_tile(base + K::GS, w.ct + blk * P * N + nb, N, P, min(NB, N - nb), 2);
            cp_async_mbar_arrive_noinc(bar_sg);
        }
    };
    // with them the step's S(seg) and G(seg) where a correction is due, into
    // the (eout B) tiles' room
    auto load_cb = [&](int nb) {
        const int npn = (min(NB, N - nb) + 31) >> 5;
        const int64_t bs = blk - (c - cf), bg = blk + (cl - c);  // S(seg)'s and G(seg)'s slots
        if (tma) {
            if (tid == 0) {
                const int seg_tiles = (dsc != 0.f) + (dgc != 0.f);
                mbar_arrive_expect_tx(bar_cb, npn * 128 * (2 * L + seg_tiles * P));
                for (int pc = 0; pc < npn; ++pc) {
                    tma_load_4d(base + K::CS + pc * PANEL, &maps.c, bar_cb, nb + 32 * pc, s0, g,
                                b);
                    tma_load_4d(base + K::BS + pc * PANEL, &maps.b, bar_cb, nb + 32 * pc, s0, g,
                                b);
                    if (dsc != 0.f)
                        tma_load_4d(base + K::EB + pc * PANEL, &maps.st, bar_cb, nb + 32 * pc, 0,
                                    (int)bs, 0);
                    if (dgc != 0.f)
                        tma_load_4d(base + K::EB + TILE + pc * PANEL, &maps.ct, bar_cb,
                                    nb + 32 * pc, 0, (int)bg, 0);
                }
            }
        } else {
            copy_tile(base + K::CS, cbase + nb, sd.cs, valid, min(NB, N - nb), 2);
            copy_tile(base + K::BS, bbase + nb, sd.bs, valid, min(NB, N - nb), 2);
            if (dsc != 0.f)
                copy_tile(base + K::EB, w.st + bs * P * N + nb, N, P, min(NB, N - nb), 2);
            if (dgc != 0.f)
                copy_tile(base + K::EB + TILE, w.ct + bg * P * N + nb, N, P, min(NB, N - nb), 2);
            cp_async_mbar_arrive_noinc(bar_cb);
        }
    };

    if (tid == 0) {
        for (uint32_t bar : {bar_ld, bar_sg, bar_cb}) mbar_init(bar, tma ? 1 : THREADS);
        fence_barrier_init();
        if (tma)
            for (const CUtensorMap* m : {&maps.x, &maps.dy, &maps.cb, &maps.ct, &maps.st,
                                         &maps.c, &maps.b})
                prefetch_tensormap(m);
    }
    if (tma) {
        zero_uncovered(tiles + K::XR, L, npx, 2);
        zero_uncovered(tiles + K::DYR, L, npx, 2);
        zero_uncovered(tiles + K::GS, P, npn0, 2);
    }
    fence_proxy_async();
    __syncthreads();
    // phase: load
    if (tma) {
        if (tid == 0) {
            mbar_arrive_expect_tx(bar_ld, 2 * npx * L * 128 + TILE);
            for (int pc = 0; pc < npx; ++pc) {
                tma_load_4d(base + K::XR + pc * PANEL, &maps.x, bar_ld, 32 * pc, s0, h, b);
                tma_load_4d(base + K::DYR + pc * PANEL, &maps.dy, bar_ld, 32 * pc, s0, h, b);
            }
            for (int pc = 0; pc < 2; ++pc)
                tma_load_4d(base + K::CBR + pc * PANEL, &maps.cb, bar_ld, 32 * pc, 0, (int)cbk,
                            0);
            // step 0's G now, its S once x is built from (the same barrier phase)
            mbar_arrive_expect_tx(bar_sg, npn0 * 128 * 2 * P);
            for (int pc = 0; pc < npn0; ++pc)
                tma_load_4d(base + K::GS + pc * PANEL, &maps.ct, bar_sg, 32 * pc, 0, (int)blk, 0);
        }
    } else {
        copy_tile(base + K::XR, x + b * sd.xb + h * sd.xh + (int64_t)s0 * sd.xs, sd.xs, valid, P,
                  2);
        copy_tile(base + K::DYR, dy + b * sd.yb + h * sd.yh + (int64_t)s0 * sd.ys, sd.ys, valid,
                  P, 2);
        copy_tile(base + K::CBR, w.cb + cbk * MAX_L * MAX_L, MAX_L, MAX_L, MAX_L, 2);
        cp_async_mbar_arrive_noinc(bar_ld);
    }
    const float ah = a[h];
    if (tid < 32)
        chunk_scan(cs, csl, dts, dt + b * sd.db + h * sd.dh + (int64_t)s0 * sd.ds, sd.ds, ah,
                   valid);
    __syncthreads();
    if (tid < MAX_L) {
        ein[tid] = expf(cs[tid]);
        eout[tid] = expf(decay_exp(cs, csl, L - 1, tid));
    }
    __syncthreads();
    mbar_wait_or_trap(bar_ld, 0);
    // end of phase: load

    // phase: build
    // x, (wout x) [j][p] and (ein dy) [i][p] hi and lo, each in its raw tile's
    // layout; x at this thread's elements of du^T, for x . du after the n-steps
    float xr[4][4];
    {
        float4 xv[4], yv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const uint32_t off = (tid + k * THREADS) * 16;
            xv[k] = sf4(base + K::XR + off);
            yv[k] = sf4(base + K::DYR + off);
        }
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                xr[cc][e] = sf(base + K::XR +
                               swz(16 * cc + 8 * wg + 2 * tq + (e & 1), r0 + 8 * (e >> 1)));
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const uint32_t off = (tid + k * THREADS) * 16;
            const int r = (off % PANEL) / 128;
            const float wo = eout[r] * dts[r], ei = ein[r];
            uint32_t s[2][4];
            split4(s, xv[k].x, xv[k].y, xv[k].z, xv[k].w);
            sf4(base + K::XHL + off) = as_float4(s[0]);
            sf4(base + K::XHL + TILE + off) = as_float4(s[1]);
            split4(s, wo * xv[k].x, wo * xv[k].y, wo * xv[k].z, wo * xv[k].w);
            sf4(base + K::WX + off) = as_float4(s[0]);
            sf4(base + K::WX + TILE + off) = as_float4(s[1]);
            split4(s, ei * yv[k].x, ei * yv[k].y, ei * yv[k].z, ei * yv[k].w);
            sf4(base + K::EDY + off) = as_float4(s[0]);
            sf4(base + K::EDY + TILE + off) = as_float4(s[1]);
        }
    }
    // end of phase: build
    fence_proxy_async();
    __syncthreads();  // x is built from: its raw tile takes step 0's S

    // phase: q
    // Q [i][j] = dy x^T for this warpgroup's 32 columns j: A = dy along its rows
    float q[4][4];
    {
        uint32_t af[RING][2][4];
#pragma unroll
        for (int kk = 0; kk < MAX_P / 8; ++kk) {
            const int slot = kk % RING;
            if (kk >= RING) {
                wgmma_wait<RING - 1>();
                wgmma_hold(af[slot]);
            }
            const int pc = 8 * kk + tq;
            split4(af[slot], sf(base + K::DYR + swz(iq, pc)), sf(base + K::DYR + swz(iq + 32, pc)),
                   sf(base + K::DYR + swz(iq, pc + 4)), sf(base + K::DYR + swz(iq + 32, pc + 4)));
            wgmma_fence();
            mma3_wg<4>(q, af[slot], base + K::XHL, base + K::XHL + TILE, kk, wg, kk > 0);
            wgmma_commit();
        }
        wgmma_wait<0>();
        wgmma_hold(q);
#pragma unroll
        for (int r = 0; r < RING; ++r) wgmma_hold(af[r]);
    }
    // end of phase: q
    if (tma) zero_uncovered(tiles + K::SS, P, npn0, 2);
    fence_proxy_async();
    __syncthreads();  // both warpgroups are done with x's hi and lo, where A^T goes
    if (tma) {
        if (tid == 0)
            for (int pc = 0; pc < npn0; ++pc)
                tma_load_4d(base + K::SS + pc * PANEL, &maps.st, bar_sg, 32 * pc, 0, (int)blk, 0);
    } else {
        load_sg(0);
    }

    // phase: form
    // Mq = Q dt_j E, M = (C B^T) o Mq below the diagonal, A = (C B^T) o E:
    // Mq [i][j] and Mq^T [j][i] hi and lo, A^T [j][i] hi and lo, M [i][j] in
    // place of C B^T
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
            const int i = iq + 32 * rh, j0 = 16 * cc + 8 * wg + 2 * tq;
            const float2 cb2 = sf2(base + K::CBR + swz(i, j0));
            float mq[2], av[2], m[2];
#pragma unroll
            for (int f = 0; f < 2; ++f) {  // selects, no branch: e^{-inf} = 0 off the triangle
                const int j = j0 + f;
                const bool on = j <= i && i < L;
                const float ex = expf(on ? decay_exp(cs, csl, i, j) : -__int_as_float(0x7f800000));
                const float cbe = f ? cb2.y : cb2.x;
                mq[f] = q[cc][2 * rh + f] * dts[j] * ex;
                av[f] = cbe * ex;
                m[f] = j < i ? cbe * mq[f] : 0.f;
            }
            uint32_t mh[2], ml[2], ah2[2], al2[2];
#pragma unroll
            for (int f = 0; f < 2; ++f) {
                tf32_split(mq[f], mh[f], ml[f]);
                tf32_split(av[f], ah2[f], al2[f]);
            }
            const uint32_t oij = swz(i, j0);
            sf2(base + K::MQ + oij) = make_float2(__uint_as_float(mh[0]), __uint_as_float(mh[1]));
            sf2(base + K::MQ + TILE + oij) =
                make_float2(__uint_as_float(ml[0]), __uint_as_float(ml[1]));
            sf2(base + K::CBR + oij) = make_float2(m[0], m[1]);
#pragma unroll
            for (int f = 0; f < 2; ++f) {
                const uint32_t oji = swz(j0 + f, i);
                sf(base + K::MQT + oji) = __uint_as_float(mh[f]);
                sf(base + K::MQT + TILE + oji) = __uint_as_float(ml[f]);
                sf(base + K::XHL + oji) = __uint_as_float(ah2[f]);
                sf(base + K::XHL + TILE + oji) = __uint_as_float(al2[f]);
            }
        }
    // end of phase: form
    fence_proxy_async();
    __syncthreads();

    // phase: du
    // du^T [p][j] = sum_i dy[i][p] A[i][j] for this warpgroup's 32 columns j:
    // A = dy across its rows, B = A^T
    float du[4][4];
    {
        uint32_t af[RING][2][4];
#pragma unroll
        for (int kk = 0; kk < MAX_L / 8; ++kk) {
            const int slot = kk % RING;
            if (kk >= RING) {
                wgmma_wait<RING - 1>();
                wgmma_hold(af[slot]);
            }
            const int i = 8 * kk + tq;
            split4(af[slot], sf(base + K::DYR + swz(i, r0)), sf(base + K::DYR + swz(i, r0 + 8)),
                   sf(base + K::DYR + swz(i + 4, r0)), sf(base + K::DYR + swz(i + 4, r0 + 8)));
            wgmma_fence();
            mma3_wg<4>(du, af[slot], base + K::XHL, base + K::XHL + TILE, kk, wg, kk > 0);
            wgmma_commit();
        }
        wgmma_wait<0>();
        wgmma_hold(du);
#pragma unroll
        for (int r = 0; r < RING; ++r) wgmma_hold(af[r]);
    }
    // end of phase: du

    // phase: straddle
    // each row of M to its exclusive prefix sums over j (four threads a row,
    // 16 columns each), then straddle[k] = sum over rows i >= k of row i's
    // prefix at k (four threads a column, each the rows i = part mod 4)
    {
        const int i = tid >> 2, qd = tid & 3;
        float4 m4[4];
        float tot = 0.f;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            m4[u] = sf4(base + K::CBR + swz(i, 16 * qd + 4 * u));
            tot += ((m4[u].x + m4[u].y) + m4[u].z) + m4[u].w;
        }
        const float e1 = __shfl_up_sync(0xffffffffu, tot, 1, 4);
        const float e2 = __shfl_up_sync(0xffffffffu, tot, 2, 4);
        const float e3 = __shfl_up_sync(0xffffffffu, tot, 3, 4);
        float run = ((qd > 2 ? e3 : 0.f) + (qd > 1 ? e2 : 0.f)) + (qd > 0 ? e1 : 0.f);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            float4 o;
            o.x = run;
            run += m4[u].x;
            o.y = run;
            run += m4[u].y;
            o.z = run;
            run += m4[u].z;
            o.w = run;
            run += m4[u].w;
            sf4(base + K::CBR + swz(i, 16 * qd + 4 * u)) = o;
        }
    }
    __syncthreads();  // the prefixes are in; both warpgroups are done with A^T
    {
        const int k = tid & (MAX_L - 1), part = tid >> 6;
        float sk = 0.f;
#pragma unroll
        for (int r = 0; r < MAX_L / 4; ++r) {
            const int i = 4 * r + part;
            const float v = sf(base + K::CBR + swz(i, k));
            sk += i >= k ? v : 0.f;
        }
        sf(base + K::XHL + 4 * tid) = sk;
    }
    __syncthreads();
    if (tid < MAX_L) {
        const uint32_t pr = base + K::XHL + 4 * tid;
        straddle[tid] = ((sf(pr) + sf(pr + 256)) + sf(pr + 512)) + sf(pr + 768);
    }
    // end of phase: straddle
    if (tma) {
        zero_uncovered(tiles + K::CS, L, npn0, 2);
        zero_uncovered(tiles + K::BS, L, npn0, 2);
        if (dsc != 0.f) zero_uncovered(tiles + K::EB, P, npn0, 2);
        if (dgc != 0.f) zero_uncovered(tiles + K::EB + TILE, P, npn0, 2);
    }
    fence_proxy_async();
    __syncthreads();  // dy, M, A^T and the partial sums are free for step 0's tiles
    load_cb(0);

    // phase: steps
    // per step of NB columns of N: (eout B) hi and lo, <G, S>; warpgroup 0
    // dB^T = G^T (wout x) (then T_j) + C^T Mq^T, warpgroup 1 dC^T = S^T (ein
    // dy) (then the C . (S^T dy) terms) + B^T Mq; each du^T += G (eout B)^T
    // for its 32 columns j
    // T_j or C_i . (S^T dy_i) at column 8 cc + 2 tq + f, over this thread's rows
    float part[8][2] = {};
    float gsum = 0.f;
    const uint32_t a_inter = base + (wg ? K::SS : K::GS), a_intra = base + (wg ? K::BS : K::CS);
    const uint32_t b_inter = base + (wg ? K::EDY : K::WX), b_intra = base + (wg ? K::MQ : K::MQT);
    const uint32_t rowv = base + (wg ? K::CS : K::BS);  // the rows T or the C . (S^T dy) terms take
    for (int st = 0, nb = 0; nb < N; ++st, nb += NB) {
        if (st > 0) {
            const int npn = (min(NB, N - nb) + 31) >> 5;
            if (tma) {
                zero_uncovered(tiles + K::CS, L, npn, 2);
                zero_uncovered(tiles + K::BS, L, npn, 2);
                zero_uncovered(tiles + K::SS, P, npn, 2);
                zero_uncovered(tiles + K::GS, P, npn, 2);
                if (dsc != 0.f) zero_uncovered(tiles + K::EB, P, npn, 2);
                if (dgc != 0.f) zero_uncovered(tiles + K::EB + TILE, P, npn, 2);
            }
            fence_proxy_async();
            __syncthreads();
            load_sg(nb);
            load_cb(nb);
        }
        mbar_wait_or_trap(bar_sg, st & 1);
        mbar_wait_or_trap(bar_cb, st & 1);
        // phase: correct
        // S and G made true where pass 1's walk started from zero (each
        // thread its own elements of S(seg) and G(seg), which the (eout B)
        // tiles then overwrite), <G, S>, (eout B) hi and lo
        {
            float4 bv[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const uint32_t off = (tid + k * THREADS) * 16;
                bv[k] = sf4(base + K::BS + off);
                float4 gv = sf4(base + K::GS + off), sv = sf4(base + K::SS + off);
                // phase: seg fix
                if (dsc != 0.f) {
                    const float4 u = sf4(base + K::EB + off);
                    sv = make_float4(fmaf(dsc, u.x, sv.x), fmaf(dsc, u.y, sv.y),
                                     fmaf(dsc, u.z, sv.z), fmaf(dsc, u.w, sv.w));
                    sf4(base + K::SS + off) = sv;
                }
                if (dgc != 0.f) {
                    const float4 u = sf4(base + K::EB + TILE + off);
                    gv = make_float4(fmaf(dgc, u.x, gv.x), fmaf(dgc, u.y, gv.y),
                                     fmaf(dgc, u.z, gv.z), fmaf(dgc, u.w, gv.w));
                    sf4(base + K::GS + off) = gv;
                }
                // end of phase: seg fix
                gsum += gv.x * sv.x + gv.y * sv.y + gv.z * sv.z + gv.w * sv.w;
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const uint32_t off = (tid + k * THREADS) * 16;
                const float eo = eout[(off % PANEL) / 128];
                uint32_t s[2][4];
                split4(s, eo * bv[k].x, eo * bv[k].y, eo * bv[k].z, eo * bv[k].w);
                sf4(base + K::EB + off) = as_float4(s[0]);
                sf4(base + K::EB + TILE + off) = as_float4(s[1]);
            }
        }
        // end of phase: correct
        fence_proxy_async();
        __syncthreads();

        // the inter-chunk product, K = p: A = G or S across its rows (n = r0, r0 + 8)
        float acc[8][4];
        {
            uint32_t af[RING][2][4];
#pragma unroll
            for (int kk = 0; kk < MAX_P / 8; ++kk) {
                const int slot = kk % RING;
                if (kk >= RING) {
                    wgmma_wait<RING - 1>();
                    wgmma_hold(af[slot]);
                }
                const int pc = 8 * kk + tq;
                split4(af[slot], sf(a_inter + swz(pc, r0)), sf(a_inter + swz(pc, r0 + 8)),
                       sf(a_inter + swz(pc + 4, r0)), sf(a_inter + swz(pc + 4, r0 + 8)));
                wgmma_fence();
                mma3<8>(acc, af[slot], b_inter, b_inter + TILE, kk, kk > 0);
                wgmma_commit();
            }
            wgmma_wait<0>();
            wgmma_hold(acc);
#pragma unroll
            for (int r = 0; r < RING; ++r) wgmma_hold(af[r]);
        }
        // T_j += B_j . (G^T u_j) e^{cs_last - cs_j}, or the C_i . (S^T dy_i)
        // e^{cs_i} terms, over this thread's rows n
#pragma unroll
        for (int cc = 0; cc < 8; ++cc)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                part[cc][e & 1] +=
                    sf(rowv + swz(8 * cc + 2 * tq + (e & 1), r0 + 8 * (e >> 1))) * acc[cc][e];
        // the intra-chunk product, K = i or j: A = C or B across its rows;
        // with du^T += G (eout B)^T, K = n: A = G along its rows (p = r0, r0 + 8)
        {
            uint32_t af[RING][2][4], ag[RING][2][4];
#pragma unroll
            for (int kk = 0; kk < MAX_L / 8; ++kk) {
                const int slot = kk % RING;
                if (kk >= RING) {
                    wgmma_wait<RING - 1>();
                    wgmma_hold(af[slot]);
                    wgmma_hold(ag[slot]);
                }
                const int k = 8 * kk + tq;
                split4(af[slot], sf(a_intra + swz(k, r0)), sf(a_intra + swz(k, r0 + 8)),
                       sf(a_intra + swz(k + 4, r0)), sf(a_intra + swz(k + 4, r0 + 8)));
                split4(ag[slot], sf(base + K::GS + swz(r0, k)), sf(base + K::GS + swz(r0 + 8, k)),
                       sf(base + K::GS + swz(r0, k + 4)), sf(base + K::GS + swz(r0 + 8, k + 4)));
                wgmma_fence();
                mma3<8>(acc, af[slot], b_intra, b_intra + TILE, kk, 1);
                mma3_wg<4>(du, ag[slot], base + K::EB, base + K::EB + TILE, kk, wg, 1);
                wgmma_commit();
            }
            wgmma_wait<0>();
            wgmma_hold(acc);
            wgmma_hold(du);
#pragma unroll
            for (int r = 0; r < RING; ++r) {
                wgmma_hold(af[r]);
                wgmma_hold(ag[r]);
            }
        }
        // dB^T or dC^T [n][j or i] into the per-head workspace
        float* outh = wg ? w.dch : w.dbh;
#pragma unroll
        for (int cc = 0; cc < 8; ++cc)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int n = nb + r0 + 8 * (e >> 1), j = 8 * cc + 2 * tq + (e & 1);
                if (j < valid && n < N)
                    outh[(((int64_t)b * sp + s0 + j) * sh.H + h) * N + n] = acc[cc][e];
            }
        __syncthreads();  // every read of the step's tiles is done
    }
    // end of phase: steps

    // phase: epilogue
    // dx = dt du; x . du, T and the C . (S^T dy) terms summed over each
    // warp's rows, then over the warps of its warpgroup in order; <G, S>
    float* red = reinterpret_cast<float*>(tiles + K::E);
    float* xdu = red;                 // [4][MAX_L]: x_j . du_j by warp of its warpgroup
    float* trow = xdu + 4 * MAX_L;    // [2][4][MAX_L]: T_j (warpgroup 0), C . (S^T dy) (1)
    float* gred = trow + 8 * MAX_L;   // [8]: <G, S> by warp
    float xd[4][2];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int f = 0; f < 2; ++f)
            xd[cc][f] = xr[cc][f] * du[cc][f] + xr[cc][2 + f] * du[cc][2 + f];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int p = r0 + 8 * (e >> 1), j = 16 * cc + 8 * wg + 2 * tq + (e & 1);
            if (j < valid && p < P)
                dx[(((int64_t)b * sh.S + s0 + j) * sh.H + h) * P + p] = dts[j] * du[cc][e];
        }
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
#pragma unroll
            for (int f = 0; f < 2; ++f)
                xd[cc][f] += __shfl_xor_sync(0xffffffffu, xd[cc][f], off);
#pragma unroll
        for (int cc = 0; cc < 8; ++cc)
#pragma unroll
            for (int f = 0; f < 2; ++f)
                part[cc][f] += __shfl_xor_sync(0xffffffffu, part[cc][f], off);
    }
    if (gq == 0) {
#pragma unroll
        for (int f = 0; f < 2; ++f) {
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
                xdu[wq * MAX_L + 16 * cc + 8 * wg + 2 * tq + f] = xd[cc][f];
#pragma unroll
            for (int cc = 0; cc < 8; ++cc)
                trow[(wg * 4 + wq) * MAX_L + 8 * cc + 2 * tq + f] = part[cc][f];
        }
    }
    gsum = warp_sum(gsum);
    if (lane == 0) gred[tid >> 5] = gsum;
    __syncthreads();  // every term of d(dA) is in

    // warp 0: d(dA) = the straddling sums of M, the reverse cumulative sum
    // of the inter-chunk terms, the exclusive prefix sum of T and e^{cs_last}
    // <G, S>; ddt and da's partial
    if (tid < 32) {
        float gs = 0.f;
#pragma unroll
        for (int k = 0; k < THREADS / 32; ++k) gs += gred[k];
        // a term's partial sums over the warps, in a fixed order
        const auto over = [](const float* v, int k) {
            return ((v[k] + v[MAX_L + k]) + v[2 * MAX_L + k]) + v[3 * MAX_L + k];
        };
        const float* tj = trow;
        const float* inter = trow + 4 * MAX_L;
        float v[2] = {over(inter, lane), over(inter, lane + 32)};  // reverse inclusive scan
        // T shifted by one position, so that its inclusive scan is the exclusive one
        float t[2] = {lane > 0 ? over(tj, lane - 1) : 0.f, over(tj, lane + 31)};
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
                ddt[((int64_t)b * sh.S + s0 + k) * sh.H + h] = over(xdu, k) + ah * v[hlf];
        }
        dap = warp_sum(dap);
        if (lane == 0) w.dap[blk] = dap;
    }
    // end of phase: epilogue
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

int sm_count(int device) {
    static int known[64] = {};  // per device ordinal, read once
    if (device >= 0 && device < 64 && known[device] > 0) return known[device];
    int sms = 132;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (device >= 0 && device < 64) known[device] = sms;
    return sms;
}

// The plan: segments of at most MAX_CPS chunks, so that pass 1's 2 * B * H *
// nseg blocks (one an SM) finish soonest, in units of one chunk of a walk (a
// block's set-up ~WALK_SETUP); the fewest segments among equals (each
// boundary costs pass 2 and pass 3's corrections).
Shape plan(int B, int S, int H, int P, int G, int N, int L, int device) {
    Shape sh{B, S, H, P, G, N, L, (S + L - 1) / L, false, 1, 0};
    if (sh.nc == 0 || B == 0) return sh;
    const int sms = sm_count(device);
    const int64_t per = 2 * (int64_t)B * H;  // blocks a segment
    const int64_t least = (sh.nc + MAX_CPS - 1) / MAX_CPS;  // the walk's table holds MAX_CPS
    const int64_t most = std::max(least, std::min<int64_t>(sh.nc, 4 * (int64_t)sms / per + 1));
    double best = 1e300;
    for (int64_t want = least; want <= most; ++want) {
        const int cps = (int)((sh.nc + want - 1) / want);
        const int nseg = (sh.nc + cps - 1) / cps;
        const double cost =
            (double)((per * nseg + sms - 1) / sms) * (cps + WALK_SETUP);
        if (cost < best) {
            best = cost;
            sh.cps = cps;
            sh.nseg = nseg;
        }
    }
    return sh;
}

}  // namespace

// Dynamic shared memory of passes 1 and 3 (0, 1) at N = 128, in bytes.
extern "C" int repro_ssd_scan_bwd_smem_bytes(int pass) {
    return pass == 0 ? WalkCfg<2>::SMEM : pass == 1 ? ChunkCfg::SMEM : -1;
}

// The plan of a shape on a device: segments and chunks a segment (pass 1's
// grid is 2 * B * H * nseg blocks).  Returns cudaError_t.
extern "C" int repro_ssd_scan_bwd_plan(int B, int S, int H, int P, int G, int N, int L,
                                        int device, int* nseg, int* cps) {
    if (!valid_shape(B, S, H, P, G, N, L)) return (int)cudaErrorInvalidValue;
    const Shape sh = plan(B, S, H, P, G, N, L, device);
    *nseg = sh.nseg;
    *cps = sh.cps;
    return 0;
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
    *ws_floats = workspace_floats(Shape{B, S, H, P, G, N, L, (S + L - 1) / L, false, 1, 0});
    return 0;
}

// x [B,S,H,P], dt [B,S,H], a [H] (contiguous), bm/cm [B,S,G,N], h_init
// [B,H,P,N] or null, dy [B,S,H,P], dstate [B,H,P,N]; gradients dx [B,S,H,P],
// ddt [B,S,H], da [H], db/dc [B,S,G,N], dh_init [B,H,P,N] (null where h_init
// is), contiguous; ws scratch of ws_floats floats, 16-byte aligned
// (repro_ssd_scan_bwd_workspace); all f32.  Strides in elements: (batch,
// seq, head) for x, dt, dy; (batch, seq, group) for bm, cm; (batch, head,
// row) for h_init and dstate; the last dim is unit-stride.  x, dy, B and C
// go by TMA where every stride is a multiple of 4 elements, each pointer
// 16-byte aligned and P and N multiples of 4, else by 4-byte cp.async.
// device is the CUDA ordinal of the tensors and the stream.  Returns
// cudaError_t.
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
    Shape sh = plan(B, S, H, P, G, N, L, device);
    sh.vec = vec;
    if (ws_floats < workspace_floats(sh) || !al16(ws)) return (int)cudaErrorInvalidValue;
    const Strides sd{xsb, xss, xsh, dsb, dss, dsh, bsb, bss, bsg, csb, css, csg,
                     ysb, yss, ysh, hsb, hsh, hsp, gsb, gsh, gsp};
    const Work w = carve(ws, sh);
    Maps maps{};
    if (vec && sh.nc > 0 &&
        !(make_map_f32(&maps.x, x, B, S, H, P, xsb, xss, xsh, L) &&
          make_map_f32(&maps.dy, dy, B, S, H, P, ysb, yss, ysh, L) &&
          make_map_f32(&maps.b, bm, B, S, G, N, bsb, bss, bsg, L) &&
          make_map_f32(&maps.c, cm, B, S, G, N, csb, css, csg, L) &&
          make_map_f32(&maps.cb, w.cb, 1, MAX_L, B * G * sh.nc, MAX_L, 0, MAX_L, MAX_L * MAX_L,
                       MAX_L) &&
          make_map_f32(&maps.st, w.st, 1, P, B * H * sh.nc, N, 0, N, (int64_t)P * N, P) &&
          make_map_f32(&maps.ct, w.ct, 1, P, B * H * sh.nc, N, 0, N, (int64_t)P * N, P)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaFuncSetAttribute(ssd_bwd_walk_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         WalkCfg<1>::SMEM);
    cudaFuncSetAttribute(ssd_bwd_walk_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         WalkCfg<2>::SMEM);
    cudaFuncSetAttribute(ssd_bwd_chunk_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         ChunkCfg::SMEM);
    cudaFuncSetAttribute(ssd_bwd_chunk_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         ChunkCfg::SMEM);
    if (sh.nc > 0) {
        const dim3 walkers(2 * sh.nseg, H, B);
        if (N <= 64)
            ssd_bwd_walk_kernel<1><<<walkers, THREADS, WalkCfg<1>::SMEM, s>>>(
                    maps, x, dt, a, bm, cm, dy, h_init, dstate, dh_init, w, sh, sd);
        else
            ssd_bwd_walk_kernel<2><<<walkers, THREADS, WalkCfg<2>::SMEM, s>>>(
                    maps, x, dt, a, bm, cm, dy, h_init, dstate, dh_init, w, sh, sd);
    }
    if (sh.nseg > 1 || sh.nc == 0)
        ssd_bwd_combine_kernel<<<dim3((P * N + NT - 1) / NT, H, B), NT, 0, s>>>(dstate, dh_init, w,
                                                                               sh, sd);
    if (sh.nc > 0) {
        const dim3 chunks(sh.nc, H, B);
        if (sh.nseg > 1)
            ssd_bwd_chunk_kernel<true><<<chunks, THREADS, ChunkCfg::SMEM, s>>>(
                    maps, x, dt, a, bm, cm, dy, dx, ddt, w, sh, sd);
        else
            ssd_bwd_chunk_kernel<false><<<chunks, THREADS, ChunkCfg::SMEM, s>>>(
                    maps, x, dt, a, bm, cm, dy, dx, ddt, w, sh, sd);
        const int64_t n_out = (int64_t)B * S * G * N;
        ssd_bwd_group_kernel<<<(unsigned)((n_out + NT - 1) / NT), NT, 0, s>>>(db, dc, w, sh);
    }
    ssd_bwd_da_kernel<<<H, 32, 0, s>>>(da, w, sh);
    return (int)cudaGetLastError();
}
