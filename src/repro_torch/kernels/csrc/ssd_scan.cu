// Mamba-2 SSD chunk scan for Hopper (sm_90a), f32 in and out, every matrix
// product on the TF32 tensor cores by `wgmma` in 3xTF32.
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
// i >= j, or cs itself, so it is never positive (a < 0, dt >= 0).
//
// What bounds it on an H100: at the prefill shape of mamba2-370m (B=1,
// S=32768, H=32, P=64, N=128, G=1, L=64; 512 chunks) the function moves
// ~576 MB (x and y f32, B, C, dt; 0.17 ms at 3.35 TB/s) and needs ~39
// GFLOP of products (0.08 ms at the 495 TFLOP/s of TF32): bytes.  What the
// tensor cores execute is more: 3xTF32 runs each product three times, the
// state products run in two passes, and each block of two heads forms C B^T
// again, ~206 GFLOP at that shape (0.42 ms at the TF32 peak).
//
// Up to four kernels on one stream, one call:
//
//   A. ssd_prep_kernel, a warp per (b, head, chunk): the chunk's cs (a
//      warp-parallel scan of dA) and dt, 64 each, zero-padded past the chunk
//      and past S.
//   B. ssd_state_kernel, a block per (b, two heads of a group, segment of
//      `cps` chunks) but the last segment: the segment's state from a zero
//      state, and its total decay exp(sum dA).
//   C. ssd_combine_kernel, elementwise over (b, h, p, n), in order over the
//      segments: the state entering each segment after the first (entering(k
//      + 1) = local(k) + decay(k) * entering(k), entering(0) = h_init or 0).
//      B and C run only where there are several segments.
//   D. ssd_output_kernel, a block per (b, two heads, segment): from the
//      entering states (h_init for segment 0), for each chunk y of both
//      heads, then their states carried on; the last segment writes the
//      final state.  Pass D recomputes pass B's state products rather than
//      reading a state per chunk ([B, 512, H, P, N] f32, 537 MB each way).
//
// Passes B and D share one body (`chunk_pass`): two warpgroups, one per head
// of the group (a group of an odd number of heads leaves its last block's
// second warpgroup computing a copy of the first's head and writing
// nothing).  Each chunk's C and B tiles are loaded once for both heads, with
// the heads' x tiles and the chunk's cs and dt, by TMA (4-D tensor maps over
// x [B,S,H,P] and B/C [B,S,G,N] with the caller's strides, 128-byte
// swizzled, a box of 32 columns by L rows, so that rows past the chunk stay
// as zeroed at the start and rows past S arrive as zeros) and a bulk copy,
// completing one mbarrier; thread 0 issues the next chunk's as soon as both
// warpgroups have built their tiles from this chunk's raw ones, so the loads
// run under the rest of the chunk.  Where a row of x, B or C is not 16-byte
// aligned, TMA cannot take it and every thread copies the same tiles by
// 4-byte cp.async.  y goes out the same way: each warpgroup writes its y
// tile into its head's W tile (its products are done with it) and one
// thread stores it by TMA (rows past S are not written), or, where y's rows
// are not 16-byte aligned, every thread stores its own elements.  One warp
// more for loading would leave 9 warps, 3 on one of the SM's four
// schedulers, and registers 168 a thread (the products spilled there); two
// warpgroups keep 255.
//
// Products, each `wgmma` m64nNk8 .tf32 with A from registers and B from
// shared memory.  TF32 `wgmma` takes both shared operands K-major only, so
// each product is laid out so that its shared operand runs along k:
//
//   y^T [p][i]  = S [p][n] . C [i][n]              (A: the state, its accumulator)
//   CB [j][i]   = B [j][n] . C [i][n]              (A: B from the B^T tiles)
//   y^T [p][i] += X^T [p][j] . W [i][j]            (A: x, read from its tile)
//   S [p][n]   += (X * wd)^T [p][s] . B^T [n][s]   (A: x scaled by wd)
//
// with W = C B^T * exp(cs_i - cs_j) * dt_j (j <= i, else 0) and wd = dt *
// exp(cs_last - cs).  Each operand is split into a TF32 hi and lo part
// (`tf32_split`: hi by truncation, lo = x - hi) and a product is lo.hi +
// hi.lo + hi.hi, ~2^-20 of the f32 one; plain TF32 misses the tolerance
// ~5x.  A register operand is split where it is read; a shared operand is
// written as a hi tile and a lo tile by the warpgroups: C (for both heads,
// and for both products that take it), B^T (the transpose of B, for both
// heads) and each head's W.  The state's accumulator is A of y's first
// product as it stands: its column r holds state column pi(r) = 8 (r / 8)
// + (r % 2 ? r % 8 / 2 + 4 : r % 8 / 2), the order in which the A
// fragment reads an accumulator's columns (t, t + 4 from 2t, 2t + 1), set
// by the row order of the B^T tiles.  C B^T is formed once a chunk for both
// heads, each warpgroup 32 of its 64 columns, and W of both heads written
// from each warpgroup's columns.  The state stays in registers (64 a thread
// at N = 128) over a segment; y's 32 are formed each chunk and stored.
//
// Shared memory (N = 128, pass D: 227 KB, one block an SM): raw C, B and
// both x tiles (96 KB, free for the next chunk once built from), B^T hi and
// lo (64 KB), and 64 KB that hold C's hi and lo for the first two products,
// both heads' W hi and lo for the third, then y; cs and dt of two chunks.
// Four barriers of both warpgroups a chunk: the last chunk's products done,
// the tiles built, C read, W written.  N takes a 32-, 64- or 128-wide tile
// (compile-time); P takes 64 rows, zero-padded, and a chunk 64, its padding
// rows zero with dt = 0, as a ragged last chunk is padded.  No atomics: a
// call gives the same bits every time.
//
// The number of segments is chosen from the SM count and the passes'
// occupancy so that the waves of passes B and D are full (8 segments of 64
// chunks at the main shape on 132 SMs: 128 blocks in pass D).
//
// Layout: x [B,S,H,P], dt [B,S,H], B/C [B,S,G,N], y [B,S,H,P], h_init and
// state [B,H,P,N] are read and written through the strides given (x, B and
// C may be slices of the conv output [B,S,channels]); the last dim of each
// is unit-stride.  Positions >= S (a ragged last chunk) are read as x = B =
// C = dt = 0, which leaves the state exactly as the plain version's
// zero-padding with dt = 0 does, and their y is not written.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int MAX_L = 64;                 // chunk length: wgmma's M and a tile's rows
constexpr int MAX_N = 128;                // state width
constexpr int MAX_P = 64;                 // head width
constexpr int HEADS = 2;                  // warpgroups a block, a head each
constexpr int THREADS = 128 * HEADS;
constexpr int CB_COLS = MAX_L / HEADS;    // columns i of C B^T a warpgroup forms
static_assert(HEADS == 1 || HEADS == 2, "C B^T split 64 or 32 columns a warpgroup");
constexpr int SYNC = 1;                   // the warpgroups' named barrier
constexpr int RING = 2;                   // A fragments in flight a product: k-steps
constexpr int CD = 2 * MAX_L;             // per (b, h, chunk): cs, dt
constexpr int PANEL = MAX_L * 128;        // bytes of a 64-row panel of 32 floats
constexpr int HEAD_TILE = MAX_L * MAX_P * 4;  // an x tile or a W tile: 16 KB
constexpr int NT_PREP = 256;
constexpr int NT_COMBINE = 256;

// State-width tile of N: 32, 64 or 128.
__host__ __device__ constexpr int n_tile(int N) { return N <= 32 ? 32 : N <= 64 ? 64 : 128; }

// Shared memory of a pass (OUT: pass D) at state-width tile NT.  Barriers
// and cs/dt first, then, from a 1024-aligned base, the tiles (offsets in
// bytes): raw C [i][n] (pass D), raw B [s][n], x [s][p] of each head, B^T
// hi and lo [r][s] (row r holds n = pi(r)), and the W area (pass D): C hi and
// lo [i][n], then each head's W hi and lo [i][j].  The 64-row tiles are
// panels of 32 columns 8 KB apart, B^T's panels of NT rows; all 128-byte
// swizzled as TMA writes them.
template <int NT, bool OUT>
struct Cfg {
    static constexpr int C_TILE = MAX_L * NT * 4;
    static constexpr int BT_TILE = NT * MAX_L * 4;
    static constexpr int CH = 0;
    static constexpr int BR = CH + (OUT ? C_TILE : 0);
    static constexpr int X = BR + C_TILE;
    static constexpr int BT = X + HEADS * HEAD_TILE;
    static constexpr int WA = BT + 2 * BT_TILE;
    static constexpr int W_AREA =
        !OUT ? 0 : 2 * C_TILE > 2 * HEADS * HEAD_TILE ? 2 * C_TILE : 2 * HEADS * HEAD_TILE;
    static constexpr int TILES = WA + W_AREA;
    static constexpr int SMALL = 16 + 2 * HEADS * CD * 4;  // the barrier; cs, dt of 2 chunks
    static constexpr int SMEM = SMALL + 1008 + TILES;       // + aligning a 16-byte base
    static_assert(SMEM <= 232448, "a block fits an SM");
};

struct Params {
    const float *x, *bm, *cm;
    const float* cd;  // pass A's cs, dt per (b, h, chunk)
    float* ls;        // per (b, h, segment k < nseg - 1): pass B's local state of segment
                      // k, then (pass C) the state entering segment k + 1
    float* sdec;      // per (b, h, segment k < nseg - 1): the segment's total decay
    const float* h_init;  // the state entering segment 0, or null (zero)
    float* y;
    float* st;        // the final state, written by pass D's last segment
    int S, H, P, G, N, L, nc, cps, nseg, rep, pairs, tma, tma_y;
    int64_t xs[3], bs[3], cs[3], ys[3];  // (batch, seq, head or group) strides
    int64_t hs[3], ss[3];                // (batch, head, p) strides of h_init and st
};

// A block's work: batch b, group g, heads h[0..HEADS) (active where the
// group has them), chunks [c_begin, c_end).
struct Work {
    int b, g, seg, c_begin, n;
    int h[HEADS];
    bool active[HEADS];
};

__device__ __forceinline__ Work block_work(const Params& p) {
    Work w;
    w.seg = blockIdx.x;
    w.b = blockIdx.z;
    w.g = blockIdx.y / p.pairs;
    const int pair = blockIdx.y - w.g * p.pairs;
    w.c_begin = w.seg * p.cps;
    w.n = min(p.nc, w.c_begin + p.cps) - w.c_begin;
#pragma unroll
    for (int k = 0; k < HEADS; ++k) {
        const int hl = pair * HEADS + k;
        w.active[k] = hl < p.rep;
        w.h[k] = w.g * p.rep + min(hl, p.rep - 1);
    }
    return w;
}

// Byte offset of element (r, c) of a swizzled tile of `rows`-row panels.
__device__ __forceinline__ uint32_t swz(int r, int c, int rows) {
    return (c >> 5) * rows * 128 + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// ---- pass A: cs and dt per (b, head, chunk) ----

__global__ void __launch_bounds__(NT_PREP)
ssd_prep_kernel(const float* __restrict__ dt, const float* __restrict__ a, float* __restrict__ cd,
                int B, int S, int H, int L, int nc, int64_t dsb, int64_t dss, int64_t dsh) {
    const int lane = threadIdx.x & 31;
    const int64_t item = (int64_t)blockIdx.x * (NT_PREP / 32) + (threadIdx.x >> 5);
    if (item >= (int64_t)B * H * nc) return;
    const int c = (int)(item % nc), h = (int)(item / nc % H), b = (int)(item / nc / H);
    // lane holds positions lane and lane + 32; positions past the chunk or S
    // have dt = 0, so cs stays at its last value there
    const int s0 = c * L, valid = min(L, S - s0);
    const float ah = a[h];
    const float* dtp = dt + b * dsb + h * dsh + (int64_t)s0 * dss;
    const float d0 = lane < valid ? dtp[lane * dss] : 0.f;
    const float d1 = lane + 32 < valid ? dtp[(lane + 32) * dss] : 0.f;
    float v0 = d0 * ah, v1 = d1 * ah;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, v0, off);
        const float u1 = __shfl_up_sync(0xffffffffu, v1, off);
        if (lane >= off) {
            v0 += u0;
            v1 += u1;
        }
    }
    v1 += __shfl_sync(0xffffffffu, v0, 31);
    float* o = cd + item * CD;
    o[lane] = v0;
    o[lane + 32] = v1;
    o[MAX_L + lane] = d0;
    o[MAX_L + lane + 32] = d1;
}

// ---- passes B and D: the loads ----

// Rows [0, L) of a swizzled tile of `np` 32-column panels from global rows
// `ld` floats apart: element (r, c) is src[r * ld + c] where r < valid and
// c < cols, else zero.  4-byte cp.async by every thread of the block.
__device__ __forceinline__ void copy_tile(uint32_t dst, const float* src, int64_t ld, int L,
                                          int valid, int cols, int np) {
    const int width = 32 * np;
    for (int e = threadIdx.x; e < L * width; e += THREADS) {
        const int r = e / width, c = e - r * width;
        const bool ok = r < valid && c < cols;
        cp_async4(dst + swz(r, c, MAX_L), ok ? src + r * ld + c : src, ok);
    }
}

// The loads of chunk `it` of the block's segment into the raw tiles and cs /
// dt slot it % 2, completing the barrier's phase it: C (pass D), B, the
// heads' x tiles, their cs and dt.  TMA by thread 0, or cp.async by every
// thread where rows are not 16-byte aligned.  The caller has seen every
// thread done with the tiles (and with the slot's chunk it - 2).
template <int NT, bool OUT>
__device__ __forceinline__ void load_chunk(const CUtensorMap* mx, const CUtensorMap* mb,
                                           const CUtensorMap* mc, const Params& p, const Work& w,
                                           uint32_t base, uint32_t small, int it) {
    using C = Cfg<NT, OUT>;
    const uint32_t full = small;
    const int npn = (p.N + 31) >> 5, npx = (p.P + 31) >> 5;  // panels holding N, P columns
    const int c = w.c_begin + it, s0 = c * p.L;
    const uint32_t cd_dst = small + 16 + (it & 1) * HEADS * CD * 4;
    if (p.tma) {
        if (threadIdx.x != 0) return;
        mbar_arrive_expect_tx(full, ((OUT ? npn : 0) + npn + HEADS * npx) * 128 * p.L +
                                        HEADS * CD * 4);
        for (int pn = 0; pn < npn; ++pn) {
            if (OUT) tma_load_4d(base + C::CH + pn * PANEL, mc, full, 32 * pn, s0, w.g, w.b);
            tma_load_4d(base + C::BR + pn * PANEL, mb, full, 32 * pn, s0, w.g, w.b);
        }
#pragma unroll
        for (int k = 0; k < HEADS; ++k) {
            for (int px = 0; px < npx; ++px)
                tma_load_4d(base + C::X + k * HEAD_TILE + px * PANEL, mx, full, 32 * px, s0,
                            w.h[k], w.b);
            bulk_load(cd_dst + k * CD * 4, p.cd + (((int64_t)w.b * p.H + w.h[k]) * p.nc + c) * CD,
                      CD * 4, full);
        }
        return;
    }
    const int valid = min(p.L, p.S - s0);
    if (OUT)
        copy_tile(base + C::CH, p.cm + w.b * p.cs[0] + (int64_t)s0 * p.cs[1] + w.g * p.cs[2],
                  p.cs[1], p.L, valid, p.N, npn);
    copy_tile(base + C::BR, p.bm + w.b * p.bs[0] + (int64_t)s0 * p.bs[1] + w.g * p.bs[2],
              p.bs[1], p.L, valid, p.N, npn);
#pragma unroll
    for (int k = 0; k < HEADS; ++k) {
        copy_tile(base + C::X + k * HEAD_TILE,
                  p.x + w.b * p.xs[0] + (int64_t)s0 * p.xs[1] + w.h[k] * p.xs[2], p.xs[1], p.L,
                  valid, p.P, npx);
        if (threadIdx.x < CD / 4)  // 16 bytes a thread
            cp_async16(cd_dst + k * CD * 4 + threadIdx.x * 16,
                       p.cd + (((int64_t)w.b * p.H + w.h[k]) * p.nc + c) * CD + threadIdx.x * 4,
                       true);
    }
    cp_async_mbar_arrive_noinc(full);
}

// ---- passes B and D: the consumers ----

// d (+)= (a_hi + a_lo)(b_hi + b_lo) without lo.lo, small terms first; the
// first product overwrites d where !accumulate.  Issued, not committed.
template <int NB>
__device__ __forceinline__ void mma3_tf32(float (&d)[NB][4], const uint32_t (&a)[2][4],
                                          uint64_t b_hi, uint64_t b_lo, int accumulate) {
    wgmma_tf32<NB>(d, a[1], b_hi, accumulate);
    wgmma_tf32<NB>(d, a[0], b_lo, 1);
    wgmma_tf32<NB>(d, a[0], b_hi, 1);
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

// Descriptor of k-step kk (8 columns) of a K-major operand of `rows`-row
// panels at `tile`.
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int kk, int rows) {
    return sw128_desc(opaque(tile) + (kk >> 2) * rows * 128 + (kk & 3) * 32);
}

// See the note at the top.  No branch sits between a product's issue and
// its wait: a register of an asynchronous `wgmma` live across a branch makes
// ptxas serialize every `wgmma` of the kernel.  A ring of RING A fragments a
// product: a k-step's are written once the k-step RING before has retired.
// The `// phase: NAME` ... `// end of phase: NAME` comments mark the spans
// that scripts/ssd_fwd_phases.py times.
template <int NT, bool OUT>
__device__ __forceinline__ void consume(const CUtensorMap* mx, const CUtensorMap* mb,
                                        const CUtensorMap* mc, const CUtensorMap* my,
                                        const Params& p, const Work& w, uint32_t base,
                                        uint32_t small, uint8_t* smem) {
    using C = Cfg<NT, OUT>;
    // shared memory at address a as a C++ lvalue (`smem` is address `small`):
    // plain accesses that the compiler may schedule, where ordered asm ones
    // made every load wait for the stores before it
    auto sf = [&](uint32_t a) -> float& { return *reinterpret_cast<float*>(smem + (a - small)); };
    auto sf4 = [&](uint32_t a) -> float4& {
        return *reinterpret_cast<float4*>(smem + (a - small));
    };
    constexpr int NK = NT / 8;  // k-steps over n
    constexpr int BT_ITEMS = NT * (MAX_L / 4) / THREADS;  // B^T's 4-float rows a thread
    constexpr int C_ITEMS = C::C_TILE / 16 / THREADS;      // C's float4s a thread
    static_assert(BT_ITEMS * THREADS == NT * (MAX_L / 4) && C_ITEMS * THREADS == C::C_TILE / 16,
                  "whole rounds of the builds");
    const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
    const int gq = lane >> 2, tq = lane & 3;
    const int p0 = 16 * ((tid >> 5) & 3) + gq;  // this thread's rows p0, p0 + 8 (of p and of j)
    int h = w.h[0];
    bool active = w.active[0];
#pragma unroll
    for (int k = 1; k < HEADS; ++k) {  // selects, not an indexed array
        h = wg == k ? w.h[k] : h;
        active = wg == k ? w.active[k] : active;
    }
    const uint32_t full = small;

    // the state: element (p0 + 8 (e / 2), pi(8 j + 2 tq + e % 2)) in st[j][e],
    // pi(8 j + 2 tq + e % 2) = 8 j + tq + 4 (e % 2)
    // pass D enters segment 0 with h_init (or zero) and segment k > 0 with
    // pass C's state in slot k - 1; pass B enters each from zero
    float st[NK][4];
    const int64_t slot_k = ((int64_t)w.b * p.H + h) * (p.nseg - 1) + w.seg;
    const float* ent = w.seg > 0 ? p.ls + (slot_k - 1) * p.P * p.N : p.h_init;
    const int64_t ent_b = w.seg > 0 ? 0 : w.b * p.hs[0] + h * p.hs[1];
    const int64_t ent_p = w.seg > 0 ? p.N : p.hs[2];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int pr = p0 + 8 * (e >> 1), n = 8 * j + tq + 4 * (e & 1);
            st[j][e] = OUT && ent != nullptr && pr < p.P && n < p.N ? ent[ent_b + pr * ent_p + n]
                                                                     : 0.f;
        }
    float log_decay = 0.f;

    for (int it = 0; it < w.n; ++it) {
        const int s0 = (w.c_begin + it) * p.L;
        const uint32_t cd = small + 16 + (it & 1) * HEADS * CD * 4;  // cs, dt of both heads
        // the tiles' addresses and this thread's place in them, worked out
        // again each chunk: held across the chunks, the compiler would keep
        // every offset derived from them in registers (these shadow the
        // function's own)
        const uint32_t tiles = opaque(base);
        const int tid_c = (int)opaque((uint32_t)tid), wg = tid_c >> 7;
        const int tq = tid_c & 3, p0 = 16 * ((tid_c >> 5) & 3) + ((tid_c & 31) >> 2);
        const uint32_t bt_hi = tiles + C::BT, bt_lo = bt_hi + C::BT_TILE;
        const uint32_t c_hi = tiles + C::WA, c_lo = c_hi + C::C_TILE;
        const uint32_t w_own = tiles + C::WA + wg * 2 * HEAD_TILE;  // this head's W hi, then lo
        const uint32_t cs_own = cd + wg * CD * 4, dt_own = cs_own + MAX_L * 4;
        mbar_wait_or_trap(full, it & 1);  // a load that never lands ends the launch
        if (it > 0) {
            // the last chunk's y is read out of this head's W tile, and every
            // product of the last chunk is done
            if (OUT && p.tma_y && (tid & 127) == 0) bulk_wait<0, true>();
            named_sync(SYNC, THREADS);
        }

        // x: A fragments (8 kk + tq, p0), (8 kk + tq, p0 + 8), (8 kk + tq + 4, p0), (.., p0 + 8),
        // read once the first products are done (pass D), so that they are
        // not live through them
        float xr[8][4];
        auto load_x = [&] {
            const uint32_t xt = tiles + C::X + wg * HEAD_TILE;
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) {
                const int s = 8 * kk + tq;
                xr[kk][0] = sf(xt + swz(s, p0, MAX_L));
                xr[kk][1] = sf(xt + swz(s, p0 + 8, MAX_L));
                xr[kk][2] = sf(xt + swz(s + 4, p0, MAX_L));
                xr[kk][3] = sf(xt + swz(s + 4, p0 + 8, MAX_L));
            }
        };
        if constexpr (!OUT) load_x();
        // phase: build
        // B^T hi and lo: row r holds column pi(r) of B, four s a store; a
        // build's loads all go out before its stores
        {
            float v[BT_ITEMS][4];
#pragma unroll
            for (int k = 0; k < BT_ITEMS; ++k) {
                const int item = tid_c + k * THREADS, r = item % NT, s4 = item / NT * 4;
                const int n = (r & ~7) + ((r & 7) >> 1) + 4 * (r & 1);
#pragma unroll
                for (int q = 0; q < 4; ++q) v[k][q] = sf(tiles + C::BR + swz(s4 + q, n, MAX_L));
            }
#pragma unroll
            for (int k = 0; k < BT_ITEMS; ++k) {
                const int item = tid_c + k * THREADS, r = item % NT, s4 = item / NT * 4;
                uint32_t a[2][4];
                split4(a, v[k][0], v[k][1], v[k][2], v[k][3]);
                const uint32_t off = swz(r, s4, NT);
                sf4(bt_hi + off) = as_float4(a[0]);
                sf4(bt_lo + off) = as_float4(a[1]);
            }
        }
        if constexpr (OUT) {  // C hi and lo, in the raw tile's layout
            float4 v[C_ITEMS];
#pragma unroll
            for (int k = 0; k < C_ITEMS; ++k)
                v[k] = sf4(tiles + C::CH + (tid_c + k * THREADS) * 16);
#pragma unroll
            for (int k = 0; k < C_ITEMS; ++k) {
                const uint32_t off = (tid_c + k * THREADS) * 16;
                uint32_t a[2][4];
                split4(a, v[k].x, v[k].y, v[k].z, v[k].w);
                sf4(c_hi + off) = as_float4(a[0]);
                sf4(c_lo + off) = as_float4(a[1]);
            }
        }
        // end of phase: build
        fence_proxy_async();
        named_sync(SYNC, THREADS);  // the tiles are built (pass B: the raw ones are free)
        if (!OUT && it + 1 < w.n) load_chunk<NT, OUT>(mx, mb, mc, p, w, base, small, it + 1);
        const float cs_last = sf(cs_own + 4 * (MAX_L - 1));

        float y[8][4];
        if constexpr (OUT) {
            // y^T = S C^T over the chunk's 64 rows i, and C B^T for rows i in
            // [CB_COLS wg, CB_COLS (wg + 1)): one commit group a k-step of n
            // (the first product of each overwrites it)
            float cb[CB_COLS / 8][4];
            uint32_t ay[RING][2][4], ab[RING][2][4];
            // phase: S4
#pragma unroll
            for (int kk = 0; kk < NK; ++kk) {
                const int slot = kk % RING;
                if (kk >= RING) {
                    wgmma_wait<RING - 1>();
                    wgmma_hold(ay[slot]);
                    wgmma_hold(ab[slot]);
                }
                // the state's columns pi(8 kk + 2 tq) = 8 kk + tq and 8 kk + tq + 4
                split4(ay[slot], st[kk][0], st[kk][2], st[kk][1], st[kk][3]);
                const int r0 = 8 * kk + 2 * tq;  // B^T rows holding n = 8 kk + tq, + 4
                const uint32_t o0 = swz(r0, p0, NT), o1 = swz(r0, p0 + 8, NT);
                const uint32_t o2 = swz(r0 + 1, p0, NT), o3 = swz(r0 + 1, p0 + 8, NT);
                ab[slot][0][0] = __float_as_uint(sf(bt_hi + o0));
                ab[slot][0][1] = __float_as_uint(sf(bt_hi + o1));
                ab[slot][0][2] = __float_as_uint(sf(bt_hi + o2));
                ab[slot][0][3] = __float_as_uint(sf(bt_hi + o3));
                ab[slot][1][0] = __float_as_uint(sf(bt_lo + o0));
                ab[slot][1][1] = __float_as_uint(sf(bt_lo + o1));
                ab[slot][1][2] = __float_as_uint(sf(bt_lo + o2));
                ab[slot][1][3] = __float_as_uint(sf(bt_lo + o3));
                wgmma_fence();
                mma3_tf32<8>(y, ay[slot], kdesc(c_hi, kk, MAX_L), kdesc(c_lo, kk, MAX_L), kk > 0);
                mma3_tf32<CB_COLS / 8>(cb, ab[slot], kdesc(c_hi + wg * CB_COLS * 128, kk, MAX_L),
                                   kdesc(c_lo + wg * CB_COLS * 128, kk, MAX_L), kk > 0);
                wgmma_commit();
            }
            // end of phase: S4
            wgmma_wait<0>();
            wgmma_hold(y);
            wgmma_hold(cb);
#pragma unroll
            for (int r = 0; r < RING; ++r) {
                wgmma_hold(ay[r]);
                wgmma_hold(ab[r]);
            }
            load_x();
            // C and x are read: the W area takes W, the raw tiles the next chunk
            named_sync(SYNC, THREADS);
            if (it + 1 < w.n) load_chunk<NT, OUT>(mx, mb, mc, p, w, base, small, it + 1);

            // W [i][j] of both heads for this warpgroup's rows i of C B^T:
            // cb[nt][e] is (j, i) = (p0 + 8 (e / 2), CB_COLS wg + 8 nt + 2 tq + e % 2)
            // phase: W
            // (its cs and dt loaded first)
            float csi[HEADS][CB_COLS / 8][2], csj[HEADS][2], dtj[HEADS][2];
#pragma unroll
            for (int k = 0; k < HEADS; ++k) {
                const uint32_t csk = cd + k * CD * 4, dtk = csk + MAX_L * 4;
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    csj[k][u] = sf(csk + 4 * (p0 + 8 * u));
                    dtj[k][u] = sf(dtk + 4 * (p0 + 8 * u));
                }
#pragma unroll
                for (int nt = 0; nt < CB_COLS / 8; ++nt)
#pragma unroll
                    for (int u = 0; u < 2; ++u)
                        csi[k][nt][u] = sf(csk + 4 * (CB_COLS * wg + 8 * nt + 2 * tq + u));
            }
#pragma unroll
            for (int k = 0; k < HEADS; ++k) {
                const uint32_t whi = tiles + C::WA + k * 2 * HEAD_TILE, wlo = whi + HEAD_TILE;
#pragma unroll
                for (int nt = 0; nt < CB_COLS / 8; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int i = CB_COLS * wg + 8 * nt + 2 * tq + (e & 1);
                        const int j = p0 + 8 * (e >> 1);
                        const float v = j <= i ? cb[nt][e] *
                                                     __expf(csi[k][nt][e & 1] - csj[k][e >> 1]) *
                                                     dtj[k][e >> 1]
                                               : 0.f;
                        uint32_t hi, lo;
                        tf32_split(v, hi, lo);
                        const uint32_t off = swz(i, j, MAX_L);
                        sf(whi + off) = __uint_as_float(hi);
                        sf(wlo + off) = __uint_as_float(lo);
                    }
            }
            // end of phase: W
            fence_proxy_async();
            // y's inter-chunk term times exp(cs_i): y[nt][e] is (p0 + 8 (e / 2),
            // 8 nt + 2 tq + e % 2)
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
                const float e0 = __expf(sf(cs_own + 4 * (8 * nt + 2 * tq)));
                const float e1 = __expf(sf(cs_own + 4 * (8 * nt + 2 * tq + 1)));
                y[nt][0] *= e0;
                y[nt][1] *= e1;
                y[nt][2] *= e0;
                y[nt][3] *= e1;
            }
        }
        const float decay = expf(cs_last);
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) st[j][e] *= decay;
        log_decay += cs_last;
        if constexpr (OUT) named_sync(SYNC, THREADS);  // both heads' W are in

        // y^T += X^T W^T (pass D) and S += (X wd)^T B over the chunk's 64 s,
        // wd = dt exp(cs_last - cs) at this thread's s = 8 kk + tq and + 4
        // (__expf: no call among the products)
        uint32_t ax[RING][2][4], aw[RING][2][4];
        // phase: S6
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
            const int slot = kk % RING;
            if (kk >= RING) {
                wgmma_wait<RING - 1>();
                if constexpr (OUT) wgmma_hold(ax[slot]);
                wgmma_hold(aw[slot]);
            }
            const int s = 8 * kk + tq;
            const float wd0 = sf(dt_own + 4 * s) * __expf(cs_last - sf(cs_own + 4 * s));
            const float wd1 = sf(dt_own + 4 * (s + 4)) *
                              __expf(cs_last - sf(cs_own + 4 * (s + 4)));
            if constexpr (OUT) split4(ax[slot], xr[kk][0], xr[kk][1], xr[kk][2], xr[kk][3]);
            split4(aw[slot], xr[kk][0] * wd0, xr[kk][1] * wd0, xr[kk][2] * wd1, xr[kk][3] * wd1);
            wgmma_fence();
            if constexpr (OUT)
                mma3_tf32<8>(y, ax[slot], kdesc(w_own, kk, MAX_L),
                             kdesc(w_own + HEAD_TILE, kk, MAX_L), 1);
            mma3_tf32<NK>(st, aw[slot], kdesc(bt_hi, kk, NT), kdesc(bt_lo, kk, NT), 1);
            wgmma_commit();
        }
        // end of phase: S6
        wgmma_wait<0>();
        wgmma_hold(st);
#pragma unroll
        for (int r = 0; r < RING; ++r) {
            wgmma_hold(aw[r]);
            if constexpr (OUT) wgmma_hold(ax[r]);
        }
        if constexpr (OUT) {
            wgmma_hold(y);
            if (p.tma_y) {
                // phase: ystore
                // y [i][p] into this head's W hi tile, which its products are
                // done with, then out by one TMA store a panel (rows past the
                // chunk are not stored, rows past S not written)
#pragma unroll
                for (int nt = 0; nt < 8; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int i = 8 * nt + 2 * tq + (e & 1), pr = p0 + 8 * (e >> 1);
                        sf(w_own + swz(i, pr, MAX_L)) = y[nt][e];
                    }
                fence_proxy_async();
                named_sync(SYNC + 1 + wg, 128);
                if ((tid & 127) == 0 && active) {
                    for (int px = 0; px < (p.P + 31) >> 5; ++px)
                        tma_store_4d(my, w_own + px * PANEL, 32 * px, s0, h, w.b);
                    bulk_commit();
                }
                // end of phase: ystore
            } else if (active) {  // rows that TMA cannot take
                float* yb = p.y + w.b * p.ys[0] + h * p.ys[2];
#pragma unroll
                for (int nt = 0; nt < 8; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int i = 8 * nt + 2 * tq + (e & 1), pr = p0 + 8 * (e >> 1);
                        if (i < p.L && s0 + i < p.S && pr < p.P)
                            yb[(int64_t)(s0 + i) * p.ys[1] + pr] = y[nt][e];
                    }
            }
        }
    }
    if (OUT && p.tma_y && (tid & 127) == 0) bulk_wait<0, false>();  // y is out
    // pass B: the segment's local state and decay; pass D's last segment:
    // the final state
    if (active && (!OUT || w.seg == p.nseg - 1)) {
        float* out = OUT ? p.st + w.b * p.ss[0] + h * p.ss[1] : p.ls + slot_k * p.P * p.N;
        const int64_t out_p = OUT ? p.ss[2] : p.N;
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int pr = p0 + 8 * (e >> 1), n = 8 * j + tq + 4 * (e & 1);
                if (pr < p.P && n < p.N) out[pr * out_p + n] = st[j][e];
            }
        if (!OUT && (tid & 127) == 0) p.sdec[slot_k] = expf(log_decay);
    }
}

// Thread 0 sets up the barrier; every thread zeroes the raw tiles (rows past
// the chunk and panels past P or N are never loaded); the first chunk's
// loads go out and the two warpgroups take the chunks in turn.
template <int NT, bool OUT>
__device__ __forceinline__ void chunk_pass(const CUtensorMap* mx, const CUtensorMap* mb,
                                           const CUtensorMap* mc, const CUtensorMap* my,
                                           const Params& p) {
    using C = Cfg<NT, OUT>;
    extern __shared__ float4 smem_ssd[];
    const uint32_t small = smem_addr(smem_ssd);
    const uint32_t base = (small + C::SMALL + 1023) & ~1023u;
    if (threadIdx.x == 0) {
        mbar_init(small, p.tma ? 1 : THREADS);
        fence_barrier_init();
    }
    for (int off = threadIdx.x * 16; off < C::BT; off += THREADS * 16)
        sts_f32x4(base + off, 0.f, 0.f, 0.f, 0.f);
    fence_proxy_async();
    __syncthreads();
    const Work w = block_work(p);
    load_chunk<NT, OUT>(mx, mb, mc, p, w, base, small, 0);
    consume<NT, OUT>(mx, mb, mc, my, p, w, base, small, reinterpret_cast<uint8_t*>(smem_ssd));
}

// ---- pass B: each segment's state from a zero state, and its total decay ----

template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
ssd_state_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mb,
                 const Params p) {
    chunk_pass<NT, false>(&mx, &mb, nullptr, nullptr, p);
}

// ---- pass C: the state entering each segment but the first, in place of
// the local state of the one before; with no chunks, the final state ----

__global__ void __launch_bounds__(NT_COMBINE)
ssd_combine_kernel(const float* __restrict__ h_init, float* __restrict__ ls,
                   const float* __restrict__ sdec, float* __restrict__ st, int H, int P, int N,
                   int nloc, int64_t hsb, int64_t hsh, int64_t hsp, int64_t ssb, int64_t ssh,
                   int64_t ssp) {
    const int i = blockIdx.x * NT_COMBINE + threadIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int pn = P * N;
    if (i >= pn) return;
    const int p = i / N, n = i - p * N;
    float e = h_init != nullptr ? h_init[b * hsb + h * hsh + p * hsp + n] : 0.f;
    const int nseg = nloc;  // local states to fold in
    float* l = ls + ((int64_t)b * H + h) * nseg * pn + i;
    const float* dec = sdec + ((int64_t)b * H + h) * nseg;
    for (int k0 = 0; k0 < nseg; k0 += 8) {  // eight segments' loads in flight at once
        float local[8], d[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            local[u] = k0 + u < nseg ? l[(int64_t)(k0 + u) * pn] : 0.f;
            d[u] = k0 + u < nseg ? dec[k0 + u] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
            if (k0 + u < nseg) {
                e = local[u] + d[u] * e;
                l[(int64_t)(k0 + u) * pn] = e;
            }
    }
    if (st != nullptr) st[b * ssb + h * ssh + p * ssp + n] = e;
}

// ---- pass D: y of every chunk of a segment, from the segment's entering states ----

template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
ssd_output_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mb,
                  const __grid_constant__ CUtensorMap mc, const __grid_constant__ CUtensorMap my,
                  const Params p) {
    chunk_pass<NT, true>(&mx, &mb, &mc, &my, p);
}

struct Shape {
    int nc, cps, nseg;
};

template <int NT>
void set_smem_limits() {
    cudaFuncSetAttribute(ssd_state_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         Cfg<NT, false>::SMEM);
    cudaFuncSetAttribute(ssd_output_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         Cfg<NT, true>::SMEM);
}

template <int NT>
void occupancy(int* occ_b, int* occ_d) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ_b, ssd_state_kernel<NT>, THREADS,
                                                  Cfg<NT, false>::SMEM);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ_d, ssd_output_kernel<NT>, THREADS,
                                                  Cfg<NT, true>::SMEM);
}

// Segments of nc chunks, each B * G * ceil(rep / 2) blocks: the count that
// keeps the waves of passes B and D fullest, in units of one chunk of pass D
// (a chunk of pass B ~0.4 of that; a block's set-up ~1).  Also sets the
// passes' shared-memory limits on the current device, which their launches
// need.
Shape plan(int B, int S, int H, int G, int N, int L, int device) {
    Shape sh{(S + L - 1) / L, 1, 0};
    set_smem_limits<32>();
    set_smem_limits<64>();
    set_smem_limits<128>();
    if (sh.nc == 0) return sh;
    int sms = 132, occ_b = 1, occ_d = 1;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    switch (n_tile(N)) {
        case 32: occupancy<32>(&occ_b, &occ_d); break;
        case 64: occupancy<64>(&occ_b, &occ_d); break;
        default: occupancy<128>(&occ_b, &occ_d); break;
    }
    occ_b = occ_b < 1 ? 1 : occ_b;
    occ_d = occ_d < 1 ? 1 : occ_d;
    const int rep = H / G;
    const int64_t units = (int64_t)B * G * ((rep + HEADS - 1) / HEADS);
    const int64_t most = std::min<int64_t>(sh.nc, 16 * (int64_t)sms / units + 1);
    auto waves = [sms](int64_t blocks, int occ) {
        return (double)((blocks + (int64_t)sms * occ - 1) / ((int64_t)sms * occ));
    };
    double best = 1e300;
    for (int64_t want = 1; want <= most; ++want) {
        const int cps = (int)((sh.nc + want - 1) / want);
        const int nseg = (sh.nc + cps - 1) / cps;  // pass B runs all but the last
        const double cost =
            (waves(units * nseg, occ_d) + 0.4 * waves(units * (nseg - 1), occ_b)) * (cps + 1);
        if (cost < best) {
            best = cost;
            sh.cps = cps;
            sh.nseg = nseg;
        }
    }
    return sh;
}

// Floats of scratch: the cs and dt, the states and decays of every segment
// but the last.
int64_t workspace_floats(int B, int H, int P, int N, const Shape& sh) {
    const int64_t nloc = sh.nseg > 0 ? sh.nseg - 1 : 0;
    return (int64_t)B * H * sh.nc * CD + (int64_t)B * H * nloc * P * N + (int64_t)B * H * nloc;
}

bool valid_shape(int B, int S, int H, int P, int G, int N, int L) {
    return B >= 0 && S >= 0 && H > 0 && G > 0 && H % G == 0 && P > 0 && P <= MAX_P && N > 0 &&
           N <= MAX_N && L >= 4 && L <= MAX_L && L % 4 == 0;
}

template <int NT>
cudaError_t launch_state(const CUtensorMap& mx, const CUtensorMap& mb, const CUtensorMap& mc,
                          const Params& prm, int B, cudaStream_t s) {
    const dim3 grid(prm.nseg - 1, prm.G * prm.pairs, B);  // the last segment's is not needed
    ssd_state_kernel<NT><<<grid, THREADS, Cfg<NT, false>::SMEM, s>>>(mx, mb, prm);
    return cudaGetLastError();
}

template <int NT>
cudaError_t launch_output(const CUtensorMap& mx, const CUtensorMap& mb, const CUtensorMap& mc,
                          const CUtensorMap& my, const Params& prm, int B, cudaStream_t s) {
    const dim3 grid(prm.nseg, prm.G * prm.pairs, B);
    ssd_output_kernel<NT><<<grid, THREADS, Cfg<NT, true>::SMEM, s>>>(mx, mb, mc, my, prm);
    return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of each pass (0..3: A, B, C, D) at N = 128, in bytes.
extern "C" int repro_ssd_scan_smem_bytes(int pass) {
    const int bytes[4] = {0, Cfg<128, false>::SMEM, 0, Cfg<128, true>::SMEM};
    return pass >= 0 && pass < 4 ? bytes[pass] : -1;
}

// The limits of the kernel: chunk L a multiple of 4 in [4, 64], P in
// [1, 64], N in [1, 128].  The wrapper reads them from here.
extern "C" int repro_ssd_scan_limits(int* max_l, int* max_p, int* max_n) {
    *max_l = MAX_L;
    *max_p = MAX_P;
    *max_n = MAX_N;
    return 0;
}

// The plan for a shape on a device: segments, chunks per segment and the
// scratch the wrapper allocates (floats).  It also sets the passes' shared-
// memory limits on the device, so it comes before the first
// repro_ssd_scan_fwd there; the wrapper computes it once per shape and
// device.  Returns cudaError_t.
extern "C" int repro_ssd_scan_plan(int B, int S, int H, int P, int G, int N, int L, int device,
                                   int* nseg, int* cps, int64_t* ws_floats) {
    if (!valid_shape(B, S, H, P, G, N, L)) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const Shape sh = plan(B, S, H, G, N, L, device);
    *nseg = sh.nseg;
    *cps = sh.cps;
    *ws_floats = workspace_floats(B, H, P, N, sh);
    return (int)cudaGetLastError();
}

// x [B,S,H,P], dt [B,S,H], a [H] (contiguous), bm/cm [B,S,G,N], h_init
// [B,H,P,N] or null, y [B,S,H,P], st [B,H,P,N], ws scratch of ws_floats
// floats (16-byte aligned); all f32.  nseg and cps are the plan's segments
// and chunks per segment, and ws_floats at least its scratch
// (repro_ssd_scan_plan, called before on this device).
// Strides in elements: (batch, seq, head) for x, dt, y; (batch, seq, group)
// for bm, cm; (batch, head, row) for h_init and st; the last dim is
// unit-stride.  x, B and C go by TMA where every stride is a multiple of 4
// elements and each pointer 16-byte aligned, else by 4-byte cp.async.
// device is the CUDA ordinal of the tensors and the stream.  Returns
// cudaError_t.
extern "C" int repro_ssd_scan_fwd(
        const float* x, const float* dt, const float* a, const float* bm, const float* cm,
        const float* h_init, float* y, float* st, float* ws, int64_t ws_floats,
        int B, int S, int H, int P, int G, int N, int L, int nseg, int cps,
        int64_t xsb, int64_t xss, int64_t xsh, int64_t dsb, int64_t dss, int64_t dsh,
        int64_t bsb, int64_t bss, int64_t bsg, int64_t csb, int64_t css, int64_t csg,
        int64_t ysb, int64_t yss, int64_t ysh, int64_t hsb, int64_t hsh, int64_t hsp,
        int64_t ssb, int64_t ssh, int64_t ssp, int device, void* stream) {
    if (!valid_shape(B, S, H, P, G, N, L)) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);  // this library's runtime keeps its own
    if (err != cudaSuccess) return (int)err;
    if (B == 0) return (int)cudaSuccess;
    auto al16 = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
    const int nc = (S + L - 1) / L;
    const Shape sh{nc, cps, nseg};
    if (cps < 1 || nseg != (nc + cps - 1) / cps || !al16(ws) ||
        ws_floats < workspace_floats(B, H, P, N, sh))
        return (int)cudaErrorInvalidValue;
    const bool tma = al16(x) && al16(bm) && al16(cm) &&
                     (xsb | xss | xsh | bsb | bss | bsg | csb | css | csg) % 4 == 0;
    const bool tma_y = al16(y) && (ysb | yss | ysh) % 4 == 0;
    const int rep = H / G;
    const int nloc = nseg > 0 ? nseg - 1 : 0;
    float* cd = ws;
    float* ls = cd + (int64_t)B * H * nc * CD;
    float* sdec = ls + (int64_t)B * H * nloc * P * N;
    const Params prm{x, bm, cm, cd, ls, sdec, h_init, y, st, S, H, P, G, N, L, nc, cps, nseg,
                     rep, (rep + HEADS - 1) / HEADS, tma ? 1 : 0, tma_y ? 1 : 0,
                     {xsb, xss, xsh}, {bsb, bss, bsg}, {csb, css, csg}, {ysb, yss, ysh},
                     {hsb, hsh, hsp}, {ssb, ssh, ssp}};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    CUtensorMap mx{}, mb{}, mc{}, my{};
    if (nc > 0 && tma &&
        (!make_map_f32(&mx, x, B, S, H, P, xsb, xss, xsh, L) ||
         !make_map_f32(&mb, bm, B, S, G, N, bsb, bss, bsg, L) ||
         !make_map_f32(&mc, cm, B, S, G, N, csb, css, csg, L)))
        return (int)cudaErrorInvalidValue;
    if (nc > 0 && tma_y && !make_map_f32(&my, y, B, S, H, P, ysb, yss, ysh, L))
        return (int)cudaErrorInvalidValue;
    if (nc > 0) {
        const int64_t items = (int64_t)B * H * nc;
        ssd_prep_kernel<<<(unsigned)((items + NT_PREP / 32 - 1) / (NT_PREP / 32)), NT_PREP, 0,
                          s>>>(dt, a, cd, B, S, H, L, nc, dsb, dss, dsh);
        if (nloc > 0) {
            switch (n_tile(N)) {
                case 32: err = launch_state<32>(mx, mb, mc, prm, B, s); break;
                case 64: err = launch_state<64>(mx, mb, mc, prm, B, s); break;
                default: err = launch_state<128>(mx, mb, mc, prm, B, s); break;
            }
            if (err != cudaSuccess) return (int)err;
        }
    }
    // the entering states of segments 1.. (pass D's last segment writes the
    // final state); with no chunks, the final state is h_init or zero
    const int pn_blocks = (P * N + NT_COMBINE - 1) / NT_COMBINE;
    if (nloc > 0 || nc == 0)
        ssd_combine_kernel<<<dim3(pn_blocks, H, B), NT_COMBINE, 0, s>>>(
            h_init, ls, sdec, nc == 0 ? st : nullptr, H, P, N, nloc, hsb, hsh, hsp, ssb, ssh,
            ssp);
    if (nc > 0) {
        switch (n_tile(N)) {
            case 32: err = launch_output<32>(mx, mb, mc, my, prm, B, s); break;
            case 64: err = launch_output<64>(mx, mb, mc, my, prm, B, s); break;
            default: err = launch_output<128>(mx, mb, mc, my, prm, B, s); break;
        }
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}
