// Mamba-2 SSD chunk scan for Hopper (sm_90a), f32 in and out, every matrix
// product on the TF32 tensor cores in 3xTF32.
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
// GFLOP of products (0.08 ms at the 495 TFLOP/s of TF32): bytes.  The
// TPU kernel walks the chunks of a (b, h) in order, one grid step each.
// Done that way on this card (one block per (b, h, 16 rows of P), f32 FMAs)
// it gave 128 blocks of 8 warps that waited on latency, C B^T computed 128
// times per chunk, and ~10 TFLOP/s on the CUDA cores: 7.3 ms.
//
// Design: four passes on one stream, so that each chunk's work is spread
// over the card and nothing is computed twice but the state products.
//
//   A. ssd_cb_kernel, one block per (b, group, chunk): C B^T of the chunk
//      ([L, L], causal tiles only) once for all heads of the group, and per
//      head the chunk's cs (a warp-parallel scan), dt and wd = dt *
//      exp(cs_last - cs), padded to 64 positions.  8.4 MB of C B^T at the
//      main shape; it stays in the 50 MB L2 for pass D.
//   B. ssd_state_kernel, one block per (b, h, segment of `cps` chunks): the
//      segment's state from a zero state, and its total decay exp(sum dA).
//   C. ssd_combine_kernel, elementwise over (b, h, p, n), in order over the
//      segments: the state entering each segment (segment 0: h_init or 0;
//      then entering(k+1) = local(k) + decay(k) * entering(k)); the last is
//      the final state.
//   D. ssd_output_kernel, one block of 16 warps per (b, h, segment): from
//      the entering state, for each chunk W = C B^T * exp(cs_i - cs_j) *
//      dt_j (built in place of C B^T), y, then the state carried on.
//
// The number of segments is chosen from the SM count and the passes'
// occupancy so that the waves of passes B and D are full (8 segments of 64
// chunks at the main shape on 132 SMs: 256 blocks).  Pass D recomputes the
// state products of pass B rather than reading a state per chunk ([B, 512,
// H, P, N] f32, 537 MB each way).
//
// Products: mma.sync m16n8k8 TF32 with f32 accumulation (tf32.cuh, shared
// with the backward).  Plain TF32 (10 mantissa bits) misses the tolerance
// the kernel is held to by ~5x, so each f32 operand is split into a TF32
// high part and a low part (x - hi), and a product is lo.hi + hi.lo +
// hi.hi (about 2^-20 relative).  Decays, the
// scans and dt stay f32 on the CUDA cores.  Each warp owns fixed 16-row
// tiles of every product; operands come from shared memory, whose row
// strides keep fragment loads free of bank conflicts.  Tiles of the next
// chunk are copied in with cp.async (16 bytes, or 4 where a row is not
// 16-byte aligned) while the current one is computed: two stages of C, B, x
// and the scan values, one of C B^T.  Measured on an H100 at the main shape
// (chip_smoke.py), what holds the passes back is shared: the tensor cores'
// mma.sync TF32 rate times the three products of 3xTF32, fragment loads
// from shared memory that several warps repeat, and the C and B tiles that
// every head reads again from L2.  wgmma with operands in
// shared memory, and several heads of a group per block, are the next steps.
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

#include "tf32.cuh"

namespace {

constexpr int NT = 256;              // threads of passes A and B: 8 warps
constexpr int NW = NT / 32;
constexpr int NT_D = 512;            // threads of pass D: 16 warps
constexpr int YT = 2;                // 8-column tiles of y per warp in pass D
constexpr int MAX_L = 64;            // chunk length
constexpr int MAX_N = 128;           // state width
constexpr int MAX_P = 64;            // head width
// Row strides of the shared tiles (floats).  A tile whose rows run along
// the summed index k is read two k at a time (8 bytes, stride = 8 mod 32);
// one whose rows are k is read one k at a time (stride = 4 mod 32); either
// way no two lanes of a load hit one bank.
constexpr int LD_K = MAX_N + 8;      // C, and B in pass A, and the state: rows along n
constexpr int LD_B = MAX_N + 4;      // B in passes B and D: rows are s
constexpr int LD_X = MAX_P + 4;      // x: rows are s
constexpr int LD_W = MAX_L + 8;      // C B^T: rows along j
constexpr int CD = 3 * MAX_L;        // per (b, h, chunk): cs, dt, wd
constexpr int NT_COMBINE = 256;

// Shared memory of each pass, in floats.
constexpr int SMEM_A = 2 * MAX_L * LD_K;                                 // C, B
constexpr int STAGE_B = MAX_L * LD_B + MAX_L * LD_X + CD;                // B, x, cd
constexpr int SMEM_B = 2 * STAGE_B;
constexpr int STAGE_D = MAX_L * LD_K + MAX_L * LD_B + MAX_L * LD_X + CD; // C, B, x, cd
constexpr int SMEM_D = 2 * STAGE_D + MAX_L * LD_W + MAX_P * LD_K;        // + C B^T, state

struct Strides {
    int64_t xb, xs, xh, db, ds, dh, bb, bs, bg, cb, cs, cg, yb, ys, yh,
            hb, hh, hp, sb, sh, sp;
};

struct Shape {
    int S, H, P, G, N, L, nc, cps, nseg;
    bool vec;  // every x, B and C row starts on a 16-byte boundary and P, N % 4 == 0
};

// ---- pass A: C B^T per (b, group, chunk); cs, dt, wd per (b, head, chunk) ----

__global__ void __launch_bounds__(NT)
ssd_cb_kernel(const float* __restrict__ dt, const float* __restrict__ a,
              const float* __restrict__ bm, const float* __restrict__ cm,
              float* __restrict__ cb, float* __restrict__ cd, Shape sh, Strides sd) {
    extern __shared__ float4 smem4[];
    float* Cs = reinterpret_cast<float*>(smem4);  // [MAX_L][LD_K]
    float* Bs = Cs + MAX_L * LD_K;                 // [MAX_L][LD_K]
    const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
    const int L = sh.L, s0 = c * L, valid = min(L, sh.S - s0);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gq = lane >> 2, tq = lane & 3;

    zero_smem(Cs, SMEM_A);
    __syncthreads();
    load_tile<MAX_L>(Cs, LD_K, cm + b * sd.cb + g * sd.cg + s0 * sd.cs, sd.cs, valid, sh.N, sh.vec);
    load_tile<MAX_L>(Bs, LD_K, bm + b * sd.bb + g * sd.bg + s0 * sd.bs, sd.bs, valid, sh.N, sh.vec);
    cp_async_commit();

    // While the tiles load: per head of the group, the inclusive scan of dA
    // over the chunk (lane holds positions lane and lane + 32; positions past
    // the chunk or S have dt = 0, so cs stays at its last value there).
    const int rep = sh.H / sh.G;
    for (int hl = warp; hl < rep; hl += NW) {
        const int h = g * rep + hl;
        const float ah = a[h];
        const float* dtp = dt + b * sd.db + h * sd.dh + (int64_t)s0 * sd.ds;
        const float d0 = lane < valid ? dtp[lane * sd.ds] : 0.f;
        const float d1 = lane + 32 < valid ? dtp[(lane + 32) * sd.ds] : 0.f;
        float v0 = d0 * ah, v1 = d1 * ah;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float u0 = __shfl_up_sync(0xffffffffu, v0, off);
            const float u1 = __shfl_up_sync(0xffffffffu, v1, off);
            if (lane >= off) { v0 += u0; v1 += u1; }
        }
        v1 += __shfl_sync(0xffffffffu, v0, 31);
        const float last = __shfl_sync(0xffffffffu, v1, 31);
        float* o = cd + (((int64_t)b * sh.H + h) * sh.nc + c) * CD;
        o[lane] = v0;
        o[lane + 32] = v1;
        o[MAX_L + lane] = d0;
        o[MAX_L + lane + 32] = d1;
        o[2 * MAX_L + lane] = d0 * expf(last - v0);
        o[2 * MAX_L + lane + 32] = d1 * expf(last - v1);
    }
    cp_async_wait<0>();
    __syncthreads();

    // C B^T: warp w owns rows 16 (w % 4).. and columns 32 (w / 4).., four
    // 8-column tiles; tiles wholly above the diagonal are written as 0.
    const int i0 = 16 * (warp & 3), j0 = 32 * (warp >> 2);
    if (i0 >= L) return;
    float acc[4][4] = {};
    const int n8 = (sh.N + 7) & ~7;
#pragma unroll 2
    for (int k0 = 0; k0 < n8; k0 += 8) {
        Frag<4> fa;
        const float* ca = Cs + (i0 + gq) * LD_K + k0 + 2 * tq;
        fa.set2(0, 2, ld2(ca));
        fa.set2(1, 3, ld2(ca + 8 * LD_K));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
            const int jt = j0 + 8 * nt;
            if (jt < L && jt <= i0 + 15) {
                Frag<2> fb;
                fb.set2(0, 1, ld2(Bs + (jt + gq) * LD_K + k0 + 2 * tq));  // B(n, j) = B[j][n]
                mma3(acc[nt], fa, fb);
            }
        }
    }
    float* out = cb + (((int64_t)b * sh.G + g) * sh.nc + c) * L * L;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int i = i0 + gq + (e >> 1) * 8, j = j0 + 8 * nt + 2 * tq + (e & 1);
            if (i < L && j < L) out[i * L + j] = acc[nt][e];
        }
}

// ---- the state products, shared by passes B and D ----

// st = decay * st + Xw^T B over one chunk, Xw = x * wd.  Warp w owns state
// rows p = 16 (w % 4).. and TILES 8-column tiles from column n = 8 TILES (w / 4):
// 8 tiles for a block of 8 warps, 4 for 16.
template <int TILES, bool FULL>
__device__ __forceinline__ void state_update(float (&st)[TILES][4], const float* Xs,
                                             const float* Bs, const float* wd, float decay,
                                             const Shape& sh) {
    const int L = FULL ? MAX_L : sh.L, P = FULL ? MAX_P : sh.P, N = FULL ? MAX_N : sh.N;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gq = lane >> 2, tq = lane & 3;
    const int p0 = 16 * (warp & 3), n0 = 8 * TILES * (warp >> 2);
#pragma unroll
    for (int nt = 0; nt < TILES; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] *= decay;
    if (p0 >= P) return;
    const int l8 = (L + 7) & ~7;
#pragma unroll
    for (int k0 = 0; k0 < l8; k0 += 8) {
        const float2 w = ld2(wd + k0 + 2 * tq);
        const float* xa = Xs + (k0 + 2 * tq) * LD_X + p0 + gq;  // A(p, s) = Xw[s][p]
        Frag<4> fa;
        fa.set(0, xa[0] * w.x);
        fa.set(1, xa[8] * w.x);
        fa.set(2, xa[LD_X] * w.y);
        fa.set(3, xa[LD_X + 8] * w.y);
#pragma unroll
        for (int nt = 0; nt < TILES; ++nt) {
            const int nn = n0 + 8 * nt;
            if (nn < N) {
                Frag<2> fb;
                const float* bp = Bs + (k0 + 2 * tq) * LD_B + nn + gq;  // B(s, n)
                fb.set(0, bp[0]);
                fb.set(1, bp[LD_B]);
                mma3(st[nt], fa, fb);
            }
        }
    }
}

// The element (row, column) of the state that st[nt][e] holds.
__device__ __forceinline__ int st_row(int e) {
    return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) + (e >> 1) * 8;
}
template <int TILES>
__device__ __forceinline__ int st_col(int nt, int e) {
    return 8 * TILES * (threadIdx.x >> 7) + 8 * nt + 2 * (threadIdx.x & 3) + (e & 1);
}

// ---- pass B: each segment's state from a zero state, and its total decay ----

// FULL: L, P and N at their largest (mamba2-370m's head) and rows that take
// 16-byte copies, all known to the compiler.  At mamba2-370m's prefill shape
// a call takes 1.55 ms of device time with the FULL passes B and D and 2.06
// ms with the generic ones (H100 SXM, scripts/ssd_full_build_ab.py).
template <bool FULL>
__global__ void __launch_bounds__(NT, 2)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                 const float* __restrict__ cd, float* __restrict__ ls, float* __restrict__ sdec,
                 Shape sh, Strides sd) {
    extern __shared__ float4 smem4[];
    float* stage0 = reinterpret_cast<float*>(smem4);  // per stage: B, x, cd
    const int seg = blockIdx.x, h = blockIdx.y, b = blockIdx.z, g = h / (sh.H / sh.G);
    const int c_begin = seg * sh.cps, c_end = min(sh.nc, c_begin + sh.cps);
    const float* bbase = bm + b * sd.bb + g * sd.bg;
    const float* xbase = x + b * sd.xb + h * sd.xh;
    const float* cdbase = cd + ((int64_t)b * sh.H + h) * sh.nc * CD;

    auto fetch = [&](int c) {
        float* Bs = stage0 + ((c - c_begin) & 1) * STAGE_B;
        const int s0 = c * sh.L, valid = min(sh.L, sh.S - s0);
        if (FULL) {
            load_rows<MAX_L, MAX_N, NT>(Bs, LD_B, bbase + (int64_t)s0 * sd.bs, sd.bs, valid);
            load_rows<MAX_L, MAX_P, NT>(Bs + MAX_L * LD_B, LD_X, xbase + (int64_t)s0 * sd.xs,
                                        sd.xs, valid);
        } else {
            load_tile<MAX_L>(Bs, LD_B, bbase + (int64_t)s0 * sd.bs, sd.bs, valid, sh.N, sh.vec);
            load_tile<MAX_L>(Bs + MAX_L * LD_B, LD_X, xbase + (int64_t)s0 * sd.xs, sd.xs, valid,
                             sh.P, sh.vec);
        }
        load_flat(Bs + MAX_L * LD_B + MAX_L * LD_X, cdbase + (int64_t)c * CD, CD);
        cp_async_commit();
    };

    zero_smem(stage0, SMEM_B);
    __syncthreads();
    fetch(c_begin);
    float st[8][4] = {};
    float log_decay = 0.f;
    for (int c = c_begin; c < c_end; ++c) {
        cp_async_wait<0>();
        __syncthreads();  // chunk c is in; every thread is done with chunk c - 1
        if (c + 1 < c_end) fetch(c + 1);
        const float* Bs = stage0 + ((c - c_begin) & 1) * STAGE_B;
        const float* Xs = Bs + MAX_L * LD_B;
        const float* cs = Xs + MAX_L * LD_X;
        log_decay += cs[MAX_L - 1];
        state_update<8, FULL>(st, Xs, Bs, cs + 2 * MAX_L, expf(cs[MAX_L - 1]), sh);
    }
    float* out = ls + (((int64_t)b * sh.H + h) * sh.nseg + seg) * sh.P * sh.N;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int p = st_row(e), n = st_col<8>(nt, e);
            if (p < sh.P && n < sh.N) out[p * sh.N + n] = st[nt][e];
        }
    if (threadIdx.x == 0) sdec[((int64_t)b * sh.H + h) * sh.nseg + seg] = expf(log_decay);
}

// ---- pass C: the state entering each segment, in place of its local state ----

__global__ void __launch_bounds__(NT_COMBINE)
ssd_combine_kernel(const float* __restrict__ h_init, float* __restrict__ ls,
                   const float* __restrict__ sdec, float* __restrict__ st, Shape sh,
                   Strides sd) {
    const int i = blockIdx.x * NT_COMBINE + threadIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int pn = sh.P * sh.N;
    if (i >= pn) return;
    const int p = i / sh.N, n = i - p * sh.N;
    float e = h_init != nullptr ? h_init[b * sd.hb + h * sd.hh + p * sd.hp + n] : 0.f;
    float* l = ls + ((int64_t)b * sh.H + h) * sh.nseg * pn + i;
    const float* dec = sdec + ((int64_t)b * sh.H + h) * sh.nseg;
#pragma unroll 4
    for (int k = 0; k < sh.nseg; ++k) {
        const float local = l[(int64_t)k * pn];
        l[(int64_t)k * pn] = e;
        e = local + dec[k] * e;
    }
    st[b * sd.sb + h * sd.sh + p * sd.sp + n] = e;
}

// ---- pass D: y of every chunk of a segment, from the segment's entering state ----

template <bool FULL>
__global__ void __launch_bounds__(NT_D, 1)
ssd_output_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                  const float* __restrict__ cm, const float* __restrict__ cb,
                  const float* __restrict__ cd, const float* __restrict__ ls,
                  float* __restrict__ y, Shape sh, Strides sd) {
    extern __shared__ float4 smem4[];
    float* stage0 = reinterpret_cast<float*>(smem4);  // per stage: C, B, x, cd
    float* CBs = stage0 + 2 * STAGE_D;                 // [MAX_L][LD_W]
    float* Ss = CBs + MAX_L * LD_W;                    // [MAX_P][LD_K]: the entering state
    const int seg = blockIdx.x, h = blockIdx.y, b = blockIdx.z, g = h / (sh.H / sh.G);
    const int L = FULL ? MAX_L : sh.L, P = FULL ? MAX_P : sh.P, N = FULL ? MAX_N : sh.N;
    const int c_begin = seg * sh.cps, c_end = min(sh.nc, c_begin + sh.cps);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gq = lane >> 2, tq = lane & 3;
    const float* bbase = bm + b * sd.bb + g * sd.bg;
    const float* cbase = cm + b * sd.cb + g * sd.cg;
    const float* xbase = x + b * sd.xb + h * sd.xh;
    const float* cdbase = cd + ((int64_t)b * sh.H + h) * sh.nc * CD;
    const float* cbbase = cb + ((int64_t)b * sh.G + g) * sh.nc * L * L;
    float* ybase = y + b * sd.yb + h * sd.yh;

    auto fetch = [&](int c) {
        float* Cs = stage0 + ((c - c_begin) & 1) * STAGE_D;
        const int s0 = c * L, valid = min(L, sh.S - s0);
        float* Bs = Cs + MAX_L * LD_K;
        float* Xs = Bs + MAX_L * LD_B;
        if (FULL) {
            load_rows<MAX_L, MAX_N, NT_D>(Cs, LD_K, cbase + (int64_t)s0 * sd.cs, sd.cs, valid);
            load_rows<MAX_L, MAX_N, NT_D>(Bs, LD_B, bbase + (int64_t)s0 * sd.bs, sd.bs, valid);
            load_rows<MAX_L, MAX_P, NT_D>(Xs, LD_X, xbase + (int64_t)s0 * sd.xs, sd.xs, valid);
        } else {
            load_tile<MAX_L>(Cs, LD_K, cbase + (int64_t)s0 * sd.cs, sd.cs, valid, N, sh.vec);
            load_tile<MAX_L>(Bs, LD_B, bbase + (int64_t)s0 * sd.bs, sd.bs, valid, N, sh.vec);
            load_tile<MAX_L>(Xs, LD_X, xbase + (int64_t)s0 * sd.xs, sd.xs, valid, P, sh.vec);
        }
        load_flat(Xs + MAX_L * LD_X, cdbase + (int64_t)c * CD, CD);
    };
    auto fetch_cb = [&](int c) {
        if (FULL)
            load_rows<MAX_L, MAX_L, NT_D>(CBs, LD_W, cbbase + (int64_t)c * L * L, L, L);
        else
            load_tile<MAX_L>(CBs, LD_W, cbbase + (int64_t)c * L * L, L, L, L, true);
    };

    zero_smem(stage0, SMEM_D);
    __syncthreads();
    fetch(c_begin);
    fetch_cb(c_begin);
    cp_async_commit();
    // the entering state, in shared memory (for C state^T) and in the
    // accumulators of the state products
    const float* ent = ls + (((int64_t)b * sh.H + h) * sh.nseg + seg) * P * N;
    for (int i = threadIdx.x; i < P * N; i += NT_D) Ss[(i / N) * LD_K + i % N] = ent[i];
    float st[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int p = st_row(e), n = st_col<4>(nt, e);
            st[nt][e] = p < P && n < N ? ent[p * N + n] : 0.f;
        }

    // this warp's tile of y: warp w runs on scheduler w % 4, so each scheduler
    // gets one warp of each row tile (the causal W X is 1 to 4 times as long)
    const int i0 = 16 * (warp >> 2), p0 = 16 * (warp & 3);
    const int n8 = (N + 7) & ~7, l8 = (L + 7) & ~7;
    for (int c = c_begin; c < c_end; ++c) {
        cp_async_wait<0>();
        __syncthreads();  // chunk c and the state entering it are in; chunk c - 1 is done
        if (c + 1 < c_end) {
            fetch(c + 1);
            cp_async_commit();
        }
        const float* Cs = stage0 + ((c - c_begin) & 1) * STAGE_D;
        const float* Bs = Cs + MAX_L * LD_K;
        const float* Xs = Bs + MAX_L * LD_B;
        const float* cs = Xs + MAX_L * LD_X;
        const float* dts = cs + MAX_L;

        // W = C B^T * exp(cs_i - cs_j) * dt_j for j <= i, else 0, in place of C B^T
        for (int e = threadIdx.x; e < MAX_L * MAX_L; e += NT_D) {
            const int i = e / MAX_L, j = e % MAX_L;
            float* w = CBs + i * LD_W + j;
            *w = j <= i ? *w * __expf(cs[i] - cs[j]) * dts[j] : 0.f;
        }
        const bool mine = i0 < L && p0 < P;
        const int ia = i0 + gq, ib = ia + 8;
        float acc[YT][4] = {};
        if (mine) {
            // C state^T, then scaled by exp(cs_i)
#pragma unroll
            for (int k0 = 0; k0 < n8; k0 += 8) {
                Frag<4> fa;
                const float* ca = Cs + (i0 + gq) * LD_K + k0 + 2 * tq;
                fa.set2(0, 2, ld2(ca));
                fa.set2(1, 3, ld2(ca + 8 * LD_K));
#pragma unroll
                for (int nt = 0; nt < YT; ++nt) {
                    const int pp = p0 + 8 * nt;
                    if (pp < P) {
                        Frag<2> fb;  // B(n, p) = S[p][n]
                        fb.set2(0, 1, ld2(Ss + (pp + gq) * LD_K + k0 + 2 * tq));
                        mma3(acc[nt], fa, fb);
                    }
                }
            }
            const float ea = expf(cs[ia]), eb = expf(cs[ib]);
#pragma unroll
            for (int nt = 0; nt < YT; ++nt) {
                acc[nt][0] *= ea;
                acc[nt][1] *= ea;
                acc[nt][2] *= eb;
                acc[nt][3] *= eb;
            }
        }
        __syncthreads();  // W is in
        if (mine) {
            // + W X
            const int jend = min(l8, i0 + 16);
            for (int k0 = 0; k0 < jend; k0 += 8) {
                const int ja = k0 + 2 * tq;
                const float* wa = CBs + ia * LD_W + ja;
                Frag<4> fa;
                fa.set2(0, 2, ld2(wa));
                fa.set2(1, 3, ld2(wa + 8 * LD_W));
#pragma unroll
                for (int nt = 0; nt < YT; ++nt) {
                    const int pp = p0 + 8 * nt;
                    if (pp < P) {
                        Frag<2> fb;
                        const float* xp = Xs + ja * LD_X + pp + gq;  // B(j, p) = X[j][p]
                        fb.set(0, xp[0]);
                        fb.set(1, xp[LD_X]);
                        mma3(acc[nt], fa, fb);
                    }
                }
            }
            const int s0 = c * L;
#pragma unroll
            for (int nt = 0; nt < YT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int i = e < 2 ? ia : ib, p = p0 + 8 * nt + 2 * tq + (e & 1);
                    if (i < L && s0 + i < sh.S && p < P)
                        ybase[(int64_t)(s0 + i) * sd.ys + p] = acc[nt][e];
                }
        }
        __syncthreads();  // every read of W and of the entering state is done
        if (c + 1 < c_end) {
            fetch_cb(c + 1);
            cp_async_commit();
        }
        state_update<4, FULL>(st, Xs, Bs, cs + 2 * MAX_L, expf(cs[MAX_L - 1]), sh);
        if (c + 1 < c_end) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) Ss[st_row(e) * LD_K + st_col<4>(nt, e)] = st[nt][e];
        }
    }
}

// Segments of chunks for B*H heads of nc chunks: the count that keeps the
// waves of passes B and D fullest, in units of one chunk of pass D (a chunk
// of pass B ~0.4 of that; a block's set-up ~1).  Also sets the passes'
// shared-memory limits on the current device, which their launches need.
Shape plan(int B, int S, int H, int P, int G, int N, int L, int device) {
    Shape sh{S, H, P, G, N, L, (S + L - 1) / L, 1, 0, false};
    cudaFuncSetAttribute(ssd_cb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_A * 4);
    for (auto k : {ssd_state_kernel<false>, ssd_state_kernel<true>})
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_B * 4);
    for (auto k : {ssd_output_kernel<false>, ssd_output_kernel<true>})
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_D * 4);
    if (sh.nc == 0) return sh;
    int sms = 132, occ_b = 2, occ_d = 1;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ_b, ssd_state_kernel<false>, NT,
                                                  SMEM_B * 4);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ_d, ssd_output_kernel<false>, NT_D,
                                                  SMEM_D * 4);
    occ_b = occ_b < 1 ? 1 : occ_b;
    occ_d = occ_d < 1 ? 1 : occ_d;
    const int64_t heads = (int64_t)B * H;
    const int64_t most = std::min<int64_t>(sh.nc, 16 * (int64_t)sms / heads + 1);
    double best = 1e300;
    for (int64_t want = 1; want <= most; ++want) {
        const int cps = (int)((sh.nc + want - 1) / want);
        const int nseg = (sh.nc + cps - 1) / cps;
        const int64_t blocks = heads * nseg;
        const double waves_d = (double)((blocks + (int64_t)sms * occ_d - 1) / ((int64_t)sms * occ_d));
        const double waves_b = (double)((blocks + (int64_t)sms * occ_b - 1) / ((int64_t)sms * occ_b));
        const double cost = (waves_d + 0.4 * waves_b) * (cps + 1);
        if (cost < best) {
            best = cost;
            sh.cps = cps;
            sh.nseg = nseg;
        }
    }
    return sh;
}

// Floats of scratch: C B^T, the scan values, the segment states and decays.
int64_t workspace_floats(int B, const Shape& sh) {
    return (int64_t)B * sh.G * sh.nc * sh.L * sh.L + (int64_t)B * sh.H * sh.nc * CD +
           (int64_t)B * sh.H * sh.nseg * sh.P * sh.N + (int64_t)B * sh.H * sh.nseg;
}

bool valid_shape(int B, int S, int H, int P, int G, int N, int L) {
    return B >= 0 && S >= 0 && H > 0 && G > 0 && H % G == 0 && P > 0 && P <= MAX_P && N > 0 &&
           N <= MAX_N && L >= 4 && L <= MAX_L && L % 4 == 0;
}

}  // namespace

// Dynamic shared memory of each pass (0..3: A, B, C, D) in bytes.
extern "C" int repro_ssd_scan_smem_bytes(int pass) {
    const int floats[4] = {SMEM_A, SMEM_B, 0, SMEM_D};
    return pass >= 0 && pass < 4 ? floats[pass] * 4 : -1;
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
    const Shape sh = plan(B, S, H, P, G, N, L, device);
    *nseg = sh.nseg;
    *cps = sh.cps;
    *ws_floats = workspace_floats(B, sh);
    return (int)cudaGetLastError();
}

// x [B,S,H,P], dt [B,S,H], a [H] (contiguous), bm/cm [B,S,G,N], h_init
// [B,H,P,N] or null, y [B,S,H,P], st [B,H,P,N], ws scratch of ws_floats
// floats (16-byte aligned); all f32.  nseg and cps are the plan's segments
// and chunks per segment, and ws_floats at least its scratch
// (repro_ssd_scan_plan, called before on this device).
// Strides in elements: (batch, seq, head) for x, dt, y; (batch, seq, group)
// for bm, cm; (batch, head, row) for h_init and st; the last dim is
// unit-stride.  device is the CUDA ordinal of the tensors and the stream.
// Returns cudaError_t.
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
    const bool vec = P % 4 == 0 && N % 4 == 0 && al16(x) && al16(bm) && al16(cm) &&
                     (xsb | xss | xsh | bsb | bss | bsg | csb | css | csg) % 4 == 0;
    const int nc = (S + L - 1) / L;
    const Shape sh{S, H, P, G, N, L, nc, cps, nseg, vec};
    if (cps < 1 || nseg != (nc + cps - 1) / cps || !al16(ws) ||
        ws_floats < workspace_floats(B, sh))
        return (int)cudaErrorInvalidValue;
    const Strides sd{xsb, xss, xsh, dsb, dss, dsh, bsb, bss, bsg, csb, css, csg,
                     ysb, yss, ysh, hsb, hsh, hsp, ssb, ssh, ssp};
    float* cd = ws;
    float* cb = cd + (int64_t)B * H * sh.nc * CD;
    float* ls = cb + (int64_t)B * G * sh.nc * L * L;
    float* sdec = ls + (int64_t)B * H * sh.nseg * P * N;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool full = L == MAX_L && P == MAX_P && N == MAX_N && vec;
    if (sh.nc > 0) {
        ssd_cb_kernel<<<dim3(sh.nc, G, B), NT, SMEM_A * 4, s>>>(dt, a, bm, cm, cb, cd, sh, sd);
        const dim3 grid(sh.nseg, H, B);
        if (full)
            ssd_state_kernel<true><<<grid, NT, SMEM_B * 4, s>>>(x, bm, cd, ls, sdec, sh, sd);
        else
            ssd_state_kernel<false><<<grid, NT, SMEM_B * 4, s>>>(x, bm, cd, ls, sdec, sh, sd);
    }
    const int pn_blocks = (P * N + NT_COMBINE - 1) / NT_COMBINE;
    ssd_combine_kernel<<<dim3(pn_blocks, H, B), NT_COMBINE, 0, s>>>(h_init, ls, sdec, st, sh, sd);
    if (sh.nc > 0) {
        const dim3 grid(sh.nseg, H, B);
        if (full)
            ssd_output_kernel<true><<<grid, NT_D, SMEM_D * 4, s>>>(x, bm, cm, cb, cd, ls, y, sh, sd);
        else
            ssd_output_kernel<false><<<grid, NT_D, SMEM_D * 4, s>>>(x, bm, cm, cb, cd, ls, y, sh,
                                                                     sd);
    }
    return (int)cudaGetLastError();
}
