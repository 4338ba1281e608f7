// Gradient of flash-decode for Hopper (sm_90a): dq, dk_cache and dv_cache of
// one query token against a masked KV cache, from the cotangent of the output
// and the forward's residuals.
//
// Replaces `_decode_vjp_bwd` in src/repro/kernels/decode_attention.py (XLA:
// it recomputes through `ref.decode_attention`'s VJP; Pallas has no AD rule).
// Same function as the plain version `repro_torch.kernels.ref.decode_attention_bwd`:
// for each query head h of kv head g, with lse_h the forward's log-sum-exp
// and o_h its f32 output (`repro_decode_attention_fwd` with residuals),
//   p_c = exp(scale q_h . k_c - lse_h) over the valid slots c (0 elsewhere),
//   dp_c = do_h . v_c, delta = do_h . o_h (= sum_c p_c dp_c), ds_c = p_c (dp_c - delta),
//   dv_c = sum_h p_c do_h,  dk_c = scale sum_h ds_c q_h,  dq_h = scale sum_c ds_c k_c,
// the sums over h running over the rep query heads that share kv head g.  A
// masked slot gets dk = dv = 0 exactly, and a cache with no valid slot gets
// zero gradients; the mask gets no cotangent.  delta is the f32 value: do . o
// of the output rounded to bf16 would be off by ~2^-9 |do| |o| in every ds.
//
// What bounds it on an H100: a few FLOPs per cache element (about 8 rep a
// (slot, dim)), far below the ~295 FLOP/B ridge, so bytes: K and V of the
// valid slots read once and dK and dV written once (B=8, C=4096, KV=8, dh=128
// bf16: 4 x 67.1 MB, ~0.080 ms at 3.35 TB/s), beside which the split's dq
// partials (B KV nsplit rep dh f32, written once and read once) are small.
// The design, one pass over the cache:
//  * one block per (batch, kv head, split); the split is chosen from the
//    shape (`split_for`): the largest of 512, 256, ... slots, down to one
//    stage, that still gives TARGET_BLOCKS blocks, one for each of an H100's
//    132 SMs (llama3-8b's decode: 512 slots, 512 blocks; paligemma-3b's, one
//    kv head: 128 slots, 256 blocks).  Two blocks fit an SM, so that is one
//    wave there.  Aiming at two blocks an SM instead gave paligemma-3b
//    64-slot splits (512 blocks in two waves, two stages each), slower on
//    the card (`scripts/decode_bwd_ab.py --target-blocks 264`): each block's
//    set-up (masks, Q, dO, delta) and its dq partial weigh on half as many
//    slots;
//  * the split streams through shared memory in stages of 16 slots a warp
//    (4 warps and 64 slots up to dh 128, 2 warps and 32 slots at 256): every
//    stage's mask is read first, then K and V go by cp.async into a ring of
//    three stages where two blocks still fit an SM (else two), a masked slot
//    zero-filled and not read; a stage whose mask is all false is neither
//    read nor computed, its dK and dV written as zeros;
//  * every product is on the tensor cores (mma.sync, bf16 in, f32
//    accumulate), the group's heads padded to RP = 8 or 16 (a padding head
//    has P = 0 exactly) on the narrow side: each warp takes its 16 slots'
//    S^T = K Q^T and dP^T = V dO^T over dh, forms P^T and dS^T in the
//    accumulators, and computes dV = P^T dO and dK = scale dS^T Q of its
//    slots; dS goes through shared memory, and each warp then sums its
//    share of the dims of the split's dq^T = K^T dS^T over the stage's slots
//    (both operands by ldmatrix.trans);
//  * P and dS are carried as bf16 hi + lo, as the flash backward does (P
//    rounded once to bf16 is off by 2^-9 of each term): at 8 heads hi and lo
//    sit side by side on the k side of one m16n8k16, at 16 they take two;
//  * dV and dK are written once, through the warp's own rows of the stage's
//    V and K tiles (dK once every warp has read K for dq), 16 bytes a lane;
//  * f32 inputs (off every model path) split every operand into bf16 hi +
//    lo in shared memory and take three products (hi hi, hi lo, lo hi);
//    their stages load synchronously, one at a time, and their dK and dV go
//    straight from the accumulators to memory;
//  * a second kernel sums the splits' dq partials in split order and
//    writes dq in the input type: no atomics, two calls bit-identical.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAXREP = 16;              // the forward's repro_decode_max_rep
constexpr int TARGET_BLOCKS = 132;      // one block for each SM of an H100
constexpr int MAX_SPLIT = 512;          // most cache slots a block

// Warps of a block; each owns 16 slots of a stage.
__host__ __device__ constexpr int warps_for(int DHP) { return DHP <= 128 ? 4 : 2; }

// Cache slots a block of the head-dim tile of dh runs through: a power-of-two
// multiple of its stage, the largest up to MAX_SPLIT that still makes
// TARGET_BLOCKS blocks.
int split_for(int B, int C, int KV, int dh) {
    const int stage = 16 * warps_for(head_dim_tile(dh));
    int split = MAX_SPLIT;
    while (split > stage && (int64_t)B * KV * ((C + split - 1) / split) < TARGET_BLOCKS)
        split /= 2;
    return split;
}

template <typename T>
__host__ __device__ constexpr int parts() { return sizeof(T) == 4 ? 2 : 1; }

// Bytes of dynamic shared memory of one block with S ring stages: the K/V
// ring [S][K, V][parts][TS][DHP + 8], Q and dO [2][parts][RP][DHP + 8]
// (bf16), dS hi and lo [2][TS][RS] (bf16), each head's lse and delta (f32),
// each stage's mask (64 bits).
template <typename T, int DHP, int RP>
__host__ __device__ constexpr int smem_for(int S) {
    constexpr int NP = parts<T>(), TS = 16 * warps_for(DHP);
    constexpr int LDS = bf16_lds<DHP>(), RS = RP == 8 ? 8 : 24;
    return 2 * (S * 2 * NP * TS * LDS + 2 * NP * RP * LDS + 2 * TS * RS) + 8 * RP +
           8 * (MAX_SPLIT / TS);
}

// Ring stages: three where two blocks still fit an SM's 228 KB, else two;
// one for f32 inputs, whose stages load synchronously.
template <typename T, int DHP, int RP>
__host__ __device__ constexpr int ring_stages() {
    return parts<T>() == 2 ? 1 : smem_for<T, DHP, RP>(3) + 1024 <= 114 * 1024 ? 3 : 2;
}

template <typename T, int DHP, int RP>
__host__ __device__ constexpr int smem_bytes() {
    return smem_for<T, DHP, RP>(ring_stages<T, DHP, RP>());
}

// d += a (16x8, row) * b (8x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(b));
}

// d += a * b over the heads: m16n8k8 for 8 heads (AF = 2), m16n8k16 for 16
template <int AF>
__device__ __forceinline__ void mma_heads(float (&d)[4], const uint32_t (&a)[AF],
                                          const uint32_t (&b)[2]) {
    if constexpr (AF == 2) mma_k8(d, a, b[0]);
    else mma_bf16(d, a, b[0], b[1]);
}

// Two 8x8 b16 matrices (lanes 0-15 give the row addresses), plain and transposed.
__device__ __forceinline__ void ldsm2(uint32_t (&r)[2], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(addr));
}

__device__ __forceinline__ void ldsm2_trans(uint32_t (&r)[2], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(addr));
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// p[0..1] = (a, b) rounded to T
__device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Bit r: slot t0 + r is valid (and below C), r < TS.
template <int TS>
__device__ __forceinline__ uint64_t stage_mask(const uint8_t* mb, int64_t msc, int t0, int C,
                                               int lane) {
    const bool v0 = t0 + lane < C && mb[(int64_t)(t0 + lane) * msc] != 0;
    uint64_t m = __ballot_sync(0xffffffffu, v0);
    if constexpr (TS > 32) {
        const bool v1 = t0 + 32 + lane < C && mb[(int64_t)(t0 + 32 + lane) * msc] != 0;
        m |= (uint64_t)__ballot_sync(0xffffffffu, v1) << 32;
    }
    return m;
}

// The stage's K and V rows [t0, t0 + TS) -> shared bf16 tiles by cp.async,
// 16 bytes a copy; a row whose mask bit is 0 and columns at or past dh are
// zero-filled and not read.  The caller commits the group.
template <int DHP, int TS, int NT>
__device__ __forceinline__ void issue_stage(bf16* kt, bf16* vt, const bf16* kb, const bf16* vb,
                                            int64_t ksc, int64_t vsc, int t0, uint64_t m,
                                            int dh, int tid) {
    constexpr int CPR = DHP / 8, LDS = bf16_lds<DHP>();
#pragma unroll
    for (int j = 0; j < TS * CPR / NT; ++j) {
        const int i = tid + j * NT, r = i / CPR, c = (i % CPR) * 8;
        const bool ok = ((m >> r) & 1) && c < dh;
        cp_async16(smem_addr(kt + r * LDS + c), ok ? kb + (int64_t)(t0 + r) * ksc + c : kb, ok);
        cp_async16(smem_addr(vt + r * LDS + c), ok ? vb + (int64_t)(t0 + r) * vsc + c : vb, ok);
    }
}

// Four f32 -> bf16 hi and lo parts at dst[0] and dst[off] (two 8-byte stores)
__device__ __forceinline__ void put_split4(bf16* dst, int off, float4 x) {
    uint2 hi, lo;
    split_bf16(x.x, x.y, hi.x, lo.x);
    split_bf16(x.z, x.w, hi.y, lo.y);
    *reinterpret_cast<uint2*>(dst) = hi;
    *reinterpret_cast<uint2*>(dst + off) = lo;
}

// f32 inputs: the stage's K and V rows -> bf16 hi and lo tiles (lo `off`
// elements after hi), loaded synchronously; masked rows are zeros.
template <int DHP, int TS, int NT>
__device__ __forceinline__ void load_stage_f32(bf16* kt, bf16* vt, int off, const float* kb,
                                               const float* vb, int64_t ksc, int64_t vsc,
                                               int t0, uint64_t m, int dh, int tid) {
    constexpr int CPR = DHP / 4, LDS = bf16_lds<DHP>();
#pragma unroll 4
    for (int j = 0; j < TS * CPR / NT; ++j) {
        const int i = tid + j * NT, r = i / CPR, c = (i % CPR) * 4;
        const bool ok = ((m >> r) & 1) && c < dh;
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        put_split4(kt + r * LDS + c, off, ok ? load4(kb + (int64_t)(t0 + r) * ksc + c) : z);
        put_split4(vt + r * LDS + c, off, ok ? load4(vb + (int64_t)(t0 + r) * vsc + c) : z);
    }
}

// Rows [0, RP) of the group's query heads (or their cotangents) -> the shared
// tile(s) `dst` (hi, and lo `off` elements on in f32); heads past rep and
// columns past dh are zeros.
template <typename T, int DHP, int RP, int NT>
__device__ __forceinline__ void stage_heads(bf16* dst, int off, const T* src, int64_t sh,
                                            int rep, int dh, int tid) {
    constexpr int LDS = bf16_lds<DHP>();
    if constexpr (sizeof(T) == 2) {
        for (int i = tid; i < RP * DHP / 8; i += NT) {
            const int r = i / (DHP / 8), c = (i % (DHP / 8)) * 8;
            uint4 u = make_uint4(0u, 0u, 0u, 0u);
            if (r < rep && c < dh) u = *reinterpret_cast<const uint4*>(src + r * sh + c);
            *reinterpret_cast<uint4*>(dst + r * LDS + c) = u;
        }
    } else {
        for (int i = tid; i < RP * DHP / 4; i += NT) {
            const int r = i / (DHP / 4), c = (i % (DHP / 4)) * 4;
            float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
            if (r < rep && c < dh) x = load4(src + r * sh + c);
            put_split4(dst + r * LDS + c, off, x);
        }
    }
}

// d += (hi + lo) b over the heads, hi and lo the A fragments of one operand:
// at 8 heads one m16n8k16 with hi and lo side by side on its k side (B
// repeated), at 16 two.
template <int AF>
__device__ __forceinline__ void mma_heads2(float (&d)[4], const uint32_t (&hi)[AF],
                                           const uint32_t (&lo)[AF], const uint32_t (&b)[2]) {
    if constexpr (AF == 2) {
        const uint32_t a[4] = {hi[0], hi[1], lo[0], lo[1]};
        mma_bf16(d, a, b[0], b[0]);
    } else {
        mma_bf16(d, hi, b[0], b[1]);
        mma_bf16(d, lo, b[0], b[1]);
    }
}

// X = mul (A_hi + A_lo) B of the warp's 16 slots over the heads, B = dO or Q
// ([RP][DHP] tiles at b_a, hi then lo in f32), 32 dims at a time.  bf16: X
// into the warp's rows of the tile `own`; f32: X straight to memory (rows
// t0 + row0 .. of `out`, slot stride `osc`), slots past C left out.
template <typename T, int DHP, int RP, int NP, int TS>
__device__ __forceinline__ void slot_product(const uint32_t (&af)[2][RP == 8 ? 2 : 4],
                                             uint32_t b_a, uint32_t off_bt, int htile,
                                             float mul, bf16* own, T* out, int64_t osc, int t0,
                                             int row0, int C, int dh, int gq, int tq) {
    constexpr int AF = RP == 8 ? 2 : 4, LDS = bf16_lds<DHP>();
#pragma unroll
    for (int ch = 0; ch < DHP / 32; ++ch) {
        float cx[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) cx[i][e] = 0.f;
#pragma unroll
        for (int pb = 0; pb < NP; ++pb) {
            uint32_t bx[4][2];
            const uint32_t o = b_a + pb * htile * 2 + off_bt + ch * 64;
            if constexpr (RP == 8) {
                uint32_t r[4];
                ldsm4_trans(r, o);
#pragma unroll
                for (int i = 0; i < 4; ++i) bx[i][0] = r[i], bx[i][1] = 0u;
            } else {
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    uint32_t r[4];
                    ldsm4_trans(r, o + 32 * u);
                    bx[2 * u][0] = r[0], bx[2 * u][1] = r[1];
                    bx[2 * u + 1][0] = r[2], bx[2 * u + 1][1] = r[3];
                }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                if (pb == 0) mma_heads2<AF>(cx[i], af[0], af[1], bx[i]);
                else mma_heads<AF>(cx[i], af[0], bx[i]);  // f32: A_hi B_lo
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int d = ch * 32 + 8 * i + 2 * tq;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const float x0 = mul * cx[i][2 * hf], x1 = mul * cx[i][2 * hf + 1];
                const int r = row0 + gq + 8 * hf;
                if constexpr (NP == 1) {
                    *reinterpret_cast<__nv_bfloat162*>(own + r * LDS + d) =
                        __floats2bfloat162_rn(x0, x1);
                } else if (d < dh && t0 + r < C) {
                    store2(out + (int64_t)(t0 + r) * osc + d, x0, x1);
                }
            }
        }
    }
}

// The warp's 16 rows of a bf16 tile to rows t0 + row0 .. of `out` (slot
// stride `osc`), 16 bytes a lane; slots past C and columns past dh left out.
template <int DHP>
__device__ __forceinline__ void rows_out(const bf16* tile, bf16* out, int64_t osc, int t0,
                                         int row0, int C, int dh, int lane) {
    constexpr int CPR = DHP / 8, LDS = bf16_lds<DHP>();
#pragma unroll
    for (int j = 0; j < 16 * CPR / 32; ++j) {
        const int i = lane + 32 * j, r = row0 + i / CPR, c = (i % CPR) * 8;
        if (t0 + r < C && c < dh)
            *reinterpret_cast<uint4*>(out + (int64_t)(t0 + r) * osc + c) =
                *reinterpret_cast<const uint4*>(tile + r * LDS + c);
    }
}

// One block: the slots [split * sidx, + split) of kv head g of batch b.  dK
// and dV of those slots, and the split's dq partial dq_p[b, g, sidx, r, :]
// (f32, unscaled).  lse [B, H] and o32 [B, H, dh] are contiguous f32.
template <typename T, int DHP, int RP>
__global__ void __launch_bounds__(32 * warps_for(DHP), 1)
decode_bwd_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                  const uint8_t* __restrict__ valid, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ o32,
                  T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dq_p, int C,
                  int KV, int rep, int dh, int split, int nsplit, int64_t qsb, int64_t qsh,
                  int64_t ksb, int64_t ksc, int64_t ksh, int64_t vsb, int64_t vsc, int64_t vsh,
                  int64_t msb, int64_t msc, int64_t dsb, int64_t dsh, int64_t dksb,
                  int64_t dksc, int64_t dksh, int64_t dvsb, int64_t dvsc, int64_t dvsh,
                  float scale) {
    constexpr int NW = warps_for(DHP), NT = 32 * NW, TS = 16 * NW;
    constexpr int NP = parts<T>(), S = ring_stages<T, DHP, RP>();
    constexpr int LDS = bf16_lds<DHP>(), RS = RP == 8 ? 8 : 24;
    constexpr int KS = DHP / 16;         // k-steps of S and dP
    constexpr int NTH = RP / 8;          // n-tiles of heads
    constexpr int AF = RP == 8 ? 2 : 4;  // A-fragment registers over the heads
    constexpr int DW = DHP / NW;         // dims of dq a warp sums
    constexpr int MT = DW / 16;          // its m-tiles
    constexpr int TILE = TS * LDS;       // elements of one K or V part tile
    constexpr int HTILE = RP * LDS;      // of one Q or dO part tile
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* kv = reinterpret_cast<bf16*>(smem_raw);   // [S][K, V][NP] tiles
    bf16* qs = kv + S * 2 * NP * TILE;              // [NP] tiles
    bf16* dos = qs + NP * HTILE;                    // [NP] tiles
    bf16* dss = dos + NP * HTILE;                   // dS hi, then lo [TS][RS]
    float* lse_s = reinterpret_cast<float*>(dss + 2 * TS * RS);
    float* dl_s = lse_s + RP;
    uint64_t* mask_s = reinterpret_cast<uint64_t*>(dl_s + RP);  // a stage's valid slots

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2, tq = lane & 3, row0 = warp * 16;
    const int sidx = blockIdx.x, g = blockIdx.y, b = blockIdx.z, H = KV * rep;
    const int s0 = sidx * split, nst = (min(split, C - s0) + TS - 1) / TS;
    const T* kb = kc + b * ksb + g * ksh;
    const T* vb = vc + b * vsb + g * vsh;
    T* dkb = dk + b * dksb + g * dksh;
    T* dvb = dv + b * dvsb + g * dvsh;

    // every stage's mask first, so that no copy waits on a load of the mask
    for (int st = warp; st < nst; st += NW) {
        const uint64_t m = stage_mask<TS>(valid + b * msb, msc, s0 + st * TS, C, lane);
        if (lane == 0) mask_s[st] = m;
    }
    __syncthreads();
    if constexpr (NP == 1) {  // the first S - 1 stages' copies fly while the heads are staged
#pragma unroll
        for (int st = 0; st < S - 1; ++st) {
            if (st < nst && mask_s[st])
                issue_stage<DHP, TS, NT>(kv + st * 2 * TILE, kv + st * 2 * TILE + TILE, kb, vb,
                                         ksc, vsc, s0 + st * TS, mask_s[st], dh, tid);
            cp_async_commit();
        }
    }
    stage_heads<T, DHP, RP, NT>(qs, HTILE, q + b * qsb + g * rep * qsh, qsh, rep, dh, tid);
    stage_heads<T, DHP, RP, NT>(dos, HTILE, dout + b * dsb + g * rep * dsh, dsh, rep, dh, tid);
    for (int r = warp; r < RP; r += NW) {  // delta = do . o in f32, lane sums then a tree
        const int64_t h = (int64_t)b * H + g * rep + r;
        float a = 0.f;
        if (r < rep) {
#pragma unroll 8
            for (int d = lane; d < dh; d += 32)
                a = fmaf(to_f32(dout[b * dsb + (g * rep + r) * dsh + d]), o32[h * dh + d], a);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
        if (lane == 0) {
            dl_s[r] = r < rep ? a : 0.f;
            lse_s[r] = r < rep ? lse[h] : 0.f;
        }
    }

    // this lane's ldmatrix offsets, in bytes: A of its warp's 16 rows of a
    // K or V tile; B of the heads (Q, dO rows); B over the heads transposed
    // (dO, Q as k x dims); A = K^T (dims x slots) of its dq dims; B = dS^T
    const uint32_t off_a = ((row0 + lane % 16) * LDS + 8 * (lane / 16)) * 2;
    const uint32_t off_b =
        ((lane % 8 + (NTH == 2 ? 8 * (lane / 16) : 0)) * LDS + 8 * ((lane / 8) % 2)) * 2;
    const uint32_t off_bt = RP == 8 ? ((lane % 8) * LDS + 8 * (lane / 8)) * 2
                                    : ((lane % 8 + 8 * ((lane / 8) % 2)) * LDS + 8 * (lane / 16)) * 2;
    const uint32_t off_at =
        ((lane % 8 + 8 * (lane / 16)) * LDS + warp * DW + 8 * ((lane / 8) % 2)) * 2;
    const uint32_t off_dt = ((lane % 8 + 8 * ((lane / 8) % 2)) * RS + 8 * (lane / 16)) * 2;
    const uint32_t q_a = smem_addr(qs), do_a = smem_addr(dos), ds_a = smem_addr(dss);

    float dq[MT][NTH][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NTH; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) dq[i][j][e] = 0.f;

    for (int st = 0; st < nst; ++st) {
        const int t0 = s0 + st * TS;
        const uint64_t mcur = mask_s[st];
        bf16* kt = kv + (st % S) * 2 * NP * TILE;
        bf16* vt = kt + NP * TILE;
        if constexpr (NP == 1) {
            cp_async_wait<S - 2>();  // this stage's copies are done
        } else {
            __syncthreads();  // every warp is done with the previous stage's tiles
            if (mcur)
                load_stage_f32<DHP, TS, NT>(kt, vt, TILE, reinterpret_cast<const float*>(kb),
                                            reinterpret_cast<const float*>(vb), ksc, vsc, t0,
                                            mcur, dh, tid);
        }
        __syncthreads();  // the stage is in; every warp is done with the previous one
        if constexpr (NP == 1) {  // its slot takes stage st + S - 1
            const int sn = st + S - 1;
            if (sn < nst && mask_s[sn]) {
                bf16* kn = kv + (sn % S) * 2 * TILE;
                issue_stage<DHP, TS, NT>(kn, kn + TILE, kb, vb, ksc, vsc, t0 + (S - 1) * TS,
                                         mask_s[sn], dh, tid);
            }
            cp_async_commit();
        }
        if (mcur == 0) {  // block-uniform: nothing valid, dK and dV are zeros
            for (int i = lane; i < 16 * (dh / 2); i += 32) {
                const int c = t0 + row0 + i / (dh / 2), d = 2 * (i % (dh / 2));
                if (c < C) {
                    store2(dkb + (int64_t)c * dksc + d, 0.f, 0.f);
                    store2(dvb + (int64_t)c * dvsc + d, 0.f, 0.f);
                }
            }
            continue;
        }
        const uint32_t k_a = smem_addr(kt), v_a = smem_addr(vt);

        // S^T = K Q^T and dP^T = V dO^T of the warp's 16 slots, over dh
        float cs[NTH][4], cdp[NTH][4];
#pragma unroll
        for (int j = 0; j < NTH; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) cs[j][e] = cdp[j][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
            uint32_t ak[NP][4], av[NP][4], bq[NP][NTH][2], bo[NP][NTH][2];
#pragma unroll
            for (int p = 0; p < NP; ++p) {
                ldsm4(ak[p], k_a + p * TILE * 2 + off_a + 32 * ks);
                ldsm4(av[p], v_a + p * TILE * 2 + off_a + 32 * ks);
                if constexpr (NTH == 2) {
                    uint32_t r[4];
                    ldsm4(r, q_a + p * HTILE * 2 + off_b + 32 * ks);
                    bq[p][0][0] = r[0], bq[p][0][1] = r[1], bq[p][1][0] = r[2], bq[p][1][1] = r[3];
                    ldsm4(r, do_a + p * HTILE * 2 + off_b + 32 * ks);
                    bo[p][0][0] = r[0], bo[p][0][1] = r[1], bo[p][1][0] = r[2], bo[p][1][1] = r[3];
                } else {
                    ldsm2(bq[p][0], q_a + p * HTILE * 2 + off_b + 32 * ks);
                    ldsm2(bo[p][0], do_a + p * HTILE * 2 + off_b + 32 * ks);
                }
            }
#pragma unroll
            for (int pa = 0; pa < NP; ++pa)
#pragma unroll
                for (int pb = 0; pb < NP; ++pb) {
                    if (pa + pb > 1) continue;  // lo x lo is below the f32 rounding
#pragma unroll
                    for (int j = 0; j < NTH; ++j) {
                        mma_bf16(cs[j], ak[pa], bq[pb][j][0], bq[pb][j][1]);
                        mma_bf16(cdp[j], av[pa], bo[pb][j][0], bo[pb][j][1]);
                    }
                }
        }

        // P and dS in the accumulators (slot gq + 8 (e / 2), head 8 j + 2 tq + e % 2),
        // then as A fragments over the heads, each a bf16 hi + lo pair
        float p[NTH][4], ds[NTH][4];
#pragma unroll
        for (int j = 0; j < NTH; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = gq + 8 * (e >> 1), h = 8 * j + 2 * tq + (e & 1);
                const bool ok = ((mcur >> (row0 + r)) & 1) && h < rep;
                const float pv = ok ? expf(cs[j][e] * scale - lse_s[h]) : 0.f;
                p[j][e] = pv;
                ds[j][e] = pv * (cdp[j][e] - dl_s[h]);
            }
        uint32_t pf[2][AF], dsf[2][AF];
#pragma unroll
        for (int f = 0; f < AF; ++f) {
            const int j = f / 2, e = (f % 2) * 2;
            split_bf16(p[j][e], p[j][e + 1], pf[0][f], pf[1][f]);
            split_bf16(ds[j][e], ds[j][e + 1], dsf[0][f], dsf[1][f]);
            const int r = row0 + gq + 8 * (f % 2), c = 2 * tq + 8 * (f / 2);
            *reinterpret_cast<uint32_t*>(dss + r * RS + c) = dsf[0][f];
            *reinterpret_cast<uint32_t*>(dss + TS * RS + r * RS + c) = dsf[1][f];
        }

        // dV = P^T dO of the warp's slots, 32 dims at a time: bf16 into the
        // warp's own rows of the V tile (only it reads them), f32 to memory
        __syncwarp();
        slot_product<T, DHP, RP, NP, TS>(pf, do_a, off_bt, HTILE, 1.f, vt, dvb, dvsc, t0, row0,
                                         C, dh, gq, tq);
        __syncthreads();  // every warp's dS of the stage is in dss

        // dq^T += K^T dS^T over the stage's slots, this warp's DW dims
#pragma unroll
        for (int kk = 0; kk < NW; ++kk) {
            uint32_t bd[2][NTH][2];
#pragma unroll
            for (int pb = 0; pb < 2; ++pb) {
                const uint32_t a = ds_a + pb * TS * RS * 2 + off_dt + kk * 16 * RS * 2;
                if constexpr (NTH == 2) {
                    uint32_t r[4];
                    ldsm4_trans(r, a);
                    bd[pb][0][0] = r[0], bd[pb][0][1] = r[1], bd[pb][1][0] = r[2], bd[pb][1][1] = r[3];
                } else {
                    ldsm2_trans(bd[pb][0], a);
                }
            }
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                uint32_t ak[NP][4];
#pragma unroll
                for (int pa = 0; pa < NP; ++pa)
                    ldsm4_trans(ak[pa], k_a + pa * TILE * 2 + off_at + kk * 16 * LDS * 2 + 32 * i);
#pragma unroll
                for (int pa = 0; pa < NP; ++pa)
#pragma unroll
                    for (int pb = 0; pb < 2; ++pb) {
                        if (pa + pb > 1) continue;
#pragma unroll
                        for (int j = 0; j < NTH; ++j)
                            mma_bf16(dq[i][j], ak[pa], bd[pb][j][0], bd[pb][j][1]);
                    }
            }
        }

        // dK = scale dS^T Q: bf16 into the warp's own rows of the K tile once
        // every warp is done reading it, then both tiles' rows to memory
        if constexpr (NP == 1) __syncthreads();
        slot_product<T, DHP, RP, NP, TS>(dsf, q_a, off_bt, HTILE, scale, kt, dkb, dksc, t0, row0,
                                         C, dh, gq, tq);
        if constexpr (NP == 1) {
            __syncwarp();
            rows_out<DHP>(vt, dvb, dvsc, t0, row0, C, dh, lane);
            rows_out<DHP>(kt, dkb, dksc, t0, row0, C, dh, lane);
        }
    }

    // the split's dq partial: dim warp * DW + 16 i + gq + 8 (e / 2), head 8 j + 2 tq + e % 2
    const int64_t part = ((int64_t)(b * KV + g) * nsplit + sidx) * rep;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NTH; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int d = warp * DW + 16 * i + gq + 8 * (e >> 1), h = 8 * j + 2 * tq + (e & 1);
                if (h < rep && d < dh) dq_p[(part + h) * dh + d] = dq[i][j][e];
            }
}

// dq[b, 0, g * rep + r, :] = scale * the splits' partials summed in split order
template <typename T>
__global__ void decode_bwd_dq_kernel(const float* __restrict__ dq_p, T* __restrict__ dq,
                                     int rep, int dh, int nsplit, int64_t osb, int64_t osh,
                                     float scale) {
    const int r = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
    const int64_t base = (int64_t)(b * gridDim.y + g) * nsplit;
    T* orow = dq + b * osb + (g * rep + r) * osh;
    for (int d = threadIdx.x; d < dh; d += blockDim.x) {
        float a = 0.f;
#pragma unroll 16
        for (int s = 0; s < nsplit; ++s) a += dq_p[((base + s) * rep + r) * dh + d];
        store1(orow + d, a * scale);
    }
}

struct Args {
    const void *q, *kc, *vc, *valid, *dout;
    const float *lse, *o32;
    void *dq, *dk, *dv;
    float* dq_p;
    int B, C, H, KV, dh;
    const int64_t* st;  // q (b, h), k (b, c, h), v (b, c, h), valid (b, c), do (b, h),
                        // dq (b, h), dk (b, c, h), dv (b, c, h)
    float scale;
};

template <typename T, int DHP, int RP>
cudaError_t launch_r(const Args& a, cudaStream_t stream) {
    const int rep = a.H / a.KV;
    const int split = split_for(a.B, a.C, a.KV, a.dh), nsplit = (a.C + split - 1) / split;
    constexpr int smem = smem_bytes<T, DHP, RP>();
    const int64_t* st = a.st;
    cudaError_t err = cudaFuncSetAttribute(decode_bwd_kernel<T, DHP, RP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    decode_bwd_kernel<T, DHP, RP><<<dim3(nsplit, a.KV, a.B), 32 * warps_for(DHP), smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.kc), static_cast<const T*>(a.vc),
        static_cast<const uint8_t*>(a.valid), static_cast<const T*>(a.dout), a.lse, a.o32,
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.dq_p, a.C, a.KV, rep, a.dh, split,
        nsplit, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
        st[11], st[14], st[15], st[16], st[17], st[18], st[19], a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    decode_bwd_dq_kernel<T><<<dim3(rep, a.KV, a.B), a.dh <= 128 ? 128 : 256, 0, stream>>>(
        a.dq_p, static_cast<T*>(a.dq), rep, a.dh, nsplit, st[12], st[13], a.scale);
    return cudaGetLastError();
}

template <typename T, int DHP>
cudaError_t launch(const Args& a, cudaStream_t s) {
    return a.H / a.KV <= 8 ? launch_r<T, DHP, 8>(a, s) : launch_r<T, DHP, 16>(a, s);
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

// q, do, dq [B,1,H,dh]; k, v, dk, dv [B,C,KV,dh]; valid [B,C] uint8; lse
// [B,H] and o32 [B,H,dh] (the forward's residuals) contiguous f32.  Strides
// in elements, 20 of them in `st`: q (batch, head), k and v (batch, slot,
// head), valid (batch, slot), do (batch, head), dq (batch, head), dk and dv
// (batch, slot, head); the head dim is unit-stride and every row starts on a
// 16-byte boundary; dh is a multiple of 8 (bf16) or 4 (f32), at most 256;
// H / KV at most 16.  dq_p [B,KV,nsplit,rep,dh] is f32 scratch with nsplit =
// repro_decode_bwd_num_splits(B, C, KV, dh).  dtype: 0 = f32, 1 = bf16.
// device is the CUDA ordinal of the tensors and the stream.
extern "C" int repro_decode_attention_bwd(
        const void* q, const void* kc, const void* vc, const void* valid, const void* dout,
        const void* lse, const void* o32, void* dq, void* dk, void* dv, void* dq_p, int dtype,
        int B, int C, int H, int KV, int dh, const int64_t* st, float scale, int device,
        void* stream) {
    if (dh <= 0 || dh > REPRO_MAX_HEAD_DIM || dh % 4 || KV <= 0 || H % KV ||
        H / KV > MAXREP || C <= 0 || (dtype == REPRO_BF16 && dh % 8))
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaSuccess;
    cudaError_t err = cudaSetDevice(device);  // this library's runtime keeps its own
    if (err != cudaSuccess) return (int)err;
    const Args a = {q, kc, vc, valid, dout, static_cast<const float*>(lse),
                    static_cast<const float*>(o32), dq, dk, dv, static_cast<float*>(dq_p),
                    B, C, H, KV, dh, st, scale};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == REPRO_F32) return (int)launch_dh<float>(a, s);
    if (dtype == REPRO_BF16) return (int)launch_dh<bf16>(a, s);
    return (int)cudaErrorInvalidValue;
}

// Cache slots a block of the kernel takes at this shape (`split_for`).
extern "C" int repro_decode_bwd_split(int B, int C, int KV, int dh) {
    return split_for(B, C, KV, dh);
}

extern "C" int repro_decode_bwd_num_splits(int B, int C, int KV, int dh) {
    const int split = split_for(B, C, KV, dh);
    return (C + split - 1) / split;
}

// Most query heads per kv head the kernel takes.
extern "C" int repro_decode_bwd_max_rep() { return MAXREP; }

// Dynamic shared memory of one block, in bytes (dtype 0 = f32, 1 = bf16).
extern "C" int repro_decode_bwd_smem_bytes(int dtype, int rep, int dh) {
    const bool wide = rep > 8;
    const int t = head_dim_tile(dh);
#define REPRO_SMEM(T) \
    (t == 64 ? (wide ? smem_bytes<T, 64, 16>() : smem_bytes<T, 64, 8>()) \
     : t == 128 ? (wide ? smem_bytes<T, 128, 16>() : smem_bytes<T, 128, 8>()) \
                : (wide ? smem_bytes<T, 256, 16>() : smem_bytes<T, 256, 8>()))
    return dtype == REPRO_F32 ? REPRO_SMEM(float) : REPRO_SMEM(bf16);
#undef REPRO_SMEM
}
