// Helpers shared by the kernels: vector loads of four f32 elements, the
// stores back to the input type, 16- and 4-byte asynchronous copies into
// shared memory, the attention kernels' head-dim tiles and mask, and the bf16
// tensor-core building blocks of the attention kernels (ldmatrix, mma.sync
// m16n8k16, the hi + lo split of an f32 operand and of an accumulator into
// the A fragments of the next product).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The finite mask value of the plain versions (-0.7 * FLT_MAX): a block whose
// scores are all masked gives exp(NEG_INF - NEG_INF) = 1, never NaN.
#define REPRO_NEG_INF (-0.7f * 3.402823466e38f)

enum ReproDtype { REPRO_F32 = 0, REPRO_BF16 = 1 };

// The attention kernels' tile widths: a head dim runs zero-padded in the
// narrowest of 64, 128 and 256 that holds it (0: above the largest).
#define REPRO_MAX_HEAD_DIM 256
__host__ __device__ constexpr int head_dim_tile(int dh) {
    return dh <= 64 ? 64 : dh <= 128 ? 128 : dh <= REPRO_MAX_HEAD_DIM ? 256 : 0;
}

// Whether query position qpos sees key under the plain version's mask (key
// < Sk, causal, a window of `window` keys; window <= 0: none), with no
// short-circuit: a select, not a branch, in an unrolled loop.
__device__ __forceinline__ bool visible_sel(int key, int qpos, int Sk, int causal, int window) {
    return (key < Sk) & (!causal | (key <= qpos)) & ((window <= 0) | (key > qpos - window));
}

// Four consecutive f32 elements; the wrapper checks that every row it
// passes starts on a 16-byte boundary.
__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}

// Asynchronous 16-byte copies global -> shared (cp.async, sm_80 and later).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled where !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously; zero-filled where !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// An f32 value split for 3xTF32 products: hi is x with the 13 mantissa bits
// that TF32 lacks cleared (truncated, so within one TF32 ulp of x), lo = x -
// hi (exact in f32), of which the tensor cores read the TF32 bits.  A
// product lo.hi + hi.lo + hi.hi is then within ~2^-20 of the f32 one.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
    hi = __float_as_uint(x) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
}

// ---- bf16 tensor cores (mma.sync.m16n8k16, sm_80 and later) ----

// Padded row stride, in elements, of a bf16 tile DHP wide: rows 16 B apart
// modulo 128 B, so the 8 row addresses of an ldmatrix fall in 8 distinct
// bank groups.
template <int DHP>
__host__ __device__ constexpr int bf16_lds() { return DHP + 8; }

// Four 8x8 b16 matrices from shared memory; lane i gives the address of row
// i % 8 of matrix i / 8.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// The same, each matrix transposed: for B operands whose contraction runs
// over the rows of the tile in shared memory.
__device__ __forceinline__ void ldsm4_trans(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
    return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) = hi + lo with hi = bf16(x) and lo = bf16(x - hi), packed in pairs
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    hi = bf16x2_bits(h);
    lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// The A fragment (16 rows x 16 columns) of columns [16 t, 16 t + 16) of an
// m16n8 accumulator array c[n-tile][4], split into bf16 hi and lo parts:
// the accumulator of one product becomes the A operand of the next.
template <int N>
__device__ __forceinline__ void acc_to_a_split(const float (&c)[N][4], int t, uint32_t (&hi)[4],
                                               uint32_t (&lo)[4]) {
    split_bf16(c[2 * t][0], c[2 * t][1], hi[0], lo[0]);
    split_bf16(c[2 * t][2], c[2 * t][3], hi[1], lo[1]);
    split_bf16(c[2 * t + 1][0], c[2 * t + 1][1], hi[2], lo[2]);
    split_bf16(c[2 * t + 1][2], c[2 * t + 1][3], hi[3], lo[3]);
}
