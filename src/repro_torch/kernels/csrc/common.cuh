// Helpers shared by the attention kernels: vector loads of four f32
// elements, the stores back to the input type, and 16-byte asynchronous
// copies into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The finite mask value of the plain versions (-0.7 * FLT_MAX): a block whose
// scores are all masked gives exp(NEG_INF - NEG_INF) = 1, never NaN.
#define REPRO_NEG_INF (-0.7f * 3.402823466e38f)

enum ReproDtype { REPRO_F32 = 0, REPRO_BF16 = 1 };

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

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
