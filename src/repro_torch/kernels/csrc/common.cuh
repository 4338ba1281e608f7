// Helpers shared by the attention kernels: vector loads of four elements
// into f32 registers, and the stores back to the input type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The finite mask value of the plain versions (-0.7 * FLT_MAX): a block whose
// scores are all masked gives exp(NEG_INF - NEG_INF) = 1, never NaN.
#define REPRO_NEG_INF (-0.7f * 3.402823466e38f)

enum ReproDtype { REPRO_F32 = 0, REPRO_BF16 = 1 };

// Four consecutive elements; the wrapper checks 16-byte (f32) or 8-byte
// (bf16) alignment of every row it passes.
__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    uint2 u = *reinterpret_cast<const uint2*>(p);
    float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}
