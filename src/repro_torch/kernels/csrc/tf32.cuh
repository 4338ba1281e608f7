// The f32 building blocks of the SSD scan's gradient (ssd_scan_bwd.cu):
// cp.async loaders of f32 tiles into padded shared memory, and matrix
// products on the TF32 tensor cores in 3xTF32 (mma.sync m16n8k8, each f32
// operand split into a TF32 high and low part).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

__device__ __forceinline__ void zero_smem(float* p, int n) {
    for (int i = threadIdx.x * 4; i < n; i += blockDim.x * 4)
        *reinterpret_cast<float4*>(p + i) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Rows [0, ROWS) of a tile of `cols` floats a row from global rows at
// `src`, `ld` floats apart, into shared rows `lds` floats apart; rows >=
// `valid` are zero-filled.  Columns >= cols are left as they are (zero).
template <int ROWS>
__device__ __forceinline__ void load_tile(float* dst, int lds, const float* src, int64_t ld,
                                          int valid, int cols, bool vec) {
    if (vec) {
        const int per = cols >> 2;
        for (int i = threadIdx.x; i < ROWS * per; i += blockDim.x) {
            const int r = i / per, c = (i - r * per) * 4;
            const bool ok = r < valid;
            cp_async16(smem_addr(dst + r * lds + c), ok ? src + r * ld + c : src, ok);
        }
    } else {
        for (int i = threadIdx.x; i < ROWS * cols; i += blockDim.x) {
            const int r = i / cols, c = i - r * cols;
            const bool ok = r < valid;
            cp_async4(smem_addr(dst + r * lds + c), ok ? src + r * ld + c : src, ok);
        }
    }
}

// load_tile for COLS columns (a multiple of 4), 16-byte copies and NTH
// threads, all known to the compiler: no division in the address of a copy.
template <int ROWS, int COLS, int NTH>
__device__ __forceinline__ void load_rows(float* dst, int lds, const float* src, int64_t ld,
                                          int valid) {
    constexpr int PER = COLS / 4;
    static_assert(ROWS * PER % NTH == 0, "whole rounds of copies");
#pragma unroll
    for (int k = 0; k < ROWS * PER / NTH; ++k) {
        const int i = threadIdx.x + k * NTH, r = i / PER, c = (i % PER) * 4;
        const bool ok = r < valid;
        cp_async16(smem_addr(dst + r * lds + c), ok ? src + r * ld + c : src, ok);
    }
}

// `n` floats (a multiple of 4, 16-byte aligned at both ends) global -> shared.
__device__ __forceinline__ void load_flat(float* dst, const float* src, int n) {
    for (int i = threadIdx.x * 4; i < n; i += blockDim.x * 4)
        cp_async16(smem_addr(dst + i), src + i, true);
}

// The whole ROWS x COLS tile at `dst` (rows `lds` floats apart) from global
// rows `ld` floats apart: element (r, c) is src[r * ld + c] where r < valid
// and c < cols, and zero elsewhere, so a tile that held something else
// needs no clearing first.  16-byte copies where `vec` (cols a multiple of
// 4, every row 16-byte aligned), else 4-byte; NTH threads.  The caller
// commits the group.
template <int ROWS, int COLS, int NTH>
__device__ __forceinline__ void load_tile_zf(float* dst, int lds, const float* src, int64_t ld,
                                             int valid, int cols, bool vec) {
    if (vec) {
        constexpr int PER = COLS / 4;
#pragma unroll 4
        for (int i = threadIdx.x; i < ROWS * PER; i += NTH) {
            const int r = i / PER, c = (i % PER) * 4;
            const bool ok = r < valid && c < cols;
            cp_async16(smem_addr(dst + r * lds + c), ok ? src + r * ld + c : src, ok);
        }
    } else {
        for (int i = threadIdx.x; i < ROWS * COLS; i += NTH) {
            const int r = i / COLS, c = i % COLS;
            const bool ok = r < valid && c < cols;
            cp_async4(smem_addr(dst + r * lds + c), ok ? src + r * ld + c : src, ok);
        }
    }
}

// ---- 3xTF32 products on the tensor cores ----

// An operand fragment split into TF32 high and low parts (`tf32_split`).
template <int K>
struct Frag {
    uint32_t hi[K], lo[K];
    __device__ __forceinline__ void set(int i, float x) { tf32_split(x, hi[i], lo[i]); }
    __device__ __forceinline__ void set2(int i, int j, float2 v) {
        set(i, v.x);
        set(j, v.y);
    }
};

__device__ __forceinline__ float2 ld2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b for a 16x8 A fragment and an 8x8 B fragment, small terms first.
// With g = lane / 4 and t = lane % 4: A holds (row, k) (g, t), (g+8, t),
// (g, t+4), (g+8, t+4); B holds (k, col) (t, g), (t+4, g); d holds (g, 2t),
// (g, 2t+1), (g+8, 2t), (g+8, 2t+1).  A sum over k may take its terms in
// any order, so a product may give the fragment's k = t and t + 4 the
// tile's k = 2t and 2t + 1 ("paired" below): one 8-byte load where the
// tile's rows run along k.  Both operands of one product take the same
// order.
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4>& a, const Frag<2>& b) {
    mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
    mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
    mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}
