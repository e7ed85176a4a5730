// The 3xTF32 pieces of the float32 tensor-core kernels (conv.cu,
// tapconv_tf32.cu, transforms.cu): a float32 x split into a TF32 big part rna(x) and a
// TF32 small part rna(x - big) (round to nearest, ties away, 10-bit
// mantissa), and mma.sync m16n8k8 with TF32 operands and float32 sums.
// A product is small*big + big*small + big*big, the small*small term
// dropped (CUTLASS's "3xTF32"): about 2^-21 relative against 2^-11 for one
// TF32 pass.

#pragma once

#include <cstdint>

#include "convio.cuh"  // CHAIN, ldsm_x4

namespace {

constexpr int FRAG = 128;  // floats of one packed, split B fragment: 32 lanes x 4
constexpr int TAPS_CHAINED = CHAIN / 3;  // taps in one tensor-core chain (3 mma a tap)
static_assert(TAPS_CHAINED >= 1, "a chain holds one tap's three products");

__device__ __forceinline__ uint32_t tf32_rna(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

// an A fragment (float32 bits) as its TF32 big and small parts
__device__ __forceinline__ void split_tf32(const uint32_t (&a)[4], uint32_t (&big)[4],
                                           uint32_t (&small)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float f = __uint_as_float(a[i]);
        big[i] = tf32_rna(f);
        small[i] = tf32_rna(f - __uint_as_float(big[i]));
    }
}

// c += a (16x8, row) * b (8x8, col), TF32 operands, float32 sums
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a * b: the first product of a chain
__device__ __forceinline__ void mma_tf32_first(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

// The A fragment of one k8 step at this lane's ldmatrix row address p
// (lanes 0-15: rows 0-15, columns 0-3; lanes 16-31: the same rows,
// columns 4-7; a float32 is two b16 values of one row, so the b16 layout
// hands each thread the TF32 fragment's element), split into its TF32
// parts
__device__ __forceinline__ void load_split(const float* p, uint32_t (&big)[4],
                                           uint32_t (&small)[4]) {
    uint32_t a[4];
    ldsm_x4(a, reinterpret_cast<const bf16*>(p));
    split_tf32(a, big, small);
}

// One tap's products for a warp's RW output rows (row r from its split
// window row big[r], small[r]): per n8 tile the lane's split B fragment
// (big b0, big b1, small b0, small b1; b: this lane's at tile 0, tiles
// FRAG floats apart) and small*big + big*small + big*big into part, FIRST
// starting a chain.
template <int NT, int RW, bool FIRST>
__device__ __forceinline__ void row_products(float (&part)[RW][NT][4], const uint32_t (&big)[RW][4],
                                             const uint32_t (&small)[RW][4], const float* b) {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
        const uint4 v = *reinterpret_cast<const uint4*>(b + t * FRAG);
#pragma unroll
        for (int r = 0; r < RW; ++r) {
            if (FIRST)
                mma_tf32_first(part[r][t], small[r], v.x, v.y);
            else
                mma_tf32(part[r][t], small[r], v.x, v.y);
        }
#pragma unroll
        for (int r = 0; r < RW; ++r) mma_tf32(part[r][t], big[r], v.z, v.w);
#pragma unroll
        for (int r = 0; r < RW; ++r) mma_tf32(part[r][t], big[r], v.x, v.y);
    }
}

}  // namespace
