// The 3-pass bf16 pieces of the plane GEMM and the fused pass B
// (transforms.cu, fold.cu) under projection_precision "manualhigh": a
// float32 x split into a bf16 hi part, hi = bf16(x) rounded to nearest
// even, and a bf16 lo part, lo = bf16(x - hi) (x - hi is exact in
// float32), and mma.sync m16n8k16 with bf16 operands and float32 sums.  A
// product is lo*hi + hi*lo + hi*hi, the lo*lo term dropped: the JAX
// package's `_split_bf16` / `_mm_h` and `_split` / `_dot_h`
// (ins_tpu/ops/pallas_kernels.py:73-119, poisson_pallas.py:62-90), about
// 2^-16 relative a product against the 3xTF32 class's 2^-21.
//
// The k order inside a k16 step.  The kernels read their float32 field
// fragments in the 3xTF32 forms' conflict-free patterns: a k8 step's A
// fragment holds columns t and t + 4 of rows g and g + 8, its B fragment
// rows t and t + 4 of column g (lane 4 g + t).  The bf16 m16n8k16
// fragments pair adjacent k: a lane's A register j holds k = 2 t, 2 t + 1
// (j = 0, 1) or 2 t + 8, 2 t + 9 (j = 2, 3), its B registers the same k.
// A sum over k does not depend on which physical k each slot holds as
// long as A and B agree, so slot 2 t + i (+ 8) of a k16 step holds k = t +
// 4 i (+ 8): a k16 step is the two k8 steps' fragments, paired.  The host
// packs the basis in that order (`ops/transforms.py` `pack_basis_a_bf16`,
// `pack_basis_b_bf16`).

#pragma once

#include <cstdint>

#include "convio.cuh"  // bf16, mma_bf16

namespace {

// (x0, x1) as packed bf16 hi and lo parts, x0 in the low half of each
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
}

// c = a * b: the first product of a chain
__device__ __forceinline__ void mma_bf16_first(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

// part (+)= a_lo*b_hi + a_hi*b_lo + a_hi*b_hi over one k16 step, FIRST
// starting a chain; b: (hi b0, hi b1, lo b0, lo b1)
template <bool FIRST>
__device__ __forceinline__ void products_bf16x3(float (&part)[4], const uint32_t (&a_hi)[4],
                                                const uint32_t (&a_lo)[4], const uint32_t (&b)[4]) {
    const uint32_t bh[2] = {b[0], b[1]}, bl[2] = {b[2], b[3]};
    if (FIRST)
        mma_bf16_first(part, a_lo, b[0], b[1]);
    else
        mma_bf16(part, a_lo, bh);
    mma_bf16(part, a_hi, bl);
    mma_bf16(part, a_hi, bh);
}

// An A fragment of one k16 step from the two k8 steps' float32 fragments
// s0, s1 (a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t +
// 4) each), as bf16 hi and lo parts in the paired order above
__device__ __forceinline__ void pair_split_a(const uint32_t (&s0)[4], const uint32_t (&s1)[4],
                                             uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    split_bf16x2(__uint_as_float(s0[0]), __uint_as_float(s0[2]), hi[0], lo[0]);
    split_bf16x2(__uint_as_float(s0[1]), __uint_as_float(s0[3]), hi[1], lo[1]);
    split_bf16x2(__uint_as_float(s1[0]), __uint_as_float(s1[2]), hi[2], lo[2]);
    split_bf16x2(__uint_as_float(s1[1]), __uint_as_float(s1[3]), hi[3], lo[3]);
}

// A B fragment of one k16 step from a column's float32 values at the
// step's rows t, t + 4, t + 8, t + 12 (b: the row t value, rows `pitch`
// floats apart), as (hi b0, hi b1, lo b0, lo b1)
__device__ __forceinline__ void load_split_b(const float* b, int pitch, uint32_t (&f)[4]) {
    split_bf16x2(b[0], b[4 * pitch], f[0], f[2]);
    split_bf16x2(b[8 * pitch], b[12 * pitch], f[1], f[3]);
}

}  // namespace
