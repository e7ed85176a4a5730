// Helpers of the closure's conv kernels (conv.cu, tapconv.cu): widening
// loads of float32 or bf16 operands, and the fixed-order sum of the
// weight-gradient kernels' block partials (no atomics: the same result on
// every run).

#pragma once

#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float load_val(const void* p, size_t i, int bf16) {
    return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                : static_cast<const float*>(p)[i];
}

template <int COT>
__device__ __forceinline__ void load_vec(const float* s, float (&v)[COT]) {
#pragma unroll
    for (int o = 0; o < COT; o += 4) {
        const float4 q = *reinterpret_cast<const float4*>(s + o);
        v[o] = q.x;
        v[o + 1] = q.y;
        v[o + 2] = q.z;
        v[o + 3] = q.w;
    }
}

// dw[i] = sum over chunks of partial[chunk, i], chunks in order.
__global__ void __launch_bounds__(256)
reduce_partials_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                       int nchunk, size_t nw) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= nw) return;
    float s = 0.0f;
    for (int c = 0; c < nchunk; ++c) s += __ldg(partial + (size_t)c * nw + i);
    dw[i] = s;
}

}  // namespace
