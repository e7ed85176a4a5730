// Helpers of the closure's conv kernels (conv.cu, the tap layer's
// kernels) and of fold.cu: the fixed-order sum of the weight-gradient
// kernels' block partials (no atomics: the same result on every run), and
// the pieces of the tensor-core kernels: 16-byte cp.async staging into a
// ring of shared buffers, ldmatrix fragment loads and mma.sync m16n8k16
// (bf16 operands, float32 sums).

#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace {

using bf16 = __nv_bfloat16;

// mma chained in the tensor cores before their sum is added to a float32
// accumulator, at most: the tensor cores' float32 sums truncate, and
// chains of at most 8 keep their error at a few float32 ulps
constexpr int CHAIN = 8;

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

// shared-memory pitch (elements) of an (rows, 8*nt) bf16 tile: an odd number
// of 16-byte units, so the 8 rows of an ldmatrix hit distinct banks
__host__ __device__ constexpr int mma_pitch(int nt) { return nt % 2 ? 8 * nt : 8 * nt + 8; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x1_trans(uint32_t& r, const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n"
                 : "=r"(r)
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a (16x8, row) * b (8x8, col): the k8 form, for a contraction's last
// 8 channels
__device__ __forceinline__ void mma_bf16_k8(float (&c)[4], const uint32_t (&a)[2], uint32_t b) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(b));
}

// Stages go through a ring of nbuf (2 or 3) shared-memory buffers: the
// copies of the next nbuf - 1 stages are in flight while one is computed.
// Every step commits one cp.async group (empty past the last stage), so
// waiting for all but the newest nbuf - 1 groups waits for this stage.
__device__ __forceinline__ void ring_wait(int nbuf) {
    if (nbuf == 3)
        cp_async_wait<2>();
    else
        cp_async_wait<1>();
    __syncthreads();
}

// Shared memory of a ring of stages of `stage_elems` bf16 each: three
// buffers where `blocks` blocks of them fit an SM, else two.
inline size_t ring_smem(size_t stage_elems, int blocks, int* nbuf) {
    constexpr size_t SM_BYTES = 227 * 1024;  // an SM's shared memory for blocks
    const size_t stage = sizeof(bf16) * stage_elems;
    *nbuf = 3 * stage * blocks <= SM_BYTES ? 3 : 2;
    return *nbuf * stage;
}

inline cudaError_t set_smem(const void* kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// a channels-last bf16 field the kernels stage 16 bytes a copy
inline bool stageable(const void* p, int c) { return c % 8 == 0 && ((uintptr_t)p & 15) == 0; }

}  // namespace
