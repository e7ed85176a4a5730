// Staging helpers of the plane-walking stencil kernels (stage.cu, smag.cu,
// channel.cu): 4-byte `cp.async` copies into shared memory (a wrapped halo
// element is one float, so the copies are single elements) and 16-byte
// ones (chunks of four floats, where a plane's rows are a multiple of 4
// long and a window starts on a multiple of 4: no chunk straddles the
// wrap), their commit and wait, the dynamic shared memory of a launch, and
// the per-thread element (or chunk) offsets of a haloed (y, z) window on a
// periodic plane, wrapped once per block so that no staging loop computes
// a `%`.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src));
}

// 16 bytes; dst and src 16-byte aligned
__device__ __forceinline__ void cp_async16f(float* dst, const float* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_commit_group() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// wait for every copy this thread issued (the caller then syncs the block)
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

__device__ __forceinline__ float* dynamic_smem() {
    extern __shared__ float4 dsmem_[];
    return reinterpret_cast<float*>(dsmem_);
}

// The elements e = tid + k * NT (k < K) of a WY x WZ window whose corner
// is (y0, z0) on a periodic n_y x n_z plane: off[k] is the in-plane offset
// y * n_z + z of element e (y, z wrapped), 0 past the window's end.
template <int WY, int WZ, int NT>
struct Window {
    static constexpr int N = WY * WZ;
    static constexpr int K = (N + NT - 1) / NT;
    int off[K];

    __device__ __forceinline__ void init(int tid, int y0, int z0, int ny, int nz) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int e = tid + k * NT;
            const int ly = e / WZ, lz = e - ly * WZ;
            int y = (y0 + ly) % ny, z = (z0 + lz) % nz;
            y += y < 0 ? ny : 0;
            z += z < 0 ? nz : 0;
            off[k] = e < N ? y * nz + z : 0;
        }
    }
};

// The 16-byte chunks c = tid + k * NT (k < K) of a WY x 4 WC window whose
// corner is (y0, z0) on a periodic n_y x n_z plane, n_z % 4 == 0 and z0 %
// 4 == 0: off[k] is the in-plane offset y * n_z + z of chunk c's first
// element (y, z wrapped; chunk c of the window is element 4 c), 0 past the
// window's end.
template <int WY, int WC, int NT>
struct Window4 {
    static constexpr int N = WY * WC;
    static constexpr int K = (N + NT - 1) / NT;
    int off[K];

    __device__ __forceinline__ void init(int tid, int y0, int z0, int ny, int nz) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int e = tid + k * NT;
            const int ly = e / WC, lc = e - ly * WC;
            int y = (y0 + ly) % ny, z = (z0 + 4 * lc) % nz;
            y += y < 0 ? ny : 0;
            z += z < 0 ? nz : 0;
            off[k] = e < N ? y * nz + z : 0;
        }
    }
};

}  // namespace
