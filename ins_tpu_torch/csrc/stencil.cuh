// Periodic staggered-grid helpers shared by the stage, per-op and
// correction kernels (stage.cu, perop.cu, correct.cu, channel.cu): the
// wrap of an index and the correction kernel.
//
// Velocity-like fields may be stored in bf16 (the opt-in stream storage
// of the fast path): `ldg_f` widens a stored value to float (exactly: a
// bf16 holds the high half of a float's bits) and `st_f` stores a float,
// rounding to the nearest even bf16.  All arithmetic is float.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float ldg_f(const float* p, size_t i) { return __ldg(p + i); }
__device__ __forceinline__ float ldg_f(const __nv_bfloat16* p, size_t i) {
    return __uint_as_float(static_cast<unsigned>(
                               __ldg(reinterpret_cast<const unsigned short*>(p) + i))
                           << 16);
}
__device__ __forceinline__ void st_f(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st_f(__nv_bfloat16* p, size_t i, float v) {
    p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int wrap(int v, int n) {
    v %= n;
    return v < 0 ? v + n : v;
}

// u_a(I) = ut_a(I) - (q(I + e_a) - q(I)) / dx_a on a periodic
// (nx, ny, nz) box: one thread per cell, z fastest across a warp (every
// access coalesced; the +e_a neighbours of q come from L1/L2).  Launch
// with blocks of (32, 8) and a grid of (ceil(nz/32), ceil(ny/8), nx).
// With HALO the box is an x-slab shard block: plane nx of q is the
// (ny, nz) ghost plane q_hi (the right ring neighbour's plane 0) instead
// of the wrapped plane 0.  ut is stored as TI and u as TO (float or bf16);
// q and the arithmetic are float.
template <bool HALO, class TI = float, class TO = float>
__global__ void __launch_bounds__(256)
correct_kernel(const TI* __restrict__ ut, const float* __restrict__ q,
               TO* __restrict__ u, int nx, int ny, int nz, float dx0, float dx1,
               float dx2, const float* __restrict__ q_hi) {
    const int z = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    const int x = blockIdx.z;
    if (z >= nz || y >= ny) return;
    const size_t n3 = (size_t)nx * ny * nz;
    const size_t i = ((size_t)x * ny + y) * nz + z;
    const int xn = x + 1 == nx ? 0 : x + 1, yn = y + 1 == ny ? 0 : y + 1;
    const int zn = z + 1 == nz ? 0 : z + 1;
    const float qc = __ldg(q + i);
    float qx;
    if constexpr (HALO) {
        qx = x + 1 == nx ? __ldg(q_hi + (size_t)y * nz + z) : __ldg(q + i + (size_t)ny * nz);
    } else {
        qx = __ldg(q + ((size_t)xn * ny + y) * nz + z);
    }
    st_f(u, i, ldg_f(ut, i) - (qx - qc) / dx0);
    st_f(u, n3 + i, ldg_f(ut, n3 + i) - (__ldg(q + ((size_t)x * ny + yn) * nz + z) - qc) / dx1);
    st_f(u, 2 * n3 + i,
         ldg_f(ut, 2 * n3 + i) - (__ldg(q + ((size_t)x * ny + y) * nz + zn) - qc) / dx2);
}

// The correction on a periodic box, or (q_hi given) on a shard block.
inline cudaError_t launch_correct(const float* ut, const float* q, float* u, int nx, int ny,
                                  int nz, float dx0, float dx1, float dx2,
                                  cudaStream_t stream, const float* q_hi = nullptr) {
    const dim3 block(32, 8);
    const dim3 grid((nz + 31) / 32, (ny + 7) / 8, nx);
    if (q_hi)
        correct_kernel<true><<<grid, block, 0, stream>>>(ut, q, u, nx, ny, nz, dx0, dx1, dx2,
                                                         q_hi);
    else
        correct_kernel<false><<<grid, block, 0, stream>>>(ut, q, u, nx, ny, nz, dx0, dx1, dx2,
                                                          nullptr);
    return cudaGetLastError();
}

// The correction on a periodic box with ut stored as TI and u as TO (the
// bf16 stream storage: bf16 or float each).
template <class TI, class TO>
inline cudaError_t launch_correct_as(const TI* ut, const float* q, TO* u, int n, float dx0,
                                     float dx1, float dx2, cudaStream_t stream) {
    const dim3 block(32, 8);
    const dim3 grid((n + 31) / 32, (n + 7) / 8, n);
    correct_kernel<false, TI, TO><<<grid, block, 0, stream>>>(ut, q, u, n, n, n, dx0, dx1, dx2,
                                                              nullptr);
    return cudaGetLastError();
}

}  // namespace
