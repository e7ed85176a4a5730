// Pressure correction: u = ut - grad(q), forward differences
//
//   u_a(I) = ut_a(I) - (q(I + e_a) - q(I)) / dx_a     on the periodic cube
//
// Replaces: the correction part of `_pc_qhat_kernel`
// (ins_tpu/ops/pallas_kernels.py:3325, wrapper `pressure_correct_qhat_3d`
// :3422).  The TPU kernel inverse-transforms qhat (q = V_y qhat V_z^T)
// inside the same pass; here the wrapper runs that transform as two
// plane-transform GEMMs (transforms.cu) first, so q makes one extra
// scalar round trip through device memory (later work, ROADMAP queue 2).
//
// What bounds it on an H100: device-memory bytes (read 3 + 1 floats,
// write 3 per cell; 0.47 GB at 256^3, ~0.14 ms at 3.35 TB/s) with ~6
// operations per cell.  One thread per cell, z fastest across a warp, so
// every access is coalesced; the +e_a neighbours of q come from L1/L2.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
correct_kernel(const float* __restrict__ ut, const float* __restrict__ q,
               float* __restrict__ u, int n, float dx0, float dx1, float dx2) {
    const int z = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    const int x = blockIdx.z;
    if (z >= n || y >= n) return;
    const size_t n3 = (size_t)n * n * n;
    const size_t i = ((size_t)x * n + y) * n + z;
    const int xn = x + 1 == n ? 0 : x + 1, yn = y + 1 == n ? 0 : y + 1;
    const int zn = z + 1 == n ? 0 : z + 1;
    const float qc = __ldg(q + i);
    u[i] = __ldg(ut + i) - (__ldg(q + ((size_t)xn * n + y) * n + z) - qc) / dx0;
    u[n3 + i] = __ldg(ut + n3 + i) - (__ldg(q + ((size_t)x * n + yn) * n + z) - qc) / dx1;
    u[2 * n3 + i] = __ldg(ut + 2 * n3 + i) - (__ldg(q + ((size_t)x * n + y) * n + zn) - qc) / dx2;
}

}  // namespace

extern "C" int ins_correct_f32(const float* ut, const float* q, float* u, int n,
                               float dx0, float dx1, float dx2, void* stream) {
    const dim3 block(32, 8);
    const dim3 grid((n + 31) / 32, (n + 7) / 8, n);
    correct_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(ut, q, u, n, dx0, dx1, dx2);
    return (int)cudaGetLastError();
}
