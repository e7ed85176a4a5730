// Pass B eigen-scale: g(i, y, z) *= 1 / den(i, y, z)
//
//   den = vol * (lam_x(i) + lam_y(y) + lam_z(z)),
//   lam_d(k) = -4 sin^2(pi * ceil(k / 2) / n) / dx_d^2,
//
// zero where |den| < eps (the k = 0 nullspace mode: zero-mean pressure).
// The wrapper brackets it with the x-forward and x-inverse plane-transform
// GEMMs (transforms.cu), so pass B = GEMM, this kernel, GEMM.
//
// Replaces: the scale of `_passB_body` (ins_tpu/ops/poisson_pallas.py:110,
// kernel `_passB_kernel` :198, called from `make_fused_projection` :411),
// with `den` from the closed form `_lam` (:101) generated in-kernel as
// there, never read from memory.  The TPU path at n % 4 == 0 runs the
// radix-2 folded form (`_passB_fold_kernel` :214), which computes the same
// q with fewer MXU passes; the dense form here is the reference, and the
// fold is a later speed-up (ROADMAP queue 2).
//
// What bounds it on an H100: device-memory bytes (one read and one write
// of an (n, n, n) float field; 134 MB at 256^3, ~0.04 ms at 3.35 TB/s).
// One thread per element, z fastest across a warp; the three eigenvalues
// are recomputed per element with sinpif (cheaper than a table load).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float lam(int idx, int n, float dx) {
    const float s = sinpif((float)((idx + 1) / 2) / (float)n);
    return (-4.0f / (dx * dx)) * s * s;
}

__global__ void __launch_bounds__(256)
eigen_scale_kernel(float* __restrict__ g, int n, float dx0, float dx1, float dx2,
                   float vol, float eps) {
    const int z = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    const int i = blockIdx.z;
    if (z >= n || y >= n) return;
    const float den = vol * (lam(i, n, dx0) + lam(y, n, dx1) + lam(z, n, dx2));
    const float inv = fabsf(den) < eps ? 0.0f : 1.0f / den;
    const size_t k = ((size_t)i * n + y) * n + z;
    g[k] = g[k] * inv;
}

}  // namespace

extern "C" int ins_eigen_scale_f32(float* g, int n, float dx0, float dx1, float dx2,
                                   float vol, float eps, void* stream) {
    const dim3 block(32, 8);
    const dim3 grid((n + 31) / 32, (n + 7) / 8, n);
    eigen_scale_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(g, n, dx0, dx1, dx2,
                                                                 vol, eps);
    return (int)cudaGetLastError();
}
