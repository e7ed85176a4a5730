// The dense pass B of the fused projection: the x-direction solve divhat
// -> qhat where n % 4 != 0, as GEMMs (transforms.cu) around the kernel
// here.  (Wherever n % 4 == 0 the folded pass B runs instead, in one
// kernel: fold.cu.)
//
// Eigen-scale: g(r, y, z) *= 1 / den(r, y, z) on an (nr, n, n) block,
//
//   den = vol * (lam_x(k(r)) + lam_y(y) + lam_z(z)),
//   lam_x(k) = -4 sin^2(pi k / n) / dx_0^2,
//   lam_d(i) = -4 sin^2(pi ceil(i / 2) / n) / dx_d^2   (d = y, z),
//
// zero where |den| < eps (the k = 0 nullspace mode: zero-mean pressure).
// The row -> x-frequency map is k = kmul * ceil(r / 2) (the dense
// transform: kmul = 1), or k = kmul * (2 floor(r / 2) + 1) with odd set.
//
// Replaces: `_passB_kernel` / `_passB_body` (dense,
// ins_tpu/ops/poisson_pallas.py:198, :110), called from
// `make_fused_projection` (:411) where n % 4 != 0, with `den` generated
// in-kernel from the closed form `_lam` (:101) as there, never read from
// memory.  The sharded pass B of an x-slab mesh, `make_passB_sharded`
// (:480; dense `_passB_yoff_kernel` :205), runs the same kernels on a
// shard's (n, ly, n) y-slice with full x after the x<->y all-to-all: only
// the eigen-scale changes, taking the slice's y extent ly and the global
// offset yoff of its first y-mode (the shard's rank times ly).
//
// What bounds it on an H100: the x-transform GEMMs' operations (4 n^4,
// 17.2 GFLOP at 256^3: 0.104 ms as 3xTF32 at the 495 TFLOP/s TF32 peak).
// The kernel here is device-memory bound: it reads and writes the block
// once.  One thread per element, z fastest across a warp; the eigenvalues
// are recomputed per element with sinpif, cheaper than a table load.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float lam_k(int k, int n, float dx) {
    const float s = sinpif((float)k / (float)n);
    return (-4.0f / (dx * dx)) * s * s;
}

__global__ void __launch_bounds__(256)
eigen_scale_kernel(float* __restrict__ g, int n, int ly, int yoff, int kmul, int odd,
                   float dx0, float dx1, float dx2, float vol, float eps) {
    const int z = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    const int r = blockIdx.z;
    if (z >= n || y >= ly) return;
    const int kx = kmul * (odd ? 2 * (r / 2) + 1 : (r + 1) / 2);
    const float den = vol * (lam_k(kx, n, dx0) + lam_k((y + yoff + 1) / 2, n, dx1) +
                             lam_k((z + 1) / 2, n, dx2));
    const float inv = fabsf(den) < eps ? 0.0f : 1.0f / den;
    const size_t i = ((size_t)r * ly + y) * n + z;
    g[i] = g[i] * inv;
}

}  // namespace

// g: an (nr, ly, n) block whose rows y are the global y-modes yoff + y
// (ly = n, yoff = 0 on one device; a shard's y-slice after the x<->y
// transpose of the sharded pass B).
extern "C" int ins_eigen_scale_f32(float* g, int nr, int n, int ly, int yoff, int kmul,
                                   int odd, float dx0, float dx1, float dx2, float vol,
                                   float eps, void* stream) {
    if (ly < 1 || yoff < 0 || yoff + ly > n) return (int)cudaErrorInvalidValue;
    const dim3 block(32, 8);
    const dim3 grid((n + 31) / 32, (ly + 7) / 8, nr);
    eigen_scale_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(g, n, ly, yoff, kmul, odd,
                                                                 dx0, dx1, dx2, vol, eps);
    return (int)cudaGetLastError();
}
