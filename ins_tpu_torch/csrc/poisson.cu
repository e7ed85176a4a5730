// Pass B of the fused projection as GEMMs (transforms.cu) around the
// kernels here: the dense pass B (n % 4 != 0) above
// `ops/poisson_kernels.DENSE_FUSED_MAX_N` (the GEMM route), and the
// radix-2 folded one above `ops/poisson_kernels.FOLD_FUSED_MAX_N` (the
// level route).  Up to those gates each is one kernel (fold.cu), whose
// panel of all n x-rows fits a block only up to n = 512 dense, 1024
// folded.
//
// Eigen-scale: g(r, y, z) *= 1 / den(r, y, z) on an (nr, n, n) block,
//
//   den = vol * (lam_x(k(r)) + lam_y(y) + lam_z(z)),
//   lam_x(k) = -4 sin^2(pi k / n) / dx_0^2,
//   lam_d(i) = -4 sin^2(pi ceil(i / 2) / n) / dx_d^2   (d = y, z),
//
// zero where |den| < eps (the k = 0 nullspace mode: zero-mean pressure).
// The row -> x-frequency map is k = kmul * ceil(r / 2) for the dense
// transform and the fold's leaf, and k = kmul * (2 floor(r / 2) + 1) for
// a fold level's odd-frequency half (odd set).
//
// Fold split and combine (one fold level on an (nn, ly, n) block, h = the
// two x-halves [h0; h1]):
//
//   e = h0 + h1,  o = h0 - h1                       (split)
//   out = [qe / 2 + qo; qe / 2 - qo]                (combine)
//
// between which the wrapper runs g_o = R_o . o, the odd eigen-scale,
// q_o = S_o . g_o (GEMMs) and the recursion on e (kmul doubled): eight
// launches at one level, twelve at two.
//
// Replaces: above the gates, `_passB_kernel` / `_passB_body` (dense,
// ins_tpu/ops/poisson_pallas.py:198, :110) and `_passB_fold_kernel` /
// `_passB_fold_body` (radix-2 folded, :214, :136),
// both called from `make_fused_projection` (:411; the fold wherever
// n % 4 == 0, :429-449), with `den` generated in-kernel from the closed
// form `_lam` (:101) as there, never read from memory.  The sharded pass B
// of an x-slab mesh, `make_passB_sharded` (:480; fold
// `_passB_fold_yoff_kernel` :223, dense `_passB_yoff_kernel` :205), runs
// the same kernels on a shard's (n, ly, n) y-slice with full x after the
// x<->y all-to-all: only the eigen-scale changes, taking the slice's y
// extent ly and the global offset yoff of its first y-mode (the shard's
// rank times ly).  The JAX kernels have no size limit; neither has this
// route (indices are 64-bit; a (2048, 512, 2048) shard holds 2^31 floats).
//
// What bounds it on an H100: the x-transform GEMMs' operations (dense 4 n^4,
// 17.2 GFLOP at 256^3: 0.104 ms as 3xTF32 at the 495 TFLOP/s TF32 peak;
// folded 2 n^4 at one level, 1.5 n^4 at two).  The kernels here are
// device-memory bound: the eigen-scale reads and writes the block once,
// the split and the combine each read two half-blocks and write two.  One
// thread per element, z fastest across a warp (scale) or a flat
// grid-stride loop (split, combine); the eigenvalues are recomputed per
// element with sinpif, cheaper than a table load.

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

__global__ void __launch_bounds__(256)
fold_split_kernel(const float* __restrict__ h, float* __restrict__ e,
                  float* __restrict__ o, long long half) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < half;
         i += (long long)gridDim.x * blockDim.x) {
        const float a = __ldg(h + i), b = __ldg(h + half + i);
        e[i] = a + b;
        o[i] = a - b;
    }
}

__global__ void __launch_bounds__(256)
fold_combine_kernel(const float* __restrict__ qe, const float* __restrict__ qo,
                    float* __restrict__ out, long long half) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < half;
         i += (long long)gridDim.x * blockDim.x) {
        const float a = 0.5f * __ldg(qe + i), b = __ldg(qo + i);
        out[i] = a + b;
        out[half + i] = a - b;
    }
}

unsigned flat_blocks(long long count) {
    const long long b = (count + 255) / 256;
    return (unsigned)(b < 65536 ? b : 65536);
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

// e = h0 + h1, o = h0 - h1 over the `half` elements of each x-half of h.
extern "C" int ins_fold_split_f32(const float* h, float* e, float* o, long long half,
                                  void* stream) {
    if (half < 1) return (int)cudaErrorInvalidValue;
    fold_split_kernel<<<flat_blocks(half), 256, 0, (cudaStream_t)stream>>>(h, e, o, half);
    return (int)cudaGetLastError();
}

// out = [qe / 2 + qo; qe / 2 - qo], each half `half` elements.
extern "C" int ins_fold_combine_f32(const float* qe, const float* qo, float* out,
                                    long long half, void* stream) {
    if (half < 1) return (int)cudaErrorInvalidValue;
    fold_combine_kernel<<<flat_blocks(half), 256, 0, (cudaStream_t)stream>>>(qe, qo, out,
                                                                             half);
    return (int)cudaGetLastError();
}
