// The per-op kernels of the differentiable fast path, on any periodic
// (nx, ny, nz) box, float32, component-first (3, nx, ny, nz) velocity:
//
//   convdiff       f = convdiff(u)                        (convdiff_roll)
//   stage_div      ut = base + c k;
//                  div = vol * sum_a (ut_a(I) - ut_a(I - e_a)) / dx_a
//   correct        u = ut - grad(q)                       (forward differences)
//
// Replaces: `_convdiff3d_kernel` (ins_tpu/ops/pallas_kernels.py:190,
// wrapper `convdiff_interior_3d` :312), `_stage_div_kernel` (:382,
// wrapper `stage_div_3d` :458) and `_pressure_correct_kernel` (:3472,
// wrapper `pressure_correct_3d` :3546).  The TPU kernels walk x-slabs in
// order with a double-buffered DMA ring carried across grid steps;
// nothing carries between CUDA blocks, so each block stages what it needs
// itself.  The conv-diff arithmetic is `convdiff` of stencil.cuh (the
// stage kernel's, stage.cu), the correction `correct_kernel` of the same
// header (correct.cu's).
//
// What bounds it on an H100: device-memory bytes.  At 128^3 the conv-diff
// reads 3 and writes 3 floats per cell (50 MB, 15 us at 3.35 TB/s); its
// stencil reads every velocity about 40 times per cell, so a block owns a
// 32 x 8 (z, y) tile and walks 8 x-planes with a ring of the velocity
// (halo of one cell in y and z) in shared memory, as stage.cu does.  The
// stage-div reads 6 floats and writes 4 per cell (84 MB, 25 us): one
// thread per cell, z fastest across a warp, the I - e_a neighbours from
// L1/L2.  The correction reads 4 and writes 3 (59 MB, 18 us), likewise.

#include "stencil.cuh"

namespace {

constexpr int TZ = 32;        // tile extent in z (one warp)
constexpr int TY = 8;         // tile extent in y
constexpr int XB = 8;         // x-planes walked per block
constexpr int HZ = TZ + 2;    // halo: 1 below, 1 above
constexpr int HY = TY + 2;
constexpr int RING = 4;       // x-planes x-1 .. x+1 and the one loading

using Ring = float[RING][3][HY][HZ];

// Fill ring slot `slot` with x-plane `xp` over the tile's haloed (y, z)
// window starting at (y0 - 1, z0 - 1).
__device__ __forceinline__ void load_plane(const float* __restrict__ u, Ring& s, int slot,
                                           int xp, int y0, int z0, int nx, int ny, int nz) {
    const size_t n3 = (size_t)nx * ny * nz;
    const int x = wrap(xp, nx);
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthreads = blockDim.x * blockDim.y;
    for (int e = tid; e < HY * HZ; e += nthreads) {
        const int ly = e / HZ, lz = e - ly * HZ;
        const int y = wrap(y0 - 1 + ly, ny), z = wrap(z0 - 1 + lz, nz);
        const size_t i = ((size_t)x * ny + y) * nz + z;
        s[slot][0][ly][lz] = __ldg(u + i);
        s[slot][1][ly][lz] = __ldg(u + n3 + i);
        s[slot][2][ly][lz] = __ldg(u + 2 * n3 + i);
    }
}

// The thread's view of the ring at step i: u(c, I + (ox, oy, oz)).
struct View {
    const Ring* s;
    int i, ly, lz;
    __device__ __forceinline__ float operator()(int c, int ox, int oy, int oz) const {
        return (*s)[(i + 1 + ox) & 3][c][ly + oy][lz + oz];
    }
};

__global__ void __launch_bounds__(TZ * TY)
convdiff_kernel(const float* __restrict__ u, float* __restrict__ f, int nx, int ny,
                int nz, float visc, float dx0, float dx1, float dx2) {
    __shared__ Ring s;
    const float dx[3] = {dx0, dx1, dx2};
    const int z0 = blockIdx.x * TZ, y0 = blockIdx.y * TY, x0 = blockIdx.z * XB;
    const int z = z0 + threadIdx.x, y = y0 + threadIdx.y;
    const bool active = z < nz && y < ny;  // ragged tiles still load and sync
    const int nxb = min(XB, nx - x0);
    const size_t n3 = (size_t)nx * ny * nz;
    // plane x0 + i + o sits in slot (i + 1 + o) & 3 at step i
    for (int r = 0; r < 2; ++r) load_plane(u, s, r, x0 - 1 + r, y0, z0, nx, ny, nz);
    View v{&s, 0, (int)threadIdx.y + 1, (int)threadIdx.x + 1};
    for (int i = 0; i < nxb; ++i) {
        load_plane(u, s, (i + 2) & 3, x0 + i + 1, y0, z0, nx, ny, nz);
        __syncthreads();
        if (active) {
            v.i = i;
            const size_t idx = ((size_t)(x0 + i) * ny + y) * nz + z;
            f[idx] = convdiff<0, 0, 0, 0>(visc, dx, v);
            f[n3 + idx] = convdiff<1, 0, 0, 0>(visc, dx, v);
            f[2 * n3 + idx] = convdiff<2, 0, 0, 0>(visc, dx, v);
        }
        __syncthreads();
    }
}

__global__ void __launch_bounds__(256)
stage_div_kernel(const float* __restrict__ base, const float* __restrict__ k, float c,
                 float* __restrict__ ut, float* __restrict__ div, int nx, int ny, int nz,
                 float dx0, float dx1, float dx2, float vol) {
    const int z = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    const int x = blockIdx.z;
    if (z >= nz || y >= ny) return;
    const size_t n3 = (size_t)nx * ny * nz;
    const size_t i = ((size_t)x * ny + y) * nz + z;
    const int xm = x == 0 ? nx - 1 : x - 1, ym = y == 0 ? ny - 1 : y - 1;
    const int zm = z == 0 ? nz - 1 : z - 1;
    const size_t im[3] = {((size_t)xm * ny + y) * nz + z, ((size_t)x * ny + ym) * nz + z,
                          ((size_t)x * ny + y) * nz + zm};
    const float dx[3] = {dx0, dx1, dx2};
    float d = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const size_t o = a * n3;
        const float uc = __ldg(base + o + i) + c * __ldg(k + o + i);
        const float um = __ldg(base + o + im[a]) + c * __ldg(k + o + im[a]);
        ut[o + i] = uc;
        d = d + (uc - um) / dx[a];
    }
    div[i] = d * vol;
}

}  // namespace

extern "C" int ins_convdiff_f32(const float* u, float* f, int nx, int ny, int nz,
                                float visc, float dx0, float dx1, float dx2,
                                void* stream) {
    const dim3 block(TZ, TY);
    const dim3 grid((nz + TZ - 1) / TZ, (ny + TY - 1) / TY, (nx + XB - 1) / XB);
    convdiff_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(u, f, nx, ny, nz, visc,
                                                               dx0, dx1, dx2);
    return (int)cudaGetLastError();
}

extern "C" int ins_stage_div_f32(const float* base, const float* k, float c, float* ut,
                                 float* div, int nx, int ny, int nz, float dx0,
                                 float dx1, float dx2, float vol, void* stream) {
    const dim3 block(32, 8);
    const dim3 grid((nz + 31) / 32, (ny + 7) / 8, nx);
    stage_div_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(base, k, c, ut, div, nx,
                                                                 ny, nz, dx0, dx1, dx2, vol);
    return (int)cudaGetLastError();
}

extern "C" int ins_pressure_correct_f32(const float* ut, const float* q, float* u, int nx,
                                        int ny, int nz, float dx0, float dx1, float dx2,
                                        void* stream) {
    return (int)launch_correct(ut, q, u, nx, ny, nz, dx0, dx1, dx2, (cudaStream_t)stream);
}
