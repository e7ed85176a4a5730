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
// itself.  The correction is `correct_kernel` of stencil.cuh (correct.cu's).
//
// The conv-diff is `convdiff_roll` (ins_tpu/ops/diffkernels.py) term for
// term, as the JAX kernel forms it with its shifted-flux identity: the
// lower-face flux uab1 * uba1 at I is the upper-face flux uab2 * uba2 at
// I - e_b (the same products of the same operands), so each cell forms its
// nine upper-face fluxes phi_ab(I) once and takes phi_ab(I - e_b) from a
// neighbour's.  Every product is rounded on its own (__fmul_rn), so both
// cells of a face see the same bits; 1/dx_b and visc/dx_b^2 come from the
// host (`ops/perop_kernels.convdiff_recips`).  Per component a:
//
//   f_a = sum_b [cd_b (u_a(I+e_b) - 2 u_a(I) + u_a(I-e_b))
//                - (phi_ab(I) - phi_ab(I-e_b)) rdx_b],
//   phi_ab = (u_a(I) + u_a(I+e_b))/2 * (u_b(I) + u_b(I+e_a))/2.
//
// What bounds it on an H100: device-memory bytes.  At 128^3 it reads 3
// and writes 3 floats a cell (50 MB, 15 us at 3.35 TB/s).  The stencil
// reads every velocity value some twenty times, so those reads stay on
// chip; what the kernel must keep small is its instructions a cell and
// the latency of its loads (the idiom of stage.cu and channel.cu):
//
// * A block of 256 threads (8 warps stacked in y, each thread one z and
//   two y-rows) owns a 16 x 32 (y, z) tile and walks CD_XB = 11 x-planes
//   (perop_geometry.cuh: one wave of blocks at 128^3, three an SM).  The
//   window of (16 + 2) x (32 + 8) cells is staged for a (16 x 32) tile,
//   and a run of 11 planes loads 13.
// * Staging is asynchronous: the three components of a plane go into a
//   ring of three slots by cp.async copies a plane ahead of their use,
//   while the block computes; 16-byte copies where nz % 4 == 0 and u is
//   16-byte aligned (the window starts 4 columns before the tile, so no
//   chunk straddles the wrap), else 4-byte ones, with each thread's
//   wrapped offsets formed once a block (`Window4`, `Window`, ring.cuh).
//   One block barrier a plane.
// * Each face flux once a cell: phi_a0(I - e_x) and u(I - e_x) are the
//   previous plane's, kept in registers (a warm-up plane x0 - 1 forms them
//   once a run); phi_a1(I - e_y) is the thread's previous row's (its first
//   row's from the row below the warp's, which every lane forms); phi_a2(I
//   - e_z) the next lane down's (a warp shuffle; lane 0 takes the value at
//   z0 - 1, which lanes 0 .. RY - 1 form, one row each).
// * No division: every 1/dx and visc/dx^2 is a multiply by a reciprocal.
//
// The stage-div reads 6 floats and writes 4 per cell (84 MB, 25 us): one
// thread per cell, z fastest across a warp, the I - e_a neighbours from
// L1/L2.  The correction reads 4 and writes 3 (59 MB, 18 us), likewise.

#include <cstdint>

#include "perop_geometry.cuh"
#include "ring.cuh"
#include "stencil.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// 1/dx_b and visc/dx_b^2 from the host
struct CdConsts {
    float rdx[3];
    float cd[3];
};

// Each thread's wrapped window offsets: 16-byte chunks (VEC) or elements.
template <bool VEC>
struct CdWin;
template <>
struct CdWin<true> {
    Window4<CD_HY, CD_HZ / 4, CD_NT> w;
};
template <>
struct CdWin<false> {
    Window<CD_HY, CD_HZ, CD_NT> w;
};

// Copy the three components of the x-plane at src (component stride n3)
// over the window into `slot` (components CD_HW floats apart).
template <bool VEC>
__device__ __forceinline__ void stage_plane(float* slot, const float* src, size_t n3,
                                            const CdWin<VEC>& win, int tid) {
    using Win = decltype(win.w);
#pragma unroll
    for (int k = 0; k < Win::K; ++k) {
        const int e = tid + k * CD_NT;
        if (e < Win::N) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                if constexpr (VEC)
                    cp_async16f(slot + c * CD_HW + 4 * e, src + c * n3 + win.w.off[k]);
                else
                    cp_async4(slot + c * CD_HW + e, src + c * n3 + win.w.off[k]);
            }
        }
    }
}

// A cell's view of the ring: u(c, I + (ox, oy, oz)) with ox 0 (the plane
// slot s0) or 1 (the next plane's, s1) and e the cell's window element.
struct CdView {
    const float* s0;
    const float* s1;
    int e;
    __device__ __forceinline__ float operator()(int c, int ox, int oy, int oz) const {
        return (ox ? s1 : s0)[c * CD_HW + e + oy * CD_HZ + oz];
    }
};

// The upper-face flux phi_ab at the view's cell: uab2 * uba2 of
// stencil.cuh's `convdiff`, rounded on its own.
template <int A, int B>
__device__ __forceinline__ float face(const CdView& u) {
    constexpr int ex = B == 0, ey = B == 1, ez = B == 2;
    const float uab = 0.5f * (u(A, 0, 0, 0) + u(A, ex, ey, ez));
    if constexpr (A == B) {
        return __fmul_rn(uab, uab);
    } else {
        constexpr int ax = A == 0, ay = A == 1, az = A == 2;
        const float uba = 0.5f * (u(B, 0, 0, 0) + u(B, ax, ay, az));
        return __fmul_rn(uab, uba);
    }
}

// f_a at the view's cell from its fluxes p[b] = phi_ab(I), the lower ones
// pm[b] = phi_ab(I - e_b) and u_a(I - e_x) (umx).
template <int A>
__device__ __forceinline__ float cell_f(const CdConsts& k, const CdView& u, const float (&p)[3],
                                        const float (&pm)[3], float umx) {
    const float ua = u(A, 0, 0, 0);
    float f = 0.0f;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
        const int ey = b == 1, ez = b == 2;
        const float upb = u(A, b == 0, ey, ez);
        const float umb = b == 0 ? umx : u(A, 0, -ey, -ez);
        const float fd = k.cd[b] * (upb - 2.0f * ua + umb);
        f = f + (fd - (p[b] - pm[b]) * k.rdx[b]);
    }
    return f;
}

template <bool VEC>
__global__ void __launch_bounds__(CD_NT, CD_SM_BLOCKS)
convdiff_kernel(const float* __restrict__ u, float* __restrict__ f, int nx, int ny, int nz,
                const CdConsts k) {
    __shared__ __align__(16) float sm[CD_RING * CD_PL];
    const int lane = threadIdx.x, w = threadIdx.y, tid = w * 32 + lane;
    const int z0 = blockIdx.x * CD_TZ, y0 = blockIdx.y * CD_TY, x0 = blockIdx.z * CD_XB;
    const int nxb = min(CD_XB, nx - x0);
    const size_t n2 = (size_t)ny * nz, n3 = (size_t)nx * n2;
    CdWin<VEC> win;
    win.w.init(tid, y0 - 1, z0 - CD_ZLO, ny, nz);
    // the thread's cells: z = z0 + lane, y = yb + r (r < RY); cells past
    // the box's edge compute on wrapped window values and store nothing
    const int z = z0 + lane, zc = min(z, nz - 1);
    const int yb = y0 + w * CD_RY;
    int row[CD_RY];
#pragma unroll
    for (int r = 0; r < CD_RY; ++r) row[r] = min(yb + r, ny - 1) * nz + zc;
    const int e0 = cd_elem(w * CD_RY, lane, 0, 0);  // row 0's window element
    // lanes < RY: the z-halo cell (yb + lane, z0 - 1)
    const int ezh = cd_elem(w * CD_RY + min(lane, CD_RY - 1), 0, 0, -1);
    float umx[3][CD_RY], pmx[3][CD_RY];  // u_a and phi_a0 at x - 1
    // Plane x0 - 1 + l (local index l) lives in slot l % RING.  Phase l
    // copies plane l + 2 and computes plane l (l = 0: the warm-up plane x0
    // - 1, whose u and phi_a0 alone are kept; then x0 .. x0 + nxb - 1).
    stage_plane<VEC>(sm, u + (size_t)wrap(x0 - 1, nx) * n2, n3, win, tid);
    stage_plane<VEC>(sm + CD_PL, u + (size_t)x0 * n2, n3, win, tid);
    cp_async_commit_group();
    cp_async_wait_all();
    __syncthreads();
    for (int l = 0; l <= nxb; ++l) {
        if (l + 1 <= nxb)
            stage_plane<VEC>(sm + ((l + 2) % CD_RING) * CD_PL,
                             u + (size_t)wrap(x0 + l + 1, nx) * n2, n3, win, tid);
        cp_async_commit_group();
        const CdView v{sm + (l % CD_RING) * CD_PL, sm + ((l + 1) % CD_RING) * CD_PL, e0};
        if (l == 0) {
#pragma unroll
            for (int r = 0; r < CD_RY; ++r) {
                CdView vr = v;
                vr.e += r * CD_HZ;
                umx[0][r] = vr(0, 0, 0, 0);
                umx[1][r] = vr(1, 0, 0, 0);
                umx[2][r] = vr(2, 0, 0, 0);
                pmx[0][r] = face<0, 0>(vr);
                pmx[1][r] = face<1, 0>(vr);
                pmx[2][r] = face<2, 0>(vr);
            }
        } else {
            const size_t pl = (size_t)(x0 + l - 1) * n2;
            // phi_a1 at (yb - 1): the lower y-faces of row 0
            CdView vh = v;
            vh.e -= CD_HZ;
            float pmy[3] = {face<0, 1>(vh), face<1, 1>(vh), face<2, 1>(vh)};
            // phi_a2 at (yb + lane, z0 - 1), lanes < RY
            float hz[3] = {0.0f, 0.0f, 0.0f};
            if (lane < CD_RY) {
                CdView vz = v;
                vz.e = ezh;
                hz[0] = face<0, 2>(vz);
                hz[1] = face<1, 2>(vz);
                hz[2] = face<2, 2>(vz);
            }
#pragma unroll
            for (int r = 0; r < CD_RY; ++r) {
                CdView vr = v;
                vr.e += r * CD_HZ;
                const float p[3][3] = {{face<0, 0>(vr), face<0, 1>(vr), face<0, 2>(vr)},
                                       {face<1, 0>(vr), face<1, 1>(vr), face<1, 2>(vr)},
                                       {face<2, 0>(vr), face<2, 1>(vr), face<2, 2>(vr)}};
                float pm[3][3];
#pragma unroll
                for (int a = 0; a < 3; ++a) {
                    float pz = __shfl_up_sync(FULL, p[a][2], 1);
                    const float h = __shfl_sync(FULL, hz[a], r);
                    if (lane == 0) pz = h;
                    pm[a][0] = pmx[a][r];
                    pm[a][1] = pmy[a];
                    pm[a][2] = pz;
                }
                const float f0 = cell_f<0>(k, vr, p[0], pm[0], umx[0][r]);
                const float f1 = cell_f<1>(k, vr, p[1], pm[1], umx[1][r]);
                const float f2 = cell_f<2>(k, vr, p[2], pm[2], umx[2][r]);
                if (yb + r < ny && z < nz) {
                    const size_t c = pl + row[r];
                    f[c] = f0;
                    f[n3 + c] = f1;
                    f[2 * n3 + c] = f2;
                }
#pragma unroll
                for (int a = 0; a < 3; ++a) {
                    umx[a][r] = vr(a, 0, 0, 0);
                    pmx[a][r] = p[a][0];
                    pmy[a] = p[a][1];
                }
            }
        }
        // each slot is refilled a phase after its last read
        cp_async_wait_all();
        __syncthreads();
    }
}

template <bool VEC>
cudaError_t launch_convdiff(const float* u, float* f, int nx, int ny, int nz, const CdConsts& k,
                            cudaStream_t stream) {
    const dim3 grid((nz + CD_TZ - 1) / CD_TZ, (ny + CD_TY - 1) / CD_TY,
                    (nx + CD_XB - 1) / CD_XB);
    convdiff_kernel<VEC><<<grid, dim3(32, CD_NW), 0, stream>>>(u, f, nx, ny, nz, k);
    return cudaGetLastError();
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

// rdx_b = 1/dx_b and cd_b = visc/dx_b^2, formed on the host.
extern "C" int ins_convdiff_f32(const float* u, float* f, int nx, int ny, int nz, float rdx0,
                                float rdx1, float rdx2, float cd0, float cd1, float cd2,
                                void* stream) {
    if (nx < 1 || ny < 1 || nz < 1) return (int)cudaErrorInvalidValue;
    const CdConsts k{{rdx0, rdx1, rdx2}, {cd0, cd1, cd2}};
    const cudaStream_t s = (cudaStream_t)stream;
    // 16-byte staging where every row of a plane is a multiple of four
    // floats and u starts on 16 bytes
    const bool vec = nz % 4 == 0 && ((uintptr_t)u & 15) == 0;
    return (int)(vec ? launch_convdiff<true>(u, f, nx, ny, nz, k, s)
                     : launch_convdiff<false>(u, f, nx, ny, nz, k, s));
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
