// Natural-form Smagorinsky force, float32, on a periodic (3, nx, ny, nz)
// box of any extent:
//
//   u     = ut_prev - grad(q)   (REBUILD: q physical, forward differences)
//         | u                   (no rebuild: u is an input)
//   S_aa  = (u_a(I) - u_a(I - e_a)) / dx_a
//   S_ab  = ((u_a(I + e_b) - u_a(I)) / dx_b + (u_b(I + e_a) - u_b(I)) / dx_a) / 2
//   nu    = theta^2 d2 sqrt(2 sum_a S_aa^2 + sum_{a<b} [S_ab^2 at I, I-e_a, I-e_b, I-e_a-e_b])
//   s_aa  = 2 nu S_aa;  s_ab = (nu + nu(+e_a) + nu(+e_b) + nu(+e_a+e_b)) / 2 * S_ab
//   F_a   = (s_aa(I + e_a) - s_aa(I)) / dx_a + sum_{b != a} (s_ab(I) - s_ab(I - e_b)) / dx_b
//   out   = F (+ bf, a steady body force, when given)
//
// theta is read from a one-element device array, so the caller never
// syncs the host for it.  d2 = sum_d dx_d^2.
//
// Replaces: `_smag_force_kernel` / `_smag_body`
// (ins_tpu/ops/pallas_kernels.py:1986, :2100; wrapper
// `smagorinsky_force_3d` :2292), term for term and in the same order of
// additions.  The REBUILD variant is the force half of the fused
// Smagorinsky stage of `pcmsd_hat_3d` (`smag=`, :2639), which evaluates
// `_smag_body` on the rebuilt velocity window; here the stage wrappers run
// this kernel first and hand its output to the stage kernel's force stream
// (stage.cu), which the JAX package's tests show equal to the fused form.
//
// What bounds it on an H100: device-memory bytes.  With REBUILD it reads
// ut_prev and q and writes F: 7 floats per cell, 470 MB at 256^3
// (0.140 ms at 3.35 TB/s); a body force adds 3 floats.  The stencil has
// radius 2 in every direction (strain, viscosity average and divergence
// each reach one cell) and reads each velocity element about 200 times, so
// those reads must come from shared memory: a block owns a TZ x TY tile of
// (y, z) and walks XB x-planes, keeping a ring of five x-planes of the
// (rebuilt) velocity with a halo of two cells in y and z, and a ring of
// three planes of nu on the tile plus a one-cell halo.  Per output plane
// it loads one velocity plane (each element rebuilt once per block), forms
// nu on the next plane (the halo is 1.33x the tile), then each thread forms
// its cell's stress and divergence from shared memory, z fastest across a
// warp.  The strain is recomputed wherever it is read rather than staged
// (simple first; staging it is later work), and every 1/dx is a multiply
// by a reciprocal computed once (an IEEE division costs ~10 instructions,
// and the stencil has ~75 of them per cell).

#include "stencil.cuh"

namespace {

constexpr int TZ = 32;        // tile extent in z (one warp)
constexpr int TY = 8;         // tile extent in y
constexpr int XB = 16;        // x-planes walked per block
constexpr int UZ = TZ + 4;    // velocity window: 2 cells each side
constexpr int UY = TY + 4;
constexpr int VZ = TZ + 2;    // nu window: 1 cell each side
constexpr int VY = TY + 2;
constexpr int UR = 5;         // velocity ring: x-planes x-2 .. x+2
constexpr int VR = 3;         // nu ring: x-planes x-1 .. x+1

struct SmagParams {
    const float* u;      // velocity, or ut_prev when REBUILD
    const float* q;      // physical pressure (REBUILD only)
    const float* bf;     // steady body force, may be null
    const float* theta;  // one element
    float* out;
    int nx, ny, nz;
    float dx[3];
    float rdx[3];        // 1 / dx: the stencil multiplies, never divides
    float d2;
};

using URing = float[UR][3][UY][UZ];
using VRing = float[VR][VY][VZ];

// Fill ring slot `slot` with x-plane `xp` of the (rebuilt) velocity over
// the tile's haloed (y, z) window starting at (y0 - 2, z0 - 2).
template <bool REBUILD>
__device__ __forceinline__ void load_plane(const SmagParams& p, URing& s, int slot,
                                           int xp, int y0, int z0) {
    const int nx = p.nx, ny = p.ny, nz = p.nz;
    const size_t n3 = (size_t)nx * ny * nz;
    const int x = wrap(xp, nx);
    const int xn = x + 1 == nx ? 0 : x + 1;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthreads = blockDim.x * blockDim.y;
    for (int e = tid; e < UY * UZ; e += nthreads) {
        const int ly = e / UZ, lz = e - ly * UZ;
        const int y = wrap(y0 - 2 + ly, ny), z = wrap(z0 - 2 + lz, nz);
        const size_t i = ((size_t)x * ny + y) * nz + z;
        float u0 = __ldg(p.u + i), u1 = __ldg(p.u + n3 + i), u2 = __ldg(p.u + 2 * n3 + i);
        if constexpr (REBUILD) {
            const float qc = __ldg(p.q + i);
            const int yn = y + 1 == ny ? 0 : y + 1, zn = z + 1 == nz ? 0 : z + 1;
            u0 -= (__ldg(p.q + ((size_t)xn * ny + y) * nz + z) - qc) / p.dx[0];
            u1 -= (__ldg(p.q + ((size_t)x * ny + yn) * nz + z) - qc) / p.dx[1];
            u2 -= (__ldg(p.q + ((size_t)x * ny + y) * nz + zn) - qc) / p.dx[2];
        }
        s[slot][0][ly][lz] = u0;
        s[slot][1][ly][lz] = u1;
        s[slot][2][ly][lz] = u2;
    }
}

// Velocity around a centre point: u(c, ox, oy, oz) = u_c(K + (ox, oy, oz)),
// |o| <= 1 in x (ring slots sl[0..2] hold planes K-1, K, K+1).
struct UView {
    const URing* s;
    int sl[3];
    int ly, lz;
    __device__ __forceinline__ float operator()(int c, int ox, int oy, int oz) const {
        return (*s)[sl[ox + 1]][c][ly + oy][lz + oz];
    }
};

// nu around a centre point, |o| <= 1 in each direction.
struct VView {
    const VRing* s;
    int sl[3];
    int ly, lz;
    __device__ __forceinline__ float operator()(int ox, int oy, int oz) const {
        return (*s)[sl[ox + 1]][ly + oy][lz + oz];
    }
};

// S_aa at K + o (rdx = 1 / dx)
__device__ __forceinline__ float sdiag(const UView& u, const float (&rdx)[3], int a,
                                       int ox, int oy, int oz) {
    const int ex = a == 0, ey = a == 1, ez = a == 2;
    return (u(a, ox, oy, oz) - u(a, ox - ex, oy - ey, oz - ez)) * rdx[a];
}

// S_ab (a < b) at K + o
__device__ __forceinline__ float soff(const UView& u, const float (&rdx)[3], int a, int b,
                                      int ox, int oy, int oz) {
    const int ax = a == 0, ay = a == 1, az = a == 2;
    const int bx = b == 0, by = b == 1, bz = b == 2;
    return 0.5f * ((u(a, ox + bx, oy + by, oz + bz) - u(a, ox, oy, oz)) * rdx[b] +
                   (u(b, ox + ax, oy + ay, oz + az) - u(b, ox, oy, oz)) * rdx[a]);
}

// sum of S_ab^2 at K, K - e_a, K - e_b, K - e_a - e_b
__device__ __forceinline__ float off4(const UView& u, const float (&rdx)[3], int a, int b) {
    const int ax = a == 0, ay = a == 1, az = a == 2;
    const int bx = b == 0, by = b == 1, bz = b == 2;
    const float s0 = soff(u, rdx, a, b, 0, 0, 0);
    const float s1 = soff(u, rdx, a, b, -ax, -ay, -az);
    const float s2 = soff(u, rdx, a, b, -bx, -by, -bz);
    const float s3 = soff(u, rdx, a, b, -ax - bx, -ay - by, -az - bz);
    return s0 * s0 + s1 * s1 + s2 * s2 + s3 * s3;
}

// nu at the view's centre
__device__ __forceinline__ float eddy_viscosity(const UView& u, const float (&rdx)[3],
                                                float cnu) {
    const float sxx = sdiag(u, rdx, 0, 0, 0, 0);
    const float syy = sdiag(u, rdx, 1, 0, 0, 0);
    const float szz = sdiag(u, rdx, 2, 0, 0, 0);
    float acc = 2.0f * (sxx * sxx + syy * syy + szz * szz);
    acc += off4(u, rdx, 0, 1);
    acc += off4(u, rdx, 0, 2);
    acc += off4(u, rdx, 1, 2);
    return cnu * sqrtf(acc);
}

// s_aa at K + o
__device__ __forceinline__ float sig_diag(const UView& u, const VView& nu,
                                          const float (&rdx)[3], int a, int ox, int oy,
                                          int oz) {
    return 2.0f * nu(ox, oy, oz) * sdiag(u, rdx, a, ox, oy, oz);
}

// s_ab (a < b) at K + o, nu averaged to the a-b edge
__device__ __forceinline__ float sig_off(const UView& u, const VView& nu,
                                         const float (&rdx)[3], int a, int b, int ox,
                                         int oy, int oz) {
    const int ax = a == 0, ay = a == 1, az = a == 2;
    const int bx = b == 0, by = b == 1, bz = b == 2;
    const float nue = nu(ox, oy, oz) + nu(ox + ax, oy + ay, oz + az) +
                      nu(ox + bx, oy + by, oz + bz) +
                      nu(ox + ax + bx, oy + ay + by, oz + az + bz);
    return 0.5f * nue * soff(u, rdx, a, b, ox, oy, oz);
}

template <bool REBUILD>
__global__ void __launch_bounds__(TZ * TY)
smag_kernel(const __grid_constant__ SmagParams p) {
    __shared__ URing su;
    __shared__ VRing sv;
    const int nx = p.nx, ny = p.ny, nz = p.nz;
    const int z0 = blockIdx.x * TZ, y0 = blockIdx.y * TY, x0 = blockIdx.z * XB;
    const int z = z0 + threadIdx.x, y = y0 + threadIdx.y;
    const bool active = z < nz && y < ny;  // ragged tiles still load and sync
    const int nxb = min(XB, nx - x0);
    const float th = __ldg(p.theta);
    const float cnu = th * th * p.d2;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthreads = blockDim.x * blockDim.y;

    // velocity plane x0 - 2 + k lives in slot k % UR; nu plane x0 - 1 + j
    // in slot j % VR
    auto nu_plane = [&](int k) {  // nu on the plane of velocity index k
        UView u{&su, {(k - 1) % UR, k % UR, (k + 1) % UR}, 0, 0};
        const int vs = (k - 1) % VR;
        for (int e = tid; e < VY * VZ; e += nthreads) {
            const int ly = e / VZ, lz = e - ly * VZ;
            u.ly = ly + 1;
            u.lz = lz + 1;
            sv[vs][ly][lz] = eddy_viscosity(u, p.rdx, cnu);
        }
    };

    for (int k = 0; k < 4; ++k) load_plane<REBUILD>(p, su, k, x0 - 2 + k, y0, z0);
    __syncthreads();
    nu_plane(1);  // plane x0 - 1
    nu_plane(2);  // plane x0
    for (int i = 0; i < nxb; ++i) {
        const int x = x0 + i;
        // plane x + 2 (index i + 4) replaces x - 3, which nothing reads now
        load_plane<REBUILD>(p, su, (i + 4) % UR, x + 2, y0, z0);
        __syncthreads();
        nu_plane(i + 3);  // plane x + 1 replaces x - 2 (read before the sync)
        __syncthreads();
        if (active) {
            const UView u{&su, {(i + 1) % UR, (i + 2) % UR, (i + 3) % UR},
                          (int)threadIdx.y + 2, (int)threadIdx.x + 2};
            const VView nu{&sv, {i % VR, (i + 1) % VR, (i + 2) % VR},
                           (int)threadIdx.y + 1, (int)threadIdx.x + 1};
            const float (&rdx)[3] = p.rdx;
            const float sxy = sig_off(u, nu, rdx, 0, 1, 0, 0, 0);
            const float sxz = sig_off(u, nu, rdx, 0, 2, 0, 0, 0);
            const float syz = sig_off(u, nu, rdx, 1, 2, 0, 0, 0);
            float cx = (sig_diag(u, nu, rdx, 0, 1, 0, 0) - sig_diag(u, nu, rdx, 0, 0, 0, 0)) * rdx[0];
            cx += (sxy - sig_off(u, nu, rdx, 0, 1, 0, -1, 0)) * rdx[1];
            cx += (sxz - sig_off(u, nu, rdx, 0, 2, 0, 0, -1)) * rdx[2];
            float cy = (sxy - sig_off(u, nu, rdx, 0, 1, -1, 0, 0)) * rdx[0];
            cy += (sig_diag(u, nu, rdx, 1, 0, 1, 0) - sig_diag(u, nu, rdx, 1, 0, 0, 0)) * rdx[1];
            cy += (syz - sig_off(u, nu, rdx, 1, 2, 0, 0, -1)) * rdx[2];
            float cz = (sxz - sig_off(u, nu, rdx, 0, 2, -1, 0, 0)) * rdx[0];
            cz += (syz - sig_off(u, nu, rdx, 1, 2, 0, -1, 0)) * rdx[1];
            cz += (sig_diag(u, nu, rdx, 2, 0, 0, 1) - sig_diag(u, nu, rdx, 2, 0, 0, 0)) * rdx[2];
            const size_t n3 = (size_t)nx * ny * nz;
            const size_t idx = ((size_t)x * ny + y) * nz + z;
            if (p.bf) {
                cx = cx + __ldg(p.bf + idx);
                cy = cy + __ldg(p.bf + n3 + idx);
                cz = cz + __ldg(p.bf + 2 * n3 + idx);
            }
            p.out[idx] = cx;
            p.out[n3 + idx] = cy;
            p.out[2 * n3 + idx] = cz;
        }
    }
}

}  // namespace

extern "C" int ins_smag_f32(const float* u, const float* q, const float* bf,
                            const float* theta, float* out, int nx, int ny, int nz,
                            float dx0, float dx1, float dx2, float d2, void* stream) {
    SmagParams p{};
    p.u = u;
    p.q = q;
    p.bf = bf;
    p.theta = theta;
    p.out = out;
    p.nx = nx;
    p.ny = ny;
    p.nz = nz;
    p.dx[0] = dx0;
    p.dx[1] = dx1;
    p.dx[2] = dx2;
    for (int a = 0; a < 3; ++a) p.rdx[a] = 1.0f / p.dx[a];
    p.d2 = d2;
    const dim3 block(TZ, TY);
    const dim3 grid((nz + TZ - 1) / TZ, (ny + TY - 1) / TY, (nx + XB - 1) / XB);
    if (q)
        smag_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(p);
    else
        smag_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}
