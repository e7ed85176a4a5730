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
//
// HALO is `smagorinsky_force_halo_3d` (`_smag_force_halo_kernel`,
// ins_tpu/ops/pallas_kernels.py:2176, wrapper :2243): the force on an
// x-slab shard block (3, lx, ny, nz) of a 1-D mesh, whose x-neighbours
// arrive as separate ghost arrays from the ring exchange
// (`parallel/halo.py`): glo lower and 2 upper planes of u (ut_prev), and
// under REBUILD glo lower and 3 upper planes of q.  `load_plane_halo`
// reads plane x from the lower ghosts when x < 0, from the upper ones when
// x >= lx and from the block otherwise, so nothing is concatenated in
// device memory; y and z still wrap.  The output starts at plane x_first:
// 0 with the JAX contract (2 + 2 ghosts -> lx planes), or -1 for the halo
// stage kernels' force stream (3 + 2 ghosts, the JAX kernels' `smag=`
// widths), whose backward divergence at x = 0 reads the force at plane -1;
// that plane goes to out_lo (3, 1, ny, nz), with bf_lo the body force
// there.  Bound at the 4-shard shape (lx = 64, n = 256) with REBUILD and
// x_first = -1: 7 floats a cell over lx + 1 planes, 0.12 GB, 0.035 ms at
// 3.35 TB/s.  Without HALO the kernel compiles as before (its parameters
// are appended to the struct).

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
    // the x-slab shard block (HALO only)
    int lx;              // x extent of the block (nx is unused)
    int glo;             // lower ghost planes of u and q (2 or 3)
    int x_first;         // first output plane (0 or -1, 2 - glo at the least)
    const float* u_lo;   // (3, glo, ny, nz): planes -glo .. -1 of u
    const float* u_hi;   // (3, 2, ny, nz): planes lx, lx + 1
    const float* q_lo;   // (glo, ny, nz) (REBUILD)
    const float* q_hi;   // (3, ny, nz): planes lx .. lx + 2 (REBUILD)
    const float* bf_lo;  // (3, 1, ny, nz): the body force at plane -1
    float* out_lo;       // (3, 1, ny, nz): the output at plane -1
};

using URing = float[UR][3][UY][UZ];
using VRing = float[VR][VY][VZ];

// Plane x (-glo <= x <= lx + 2) of a scalar on a shard block: the lower
// ghosts, the block or the upper ghosts (HALO).
__device__ __forceinline__ const float* halo_plane(const SmagParams& p, const float* lo,
                                                   const float* blk, const float* hi,
                                                   int x) {
    const size_t n2 = (size_t)p.ny * p.nz;
    if (x < 0) return lo + (size_t)(x + p.glo) * n2;
    if (x >= p.lx) return hi + (size_t)(x - p.lx) * n2;
    return blk + (size_t)x * n2;
}

// `load_plane` on a shard block: plane xp (x_first - 2 <= xp <= lx + 1) of
// u from the lower ghosts, the block or the upper ghosts, and q's planes
// xp and xp + 1 likewise (REBUILD).
template <bool REBUILD>
__device__ __forceinline__ void load_plane_halo(const SmagParams& p, URing& s, int slot,
                                                int xp, int y0, int z0) {
    const int ny = p.ny, nz = p.nz;
    const size_t n2 = (size_t)ny * nz;
    // component 0 of plane xp; the components lie cs apart
    const float* up = halo_plane(p, p.u_lo, p.u, p.u_hi, xp);
    const size_t cs = (size_t)(xp < 0 ? p.glo : xp >= p.lx ? 2 : p.lx) * n2;
    const float* qp = REBUILD ? halo_plane(p, p.q_lo, p.q, p.q_hi, xp) : nullptr;
    const float* qn = REBUILD ? halo_plane(p, p.q_lo, p.q, p.q_hi, xp + 1) : nullptr;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthreads = blockDim.x * blockDim.y;
    for (int e = tid; e < UY * UZ; e += nthreads) {
        const int ly = e / UZ, lz = e - ly * UZ;
        const int y = wrap(y0 - 2 + ly, ny), z = wrap(z0 - 2 + lz, nz);
        const size_t i = (size_t)y * nz + z;
        float u0 = __ldg(up + i), u1 = __ldg(up + cs + i), u2 = __ldg(up + 2 * cs + i);
        if constexpr (REBUILD) {
            const float qc = __ldg(qp + i);
            const int yn = y + 1 == ny ? 0 : y + 1, zn = z + 1 == nz ? 0 : z + 1;
            u0 -= (__ldg(qn + i) - qc) / p.dx[0];
            u1 -= (__ldg(qp + (size_t)yn * nz + z) - qc) / p.dx[1];
            u2 -= (__ldg(qp + (size_t)y * nz + zn) - qc) / p.dx[2];
        }
        s[slot][0][ly][lz] = u0;
        s[slot][1][ly][lz] = u1;
        s[slot][2][ly][lz] = u2;
    }
}

// Fill ring slot `slot` with x-plane `xp` of the (rebuilt) velocity over
// the tile's haloed (y, z) window starting at (y0 - 2, z0 - 2).
template <bool REBUILD, bool HALO>
__device__ __forceinline__ void load_plane(const SmagParams& p, URing& s, int slot,
                                           int xp, int y0, int z0) {
    if constexpr (HALO) {
        load_plane_halo<REBUILD>(p, s, slot, xp, y0, z0);
        return;
    }
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

// The output of one cell (F + bf) on a shard block: planes 0 .. lx - 1,
// and out_lo at x = -1 (HALO).
__device__ __forceinline__ void store_halo(const SmagParams& p, int x, int y, int z,
                                           float cx, float cy, float cz) {
    const int ny = p.ny, nz = p.nz;
    const bool lo = x < 0;
    const size_t cs = (size_t)(lo ? 1 : p.lx) * ny * nz;
    const size_t idx = ((size_t)(lo ? 0 : x) * ny + y) * nz + z;
    const float* bf = lo ? p.bf_lo : p.bf;
    float* out = lo ? p.out_lo : p.out;
    if (bf) {
        cx = cx + __ldg(bf + idx);
        cy = cy + __ldg(bf + cs + idx);
        cz = cz + __ldg(bf + 2 * cs + idx);
    }
    out[idx] = cx;
    out[cs + idx] = cy;
    out[2 * cs + idx] = cz;
}

template <bool REBUILD, bool HALO>
__global__ void __launch_bounds__(TZ * TY)
smag_kernel(const __grid_constant__ SmagParams p) {
    __shared__ URing su;
    __shared__ VRing sv;
    const int nx = p.nx, ny = p.ny, nz = p.nz;
    // output planes x_first .. lx - 1 on a shard block (HALO), 0 .. nx - 1
    // of the periodic box
    const int z0 = blockIdx.x * TZ, y0 = blockIdx.y * TY,
              x0 = (HALO ? p.x_first : 0) + blockIdx.z * XB;
    const int z = z0 + threadIdx.x, y = y0 + threadIdx.y;
    const bool active = z < nz && y < ny;  // ragged tiles still load and sync
    const int nxb = min(XB, (HALO ? p.lx : nx) - x0);
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

    for (int k = 0; k < 4; ++k) load_plane<REBUILD, HALO>(p, su, k, x0 - 2 + k, y0, z0);
    __syncthreads();
    nu_plane(1);  // plane x0 - 1
    nu_plane(2);  // plane x0
    for (int i = 0; i < nxb; ++i) {
        const int x = x0 + i;
        // plane x + 2 (index i + 4) replaces x - 3, which nothing reads now
        load_plane<REBUILD, HALO>(p, su, (i + 4) % UR, x + 2, y0, z0);
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
            if constexpr (HALO) {
                store_halo(p, x, y, z, cx, cy, cz);
            } else {
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
        smag_kernel<true, false><<<grid, block, 0, (cudaStream_t)stream>>>(p);
    else
        smag_kernel<false, false><<<grid, block, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

// The force on an x-slab shard block (HALO): u (ut_prev with q) is the
// (3, lx, ny, nz) block, u_lo/u_hi its ring neighbours' glo lower / 2
// upper planes, q_lo/q_hi the glo lower / 3 upper planes of q (with q),
// bf the body force on the block and bf_lo at plane -1 (with bf when
// x_first = -1).  Writes planes 0 .. lx - 1 to out and, when x_first =
// -1, plane -1 to out_lo.
extern "C" int ins_smag_halo_f32(const float* u, const float* u_lo, const float* u_hi,
                                 const float* q, const float* q_lo, const float* q_hi,
                                 const float* bf, const float* bf_lo, const float* theta,
                                 float* out, float* out_lo, int lx, int ny, int nz, int glo,
                                 int x_first, float dx0, float dx1, float dx2, float d2,
                                 void* stream) {
    if (lx < 1 || !u_lo || !u_hi || (glo != 2 && glo != 3)) return (int)cudaErrorInvalidValue;
    if ((x_first != 0 && x_first != -1) || x_first - 2 < -glo) return (int)cudaErrorInvalidValue;
    if (q && (!q_lo || !q_hi)) return (int)cudaErrorInvalidValue;
    if (x_first < 0 && (!out_lo || (bf && !bf_lo))) return (int)cudaErrorInvalidValue;
    SmagParams p{};
    p.u = u;
    p.q = q;
    p.bf = bf;
    p.theta = theta;
    p.out = out;
    p.ny = ny;
    p.nz = nz;
    p.dx[0] = dx0;
    p.dx[1] = dx1;
    p.dx[2] = dx2;
    for (int a = 0; a < 3; ++a) p.rdx[a] = 1.0f / p.dx[a];
    p.d2 = d2;
    p.lx = lx;
    p.glo = glo;
    p.x_first = x_first;
    p.u_lo = u_lo;
    p.u_hi = u_hi;
    p.q_lo = q_lo;
    p.q_hi = q_hi;
    p.bf_lo = bf_lo;
    p.out_lo = out_lo;
    const int nout = lx - x_first;
    const dim3 block(TZ, TY);
    const dim3 grid((nz + TZ - 1) / TZ, (ny + TY - 1) / TY, (nout + XB - 1) / XB);
    if (q)
        smag_kernel<true, true><<<grid, block, 0, (cudaStream_t)stream>>>(p);
    else
        smag_kernel<false, true><<<grid, block, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}
