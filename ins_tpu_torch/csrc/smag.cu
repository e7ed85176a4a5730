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
// What bounds it on an H100: device-memory bytes, at best.  With REBUILD
// it reads ut_prev and q and writes F: 7 floats per cell, 470 MB at 256^3
// (0.140 ms at 3.35 TB/s); a body force adds 3 floats.  The stencil has
// radius 2 in every direction (strain, viscosity average and divergence
// each reach one cell), so it runs from shared memory, and each quantity
// is formed once a point:
//
// * A block owns a TY x TZ tile of (y, z) and walks XB x-planes.  Per
//   x-plane it forms the six strain components once on the plane's window
//   (the off-diagonal S_xy, S_xz, S_yz on (TY + 3) x (TZ + 3) points, the
//   diagonal on (TY + 2) x (TZ + 2)) into a ring of three strain planes,
//   then nu from the staged strain on (TY + 2) x (TZ + 2) points into a
//   ring of two nu planes, and each thread its cell's stresses and their
//   divergence from staged strain and nu: no S_ab is formed twice (formed
//   where read, each would be formed about 25 times a cell).  The
//   stresses a thread needs at x - 1 (s_xy, s_xz) and at x (s_xx) are the
//   ones it formed on the plane before, kept in registers.
// * The velocity goes through a ring of four x-planes: each thread copies
//   its window elements (wrapped offsets formed once a block, `Window` of
//   ring.cuh, no `%` in the loops) by 4-byte cp.async copies a phase
//   before the phase that rebuilds them; under REBUILD ut_prev is rebuilt in place
//   (u = ut_prev - grad q, from a ring of three q planes) one phase after
//   it lands.  A phase (one output plane) has two block barriers: the
//   strain and the output plane, then the copies, the rebuild and nu.
// * Every 1/dx is a multiply by a reciprocal computed once (an IEEE
//   division costs ~10 instructions).
//
// Shared memory: 20.7 KB of velocity ring, 5.8 KB of q ring (REBUILD),
// 26.1 KB of strain ring and 2.7 KB of nu ring a block of 256 threads:
// four blocks an SM.
//
// HALO is `smagorinsky_force_halo_3d` (`_smag_force_halo_kernel`,
// ins_tpu/ops/pallas_kernels.py:2176, wrapper :2243): the force on an
// x-slab shard block (3, lx, ny, nz) of a 1-D mesh, whose x-neighbours
// arrive as separate ghost arrays from the ring exchange
// (`parallel/halo.py`): glo lower and 2 upper planes of u (ut_prev), and
// under REBUILD glo lower and 3 upper planes of q.  `stage_u`
// reads plane x from the lower ghosts when x < 0, from the upper ones when
// x >= lx and from the block otherwise, so nothing is concatenated in
// device memory; y and z still wrap.  The output starts at plane x_first:
// 0 with the JAX contract (2 + 2 ghosts -> lx planes), or -1 for the halo
// stage kernels' force stream (3 + 2 ghosts, the JAX kernels' `smag=`
// widths), whose backward divergence at x = 0 reads the force at plane -1;
// that plane goes to out_lo (3, 1, ny, nz), with bf_lo the body force
// there.  Bound at the 4-shard shape (lx = 64, n = 256) with REBUILD and
// x_first = -1: 7 floats a cell over lx + 1 planes, 0.12 GB, 0.035 ms at
// 3.35 TB/s.  The HALO parameters are appended to the struct.

#include "ring.cuh"
#include "stencil.cuh"

namespace {

constexpr int TZ = 32;        // tile extent in z (one warp)
constexpr int TY = 8;         // tile extent in y
constexpr int NT = TZ * TY;   // threads a block, one cell each
constexpr int XB = 32;        // x-planes walked per block
constexpr int UY = TY + 4, UZ = TZ + 4;  // velocity window: 2 cells each side
constexpr int QY = UY + 1, QZ = UZ + 1;  // q window: one more above
constexpr int SY = TY + 3, SZ = TZ + 3;  // off-diagonal strain: 2 below, 1 above
constexpr int DY = TY + 2, DZ = TZ + 2;  // diagonal strain and nu: 1 each side
constexpr int UW = UY * UZ, SW = SY * SZ, DW = DY * DZ;
constexpr int UPL = 3 * UW;               // floats of a velocity plane
constexpr int QPL = QY * QZ;
constexpr int SPL = 3 * SW + 3 * DW;      // a strain plane: xy, xz, yz, then xx, yy, zz
// ring slots (copies a phase ahead: two ahead needed deeper rings, left
// room for fewer blocks an SM and ran slower)
constexpr int UR = 4, QR = 3, SR = 3, VR = 2;

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

using UWin = Window<UY, UZ, NT>;
using QWin = Window<QY, QZ, NT>;

// slot of local plane l (l >= -R) in a ring of R
template <int R>
__device__ __forceinline__ int slot(int l) {
    return (l + R) % R;
}

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

// Copy x-plane xp of u (ut_prev) over the window into the velocity slot
// `dst` ([3][UY][UZ]): on a shard block from the lower ghosts, the block or
// the upper ghosts (HALO), else wrapped.
template <bool HALO>
__device__ __forceinline__ void stage_u(const SmagParams& p, float* dst, int xp, const UWin& w,
                                        int tid) {
    const size_t n2 = (size_t)p.ny * p.nz;
    const float* up;  // component 0 of plane xp; the components lie cs apart
    size_t cs;
    if constexpr (HALO) {
        up = halo_plane(p, p.u_lo, p.u, p.u_hi, xp);
        cs = (size_t)(xp < 0 ? p.glo : xp >= p.lx ? 2 : p.lx) * n2;
    } else {
        up = p.u + (size_t)wrap(xp, p.nx) * n2;
        cs = (size_t)p.nx * n2;
    }
#pragma unroll
    for (int k = 0; k < UWin::K; ++k) {
        const int e = tid + k * NT;
        if (e < UW) {
            cp_async4(dst + e, up + w.off[k]);
            cp_async4(dst + UW + e, up + cs + w.off[k]);
            cp_async4(dst + 2 * UW + e, up + 2 * cs + w.off[k]);
        }
    }
}

// Copy x-plane xp of q over its window into the q slot `dst`.
template <bool HALO>
__device__ __forceinline__ void stage_q(const SmagParams& p, float* dst, int xp, const QWin& w,
                                        int tid) {
    const float* qp = HALO ? halo_plane(p, p.q_lo, p.q, p.q_hi, xp)
                           : p.q + (size_t)wrap(xp, p.nx) * p.ny * p.nz;
#pragma unroll
    for (int k = 0; k < QWin::K; ++k) {
        const int e = tid + k * NT;
        if (e < QPL) cp_async4(dst + e, qp + w.off[k]);
    }
}

// u = ut_prev - grad q in place on the velocity slot `us`, with qa and qb
// the q slots of the same plane and the next.
__device__ __forceinline__ void rebuild(float* us, const float* qa, const float* qb,
                                        const float (&rdx)[3], int tid) {
#pragma unroll
    for (int k = 0; k < UWin::K; ++k) {
        const int e = tid + k * NT;
        if (e < UW) {
            const int ly = e / UZ, lz = e - ly * UZ;
            const int qe = ly * QZ + lz;
            const float qc = qa[qe];
            us[e] -= (qb[qe] - qc) * rdx[0];
            us[UW + e] -= (qa[qe + QZ] - qc) * rdx[1];
            us[2 * UW + e] -= (qa[qe + 1] - qc) * rdx[2];
        }
    }
}

// The six strain components of the plane whose velocity is in slot `a`
// (`m`: the plane below, `b`: the plane above) into the strain slot `s`:
// S_ab = ((u_a(K + e_b) - u_a(K)) / dx_b + (u_b(K + e_a) - u_b(K)) / dx_a) / 2
// (a < b) on the off-diagonal window, S_aa = (u_a(K) - u_a(K - e_a)) / dx_a
// on the diagonal one.
__device__ __forceinline__ void strain(float* s, const float* m, const float* a, const float* b,
                                       const float (&rdx)[3], int tid) {
    for (int e = tid; e < SW; e += NT) {
        const int sy = e / SZ, sz = e - sy * SZ;
        const int ue = sy * UZ + sz;
        const float ax = a[ue], ay = a[UW + ue], az = a[2 * UW + ue];
        s[e] = 0.5f * ((a[ue + UZ] - ax) * rdx[1] + (b[UW + ue] - ay) * rdx[0]);
        s[SW + e] = 0.5f * ((a[ue + 1] - ax) * rdx[2] + (b[2 * UW + ue] - az) * rdx[0]);
        s[2 * SW + e] = 0.5f * ((a[UW + ue + 1] - ay) * rdx[2] + (a[2 * UW + ue + UZ] - az) * rdx[1]);
    }
    float* d = s + 3 * SW;
    for (int e = tid; e < DW; e += NT) {
        const int dy = e / DZ, dz = e - dy * DZ;
        const int ue = (dy + 1) * UZ + dz + 1;
        d[e] = (a[ue] - m[ue]) * rdx[0];
        d[DW + e] = (a[UW + ue] - a[UW + ue - UZ]) * rdx[1];
        d[2 * DW + e] = (a[2 * UW + ue] - a[2 * UW + ue - 1]) * rdx[2];
    }
}

// nu on the diagonal window of the plane whose strain is in slot `c` (`b`:
// the plane below) into the nu slot `v`:
// nu = cnu sqrt(2 sum_a S_aa^2 + sum_{a<b} [S_ab^2 at K, K-e_a, K-e_b, K-e_a-e_b]).
__device__ __forceinline__ void eddy_viscosity(float* v, const float* b, const float* c,
                                               float cnu, int tid) {
    for (int e = tid; e < DW; e += NT) {
        const int dy = e / DZ, dz = e - dy * DZ;
        const int o = (dy + 1) * SZ + dz + 1;  // K on the off-diagonal window
        const float* cd = c + 3 * SW;
        const float sxx = cd[e], syy = cd[DW + e], szz = cd[2 * DW + e];
        float acc = 2.0f * (sxx * sxx + syy * syy + szz * szz);
        {  // S_xy at K, K - e_x, K - e_y, K - e_x - e_y
            const float s0 = c[o], s1 = b[o], s2 = c[o - SZ], s3 = b[o - SZ];
            acc += s0 * s0 + s1 * s1 + s2 * s2 + s3 * s3;
        }
        {  // S_xz at K, K - e_x, K - e_z, K - e_x - e_z
            const float s0 = c[SW + o], s1 = b[SW + o], s2 = c[SW + o - 1], s3 = b[SW + o - 1];
            acc += s0 * s0 + s1 * s1 + s2 * s2 + s3 * s3;
        }
        {  // S_yz at K, K - e_y, K - e_z, K - e_y - e_z
            const float* cy = c + 2 * SW;
            const float s0 = cy[o], s1 = cy[o - SZ], s2 = cy[o - 1], s3 = cy[o - SZ - 1];
            acc += s0 * s0 + s1 * s1 + s2 * s2 + s3 * s3;
        }
        v[e] = cnu * sqrtf(acc);
    }
}

// A cell's view of the staged strain and nu of planes x and x + 1.
struct Staged {
    const float* s[2];  // strain slots
    const float* v[2];  // nu slots
    int o, d;           // the cell on the off-diagonal and the diagonal windows
    // S_ab (ab = 0: xy, 1: xz, 2: yz) and S_aa at K + (ox, oy, oz)
    __device__ __forceinline__ float off(int ab, int ox, int oy, int oz) const {
        return s[ox][ab * SW + o + oy * SZ + oz];
    }
    __device__ __forceinline__ float diag(int a, int ox, int oy, int oz) const {
        return s[ox][3 * SW + a * DW + d + oy * DZ + oz];
    }
    __device__ __forceinline__ float nu(int ox, int oy, int oz) const {
        return v[ox][d + oy * DZ + oz];
    }
    // s_aa = 2 nu S_aa
    __device__ __forceinline__ float sig_diag(int a, int ox, int oy, int oz) const {
        return 2.0f * nu(ox, oy, oz) * diag(a, ox, oy, oz);
    }
    // s_ab (a < b), nu averaged to the a-b edge
    __device__ __forceinline__ float sig_off(int a, int b, int ox, int oy, int oz) const {
        const int ax = a == 0, ay = a == 1, az = a == 2;
        const int bx = b == 0, by = b == 1, bz = b == 2;
        const float nue = nu(ox, oy, oz) + nu(ox + ax, oy + ay, oz + az) +
                          nu(ox + bx, oy + by, oz + bz) +
                          nu(ox + ax + bx, oy + ay + by, oz + az + bz);
        return 0.5f * nue * off(a + b - 1, ox, oy, oz);
    }
};

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

template <bool REBUILD>
constexpr size_t smag_smem() {
    return sizeof(float) * (UR * UPL + (REBUILD ? QR * QPL : 0) + SR * SPL + VR * DW);
}

template <bool REBUILD, bool HALO>
__global__ void __launch_bounds__(NT, 4)
smag_kernel(const __grid_constant__ SmagParams p) {
    float* const su = dynamic_smem();                  // velocity ring
    float* const sq = su + UR * UPL;                   // q ring (REBUILD)
    float* const ss = sq + (REBUILD ? QR * QPL : 0);   // strain ring
    float* const sv = ss + SR * SPL;                   // nu ring
    const int nx = p.nx, ny = p.ny, nz = p.nz;
    // output planes x_first .. lx - 1 on a shard block (HALO), 0 .. nx - 1
    // of the periodic box
    const int z0 = blockIdx.x * TZ, y0 = blockIdx.y * TY,
              x0 = (HALO ? p.x_first : 0) + blockIdx.z * XB;
    const int ty = threadIdx.y, tz = threadIdx.x, tid = ty * TZ + tz;
    const int z = z0 + tz, y = y0 + ty;
    const bool active = z < nz && y < ny;  // ragged tiles still stage and sync
    const int nxb = min(XB, (HALO ? p.lx : nx) - x0);
    const float th = __ldg(p.theta);
    const float cnu = th * th * p.d2;
    UWin wu;
    wu.init(tid, y0 - 2, z0 - 2, ny, nz);
    QWin wq;
    if constexpr (REBUILD) wq.init(tid, y0 - 2, z0 - 2, ny, nz);
    const int co = (ty + 2) * SZ + tz + 2, cd = (ty + 1) * DZ + tz + 1;
    // the cell's stresses carried to the next plane: s_xy and s_xz at
    // x - 1, s_xx at x
    float sxy_m = 0.0f, sxz_m = 0.0f, sxx = 0.0f;
    // Plane x0 - 2 + l (local index l) lives in slot l % R of each ring.
    // Phase tt forms the strain of plane tt - 3 and the output plane x0 +
    // tt - 7 (at tt = 6 the carries of x0 - 1), waits for the copies of
    // phase tt - 1 and syncs; then copies velocity plane tt and q plane
    // tt + 1 (0 too at tt = 0), rebuilds velocity plane tt - 1 and forms nu
    // of plane tt - 3.
    for (int tt = 0; tt <= nxb + 6; ++tt) {
        if (tt >= 3 && tt <= nxb + 5)
            strain(ss + slot<SR>(tt - 3) * SPL, su + slot<UR>(tt - 4) * UPL,
                   su + slot<UR>(tt - 3) * UPL, su + slot<UR>(tt - 2) * UPL, p.rdx, tid);
        if (tt >= 6 && active) {
            // the plane x0 + tt - 7 (tt = 6: x0 - 1, only the carries)
            const Staged st{{ss + slot<SR>(tt - 5) * SPL, ss + slot<SR>(tt - 4) * SPL},
                            {sv + slot<VR>(tt - 5) * DW, sv + slot<VR>(tt - 4) * DW},
                            co, cd};
            const float (&rdx)[3] = p.rdx;
            const float sxy = st.sig_off(0, 1, 0, 0, 0);
            const float sxz = st.sig_off(0, 2, 0, 0, 0);
            const float sxx_p = st.sig_diag(0, 1, 0, 0);  // s_xx at x + 1
            if (tt >= 7) {
                const int x = x0 + tt - 7;
                const float syz = st.sig_off(1, 2, 0, 0, 0);
                float cx = (sxx_p - sxx) * rdx[0];
                cx += (sxy - st.sig_off(0, 1, 0, -1, 0)) * rdx[1];
                cx += (sxz - st.sig_off(0, 2, 0, 0, -1)) * rdx[2];
                float cy = (sxy - sxy_m) * rdx[0];
                cy += (st.sig_diag(1, 0, 1, 0) - st.sig_diag(1, 0, 0, 0)) * rdx[1];
                cy += (syz - st.sig_off(1, 2, 0, 0, -1)) * rdx[2];
                float cz = (sxz - sxz_m) * rdx[0];
                cz += (syz - st.sig_off(1, 2, 0, -1, 0)) * rdx[1];
                cz += (st.sig_diag(2, 0, 0, 1) - st.sig_diag(2, 0, 0, 0)) * rdx[2];
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
            sxy_m = sxy;
            sxz_m = sxz;
            sxx = sxx_p;
        }
        cp_async_wait_all();
        __syncthreads();
        if (tt <= nxb + 3) stage_u<HALO>(p, su + slot<UR>(tt) * UPL, x0 - 2 + tt, wu, tid);
        if constexpr (REBUILD) {
            if (tt == 0) stage_q<HALO>(p, sq, x0 - 2, wq, tid);
            if (tt <= nxb + 3) stage_q<HALO>(p, sq + slot<QR>(tt + 1) * QPL, x0 - 1 + tt, wq, tid);
        }
        cp_async_commit_group();
        if constexpr (REBUILD) {
            if (tt >= 1 && tt <= nxb + 4)
                rebuild(su + slot<UR>(tt - 1) * UPL, sq + slot<QR>(tt - 1) * QPL,
                        sq + slot<QR>(tt) * QPL, p.rdx, tid);
        }
        if (tt >= 4 && tt <= nxb + 5)
            eddy_viscosity(sv + slot<VR>(tt - 3) * DW, ss + slot<SR>(tt - 4) * SPL,
                           ss + slot<SR>(tt - 3) * SPL, cnu, tid);
        __syncthreads();
    }
}

template <bool REBUILD, bool HALO>
cudaError_t launch(const SmagParams& p, int nout, cudaStream_t stream) {
    const auto kernel = smag_kernel<REBUILD, HALO>;
    constexpr size_t smem = smag_smem<REBUILD>();
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.nz + TZ - 1) / TZ, (p.ny + TY - 1) / TY, (nout + XB - 1) / XB);
    kernel<<<grid, dim3(TZ, TY), smem, stream>>>(p);
    return cudaGetLastError();
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
    return (int)(q ? launch<true, false>(p, nx, (cudaStream_t)stream)
                   : launch<false, false>(p, nx, (cudaStream_t)stream));
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
    return (int)(q ? launch<true, true>(p, nout, (cudaStream_t)stream)
                   : launch<false, true>(p, nout, (cudaStream_t)stream));
}
