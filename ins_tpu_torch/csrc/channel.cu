// The wall-bounded channel's two kernels, float32, on the interior channel
// layout (3, nx, ny, nz): x/y periodic, z between no-slip (or sliding)
// walls on a stretched grid, w's top slot pinned to the wall's 0.
//
//   channel_msd      u    = t - grad(q)/Delta_u                (RECON only)
//                    k    = convdiff(u) + force
//                    us   = base + ca k    (base = ustart, or u when null)
//                    acc' = (acc or base) + cb k               (cb = 0: copy)
//                    div  = div(us), or div(acc') when div_of_acc
//                    urec = u                                  (emit_urec)
//   channel_correct  u    = t - grad(q)/Delta_u
//
// ca and cb arrive dt-scaled.  The z coefficients are the 12 metric
// vectors packed (12, nz) by `ops/channel_kernels.pack_zmet` (row order
// below), all 0 at w's pinned slot nz-1.
//
// Replaces: `_channel_msd_kernel` (ins_tpu/ops/channel_kernels.py:175,
// conv-diff `_channel_convdiff` :88, wrapper `channel_msd_3d` :333) and
// `_channel_pc_kernel` (:463, wrapper `channel_pressure_correct_3d` :503).
// The arithmetic is `channel_convdiff_roll`, `channel_divergence_roll` and
// `channel_correct_roll` (ins_tpu_torch/ops/channelpath.py) term for term.
// z-neighbours have the rolls' semantics: z is indexed mod nz, and only
// u and v select the wall value at slots 0 and nz-1; w needs no select
// (its pinned slot is 0, and every wrap delivers it as the bottom-wall
// ghost), and w's F is forced to 0 at the pinned slot.
//
// What bounds it on an H100 (both kernels): device-memory bytes.  At 256 x 128 x 128 a
// stage moves 14-20 floats per cell (235-335 MB, 70-100 us at 3.35 TB/s)
// and the correction 7 (117 MB, 35 us).  The stage stencil reads each
// velocity value some sixty times, so those reads stay on chip: a block
// owns a 32 x 8 (z, y) tile and walks XB x-planes, keeping a ring of four
// x-planes of the (rebuilt) velocity, with a halo of two cells below and
// one above in y and z, in shared memory, next to the tile's slice of the
// metric vectors.  The backward divergence needs the target at x-1, y-1
// and z-1.  Each thread keeps its own x-1 target in a register from the
// previous plane (the first plane of a run computes it once); the y-1 and
// z-1 targets come from the neighbouring threads through shared memory,
// and the tile's edge threads compute the one component the halo row (v)
// and halo column (w) need.  So each target is computed once, plus 5 %
// on the tile edges and one u-component plane per run of XB planes.  The
// correction is one thread per cell, z fastest across a warp.

#include "stencil.cuh"

namespace {

constexpr int TZ = 32;            // tile extent in z (one warp)
constexpr int TY = 8;             // tile extent in y
constexpr int XB = 16;            // x-planes walked per block
constexpr int HZ = TZ + 3;        // halo: 2 below, 1 above
constexpr int HY = TY + 3;
constexpr int RING = 4;           // x-planes x-2 .. x+1
constexpr int NZV = 12;           // packed metric rows
constexpr int MZ = TZ + 1;        // metric slice: z0-1 .. z0+TZ-1

// rows of the packed metric block (ops/channel_kernels.py _ZVECS)
enum { INV_DZ, INV_DA_T, INV_DB_T, INV_DUZ, INV_DA_N, INV_DB_N,
       AZ1, AZ2, AZZ_M1, AZZ_M2, AZZ_C1, AZZ_C2 };

struct MsdParams {
    const float* u;        // velocity, or the unprojected target t (RECON)
    const float* q;        // projection potential (RECON only)
    const float* ustart;   // tableau base; null: the (rebuilt) velocity
    const float* acc;      // accumulator base; null: the tableau base
    const float* force;    // steady force; may be null
    const float* zmet;     // (12, nz) metric rows
    float* urec;           // may be null (RECON only)
    float* us;             // may be null (div_of_acc)
    float* acc_out;
    float* div;
    int nx, ny, nz;
    float visc, dx, dy;
    float gb[2], gt[2];    // wall velocities of u and v (bottom, top)
    float ca, cb;          // dt-scaled tableau coefficients
    int use_cb, div_of_acc;
};

using Ring = float[RING][3][HY][HZ];
using ZSlice = float[NZV][MZ];

// Fill ring slot `slot` with x-plane `xp` of the (rebuilt) velocity over
// the tile's haloed (y, z) window starting at (y0 - 2, z0 - 2).
template <bool RECON>
__device__ __forceinline__ void load_plane(const MsdParams& p, Ring& s, int slot, int xp,
                                           int y0, int z0) {
    const int nx = p.nx, ny = p.ny, nz = p.nz;
    const size_t n3 = (size_t)nx * ny * nz;
    const int x = wrap(xp, nx);
    const int xn = x + 1 == nx ? 0 : x + 1;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthreads = blockDim.x * blockDim.y;
    for (int e = tid; e < HY * HZ; e += nthreads) {
        const int ly = e / HZ, lz = e - ly * HZ;
        const int y = wrap(y0 - 2 + ly, ny), z = wrap(z0 - 2 + lz, nz);
        const size_t i = ((size_t)x * ny + y) * nz + z;
        float u0 = __ldg(p.u + i), u1 = __ldg(p.u + n3 + i), u2 = __ldg(p.u + 2 * n3 + i);
        if constexpr (RECON) {
            const float qc = __ldg(p.q + i);
            const int yn = y + 1 == ny ? 0 : y + 1, zn = z + 1 == nz ? 0 : z + 1;
            u0 = u0 - (__ldg(p.q + ((size_t)xn * ny + y) * nz + z) - qc) / p.dx;
            u1 = u1 - (__ldg(p.q + ((size_t)x * ny + yn) * nz + z) - qc) / p.dy;
            u2 = u2 - (__ldg(p.q + ((size_t)x * ny + y) * nz + zn) - qc) *
                          __ldg(p.zmet + INV_DUZ * nz + z);
        }
        s[slot][0][ly][lz] = u0;
        s[slot][1][ly][lz] = u1;
        s[slot][2][ly][lz] = u2;
    }
}

// A thread's view of the ring around one cell: u(c, I + (ox, oy, oz)).
// The cell's x-plane is slot (i + 2) & 3; i = -1 views the plane before
// the block's first.
struct View {
    const Ring* s;
    int i, ly, lz;
    __device__ __forceinline__ float operator()(int c, int ox, int oy, int oz) const {
        return (*s)[(i + 2 + ox) & 3][c][ly + oy][lz + oz];
    }
};

// Conv-diff of a tangential component A (0: u, 1: v) at global slot z;
// m[r][mz] are the metric rows at z.
template <int A>
__device__ __forceinline__ float convdiff_tangential(const MsdParams& p, const View& u,
                                                     const ZSlice& m, int z, int mz) {
    constexpr int T = 1 - A;  // the other tangential axis
    constexpr int AX = A == 0, AY = A == 1, TX = T == 0, TY_ = T == 1;
    const float da = A == 0 ? p.dx : p.dy, db = A == 0 ? p.dy : p.dx;
    const float ua = u(A, 0, 0, 0);
    float f = 0.0f;
    // b = A (own axis, uniform)
    const float ua_p = u(A, AX, AY, 0), ua_m = u(A, -AX, -AY, 0);
    const float h2 = 0.5f * (ua + ua_p), h1 = 0.5f * (ua_m + ua);
    f = f - (h2 * h2 - h1 * h1) / da;
    f = f + p.visc * (ua_p - 2.0f * ua + ua_m) / (da * da);
    // b = T (the other tangential axis, uniform)
    const float ua_pt = u(A, TX, TY_, 0), ua_mt = u(A, -TX, -TY_, 0);
    float phi2 = 0.5f * (ua + ua_pt) * (0.5f * (u(T, 0, 0, 0) + u(T, AX, AY, 0)));
    float phi1 = 0.5f * (ua_mt + ua) * (0.5f * (u(T, -TX, -TY_, 0) + u(T, AX - TX, AY - TY_, 0)));
    f = f - (phi2 - phi1) / db;
    f = f + p.visc * (ua_pt - 2.0f * ua + ua_mt) / (db * db);
    // b = z (stretched, walls): wall selects on the u/v shifts
    const int nz = p.nz;
    const float ua_zp = z == nz - 1 ? p.gt[A] : u(A, 0, 0, 1);
    const float ua_zm = z == 0 ? p.gb[A] : u(A, 0, 0, -1);
    phi2 = 0.5f * (ua + ua_zp) * (0.5f * (u(2, 0, 0, 0) + u(2, AX, AY, 0)));
    // phi2 at z-1 (mod nz): its upper u/v neighbour is ua, or the top wall
    // where z-1 wraps to nz-1 (there w = 0, so the flux is the wall's 0)
    const float ua_zp_m = z == 0 ? p.gt[A] : ua;
    phi1 = 0.5f * (u(A, 0, 0, -1) + ua_zp_m) * (0.5f * (u(2, 0, 0, -1) + u(2, AX, AY, -1)));
    const float inv_dz = m[INV_DZ][mz];
    f = f - (phi2 - phi1) * inv_dz;
    const float d_hi = (ua_zp - ua) * m[INV_DB_T][mz];
    const float d_lo = (ua - ua_zm) * m[INV_DA_T][mz];
    return f + p.visc * (d_hi - d_lo) * inv_dz;
}

// Conv-diff of the wall-normal component w at global slot z.
__device__ __forceinline__ float convdiff_normal(const MsdParams& p, const View& u,
                                                 const ZSlice& m, int z, int mz) {
    const float w = u(2, 0, 0, 0);
    const float az1 = m[AZ1][mz], az2 = m[AZ2][mz];
    float f = 0.0f;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
        const int bx = b == 0, by = b == 1;
        const float db = b == 0 ? p.dx : p.dy;
        const float w_pb = u(2, bx, by, 0), w_mb = u(2, -bx, -by, 0);
        // u_b interpolated along z to the face (plain wrap: the weights are
        // 0 at the pinned slot)
        const float phi2 = 0.5f * (w + w_pb) * (az2 * u(b, 0, 0, 0) + az1 * u(b, 0, 0, 1));
        const float phi1 = 0.5f * (w_mb + w) * (az2 * u(b, -bx, -by, 0) + az1 * u(b, -bx, -by, 1));
        f = f - (phi2 - phi1) / db;
        f = f + p.visc * (w_pb - 2.0f * w + w_mb) / (db * db);
    }
    // b = z (own axis): every wrap of w delivers the pinned 0 as the wall
    const float w_zp = u(2, 0, 0, 1), w_zm = u(2, 0, 0, -1);
    const float uab2 = 0.5f * (w + w_zp), uab1 = 0.5f * (w_zm + w);
    const float uba2 = m[AZZ_C2][mz] * w + m[AZZ_C1][mz] * w_zp;
    const float uba1 = m[AZZ_M2][mz] * w_zm + m[AZZ_M1][mz] * w;
    const float inv_duz = m[INV_DUZ][mz];
    f = f - (uab2 * uba2 - uab1 * uba1) * inv_duz;
    const float d_hi = (w_zp - w) * m[INV_DB_N][mz];
    const float d_lo = (w - w_zm) * m[INV_DA_N][mz];
    f = f + p.visc * (d_hi - d_lo) * inv_duz;
    return z == p.nz - 1 ? 0.0f : f;
}

// Stage values of component A at the cell (x, y, z) the view is centred
// on; writes them when `write`.  Returns the projection target.
template <int A>
__device__ __forceinline__ float stage_target(const MsdParams& p, const View& u,
                                              const ZSlice& m, int x, int y, int z, int mz,
                                              bool write) {
    const size_t idx = (size_t)A * p.nx * p.ny * p.nz + ((size_t)x * p.ny + y) * p.nz + z;
    float k;
    if constexpr (A == 2)
        k = convdiff_normal(p, u, m, z, mz);
    else
        k = convdiff_tangential<A>(p, u, m, z, mz);
    if (p.force) k = k + __ldg(p.force + idx);
    const float ua = u(A, 0, 0, 0);
    const float base = p.ustart ? __ldg(p.ustart + idx) : ua;
    const float accw = p.acc ? __ldg(p.acc + idx) : base;
    const float accn = p.use_cb ? accw + p.cb * k : accw;
    if (write) {
        p.acc_out[idx] = accn;
        if (p.urec) p.urec[idx] = ua;
    }
    if (p.div_of_acc) return accn;
    const float usn = base + p.ca * k;
    if (write) p.us[idx] = usn;
    return usn;
}

struct MsdShared {
    Ring ring;
    ZSlice m;
    float t1[TY + 1][TZ];   // v targets; row 0 is y0-1
    float t2[TY][TZ + 1];   // w targets; column 0 is z0-1
};

template <bool RECON>
__global__ void __launch_bounds__(TZ * TY)
channel_msd_kernel(const __grid_constant__ MsdParams p) {
    __shared__ MsdShared sh;
    const int nx = p.nx, ny = p.ny, nz = p.nz;
    const int z0 = blockIdx.x * TZ, y0 = blockIdx.y * TY, x0 = blockIdx.z * XB;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int z = z0 + tx, y = y0 + ty;
    const bool active = z < nz && y < ny;  // ragged tiles still load and sync
    const int nxb = min(XB, nx - x0);
    const int tid = ty * TZ + tx;
    for (int e = tid; e < NZV * MZ; e += TZ * TY) {
        const int r = e / MZ, c = e - r * MZ;
        sh.m[r][c] = __ldg(p.zmet + (size_t)r * nz + wrap(z0 - 1 + c, nz));
    }
    for (int r = 0; r < 3; ++r) load_plane<RECON>(p, sh.ring, r, x0 - 2 + r, y0, z0);
    const int mz = tx + 1;
    const int ym = y == 0 ? ny - 1 : y - 1;
    const int zm = z == 0 ? nz - 1 : z - 1;
    View v{&sh.ring, 0, ty + 2, tx + 2};
    float t0_prev = 0.0f;  // the u target at x - 1
    for (int i = 0; i < nxb; ++i) {
        // ring slot (i + 3) & 3 takes plane x + 1; the others hold x-2..x
        load_plane<RECON>(p, sh.ring, (i + 3) & 3, x0 + i + 1, y0, z0);
        __syncthreads();
        const int x = x0 + i;
        float t0 = 0.0f, t1 = 0.0f, t2 = 0.0f;
        if (active) {
            v.i = i;
            if (i == 0) {
                View vm = v;
                vm.i = -1;
                t0_prev = stage_target<0>(p, vm, sh.m, x == 0 ? nx - 1 : x - 1, y, z, mz, false);
            }
            t0 = stage_target<0>(p, v, sh.m, x, y, z, mz, true);
            t1 = stage_target<1>(p, v, sh.m, x, y, z, mz, true);
            t2 = stage_target<2>(p, v, sh.m, x, y, z, mz, true);
            sh.t1[ty + 1][tx] = t1;
            sh.t2[ty][tx + 1] = t2;
            if (ty == 0) {  // the v target of the halo row y0 - 1
                View vh = v;
                vh.ly -= 1;
                sh.t1[0][tx] = stage_target<1>(p, vh, sh.m, x, ym, z, mz, false);
            }
            if (tx == 0) {  // the w target of the halo column z0 - 1
                View vh = v;
                vh.lz -= 1;
                sh.t2[ty][0] = stage_target<2>(p, vh, sh.m, x, y, zm, 0, false);
            }
        }
        __syncthreads();
        if (active) {
            float d = (t0 - t0_prev) / p.dx;
            d = d + (t1 - sh.t1[ty][tx]) / p.dy;
            d = d + (t2 - sh.t2[ty][tx]) * sh.m[INV_DZ][mz];
            p.div[((size_t)x * ny + y) * nz + z] = d;
            t0_prev = t0;
        }
        // the next plane's load refills slot i & 3 only after this step's
        // second barrier, and t1/t2 are rewritten after the next first one
    }
}

__global__ void __launch_bounds__(256)
channel_correct_kernel(const float* __restrict__ t, const float* __restrict__ q,
                       const float* __restrict__ inv_duz, float* __restrict__ u, int nx,
                       int ny, int nz, float dx, float dy) {
    const int z = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    const int x = blockIdx.z;
    if (z >= nz || y >= ny) return;
    const size_t n3 = (size_t)nx * ny * nz;
    const size_t i = ((size_t)x * ny + y) * nz + z;
    const int xn = x + 1 == nx ? 0 : x + 1, yn = y + 1 == ny ? 0 : y + 1;
    const int zn = z + 1 == nz ? 0 : z + 1;
    const float qc = __ldg(q + i);
    u[i] = __ldg(t + i) - (__ldg(q + ((size_t)xn * ny + y) * nz + z) - qc) / dx;
    u[n3 + i] = __ldg(t + n3 + i) - (__ldg(q + ((size_t)x * ny + yn) * nz + z) - qc) / dy;
    u[2 * n3 + i] = __ldg(t + 2 * n3 + i) -
                    (__ldg(q + ((size_t)x * ny + y) * nz + zn) - qc) * __ldg(inv_duz + z);
}

}  // namespace

extern "C" int ins_channel_msd_f32(const float* u, const float* q, const float* ustart,
                                   const float* acc, const float* force, const float* zmet,
                                   float* urec, float* us, float* acc_out, float* div, int nx,
                                   int ny, int nz, float visc, float dx, float dy, float gb0,
                                   float gb1, float gt0, float gt1, float ca, float cb,
                                   int use_cb, int div_of_acc, void* stream) {
    MsdParams p{};
    p.u = u;
    p.q = q;
    p.ustart = ustart;
    p.acc = acc;
    p.force = force;
    p.zmet = zmet;
    p.urec = urec;
    p.us = us;
    p.acc_out = acc_out;
    p.div = div;
    p.nx = nx;
    p.ny = ny;
    p.nz = nz;
    p.visc = visc;
    p.dx = dx;
    p.dy = dy;
    p.gb[0] = gb0;
    p.gb[1] = gb1;
    p.gt[0] = gt0;
    p.gt[1] = gt1;
    p.ca = ca;
    p.cb = cb;
    p.use_cb = use_cb;
    p.div_of_acc = div_of_acc;
    const dim3 block(TZ, TY);
    const dim3 grid((nz + TZ - 1) / TZ, (ny + TY - 1) / TY, (nx + XB - 1) / XB);
    if (q)
        channel_msd_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(p);
    else
        channel_msd_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

extern "C" int ins_channel_correct_f32(const float* t, const float* q, const float* zmet,
                                       float* u, int nx, int ny, int nz, float dx, float dy,
                                       void* stream) {
    const dim3 block(32, 8);
    const dim3 grid((nz + 31) / 32, (ny + 7) / 8, nx);
    channel_correct_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        t, q, zmet + INV_DUZ * nz, u, nx, ny, nz, dx, dy);
    return (int)cudaGetLastError();
}
