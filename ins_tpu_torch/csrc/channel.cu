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
// ca and cb arrive dt-scaled, 1/dx, 1/dy, 1/dx^2 and 1/dy^2 formed on the
// host (`ops/channel_kernels.channel_recips`).  The z coefficients are the
// 12 metric vectors packed (12, nz) by `ops/channel_kernels.pack_zmet` (row
// order below), all 0 at w's pinned slot nz-1.
//
// Replaces: `_channel_msd_kernel` (ins_tpu/ops/channel_kernels.py:175,
// conv-diff `_channel_convdiff` :88, wrapper `channel_msd_3d` :333) and
// `_channel_pc_kernel` (:463, wrapper `channel_pressure_correct_3d` :503).
// The arithmetic is `channel_convdiff_roll`, `channel_divergence_roll` and
// `channel_correct_roll` (ins_tpu_torch/ops/channelpath.py) term for term,
// with every 1/dx, 1/dy, 1/dx^2, 1/dy^2 a multiply by its reciprocal.
// z-neighbours have the rolls' semantics: z is indexed mod nz, and only
// u and v select the wall value at slots 0 and nz-1; w needs no select
// (its pinned slot is 0, and every wrap delivers it as the bottom-wall
// ghost), and w's F is forced to 0 at the pinned slot.
//
// What bounds it on an H100 (both kernels): device-memory bytes.  At 256 x
// 128 x 128 a stage moves 14-20 floats a cell (235-335 MB, 70-100 us at 3.35
// TB/s).  The stencil reads each velocity value some sixty times, so those
// reads stay on chip, and each projection target is formed once a cell;
// what the kernel must keep small is its instructions a cell and the
// latency of its loads, which it does so (the idiom of stage.cu):
//
// * A block of 256 threads (8 warps stacked in y, each thread one z and
//   two y-rows) owns a 16 x 32 (y, z) tile (channel_geometry.cuh) and walks
//   CH_XB = 16 x-planes.  The stencil reads a (16 + 3) x (32 + 3) window
//   of the rebuilt velocity, 1.30x the tile (8 x 32: 1.50x), and a run of
//   16 planes loads 19.
// * Staging is asynchronous: the raw t (or u) and q planes go into rings
//   of shared memory by cp.async copies a plane ahead of their use, while
//   the block computes; 16-byte copies where nz % 4 == 0 (the windows start
//   4 columns before the tile, so no chunk straddles the wrap), else 4-byte
//   ones, with each thread's wrapped offsets formed once a block (`Window`,
//   `Window4`, ring.cuh).  A plane of t is rebuilt in place (u = t -
//   grad(q)/Delta_u from the q ring) one phase after it lands, once per
//   staged element, and read by the three phases after that: q is read
//   from device memory once (it was four times).  The pointwise streams
//   (ustart, acc, force) at the tile's cells go the same way into two
//   staged planes, a plane ahead.
// * The divergence needs each target at x-1, y-1 and z-1: x-1 from the
//   thread's registers (the previous plane's u target; a warm-up plane
//   x0-1 forms it once a run), y-1 and z-1 from the tile's targets in
//   shared memory after a block barrier.  The halo row y0-1 (v targets) is
//   warp 0's and the halo column z0-1 (w targets) warp 7's: a warp pays a
//   whole pass whether one lane works or 32, so the 48 halo targets of a
//   plane cost two warp passes (they cost 9 when lane 0 of every warp
//   formed its row's w target).
// * No division: every 1/dx is a multiply by a reciprocal from the host.
//
// Shared memory: 44.5 KB of u ring, 9.4 KB of q ring (RECON), 1.9 KB of
// metric slice, 4.2 KB of target exchange and two staged planes of 6.2 KB
// a stream: at most 97 KB, two blocks an SM (`__launch_bounds__(256, 2)`).
// The correction is one thread per cell, z fastest across a warp.

#include <cstdint>

#include "channel_geometry.cuh"
#include "ring.cuh"
#include "stencil.cuh"

namespace {

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
    float visc;
    float rdx, rdy, rdx2, rdy2;  // 1/dx, 1/dy, 1/dx^2, 1/dy^2
    float gb[2], gt[2];    // wall velocities of u and v (bottom, top)
    float ca, cb;          // dt-scaled tableau coefficients
    int use_cb, div_of_acc;
};

// A cell's view of the u ring: u(c, I + (ox, oy, oz)), with b the slots'
// offsets (floats) of planes x - 1, x, x + 1 and e the cell's window
// element.
struct View {
    const float* s;
    int b[3];
    int e;
    __device__ __forceinline__ float operator()(int c, int ox, int oy, int oz) const {
        return s[b[ox + 1] + c * CH_HW + e + oy * CH_HZ + oz];
    }
};

// The metric slice's row r at window column mz (global slot z0 - 4 + mz).
__device__ __forceinline__ float zm(const float* met, int r, int mz) {
    return met[r * CH_HZ + mz];
}

// Conv-diff of a tangential component A (0: u, 1: v) at global slot z,
// window column mz.
template <int A>
__device__ __forceinline__ float convdiff_tangential(const MsdParams& p, const View& u,
                                                     const float* met, int z, int mz) {
    constexpr int T = 1 - A;  // the other tangential axis
    constexpr int AX = A == 0, AY = A == 1, TX = T == 0, TY_ = T == 1;
    const float rda = A == 0 ? p.rdx : p.rdy, rdb = A == 0 ? p.rdy : p.rdx;
    const float rda2 = A == 0 ? p.rdx2 : p.rdy2, rdb2 = A == 0 ? p.rdy2 : p.rdx2;
    const float ua = u(A, 0, 0, 0);
    float f = 0.0f;
    // b = A (own axis, uniform)
    const float ua_p = u(A, AX, AY, 0), ua_m = u(A, -AX, -AY, 0);
    const float h2 = 0.5f * (ua + ua_p), h1 = 0.5f * (ua_m + ua);
    f = f - (h2 * h2 - h1 * h1) * rda;
    f = f + p.visc * (ua_p - 2.0f * ua + ua_m) * rda2;
    // b = T (the other tangential axis, uniform)
    const float ua_pt = u(A, TX, TY_, 0), ua_mt = u(A, -TX, -TY_, 0);
    float phi2 = 0.5f * (ua + ua_pt) * (0.5f * (u(T, 0, 0, 0) + u(T, AX, AY, 0)));
    float phi1 = 0.5f * (ua_mt + ua) * (0.5f * (u(T, -TX, -TY_, 0) + u(T, AX - TX, AY - TY_, 0)));
    f = f - (phi2 - phi1) * rdb;
    f = f + p.visc * (ua_pt - 2.0f * ua + ua_mt) * rdb2;
    // b = z (stretched, walls): wall selects on the u/v shifts
    const int nz = p.nz;
    const float ua_zp = z == nz - 1 ? p.gt[A] : u(A, 0, 0, 1);
    const float ua_zm = z == 0 ? p.gb[A] : u(A, 0, 0, -1);
    phi2 = 0.5f * (ua + ua_zp) * (0.5f * (u(2, 0, 0, 0) + u(2, AX, AY, 0)));
    // phi2 at z-1 (mod nz): its upper u/v neighbour is ua, or the top wall
    // where z-1 wraps to nz-1 (there w = 0, so the flux is the wall's 0)
    const float ua_zp_m = z == 0 ? p.gt[A] : ua;
    phi1 = 0.5f * (u(A, 0, 0, -1) + ua_zp_m) * (0.5f * (u(2, 0, 0, -1) + u(2, AX, AY, -1)));
    const float inv_dz = zm(met, INV_DZ, mz);
    f = f - (phi2 - phi1) * inv_dz;
    const float d_hi = (ua_zp - ua) * zm(met, INV_DB_T, mz);
    const float d_lo = (ua - ua_zm) * zm(met, INV_DA_T, mz);
    return f + p.visc * (d_hi - d_lo) * inv_dz;
}

// Conv-diff of the wall-normal component w at global slot z, window
// column mz.
__device__ __forceinline__ float convdiff_normal(const MsdParams& p, const View& u,
                                                 const float* met, int z, int mz) {
    const float w = u(2, 0, 0, 0);
    const float az1 = zm(met, AZ1, mz), az2 = zm(met, AZ2, mz);
    float f = 0.0f;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
        const int bx = b == 0, by = b == 1;
        const float rdb = b == 0 ? p.rdx : p.rdy, rdb2 = b == 0 ? p.rdx2 : p.rdy2;
        const float w_pb = u(2, bx, by, 0), w_mb = u(2, -bx, -by, 0);
        // u_b interpolated along z to the face (plain wrap: the weights are
        // 0 at the pinned slot)
        const float phi2 = 0.5f * (w + w_pb) * (az2 * u(b, 0, 0, 0) + az1 * u(b, 0, 0, 1));
        const float phi1 = 0.5f * (w_mb + w) * (az2 * u(b, -bx, -by, 0) + az1 * u(b, -bx, -by, 1));
        f = f - (phi2 - phi1) * rdb;
        f = f + p.visc * (w_pb - 2.0f * w + w_mb) * rdb2;
    }
    // b = z (own axis): every wrap of w delivers the pinned 0 as the wall
    const float w_zp = u(2, 0, 0, 1), w_zm = u(2, 0, 0, -1);
    const float uab2 = 0.5f * (w + w_zp), uab1 = 0.5f * (w_zm + w);
    const float uba2 = zm(met, AZZ_C2, mz) * w + zm(met, AZZ_C1, mz) * w_zp;
    const float uba1 = zm(met, AZZ_M2, mz) * w_zm + zm(met, AZZ_M1, mz) * w;
    const float inv_duz = zm(met, INV_DUZ, mz);
    f = f - (uab2 * uba2 - uab1 * uba1) * inv_duz;
    const float d_hi = (w_zp - w) * zm(met, INV_DB_N, mz);
    const float d_lo = (w - w_zm) * zm(met, INV_DA_N, mz);
    f = f + p.visc * (d_hi - d_lo) * inv_duz;
    return z == p.nz - 1 ? 0.0f : f;
}

// A cell's pointwise stream values (those the launch has).
struct StreamVals {
    float base, acc, force;
};

// from a staged plane (sb), element i of each stream's block
__device__ __forceinline__ StreamVals staged(const float* sb, const ChannelLayout& L, int i) {
    return {L.base >= 0 ? sb[L.base + i] : 0.0f, L.acc >= 0 ? sb[L.acc + i] : 0.0f,
            L.force >= 0 ? sb[L.force + i] : 0.0f};
}

// from device memory, at flat index idx
__device__ __forceinline__ StreamVals loaded(const MsdParams& p, size_t idx) {
    return {p.ustart ? __ldg(p.ustart + idx) : 0.0f, p.acc ? __ldg(p.acc + idx) : 0.0f,
            p.force ? __ldg(p.force + idx) : 0.0f};
}

// Stage values of component A at the cell the view is centred on (global
// slot z, window column mz); with `store` writes them at flat index idx.
// Returns the projection target.
template <int A>
__device__ __forceinline__ float stage_target(const MsdParams& p, const View& u,
                                              const float* met, int z, int mz,
                                              const StreamVals& s, size_t idx, bool store) {
    float k;
    if constexpr (A == 2)
        k = convdiff_normal(p, u, met, z, mz);
    else
        k = convdiff_tangential<A>(p, u, met, z, mz);
    if (p.force) k = k + s.force;
    const float ua = u(A, 0, 0, 0);
    const float base = p.ustart ? s.base : ua;
    const float accw = p.acc ? s.acc : base;
    const float accn = p.use_cb ? accw + p.cb * k : accw;
    if (store) {
        p.acc_out[idx] = accn;
        if (p.urec) p.urec[idx] = ua;
    }
    if (p.div_of_acc) return accn;
    const float usn = base + p.ca * k;
    if (store) p.us[idx] = usn;
    return usn;
}

// Each thread's wrapped window offsets: 16-byte chunks (VEC) or elements.
template <bool VEC>
struct Wins;
template <>
struct Wins<true> {
    Window4<CH_HY, CH_HZ / 4, CH_NT> u;
    Window4<CH_QY, CH_HZ / 4, CH_NT> q;
};
template <>
struct Wins<false> {
    Window<CH_HY, CH_HZ, CH_NT> u;
    Window<CH_QY, CH_HZ, CH_NT> q;
};

// Copy x-plane xp (wrapped) of the C components of src (component stride
// cs) over a window into `slot` (components WY x CH_HZ apart).
template <bool VEC, int C, class Win>
__device__ __forceinline__ void stage_window(float* slot, const float* src, size_t cs,
                                             const Win& w, int tid) {
    constexpr int CSTRIDE = Win::N * (VEC ? 4 : 1);
#pragma unroll
    for (int k = 0; k < Win::K; ++k) {
        const int e = tid + k * CH_NT;
        if (e < Win::N) {
#pragma unroll
            for (int c = 0; c < C; ++c) {
                if constexpr (VEC)
                    cp_async16f(slot + c * CSTRIDE + 4 * e, src + c * cs + w.off[k]);
                else
                    cp_async4(slot + c * CSTRIDE + e, src + c * cs + w.off[k]);
            }
        }
    }
}

// u = t - grad(q)/Delta_u in place on the u slot `us` over the rebuilt
// columns, with qa and qb the q slots of the same plane and the next (the
// q window shares the u window's corner and row pitch).
__device__ __forceinline__ void rebuild(float* us, const float* qa, const float* qb,
                                        const float* met, const MsdParams& p, int tid) {
    constexpr int N = CH_HY * CH_RW;
    for (int e = tid; e < N; e += CH_NT) {
        const int ly = e / CH_RW, lz = e - ly * CH_RW + CH_RZ0;
        const int i = ly * CH_HZ + lz;
        const float qc = qa[i];
        us[i] -= (qb[i] - qc) * p.rdx;
        us[CH_HW + i] -= (qa[i + CH_HZ] - qc) * p.rdy;
        us[2 * CH_HW + i] -= (qa[i + 1] - qc) * zm(met, INV_DUZ, lz);
    }
}

// The tile cells, halo row and halo column of a launch's streams at the
// x-plane at offset pl (x ny nz) into the staged plane `buf`.  VEC: each
// thread copies 16-byte chunks of the tile's rows (rows past ny clamped,
// columns past nz clamped to the last chunk), else its own cells; the
// halo elements by the threads that form those targets.
template <bool VEC>
__device__ __forceinline__ void stage_streams(const MsdParams& p, float* buf,
                                              const ChannelLayout& L, size_t pl, size_t n3,
                                              int tid, const int (&row)[CH_RY], int cp0,
                                              bool vhalo, int vcell, bool whalo, int wcell) {
    const int ny = p.ny, nz = p.nz, y0 = blockIdx.y * CH_TY, z0 = blockIdx.x * CH_TZ;
    const int lane = tid & 31;
    const auto one = [&](float* d, const float* src) {
        if constexpr (VEC) {
            constexpr int CHUNKS = 3 * CH_TTW / 4, PER_C = CH_TTW / 4;
            for (int e = tid; e < CHUNKS; e += CH_NT) {
                const int c = e / PER_C, r = e - c * PER_C;
                const int ly = r / (CH_TZ / 4), j = r - ly * (CH_TZ / 4);
                const int y = min(y0 + ly, ny - 1), z = min(z0 + 4 * j, nz - 4);
                cp_async16f(d + c * CH_TTW + ly * CH_TZ + 4 * j,
                            src + c * n3 + pl + (size_t)y * nz + z);
            }
        } else {
#pragma unroll
            for (int c = 0; c < 3; ++c)
#pragma unroll
                for (int r = 0; r < CH_RY; ++r)
                    cp_async4(d + c * CH_TTW + cp0 + r * CH_TZ, src + c * n3 + pl + row[r]);
        }
        if (vhalo) cp_async4(d + 3 * CH_TTW + lane, src + n3 + pl + vcell);
        if (whalo) cp_async4(d + 3 * CH_TTW + CH_TZ + lane, src + 2 * n3 + pl + wcell);
    };
    if (L.base >= 0) one(buf + L.base, p.ustart);
    if (L.acc >= 0) one(buf + L.acc, p.acc);
    if (L.force >= 0) one(buf + L.force, p.force);
}

template <bool RECON, bool VEC>
__global__ void __launch_bounds__(CH_NT, 2)
channel_msd_kernel(const __grid_constant__ MsdParams p) {
    float* const sm = dynamic_smem();
    const ChannelLayout L = channel_layout(RECON, p.ustart, p.acc, p.force);
    float* const met = sm + L.met;
    float* const t1s = sm + L.t1;
    float* const t2s = sm + L.t2;
    float* const sst = sm + L.streams;
    const int nx = p.nx, ny = p.ny, nz = p.nz;
    const int lane = threadIdx.x, w = threadIdx.y, tid = w * 32 + lane;
    const int z0 = blockIdx.x * CH_TZ, y0 = blockIdx.y * CH_TY, x0 = blockIdx.z * CH_XB;
    const int nxb = min(CH_XB, nx - x0);
    const size_t n2 = (size_t)ny * nz, n3 = (size_t)nx * n2;
    for (int e = tid; e < CH_NZV * CH_HZ; e += CH_NT) {
        const int r = e / CH_HZ, c = e - r * CH_HZ;
        met[e] = __ldg(p.zmet + (size_t)r * nz + wrap(z0 - CH_ZLO + c, nz));
    }
    Wins<VEC> win;
    win.u.init(tid, y0 - 2, z0 - CH_ZLO, ny, nz);
    if constexpr (RECON) win.q.init(tid, y0 - 2, z0 - CH_ZLO, ny, nz);
    // the thread's cells: z = z0 + lane, y = yb + r (r < RY); cells past
    // the box's edge compute on clamped indices and store nothing
    const int z = z0 + lane, zc = min(z, nz - 1);
    const int yb = y0 + w * CH_RY;
    int row[CH_RY];
#pragma unroll
    for (int r = 0; r < CH_RY; ++r) row[r] = min(yb + r, ny - 1) * nz + zc;
    const int cp0 = w * CH_RY * CH_TZ + lane;  // row 0's element of a tile plane
    // the halo row y0 - 1 (v targets) is warp 0's, the halo column z0 - 1
    // (w targets, one a row) the lanes < TY of the last warp's
    const bool vhalo = w == 0, whalo = w == CH_NW - 1 && lane < CH_TY;
    const int zh = z0 == 0 ? nz - 1 : z0 - 1;
    const int vcell = (y0 == 0 ? ny - 1 : y0 - 1) * nz + zc;
    const int wcell = min(y0 + lane, ny - 1) * nz + zh;
    const int mz = lane + CH_ZLO;                         // the cell's window column
    const int e0 = (w * CH_RY + 2) * CH_HZ + mz;         // row 0's window element
    const int ev = CH_HZ + mz;                           // the v halo cell's
    const int ew = (lane + 2) * CH_HZ + CH_ZLO - 1;      // the w halo cell's (whalo)
    float t0m[CH_RY];                                    // the u targets at x - 1
    // Plane x0 - 2 + l (local index l) lives in u slot l % UR, q slot l %
    // QR and staged stream plane l % SR.  Phase t copies u plane l = t, q
    // plane t + 1 (0 too at t = 0) and the streams of plane t - 2; rebuilds
    // u plane t - 1 (its copies landed at the end of phase t - 1) and
    // computes plane lc = t - 3 (lc = 1: the warm-up plane x0 - 1, then
    // x0 .. x0 + nxb - 1).
    for (int t = 0; t < nxb + 5; ++t) {
        if (t <= nxb + 2)
            stage_window<VEC, 3>(sm + (t % CH_UR) * CH_UPL,
                                 p.u + (size_t)wrap(x0 - 2 + t, nx) * n2, n3, win.u, tid);
        if constexpr (RECON) {
            float* const qr = sm + L.q;
            if (t == 0)
                stage_window<VEC, 1>(qr, p.q + (size_t)wrap(x0 - 2, nx) * n2, 0, win.q, tid);
            if (t <= nxb + 2)
                stage_window<VEC, 1>(qr + ((t + 1) % CH_QR) * CH_QPL,
                                     p.q + (size_t)wrap(x0 - 1 + t, nx) * n2, 0, win.q, tid);
        }
        if (t >= 4 && t <= nxb + 3)
            stage_streams<VEC>(p, sst + ((t - 2) % CH_SR) * L.plane, L,
                               (size_t)(x0 - 4 + t) * n2, n3, tid, row, cp0, vhalo, vcell,
                               whalo, wcell);
        cp_async_commit_group();
        if constexpr (RECON) {
            if (t >= 1 && t <= nxb + 3)
                rebuild(sm + ((t - 1) % CH_UR) * CH_UPL, sm + L.q + ((t - 1) % CH_QR) * CH_QPL,
                        sm + L.q + (t % CH_QR) * CH_QPL, met, p, tid);
        }
        const int lc = t - 3;
        if (lc >= 1) {
            const View u{sm, {((lc - 1) % CH_UR) * CH_UPL, (lc % CH_UR) * CH_UPL,
                              ((lc + 1) % CH_UR) * CH_UPL},
                         e0};
            const int x = x0 - 2 + lc;
            if (lc == 1) {  // the warm-up plane x0 - 1: the u targets alone
                const size_t pl = (size_t)wrap(x, nx) * n2;
#pragma unroll
                for (int r = 0; r < CH_RY; ++r) {
                    View v = u;
                    v.e += r * CH_HZ;
                    t0m[r] = stage_target<0>(p, v, met, z, mz, loaded(p, pl + row[r]), 0, false);
                }
            } else {
                const size_t pl = (size_t)x * n2;
                const float* sb = sst + (lc % CH_SR) * L.plane;  // this plane's streams
                float t0[CH_RY], t1[CH_RY], t2[CH_RY];
#pragma unroll
                for (int r = 0; r < CH_RY; ++r) {
                    View v = u;
                    v.e += r * CH_HZ;
                    const bool act = yb + r < ny && z < nz;
                    const size_t c = pl + row[r];
                    const int ce = cp0 + r * CH_TZ;
                    t0[r] = stage_target<0>(p, v, met, z, mz, staged(sb, L, ce), c, act);
                    t1[r] = stage_target<1>(p, v, met, z, mz, staged(sb, L, CH_TTW + ce),
                                            n3 + c, act);
                    t2[r] = stage_target<2>(p, v, met, z, mz, staged(sb, L, 2 * CH_TTW + ce),
                                            2 * n3 + c, act);
                    t1s[(w * CH_RY + r + 1) * CH_TZ + lane] = t1[r];
                    t2s[(w * CH_RY + r) * (CH_TZ + 1) + lane + 1] = t2[r];
                }
                if (vhalo) {
                    View v = u;
                    v.e = ev;
                    t1s[lane] = stage_target<1>(p, v, met, z, mz,
                                                staged(sb, L, 3 * CH_TTW + lane), 0, false);
                }
                if (whalo) {
                    View v = u;
                    v.e = ew;
                    t2s[lane * (CH_TZ + 1)] =
                        stage_target<2>(p, v, met, zh, CH_ZLO - 1,
                                        staged(sb, L, 3 * CH_TTW + CH_TZ + lane), 0, false);
                }
                __syncthreads();
                const float rdz = zm(met, INV_DZ, mz);
#pragma unroll
                for (int r = 0; r < CH_RY; ++r) {
                    const int ty = w * CH_RY + r;
                    float d = (t0[r] - t0m[r]) * p.rdx;
                    d = d + (t1[r] - t1s[ty * CH_TZ + lane]) * p.rdy;
                    d = d + (t2[r] - t2s[ty * (CH_TZ + 1) + lane]) * rdz;
                    if (yb + r < ny && z < nz) p.div[pl + row[r]] = d;
                    t0m[r] = t0[r];
                }
            }
        }
        // the target exchange is rewritten only after this barrier, and
        // each ring slot is refilled a phase after its last read
        cp_async_wait_all();
        __syncthreads();
    }
}

template <bool RECON, bool VEC>
cudaError_t launch_msd(const MsdParams& p, cudaStream_t stream) {
    const auto kernel = channel_msd_kernel<RECON, VEC>;
    const long smem = channel_smem(channel_layout(RECON, p.ustart, p.acc, p.force));
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    const dim3 grid((p.nz + CH_TZ - 1) / CH_TZ, (p.ny + CH_TY - 1) / CH_TY,
                    (p.nx + CH_XB - 1) / CH_XB);
    kernel<<<grid, dim3(32, CH_NW), smem, stream>>>(p);
    return cudaGetLastError();
}

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

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

// rdx, rdy, rdx2, rdy2: 1/dx, 1/dy, 1/dx^2, 1/dy^2.
extern "C" int ins_channel_msd_f32(const float* u, const float* q, const float* ustart,
                                   const float* acc, const float* force, const float* zmet,
                                   float* urec, float* us, float* acc_out, float* div, int nx,
                                   int ny, int nz, float visc, float rdx, float rdy,
                                   float rdx2, float rdy2, float gb0, float gb1, float gt0,
                                   float gt1, float ca, float cb, int use_cb, int div_of_acc,
                                   void* stream) {
    if (nx < 1 || ny < 1 || nz < 1) return (int)cudaErrorInvalidValue;
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
    p.rdx = rdx;
    p.rdy = rdy;
    p.rdx2 = rdx2;
    p.rdy2 = rdy2;
    p.gb[0] = gb0;
    p.gb[1] = gb1;
    p.gt[0] = gt0;
    p.gt[1] = gt1;
    p.ca = ca;
    p.cb = cb;
    p.use_cb = use_cb;
    p.div_of_acc = div_of_acc;
    // 16-byte staging where every row of a plane is a multiple of four
    // floats and the streams start on 16 bytes
    const bool vec = nz % 4 == 0 && aligned16(u) && aligned16(q) && aligned16(ustart) &&
                     aligned16(acc) && aligned16(force);
    const cudaStream_t s = (cudaStream_t)stream;
    if (q) return (int)(vec ? launch_msd<true, true>(p, s) : launch_msd<true, false>(p, s));
    return (int)(vec ? launch_msd<false, true>(p, s) : launch_msd<false, false>(p, s));
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
