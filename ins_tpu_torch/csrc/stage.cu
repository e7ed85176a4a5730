// Stage stencil kernel: conv-diff + RK tableau accumulation + divergence
//
// For every cell I of the periodic cube:
//
//   u     = ut_prev - grad(q)   (REBUILD: q physical, forward differences)
//         | u                   (no rebuild: u is an input)
//   f     = convdiff(u)(I) + buoy(I) + force(I) (-> k_out if requested)
//   ut    = base + sum_j ck_j k_j + cnew f      (base = u when null: RECON)
//   usnew = (usnew_base or base) + cusnew f     (the b-row accumulator)
//   u_out = u                                   (emit_u, REBUILD only)
//   div   = vol * sum_a (ut_a(I) - ut_a(I - e_a)) / dx_a
//
// and, with the Boussinesq temperature stream (TEMP), the buoyancy
// buoy_g = alpha2 (T(I) + T(I + e_g)) / 2 in component g = gdir only, and
//
//   kt       = sum_b [-(u_b Tb(I) - u_b Tb(I - e_b))
//                     + alpha4 (dT_b(I) - dT_b(I - e_b))] / dx_b
//              + dis * sum_b (g_b(I) + g_b(I - e_b)) / 2   (with_dis)
//   temp_out = (tstart or T) + cnew kt
//   tempnew  = (tacc or tstart or T) + cusnew kt            (with usnew)
//
// with Tb(I) = (T(I) + T(I + e_b)) / 2, dT_b(I) = (T(I + e_b) - T(I)) / dx_b
// and g_b = u_b * visc * Laplacian(u_b): `_stage_tail`'s temperature half
// (ins_tpu/ops/pallas_kernels.py:1018-1036, 1066-1117).
//
// Replaces: the stencil part of `_pcmsd_hat_kernel`
// (ins_tpu/ops/pallas_kernels.py:2341, wrapper `pcmsd_hat_3d` :2694) and
// of `_msd_hat_kernel` / `_stage_tail` (:692, :972, wrapper
// `momentum_stage_divhat_3d` :1264), with their steady body-force stream
// (`bf(a)`, :1037).  The conv-diff is
// `_convdiff_window` (:129) / `convdiff_roll` term for term (`convdiff_r`
// below, with every 1/dx a multiply).  The TPU
// kernels apply the z/y eigen-transforms of q and div in the same pass;
// here the wrappers run them as plane-transform GEMMs (transforms.cu)
// before (q) and after (div) this kernel, so q and div each make one
// extra scalar round trip through device memory.  Removing those round
// trips (a block-level fused transform) is later work (ROADMAP queue 2).
// The force stream carries a steady body force or, with the JAX
// kernels' `smag=` option, the Smagorinsky force (+ body force) that
// smag.cu computed in a pass of its own just before: the TPU kernels form
// it inside the stage (`_stage_tail` :1011-1034), so the force makes one
// extra round trip through device memory here (fusing it is later work,
// ROADMAP queue 2).  The temperature stream (`tparams` of both TPU
// kernels, :724-757 and :2372-2406) is the TEMP template flag.
//
// What bounds it on an H100: device-memory bytes, at best.  With REBUILD
// and a stream base it reads ut_prev, q and the tableau streams and writes
// ut, usnew (and u) and div: 14-17 floats per cell, 0.9-1.1 GB per call
// at 256^3 (0.28-0.34 ms at 3.35 TB/s).  The conv-diff reads each
// velocity about fifteen times per cell, so those reads come from shared
// memory; what the kernel must then keep small is its instructions per
// cell, and it does so four ways:
//
// * Each cell's tendency f and tableau value ut are formed once.  A block
//   owns a (y, z) tile of TY x TZ cells and walks XB x-planes; a warp owns
//   32 z-columns of RY consecutive y-rows, each thread one z and RY y.  The
//   backward divergence takes ut_0 at x - 1 from the thread's registers
//   (the previous plane's value; one warm-up plane at x0 - 1 forms ut_0
//   alone), ut_1 at y - 1 from the thread's previous row (or, for its
//   first row, from ut_1 at that row's y - 1, which the warp forms once a
//   plane) and ut_2 at z - 1 from the next lane down (a warp shuffle; lane
//   0 takes the value at z0 - 1, which lanes 0 .. RY - 1 form once a plane,
//   one row each).  The tableau streams and the force are read once a cell,
//   and once more only at those halo cells.  Under TEMP the dissipation
//   g_b = u_b * visc * Laplacian(u_b) is formed the same way, once a cell,
//   with the Laplacian summed from the diffusion terms the conv-diff has
//   just formed, and g_b(I - e_b) comes from the same registers and
//   shuffles.
// * Every 1/dx is a multiply by a reciprocal formed once (an IEEE division
//   is a call of ~10 instructions, and the stage divides ~30 times a
//   cell), and visc/dx^2 too.
// * Staging is asynchronous and has no `%`: each thread's window elements'
//   wrapped (y, z) offsets are formed once a block (`Window`, ring.cuh),
//   and the raw ut_prev (or u), q and T planes go into rings of shared
//   memory by 4-byte cp.async copies a plane ahead of their use, while the
//   block computes.  A plane of ut_prev is rebuilt in place (u = ut_prev -
//   grad q from the q ring) one phase after it lands and used in the three
//   phases after that: five u slots, three q slots, four T slots.  Each
//   phase issues the next copies, rebuilds a plane, computes one x-plane
//   and ends with one block barrier.  The pointwise streams (base,
//   usnew_base, the force, the k streams, tstart, tacc) at the thread's own
//   cells go the same way into two staged planes, a plane ahead, so their
//   loads stay off the arithmetic's dependency chain (read directly, they
//   held the kernel at its old speed).  bf16 streams (S) are widened by
//   plain loads into the same ring and planes (cp.async copies 4 bytes at
//   least).
// * The tile is 16 x 32 cells (the haloed window (16 + 3) x (32 + 3) is
//   1.30x the tile, against 1.50x for 8 x 32) and a block walks 32
//   x-planes (35 u planes loaded for 32, against 11 for 8).
//
// A block of 256 threads (8 warps of RY = 2 rows; 128 registers a thread)
// holds 39.9 KB of u ring, 8.6 KB of q ring (REBUILD), 9.8 KB of T ring
// (TEMP) and two staged planes of 7.2 KB a vector stream and 2 KB a
// scalar one: two blocks an SM.  Four rows a thread (4 warps) took more
// registers and ran 10 % slower; more warps a block with one row each,
// slower still (the halo rows and cells are then a larger share).
//
// HALO runs the stage on an x-slab shard block of a 1-D mesh: the port of
// `_msd_hat_halo_kernel` (:1542, wrapper `momentum_stage_divhat_halo_3d`
// :1730) and `_pcmsd_hat_halo_kernel` (:2877, wrapper `pcmsd_hat_halo_3d`
// :3183).  The block is (3, lx, n, n); its x-neighbours arrive as separate
// ghost arrays from the ring exchange (`parallel/halo.py`): 2 lower and 1
// upper plane of u (ut_prev), 2 and 2 of q (the rebuild's forward
// x-difference reaches plane lx + 1) and plane -1 of each tableau stream
// (the backward divergence reads its component 0 there).  `stage_u`
// reads plane x from the lower ghosts when x < 0, from the upper one when
// x >= lx and from the block otherwise; y and z still wrap.  The TPU
// kernels' segmented window DMAs (`_seg_window_copy` :1497) and their
// slab-size pick have no counterpart: a block reads a ghost plane where it
// needs it.  Bound at the 4-shard shape (lx = 64, n = 256): the same 14-17
// floats a cell over 4.2M cells, 0.23-0.29 GB, 0.07-0.09 ms at 3.35 TB/s;
// the ghost planes add 3-5 %.
//
// HALO with FORCE is the shard stage's force stream: a steady body force
// (`bodyforce=` of the JAX halo kernels) or, with their `smag=` option,
// the Smagorinsky force (+ body force) that smag.cu's HALO kernel computed
// just before on planes -1 .. lx - 1.  The force arrives as the block
// (3, lx, n, n) and its plane -1 (3, 1, n, n), which the backward
// divergence at x = 0 reads, like the tableau streams' lower planes.  With
// `smag=` the JAX kernels widen the ghosts of u (ut_prev) to 3 lower and 2
// upper planes and those of q to 3 and 3 (the force kernel reads them; the
// stage still reads planes -2 .. lx of u and -2 .. lx + 1 of q), so the
// FORCE variants take the lower and upper ghost counts as parameters
// (glo, ghi); the FORCE-less ones keep (2, 1) as constants.
// The shard stage has no temperature stream (the JAX halo kernels
// have none).
//
// S is the storage type of the velocity-like streams: float, or bf16 for
// the opt-in bf16 stream storage (`compute_dtype` of
// `momentum_stage_divhat_3d` :1264, bf16 `ut_prev` of `pcmsd_hat_3d`
// :2694, the dtype rules at :2802-2808).  u (ut_prev), base, the k streams,
// usnew_base and the force are read as S and widened; k, ut, usnew and u
// are rounded to S on the store.  q, div and all arithmetic stay float,
// so the divergence is that of the float ut, as in the JAX kernels.  The
// pointers of StageParams stay float* (the float kernels' parameter
// layout); `ld`/`st` read them as S.  The bf16 variants are the non-HALO
// ones without TEMP (the JAX halo kernels have no stream dtype).  At 256^3
// a bf16 REBUILD stage with a stream base moves 8 float and 8 bf16 values
// a cell where the float one moves 16: 0.40 against 0.54 GB a call.
//
// STREAMS is the stage with more than MAXK k streams, the port of
// `_msd_hat_stream_kernel` (:1126, chosen at :1386-1392): their pointers
// and coefficients come from a small device table (ktab, kctab) and the
// tableau loops over p.m at run time.  The TPU kernel folds the streams
// through one buffer to keep VMEM flat in their count; here each stream
// is a single load a cell, so nothing is staged.
// It runs without REBUILD and TEMP (the JAX kernel is `_msd_hat_kernel`'s
// twin); at 256^3 with m = 9 it reads 11 vector fields and writes 3: 2.8
// GB, 0.84 ms at 3.35 TB/s.  The m <= MAXK kernels unroll their
// loop.

#include <type_traits>

#include "ring.cuh"
#include "stencil.cuh"

namespace {

constexpr int MAXK = 4;
constexpr int TZ = 32;                  // tile extent in z: a warp's lanes
constexpr int RY = 2;                   // y-rows a thread
constexpr int NW = 8;                   // warps a block, stacked in y
constexpr int TY = RY * NW;             // tile extent in y
constexpr int NT = 32 * NW;             // threads a block
constexpr int XB = 32;                  // x-planes walked per block
constexpr int HY = TY + 3, HZ = TZ + 3;  // u window: 2 cells below, 1 above
constexpr int HW = HY * HZ;
constexpr int QY = HY + 1, QZ = HZ + 1;  // q window: one more above
constexpr int TWY = TY + 2, TWZ = TZ + 2;  // T window: one cell each side
constexpr int UPL = 3 * HW;             // floats of a u plane (3 components)
constexpr int QPL = QY * QZ;
constexpr int TPL = TWY * TWZ;

// Ring slots: a plane is copied a phase before the phase that first reads
// it (copies two phases ahead needed deeper rings, left room for fewer
// blocks an SM and ran slower: PERF.md).
constexpr int UR = 5;  // u: copied, rebuilt, then read by three planes
constexpr int QR = 3;  // q
constexpr int TR = 4;  // T
constexpr int SR = 2;  // staged stream planes
constexpr unsigned FULL = 0xffffffffu;
constexpr int TTW = TY * TZ;            // floats of a tile plane
// floats of a staged vector stream's plane: the tile's three components,
// then component 1 on each warp's y-halo row and component 2 on its
// z-halo cells
constexpr int VSZ = 3 * TTW + NW * TZ + NW * RY;

// Offsets (floats) of the staged pointwise streams in a plane's buffer,
// -1 where a stream is absent: base, usnew_base, the force and the m k
// streams (VSZ each), then tstart and tacc (TTW each); size: the buffer.
struct Layout {
    int base, usnew, force, k, tstart, tacc, size;
};

__host__ __device__ inline Layout layout(bool base, bool usnew, bool force, int mk, bool tstart,
                                         bool tacc) {
    Layout L;
    int o = 0;
    L.base = base ? o : -1;
    o += base ? VSZ : 0;
    L.usnew = usnew ? o : -1;
    o += usnew ? VSZ : 0;
    L.force = force ? o : -1;
    o += force ? VSZ : 0;
    L.k = o;
    o += mk * VSZ;
    L.tstart = tstart ? o : -1;
    o += tstart ? TTW : 0;
    L.tacc = tacc ? o : -1;
    o += tacc ? TTW : 0;
    L.size = o;
    return L;
}

struct StageParams {
    const float* u;           // velocity, or ut_prev when REBUILD
    const float* q;           // physical pressure (REBUILD only)
    const float* base;        // tableau base; null: the (rebuilt) velocity
    const float* k[MAXK];     // earlier-stage k streams
    float ck[MAXK];
    int m;
    float cnew;
    const float* usnew_base;  // null: base
    const float* force;       // added to f; may be null
    float cusnew;
    int with_usnew;
    float* k_out;             // may be null
    float* ut_out;
    float* usnew_out;         // may be null
    float* u_out;             // may be null (REBUILD only)
    float* div_out;
    int n;
    float visc;
    float dx[3];
    float vol;
    // the temperature stream (TEMP only)
    const float* T;           // the stage's temperature
    const float* tstart;      // its tableau base; null: T
    const float* tacc;        // the tempnew base; null: tstart or T
    float* temp_out;
    float* tempnew_out;       // written when with_usnew
    int gdir;
    float alpha2, alpha4, dis;
    int with_dis;
    // the x-slab shard block (HALO only)
    int lx;                   // x extent of the block (n: the cube)
    const float* u_lo;        // (3, glo, n, n): planes -glo .. -1 of u (ut_prev)
    const float* u_hi;        // (3, ghi, n, n): planes lx .. lx + ghi - 1
    const float* q_lo;        // (glo, n, n): q planes -glo .. -1 (REBUILD)
    const float* q_hi;        // (ghi + 1, n, n): q planes lx .. (REBUILD)
    const float* base_lo;     // (3, 1, n, n): plane -1 of base (with base)
    const float* k_lo[MAXK];  // (3, 1, n, n): plane -1 of each k stream
    // the shard stage's force stream (HALO with FORCE only)
    const float* force_lo;    // (3, 1, n, n): plane -1 of the force
    int glo;                  // lower ghost planes of u and q: 2, or 3 (smag=)
    int ghi;                  // upper ghost planes of u: 1, or 2 (smag=)
    // the k-stream table (STREAMS only): m pointers, then m coefficients
    const unsigned long long* ktab;
    const float* kctab;
};

// 1/dx_b and visc/dx_b^2, formed once a thread
struct Consts {
    float rdx[3];
    float cd[3];
};

__device__ __forceinline__ Consts consts(const StageParams& p) {
    Consts c;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
        c.rdx[b] = 1.0f / p.dx[b];
        c.cd[b] = p.visc * (c.rdx[b] * c.rdx[b]);
    }
    return c;
}

// The staged streams of a launch (the k streams only when unrolled).
template <bool FORCE, bool TEMP, bool STREAMS>
__host__ __device__ inline Layout layout_of(const StageParams& p) {
    return layout(p.base != nullptr, p.with_usnew && p.usnew_base != nullptr, FORCE,
                  STREAMS ? 0 : p.m, TEMP && p.tstart != nullptr,
                  TEMP && p.with_usnew && p.tacc != nullptr);
}

// A thread's cells, the same on every x-plane: in-plane offsets y n + z of
// its RY rows (clamped to the box), of its warp's y-halo cell and (lanes <
// RY) z-halo cell, and their elements in a staged plane.
struct Cells {
    int row[RY];
    int yrow, zrow;
    int cp0, yhs, zhs;
    bool zlane;
};

// A velocity-like stream stored as S, read and written through the
// float* fields of StageParams.
template <class S>
__device__ __forceinline__ float ld(const float* p, size_t i) {
    return ldg_f(reinterpret_cast<const S*>(p), i);
}
template <class S>
__device__ __forceinline__ void st(float* p, size_t i, float v) {
    st_f(reinterpret_cast<S*>(p), i, v);
}

// A cell's view of the u ring: u(c, I + (ox, oy, oz)), with b the slots'
// offsets (floats) of planes x - 1, x, x + 1 and e the cell's window
// element.
struct View {
    const float* s;
    int b[3];
    int e;
    __device__ __forceinline__ float operator()(int c, int ox, int oy, int oz) const {
        return s[b[ox + 1] + c * HW + e + oy * HZ + oz];
    }
};

// The same view of the T ring: T(I + (ox, oy, oz)).
struct TView {
    const float* s;
    int b[3];
    int e;
    __device__ __forceinline__ float operator()(int ox, int oy, int oz) const {
        return s[b[ox + 1] + e + oy * TWZ + oz];
    }
};

// Conv-diff of component A at the view's cell (`convdiff_roll` term for
// term, every 1/dx a multiply); lap = visc * Laplacian(u_A), the
// sum of its diffusion terms.
template <int A>
__device__ __forceinline__ float convdiff_r(const Consts& k, const View& u, float& lap) {
    const float ua = u(A, 0, 0, 0);
    float f = 0.0f, l = 0.0f;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
        const int ex = b == 0, ey = b == 1, ez = b == 2;
        const float upb = u(A, ex, ey, ez);
        const float umb = u(A, -ex, -ey, -ez);
        const float fd = k.cd[b] * (upb - 2.0f * ua + umb);
        l = l + fd;
        const float uab1 = 0.5f * (umb + ua);
        const float uab2 = 0.5f * (ua + upb);
        float uba1, uba2;
        if (A == b) {
            uba1 = uab1;
            uba2 = uab2;
        } else {
            const int ax = A == 0, ay = A == 1, az = A == 2;
            const float ub = u(b, 0, 0, 0);
            const float ub_pa = u(b, ax, ay, az);
            const float ub_mb = u(b, -ex, -ey, -ez);
            const float ub_pa_mb = u(b, ax - ex, ay - ey, az - ez);
            uba1 = 0.5f * (ub_mb + ub_pa_mb);
            uba2 = 0.5f * (ub + ub_pa);
        }
        f = f + (fd - (uab2 * uba2 - uab1 * uba1) * k.rdx[b]);
    }
    lap = l;
    return f;
}

// Tableau value base + sum_j ck_j k_j + cnew f at flat index idx.
template <class S, bool STREAMS>
__device__ __forceinline__ float tableau(const StageParams& p, size_t idx, float b0, float f) {
    float ut = b0;
    if constexpr (STREAMS) {
        for (int j = 0; j < p.m; ++j) {
            const float* k = reinterpret_cast<const float*>(__ldg(p.ktab + j));
            ut = ut + __ldg(p.kctab + j) * ld<S>(k, idx);
        }
    } else {
#pragma unroll
        for (int j = 0; j < MAXK; ++j)
            if (j < p.m) ut = ut + p.ck[j] * ld<S>(p.k[j], idx);
    }
    return ut + p.cnew * f;
}

// ut_A at a cell (stream index idx = A n3 + cell); with `store` (a tile
// cell inside the box) also its outputs k, ut, usnew and u.  lap: visc *
// Laplacian(u_A) there.  STG: the pointwise streams come from the staged
// plane (sv: the cell's element there, L: the streams' offsets), else
// from device memory.
template <bool REBUILD, bool FORCE, bool TEMP, class S, bool STREAMS, int A, bool STG>
__device__ __forceinline__ float cell_ut(const StageParams& p, const Consts& k, const View& u,
                                         const TView& T, size_t idx, bool store, float& lap,
                                         const float* sv, const Layout& L) {
    float f = convdiff_r<A>(k, u, lap);
    if constexpr (TEMP) {
        if (A == p.gdir) f = f + p.alpha2 * (0.5f * (T(0, 0, 0) + T(A == 0, A == 1, A == 2)));
    }
    if constexpr (FORCE) f = f + (STG ? sv[L.force] : ld<S>(p.force, idx));
    const float ua = u(A, 0, 0, 0);
    const float b0 = p.base ? (STG ? sv[L.base] : ld<S>(p.base, idx)) : ua;
    float ut;
    if constexpr (STG && !STREAMS) {
        ut = b0;
#pragma unroll
        for (int j = 0; j < MAXK; ++j)
            if (j < p.m) ut = ut + p.ck[j] * sv[L.k + j * VSZ];
        ut = ut + p.cnew * f;
    } else {
        ut = tableau<S, STREAMS>(p, idx, b0, f);
    }
    if (store) {
        if (p.k_out) st<S>(p.k_out, idx, f);
        st<S>(p.ut_out, idx, ut);
        if (p.with_usnew) {
            const float ub =
                p.usnew_base ? (STG ? sv[L.usnew] : ld<S>(p.usnew_base, idx)) : b0;
            st<S>(p.usnew_out, idx, ub + p.cusnew * f);
        }
        if (REBUILD && p.u_out) st<S>(p.u_out, idx, ua);
    }
    return ut;
}

// The temperature outputs at cell c (TEMP), with g = u_b visc Lap(u_b) at
// I and gm at I - e_b; tstart and tacc from the staged plane (sv: the
// cell's element there).
__device__ __forceinline__ void temperature(const StageParams& p, const Consts& k,
                                            const View& u, const TView& T, size_t c,
                                            const float (&g)[3], const float (&gm)[3],
                                            const float* sv, const Layout& L) {
    const float tc = T(0, 0, 0);
    float kt = 0.0f;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
        const int ex = b == 0, ey = b == 1, ez = b == 2;
        const float tp = T(ex, ey, ez), tm = T(-ex, -ey, -ez);
        const float uT2 = u(b, 0, 0, 0) * (0.5f * (tc + tp));
        const float uT1 = u(b, -ex, -ey, -ez) * (0.5f * (tm + tc));
        const float dT2 = (tp - tc) * k.rdx[b];
        const float dT1 = (tc - tm) * k.rdx[b];
        kt = kt + (-(uT2 - uT1) + p.alpha4 * (dT2 - dT1)) * k.rdx[b];
    }
    if (p.with_dis) {
        float dacc = 0.0f;
#pragma unroll
        for (int b = 0; b < 3; ++b) dacc = dacc + 0.5f * (g[b] + gm[b]);
        kt = kt + p.dis * dacc;
    }
    const float tb = p.tstart ? sv[L.tstart] : tc;
    p.temp_out[c] = tb + p.cnew * kt;
    if (p.with_usnew) {
        const float ta = p.tacc ? sv[L.tacc] : tb;
        p.tempnew_out[c] = ta + p.cusnew * kt;
    }
}

using UWin = Window<HY, HZ, NT>;
using QWin = Window<QY, QZ, NT>;
using TWin = Window<TWY, TWZ, NT>;

// Plane x (-2 <= x <= lx + 1) of q on a shard block: the lower ghosts
// (glo of them), the block or the upper ghosts (HALO).
__device__ __forceinline__ const float* halo_qplane(const StageParams& p, int x, int glo) {
    const size_t n2 = (size_t)p.n * p.n;
    if (x < 0) return p.q_lo + (size_t)(x + glo) * n2;
    if (x >= p.lx) return p.q_hi + (size_t)(x - p.lx) * n2;
    return p.q + (size_t)x * n2;
}

// Copy x-plane xp of u (ut_prev) over the window into the u slot `slot`
// ([3][HY][HZ]): on a shard block from the lower ghosts, the block or the
// upper ghost (HALO); bf16 storage by plain loads, widened.
template <bool FORCE, bool HALO, class S>
__device__ __forceinline__ void stage_u(const StageParams& p, float* slot, int xp,
                                        const UWin& w, int tid) {
    const int n = p.n;
    const size_t n2 = (size_t)n * n;
    const float* src;
    size_t cs;  // component stride
    if constexpr (HALO) {
        const int glo = FORCE ? p.glo : 2, ghi = FORCE ? p.ghi : 1;
        if (xp < 0) {
            src = p.u_lo;
            cs = (size_t)glo * n2;
            xp += glo;
        } else if (xp >= p.lx) {
            src = p.u_hi;
            cs = (size_t)ghi * n2;
            xp -= p.lx;
        } else {
            src = p.u;
            cs = (size_t)p.lx * n2;
        }
    } else {
        src = p.u;
        cs = n2 * n;
        xp = wrap(xp, n);
    }
    const S* sp = reinterpret_cast<const S*>(src) + (size_t)xp * n2;
#pragma unroll
    for (int kk = 0; kk < UWin::K; ++kk) {
        const int e = tid + kk * NT;
        if (e < HW) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                if constexpr (std::is_same<S, float>::value)
                    cp_async4(slot + c * HW + e, sp + c * cs + w.off[kk]);
                else
                    slot[c * HW + e] = ldg_f(sp + c * cs, w.off[kk]);
            }
        }
    }
}

// Copy x-plane xp of q over its window into the q slot `slot`.
template <bool FORCE, bool HALO>
__device__ __forceinline__ void stage_q(const StageParams& p, float* slot, int xp,
                                        const QWin& w, int tid) {
    const float* qp = HALO ? halo_qplane(p, xp, FORCE ? p.glo : 2)
                           : p.q + (size_t)wrap(xp, p.n) * p.n * p.n;
#pragma unroll
    for (int kk = 0; kk < QWin::K; ++kk) {
        const int e = tid + kk * NT;
        if (e < QPL) cp_async4(slot + e, qp + w.off[kk]);
    }
}

// Copy x-plane xp of T over its window into the T slot `slot`.
__device__ __forceinline__ void stage_t(const StageParams& p, float* slot, int xp,
                                        const TWin& w, int tid) {
    const float* tp = p.T + (size_t)wrap(xp, p.n) * p.n * p.n;
#pragma unroll
    for (int kk = 0; kk < TWin::K; ++kk) {
        const int e = tid + kk * NT;
        if (e < TPL) cp_async4(slot + e, tp + w.off[kk]);
    }
}

// u = ut_prev - grad q in place on the u slot `us`, with qa and qb the q
// slots of the same plane and the next.
__device__ __forceinline__ void rebuild(float* us, const float* qa, const float* qb,
                                        const Consts& k, int tid) {
#pragma unroll
    for (int kk = 0; kk < UWin::K; ++kk) {
        const int e = tid + kk * NT;
        if (e < HW) {
            const int ly = e / HZ, lz = e - ly * HZ;
            const int qe = ly * QZ + lz;
            const float qc = qa[qe];
            us[e] -= (qb[qe] - qc) * k.rdx[0];
            us[HW + e] -= (qa[qe + QZ] - qc) * k.rdx[1];
            us[2 * HW + e] -= (qa[qe + 1] - qc) * k.rdx[2];
        }
    }
}

// One element of a stream stored as S into a staged plane: a cp.async
// copy for float; a bf16 element (2 bytes, below cp.async's 4) is loaded
// and widened.
template <class S>
__device__ __forceinline__ void stage_one(float* d, const float* src, size_t i) {
    if constexpr (std::is_same<S, float>::value)
        cp_async4(d, src + i);
    else
        *d = ld<S>(src, i);
}

// Copy the pointwise streams of the x-plane at offset pl (x n^2) at the
// thread's cells into the staged plane `buf` (layout L).
template <bool FORCE, bool TEMP, class S, bool STREAMS>
__device__ __forceinline__ void stage_streams(const StageParams& p, float* buf, const Layout& L,
                                              size_t pl, size_t n3, const Cells& cl) {
    const auto vec = [&](float* d, const float* src) {
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int r = 0; r < RY; ++r)
                stage_one<S>(d + a * TTW + cl.cp0 + r * TZ, src, a * n3 + pl + cl.row[r]);
        stage_one<S>(d + cl.yhs, src, n3 + pl + cl.yrow);
        if (cl.zlane) stage_one<S>(d + cl.zhs, src, 2 * n3 + pl + cl.zrow);
    };
    const auto sca = [&](float* d, const float* src) {
#pragma unroll
        for (int r = 0; r < RY; ++r) stage_one<float>(d + cl.cp0 + r * TZ, src, pl + cl.row[r]);
    };
    if (L.base >= 0) vec(buf + L.base, p.base);
    if (L.usnew >= 0) vec(buf + L.usnew, p.usnew_base);
    if constexpr (FORCE) vec(buf + L.force, p.force);
    if constexpr (!STREAMS) {
#pragma unroll
        for (int j = 0; j < MAXK; ++j)
            if (j < p.m) vec(buf + L.k + j * VSZ, p.k[j]);
    }
    if constexpr (TEMP) {
        if (L.tstart >= 0) sca(buf + L.tstart, p.tstart);
        if (L.tacc >= 0) sca(buf + L.tacc, p.tacc);
    }
}

// the rings' shared memory (the staged planes come after them)
template <bool REBUILD, bool TEMP>
__host__ __device__ constexpr int ring_floats() {
    return UR * UPL + (REBUILD ? QR * QPL : 0) + (TEMP ? TR * TPL : 0);
}

template <bool REBUILD, bool FORCE, bool TEMP, bool HALO, class S = float,
          bool STREAMS = false>
__global__ void __launch_bounds__(NT, 2)
stage_kernel(const __grid_constant__ StageParams p) {
    static_assert(!(HALO && TEMP), "the shard stage has no T stream");
    static_assert(!HALO || (std::is_same<S, float>::value && !STREAMS),
                  "the shard stage stores float and takes at most MAXK k streams");
    static_assert(!TEMP || std::is_same<S, float>::value, "the T stream is float");
    float* const sm = dynamic_smem();
    constexpr int QOFF = UR * UPL;                            // the q ring
    constexpr int TOFF = QOFF + (REBUILD ? QR * QPL : 0);    // the T ring
    constexpr int SOFF = ring_floats<REBUILD, TEMP>();       // two staged planes
    const Layout L = layout_of<FORCE, TEMP, STREAMS>(p);
    const int n = p.n;
    const int lane = threadIdx.x, w = threadIdx.y, tid = w * 32 + lane;
    const int z0 = blockIdx.x * TZ, y0 = blockIdx.y * TY, x0 = blockIdx.z * XB;
    const int nx = min(XB, (HALO ? p.lx : n) - x0);
    const Consts k = consts(p);
    UWin wu;
    wu.init(tid, y0 - 2, z0 - 2, n, n);
    QWin wq;
    if constexpr (REBUILD) wq.init(tid, y0 - 2, z0 - 2, n, n);
    TWin wt;
    if constexpr (TEMP) wt.init(tid, y0 - 1, z0 - 1, n, n);
    // the thread's cells: z = z0 + lane, y = yb + r (r < RY); cells past
    // the box's edge compute on clamped indices and store nothing
    const int z = z0 + lane, zc = min(z, n - 1);
    const int yb = y0 + w * RY;
    Cells cl;
#pragma unroll
    for (int r = 0; r < RY; ++r) cl.row[r] = min(yb + r, n - 1) * n + zc;
    cl.yrow = (yb == 0 ? n - 1 : min(yb, n) - 1) * n + zc;               // y-halo row
    cl.zrow = min(yb + lane, n - 1) * n + (z0 == 0 ? n - 1 : z0 - 1);    // z-halo column
    cl.cp0 = w * RY * TZ + lane;
    cl.yhs = 3 * TTW + w * TZ + lane;
    cl.zhs = 3 * TTW + NW * TZ + w * RY + lane;
    cl.zlane = lane < RY;
    const size_t n2 = (size_t)n * n;
    const size_t n3 = (size_t)(HALO ? p.lx : n) * n2;
    const int e0 = (w * RY + 2) * HZ + lane + 2;         // row 0's window elements
    const int et0 = (w * RY + 1) * TWZ + lane + 1;
    float ut0m[RY], g0m[RY];                             // ut_0, g_0 at x - 1
    // Plane x0 - 2 + l (local index l) lives in u slot l % UR, q slot
    // l % QR, T slot l % TR and staged stream plane l % SR.  Phase t copies
    // u plane l = t, q plane t + 1 (0 too at t = 0), T plane t - 1 and the
    // pointwise streams of plane t - 2; rebuilds u plane t - 1 (its copies
    // landed at the end of phase t - 1) and computes plane lc = t - 3
    // (lc = 1: the warm-up plane x0 - 1, then x0 .. x0 + nx - 1).
    for (int t = 0; t < nx + 5; ++t) {
        if (t <= nx + 2) stage_u<FORCE, HALO, S>(p, sm + (t % UR) * UPL, x0 - 2 + t, wu, tid);
        if constexpr (REBUILD) {
            if (t == 0) stage_q<FORCE, HALO>(p, sm + QOFF, x0 - 2, wq, tid);
            if (t <= nx + 2)
                stage_q<FORCE, HALO>(p, sm + QOFF + ((t + 1) % QR) * QPL, x0 - 1 + t, wq, tid);
        }
        if constexpr (TEMP) {
            if (t >= 2 && t <= nx + 3)
                stage_t(p, sm + TOFF + ((t - 1) % TR) * TPL, x0 - 3 + t, wt, tid);
        }
        if (t >= 4 && t <= nx + 3)
            stage_streams<FORCE, TEMP, S, STREAMS>(p, sm + SOFF + ((t - 2) % SR) * L.size, L,
                                                   (size_t)(x0 - 4 + t) * n2, n3, cl);
        cp_async_commit_group();
        if constexpr (REBUILD) {
            if (t >= 1 && t <= nx + 3)
                rebuild(sm + ((t - 1) % UR) * UPL, sm + QOFF + ((t - 1) % QR) * QPL,
                        sm + QOFF + (t % QR) * QPL, k, tid);
        }
        const int lc = t - 3;
        if (lc >= 1) {
            const View u{sm, {((lc - 1) % UR) * UPL, (lc % UR) * UPL, ((lc + 1) % UR) * UPL},
                         e0};
            const TView tv{sm + TOFF, {((lc - 1) % TR) * TPL, (lc % TR) * TPL,
                                       ((lc + 1) % TR) * TPL},
                           et0};
            const int x = x0 - 2 + lc;
            if (lc == 1) {  // the warm-up plane x0 - 1: ut_0 and g_0 only
                // on a shard block's plane -1 the streams' lower planes,
                // through the same code as every other plane's
                StageParams wp = p;
                int xw = x < 0 ? x + n : x;
                if (HALO && x < 0) {
                    wp.base = p.base_lo;
                    wp.force = p.force_lo;
#pragma unroll
                    for (int j = 0; j < MAXK; ++j) wp.k[j] = p.k_lo[j];
                    xw = 0;
                }
#pragma unroll
                for (int r = 0; r < RY; ++r) {
                    View v = u;
                    v.e += r * HZ;
                    TView T = tv;
                    T.e += r * TWZ;
                    float lap;
                    ut0m[r] = cell_ut<REBUILD, FORCE, TEMP, S, STREAMS, 0, false>(
                        wp, k, v, T, (size_t)xw * n2 + cl.row[r], false, lap, nullptr, L);
                    g0m[r] = v(0, 0, 0, 0) * lap;
                }
            } else {
                const size_t pl = (size_t)x * n2;
                const float* sb = sm + SOFF + (lc % SR) * L.size;  // this plane's streams
                float lap;
                // the y-halo row: ut_1 and g_1 at (x, y - 1) of row 0
                View vh = u;
                vh.e -= HZ;
                TView th = tv;
                th.e -= TWZ;
                float ut1m = cell_ut<REBUILD, FORCE, TEMP, S, STREAMS, 1, true>(
                    p, k, vh, th, n3 + pl + cl.yrow, false, lap, sb + cl.yhs, L);
                float g1m = vh(1, 0, 0, 0) * lap;
                // the z-halo column: ut_2 and g_2 at (x, yb + lane, z0 - 1), lanes < RY
                float hut = 0.0f, hg = 0.0f;
                if (cl.zlane) {
                    View vz = u;
                    vz.e += lane * HZ - lane - 1;
                    TView tz = tv;
                    tz.e += lane * TWZ - lane - 1;
                    hut = cell_ut<REBUILD, FORCE, TEMP, S, STREAMS, 2, true>(
                        p, k, vz, tz, 2 * n3 + pl + cl.zrow, false, lap, sb + cl.zhs, L);
                    hg = vz(2, 0, 0, 0) * lap;
                }
#pragma unroll
                for (int r = 0; r < RY; ++r) {
                    View v = u;
                    v.e += r * HZ;
                    TView T = tv;
                    T.e += r * TWZ;
                    const bool act = yb + r < n && z < n;
                    const size_t c = pl + cl.row[r];
                    const float* sc = sb + cl.cp0 + r * TZ;
                    float l0, l1, l2;
                    const float ut0 = cell_ut<REBUILD, FORCE, TEMP, S, STREAMS, 0, true>(
                        p, k, v, T, c, act, l0, sc, L);
                    const float ut1 = cell_ut<REBUILD, FORCE, TEMP, S, STREAMS, 1, true>(
                        p, k, v, T, n3 + c, act, l1, sc + TTW, L);
                    const float ut2 = cell_ut<REBUILD, FORCE, TEMP, S, STREAMS, 2, true>(
                        p, k, v, T, 2 * n3 + c, act, l2, sc + 2 * TTW, L);
                    float ut2m = __shfl_up_sync(FULL, ut2, 1);
                    const float h2 = __shfl_sync(FULL, hut, r);
                    if (lane == 0) ut2m = h2;
                    const float d = (ut0 - ut0m[r]) * k.rdx[0] + (ut1 - ut1m) * k.rdx[1] +
                                    (ut2 - ut2m) * k.rdx[2];
                    if (act) p.div_out[c] = d * p.vol;
                    if constexpr (TEMP) {
                        const float g[3] = {v(0, 0, 0, 0) * l0, v(1, 0, 0, 0) * l1,
                                            v(2, 0, 0, 0) * l2};
                        float g2m = __shfl_up_sync(FULL, g[2], 1);
                        const float hg2 = __shfl_sync(FULL, hg, r);
                        if (lane == 0) g2m = hg2;
                        const float gm[3] = {g0m[r], g1m, g2m};
                        if (act) temperature(p, k, v, T, c, g, gm, sc, L);
                        g0m[r] = g[0];
                        g1m = g[1];
                    }
                    ut0m[r] = ut0;
                    ut1m = ut1;
                }
            }
        }
        cp_async_wait_all();
        __syncthreads();
    }
}

// Launch one instantiation on the cube (or the shard block's) grid.
template <bool REBUILD, bool FORCE, bool TEMP, bool HALO, class S = float,
          bool STREAMS = false>
cudaError_t launch(const StageParams& p, int nx, cudaStream_t stream) {
    const auto kernel = stage_kernel<REBUILD, FORCE, TEMP, HALO, S, STREAMS>;
    const size_t smem = sizeof(float) * (ring_floats<REBUILD, TEMP>() +
                                         SR * layout_of<FORCE, TEMP, STREAMS>(p).size);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    const int n = p.n;
    const dim3 grid((n + TZ - 1) / TZ, (n + TY - 1) / TY, (nx + XB - 1) / XB);
    kernel<<<grid, dim3(32, NW), smem, stream>>>(p);
    return cudaGetLastError();
}

using Launch = cudaError_t (*)(const StageParams&, int, cudaStream_t);

}  // namespace

// The cube stage with the velocity-like streams stored as S.  With m >
// MAXK k streams, ktable is a device array of their m pointers (64-bit)
// followed by their m float coefficients (kptrs and kcoef unused), and
// the STREAMS kernel runs (no rebuild, no temperature).
template <class S>
static int launch_stage(const float* u, const float* q, const float* base,
                        const void* const* kptrs, const float* kcoef, int m, float cnew,
                        const float* usnew_base, const float* force, float cusnew,
                        int with_usnew, float* k_out, float* ut_out, float* usnew_out,
                        float* u_out, float* div_out, int n, float visc, float dx0, float dx1,
                        float dx2, float vol, const float* T, const float* tstart,
                        const float* tacc, float* temp_out, float* tempnew_out, int gdir,
                        float alpha2, float alpha4, float dis, int with_dis,
                        const void* ktable, cudaStream_t stream) {
    constexpr bool F32 = std::is_same<S, float>::value;
    const bool many = m > MAXK;
    if (n < 1 || m < 0 || (many && (!ktable || q || T))) return (int)cudaErrorInvalidValue;
    if (T && (!F32 || gdir < 0 || gdir > 2 || !temp_out || (with_usnew && !tempnew_out) ||
              m != 0))
        return (int)cudaErrorInvalidValue;
    StageParams p{};
    p.u = u;
    p.q = q;
    p.base = base;
    if (many) {
        p.ktab = static_cast<const unsigned long long*>(ktable);
        p.kctab = reinterpret_cast<const float*>(p.ktab + m);
    } else {
        for (int j = 0; j < m; ++j) {
            p.k[j] = static_cast<const float*>(kptrs[j]);
            p.ck[j] = kcoef[j];
        }
    }
    p.m = m;
    p.cnew = cnew;
    p.usnew_base = usnew_base;
    p.force = force;
    p.cusnew = cusnew;
    p.with_usnew = with_usnew;
    p.k_out = k_out;
    p.ut_out = ut_out;
    p.usnew_out = usnew_out;
    p.u_out = u_out;
    p.div_out = div_out;
    p.n = n;
    p.visc = visc;
    p.dx[0] = dx0;
    p.dx[1] = dx1;
    p.dx[2] = dx2;
    p.vol = vol;
    p.T = T;
    p.tstart = tstart;
    p.tacc = tacc;
    p.temp_out = temp_out;
    p.tempnew_out = tempnew_out;
    p.gdir = gdir;
    p.alpha2 = alpha2;
    p.alpha4 = alpha4;
    p.dis = dis;
    p.with_dis = with_dis;
    Launch run;
    if (many) {
        run = force ? launch<false, true, false, false, S, true>
                    : launch<false, false, false, false, S, true>;
    } else if constexpr (F32) {
        const Launch runs[2][2][2] = {
            {{launch<false, false, false, false>, launch<false, false, true, false>},
             {launch<false, true, false, false>, launch<false, true, true, false>}},
            {{launch<true, false, false, false>, launch<true, false, true, false>},
             {launch<true, true, false, false>, launch<true, true, true, false>}},
        };
        run = runs[q != nullptr][force != nullptr][T != nullptr];
    } else {
        const Launch runs[2][2] = {
            {launch<false, false, false, false, S>, launch<false, true, false, false, S>},
            {launch<true, false, false, false, S>, launch<true, true, false, false, S>},
        };
        run = runs[q != nullptr][force != nullptr];
    }
    return (int)run(p, n, stream);
}

#define INS_STAGE_ARGS                                                                      \
    const float *u, const float *q, const float *base, const void *const *kptrs,            \
        const float *kcoef, int m, float cnew, const float *usnew_base, const float *force, \
        float cusnew, int with_usnew, float *k_out, float *ut_out, float *usnew_out,        \
        float *u_out, float *div_out, int n, float visc, float dx0, float dx1, float dx2,   \
        float vol, const float *T, const float *tstart, const float *tacc, float *temp_out, \
        float *tempnew_out, int gdir, float alpha2, float alpha4, float dis, int with_dis,  \
        const void *ktable, void *stream
#define INS_STAGE_FORWARD                                                                  \
    u, q, base, kptrs, kcoef, m, cnew, usnew_base, force, cusnew, with_usnew, k_out, ut_out, \
        usnew_out, u_out, div_out, n, visc, dx0, dx1, dx2, vol, T, tstart, tacc, temp_out,  \
        tempnew_out, gdir, alpha2, alpha4, dis, with_dis, ktable, (cudaStream_t)stream

extern "C" int ins_stage_f32(INS_STAGE_ARGS) { return launch_stage<float>(INS_STAGE_FORWARD); }

// The same stage with u (ut_prev), base, the k streams, usnew_base, the
// force and the k, ut, usnew and u outputs holding bf16 (their pointers
// typed float* as above); q, div and the temperature pointers float.
extern "C" int ins_stage_bf16(INS_STAGE_ARGS) {
    return launch_stage<__nv_bfloat16>(INS_STAGE_FORWARD);
}

// The stage on an x-slab shard block (HALO): u (ut_prev with q) is the
// (3, lx, n, n) block, u_lo/u_hi its ring neighbours' glo lower / ghi
// upper planes, q_lo/q_hi the glo lower / ghi + 1 upper planes of q,
// base_lo and klo_ptrs each tableau stream's plane -1 (the backward
// divergence reads its component 0 at x = -1), force/force_lo the force
// stream on the block and at plane -1 (both or neither).  (glo, ghi) is
// (2, 1), or (3, 2) with a force (the JAX kernels' `smag=` ghosts).  The
// outputs have the block's extent.
extern "C" int ins_stage_halo_f32(const float* u, const float* u_lo, const float* u_hi,
                                  const float* q, const float* q_lo, const float* q_hi,
                                  const float* base, const float* base_lo,
                                  const void* const* kptrs, const void* const* klo_ptrs,
                                  const float* kcoef, int m, float cnew,
                                  const float* usnew_base, float cusnew, int with_usnew,
                                  float* k_out, float* ut_out, float* usnew_out, float* u_out,
                                  float* div_out, int lx, int n, float visc, float dx0,
                                  float dx1, float dx2, float vol, const float* force,
                                  const float* force_lo, int glo, int ghi, void* stream) {
    if (n < 1 || m < 0 || m > MAXK || lx < 1 || !u_lo || !u_hi) return (int)cudaErrorInvalidValue;
    if (q && (!q_lo || !q_hi)) return (int)cudaErrorInvalidValue;
    if (base && !base_lo) return (int)cudaErrorInvalidValue;
    if (!force != !force_lo) return (int)cudaErrorInvalidValue;
    const bool ghosts_ok = (glo == 2 && ghi == 1) || (force && glo == 3 && ghi == 2);
    if (!ghosts_ok) return (int)cudaErrorInvalidValue;
    StageParams p{};
    p.u = u;
    p.q = q;
    p.base = base;
    for (int j = 0; j < m; ++j) {
        p.k[j] = static_cast<const float*>(kptrs[j]);
        p.k_lo[j] = static_cast<const float*>(klo_ptrs[j]);
        if (!p.k_lo[j]) return (int)cudaErrorInvalidValue;
        p.ck[j] = kcoef[j];
    }
    p.m = m;
    p.cnew = cnew;
    p.usnew_base = usnew_base;
    p.cusnew = cusnew;
    p.with_usnew = with_usnew;
    p.k_out = k_out;
    p.ut_out = ut_out;
    p.usnew_out = usnew_out;
    p.u_out = u_out;
    p.div_out = div_out;
    p.n = n;
    p.visc = visc;
    p.dx[0] = dx0;
    p.dx[1] = dx1;
    p.dx[2] = dx2;
    p.vol = vol;
    p.lx = lx;
    p.u_lo = u_lo;
    p.u_hi = u_hi;
    p.q_lo = q_lo;
    p.q_hi = q_hi;
    p.base_lo = base_lo;
    p.force = force;
    p.force_lo = force_lo;
    p.glo = glo;
    p.ghi = ghi;
    const Launch runs[2][2] = {
        {launch<false, false, false, true>, launch<false, true, false, true>},
        {launch<true, false, false, true>, launch<true, true, false, true>},
    };
    return (int)runs[q != nullptr][force != nullptr](p, lx, (cudaStream_t)stream);
}
