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
// `_convdiff_window` (:129) / `convdiff_roll` term for term (`convdiff`
// of stencil.cuh, which perop.cu shares).  The TPU
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
// What bounds it on an H100: device-memory bytes.  With REBUILD and a
// stream base it reads ut_prev, q and the tableau streams and writes ut,
// usnew (and u) and div: 14-17 floats per cell, 0.9-1.1 GB per call at
// 256^3 (0.28-0.34 ms at 3.35 TB/s).  The stencil reads each velocity
// about a hundred times per cell (the conv-diff at I and, for the
// backward divergence, at I - e_a), so those reads must not go to global
// memory: a block owns a TZ x TY tile of (y, z) and walks XB x-planes,
// keeping a ring of four x-planes of the (rebuilt) velocity, with a halo
// of two cells below and one above in y and z, in shared memory.  Each
// velocity element is rebuilt once per block from three loads (ut_prev
// and two q values); the stencil then reads only shared memory, z fastest
// across a warp (conflict-free).  The backward divergence needs ut at
// I - e_a, which a neighbouring thread also computes; each thread
// recomputes that one component from the shared tile rather than
// exchanging it, since the tableau streams at I - e_a are single loads.
// TEMP adds a second ring, of T, over x-planes x-1 .. x+1 with a one-cell
// (y, z) halo (5.4 KB beside the velocity ring's 18.5 KB; residency is
// still bounded by the 2048 threads of an SM), loaded once per block.  The
// velocity ring already holds what the temperature RHS reads: u_b at I and
// I - e_b, and for the dissipation the Laplacian of u_b there, which
// reaches I - 2 e_b, inside the ring's (2, 1) halo.  T, tstart and tacc
// add one to three floats a cell and temp_out/tempnew one or two (19-22 in
// all with the velocity streams).  Without TEMP (and without FORCE) the
// kernel compiles exactly as it did before those streams existed.
//
// HALO runs the stage on an x-slab shard block of a 1-D mesh: the port of
// `_msd_hat_halo_kernel` (:1542, wrapper `momentum_stage_divhat_halo_3d`
// :1730) and `_pcmsd_hat_halo_kernel` (:2877, wrapper `pcmsd_hat_halo_3d`
// :3183).  The block is (3, lx, n, n); its x-neighbours arrive as separate
// ghost arrays from the ring exchange (`parallel/halo.py`): 2 lower and 1
// upper plane of u (ut_prev), 2 and 2 of q (the rebuild's forward
// x-difference reaches plane lx + 1) and plane -1 of each tableau stream
// (the backward divergence reads its component 0 there).  `load_plane`
// reads plane x from the lower ghosts when x < 0, from the upper one when
// x >= lx and from the block otherwise; y and z still wrap.  The TPU
// kernels' segmented window DMAs (`_seg_window_copy` :1497) and their
// slab-size pick have no counterpart: a block reads a ghost plane where it
// needs it.  Bound at the 4-shard shape (lx = 64, n = 256): the same 14-17
// floats a cell over 4.2M cells, 0.23-0.29 GB, 0.07-0.09 ms at 3.35 TB/s;
// the ghost planes add 3-5 %.  Without HALO the kernels compile as before.
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
// (glo, ghi); the FORCE-less ones keep (2, 1) as constants and compile as
// before.  The shard stage has no temperature stream (the JAX halo kernels
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
// is a single load a cell (and one more at I - e_a), so nothing is staged.
// It runs without REBUILD and TEMP (the JAX kernel is `_msd_hat_kernel`'s
// twin); at 256^3 with m = 9 it reads 11 vector fields and writes 3: 2.8
// GB, 0.84 ms at 3.35 TB/s.  The m <= MAXK kernels keep their unrolled
// loop.

#include <type_traits>

#include "stencil.cuh"

namespace {

constexpr int MAXK = 4;
constexpr int TZ = 32;             // tile extent in z (one warp)
constexpr int TY = 8;              // tile extent in y
constexpr int XB = 8;              // x-planes walked per block
constexpr int HZ = TZ + 3;         // halo: 2 below, 1 above
constexpr int HY = TY + 3;
constexpr int RING = 4;            // x-planes x-2 .. x+1
constexpr int TY2 = TY + 2;        // T halo: one cell each side in y, z
constexpr int TZ2 = TZ + 2;

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
    // the x-slab shard block (HALO only; appended, so the cube kernels'
    // parameter offsets are as before)
    int lx;                   // x extent of the block (n: the cube)
    const float* u_lo;        // (3, 2, n, n): planes -2, -1 of u (ut_prev)
    const float* u_hi;        // (3, 1, n, n): plane lx
    const float* q_lo;        // (2, n, n): q planes -2, -1 (REBUILD)
    const float* q_hi;        // (2, n, n): q planes lx, lx + 1 (REBUILD)
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

using Ring = float[RING][3][HY][HZ];
using TRing = float[RING][TY2][TZ2];  // slot pattern of Ring; x-2 unused

// Plane x (-2 <= x <= lx + 1) of q on a shard block: the lower ghosts
// (glo of them), the block or the upper ghosts (HALO).
__device__ __forceinline__ const float* halo_qplane(const StageParams& p, int x, int glo) {
    const size_t n2 = (size_t)p.n * p.n;
    if (x < 0) return p.q_lo + (size_t)(x + glo) * n2;
    if (x >= p.lx) return p.q_hi + (size_t)(x - p.lx) * n2;
    return p.q + (size_t)x * n2;
}

// `load_plane` on a shard block: plane xp (-2 <= xp <= lx) comes from the
// lower ghosts, the block or the upper ghosts, and q's planes xp and
// xp + 1 likewise (lx + 1 is the second upper q ghost).  The ghost counts
// are (2, 1) without FORCE and parameters with it.
template <bool REBUILD, bool FORCE>
__device__ __forceinline__ void load_plane_halo(const StageParams& p, Ring& s, int slot,
                                                int xp, int y0, int z0) {
    const int n = p.n;
    const size_t n2 = (size_t)n * n;
    const int glo = FORCE ? p.glo : 2, ghi = FORCE ? p.ghi : 1;
    const float* up;  // component 0 of plane xp; the components lie cs apart
    size_t cs;
    if (xp < 0) {
        up = p.u_lo + (size_t)(xp + glo) * n2;
        cs = (size_t)glo * n2;
    } else if (xp >= p.lx) {
        up = p.u_hi + (size_t)(xp - p.lx) * n2;
        cs = (size_t)ghi * n2;
    } else {
        up = p.u + (size_t)xp * n2;
        cs = (size_t)p.lx * n2;
    }
    const float* qp = REBUILD ? halo_qplane(p, xp, glo) : nullptr;
    const float* qn = REBUILD ? halo_qplane(p, xp + 1, glo) : nullptr;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthreads = blockDim.x * blockDim.y;
    for (int e = tid; e < HY * HZ; e += nthreads) {
        const int ly = e / HZ, lz = e - ly * HZ;
        const int y = wrap(y0 - 2 + ly, n), z = wrap(z0 - 2 + lz, n);
        const size_t i = (size_t)y * n + z;
        float u0 = __ldg(up + i), u1 = __ldg(up + cs + i), u2 = __ldg(up + 2 * cs + i);
        if constexpr (REBUILD) {
            const float qc = __ldg(qp + i);
            const int yn = y + 1 == n ? 0 : y + 1, zn = z + 1 == n ? 0 : z + 1;
            u0 -= (__ldg(qn + i) - qc) / p.dx[0];
            u1 -= (__ldg(qp + (size_t)yn * n + z) - qc) / p.dx[1];
            u2 -= (__ldg(qp + (size_t)y * n + zn) - qc) / p.dx[2];
        }
        s[slot][0][ly][lz] = u0;
        s[slot][1][ly][lz] = u1;
        s[slot][2][ly][lz] = u2;
    }
}

// Fill ring slot `slot` with x-plane `xp` of the (rebuilt) velocity over
// the tile's haloed (y, z) window starting at (y0 - 2, z0 - 2).
template <bool REBUILD, bool FORCE, bool HALO, class S>
__device__ __forceinline__ void load_plane(const StageParams& p, Ring& s, int slot,
                                           int xp, int y0, int z0) {
    if constexpr (HALO) {
        load_plane_halo<REBUILD, FORCE>(p, s, slot, xp, y0, z0);
        return;
    }
    const int n = p.n;
    const size_t n3 = (size_t)n * n * n;
    const int x = wrap(xp, n);
    const int xn = x + 1 == n ? 0 : x + 1;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthreads = blockDim.x * blockDim.y;
    for (int e = tid; e < HY * HZ; e += nthreads) {
        const int ly = e / HZ, lz = e - ly * HZ;
        const int y = wrap(y0 - 2 + ly, n), z = wrap(z0 - 2 + lz, n);
        const size_t i = ((size_t)x * n + y) * n + z;
        const S* up = reinterpret_cast<const S*>(p.u);
        float u0 = ldg_f(up, i), u1 = ldg_f(up + n3, i), u2 = ldg_f(up + 2 * n3, i);
        if constexpr (REBUILD) {
            const float qc = __ldg(p.q + i);
            const int yn = y + 1 == n ? 0 : y + 1, zn = z + 1 == n ? 0 : z + 1;
            u0 -= (__ldg(p.q + ((size_t)xn * n + y) * n + z) - qc) / p.dx[0];
            u1 -= (__ldg(p.q + ((size_t)x * n + yn) * n + z) - qc) / p.dx[1];
            u2 -= (__ldg(p.q + ((size_t)x * n + y) * n + zn) - qc) / p.dx[2];
        }
        s[slot][0][ly][lz] = u0;
        s[slot][1][ly][lz] = u1;
        s[slot][2][ly][lz] = u2;
    }
}

// Fill T-ring slot `slot` with x-plane `xp` of T over the tile's haloed
// (y, z) window starting at (y0 - 1, z0 - 1).
__device__ __forceinline__ void load_tplane(const StageParams& p, TRing& s, int slot,
                                            int xp, int y0, int z0) {
    const int n = p.n;
    const int x = wrap(xp, n);
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthreads = blockDim.x * blockDim.y;
    for (int e = tid; e < TY2 * TZ2; e += nthreads) {
        const int ly = e / TZ2, lz = e - ly * TZ2;
        const int y = wrap(y0 - 1 + ly, n), z = wrap(z0 - 1 + lz, n);
        s[slot][ly][lz] = __ldg(p.T + ((size_t)x * n + y) * n + z);
    }
}

// The thread's view of the ring at step i: u(c, I + (ox, oy, oz)).
struct View {
    const Ring* s;
    int i, ly, lz;
    __device__ __forceinline__ float operator()(int c, int ox, int oy, int oz) const {
        return (*s)[(i + 2 + ox) & 3][c][ly + oy][lz + oz];
    }
};

// The thread's view of the T ring at step i: T(I + (ox, oy, oz)).
struct TView {
    const TRing* s;
    int i, ly, lz;
    __device__ __forceinline__ float operator()(int ox, int oy, int oz) const {
        return (*s)[(i + 2 + ox) & 3][ly + oy][lz + oz];
    }
};

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

// `tableau` at plane -1 of a shard block (HALO): the streams' lower
// ghosts, offset il in their component-0 plane.
__device__ __forceinline__ float tableau_lo(const StageParams& p, size_t il, float b0,
                                            float f) {
    float ut = b0;
#pragma unroll
    for (int j = 0; j < MAXK; ++j)
        if (j < p.m) ut = ut + p.ck[j] * __ldg(p.k_lo[j] + il);
    return ut + p.cnew * f;
}

// Outputs of component A at I; returns its term of the divergence.
template <bool REBUILD, bool FORCE, bool TEMP, bool HALO, class S, bool STREAMS, int A>
__device__ __forceinline__ float component(const StageParams& p, const View& u,
                                           const TView& T, int x, int y, int z) {
    static_assert(!(HALO && TEMP), "the shard stage has no T stream");
    static_assert(!HALO || (std::is_same<S, float>::value && !STREAMS),
                  "the shard stage stores float and takes at most MAXK k streams");
    const int n = p.n;
    const size_t n3 = (size_t)(HALO ? p.lx : n) * n * n;
    const size_t idx = A * n3 + ((size_t)x * n + y) * n + z;
    float f = convdiff<A, 0, 0, 0>(p.visc, p.dx, u);
    if constexpr (TEMP) {
        if (A == p.gdir) f = f + p.alpha2 * (0.5f * (T(0, 0, 0) + T(A == 0, A == 1, A == 2)));
    }
    // the float stage reads and stores as it did before S existed: its
    // stores through `st` compile to other SASS in the stages without the
    // rebuild (sass_diff.py against the parent)
    constexpr bool F32 = std::is_same<S, float>::value;
    if constexpr (FORCE) f = f + (F32 ? __ldg(p.force + idx) : ld<S>(p.force, idx));
    const float ua = u(A, 0, 0, 0);
    const float b0 = p.base ? (F32 ? __ldg(p.base + idx) : ld<S>(p.base, idx)) : ua;
    const float ut = tableau<S, STREAMS>(p, idx, b0, f);
    if constexpr (F32) {
        if (p.k_out) p.k_out[idx] = f;
        p.ut_out[idx] = ut;
        if (p.with_usnew) {
            const float ub = p.usnew_base ? __ldg(p.usnew_base + idx) : b0;
            p.usnew_out[idx] = ub + p.cusnew * f;
        }
        if (REBUILD && p.u_out) p.u_out[idx] = ua;
    } else {
        if (p.k_out) st<S>(p.k_out, idx, f);
        st<S>(p.ut_out, idx, ut);
        if (p.with_usnew) {
            const float ub = p.usnew_base ? ld<S>(p.usnew_base, idx) : b0;
            st<S>(p.usnew_out, idx, ub + p.cusnew * f);
        }
        if (REBUILD && p.u_out) st<S>(p.u_out, idx, ua);
    }
    // ut_A at I - e_A (owned by a neighbour; recomputed from the tile)
    constexpr int MX = -(A == 0), MY = -(A == 1), MZ = -(A == 2);
    const int xm = A == 0 ? (x == 0 ? n - 1 : x - 1) : x;
    const int ym = A == 1 ? (y == 0 ? n - 1 : y - 1) : y;
    const int zm = A == 2 ? (z == 0 ? n - 1 : z - 1) : z;
    const size_t idxm = A * n3 + ((size_t)xm * n + ym) * n + zm;
    float fm = convdiff<A, MX, MY, MZ>(p.visc, p.dx, u);
    // the buoyancy at I - e_A too, or the backward divergence misses it
    if constexpr (TEMP) {
        if (A == p.gdir) fm = fm + p.alpha2 * (0.5f * (T(MX, MY, MZ) + T(0, 0, 0)));
    }
    if constexpr (FORCE) {
        if (HALO && A == 0 && x == 0)  // plane -1: the force's lower plane
            fm = fm + __ldg(p.force_lo + (size_t)y * n + z);
        else
            fm = fm + (F32 ? __ldg(p.force + idxm) : ld<S>(p.force, idxm));
    }
    if constexpr (HALO) {
        if (A == 0 && x == 0) {  // plane -1: the tableau streams' lower ghosts
            const size_t il = (size_t)y * n + z;
            const float bl = p.base ? __ldg(p.base_lo + il) : u(A, MX, MY, MZ);
            return (ut - tableau_lo(p, il, bl, fm)) / p.dx[A];
        }
    }
    const float bm = p.base ? (F32 ? __ldg(p.base + idxm) : ld<S>(p.base, idxm))
                            : u(A, MX, MY, MZ);
    const float utm = tableau<S, STREAMS>(p, idxm, bm, fm);
    return (ut - utm) / p.dx[A];
}

// visc-free Laplacian of u_b at I + (ox, oy, oz)
__device__ __forceinline__ float laplacian(const StageParams& p, const View& u, int b,
                                           int ox, int oy, int oz) {
    const float c = u(b, ox, oy, oz);
    float l = (u(b, ox + 1, oy, oz) - 2.0f * c + u(b, ox - 1, oy, oz)) / (p.dx[0] * p.dx[0]);
    l = l + (u(b, ox, oy + 1, oz) - 2.0f * c + u(b, ox, oy - 1, oz)) / (p.dx[1] * p.dx[1]);
    l = l + (u(b, ox, oy, oz + 1) - 2.0f * c + u(b, ox, oy, oz - 1)) / (p.dx[2] * p.dx[2]);
    return l;
}

// The temperature outputs at I (TEMP).
__device__ __forceinline__ void temperature(const StageParams& p, const View& u,
                                            const TView& T, int x, int y, int z) {
    const int n = p.n;
    const size_t idx = ((size_t)x * n + y) * n + z;
    const float tc = T(0, 0, 0);
    float kt = 0.0f;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
        const int ex = b == 0, ey = b == 1, ez = b == 2;
        const float tp = T(ex, ey, ez), tm = T(-ex, -ey, -ez);
        const float uT2 = u(b, 0, 0, 0) * (0.5f * (tc + tp));
        const float uT1 = u(b, -ex, -ey, -ez) * (0.5f * (tm + tc));
        const float dT2 = (tp - tc) / p.dx[b];
        const float dT1 = (tc - tm) / p.dx[b];
        kt = kt + (-(uT2 - uT1) + p.alpha4 * (dT2 - dT1)) / p.dx[b];
    }
    if (p.with_dis) {
        float dacc = 0.0f;
#pragma unroll
        for (int b = 0; b < 3; ++b) {
            const int ex = b == 0, ey = b == 1, ez = b == 2;
            const float g2 = u(b, 0, 0, 0) * (p.visc * laplacian(p, u, b, 0, 0, 0));
            const float g1 = u(b, -ex, -ey, -ez) * (p.visc * laplacian(p, u, b, -ex, -ey, -ez));
            dacc = dacc + 0.5f * (g2 + g1);
        }
        kt = kt + p.dis * dacc;
    }
    const float tb = p.tstart ? __ldg(p.tstart + idx) : tc;
    p.temp_out[idx] = tb + p.cnew * kt;
    if (p.with_usnew) {
        const float ta = p.tacc ? __ldg(p.tacc + idx) : tb;
        p.tempnew_out[idx] = ta + p.cusnew * kt;
    }
}

// The T ring, which exists only in the TEMP kernels.
template <bool TEMP>
__device__ __forceinline__ TRing* temp_ring() {
    if constexpr (TEMP) {
        __shared__ TRing ts;
        return &ts;
    } else {
        return nullptr;
    }
}

template <bool REBUILD, bool FORCE, bool TEMP, bool HALO, class S = float,
          bool STREAMS = false>
__global__ void __launch_bounds__(TZ * TY)
stage_kernel(const __grid_constant__ StageParams p) {
    __shared__ Ring s;
    TRing* const ts = temp_ring<TEMP>();
    const int n = p.n;
    const int z0 = blockIdx.x * TZ, y0 = blockIdx.y * TY, x0 = blockIdx.z * XB;
    const int z = z0 + threadIdx.x, y = y0 + threadIdx.y;
    const bool active = z < n && y < n;  // ragged tiles still load and sync
    const int nx = min(XB, (HALO ? p.lx : n) - x0);
    for (int r = 0; r < 3; ++r)
        load_plane<REBUILD, FORCE, HALO, S>(p, s, r, x0 - 2 + r, y0, z0);
    if constexpr (TEMP) {
        for (int r = 1; r < 3; ++r) load_tplane(p, *ts, r, x0 - 2 + r, y0, z0);
    }
    const View u{&s, 0, (int)threadIdx.y + 2, (int)threadIdx.x + 2};
    const TView tv{ts, 0, (int)threadIdx.y + 1, (int)threadIdx.x + 1};
    for (int i = 0; i < nx; ++i) {
        // ring slot (i + 3) & 3 takes plane x + 1; the others hold x-2..x
        load_plane<REBUILD, FORCE, HALO, S>(p, s, (i + 3) & 3, x0 + i + 1, y0, z0);
        if constexpr (TEMP) load_tplane(p, *ts, (i + 3) & 3, x0 + i + 1, y0, z0);
        __syncthreads();
        if (active) {
            View v = u;
            v.i = i;
            TView t = tv;
            t.i = i;
            const int x = x0 + i;
            float d = component<REBUILD, FORCE, TEMP, HALO, S, STREAMS, 0>(p, v, t, x, y, z);
            d += component<REBUILD, FORCE, TEMP, HALO, S, STREAMS, 1>(p, v, t, x, y, z);
            d += component<REBUILD, FORCE, TEMP, HALO, S, STREAMS, 2>(p, v, t, x, y, z);
            p.div_out[((size_t)x * n + y) * n + z] = d * p.vol;
            if constexpr (TEMP) temperature(p, v, t, x, y, z);
        }
        __syncthreads();  // plane x-2's slot is refilled next step
    }
}

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
    if (m < 0 || (many && (!ktable || q || T))) return (int)cudaErrorInvalidValue;
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
    const dim3 block(TZ, TY);
    const dim3 grid((n + TZ - 1) / TZ, (n + TY - 1) / TY, (n + XB - 1) / XB);
    // the force and temperature streams, the storage type and the many
    // streams are template flags, so the float stage without them
    // compiles exactly as before they existed
    using Kernel = void (*)(const StageParams);
    Kernel kernel;
    if (many) {
        kernel = force ? stage_kernel<false, true, false, false, S, true>
                       : stage_kernel<false, false, false, false, S, true>;
    } else if constexpr (F32) {
        const Kernel kernels[2][2][2] = {
            {{stage_kernel<false, false, false, false>, stage_kernel<false, false, true, false>},
             {stage_kernel<false, true, false, false>, stage_kernel<false, true, true, false>}},
            {{stage_kernel<true, false, false, false>, stage_kernel<true, false, true, false>},
             {stage_kernel<true, true, false, false>, stage_kernel<true, true, true, false>}},
        };
        kernel = kernels[q != nullptr][force != nullptr][T != nullptr];
    } else {
        const Kernel kernels[2][2] = {
            {stage_kernel<false, false, false, false, S>,
             stage_kernel<false, true, false, false, S>},
            {stage_kernel<true, false, false, false, S>,
             stage_kernel<true, true, false, false, S>},
        };
        kernel = kernels[q != nullptr][force != nullptr];
    }
    kernel<<<grid, block, 0, stream>>>(p);
    return (int)cudaGetLastError();
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
    if (m < 0 || m > MAXK || lx < 1 || !u_lo || !u_hi) return (int)cudaErrorInvalidValue;
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
    const dim3 block(TZ, TY);
    const dim3 grid((n + TZ - 1) / TZ, (n + TY - 1) / TY, (lx + XB - 1) / XB);
    using Kernel = void (*)(const StageParams);
    const Kernel kernels[2][2] = {
        {stage_kernel<false, false, false, true>, stage_kernel<false, true, false, true>},
        {stage_kernel<true, false, false, true>, stage_kernel<true, true, false, true>},
    };
    kernels[q != nullptr][force != nullptr]<<<grid, block, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}
