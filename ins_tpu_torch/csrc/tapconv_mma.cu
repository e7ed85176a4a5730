// The tap-matmul and pack-tile convolution of the CNN closure's z-folded
// layer on the tensor cores (bf16 operands, `mma.sync.m16n8k16` with
// float32 sums), forward with bias and tanh/identity fused in:
//
//   out[x, y, z, o] = act(b[o] + sum_{dx<kx, dy<ky} sum_c g[x+dx, y+dy, z, c]
//                                                         * w2[dx, dy, c, o])
//
// g is (nxp, nyp, nz, kc) bf16, channels last, the z taps already folded
// into kc (a multiple of 8: the wrapper pads with zero channels) and x, y
// padded by kx-1, ky-1; out is (nxp-kx+1, nyp-ky+1, nz, cout) in float32
// or bf16.  The layer's input gradient is the same function on the
// zero-padded cotangent with flipped, transposed taps.  The float32 route
// of both forwards is tapconv_tf32.cu (3xTF32 on the tensor cores, these
// two kernels' plan); the weight gradient is tapwgrad_mma.cu (bf16) and
// tapwgrad_tf32.cu (float32).
//
// Replaces: for bf16 operands, `_tapconv_kernel` (ins_tpu/ops/convkernels.py:78,
// wrapper `tapconv_3d` :130) and `_packconv_kernel` (:387, wrapper
// `packconv_3d` :471).
//
// What bounds it on an H100: the 24 -> 24 layer at 128^3 is 302 GFLOP
// against 0.74 GB of compulsory traffic (0.31 ms at the 989 TFLOP/s bf16
// peak), so the tensor cores and the shared-memory reads that feed them;
// the input gradient (120 output channels) writes 0.5-1.1 GB, so there the
// stores.  Measured (H100 80GB HBM3, 700 W; PERF.md): the tap kernel at
// 160 TFLOP/s, 6.2x its bound, held by the restaging of each (dx, chunk)
// stage from L2 (below); the pack kernel at 4.9x its byte bound, held by
// the tap sums between its mma phases.
//
// * tap kernel (output-first, `tapconv_3d`, and `packconv_3d` where the taps
//   do not all pack into one tile): an implicit GEMM with M = the cells of
//   an output row, K = kc and N = cout in blocks of 8*NT columns (NT <= 5
//   n8 tiles).  For tap (dx, dy) the A rows of output row (x, y) are the
//   contiguous (cells x kc) block of g at (x + dx, y + dy): no window
//   arithmetic.  A block of 8 warps (two blocks an SM) owns one x-plane's
//   8 (y) x 32 (z) cells and one block of output channels, a warp 2 rows of
//   one m16 tile of cells.  The block walks stages (dx, 32-channel chunk):
//   the input plane's (8 + ky - 1) x 32-cell window and the ky weight
//   tiles of that dx, staged by 16-byte cp.async into a ring of two shared
//   buffers, so the next stage's copies overlap this one's products.  Per
//   k16 step a warp loads each of its 2 + ky - 1 window rows' A fragment
//   once (ldmatrix.x4) and each tap's B fragments (ldmatrix.x2.trans) at
//   their first use: input row ri feeds output row ri - dy through tap dy,
//   so an A fragment feeds up to 2*NT mma and at most two taps' B
//   fragments are live.  A chunk's last 8 channels, where kc % 16 == 8,
//   take one m16n8k8 step (the input gradient's 24- and 8-channel
//   contractions waste no padded half step).  Where cout % 8 == 0 the
//   output tile goes through shared memory and leaves as 16-byte rows (the
//   input gradient is bound by these stores).  What holds it (128^3, 8
//   warps against 16, 4 rows a warp, 64-channel stages and three buffers
//   all measured slower): the window and weights restaged from L2 for each
//   (dx, chunk) stage, ~5 GB at 24 -> 24, since the z-folded operand is
//   five times the unfolded one.
// * pack kernel (weight-first, `packconv_3d` where every tap packs into one
//   tile of at most 128 columns: the JAX kernel's `pack_dx` plan, e.g. the
//   24 -> 3 layer, N = 75 -> 80): each input plane's products with every
//   tap once, P[(y, z), (dx, dy, o)] = sum_c g[p, y, z, c] ws[c, (dx, dy,
//   o)], one tensor-core chain of KP/16 <= 8 mma per product (the per-tap
//   K-sum, in float32), then the shifted tap sums, in float32 and in the
//   order (dx, dy): out[x, y] = sum_{dx, dy} P[x + dx][(y + dy, z), (dx, dy,
//   o)].  A block of 8 warps owns 16 input rows (16 - ky + 1 output rows)
//   x 16 cells and walks a run of x-planes; a warp forms the products of two
//   rows, the block writes them to shared memory (float32) and adds their
//   column groups into a ring of kx output-plane accumulators in shared
//   memory; a plane leaves when its last tap is in.  The products never go
//   through device memory.  Packing all taps lets an A fragment feed
//   10 mma at 24 -> 3 where the output-first form fills one n8 tile of 8
//   with 3 channels.
//
// The tensor cores' float32 sums truncate: a chain holds at most CHAIN = 8
// mma before it is added to a float32 accumulator (the tap kernel adds
// every k step's ky mma, the pack kernel each tap's KP/16), so a kernel
// differs from a float32 reference on the same bf16 operands by a few
// float32 ulps of each sum.

#include <cstdint>
#include <utility>

#include "convio.cuh"  // bf16, CHAIN, cp.async, ldmatrix, mma_bf16, ring helpers

namespace {

constexpr int TM_THREADS = 256;  // tap kernel: 8 warps
constexpr int TTY = 8;           // tap: output rows (y) a block
constexpr int TTZ = 32;          // tap: output cells (z) a row
constexpr int TRW = 2;           // tap: output rows a warp (one m16 tile of cells)
static_assert(TTY * TTZ == TM_THREADS / 32 * TRW * 16, "the warps tile the block's cells");
constexpr int TMAXNT = 5;        // tap: n8 tiles of output channels a block, at most
constexpr int KCH = 32;          // tap: channels a stage (two k16 steps)
constexpr int KCHP = KCH + 8;    // their staged pitch: 5 16-byte units (odd: no bank conflicts)

constexpr int PK_THREADS = 256;  // pack kernel: 8 warps
constexpr int PROWS = 16;        // pack: input rows a block (two a warp)
constexpr int PTZ = 16;          // pack: cells a row (one m16 tile)
static_assert(PROWS == PK_THREADS / 32 * 2, "a pack warp owns two input rows");
constexpr int PKCH = 64;         // pack: channels a stage (four k16 steps)
constexpr int PKCHP = PKCH + 8;  // their staged pitch: 9 16-byte units
constexpr int PMAXNT = 16;       // pack: n8 tiles of packed columns, at most (128 columns)
constexpr int PMAXKY = 7;        // pack: y-taps, at most
constexpr int PMAXKP = 16 * CHAIN;  // pack: contraction of one chain, at most
constexpr int PBLOCKS = 264;     // pack: target number of blocks (two waves of 132 SMs)
constexpr size_t SMEM_MAX = 232448;  // shared memory a block may use

__device__ __forceinline__ void zero16(bf16* dst) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// Stage channels c .. c+7 of g's cell (plane, y, z) into 16 bytes of shared
// memory: one cp.async, or zeros past the field (rows y >= nyp, cells z >=
// nz, channels c >= kc).
__device__ __forceinline__ void stage_g(bf16* dst, const bf16* g, int plane, int y, int z, int c,
                                        int nyp, int nz, int kc) {
    if (y < nyp && z < nz && c < kc)
        cp_async16(dst, g + (((size_t)plane * nyp + y) * nz + z) * kc + c);
    else
        zero16(dst);
}

// (lo, hi) rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float epilogue(float v, const float* bias, int co, int act) {
    if (bias) v += __ldg(bias + co);
    return act == 1 ? tanhf(v) : v;
}

struct TapMmaParams {
    const bf16* g;      // (nxp, nyp, nz, kc)
    const bf16* w;      // packed (kx, ky, kp, np): zero past kc rows and cout columns
    const float* bias;  // may be null
    int act;            // 0 identity, 1 tanh
    void* out;
    int out_bf16;
    int vec_out;        // cout % 8 == 0 and out 16-byte aligned: 16-byte stores
    int nxp, nyp, nz, kc, kx, cout;
    int kp, np;         // kc rounded up to 16; output channels padded to nblk * 8*NT
    int nbuf;           // stages in the ring
};

// Blocks an SM the tap kernel's launch bounds ask for: two (at most 128
// registers a thread), but one where ptxas spilled at 128 (ky = 1 and 3
// with nt = 5, ky = 7 with nt = 4; build.log).
__host__ __device__ constexpr int tap_min_blocks(int ky, int nt) {
    return (nt == 5 && ky < 5) || (nt == 4 && ky == 7) ? 1 : 2;
}

template <int KY, int NT>
__host__ __device__ constexpr int tap_stage_elems() {  // a buffer: window, then the ky weight tiles
    return (TTY + KY - 1) * TTZ * KCHP + KY * KCH * mma_pitch(NT);
}

template <int KY, int NT>
__global__ void __launch_bounds__(TM_THREADS, tap_min_blocks(KY, NT))
tap_mma_kernel(const __grid_constant__ TapMmaParams p) {
    constexpr int ROWS = TTY + KY - 1;
    constexpr int IN = ROWS * TTZ * KCHP;
    constexpr int WP = mma_pitch(NT);
    constexpr int STAGE = tap_stage_elems<KY, NT>();
    // k steps whose products one tensor-core chain sums (KY mma a step)
    // before a float32 add
    constexpr int FLUSH = CHAIN / KY > 1 ? CHAIN / KY : 1;
    extern __shared__ uint4 smem_u4[];
    bf16* smem = reinterpret_cast<bf16*>(smem_u4);
    const int nbuf = p.nbuf;
    const int ny = p.nyp - KY + 1;
    const int nblk = p.np / (8 * NT);
    const int x = blockIdx.z / nblk, n0 = (blockIdx.z % nblk) * 8 * NT;
    const int y0 = blockIdx.y * TTY, z0 = blockIdx.x * TTZ;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    // warp: output rows wy0 .. wy0 + TRW - 1, cells 16 * wm .. 16 * wm + 15
    const int wy0 = (warp / (TTZ / 16)) * TRW, wm = warp % (TTZ / 16);
    const int nchunk = (p.kp + KCH - 1) / KCH;
    const int nstage = p.kx * nchunk;  // (dx, chunk)

    auto issue = [&](int s) {
        if (s < nstage) {
            const int dx = s / nchunk, c0 = (s % nchunk) * KCH;
            bf16* s_in = smem + (s % nbuf) * STAGE;
            bf16* s_w = s_in + IN;
            for (int u = tid; u < ROWS * TTZ * (KCH / 8); u += TM_THREADS) {
                const int q = u % (KCH / 8), cell = (u / (KCH / 8)) % TTZ;
                const int r = u / (KCH / 8 * TTZ);
                stage_g(s_in + (r * TTZ + cell) * KCHP + 8 * q, p.g, x + dx, y0 + r, z0 + cell,
                        c0 + 8 * q, p.nyp, p.nz, p.kc);
            }
            // rows (dy, j) of tap (dx, dy), channels c0 + j, this block's columns
            const bf16* w = p.w + ((size_t)dx * KY * p.kp + c0) * p.np + n0;
            for (int u = tid; u < KY * KCH * NT; u += TM_THREADS) {
                const int t = u % NT, row = u / NT;
                const int dy = row / KCH, j = row % KCH;
                if (c0 + j < p.kp)
                    cp_async16(s_w + row * WP + 8 * t, w + ((size_t)dy * p.kp + j) * p.np + 8 * t);
            }
        }
        cp_async_commit();
    };

    // acc: the sum (float32 adds); part: the products of FLUSH k steps,
    // chained in the tensor cores
    float acc[TRW][NT][4], part[TRW][NT][4];
#pragma unroll
    for (int r = 0; r < TRW; ++r)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][t][e] = part[r][t][e] = 0.0f;

    // ldmatrix row addresses: A rows are cells (lanes 0-15: k 0-7, 16-31:
    // k 8-15), B rows are channels (lanes 0-15)
    const int a_lane = (wy0 * TTZ + 16 * wm + (lane & 15)) * KCHP + (lane >> 4) * 8;
    const int b_lane = (lane & 15) * WP;
    int chained = 0;  // k steps in `part`
    for (int s = 0; s < nbuf - 1; ++s) issue(s);
    for (int s = 0; s < nstage; ++s) {
        issue(s + nbuf - 1);
        ring_wait(nbuf);
        // the chunk's k16 steps, then a k8 step where kc % 16 == 8 (its
        // last 8 channels: the input gradient's 24 and 8 channel
        // contractions take no padded k16 step)
        const int c0 = (s % nchunk) * KCH, cc = min(KCH, p.kc - c0);
        const int nks = cc / 16, nsteps = (cc + 15) / 16;
        const bf16* s_in = smem + (s % nbuf) * STAGE + a_lane;
        const bf16* s_w = smem + (s % nbuf) * STAGE + IN + b_lane;
#pragma unroll 1
        for (int ks = 0; ks < nsteps; ++ks) {
            // the k step's weights of every y-tap, then each window row
            // once: input row ri feeds output row ri - dy through tap dy
            if (ks < nks) {
                // tap ri's B fragments at its first use: at most TRW taps'
                // are live
                uint32_t b[KY][NT][2];
#pragma unroll
                for (int ri = 0; ri < TRW + KY - 1; ++ri) {
                    if (ri < KY) {
#pragma unroll
                        for (int t = 0; t < NT; ++t)
                            ldsm_x2_trans(b[ri][t], s_w + (ri * KCH + ks * 16) * WP + 8 * t);
                    }
                    uint32_t a[4];
                    ldsm_x4(a, s_in + ri * TTZ * KCHP + ks * 16);
#pragma unroll
                    for (int dy = 0; dy < KY; ++dy) {
                        const int ro = ri - dy;
                        if (ro < 0 || ro >= TRW) continue;
#pragma unroll
                        for (int t = 0; t < NT; ++t) mma_bf16(part[ro][t], a, b[dy][t]);
                    }
                }
            } else {
                uint32_t b[KY][NT];
#pragma unroll
                for (int ri = 0; ri < TRW + KY - 1; ++ri) {
                    if (ri < KY) {
#pragma unroll
                        for (int t = 0; t < NT; ++t)
                            ldsm_x1_trans(b[ri][t], s_w + (ri * KCH + ks * 16) * WP + 8 * t);
                    }
                    uint32_t a[2];
                    ldsm_x2(a, s_in + ri * TTZ * KCHP + ks * 16);
#pragma unroll
                    for (int dy = 0; dy < KY; ++dy) {
                        const int ro = ri - dy;
                        if (ro < 0 || ro >= TRW) continue;
#pragma unroll
                        for (int t = 0; t < NT; ++t) mma_bf16_k8(part[ro][t], a, b[dy][t]);
                    }
                }
            }
            if (++chained == FLUSH || (s == nstage - 1 && ks == nsteps - 1)) {
                chained = 0;
#pragma unroll
                for (int r = 0; r < TRW; ++r)
#pragma unroll
                    for (int t = 0; t < NT; ++t)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            acc[r][t][e] += part[r][t][e];
                            part[r][t][e] = 0.0f;
                        }
            }
        }
        __syncthreads();  // the buffer is refilled nbuf - 1 stages on
    }

    if (p.vec_out) {
        // the warp's 2 x 16 cells x 8*NT channels through shared memory (the
        // ring is free), then out as 16-byte units of 8 channels
        constexpr int EP = 8 * NT + 4;
        float* so = reinterpret_cast<float*>(smem_u4) + warp * (TRW * 16 * EP);
#pragma unroll
        for (int r = 0; r < TRW; ++r)
#pragma unroll
            for (int t = 0; t < NT; ++t)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int cell = (lane >> 2) + 8 * (e >> 1), col = 8 * t + 2 * (lane & 3) + (e & 1);
                    const int co = n0 + col;
                    so[(r * 16 + cell) * EP + col] =
                        co < p.cout ? epilogue(acc[r][t][e], p.bias, co, p.act) : 0.0f;
                }
        __syncwarp();
        for (int u = lane; u < TRW * 16 * NT; u += 32) {
            const int t = u % NT, cell = (u / NT) % 16, r = u / (NT * 16);
            const int y = y0 + wy0 + r, z = z0 + 16 * wm + cell, co = n0 + 8 * t;
            if (y >= ny || z >= p.nz || co >= p.cout) continue;
            const float* src = so + (r * 16 + cell) * EP + 8 * t;
            const size_t off = (((size_t)x * ny + y) * p.nz + z) * p.cout + co;
            const float4 v0 = *reinterpret_cast<const float4*>(src);
            const float4 v1 = *reinterpret_cast<const float4*>(src + 4);
            if (p.out_bf16) {
                *reinterpret_cast<uint4*>(static_cast<bf16*>(p.out) + off) =
                    make_uint4(bf16x2(v0.x, v0.y), bf16x2(v0.z, v0.w), bf16x2(v1.x, v1.y),
                               bf16x2(v1.z, v1.w));
            } else {
                float4* dst = reinterpret_cast<float4*>(static_cast<float*>(p.out) + off);
                dst[0] = v0;
                dst[1] = v1;
            }
        }
        return;
    }
#pragma unroll
    for (int r = 0; r < TRW; ++r) {
        const int y = y0 + wy0 + r;
        if (y >= ny) break;
        const size_t row = ((size_t)x * ny + y) * p.nz;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int z = z0 + 16 * wm + (lane >> 2) + 8 * half;
            if (z >= p.nz) continue;
            const size_t cell = (row + z) * p.cout;
#pragma unroll
            for (int t = 0; t < NT; ++t)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int co = n0 + 8 * t + 2 * (lane & 3) + e;
                    if (co >= p.cout) continue;
                    const float v = epilogue(acc[r][t][2 * half + e], p.bias, co, p.act);
                    if (p.out_bf16)
                        static_cast<bf16*>(p.out)[cell + co] = __float2bfloat16(v);
                    else
                        static_cast<float*>(p.out)[cell + co] = v;
                }
        }
    }
}

struct PackMmaParams {
    const bf16* g;      // (nxp, nyp, nz, kc)
    const bf16* w;      // (kp, 8*NT): column (dx * ky + dy) * cout + o; zero past kc rows
                        // and kx * ky * cout columns
    const float* bias;  // may be null
    int act;
    void* out;
    int out_bf16;
    int nxp, nyp, nz, kc, kx, ky, cout, kp;
    int xb;             // output planes a block walks
    int nbuf;           // stages in the ring
};

// Shared memory of the pack kernel with nbuf staged buffers: the staging
// ring, all of the packed weights, one input plane's products (float32)
// and the ring of kx output-plane accumulators.
__host__ __device__ constexpr size_t pack_smem(int nbuf, int kp, int nt, int kx, int ky, int cout) {
    return sizeof(bf16) * ((size_t)nbuf * PROWS * PTZ * PKCHP + (size_t)kp * mma_pitch(nt)) +
           sizeof(float) * ((size_t)PROWS * PTZ * (8 * nt + 4) +
                            (size_t)kx * (PROWS - ky + 1) * PTZ * cout);
}

template <int NT>
__global__ void __launch_bounds__(PK_THREADS, 1)
pack_mma_kernel(const __grid_constant__ PackMmaParams p) {
    constexpr int NP = 8 * NT, WP = mma_pitch(NT), PP = NP + 4;
    constexpr int IN = PROWS * PTZ * PKCHP;
    extern __shared__ uint4 smem_u4[];
    const int nbuf = p.nbuf, kx = p.kx, ky = p.ky, cout = p.cout;
    bf16* s_ring = reinterpret_cast<bf16*>(smem_u4);  // nbuf staged (plane, chunk)s
    bf16* s_w = s_ring + nbuf * IN;                    // (kp, WP)
    float* s_p = reinterpret_cast<float*>(s_w + p.kp * WP);  // (PROWS * PTZ, PP) products
    float* s_acc = s_p + PROWS * PTZ * PP;             // (kx, ty * PTZ * cout) accumulators
    const int ty = PROWS - ky + 1;                     // output rows a block
    const int nx = p.nxp - kx + 1, ny = p.nyp - ky + 1;
    const int z0 = blockIdx.x * PTZ, y0 = blockIdx.y * ty;
    const int x0 = blockIdx.z * p.xb, x1 = min(nx, x0 + p.xb);
    const int nchunk = (p.kp + PKCH - 1) / PKCH;
    const int nstage = (x1 - x0 + kx - 1) * nchunk;  // (input plane, chunk)
    const int nacc = ty * PTZ * cout;                // an output plane's accumulators
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

    for (int i = tid; i < kx * nacc; i += PK_THREADS) s_acc[i] = 0.0f;
    for (int u = tid; u < p.kp * NT; u += PK_THREADS)  // with stage 0's copies
        cp_async16(s_w + (u / NT) * WP + 8 * (u % NT), p.w + (size_t)(u / NT) * NP + 8 * (u % NT));
    auto issue = [&](int s) {
        if (s < nstage) {
            const int plane = x0 + s / nchunk, c0 = (s % nchunk) * PKCH;
            bf16* s_in = s_ring + (s % nbuf) * IN;
            for (int u = tid; u < PROWS * PTZ * (PKCH / 8); u += PK_THREADS) {
                const int q = u % (PKCH / 8), cell = (u / (PKCH / 8)) % PTZ;
                const int r = u / (PKCH / 8 * PTZ);
                stage_g(s_in + (r * PTZ + cell) * PKCHP + 8 * q, p.g, plane, y0 + r, z0 + cell,
                        c0 + 8 * q, p.nyp, p.nz, p.kc);
            }
        }
        cp_async_commit();
    };

    // the products of the warp's input rows 2 warp and 2 warp + 1: one chain
    // over the plane's K (at most CHAIN k16 steps)
    float acc[2][NT][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][t][e] = 0.0f;

    const int a_lane = (2 * warp * PTZ + (lane & 15)) * PKCHP + (lane >> 4) * 8;
    const int b_lane = (lane & 15) * WP;
    for (int s = 0; s < nbuf - 1; ++s) issue(s);
    for (int s = 0; s < nstage; ++s) {
        issue(s + nbuf - 1);
        ring_wait(nbuf);
        const int chunk = s % nchunk, c0 = chunk * PKCH;
        const int nks = min(PKCH, p.kp - c0) / 16;
        const bf16* s_in = s_ring + (s % nbuf) * IN + a_lane;
#pragma unroll 1
        for (int ks = 0; ks < nks; ++ks) {
            uint32_t a0[4], a1[4];
            ldsm_x4(a0, s_in + ks * 16);
            ldsm_x4(a1, s_in + PTZ * PKCHP + ks * 16);
#pragma unroll
            for (int t = 0; t < NT; ++t) {
                uint32_t b[2];
                ldsm_x2_trans(b, s_w + b_lane + (c0 + ks * 16) * WP + 8 * t);
                mma_bf16(acc[0][t], a0, b);
                mma_bf16(acc[1][t], a1, b);
            }
        }
        if (chunk == nchunk - 1) {
            // the input plane's products are complete: to shared memory
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
                for (int t = 0; t < NT; ++t)
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        const int row = (2 * warp + r) * PTZ + (lane >> 2) + 8 * half;
                        *reinterpret_cast<float2*>(s_p + row * PP + 8 * t + 2 * (lane & 3)) =
                            make_float2(acc[r][t][2 * half], acc[r][t][2 * half + 1]);
                        acc[r][t][2 * half] = acc[r][t][2 * half + 1] = 0.0f;
                    }
            __syncthreads();
            // the tap sums: output plane x = plane - dx takes column group
            // (dx, dy) of input row y + dy; each output value is one thread's,
            // its taps added in the order (dx, dy)
            const int plane = x0 + s / nchunk;
            for (int e = tid; e < nacc; e += PK_THREADS) {
                const int o = e % cout, cz = e / cout;
                const int z = cz % PTZ, y = cz / PTZ;
                const float* pr = s_p + (y * PTZ + z) * PP + o;
                for (int dx = 0; dx < kx; ++dx) {
                    const int x = plane - dx;
                    if (x < x0 || x >= x1) continue;
                    float col[PMAXKY];  // the column groups, read together, added in order
#pragma unroll
                    for (int dy = 0; dy < PMAXKY; ++dy)
                        col[dy] = dy < ky ? pr[dy * PTZ * PP + (dx * ky + dy) * cout] : 0.0f;
                    float* a = s_acc + (x % kx) * nacc + e;
                    float v = *a;
#pragma unroll
                    for (int dy = 0; dy < PMAXKY; ++dy)
                        if (dy < ky) v += col[dy];
                    *a = v;
                }
                const int x = plane - kx + 1;  // its last tap is in
                if (x < x0) continue;
                float* a = s_acc + (x % kx) * nacc + e;
                const float v = epilogue(*a, p.bias, o, p.act);
                *a = 0.0f;
                const int yy = y0 + y, zz = z0 + z;
                if (yy >= ny || zz >= p.nz) continue;
                const size_t off = (((size_t)x * ny + yy) * p.nz + zz) * cout + o;
                if (p.out_bf16)
                    static_cast<bf16*>(p.out)[off] = __float2bfloat16(v);
                else
                    static_cast<float*>(p.out)[off] = v;
            }
        }
        __syncthreads();  // the products and the buffer are rewritten
    }
}

// Whether the pack kernel takes a layer: every tap packs into one tile of
// at most 128 columns, kp into one chain, and its shared memory fits (the
// wrapper's `ops/conv_kernels.py` `pack_mma_takes` is the same rule).
bool pack_takes(int kc, int kx, int ky, int cout) {
    const int kp = (kc + 15) / 16 * 16, n = kx * ky * cout;
    return kx >= 1 && ky >= 1 && ky <= PMAXKY && cout >= 1 && n <= 8 * PMAXNT && kp <= PMAXKP &&
           pack_smem(2, kp, (n + 7) / 8, kx, ky, cout) <= SMEM_MAX;
}

// kc rounded up to 16 and the padded output columns, as the wrapper packs them
bool tap_geometry_ok(int kc, int cout, int kp, int nt, int np) {
    return kc >= 8 && kp == (kc + 15) / 16 * 16 && nt >= 1 && nt <= TMAXNT &&
           np % (8 * nt) == 0 && np >= cout && np - 8 * nt < cout;
}

template <int KY, int NT>
cudaError_t launch_tap_mma(TapMmaParams p, cudaStream_t stream) {
    size_t smem = ring_smem(tap_stage_elems<KY, NT>(), tap_min_blocks(KY, NT), &p.nbuf);
    const size_t epilogue_bytes = sizeof(float) * (TM_THREADS / 32) * TRW * 16 * (8 * NT + 4);
    smem = smem > epilogue_bytes ? smem : epilogue_bytes;
    const cudaError_t e = set_smem((const void*)tap_mma_kernel<KY, NT>, smem);
    if (e != cudaSuccess) return e;
    const int nx = p.nxp - p.kx + 1, ny = p.nyp - KY + 1;
    const dim3 grid((p.nz + TTZ - 1) / TTZ, (ny + TTY - 1) / TTY, nx * (p.np / (8 * NT)));
    tap_mma_kernel<KY, NT><<<grid, TM_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <int NT>
cudaError_t launch_pack_mma(PackMmaParams p, cudaStream_t stream) {
    p.nbuf = pack_smem(3, p.kp, NT, p.kx, p.ky, p.cout) <= SMEM_MAX ? 3 : 2;
    const size_t smem = pack_smem(p.nbuf, p.kp, NT, p.kx, p.ky, p.cout);  // `pack_takes` checked
    const cudaError_t e = set_smem((const void*)pack_mma_kernel<NT>, smem);
    if (e != cudaSuccess) return e;
    const int nx = p.nxp - p.kx + 1, ny = p.nyp - p.ky + 1, ty = PROWS - p.ky + 1;
    const int zs = (p.nz + PTZ - 1) / PTZ, ys = (ny + ty - 1) / ty;
    int groups = (PBLOCKS + zs * ys - 1) / (zs * ys);
    groups = groups > nx ? nx : groups;
    p.xb = (nx + groups - 1) / groups;
    const dim3 grid(zs, ys, (nx + p.xb - 1) / p.xb);
    pack_mma_kernel<NT><<<grid, PK_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

#define INS_TAP_NT(KY)                                          \
    switch (nt) {                                               \
        case 1: return launch_tap_mma<KY, 1>(p, s);             \
        case 2: return launch_tap_mma<KY, 2>(p, s);             \
        case 3: return launch_tap_mma<KY, 3>(p, s);             \
        case 4: return launch_tap_mma<KY, 4>(p, s);             \
        case 5: return launch_tap_mma<KY, 5>(p, s);             \
        default: return cudaErrorInvalidValue;                  \
    }

cudaError_t tap_mma(int ky, int nt, const TapMmaParams& p, cudaStream_t s) {
    switch (ky) {
        case 1: INS_TAP_NT(1)
        case 3: INS_TAP_NT(3)
        case 5: INS_TAP_NT(5)
        case 7: INS_TAP_NT(7)
        default: return cudaErrorInvalidValue;
    }
}

#undef INS_TAP_NT

template <int... NTS>
cudaError_t pack_mma_dispatch(int nt, const PackMmaParams& p, cudaStream_t s,
                              std::integer_sequence<int, NTS...>) {
    cudaError_t e = cudaErrorInvalidValue;
    ((nt == NTS + 1 ? (void)(e = launch_pack_mma<NTS + 1>(p, s)) : (void)0), ...);
    return e;
}

}  // namespace

// The tap forward on the tensor cores: g (nxp, nyp, nz, kc) bf16 (kc a
// multiple of 8, 16-byte aligned), wp the packed weights (kx, ky, kp, np)
// bf16, out (nxp-kx+1, nyp-ky+1, nz, cout) float32 or bf16; ky in (1, 3, 5,
// 7); kp = kc rounded up to 16, np = cout padded to a multiple of 8*nt (nt
// <= 5), as `ops/conv_kernels.py` `tap_mma_geometry` computes them.
extern "C" int ins_tapconv_fwd_mma(const void* g, const void* wp, const float* bias, int act,
                                   void* out, int out_bf16, int nxp, int nyp, int nz, int kc,
                                   int kx, int ky, int cout, int kp, int nt, int np,
                                   void* stream) {
    if (kx < 1 || nxp < kx || nyp < ky || nz < 1 || cout < 1 ||
        !tap_geometry_ok(kc, cout, kp, nt, np) || !stageable(g, kc) || !stageable(wp, np))
        return (int)cudaErrorInvalidValue;
    const TapMmaParams p{static_cast<const bf16*>(g), static_cast<const bf16*>(wp), bias, act,
                         out, out_bf16, cout % 8 == 0 && ((uintptr_t)out & 15) == 0,
                         nxp, nyp, nz, kc, kx, cout, kp, np};
    return (int)tap_mma(ky, nt, p, (cudaStream_t)stream);
}

// The pack forward on the tensor cores: g as `ins_tapconv_fwd_mma`, ws the
// packed weights (kp, 8*nt) bf16 (every tap's columns side by side), out
// (nxp-kx+1, nyp-ky+1, nz, cout) float32 or bf16.
extern "C" int ins_packconv_mma(const void* g, const void* ws, const float* bias, int act,
                                void* out, int out_bf16, int nxp, int nyp, int nz, int kc,
                                int kx, int ky, int cout, int kp, int nt, void* stream) {
    const int n = kx * ky * cout;
    if (nxp < kx || nyp < ky || nz < 1 || kc < 8 || kp != (kc + 15) / 16 * 16 ||
        nt != (n + 7) / 8 || !pack_takes(kc, kx, ky, cout) ||
        !stageable(g, kc) || !stageable(ws, 8 * nt))
        return (int)cudaErrorInvalidValue;
    const PackMmaParams p{static_cast<const bf16*>(g), static_cast<const bf16*>(ws), bias, act,
                          out, out_bf16, nxp, nyp, nz, kc, kx, ky, cout, kp};
    return (int)pack_mma_dispatch(nt, p, (cudaStream_t)stream,
                                  std::make_integer_sequence<int, PMAXNT>{});
}
