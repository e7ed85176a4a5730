// Periodic k^3 convolution layer of the CNN closure, forward (with bias
// and tanh/identity fused in) and weight gradient.
//
//   out[x, y, z, o] = act(b[o] + sum_{dx,dy,dz,c} h[x+dx-r, y+dy-r, z+dz-r, c]
//                                               * w[dx, dy, dz, c, o])
//   dw[dx, dy, dz, c, o] = sum_{x,y,z} h[x+dx-r, y+dy-r, z+dz-r, c] * d[x, y, z, o]
//
// on a periodic (nx, ny, nz) box (indices wrap), channels last: h is
// (nx, ny, nz, cin), d (nx, ny, nz, cout), out (nx, ny, nz, cout) in
// float32 or bfloat16.  Every sum is taken in float32.  The input gradient
// of a layer is the forward kernel on d with the taps flipped and
// transposed (w'[dx, dy, dz, o, c] = w[k-1-dx, k-1-dy, k-1-dz, c, o]).
//
// Replaces: `_fusedconv_kernel` (ins_tpu/ops/convkernels.py:687, wrapper
// `fusedconv_3d` :780, forward and input gradient) and
// `_fused_wgrad_kernel` (:840, wrapper `fusedconv_wgrad_3d` :918).
//
// Both routes run on the tensor cores with the z taps folded into the
// contraction, as in the TPU kernel: in channels-last order the folded row
// of cell (x, y, z) for tap (dx, dy) is the contiguous slice
// row[z*CW : z*CW + KP] of the wrap-padded input row (x+dx-r, y+dy-r), its
// channels padded to CW (wider inputs are cut into nch chunks of CW
// channels) and KP = k*CW rounded up to the mma's step.  So
//   forward  out[cells, o] = sum_{dx,dy,chunk} A[cells, (dz,c)] W[(dz,c), o]
//   wgrad    dW[(dz,c), o] = sum_cells A[cell, (dz,c)]^T d[cell, o]
// with A the overlapping windows of one staged row and W the packed
// weights (k, k, nch*KP, np): zero past k*CW rows and cout columns, np =
// nblk * 8*NT output channels in blocks of NT <= 3 n8 tiles.  A staged
// row carries KP - k*CW zeros past its last cell, which the last window
// reads (times zero weights, or into gradient rows nobody reads: they
// must be finite).  The operands' dtype picks the route:
//
// * bf16 operands (`ins_conv_fwd_mma`, `ins_conv_wgrad_mma`):
//   `mma.sync.m16n8k16` bf16 x bf16 -> float32.  CW is a multiple of 8, at
//   most 24, and KP a multiple of 16; the wrapper pads h and d with zero
//   channels to a multiple of 8, so every staged unit is one 16-byte
//   cp.async.  bf16 operands are exact in float32, so their products are
//   exact and a kernel differs from a float32 reference on the same
//   rounded operands only in the order of its sums.  A is ldmatrix on rows
//   CW*2 bytes apart (48 bytes at CW = 24, conflict-free).
//   - forward: a block of 16 warps owns one x-plane's 8 (y) x 64 (z) cells
//     and one block of 8*NT output channels; a warp owns 2 rows of one m16
//     tile of cells.  The block walks stages (chunk, dx): the input plane's
//     12 x 68-cell window and the k (dy) weight tiles of that dx, in a ring
//     of three (two where they do not fit) buffers filled by cp.async, so
//     the next stages' copies overlap this one's products.  Per k16 step a
//     warp loads the k taps' B fragments (ldmatrix.x2.trans) and each of its
//     2 + k - 1 window rows' A fragment once (ldmatrix.x4): input row ri
//     feeds output row ri - dy through tap dy, so an A fragment feeds up to
//     2*NT mma instead of NT.
//   - weight gradient: a block owns one dx, one chunk and block of output
//     channels and a chunk of cells (8 y x 32 z over a run of x-planes);
//     its (KP/16) x k (m16 tile, dy) items are spread over the 8 warps,
//     each with NT accumulator tiles.  Per x-plane it stages the input
//     window and the d tile (cells past the box zero), three-deep; A is
//     ldmatrix.x4.trans on the windows, B ldmatrix.x2.trans on the d tile,
//     one B fragment for all of a warp's items.
//   The tensor cores' float32 sums truncate, so the forward chains at most
//   8 mma before it adds their sum to its float32 accumulator (an error of
//   a few float32 ulps; the bf16 output then rounds once); the weight
//   gradient's chains run over a block's cells (7.9e-6 of the largest
//   weight at 128^3 against a float64 sum on an H100, within the 1e-4 its
//   checks allow).
//   What bounds it on an H100: shared-memory reads and tensor-core issue
//   (at N = 24 an A fragment of the weight gradient feeds 3 mma), and the
//   staging of each stage's window and weights from L2.
//
// * float32 operands (`ins_conv_fwd_tf32`, `ins_conv_wgrad_tf32`): 3xTF32,
//   `mma.sync.m16n8k8` with TF32 operands and float32 sums (tf32.cuh):
//   each operand split into big = rna(x) and small = rna(x - big), a
//   product small*big + big*small + big*big, about 2^-21 relative against
//   2^-11 for one TF32 pass, so the kernels stay in the float32 class.  The
//   wrapper pads h and d with zero channels to a multiple of 4 (16-byte
//   cp.async units).  There is no transposing load for 32-bit elements, so
//   each kernel's geometry (`ops/conv_kernels.py` `tf32_geometry`) picks
//   CW for its own fragment loads:
//   - forward: A fragments by ldmatrix.x4 on the staged window, a float32
//     read as two b16 values of one row (tf32.cuh `load_split`), rows CW
//     floats apart: CW is an odd number of 16-byte units (4, 12, 20 or 28
//     channels), so an ldmatrix's 8 rows hit distinct banks, and KP = k*CW
//     rounded up to 8.  B comes split from the host in fragment order
//     (`pack_conv_weights_tf32`: per (dx, dy, k8 step, n8 tile) 32 lanes x
//     (big b0, big b1, small b0, small b1)), one 16-byte load a lane.  A
//     block of 16 warps owns one x-plane's 16 (y) x 32 (z) output cells
//     (32 x 32 with a single n8 tile) and one block of output channels, a
//     warp 2 rows (4 with a single n8 tile: few accumulators, and each A
//     fragment then feeds more products) of one m16 tile of cells.  Per k8
//     step the warp walks the dy taps with its current window rows split in
//     registers, one new row a tap, each B fragment feeding all its rows;
//     a chain holds two taps' products.  Stages (chunk, dx) hold the
//     window and the k taps' split fragments, two or three deep in one
//     block an SM (192 KB at 24 -> 24, k = 5, CW = 12: the split weights
//     are 4x the bf16 ones, so the geometry narrows CW where two stages
//     would not fit).
//   - weight gradient: A = windows^T and B = d both come from 32-bit
//     shared loads in the m16n8k8 fragment pattern (a0 = (g, t), a1 = (g +
//     8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4) at window offset t*CW +
//     g; b0 = (t, g), b1 = (t + 4, g)) and are split in registers.  The
//     32 lanes hit distinct banks where t*CW is 0, 8, 16, 24 mod 32 (CW = 8
//     or 24) or the lanes' words overlap (CW = 4), and the d tile's pitch is
//     8 or 24 floats; KP = k*CW rounded up to 16 (m16 tiles).  A block of 8
//     warps owns one dx, one chunk and block of output channels, a group of
//     mc m16 tiles (mc dividing 8, mc * k <= 40: warp w takes tile w % mc
//     and every (8/mc)-th dy from w / mc, at most 5 (tile, dy) items of NT
//     accumulator tiles) and a chunk of cells (8 y x 16 z over a run of
//     x-planes); per x-plane it stages the window and the d tile, two or
//     three deep, two blocks an SM.  Per k8 step of cells a warp loads and
//     splits the NT B fragments once, then each item's A fragment; each
//     step's three products are one chain, added to the item's float32
//     accumulators.
//   What bounds it on an H100: a 24 -> 24 layer at 128^3 with k = 5 is 302
//   GFLOP, 906 GFLOP of TF32 mma (1.83 ms at the 495 TFLOP/s dense TF32
//   peak) against 0.2 GB of compulsory traffic; mma.sync issue, the
//   fragment loads and splits beside it, and the restaging of windows and
//   weights from L2 hold it below that peak.
//
// The weight gradients write one partial sum per block; a second kernel
// adds the partials of every weight in a fixed order, so the result is the
// same on every run (no atomics).

#include <cstdint>

#include "convio.cuh"  // cp.async, ldmatrix, mma_bf16, ring_wait, reduce_partials_kernel
#include "tf32.cuh"    // FRAG, TAPS_CHAINED, tf32_rna, mma_tf32, load_split, row_products

// --------------------------------------------------------------------------
// The bf16 route: tensor-core kernels on z-folded windows
// --------------------------------------------------------------------------

namespace {

constexpr int MMA_THREADS = 256;  // 8 warps
constexpr int MMA_WARPS = MMA_THREADS / 32;
constexpr int FWD_THREADS = 512;  // forward: 16 warps
constexpr int FTY = 8;            // forward: output rows (y) a block
constexpr int FTZ = 64;           // forward: output cells (z) a row
constexpr int FRW = 2;            // forward: output rows a warp (one m16 tile of cells)
static_assert(FTY * FTZ == FWD_THREADS / 32 * FRW * 16, "the warps tile the block's cells");
constexpr int GTY = 8;            // wgrad: cell rows (y) a block
constexpr int GTZ = 32;           // wgrad: cells (z) a row
constexpr int MAXNT = 3;          // n8 tiles of output channels a block, at most
constexpr int MMA_WBLOCKS = 1024; // wgrad: target number of blocks

// contraction depth of one (dx, dy, chunk): k*CW rounded up to 16
__host__ __device__ constexpr int mma_kp(int k, int cw) { return (k * cw + 15) / 16 * 16; }

// elements of a staged row of `cells` cells: the cells, then the zeros the
// last window reads past them
__host__ __device__ constexpr int mma_rowlen(int k, int cw, int cells) {
    return cells * cw + mma_kp(k, cw) - k * cw;
}

template <int K, int CW>
__host__ __device__ constexpr int fwd_mma_in_elems() {
    return (FTY + K - 1) * mma_rowlen(K, CW, FTZ + K - 1);
}

template <int K, int CW>
__host__ __device__ constexpr int wgrad_mma_in_elems() {
    return (GTY + K - 1) * mma_rowlen(K, CW, GTZ + K - 1);
}

// v mod n for v at most a few periods outside [0, n)
__device__ __forceinline__ int wrap_near(int v, int n) {
    while (v < 0) v += n;
    while (v >= n) v -= n;
    return v;
}

// Stage channels c0 .. c0+7 of `cell` of a channels-last bf16 field with c
// channels (c % 8 == 0, the field 16-byte aligned: the wrapper pads) into
// 16 bytes of shared memory: one cp.async, or zeros past c.
__device__ __forceinline__ void stage8(bf16* dst, const bf16* field, size_t cell, int c0, int c) {
    if (c0 < c)
        cp_async16(dst, field + cell * c + c0);
    else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// The staging of an input window (ROWS rows x CELLS cells of one chunk of
// CW channels, row pitch ROWLEN) by one thread: it owns one (cell, 8-channel
// group) unit and stages it in every RSTEP-th row, so its z offset and
// shared-memory offset are computed once a block.
template <int ROWS, int CELLS, int CW, int ROWLEN, int NTHR>
struct WindowStager {
    static constexpr int GPR = CW / 8, UNITS = CELLS * GPR, RSTEP = NTHR / UNITS;
    static_assert(RSTEP >= 1, "a row of the window has more units than the block threads");
    int r0, soff, c0, z;

    __device__ WindowStager(int tid, int z0, int nz) {
        const int u = tid % UNITS, c = u / GPR, g = u % GPR;
        r0 = tid / UNITS;
        soff = c * CW + 8 * g;
        c0 = 8 * g;
        z = wrap_near(z0 + c, nz);
    }

    // rows y0 .. y0 + ROWS - 1 (wrapped) of plane xp, channels ch*CW + ...
    __device__ __forceinline__ void stage(bf16* s, const bf16* h, int xp, int y0, int ny, int nz,
                                          int cin, int ch) const {
#pragma unroll
        for (int i = 0; i < (ROWS + RSTEP - 1) / RSTEP; ++i) {
            const int r = r0 + i * RSTEP;
            if (r >= ROWS || r0 >= RSTEP) break;
            const size_t cell = ((size_t)xp * ny + wrap_near(y0 + r, ny)) * nz + z;
            stage8(s + r * ROWLEN + soff, h, cell, ch * CW + c0, cin);
        }
    }
};

// Zero the KP - k*CW elements past the cells of each of the rows (the part
// of a window past the last cell; never written by a stage).
template <int ROWS, int CELLS, int CW, int ROWLEN>
__device__ __forceinline__ void zero_row_tails(bf16* s, int tid) {
    constexpr int TAIL = ROWLEN - CELLS * CW;  // 0 or 8
    if (TAIL == 0) return;
    for (int r = tid; r < ROWS; r += blockDim.x)
        *reinterpret_cast<uint4*>(s + r * ROWLEN + CELLS * CW) = make_uint4(0u, 0u, 0u, 0u);
}

// The forwards' epilogue: bias, activation and the store of a warp's RW
// output rows (from y) of one m16 tile of cells (from z) x 8*NT channels
// (from n0) of accumulators in mma.sync's C layout; rows and cells past the
// box and channels past cout are dropped.
template <int RW, int NT, class Params>
__device__ __forceinline__ void store_rows(const float (&acc)[RW][NT][4], const Params& p, int x,
                                           int y, int z, int n0, int lane) {
#pragma unroll
    for (int r = 0; r < RW; ++r) {
        if (y + r >= p.ny) break;
        const size_t row = ((size_t)x * p.ny + y + r) * p.nz;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int zc = z + (lane >> 2) + 8 * half;
            if (zc >= p.nz) continue;
            const size_t cell = (row + zc) * p.cout;
#pragma unroll
            for (int t = 0; t < NT; ++t) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int co = n0 + 8 * t + 2 * (lane & 3) + e;
                    if (co >= p.cout) continue;
                    float v = acc[r][t][2 * half + e];
                    if (p.bias) v += __ldg(p.bias + co);
                    if (p.act == 1) v = tanhf(v);
                    if (p.out_bf16)
                        static_cast<bf16*>(p.out)[cell + co] = __float2bfloat16(v);
                    else
                        static_cast<float*>(p.out)[cell + co] = v;
                }
            }
        }
    }
}

struct MmaConvParams {
    const bf16* h;     // (nx, ny, nz, cin)
    const bf16* w;     // packed (k, k, nch * kp, np)
    const float* bias; // may be null
    int act;           // 0 identity, 1 tanh
    void* out;
    int out_bf16;
    int nx, ny, nz, cin, cout;
    int nch, np;       // input chunks; output channels, padded
    int nbuf;          // stages in the ring
};

template <int K, int CW, int NT>
__global__ void __launch_bounds__(FWD_THREADS, 1)
conv_fwd_mma_kernel(const __grid_constant__ MmaConvParams p) {
    constexpr int R = K / 2, KP = mma_kp(K, CW), WP = mma_pitch(NT);
    // k16 steps whose products one tensor-core chain sums (K mma a step)
    // before a float32 add
    constexpr int FLUSH = CHAIN / K > 1 ? CHAIN / K : 1;
    constexpr int ROWS = FTY + K - 1, CELLS = FTZ + K - 1;
    constexpr int ROWLEN = mma_rowlen(K, CW, CELLS);
    constexpr int IN = fwd_mma_in_elems<K, CW>();
    extern __shared__ uint4 smem_u4[];
    bf16* smem = reinterpret_cast<bf16*>(smem_u4);
    const int nbuf = p.nbuf;
    constexpr int STAGE = IN + K * KP * WP;  // a buffer: window, then the k weight tiles
    const int nblk = p.np / (8 * NT);
    const int x = blockIdx.z / nblk, n0 = (blockIdx.z % nblk) * 8 * NT;
    const int y0 = blockIdx.y * FTY, z0 = blockIdx.x * FTZ;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    // warp: output rows wy0 .. wy0 + FRW - 1, cells 16 * wm .. 16 * wm + 15
    const int wy0 = (warp / (FTZ / 16)) * FRW, wm = warp % (FTZ / 16);
    const int nstage = p.nch * K;  // (chunk, dx)

    for (int b = 0; b < nbuf; ++b)
        zero_row_tails<ROWS, CELLS, CW, ROWLEN>(smem + b * STAGE, tid);
    const WindowStager<ROWS, CELLS, CW, ROWLEN, FWD_THREADS> window(tid, z0 - R, p.nz);
    auto issue = [&](int s) {
        if (s < nstage) {
            const int ch = s / K, dx = s % K;
            bf16* s_in = smem + (s % nbuf) * STAGE;
            bf16* s_w = s_in + IN;
            window.stage(s_in, p.h, wrap_near(x + dx - R, p.nx), y0 - R, p.ny, p.nz, p.cin, ch);
            // rows (dy, j) of tap (dx, dy), chunk ch, this block's columns
            const bf16* w = p.w + ((size_t)(dx * K * p.nch + ch) * KP) * p.np + n0;
            for (int u = tid; u < K * KP * NT; u += FWD_THREADS) {
                const int t = u % NT, row = u / NT;
                const int dy = row / KP, j = row % KP;
                cp_async16(s_w + row * WP + 8 * t, w + ((size_t)dy * p.nch * KP + j) * p.np + 8 * t);
            }
        }
        cp_async_commit();
    };

    // acc: the sum (float32 adds); part: the products of FLUSH k16 steps,
    // chained in the tensor cores (whose float32 sums truncate: chains of at
    // most CHAIN mma keep their error at a few float32 ulps)
    float acc[FRW][NT][4], part[FRW][NT][4];
#pragma unroll
    for (int r = 0; r < FRW; ++r)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][t][e] = part[r][t][e] = 0.0f;

    // ldmatrix row addresses: A rows are cells (lanes 0-15: k 0-7, 16-31:
    // k 8-15), B rows are window elements (lanes 0-15)
    const int a_lane = wy0 * ROWLEN + (16 * wm + (lane & 15)) * CW + (lane >> 4) * 8;
    const int b_lane = (lane & 15) * WP;
    for (int s = 0; s < nbuf - 1; ++s) issue(s);
    for (int s = 0; s < nstage; ++s) {
        issue(s + nbuf - 1);
        ring_wait(nbuf);
        const bf16* s_in = smem + (s % nbuf) * STAGE + a_lane;
        const bf16* s_w = smem + (s % nbuf) * STAGE + IN + b_lane;
#pragma unroll 1
        for (int ks = 0; ks < KP / 16; ++ks) {
            // the k16 step's weights of every y-tap, then each window row
            // once: input row ri feeds output row ri - dy through tap dy
            uint32_t b[K][NT][2];
#pragma unroll
            for (int dy = 0; dy < K; ++dy)
#pragma unroll
                for (int t = 0; t < NT; ++t)
                    ldsm_x2_trans(b[dy][t], s_w + (dy * KP + ks * 16) * WP + 8 * t);
#pragma unroll
            for (int ri = 0; ri < FRW + K - 1; ++ri) {
                uint32_t a[4];
                ldsm_x4(a, s_in + ri * ROWLEN + ks * 16);
#pragma unroll
                for (int dy = 0; dy < K; ++dy) {
                    const int ro = ri - dy;
                    if (ro < 0 || ro >= FRW) continue;
#pragma unroll
                    for (int t = 0; t < NT; ++t) mma_bf16(part[ro][t], a, b[dy][t]);
                }
            }
            if ((ks + 1) % FLUSH == 0 || ks == KP / 16 - 1) {
#pragma unroll
                for (int r = 0; r < FRW; ++r)
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

    store_rows(acc, p, x, y0 + wy0, z0 + 16 * wm, n0, lane);
}

struct MmaWgradParams {
    const bf16* h;   // (nx, ny, nz, cin)
    const bf16* d;   // (nx, ny, nz, cout)
    float* partial;  // (nchunk, k, k, nch * kp, np)
    int nx, ny, nz, cin, cout;
    int nch, np;       // input chunks; output channels, padded
    int xb;          // x-planes a cell chunk
    int nbuf;        // stages in the ring
};

__host__ __device__ inline void wgrad_mma_chunks(int nx, int ny, int nz, int k, int nch,
                                                 int nblk, int* xb, int* nchunk) {
    const int yz = ((ny + GTY - 1) / GTY) * ((nz + GTZ - 1) / GTZ);
    const int per_group = yz * k * nch * nblk;
    int groups = (MMA_WBLOCKS + per_group - 1) / per_group;
    groups = groups < 1 ? 1 : (groups > nx ? nx : groups);
    *xb = (nx + groups - 1) / groups;
    *nchunk = ((nx + *xb - 1) / *xb) * yz;
}

template <int K, int CW, int NT>
__global__ void __launch_bounds__(MMA_THREADS, K < 7 ? 2 : 1)
wgrad_mma_kernel(const __grid_constant__ MmaWgradParams p) {
    constexpr int R = K / 2, KP = mma_kp(K, CW), MTJ = KP / 16, WP = mma_pitch(NT);
    constexpr int NITEMS = MTJ * K;  // (m16 tile of window rows, dy)
    constexpr int IPW = (NITEMS + MMA_WARPS - 1) / MMA_WARPS;
    constexpr int ROWS = GTY + K - 1, CELLS = GTZ + K - 1;
    constexpr int ROWLEN = mma_rowlen(K, CW, CELLS);
    constexpr int IN = wgrad_mma_in_elems<K, CW>();
    extern __shared__ uint4 smem_u4[];
    bf16* smem = reinterpret_cast<bf16*>(smem_u4);
    const int nbuf = p.nbuf;
    constexpr int STAGE = IN + GTY * GTZ * WP;  // a buffer: window, then the d tile
    const int nblk = p.np / (8 * NT);
    const int ch = blockIdx.y / nblk, n0 = (blockIdx.y % nblk) * 8 * NT;
    const int dx = blockIdx.z;
    const int ytiles = (p.ny + GTY - 1) / GTY, ztiles = (p.nz + GTZ - 1) / GTZ;
    const int chunk = blockIdx.x;
    const int zt = chunk % ztiles, yt = (chunk / ztiles) % ytiles, xg = chunk / (ztiles * ytiles);
    const int y0 = yt * GTY, z0 = zt * GTZ;
    const int x0 = xg * p.xb, x1 = min(p.nx, x0 + p.xb);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int nstage = x1 - x0;

    for (int b = 0; b < nbuf; ++b)
        zero_row_tails<ROWS, CELLS, CW, ROWLEN>(smem + b * STAGE, tid);
    const WindowStager<ROWS, CELLS, CW, ROWLEN, MMA_THREADS> window(tid, z0 - R, p.nz);
    auto issue = [&](int s) {
        if (s < nstage) {
            const int x = x0 + s;
            bf16* s_in = smem + (s % nbuf) * STAGE;
            bf16* s_d = s_in + IN;
            window.stage(s_in, p.h, wrap_near(x + dx - R, p.nx), y0 - R, p.ny, p.nz, p.cin, ch);
            for (int v = tid; v < GTY * GTZ * NT; v += MMA_THREADS) {
                const int t = v % NT, u = v / NT;
                const int y = y0 + u / GTZ, z = z0 + u % GTZ;
                bf16* dst = s_d + u * WP + 8 * t;
                if (y < p.ny && z < p.nz)  // cells past the box add 0
                    stage8(dst, p.d, ((size_t)x * p.ny + y) * p.nz + z, n0 + 8 * t, p.cout);
                else
                    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
            }
        }
        cp_async_commit();
    };

    float acc[IPW][NT][4];
#pragma unroll
    for (int q = 0; q < IPW; ++q)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[q][t][e] = 0.0f;

    // ldmatrix.trans row addresses: A's stored rows are cells (lanes 0-7 and
    // 8-15: cells 0-7, window rows +0 and +8; lanes 16-31: cells 8-15), B's
    // stored rows are cells (lanes 0-15)
    const int a_lane = ((lane & 7) + 8 * (lane >> 4)) * CW + 8 * ((lane >> 3) & 1);
    const int b_lane = (lane & 15) * WP;
    // offset of each item's window rows in the staged plane (items past the
    // last are computed on item 0's rows and dropped)
    int a_item[IPW];
#pragma unroll
    for (int q = 0; q < IPW; ++q) {
        const int it = warp + MMA_WARPS * q;
        a_item[q] = it < NITEMS ? (it / MTJ) * ROWLEN + (it % MTJ) * 16 : 0;
    }
    for (int s = 0; s < nbuf - 1; ++s) issue(s);
    for (int s = 0; s < nstage; ++s) {
        issue(s + nbuf - 1);
        ring_wait(nbuf);
        const bf16* s_in = smem + (s % nbuf) * STAGE + a_lane;
        const bf16* s_d = smem + (s % nbuf) * STAGE + IN + b_lane;
#pragma unroll 1
        for (int ly = 0; ly < GTY; ++ly) {
#pragma unroll
            for (int ks = 0; ks < GTZ / 16; ++ks) {
                uint32_t b[NT][2];
#pragma unroll
                for (int t = 0; t < NT; ++t)
                    ldsm_x2_trans(b[t], s_d + (ly * GTZ + 16 * ks) * WP + 8 * t);
                const bf16* arow = s_in + ly * ROWLEN + 16 * ks * CW;
#pragma unroll
                for (int q = 0; q < IPW; ++q) {
                    uint32_t a[4];
                    ldsm_x4_trans(a, arow + a_item[q]);
#pragma unroll
                    for (int t = 0; t < NT; ++t) mma_bf16(acc[q][t], a, b[t]);
                }
            }
        }
        __syncthreads();  // the buffer is refilled nbuf - 1 stages on
    }

    const size_t nw = (size_t)K * K * p.nch * KP * p.np;
    float* part = p.partial + (size_t)chunk * nw;
#pragma unroll
    for (int q = 0; q < IPW; ++q) {
        const int it = warp + MMA_WARPS * q;
        if (it >= NITEMS) break;
        const int dy = it / MTJ, j = (it % MTJ) * 16 + (lane >> 2);
        const size_t base = (((size_t)dx * K + dy) * p.nch + ch) * KP;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
            const int n = n0 + 8 * t + 2 * (lane & 3);
            *reinterpret_cast<float2*>(part + (base + j) * p.np + n) =
                make_float2(acc[q][t][0], acc[q][t][1]);
            *reinterpret_cast<float2*>(part + (base + j + 8) * p.np + n) =
                make_float2(acc[q][t][2], acc[q][t][3]);
        }
    }
}

// The checks both bf16 entry points make of the chunk/tile geometry the
// wrapper computed (`ops/conv_kernels.py` `mma_geometry`).
bool mma_geometry_ok(int cin, int cout, int k, int cw, int nch, int kp, int nt, int np) {
    return (cw == 8 || cw == 16 || cw == 24) && nch >= 1 && nch * cw >= cin &&
           (nch - 1) * cw < cin && kp == mma_kp(k, cw) && nt >= 1 && nt <= MAXNT &&
           np % (8 * nt) == 0 && np >= cout && np - 8 * nt < cout;
}

template <int K, int CW, int NT>
cudaError_t launch_fwd_mma(MmaConvParams p, cudaStream_t stream) {
    const size_t smem = ring_smem(
        (size_t)fwd_mma_in_elems<K, CW>() + K * mma_kp(K, CW) * mma_pitch(NT), 1, &p.nbuf);
    cudaError_t e = set_smem((const void*)conv_fwd_mma_kernel<K, CW, NT>, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((p.nz + FTZ - 1) / FTZ, (p.ny + FTY - 1) / FTY, p.nx * (p.np / (8 * NT)));
    conv_fwd_mma_kernel<K, CW, NT><<<grid, FWD_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <int K, int CW, int NT>
cudaError_t launch_wgrad_mma(MmaWgradParams p, int nchunk, cudaStream_t stream) {
    const size_t smem = ring_smem(
        (size_t)wgrad_mma_in_elems<K, CW>() + GTY * GTZ * mma_pitch(NT), K < 7 ? 2 : 1, &p.nbuf);
    cudaError_t e = set_smem((const void*)wgrad_mma_kernel<K, CW, NT>, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(nchunk, p.nch * (p.np / (8 * NT)), K);
    wgrad_mma_kernel<K, CW, NT><<<grid, MMA_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

// (k, cw, nt) -> the kernel instantiation
#define INS_MMA_NT(LAUNCH, K, CW, ...)                                                  \
    switch (nt) {                                                                       \
        case 1: return LAUNCH<K, CW, 1>(__VA_ARGS__);                                   \
        case 2: return LAUNCH<K, CW, 2>(__VA_ARGS__);                                   \
        case 3: return LAUNCH<K, CW, 3>(__VA_ARGS__);                                   \
        default: return cudaErrorInvalidValue;                                          \
    }
#define INS_MMA_DISPATCH(LAUNCH, ...)                                                   \
    switch (k * 100 + cw) {                                                             \
        case 308: INS_MMA_NT(LAUNCH, 3, 8, __VA_ARGS__)                                 \
        case 316: INS_MMA_NT(LAUNCH, 3, 16, __VA_ARGS__)                                \
        case 324: INS_MMA_NT(LAUNCH, 3, 24, __VA_ARGS__)                                \
        case 508: INS_MMA_NT(LAUNCH, 5, 8, __VA_ARGS__)                                 \
        case 516: INS_MMA_NT(LAUNCH, 5, 16, __VA_ARGS__)                                \
        case 524: INS_MMA_NT(LAUNCH, 5, 24, __VA_ARGS__)                                \
        case 708: INS_MMA_NT(LAUNCH, 7, 8, __VA_ARGS__)                                 \
        case 716: INS_MMA_NT(LAUNCH, 7, 16, __VA_ARGS__)                                \
        case 724: INS_MMA_NT(LAUNCH, 7, 24, __VA_ARGS__)                                \
        default: return cudaErrorInvalidValue;                                          \
    }

cudaError_t fwd_mma(int k, int cw, int nt, const MmaConvParams& p, cudaStream_t s) {
    INS_MMA_DISPATCH(launch_fwd_mma, p, s)
}

cudaError_t wgrad_mma(int k, int cw, int nt, const MmaWgradParams& p, int nchunk,
                      cudaStream_t s) {
    INS_MMA_DISPATCH(launch_wgrad_mma, p, nchunk, s)
}

#undef INS_MMA_DISPATCH
#undef INS_MMA_NT

}  // namespace

// bf16 forward on the tensor cores: h (nx, ny, nz, cin) bf16 (cin a
// multiple of 8: the wrapper pads it with zero channels), wp the packed
// weights (k, k, nch * kp, np) bf16, out (nx, ny, nz, cout) in float32 or
// bf16; (cw, nch, kp, nt, np) as `ops/conv_kernels.py` `mma_geometry`
// computes them.
extern "C" int ins_conv_fwd_mma(const void* h, const void* wp, const float* bias, int act,
                                void* out, int out_bf16, int nx, int ny, int nz, int cin,
                                int cout, int k, int cw, int nch, int kp, int nt, int np,
                                void* stream) {
    if (!mma_geometry_ok(cin, cout, k, cw, nch, kp, nt, np) || !stageable(h, cin) ||
        !stageable(wp, np))
        return (int)cudaErrorInvalidValue;
    const MmaConvParams p{static_cast<const bf16*>(h), static_cast<const bf16*>(wp), bias, act,
                          out, out_bf16, nx, ny, nz, cin, cout, nch, np};
    return (int)fwd_mma(k, cw, nt, p, (cudaStream_t)stream);
}

// Number of cell chunks (rows of the partial-sum buffer) of a bf16 wgrad call.
extern "C" int ins_conv_wgrad_mma_chunks(int nx, int ny, int nz, int k, int nch, int nblk) {
    int xb, nchunk;
    wgrad_mma_chunks(nx, ny, nz, k, nch, nblk, &xb, &nchunk);
    return nchunk;
}

// bf16 weight gradient on the tensor cores: h (nx, ny, nz, cin) and d
// (nx, ny, nz, cout) bf16 (cin and cout multiples of 8: the wrapper pads);
// dwp the packed float32 gradient (k, k, nch * kp, np), partial (nchunk,
// k, k, nch * kp, np) float32 scratch.
extern "C" int ins_conv_wgrad_mma(const void* h, const void* d, float* partial, float* dwp,
                                  int nx, int ny, int nz, int cin, int cout, int k, int cw,
                                  int nch, int kp, int nt, int np, void* stream) {
    if (!mma_geometry_ok(cin, cout, k, cw, nch, kp, nt, np) || !stageable(h, cin) ||
        !stageable(d, cout))
        return (int)cudaErrorInvalidValue;
    int xb, nchunk;
    wgrad_mma_chunks(nx, ny, nz, k, nch, np / (8 * nt), &xb, &nchunk);
    const MmaWgradParams p{static_cast<const bf16*>(h), static_cast<const bf16*>(d), partial,
                           nx, ny, nz, cin, cout, nch, np, xb};
    const cudaStream_t s = (cudaStream_t)stream;
    const cudaError_t e = wgrad_mma(k, cw, nt, p, nchunk, s);
    if (e != cudaSuccess) return (int)e;
    const size_t nw = (size_t)k * k * nch * kp * np;
    reduce_partials_kernel<<<(unsigned)((nw + 255) / 256), 256, 0, s>>>(partial, dwp, nchunk, nw);
    return (int)cudaGetLastError();
}

// --------------------------------------------------------------------------
// The float32 route: 3xTF32 tensor-core kernels on z-folded windows
// --------------------------------------------------------------------------

namespace {

constexpr int SM_SMEM = 227 * 1024;  // an SM's shared memory for blocks (and a block's most)
constexpr int TF_FWD_THREADS = 512;  // forward: 16 warps
constexpr int TFZ = 32;              // forward: output cells (z) a row (two m16 tiles)
constexpr int TW_THREADS = 256;      // wgrad: 8 warps
constexpr int TW_WARPS = TW_THREADS / 32;
constexpr int TWY = 8;               // wgrad: cell rows (y) a block
constexpr int TWZ = 16;              // wgrad: cells (z) a row (two k8 steps)
constexpr int TW_IPW = 5;            // wgrad: (m16 tile, dy) items a warp, at most
constexpr int TW_SM_BLOCKS = 2;      // wgrad: blocks an SM (128 registers a thread)
constexpr int TW_BLOCKS = 1024;      // wgrad: target number of blocks

// floats of a staged window row of `cells` cells of cw channels: the cells,
// then the kp - k*cw zeros the last window reads past them
__host__ __device__ inline int tf32_rowlen(int k, int cw, int kp, int cells) {
    return cells * cw + kp - k * cw;
}

// output rows a forward warp owns (of one m16 tile of cells): two, four
// with a single n8 tile (few accumulators; an A fragment then feeds more
// products), and a block's rows: the 16 warps tile 8 row groups x 2 m16
// tiles
__host__ __device__ constexpr int fwd_rows(int nt) { return nt == 1 ? 4 : 2; }
__host__ __device__ constexpr int fwd_block_rows(int rw) { return TF_FWD_THREADS / 32 / (TFZ / 16) * rw; }

// floats of a forward stage: the window, then the k taps' split fragments
// of the chunk's kp/8 k8 steps
__host__ __device__ inline int fwd_tf32_stage(int k, int cw, int kp, int nt, int rw) {
    return (fwd_block_rows(rw) + k - 1) * tf32_rowlen(k, cw, kp, TFZ + k - 1) +
           k * (kp / 8) * nt * FRAG;
}

// pitch (floats) of the wgrad's staged d tile: 8 or 24 mod 32, so that a B
// fragment's 32 lanes (t * pitch + g) hit distinct banks
__host__ __device__ constexpr int tw_dpitch(int nt) { return nt == 2 ? 24 : 8 * nt; }

// floats of a wgrad stage: the window, then the d tile
__host__ __device__ inline int wgrad_tf32_stage(int k, int cw, int kp, int nt) {
    return (TWY + k - 1) * tf32_rowlen(k, cw, kp, TWZ + k - 1) + TWY * TWZ * tw_dpitch(nt);
}

// The thread's index, read afresh where it is called: what a stage derives
// from it is recomputed at each stage, not held in registers across the
// product loops (the weight gradient's accumulators need them all).
__device__ __forceinline__ int fresh_tid() {
    int t;
    asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
    return t;
}

__device__ __forceinline__ void zero16(float* dst) {
    *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// The staging of an input window (ROWS rows x CELLS cells of one chunk of
// cw float32 channels, row pitch rowlen) by one thread: it owns one (cell,
// 4-channel unit) and stages it in every rstep-th row, so its z offset and
// shared-memory offset are computed once a block.
struct Tf32WindowStager {
    int r0, rstep, soff, c0, z;

    __device__ Tf32WindowStager(int tid, int nthr, int cells, int cw, int z0, int nz) {
        const int upc = cw / 4, upr = cells * upc, u = tid % upr;
        r0 = tid / upr;
        rstep = nthr / upr;
        soff = (u / upc) * cw + 4 * (u % upc);
        c0 = 4 * (u % upc);
        z = wrap_near(z0 + u / upc, nz);
    }

    // rows y0 .. y0 + rows - 1 (wrapped) of plane xp, channels ch*cw + ...
    // (zeros past cin)
    __device__ __forceinline__ void stage(float* s, const float* h, int xp, int y0, int rows,
                                          int rowlen, int ny, int nz, int cin, int c) const {
        if (r0 >= rstep) return;
        c += c0;
        for (int r = r0; r < rows; r += rstep) {
            float* dst = s + r * rowlen + soff;
            if (c < cin)
                cp_async16(dst, h + (((size_t)xp * ny + wrap_near(y0 + r, ny)) * nz + z) * cin + c);
            else
                zero16(dst);
        }
    }
};

// Zero the kp - k*cw floats past the cells of each window row (never
// written by a stage) of every buffer.
__device__ __forceinline__ void zero_tf32_tails(float* smem, int nbuf, int stage, int rows,
                                                int rowlen, int cells_floats, int tid, int nthr) {
    const int tail4 = (rowlen - cells_floats) / 4;
    for (int i = tid; i < nbuf * rows * tail4; i += nthr) {
        const int b = i / (rows * tail4), r = (i / tail4) % rows, q = i % tail4;
        zero16(smem + b * stage + r * rowlen + cells_floats + 4 * q);
    }
}

struct Tf32ConvParams {
    const float* h;     // (nx, ny, nz, cin), cin a multiple of 4
    const float* w;     // split B fragments (k, k, nch * kp/8, np/8, 32, 4)
    const float* bias;  // may be null
    int act;            // 0 identity, 1 tanh
    void* out;
    int out_bf16;
    int nx, ny, nz, cin, cout;
    int cw, nch, kp, np;
    int nbuf;           // stages in the ring
};

template <int K, int NT, int RW>
__global__ void __launch_bounds__(TF_FWD_THREADS, 1)
conv_fwd_tf32_kernel(const __grid_constant__ Tf32ConvParams p) {
    constexpr int R = K / 2, TFY = fwd_block_rows(RW), ROWS = TFY + K - 1, CELLS = TFZ + K - 1;
    constexpr int UNROLL = RW == 2 ? 2 : K;  // fully unrolled, RW = 2 spills (as tapconv_tf32.cu)
    extern __shared__ float4 smem_f4[];
    float* smem = reinterpret_cast<float*>(smem_f4);
    const int cw = p.cw, kp = p.kp, nks = kp / 8, nbuf = p.nbuf;
    const int rowlen = tf32_rowlen(K, cw, kp, CELLS), in = ROWS * rowlen;
    const int stage = fwd_tf32_stage(K, cw, kp, NT, RW);
    const int ntiles = p.np / 8, nblk = ntiles / NT;
    const int x = blockIdx.z / nblk, blk = blockIdx.z % nblk, n0 = blk * 8 * NT;
    const int y0 = blockIdx.y * TFY, z0 = blockIdx.x * TFZ;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    // warp: output rows wy0 .. wy0 + RW - 1, cells 16 * wm .. 16 * wm + 15
    const int wy0 = (warp / (TFZ / 16)) * RW, wm = warp % (TFZ / 16);
    const int nstage = p.nch * K;  // (chunk, dx)

    zero_tf32_tails(smem, nbuf, stage, ROWS, rowlen, CELLS * cw, tid, TF_FWD_THREADS);
    const Tf32WindowStager window(tid, TF_FWD_THREADS, CELLS, cw, z0 - R, p.nz);
    auto issue = [&](int s) {
        if (s < nstage) {
            const int ch = s / K, dx = s % K;
            float* s_in = smem + (s % nbuf) * stage;
            float* s_w = s_in + in;
            window.stage(s_in, p.h, wrap_near(x + dx - R, p.nx), y0 - R, ROWS, rowlen, p.ny, p.nz,
                         p.cin, ch * cw);
            // rows (dy, k8 step) of tap (dx, dy), chunk ch: this block's NT
            // fragments, contiguous in the packed weights
            const float* w = p.w + (((size_t)dx * K * p.nch + ch) * nks * ntiles + blk * NT) * FRAG;
            for (int u = tid; u < K * nks * NT * 32; u += TF_FWD_THREADS) {
                const int l = u % (NT * 32), row = u / (NT * 32);
                const int dy = row / nks, ks = row % nks;
                cp_async16(s_w + row * NT * FRAG + 4 * l,
                           w + ((size_t)dy * p.nch * nks + ks) * ntiles * FRAG + 4 * l);
            }
        }
        cp_async_commit();
    };

    // acc: the sum (float32 adds); part: a chain of at most TAPS_CHAINED
    // taps' products in the tensor cores
    float acc[RW][NT][4], part[RW][NT][4];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][t][e] = 0.0f;

    // ldmatrix row addresses: rows are cells (lanes 0-15: the k8 step's
    // elements 0-3, 16-31: 4-7)
    const int a_lane = wy0 * rowlen + (16 * wm + (lane & 15)) * cw + (lane >> 4) * 4;
    for (int s = 0; s < nbuf - 1; ++s) issue(s);
    for (int s = 0; s < nstage; ++s) {
        issue(s + nbuf - 1);
        ring_wait(nbuf);
        const float* s_in = smem + (s % nbuf) * stage + a_lane;
        const float* s_w = smem + (s % nbuf) * stage + in + 4 * lane;
#pragma unroll 1
        for (int ks = 0; ks < nks; ++ks) {
            // tap dy feeds output row ro from window row dy + ro: the warp
            // holds its RW current window rows split, one new row a tap
            const float* arow = s_in + ks * 8;
            const float* brow = s_w + ks * NT * FRAG;
            uint32_t big[RW][4], small[RW][4];
#pragma unroll
            for (int r = 0; r + 1 < RW; ++r) load_split(arow + r * rowlen, big[r], small[r]);
#pragma unroll UNROLL
            for (int dy = 0; dy < K; ++dy) {
                load_split(arow + (dy + RW - 1) * rowlen, big[RW - 1], small[RW - 1]);
                const float* b = brow + dy * nks * NT * FRAG;
                if (dy % TAPS_CHAINED == 0)
                    row_products<NT, RW, true>(part, big, small, b);
                else
                    row_products<NT, RW, false>(part, big, small, b);
                if ((dy + 1) % TAPS_CHAINED == 0 || dy == K - 1) {
#pragma unroll
                    for (int ro = 0; ro < RW; ++ro)
#pragma unroll
                        for (int t = 0; t < NT; ++t)
#pragma unroll
                            for (int e = 0; e < 4; ++e) acc[ro][t][e] += part[ro][t][e];
                }
#pragma unroll
                for (int r = 0; r + 1 < RW; ++r)
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        big[r][i] = big[r + 1][i];
                        small[r][i] = small[r + 1][i];
                    }
            }
        }
        __syncthreads();  // the buffer is refilled nbuf - 1 stages on
    }

    store_rows(acc, p, x, y0 + wy0, z0 + 16 * wm, n0, lane);
}

struct Tf32WgradParams {
    const float* h;  // (nx, ny, nz, cin), cin a multiple of 4
    const float* d;  // (nx, ny, nz, cout), cout a multiple of 4
    float* partial;  // (nchunk, k, k, nch * kp, np)
    int nx, ny, nz, cin, cout;
    int cw, nch, kp, np;
    int mc;          // m16 tiles of kp a block (dividing the warps)
    int xb;          // x-planes a cell chunk
    int nbuf;        // stages in the ring
};

// m16 tiles of kp a wgrad block takes: warp w owns tile w % mc and every
// (TW_WARPS / mc)-th dy from w / mc, so mc divides the warps; the largest
// such mc whose items fit the warps' TW_IPW each
__host__ __device__ inline int wgrad_tf32_mc(int k, int kp) {
    int mc = TW_WARPS;
    while (mc > 1 && (mc > kp / 16 || mc * k > TW_WARPS * TW_IPW)) mc /= 2;
    return mc;
}

inline void wgrad_tf32_chunks(int nx, int ny, int nz, int k, int nch, int nblk, int kp, int* xb,
                              int* nchunk) {
    const int mc = wgrad_tf32_mc(k, kp), groups = (kp / 16 + mc - 1) / mc;
    const int yz = ((ny + TWY - 1) / TWY) * ((nz + TWZ - 1) / TWZ);
    const int per_group = yz * k * nch * nblk * groups;
    int g = (TW_BLOCKS + per_group - 1) / per_group;
    g = g < 1 ? 1 : (g > nx ? nx : g);
    *xb = (nx + g - 1) / g;
    *nchunk = ((nx + *xb - 1) / *xb) * yz;
}

template <int K, int NT>
__global__ void __launch_bounds__(TW_THREADS, TW_SM_BLOCKS)
wgrad_tf32_kernel(const __grid_constant__ Tf32WgradParams p) {
    constexpr int R = K / 2, ROWS = TWY + K - 1, CELLS = TWZ + K - 1, DP = tw_dpitch(NT);
    // the k8 steps of a cell row one at a time with three n8 tiles (two
    // steps' B fragments at once would spill), else both at once
    constexpr int KS_UNROLL = NT == 3 ? 1 : TWZ / 8;
    extern __shared__ float4 smem_f4[];
    float* smem = reinterpret_cast<float*>(smem_f4);
    const int cw = p.cw, kp = p.kp, nbuf = p.nbuf;
    const int rowlen = tf32_rowlen(K, cw, kp, CELLS), in = ROWS * rowlen;
    const int stage = wgrad_tf32_stage(K, cw, kp, NT);
    const int nblk = p.np / (8 * NT), ngroups = (kp / 16 + p.mc - 1) / p.mc;
    const int grp = blockIdx.y % ngroups, blk = (blockIdx.y / ngroups) % nblk;
    const int ch = blockIdx.y / (ngroups * nblk), n0 = blk * 8 * NT, dx = blockIdx.z;
    const int mt0 = grp * p.mc, mc = min(p.mc, kp / 16 - mt0);
    const int ytiles = (p.ny + TWY - 1) / TWY, ztiles = (p.nz + TWZ - 1) / TWZ;
    const int chunk = blockIdx.x;
    const int zt = chunk % ztiles, yt = (chunk / ztiles) % ytiles, xg = chunk / (ztiles * ytiles);
    const int y0 = yt * TWY, z0 = zt * TWZ;
    const int x0 = xg * p.xb, x1 = min(p.nx, x0 + p.xb);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int nstage = x1 - x0;

    zero_tf32_tails(smem, nbuf, stage, ROWS, rowlen, CELLS * cw, tid, TW_THREADS);
    auto issue = [&](int s) {
        if (s < nstage) {
            const int x = x0 + s, ftid = fresh_tid();
            float* s_in = smem + (s % nbuf) * stage;
            float* s_d = s_in + in;
            const Tf32WindowStager window(ftid, TW_THREADS, CELLS, cw, z0 - R, p.nz);
            window.stage(s_in, p.h, wrap_near(x + dx - R, p.nx), y0 - R, ROWS, rowlen, p.ny, p.nz,
                         p.cin, ch * cw);
            // the d tile: 8*NT channels a cell, 2*NT 16-byte units
            for (int v = ftid; v < TWY * TWZ * 2 * NT; v += TW_THREADS) {
                const int q = v % (2 * NT), u = v / (2 * NT);
                const int y = y0 + u / TWZ, z = z0 + u % TWZ, c = n0 + 4 * q;
                float* dst = s_d + u * DP + 4 * q;
                if (y < p.ny && z < p.nz && c < p.cout)  // cells past the box add 0
                    cp_async16(dst, p.d + (((size_t)x * p.ny + y) * p.nz + z) * p.cout + c);
                else
                    zero16(dst);
            }
        }
        cp_async_commit();
    };

    float acc[TW_IPW][NT][4];
#pragma unroll
    for (int q = 0; q < TW_IPW; ++q)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[q][n][e] = 0.0f;

    // the warp's items: m16 tile mt0 + mtl and dy = dy0 + q * dstep for q <
    // nq, window rows dy * rowlen + 16 * tile in the staged plane
    const int dstep = TW_WARPS / p.mc, mtl = warp % p.mc, dy0 = warp / p.mc;
    const int nq = mtl < mc && dy0 < K ? (K - dy0 + dstep - 1) / dstep : 0;
    const int a_item = dy0 * rowlen + (mt0 + mtl) * 16, a_qstep = dstep * rowlen;
    // fragment element offsets: A (rows (dz, c) of the window, columns
    // cells) at t*cw + g, B (rows cells, columns d's channels) at t*DP + g
    const int a_lane = t * cw + g + a_item, b_lane = t * DP + g;
    for (int s = 0; s < nbuf - 1; ++s) issue(s);
    for (int s = 0; s < nstage; ++s) {
        issue(s + nbuf - 1);
        ring_wait(nbuf);
        const float* s_in = smem + (s % nbuf) * stage + a_lane;
        const float* s_d = smem + (s % nbuf) * stage + in + b_lane;
#pragma unroll 1
        for (int ly = 0; ly < TWY; ++ly) {
#pragma unroll KS_UNROLL
            for (int ks = 0; ks < TWZ / 8; ++ks) {
                // the k8 step's B fragments, split once for all the items
                uint32_t bb[NT][2], bs[NT][2];
                const float* brow = s_d + (ly * TWZ + 8 * ks) * DP;
#pragma unroll
                for (int n = 0; n < NT; ++n)
#pragma unroll
                    for (int i = 0; i < 2; ++i) {
                        const float v = brow[i * 4 * DP + 8 * n];
                        bb[n][i] = tf32_rna(v);
                        bs[n][i] = tf32_rna(v - __uint_as_float(bb[n][i]));
                    }
                const float* arow = s_in + ly * rowlen + 8 * ks * cw;
#pragma unroll
                for (int q = 0; q < TW_IPW; ++q) {
                    if (q >= nq) break;
                    const float* a = arow + q * a_qstep;
                    const uint32_t raw[4] = {__float_as_uint(a[0]), __float_as_uint(a[8]),
                                             __float_as_uint(a[4 * cw]),
                                             __float_as_uint(a[4 * cw + 8])};
                    uint32_t ab[4], as[4];
                    split_tf32(raw, ab, as);
                    // one chain: the step's three products
                    float part[NT][4];
#pragma unroll
                    for (int n = 0; n < NT; ++n) {
                        mma_tf32_first(part[n], as, bb[n][0], bb[n][1]);
                        mma_tf32(part[n], ab, bs[n][0], bs[n][1]);
                        mma_tf32(part[n], ab, bb[n][0], bb[n][1]);
#pragma unroll
                        for (int e = 0; e < 4; ++e) acc[q][n][e] += part[n][e];
                    }
                }
            }
        }
        __syncthreads();  // the buffer is refilled nbuf - 1 stages on
    }

    const size_t nw = (size_t)K * K * p.nch * kp * p.np;
    float* out = p.partial + (size_t)chunk * nw;
#pragma unroll
    for (int q = 0; q < TW_IPW; ++q) {
        if (q >= nq) break;
        const int dy = dy0 + q * dstep, j = (mt0 + mtl) * 16 + g;
        const size_t base = (((size_t)dx * K + dy) * p.nch + ch) * kp;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const int o = n0 + 8 * n + 2 * t;
            *reinterpret_cast<float2*>(out + (base + j) * p.np + o) =
                make_float2(acc[q][n][0], acc[q][n][1]);
            *reinterpret_cast<float2*>(out + (base + j + 8) * p.np + o) =
                make_float2(acc[q][n][2], acc[q][n][3]);
        }
    }
}

// The checks both float32 entry points make of the chunk/tile geometry the
// wrapper computed (`ops/conv_kernels.py` `tf32_geometry`): kp = k*cw
// rounded up to `step` (8 forward, 16 wgrad).
bool tf32_geometry_ok(int cin, int cout, int k, int cw, int nch, int kp, int nt, int np,
                      int step) {
    return cw >= 4 && cw % 4 == 0 && cw <= 28 && nch >= 1 &&
           nch * cw >= cin && (nch - 1) * cw < cin && kp == (k * cw + step - 1) / step * step &&
           nt >= 1 && nt <= MAXNT && np % (8 * nt) == 0 && np >= cout && np - 8 * nt < cout;
}

// a float32 field the kernels stage 16 bytes a copy
inline bool stageable_f32(const void* p, int c) { return c % 4 == 0 && ((uintptr_t)p & 15) == 0; }

// nbuf stages of `stage` floats, three where `blocks` blocks of them fit an
// SM, else two; 0 where two do not fit
inline size_t tf32_ring(int stage, int blocks, int* nbuf) {
    const size_t bytes = sizeof(float) * (size_t)stage;
    *nbuf = 3 * bytes * blocks <= SM_SMEM ? 3 : 2;
    return 2 * bytes * blocks <= SM_SMEM ? *nbuf * bytes : 0;
}

template <int K, int NT, int RW>
cudaError_t launch_fwd_tf32_rows(Tf32ConvParams p, cudaStream_t stream) {
    const size_t smem = tf32_ring(fwd_tf32_stage(K, p.cw, p.kp, NT, RW), 1, &p.nbuf);
    if (smem == 0) return cudaErrorInvalidValue;
    const cudaError_t e = set_smem((const void*)conv_fwd_tf32_kernel<K, NT, RW>, smem);
    if (e != cudaSuccess) return e;
    const int ty = fwd_block_rows(RW);
    const dim3 grid((p.nz + TFZ - 1) / TFZ, (p.ny + ty - 1) / ty, p.nx * (p.np / (8 * NT)));
    conv_fwd_tf32_kernel<K, NT, RW><<<grid, TF_FWD_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <int K, int NT>
cudaError_t launch_fwd_tf32(Tf32ConvParams p, cudaStream_t stream) {
    return launch_fwd_tf32_rows<K, NT, fwd_rows(NT)>(p, stream);
}

template <int K, int NT>
cudaError_t launch_wgrad_tf32(Tf32WgradParams p, int nchunk, cudaStream_t stream) {
    const size_t smem = tf32_ring(wgrad_tf32_stage(K, p.cw, p.kp, NT), TW_SM_BLOCKS, &p.nbuf);
    if (smem == 0) return cudaErrorInvalidValue;
    const cudaError_t e = set_smem((const void*)wgrad_tf32_kernel<K, NT>, smem);
    if (e != cudaSuccess) return e;
    const int groups = (p.kp / 16 + p.mc - 1) / p.mc;
    const dim3 grid(nchunk, p.nch * (p.np / (8 * NT)) * groups, K);
    wgrad_tf32_kernel<K, NT><<<grid, TW_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

// (k, nt) -> the kernel instantiation
#define INS_TF32_NT(LAUNCH, K, ...)                                                     \
    switch (nt) {                                                                       \
        case 1: return LAUNCH<K, 1>(__VA_ARGS__);                                       \
        case 2: return LAUNCH<K, 2>(__VA_ARGS__);                                       \
        case 3: return LAUNCH<K, 3>(__VA_ARGS__);                                       \
        default: return cudaErrorInvalidValue;                                          \
    }
#define INS_TF32_DISPATCH(LAUNCH, ...)                                                  \
    switch (k) {                                                                        \
        case 3: INS_TF32_NT(LAUNCH, 3, __VA_ARGS__)                                     \
        case 5: INS_TF32_NT(LAUNCH, 5, __VA_ARGS__)                                     \
        case 7: INS_TF32_NT(LAUNCH, 7, __VA_ARGS__)                                     \
        default: return cudaErrorInvalidValue;                                          \
    }

cudaError_t fwd_tf32(int k, int nt, const Tf32ConvParams& p, cudaStream_t s) {
    INS_TF32_DISPATCH(launch_fwd_tf32, p, s)
}

cudaError_t wgrad_tf32(int k, int nt, const Tf32WgradParams& p, int nchunk, cudaStream_t s) {
    INS_TF32_DISPATCH(launch_wgrad_tf32, p, nchunk, s)
}

#undef INS_TF32_DISPATCH
#undef INS_TF32_NT

}  // namespace

// float32 forward on the tensor cores in 3xTF32: h (nx, ny, nz, cin)
// float32 (cin a multiple of 4: the wrapper pads it with zero channels),
// wp the split B fragments (k, k, nch * kp/8, np/8, 32, 4) float32, out
// (nx, ny, nz, cout) in float32 or bf16; (cw, nch, kp, nt, np) as
// `ops/conv_kernels.py` `tf32_geometry` computes them.
extern "C" int ins_conv_fwd_tf32(const void* h, const void* wp, const float* bias, int act,
                                 void* out, int out_bf16, int nx, int ny, int nz, int cin,
                                 int cout, int k, int cw, int nch, int kp, int nt, int np,
                                 void* stream) {
    if (!tf32_geometry_ok(cin, cout, k, cw, nch, kp, nt, np, 8) ||
        !stageable_f32(h, cin) || ((uintptr_t)wp & 15))
        return (int)cudaErrorInvalidValue;
    const Tf32ConvParams p{static_cast<const float*>(h), static_cast<const float*>(wp), bias, act,
                           out, out_bf16, nx, ny, nz, cin, cout, cw, nch, kp, np};
    return (int)fwd_tf32(k, nt, p, (cudaStream_t)stream);
}

// Number of cell chunks (rows of the partial-sum buffer) of a float32 wgrad call.
extern "C" int ins_conv_wgrad_tf32_chunks(int nx, int ny, int nz, int k, int nch, int nblk,
                                          int kp) {
    int xb, nchunk;
    wgrad_tf32_chunks(nx, ny, nz, k, nch, nblk, kp, &xb, &nchunk);
    return nchunk;
}

// float32 weight gradient on the tensor cores in 3xTF32: h (nx, ny, nz,
// cin) and d (nx, ny, nz, cout) float32 (cin and cout multiples of 4: the
// wrapper pads); dwp the packed float32 gradient (k, k, nch * kp, np),
// partial (nchunk, k, k, nch * kp, np) float32 scratch.
extern "C" int ins_conv_wgrad_tf32(const void* h, const void* d, float* partial, float* dwp,
                                   int nx, int ny, int nz, int cin, int cout, int k, int cw,
                                   int nch, int kp, int nt, int np, void* stream) {
    if (!tf32_geometry_ok(cin, cout, k, cw, nch, kp, nt, np, 16) || !stageable_f32(h, cin) ||
        !stageable_f32(d, cout))
        return (int)cudaErrorInvalidValue;
    int xb, nchunk;
    wgrad_tf32_chunks(nx, ny, nz, k, nch, np / (8 * nt), kp, &xb, &nchunk);
    const Tf32WgradParams p{static_cast<const float*>(h), static_cast<const float*>(d), partial,
                            nx, ny, nz, cin, cout, cw, nch, kp, np, wgrad_tf32_mc(k, kp), xb};
    const cudaStream_t s = (cudaStream_t)stream;
    const cudaError_t e = wgrad_tf32(k, nt, p, nchunk, s);
    if (e != cudaSuccess) return (int)e;
    const size_t nw = (size_t)k * k * nch * kp * np;
    reduce_partials_kernel<<<(unsigned)((nw + 255) / 256), 256, 0, s>>>(partial, dwp, nchunk, nw);
    return (int)cudaGetLastError();
}
