// The tap-matmul and pack-tile convolutions of the CNN closure's z-folded
// layer on float32 operands, on the tensor cores in 3xTF32
// (`mma.sync.m16n8k8`, TF32 operands, float32 sums), forward with bias and
// tanh/identity fused in:
//
//   out[x, y, z, o] = act(b[o] + sum_{dx<kx, dy<ky} sum_c g[x+dx, y+dy, z, c]
//                                                         * w2[dx, dy, c, o])
//
// g is (nxp, nyp, nz, kc) float32, channels last, the z taps already
// folded into kc (a multiple of 4: the wrapper pads with zero channels)
// and x, y padded by kx-1, ky-1; out is (nxp-kx+1, nyp-ky+1, nz, cout) in
// float32 or bf16.  The layer's input gradient is the same function on the
// zero-padded cotangent with flipped, transposed taps.  The bf16 route is
// tapconv_mma.cu, whose two kernels these follow: the output-first tap
// kernel (`tapconv_3d`, and `packconv_3d` where the taps do not all pack
// into one tile) and the weight-first pack kernel (`packconv_3d` where
// they do, `pack_tf32_takes`: the 24 -> 3 layer).
//
// Replaces: for float32 operands, `_tapconv_kernel`
// (ins_tpu/ops/convkernels.py:78, wrapper `tapconv_3d` :130) and
// `_packconv_kernel` (:387, wrapper `packconv_3d` :471).
//
// Accuracy: each operand is split into a TF32 big part and a TF32 small
// part, big = rna(x) and small = rna(x - big) (round to nearest, ties away,
// 10-bit mantissa), and a product is small*big + big*small + big*big, the
// small*small term dropped (CUTLASS's "3xTF32"): about 2^-21 relative a
// product against 2^-11 for one TF32 pass, so the kernel stays in the
// float32 class.  The tensor cores' float32 sums truncate, so a chain
// holds at most CHAIN mma (two taps' three products) before it is added to
// a float32 accumulator.
//
// What bounds it on an H100: the 24 -> 24 layer at 128^3 is 302 GFLOP, so
// 906 GFLOP of TF32 mma (1.83 ms at the 495 TFLOP/s dense TF32 peak)
// against 1.2 GB of compulsory traffic; the input gradient (24 -> 120) 963
// GFLOP (1.95 ms).  mma.sync reaches a fraction of that peak, and the
// window and weights are restaged from L2 for every (dx, chunk) stage
// (~13 GB at 24 -> 24 by the shapes' count), so the tensor cores' issue
// rate and L2 hold it; two blocks an SM (16 warps) hide the latencies, so
// registers (128 a thread) bound the design.
//
// The pack kernel at 24 -> 3 (75 packed columns, 80 with padding) is
// 37.7 GFLOP, 121 GFLOP of TF32 mma with the padding (0.24 ms at the
// peak), against 1.07 GB of g read once (0.32 ms): there the bytes bound
// it, and a block reads its 16 input rows for 12 output rows (ky = 5), the
// 4 overlapping rows mostly from L2.
//
// Design of the tap kernel: tapconv_mma.cu's output-first `tap_mma_kernel` with float32
// stages: an implicit GEMM with M = the cells of an output row, K = kc and
// N = cout in blocks of 8*NT columns (NT <= 3 n8 tiles: a warp's
// accumulators and its tensor-core chains, 16*NT registers, then fit two
// blocks an SM without spilling; the input gradient's 120 columns are
// five blocks).  A block of 8 warps owns one x-plane's 8 (y) x 32 (z)
// cells and one block of output channels, a warp 2 rows of one m16 tile
// of cells; the block walks stages (dx, 16-channel chunk) through a ring
// of 16-byte cp.async copies: the input plane's (8 + ky - 1) x 32-cell
// window (pitch 20 floats: 5 16-byte units, so an ldmatrix's 8 rows hit
// distinct banks) and that dx's ky weight tiles.  The A fragment of a k8
// step is one `ldmatrix.x4` (a float32 is two b16 values of one row, so
// the b16 layout hands each thread the TF32 fragment's element) split in
// registers; the B fragments come split and in fragment order from the
// host (`pack_tap_weights_tf32`: per (dx, dy, k8 step, n8 tile) 32 lanes
// x (big b0, big b1, small b0, small b1)), one 16-byte shared load a
// lane.  Tap dy feeds output row ro from window row dy + ro: a warp walks
// the taps (unrolled by two: fully unrolled, the scheduler's look-ahead
// spilled registers) with its 2 current window rows split in registers
// (one new row a tap, so each row is loaded and split once), and each B
// fragment feeds both rows as it is loaded, so an A fragment feeds up to
// 3*2*NT mma and one B fragment is live.
//
// Design of the pack kernel: tapconv_mma.cu's weight-first
// `pack_mma_kernel` with float32 stages: each input plane's products with
// every tap once, P[(y, z), (dx, dy, o)] = sum_c g[p, y, z, c] ws[c, (dx,
// dy, o)], then the shifted tap sums in float32 and in the order (dx, dy):
// out[x, y] = sum_{dx, dy} P[x + dx][(y + dy, z), (dx, dy, o)].  A block
// of 16 warps owns 16 input rows (16 - ky + 1 output rows) x 16 cells and
// walks a run of x-planes (`pack_geometry.cuh`); two warps share a pair of
// input rows, each forming half the packed columns' products, so that the
// products and chains of a warp fit 128 registers and 16 warps share an
// SM (8 warps of all the columns took 253 registers and the same shared
// memory, one block of 8 warps an SM, and ran slower).  g arrives by
// 16-byte cp.async in stages of (input plane, 32 channels) through a ring
// (pitch 36 floats: 9 16-byte units, so an ldmatrix's 8 rows hit distinct
// banks), each stage with the chunk's split B fragments of every tap
// (`pack_all_taps_tf32`: per k8 step and n8 tile 32 lanes x (big b0, big
// b1, small b0, small b1); 20 KB a stage at 24 -> 3, from L2), in a ring
// of as many stages as fit (two at 24 -> 3), one barrier a stage (each
// thread's copies of g are the same cells every stage: their offsets are
// formed once a block).  Per k8 step each of a warp's two rows has its A
// fragment from one `ldmatrix.x4` split in registers, and each of its n8
// tiles' B fragment is one 16-byte shared load feeding both rows' three
// products (small*big, big*small, big*big); two k8 steps are one
// tensor-core chain (6 mma) added to the products' float32 sums.  When a
// plane's last stage is in, the block writes its products to shared
// memory (float32) and adds their column groups into a ring of kx
// output-plane accumulators in shared memory; an output plane leaves when
// its last tap is in.  The products never go through device memory.  At
// 24 -> 3 (kc 120, nt 10) the block takes 207 KB (two 56 KB stages, 84 KB
// of products, 11 KB of accumulators): one block an SM.  Stages of 16
// channels (four in the ring) ran 8 % slower, the tap sums deferred past
// the next stage's barrier no faster (PERF.md).

#include <cstdint>
#include <utility>

#include "convio.cuh"         // bf16, CHAIN, cp.async, ring_wait, set_smem
#include "pack_geometry.cuh"  // PF_*, pack_tf32_smem, pack_tf32_takes, pack_tf32_nbuf
#include "tf32.cuh"           // FRAG, TAPS_CHAINED, load_split, row_products

namespace {

constexpr int TF_THREADS = 256;  // 8 warps
constexpr int TTY = 8;           // output rows (y) a block
constexpr int TTZ = 32;          // output cells (z) a row
constexpr int TRW = 2;           // output rows a warp (one m16 tile of cells)
static_assert(TTY * TTZ == TF_THREADS / 32 * TRW * 16, "the warps tile the block's cells");
constexpr int TMAXNT = 3;        // n8 tiles of output channels a block, at most
constexpr int FCH = 16;          // channels a stage (two k8 steps)
constexpr int FKS = FCH / 8;     // k8 steps a stage
constexpr int FCHP = FCH + 4;    // their staged pitch in floats: 5 16-byte units (odd)
constexpr int TF_SM_BLOCKS = 2;  // blocks an SM the launch bounds ask for (128 registers)

// floats of one stage: the window, then the ky taps' fragments of its two k8 steps
template <int KY, int NT>
__host__ __device__ constexpr int tf32_stage_floats() {
    return (TTY + KY - 1) * TTZ * FCHP + KY * FKS * NT * FRAG;
}

// Stage channels c .. c+3 of g's cell (plane, y, z) into 16 bytes of shared
// memory: one cp.async, or zeros past the field (rows y >= nyp, cells z >=
// nz, channels c >= kc).
__device__ __forceinline__ void stage_g4(float* dst, const float* g, int plane, int y, int z,
                                         int c, int nyp, int nz, int kc) {
    if (y < nyp && z < nz && c < kc)
        cp_async16(dst, g + (((size_t)plane * nyp + y) * nz + z) * kc + c);
    else
        *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ float epilogue(float v, const float* bias, int co, int act) {
    if (bias) v += __ldg(bias + co);
    return act == 1 ? tanhf(v) : v;
}

// (lo, hi) rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

struct TapTf32Params {
    const float* g;     // (nxp, nyp, nz, kc)
    const float* w;     // packed (kx, ky, kp/8, np/8, 32, 4): split B fragments
    const float* bias;  // may be null
    int act;            // 0 identity, 1 tanh
    void* out;
    int out_bf16;
    int vec_out;        // cout % 8 == 0 and out 16-byte aligned: 16-byte stores
    int nxp, nyp, nz, kc, kx, cout;
    int kp, np;         // kc rounded up to 8; output channels padded to nblk * 8*NT
    int nbuf;           // stages in the ring
};

template <int KY, int NT>
__global__ void __launch_bounds__(TF_THREADS, TF_SM_BLOCKS)
tap_tf32_kernel(const __grid_constant__ TapTf32Params p) {
    constexpr int ROWS = TTY + KY - 1;
    constexpr int IN = ROWS * TTZ * FCHP;
    constexpr int STAGE = tf32_stage_floats<KY, NT>();
    extern __shared__ float4 smem_f4[];
    float* smem = reinterpret_cast<float*>(smem_f4);
    const int nbuf = p.nbuf;
    const int ny = p.nyp - KY + 1;
    const int nblk = p.np / (8 * NT), ntiles = p.np / 8, nks = p.kp / 8;
    const int x = blockIdx.z / nblk, blk = blockIdx.z % nblk, n0 = blk * 8 * NT;
    const int y0 = blockIdx.y * TTY, z0 = blockIdx.x * TTZ;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    // warp: output rows wy0 .. wy0 + TRW - 1, cells 16 * wm .. 16 * wm + 15
    const int wy0 = (warp / (TTZ / 16)) * TRW, wm = warp % (TTZ / 16);
    const int nchunk = (p.kp + FCH - 1) / FCH;
    const int nstage = p.kx * nchunk;  // (dx, chunk)

    auto issue = [&](int s) {
        if (s < nstage) {
            const int dx = s / nchunk, c0 = (s % nchunk) * FCH;
            float* s_in = smem + (s % nbuf) * STAGE;
            float* s_w = s_in + IN;
            for (int u = tid; u < ROWS * TTZ * (FCH / 4); u += TF_THREADS) {
                const int q = u % (FCH / 4), cell = (u / (FCH / 4)) % TTZ;
                const int r = u / (FCH / 4 * TTZ);
                stage_g4(s_in + (r * TTZ + cell) * FCHP + 4 * q, p.g, x + dx, y0 + r, z0 + cell,
                         c0 + 4 * q, p.nyp, p.nz, p.kc);
            }
            // k8 steps (dy, j) of tap (dx, dy): this block's NT fragments,
            // contiguous in the packed weights
            const int ks0 = c0 / 8;
            for (int u = tid; u < KY * FKS * NT * 32; u += TF_THREADS) {
                const int l = u % (NT * 32), j = (u / (NT * 32)) % FKS, dy = u / (NT * 32 * FKS);
                if (ks0 + j < nks)
                    cp_async16(s_w + (dy * FKS + j) * NT * FRAG + 4 * l,
                               p.w + ((((size_t)dx * KY + dy) * nks + ks0 + j) * ntiles +
                                      blk * NT) * FRAG + 4 * l);
            }
        }
        cp_async_commit();
    };

    // acc: the sum (float32 adds); part: a chain of at most TAPS_CHAINED
    // taps' products in the tensor cores
    float acc[TRW][NT][4], part[TRW][NT][4];
#pragma unroll
    for (int r = 0; r < TRW; ++r)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][t][e] = 0.0f;

    // ldmatrix row addresses: rows are cells (lanes 0-15: channels 0-3,
    // 16-31: channels 4-7 of the k8 step)
    const int a_lane = (wy0 * TTZ + 16 * wm + (lane & 15)) * FCHP + (lane >> 4) * 4;
    for (int s = 0; s < nbuf - 1; ++s) issue(s);
    for (int s = 0; s < nstage; ++s) {
        issue(s + nbuf - 1);
        ring_wait(nbuf);
        const int c0 = (s % nchunk) * FCH;
        const int nsteps = min(FCH, p.kp - c0) / 8;
        const float* s_in = smem + (s % nbuf) * STAGE + a_lane;
        const float* s_w = smem + (s % nbuf) * STAGE + IN + 4 * lane;
#pragma unroll 1
        for (int ks = 0; ks < nsteps; ++ks) {
            const float* arow = s_in + ks * 8;
            const float* brow = s_w + ks * NT * FRAG;
            uint32_t big[TRW][4], small[TRW][4];  // window rows dy and dy + 1
            load_split(arow, big[0], small[0]);
#pragma unroll 2
            for (int dy = 0; dy < KY; ++dy) {
                load_split(arow + (dy + 1) * TTZ * FCHP, big[1], small[1]);
                const float* b = brow + dy * FKS * NT * FRAG;
                if (dy % TAPS_CHAINED == 0)
                    row_products<NT, TRW, true>(part, big, small, b);
                else
                    row_products<NT, TRW, false>(part, big, small, b);
                if ((dy + 1) % TAPS_CHAINED == 0 || dy == KY - 1) {
#pragma unroll
                    for (int ro = 0; ro < TRW; ++ro)
#pragma unroll
                        for (int t = 0; t < NT; ++t)
#pragma unroll
                            for (int e = 0; e < 4; ++e) acc[ro][t][e] += part[ro][t][e];
                }
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    big[0][i] = big[1][i];
                    small[0][i] = small[1][i];
                }
            }
        }
        __syncthreads();  // the buffer is refilled nbuf - 1 stages on
    }

    if (p.vec_out) {
        // the warp's 2 x 16 cells x 8*NT channels through shared memory (the
        // ring is free), then out as 16-byte units of 8 channels
        constexpr int EP = 8 * NT + 4;
        float* so = smem + warp * (TRW * 16 * EP);
#pragma unroll
        for (int r = 0; r < TRW; ++r)
#pragma unroll
            for (int t = 0; t < NT; ++t)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int cell = (lane >> 2) + 8 * (e >> 1);
                    const int col = 8 * t + 2 * (lane & 3) + (e & 1);
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

struct PackTf32Params {
    const float* g;     // (nxp, nyp, nz, kc)
    const float* w;     // (kp/8, nt, 32, 4): every tap's split B fragments, column
                        // (dx * ky + dy) * cout + o; zero past kc rows and kx * ky *
                        // cout columns
    const float* bias;  // may be null
    int act;
    void* out;
    int out_bf16;
    int nxp, nyp, nz, kc, kx, ky, cout, kp, nt;
    int xb;             // output planes a block walks
    int nbuf;           // stages in the ring
};

template <int NTW>
__global__ void __launch_bounds__(PF_THREADS, 1)
pack_tf32_kernel(const __grid_constant__ PackTf32Params p) {
    constexpr int NTP = PF_COLG * NTW;  // n8 tiles staged and formed (p.nt and a zero pad)
    constexpr int PP = 8 * NTP + 4;     // the products' pitch
    constexpr int IN = PF_ROWS * PF_TZ * PF_CHP;
    constexpr int STAGE = pack_tf32_stage_floats(NTP);
    // g's 16-byte copies a thread a stage
    constexpr int COPIES = PF_ROWS * PF_TZ * (PF_CH / 4) / PF_THREADS;
    static_assert(COPIES * PF_THREADS == PF_ROWS * PF_TZ * (PF_CH / 4), "whole copies");
    extern __shared__ float4 smem_f4[];
    const int nbuf = p.nbuf, kx = p.kx, ky = p.ky, cout = p.cout, nt = p.nt;
    // nbuf staged (plane, chunk)s: the window, then the chunk's fragments
    float* s_ring = reinterpret_cast<float*>(smem_f4);
    float* s_p = s_ring + nbuf * STAGE;                  // (PF_ROWS * PF_TZ, PP) products
    float* s_acc = s_p + PF_ROWS * PF_TZ * PP;           // (kx, ty * PF_TZ * cout) accumulators
    const int ty = PF_ROWS - ky + 1;                     // output rows a block
    const int nx = p.nxp - kx + 1, ny = p.nyp - ky + 1;
    const int z0 = blockIdx.x * PF_TZ, y0 = blockIdx.y * ty;
    const int x0 = blockIdx.z * p.xb, x1 = min(nx, x0 + p.xb);
    const int nchunk = (p.kp + PF_CH - 1) / PF_CH;
    const int nstage = (x1 - x0 + kx - 1) * nchunk;  // (input plane, chunk)
    const int nacc = ty * PF_TZ * cout;              // an output plane's accumulators
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    // warp: input rows 2 rp and 2 rp + 1, n8 tiles NTW cg ..
    const int rp = warp % (PF_ROWS / 2), cg = warp / (PF_ROWS / 2);

    for (int i = tid; i < kx * nacc; i += PF_THREADS) s_acc[i] = 0.0f;
    // the pad tiles' fragments, zero in every buffer (no copy writes them)
    for (int i = tid; i < nbuf * 2 * (NTP - nt) * PF_FRAG; i += PF_THREADS) {
        const int f = i % ((NTP - nt) * PF_FRAG), j = i / ((NTP - nt) * PF_FRAG);
        s_ring[(j / 2) * STAGE + IN + ((j % 2) * NTP + nt) * PF_FRAG + f] = 0.0f;
    }
    // this thread's copies of g: the same cells and channel quad each stage
    int dst[COPIES], quad[COPIES];
    size_t src[COPIES];
    bool inside[COPIES];
#pragma unroll
    for (int k = 0; k < COPIES; ++k) {
        const int u = tid + k * PF_THREADS;
        const int q = u % (PF_CH / 4), cell = (u / (PF_CH / 4)) % PF_TZ;
        const int r = u / (PF_CH / 4 * PF_TZ);
        dst[k] = (r * PF_TZ + cell) * PF_CHP + 4 * q;
        quad[k] = 4 * q;
        src[k] = ((size_t)(y0 + r) * p.nz + z0 + cell) * p.kc + 4 * q;
        inside[k] = y0 + r < p.nyp && z0 + cell < p.nz;
    }
    const size_t plane_floats = (size_t)p.nyp * p.nz * p.kc;
    auto issue = [&](int s) {
        if (s < nstage) {
            const int plane = x0 + s / nchunk, c0 = (s % nchunk) * PF_CH;
            float* s_in = s_ring + (s % nbuf) * STAGE;
            const float* g = p.g + plane * plane_floats + c0;
#pragma unroll
            for (int k = 0; k < COPIES; ++k) {
                if (inside[k] && c0 + quad[k] < p.kc)
                    cp_async16(s_in + dst[k], g + src[k]);
                else
                    *reinterpret_cast<float4*>(s_in + dst[k]) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            }
            // the chunk's k8 steps of every tap's fragments (nt tiles a step)
            const int nks = min(PF_CH, p.kp - c0) / 8;
            for (int j = 0; j < nks; ++j) {
                const float* w = p.w + (size_t)(c0 / 8 + j) * nt * PF_FRAG;
                for (int u = tid; u < nt * PF_FRAG / 4; u += PF_THREADS)
                    cp_async16(s_in + IN + j * NTP * PF_FRAG + 4 * u, w + 4 * u);
            }
        }
        cp_async_commit();
    };

    // acc: the products of the warp's rows and tiles (float32 adds); part:
    // a chain of two k8 steps in the tensor cores
    float acc[2][NTW][4], part[2][NTW][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int t = 0; t < NTW; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][t][e] = 0.0f;

    // ldmatrix row addresses: rows are cells (lanes 0-15: channels 0-3,
    // 16-31: channels 4-7 of the k8 step)
    const int a_lane = (2 * rp * PF_TZ + (lane & 15)) * PF_CHP + (lane >> 4) * 4;
    const int b_lane = IN + cg * NTW * PF_FRAG + 4 * lane;
    for (int s = 0; s < nbuf - 1; ++s) issue(s);
    for (int s = 0; s < nstage; ++s) {
        // this stage's copies have landed (all but the newest nbuf - 2
        // groups), and every warp is done with stage s - 1, whose buffer
        // the next issue refills: one barrier a stage
        if (nbuf == 4)
            cp_async_wait<2>();
        else if (nbuf == 3)
            cp_async_wait<1>();
        else
            cp_async_wait<0>();
        __syncthreads();
        issue(s + nbuf - 1);
        const int chunk = s % nchunk, c0 = chunk * PF_CH;
        const int nks = min(PF_CH, p.kp - c0) / 8;
        const float* s_in = s_ring + (s % nbuf) * STAGE + a_lane;
        const float* b = s_ring + (s % nbuf) * STAGE + b_lane;
        // the stage's k8 steps in chains of two, each added to the products
#pragma unroll 1
        for (int j = 0; j < nks; j += 2) {
            uint32_t big[2][4], small[2][4];
            load_split(s_in + 8 * j, big[0], small[0]);
            load_split(s_in + PF_TZ * PF_CHP + 8 * j, big[1], small[1]);
            row_products<NTW, 2, true>(part, big, small, b + j * NTP * PF_FRAG);
            if (j + 1 < nks) {
                load_split(s_in + 8 * (j + 1), big[0], small[0]);
                load_split(s_in + PF_TZ * PF_CHP + 8 * (j + 1), big[1], small[1]);
                row_products<NTW, 2, false>(part, big, small, b + (j + 1) * NTP * PF_FRAG);
            }
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
                for (int t = 0; t < NTW; ++t)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[r][t][e] += part[r][t][e];
        }
        if (chunk == nchunk - 1) {
            // the input plane's products are complete: to shared memory
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
                for (int t = 0; t < NTW; ++t)
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        const int row = (2 * rp + r) * PF_TZ + (lane >> 2) + 8 * half;
                        const int col = 8 * (cg * NTW + t) + 2 * (lane & 3);
                        *reinterpret_cast<float2*>(s_p + row * PP + col) =
                            make_float2(acc[r][t][2 * half], acc[r][t][2 * half + 1]);
                        acc[r][t][2 * half] = acc[r][t][2 * half + 1] = 0.0f;
                    }
            __syncthreads();
            // the tap sums: output plane x = plane - dx takes column group
            // (dx, dy) of input row y + dy; each output value is one thread's,
            // its taps added in the order (dx, dy)
            const int plane = x0 + s / nchunk;
            for (int e = tid; e < nacc; e += PF_THREADS) {
                const int o = e % cout, cz = e / cout;
                const int z = cz % PF_TZ, y = cz / PF_TZ;
                const float* pr = s_p + (y * PF_TZ + z) * PP + o;
                for (int dx = 0; dx < kx; ++dx) {
                    const int x = plane - dx;
                    if (x < x0 || x >= x1) continue;
                    float col[PF_MAXKY];  // the column groups, read together, added in order
#pragma unroll
                    for (int dy = 0; dy < PF_MAXKY; ++dy)
                        col[dy] = dy < ky ? pr[dy * PF_TZ * PP + (dx * ky + dy) * cout] : 0.0f;
                    float* a = s_acc + (x % kx) * nacc + e;
                    float v = *a;
#pragma unroll
                    for (int dy = 0; dy < PF_MAXKY; ++dy)
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
            // the products and the accumulators are next touched after the
            // next stage's barrier
        }
    }
}

// kc rounded up to 8 and the padded output columns, as the wrapper packs them
bool tf32_geometry_ok(int kc, int cout, int kp, int nt, int np) {
    return kc >= 4 && kc % 4 == 0 && kp == (kc + 7) / 8 * 8 && nt >= 1 && nt <= TMAXNT &&
           np % (8 * nt) == 0 && np >= cout && np - 8 * nt < cout;
}

template <int KY, int NT>
cudaError_t launch_tap_tf32(TapTf32Params p, cudaStream_t stream) {
    constexpr size_t SM_BYTES = 227 * 1024;  // an SM's shared memory for blocks
    const size_t stage = sizeof(float) * tf32_stage_floats<KY, NT>();
    p.nbuf = 3 * stage * TF_SM_BLOCKS <= SM_BYTES ? 3 : 2;
    size_t smem = p.nbuf * stage;
    const size_t epilogue_bytes = sizeof(float) * (TF_THREADS / 32) * TRW * 16 * (8 * NT + 4);
    smem = smem > epilogue_bytes ? smem : epilogue_bytes;
    const cudaError_t e = set_smem((const void*)tap_tf32_kernel<KY, NT>, smem);
    if (e != cudaSuccess) return e;
    const int nx = p.nxp - p.kx + 1, ny = p.nyp - KY + 1;
    const dim3 grid((p.nz + TTZ - 1) / TTZ, (ny + TTY - 1) / TTY, nx * (p.np / (8 * NT)));
    tap_tf32_kernel<KY, NT><<<grid, TF_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

#define INS_TF32_NT(KY)                                         \
    switch (nt) {                                               \
        case 1: return launch_tap_tf32<KY, 1>(p, s);            \
        case 2: return launch_tap_tf32<KY, 2>(p, s);            \
        case 3: return launch_tap_tf32<KY, 3>(p, s);            \
        default: return cudaErrorInvalidValue;                  \
    }

cudaError_t tap_tf32(int ky, int nt, const TapTf32Params& p, cudaStream_t s) {
    switch (ky) {
        case 1: INS_TF32_NT(1)
        case 3: INS_TF32_NT(3)
        case 5: INS_TF32_NT(5)
        case 7: INS_TF32_NT(7)
        default: return cudaErrorInvalidValue;
    }
}

#undef INS_TF32_NT

template <int NTW>
cudaError_t launch_pack_tf32(PackTf32Params p, cudaStream_t stream) {
    p.nbuf = pack_tf32_nbuf(p.nt, p.kx, p.ky, p.cout);
    const size_t smem = pack_tf32_smem(p.nbuf, p.nt, p.kx, p.ky, p.cout);  // `pack_tf32_takes`
    const cudaError_t e = set_smem((const void*)pack_tf32_kernel<NTW>, smem);
    if (e != cudaSuccess) return e;
    const int nx = p.nxp - p.kx + 1, ny = p.nyp - p.ky + 1, ty = PF_ROWS - p.ky + 1;
    const int zs = (p.nz + PF_TZ - 1) / PF_TZ, ys = (ny + ty - 1) / ty;
    int groups = (PF_BLOCKS + zs * ys - 1) / (zs * ys);
    groups = groups > nx ? nx : groups;
    p.xb = (nx + groups - 1) / groups;
    const dim3 grid(zs, ys, (nx + p.xb - 1) / p.xb);
    pack_tf32_kernel<NTW><<<grid, PF_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <int... NTWS>
cudaError_t pack_tf32_dispatch(int ntw, const PackTf32Params& p, cudaStream_t s,
                               std::integer_sequence<int, NTWS...>) {
    cudaError_t e = cudaErrorInvalidValue;
    ((ntw == NTWS + 1 ? (void)(e = launch_pack_tf32<NTWS + 1>(p, s)) : (void)0), ...);
    return e;
}

}  // namespace

// The tap forward on float32 operands, 3xTF32 on the tensor cores: g (nxp,
// nyp, nz, kc) float32 (kc a multiple of 4, 16-byte aligned), wp the split
// B fragments (kx, ky, kp/8, np/8, 32, 4) float32, out (nxp-kx+1, nyp-ky+1,
// nz, cout) float32 or bf16; ky in (1, 3, 5, 7); kp = kc rounded up to 8,
// np = cout padded to a multiple of 8*nt (nt <= 3), as `ops/conv_kernels.py`
// `tap_tf32_geometry` computes them.
extern "C" int ins_tapconv_fwd_tf32(const void* g, const void* wp, const float* bias, int act,
                                    void* out, int out_bf16, int nxp, int nyp, int nz, int kc,
                                    int kx, int ky, int cout, int kp, int nt, int np,
                                    void* stream) {
    if (kx < 1 || nxp < kx || nyp < ky || nz < 1 || cout < 1 ||
        !tf32_geometry_ok(kc, cout, kp, nt, np) || ((uintptr_t)g & 15) || ((uintptr_t)wp & 15))
        return (int)cudaErrorInvalidValue;
    const TapTf32Params p{static_cast<const float*>(g), static_cast<const float*>(wp), bias, act,
                          out, out_bf16, cout % 8 == 0 && ((uintptr_t)out & 15) == 0,
                          nxp, nyp, nz, kc, kx, cout, kp, np};
    return (int)tap_tf32(ky, nt, p, (cudaStream_t)stream);
}

// The pack forward on float32 operands, 3xTF32 on the tensor cores: g as
// `ins_tapconv_fwd_tf32`, ws every tap's split B fragments (kp/8, nt, 32,
// 4) float32 (`ops/conv_kernels.py` `pack_all_taps_tf32`), out
// (nxp-kx+1, nyp-ky+1, nz, cout) float32 or bf16; only layers that
// `pack_tf32_takes`.
extern "C" int ins_packconv_tf32(const void* g, const void* ws, const float* bias, int act,
                                 void* out, int out_bf16, int nxp, int nyp, int nz, int kc,
                                 int kx, int ky, int cout, int kp, int nt, void* stream) {
    if (nxp < kx || nyp < ky || nz < 1 || !pack_tf32_takes(kc, kx, ky, cout) ||
        kp != (kc + 7) / 8 * 8 || nt != (kx * ky * cout + 7) / 8 || ((uintptr_t)g & 15) ||
        ((uintptr_t)ws & 15))
        return (int)cudaErrorInvalidValue;
    const PackTf32Params p{static_cast<const float*>(g), static_cast<const float*>(ws), bias, act,
                           out, out_bf16, nxp, nyp, nz, kc, kx, ky, cout, kp, nt};
    return (int)pack_tf32_dispatch(
        pack_tf32_warp_tiles(nt), p, (cudaStream_t)stream,
        std::make_integer_sequence<int, pack_tf32_warp_tiles(PF_MAXNT)>{});
}
