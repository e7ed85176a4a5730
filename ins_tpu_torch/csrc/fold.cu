// Pass B of the fused projection in one kernel: divhat -> qhat on an
// (n, ly, n) block (the cube, ly = n, yoff = 0, or an x-slab shard's
// y-slice after the x<->y transpose, whose first y-mode is yoff), one pass
// over device memory.  Two forms share it.  The radix-2 folded pass B
// (n % 4 == 0; with h = [h0; h1] the two x-halves of a column c = y n + z):
//
//   e = h0 + h1,  o = h0 - h1                          (fold split)
//   g_o = R_o . o,  g_o *= 1 / den(kx_odd(r), c)        (odd frequencies)
//   q_o = S_o . g_o
//   q_e = the same solve on e with doubled frequencies (one more fold at
//         two levels; at the leaf g = Vinv_L . e, scaled, q = V_L . g)
//   out = [q_e / 2 + q_o; q_e / 2 - q_o]                (combine)
//
// and the dense pass B (LEVELS = 0, any n; the projection's choice where
// n % 4 != 0): the leaf alone at full size,
//
//   g = Vinv . h,  g *= 1 / den(ceil(r / 2), c),  out = V . g
//
// den = vol (lam_x(kx) + lam_y(yoff + y) + lam_z(z)) from the closed form,
// lam(k) = -4 sin^2(pi k / n) / dx^2 with k = ceil(i / 2) in y and z, kx =
// kmul (2 floor(r / 2) + 1) on a level's odd half and kmul ceil(r / 2) at
// the leaf (kmul 1, 2, 4 down the levels; 1 dense); 0 where |den| < eps
// (the zero-mean pressure), formed exactly as `poisson.cu`'s eigen-scale
// does.
//
// Replaces: `_passB_fold_kernel` / `_passB_fold_body`
// (ins_tpu/ops/poisson_pallas.py:214, :136; the cube, from
// `make_fused_projection` :411 wherever n % 4 == 0, :429-449) and
// `_passB_fold_yoff_kernel` (:223; the shard's y-slice, from
// `make_passB_sharded` :480, fold form :504); and `_passB_kernel` /
// `_passB_body` (dense, :198, :110; `make_fused_projection` :451 where
// n % 4 != 0) and `_passB_yoff_kernel` (:205; the shard's dense form,
// :534).  The TPU kernels keep a whole (n, by, n) slab in VMEM and do
// split, products, scale, recursion and combine there; this kernel
// computes the same functions with a block's panel of columns in shared
// memory.
//
// Two precision forms (BF): 3xTF32 (the "highest" projection precision)
// and bf16x3 ("manualhigh", the JAX package's default: `_dot_h` with prec
// None, poisson_pallas.py:68, three bf16 products hi*hi + hi*lo + lo*hi
// of a bf16 hi/lo split, float32 sums; bf16x3.cuh).  The bf16x3 form
// splits the panel in registers where each product reads it (so g is split
// again before the second product, as `_dot_h` splits both operands of
// every product), takes the basis split on the host
// (`pack_basis_a_bf16`), runs `mma.sync.m16n8k16`, a stage's k16 steps
// (KS / 2 of them) one chain, and keeps the eigen-scale and the combine
// in the float32 epilogues.  Its k16 step pairs the 3xTF32 form's two k8
// fragments, so both forms read the panel in the same pattern; its stages
// hold half the basis bytes of K (`fold_geometry.cuh`, bf).
//
// What bounds it on an H100: the x products, as 3xTF32 (three TF32
// products a multiply-add; bf16x3: three bf16 products at the 989
// TFLOP/s bf16 peak, so a third of the 3xTF32 form's bound there).
// Folded: 2 n^4 FLOP at one level (n^4 for the odd pair, n^4 for the leaf
// pair; 1.5 n^4 at two levels: n^4, then n^4 /
// 4 each for the second odd pair and the leaf pair), 25.8 GFLOP of TF32
// mma at 256^3, 0.052 ms at the 495 TFLOP/s dense peak (0.0568 ms with the
// elementwise work counted at the FP32 peak, as `chip_smoke.py` `fold_ops`
// counts it; 0.0448 ms at two levels).  Dense: 4 n^4 FLOP, 51.5 GFLOP of
// TF32 mma at 256^3 (0.104 ms; 0.1079 ms as `chip_smoke.py` counts it).
// Against them 134 MB of compulsory traffic at 256^3 (h read once, qhat
// written once: 0.040 ms at 3.35 TB/s), where separate launches would move
// every intermediate (the folded e, o, g_o, q_o, g_e, q_e; the dense g
// twice) through device memory.
//
// Design: a block owns a panel of nc consecutive columns over all n
// x-rows, in shared memory for the whole solve, so device memory sees h
// once and qhat once; blocks are independent.  The panel's rows hold the
// level's halves in place ([e | o], at two levels [e' | o' | o]); each
// product reads its operand rows and, after a barrier, its epilogue
// writes its output over them:
//
//   dense:       g = Vinv h (scale), out = V g -> device memory
//   one level:   g_o = R_o o (scale), g_e = Vinv_L e (scale), q_e = V_L g_e,
//                q_o = S_o g_o, out = [q_e/2 + q_o; q_e/2 - q_o] -> device memory
//   two levels:  g_o = R_o^0 o (scale), then e -> [e' | o'];
//                g_o' = R_o^1 o' (scale), g_e' = Vinv_L e' (scale),
//                q_e' = V_L g_e', q_o' = S_o^1 g_o', e-rows = [q_e'/2 +- q_o'];
//                q_o = S_o^0 g_o, out = [q_e/2 + q_o; q_e/2 - q_o]
//
// h arrives in chunks of x-rows (of both halves when folded) with the
// first product's stages (a chunk a stage ahead of its use); folded, each
// chunk is split in place just before the stage that reads it.  Where the
// columns are no multiple of 4 (a dense shard such as (250, 125, 250)) or
// h and out are not 16-byte aligned, h is staged by 4-byte copies and
// qhat stored a float at a time.  The products are the plane GEMM's
// (`transforms.cu`): 3xTF32 `mma.sync.m16n8k8`, the panel as B (32-bit
// fragment loads, rows nc + 8 floats apart: the 32 lanes hit distinct
// banks), split into TF32 big and small parts in registers; the basis as
// A, split on the host in fragment order (`ops/transforms.py`
// `pack_basis_a`, kept on the matrix by `split_basis`), streamed from L2
// through a ring of stages (cp.async, 16 bytes a copy) that runs on
// across the products, so the next product's first stage is in flight
// while one ends.  A chain holds one stage's K (at most 32) before its
// float32 add (the tensor cores' float32 sums truncate, transforms.cu);
// every output element sums its K in the same order whatever the panel,
// ly or yoff (no split-K; the geometry depends on n alone); with stages
// of 32 of K it sums exactly as the plane GEMM does.
//
// Geometry (`fold_geometry.cuh`, chosen by the entry from n): 8 warps,
// each a 64 x 32 output tile (4 m16 x 4 n8 tiles, 64 accumulators), nc /
// 32 across the panel and 8 / (nc / 32) down its rows, so a product's
// rows (at most n / 2 folded, n dense) fit one pass of the warps: folded
// nc = 256 at n <= 128, 128 at n <= 256, 64 at n <= 512, 32 at n <= 1024;
// dense nc = 256 at n <= 64, 128 at n <= 128, 64 at n <= 256, 32 at n <=
// 512; stages of 32 of K in a ring of two where they fit beside the
// panel, else of 16 (folded n = 512, dense above 256) or 8 (folded n =
// 1024).  Above that no panel of all n rows whose warps cover a product
// fits a block and the entries refuse.  Folded at 256^3: a 128-column
// panel (136 KB), two 32 KB stages, 206 KB, one block an SM, 512 blocks;
// the split basis is 512 KB a panel, ~256 MB a call from L2; 203
// registers, no spills.  Dense at 256^3: a 64-column panel (72 KB), two 64
// KB stages, 1024 blocks, 1 MB of split basis a panel (~1 GB a call from
// L2).  At 1024 (32-column panels) the folded basis is 6.3 MB a panel at
// two levels, 4x the L2 traffic a FLOP of 256^3.  64-column panels of 32
// x 32 warp tiles (4x the basis traffic a FLOP), 16 warps of 32 x 32
// tiles, and rings of four 16-K stages ran slower at 256^3 on an H100
// (PERF.md).  The basis is zero-padded to whole tiles on the host and the
// panel's rows below each operand hold finite values (the next slot, or a
// zero tail where the operand is no multiple of the stage's K), so ragged
// n (n = 100: halves of 50; dense n = 250) needs no masks in the
// products; ragged panels are zero-filled and masked on store.

#include <cstdint>

#include "bf16x3.cuh"         // products_bf16x3, load_split_b
#include "convio.cuh"         // cp_async16, cp_async_commit, cp_async_wait, set_smem
#include "fold_geometry.cuh"  // FP_*, fold_rows .. fold_smem, fold_geometry, dense_geometry
#include "ring.cuh"           // cp_async4
#include "tf32.cuh"           // tf32_rna, split_tf32, mma_tf32, mma_tf32_first

namespace {

struct FoldParams {
    const float* h;        // (n, cols) rows, x leading
    float* out;            // (n, cols)
    const float* mats[6];  // pack_basis_a: R_o^0, S_o^0, [R_o^1, S_o^1,] Vinv_L, V_L
                           // (dense: Vinv, V)
    int cols;              // ly n
    int n, ly, yoff, nc;   // nc: a panel's columns
    float dx0, dx1, dx2, vol, eps;
    int vec;               // cols % 4 == 0, h and out 16-byte aligned: 16-byte copies
};

// what a product's epilogue does with its output rows r < size
enum Epilogue {
    EPI_ODD,   // scale (a level's odd frequencies), back over its operand rows
    EPI_LEAF,  // scale (the leaf's frequencies), back over its operand rows
    EPI_STORE, // back over its operand rows
    EPI_HALF,  // combine with the even rows 0.. into rows r and row0 + r
    EPI_OUT,   // the same combine into device memory
    EPI_DENSE, // into device memory
};

struct Gemm {
    int mat;   // index into FoldParams::mats
    int size;  // M = K
    int row0;  // the panel row of its operand's first row
    int epi;
    int kmul;  // x-frequency multiplier of a scaling epilogue
};

// The products in order (see the note at the top)
template <int LEVELS>
__device__ __forceinline__ Gemm fold_gemm(int i, int n) {
    const int s0 = n / 2, s1 = n / 4;
    if (LEVELS == 0) return i == 0 ? Gemm{0, n, 0, EPI_LEAF, 1} : Gemm{1, n, 0, EPI_DENSE, 0};
    if (LEVELS == 1) {
        switch (i) {
            case 0: return {0, s0, s0, EPI_ODD, 1};
            case 1: return {2, s0, 0, EPI_LEAF, 2};
            case 2: return {3, s0, 0, EPI_STORE, 0};
            default: return {1, s0, s0, EPI_OUT, 0};
        }
    }
    switch (i) {
        case 0: return {0, s0, s0, EPI_ODD, 1};
        case 1: return {2, s1, s1, EPI_ODD, 2};
        case 2: return {4, s1, 0, EPI_LEAF, 4};
        case 3: return {5, s1, 0, EPI_STORE, 0};
        case 4: return {3, s1, s1, EPI_HALF, 0};
        default: return {1, s0, s0, EPI_OUT, 0};
    }
}

__device__ __forceinline__ float fold_lam(int k, int n, float dx) {
    const float s = sinpif((float)k / (float)n);
    return (-4.0f / (dx * dx)) * s * s;
}

// part (+)= a_small*b_big + a_big*b_small + a_big*b_big, FIRST starting a
// chain (the plane GEMM's order, transforms.cu `products`)
template <bool FIRST>
__device__ __forceinline__ void fold_products(float (&part)[4], const uint32_t (&a_big)[4],
                                              const uint32_t (&a_small)[4], const uint32_t (&b)[4]) {
    if (FIRST)
        mma_tf32_first(part, a_small, b[0], b[1]);
    else
        mma_tf32(part, a_small, b[0], b[1]);
    mma_tf32(part, a_big, b[2], b[3]);
    mma_tf32(part, a_big, b[0], b[1]);
}

template <int LEVELS, int KS, bool BF>
__global__ void __launch_bounds__(FP_THREADS, 1)
passb_fold_kernel(const __grid_constant__ FoldParams p) {
    constexpr int MT = 4;  // m16 tiles a warp
    constexpr int NG = 2 + 2 * LEVELS;  // products
    constexpr int BK = 8 * KS;          // K a stage: one chain
    static_assert(!BF || KS % 2 == 0, "a bf16x3 stage is whole k16 steps");
    constexpr int STEPS = BF ? KS / 2 : KS;  // k steps a stage: k8 (3xTF32) or k16 (bf16x3)
    extern __shared__ float4 smem_f4[];
    float* F = reinterpret_cast<float*>(smem_f4);  // the panel
    constexpr int HALVES = LEVELS ? 2 : 1;  // x-halves of h the first product's stages bring
    // s0: the first product's size, its operand rows per half (the
    // largest product: the geometry's m)
    const int n = p.n, nc = p.nc, pitch = nc + 8, s0 = LEVELS ? n / 2 : n;
    const int stage_floats = fold_stage_floats(nc, KS, BF);
    float* ring = F + fold_panel_floats(n, s0, nc, KS);
    float* lx = ring + FP_NBUF * stage_floats;  // lam_x(k), k <= n / 2
    float* lyc = lx + n / 2 + 1;             // lam_y, lam_z of the panel's columns
    float* lzc = lyc + nc;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wn_count = nc / 32;
    const int wm = warp / wn_count, wn = warp % wn_count;
    const int c0 = blockIdx.x * nc;
    // this thread's float4 of a panel row and its first row in a sweep of
    // FP_THREADS float4 (nc / 4 divides FP_THREADS)
    const int q4 = nc / 4, cq = 4 * (tid % q4), rq = tid / q4, rstep = FP_THREADS / q4;

    for (int k = tid; k <= n / 2; k += FP_THREADS) lx[k] = fold_lam(k, n, p.dx0);
    for (int c = tid; c < nc; c += FP_THREADS) {
        const int gc = c0 + c, y = gc / n, z = gc - y * n;
        lyc[c] = fold_lam((y + p.yoff + 1) / 2, n, p.dx1);
        lzc[c] = fold_lam((z + 1) / 2, n, p.dx2);
    }
    for (int r = n + rq; r < n + fold_tail(s0, KS); r += rstep)
        *reinterpret_cast<float4*>(F + r * pitch + cq) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

    // e, o = h0 + h1, h0 - h1 on panel rows r_lo + r and s + r_lo + r, r < nr
    auto split = [&](int r_lo, int nr, int s) {
        for (int r = rq; r < nr; r += rstep) {
            float4* pa = reinterpret_cast<float4*>(F + (r_lo + r) * pitch + cq);
            float4* pb = reinterpret_cast<float4*>(F + (s + r_lo + r) * pitch + cq);
            const float4 x = *pa, y = *pb;
            *pa = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
            *pb = make_float4(x.x - y.x, x.y - y.y, x.z - y.z, x.w - y.w);
        }
    };

    // the stage ring: ig, is the next stage to issue (product, stage of
    // it), qi the stages issued; each issue commits one cp.async group
    int ig = 0, is = 0, qi = 0;
    const bool col_ok = c0 + cq < p.cols;  // vec: cols % 4 == 0, all four or none
    const bool vec = LEVELS > 0 || p.vec;  // the folded pass B: n % 4 == 0, aligned
    auto issue = [&]() {
        if (ig < NG) {
            const Gemm G = fold_gemm<LEVELS>(ig, n);
            float* slot = ring + (qi % FP_NBUF) * stage_floats;
            // the basis: k steps STEPS is.. of the product's m16 tiles
            // (pack_basis_a: per step ceil(size / 128) * 8 tiles, contiguous)
            const int per_ks = (G.size + 15) / 16 * (FP_ATILE / 4);  // 16-byte copies
            const int tps = (G.size + 127) / 128 * 8;
            const float* base = p.mats[G.mat] + (size_t)is * STEPS * tps * FP_ATILE;
#pragma unroll
            for (int ks = 0; ks < STEPS; ++ks)
                for (int u = tid; u < per_ks; u += FP_THREADS)
                    cp_async16(slot + ks * per_ks * 4 + 4 * u,
                               base + (size_t)ks * tps * FP_ATILE + 4 * u);
            // the first product's stages bring h: x-rows BK is.. (of both
            // halves when folded)
            if (ig == 0) {
                const int r_lo = is * BK, nr = min(BK, s0 - r_lo);
                for (int r = rq; r < nr; r += rstep)
#pragma unroll
                    for (int half = 0; half < HALVES; ++half) {
                        const int row = half * s0 + r_lo + r;
                        float* d = F + row * pitch + cq;
                        const float* src = p.h + (size_t)row * p.cols + c0 + cq;
                        if (vec) {
                            if (col_ok)
                                cp_async16(d, src);
                            else
                                *reinterpret_cast<float4*>(d) =
                                    make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                        } else {
#pragma unroll
                            for (int e = 0; e < 4; ++e) {
                                if (c0 + cq + e < p.cols)
                                    cp_async4(d + e, src + e);
                                else
                                    d[e] = 0.0f;
                            }
                        }
                    }
            }
            ++qi;
            if (++is == (G.size + BK - 1) / BK) ++ig, is = 0;
        }
        cp_async_commit();
    };

    for (int s = 0; s < FP_NBUF - 1; ++s) issue();
    int q = 0;  // stages computed
    for (int gi = 0; gi < NG; ++gi) {
        const Gemm G = fold_gemm<LEVELS>(gi, n);
        const int mt = (G.size + 15) / 16;
        const int tv = min(max(mt - MT * wm, 0), MT);  // this warp's m16 tiles with rows
        float acc[MT][4][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
        const int nst = (G.size + BK - 1) / BK;
        for (int s = 0; s < nst; ++s, ++q) {
            issue();
            cp_async_wait<FP_NBUF - 1>();  // this stage's copies have landed
            __syncthreads();
            if (LEVELS > 0 && gi == 0) {  // the fold split of the chunk this stage reads
                split(s * BK, min(BK, s0 - s * BK), s0);
                __syncthreads();
            }
            if (BF && tv > 0) {
                const float* slot = ring + (q % FP_NBUF) * stage_floats;
                const int k0 = G.row0 + s * BK;
                // the panel's B fragments of every k16 step, split: (hi b0,
                // b1, lo b0, b1) per n8 tile and step
                uint32_t bf[4][STEPS][4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int kk = 0; kk < STEPS; ++kk)
                        load_split_b(F + (k0 + kk * 16 + t) * pitch + wn * 32 + j * 8 + g, pitch,
                                     bf[j][kk]);
#pragma unroll
                for (int i = 0; i < MT; ++i) {
                    if (i >= tv) break;
                    // the basis's split A fragments of every k16 step
                    uint32_t ah[STEPS][4], al[STEPS][4];
#pragma unroll
                    for (int kk = 0; kk < STEPS; ++kk) {
                        const float* a = slot + (kk * mt + MT * wm + i) * FP_ATILE + 4 * lane;
                        const uint4 hi = *reinterpret_cast<const uint4*>(a);
                        const uint4 lo = *reinterpret_cast<const uint4*>(a + FP_ATILE / 2);
                        ah[kk][0] = hi.x, ah[kk][1] = hi.y, ah[kk][2] = hi.z, ah[kk][3] = hi.w;
                        al[kk][0] = lo.x, al[kk][1] = lo.y, al[kk][2] = lo.z, al[kk][3] = lo.w;
                    }
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        float part[4];
                        products_bf16x3<true>(part, ah[0], al[0], bf[j][0]);
#pragma unroll
                        for (int kk = 1; kk < STEPS; ++kk)
                            products_bf16x3<false>(part, ah[kk], al[kk], bf[j][kk]);
#pragma unroll
                        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[e];
                    }
                }
            } else if (tv > 0) {
                const float* slot = ring + (q % FP_NBUF) * stage_floats;
                const int k0 = G.row0 + s * BK;
                // the panel's B fragments of every step, split: (big b0,
                // b1, small b0, b1) per n8 tile and step
                uint32_t bf[4][KS][4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int ks = 0; ks < KS; ++ks) {
                        const float* b = F + (k0 + ks * 8 + t) * pitch + wn * 32 + j * 8 + g;
                        const float b0 = b[0], b1 = b[4 * pitch];
                        bf[j][ks][0] = tf32_rna(b0);
                        bf[j][ks][1] = tf32_rna(b1);
                        bf[j][ks][2] = tf32_rna(b0 - __uint_as_float(bf[j][ks][0]));
                        bf[j][ks][3] = tf32_rna(b1 - __uint_as_float(bf[j][ks][1]));
                    }
#pragma unroll
                for (int i = 0; i < MT; ++i) {
                    if (i >= tv) break;
                    // the basis's split A fragments of every step
                    uint32_t ab[KS][4], as[KS][4];
#pragma unroll
                    for (int ks = 0; ks < KS; ++ks) {
                        const float* a = slot + (ks * mt + MT * wm + i) * FP_ATILE + 4 * lane;
                        const uint4 big = *reinterpret_cast<const uint4*>(a);
                        const uint4 small = *reinterpret_cast<const uint4*>(a + FP_ATILE / 2);
                        ab[ks][0] = big.x, ab[ks][1] = big.y, ab[ks][2] = big.z, ab[ks][3] = big.w;
                        as[ks][0] = small.x, as[ks][1] = small.y, as[ks][2] = small.z,
                        as[ks][3] = small.w;
                    }
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        float part[4];
                        fold_products<true>(part, ab[0], as[0], bf[j][0]);
#pragma unroll
                        for (int ks = 1; ks < KS; ++ks)
                            fold_products<false>(part, ab[ks], as[ks], bf[j][ks]);
#pragma unroll
                        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[e];
                    }
                }
            }
            __syncthreads();  // the operand rows are free, the slot refillable
        }

        // the epilogue: output row r < size of this warp, columns c, c + 1
#pragma unroll
        for (int i = 0; i < MT; ++i) {
            if (i >= tv) break;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int r = wm * 16 * MT + i * 16 + g + 8 * hh;
                if (r >= G.size) continue;
                float lxr = 0.0f;
                if (G.epi == EPI_ODD) lxr = lx[G.kmul * (2 * (r / 2) + 1)];
                if (G.epi == EPI_LEAF) lxr = lx[G.kmul * ((r + 1) / 2)];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int c = wn * 32 + j * 8 + 2 * t;
                    float v0 = acc[i][j][2 * hh], v1 = acc[i][j][2 * hh + 1];
                    float2* own = reinterpret_cast<float2*>(F + (G.row0 + r) * pitch + c);
                    if (LEVELS == 0 && G.epi == EPI_DENSE) {
                        float* o = p.out + (size_t)r * p.cols + c0 + c;
                        if (vec) {  // cols even: both columns or none
                            if (c0 + c < p.cols) *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
                        } else {
                            if (c0 + c < p.cols) o[0] = v0;
                            if (c0 + c + 1 < p.cols) o[1] = v1;
                        }
                    } else if (G.epi == EPI_ODD || G.epi == EPI_LEAF) {
                        const float d0 = p.vol * (lxr + lyc[c] + lzc[c]);
                        const float d1 = p.vol * (lxr + lyc[c + 1] + lzc[c + 1]);
                        v0 = v0 * (fabsf(d0) < p.eps ? 0.0f : 1.0f / d0);
                        v1 = v1 * (fabsf(d1) < p.eps ? 0.0f : 1.0f / d1);
                        *own = make_float2(v0, v1);
                    } else if (G.epi == EPI_STORE) {
                        *own = make_float2(v0, v1);
                    } else {
                        // the even half's rows 0.. hold its solve
                        float2* ev = reinterpret_cast<float2*>(F + r * pitch + c);
                        const float2 e = *ev;
                        const float a0 = 0.5f * e.x, a1 = 0.5f * e.y;
                        const float2 lo = make_float2(a0 + v0, a1 + v1);
                        const float2 hi = make_float2(a0 - v0, a1 - v1);
                        if (G.epi == EPI_HALF) {
                            *ev = lo;
                            *own = hi;
                        } else if (c0 + c < p.cols) {  // cols even: both columns or none
                            float* o = p.out + (size_t)r * p.cols + c0 + c;
                            *reinterpret_cast<float2*>(o) = lo;
                            *reinterpret_cast<float2*>(o + (size_t)G.row0 * p.cols) = hi;
                        }
                    }
                }
            }
        }
        // two levels: e -> [e' | o'] on rows 0.. n/2 (the first product's
        // split formed e; its epilogue wrote rows n/2.. only)
        if (LEVELS == 2 && gi == 0) split(0, n / 4, n / 4);
    }
}

template <int LEVELS, int KS, bool BF>
cudaError_t launch_fold(const FoldParams& p, size_t smem, cudaStream_t stream) {
    const void* k = (const void*)passb_fold_kernel<LEVELS, KS, BF>;
    const cudaError_t e = set_smem(k, smem);
    if (e != cudaSuccess) return e;
    passb_fold_kernel<LEVELS, KS, BF><<<(p.cols + p.nc - 1) / p.nc, FP_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <bool BF>
int passb_fold(const float* h, float* out, const float* const (&mats)[6], int n, int ly,
               int yoff, int levels, float dx0, float dx1, float dx2, float vol, float eps,
               void* stream) {
    const FoldGeometry geo = fold_geometry(n, BF);
    if (levels < 1 || levels > 2 || n < 4 || n % (2 << levels) || ly < 1 || yoff < 0 ||
        yoff + ly > n || geo.nc == 0)
        return (int)cudaErrorInvalidValue;
    for (int i = 0; i < 2 + 2 * levels; ++i)
        if (mats[i] == nullptr || ((uintptr_t)mats[i] & 15)) return (int)cudaErrorInvalidValue;
    if (((uintptr_t)h & 15) || ((uintptr_t)out & 15)) return (int)cudaErrorInvalidValue;
    FoldParams p{h, out, {mats[0], mats[1], mats[2], mats[3], mats[4], mats[5]}, ly * n, n, ly,
                 yoff, geo.nc, dx0, dx1, dx2, vol, eps, 1};
    cudaStream_t s = (cudaStream_t)stream;
    if (BF) {  // ks 4 or 2 (fold_geometry)
        if (levels == 1)
            return (int)(geo.ks == 4 ? launch_fold<1, 4, true>(p, geo.smem, s)
                                     : launch_fold<1, 2, true>(p, geo.smem, s));
        return (int)(geo.ks == 4 ? launch_fold<2, 4, true>(p, geo.smem, s)
                                 : launch_fold<2, 2, true>(p, geo.smem, s));
    }
    if (levels == 1)
        return (int)(geo.ks == 4   ? launch_fold<1, 4, false>(p, geo.smem, s)
                     : geo.ks == 2 ? launch_fold<1, 2, false>(p, geo.smem, s)
                                   : launch_fold<1, 1, false>(p, geo.smem, s));
    return (int)(geo.ks == 4   ? launch_fold<2, 4, false>(p, geo.smem, s)
                 : geo.ks == 2 ? launch_fold<2, 2, false>(p, geo.smem, s)
                               : launch_fold<2, 1, false>(p, geo.smem, s));
}

template <bool BF>
int passb_dense(const float* h, float* out, const float* vinv, const float* v, int n, int ly,
                int yoff, float dx0, float dx1, float dx2, float vol, float eps, void* stream) {
    const FoldGeometry geo = dense_geometry(n, BF);
    if (n < 1 || ly < 1 || yoff < 0 || yoff + ly > n || geo.ks < 2 || vinv == nullptr ||
        v == nullptr || ((uintptr_t)vinv & 15) || ((uintptr_t)v & 15) || ((uintptr_t)h & 3) ||
        ((uintptr_t)out & 3))
        return (int)cudaErrorInvalidValue;
    const int cols = ly * n;
    const int vec = cols % 4 == 0 && ((uintptr_t)h & 15) == 0 && ((uintptr_t)out & 15) == 0;
    FoldParams p{h, out, {vinv, v, nullptr, nullptr, nullptr, nullptr}, cols, n, ly, yoff,
                 geo.nc, dx0, dx1, dx2, vol, eps, vec};
    cudaStream_t s = (cudaStream_t)stream;
    return (int)(geo.ks == 4 ? launch_fold<0, 4, BF>(p, geo.smem, s)
                             : launch_fold<0, 2, BF>(p, geo.smem, s));
}

}  // namespace

// qhat = the folded pass B of h: (n, ly, n) float32 rows, out the same;
// m0..m5 the fold matrices split as `pack_basis_a` lays them out (levels
// 1: R_o^0, S_o^0, Vinv_L, V_L; 2: R_o^0, S_o^0, R_o^1, S_o^1, Vinv_L, V_L;
// the rest null), each and h and out 16-byte aligned.  cudaErrorInvalidValue
// where the shape has no fold of that depth or no geometry (n > 1024).
extern "C" int ins_passb_fold_f32(const float* h, float* out, const float* m0, const float* m1,
                                  const float* m2, const float* m3, const float* m4,
                                  const float* m5, int n, int ly, int yoff, int levels,
                                  float dx0, float dx1, float dx2, float vol, float eps,
                                  void* stream) {
    const float* const mats[6] = {m0, m1, m2, m3, m4, m5};
    return passb_fold<false>(h, out, mats, n, ly, yoff, levels, dx0, dx1, dx2, vol, eps, stream);
}

// The same in bf16x3 (the "manualhigh" precision): the fold matrices split
// as `pack_basis_a_bf16` lays them out.
extern "C" int ins_passb_fold_bf16x3(const float* h, float* out, const float* m0,
                                     const float* m1, const float* m2, const float* m3,
                                     const float* m4, const float* m5, int n, int ly, int yoff,
                                     int levels, float dx0, float dx1, float dx2, float vol,
                                     float eps, void* stream) {
    const float* const mats[6] = {m0, m1, m2, m3, m4, m5};
    return passb_fold<true>(h, out, mats, n, ly, yoff, levels, dx0, dx1, dx2, vol, eps, stream);
}

// qhat = the dense pass B of h: (n, ly, n) float32 rows, out the same;
// vinv and v the x eigenbasis pair split as `pack_basis_a` lays them out,
// each 16-byte aligned (h and out need not be: where they or the columns
// ly n are not, h is staged a float at a time).  cudaErrorInvalidValue
// where no geometry fits (n > 512).
extern "C" int ins_passb_dense_f32(const float* h, float* out, const float* vinv,
                                   const float* v, int n, int ly, int yoff, float dx0,
                                   float dx1, float dx2, float vol, float eps, void* stream) {
    return passb_dense<false>(h, out, vinv, v, n, ly, yoff, dx0, dx1, dx2, vol, eps, stream);
}

// The same in bf16x3 (the "manualhigh" precision): vinv and v split as
// `pack_basis_a_bf16` lays them out.
extern "C" int ins_passb_dense_bf16x3(const float* h, float* out, const float* vinv,
                                      const float* v, int n, int ly, int yoff, float dx0,
                                      float dx1, float dx2, float vol, float eps, void* stream) {
    return passb_dense<true>(h, out, vinv, v, n, ly, yoff, dx0, dx1, dx2, vol, eps, stream);
}
