// The weight gradient of the CNN closure's z-folded tap layer on float32
// operands, on the tensor cores in 3xTF32 (`mma.sync.m16n8k8` with TF32
// operands and float32 sums, tf32.cuh):
//
//   dW[dx, dy, c, o] = sum_{x, y, z} g[x+dx, y+dy, z, c] * d[x, y, z, o]
//
// g is (nxp, nyp, nz, kc) float32 with the z taps folded into kc (a
// multiple of 4: the wrapper pads with zero channels) and x, y padded by
// kx-1, ky-1; d, the pre-activation cotangent, is (nxp-kx+1, nyp-ky+1, nz,
// cd) float32 (cd a multiple of 4, likewise).  dW is float32.  The bf16
// route is tapwgrad_mma.cu, whose structure this kernel keeps.
//
// Replaces: for float32 operands, `_wgrad_kernel`
// (ins_tpu/ops/convkernels.py:191, wrapper `tapconv_wgrad_3d` :249).
//
// An implicit GEMM per tap: dW[dx, dy] (kp x np) = sum_cells A^T B with A
// the staged g rows (cells x channels) of plane x + dx, row y + dy, and B
// the cotangent rows (cells x channels) of plane x, row y; M = the
// channels kc padded to kp (m16 tiles), N = cd in blocks of 8*NT columns
// (NT <= 3 n8 tiles), K = the cells, 8 (one z row of the tile) a step.
// There is no transposing load for 32-bit elements, so both operands come
// from 32-bit shared loads in the m16n8k8 fragment pattern (a0 = (g, t),
// a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4) at cell t,
// channel g; b0 = (t, g), b1 = (t + 4, g)), as conv.cu's
// `wgrad_tf32_kernel` loads them: a staged cell's channels are 16 mc + 8
// floats apart and the cotangent's 8 or 24, so t * pitch is 0, 8, 16, 24
// mod 32 and the 32 lanes hit distinct banks.  Each operand is split in
// registers into a TF32 big part rna(x) and a small part rna(x - big); a
// product is small*big + big*small + big*big (the float32 class, ~2^-21
// relative).  Each k8 step's three products are one tensor-core chain,
// added to the item's float32 accumulators (the tensor cores' float32
// sums truncate, so chains stay short).
//
// What bounds it on an H100: the 24 -> 24 layer at 128^3 is 302 GFLOP,
// 906 GFLOP of TF32 mma (1.83 ms at the 495 TFLOP/s dense TF32 peak),
// against 0.6 GB of compulsory traffic: mma.sync issue and the fragment
// loads and splits beside it.  A block owns a chunk of mc m16 channel
// tiles, one block of output columns, a group of kxb dx taps and 8 (y) x 8
// (z) cells over a run of x-planes, and walks the run with a ring of kxb +
// nbuf - 1 staged g planes: each g plane is staged once and feeds every dx
// whose output it meets (plane p meets output x = p - dx).  Its (dx, dy,
// m16 tile) items are spread over the 8 warps (at most WT_IPW = 7 each; a
// tap count past 56 / ky splits dx into groups of blocks), each with NT
// accumulator tiles; per k8 step of cells a warp loads and splits the NT B
// fragments once and feeds them to all of its items.  A staged float32
// takes twice a bf16's shared memory, so the tile is 8 x 8 cells (the
// bf16 kernel's 8 x 16 halved) and the plan keeps two blocks an SM: at 24
// -> 24, mc = 2 and two buffers, 102 KB a block.  Each block writes float32
// partials; `reduce_partials_kernel` adds them in a fixed order (no
// atomics: the same result on every run).

#include <cstdint>

#include "convio.cuh"  // cp.async, ring_wait, reduce_partials_kernel, set_smem
#include "tf32.cuh"    // tf32_rna, split_tf32, mma_tf32, mma_tf32_first

namespace {

constexpr int WT_THREADS = 256;  // 8 warps
constexpr int WT_WARPS = WT_THREADS / 32;
constexpr int WTY = 8;           // cotangent rows (y) a block
constexpr int WTZ = 8;           // cells (z) a row: one k8 step
constexpr int WT_MAXNT = 3;      // n8 tiles of output columns a block, at most
constexpr int WT_IPW = 7;        // (dx, dy, m16 tile) items a warp, at most
constexpr int WT_MAXMC = 8;      // m16 channel tiles a block, at most (a row's units,
                                 // 32 mc, fit the threads)
constexpr size_t WT_SMEM_MAX = 232448 - sizeof(int) * WT_WARPS * WT_IPW;  // dynamic, a block

struct TapWgradTf32Params {
    const float* g;  // (nxp, nyp, nz, kc)
    const float* d;  // (nxp - kx + 1, nyp - ky + 1, nz, cd)
    float* partial;  // (nchunk, kx, ky, kp, np)
    int nxp, nyp, nz, kc, cd, kx;
    int kp, np;      // kc rounded up to 16; cd padded to nblk * 8*NT
    int mc;          // m16 channel tiles a block
    int kxb;         // dx taps a block
    int xb;          // output planes a cell chunk
    int nbuf;        // cotangent planes in the ring (and g planes in flight + 1)
};

// shared-memory pitch (floats) of a cotangent cell's 8*nt channels: 8 or 24
// mod 32, so the b fragments' 32 lanes hit distinct banks
__host__ __device__ constexpr int wt_dpitch(int nt) { return nt == 2 ? 24 : 8 * nt; }

// Shared memory of a block: the ring of kxb + nbuf - 1 g planes ((WTY + ky
// - 1) rows x WTZ cells x 16 mc + 8 channels) and nbuf cotangent planes
// (WTY x WTZ cells x wt_dpitch(nt)).
__host__ __device__ constexpr size_t wgrad_tf32_smem(int kxb, int ky, int mc, int nt,
                                                     int nbuf) {
    return sizeof(float) * ((size_t)(kxb + nbuf - 1) * (WTY + ky - 1) * WTZ * (16 * mc + 8) +
                            (size_t)nbuf * WTY * WTZ * wt_dpitch(nt));
}

// Blocks an SM the launch bounds ask for (at most 128 registers a thread;
// the NT = 3 instantiations spill 48-56 bytes there, and one block an SM
// ran 18 % slower: PERF.md).  `ops/conv_kernels.py` `_WGRAD_TF32_SM_BLOCKS`.
constexpr int WT_SM_BLOCKS = 2;

__device__ __forceinline__ void zero16f(float* dst) {
    *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

template <int KY, int NT>
__global__ void __launch_bounds__(WT_THREADS, WT_SM_BLOCKS)
tap_wgrad_tf32_kernel(const __grid_constant__ TapWgradTf32Params p) {
    constexpr int ROWS = WTY + KY - 1;
    constexpr int DP = wt_dpitch(NT);
    constexpr int DPLANE = WTY * WTZ * DP;
    extern __shared__ float4 smem_f4[];
    float* const smem = reinterpret_cast<float*>(smem_f4);
    const int nch = (p.kp / 16 + p.mc - 1) / p.mc;
    const int ch = blockIdx.x % nch, dx0 = blockIdx.x / nch * p.kxb;
    const int kxg = min(p.kxb, p.kx - dx0), nbuf = p.nbuf, ring = kxg + nbuf - 1;
    const int P = 16 * p.mc + 8;  // staged pitch of a cell's channels
    const int GPLANE = ROWS * WTZ * P;
    float* const s_g = smem;                                // ring of g planes
    float* const s_d = smem + (p.kxb + nbuf - 1) * GPLANE;  // nbuf cotangent planes
    const int nx = p.nxp - p.kx + 1, ny = p.nyp - KY + 1;
    const int mt0 = ch * p.mc, mtiles = min(p.mc, p.kp / 16 - mt0);
    const int c0 = 16 * mt0;  // the chunk's first channel
    const int n0 = blockIdx.y * 8 * NT;
    const int ytiles = (ny + WTY - 1) / WTY, ztiles = (p.nz + WTZ - 1) / WTZ;
    const int chunk = blockIdx.z;
    const int zt = chunk % ztiles, yt = (chunk / ztiles) % ytiles, xg = chunk / (ztiles * ytiles);
    const int y0 = yt * WTY, z0 = zt * WTZ;
    const int x0 = xg * p.xb, x1 = min(nx, x0 + p.xb);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int nload = x1 - x0 + kxg - 1;  // g planes the run stages

    // g staging: a thread owns one (cell, 16-byte unit) of a row and stages
    // it in every rstep-th row; its offsets, in a staged row and in a g row
    // (-1: zeros, the cell or channels past the field), computed once
    const int units = 4 * mtiles, cell_units = WTZ * units;
    const int rstep = WT_THREADS / cell_units, r0 = tid / cell_units;
    const int cell = (tid % cell_units) / units, unit = tid % units;
    const int g_soff = cell * P + 4 * unit;
    const int g_goff =
        z0 + cell < p.nz && c0 + 4 * unit < p.kc ? (z0 + cell) * p.kc + c0 + 4 * unit : -1;
    // load step j: g plane x0 + dx0 + j; with it, from j = kxg - 1,
    // cotangent plane x0 + j - (kxg - 1)
    auto issue = [&](int j) {
        if (j < nload) {
            float* dst = s_g + (j % ring) * GPLANE + g_soff;
            const float* src =
                p.g + ((size_t)(x0 + dx0 + j) * p.nyp + y0) * p.nz * p.kc + max(g_goff, 0);
            for (int r = r0; r < ROWS && r0 < rstep; r += rstep) {
                if (y0 + r < p.nyp && g_goff >= 0)
                    cp_async16(dst + r * WTZ * P, src + (size_t)r * p.nz * p.kc);
                else
                    zero16f(dst + r * WTZ * P);
            }
            const int xd = j - (kxg - 1);
            if (xd >= 0) {
                float* sd = s_d + (xd % nbuf) * DPLANE;
                for (int u = tid; u < WTY * WTZ * 2 * NT; u += WT_THREADS) {
                    const int q = u % (2 * NT), c = u / (2 * NT);
                    const int y = y0 + c / WTZ, z = z0 + c % WTZ, n = n0 + 4 * q;
                    if (y < ny && z < p.nz && n < p.cd)  // cells past the box add 0
                        cp_async16(sd + c * DP + 4 * q,
                                   p.d + (((size_t)(x0 + xd) * ny + y) * p.nz + z) * p.cd + n);
                    else
                        zero16f(sd + c * DP + 4 * q);
                }
            }
        }
        cp_async_commit();
    };

    // the warp's items it = warp + WT_WARPS q: (dx - dx0, dy, m16 tile), the
    // tile fastest
    const int nitems = kxg * KY * mtiles;
    const int nq = nitems > warp ? (nitems - warp + WT_WARPS - 1) / WT_WARPS : 0;
    // (dx - dx0) << 16 | the offset of the item's rows in a staged plane,
    // read back (volatile: not hoisted into registers) at each k8 step:
    // registers are what bounds the items a warp holds
    __shared__ int s_item[WT_WARPS][WT_IPW];
    const volatile int* const items = s_item[warp];
    if (lane < WT_IPW) {
        const int it = warp + WT_WARPS * lane;
        const int m = it % mtiles, dy = (it / mtiles) % KY;
        s_item[warp][lane] = (it / (mtiles * KY)) << 16 | (dy * WTZ * P + 16 * m);
    }
    float acc[WT_IPW][NT][4];
#pragma unroll
    for (int q = 0; q < WT_IPW; ++q)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[q][n][e] = 0.0f;

    // fragment element offsets: A (rows channels, columns cells) at t*P +
    // g, B (rows cells, columns d's channels) at t*DP + g
    const int a_lane = t * P + g, b_lane = t * DP + g;
    for (int j = 0; j < kxg + nbuf - 2; ++j) issue(j);
    for (int s = 0; s < x1 - x0; ++s) {
        issue(s + kxg + nbuf - 2);
        ring_wait(nbuf);
        // item q reads g plane x + dx, in ring slot (s + dx - dx0) % ring
        const int sr = s % ring;
        const float* sd = s_d + (s % nbuf) * DPLANE + b_lane;
#pragma unroll 1
        for (int ly = 0; ly < WTY; ++ly) {
            // the k8 step's B fragments, split once for all the items
            uint32_t bb[NT][2], bs[NT][2];
            const float* brow = sd + ly * WTZ * DP;
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const float v = brow[i * 4 * DP + 8 * n];
                    bb[n][i] = tf32_rna(v);
                    bs[n][i] = tf32_rna(v - __uint_as_float(bb[n][i]));
                }
#pragma unroll
            for (int q = 0; q < WT_IPW; ++q) {
                if (q >= nq) break;
                const int item = items[q];
                int slot = sr + (item >> 16);
                slot = slot >= ring ? slot - ring : slot;
                const float* a = s_g + slot * GPLANE + (item & 0xffff) + a_lane + ly * WTZ * P;
                const uint32_t raw[4] = {__float_as_uint(a[0]), __float_as_uint(a[8]),
                                         __float_as_uint(a[4 * P]),
                                         __float_as_uint(a[4 * P + 8])};
                uint32_t ab[4], as[4];
                split_tf32(raw, ab, as);
                // one chain: the step's three products
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                    float part[4];
                    mma_tf32_first(part, as, bb[n][0], bb[n][1]);
                    mma_tf32(part, ab, bs[n][0], bs[n][1]);
                    mma_tf32(part, ab, bb[n][0], bb[n][1]);
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[q][n][e] += part[e];
                }
            }
        }
        __syncthreads();  // the slots are refilled on the next steps
    }

    const size_t nw = (size_t)p.kx * KY * p.kp * p.np;
    float* part = p.partial + (size_t)chunk * nw;
#pragma unroll
    for (int q = 0; q < WT_IPW; ++q) {
        if (q >= nq) break;
        const int it = warp + WT_WARPS * q;
        const int m = it % mtiles, dy = (it / mtiles) % KY, dx = dx0 + it / (mtiles * KY);
        const int row = c0 + 16 * m + g;
        const size_t base = (((size_t)dx * KY + dy) * p.kp + row) * p.np;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const int o = n0 + 8 * n + 2 * t;
            *reinterpret_cast<float2*>(part + base + o) = make_float2(acc[q][n][0], acc[q][n][1]);
            *reinterpret_cast<float2*>(part + base + 8 * p.np + o) =
                make_float2(acc[q][n][2], acc[q][n][3]);
        }
    }
}

template <int KY, int NT>
cudaError_t launch_wgrad_tf32(const TapWgradTf32Params& p, int nchunk, cudaStream_t stream) {
    const size_t smem = wgrad_tf32_smem(p.kxb, KY, p.mc, NT, p.nbuf);
    const cudaError_t e = set_smem((const void*)tap_wgrad_tf32_kernel<KY, NT>, smem);
    if (e != cudaSuccess) return e;
    const int nch = (p.kp / 16 + p.mc - 1) / p.mc, ndx = (p.kx + p.kxb - 1) / p.kxb;
    const dim3 grid(nch * ndx, p.np / (8 * NT), nchunk);
    tap_wgrad_tf32_kernel<KY, NT><<<grid, WT_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

#define INS_WGRAD_TF32_NT(KY)                                         \
    switch (nt) {                                                     \
        case 1: return launch_wgrad_tf32<KY, 1>(p, nchunk, s);        \
        case 2: return launch_wgrad_tf32<KY, 2>(p, nchunk, s);        \
        case 3: return launch_wgrad_tf32<KY, 3>(p, nchunk, s);        \
        default: return cudaErrorInvalidValue;                        \
    }

cudaError_t wgrad_tf32(int ky, int nt, const TapWgradTf32Params& p, int nchunk,
                       cudaStream_t s) {
    switch (ky) {
        case 1: INS_WGRAD_TF32_NT(1)
        case 3: INS_WGRAD_TF32_NT(3)
        case 5: INS_WGRAD_TF32_NT(5)
        case 7: INS_WGRAD_TF32_NT(7)
        default: return cudaErrorInvalidValue;
    }
}

#undef INS_WGRAD_TF32_NT

// a float32 field the kernel stages 16 bytes a copy
bool stageable4(const void* p, int c) { return c % 4 == 0 && ((uintptr_t)p & 15) == 0; }

}  // namespace

// The weight gradient in 3xTF32 on the tensor cores: g (nxp, nyp, nz, kc)
// and d (nxp-kx+1, nyp-ky+1, nz, cd) float32 (kc and cd multiples of 4,
// 16-byte aligned); dwp the float32 gradient (kx, ky, kp, np), partial
// (nchunk, kx, ky, kp, np) float32 scratch; the plan (kp, nt, np, mc, kxb,
// nbuf, xb, nchunk) as `ops/conv_kernels.py` `tap_wgrad_tf32_plan`
// computes it: kp = kc rounded up to 16, np = cd padded to a multiple of
// 8*nt (nt <= 3), mc m16 channel tiles a block (at most 8), kxb dx taps a
// block (kxb * ky * mc <= 8 * 7 items), nbuf cotangent buffers (the shared
// memory within a block's), xb output planes a cell chunk of 8 (y) x 8 (z)
// cells, nchunk the cell chunks.
extern "C" int ins_tapconv_wgrad_tf32(const void* g, const void* d, float* partial, float* dwp,
                                      int nxp, int nyp, int nz, int kc, int cd, int kx, int ky,
                                      int kp, int nt, int np, int mc, int kxb, int nbuf, int xb,
                                      int nchunk, void* stream) {
    const int nx = nxp - kx + 1, ny = nyp - ky + 1;
    if (kx < 1 || nx < 1 || ny < 1 || nz < 1 || kc < 4 || kp != (kc + 15) / 16 * 16 ||
        nt < 1 || nt > WT_MAXNT || np % (8 * nt) != 0 || np < cd || np - 8 * nt >= cd ||
        mc < 1 || mc > kp / 16 || mc > WT_MAXMC || kxb < 1 || kxb > kx ||
        kxb * ky * mc > WT_WARPS * WT_IPW || (nbuf != 2 && nbuf != 3) ||
        wgrad_tf32_smem(kxb, ky, mc, nt, nbuf) > WT_SMEM_MAX || xb < 1 ||
        nchunk != (nx + xb - 1) / xb * ((ny + WTY - 1) / WTY) * ((nz + WTZ - 1) / WTZ) ||
        !stageable4(g, kc) || !stageable4(d, cd))
        return (int)cudaErrorInvalidValue;
    const TapWgradTf32Params p{static_cast<const float*>(g), static_cast<const float*>(d),
                               partial, nxp, nyp, nz, kc, cd, kx, kp, np, mc, kxb, xb, nbuf};
    const cudaStream_t s = (cudaStream_t)stream;
    const cudaError_t e = wgrad_tf32(ky, nt, p, nchunk, s);
    if (e != cudaSuccess) return (int)e;
    const size_t nw = (size_t)kx * ky * kp * np;
    reduce_partials_kernel<<<(unsigned)((nw + 255) / 256), 256, 0, s>>>(partial, dwp, nchunk, nw);
    return (int)cudaGetLastError();
}
