// The weight gradient of the CNN closure's z-folded tap layer on the
// tensor cores (bf16 operands, `mma.sync.m16n8k16` with float32 sums):
//
//   dW[dx, dy, c, o] = sum_{x, y, z} g[x+dx, y+dy, z, c] * d[x, y, z, o]
//
// g is (nxp, nyp, nz, kc) bf16 with the z taps folded into kc (a multiple
// of 8: the wrapper pads with zero channels) and x, y padded by kx-1, ky-1;
// d, the pre-activation cotangent rounded to bf16, is (nxp-kx+1, nyp-ky+1,
// nz, cd) (cd a multiple of 8, likewise).  dW is float32.  The float32
// route is tapwgrad_tf32.cu (3xTF32 on the tensor cores).
//
// Replaces: for bf16 operands, `_wgrad_kernel` (ins_tpu/ops/convkernels.py:191,
// wrapper `tapconv_wgrad_3d` :249).
//
// An implicit GEMM per tap: dW[dx, dy] (kp x np) = sum_cells A^T B with A
// the staged g rows (cells x channels) of plane x + dx, row y + dy, and B
// the cotangent rows (cells x channels) of plane x, row y; M = the
// channels kc padded to kp (m16 tiles), N = cd in blocks of 8*NT columns
// (NT <= 3 n8 tiles), K = the cells, 16 (one z row of the tile) a step.
// A is `ldmatrix.x4.trans` on the staged g rows, B `ldmatrix.x2.trans` on
// the staged cotangent rows, as in conv.cu's `wgrad_mma_kernel`.
//
// What bounds it on an H100: the 24 -> 24 layer at 128^3 is 302 GFLOP (0.31
// ms at the 989 TFLOP/s bf16 peak) against 0.64 GB of compulsory traffic,
// so the tensor cores and the shared-memory reads that feed them.  The
// z-folded g is five times the unfolded field (535 MB at 24 -> 24), so a
// design that restages g for each dx moves ~4 GB from L2.  Here a block
// owns a chunk of mc m16 channel tiles, one block of output columns and
// 8 (y) x 16 (z) cells over a run of x-planes, and walks the run with a
// ring of kx + nbuf - 1 staged g planes: each g plane is staged once and
// feeds every dx whose output it meets (plane p meets output x = p - dx),
// so g leaves L2 about once (times the y halo and the run's x ramp).  Its
// (dx, dy, m16 tile) items are spread over the 8 warps (at most IPW = 7
// each, the channel chunk chosen so that they fit: 50 items at 5 x 5
// taps), each with NT accumulator tiles; per cotangent row a warp loads
// the B fragments once and feeds them to all of its items.  Two blocks an
// SM (16 warps) are worth the most (one measured 40 % slower), so
// registers bound the design: the items' (dx, row offset) pairs live in
// shared memory, and a thread's staging state is two offsets.  The
// accumulators chain the block's cells in the tensor cores (as conv.cu's
// wgrad, whose chains measured 7.9e-6 of max|dw| at 128^3 against a
// float64 sum).  Each block writes float32
// partials; `reduce_partials_kernel` adds them in a fixed order (no
// atomics: the same result on every run).

#include <cstdint>

#include "convio.cuh"  // bf16, cp.async, ldmatrix, mma_bf16, ring helpers

namespace {

constexpr int WG_THREADS = 256;  // 8 warps
constexpr int WG_WARPS = WG_THREADS / 32;
constexpr int GTY = 8;           // cotangent rows (y) a block
constexpr int GTZ = 16;          // cells (z) a row: one k16 step
constexpr int WMAXNT = 3;        // n8 tiles of output columns a block, at most
constexpr int IPW = 7;           // (dx, dy, m16 tile) items a warp, at most
constexpr int WMAXMC = 8;        // m16 channel tiles a block, at most (a row's units, 16 mc,
                                 // fit the threads)
constexpr size_t SMEM_MAX = 232448;  // shared memory a block may use

struct TapWgradMmaParams {
    const bf16* g;   // (nxp, nyp, nz, kc)
    const bf16* d;   // (nxp - kx + 1, nyp - ky + 1, nz, cd)
    float* partial;  // (nchunk, kx, ky, kp, np)
    int nxp, nyp, nz, kc, cd, kx;
    int kp, np;      // kc rounded up to 16; cd padded to nblk * 8*NT
    int mc;          // m16 channel tiles a block
    int xb;          // output planes a cell chunk
    int nbuf;        // cotangent planes in the ring (and g planes in flight + 1)
};

// Shared memory of a block: the ring of kx + nbuf - 1 g planes ((GTY + ky
// - 1) rows x GTZ cells x 16 mc + 8 channels: an odd number of 16-byte
// units a cell) and nbuf cotangent planes (GTY x GTZ cells x mma_pitch(nt)).
__host__ __device__ constexpr size_t wgrad_mma_smem(int kx, int ky, int mc, int nt, int nbuf) {
    return sizeof(bf16) * ((size_t)(kx + nbuf - 1) * (GTY + ky - 1) * GTZ * (16 * mc + 8) +
                           (size_t)nbuf * GTY * GTZ * mma_pitch(nt));
}

// Blocks an SM the launch bounds ask for: two (at most 128 registers a
// thread), but one where ptxas spilled at 128 (two n8 tiles, and ky = 1
// with more than one; build.log).  `ops/conv_kernels.py` `_wgrad_sm_blocks`
// is the same rule.
__host__ __device__ constexpr int wgrad_sm_blocks(int ky, int nt) {
    return nt == 2 || (ky == 1 && nt > 1) ? 1 : 2;
}

__device__ __forceinline__ void ldsm_x4_trans_a(uint32_t (&r)[4], unsigned addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_trans_a(uint32_t (&r)[2], unsigned addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(addr));
}

__device__ __forceinline__ void zero16(bf16* dst) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

template <int KY, int NT>
__global__ void __launch_bounds__(WG_THREADS, wgrad_sm_blocks(KY, NT))
tap_wgrad_mma_kernel(const __grid_constant__ TapWgradMmaParams p) {
    constexpr int ROWS = GTY + KY - 1;
    constexpr int WP = mma_pitch(NT);
    constexpr int DPLANE = GTY * GTZ * WP;
    extern __shared__ uint4 smem_u4[];
    bf16* smem = reinterpret_cast<bf16*>(smem_u4);
    const int kx = p.kx, nbuf = p.nbuf, ring = kx + nbuf - 1;
    const int P = 16 * p.mc + 8;  // staged pitch of a cell's channels
    const int GPLANE = ROWS * GTZ * P;
    bf16* s_g = smem;                 // ring of g planes
    bf16* s_d = smem + ring * GPLANE;  // nbuf cotangent planes
    const int nx = p.nxp - kx + 1, ny = p.nyp - KY + 1;
    const int mt0 = blockIdx.x * p.mc, mtiles = min(p.mc, p.kp / 16 - mt0);
    const int c0 = 16 * mt0;          // the chunk's first channel
    const int n0 = blockIdx.y * 8 * NT;
    const int ytiles = (ny + GTY - 1) / GTY, ztiles = (p.nz + GTZ - 1) / GTZ;
    const int chunk = blockIdx.z;
    const int zt = chunk % ztiles, yt = (chunk / ztiles) % ytiles, xg = chunk / (ztiles * ytiles);
    const int y0 = yt * GTY, z0 = zt * GTZ;
    const int x0 = xg * p.xb, x1 = min(nx, x0 + p.xb);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int nload = x1 - x0 + kx - 1;  // g planes the run stages

    // g staging: a thread owns one (cell, 16-byte unit) of a row and stages
    // it in every rstep-th row; its offsets, in a staged row and in a g row
    // (-1: zeros, the cell or channels past the field), computed once
    const int units = 2 * mtiles, cell_units = GTZ * units;
    const int rstep = WG_THREADS / cell_units, r0 = tid / cell_units;
    const int g_soff = (tid % cell_units) / units * P + 8 * (tid % units);
    const int g_goff = z0 + (tid % cell_units) / units < p.nz && c0 + 8 * (tid % units) < p.kc
                           ? (z0 + (tid % cell_units) / units) * p.kc + c0 + 8 * (tid % units)
                           : -1;
    // load step j: g plane x0 + j; with it, from j = kx - 1, cotangent plane
    // x0 + j - (kx - 1)
    auto issue = [&](int j) {
        if (j < nload) {
            bf16* dst = s_g + (j % ring) * GPLANE + g_soff;
            const bf16* src = p.g + ((size_t)(x0 + j) * p.nyp + y0) * p.nz * p.kc + max(g_goff, 0);
            for (int r = r0; r < ROWS && r0 < rstep; r += rstep) {
                if (y0 + r < p.nyp && g_goff >= 0)
                    cp_async16(dst + r * GTZ * P, src + (size_t)r * p.nz * p.kc);
                else
                    zero16(dst + r * GTZ * P);
            }
            const int xd = j - (kx - 1);
            if (xd >= 0) {
                bf16* sd = s_d + (xd % nbuf) * DPLANE;
                for (int u = tid; u < GTY * GTZ * NT; u += WG_THREADS) {
                    const int t = u % NT, cell = u / NT;
                    const int y = y0 + cell / GTZ, z = z0 + cell % GTZ, n = n0 + 8 * t;
                    if (y < ny && z < p.nz && n < p.cd)  // cells past the box add 0
                        cp_async16(sd + cell * WP + 8 * t,
                                   p.d + (((size_t)(x0 + xd) * ny + y) * p.nz + z) * p.cd + n);
                    else
                        zero16(sd + cell * WP + 8 * t);
                }
            }
        }
        cp_async_commit();
    };

    // the warp's items it = warp + WG_WARPS q: (dx, dy, m16 tile), the tile fastest
    const int nitems = kx * KY * mtiles;
    const int nq = nitems > warp ? (nitems - warp + WG_WARPS - 1) / WG_WARPS : 0;
    // (dx << 16) | the offset of the item's rows in a staged plane, read
    // back at each plane (registers are what bounds the items a warp holds)
    __shared__ int s_item[WG_WARPS][IPW];
    if (lane < IPW) {
        const int it = warp + WG_WARPS * lane;
        const int m = it % mtiles, dy = (it / mtiles) % KY;
        s_item[warp][lane] = (it / (mtiles * KY)) << 16 | (dy * GTZ * P + 16 * m);
    }
    float acc[IPW][NT][4];
#pragma unroll
    for (int q = 0; q < IPW; ++q)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[q][t][e] = 0.0f;

    // ldmatrix.trans row addresses: A's stored rows are cells (lanes 0-7 and
    // 8-15: cells 0-7, channels +0 and +8; lanes 16-31: cells 8-15), B's
    // stored rows are cells (lanes 0-15)
    const unsigned a_lane =
        smem_addr(s_g) + 2 * (((lane & 7) + 8 * (lane >> 4)) * P + 8 * ((lane >> 3) & 1));
    const unsigned b_lane = smem_addr(s_d) + 2 * (lane & 15) * WP;
    for (int j = 0; j < kx + nbuf - 2; ++j) issue(j);
    for (int s = 0; s < x1 - x0; ++s) {
        issue(s + kx + nbuf - 2);
        ring_wait(nbuf);
        // item q reads g plane x + dx, in ring slot (s + dx) % ring
        const int sr = s % ring;
        unsigned ga[IPW];
#pragma unroll
        for (int q = 0; q < IPW; ++q) {
            const int item = s_item[warp][q];
            int slot = sr + (item >> 16);
            slot = slot >= ring ? slot - ring : slot;
            ga[q] = a_lane + 2 * (slot * GPLANE + (item & 0xffff));
        }
        const unsigned sd = b_lane + 2 * (s % nbuf) * DPLANE;
#pragma unroll 1
        for (int ly = 0; ly < GTY; ++ly) {
            uint32_t b[NT][2];
#pragma unroll
            for (int t = 0; t < NT; ++t) ldsm_x2_trans_a(b[t], sd + 2 * (ly * GTZ * WP + 8 * t));
#pragma unroll
            for (int q = 0; q < IPW; ++q) {
                if (q >= nq) break;
                uint32_t a[4];
                ldsm_x4_trans_a(a, ga[q] + 2 * ly * GTZ * P);
#pragma unroll
                for (int t = 0; t < NT; ++t) mma_bf16(acc[q][t], a, b[t]);
            }
        }
        __syncthreads();  // the slots are refilled on the next steps
    }

    const size_t nw = (size_t)kx * KY * p.kp * p.np;
    float* part = p.partial + (size_t)chunk * nw;
#pragma unroll
    for (int q = 0; q < IPW; ++q) {
        if (q >= nq) break;
        const int it = warp + WG_WARPS * q;
        const int m = it % mtiles, dy = (it / mtiles) % KY, dx = it / (mtiles * KY);
        const int row = c0 + 16 * m + (lane >> 2);
        const size_t base = (((size_t)dx * KY + dy) * p.kp + row) * p.np;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
            const int n = n0 + 8 * t + 2 * (lane & 3);
            *reinterpret_cast<float2*>(part + base + n) = make_float2(acc[q][t][0], acc[q][t][1]);
            *reinterpret_cast<float2*>(part + base + 8 * p.np + n) =
                make_float2(acc[q][t][2], acc[q][t][3]);
        }
    }
}

template <int KY, int NT>
cudaError_t launch_wgrad_mma(const TapWgradMmaParams& p, int nchunk, cudaStream_t stream) {
    const size_t smem = wgrad_mma_smem(p.kx, KY, p.mc, NT, p.nbuf);
    const cudaError_t e = set_smem((const void*)tap_wgrad_mma_kernel<KY, NT>, smem);
    if (e != cudaSuccess) return e;
    const int nch = (p.kp / 16 + p.mc - 1) / p.mc;
    const dim3 grid(nch, p.np / (8 * NT), nchunk);
    tap_wgrad_mma_kernel<KY, NT><<<grid, WG_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

#define INS_WGRAD_NT(KY)                                            \
    switch (nt) {                                                   \
        case 1: return launch_wgrad_mma<KY, 1>(p, nchunk, s);       \
        case 2: return launch_wgrad_mma<KY, 2>(p, nchunk, s);       \
        case 3: return launch_wgrad_mma<KY, 3>(p, nchunk, s);       \
        default: return cudaErrorInvalidValue;                      \
    }

cudaError_t wgrad_mma(int ky, int nt, const TapWgradMmaParams& p, int nchunk, cudaStream_t s) {
    switch (ky) {
        case 1: INS_WGRAD_NT(1)
        case 3: INS_WGRAD_NT(3)
        case 5: INS_WGRAD_NT(5)
        case 7: INS_WGRAD_NT(7)
        default: return cudaErrorInvalidValue;
    }
}

#undef INS_WGRAD_NT

}  // namespace

// The weight gradient on the tensor cores: g (nxp, nyp, nz, kc) and d
// (nxp-kx+1, nyp-ky+1, nz, cd) bf16 (kc and cd multiples of 8, 16-byte
// aligned); dwp the float32 gradient (kx, ky, kp, np), partial (nchunk,
// kx, ky, kp, np) float32 scratch; the plan (kp, nt, np, mc, nbuf, xb,
// nchunk) as `ops/conv_kernels.py` `tap_wgrad_plan` computes it: kp = kc
// rounded up to 16, np = cd padded to a multiple of 8*nt (nt <= 3), mc
// m16 channel tiles a block (at most 8, kx * ky * mc <= 8 * 7 items and
// the shared memory within a block's), xb output planes a cell chunk of 8 (y) x 16
// (z) cells, nchunk the cell chunks.
extern "C" int ins_tapconv_wgrad_mma(const void* g, const void* d, float* partial, float* dwp,
                                     int nxp, int nyp, int nz, int kc, int cd, int kx, int ky,
                                     int kp, int nt, int np, int mc, int nbuf, int xb,
                                     int nchunk, void* stream) {
    const int nx = nxp - kx + 1, ny = nyp - ky + 1;
    if (kx < 1 || nx < 1 || ny < 1 || nz < 1 || kc < 8 || kp != (kc + 15) / 16 * 16 ||
        nt < 1 || nt > WMAXNT || np % (8 * nt) != 0 || np < cd || np - 8 * nt >= cd ||
        mc < 1 || mc > kp / 16 || mc > WMAXMC || kx * ky * mc > WG_WARPS * IPW ||
        (nbuf != 2 && nbuf != 3) ||
        wgrad_mma_smem(kx, ky, mc, nt, nbuf) > SMEM_MAX || xb < 1 ||
        nchunk != (nx + xb - 1) / xb * ((ny + GTY - 1) / GTY) * ((nz + GTZ - 1) / GTZ) ||
        !stageable(g, kc) || !stageable(d, cd))
        return (int)cudaErrorInvalidValue;
    const TapWgradMmaParams p{static_cast<const bf16*>(g), static_cast<const bf16*>(d), partial,
                              nxp, nyp, nz, kc, cd, kx, kp, np, mc, xb, nbuf};
    const cudaStream_t s = (cudaStream_t)stream;
    const cudaError_t e = wgrad_mma(ky, nt, p, nchunk, s);
    if (e != cudaSuccess) return (int)e;
    const size_t nw = (size_t)kx * ky * kp * np;
    reduce_partials_kernel<<<(unsigned)((nw + 255) / 256), 256, 0, s>>>(partial, dwp, nchunk, nw);
    return (int)cudaGetLastError();
}
