// The pack-tile convolution of the CNN closure's z-folded layer on
// float32 operands, forward (with bias and tanh/identity fused in):
//
//   out[x, y, z, o] = act(b[o] + sum_{dx<kx, dy<ky, c<kc} g[x+dx, y+dy, z, c]
//                                                         * w2[dx, dy, c, o])
//
// g is (nxp, nyp, nz, kc) channels last with the z taps already folded
// into kc and x, y padded by kx-1, ky-1: a VALID correlation over (x, y)
// with z a batch axis; out is (nxp-kx+1, nyp-ky+1, nz, cout).  g and w2
// are float32 (the loads also widen a bf16 g exactly), out float32 or
// bfloat16.  Every sum is taken in float32.  The other routes: the tap
// forward and the weight gradient on float32 operands are tapconv_tf32.cu
// and tapwgrad_tf32.cu (3xTF32 on the tensor cores); bf16 operands run
// tapconv_mma.cu (forwards) and tapwgrad_mma.cu (weight gradient).
//
// Replaces: for float32 operands, `_packconv_kernel`
// (ins_tpu/ops/convkernels.py:387, wrapper `packconv_3d` :471).  The TPU
// kernel needs kc and nz in 128-lane multiples, emits lane-padded outputs,
// carries a ring of g planes and of product planes across the sequential
// x grid and collapses the packed tap lanes with a block-sum matmul; none
// of that carries over: this kernel takes any kc, nz and cout and emits
// cout channels.
//
// What bounds it on an H100: FP32 FMA issue, as in conv.cu's float32
// route.  The 24 -> 24 layer at 128^3 is 2 * 25 * 120 * 24 * 128^3 = 302
// GFLOP (4.5 ms at the 67 TFLOP/s FP32 peak) against 0.3 GB of compulsory
// traffic.  Weight-first, as the TPU kernel: phase 1 forms every input
// plane's products with all taps once, P[p, (y, z), (dx, dy, o)] = sum_c
// g[p, y, z, c] w2[dx, dy, c, o], a dense product (M = nyp nz rows, K =
// kc, N = kx ky cout) by a 128 x 128 shared-memory tiled FP32 GEMM into a
// float32 scratch ring of S planes (the TPU kernel keeps its partials in
// float32 too: bf16 ones measured 5e-2 off); phase 2 forms out[x, y] =
// act(b + sum_{dx,dy} P[x+dx, (y+dy, z), (dx, dy, o)]), a plane's products
// serving the kx output planes that read it.  The host walks x in chunks
// of S - kx + 1 output planes, two launches each; the ring slot of plane p
// is p % S, so the kx - 1 planes a chunk shares with the next are kept,
// not recomputed.  Where kc % 8 == 0 (and g is 16-byte aligned), g is
// staged eight values a load; the scalar loads of the other shapes cost
// several times more.

#include <cstdint>

#include "convio.cuh"  // load_val

namespace {

constexpr int PM = 128;          // pack products: rows per block
constexpr int PN = 128;          // pack products: columns per block
constexpr int PK = 8;            // pack products: depth staged per pass
constexpr int PPAD = PM + 4;     // its shared row stride (conflict-free stores)

// p[i .. i + 8) widened; i a multiple of 8 and p 16-byte aligned
__device__ __forceinline__ void load8(const void* p, size_t i, int bf16, float (&v)[8]) {
    if (bf16) {
        const uint4 q = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p) + i);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const float2 f = __bfloat1622float2(h[k]);
            v[2 * k] = f.x;
            v[2 * k + 1] = f.y;
        }
    } else {
        const float4* q = reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
        const float4 a = q[0], b = q[1];
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
}

__device__ __forceinline__ void store_val(void* p, size_t i, float v, int bf16) {
    if (bf16)
        static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
    else
        static_cast<float*>(p)[i] = v;
}

struct PackParams {
    const void* g;
    int g_bf16;
    int vec;            // 8-value loads of g, as WgradParams::vec
    const float* ws;    // (kc, N): ws[c, (dx * ky + dy) * cout + o] = w2[dx, dy, c, o]
    const float* bias;  // may be null
    int act;
    float* P;           // (slots, nyp * nz, N) float32 ring of plane products
    int slots;
    void* out;
    int out_bf16;
    int nxp, nyp, nz, kc, kx, ky, cout;
};

// Phase 1: rows [row0, row0 + nrows) of g (row = (plane, y, z)) times ws
// into the ring: row (p, r) lands at P[p % slots, r].  A 256-thread block
// owns a 128 x 128 tile of P; each thread 8 x 8 of it, as rows
// {ty*4 + i, 64 + ty*4 + i} and columns {tx*4 + j, 64 + tx*4 + j} so that
// its float4 reads of shared memory are broadcasts or contiguous.
__global__ void __launch_bounds__(256)
pack_products_kernel(const __grid_constant__ PackParams p, long long row0, long long nrows) {
    __shared__ __align__(16) float sa[PK][PPAD];  // sa[k][m]
    __shared__ __align__(16) float sb[PK][PPAD];  // sb[k][n]
    const int kc = p.kc, N = p.kx * p.ky * p.cout;
    const long long R = (long long)p.nyp * p.nz;
    const long long m0 = (long long)blockIdx.x * PM;
    const int n0 = blockIdx.y * PN;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < kc; k0 += PK) {
        __syncthreads();
        if (p.vec) {  // a row's PK values in one 16-byte load
            if (tid < PM) {
                float v[PK] = {};
                if (m0 + tid < nrows) load8(p.g, (size_t)(row0 + m0 + tid) * kc + k0, p.g_bf16, v);
#pragma unroll
                for (int kk = 0; kk < PK; ++kk) sa[kk][tid] = v[kk];
            }
        } else {
#pragma unroll
            for (int i = 0; i < PM * PK / 256; ++i) {
                const int e = tid + i * 256;
                const int kk = e % PK, mm = e / PK;
                const long long m = m0 + mm;
                const int k = k0 + kk;
                float v = 0.0f;
                if (m < nrows && k < kc) v = load_val(p.g, (size_t)(row0 + m) * kc + k, p.g_bf16);
                sa[kk][mm] = v;
            }
        }
#pragma unroll
        for (int i = 0; i < PN * PK / 256; ++i) {
            const int e = tid + i * 256;
            const int nn = e % PN, kk = e / PN;
            const int n = n0 + nn, k = k0 + kk;
            sb[kk][nn] = (n < N && k < kc) ? __ldg(p.ws + (size_t)k * N + n) : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < PK; ++kk) {
            float a[8], b[8];
            const float4 a0 = *reinterpret_cast<const float4*>(&sa[kk][ty * 4]);
            const float4 a1 = *reinterpret_cast<const float4*>(&sa[kk][64 + ty * 4]);
            const float4 b0 = *reinterpret_cast<const float4*>(&sb[kk][tx * 4]);
            const float4 b1 = *reinterpret_cast<const float4*>(&sb[kk][64 + tx * 4]);
            a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
            a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
            b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
            b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const long long m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
        if (m >= nrows) continue;
        const long long gm = row0 + m;
        const long long dst = ((gm / R) % p.slots * R + gm % R) * N;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
            if (n < N) p.P[dst + n] = acc[i][j];
        }
    }
}

// Phase 2: output planes [x0, x1), one thread per output value; the taps
// are added in the order (dx, dy).
__global__ void __launch_bounds__(256)
pack_combine_kernel(const __grid_constant__ PackParams p, int x0, int x1) {
    const int nz = p.nz, ky = p.ky, cout = p.cout;
    const int ny = p.nyp - ky + 1, N = p.kx * ky * cout;
    const size_t R = (size_t)p.nyp * nz;
    const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (size_t)(x1 - x0) * ny * nz * cout) return;
    const int co = (int)(idx % cout);
    const size_t cell = idx / cout;
    const int z = (int)(cell % nz);
    const size_t rest = cell / nz;
    const int y = (int)(rest % ny), x = x0 + (int)(rest / ny);
    float s = 0.0f;
    for (int dx = 0; dx < p.kx; ++dx) {
        const float* P = p.P + (size_t)((x + dx) % p.slots) * R * N;
        for (int dy = 0; dy < ky; ++dy)
            s += P[((size_t)(y + dy) * nz + z) * N + (dx * ky + dy) * cout + co];
    }
    if (p.bias) s += __ldg(p.bias + co);
    if (p.act == 1) s = tanhf(s);
    store_val(p.out, (size_t)x0 * ny * nz * cout + idx, s, p.out_bf16);
}

// Whether every cell's channels start 16-byte aligned, in chunks of 8.
int aligned8(const void* g, int kc) {
    return kc % 8 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
}

}  // namespace

// The pack forward: out (nxp-kx+1, nyp-ky+1, nz, cout); ws the packed
// weights (kc, kx * ky * cout); P a float32 scratch of `slots` planes of
// nyp * nz * kx * ky * cout (slots >= kx).  Walks x in chunks of
// slots - kx + 1 output planes: phase 1 on the chunk's new input planes,
// then phase 2, two launches each.
extern "C" int ins_packconv(const void* g, int g_bf16, const float* ws, const float* bias,
                            int act, float* P, int slots, void* out, int out_bf16, int nxp,
                            int nyp, int nz, int kc, int kx, int ky, int cout, void* stream) {
    if (kx < 1 || ky < 1 || nxp < kx || nyp < ky || kc < 1 || cout < 1 || slots < kx)
        return (int)cudaErrorInvalidValue;
    const PackParams p{g, g_bf16, aligned8(g, kc), ws, bias, act, P, slots, out, out_bf16,
                       nxp, nyp, nz, kc, kx, ky, cout};
    const cudaStream_t s = (cudaStream_t)stream;
    const int nx = nxp - kx + 1, ny = nyp - ky + 1, xc = slots - kx + 1;
    const int N = kx * ky * cout;
    const long long R = (long long)nyp * nz;
    int done = 0;  // input planes whose products are in the ring
    for (int x0 = 0; x0 < nx; x0 += xc) {
        const int x1 = x0 + xc < nx ? x0 + xc : nx, hi = x1 + kx - 1;
        const long long nrows = (hi - done) * R;
        const dim3 grid((unsigned)((nrows + PM - 1) / PM), (N + PN - 1) / PN);
        pack_products_kernel<<<grid, 256, 0, s>>>(p, done * R, nrows);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        done = hi;
        const size_t total = (size_t)(x1 - x0) * ny * nz * cout;
        pack_combine_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(p, x0, x1);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return 0;
}
