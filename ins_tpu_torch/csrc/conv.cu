// Periodic k^3 convolution layer of the CNN closure, forward (with bias
// and tanh/identity fused in) and weight gradient.
//
//   out[x, y, z, o] = act(b[o] + sum_{dx,dy,dz,c} h[x+dx-r, y+dy-r, z+dz-r, c]
//                                               * w[dx, dy, dz, c, o])
//   dw[dx, dy, dz, c, o] = sum_{x,y,z} h[x+dx-r, y+dy-r, z+dz-r, c] * d[x, y, z, o]
//
// on a periodic (nx, ny, nz) box (indices wrap), channels last: h is
// (nx, ny, nz, cin) in float32 or bfloat16, d (nx, ny, nz, cout) likewise,
// w canonical (k, k, k, cin, cout) float32 (the wrapper rounds it to h's
// type first), out (nx, ny, nz, cout) in float32 or bfloat16.  Every sum
// is taken in float32; bf16 operands are widened exactly, so their
// products are exact and a kernel differs from a float32 reference on the
// same rounded operands only in the order of its sums.  The input
// gradient of a layer is the forward kernel on d with the taps flipped and
// transposed (w'[dx, dy, dz, o, c] = w[k-1-dx, k-1-dy, k-1-dz, c, o]).
//
// Replaces: `_fusedconv_kernel` (ins_tpu/ops/convkernels.py:687, wrapper
// `fusedconv_3d` :780, forward and input gradient) and
// `_fused_wgrad_kernel` (:840, wrapper `fusedconv_wgrad_3d` :918).  The
// TPU kernels fold the z taps into a 128-lane contraction for the MXU and
// carry a ring of per-plane partial products across the sequential grid;
// none of that layout carries over.
//
// What bounds it on an H100: FP32 FMA issue.  A 24 -> 24 layer at 128^3
// with k = 5 is 2 * 125 * 576 * 128^3 = 302 GFLOP against 0.2 GB of
// compulsory traffic, so the kernels are built to keep the FMA pipes fed
// from registers:
//
// - forward: a block of 32 (z) x 4 (y) threads owns a 32 x 16 output tile
//   of one x-plane and a tile of COT output channels.  For each x-tap and
//   each chunk of 8 input channels it stages the input window (tile plus
//   halo, channel-major, conflict-free for the reads) and that x-tap's
//   weights in shared memory.  A thread holds CY = 4 y-rows x COT channels
//   of accumulators, loads a column of CY + k - 1 inputs once per
//   (z-tap, channel) and reuses it across the k y-taps: 8 + 2k shared
//   loads per 32k FMA at COT = 8.
// - weight gradient: a block owns one x-tap, a tile of COT output channels
//   and a chunk of cells (8 y x 16 z over a run of x-planes); each thread
//   owns RPT = 8 rows (dy, dz, c) of dw for those COT channels and walks
//   the staged cells: 8 + 2 shared loads per 64 FMA.  Each block writes
//   its partial sums; a second kernel adds the partials of every weight in
//   a fixed order, so the result is the same on every run (no atomics).

#include "convio.cuh"   // load_val, load_vec, reduce_partials_kernel
#include "stencil.cuh"  // wrap

namespace {

constexpr int BZ = 32;         // forward: threads along z (one warp)
constexpr int BY = 4;          // forward: threads along y
constexpr int CY = 4;          // forward: y-rows per thread
constexpr int TYO = BY * CY;   // forward: output tile extent in y
constexpr int CC = 8;          // forward: input channels staged per pass
constexpr int WTY = 8;         // wgrad: cell tile extent in y
constexpr int WTZ = 16;        // wgrad: cell tile extent in z
constexpr int RPT = 8;         // wgrad: dw rows per thread
constexpr int WCHUNKS = 256;   // wgrad: target number of cell chunks
constexpr int WMAXT = 256;     // wgrad: most threads per block

struct ConvParams {
    const void* h;
    int h_bf16;
    const float* w;
    const float* bias;  // may be null
    int act;            // 0 identity, 1 tanh
    void* out;
    int out_bf16;
    int nx, ny, nz, cin, cout;
};

template <int K>
__host__ __device__ constexpr int fwd_stride() {  // channel stride of the staged window (odd)
    return (TYO + K - 1) * (BZ + K - 1) + 1;
}

template <int K, int COT>
constexpr size_t fwd_smem() {
    return sizeof(float) * (CC * fwd_stride<K>() + K * K * CC * COT);
}

template <int K, int COT>
__global__ void __launch_bounds__(BZ * BY)
conv_fwd_kernel(const __grid_constant__ ConvParams p) {
    extern __shared__ float4 smem4[];
    constexpr int R = K / 2;
    constexpr int TYH = TYO + K - 1, TZH = BZ + K - 1;
    constexpr int CS = fwd_stride<K>();
    float* s_in = reinterpret_cast<float*>(smem4);
    float* s_w = s_in + CC * CS;  // 16-byte aligned: CC * CS * 4 = 32 * CS
    const int nx = p.nx, ny = p.ny, nz = p.nz, cin = p.cin, cout = p.cout;
    const int ncot = (cout + COT - 1) / COT;
    const int x = blockIdx.z / ncot, co0 = (blockIdx.z % ncot) * COT;
    const int z0 = blockIdx.x * BZ, y0 = blockIdx.y * TYO;
    const int tz = threadIdx.x, ty = threadIdx.y, tid = ty * BZ + tz;

    float acc[CY][COT];
#pragma unroll
    for (int j = 0; j < CY; ++j)
#pragma unroll
        for (int o = 0; o < COT; ++o) acc[j][o] = 0.0f;

    for (int dx = 0; dx < K; ++dx) {
        const size_t plane = (size_t)wrap(x + dx - R, nx) * ny;
        for (int c0 = 0; c0 < cin; c0 += CC) {
            const int cc = min(CC, cin - c0);
            __syncthreads();  // the previous pass is done with shared memory
            for (int e = tid; e < TYH * TZH * cc; e += BZ * BY) {
                const int c = e % cc, rest = e / cc;
                const int lz = rest % TZH, ly = rest / TZH;
                const int yy = wrap(y0 - R + ly, ny), zz = wrap(z0 - R + lz, nz);
                s_in[c * CS + ly * TZH + lz] =
                    load_val(p.h, ((plane + yy) * nz + zz) * cin + c0 + c, p.h_bf16);
            }
            for (int e = tid; e < K * K * CC * COT; e += BZ * BY) {
                const int o = e % COT, rest = e / COT;
                const int ci = rest % CC, t = rest / CC;  // t = dy * K + dz
                float v = 0.0f;
                if (ci < cc && co0 + o < cout)
                    v = __ldg(p.w + ((size_t)(dx * K * K + t) * cin + c0 + ci) * cout + co0 + o);
                s_w[e] = v;
            }
            __syncthreads();
            for (int dz = 0; dz < K; ++dz) {
                for (int ci = 0; ci < cc; ++ci) {
                    const float* src = s_in + ci * CS + ty * CY * TZH + tz + dz;
                    float col[CY + K - 1];
#pragma unroll
                    for (int j = 0; j < CY + K - 1; ++j) col[j] = src[j * TZH];
#pragma unroll
                    for (int dy = 0; dy < K; ++dy) {
                        float wr[COT];
                        load_vec<COT>(s_w + ((dy * K + dz) * CC + ci) * COT, wr);
#pragma unroll
                        for (int j = 0; j < CY; ++j)
#pragma unroll
                            for (int o = 0; o < COT; ++o)
                                acc[j][o] = fmaf(col[j + dy], wr[o], acc[j][o]);
                    }
                }
            }
        }
    }

    const int z = z0 + tz;
    if (z >= nz) return;
#pragma unroll
    for (int j = 0; j < CY; ++j) {
        const int y = y0 + ty * CY + j;
        if (y >= ny) continue;
        const size_t cell = (((size_t)x * ny + y) * nz + z) * cout;
#pragma unroll
        for (int o = 0; o < COT; ++o) {
            const int co = co0 + o;
            if (co >= cout) break;
            float v = acc[j][o];
            if (p.bias) v += __ldg(p.bias + co);
            if (p.act == 1) v = tanhf(v);
            if (p.out_bf16)
                static_cast<__nv_bfloat16*>(p.out)[cell + co] = __float2bfloat16(v);
            else
                static_cast<float*>(p.out)[cell + co] = v;
        }
    }
}

struct WgradParams {
    const void* h;
    int h_bf16;
    const void* d;
    int d_bf16;
    float* partial;  // (nchunk, k^3 * cin * cout)
    int nx, ny, nz, cin, cout;
    int xb;          // x-planes per cell chunk
};

__host__ __device__ inline void wgrad_chunks(int nx, int ny, int nz, int* xb, int* nchunk) {
    const int yz = ((ny + WTY - 1) / WTY) * ((nz + WTZ - 1) / WTZ);
    int groups = (WCHUNKS + yz - 1) / yz;
    groups = groups < 1 ? 1 : (groups > nx ? nx : groups);
    *xb = (nx + groups - 1) / groups;
    *nchunk = ((nx + *xb - 1) / *xb) * yz;
}

template <int K>
__host__ __device__ constexpr int wgrad_tzh() {
    return WTZ + K - 1;
}

template <int K, int COT>
__global__ void __launch_bounds__(WMAXT)
wgrad_kernel(const __grid_constant__ WgradParams p) {
    extern __shared__ float4 smem4[];
    constexpr int R = K / 2;
    constexpr int TYH = WTY + K - 1, TZH = wgrad_tzh<K>();
    const int nx = p.nx, ny = p.ny, nz = p.nz, cin = p.cin, cout = p.cout;
    float* s_d = reinterpret_cast<float*>(smem4);  // (WTY, WTZ, COT)
    float* s_h = s_d + WTY * WTZ * COT;             // (TYH, TZH, cin)
    const int nrow = K * K * cin;
    const int ncot = (cout + COT - 1) / COT;
    const int dx = blockIdx.z / ncot, co0 = (blockIdx.z % ncot) * COT;
    const int ytiles = (ny + WTY - 1) / WTY, ztiles = (nz + WTZ - 1) / WTZ;
    const int chunk = blockIdx.x;
    const int zt = chunk % ztiles, yt = (chunk / ztiles) % ytiles, xg = chunk / (ztiles * ytiles);
    const int y0 = yt * WTY, z0 = zt * WTZ;
    const int x0 = xg * p.xb, x1 = min(nx, x0 + p.xb);
    const int tid = threadIdx.x, nthr = blockDim.x;
    const int row0 = blockIdx.y * nthr * RPT + tid;

    int off[RPT];  // offset of row j's input relative to the cell, in s_h
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
        const int r = row0 + j * nthr;
        if (r < nrow) {
            const int ci = r % cin, t = r / cin;
            off[j] = ((t / K) * TZH + t % K) * cin + ci;
        } else {
            off[j] = 0;  // computed and discarded
        }
    }
    float acc[RPT][COT];
#pragma unroll
    for (int j = 0; j < RPT; ++j)
#pragma unroll
        for (int o = 0; o < COT; ++o) acc[j][o] = 0.0f;

    for (int x = x0; x < x1; ++x) {
        const size_t hplane = (size_t)wrap(x + dx - R, nx) * ny;
        __syncthreads();
        for (int e = tid; e < TYH * TZH * cin; e += nthr) {
            const int c = e % cin, rest = e / cin;
            const int lz = rest % TZH, ly = rest / TZH;
            const int yy = wrap(y0 - R + ly, ny), zz = wrap(z0 - R + lz, nz);
            s_h[e] = load_val(p.h, ((hplane + yy) * nz + zz) * cin + c, p.h_bf16);
        }
        for (int e = tid; e < WTY * WTZ * COT; e += nthr) {
            const int o = e % COT, rest = e / COT;
            const int lz = rest % WTZ, ly = rest / WTZ;
            const int y = y0 + ly, z = z0 + lz, co = co0 + o;
            float v = 0.0f;  // cells outside the box and channels past cout add 0
            if (y < ny && z < nz && co < cout)
                v = load_val(p.d, (((size_t)x * ny + y) * nz + z) * cout + co, p.d_bf16);
            s_d[e] = v;
        }
        __syncthreads();
        for (int ly = 0; ly < WTY; ++ly) {
            for (int lz = 0; lz < WTZ; ++lz) {
                float dv[COT];
                load_vec<COT>(s_d + (ly * WTZ + lz) * COT, dv);
                const float* hc = s_h + (ly * TZH + lz) * cin;
#pragma unroll
                for (int j = 0; j < RPT; ++j) {
                    const float hv = hc[off[j]];
#pragma unroll
                    for (int o = 0; o < COT; ++o) acc[j][o] = fmaf(hv, dv[o], acc[j][o]);
                }
            }
        }
    }

    const size_t nw = (size_t)K * nrow * cout;
    float* part = p.partial + (size_t)chunk * nw;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
        const int r = row0 + j * nthr;
        if (r >= nrow) continue;
        const size_t base = ((size_t)dx * nrow + r) * cout;
#pragma unroll
        for (int o = 0; o < COT; ++o)
            if (co0 + o < cout) part[base + co0 + o] = acc[j][o];
    }
}

template <int K, int COT>
cudaError_t launch_fwd(const ConvParams& p, cudaStream_t stream) {
    const int ncot = (p.cout + COT - 1) / COT;
    const dim3 block(BZ, BY);
    const dim3 grid((p.nz + BZ - 1) / BZ, (p.ny + TYO - 1) / TYO, p.nx * ncot);
    conv_fwd_kernel<K, COT><<<grid, block, fwd_smem<K, COT>(), stream>>>(p);
    return cudaGetLastError();
}

template <int K, int COT>
cudaError_t launch_wgrad(const WgradParams& p, int nchunk, cudaStream_t stream) {
    const int nrow = K * K * p.cin;
    int nthr = (nrow + RPT - 1) / RPT;
    nthr = nthr > WMAXT ? WMAXT : ((nthr + 31) / 32) * 32;
    const int nrowchunk = (nrow + nthr * RPT - 1) / (nthr * RPT);
    const size_t smem = sizeof(float) * (WTY * WTZ * COT +
                                         (size_t)(WTY + K - 1) * wgrad_tzh<K>() * p.cin);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            wgrad_kernel<K, COT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    const int ncot = (p.cout + COT - 1) / COT;
    const dim3 grid(nchunk, nrowchunk, K * ncot);
    wgrad_kernel<K, COT><<<grid, nthr, smem, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace

extern "C" int ins_conv_fwd(const void* h, int h_bf16, const float* w, const float* bias,
                            int act, void* out, int out_bf16, int nx, int ny, int nz,
                            int cin, int cout, int k, void* stream) {
    const ConvParams p{h, h_bf16, w, bias, act, out, out_bf16, nx, ny, nz, cin, cout};
    const cudaStream_t s = (cudaStream_t)stream;
    const bool small = cout <= 4;
    switch (k) {
        case 3: return (int)(small ? launch_fwd<3, 4>(p, s) : launch_fwd<3, 8>(p, s));
        case 5: return (int)(small ? launch_fwd<5, 4>(p, s) : launch_fwd<5, 8>(p, s));
        case 7: return (int)(small ? launch_fwd<7, 4>(p, s) : launch_fwd<7, 8>(p, s));
        default: return (int)cudaErrorInvalidValue;
    }
}

// Number of cell chunks (rows of the partial-sum buffer) of a wgrad call.
extern "C" int ins_conv_wgrad_chunks(int nx, int ny, int nz) {
    int xb, nchunk;
    wgrad_chunks(nx, ny, nz, &xb, &nchunk);
    return nchunk;
}

extern "C" int ins_conv_wgrad(const void* h, int h_bf16, const void* d, int d_bf16,
                              float* partial, float* dw, int nx, int ny, int nz, int cin,
                              int cout, int k, void* stream) {
    int xb, nchunk;
    wgrad_chunks(nx, ny, nz, &xb, &nchunk);
    const WgradParams p{h, h_bf16, d, d_bf16, partial, nx, ny, nz, cin, cout, xb};
    const cudaStream_t s = (cudaStream_t)stream;
    const bool small = cout <= 4;
    cudaError_t e;
    switch (k) {
        case 3: e = small ? launch_wgrad<3, 4>(p, nchunk, s) : launch_wgrad<3, 8>(p, nchunk, s); break;
        case 5: e = small ? launch_wgrad<5, 4>(p, nchunk, s) : launch_wgrad<5, 8>(p, nchunk, s); break;
        case 7: e = small ? launch_wgrad<7, 4>(p, nchunk, s) : launch_wgrad<7, 8>(p, nchunk, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (e != cudaSuccess) return (int)e;
    const size_t nw = (size_t)k * k * k * cin * cout;
    reduce_partials_kernel<<<(unsigned)((nw + 255) / 256), 256, 0, s>>>(partial, dw, nchunk, nw);
    return (int)cudaGetLastError();
}
