// Periodic k^3 convolution layer of the CNN closure, forward (with bias
// and tanh/identity fused in) and weight gradient.
//
//   out[x, y, z, o] = act(b[o] + sum_{dx,dy,dz,c} h[x+dx-r, y+dy-r, z+dz-r, c]
//                                               * w[dx, dy, dz, c, o])
//   dw[dx, dy, dz, c, o] = sum_{x,y,z} h[x+dx-r, y+dy-r, z+dz-r, c] * d[x, y, z, o]
//
// on a periodic (nx, ny, nz) box (indices wrap), channels last: h is
// (nx, ny, nz, cin), d (nx, ny, nz, cout), out (nx, ny, nz, cout) in
// float32 or bfloat16.  Every sum is taken in float32; bf16 operands are
// exact in float32, so their products are exact and a kernel differs from
// a float32 reference on the same rounded operands only in the order of
// its sums.  The input gradient of a layer is the forward kernel on d with
// the taps flipped and transposed (w'[dx, dy, dz, o, c] =
// w[k-1-dx, k-1-dy, k-1-dz, c, o]).
//
// Replaces: `_fusedconv_kernel` (ins_tpu/ops/convkernels.py:687, wrapper
// `fusedconv_3d` :780, forward and input gradient) and
// `_fused_wgrad_kernel` (:840, wrapper `fusedconv_wgrad_3d` :918).
//
// Two routes, picked by the operands' dtype:
//
// * float32 operands (`ins_conv_fwd`, `ins_conv_wgrad`).  What bounds it on
//   an H100: FP32 FMA issue (a 24 -> 24 layer at 128^3 with k = 5 is 302
//   GFLOP against 0.2 GB of compulsory traffic), so the kernels keep the
//   FMA pipes fed from registers.  w is canonical (k, k, k, cin, cout)
//   float32.
//   - forward: a block of 32 (z) x 4 (y) threads owns a 32 x 16 output tile
//     of one x-plane and a tile of COT output channels.  For each x-tap and
//     each chunk of 8 input channels it stages the input window (tile plus
//     halo, channel-major, conflict-free for the reads) and that x-tap's
//     weights in shared memory.  A thread holds CY = 4 y-rows x COT channels
//     of accumulators, loads a column of CY + k - 1 inputs once per
//     (z-tap, channel) and reuses it across the k y-taps: 8 + 2k shared
//     loads per 32k FMA at COT = 8.
//   - weight gradient: a block owns one x-tap, a tile of COT output channels
//     and a chunk of cells (8 y x 16 z over a run of x-planes); each thread
//     owns RPT = 8 rows (dy, dz, c) of dw for those COT channels and walks
//     the staged cells: 8 + 2 shared loads per 64 FMA.
//
// * bf16 operands (`ins_conv_fwd_mma`, `ins_conv_wgrad_mma`): the tensor
//   cores, `mma.sync.m16n8k16` bf16 x bf16 -> float32.  The z taps fold
//   into the contraction, as in the TPU kernel: in channels-last order the
//   folded row of cell (x, y, z) for tap (dx, dy) is the contiguous slice
//   row[z*CW : z*CW + KP] of the wrap-padded input row (x+dx-r, y+dy-r), its
//   channels padded to CW (a multiple of 8, at most 24; wider inputs are cut
//   into nch chunks of CW channels) and KP = k*CW rounded up to 16.  The
//   wrapper pads h and d with zero channels to a multiple of 8, so every
//   staged unit is one 16-byte cp.async.  So
//     forward  out[cells, o] = sum_{dx,dy,chunk} A[cells, (dz,c)] W[(dz,c), o]
//     wgrad    dW[(dz,c), o] = sum_cells A[cell, (dz,c)]^T d[cell, o]
//   with A the overlapping windows of one staged row (ldmatrix on rows
//   CW*2 bytes apart: 48 bytes at CW = 24, conflict-free) and W the packed
//   weights (k, k, nch*KP, np): zero past k*CW rows and cout columns, np =
//   nblk * 8*NT output channels in blocks of NT <= 3 n8 tiles.  A staged
//   row carries KP - k*CW zeros past its last cell, which the last window
//   reads (times zero weights: they must be finite).
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
// Both weight gradients write one partial sum per block; a second kernel
// adds the partials of every weight in a fixed order, so the result is the
// same on every run (no atomics).

#include <cstdint>

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

#pragma unroll
    for (int r = 0; r < FRW; ++r) {
        const int y = y0 + wy0 + r;
        if (y >= p.ny) break;
        const size_t row = ((size_t)x * p.ny + y) * p.nz;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int z = z0 + 16 * wm + (lane >> 2) + 8 * half;
            if (z >= p.nz) continue;
            const size_t cell = (row + z) * p.cout;
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
