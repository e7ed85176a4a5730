// Plane-transform GEMM: one strided, batched float32 matrix product on the
// tensor cores, between a field and an eigen-basis matrix, in one of two
// forms: 3xTF32 (`mma.sync.m16n8k8`, TF32 operands, float32 sums; the
// "highest" projection precision) or bf16x3 (`mma.sync.m16n8k16`, bf16
// operands, float32 sums; "manualhigh", the JAX package's default):
//
//     field as A:   C[b] = F[b] @ W    (F: M x K, W: K x N)
//     field as B:   C[b] = W @ F[b]    (W: M x K, F: K x N)
//
// row-major, F and C with a batch stride, W broadcast.  Every
// eigen-transform of the fused projection is one call of it:
//
//   . V_z^T  along z      field as A: one (r n x n) @ (n x n) product
//   V_y .    along y      field as B, batched over the r x-planes
//   V_x .    along x      field as B (pass B): one (m x r) @ (r x a b) product
//
// Replaces: the in-kernel transform products of the TPU kernels
// (`_mm_h` / `_mm_h_left`, ins_tpu/ops/pallas_kernels.py:87,106, and
// `_dot_h`, ins_tpu/ops/poisson_pallas.py:68) that `pcmsd_hat_3d`,
// `momentum_stage_divhat_3d`, `pressure_correct_qhat_3d` and pass B run
// on the MXU.  There "highest" is f32 via six bf16 passes and
// "manualhigh" three bf16 passes (hi*hi + hi*lo + lo*hi of a bf16 hi/lo
// split, float32 sums); here "highest" is the 3xTF32 form (the float32
// class) and "manualhigh" the bf16x3 form, the same three bf16 products
// (bf16x3.cuh).
//
// Accuracy (3xTF32): each operand is split into a TF32 big and small part
// and a product is small*big + big*small + big*big (tf32.cuh).  The basis is
// constant per projection, so it comes split from the host, in fragment
// order (`ops/transforms.py` `pack_basis_a` / `pack_basis_b`); the field
// is split in registers after its fragments are read.  The tensor cores'
// float32 sums truncate, so a chain holds one stage's four k8 steps
// (twelve mma, 32 of K) before it is added to a float32 accumulator (a CPU
// emulation of truncating chains, tests/test_torch_transforms_tf32.py,
// keeps that within the float32 class at K = 256 and 512; one chain over
// all of K is not).  The bf16x3 form splits the same way into bf16 hi and
// lo parts (the basis on the host, `pack_basis_a_bf16` /
// `pack_basis_b_bf16`, the field in registers) and runs a stage's two k16
// steps (six mma, 32 of K) as one chain (the same emulation keeps that
// within 1e-6 of the exact sum of its products at K = 512); its k16 step
// pairs the 3xTF32 form's two k8 fragments (bf16x3.cuh), so it stages,
// loads and stores as that form does, with half the basis bytes a stage.
// Every output element sums its K in the same order whatever M, N or the
// batch (no split-K), so a shard's rows come out as the cube's.
//
// What bounds it on an H100: at n = 256 each transform is 2 n^4 = 8.6
// GFLOP, so 25.8 GFLOP of TF32 mma (0.052 ms at the 495 TFLOP/s dense TF32
// peak) against 134 MB of compulsory traffic (0.040 ms).  mma.sync
// reaches only part of that peak, the split basis doubles what a block
// stages from L2 (48 KB a 128 x 128 x 32 step), and the staging, fragment
// loads, splits and chain adds are instructions beside each mma: issue
// and staging, not the tensor cores' peak, hold it (PERF.md).
//
// Design: a 128 x 128 output tile per block of 8 warps, one block an SM
// (the accumulators, a chain's partial sums and a chain's fragments take
// up to ~240 registers a thread; at two blocks an SM the 128-register
// budget spilled and ran no faster); K in stages of 32 through a ring of
// four shared buffers filled by cp.async (16 bytes a copy where the
// field's rows allow it, else 4; each thread's source and destination
// offsets computed once a stage), ragged tiles zero-filled in staging, so
// any M, N, K.  A stage holds the field tile and the basis's split
// fragments of its four k8 steps.  The
// field's fragments are read from shared memory in either orientation:
// as A (K contiguous) with one ldmatrix.x4 an m16 tile (rows 36 floats
// apart: an ldmatrix's 8 rows hit distinct banks); as B (N contiguous,
// what wgmma's TF32 form cannot read) with two 32-bit loads an n8 tile
// (rows 136 floats apart: the 32 lanes hit distinct banks).  A warp's
// tile is 32 field rows x 64 basis columns (field as A) or 64 basis rows
// x 32 field columns (field as B), so a warp splits 8 field values a k8
// step against 48 mma, and each split basis fragment is one 16-byte
// shared load.

#include <cstdint>

#include "bf16x3.cuh"  // split_bf16x2, products_bf16x3, pair_split_a, load_split_b
#include "convio.cuh"   // cp.async, set_smem, ldsm_x4
#include "tf32.cuh"     // tf32_rna, mma_tf32, mma_tf32_first, load_split

namespace {

constexpr int PT_THREADS = 256;      // 8 warps
constexpr int PT_BM = 128;           // output rows a block
constexpr int PT_BN = 128;           // output columns a block
constexpr int PT_BK = 32;            // contraction a stage
constexpr int PT_KS = PT_BK / 8;     // k8 steps a stage
constexpr int PT_NBUF = 4;           // stages in the ring (205 KB at the field as A)
constexpr int FA_PITCH = PT_BK + 4;  // field as A: (128 rows, 32 k), rows 36 floats apart
constexpr int FB_PITCH = PT_BN + 8;  // field as B: (32 k, 128 columns), rows 136 floats apart
// a stage's split basis fragments: as B, 4 k8 steps x 16 n8 tiles x 32
// lanes x (big b0, b1, small b0, b1); as A, 4 k8 steps x 8 m16 tiles x
// (32 lanes x big a0..a3, 32 lanes x small a0..a3); bf16x3: the same per
// k16 step (2 a stage), each word two bf16 values
constexpr int B_TILE = 128;          // floats of a split B fragment
constexpr int A_TILE = 256;          // floats of a split A fragment
constexpr int BASIS_KS = PT_BN / 8 * B_TILE;  // floats a k8 step
static_assert(BASIS_KS == PT_BM / 16 * A_TILE, "both forms stage as many basis floats");

template <bool FA>
__host__ __device__ constexpr int pt_field_floats() {
    return FA ? PT_BM * FA_PITCH : PT_BK * FB_PITCH;
}

// k steps a stage: 4 k8 (3xTF32) or 2 k16 (bf16x3)
template <bool BF>
__host__ __device__ constexpr int pt_steps() {
    return BF ? PT_KS / 2 : PT_KS;
}

template <bool FA, bool BF>
__host__ __device__ constexpr int pt_stage_floats() {
    return pt_field_floats<FA>() + pt_steps<BF>() * BASIS_KS;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

struct PlaneGemmParams {
    const float* field;  // field as A: (M, K); as B: (K, N); batch stride sf
    const float* basis;  // split fragments: as B (Kp/8, Np/8, 32, 4), as A (Kp/8, Mp/16, 2, 32, 4)
                         // (bf16x3: Kp/16 steps of the same, two bf16 a word)
    float* c;            // (M, N), batch stride sc
    long long sf, sc;
    int M, N, K;
    int tiles;           // basis tiles a k8 step: Np/8 (field as A) or Mp/16 (as B)
    int vec2;            // C's rows take 8-byte stores
};

// part (+)= a_small*b_big + a_big*b_small + a_big*b_big, FIRST starting a chain
template <bool FIRST>
__device__ __forceinline__ void products(float (&part)[4], const uint32_t (&a_big)[4],
                                         const uint32_t (&a_small)[4], uint32_t bb0, uint32_t bb1,
                                         uint32_t bs0, uint32_t bs1) {
    if (FIRST)
        mma_tf32_first(part, a_small, bb0, bb1);
    else
        mma_tf32(part, a_small, bb0, bb1);
    mma_tf32(part, a_big, bs0, bs1);
    mma_tf32(part, a_big, bb0, bb1);
}

template <bool FA, bool VEC, bool BF>
__global__ void __launch_bounds__(PT_THREADS, 1)
plane_gemm_tf32_kernel(const __grid_constant__ PlaneGemmParams p) {
    constexpr int FIELD = pt_field_floats<FA>();
    constexpr int STAGE = pt_stage_floats<FA, BF>();
    constexpr int STEPS = pt_steps<BF>();
    constexpr int MT = FA ? 2 : 4;  // m16 tiles a warp
    constexpr int NT = FA ? 8 : 4;  // n8 tiles a warp
    extern __shared__ float4 smem_f4[];
    float* smem = reinterpret_cast<float*>(smem_f4);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int m0 = blockIdx.y * PT_BM, n0 = blockIdx.x * PT_BN;
    const float* field = p.field + (long long)blockIdx.z * p.sf;
    float* c = p.c + (long long)blockIdx.z * p.sc;
    const int nstage = (p.K + PT_BK - 1) / PT_BK;
    // the block's first basis tile of a k8 step: as B its n8 tiles from
    // n0, as A its m16 tiles from m0 (contiguous in the packed basis)
    const size_t tile0 = FA ? n0 / 8 : m0 / 16;
    constexpr int TILE = FA ? B_TILE : A_TILE;

    auto issue = [&](int s) {
        if (s < nstage) {
            const int k0 = s * PT_BK;
            float* s_f = smem + (s % PT_NBUF) * STAGE;
            float* s_b = s_f + FIELD;
            // the field tile: as A rows m0.. x k0..k0+31, as B rows k0.. x n0..n0+127
            constexpr int ROWS = FA ? PT_BM : PT_BK, COLS = FA ? PT_BK : PT_BN;
            constexpr int PITCH = FA ? FA_PITCH : FB_PITCH;
            const int r_lim = FA ? p.M : p.K, c_lim = FA ? p.K : p.N;
            const int r0 = FA ? m0 : k0, c0 = FA ? k0 : n0;
            const int ld = FA ? p.K : p.N;
            // this thread's copies: W floats at columns q.., rows rb + i RSTEP
            constexpr int W = VEC ? 4 : 1, UPR = COLS / W, RSTEP = PT_THREADS / UPR;
            const int rb = tid / UPR, q = W * (tid % UPR);
            const float* src = field + (size_t)(r0 + rb) * ld + c0 + q;
            float* dst = s_f + rb * PITCH + q;
            const bool col_ok = c0 + q < c_lim;
#pragma unroll
            for (int i = 0; i < ROWS / RSTEP; ++i) {
                float* d = dst + i * RSTEP * PITCH;
                if (col_ok && r0 + rb + i * RSTEP < r_lim) {
                    if (VEC)
                        cp_async16(d, src + (size_t)i * RSTEP * ld);
                    else
                        cp_async4(d, src + (size_t)i * RSTEP * ld);
                } else if (VEC) {
                    *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                } else {
                    *d = 0.0f;
                }
            }
            // the basis fragments of the stage's k steps (zero-padded on
            // the host): per step the block's tiles, contiguous
            constexpr int PER = BASIS_KS / 4 / PT_THREADS;  // 16-byte copies a step a thread
            const float* b = p.basis + ((size_t)s * STEPS * p.tiles + tile0) * TILE + 4 * tid;
            const size_t kstep = (size_t)p.tiles * TILE;
#pragma unroll
            for (int i = 0; i < STEPS * PER; ++i)
                cp_async16(s_b + (i / PER) * BASIS_KS + (i % PER) * 4 * PT_THREADS + 4 * tid,
                           b + (i / PER) * kstep + (i % PER) * 4 * PT_THREADS);
        }
        cp_async_commit();
    };

    // acc: the sum (float32 adds) of the chains
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

    // field as A: 4 warps down M (32 rows each) x 2 across N (64 columns);
    // as B: 2 down M (64 rows) x 4 across N (32 columns)
    const int wm = FA ? warp % 4 : warp / 4, wn = FA ? warp / 4 : warp % 4;
    for (int s = 0; s < PT_NBUF - 1; ++s) issue(s);
    for (int s = 0; s < nstage; ++s) {
        issue(s + PT_NBUF - 1);
        cp_async_wait<PT_NBUF - 1>();  // this stage's copies have landed
        __syncthreads();
        const float* s_f = smem + (s % PT_NBUF) * STAGE;
        const float* s_b = s_f + FIELD;
        // a chain: one tile's products over the stage's PT_KS k8 steps,
        // then one float32 add into its accumulator
        if (FA && BF) {
            // the field's A fragments of every k16 step (the k8 steps'
            // ldmatrix loads, paired), split into bf16 hi and lo
            uint32_t ah[MT][STEPS][4], al[MT][STEPS][4];
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
                for (int kk = 0; kk < STEPS; ++kk) {
                    uint32_t s0[4], s1[4];
                    const float* a = s_f + (wm * 32 + i * 16 + (lane & 15)) * FA_PITCH +
                                     kk * 16 + (lane >> 4) * 4;
                    ldsm_x4(s0, reinterpret_cast<const bf16*>(a));
                    ldsm_x4(s1, reinterpret_cast<const bf16*>(a + 8));
                    pair_split_a(s0, s1, ah[i][kk], al[i][kk]);
                }
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                uint32_t v[STEPS][4];
#pragma unroll
                for (int kk = 0; kk < STEPS; ++kk) {
                    const uint4 w = *reinterpret_cast<const uint4*>(
                        s_b + kk * BASIS_KS + (wn * NT + j) * B_TILE + 4 * lane);
                    v[kk][0] = w.x, v[kk][1] = w.y, v[kk][2] = w.z, v[kk][3] = w.w;
                }
#pragma unroll
                for (int i = 0; i < MT; ++i) {
                    float part[4];
                    products_bf16x3<true>(part, ah[i][0], al[i][0], v[0]);
#pragma unroll
                    for (int kk = 1; kk < STEPS; ++kk)
                        products_bf16x3<false>(part, ah[i][kk], al[i][kk], v[kk]);
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[i][j][e] += part[e];
                }
            }
        } else if (BF) {
            // the field's B fragments of every k16 step, split: (hi b0,
            // b1, lo b0, b1) per n8 tile and step
            uint32_t bf[NT][STEPS][4];
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int kk = 0; kk < STEPS; ++kk)
                    load_split_b(s_f + (kk * 16 + t) * FB_PITCH + wn * 32 + j * 8 + g, FB_PITCH,
                                 bf[j][kk]);
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                uint32_t ah[STEPS][4], al[STEPS][4];
#pragma unroll
                for (int kk = 0; kk < STEPS; ++kk) {
                    const float* a = s_b + kk * BASIS_KS + (wm * MT + i) * A_TILE + 4 * lane;
                    const uint4 hi = *reinterpret_cast<const uint4*>(a);
                    const uint4 lo = *reinterpret_cast<const uint4*>(a + A_TILE / 2);
                    ah[kk][0] = hi.x, ah[kk][1] = hi.y, ah[kk][2] = hi.z, ah[kk][3] = hi.w;
                    al[kk][0] = lo.x, al[kk][1] = lo.y, al[kk][2] = lo.z, al[kk][3] = lo.w;
                }
#pragma unroll
                for (int j = 0; j < NT; ++j) {
                    float part[4];
                    products_bf16x3<true>(part, ah[0], al[0], bf[j][0]);
#pragma unroll
                    for (int kk = 1; kk < STEPS; ++kk)
                        products_bf16x3<false>(part, ah[kk], al[kk], bf[j][kk]);
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[i][j][e] += part[e];
                }
            }
        } else if (FA) {
            // the field's A fragments of every step, split
            uint32_t ab[MT][PT_KS][4], as[MT][PT_KS][4];
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
                for (int ks = 0; ks < PT_KS; ++ks)
                    load_split(s_f + (wm * 32 + i * 16 + (lane & 15)) * FA_PITCH + ks * 8 +
                                   (lane >> 4) * 4,
                               ab[i][ks], as[i][ks]);
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                uint4 v[PT_KS];
#pragma unroll
                for (int ks = 0; ks < PT_KS; ++ks)
                    v[ks] = *reinterpret_cast<const uint4*>(
                        s_b + ks * BASIS_KS + (wn * NT + j) * B_TILE + 4 * lane);
#pragma unroll
                for (int i = 0; i < MT; ++i) {
                    float part[4];
                    products<true>(part, ab[i][0], as[i][0], v[0].x, v[0].y, v[0].z, v[0].w);
#pragma unroll
                    for (int ks = 1; ks < PT_KS; ++ks)
                        products<false>(part, ab[i][ks], as[i][ks], v[ks].x, v[ks].y, v[ks].z,
                                        v[ks].w);
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[i][j][e] += part[e];
                }
            }
        } else {
            // the field's B fragments of every step, split: (big b0, b1,
            // small b0, b1) per n8 tile and step
            uint32_t bf[NT][PT_KS][4];
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int ks = 0; ks < PT_KS; ++ks) {
                    const float* b = s_f + (ks * 8 + t) * FB_PITCH + wn * 32 + j * 8 + g;
                    const float b0 = b[0], b1 = b[4 * FB_PITCH];
                    bf[j][ks][0] = tf32_rna(b0);
                    bf[j][ks][1] = tf32_rna(b1);
                    bf[j][ks][2] = tf32_rna(b0 - __uint_as_float(bf[j][ks][0]));
                    bf[j][ks][3] = tf32_rna(b1 - __uint_as_float(bf[j][ks][1]));
                }
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                uint32_t ab[PT_KS][4], as[PT_KS][4];
#pragma unroll
                for (int ks = 0; ks < PT_KS; ++ks) {
                    const float* a = s_b + ks * BASIS_KS + (wm * MT + i) * A_TILE + 4 * lane;
                    const uint4 big = *reinterpret_cast<const uint4*>(a);
                    const uint4 small = *reinterpret_cast<const uint4*>(a + A_TILE / 2);
                    ab[ks][0] = big.x, ab[ks][1] = big.y, ab[ks][2] = big.z, ab[ks][3] = big.w;
                    as[ks][0] = small.x, as[ks][1] = small.y, as[ks][2] = small.z,
                    as[ks][3] = small.w;
                }
#pragma unroll
                for (int j = 0; j < NT; ++j) {
                    float part[4];
                    products<true>(part, ab[0], as[0], bf[j][0][0], bf[j][0][1], bf[j][0][2],
                                   bf[j][0][3]);
#pragma unroll
                    for (int ks = 1; ks < PT_KS; ++ks)
                        products<false>(part, ab[ks], as[ks], bf[j][ks][0], bf[j][ks][1],
                                        bf[j][ks][2], bf[j][ks][3]);
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[i][j][e] += part[e];
                }
            }
        }
        __syncthreads();  // the buffer is refilled PT_NBUF - 1 stages on
    }

#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = m0 + wm * MT * 16 + i * 16 + g + 8 * h;
            if (row >= p.M) continue;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const int col = n0 + wn * NT * 8 + j * 8 + 2 * t;
                float* dst = c + (size_t)row * p.N + col;
                const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
                if (p.vec2 && col + 1 < p.N) {
                    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
                } else {
                    if (col < p.N) dst[0] = v0;
                    if (col + 1 < p.N) dst[1] = v1;
                }
            }
        }
}

template <bool FA, bool VEC, bool BF>
cudaError_t launch_plane_gemm(const PlaneGemmParams& p, int batch, cudaStream_t stream) {
    const size_t smem = sizeof(float) * PT_NBUF * pt_stage_floats<FA, BF>();
    const cudaError_t e = set_smem((const void*)plane_gemm_tf32_kernel<FA, VEC, BF>, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((p.N + PT_BN - 1) / PT_BN, (p.M + PT_BM - 1) / PT_BM, batch);
    plane_gemm_tf32_kernel<FA, VEC, BF><<<grid, PT_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <bool BF>
int plane_gemm(const float* field, long long sf, const float* basis, float* c, long long sc,
               int M, int N, int K, int field_is_a, int batch, void* stream) {
    if (M < 1 || N < 1 || K < 1 || batch < 1 || batch > 65535 ||
        (M + PT_BM - 1) / PT_BM > 65535 || ((uintptr_t)basis & 15))
        return (int)cudaErrorInvalidValue;
    const PlaneGemmParams p{
        field, basis, c, sf, sc, M, N, K,
        field_is_a ? (N + PT_BN - 1) / PT_BN * (PT_BN / 8) : (M + PT_BM - 1) / PT_BM * (PT_BM / 16),
        N % 2 == 0 && sc % 2 == 0 && ((uintptr_t)c & 7) == 0};
    // 16-byte copies where every row of the field starts 16-byte aligned
    const bool vec = (field_is_a ? K : N) % 4 == 0 && sf % 4 == 0 && ((uintptr_t)field & 15) == 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (field_is_a)
        return (int)(vec ? launch_plane_gemm<true, true, BF>(p, batch, s)
                         : launch_plane_gemm<true, false, BF>(p, batch, s));
    return (int)(vec ? launch_plane_gemm<false, true, BF>(p, batch, s)
                     : launch_plane_gemm<false, false, BF>(p, batch, s));
}

}  // namespace

// C[b] = field[b] @ W (field_is_a) or W @ field[b] (else), b < batch:
// field (M, K) or (K, N) float32 rows with batch stride sf, C (M, N) with
// batch stride sc, W split into TF32 fragments as `ops/transforms.py`
// `pack_basis_b` (field as A: (Kp/8, Np/8, 32, 4)) or `pack_basis_a`
// (field as B: (Kp/8, Mp/16, 2, 32, 4)) lays it out, Kp = K rounded up to
// 32, Np = N and Mp = M rounded up to 128; W 16-byte aligned.
extern "C" int ins_plane_gemm_tf32(const float* field, long long sf, const float* basis,
                                   float* c, long long sc, int M, int N, int K, int field_is_a,
                                   int batch, void* stream) {
    return plane_gemm<false>(field, sf, basis, c, sc, M, N, K, field_is_a, batch, stream);
}

// The same product in bf16x3 (the "manualhigh" precision): W split into
// bf16 hi and lo fragments as `ops/transforms.py` `pack_basis_b_bf16`
// (field as A: (Kp/16, Np/8, 32, 4) words) or `pack_basis_a_bf16` (field
// as B: (Kp/16, Mp/16, 2, 32, 4)) lays it out, each word two bf16 values.
extern "C" int ins_plane_gemm_bf16x3(const float* field, long long sf, const float* basis,
                                     float* c, long long sc, int M, int N, int K, int field_is_a,
                                     int batch, void* stream) {
    return plane_gemm<true>(field, sf, basis, c, sc, M, N, K, field_is_a, batch, stream);
}

extern "C" const char* ins_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
