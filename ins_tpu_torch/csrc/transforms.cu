// Plane-transform GEMM: one strided, batched FP32 matrix product
//
//     C[b] = A[b] @ B[b]      (row-major; A: M x K, B: K x N, C: M x N)
//
// with a batch stride per operand (0 broadcasts one operand).  Every
// eigen-transform of the fused projection is one call of it:
//
//   . V_z^T  along z      one (n^2 x n) @ (n x n) product
//   V_y .    along y      batched over the n x-planes, A stride 0, B/C stride n^2
//   V_x .    along x      (pass B) one (n x n) @ (n x n^2) product
//
// Replaces: the in-kernel transform products of the TPU kernels
// (`_mm_h` / `_mm_h_left`, ins_tpu/ops/pallas_kernels.py:87,106, and
// `_dot_h`, ins_tpu/ops/poisson_pallas.py:68) that `pcmsd_hat_3d`,
// `momentum_stage_divhat_3d`, `pressure_correct_qhat_3d` and pass B run
// on the MXU.  There "highest" is f32 via six bf16 passes and
// "manualhigh" three; here the FP32 FMA pipe with an FP32 accumulator
// gives the "highest" accuracy class for both precision names.
//
// What bounds it on an H100: FP32 FMA throughput.  At n = 256 each
// transform is 2 n^4 = 8.6 GFLOP over 0.5 MB of operands per plane, far
// above the card's bytes-per-flop line, so the design is a classic
// register-blocked SGEMM: a 128 x 128 output tile per 256-thread block,
// an 8 x 8 register micro-tile per thread split into two 4-wide halves
// (conflict-free float4 shared-memory reads), K stepped in slabs of 8
// staged through shared memory (A stored transposed).  Loads are bounds
// checked, so any n works.  Not yet: double buffering, vectorised
// global loads, TF32/3xTF32 on the tensor cores with wgmma (ROADMAP
// queue 2).

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;

__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                float* __restrict__ C, int M, int N, int K, int lda, int ldb,
                int ldc, long long sA, long long sB, long long sC) {
    A += (long long)blockIdx.z * sA;
    B += (long long)blockIdx.z * sB;
    C += (long long)blockIdx.z * sC;

    __shared__ __align__(16) float As[BK][BM];
    __shared__ __align__(16) float Bs[BK][BN];

    const int tid = threadIdx.x;
    const int tx = tid & 15;   // output columns tx*4 .. and 64 + tx*4 ..
    const int ty = tid >> 4;   // output rows    ty*4 .. and 64 + ty*4 ..
    const int row0 = blockIdx.y * BM;
    const int col0 = blockIdx.x * BN;

    // global -> shared load assignment: 4 consecutive elements each
    const int a_r = tid >> 1, a_k = (tid & 1) * 4;   // A tile: 128 rows x 8 k
    const int b_k = tid >> 5, b_c = (tid & 31) * 4;  // B tile: 8 k x 128 cols

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += BK) {
        const int ar = row0 + a_r;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int k = k0 + a_k + i;
            As[a_k + i][a_r] = (ar < M && k < K) ? A[(size_t)ar * lda + k] : 0.f;
        }
        const int bk = k0 + b_k;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int c = col0 + b_c + i;
            Bs[b_k][b_c + i] = (bk < K && c < N) ? B[(size_t)bk * ldb + c] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
            const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
            const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
            const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
            const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
        if (r >= M) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int c = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
            if (c < N) C[(size_t)r * ldc + c] = acc[i][j];
        }
    }
}

}  // namespace

extern "C" int ins_gemm_f32(const float* A, const float* B, float* C, int M,
                            int N, int K, int lda, int ldb, int ldc,
                            long long sA, long long sB, long long sC,
                            int batch, void* stream) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
    gemm_f32_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        A, B, C, M, N, K, lda, ldb, ldc, sA, sB, sC);
    return (int)cudaGetLastError();
}

extern "C" const char* ins_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
