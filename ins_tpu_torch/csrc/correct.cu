// Pressure correction: u = ut - grad(q), forward differences
//
//   u_a(I) = ut_a(I) - (q(I + e_a) - q(I)) / dx_a     on the periodic cube
//
// Replaces: the correction part of `_pc_qhat_kernel`
// (ins_tpu/ops/pallas_kernels.py:3325, wrapper `pressure_correct_qhat_3d`
// :3422).  The TPU kernel inverse-transforms qhat (q = V_y qhat V_z^T)
// inside the same pass; here the wrapper runs that transform as two
// plane-transform GEMMs (transforms.cu) first, so q makes one extra
// scalar round trip through device memory (later work, ROADMAP queue 2).
//
// What bounds it on an H100: device-memory bytes (read 3 + 1 floats,
// write 3 per cell; 0.47 GB at 256^3, ~0.14 ms at 3.35 TB/s) with ~6
// operations per cell.  The kernel is `correct_kernel` of stencil.cuh,
// which the per-op `pressure_correct_3d` (perop.cu) launches too.

#include "stencil.cuh"

extern "C" int ins_correct_f32(const float* ut, const float* q, float* u, int n,
                               float dx0, float dx1, float dx2, void* stream) {
    return (int)launch_correct(ut, q, u, n, n, n, dx0, dx1, dx2, (cudaStream_t)stream);
}
