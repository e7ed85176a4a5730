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
//
// `ins_correct_halo_f32` is the same correction on an x-slab shard block
// (3, lx, n, n): `_pc_qhat_halo_kernel` (ins_tpu/ops/pallas_kernels.py
// :1873, wrapper `pressure_correct_qhat_halo_3d` :1937).  The forward
// x-difference at the block's last plane reads q's plane lx, the right
// ring neighbour's plane 0, which the wrapper hands in as the ghost plane
// q_hi (exchanged in the eigen-basis and transformed with the block's
// planes; the transform is per plane, so the two orders agree).  Bound at
// the 4-shard shape (lx = 64, n = 256): 7 floats a cell over 4.2M cells,
// 0.12 GB, 0.035 ms at 3.35 TB/s.
//
// `ins_correct_bf16` is the correction with bf16 stream storage
// (`pressure_correct_qhat_3d`'s bf16 `ut_int` and `out_dtype`, :3433-3434):
// ut is read as bf16 or float and u written as bf16 or float, q and the
// arithmetic stay float.  With bf16 on both sides it moves 3·2 + 4 +
// 3·2 = 16 bytes a cell, 0.27 GB at 256^3, 0.08 ms at 3.35 TB/s (bf16 in,
// float out: 22 bytes, 0.11 ms).

#include "stencil.cuh"

extern "C" int ins_correct_f32(const float* ut, const float* q, float* u, int n,
                               float dx0, float dx1, float dx2, void* stream) {
    return (int)launch_correct(ut, q, u, n, n, n, dx0, dx1, dx2, (cudaStream_t)stream);
}

// ut_bf16 / out_bf16: whether ut / u hold bf16 (else float); not both 0
// (that is `ins_correct_f32`).
extern "C" int ins_correct_bf16(const void* ut, int ut_bf16, const float* q, void* u,
                                int out_bf16, int n, float dx0, float dx1, float dx2,
                                void* stream) {
    const auto s = (cudaStream_t)stream;
    using bf = __nv_bfloat16;
    if (ut_bf16 && out_bf16)
        return (int)launch_correct_as(static_cast<const bf*>(ut), q, static_cast<bf*>(u), n,
                                      dx0, dx1, dx2, s);
    if (ut_bf16)
        return (int)launch_correct_as(static_cast<const bf*>(ut), q, static_cast<float*>(u),
                                      n, dx0, dx1, dx2, s);
    if (out_bf16)
        return (int)launch_correct_as(static_cast<const float*>(ut), q, static_cast<bf*>(u),
                                      n, dx0, dx1, dx2, s);
    return (int)cudaErrorInvalidValue;
}

extern "C" int ins_correct_halo_f32(const float* ut, const float* q, const float* q_hi,
                                    float* u, int lx, int n, float dx0, float dx1,
                                    float dx2, void* stream) {
    if (!q_hi) return (int)cudaErrorInvalidValue;
    return (int)launch_correct(ut, q, u, lx, n, n, dx0, dx1, dx2, (cudaStream_t)stream,
                               q_hi);
}
