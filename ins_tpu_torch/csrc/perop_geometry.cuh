// The per-op conv-diff kernel's tile and shared memory (`perop.cu`
// `convdiff_kernel`), on the host and the device: a block of CD_NT threads
// (CD_NW warps stacked in y, each thread one z and CD_RY y-rows) owns a
// CD_TY x CD_TZ (y, z) tile and walks CD_XB x-planes.  Plain C++, so that
// a host compiler checks it too (tests/test_torch_perop_convdiff.py).
#pragma once

#ifdef __CUDACC__
#define CD_HD __host__ __device__
#else
#define CD_HD
#endif

constexpr int CD_TZ = 32;              // tile extent in z: a warp's lanes
constexpr int CD_RY = 2;               // y-rows a thread
constexpr int CD_NW = 8;               // warps a block, stacked in y
constexpr int CD_TY = CD_RY * CD_NW;   // tile extent in y
constexpr int CD_NT = 32 * CD_NW;      // threads a block
// x-planes a block walks (a run loads its warm-up plane x0 - 1 and the
// plane past its end once).  At 128^3 a plane has 4 x 8 tiles and the
// kernel's 70-72 registers leave room for three blocks an SM: 11 planes
// give 384 blocks, one wave of 396.  The profiler's device time at 128^3
// in turns (`chip_smoke.py --perop-turns` with `--perop-variant` edits of
// this constant; NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6), ms: 8
// planes 0.0263, 0.0264; 11 0.0258, 0.0259; 16 0.0267, 0.0274.
constexpr int CD_XB = 11;
// The staged window of u: rows y0 - 1 .. y0 + TY, columns z0 - 4 .. z0 + TZ
// + 3, so that its 16-byte chunks align where nz % 4 == 0 (no chunk
// straddles the wrap).  The stencil reads columns z0 - 1 .. z0 + TZ.
constexpr int CD_ZLO = 4;
constexpr int CD_HY = CD_TY + 2;
constexpr int CD_HZ = CD_TZ + 2 * CD_ZLO;
constexpr int CD_HW = CD_HY * CD_HZ;   // floats of a component's window
constexpr int CD_PL = 3 * CD_HW;       // of a staged plane
// Ring slots: planes x and x + 1 read while x + 2 lands (x - 1 lives in
// registers).
constexpr int CD_RING = 3;
constexpr int CD_SMEM = 4 * CD_RING * CD_PL;  // bytes, static shared memory
// blocks an SM the launch bounds ask for (registers: at most 85 a thread;
// ptxas gave the kernel 70-72 under a bound of two)
constexpr int CD_SM_BLOCKS = 3;

// The window element of tile cell (ty, tz) (ty < CD_TY, tz < CD_TZ)
// shifted by (oy, oz), -1 <= oy <= 1 and -1 <= oz <= 1: the cell's row
// starts one row into the window and its column CD_ZLO columns in.
CD_HD constexpr int cd_elem(int ty, int tz, int oy, int oz) {
    return (ty + 1 + oy) * CD_HZ + tz + CD_ZLO + oz;
}
