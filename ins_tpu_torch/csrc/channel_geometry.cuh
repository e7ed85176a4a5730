// The channel stage kernel's tile and shared memory (`channel.cu`
// `channel_msd_kernel`), on the host and the device: a block of CH_NT
// threads (CH_NW warps stacked in y, each thread one z and CH_RY y-rows)
// owns a CH_TY x CH_TZ (y, z) tile and walks x-planes.  Plain C++ apart
// from the qualifiers, so that a host compiler checks it too
// (tests/test_torch_channel_stage.py).
#pragma once

#ifdef __CUDACC__
#define CHAN_HD __host__ __device__
#else
#define CHAN_HD
#endif

constexpr int CH_TZ = 32;              // tile extent in z: a warp's lanes
constexpr int CH_RY = 2;               // y-rows a thread
constexpr int CH_NW = 8;               // warps a block, stacked in y
constexpr int CH_TY = CH_RY * CH_NW;   // tile extent in y
constexpr int CH_NT = 32 * CH_NW;      // threads a block
// x-planes a block walks (a run loads its warm-up plane and two halo
// planes once).  The hat chain's stages 1-2 at 256x128x128 in turns
// (`chip_smoke.py --channel-turns` while the count was a launch argument;
// NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6), ms: 16 planes 0.1527,
// 0.1534; 32 0.1563, 0.1580; 64 0.1845, 0.1870 (512, 256 and 128 blocks,
// two an SM on 132 SMs: the shorter runs fill the card better than they
// lose on halo planes).
constexpr int CH_XB = 16;
// The staged windows of u (and q) start 2 rows below the tile and 4
// columns before it, so that their 16-byte chunks align where nz % 4 == 0:
// u rows y0 - 2 .. y0 + TY, q one row more; both columns z0 - 4 .. z0 + TZ
// + 3.  The stencil reads columns z0 - 2 .. z0 + TZ (the rebuilt ones).
constexpr int CH_ZLO = 4;
constexpr int CH_HY = CH_TY + 3;
constexpr int CH_QY = CH_HY + 1;
constexpr int CH_HZ = CH_TZ + 2 * CH_ZLO;
constexpr int CH_RZ0 = CH_ZLO - 2, CH_RW = CH_TZ + 3;  // the rebuilt columns
constexpr int CH_HW = CH_HY * CH_HZ;   // floats of a u component's window
constexpr int CH_UPL = 3 * CH_HW;      // of a u plane
constexpr int CH_QPL = CH_QY * CH_HZ;  // of a q plane
// Ring slots: u copied, rebuilt in place, then read by three planes; q
// read by two rebuilds; two staged planes of the pointwise streams.
constexpr int CH_UR = 5, CH_QR = 3, CH_SR = 2;
constexpr int CH_TTW = CH_TY * CH_TZ;  // floats of a tile plane
// A staged vector stream's plane: the tile's three components, then
// component 1 on the halo row y0 - 1 and component 2 on the halo column
// z0 - 1.
constexpr int CH_VSZ = 3 * CH_TTW + CH_TZ + CH_TY;
constexpr int CH_NZV = 12;             // packed metric rows
// two blocks an SM: 228 KB of shared memory, 1 KB of it reserved a block
constexpr int CH_SMEM_2BLOCKS = (233472 - 2 * 1024) / 2;

// Offsets (floats) of a launch's shared memory; -1 where absent.
struct ChannelLayout {
    int q;                 // the q ring (RECON)
    int met;               // the metric slice, [CH_NZV][CH_HZ]
    int t1;                // v targets, [CH_TY + 1][CH_TZ]; row 0 is y0 - 1
    int t2;                // w targets, [CH_TY][CH_TZ + 1]; column 0 is z0 - 1
    int streams;           // CH_SR staged planes of `plane` floats
    int base, acc, force;  // a stream's offset in a staged plane
    int plane;
    int total;
};

CHAN_HD inline int ch_align4(int v) { return (v + 3) / 4 * 4; }

CHAN_HD inline ChannelLayout channel_layout(bool recon, bool base, bool acc, bool force) {
    ChannelLayout L;
    int o = CH_UR * CH_UPL;  // the u ring first
    L.q = recon ? o : -1;
    o += recon ? CH_QR * CH_QPL : 0;
    L.met = o;
    o += ch_align4(CH_NZV * CH_HZ);
    L.t1 = o;
    o += ch_align4((CH_TY + 1) * CH_TZ);
    L.t2 = o;
    o += ch_align4(CH_TY * (CH_TZ + 1));
    int s = 0;
    L.base = base ? s : -1;
    s += base ? CH_VSZ : 0;
    L.acc = acc ? s : -1;
    s += acc ? CH_VSZ : 0;
    L.force = force ? s : -1;
    s += force ? CH_VSZ : 0;
    L.plane = s;
    L.streams = o;
    L.total = o + CH_SR * s;
    return L;
}

// the launch's dynamic shared memory, in bytes
inline long channel_smem(const ChannelLayout& L) { return 4L * L.total; }
