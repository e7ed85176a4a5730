// The float32 pack kernel's (`tapconv_tf32.cu` `pack_tf32_kernel`) block,
// its shared memory and the layers it takes, on the host and the device.
// Plain C++ apart from the qualifiers, so that a host compiler checks it
// too (tests/test_torch_pack_tf32.py); `ops/conv_kernels.py`
// `pack_tf32_takes` is the same rule.
#pragma once

#include <cstddef>

#ifdef __CUDACC__
#define PACK_HD __host__ __device__
#else
#define PACK_HD
#endif

constexpr int PF_ROWS = 16;         // input rows a block (two a warp)
constexpr int PF_TZ = 16;           // cells a row (one m16 tile)
constexpr int PF_COLG = 2;          // column groups: warps that share two rows, each
                                    // forming the products of its share of the columns
constexpr int PF_THREADS = 32 * (PF_ROWS / 2) * PF_COLG;  // 16 warps
constexpr int PF_CH = 32;           // channels a stage: k8 steps in tensor-core chains of two
constexpr int PF_CHP = PF_CH + 4;   // their staged pitch in floats: an odd number of 16-byte
                                    // units, so that an ldmatrix's 8 rows hit distinct banks
constexpr int PF_MAXNT = 10;        // n8 tiles of packed columns, at most (80 columns): a
                                    // warp's products and chains, 16 NT / PF_COLG
                                    // registers, fit its share of the register file
constexpr int PF_MAXKY = 7;         // y-taps, at most
constexpr int PF_FRAG = 128;        // floats of one split B fragment: 32 lanes x 4
constexpr int PF_MAXNBUF = 4;       // stages in the ring, at most
constexpr int PF_BLOCKS = 264;      // target number of blocks (two waves of 132 SMs)
constexpr size_t PF_SMEM_MAX = 232448;  // shared memory a block may use on an H100

// n8 tiles a warp forms of nt: its column group's share
PACK_HD constexpr int pack_tf32_warp_tiles(int nt) { return (nt + PF_COLG - 1) / PF_COLG; }
// n8 tiles staged and formed: nt and a zero pad to whole shares
PACK_HD constexpr int pack_tf32_tiles(int nt) { return PF_COLG * pack_tf32_warp_tiles(nt); }

// Floats of one stage: the (input plane, PF_CH-channel chunk) window of
// PF_ROWS x PF_TZ cells, then the chunk's k8 steps of every tap's split B
// fragments (the fragments stream from L2 with the stages).
PACK_HD constexpr int pack_tf32_stage_floats(int nt) {
    return PF_ROWS * PF_TZ * PF_CHP + PF_CH / 8 * pack_tf32_tiles(nt) * PF_FRAG;
}

// Bytes of shared memory with nbuf stages in the ring: the ring, one input
// plane's products (float32, rows 8 tiles + 4 floats apart) and the ring
// of kx output-plane accumulators.
inline size_t pack_tf32_smem(int nbuf, int nt, int kx, int ky, int cout) {
    return sizeof(float) * ((size_t)nbuf * pack_tf32_stage_floats(nt) +
                            (size_t)PF_ROWS * PF_TZ * (8 * pack_tf32_tiles(nt) + 4) +
                            (size_t)kx * (PF_ROWS - ky + 1) * PF_TZ * cout);
}

// Whether the pack kernel takes a layer of kc staged channels (a multiple
// of 4): every tap packs into one tile of at most 8 PF_MAXNT columns,
// at most PF_MAXKY y-taps, and a ring of two stages fits beside the rest.
inline bool pack_tf32_takes(int kc, int kx, int ky, int cout) {
    const int nt = (kx * ky * cout + 7) / 8;
    return kc >= 4 && kc % 4 == 0 && kx >= 1 && ky >= 1 && ky <= PF_MAXKY && cout >= 1 &&
           nt <= PF_MAXNT && pack_tf32_smem(2, nt, kx, ky, cout) <= PF_SMEM_MAX;
}

// Stages in the ring: the most that fit, at most PF_MAXNBUF.
inline int pack_tf32_nbuf(int nt, int kx, int ky, int cout) {
    int nbuf = PF_MAXNBUF;
    while (nbuf > 2 && pack_tf32_smem(nbuf, nt, kx, ky, cout) > PF_SMEM_MAX) --nbuf;
    return nbuf;
}
