// The panel pass B's launch geometry (`fold.cu`: the folded pass B and the
// dense one), on the host and the device: a block of FP_THREADS (8 warps,
// each a 64 x 32 output tile, nc / 32 across a panel of nc columns and
// 8 / (nc / 32) down its rows), the panel with all n x-rows in shared
// memory, and a ring of FP_NBUF stages of ks k8 steps of the split basis
// (one tensor-core chain of 8 ks of K; the bf16x3 form's stages hold
// half the basis floats, whole k16 steps: ks even).  m is the largest
// product's size:
// n / 2 folded (the half-size products), n dense.  Plain C++ apart from
// the qualifiers, so that a host compiler checks it too
// (tests/test_torch_fold_fused.py, tests/test_torch_dense_fused.py).
#pragma once

#include <cstddef>

#ifdef __CUDACC__
#define FOLD_HD __host__ __device__
#else
#define FOLD_HD
#endif

constexpr int FP_THREADS = 256;     // 8 warps, each a 64 x 32 output tile
constexpr int FP_ATILE = 256;       // floats of a split A fragment (pack_basis_a)
constexpr int FP_NBUF = 2;          // stages in the basis ring
constexpr int FP_SMEM_MAX = 232448; // an H100 block's shared memory (227 KB)

// The shared memory of a launch, in floats: the panel (n rows and a zero
// tail for the last operand's K overrun, rows nc + 8 apart: the B
// fragment loads' 32 lanes hit 32 banks), a ring of FP_NBUF stages of the
// split basis (rows the warps cover x 8 ks of K), the eigenvalue tables
FOLD_HD constexpr int fold_rows(int nc) { return 64 * (256 / nc); }
FOLD_HD constexpr int fold_tail(int m, int ks) {
    return (m + 8 * ks - 1) / (8 * ks) * (8 * ks) - m;
}
FOLD_HD constexpr int fold_panel_floats(int n, int m, int nc, int ks) {
    return (n + fold_tail(m, ks)) * (nc + 8);
}
FOLD_HD constexpr int fold_stage_floats(int nc, int ks, bool bf = false) {
    return fold_rows(nc) / 16 * ks * FP_ATILE / (bf ? 2 : 1);
}
FOLD_HD constexpr int fold_table_floats(int n, int nc) { return n / 2 + 1 + 2 * nc; }

// in bytes
inline size_t fold_smem(int n, int m, int nc, int ks, bool bf = false) {
    return sizeof(float) * ((size_t)fold_panel_floats(n, m, nc, ks) +
                            (size_t)FP_NBUF * fold_stage_floats(nc, ks, bf) +
                            fold_table_floats(n, nc));
}

struct FoldGeometry {
    int nc;  // a panel's columns; 0: no geometry fits
    int ks;  // k8 steps a stage
    size_t smem;
};

// The widest panel whose warps cover a product's rows (at most m) in one
// pass, then the longest stage (32, 16 or 8 of K; bf16x3 32 or 16) whose
// ring fits beside it.  Depends on n (and the form) alone, so a shard sums
// as the cube does.
inline FoldGeometry panel_geometry(int n, int m, bool bf = false) {
    for (int nc = 256; nc >= 32; nc /= 2) {
        if (fold_rows(nc) < m) continue;
        for (int ks = 4; ks >= (bf ? 2 : 1); ks /= 2)
            if (fold_smem(n, m, nc, ks, bf) <= FP_SMEM_MAX)
                return {nc, ks, fold_smem(n, m, nc, ks, bf)};
        break;
    }
    return {0, 0, 0};
}

// The folded pass B: nc = 256 at n <= 128, 128 at n <= 256, 64 at n <=
// 512, 32 at n <= 1024 (bf16x3: stages of 32 of K up to 512, 16 above).
inline FoldGeometry fold_geometry(int n, bool bf = false) {
    return panel_geometry(n, n / 2, bf);
}

// The dense pass B (full-size products): nc = 256 at n <= 64, 128 at n <=
// 128, 64 at n <= 256, 32 at n <= 512 (stages of 16 of K there).
inline FoldGeometry dense_geometry(int n, bool bf = false) { return panel_geometry(n, n, bf); }
