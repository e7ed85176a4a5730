"""Plane eigen-transforms of the fused projection.

`yz_transform(f, my, mzT)` computes ``my @ f[x] @ mzT`` for every x-plane
of an (r, n, n) block (the z/y eigen-transforms that the TPU stage and
correction kernels run in their own bodies); `x_transform(mx, h)`
computes ``mx @ h`` over the leading axis (pass B's x-transform).  On a
CUDA tensor each product is one launch of the hand-written FP32 GEMM in
`csrc/transforms.cu` (counted under ``"plane_transform"``); on a CPU
tensor the plain `torch.einsum` version runs.  FP32 accumulation meets
the "highest" accuracy class, so both `projection_precision` names map
to it.
"""

from __future__ import annotations

import torch

from .. import _build
from .launches import (
    LAUNCHES,
    check_cuda_operands,
    check_cuda_tensors,
    current_stream,
    note_plain,
)

__all__ = [
    "yz_transform",
    "yz_transform_plain",
    "x_transform",
    "x_transform_plain",
]


def yz_transform_plain(f, my, mzT):
    note_plain("plane_transform", f)
    t = torch.einsum("xjk,kl->xjl", f, mzT)
    return torch.einsum("yj,xjl->xyl", my, t)


def x_transform_plain(mx, h):
    note_plain("plane_transform", h)
    return torch.einsum("ix,xyz->iyz", mx, h)


def _gemm(A, B, C, M, N, K, lda, ldb, ldc, sA, sB, sC, batch):
    """C[b] = A[b] @ B[b] (row-major, strided batch) on the current stream."""
    err = _build.load().ins_gemm_f32(
        A.data_ptr(), B.data_ptr(), C.data_ptr(), M, N, K, lda, ldb, ldc,
        sA, sB, sC, batch, current_stream(C.device),
    )
    _build.check(err, "plane_transform")
    LAUNCHES["plane_transform"] += 1


def yz_transform(f, my, mzT):
    """``my @ f[x] @ mzT`` for every x-plane of an (r, n, n) block (r = n
    on a cube, a shard's x extent or its ghost planes on an x-slab mesh):
    two GEMM launches."""
    if f.device.type == "cpu":
        return yz_transform_plain(f, my, mzT)
    r, n = f.shape[0], f.shape[-1]
    device = check_cuda_operands("yz_transform", n, my=(my, "mat"), mzT=(mzT, "mat"))
    check_cuda_tensors("yz_transform", (torch.float32,), f=(f, (r, n, n)))
    with torch.cuda.device(device):
        t = torch.empty_like(f)
        # . mzT: one (r n x n) @ (n x n) product
        _gemm(f, mzT, t, r * n, n, n, n, n, n, 0, 0, 0, 1)
        out = torch.empty_like(f)
        # my . : batched over the x-planes, my broadcast (stride 0)
        _gemm(my, t, out, n, n, n, n, n, n, 0, n * n, n * n, r)
    return out


def x_transform(mx, h):
    """``mx @ h`` over the leading axis: one (m x r) @ (r x a b) GEMM for
    an (r, a, b) block (r = n for pass B, a fold level's half for the
    folded pass B; a = b = n on a cube, a shard's y-slice a = ly)."""
    if h.device.type == "cpu":
        return x_transform_plain(mx, h)
    if h.dim() != 3:
        raise ValueError(f"x_transform: expected an (r, a, b) block, got {tuple(h.shape)}")
    r, a, b = h.shape
    m = mx.shape[0]
    device = check_cuda_tensors(
        "x_transform", (torch.float32,), h=(h, (r, a, b)), mx=(mx, (m, r))
    )
    with torch.cuda.device(device):
        out = torch.empty((m, a, b), dtype=h.dtype, device=device)
        _gemm(mx, h, out, m, a * b, r, r, a * b, a * b, 0, 0, 0, 1)
    return out
