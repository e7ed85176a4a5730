"""Plane eigen-transforms of the fused projection.

`yz_transform(f, my, mzT)` computes ``my @ f[x] @ mzT`` for every x-plane
of an (r, n, n) block (the z/y eigen-transforms that the TPU stage and
correction kernels run in their own bodies); `x_transform(mx, h)`
computes ``mx @ h`` over the leading axis (pass B's x-transform).  On a
CUDA tensor each product is one launch of the hand-written GEMM in
`csrc/transforms.cu` (counted under ``"plane_transform"``): 3xTF32 on the
tensor cores, the float32 accuracy class (within ~1e-6 of the float64
product at 256³; one TF32 pass would be ~3e-4 off).  On a CPU tensor the
plain `torch.einsum` version runs.  Both `projection_precision` names
("manualhigh", "highest") map to that float32 class; the JAX package's
3-pass bf16 "manualhigh" (~4e-5) waits in ROADMAP queue 1 item 6.

The basis operand of a product (``mzT`` as B, ``my`` and ``mx`` as A) is
split into TF32 big and small parts in the kernel's fragment order once,
on the host side of the launch (`pack_basis_b`, `pack_basis_a`), and kept
on the matrix (`split_basis`): the projection factories split their
matrices when they build them; the field operand is split in the kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import _build
from .conv_kernels import tf32_round
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
    "pack_basis_a",
    "pack_basis_b",
    "split_basis",
    "Launch",
    "yz_launches",
    "x_launch",
]

# the kernel's block tile (csrc/transforms.cu): 128 x 128 outputs, K in
# stages of 32; the packed basis is zero-padded to whole tiles
_BM = _BN = 128
_BK = 32


def _ceil(a, b):
    return -(-a // b) * b


def _split(w):
    """(..., 2) -> (..., 4): each value's TF32 big part, then its small
    part, ``big = tf32_round(w)``, ``small = tf32_round(w − big)``."""
    big = tf32_round(w)
    return torch.cat([big, tf32_round(w - big)], dim=-1)


def pack_basis_b(w):
    """A (K, N) float32 matrix as the kernel's B operand (the field as A):
    zero-padded to (Kp, Np), Kp = K rounded up to 32, Np = N rounded up
    to 128, then per k8 step and n8 tile the 32 lanes' ``mma.m16n8k8`` B
    fragments in TF32 (lane 4·g + t holds rows t and t + 4 of column g),
    each split: ``(Kp/8, Np/8, 32, 4)`` = (big b0, big b1, small b0, small
    b1)."""
    k, n = w.shape
    kp, np_ = _ceil(k, _BK), _ceil(n, _BN)
    w = F.pad(w.to(torch.float32), (0, np_ - n, 0, kp - k))
    # row 8·step + 4·j + t, column 8·tile + g -> (step, tile, lane 4·g + t, j)
    w = w.reshape(kp // 8, 2, 4, np_ // 8, 8).permute(0, 3, 4, 2, 1)
    return _split(w.reshape(kp // 8, np_ // 8, 32, 2)).contiguous()


def pack_basis_a(w):
    """An (M, K) float32 matrix as the kernel's A operand (the field as
    B): zero-padded to (Mp, Kp), Mp = M rounded up to 128, Kp = K rounded
    up to 32, then per k8 step and m16 tile the 32 lanes' ``mma.m16n8k8``
    A fragments in TF32 (lane 4·g + t holds a0 = (g, t), a1 = (g + 8, t),
    a2 = (g, t + 4), a3 = (g + 8, t + 4)), all lanes' big parts, then all
    their small parts: ``(Kp/8, Mp/16, 2, 32, 4)``."""
    m, k = w.shape
    mp, kp = _ceil(m, _BM), _ceil(k, _BK)
    w = F.pad(w.to(torch.float32), (0, kp - k, 0, mp - m))
    # row 16·tile + 8·h + g, column 8·step + 4·j + t -> (step, tile, g, t, j, h)
    w = w.reshape(mp // 16, 2, 8, kp // 8, 2, 4).permute(3, 0, 2, 5, 4, 1)
    w = w.reshape(kp // 8, mp // 16, 32, 4)
    big = tf32_round(w)
    return torch.stack([big, tf32_round(w - big)], dim=2).contiguous()


_PACKERS = {"a": pack_basis_a, "b": pack_basis_b}


def split_basis(w, side):
    """``w``'s split fragments as the kernel's ``side`` ("a" or "b")
    operand, packed on the first call and kept on the tensor (repacked if
    ``w`` was written in place since; an inference tensor keeps no
    version count, so its first split stands)."""
    version = None if w.is_inference() else w._version
    cache = w.__dict__.setdefault("_tf32_split", {})
    hit = cache.get(side)
    if hit is None or hit[0] != version:
        hit = (version, _PACKERS[side](w))
        cache[side] = hit
    return hit[1]


def yz_transform_plain(f, my, mzT):
    note_plain("plane_transform", f)
    t = torch.einsum("xjk,kl->xjl", f, mzT)
    return torch.einsum("yj,xjl->xyl", my, t)


def x_transform_plain(mx, h):
    note_plain("plane_transform", h)
    return torch.einsum("ix,xyz->iyz", mx, h)


class Launch(NamedTuple):
    """One call of the kernel: c[b] = field[b] @ W (``field_is_a``) or W @
    field[b], b < ``batch``; the field (M, K) or (K, N) and c (M, N)
    row-major with batch strides ``sf`` and ``sc`` (floats)."""

    field_is_a: bool
    M: int
    N: int
    K: int
    sf: int
    sc: int
    batch: int


def yz_launches(r, n):
    """The two calls of `yz_transform` on an (r, n, n) block: ``t = f @
    mzT`` as one (r n x n) @ (n x n) product (the field as A, mzT split as
    B), then ``my @ t[x]`` batched over the r planes (the field as B, my
    split as A)."""
    return (Launch(True, r * n, n, n, 0, 0, 1), Launch(False, n, n, n, n * n, n * n, r))


def x_launch(m, r, a, b):
    """The call of `x_transform` with an (m, r) matrix on an (r, a, b)
    block: one (m x r) @ (r x a b) product, the field as B."""
    return Launch(False, m, a * b, r, 0, 0, 1)


def _gemm(launch, field, basis, c):
    """One kernel launch on the current stream; ``basis`` is W split as
    `pack_basis_b` (the field as A) or `pack_basis_a` lays it out."""
    L = launch
    err = _build.load().ins_plane_gemm_tf32(
        field.data_ptr(), L.sf, basis.data_ptr(), c.data_ptr(), L.sc, L.M, L.N, L.K,
        int(L.field_is_a), L.batch, current_stream(c.device),
    )
    _build.check(err, "plane_transform")
    LAUNCHES["plane_transform"] += 1


def yz_transform(f, my, mzT):
    """``my @ f[x] @ mzT`` for every x-plane of an (r, n, n) block (r = n
    on a cube, a shard's x extent or its ghost planes on an x-slab mesh):
    two kernel launches (`yz_launches`)."""
    if f.device.type == "cpu":
        return yz_transform_plain(f, my, mzT)
    r, n = f.shape[0], f.shape[-1]
    device = check_cuda_operands("yz_transform", n, my=(my, "mat"), mzT=(mzT, "mat"))
    check_cuda_tensors("yz_transform", (torch.float32,), f=(f, (r, n, n)))
    z, y = yz_launches(r, n)
    with torch.cuda.device(device):
        t = torch.empty_like(f)
        _gemm(z, f, split_basis(mzT, "b"), t)
        out = torch.empty_like(f)
        _gemm(y, t, split_basis(my, "a"), out)
    return out


def x_transform(mx, h):
    """``mx @ h`` over the leading axis: one kernel launch (`x_launch`) for
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
        _gemm(x_launch(m, r, a, b), h, split_basis(mx, "a"), out)
    return out
