"""Plane eigen-transforms of the fused projection.

`yz_transform(f, my, mzT)` computes ``my @ f[x] @ mzT`` for every x-plane
of an (r, n, n) block (the z/y eigen-transforms that the TPU stage and
correction kernels run in their own bodies); `x_transform(mx, h)`
computes ``mx @ h`` over the leading axis (pass B's x-transform).

The precision contract (``precision=``, the `projection_precision` of the
paths; the JAX package's `_mm_h` / `_mm_h_left` / `_dot_h`):

- ``"manualhigh"`` (the default, as in the JAX package) on float32
  operands: the 3-pass bf16 class.  Each operand is split into ``hi =
  bf16(a)`` (round to nearest even) and ``lo = bf16(a − hi)``, and a
  product is ``hi·hi + hi·lo + lo·hi`` summed in float32 (~1e-5 of the
  float64 product; the JAX package documents a projection residual of
  ~4e-5).  On the card the bf16x3 form of `csrc/transforms.cu` (launch
  key ``"plane_transform+bf16x3"``; `mma.sync` m16n8k16).
- ``"highest"`` on float32 operands: the float32 class, 3xTF32 on the
  card (launch key ``"plane_transform"``; within ~1e-6 of the float64
  product at 256³; one TF32 pass would be ~3e-4 off).
- float64 operands (the CPU, and the card's float64 checks): the exact
  product under both names (the JAX package's default path there is the
  roll twin with HIGHEST contractions).

On a CPU tensor the plain version runs: `torch.einsum` for the float32
class and float64, the three products of the split (`bf16x3_matmul`)
for "manualhigh" on float32.

The order of the two products.  The forward transform (``divhat =
Vinv_y·div·Vinv_zᵀ``) takes z first, as the TPU kernels do; the inverse
one (``q = V_y·qhat·V_zᵀ``, ``inverse=True``) takes y first under
"manualhigh" on float32, as the TPU kernels do (`_mm_h_left`, then
`_mm_h`): there the intermediate is split again, so the order is part of
the result (~1e-5 apart).  Under "highest" and on float64 the inverse
keeps z first, as before.

The basis operand of a product (``mzT`` as B, ``my`` and ``mx`` as A) is
split in the kernel's fragment order once, on the host side of the launch
(`pack_basis_b`, `pack_basis_a` into TF32 big and small parts;
`pack_basis_b_bf16`, `pack_basis_a_bf16` into bf16 hi and lo parts), and
kept on the matrix per precision (`split_basis`): the projection
factories split their matrices for their precision when they build them;
the field operand is split in the kernel.
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
    "PRECISIONS",
    "check_precision",
    "plane_key",
    "bf16_parts",
    "bf16x3_matmul",
    "yz_transform",
    "yz_transform_plain",
    "x_transform",
    "x_transform_plain",
    "pack_basis_a",
    "pack_basis_b",
    "pack_basis_a_bf16",
    "pack_basis_b_bf16",
    "split_basis",
    "Launch",
    "yz_launches",
    "x_launch",
]

# the kernel's block tile (csrc/transforms.cu): 128 x 128 outputs, K in
# stages of 32; the packed basis is zero-padded to whole tiles
_BM = _BN = 128
_BK = 32


# the projection precision names: the JAX package's default 3-pass bf16
# class first, then the float32 class
PRECISIONS = ("manualhigh", "highest")


def check_precision(precision):
    if precision not in PRECISIONS:
        raise ValueError(f"unknown projection precision {precision!r}")
    return precision


def plane_key(precision):
    """The plane GEMM's launch key under ``precision``."""
    return "plane_transform" + ("+bf16x3" if check_precision(precision) == "manualhigh" else "")


def bf16_parts(a):
    """float32 ``a`` as its bf16 hi and lo parts, held in float32: ``hi =
    bf16(a)`` (round to nearest even), ``lo = bf16(a − hi)`` (the JAX
    package's `_split_bf16`)."""
    hi = a.to(torch.bfloat16).to(a.dtype)
    return hi, (a - hi).to(torch.bfloat16).to(a.dtype)


def bf16x3_matmul(eq, a, b):
    """``torch.einsum(eq, a, b)`` of float32 operands in the 3-pass bf16
    class: each operand split by `bf16_parts`, then hi·hi + hi·lo + lo·hi,
    each a float32 einsum (the products of bf16 values are exact in
    float32)."""
    ah, al = bf16_parts(a)
    bh, bl = bf16_parts(b)
    return torch.einsum(eq, ah, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)


def _product(eq, a, b, precision):
    """The plain product under the precision contract (module docstring)."""
    if check_precision(precision) == "manualhigh" and a.dtype == torch.float32 \
            and b.dtype == torch.float32:
        return bf16x3_matmul(eq, a, b)
    return torch.einsum(eq, a, b)


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


def _bf16_pairs(p):
    """(..., 2) float32 bf16 values -> (...,) int32 words, the first value
    in the low half (the order of a bf16x2 register)."""
    return p.to(torch.bfloat16).contiguous().view(torch.int32).squeeze(-1)


def pack_basis_b_bf16(w):
    """A (K, N) float32 matrix as the bf16x3 kernel's B operand (the field
    as A): zero-padded to (Kp, Np) as `pack_basis_b`, split by
    `bf16_parts`, then per k16 step and n8 tile the 32 lanes' ``mma.m16n8k16``
    B fragments in the paired k order (`csrc/bf16x3.cuh`: lane 4·g + t
    holds b0 = rows t, t + 4 and b1 = rows t + 8, t + 12 of column g, the
    first row in the low half): ``(Kp/16, Np/8, 32, 4)`` int32 words = (hi
    b0, hi b1, lo b0, lo b1)."""
    k, n = w.shape
    kp, np_ = _ceil(k, _BK), _ceil(n, _BN)
    w = F.pad(w.to(torch.float32), (0, np_ - n, 0, kp - k))
    parts = []
    for p in bf16_parts(w):
        # row 16·step + 8·r + 4·i + t, column 8·tile + g -> (step, tile, g, t, r, i)
        p = p.reshape(kp // 16, 2, 2, 4, np_ // 8, 8).permute(0, 4, 5, 3, 1, 2)
        parts.append(_bf16_pairs(p.reshape(kp // 16, np_ // 8, 32, 2, 2)))
    return torch.cat(parts, dim=-1).contiguous()


def pack_basis_a_bf16(w):
    """An (M, K) float32 matrix as the bf16x3 kernel's A operand (the field
    as B): zero-padded to (Mp, Kp) as `pack_basis_a`, split by
    `bf16_parts`, then per k16 step and m16 tile the 32 lanes'
    ``mma.m16n8k16`` A fragments in the paired k order (lane 4·g + t holds
    a0 = row g, columns t, t + 4; a1 = row g + 8, the same columns; a2, a3
    = rows g, g + 8, columns t + 8, t + 12), all lanes' hi parts, then all
    their lo parts: ``(Kp/16, Mp/16, 2, 32, 4)`` int32 words."""
    m, k = w.shape
    mp, kp = _ceil(m, _BM), _ceil(k, _BK)
    w = F.pad(w.to(torch.float32), (0, kp - k, 0, mp - m))
    parts = []
    for p in bf16_parts(w):
        # row 16·tile + 8·h + g, column 16·step + 8·c + 4·i + t
        #   -> (step, tile, g, t, c, h, i): register 2·c + h
        p = p.reshape(mp // 16, 2, 8, kp // 16, 2, 2, 4).permute(3, 0, 2, 6, 4, 1, 5)
        parts.append(_bf16_pairs(p.reshape(kp // 16, mp // 16, 32, 4, 2)))
    return torch.stack(parts, dim=2).contiguous()


_PACKERS = {("a", "highest"): pack_basis_a, ("b", "highest"): pack_basis_b,
            ("a", "manualhigh"): pack_basis_a_bf16, ("b", "manualhigh"): pack_basis_b_bf16}
# where each precision's split is kept on a matrix (a 3xTF32 split and a
# bf16x3 split never share a slot)
_CACHES = {"highest": "_tf32_split", "manualhigh": "_bf16x3_split"}


def split_basis(w, side, precision="highest"):
    """``w``'s split fragments as the ``precision`` form's ``side`` ("a"
    or "b") operand ("highest": the 3xTF32 kernel's TF32 parts,
    "manualhigh": the bf16x3 kernel's bf16 parts), packed on the first
    call and kept on the tensor per precision (repacked if ``w`` was
    written in place since; an inference tensor keeps no version count, so
    its first split stands)."""
    version = None if w.is_inference() else w._version
    cache = w.__dict__.setdefault(_CACHES[check_precision(precision)], {})
    hit = cache.get(side)
    if hit is None or hit[0] != version:
        hit = (version, _PACKERS[side, precision](w))
        cache[side] = hit
    return hit[1]


def _y_first(inverse, precision, dtype):
    """Whether `yz_transform` takes the y product first (the module
    docstring's order)."""
    return inverse and precision == "manualhigh" and dtype == torch.float32


def yz_transform_plain(f, my, mzT, precision="manualhigh", inverse=False):
    note_plain(plane_key(precision), f)
    if _y_first(inverse, precision, f.dtype):
        t = _product("yj,xjl->xyl", my, f, precision)
        return _product("xjk,kl->xjl", t, mzT, precision)
    t = _product("xjk,kl->xjl", f, mzT, precision)
    return _product("yj,xjl->xyl", my, t, precision)


def x_transform_plain(mx, h, precision="manualhigh"):
    note_plain(plane_key(precision), h)
    return _product("ix,xyz->iyz", mx, h, precision)


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


def yz_launches(r, n, y_first=False):
    """The two calls of `yz_transform` on an (r, n, n) block: ``t = f @
    mzT`` as one (r n x n) @ (n x n) product (the field as A, mzT split as
    B), then ``my @ t[x]`` batched over the r planes (the field as B, my
    split as A); with ``y_first`` the same two calls the other way round."""
    z, y = Launch(True, r * n, n, n, 0, 0, 1), Launch(False, n, n, n, n * n, n * n, r)
    return (y, z) if y_first else (z, y)


def x_launch(m, r, a, b):
    """The call of `x_transform` with an (m, r) matrix on an (r, a, b)
    block: one (m x r) @ (r x a b) product, the field as B."""
    return Launch(False, m, a * b, r, 0, 0, 1)


def _gemm(launch, field, basis, c, precision):
    """One kernel launch on the current stream of the ``precision`` form;
    ``basis`` is W split as `split_basis(W, "b" (the field as A) or "a",
    precision)` lays it out."""
    L = launch
    lib = _build.load()
    entry = (lib.ins_plane_gemm_bf16x3 if precision == "manualhigh"
             else lib.ins_plane_gemm_tf32)
    err = entry(
        field.data_ptr(), L.sf, basis.data_ptr(), c.data_ptr(), L.sc, L.M, L.N, L.K,
        int(L.field_is_a), L.batch, current_stream(c.device),
    )
    key = plane_key(precision)
    _build.check(err, key)
    LAUNCHES[key] += 1


def yz_transform(f, my, mzT, precision="manualhigh", inverse=False):
    """``my @ f[x] @ mzT`` for every x-plane of an (r, n, n) block (r = n
    on a cube, a shard's x extent or its ghost planes on an x-slab mesh):
    two kernel launches (`yz_launches`) of the ``precision`` form, in the
    order the module docstring gives (``inverse``: the V_y·qhat·V_zᵀ
    transform)."""
    check_precision(precision)
    if f.device.type == "cpu":
        return yz_transform_plain(f, my, mzT, precision, inverse)
    r, n = f.shape[0], f.shape[-1]
    device = check_cuda_operands("yz_transform", n, my=(my, "mat"), mzT=(mzT, "mat"))
    check_cuda_tensors("yz_transform", (torch.float32,), f=(f, (r, n, n)))
    launches = yz_launches(r, n, _y_first(inverse, precision, f.dtype))
    with torch.cuda.device(device):
        for L in launches:
            out = torch.empty_like(f)
            basis = split_basis(mzT, "b", precision) if L.field_is_a else \
                split_basis(my, "a", precision)
            _gemm(L, f, basis, out, precision)
            f = out
    return out


def x_transform(mx, h, precision="manualhigh"):
    """``mx @ h`` over the leading axis: one kernel launch (`x_launch`) of
    the ``precision`` form for an (r, a, b) block (r = n for pass B, a
    fold level's half for the folded pass B; a = b = n on a cube, a
    shard's y-slice a = ly)."""
    check_precision(precision)
    if h.device.type == "cpu":
        return x_transform_plain(mx, h, precision)
    if h.dim() != 3:
        raise ValueError(f"x_transform: expected an (r, a, b) block, got {tuple(h.shape)}")
    r, a, b = h.shape
    m = mx.shape[0]
    device = check_cuda_tensors(
        "x_transform", (torch.float32,), h=(h, (r, a, b)), mx=(mx, (m, r))
    )
    with torch.cuda.device(device):
        out = torch.empty((m, a, b), dtype=h.dtype, device=device)
        _gemm(x_launch(m, r, a, b), h, split_basis(mx, "a", precision), out, precision)
    return out
