"""Pass B of the fused pressure projection on a periodic cube.

Port of `poisson_eigen_consts`, `fold_levels_default`,
`poisson_fold_consts` and `make_fused_projection` from
`ins_tpu/ops/poisson_pallas.py`.  The fused projection splits the
fast-diagonalization Poisson solve across three kernels: the stage
kernel emits ``divhat = Vinv_y · (vol·div) · Vinv_zᵀ`` per x-plane, pass
B here solves in x, and the correction consumes ``qhat`` with the z/y
inverse transform.  The dense pass B is

    g    = Vinv_x · divhat                     (x-forward)
    g   *= 1 / (vol·(λx + λy + λz))            (0 where |den| < eps)
    qhat = V_x · g                             (x-inverse)

and the radix-2 folded one (`make_fused_projection` takes it wherever
n % 4 == 0, as the JAX package does) splits each level's transform into
half-size ones: with e = h[:n/2] + h[n/2:] and o = h[:n/2] − h[n/2:],
the odd frequencies solve as ``S_o · scale(R_o · o)`` and the even ones
recurse on e (the even half-basis is the n/2-point basis scaled by
1/√2), then ``qhat = [q_e/2 + q_o; q_e/2 − q_o]``; the leaf is dense.

On CUDA tensors the folded pass B takes one of two routes, chosen from n
before any launch (`fold_route`): up to `FOLD_FUSED_MAX_N` one launch of
`csrc/fold.cu`'s fused kernel (split, half-size 3xTF32 x-products,
eigen-scale and combine on a panel of columns in shared memory; the C
entry picks the panel width and the ring depth from n, and refuses n >
1024), above it the level route (launch keys ``+levels``): the
recursion `_fold_levels` of x-products (`csrc/transforms.cu`) around
`csrc/poisson.cu`'s split, eigen-scale and combine kernels, which has no
size limit.  The dense pass B (n % 4 != 0) routes the same way
(`dense_route`): up to `DENSE_FUSED_MAX_N` (`DENSE_FUSED_MAX_N_BF16X3`
in the bf16x3 form) one launch of the same
kernel with no fold level (the full-size x-products, the eigen-scale in
the first one's epilogue), above it the GEMM route (launch keys
``+gemm``): x-products around the eigen-scale kernel, three launches, no
size limit.  On CPU tensors the wrappers run the plain versions
`passB_plain` and `passB_fold_plain`.  The level route's pieces
(`_fold_split`, `_eigen_scale`, `_fold_combine`, `x_transform`) run their
plain versions on CPU tensors too: no wrapper sends them one, but the
CPU tests drive the route itself (`_fold_levels`) through them against
the JAX package.

The precision contract is `transforms.py`'s: the projection's
``precision`` ("manualhigh", the default as in the JAX package, or
"highest") picks the form of every x product (pass B's and the 3-pass
solve's z/y ones): on float32 operands "manualhigh" is the JAX package's
3-pass bf16 class (`_dot_h` with prec None: hi·hi + hi·lo + lo·hi of a
bf16 hi/lo split, float32 sums; on the card the bf16x3 forms of
`fold.cu` and `transforms.cu`, launch keys ``+bf16x3``) and "highest" the
float32 class (3xTF32 on the card, the keys without it); float64
operands get the exact product under both names.  The eigen-scale, the
split and the combine are float32 elementwise under both.  The
projection splits its basis matrices once, for its precision, when it is
built (`transforms.split_basis`).

`make_passB_sharded` is the same pass B on a shard's (n, ly, n) y-slice
of an x-slab mesh (`parallel/halo.py`), whose eigen-scale takes the
slice's global y offset.

`make_poisson_pallas` is the port of the JAX package's standalone 3-pass
solve of the same name: pass A is the z/y forward transform
(`yz_transform(f, Vinv, VinvT)`), pass B the fused projection's (folded
where n % 4 == 0), pass C the z/y inverse transform; the per-op chain
solves with it on the card when it is not differentiated.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import _build
from .dft import fourier_eigenbasis
from .launches import (
    LAUNCHES,
    check_cuda_operands,
    check_cuda_tensors,
    current_stream,
    note_plain,
)
from .transforms import (
    check_precision, split_basis, x_transform, x_transform_plain, yz_transform,
    yz_transform_plain,
)

__all__ = [
    "FOLD_FUSED_MAX_N",
    "fused_key",
    "fold_route",
    "DENSE_FUSED_MAX_N",
    "DENSE_FUSED_MAX_N_BF16X3",
    "dense_route",
    "poisson_eigen_consts",
    "fold_levels_default",
    "poisson_fold_consts",
    "make_fused_projection",
    "make_poisson_pallas",
    "passB",
    "passB_plain",
    "passB_fold",
    "passB_fold_plain",
    "make_passB_sharded",
    "passB_sharded",
    "passB_sharded_plain",
]


# The largest n whose folded pass B runs as one fused kernel (`fold.cu`);
# above it the level route runs.  Set from both routes timed in turns
# (`chip_smoke.py --fold-turns`, `fold_gate_times`; NVIDIA H100 80GB HBM3,
# 700 W; PERF.md §6), ms a call, fused | level route: 512³ two
# levels 3.672, 3.662 | 3.843, 3.834; 768³ two levels 28.109, 28.096 |
# 15.986, 15.985; the (1024, 256, 1024) shard 16.510, 16.472 | 10.490,
# 10.474.  Above 512 the fused kernel's panels narrow from 64 columns to
# 32 (`fold_geometry.cuh`), which doubles its basis traffic a FLOP.  The
# kernel keeps that geometry (up to n = 1024) so that every
# `chip_smoke.py` run times both routes above the gate and fails if the
# gate picks the slower one (ROADMAP.md queue 2 item 20).
FOLD_FUSED_MAX_N = 512


def _prec(proj):
    """A projection dict's precision ("manualhigh" where a hand-built dict
    names none, as `make_fused_projection`'s default)."""
    return proj.get("precision", "manualhigh")


def fused_key(name, precision):
    """The launch key of the fused pass B ``name`` ("passB", "passB_fold",
    "passB_sharded") under ``precision``: "+bf16x3" for "manualhigh"."""
    return name + ("+bf16x3" if check_precision(precision) == "manualhigh" else "")


def fold_route(n):
    """The folded pass B's route on the card at x extent n: ``"fused"``
    (one `fold.cu` launch) up to `FOLD_FUSED_MAX_N`, else ``"levels"``."""
    return "fused" if n <= FOLD_FUSED_MAX_N else "levels"


# The largest n whose dense pass B runs as one fused kernel (`fold.cu`
# with no fold level); above it the GEMM route runs.  Set from both
# routes timed in turns (`chip_smoke.py` `dense_gate_times`; NVIDIA H100
# 80GB HBM3, 700 W; PERF.md §6), ms a call, fused | GEMM route: 250³
# 0.3962, 0.3949 | 0.4448, 0.4422; the (250, 125, 250) shard 0.2376,
# 0.2374 | 0.2680, 0.2682; 258³ 0.7645, 0.7627 | 0.6581, 0.6573; the
# (258, 129, 258) shard 0.4158, 0.4179 | 0.3899, 0.3894.  Above 256
# the kernel's panels narrow from 64 columns to 32 (`dense_geometry`),
# which doubles its basis traffic a FLOP.  The kernel keeps that geometry
# (up to n = 512) so that every `chip_smoke.py` run times both routes
# above the gate and fails if the gate picks the slower one.
DENSE_FUSED_MAX_N = 256
# The same gate for the bf16x3 form ("manualhigh"), set from both routes
# timed in turns in that form (`chip_smoke.py` `dense_gate_times`, NVIDIA
# H100 80GB HBM3, 700 W; PERF.md §6), ms a call, fused | GEMM route: 250³
# 0.2752 | 0.3488; (250, 125, 250) 0.1762 | 0.2189; 258³ 0.4805 | 0.4990;
# (258, 129, 258) 0.2758 | 0.3058; 322³ 1.0275 | 0.9118; (322, 161, 322)
# 0.5790 | 0.5601; 382³ 1.5764 | 1.4055; (382, 191, 382) 0.8777 | 0.8332;
# 510³ 3.7738 | 3.9148; (510, 255, 510) 2.0971 | 2.3274.  Its stages hold
# half the basis bytes of K, so above 256 it keeps stages of 32 of K
# (`dense_geometry(n, true)`) where the 3xTF32 form drops to 16, and it
# still wins at 258; from 322 the GEMM route wins, until it loses again
# at 510 (3.6 % on the cube, within the check's 5 %; 10 % on the shard).
# One threshold cannot follow that; this one is where the fused kernel
# first stops winning.
DENSE_FUSED_MAX_N_BF16X3 = 258


def dense_route(n, precision="highest"):
    """The dense pass B's route on the card at x extent n in
    ``precision``'s form: ``"fused"`` (one `fold.cu` launch) up to
    `DENSE_FUSED_MAX_N` (3xTF32, "highest") or `DENSE_FUSED_MAX_N_BF16X3`
    (bf16x3, "manualhigh"), else ``"gemm"``."""
    gate = (DENSE_FUSED_MAX_N_BF16X3 if check_precision(precision) == "manualhigh"
            else DENSE_FUSED_MAX_N)
    return "fused" if n <= gate else "gemm"


def _pin_eps(Np, dxs):
    """The nullspace pin threshold: 1e-12 of the largest |den|."""
    vol = float(np.prod(dxs))
    maxden = 0.0
    for d in range(3):
        _, _, lam_d = fourier_eigenbasis(Np[d], dxs[d])
        maxden += np.max(np.abs(lam_d)) * vol
    return float(1e-12 * maxden)


def _const(a, dtype, device):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


def poisson_eigen_consts(Np, dxs, dtype, device="cuda"):
    """(V, Vinv, eps) for the cube fast-diagonalization solve; `eps` is
    the nullspace pin threshold (the k = 0 mode, den == 0, maps to 0)."""
    V, Vinv, _ = fourier_eigenbasis(Np[0], dxs[0])
    return _const(V, dtype, device), _const(Vinv, dtype, device), _pin_eps(Np, dxs)


def fold_levels_default(n):
    """Recursion depth of the folded pass B: halve while the leaf stays
    >= 128 wide, at most twice (1 level at 64-256, 2 at 512); one fold
    for smaller n % 4 == 0.  Every folded size keeps n_d % 4 == 0, so the
    Nyquist mode stays an even frequency."""
    levels = 0
    n_d = n
    while n_d % 4 == 0 and n_d // 2 >= 128 and levels < 2:
        levels += 1
        n_d //= 2
    if levels == 0 and n % 4 == 0:
        levels = 1
    return levels


def poisson_fold_consts(Np, dxs, dtype, levels=None, device="cuda"):
    """(mats, levels, eps) of the folded pass B: per level the
    odd-frequency rows of the level's x eigenbasis restricted to the first
    half of its domain (R_o) and the matching inverse columns (S_o), then
    the leaf basis pair: ``[R_o^0, S_o^0, ..., Vinv_L, V_L]``."""
    n = Np[0]
    if levels is None:
        levels = fold_levels_default(n)
    mats = []
    n_d = n
    for _ in range(levels):
        if n_d % 4:
            raise ValueError(f"{levels} fold levels need n % {2 ** (levels + 1)} == 0, got {n}")
        V, Vinv, _ = fourier_eigenbasis(n_d, dxs[0])
        n2 = n_d // 2
        odd_idx = []
        for k in range(1, n2, 2):
            odd_idx += [2 * k - 1, 2 * k]
        mats += [_const(Vinv[odd_idx][:, :n2], dtype, device),
                 _const(V[:n2][:, odd_idx], dtype, device)]
        n_d = n2
    V, Vinv, _ = fourier_eigenbasis(n_d, dxs[0])
    mats += [_const(Vinv, dtype, device), _const(V, dtype, device)]
    return mats, levels, _pin_eps(Np, dxs)


def _lam(idx, dx, n):
    """Second-difference eigenvalue -4 sin^2(pi k / n) / dx^2 at frequency
    k = ceil(idx / 2) (eigenbasis order const, cos_1, sin_1, ...,
    Nyquist)."""
    return _lam_k(torch.div(idx + 1, 2, rounding_mode="floor"), dx, n)


def _lam_k(k, dx, n):
    """-4 sin^2(pi k / n) / dx^2 at frequency k."""
    s = torch.sin((math.pi / n) * k)
    return (-4.0 / (dx * dx)) * s * s


def _scale_plain(g, kx, proj, yoff=0):
    """g *= 1/den, den = vol·(λx(kx) + λy + λz), with the x-frequencies
    ``kx`` of g's rows and the y-modes ``yoff + y`` of its columns; 0
    where |den| < eps (the nullspace pin)."""
    n, ly = g.shape[-1], g.shape[1]
    dxs, vol = proj["dxs"], proj["vol"]
    idx = torch.arange(n, dtype=g.dtype, device=g.device)
    lam_yz = _lam(idx[yoff:yoff + ly], dxs[1], n)[:, None] + _lam(idx, dxs[2], n)[None, :]
    den = vol * (_lam_k(kx.to(g.dtype), dxs[0], n)[:, None, None] + lam_yz)
    safe = torch.where(den == 0.0, torch.ones_like(den), den)
    return g * torch.where(den.abs() < proj["eps"], torch.zeros_like(den), 1.0 / safe)


def _ceil_half(r):
    return torch.div(r + 1, 2, rounding_mode="floor")


def _odd_rows(r):
    """x-frequency of a fold level's odd-half row r, before kmul."""
    return 2 * torch.div(r, 2, rounding_mode="floor") + 1


def _dense_plain(h, proj, yoff=0):
    prec = _prec(proj)
    r = torch.arange(h.shape[0], device=h.device)
    g = _scale_plain(x_transform_plain(proj["Vinv"], h, prec), _ceil_half(r), proj, yoff)
    return x_transform_plain(proj["V"], g, prec)


def passB_plain(h, proj):
    """Plain PyTorch pass B: the x-transforms in the projection's precision
    and the closed-form scale."""
    note_plain(fused_key("passB", _prec(proj)), h)
    return _dense_plain(h, proj)


def _fold_plain(hb, proj, lvl, kmul, yoff=0):
    """The recursion of `_passB_fold_body` (poisson_pallas.py:136)."""
    mats, levels, prec = proj["fold_mats"], proj["fold_levels"], _prec(proj)
    nn = hb.shape[0]
    r = torch.arange(nn, device=hb.device)
    if lvl == levels:
        g = _scale_plain(x_transform_plain(mats[2 * levels], hb, prec), kmul * _ceil_half(r),
                         proj, yoff)
        return x_transform_plain(mats[2 * levels + 1], g, prec)
    n2 = nn // 2
    e = hb[:n2] + hb[n2:]
    o = hb[:n2] - hb[n2:]
    ro = r[:n2]
    go = _scale_plain(x_transform_plain(mats[2 * lvl], o, prec), kmul * _odd_rows(ro), proj,
                      yoff)
    qo = x_transform_plain(mats[2 * lvl + 1], go, prec)
    qe = 0.5 * _fold_plain(e, proj, lvl + 1, 2 * kmul, yoff)
    return torch.cat([qe + qo, qe - qo], dim=0)


def passB_fold_plain(h, proj):
    """Plain PyTorch folded pass B (the same qhat as `passB_plain`)."""
    note_plain(fused_key("passB_fold", _prec(proj)), h)
    return _fold_plain(h, proj, 0, 1)


def _eigen_scale_plain(g, kmul, odd, proj, yoff=0):
    r = torch.arange(g.shape[0], device=g.device)
    return _scale_plain(g, kmul * (_odd_rows(r) if odd else _ceil_half(r)), proj, yoff)


def _eigen_scale(g, kmul, odd, proj, yoff=0):
    """g *= 1/den with row r at x-frequency kmul·ceil(r/2) (kmul·(2⌊r/2⌋+1)
    on a level's odd half): in place on the card (`poisson.cu`); the plain
    version on CPU tensors, which only the tests of the level route pass."""
    if g.device.type == "cpu":
        return _eigen_scale_plain(g, kmul, odd, proj, yoff)
    dx0, dx1, dx2 = proj["dxs"]
    err = _build.load().ins_eigen_scale_f32(
        g.data_ptr(), g.shape[0], g.shape[2], g.shape[1], yoff, kmul, int(odd), dx0, dx1,
        dx2, proj["vol"], proj["eps"], current_stream(g.device),
    )
    _build.check(err, "pass B eigen-scale")
    return g


def _fold_split_plain(hb):
    n2 = hb.shape[0] // 2
    return hb[:n2] + hb[n2:], hb[:n2] - hb[n2:]


def _fold_split(hb):
    """(e, o) = (h0 + h1, h0 − h1) of hb's two x-halves (the plain
    version on CPU tensors, which only the tests of the level route
    pass)."""
    if hb.device.type == "cpu":
        return _fold_split_plain(hb)
    n2 = hb.shape[0] // 2
    e, o = torch.empty_like(hb[:n2]), torch.empty_like(hb[:n2])
    err = _build.load().ins_fold_split_f32(hb.data_ptr(), e.data_ptr(), o.data_ptr(),
                                           e.numel(), current_stream(hb.device))
    _build.check(err, "pass B fold split")
    return e, o


def _fold_combine_plain(qe, qo):
    qe = 0.5 * qe
    return torch.cat([qe + qo, qe - qo], dim=0)


def _fold_combine(qe, qo):
    """[qe/2 + qo; qe/2 − qo] (the plain version on CPU tensors, which
    only the tests of the level route pass)."""
    if qe.device.type == "cpu":
        return _fold_combine_plain(qe, qo)
    out = torch.empty((2 * qe.shape[0], *qe.shape[1:]), dtype=qe.dtype, device=qe.device)
    err = _build.load().ins_fold_combine_f32(qe.data_ptr(), qo.data_ptr(), out.data_ptr(),
                                             qe.numel(), current_stream(qe.device))
    _build.check(err, "pass B fold combine")
    return out


def _fold_levels(hb, proj, lvl, kmul, yoff=0):
    """The level route of the folded pass B from level ``lvl`` down (the
    recursion of `_fold_plain`): split, the odd half's x-products around
    its eigen-scale, the even half one level down with kmul doubled, the
    combine; the leaf dense.  Each piece is a kernel on the card (and its
    plain version on the CPU); intermediates are dropped as soon as they
    are used, so a (2048, 512, 2048) shard's solve peaks near four times
    its input."""
    mats, levels, prec = proj["fold_mats"], proj["fold_levels"], _prec(proj)
    if lvl == levels:
        g = _eigen_scale(x_transform(mats[2 * levels], hb, prec), kmul, False, proj, yoff)
        return x_transform(mats[2 * levels + 1], g, prec)
    e, o = _fold_split(hb)
    go = _eigen_scale(x_transform(mats[2 * lvl], o, prec), kmul, True, proj, yoff)
    del o
    qo = x_transform(mats[2 * lvl + 1], go, prec)
    del go
    qe = _fold_levels(e, proj, lvl + 1, 2 * kmul, yoff)
    del e
    return _fold_combine(qe, qo)


def _dense_gemm(h, proj, yoff=0):
    """The GEMM route of the dense pass B: x-product, eigen-scale,
    x-product (three launches; the x-products in the projection's
    precision)."""
    prec = _prec(proj)
    g = _eigen_scale(x_transform(proj["Vinv"], h, prec), 1, False, proj, yoff)
    return x_transform(proj["V"], g, prec)


def _dense_fused(h, proj, yoff, ly):
    """One launch of the fused dense pass B on an (n, ly, n) block (n <=
    512: above it no panel of all n x-rows fits a block, and the launch is
    refused)."""
    n, prec = h.shape[0], _prec(proj)
    out = torch.empty_like(h)
    dx0, dx1, dx2 = proj["dxs"]
    lib = _build.load()
    entry = lib.ins_passb_dense_bf16x3 if prec == "manualhigh" else lib.ins_passb_dense_f32
    err = entry(
        h.data_ptr(), out.data_ptr(), split_basis(proj["Vinv"], "a", prec).data_ptr(),
        split_basis(proj["V"], "a", prec).data_ptr(), n, ly, yoff, dx0, dx1, dx2, proj["vol"],
        proj["eps"], current_stream(h.device),
    )
    _build.check(err, fused_key("passB", prec))
    return out


def _dense_run(h, proj, yoff, ly):
    """The dense pass B on an (n, ly, n) block by ``dense_route(n,
    precision)``:
    (qhat, the launch key's suffix: "" fused in 3xTF32, "+bf16x3" fused in
    bf16x3, "+gemm" the GEMM route)."""
    if dense_route(h.shape[0], _prec(proj)) == "fused":
        return _dense_fused(h, proj, yoff, ly), fused_key("", _prec(proj))
    return _dense_gemm(h, proj, yoff), "+gemm"


def _fold(h, proj, yoff, ly):
    """One launch of the fused folded pass B on an (n, ly, n) block (n <=
    1024: above it no panel of all n x-rows fits a block, and the launch
    is refused)."""
    n, levels, prec = h.shape[0], proj["fold_levels"], _prec(proj)
    mats = [split_basis(w, "a", prec) for w in proj["fold_mats"]]
    ptrs = [m.data_ptr() for m in mats] + [None] * (6 - len(mats))
    out = torch.empty_like(h)
    dx0, dx1, dx2 = proj["dxs"]
    lib = _build.load()
    entry = lib.ins_passb_fold_bf16x3 if prec == "manualhigh" else lib.ins_passb_fold_f32
    err = entry(
        h.data_ptr(), out.data_ptr(), *ptrs, n, ly, yoff, levels, dx0, dx1, dx2, proj["vol"],
        proj["eps"], current_stream(h.device),
    )
    _build.check(err, fused_key("passB_fold", prec))
    return out


def _fold_run(h, proj, yoff, ly):
    """The folded pass B on an (n, ly, n) block by ``fold_route(n)``:
    (qhat, the launch key's suffix: "" fused in 3xTF32, "+bf16x3" fused in
    bf16x3, "+levels" the level route)."""
    if fold_route(h.shape[0]) == "fused":
        return _fold(h, proj, yoff, ly), fused_key("", _prec(proj))
    return _fold_levels(h, proj, 0, 1, yoff), "+levels"


def _check_fold(name, h, proj, ly):
    """Raise unless h is an (n, ly, n) float32 CUDA tensor and the fold
    matrices lie on its device at their levels' sizes; returns the
    device."""
    n, levels = proj["V"].shape[0], proj["fold_levels"]
    sizes = [n >> (lv + 1) for lv in range(levels) for _ in range(2)] + [n >> levels] * 2
    return check_cuda_tensors(
        name, (torch.float32,), h=(h, (n, ly, n)),
        **{f"fold_mats[{i}]": (w, (m, m))
           for i, (w, m) in enumerate(zip(proj["fold_mats"], sizes))},
    )


def passB(h, proj):
    """Dense pass B: ``divhat -> qhat`` on an (n, n, n) field, by the route
    `dense_route` picks on the card (launch key ``passB`` fused in 3xTF32,
    ``passB+bf16x3`` fused in bf16x3, ``passB+gemm`` the GEMM route)."""
    if h.device.type == "cpu":
        return passB_plain(h, proj)
    n = h.shape[0]
    device = check_cuda_operands(
        "passB", n, h=(h, "sca"), Vinv=(proj["Vinv"], "mat"), V=(proj["V"], "mat")
    )
    with torch.cuda.device(device):
        out, route = _dense_run(h, proj, 0, n)
        LAUNCHES["passB" + route] += 1
    return out


def passB_fold(h, proj):
    """Radix-2 folded pass B (``proj["fold_levels"]`` levels, matrices
    ``proj["fold_mats"]``): ``divhat -> qhat`` on an (n, n, n) field, by
    the route `fold_route` picks on the card (launch key ``passB_fold``
    fused in 3xTF32, ``passB_fold+bf16x3`` fused in bf16x3,
    ``passB_fold+levels`` the level route)."""
    if h.device.type == "cpu":
        return passB_fold_plain(h, proj)
    n = h.shape[0]
    levels = proj["fold_levels"]
    if levels is None or n % 2 ** (levels + 1):
        raise ValueError(f"passB_fold: no {levels}-level fold at n = {n}")
    device = _check_fold("passB_fold", h, proj, n)
    with torch.cuda.device(device):
        out, route = _fold_run(h, proj, 0, n)
        LAUNCHES["passB_fold" + route] += 1
    return out


def make_fused_projection(Np, dxs, dtype, *, precision="manualhigh", device="cuda"):
    """Pieces of the fused pressure projection: ``passB(h) -> qhat`` (the
    folded pass B where n % 4 == 0, else the dense one; ``passB_plain``
    the same choice's plain version) and the transform matrices (Vinv,
    VinvT, V, VT) the stage and correction kernels take, each split once
    here, like the fold matrices, into the fragments of ``precision``'s
    form of the plane-transform and fused pass B kernels
    (`transforms.split_basis`: bf16 hi/lo parts for "manualhigh", TF32
    big/small parts for "highest").  ``precision`` is the module
    docstring's contract: "manualhigh" (the default) the JAX package's
    3-pass bf16 class on float32 operands, "highest" the float32 class;
    float64 operands exact under both.  The dict keeps it as
    ``_prec(proj)``: pass B takes its form from it."""
    check_precision(precision)
    if not (len(Np) == 3 and Np[0] == Np[1] == Np[2]):
        raise ValueError(f"the fused projection needs a cube, got {Np}")
    V, Vinv, eps = poisson_eigen_consts(Np, dxs, dtype, device)
    proj = {
        "Vinv": Vinv,
        "VinvT": Vinv.T.contiguous(),
        "V": V,
        "VT": V.T.contiguous(),
        "eps": eps,
        "dxs": tuple(float(d) for d in dxs),
        "vol": float(np.prod(dxs)),
        "precision": precision,
    }
    if Np[0] % 4 == 0:
        mats, levels, _ = poisson_fold_consts(Np, dxs, dtype, device=device)
        proj.update(fold_mats=mats, fold_levels=levels)
        proj["passB"] = lambda h: passB_fold(h, proj)
        proj["passB_plain"] = lambda h: passB_fold_plain(h, proj)
    else:
        proj.update(fold_mats=None, fold_levels=None)
        proj["passB"] = lambda h: passB(h, proj)
        proj["passB_plain"] = lambda h: passB_plain(h, proj)
    # the basis operands of the transforms: V_z^T as B (the field as A),
    # V_y and every x matrix as A (the field as B: the plane GEMM's and the
    # fused pass B's)
    for w in (proj["VT"], proj["VinvT"]):
        split_basis(w, "b", precision)
    for w in (proj["V"], proj["Vinv"], *(proj["fold_mats"] or ())):
        split_basis(w, "a", precision)
    return proj


def make_poisson_pallas(Np, dxs, dtype, *, precision="manualhigh", device="cuda",
                        plain=False):
    """``solve(f) -> p`` of the volume-scaled periodic Laplacian on a cube
    (the zero-mean mode pinned to 0): the same solve as `make_poisson_mm`
    in three passes, ``V_y·(passB(Vinv_y·f·Vinv_zᵀ))·V_zᵀ``, every product
    in ``precision``'s form (the module docstring's contract; the JAX
    package passes its ``precision`` to all three passes).  On CUDA
    tensors each pass is its hand-written kernels (counted once per solve
    under ``"poisson_pallas"``); on CPU tensors, or with ``plain=True`` on
    any device, the plain versions."""
    proj = make_fused_projection(Np, dxs, dtype, precision=precision, device=device)
    passB_fn = proj["passB_plain" if plain else "passB"]
    Vinv, VinvT, V, VT = proj["Vinv"], proj["VinvT"], proj["V"], proj["VT"]

    def solve(f):
        if plain or f.device.type == "cpu":
            h = passB_fn(yz_transform_plain(f, Vinv, VinvT, precision))
            return yz_transform_plain(h, V, VT, precision, inverse=True)
        with torch.cuda.device(f.device):
            p = yz_transform(passB_fn(yz_transform(f, Vinv, VinvT, precision)), V, VT,
                             precision, inverse=True)
            LAUNCHES["poisson_pallas"] += 1
        return p

    return solve


def passB_sharded_plain(h, proj, yoff):
    """Plain PyTorch version of `passB_sharded`."""
    note_plain(fused_key("passB_sharded", _prec(proj)), h)
    if proj["fold_levels"]:
        return _fold_plain(h, proj, 0, 1, int(yoff))
    return _dense_plain(h, proj, int(yoff))


def passB_sharded(h, proj, yoff):
    """Pass B of an x-slab-sharded projection on a shard's (n, ly, n)
    y-slice with full x, whose first y-mode is ``yoff``: the folded pass B
    where n % 4 == 0 (on the card by `fold_route`'s route: launch key
    ``passB_sharded`` fused in 3xTF32, ``passB_sharded+bf16x3`` fused in
    bf16x3, ``passB_sharded+levels`` the level route), else the dense one
    (the projection's choice; by `dense_route`'s route: ``passB_sharded``
    or ``passB_sharded+bf16x3`` fused, ``passB_sharded+gemm`` the GEMM
    route)."""
    if h.device.type == "cpu":
        return passB_sharded_plain(h, proj, yoff)
    n, ly = proj["V"].shape[0], proj["ly"]
    yoff = int(yoff)
    if not 0 <= yoff <= n - ly:
        raise ValueError(f"passB_sharded: yoff {yoff} outside [0, {n - ly}]")
    fold = proj["fold_levels"]
    device = (_check_fold("passB_sharded", h, proj, ly) if fold
              else check_cuda_tensors("passB_sharded", (torch.float32,), h=(h, (n, ly, n))))
    with torch.cuda.device(device):
        out, route = (_fold_run if fold else _dense_run)(h, proj, yoff, ly)
        LAUNCHES["passB_sharded" + route] += 1
    return out


def make_passB_sharded(Np, dxs, dtype, ly, *, precision="manualhigh", device="cuda"):
    """Pass B of an x-slab-sharded fused projection (the port of
    `make_passB_sharded`, poisson_pallas.py:480): after the x<->y
    all-to-all each shard holds an (n, ly, n) y-slice of divhat with full
    x, so the x-forward / eigen-scale / x-inverse runs on it alone; only
    the eigen-scale's y-modes depend on the shard, through ``yoff`` (the
    rank times ly).  Returns `make_fused_projection`'s dict with
    ``passB(h_local, yoff) -> qhat_local`` and ``passB_plain`` replaced
    by the sharded forms."""
    n = Np[0]
    if not 1 <= ly <= n or n % ly:
        raise ValueError(f"make_passB_sharded: ly = {ly} must divide n = {n}")
    proj = make_fused_projection(Np, dxs, dtype, precision=precision, device=device)
    proj["ly"] = ly
    proj["passB"] = lambda h, yoff: passB_sharded(h, proj, yoff)
    proj["passB_plain"] = lambda h, yoff: passB_sharded_plain(h, proj, yoff)
    return proj
