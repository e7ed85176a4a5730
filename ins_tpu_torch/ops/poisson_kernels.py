"""Pass B of the fused pressure projection on a periodic cube.

Port of `poisson_eigen_consts` and `make_fused_projection` from
`ins_tpu/ops/poisson_pallas.py`.  The fused projection splits the
fast-diagonalization Poisson solve across three kernels: the stage
kernel emits ``divhat = Vinv_y · (vol·div) · Vinv_zᵀ`` per x-plane, pass
B here solves in x, and the correction consumes ``qhat`` with the z/y
inverse transform.  Pass B is

    g    = Vinv_x · divhat                     (x-forward)
    g   *= 1 / (vol·(λx + λy + λz))            (0 where |den| < eps)
    qhat = V_x · g                             (x-inverse)

On CUDA tensors it runs as GEMM (`csrc/transforms.cu`), eigen-scale
kernel (`csrc/poisson.cu`), GEMM; on CPU tensors as its plain version
`passB_plain`.  The dense form computes the same qhat as the JAX
package's radix-2 folded pass B; the fold is a later speed-up.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import _build
from .dft import fourier_eigenbasis
from .launches import LAUNCHES, check_cuda_operands, current_stream, note_plain
from .transforms import x_transform, x_transform_plain

__all__ = [
    "poisson_eigen_consts",
    "make_fused_projection",
    "passB",
    "passB_plain",
]


def poisson_eigen_consts(Np, dxs, dtype, device="cuda"):
    """(V, Vinv, eps) for the cube fast-diagonalization solve; `eps` is
    the nullspace pin threshold (the k = 0 mode, den == 0, maps to 0)."""
    V, Vinv, _ = fourier_eigenbasis(Np[0], dxs[0])
    vol = float(np.prod(dxs))
    maxden = 0.0
    for d in range(3):
        _, _, lam_d = fourier_eigenbasis(Np[d], dxs[d])
        maxden += np.max(np.abs(lam_d)) * vol
    eps = float(1e-12 * maxden)

    def c(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return c(V), c(Vinv), eps


def _lam(idx, dx, n):
    """Second-difference eigenvalue -4 sin^2(pi k / n) / dx^2 at
    frequency k = ceil(idx / 2) (eigenbasis order const, cos_1, sin_1,
    ..., Nyquist)."""
    kk = torch.div(idx + 1, 2, rounding_mode="floor")
    s = torch.sin((math.pi / n) * kk)
    return (-4.0 / (dx * dx)) * s * s


def _inv_den(n, dxs, eps, dtype, device):
    idx = torch.arange(n, dtype=dtype, device=device)
    vol = float(np.prod(dxs))
    den = vol * (
        _lam(idx, dxs[0], n)[:, None, None]
        + _lam(idx, dxs[1], n)[None, :, None]
        + _lam(idx, dxs[2], n)[None, None, :]
    )
    safe = torch.where(den == 0.0, torch.ones_like(den), den)
    return torch.where(den.abs() < eps, torch.zeros_like(den), 1.0 / safe)


def passB_plain(h, proj):
    """Plain PyTorch pass B: einsum x-transforms and the closed-form scale."""
    note_plain("passB", h)
    n = h.shape[0]
    g = x_transform_plain(proj["Vinv"], h)
    g = g * _inv_den(n, proj["dxs"], proj["eps"], h.dtype, h.device)
    return x_transform_plain(proj["V"], g)


def passB(h, proj):
    """Pass B: ``divhat -> qhat`` on an (n, n, n) field."""
    if h.device.type == "cpu":
        return passB_plain(h, proj)
    n = h.shape[0]
    device = check_cuda_operands(
        "passB", n, h=(h, "sca"), Vinv=(proj["Vinv"], "mat"), V=(proj["V"], "mat")
    )
    dx0, dx1, dx2 = proj["dxs"]
    with torch.cuda.device(device):
        g = x_transform(proj["Vinv"], h)
        err = _build.load().ins_eigen_scale_f32(
            g.data_ptr(), n, dx0, dx1, dx2, proj["vol"], proj["eps"],
            current_stream(device),
        )
        _build.check(err, "passB")
        LAUNCHES["passB"] += 1
        return x_transform(proj["V"], g)


def make_fused_projection(Np, dxs, dtype, *, precision="manualhigh", device="cuda"):
    """Pieces of the fused pressure projection: ``passB(h) -> qhat`` and
    the transform matrices (Vinv, VinvT, V, VT) the stage and correction
    kernels take.  ``precision`` is accepted for parity with the JAX
    package; both names run at FP32 ("highest" class) here."""
    if precision not in ("manualhigh", "highest"):
        raise ValueError(f"unknown projection precision {precision!r}")
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
    }
    proj["passB"] = lambda h: passB(h, proj)
    return proj
