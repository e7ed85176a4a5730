"""Spectral pressure solve and the periodic projection.

Port of `psolver_spectral` from `ins_tpu/ops/pressure.py` (its FFT
branch, here on `torch.fft` for any device, applied to the ghost-free
interior array) and of the periodic projection the fast path's roll twin
and `random_field` use.  The solve is the
volume-scaled periodic Laplacian, diagonal in Fourier space with
eigenvalues ``-4 vol sin²(πk/N)/Δx²`` summed over dimensions; the k = 0
mode (zero-mean pressure) is pinned to 0.  `default_psolver` picks the
FDM solve (`ops/fdm.py`) on other grids; CG and the host direct solver
wait for ROADMAP queue 1 item 7.
"""

from __future__ import annotations

import numpy as np
import torch

from .diffkernels import roll_m, roll_p
from .fdm import psolver_fdm

__all__ = ["psolver_spectral", "default_psolver", "project_periodic", "uniform_dxs"]


def uniform_dxs(setup):
    """Grid spacing per dimension of a uniform grid."""
    return tuple(float(setup.grid.delta[d][0]) for d in range(setup.grid.dim))


def _spectral_solve(Np, dxs, dtype, device):
    D = len(Np)
    vol = float(np.prod(dxs))
    kmax = tuple(Np[d] // 2 + 1 if d == D - 1 else Np[d] for d in range(D))
    denom = np.zeros(kmax, dtype=np.float64)
    for d in range(D):
        k = np.arange(kmax[d])
        a = 4.0 * vol * np.sin(np.pi * k / Np[d]) ** 2 / dxs[d] ** 2
        denom = denom + a.reshape(tuple(-1 if i == d else 1 for i in range(D)))
    denom[(0,) * D] = 1.0  # avoid 0/0
    inv = -1.0 / denom
    inv[(0,) * D] = 0.0  # zero-mean pressure folded into the multiplier
    inv_denom = torch.as_tensor(inv, dtype=dtype, device=device)

    def solve(f):
        fhat = torch.fft.rfftn(f)
        return torch.fft.irfftn(fhat * inv_denom, s=f.shape).to(f.dtype)

    return solve


def psolver_spectral(setup):
    """FFT Poisson solver on a uniform periodic grid: ``psolve(f) -> p``
    on the interior (ghost-free) array the fast path carries."""
    g = setup.grid
    if not (all(g.periodic) and all(g.uniform)):
        raise ValueError("Spectral psolver requires a uniform periodic grid")
    psolve = _spectral_solve(g.Np, uniform_dxs(setup), setup.dtype, setup.device)
    psolve.is_spectral = True  # enables the ghost-free periodic fast path
    return psolve


def default_psolver(setup):
    """Spectral on uniform periodic grids, the fast-diagonalization direct
    solve (`ops/fdm.psolver_fdm`) otherwise, as in the JAX package."""
    g = setup.grid
    if all(g.periodic) and all(g.uniform):
        return psolver_spectral(setup)
    return psolver_fdm(setup)


def project_periodic(u, dxs, solve):
    """Divergence-free part of an interior periodic field `(D, *n)`:
    ``u − G p`` with ``L p = vol·div u`` (backward-difference divergence,
    forward-difference gradient)."""
    D = u.shape[0]
    vol = float(np.prod(dxs))
    div = sum((u[a] - roll_m(u[a], a)) / dxs[a] for a in range(D)) * vol
    p = solve(div)
    G = torch.stack([(roll_p(p, a) - p) / dxs[a] for a in range(D)])
    return u - G
