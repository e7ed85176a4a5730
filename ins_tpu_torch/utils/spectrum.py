"""Energy-spectrum binning.

Port of `spectral_stuff` and `observe_spectrum` from
`ins_tpu/utils/spectrum.py`: dyadic bins in 2-D (the k^-3 inertial
slope), linear bins in 3-D (k^-5/3).  In 2-D the bins overlap and are
kept as a dense (npoint, *K) mask, reduced with one masked matmul; in 3-D
they are disjoint and a cell -> bin map is reduced with one
`index_add_` (a segment sum), which needs O(prod(K)) memory instead of
the mask's O(npoint · prod(K)).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["spectral_stuff", "observe_spectrum"]


def spectral_stuff(setup, *, npoint=100, a=(1 + math.sqrt(5)) / 2):
    """Precompute spectrum bins on `setup.device`: ``kappa`` (integer
    query wavenumbers, log-spaced), ``K`` (per-dimension wavenumber
    counts), and ``masks`` (2-D, (len(kappa), *K) float) or ``bin_id``
    (3-D, (*K,) int64 cell -> bin, len(kappa) for "no bin")."""
    g = setup.grid
    D = g.dim
    K = tuple(n // 2 for n in g.Np)

    kk = np.zeros(K)
    for d in range(D):
        kd = np.arange(K[d]).reshape(tuple(-1 if i == d else 1 for i in range(D)))
        kk = kk + kd.astype(np.float64) ** 2
    k = np.sqrt(kk)

    kmax = min(K) - 1
    kappa = np.unique(
        np.round(np.exp(np.linspace(np.log(1.0), np.log(kmax), npoint))).astype(int)
    )

    dev = setup.device
    out = dict(kappa=torch.as_tensor(kappa, device=dev), K=K)
    if D == 2:
        masks = [(k >= kap / a) & (k < kap * a) for kap in kappa]
        out["masks"] = torch.as_tensor(np.stack(masks), dtype=setup.dtype, device=dev)
    else:
        # integer shell floor(k + tol); shells absent from kappa go to the
        # overflow bin len(kappa), dropped after the sum
        tol = 0.01
        shell = np.floor(k + tol).astype(np.int64)
        lut = np.full(int(shell.max()) + 2, len(kappa), dtype=np.int64)
        lut[kappa] = np.arange(len(kappa), dtype=np.int64)
        out["bin_id"] = torch.as_tensor(lut[shell], device=dev)
    return out


def observe_spectrum(u_hat_energy, st):
    """Bin a spectral energy field with `spectral_stuff` bins."""
    e = u_hat_energy.reshape(-1)
    nk = st["kappa"].shape[0]
    if "bin_id" in st:
        acc = torch.zeros(nk + 1, dtype=e.dtype, device=e.device)
        return acc.index_add_(0, st["bin_id"].reshape(-1), e)[:nk]
    return st["masks"].reshape(nk, -1).to(e.dtype) @ e
