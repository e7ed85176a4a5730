"""Real Fourier eigenbasis of the periodic second difference, and the
eigen-matmul Poisson solve.

Port of `fourier_eigenbasis` and `make_poisson_mm` from
`ins_tpu/ops/dft.py` (float64 numpy constants, identical arithmetic).
The eigen-transforms of the fused projection (`ops/poisson_kernels.py`,
`ops/stage_kernels.py`) are products with these matrices;
`make_poisson_mm` is the per-op chain's Poisson solve on the card, as
plain FP32 tensor contractions (the JAX package leaves it to XLA as
well), which autograd differentiates natively.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["fourier_eigenbasis", "make_poisson_mm"]


def fourier_eigenbasis(n, dx):
    """Real orthonormal eigenbasis of the periodic 1-D second-difference
    operator on `n` points with spacing `dx` (float64).

    Returns (V, Vinv, lam): columns of V are the constant mode, cos/sin
    pairs, and (even n) the Nyquist mode, delta-orthonormal so that
    V^T diag(dx) V = I; lam[k] = -4 sin^2(pi k / n) / dx^2 repeated per
    pair — the eigenvalues of the stencil (1, -2, 1)/dx^2.
    """
    j = np.arange(n)
    cols = [np.full(n, 1.0)]
    lams = [0.0]
    for k in range(1, n // 2 + 1):
        lam_k = -4.0 * np.sin(np.pi * k / n) ** 2 / dx**2
        if 2 * k < n:
            cols.append(np.sqrt(2.0) * np.cos(2 * np.pi * k * j / n))
            cols.append(np.sqrt(2.0) * np.sin(2 * np.pi * k * j / n))
            lams.extend([lam_k, lam_k])
        else:  # Nyquist (even n): alternating +-1
            cols.append(np.cos(np.pi * j))
            lams.append(lam_k)
    V = np.stack(cols, axis=1) / np.sqrt(n * dx)
    Vinv = V.T * dx
    return V, Vinv, np.asarray(lams)


def make_poisson_mm(Np, dxs, dtype, device="cuda"):
    """Solve L p = f on a uniform periodic box by fast diagonalization in
    the real Fourier basis, as 2·D tensor contractions: L is the
    volume-scaled Laplacian (row: Σ_d (p[+d] − 2p + p[−d])·vol/dx_d²)
    and the zero-mean (nullspace) mode is pinned to 0."""
    D = len(Np)
    vol = float(np.prod(dxs))
    Vs, Vinvs = [], []
    den = 0.0
    eps = 0.0
    for d in range(D):
        V, Vinv, lam = fourier_eigenbasis(Np[d], dxs[d])
        Vs.append(torch.as_tensor(V, dtype=dtype, device=device))
        Vinvs.append(torch.as_tensor(Vinv, dtype=dtype, device=device))
        eps += float(np.max(np.abs(lam * vol)))
        shape = [-1 if i == d else 1 for i in range(D)]
        den = den + torch.as_tensor(lam * vol, dtype=dtype, device=device).reshape(shape)
    eps = 1e-12 * eps
    pinned = den.abs() < eps
    den = torch.where(den == 0.0, torch.ones_like(den), den)

    def tdot(m, x, axis):
        return torch.movedim(torch.tensordot(m, x, dims=([1], [axis])), 0, axis)

    def solve(f):
        x = f
        for d in range(D):
            x = tdot(Vinvs[d], x, d)
        x = torch.where(pinned, torch.zeros_like(x), x / den)
        for d in range(D):
            x = tdot(Vs[d], x, d)
        return x

    return solve
