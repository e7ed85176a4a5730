"""Real Fourier eigenbasis of the periodic second difference.

Port of `fourier_eigenbasis` from `ins_tpu/ops/dft.py` (float64 numpy,
identical arithmetic).  The eigen-transforms of the fused projection
(`ops/poisson_kernels.py`, `ops/stage_kernels.py`) are products with
these matrices.
"""

from __future__ import annotations

import numpy as np

__all__ = ["fourier_eigenbasis"]


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
