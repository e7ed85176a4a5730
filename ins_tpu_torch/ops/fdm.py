"""Fast-diagonalization (tensor-product) direct Poisson solver.

Port of `ins_tpu/ops/fdm.py`.  The pressure Laplacian on a
tensor-product grid is separable, L = Omega * sum_d K_d, and each 1-D
operator solves the generalized symmetric eigenproblem
M_d v = lambda diag(Delta_d) v, so

    p = (x V_d) [ (x V_d^-1) (f / Omega) / (sum_d lambda_d) ]

— D contractions in, a diagonal solve, D contractions out.  The
eigendecompositions are computed once per setup on the host, in float64
(`scipy.linalg.eigh`).  The contractions are plain matrix products
(`torch.matmul`, as the JAX package leaves its `tensordot`s to XLA); on
the card they run in full FP32 as long as
`torch.backends.cuda.matmul.allow_tf32` stays False (PyTorch's default),
which is at least as accurate as the TPU's 3-pass-bf16 "high".

Like every psolver of the port (`ops/pressure.py`), `psolver_fdm` solves
on the interior (ghost-free) box: ``psolve(f) -> p`` with f the
volume-scaled right-hand side.  Its iterative refinement applies
`laplacian_box`, the interior rows of the ghosted Laplacian after
`apply_bc_p` (the JAX package refines against that): periodic
neighbours wrap, a `SymmetricBC` side reads its own boundary cell (the
ghost copies it), and Dirichlet / pressure sides have zero ghost
coefficients in `lap_c`.
"""

from __future__ import annotations

import logging

import numpy as np
import scipy.linalg
import torch

from ..boundary_conditions import PressureBC, SymmetricBC
from ..grid import _numpy_dtype
from ._stencil import seg
from .diffkernels import roll_m, roll_p

__all__ = [
    "psolver_fdm",
    "fdm_solve_box",
    "fdm_null_modes",
    "fdm_transform_roundoff",
    "laplacian_box",
    "om_box",
]


_log = logging.getLogger(__name__)

def _box_delta(g, d):
    return np.asarray(g.delta[d], np.float64)[g.Ip[d][0] : g.Ip[d][1]]


def fdm_transform_roundoff(setup):
    """Host-side estimate of the relative roundoff the working dtype's
    eigen transforms leave in a `fdm_solve_box` round trip: per axis,
    ``max ||V (V^T diag(delta) x) - x|| / ||x||`` over a random probe,
    computed in the working precision."""
    g = setup.grid
    wdt = _numpy_dtype(setup.dtype)
    rng = np.random.RandomState(0)
    err = 0.0
    for d in range(g.dim):
        delta = _box_delta(g, d)
        lam, V = scipy.linalg.eigh(_one_dim_operator(setup, d), np.diag(delta))
        V32 = V.astype(wdt)
        Vinv32 = (V.T * delta[None, :]).astype(wdt)
        x = rng.randn(len(delta), 8).astype(wdt)
        y = V32 @ (Vinv32 @ x)
        err = max(
            err,
            float(np.linalg.norm(y - x, axis=0).max() / np.linalg.norm(x, axis=0).min()),
        )
    return err


def _one_dim_operator(setup, d):
    """Dense 1-D operator M_d (Np_d x Np_d): row i of
    cl[i] p[i-1] + cc[i] p[i] + cr[i] p[i+1], with the ghost closure of
    the BC folded in (periodic wrap; SymmetricBC ghost = interior copy
    folds into the diagonal; Dirichlet/Pressure rows already have zero
    ghost coefficients in lap_c)."""
    g = setup.grid
    cl, cc, cr = (np.asarray(a, np.float64) for a in g.lap_c[d])
    npd = g.Np[d]
    bcl, bcr = setup.boundary_conditions[d]
    M = np.zeros((npd, npd))
    for i in range(npd):
        M[i, i] = cc[i]
        if i - 1 >= 0:
            M[i, i - 1] = cl[i]
        elif g.periodic[d]:
            M[i, npd - 1] = cl[i]
        elif isinstance(bcl, SymmetricBC):
            M[i, i] += cl[i]  # ghost p[-1] = p[0]
        if i + 1 < npd:
            M[i, i + 1] = cr[i]
        elif g.periodic[d]:
            M[i, 0] = cr[i]
        elif isinstance(bcr, SymmetricBC):
            M[i, i] += cr[i]  # ghost p[np] = p[np-1]
    return M


def _contract(x, mats):
    """Apply ``mats[d]`` along dimension d of x for every d, each as one
    (batched) matrix product on a contiguous view."""
    D = x.dim()
    for d, m in enumerate(mats):
        n = x.shape[d]
        if d == D - 1:
            x = (x.reshape(-1, n) @ m.T).reshape(x.shape)
        else:
            lead = int(np.prod(x.shape[:d], dtype=np.int64))
            x = torch.matmul(m, x.reshape(lead, n, -1)).reshape(x.shape)
    return x


def _axis_spectra(setup):
    """Per axis the generalized eigenpairs ``M_d v = lambda diag(delta) v``
    (float64, host) and the widths delta."""
    g = setup.grid
    out = []
    for d in range(g.dim):
        delta = _box_delta(g, d)
        M = _one_dim_operator(setup, d)
        assert np.allclose(M, M.T, atol=1e-12), "1-D operator not symmetric"
        lam, V = scipy.linalg.eigh(M, np.diag(delta))
        out.append((lam, V, delta))
    return out


def _denominator(lams):
    """``sum_d lambda_d`` over the box."""
    denom = np.zeros(())
    for lam in lams:
        denom = np.add.outer(denom, lam)
    return denom


def _null_mask(setup, lams):
    """The modes of the tensor-product operator that are null: those where
    every axis's eigenvalue is that axis's own null one, the smallest
    |lambda_d| of an axis whose operator annihilates constants (its rows
    sum to zero: periodic, wall and symmetric sides); an axis with a
    pressure side (`PressureBC`) has none.  No epsilon threshold does
    this job: the computed null modes of float32 grids sit up to 4e-9 of
    max|lambda_d| (the channel's), while the lowest true mode of the
    512² cosine grid sits at 1.3e-9 of it."""
    mask = np.ones((), bool)
    for bcs, lam in zip(setup.boundary_conditions, lams):
        null = np.zeros(len(lam), bool)
        if not any(isinstance(bc, PressureBC) for bc in bcs):
            null[np.argmin(np.abs(lam))] = True
        mask = np.logical_and.outer(mask, null)
    return mask


def _sum_cut(denom):
    """The JAX package's null test, ``|sum_d lambda_d| < 1e-8 max|sum|``:
    on a strongly stretched grid it also cuts true modes (kept here only
    to log how many)."""
    return np.abs(denom) < 1e-8 * np.max(np.abs(denom))


def fdm_null_modes(setup):
    """``(per_axis, by_sum)``: how many modes of the setup's pressure box
    the solve classes as null (`_null_mask`) and how many the JAX
    package's sum test cuts.  They differ only where the sum test drops
    true modes."""
    lams = [lam for lam, _, _ in _axis_spectra(setup)]
    return (int(np.count_nonzero(_null_mask(setup, lams))),
            int(np.count_nonzero(_sum_cut(_denominator(lams)))))


def fdm_solve_box(setup):
    """The fast-diagonalization solve map on the interior DOF box:
    ``fbox -> pbox`` with ``L p = f`` solved exactly up to the working
    precision by per-axis eigen contractions."""
    g = setup.grid
    D = g.dim
    dtype, device = setup.dtype, setup.device

    Vs, Vinvs, lams = [], [], []
    for lam, V, delta in _axis_spectra(setup):
        # V is delta-orthonormal: V^T diag(delta) V = I -> V^-1 = V^T diag(delta)
        Vs.append(torch.as_tensor(V, dtype=dtype, device=device))
        Vinvs.append(torch.as_tensor(V.T * delta[None, :], dtype=dtype, device=device))
        lams.append(lam)

    denom = _denominator(lams)
    # zero (nullspace) modes: pinned to zero like the spectral solver's k = 0
    small = _null_mask(setup, lams)
    _log.info("fdm_solve_box %s: %d null modes by the per-axis test, %d by the sum test",
              tuple(g.Np), int(np.count_nonzero(small)),
              int(np.count_nonzero(_sum_cut(denom))))
    denom_safe = np.where(small, 1.0, denom)
    inv_denom = torch.as_tensor(np.where(small, 0.0, 1.0 / denom_safe), dtype=dtype,
                                device=device)

    om = np.ones(g.Np)
    for d in range(D):
        om = om * _box_delta(g, d).reshape([-1 if i == d else 1 for i in range(D)])
    inv_om = torch.as_tensor(1.0 / om, dtype=dtype, device=device)

    def solve_box(fbox):
        fhat = _contract(fbox * inv_om, Vinvs)
        return _contract(fhat * inv_denom, Vs)

    return solve_box


def om_box(setup):
    """Cell volumes over the interior pressure box, as the product of the
    per-axis widths (`ins_tpu/ops/channelpath.py` `_om_box`)."""
    g = setup.grid
    om = 1.0
    for d in range(g.dim):
        om = om * seg(g.delta[d], g.Ip, d, device=setup.device).to(setup.dtype)
    return om


def _shift_m(q, d, mirror):
    """q[I - e_d]; at the low edge q's first plane where the side is
    symmetric (`mirror`), else the wrapped last plane."""
    if not mirror:
        return roll_m(q, d)
    n = q.shape[d]
    return torch.cat([q.narrow(d, 0, 1), q.narrow(d, 0, n - 1)], dim=d)


def _shift_p(q, d, mirror):
    """q[I + e_d]; at the high edge q's last plane where the side is
    symmetric, else the wrapped first plane."""
    if not mirror:
        return roll_p(q, d)
    n = q.shape[d]
    return torch.cat([q.narrow(d, 1, n - 1), q.narrow(d, n - 1, 1)], dim=d)


def laplacian_box(setup):
    """``lap(q)``: the volume-scaled pressure Laplacian on the interior box
    from the BC-aware `lap_c` rows, equal to the interior rows of the
    ghosted Laplacian after `apply_bc_p`.  Periodic rolls wrap correctly;
    a symmetric side reads its boundary cell; the Dirichlet/pressure rows
    have zero ghost coefficients, which kill the wrapped values
    (`ins_tpu/ops/channelpath.py` `channel_laplacian_box`)."""
    g = setup.grid
    dtype, device = setup.dtype, setup.device
    rows = []
    for d in range(g.dim):
        shape = [1] * g.dim
        shape[d] = g.Np[d]
        cl, cc, cr = (torch.as_tensor(v, dtype=dtype, device=device).reshape(shape)
                      for v in g.lap_c[d])
        delta_d = seg(g.delta[d], g.Ip, d, device=device).to(dtype)
        bcl, bcr = setup.boundary_conditions[d]
        rows.append((cl, cc, cr, delta_d, isinstance(bcl, SymmetricBC),
                     isinstance(bcr, SymmetricBC)))
    om = om_box(setup)

    def lap(q):
        acc = 0.0
        for d, (cl, cc, cr, delta_d, sym_l, sym_r) in enumerate(rows):
            part = cr * _shift_p(q, d, sym_r) + cc * q + cl * _shift_m(q, d, sym_l)
            acc = acc + part / delta_d
        return om * acc

    return lap


def psolver_fdm(setup, *, nrefine=None):
    """Direct Poisson solver by fast diagonalization on the interior box
    (see module docs).  ``nrefine``: iterative-refinement sweeps
    ``p += L~^-1 (f - L p)`` (default 1 in float32, 0 in float64)."""
    if nrefine is None:
        nrefine = 1 if setup.dtype == torch.float32 else 0
    solve_box = fdm_solve_box(setup)
    lap = laplacian_box(setup) if nrefine else None

    def psolve(f):
        sol = solve_box(f)
        for _ in range(nrefine):
            sol = sol + solve_box(f - lap(sol))
        return sol

    psolve.is_fdm = True
    psolve.is_direct = True
    return psolve
