"""Pressure-Poisson solvers and the projection.

Port of `ins_tpu/ops/pressure.py`: `psolver_spectral` (its FFT branch,
on `torch.fft` for any device), `psolver_cg` (matrix-free preconditioned
conjugate gradients, Jacobi or the fast-diagonalization solve as the
preconditioner), `default_psolver`, the self-adjoint `poisson`, and
`pressure` and `project` of the general ghosted path, plus the periodic
projection the fast path's roll twin and `random_field` use.

**The solver contract.**  Every psolver of the port maps the
volume-scaled right-hand side on the interior pressure box (``Np``, no
ghosts) to the pressure on that box: ``psolve(fbox) -> pbox``.  The fast
and channel paths carry ghost-free fields and call it directly; the
ghosted path's `pressure` and `project` cut the box ``grid.Ip`` out of
their ghosted right-hand side, solve it through `poisson` (the solver
with its self-adjoint VJP, on the solver's own domain) and put the
solution on a zero-ghosted field, as the JAX package's solvers leave
it.  So any solver `solve_unsteady` is handed works on every path that
takes it.

The spectral solve is the volume-scaled periodic Laplacian, diagonal in
Fourier space with eigenvalues ``-4 vol sin²(πk/N)/Δx²`` summed over
dimensions; the k = 0 mode (zero-mean pressure) is pinned to 0.
`default_psolver` picks the FDM solve (`ops/fdm.py`) on other grids.
The assembled-matrix CG and the host direct solver (`psolver_cg_matrix`,
`psolver_direct`) wait for ROADMAP queue 1 item 7.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..boundary_conditions import PressureBC, apply_bc_p, apply_bc_u
from ..grid import _numpy_dtype
from ._stencil import dseg, slc
from .diffkernels import roll_m, roll_p
from .fdm import fdm_solve_box, laplacian_box, psolver_fdm
from .operators import _on_box, applypressure, divergence, momentum, scalewithvolume

__all__ = [
    "psolver_spectral",
    "psolver_cg",
    "default_psolver",
    "poisson",
    "pressure",
    "project",
    "project_periodic",
    "uniform_dxs",
]

# How often the CG loop reads its stop flag on the host (a device sync):
# after its first iteration and then every this many (`psolver_cg`).
CG_POLL = 16


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


# --------------------------------------------------------------------------
# Matrix-free preconditioned CG
# --------------------------------------------------------------------------


def _is_singular(setup):
    """Without a PressureBC the Laplacian has the constants as nullspace."""
    return not any(isinstance(bc, PressureBC) for bcs in setup.boundary_conditions for bc in bcs)


def psolver_cg(setup, *, abstol=0.0, reltol=None, maxiter=None, precond="jacobi"):
    """Matrix-free preconditioned CG on the interior pressure box
    (`ins_tpu.psolver_cg`).  ``precond``: "jacobi" (the diagonal of the
    Laplacian with the unmodified centre coefficient, `grid.plap_diag`) or
    "fdm" (the fast-diagonalization solve `fdm_solve_box`, the exact
    inverse on a separable grid).  The Laplacian is `fdm.laplacian_box`,
    the ghosted Laplacian's interior rows after `apply_bc_p`.

    Without a `PressureBC` the right-hand side is projected onto the
    zero-sum fields and the solution's mean is pinned to zero, which keeps
    the solve map symmetric (the self-adjoint `poisson` VJP is exact).

    The loop keeps its stop condition on the device: each iteration is
    computed, and p, r, q, ρ and the residual are frozen by `torch.where`
    once the residual is at or below ``max(reltol·|f|, abstol)`` (or from
    the start where |f| is), so the result equals a loop that stops at
    the same iteration as the JAX `lax.while_loop`.  To end the loop
    early the host reads the flag (a device sync) after the first
    iteration and then every `CG_POLL` iterations; the iterations run
    between two reads after convergence are frozen.  The iteration count
    of the last call is ``psolve.iterations`` (a 0-d tensor on the
    device)."""
    g = setup.grid
    dtype, device = setup.dtype, setup.device
    if reltol is None:
        reltol = math.sqrt(float(np.finfo(_numpy_dtype(dtype)).eps))
    if maxiter is None:
        maxiter = int(np.prod(g.Np))
    lap = laplacian_box(setup)

    if precond == "fdm":
        apply_precond = fdm_solve_box(setup)
    elif precond == "jacobi":
        dg = setup.dgrid
        om = 1.0
        for d in range(g.dim):
            om = om * dseg(dg.delta[d], g.Ip, d)
        diag = 0.0
        for d in range(g.dim):
            diag = diag + om / dseg(dg.delta[d], g.Ip, d) * dg.plap_diag[d]

        def apply_precond(r):
            return -r / diag
    else:
        raise ValueError(f"unknown precond {precond!r}")

    issingular = _is_singular(setup)
    npoints = float(np.prod(g.Np))

    def psolve(f):
        if issingular:
            f = f - torch.sum(f) / npoints
        r = f
        residual = torch.sqrt(torch.sum(r * r))
        tolerance = torch.clamp(reltol * residual, min=abstol)
        p = torch.zeros_like(f)
        q = torch.zeros_like(f)
        rho_prev = torch.ones((), dtype=f.dtype, device=f.device)
        active = residual > tolerance
        iters = torch.zeros((), dtype=torch.int32, device=f.device)
        for it in range(maxiter):
            z = apply_precond(r)
            rho = torch.sum(z * r)
            q_new = z + (rho / rho_prev) * q
            Lq = lap(q_new)
            alpha = rho / torch.sum(q_new * Lq)
            p = torch.where(active, p + alpha * q_new, p)
            r = torch.where(active, r - alpha * Lq, r)
            q = torch.where(active, q_new, q)
            rho_prev = torch.where(active, rho, rho_prev)
            residual = torch.where(active, torch.sqrt(torch.sum(r * r)), residual)
            iters = iters + active.to(torch.int32)
            active = active & (residual > tolerance)
            done = it + 1
            if done < maxiter and (done == 1 or done % CG_POLL == 0) and not bool(active):
                break
        if issingular:
            # zero-mean gauge: the solve map is P0 L+ P0, symmetric
            p = p - torch.sum(p) / npoints
        psolve.iterations = iters
        return p

    psolve.is_cg = True
    psolve.iterations = None
    return psolve


# --------------------------------------------------------------------------
# poisson / pressure / project
# --------------------------------------------------------------------------


class _Poisson(torch.autograd.Function):
    """``psolver`` as its own adjoint (the Laplacian is self-adjoint)."""

    @staticmethod
    def forward(ctx, f, psolver):
        ctx.psolver = psolver
        return psolver(f).to(f.dtype)

    @staticmethod
    def backward(ctx, phibar):
        return _Poisson.apply(phibar, ctx.psolver), None


def poisson(psolver, f):
    """Solve the pressure-Poisson equation for the volume-scaled
    right-hand side `f` on the solver's domain (the interior pressure
    box, see the module docs).  Differentiable: the VJP applies the same
    solve to the cotangent (the JAX package's custom VJP)."""
    return _Poisson.apply(f, psolver)


def _solve_ghosted(psolver, div, setup):
    """`poisson` on the pressure box of the ghosted `div`, on a zero
    field."""
    box = setup.grid.Ip
    return _on_box(setup, box, poisson(psolver, div[slc(box)]))


def pressure(u, temp, t, setup, *, psolver):
    """Pressure consistent with a ghosted velocity field: the solve of the
    divergence of the momentum right-hand side (with the Dirichlet
    values' time derivative in its ghosts), ghost-filled."""
    F = momentum(u, temp, t, setup)
    F = apply_bc_u(F, t, setup, dudt=True)
    div = scalewithvolume(divergence(F, setup), setup)
    return apply_bc_p(_solve_ghosted(psolver, div, setup), t, setup)


def project(u, setup, *, psolver):
    """Divergence-free part of a ghosted velocity field: ``u − G p`` with
    ``L p = Ω div u``; the ghosts of `u` are left as they were."""
    div = scalewithvolume(divergence(u, setup), setup)
    p = apply_bc_p(_solve_ghosted(psolver, div, setup), 0.0, setup)
    return applypressure(u, p, setup)
