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
`psolver_cg_matrix` runs Jacobi CG on the assembled Laplacian
(`ops/matrices.laplacian_mat`) as a sparse CSR tensor on the setup's
device; `psolver_direct` factors the same matrix once on the host and
solves there, one copy to the host and one back a solve.

The loops that stop on a residual (`psolver_cg`, `psolver_cg_matrix`,
and the implicit steppers' CG and Newton loops) keep their stop flag on
the device through one driver, `device_while`.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ..boundary_conditions import PressureBC, apply_bc_p, apply_bc_u
from ..grid import _numpy_dtype
from ._stencil import dseg, slc
from .diffkernels import roll_m, roll_p
from .fdm import fdm_solve_box, laplacian_box, psolver_fdm
from .matrices import laplacian_mat
from .operators import _on_box, applypressure, divergence, momentum, scalewithvolume

__all__ = [
    "psolver_spectral",
    "psolver_cg",
    "psolver_cg_matrix",
    "psolver_direct",
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
# Loops with their stop flag on the device
# --------------------------------------------------------------------------


def device_while(cond, body, carry, maxiter, poll=None):
    """``lax.while_loop(cond, body, carry)`` of at most `maxiter`
    iterations, its stop flag kept on the device.  `carry` is a tuple of
    tensors, ``body(carry)`` returns the next one and ``cond(carry)`` a
    0-d bool tensor.  Each iteration is computed, and the carry is
    frozen by `torch.where` once `cond` fails (or from the start where
    it fails on the initial carry), so the result equals a loop that
    stops at the same iteration.  To end the loop early the host reads
    the flag (a device sync) after the first iteration and then every
    `poll` iterations; the iterations run between two reads after the
    stop are frozen.  The CG loops, whose iterations are a few kernels,
    read every `CG_POLL` (``poll=None``, read at the call); the Newton
    loop, whose iteration is a GMRES solve of hundreds of kernels, every
    iteration (``poll=1``).  Returns the final carry and the number of
    iterations run unfrozen (a 0-d int32 tensor on the device)."""
    if poll is None:
        poll = CG_POLL
    active = cond(carry)
    iters = torch.zeros((), dtype=torch.int32, device=active.device)
    for it in range(maxiter):
        carry = tuple(torch.where(active, new, old) for new, old in zip(body(carry), carry))
        iters = iters + active.to(torch.int32)
        active = active & cond(carry)
        done = it + 1
        if done < maxiter and (done == 1 or done % poll == 0) and not bool(active):
            break
    return carry, iters


def _default_reltol(dtype):
    return math.sqrt(float(np.finfo(_numpy_dtype(dtype)).eps))


def _pcg(f, matvec, precond, reltol, abstol, maxiter):
    """Preconditioned CG from p = 0 on ``matvec p = f``: stops where the
    residual is at or below ``max(reltol·|f|, abstol)``.  Returns the
    solution and the iteration count."""
    residual = torch.sqrt(torch.sum(f * f))
    tolerance = torch.clamp(reltol * residual, min=abstol)
    zero = torch.zeros_like(f)
    one = torch.ones((), dtype=f.dtype, device=f.device)

    def body(c):
        p, r, q, rho_prev, _ = c
        z = precond(r)
        rho = torch.sum(z * r)
        q = z + (rho / rho_prev) * q
        Lq = matvec(q)
        alpha = rho / torch.sum(q * Lq)
        r = r - alpha * Lq
        return p + alpha * q, r, q, rho, torch.sqrt(torch.sum(r * r))

    (p, *_), iters = device_while(lambda c: c[4] > tolerance, body,
                                  (zero, f, zero, one, residual), maxiter)
    return p, iters


# --------------------------------------------------------------------------
# Matrix-free preconditioned CG
# --------------------------------------------------------------------------


def _is_singular(setup):
    """Without a PressureBC the Laplacian has the constants as nullspace."""
    return not any(isinstance(bc, PressureBC) for bcs in setup.boundary_conditions for bc in bcs)


def _centering(setup):
    """Where the Laplacian is singular, the map onto the zero-sum fields
    (applied to the right-hand side and to the solution: the solve map
    is then P0 L+ P0, symmetric, so the self-adjoint `poisson` VJP is
    exact); else the identity."""
    if not _is_singular(setup):
        return lambda x: x
    npoints = float(np.prod(setup.grid.Np))
    return lambda x: x - torch.sum(x) / npoints


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

    The loop is `device_while`: its result equals the JAX
    `lax.while_loop`'s at the same stopping iteration, and the host reads
    the stop flag after the first iteration and every `CG_POLL`.  The
    iteration count of the last call is ``psolve.iterations`` (a 0-d
    tensor on the device)."""
    g = setup.grid
    if reltol is None:
        reltol = _default_reltol(setup.dtype)
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

    center = _centering(setup)

    def psolve(f):
        p, psolve.iterations = _pcg(center(f), lap, apply_precond, reltol, abstol, maxiter)
        return center(p)

    psolve.is_cg = True
    psolve.iterations = None
    return psolve


# --------------------------------------------------------------------------
# The assembled Laplacian: CG on the card, a direct solve on the host
# --------------------------------------------------------------------------


def psolver_cg_matrix(setup, *, abstol=0.0, reltol=None, maxiter=None):
    """Jacobi CG on the assembled pressure Laplacian
    (`ins_tpu.psolver_cg_matrix`): `ops.matrices.laplacian_mat`, built
    once on the host at the setup's dtype, becomes a sparse CSR tensor on
    the setup's device, and the CG (`device_while`, as `psolver_cg`) runs
    on the flat pressure DOFs with its product.  The singular case is
    handled by the zero-mean projection.  Prefer `psolver_cg` (the
    matrix-free stencil) or `psolver_fdm` for speed; this one serves an
    operator inspected or modified as a matrix.  The iteration count of
    the last call is ``psolve.iterations``."""
    g = setup.grid
    if reltol is None:
        reltol = _default_reltol(setup.dtype)
    if maxiter is None:
        maxiter = int(np.prod(g.Np))
    L = laplacian_mat(setup)
    diag = L.diagonal()
    diag = np.where(np.abs(diag) > 0, diag, 1.0)
    kw = dict(dtype=setup.dtype, device=setup.device)
    Lt = torch.sparse_csr_tensor(
        torch.as_tensor(L.indptr, dtype=torch.int64), torch.as_tensor(L.indices, dtype=torch.int64),
        torch.as_tensor(L.data), size=L.shape, **kw)
    invdiag = torch.as_tensor(1.0 / diag, **kw)

    center = _centering(setup)

    def psolve(f):
        x, psolve.iterations = _pcg(center(f.reshape(-1)), lambda q: Lt @ q,
                                    lambda r: r * invdiag, reltol, abstol, maxiter)
        return center(x).reshape(f.shape)

    psolve.is_cg = True
    psolve.iterations = None
    return psolve


def psolver_direct(setup):
    """Direct solve by a sparse LU of `ops.matrices.laplacian_mat`
    (`ins_tpu.psolver_direct`), factored once in float64 on the host by
    SuperLU (`scipy.sparse.linalg.splu`) under a minimum-degree ordering
    of A' + A, the Laplacian's structure being symmetric (less fill than
    the default column ordering, so a cheaper solve); where no
    `PressureBC` makes the Laplacian definite, the
    bordered system ``[L e; e' 0]`` pins the constant.  Every solve is a
    host solve: the right-hand side is copied to the host and the
    solution back to its device (rounded to its dtype), so on the card it
    costs two copies and a wait, and does not belong in a hot loop (nor
    does JAX's, a host callback).  It is never swapped for another
    solver."""
    L = laplacian_mat(setup)
    n = L.shape[0]
    if _is_singular(setup):
        e = np.ones((n, 1))
        A = sp.bmat([[L, e], [e.T, None]], format="csc")
    else:
        A = sp.csc_matrix(L)
    lu = spla.splu(A.astype(np.float64), permc_spec="MMD_AT_PLUS_A")

    def host_solve(fvec):
        if A.shape[0] == n:
            return lu.solve(fvec)
        return lu.solve(np.concatenate([fvec, [0.0]]))[:n]

    def psolve(f):
        fvec = f.detach().reshape(-1).to(device="cpu", dtype=torch.float64).numpy()
        x = torch.from_numpy(host_solve(fvec)).to(f.dtype)
        return x.to(f.device).reshape(f.shape)

    psolve.is_direct = True
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
