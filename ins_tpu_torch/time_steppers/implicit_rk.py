"""Implicit Runge-Kutta stepper: Picard or matrix-free Newton-Krylov.

Port of `ins_tpu/time_steppers/implicit_rk.py` on the general ghosted
path.  The stage system

    G(U) = U - u_0 - dt (A (x) I) f(U) = 0,   f = P o F o BC

is solved by Picard iteration (``newton_type="picard"``: converges in the
contraction regime only) or by Newton-Krylov (``"full"``: the Jacobian
at the current iterate; ``"approximate"``: frozen at u_0).  Each Newton
step solves ``J dU = -G`` by GMRES (`_gmres`), J applied matrix-free as

    J V = V - dt (A (x) I) P jvp(F o BC)(U; V),

the projection P being linear, so the Jacobian's action needs only the
forward-mode derivative of the momentum and its ghost fills
(dual tensors of `torch.autograd.forward_ad`; the fills write into
clones, which forward mode carries).  The loop (`ops.pressure.device_while`,
its flag on the device, read after every iteration) stops at
``|G| <= abstol + reltol·|G_0|``, at ``maxiter`` or where the residual
goes non-finite; the step ends with a projection and ghost fill like
the explicit steppers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.autograd.forward_ad as fwad

from ..boundary_conditions import apply_bc_u
from ..grid import _numpy_dtype
from ..ops.operators import momentum
from ..ops.pressure import device_while, project
from .step import StepperState

__all__ = ["timestep_irk"]


def _jvp(f, u, v):
    """The forward-mode derivative of `f` at `u` along `v`."""
    with fwad.dual_level():
        tangent = fwad.unpack_dual(f(fwad.make_dual(u, v))).tangent
    return torch.zeros_like(u) if tangent is None else tangent


def momentum_bc(u, t, setup, theta=None):
    """F o BC: the momentum right-hand side (with the closure) of the
    filled `u`, its ghosts filled with the Dirichlet values' time
    derivative.  Its projection is a stage's right-hand side; its
    forward-mode derivative, projected, the Newton matvec's."""
    ub = apply_bc_u(u, t, setup)
    F = momentum(ub, None, t, setup)
    if setup.closure_model is not None:
        F = F + setup.closure_model(ub, theta)
    return apply_bc_u(F, t, setup, dudt=True)


def _lstsq(H, b):
    """Least-squares solution of ``H y = b`` by the SVD, with the
    minimum norm where H is rank-deficient (singular values below
    ``eps·max(H.shape)`` of the largest dropped, as `jnp.linalg.lstsq`):
    a Hessenberg matrix after a happy breakdown has a zero row."""
    U, s, Vh = torch.linalg.svd(H, full_matrices=False)
    rcond = float(np.finfo(_numpy_dtype(H.dtype)).eps) * max(H.shape)
    keep = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(keep, 1 / torch.where(keep, s, 1.0), 0.0)
    return Vh.mT @ (s_inv * (U.mT @ b))


def _gmres(matvec, b, *, m=12, cycles=1):
    """Matrix-free GMRES(m) from x = 0: `cycles` restarts of m Arnoldi
    steps (modified Gram-Schmidt) and a small least-squares solve
    (`_lstsq`).  A Krylov space that closes early leaves zero rows in the
    Hessenberg matrix, which the least squares drops."""
    shape, dtype = b.shape, b.dtype
    bf = b.reshape(-1)
    tiny = float(np.finfo(_numpy_dtype(dtype)).tiny) * 1e6

    def mv(x):
        return matvec(x.reshape(shape)).reshape(-1)

    x = torch.zeros_like(bf)
    for _ in range(cycles):
        r = bf - mv(x)
        beta = torch.linalg.vector_norm(r)
        V = [r / (beta + tiny)]
        cols = []
        for j in range(m):
            w = mv(V[j])
            hcol = []
            for i in range(j + 1):
                hij = torch.dot(V[i], w)
                w = w - hij * V[i]
                hcol.append(hij)
            hj1 = torch.linalg.vector_norm(w)
            V.append(w / (hj1 + tiny))
            col = torch.zeros(m + 1, dtype=dtype, device=bf.device)
            col[: j + 2] = torch.stack(hcol + [hj1])
            cols.append(col)
        e1 = torch.zeros(m + 1, dtype=dtype, device=bf.device)
        e1[0] = beta
        y = _lstsq(torch.stack(cols, 1), e1)
        x = x + y @ torch.stack(V[:m])
    return x.reshape(shape)


def timestep_irk(method, state, dt, *, setup, psolver, theta=None, niter=None):
    """One implicit-RK step (Gauss, Radau, Lobatto, SDIRK tableaus of
    `rk_methods`); the stage solver is ``method.newton_type``, at most
    ``niter`` (default ``method.maxiter``) iterations."""
    u0, temp, t0, n = state
    if temp is not None:
        raise ValueError("the implicit RK stepper does not support the temperature equation")
    dtype, device = setup.dtype, setup.device
    A = torch.tensor(method.A, dtype=dtype, device=device)
    b = torch.tensor(method.b, dtype=dtype, device=device)
    s = method.nstage
    maxiter = niter if niter is not None else method.maxiter
    eps = float(np.finfo(_numpy_dtype(dtype)).eps)
    reltol = max(float(method.reltol), 50 * eps)
    abstol = max(float(method.abstol), 0.0)
    ts = [t0 + ci * dt for ci in method.c]

    def stage_rhs(U):
        return torch.stack([project(momentum_bc(U[i], ts[i], setup, theta), setup, psolver=psolver)
                            for i in range(s)])

    def residual(U):
        return U - u0[None] - dt * torch.tensordot(A, stage_rhs(U), dims=([1], [0]))

    def norm(G):
        return torch.sqrt(torch.sum(G * G))

    U0 = u0.expand(s, *u0.shape).clone()
    G0 = residual(U0)
    res0 = norm(G0)
    tol = abstol + reltol * res0

    if method.newton_type == "picard":

        def update(U, G):
            return U - G  # U <- u0 + dt A K(U)

    elif method.newton_type in ("full", "approximate"):

        def update(U, G):
            Ulin = U0 if method.newton_type == "approximate" else U

            def matvec(V):
                dK = torch.stack([
                    project(_jvp(lambda u: momentum_bc(u, ts[i], setup, theta), Ulin[i], V[i]),
                            setup, psolver=psolver)
                    for i in range(s)
                ])
                return V - dt * torch.tensordot(A, dK, dims=([1], [0]))

            return U + _gmres(matvec, -G, m=12, cycles=1)

    else:
        raise ValueError(f"unknown newton_type {method.newton_type!r}")

    def body(c):
        U, G, _ = c
        U = update(U, G)
        G = residual(U)
        return U, G, norm(G)

    (U, _, _), _ = device_while(lambda c: (c[2] > tol) & torch.isfinite(c[2]), body,
                                (U0, G0, res0), maxiter, poll=1)
    u1 = u0 + dt * torch.tensordot(b, stage_rhs(U), dims=([0], [0]))

    t1 = t0 + dt
    u1 = apply_bc_u(u1, t1, setup)
    u1 = project(u1, setup, psolver=psolver)
    u1 = apply_bc_u(u1, t1, setup)
    return StepperState(u=u1, temp=None, t=t1, n=n + 1)
