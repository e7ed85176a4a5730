"""IMEX Adams-Bashforth/Crank-Nicolson and one-leg steppers.

Port of `ins_tpu/time_steppers/imex.py` on the general ghosted path.
AB-CN takes the convection explicitly (Adams-Bashforth) and the
diffusion implicitly (Crank-Nicolson): the implicit diffusion solve is a
matrix-free CG on the velocity DOFs (`_solve_implicit_diffusion`),
homogeneous ghost fills inside the Krylov loop and the inhomogeneous
boundary values carried by the start field; a pressure correction
follows.  The one-leg beta method (Verstappen) is explicit, with one
pressure correction a step.

Both need one step of history.  The first step (``n == 0``) runs the
method's startup method (RK44 by default) through `step.timestep`,
which restores full order from step one; ``method_startup=False`` keeps
the first-order startup (``c_{-1} = c_0``, ``u_{-1} = u_0``).  `n` is a
Python int, so the choice is a plain branch on the host.  The CG's stop
flag stays on the device (`ops.pressure.device_while`).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..boundary_conditions import apply_bc_p, apply_bc_u
from ..grid import _numpy_dtype
from ..ops._stencil import slc
from ..ops.operators import (
    applybodyforce,
    convection,
    diffusion,
    divergence,
    momentum,
    pressuregradient,
    scalewithvolume,
)
from ..ops.pressure import _solve_ghosted, default_psolver, device_while, pressure

__all__ = [
    "ABCNState",
    "OneLegState",
    "create_stepper_abcn",
    "create_stepper_oneleg",
    "timestep_abcn",
    "timestep_oneleg",
]

# the implicit diffusion CG's iteration limit (the JAX package's)
DIFFUSION_MAXITER = 100


class ABCNState(NamedTuple):
    """AB-CN state: the ghosted velocity, t (a Python float), n (a Python
    int), the convection of the previous step and the current pressure."""

    u: Any
    temp: Any
    t: float
    n: int
    c_prev: Any
    p: Any


class OneLegState(NamedTuple):
    """One-leg state: the ghosted velocity and pressure of this step and
    of the previous one."""

    u: Any
    temp: Any
    t: float
    n: int
    u_prev: Any
    p: Any
    p_prev: Any


def _no_temperature(temp, name):
    if temp is not None:
        raise ValueError(f"the {name} stepper does not support the temperature equation")


def _velocity_mask(setup):
    """True on every component's DOF box ``Iu[alpha]``."""
    g = setup.grid
    m = torch.zeros((g.dim, *g.N), dtype=torch.bool, device=setup.device)
    for a in range(g.dim):
        m[(a,) + slc(g.Iu[a])] = True
    return m


def _solve_implicit_diffusion(rhs, vstart, dt, theta, t, setup, *, maxiter=DIFFUSION_MAXITER):
    """CG solve of ``(I/dt − (1 − theta) D) v = rhs`` on the velocity
    DOFs, the inhomogeneous boundary values carried by `vstart` and
    homogeneous ghost fills inside the Krylov loop; stops at a residual
    of sqrt(eps)·|r_0| or after `maxiter` iterations."""
    mask = _velocity_mask(setup)
    reltol = float(np.sqrt(np.finfo(_numpy_dtype(setup.dtype)).eps))

    def dot(a, b):
        return torch.sum(torch.where(mask, a * b, 0.0))

    def A_hom(w):
        wb = apply_bc_u(w, t, setup, homogeneous=True)
        return wb / dt - (1 - theta) * diffusion(wb, setup)

    r = torch.where(mask, rhs - (vstart / dt - (1 - theta) * diffusion(vstart, setup)), 0.0)
    res0 = torch.sqrt(dot(r, r))
    tol = reltol * res0

    def body(c):
        x, r, p, _ = c
        Ap = torch.where(mask, A_hom(p), 0.0)
        rr = dot(r, r)
        alpha = rr / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rr_new = dot(r, r)
        return x, r, r + (rr_new / rr) * p, torch.sqrt(rr_new)

    (x, *_), _ = device_while(lambda c: c[3] > tol, body,
                              (torch.where(mask, vstart, 0.0), r, r, res0), maxiter)
    return torch.where(mask, x, vstart)


def _correct(div, t1, setup, psolver):
    """The pressure correction of a predictor: the solve of its scaled
    divergence `div` (ghost-filled, `dp`) and ``G dp``."""
    dp = apply_bc_p(_solve_ghosted(psolver, div, setup), t1, setup)
    return dp, pressuregradient(dp, setup)


def _resolve_startup(method):
    ms = method.method_startup
    if ms is None:
        from .rk_methods import RK44

        return RK44()
    return ms or None  # False: the first-order startup


def _startup_step(method_startup, u0, t0, dt, setup, psolver, theta):
    """u after one step of the startup method from (u0, t0)."""
    from .step import StepperState, timestep

    s = StepperState(u=u0, temp=None, t=t0, n=0)
    return timestep(method_startup, s, dt, setup=setup, psolver=psolver, theta=theta).u


def create_stepper_abcn(method, *, setup, psolver=None, u, temp=None, t=0.0):
    """Initial AB-CN state: the filled u, its convection and pressure."""
    _no_temperature(temp, "AB-CN")
    psolver = psolver or default_psolver(setup)
    t = float(t)
    ub = apply_bc_u(u, t, setup)
    return ABCNState(u=ub, temp=None, t=t, n=0, c_prev=convection(ub, setup),
                     p=pressure(ub, None, t, setup, psolver=psolver))


def timestep_abcn(method, state, dt, *, setup, psolver, theta=None):
    """One IMEX AB-CN step; the first (``n == 0``) runs the startup
    method and records the convection at (u0, t0) as the history."""
    startup = _resolve_startup(method)
    if startup is None or state.n != 0:
        return _timestep_abcn_inner(method, state, dt, setup=setup, psolver=psolver, theta=theta)
    u0, t0 = state.u, state.t
    u1 = _startup_step(startup, u0, t0, dt, setup, psolver, theta)
    t1 = t0 + dt
    c0 = convection(apply_bc_u(u0, t0, setup), setup)
    return ABCNState(u=u1, temp=None, t=t1, n=state.n + 1, c_prev=c0,
                     p=pressure(u1, None, t1, setup, psolver=psolver))


def _timestep_abcn_inner(method, state, dt, *, setup, psolver, theta=None):
    a1, a2, th = method.alpha1, method.alpha2, method.theta
    u0, _, t0, n, c_prev, p0 = state
    t1 = t0 + dt

    ub = apply_bc_u(u0, t0, setup)
    c0 = convection(ub, setup)
    d0 = diffusion(ub, setup)
    rhs = ub / dt + th * d0 - (a1 * c0 + a2 * c_prev)
    if setup.bodyforce_field is not None or setup.unsteady_bodyforce is not None:
        f0 = applybodyforce(ub, t0, setup)
        f1 = applybodyforce(ub, t1, setup)
        rhs = rhs + th * f0 + (1 - th) * f1
    rhs = rhs - pressuregradient(apply_bc_p(p0, t0, setup), setup)
    if setup.closure_model is not None:
        rhs = rhs + setup.closure_model(ub, theta)

    vstart = apply_bc_u(u0, t1, setup)
    v = _solve_implicit_diffusion(rhs, vstart, dt, th, t1, setup)

    # pressure correction: L dp = Ω div v / dt
    v = apply_bc_u(v, t1, setup)
    dp, Gdp = _correct(scalewithvolume(divergence(v, setup), setup) / dt, t1, setup, psolver)
    u1 = apply_bc_u(v - dt * Gdp, t1, setup)

    if method.p_add_solve:
        p1 = pressure(u1, None, t1, setup, psolver=psolver)
    else:
        p1 = p0 + dp
    return ABCNState(u=u1, temp=None, t=t1, n=n + 1, c_prev=c0, p=p1)


def create_stepper_oneleg(method, *, setup, psolver=None, u, temp=None, t=0.0):
    """Initial one-leg state: the filled u and its pressure, each also as
    the previous step's."""
    _no_temperature(temp, "one-leg")
    psolver = psolver or default_psolver(setup)
    t = float(t)
    ub = apply_bc_u(u, t, setup)
    p = pressure(ub, None, t, setup, psolver=psolver)
    return OneLegState(u=ub, temp=None, t=t, n=0, u_prev=ub, p=p, p_prev=p)


def timestep_oneleg(method, state, dt, *, setup, psolver, theta=None):
    """One explicit one-leg beta step; the first (``n == 0``) runs the
    startup method."""
    startup = _resolve_startup(method)
    if startup is None or state.n != 0:
        return _timestep_oneleg_inner(method, state, dt, setup=setup, psolver=psolver, theta=theta)
    u0, t0 = state.u, state.t
    u1 = _startup_step(startup, u0, t0, dt, setup, psolver, theta)
    t1 = t0 + dt
    return OneLegState(u=u1, temp=None, t=t1, n=state.n + 1, u_prev=u0,
                       p=pressure(u1, None, t1, setup, psolver=psolver), p_prev=state.p)


def _timestep_oneleg_inner(method, state, dt, *, setup, psolver, theta=None):
    beta = method.beta
    u0, _, t0, n, u_prev, p0, p_prev = state
    t1 = t0 + dt
    t_off = t0 + beta * dt

    v = apply_bc_u((1 + beta) * u0 - beta * u_prev, t_off, setup)
    Q = (1 + beta) * p0 - beta * p_prev
    F = momentum(v, None, t_off, setup)
    if setup.closure_model is not None:
        F = F + setup.closure_model(v, theta)
    GQ = pressuregradient(apply_bc_p(Q, t_off, setup), setup)
    vt = (2 * beta * u0 - (beta - 0.5) * u_prev + dt * F - dt * GQ) / (beta + 0.5)

    vt = apply_bc_u(vt, t1, setup)
    div = scalewithvolume(divergence(vt, setup), setup) * (beta + 0.5) / dt
    dp, Gdp = _correct(div, t1, setup, psolver)
    u1 = apply_bc_u(vt - dt / (beta + 0.5) * Gdp, t1, setup)

    if method.p_add_solve:
        p1 = pressure(u1, None, t1, setup, psolver=psolver)
    else:
        p1 = 2 * p0 - p_prev + 4 / 3 * dp
    return OneLegState(u=u1, temp=None, t=t1, n=n + 1, u_prev=u0, p=p1, p_prev=p0)
