"""Time steppers of the general ghosted path.

Port of `ins_tpu/time_steppers/step.py`: the stepper state, and one
`timestep` per method on ghosted fields — explicit Runge-Kutta tableaus
(`_timestep_erk`) and the low-storage Wray RK3 (`_timestep_lmwray3`),
each stage a ghost fill, the momentum right-hand side (with the
buoyancy, the closure model and the temperature right-hand side), the
stage update, a ghost fill and the projection; the IMEX AB-CN and
one-leg methods (`imex.py`, with states of their own) and implicit RK
tableaus (`implicit_rk.py`).  The fast and channel paths step their own
ghost-free carries (`ops/fastpath.py`, `ops/channelpath.py`);
`solve_unsteady` calls `timestep` where neither applies.
"""

from __future__ import annotations

from typing import Any, NamedTuple

from ..boundary_conditions import apply_bc_temp, apply_bc_u
from ..ops.operators import convection_diffusion_temp, dissipation, momentum
from ..ops.pressure import project
from .methods import (
    AdamsBashforthCrankNicolsonMethod,
    ExplicitRungeKuttaMethod,
    ImplicitRungeKuttaMethod,
    LMWray3,
    OneLegMethod,
)

__all__ = ["StepperState", "create_stepper", "timestep"]


class StepperState(NamedTuple):
    """Carried simulation state.  ``u`` and ``temp`` are tensors (``temp``
    None without a temperature equation); ``t`` is a Python float and
    ``n`` a Python int, so the loop never reads them back from the
    device."""

    u: Any
    temp: Any  # scalar field or None
    t: float
    n: int


def create_stepper(method, *, setup, psolver=None, u, temp=None, t=0.0, n=0):
    """Initial state of `method`: a `StepperState`, or for AB-CN and
    one-leg their own state, whose initial pressure is solved by
    `psolver` (`default_psolver(setup)` where None)."""
    if isinstance(method, AdamsBashforthCrankNicolsonMethod):
        from .imex import create_stepper_abcn

        return create_stepper_abcn(method, setup=setup, psolver=psolver, u=u, temp=temp, t=t)
    if isinstance(method, OneLegMethod):
        from .imex import create_stepper_oneleg

        return create_stepper_oneleg(method, setup=setup, psolver=psolver, u=u, temp=temp, t=t)
    return StepperState(u=u, temp=temp, t=float(t), n=int(n))


def timestep(method, state, dt, *, setup, psolver, theta=None):
    """Advance a ghosted state one step (a new state; the input's tensors
    are not written).  ``theta`` goes to the setup's closure model."""
    if isinstance(method, ExplicitRungeKuttaMethod):
        return _timestep_erk(method, state, dt, setup=setup, psolver=psolver, theta=theta)
    if isinstance(method, LMWray3):
        return _timestep_lmwray3(method, state, dt, setup=setup, psolver=psolver, theta=theta)
    if isinstance(method, AdamsBashforthCrankNicolsonMethod):
        from .imex import timestep_abcn

        return timestep_abcn(method, state, dt, setup=setup, psolver=psolver, theta=theta)
    if isinstance(method, OneLegMethod):
        from .imex import timestep_oneleg

        return timestep_oneleg(method, state, dt, setup=setup, psolver=psolver, theta=theta)
    if isinstance(method, ImplicitRungeKuttaMethod):
        from .implicit_rk import timestep_irk

        return timestep_irk(method, state, dt, setup=setup, psolver=psolver, theta=theta)
    raise TypeError(f"timestep is not defined for {type(method).__name__}")


def _temp_rhs(u, temp, setup):
    ktemp = convection_diffusion_temp(u, temp, setup)
    if setup.temperature.dodissipation:
        ktemp = ktemp + dissipation(u, setup)
    return ktemp


def _timestep_erk(method, state, dt, *, setup, psolver, theta):
    """Per stage: ghost fill, momentum (+ temperature right-hand side,
    + closure), the tableau's update from the step's start, ghost fill,
    projection."""
    u, temp, t, n = state
    A, c = method.A, method.c
    m = setup.closure_model
    tstart, ustart, tempstart = t, u, temp
    ku, ktemp = [], []
    for i in range(method.nstage):
        u = apply_bc_u(u, t, setup)
        if temp is not None:
            temp = apply_bc_temp(temp, t, setup)
        F = momentum(u, temp, t, setup)
        if temp is not None:
            ktemp.append(_temp_rhs(u, temp, setup))
        if m is not None:
            F = F + m(u, theta)
        ku.append(F)

        t = tstart + c[i] * dt
        u = ustart
        for j in range(i + 1):
            u = u + dt * A[i][j] * ku[j]
        if temp is not None:
            temp = tempstart
            for j in range(i + 1):
                temp = temp + dt * A[i][j] * ktemp[j]

        u = apply_bc_u(u, t, setup)
        u = project(u, setup, psolver=psolver)

    # the Neumann ghosts need exact copies (the thin-volume guard of the
    # diffusion), so fill once more after the last projection
    u = apply_bc_u(u, t, setup)
    if temp is not None:
        temp = apply_bc_temp(temp, t, setup)
    return StepperState(u=u, temp=temp, t=t, n=n + 1)


def _timestep_lmwray3(method, state, dt, *, setup, psolver, theta):
    """Low-storage Wray RK3: stage i sets u = P(ustart + dt·a_i·f) and,
    before the last, ustart += dt·b_i·f."""
    u, temp, t, n = state
    m = setup.closure_model
    a, b, c = method.a, method.b, method.c
    nstage = len(a)
    tstart = t

    def f(u, temp, t):
        u = apply_bc_u(u, t, setup)
        if temp is not None:
            temp = apply_bc_temp(temp, t, setup)
        du = momentum(u, temp, t, setup)
        if m is not None:
            du = du + m(u, theta)
        dtemp = _temp_rhs(u, temp, setup) if temp is not None else None
        return du, dtemp

    ustart, tempstart = u, temp
    for i in range(nstage):
        ti = tstart + c[i] * dt
        du, dtemp = f(u, temp, ti)
        u = ustart + dt * a[i] * du
        if temp is not None:
            temp = tempstart + dt * a[i] * dtemp
        u = apply_bc_u(u, ti, setup)
        u = project(u, setup, psolver=psolver)
        if i < nstage - 1:
            ustart = ustart + dt * b[i] * du
            if temp is not None:
                tempstart = tempstart + dt * b[i] * dtemp

    t = tstart + dt
    u = apply_bc_u(u, t, setup)
    if temp is not None:
        temp = apply_bc_temp(temp, t, setup)
    return StepperState(u=u, temp=temp, t=t, n=n + 1)
