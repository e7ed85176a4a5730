"""Stepper state.

Port of the state half of `ins_tpu/time_steppers/step.py`.  The ghosted
per-method `timestep` waits for the general path (ROADMAP queue 1 item
7); the port steps through `ops/fastpath.py`.
"""

from __future__ import annotations

from typing import Any, NamedTuple

from .methods import ExplicitRungeKuttaMethod, LMWray3

__all__ = ["StepperState", "create_stepper"]


class StepperState(NamedTuple):
    """Carried simulation state.  ``u`` and ``temp`` are tensors (``temp``
    None without a temperature equation); ``t`` is a Python float and
    ``n`` a Python int, so the loop never reads them back from the
    device."""

    u: Any
    temp: Any  # scalar field or None
    t: float
    n: int


def create_stepper(method, *, setup, u, temp=None, t=0.0, n=0):
    """Initial state for an explicit RK method or LMWray3."""
    if not isinstance(method, (ExplicitRungeKuttaMethod, LMWray3)):
        raise NotImplementedError(
            f"{type(method).__name__} is not ported yet: the port steps "
            "explicit RK tableaus and LMWray3 (IMEX/implicit steppers are "
            "ROADMAP queue 1 item 7)"
        )
    return StepperState(u=u, temp=temp, t=float(t), n=int(n))
