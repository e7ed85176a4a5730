"""ODE method definitions (data only).

Port of `ins_tpu/time_steppers/methods.py`: frozen dataclasses holding
Butcher tableaus as nested tuples of Python floats, so stage coefficients
reach the kernels as plain float arguments.  The IMEX and one-leg
methods wait for the general stepper (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "ExplicitRungeKuttaMethod",
    "ImplicitRungeKuttaMethod",
    "LMWray3",
    "runge_kutta_method",
]


@dataclasses.dataclass(frozen=True)
class ExplicitRungeKuttaMethod:
    """Explicit RK with per-stage pressure projection.  The tableau is
    stored *shifted* (row i holds original row i+1; last row is b)."""

    A: tuple  # (s, s) nested tuple, shifted
    b: tuple
    c: tuple  # shifted; last entry 1
    r: float = 0.0
    p_add_solve: bool = True

    @property
    def nstage(self):
        return len(self.b)


@dataclasses.dataclass(frozen=True)
class ImplicitRungeKuttaMethod:
    """Implicit RK tableau (data only: no stepper in the port yet)."""

    A: tuple
    b: tuple
    c: tuple
    r: float = 0.0
    newton_type: str = "full"
    maxiter: int = 10
    abstol: float = 1e-14
    reltol: float = 1e-14
    p_add_solve: bool = True

    @property
    def nstage(self):
        return len(self.b)


@dataclasses.dataclass(frozen=True)
class LMWray3:
    """Low-storage 3-stage Wray RK3: stage i sets u = P(ustart + dt·a_i·f)
    and, before the last, ustart += dt·b_i·f.  The periodic fast path
    steps it (hat chain, per-op chain and roll twin)."""

    a: tuple = (8 / 15, 5 / 12, 3 / 4)
    b: tuple = (1 / 4, 0.0)
    c: tuple = (0.0, 8 / 15, 2 / 3)


def _tup(m):
    m = np.asarray(m, dtype=np.float64)
    if m.ndim == 1:
        return tuple(float(v) for v in m)
    return tuple(tuple(float(v) for v in row) for row in m)


def runge_kutta_method(A, b, c, r, **kwargs):
    """Build an RK method from a Butcher tableau; explicit tableaus are
    shifted (A[1:] + [b]; c[1:] + [1])."""
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    s = A.shape[0]
    if A.shape != (s, s) or len(b) != s or len(c) != s:
        raise ValueError(f"inconsistent tableau shapes {A.shape}, {b.shape}, {c.shape}")
    if np.allclose(np.triu(A), 0.0):
        A = np.vstack([A[1:, :], b[None, :]])
        c = np.append(c[1:], 1.0)
        return ExplicitRungeKuttaMethod(
            A=_tup(A), b=_tup(b), c=_tup(c), r=float(r), **kwargs
        )
    return ImplicitRungeKuttaMethod(
        A=_tup(A), b=_tup(b), c=_tup(c), r=float(r), **kwargs
    )
