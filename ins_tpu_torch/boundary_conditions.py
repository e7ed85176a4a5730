"""Boundary-condition types and the grid-metadata rules they imply.

Port of the type half of `ins_tpu/boundary_conditions.py` (the four BC
families and the ghost-coordinate / DOF-offset rules `grid.py` needs).
The ghost-cell fills wait for the general ghosted path (ROADMAP queue 1
item 7): the port's fast paths carry fields without ghosts, and the
channel path fills its static wall ghosts itself
(`ops/channelpath.reghost_channel`, from `_const_wall_values`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

__all__ = [
    "PeriodicBC",
    "DirichletBC",
    "SymmetricBC",
    "PressureBC",
    "padghost",
    "offset_u",
    "offset_p",
]


@dataclasses.dataclass(frozen=True)
class PeriodicBC:
    """Periodic boundary conditions. Must be periodic on both sides."""


@dataclasses.dataclass(frozen=True)
class DirichletBC:
    """Dirichlet velocity BC: `u` is None (no-slip), a tuple of constants
    (one per component), or a callable `u(alpha, *x, t)`."""

    u: Any = None


@dataclasses.dataclass(frozen=True)
class SymmetricBC:
    """Symmetric BC: parallel velocity/pressure mirrored, normal velocity zero."""


@dataclasses.dataclass(frozen=True)
class PressureBC:
    """Pressure (outflow) BC: p = 0 on the boundary, zero-Neumann velocity."""


def _const_wall_values(bc, D):
    """Per-component wall velocity of a static DirichletBC, or None
    (`ins_tpu/ops/channelpath.py` `_const_wall_values`)."""
    if not isinstance(bc, DirichletBC):
        return None
    if bc.u is None:
        return (0.0,) * D
    if isinstance(bc.u, tuple) and all(isinstance(v, (int, float)) for v in bc.u):
        return tuple(float(v) for v in bc.u)
    return None  # time/space-dependent walls stay on the ghosted path


def padghost(bc, x: np.ndarray, isright: bool) -> np.ndarray:
    """Pad volume-boundary coordinate vector with ghost coordinates."""
    if isinstance(bc, PeriodicBC):
        if isright:
            return np.append(x, x[-1] + (x[1] - x[0]))
        return np.insert(x, 0, x[0] - (x[-1] - x[-2]))
    if isinstance(bc, DirichletBC):
        return np.append(x, x[-1]) if isright else np.insert(x, 0, x[0])
    if isinstance(bc, SymmetricBC):
        if isright:
            return np.append(x, x[-1] + (x[-1] - x[-2]))
        return np.insert(x, 0, x[0] - (x[1] - x[0]))
    if isinstance(bc, PressureBC):
        return np.append(x, x[-1]) if isright else np.insert(x, 0, [x[0], x[0]])
    raise TypeError(f"Unknown boundary condition {bc!r}")


def offset_u(bc, isright: bool, isnormal: bool) -> int:
    """Number of non-DOF velocity components at this boundary side."""
    if isinstance(bc, PeriodicBC):
        return 1
    if isinstance(bc, (DirichletBC, SymmetricBC)):
        return 1 + (isright and isnormal)
    if isinstance(bc, PressureBC):
        return 1 + ((not isright) and (not isnormal))
    raise TypeError(f"Unknown boundary condition {bc!r}")


def offset_p(bc, isright: bool) -> int:
    """Number of non-DOF pressure components at this boundary side."""
    if isinstance(bc, (PeriodicBC, DirichletBC, SymmetricBC)):
        return 1
    if isinstance(bc, PressureBC):
        return 1 + (not isright)
    raise TypeError(f"Unknown boundary condition {bc!r}")
