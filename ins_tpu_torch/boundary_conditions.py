"""Boundary conditions: types, ghost metadata rules, and ghost-cell fills.

Port of `ins_tpu/boundary_conditions.py`: the four BC families, the
ghost-coordinate / DOF-offset rules `grid.py` needs, and the ghost fills
`apply_bc_u`, `apply_bc_p` and `apply_bc_temp` of the general ghosted
path.  Velocity fields are ``(D, *N)`` (component first), scalar fields
``(*N)`` (a pressure-point tensor may carry trailing dimensions), where
`N` counts one ghost layer a side (two on the left of a `PressureBC`).
BCs are applied dimension by dimension, left then right, which fixes the
corner ghosts as in the JAX package.

A fill never writes into the tensor it is given: it fills a copy (one
clone, then plane copies and plane fills on it), so the caller's field
is left as it was and autograd differentiates the fill as JAX does its
functional updates.  Dirichlet values may be callables of the boundary
coordinates and of t (a 0-d tensor of the setup's dtype on its device);
``dudt=True`` gives their central-difference time derivative.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

__all__ = [
    "PeriodicBC",
    "DirichletBC",
    "SymmetricBC",
    "PressureBC",
    "padghost",
    "offset_u",
    "offset_p",
    "boundary_plane",
    "plane_coords",
    "apply_bc_u",
    "apply_bc_p",
    "apply_bc_temp",
]


@dataclasses.dataclass(frozen=True)
class PeriodicBC:
    """Periodic boundary conditions. Must be periodic on both sides."""


@dataclasses.dataclass(frozen=True)
class DirichletBC:
    """Dirichlet velocity BC: `u` is None (no-slip), a tuple of constants
    (one per component), or a torch callable `u(alpha, *x, t)` (``alpha``
    a Python int, the coordinates broadcastable tensors, ``t`` a 0-d
    tensor).  For the temperature equation `u` is None (zero), a constant
    or a callable `u(*x, t)`."""

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


# --------------------------------------------------------------------------
# Index helpers
# --------------------------------------------------------------------------


def boundary_plane(beta: int, N, box, isright: bool):
    """Boundary layer just outside the DOF `box`, normal to dimension `beta`."""
    i = box[beta][1] if isright else box[beta][0] - 1
    return tuple((i, i + 1) if a == beta else (0, N[a]) for a in range(len(N)))


def plane_coords(coords_1d, box):
    """Broadcastable coordinate tensors of a box from per-dim 1-D coords
    on the device (a setup's ``dgrid.xu[alpha]`` or ``dgrid.xp``)."""
    from .ops._stencil import dseg

    return tuple(dseg(coords_1d[g], box, g) for g in range(len(box)))


# --------------------------------------------------------------------------
# Dirichlet boundary values
# --------------------------------------------------------------------------


def _time(t, setup):
    """t as a 0-d tensor of the setup's dtype on its device (a fill
    kernel for a Python float, never a host copy)."""
    if torch.is_tensor(t):
        return t.to(dtype=setup.dtype, device=setup.device)
    return torch.full((), float(t), dtype=setup.dtype, device=setup.device)


def _dirichlet_u_value(bc, alpha, coords, t, dtype, dudt):
    """The alpha-component of a callable Dirichlet value on a boundary
    plane (`ins_tpu` `_dirichlet_u_value`); constant values are filled in
    place by the caller."""
    ones = torch.ones(torch.broadcast_shapes(*(c.shape for c in coords)), dtype=dtype,
                      device=coords[0].device)
    if dudt:
        # central difference in time of the boundary function
        h = math.sqrt(float(np.finfo(_np_dtype(dtype)).eps)) / 2
        return (bc.u(alpha, *coords, t + h) - bc.u(alpha, *coords, t - h)) / (2 * h) * ones
    return bc.u(alpha, *coords, t) * ones


def _dirichlet_temp_value(bc, coords, t, dtype):
    ones = torch.ones(torch.broadcast_shapes(*(c.shape for c in coords)), dtype=dtype,
                      device=coords[0].device)
    return bc.u(*coords, t) * ones


def _np_dtype(dtype):
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


# --------------------------------------------------------------------------
# Ghost fills
# --------------------------------------------------------------------------


def _plane(f, axis, i):
    return f.narrow(axis, i, 1)


def _wrap(f, axis, n):
    """Periodic ghosts along `axis` of extent `n`: 0 <- n-2, n-1 <- 1."""
    _plane(f, axis, 0).copy_(_plane(f, axis, n - 2))
    _plane(f, axis, n - 1).copy_(_plane(f, axis, 1))


def _mirror(f, axis, plane, isright):
    """Copy the plane next to `plane` (towards the interior) onto it."""
    _plane(f, axis, plane).copy_(_plane(f, axis, plane - 1 if isright else plane + 1))


def apply_bc_u(u, t, setup, *, dudt: bool = False, homogeneous: bool = False):
    """Velocity ghost fill (`ins_tpu.apply_bc_u`) on a copy of `u`.
    ``homogeneous=True`` zeroes the Dirichlet values; ``dudt=True`` fills
    the Dirichlet ghosts with the values' time derivative."""
    g = setup.grid
    u = u.clone()
    tt = None
    for beta in range(g.dim):
        for isright, bc in zip((False, True), setup.boundary_conditions[beta]):
            if homogeneous and isinstance(bc, DirichletBC):
                bc = DirichletBC()
            if isinstance(bc, DirichletBC) and callable(bc.u) and tt is None:
                tt = _time(t, setup)
            _fill_u_side(bc, u, beta, tt, setup, isright, dudt)
    return u


def _fill_u_side(bc, u, beta, t, setup, isright, dudt):
    g = setup.grid
    D, N = g.dim, g.N
    if isinstance(bc, PeriodicBC):
        if not isright:  # both sides in the left call
            _wrap(u, 1 + beta, N[beta])
        return
    for alpha in range(D):
        box = boundary_plane(beta, N, g.Iu[alpha], isright)
        plane = box[beta][0]
        comp = _plane(u[alpha], beta, plane)
        if isinstance(bc, DirichletBC):
            if bc.u is None or (dudt and isinstance(bc.u, tuple)):
                comp.fill_(0.0)
            elif isinstance(bc.u, tuple):
                comp.fill_(bc.u[alpha])
            else:
                coords = plane_coords(setup.dgrid.xu[alpha], box)
                comp.copy_(_dirichlet_u_value(bc, alpha, coords, t, setup.dtype, dudt))
        elif isinstance(bc, (SymmetricBC, PressureBC)):
            if isinstance(bc, SymmetricBC) and alpha == beta:
                comp.fill_(0.0)
            else:
                _mirror(u[alpha], beta, plane, isright)
        else:
            raise TypeError(f"Unknown boundary condition {bc!r}")


def apply_bc_p(p, t, setup):
    """Pressure ghost fill (`ins_tpu.apply_bc_p`) on a copy of `p`, whose
    leading dimensions are the grid's (trailing ones ride along)."""
    g = setup.grid
    p = p.clone()
    for beta in range(g.dim):
        for isright, bc in zip((False, True), setup.boundary_conditions[beta]):
            _fill_p_side(bc, p, beta, setup, isright)
    return p


def _fill_p_side(bc, p, beta, setup, isright):
    g = setup.grid
    if isinstance(bc, PeriodicBC):
        if not isright:
            _wrap(p, beta, g.N[beta])
        return
    if isinstance(bc, DirichletBC):
        return  # not used
    plane = boundary_plane(beta, g.N, g.Ip, isright)[beta][0]
    if isinstance(bc, SymmetricBC):
        _mirror(p, beta, plane, isright)
    elif isinstance(bc, PressureBC):
        _plane(p, beta, plane).fill_(0.0)
    else:
        raise TypeError(f"Unknown boundary condition {bc!r}")


def apply_bc_temp(temp, t, setup):
    """Temperature ghost fill (`ins_tpu.apply_bc_temp`) on a copy of
    `temp`: periodic and symmetric as the pressure, a `PressureBC` as a
    symmetric one, Dirichlet values on the boundary plane."""
    g = setup.grid
    temp = temp.clone()
    tt = None
    for beta in range(g.dim):
        for isright, bc in zip((False, True), setup.temperature.boundary_conditions[beta]):
            if isinstance(bc, DirichletBC):
                box = boundary_plane(beta, g.N, g.Ip, isright)
                comp = _plane(temp, beta, box[beta][0])
                if bc.u is None:
                    comp.fill_(0.0)
                elif isinstance(bc.u, (int, float)):
                    comp.fill_(bc.u)
                else:
                    if tt is None:
                        tt = _time(t, setup)
                    coords = plane_coords(setup.dgrid.xp, box)
                    comp.copy_(_dirichlet_temp_value(bc, coords, tt, setup.dtype))
            elif isinstance(bc, PressureBC):
                _fill_p_side(SymmetricBC(), temp, beta, setup, isright)
            else:
                _fill_p_side(bc, temp, beta, setup, isright)
    return temp
