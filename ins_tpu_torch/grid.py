"""Staggered Cartesian grid metadata.

Port of `ins_tpu/grid.py`.  The metadata is host-side numpy at setup
time (the JAX package registers it as a pytree; the port has no need),
stored in the working dtype so that it compares field by field with the
JAX grid.  Conventions (0-based): `x[d]` has `N[d]+1` volume-boundary
coordinates (ghosts included); the `u[alpha]` component at index `I`
sits on the right face of volume `I` in direction `alpha`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .boundary_conditions import (
    DirichletBC,
    PeriodicBC,
    PressureBC,
    offset_p,
    offset_u,
    padghost,
)

__all__ = [
    "Grid",
    "DeviceGrid",
    "device_grid",
    "make_grid",
    "stretched_grid",
    "cosine_grid",
    "tanh_grid",
    "max_size",
]


def _numpy_dtype(dtype) -> np.dtype:
    """numpy dtype of a torch floating dtype (or of a numpy dtype)."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def cosine_grid(a, b, N):
    """Nonuniform grid of N+1 points on [a, b] with a cosine profile."""
    i = np.arange(N + 1, dtype=np.float64)
    return a + (b - a) * (1 - np.cos(np.pi * i / N)) / 2


def stretched_grid(a, b, N, s=1.0):
    """Grid of N+1 points on [a, b] with per-cell stretch factor `s`."""
    if s <= 0:
        raise ValueError("The stretch factor must be positive")
    if abs(s - 1.0) < 1e-12:
        return np.linspace(a, b, N + 1)
    i = np.arange(N + 1, dtype=np.float64)
    return a + (b - a) * (1 - s**i) / (1 - s**N)


def tanh_grid(a, b, N, gamma=1.0):
    """Grid of N+1 points on [a, b], Trias et al. tanh refinement."""
    x = np.linspace(0.0, 1.0, N + 1)
    return a + (b - a) * (1 + np.tanh(gamma * (2 * x - 1)) / np.tanh(gamma)) / 2


def max_size(grid) -> float:
    """Size of the largest grid element."""
    m = [float(np.max(d)) for d in grid.delta]
    return float(np.sqrt(np.sum(np.square(m))))


@dataclasses.dataclass(frozen=True)
class Grid:
    dim: int
    N: tuple  # volumes per dim, incl. ghosts
    Nu: tuple  # Nu[alpha][beta]: u[alpha] DOF count per dim
    Np: tuple  # pressure DOF count per dim
    Iu: tuple  # Iu[alpha]: box of u[alpha] DOFs
    Ip: tuple  # box of pressure DOFs
    xlims: tuple  # physical domain limits per dim
    periodic: tuple  # per-dim: both sides periodic?
    uniform: tuple  # per-dim: uniform spacing (interior)?
    x: tuple  # x[d]: N[d]+1 volume boundary coords (ghosts included)
    xu: tuple  # xu[alpha][beta]: coords of u[alpha] points along dim beta
    xp: tuple  # xp[d]: pressure point coords
    delta: tuple  # delta[d]: volume widths (clamped at eps)
    delta_u: tuple  # delta_u[d]: distance between pressure points
    A: tuple  # A[alpha][beta] = (A1, A2): face interpolation weights
    lap_c: tuple  # lap_c[d] = (cl, cc, cr): BC-aware Laplacian row coeffs
    plap_diag: tuple  # plap_diag[d]: unmodified center coeff


def make_grid(*, x, boundary_conditions, dtype=torch.float32) -> Grid:
    """Build staggered-grid metadata (same arrays as `ins_tpu.make_grid`)."""
    np_dtype = _numpy_dtype(dtype)
    eps = float(np.finfo(np_dtype).eps)
    # uniformity detection in float64 (working-precision rounding would
    # mis-flag large uniform grids as stretched)
    x64 = [np.asarray(xd, dtype=np.float64) for xd in x]
    uniform = tuple(
        bool(np.allclose(np.diff(xd), np.diff(xd)[0], rtol=1e-8)) for xd in x64
    )
    x = [np.asarray(xd, dtype=np_dtype).copy() for xd in x]
    xlims = tuple((float(xd[0]), float(xd[-1])) for xd in x)
    D = len(x)
    if D not in (2, 3):
        raise ValueError("Only 2D and 3D grids are supported")

    for d in range(D):
        bcl, bcr = boundary_conditions[d]
        if isinstance(bcl, PeriodicBC) != isinstance(bcr, PeriodicBC):
            raise ValueError("PeriodicBC must be used on both sides")
        x[d] = padghost(bcl, x[d], False)
        x[d] = padghost(bcr, x[d], True)

    N = tuple(len(xd) - 1 for xd in x)

    def u_range(alpha, beta):
        na = offset_u(boundary_conditions[beta][0], False, alpha == beta)
        nb = offset_u(boundary_conditions[beta][1], True, alpha == beta)
        return (na, N[beta] - nb)

    def p_range(d):
        na = offset_p(boundary_conditions[d][0], False)
        nb = offset_p(boundary_conditions[d][1], True)
        return (na, N[d] - nb)

    Iu = tuple(tuple(u_range(a, b) for b in range(D)) for a in range(D))
    Ip = tuple(p_range(d) for d in range(D))
    Nu = tuple(tuple(e - s for (s, e) in Iu[a]) for a in range(D))
    Np = tuple(e - s for (s, e) in Ip)

    xu = tuple(
        tuple(
            x[b][1:] if a == b else (x[b][:-1] + x[b][1:]) / 2 for b in range(D)
        )
        for a in range(D)
    )
    xp = tuple((xd[:-1] + xd[1:]) / 2 for xd in x)

    delta = tuple(np.maximum(np.diff(xd), eps) for xd in x)
    delta_u = tuple(
        np.maximum(np.append(np.diff(xp[d]), delta[d][-1] / 2), eps)
        for d in range(D)
    )

    A = []
    for a in range(D):
        Arow = []
        for b in range(D):
            if a == b:
                A1 = np.full(N[a], 0.5, np_dtype)
                A1[0] = 1.0
                A2 = np.full(N[a], 0.5, np_dtype)
                A2[-1] = 1.0
            else:
                raw = (x[b][1:-1] - xp[b][:-1]) / delta_u[b][:-1]
                A1 = np.concatenate(([1.0], 1.0 - raw)).astype(np_dtype)
                A2 = np.concatenate((raw, [1.0])).astype(np_dtype)
            Arow.append((A1, A2))
        A.append(tuple(Arow))

    lap_c = []
    plap_diag = []
    for d in range(D):
        s, e = Ip[d]
        idx = np.arange(s, e)
        du = delta_u[d]
        cr = 1.0 / du[idx]
        cl = 1.0 / du[idx - 1]
        cc = -(cr + cl)
        plap_diag.append(cc.astype(np_dtype).copy())
        bcl, bcr = boundary_conditions[d]
        if isinstance(bcl, PressureBC):
            cl[0] = 0.0
        elif isinstance(bcl, DirichletBC):
            cl[0] = 0.0
            cc[0] = -1.0 / du[s]
        if isinstance(bcr, PressureBC):
            cr[-1] = 0.0
        elif isinstance(bcr, DirichletBC):
            cr[-1] = 0.0
            cc[-1] = -1.0 / du[e - 2]
        lap_c.append(
            (cl.astype(np_dtype), cc.astype(np_dtype), cr.astype(np_dtype))
        )

    periodic = tuple(
        isinstance(boundary_conditions[d][0], PeriodicBC) for d in range(D)
    )

    def cast(t):
        if isinstance(t, tuple):
            return tuple(cast(v) for v in t)
        return np.asarray(t, dtype=np_dtype)

    return Grid(
        dim=D,
        N=N,
        Nu=Nu,
        Np=Np,
        Iu=Iu,
        Ip=Ip,
        xlims=xlims,
        periodic=periodic,
        uniform=uniform,
        x=cast(tuple(x)),
        xu=cast(xu),
        xp=cast(xp),
        delta=cast(delta),
        delta_u=cast(delta_u),
        A=cast(tuple(A)),
        lap_c=cast(tuple(lap_c)),
        plap_diag=cast(tuple(plap_diag)),
    )


@dataclasses.dataclass(frozen=True)
class DeviceGrid:
    """The grid's 1-D vectors as tensors on a device, nested as in `Grid`,
    each shaped to broadcast along the dimension it runs along (``x[d]``,
    ``delta[d]``, ``lap_c[d]``: `d`; ``xu[alpha][beta]`` and
    ``A[alpha][beta]``: `beta`).  The general ghosted path's operators
    read their segments from it (`ops._stencil.dseg`)."""

    x: tuple
    xu: tuple
    xp: tuple
    delta: tuple
    delta_u: tuple
    A: tuple
    lap_c: tuple
    plap_diag: tuple


def device_grid(grid, device) -> DeviceGrid:
    """`DeviceGrid` of `grid` on `device` (one copy of each vector)."""
    D = grid.dim

    def along(v, d):
        shape = [1] * D
        shape[d] = -1
        return torch.as_tensor(v).to(device).reshape(shape)

    def per_dim(vs):
        return tuple(along(vs[d], d) for d in range(D))

    return DeviceGrid(
        x=per_dim(grid.x),
        xu=tuple(per_dim(grid.xu[a]) for a in range(D)),
        xp=per_dim(grid.xp),
        delta=per_dim(grid.delta),
        delta_u=per_dim(grid.delta_u),
        A=tuple(tuple(tuple(along(w, b) for w in grid.A[a][b]) for b in range(D))
                for a in range(D)),
        lap_c=tuple(tuple(along(c, d) for c in grid.lap_c[d]) for d in range(D)),
        plap_diag=per_dim(grid.plap_diag),
    )
