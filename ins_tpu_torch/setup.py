"""Problem setup.

Port of `ins_tpu/setup.py` for the configurations the port runs: a grid,
boundary conditions, a Reynolds number, a steady body force, a closure
model, a working dtype and the device every tensor of the run is made
on.  The device defaults to the card (``"cuda"``); without one, `Setup`
raises unless the caller passes ``device="cpu"``.  A closure model is a
callable ``closure(u, theta)`` on the ghosted ``(D, *N)`` velocity (for
example `models.wrappedclosure` around a CNN, or the natural-form
Smagorinsky closure `smagorinsky_closure_natural`, which the periodic
fast path recognises by its tag).  A steady body force is a torch
function ``bodyforce(dim, *x, t)`` (``dim`` a Python int, the coordinates
broadcastable tensors), evaluated once here on the full staggered
coordinates as `bodyforce_field`.  Unsteady body forces and temperature
wait for ROADMAP queue 1 item 6 and raise until then.
"""

from __future__ import annotations

import dataclasses

import torch

from .boundary_conditions import PeriodicBC
from .grid import Grid, make_grid
from .ops._stencil import seg

__all__ = ["Setup", "SetupData", "resolve_device"]


@dataclasses.dataclass(frozen=True)
class SetupData:
    grid: Grid
    Re: float
    boundary_conditions: tuple
    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cuda")
    closure_model: object = None
    bodyforce_field: object = None  # steady force (D, *N) on `device`, or None

    @property
    def dim(self):
        return self.grid.dim


def resolve_device(device):
    """`torch.device(device)`; raises RuntimeError for a CUDA device on a
    machine without one (never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card by "
            "default; pass device=\"cpu\" to run on the CPU"
        )
    return device


def _bodyforce_field(bodyforce, grid, dtype, device):
    """The steady force on the full staggered coordinates, as
    `ins_tpu.ops.operators.applybodyforce` evaluates it."""
    D = grid.dim
    full = tuple((0, n) for n in grid.N)
    t = torch.zeros((), dtype=dtype, device=device)
    comps = []
    for a in range(D):
        coords = [seg(grid.xu[a][b], full, b, device=device) for b in range(D)]
        val = bodyforce(a, *coords, t)
        comps.append(val * torch.ones(grid.N, dtype=dtype, device=device))
    return torch.stack(comps)


def Setup(
    *,
    x,
    boundary_conditions=None,
    Re=None,
    bodyforce=None,
    issteadybodyforce=True,
    closure_model=None,
    temperature=None,
    dtype=torch.float32,
    device="cuda",
):
    """Build a problem setup (keyword-compatible with `ins_tpu.Setup`,
    plus `device`)."""
    if temperature is not None:
        raise NotImplementedError(
            "temperature is not ported yet (ROADMAP queue 1 item 6)"
        )
    if closure_model is not None and not callable(closure_model):
        raise TypeError("closure_model must be a callable closure(u, theta)")
    if bodyforce is not None and not issteadybodyforce:
        raise NotImplementedError(
            "unsteady body forces are not ported yet (ROADMAP queue 1 item 6)"
        )
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
    device = resolve_device(device)
    D = len(x)
    if boundary_conditions is None:
        boundary_conditions = tuple((PeriodicBC(), PeriodicBC()) for _ in range(D))
    boundary_conditions = tuple(tuple(bc) for bc in boundary_conditions)
    if Re is None:
        Re = 1000.0
    grid = make_grid(x=x, boundary_conditions=boundary_conditions, dtype=dtype)
    field = None
    if bodyforce is not None:
        field = _bodyforce_field(bodyforce, grid, dtype, device)
    return SetupData(
        grid=grid,
        Re=float(Re),
        boundary_conditions=boundary_conditions,
        dtype=dtype,
        device=device,
        closure_model=closure_model,
        bodyforce_field=field,
    )
