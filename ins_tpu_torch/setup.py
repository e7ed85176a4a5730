"""Problem setup.

Port of `ins_tpu/setup.py` for the configurations the port runs: a grid,
boundary conditions, a Reynolds number, a closure model, a working dtype
and the device every tensor of the run is made on.  A closure model is a
callable ``closure(u, theta)`` on the ghosted ``(D, *N)`` velocity (for
example `models.wrappedclosure` around a CNN); the natural-form
Smagorinsky closure, temperature and body forces wait for ROADMAP queue
1 item 6 and raise until then.
"""

from __future__ import annotations

import dataclasses

import torch

from .boundary_conditions import PeriodicBC
from .grid import Grid, make_grid

__all__ = ["Setup", "SetupData"]


@dataclasses.dataclass(frozen=True)
class SetupData:
    grid: Grid
    Re: float
    boundary_conditions: tuple
    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cpu")
    closure_model: object = None

    @property
    def dim(self):
        return self.grid.dim


def Setup(
    *,
    x,
    boundary_conditions=None,
    Re=None,
    bodyforce=None,
    closure_model=None,
    temperature=None,
    dtype=torch.float32,
    device="cpu",
):
    """Build a problem setup (keyword-compatible with `ins_tpu.Setup`,
    plus `device`)."""
    if temperature is not None:
        raise NotImplementedError(
            "temperature is not ported yet (ROADMAP queue 1 item 6)"
        )
    if getattr(closure_model, "kind", None) == "smagorinsky_natural":
        raise NotImplementedError(
            "the natural-form Smagorinsky closure is not ported yet "
            "(ROADMAP queue 1 item 6: fused Smagorinsky)"
        )
    if closure_model is not None and not callable(closure_model):
        raise TypeError("closure_model must be a callable closure(u, theta)")
    if bodyforce is not None:
        raise NotImplementedError(
            "body forces are not ported yet (ROADMAP queue 1 item 6)"
        )
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
    D = len(x)
    if boundary_conditions is None:
        boundary_conditions = tuple((PeriodicBC(), PeriodicBC()) for _ in range(D))
    boundary_conditions = tuple(tuple(bc) for bc in boundary_conditions)
    if Re is None:
        Re = 1000.0
    grid = make_grid(x=x, boundary_conditions=boundary_conditions, dtype=dtype)
    return SetupData(
        grid=grid,
        Re=float(Re),
        boundary_conditions=boundary_conditions,
        dtype=dtype,
        device=torch.device(device),
        closure_model=closure_model,
    )
