"""Problem setup.

Port of `ins_tpu/setup.py` for the configurations the port runs: a grid,
boundary conditions, a Reynolds number, a steady body force, a closure
model, a Boussinesq temperature equation, a working dtype and the device
every tensor of the run is made on.  The device defaults to the card (``"cuda"``); without one, `Setup`
raises unless the caller passes ``device="cpu"``.  A closure model is a
callable ``closure(u, theta)`` on the ghosted ``(D, *N)`` velocity (for
example `models.wrappedclosure` around a CNN, or the natural-form
Smagorinsky closure `smagorinsky_closure_natural`, which the periodic
fast path recognises by its tag).  A body force is a torch function
``bodyforce(dim, *x, t)``: ``dim`` a Python int, the coordinates
broadcastable tensors of the setup's dtype on its device (the full
staggered coordinates of component ``dim``), ``t`` a 0-d tensor of that
dtype on that device.  A steady one (``issteadybodyforce=True``) is
evaluated once here, at t = 0, as `bodyforce_field`; an unsteady one is
kept and evaluated at each stage's time (`ops.operators.applybodyforce`):
the roll twin and the per-op chain of the periodic fast path and the
general ghosted path take it, the fused chains, the channel path and the
halo path do not (as in the JAX package).  `temperature_equation` gives
the temperature coefficients of the three non-dimensionalisations, with
any of the four BC families (periodic ones ride the fast path, others the
general ghosted path).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from .boundary_conditions import PeriodicBC
from .grid import DeviceGrid, Grid, device_grid, make_grid
from .ops._stencil import seg
from .ops.operators import bodyforce_on_grid

__all__ = ["Setup", "SetupData", "Temperature", "temperature_equation", "resolve_device"]


@dataclasses.dataclass(frozen=True)
class Temperature:
    """Boussinesq temperature-equation coefficients (the JAX package's
    `Temperature`): Python floats rounded to the working dtype, as the
    JAX package stores them in arrays of that dtype."""

    alpha1: float
    alpha2: float
    alpha3: float
    alpha4: float
    gamma: float
    dodissipation: bool
    boundary_conditions: tuple
    gdir: int


_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def temperature_equation(*, Pr, Ra, Ge, boundary_conditions, dodissipation=True, gdir=1,
                         nondim_type=1, dtype=torch.float32):
    """Temperature-equation coefficients of one of three
    non-dimensionalisations (`ins_tpu.temperature_equation`): 1 the
    free-fall velocity sqrt(βgΔT·H), 2 the conduction scale κ/H, 3
    sqrt(cΔT).  `gdir` is the 0-based gravity direction."""
    if nondim_type == 1:
        a1 = math.sqrt(Pr / Ra)
        a2 = 1.0
        a3 = Ge * math.sqrt(Pr / Ra)
        a4 = 1 / math.sqrt(Pr * Ra)
    elif nondim_type == 2:
        a1 = Pr
        a2 = Pr * Ra
        a3 = Ge / Ra
        a4 = 1.0
    elif nondim_type == 3:
        a1 = math.sqrt(Pr * Ge / Ra)
        a2 = Ge
        a3 = math.sqrt(Pr * Ge / Ra)
        a4 = math.sqrt(Ge / (Pr * Ra))
    else:
        raise ValueError(f"Unknown nondim_type {nondim_type}")
    if dtype not in _NP_DTYPES:
        raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
    cast = _NP_DTYPES[dtype]
    a1, a2, a3, a4, gamma = (float(cast(v)) for v in (a1, a2, a3, a4, a1 / a3))
    return Temperature(
        alpha1=a1, alpha2=a2, alpha3=a3, alpha4=a4, gamma=gamma,
        dodissipation=bool(dodissipation),
        boundary_conditions=tuple(tuple(bc) for bc in boundary_conditions),
        gdir=int(gdir),
    )


@dataclasses.dataclass(frozen=True)
class SetupData:
    grid: Grid
    Re: float
    boundary_conditions: tuple
    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cuda")
    closure_model: object = None
    bodyforce_field: object = None  # steady force (D, *N) on `device`, or None
    temperature: Temperature | None = None
    bodyforce: object = None  # the force callable, steady or not, or None
    issteadybodyforce: bool = True

    @property
    def unsteady_bodyforce(self):
        """The time-dependent force callable, or None."""
        return None if self.issteadybodyforce else self.bodyforce

    @functools.cached_property
    def dgrid(self) -> DeviceGrid:
        """The grid's vectors on `device`, copied at the first use by the
        general path's operators and kept with this setup (a setup made
        by `dataclasses.replace` makes its own)."""
        return device_grid(self.grid, self.device)

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
    """The steady force, evaluated once at t = 0."""
    full = tuple((0, n) for n in grid.N)
    xu = [[seg(grid.xu[a][b], full, b, device=device) for b in range(grid.dim)]
          for a in range(grid.dim)]
    return bodyforce_on_grid(bodyforce, xu, 0.0, grid.N, dtype, device)


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
    plus `device`).  With a temperature equation Re defaults to
    1/alpha1.  ``bodyforce(dim, *x, t)`` gets ``t`` as a 0-d tensor of
    ``dtype`` on ``device`` (see the module docstring)."""
    if closure_model is not None and not callable(closure_model):
        raise TypeError("closure_model must be a callable closure(u, theta)")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
    device = resolve_device(device)
    D = len(x)
    if boundary_conditions is None:
        boundary_conditions = tuple((PeriodicBC(), PeriodicBC()) for _ in range(D))
    boundary_conditions = tuple(tuple(bc) for bc in boundary_conditions)
    if Re is None:
        Re = 1000.0 if temperature is None else 1.0 / temperature.alpha1
    grid = make_grid(x=x, boundary_conditions=boundary_conditions, dtype=dtype)
    field = None
    if bodyforce is not None and issteadybodyforce:
        field = _bodyforce_field(bodyforce, grid, dtype, device)
    return SetupData(
        grid=grid,
        Re=float(Re),
        boundary_conditions=boundary_conditions,
        dtype=dtype,
        device=device,
        closure_model=closure_model,
        bodyforce_field=field,
        temperature=temperature,
        bodyforce=bodyforce,
        issteadybodyforce=bool(issteadybodyforce),
    )
