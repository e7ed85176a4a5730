"""Processors: in-loop observability.

Port of the protocol, `timelogger`, `fieldsaver`, `observefield`,
`observespectrum` and `observe_nusselt` of `ins_tpu/processors.py`, plus
`total_kinetic_energy` (`ops/operators.py`), on any grid.  A processor is ``(initialize, update,
finalize)`` over snapshots of the solver state taken at chunk
boundaries; ``nupdate`` decimation also sets the chunk size, so no step
forces a device-to-host sync.  The other observers wait for ROADMAP
queue 1 items 3 and 10.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from .ops._stencil import seg
from .ops.operators import total_kinetic_energy
from .utils.spectrum import observe_spectrum, spectral_stuff

__all__ = [
    "Processor",
    "processor",
    "timelogger",
    "fieldsaver",
    "observefield",
    "observespectrum",
    "observe_nusselt",
    "total_kinetic_energy",
]


@dataclasses.dataclass
class Processor:
    initialize: Callable[[dict], Any]
    update: Callable[[Any, dict], Any]
    finalize: Callable[[Any, dict], Any]
    nupdate: int = 1


def processor(update, *, initialize=None, finalize=None, nupdate=1):
    """Build a processor from an update function `pstate, state -> pstate`."""
    return Processor(
        initialize=initialize or (lambda state: None),
        update=update,
        finalize=finalize or (lambda pstate, state: pstate),
        nupdate=nupdate,
    )


def timelogger(nupdate=1):
    """Print step number, time, wall time per step and umax."""

    def initialize(state):
        return {"wall": time.perf_counter(), "n": int(state["n"])}

    def update(pstate, state):
        umax = float(state["u"].abs().max())  # waits for the device
        now = time.perf_counter()
        n = int(state["n"])
        itertime = (now - pstate["wall"]) / max(1, n - pstate["n"])
        print(
            f"Iteration {n}\tt = {float(state['t']):.3g}"
            f"\tΔt_wall = {itertime * 1e3:.3g} ms/it\tumax = {umax:.3g}"
        )
        return {"wall": now, "n": n}

    return Processor(initialize, update, lambda p, s: None, nupdate)


def fieldsaver(nupdate=1):
    """Keep host (numpy) copies of the state every `nupdate` steps."""

    def initialize(state):
        return []

    def update(fields, state):
        temp = state.get("temp")
        fields.append(
            dict(
                u=state["u"].detach().cpu().numpy(),
                temp=None if temp is None else temp.detach().cpu().numpy(),
                t=float(state["t"]),
            )
        )
        return fields

    return Processor(initialize, update, lambda fields, s: fields, nupdate)


def _to_host(v):
    """Tensors (also inside lists, tuples and dicts) as numpy arrays."""
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    if isinstance(v, (list, tuple)):
        return type(v)(_to_host(x) for x in v)
    if isinstance(v, dict):
        return {k: _to_host(x) for k, x in v.items()}
    return v


def observefield(func, *, nupdate=1):
    """Record a derived quantity `func(state) -> value` every `nupdate`
    steps, tensors copied to the host as numpy arrays."""

    def initialize(state):
        return []

    def update(vals, state):
        vals.append(_to_host(func(state)))
        return vals

    return Processor(initialize, update, lambda vals, s: vals, nupdate)


def observespectrum(setup, *, nupdate=1, npoint=100):
    """Processor recording the binned kinetic-energy spectrum: per velocity
    component the FFT of the interior, cropped to the first K wavenumbers
    per dimension, |û|²/(2·prod(Np)²) summed and binned by
    `utils.spectrum.observe_spectrum`.  Returns dict(kappa, ehat, t)."""
    g = setup.grid
    D = g.dim
    st = spectral_stuff(setup, npoint=npoint)
    K = st["K"]
    ip = tuple(slice(s, e) for s, e in g.Ip)
    scale = 2 * float(np.prod(g.Np)) ** 2

    def ehat_of(u):
        e = 0.0
        for a in range(D):
            uhat = u[a][ip]
            for d in range(D):  # per axis, cropped as it goes
                uhat = torch.fft.fft(uhat, dim=d).narrow(d, 0, K[d])
            e = e + uhat.abs() ** 2 / scale
        return observe_spectrum(e.to(u.dtype), st)

    def initialize(state):
        return dict(kappa=st["kappa"].cpu().numpy(), ehat=[], t=[])

    def update(ps, state):
        ps["ehat"].append(ehat_of(state["u"]).cpu().numpy())
        ps["t"].append(float(state["t"]))
        return ps

    return Processor(initialize, update, lambda ps, s: ps, nupdate)


def _interior_volume_weights(setup):
    """Cell volumes over the interior pressure box (volume averages on
    stretched grids)."""
    g = setup.grid
    w = torch.ones(tuple(e - s for s, e in g.Ip), dtype=setup.dtype, device=setup.device)
    for d in range(g.dim):
        w = w * seg(g.delta[d], g.Ip, d, device=setup.device).to(setup.dtype)
    return w


def observe_nusselt(setup, *, nupdate=1):
    """Processor recording the volume-averaged Nusselt number
    ``Nu = 1 + <u_g θ>/α4`` (`ins_tpu.processors.observe_nusselt`): u_g,
    the velocity in the gravity direction averaged to the pressure points
    from I and I − e_g, times the temperature, volume-weighted over the
    interior (`_interior_volume_weights`), on any grid.  Returns
    dict(t, Nu)."""
    te = setup.temperature
    if te is None:
        raise ValueError("observe_nusselt requires a temperature equation")
    g = setup.grid
    gdir = te.gdir
    ip = tuple(slice(s, e) for s, e in g.Ip)
    left = tuple(slice(s - (d == gdir), e - (d == gdir)) for d, (s, e) in enumerate(g.Ip))
    w = _interior_volume_weights(setup)
    wsum = torch.sum(w)

    def nu_of(u, temp):
        up = (u[gdir][left] + u[gdir][ip]) / 2
        return 1.0 + torch.sum(w * up * temp[ip]) / wsum / te.alpha4

    def update(ps, state):
        ps["t"].append(float(state["t"]))
        ps["Nu"].append(float(nu_of(state["u"], state["temp"])))
        return ps

    def initialize(state):
        return update(dict(t=[], Nu=[]), state)

    return Processor(initialize, update, lambda ps, s: ps, nupdate)
