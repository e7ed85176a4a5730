"""Processors: in-loop observability.

Port of the protocol, `timelogger` and `fieldsaver` of
`ins_tpu/processors.py`, plus `total_kinetic_energy` on periodic grids
and channels.  A processor is ``(initialize, update, finalize)`` over snapshots
of the solver state taken at chunk boundaries; ``nupdate`` decimation
also sets the chunk size, so no step forces a device-to-host sync.  The
other observers wait for ROADMAP queue 1 items 3 and 10.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from .ops._stencil import seg
from .ops.channelpath import channelpath_applicable

__all__ = [
    "Processor",
    "processor",
    "timelogger",
    "fieldsaver",
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
        fields.append(
            dict(
                u=state["u"].detach().cpu().numpy(),
                temp=None,
                t=float(state["t"]),
            )
        )
        return fields

    return Processor(initialize, update, lambda fields, s: fields, nupdate)


def total_kinetic_energy(u, setup):
    """Volume-integrated kinetic energy of a ghosted velocity field: at
    each pressure point the mean of the squared face velocities on both
    sides, scaled by the cell volume and summed
    (`ins_tpu.ops.operators.total_kinetic_energy`).  Uniform periodic
    grids and channels (whose ghosts hold the walls).  Returns a 0-d
    tensor on the field's device."""
    g = setup.grid
    if not ((all(g.periodic) and all(g.uniform)) or channelpath_applicable(setup)):
        raise NotImplementedError(
            "total_kinetic_energy is ported for uniform periodic grids and "
            "channels (ROADMAP queue 1 item 3)"
        )
    D = g.dim
    box = g.Ip
    acc = 0.0
    for a in range(D):
        here = tuple(slice(s, e) for s, e in box)
        left = tuple(slice(s - (d == a), e - (d == a)) for d, (s, e) in enumerate(box))
        acc = acc + u[a][here] ** 2 + u[a][left] ** 2
    k = acc / 4
    for d in range(D):
        k = k * seg(g.delta[d], box, d, device=u.device).to(u.dtype)
    return torch.sum(k)
