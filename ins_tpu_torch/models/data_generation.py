"""Filtered-DNS data generation for closure training.

Port of `ins_tpu/models/data_generation.py`: a DNS burn-in, then a DNS
run with a `filtersaver` processor that, every ``savefreq`` steps,
computes for each (LES grid, filter) pair the filtered velocity ``Φu``
and the commutator error ``c = Φ(F(u)) − P(F(Φu))``.  The DNS steps
whatever path `solve_unsteady` picks for its setup (the fused hat chain
on a 3-D periodic cube); the snapshots go through the general path's
operators (`ops.operators.momentum`, `boundary_conditions.apply_bc_u`,
`ops.pressure.project`) on the setups' device and reach the host as
numpy arrays.  Random draws come from a numpy `Generator` (the force)
and a `torch.Generator` (the initial field) in place of `jax.random`
keys.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..boundary_conditions import apply_bc_u
from ..ops.initializers import random_field
from ..ops.operators import momentum
from ..ops.pressure import default_psolver, project
from ..processors import Processor, timelogger
from ..setup import Setup
from ..solver import solve_unsteady
from ..time_steppers.rk_methods import RK44

__all__ = [
    "gaussian_force",
    "gaussian_bump",
    "filtersaver",
    "create_les_data",
    "create_io_arrays",
]


def gaussian_bump(setup, xc, yc, phi, *, sigma=0.05, A=0.002):
    """The steady Gaussian body-force bump of `gaussian_force` centred at
    (xc, yc) and pointing along (sin φ, cos φ): periodically extended
    over the eight neighbouring images and mean-free.  2-D, ``(2, *N)``
    on the setup's device."""
    g = setup.grid
    if g.dim != 2:
        raise ValueError("gaussian_force is 2-D")
    (x0, x1), (y0, y1) = g.xlims
    Lx, Ly = x1 - x0, y1 - y0
    sx, sy = sigma * Lx, sigma * Ly
    xs = torch.as_tensor(g.xp[0], dtype=setup.dtype, device=setup.device).reshape(-1, 1)
    ys = torch.as_tensor(g.xp[1], dtype=setup.dtype, device=setup.device).reshape(1, -1)
    f = 0.0
    for lx in (-Lx, 0.0, Lx):
        for ly in (-Ly, 0.0, Ly):
            f = f + A * torch.exp(-((xs - xc - lx) ** 2) / (2 * sx**2)
                                  - ((ys - yc - ly) ** 2) / (2 * sy**2))
    F = torch.stack([math.sin(phi) * f, math.cos(phi) * f])
    return F - F.mean()


def gaussian_force(setup, *, sigma=0.05, A=0.002, rng):
    """Random steady Gaussian body-force bump (2-D): its centre and
    direction are three uniform draws from the numpy Generator ``rng``
    (`gaussian_bump` holds the formula)."""
    (x0, x1), (y0, y1) = setup.grid.xlims
    a, b, c = rng.random(3)
    return gaussian_bump(setup, x0 + a * (x1 - x0), y0 + b * (y1 - y0), 2 * np.pi * c,
                         sigma=sigma, A=A)


def filtersaver(dns, les, filters, compression, psolver_dns, psolver_les, *, nupdate=1):
    """Processor computing filtered-DNS training pairs.

    Returns per (LES setup, filter) combination a dict with the stacked
    ``u`` (filtered velocity) and ``c`` (commutator error) numpy arrays,
    the snapshot times ``t`` and ``comptime`` (wall seconds)."""
    combos = [
        (les_i, compression[i], psolver_les[i], phi)
        for i, les_i in enumerate(les)
        for phi in filters
    ]

    def dns_force(u, t):
        F = apply_bc_u(momentum(u, None, t, dns), t, dns, dudt=True)
        return project(F, dns, psolver=psolver_dns)

    def snapshot(u, F, t, les_i, comp, psolver_i, phi):
        Phiu = apply_bc_u(phi(u, les_i, comp), t, les_i)
        PhiF = phi(F, les_i, comp)
        FPhi = apply_bc_u(momentum(Phiu, None, t, les_i), t, les_i, dudt=True)
        return Phiu, PhiF - project(FPhi, les_i, psolver=psolver_i)

    def initialize(state):
        pstate = {"t": [], "u": [[] for _ in combos], "c": [[] for _ in combos],
                  "comptime": time.time()}
        return _update(pstate, state)

    def _update(pstate, state):
        u, t = state["u"], state["t"]
        with torch.no_grad():
            F = dns_force(u, t)
            pstate["t"].append(float(t))
            for k, combo in enumerate(combos):
                Phiu, c = snapshot(u, F, t, *combo)
                pstate["u"][k].append(Phiu.cpu().numpy())
                pstate["c"][k].append(c.cpu().numpy())
        return pstate

    def finalize(pstate, state):
        return [
            dict(u=np.stack(pstate["u"][k]), c=np.stack(pstate["c"][k]),
                 t=np.asarray(pstate["t"]), comptime=time.time() - pstate["comptime"])
            for k in range(len(combos))
        ]

    return Processor(initialize, _update, finalize, nupdate)


def create_les_data(*, D, Re, lims, nles, ndns, filters, tburn, tsim, savefreq, dt=None,
                    method=None, create_psolver=default_psolver, icfunc=None, rng=None,
                    dtype=torch.float32, device="cuda", processors=None, **kwargs):
    """Generate filtered-DNS data: a DNS of ``ndns`` volumes a side on
    ``lims``, burnt in for ``tburn``, then run for ``tsim`` with a
    `filtersaver` every ``savefreq`` steps for each LES grid of ``nles``
    and each filter.  The initial field is ``icfunc(dns, psolver, rng)``,
    by default `random_field` drawn from ``rng`` (a `torch.Generator` on
    ``device``, or None for the global one).  Further keywords go to
    `Setup`.  Returns the saver's list of dicts, one per (LES grid,
    filter) pair, LES grids outer."""
    if method is None:
        method = RK44()
    compression = [ndns // n for n in nles]
    if any(c * n != ndns for c, n in zip(compression, nles)):
        raise ValueError(f"every LES size must divide ndns = {ndns}: {nles}")

    def make(n):
        x = tuple(np.linspace(lims[0], lims[1], n + 1) for _ in range(D))
        return Setup(x=x, Re=Re, dtype=dtype, device=device, **kwargs)

    dns = make(ndns)
    les = [make(n) for n in nles]
    psolver = create_psolver(dns)
    psolver_les = [create_psolver(s) for s in les]

    if icfunc is None:
        ustart = random_field(dns, psolver=psolver, generator=rng)
    else:
        ustart = icfunc(dns, psolver, rng)
    if bool(torch.isnan(ustart).any()):
        print("Warning: initial conditions contain NaNs")

    base_procs = dict(processors if processors is not None else {"log": timelogger(nupdate=10)})
    state, _ = solve_unsteady(setup=dns, ustart=ustart, tlims=(0.0, tburn), dt=dt,
                              method=method, psolver=psolver, processors=base_procs)
    fsaver = filtersaver(dns, les, filters, compression, psolver, psolver_les,
                         nupdate=savefreq)
    _, outputs = solve_unsteady(setup=dns, ustart=state.u, tlims=(0.0, tsim), dt=dt,
                                method=method, psolver=psolver,
                                processors={**base_procs, "f": fsaver})
    return outputs["f"]


def create_io_arrays(data, setup):
    """Interior (ubar, c) training arrays, batch first and channels last
    ``(nsample, *n, D)``, as numpy."""
    g = setup.grid
    inside = g.Iu[0]
    if not all(box == inside for box in g.Iu):
        raise ValueError("create_io_arrays needs equal DOF boxes (a periodic grid)")
    sl = (slice(None), slice(None)) + tuple(slice(s, e) for (s, e) in inside)
    return {
        key: np.concatenate([np.moveaxis(traj[key][sl], 1, -1) for traj in data], axis=0)
        for key in ("u", "c")
    }
