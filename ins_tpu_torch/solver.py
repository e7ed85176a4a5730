"""Unsteady solve loop.

Port of the fixed-dt loop of `ins_tpu/solver.py`.  The run advances in
chunks of steps; processors (observability) run between chunks at their
`nupdate` decimation, and a NaN guard checks each chunk's velocity and
temperature.  Where the fused hat chain applies (3-D periodic cube,
classic-row RK tableau or LMWray3) a chunk carries
`HatState(ut, qhat, temp)` and materialises u only at its end, with the
natural-form Smagorinsky closure (``theta`` its constant), a steady body
force and the Boussinesq temperature (``tempstart``) on its stage
kernels; a tableau whose rows read earlier k's (SSP33, SSP104, RK56, ...)
steps the fused unmerged chain, with the Smagorinsky closure and a steady
body force too; with another closure model it steps the per-op chain
(``theta`` goes to the closure), otherwise the roll twin.
``stream_dtype=torch.bfloat16`` (opt-in, off by default, as in the JAX
package) stores the fused chains' velocity-like streams in bf16
(`make_fast_timestep_hat`); processors and the NaN guard see u at the
setup's dtype.  On a wall-bounded channel (x/y
periodic, static z walls, the FDM solver) a chunk carries a `ChannelHat`
of the channel path (`ops/channelpath.py`) the same way, crossing to and
from the public ghosted layout with `strip_channel`/`reghost_channel`.
Every other setup (walls, symmetric and pressure boundaries, stretched
grids, non-periodic temperature, the ghosted Smagorinsky closure,
`psolver_cg`, `psolver_cg_matrix`, `psolver_direct`, or the channel
without `psolver_fdm`) and every other method (AB-CN, one-leg, implicit
RK tableaus) steps the general ghosted path: `time_steppers.step.timestep`
on the ghosted state (ghost fills, the staggered operators,
`ops.pressure.project`; AB-CN and one-leg carry their own states, whose
``u`` and ``temp`` the NaN guard and the processors see), as the JAX
package's `else` branch does.  The run is not differentiated (it
runs under `torch.no_grad`; training unrolls go through
`models.training`).  The step is an eager Python loop of
kernel launches; dt and the tableau coefficients reach the kernels as
Python floats, so a chunk syncs with the device only in the NaN guard
and the processors.

With ``mesh=make_mesh()`` and ``halo=True`` every rank of the mesh's
process group calls `solve_unsteady` with the same global ghosted
``ustart``; each steps its x-slab through the halo chain's hat carry
(`parallel/halo.py`; the natural-form Smagorinsky closure, ``theta``
its constant, and a steady body force ride its stage kernels' force
stream), and at chunk ends the NaN guard and the processors see the
global field (`all_gather`), which is also what every rank returns.
Adaptive (CFL) stepping, the GSPMD mesh path (``mesh`` without
``halo``) and the halo path's other options wait for ROADMAP queue 1
items 6 and 11.
"""

from __future__ import annotations

import math

import torch

from .ops.channelpath import (
    channelpath_applicable,
    make_channel_timestep_hat,
    reghost_channel,
    strip_channel,
)
from .ops.fastpath import (
    fastpath_applicable,
    make_fast_timestep,
    make_fast_timestep_hat,
    reghost_state,
    strip_state,
)
from .ops.pressure import default_psolver
from .time_steppers.rk_methods import RK44
from .time_steppers.step import StepperState, create_stepper, timestep

__all__ = ["solve_unsteady", "get_state", "SolverDivergedError"]


class SolverDivergedError(RuntimeError):
    """A run produced non-finite fields.  Carries the last finite state
    (`state`, a dict like `get_state`'s, or None)."""

    def __init__(self, msg, state=None):
        super().__init__(msg)
        self.state = state


def get_state(stepper: StepperState):
    return dict(u=stepper.u, temp=stepper.temp, t=stepper.t, n=stepper.n)


def _chunk_sizes(nstep: int, chunk: int):
    out = []
    left = nstep
    while left > 0:
        c = min(chunk, left)
        out.append(c)
        left -= c
    return out


def solve_unsteady(
    *,
    setup,
    ustart,
    tlims,
    tempstart=None,
    method=None,
    psolver=None,
    dt=None,
    processors=None,
    theta=None,
    max_chunk=256,
    nan_guard=True,
    projection_precision=None,
    mesh=None,
    halo=False,
    halo_psolver="pencil",
    stream_dtype=None,
):
    """Solve the unsteady problem on `tlims` with a fixed `dt`, rounded
    so that `(tend - tstart)/dt` is an integer.  `ustart` is a ghosted
    velocity field on `setup.device`, `tempstart` a ghosted temperature
    (`temperaturefield`) where the setup has a temperature equation;
    `processors` is a dict name -> Processor.  Returns `(state, outputs)`
    with the state in the public ghosted layout.  `theta` holds the
    closure model's parameters.  `projection_precision` ("manualhigh" or
    "highest") is accepted for parity; both run at FP32 here.  ``mesh``
    (`parallel.make_mesh`) with ``halo=True`` steps the x-slab halo chain
    on every rank of the mesh (``halo_psolver="pencil"``: the fused eigen
    projection); see the module docstring.  ``stream_dtype``
    (``torch.bfloat16``) stores the periodic fast path's velocity-like
    streams in bf16 (`make_fast_timestep_hat`); where that has no bf16 form
    the run steps at the setup's dtype, and the channel and halo paths do
    not read it (as in the JAX package)."""
    if dt is None:
        raise NotImplementedError(
            "adaptive (CFL) time stepping is not ported yet (ROADMAP queue 1 item 6)"
        )
    if tempstart is not None and setup.temperature is None:
        raise ValueError("tempstart needs a setup with a temperature equation")
    if method is None:
        method = RK44()
    if halo and mesh is None:
        raise ValueError("halo=True requires a mesh")
    if mesh is not None and not halo:
        raise NotImplementedError(
            "the GSPMD mesh path (mesh without halo=True) is not ported yet (ROADMAP "
            "queue 1 item 11); pass halo=True for the x-slab halo chain"
        )
    if halo:
        return _solve_halo(setup, ustart, tlims, method, mesh, dt, processors, max_chunk,
                           nan_guard, projection_precision or "manualhigh", halo_psolver, theta)
    if psolver is None:
        psolver = default_psolver(setup)
    use_fast = fastpath_applicable(setup, method, psolver)
    # the channel path's projection is the FDM solve, so it runs where the
    # chosen solver is that solve (as in the JAX package)
    use_channel = (
        not use_fast
        and getattr(psolver, "is_fdm", False)
        and channelpath_applicable(setup, method)
    )
    # no path writes into its inputs, so the caller's field needs no
    # defensive copy
    ustart = torch.as_tensor(ustart, dtype=setup.dtype, device=setup.device)
    if tempstart is not None:
        tempstart = torch.as_tensor(tempstart, dtype=setup.dtype, device=setup.device)
    precision = projection_precision or "manualhigh"

    step = None
    hat_fns = None
    if not (use_fast or use_channel):
        # the general ghosted path: the state stays in the public layout

        def step(s, dt, theta):
            return timestep(method, s, dt, setup=setup, psolver=psolver, theta=theta)

        strip = reghost_s = _same
    elif use_channel:
        hat_fns = make_channel_timestep_hat(setup, method)

        def strip(s):
            return s._replace(u=strip_channel(s.u))

        def reghost_s(s):
            return s._replace(u=reghost_channel(s.u, setup))
    else:
        hat_fns = make_fast_timestep_hat(setup, method, projection_precision=precision,
                                         stream_dtype=stream_dtype)
        if hat_fns is None:
            step = make_fast_timestep(setup, method, projection_precision=precision)
        strip, reghost_s = strip_state, reghost_state

    def run_chunk(s, nsteps, dt):
        if hat_fns is not None:
            to_hat, step_hat, from_hat = hat_fns
            h = to_hat(s)
            # theta reaches the periodic chain's Smagorinsky force
            extra = () if use_channel else (theta,)
            for _ in range(nsteps):
                h = step_hat(h, dt, *extra)
            return from_hat(h)
        for _ in range(nsteps):
            s = step(s, dt, theta)
        return s

    state = strip(create_stepper(method, setup=setup, psolver=psolver, u=ustart, temp=tempstart,
                                 t=tlims[0]))
    return _drive(state, run_chunk, reghost_s, tlims, dt, processors, max_chunk, nan_guard)


def _same(s):
    return s


def _drive(state, run_chunk, reghost_s, tlims, dt, processors, max_chunk, nan_guard,
           local=_same, to_global=_same):
    """The chunk loop: ``state`` is the interior state, ``run_chunk`` steps
    it, ``reghost_s`` crosses to the public layout.  On a mesh ``local``
    cuts the rank's slab from the global state and ``to_global`` gathers
    it back; the NaN guard and the processors see the global state."""
    processors = dict(processors or {})
    initialized = {
        k: p.initialize(get_state(reghost_s(state))) for k, p in processors.items()
    }

    def update_processors(s):
        st = None
        for k, p in processors.items():
            if s.n % getattr(p, "nupdate", 1) == 0:
                if st is None:
                    st = get_state(reghost_s(s))
                initialized[k] = p.update(initialized[k], st)

    def finite(s):
        ok = bool(torch.isfinite(s.u).all())
        if ok and s.temp is not None:
            ok = bool(torch.isfinite(s.temp).all())
        return ok

    tstart, tend = tlims
    nstep = int(round((tend - tstart) / dt))
    dt = (tend - tstart) / nstep
    nupdates = [getattr(p, "nupdate", 1) for p in processors.values()]
    chunk = math.gcd(*nupdates) if nupdates else max_chunk
    chunk = max(1, min(chunk, max_chunk, nstep))

    last_good = state
    state = local(state)
    for c in _chunk_sizes(nstep, chunk):
        with torch.no_grad():
            state = run_chunk(state, c, dt)
        glob = to_global(state) if (nan_guard or processors) else None
        if nan_guard:
            if not finite(glob):
                st = get_state(reghost_s(last_good))
                raise SolverDivergedError(
                    f"solver produced non-finite fields (last finite state: "
                    f"n={st['n']}, t={st['t']:g})",
                    state=st,
                )
            last_good = glob
        if processors:
            update_processors(glob)

    state = reghost_s(to_global(state))
    outputs = {
        k: p.finalize(initialized[k], get_state(state)) for k, p in processors.items()
    }
    return state, outputs


def _solve_halo(setup, ustart, tlims, method, mesh, dt, processors, max_chunk, nan_guard,
                precision, halo_psolver, theta):
    """`solve_unsteady` on the x-slab halo chain (every rank calls it);
    ``theta`` reaches the Smagorinsky force (0.17 where None)."""
    from .parallel.halo import gather_interior, make_halo_fast_step, shard_interior

    step = make_halo_fast_step(setup, method, mesh, psolver=halo_psolver,
                               projection_precision=precision)
    to_hat, step_hat, from_hat = step.hat

    def run_chunk(s, nsteps, dt):
        h = to_hat(s)
        for _ in range(nsteps):
            h = step_hat(h, dt, theta)
        return from_hat(h)

    ustart = torch.as_tensor(ustart, dtype=setup.dtype, device=mesh.device)
    state = strip_state(create_stepper(method, setup=setup, u=ustart, t=tlims[0]))
    return _drive(
        state, run_chunk, reghost_state, tlims, dt, processors, max_chunk, nan_guard,
        local=lambda s: s._replace(u=shard_interior(mesh, s.u)),
        to_global=lambda s: s._replace(u=gather_interior(mesh, s.u)),
    )
