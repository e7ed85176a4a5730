"""Unsteady solve loop.

Port of `ins_tpu/solver.py`.  The run advances in chunks of steps;
processors (observability) run between chunks at their `nupdate`
decimation, and a NaN guard checks each chunk's velocity and
temperature.  Where the fused hat chain applies (3-D periodic cube,
classic-row RK tableau or LMWray3) a chunk carries
`HatState(ut, qhat, temp)` and materialises u only at its end, with the
natural-form Smagorinsky closure (``theta`` its constant), a steady body
force and the Boussinesq temperature (``tempstart``) on its stage
kernels; a tableau whose rows read earlier k's (SSP33, SSP104, RK56, ...)
steps the fused unmerged chain, with the Smagorinsky closure and a steady
body force too; with another closure model it steps the per-op chain
(``theta`` goes to the closure), otherwise the roll twin (which also
takes an unsteady body force, evaluated at each stage's time).
``stream_dtype=torch.bfloat16`` (opt-in, off by default, as in the JAX
package) stores the fused chains' velocity-like streams in bf16
(`make_fast_timestep_hat`); processors and the NaN guard see u at the
setup's dtype.  On a wall-bounded channel (x/y
periodic, static z walls, the FDM solver, no unsteady force) a chunk
carries a `ChannelHat` of the channel path (`ops/channelpath.py`) the
same way, crossing to and from the public ghosted layout with
`strip_channel`/`reghost_channel`.
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
host scalars, so a fixed-dt chunk syncs with the device only in the NaN
guard and the processors.

``dt=None`` steps adaptively, as the JAX package does: every
``n_adapt_dt`` steps the CFL limit `get_cfl_timestep` of the corrected
velocity (read off the carry without ending it: the hat chains' `from_hat`
leaves the carry as it is) times ``cfl``, at least ``dt_min``, at most
what is left to ``tend``.  The limit is the one host read of a recompute
(the kernels take dt as a host scalar); t and dt are tracked on the host
in the setup's dtype (numpy scalars), so that the steps are those JAX
computes.  A step that would not advance t (dt underflow away from
``tend``) raises `SolverDivergedError`.

With ``mesh=make_mesh()`` and ``halo=True`` every rank of the mesh's
process group calls `solve_unsteady` with the same global ghosted
``ustart``; each steps its x-slab through the halo chain's hat carry
(`parallel/halo.py`; the natural-form Smagorinsky closure, ``theta``
its constant, and a steady body force ride its stage kernels' force
stream), and at chunk ends the NaN guard and the processors see the
global field (`all_gather`), which is also what every rank returns.  On
the adaptive path each rank takes the CFL limit of its slab and one
``all_reduce(MIN)`` makes it the global one.  The GSPMD mesh path
(``mesh`` without ``halo``) and the halo path's other options wait for
ROADMAP queue 1 item 11.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .grid import _numpy_dtype
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

__all__ = ["solve_unsteady", "get_cfl_timestep", "get_state", "SolverDivergedError"]


class SolverDivergedError(RuntimeError):
    """A run produced non-finite fields, or its adaptive dt underflowed.
    Carries the last finite state (`state`, a dict like `get_state`'s, or
    None)."""

    def __init__(self, msg, state=None):
        super().__init__(msg)
        self.state = state


def get_state(stepper: StepperState):
    return dict(u=stepper.u, temp=stepper.temp, t=stepper.t, n=stepper.n)


def get_cfl_timestep(u, setup):
    """The largest stable time step of the velocity ``u`` by its
    convective and diffusive limits (the JAX package's
    `get_cfl_timestep`): per axis a, ``Re·min(δ_a)²/2`` and
    ``min(δ_a/|u_a|)`` over u_a's DOF box ``Iu[a]``, δ_a the distances
    between pressure points, in the setup's dtype.  ``u`` is ghosted
    ``(D, *N)`` (the general path's layout) or interior ``(D, *(N - 2))``
    (the fast, channel and halo paths').  A 0-d tensor on u's device,
    from device reductions only (no host read)."""
    g = setup.grid
    shape = tuple(u.shape[1:])
    if shape == tuple(g.N):
        return _cfl_box(u, setup, (0,) * g.dim)
    if shape == tuple(n - 2 for n in g.N):
        return _cfl_box(u, setup, (1,) * g.dim)
    raise ValueError(f"velocity of shape {tuple(u.shape)} is neither the ghosted nor the "
                     f"interior layout of a grid of {g.N} volumes")


def _cfl_box(u, setup, origin):
    """`get_cfl_timestep` of a field whose first cell is the ghosted
    index ``origin`` (a halo rank's slab: ``(1 + x0, 1, 1)``): its
    convective limit covers the cells it holds, the diffusive one the
    whole grid."""
    g = setup.grid
    ext = tuple(u.shape[1:])
    dt_diff = np.inf
    dt_conv = None
    for a in range(g.dim):
        s, e = g.Iu[a][a]
        dt_diff = min(dt_diff, setup.Re * np.min(g.delta_u[a][s:e]) ** 2 / 2)
        box = [(max(lo, o), min(hi, o + n)) for (lo, hi), o, n in zip(g.Iu[a], origin, ext)]
        ua = u[a][tuple(slice(lo - o, hi - o) for (lo, hi), o in zip(box, origin))]
        lo, hi = box[a]
        # δ_a is constant over each plane normal to a, so the plane's
        # min(δ/|u|) is δ/max|u| bit for bit (a rounded division is
        # monotone in its divisor): one read of u_a
        others = [d for d in range(g.dim) if d != a]
        m = torch.linalg.vector_norm(ua, float("inf"), dim=others)
        delta = setup.dgrid.delta_u[a].narrow(a, lo, hi - lo).reshape(-1).to(u.device)
        conv = torch.amin(delta / m)
        dt_conv = conv if dt_conv is None else torch.minimum(dt_conv, conv)
    return dt_conv.to(setup.dtype).clamp(max=float(dt_diff))


def _chunk_sizes(nstep: int, chunk: int):
    out = []
    left = nstep
    while left > 0:
        c = min(chunk, left)
        out.append(c)
        left -= c
    return out


class _Chain(NamedTuple):
    """How a path steps its interior state: ``to_c`` makes the carry,
    ``step(c, dt)`` advances it one step, ``from_c`` materialises the
    state (without ending the carry), ``cfl(s)`` is the CFL limit of a
    state's velocity as a 0-d tensor."""

    to_c: Callable
    step: Callable
    from_c: Callable
    cfl: Callable


def solve_unsteady(
    *,
    setup,
    ustart,
    tlims,
    tempstart=None,
    method=None,
    psolver=None,
    dt=None,
    dt_min=None,
    cfl=0.9,
    n_adapt_dt=1,
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
    """Solve the unsteady problem on `tlims`.  A fixed `dt` is rounded so
    that `(tend - tstart)/dt` is an integer; ``dt=None`` steps
    adaptively: ``cfl`` times the CFL limit of u (`get_cfl_timestep`),
    recomputed every ``n_adapt_dt`` steps, at least ``dt_min``, the last
    step ending on ``tend``.  `ustart` is a ghosted velocity field on
    `setup.device`, `tempstart` a ghosted temperature
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
    adapt = None if dt is not None else (cfl, dt_min, n_adapt_dt)
    if halo:
        return _solve_halo(setup, ustart, tlims, method, mesh, dt, processors, max_chunk,
                           nan_guard, projection_precision or "manualhigh", halo_psolver, theta,
                           adapt)
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

    def cfl_of(s):
        return get_cfl_timestep(s.u, setup)

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

    if hat_fns is not None:
        to_hat, step_hat, from_hat = hat_fns
        # theta reaches the periodic chain's Smagorinsky force
        extra = () if use_channel else (theta,)
        chain = _Chain(to_hat, lambda h, dt: step_hat(h, dt, *extra), from_hat, cfl_of)
    else:
        chain = _Chain(_same, lambda s, dt: step(s, dt, theta), _same, cfl_of)

    state = strip(create_stepper(method, setup=setup, psolver=psolver, u=ustart, temp=tempstart,
                                 t=tlims[0]))
    return _drive(state, chain, reghost_s, tlims, dt, processors, max_chunk, nan_guard, setup,
                  adapt)


def _same(s):
    return s


def _drive(state, chain, reghost_s, tlims, dt, processors, max_chunk, nan_guard, setup, adapt,
           local=_same, to_global=_same):
    """The chunk loop: ``state`` is the interior state, ``chain`` steps it
    (`_Chain`), ``reghost_s`` crosses to the public layout.  ``adapt`` is
    None (fixed ``dt``) or ``(cfl, dt_min, n_adapt_dt)``.  On a mesh
    ``local`` cuts the rank's slab from the global state and
    ``to_global`` gathers it back; the NaN guard and the processors see
    the global state."""
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

    def after_chunk(s, last_good):
        """The NaN guard and the processors on the global state; returns
        the new last finite state."""
        glob = to_global(s) if (nan_guard or processors) else None
        if nan_guard:
            if not (finite(glob) and math.isfinite(float(glob.t))):
                st = get_state(reghost_s(last_good))
                raise SolverDivergedError(
                    f"solver produced non-finite fields (last finite state: "
                    f"n={st['n']}, t={float(st['t']):g})",
                    state=st,
                )
            last_good = glob
        if processors:
            update_processors(glob)
        return last_good

    tstart, tend = tlims
    nupdates = [getattr(p, "nupdate", 1) for p in processors.values()]
    chunk = math.gcd(*nupdates) if nupdates else max_chunk
    last_good = state
    if adapt is None:
        nstep = int(round((tend - tstart) / dt))
        dt = (tend - tstart) / nstep
        chunk = max(1, min(chunk, max_chunk, nstep))
        state = local(state)
        for c in _chunk_sizes(nstep, chunk):
            with torch.no_grad():
                s = chain.to_c(state)
                for _ in range(c):
                    s = chain.step(s, dt)
                state = chain.from_c(s)
            last_good = after_chunk(state, last_good)
    else:
        chunk = max(1, min(chunk, max_chunk))
        fdt = _numpy_dtype(setup.dtype).type
        cfl, dt_min, n_adapt = adapt
        cfl_, dt_min_, tend_ = fdt(cfl), fdt(0.0 if dt_min is None else dt_min), fdt(tend)
        n_adapt = max(int(n_adapt), 1)
        margin = fdt(1e-14) * np.maximum(fdt(1.0), np.abs(tend_))
        state = local(state._replace(t=fdt(tstart)))

        def limit(s):
            # the recompute's one host read
            with torch.no_grad():
                return cfl_ * fdt(chain.cfl(s).item())

        def run(state, dtc):
            """Up to ``chunk`` steps of the JAX `scan_adaptive` loop."""
            with torch.no_grad():
                c, k = chain.to_c(state), 0
                while k < chunk and c.t < tend_ - margin:
                    if c.n % n_adapt == 0:
                        dtc = limit(chain.from_c(c))
                    dtc = np.maximum(dtc, dt_min_)
                    dt_step = fdt(np.minimum(dtc, tend_ - c.t))
                    if c.t + dt_step <= c.t:
                        break  # no progress (a NaN dt steps on to the NaN guard)
                    c, k = chain.step(c, dt_step), k + 1
                return chain.from_c(c), dtc

        # the seed, for states entering with n % n_adapt != 0
        dtc = np.maximum(limit(state), dt_min_)
        while float(state.t) < tend - 1e-14 * max(1.0, abs(tend)):
            n_prev = state.n
            state, dtc = run(state, dtc)
            if state.n == n_prev:
                ulp = float(np.finfo(fdt).eps) * max(1.0, abs(tend))
                if abs(tend - float(state.t)) <= 4 * ulp:
                    break  # reached tend to the dtype's resolution
                raise SolverDivergedError(
                    f"adaptive dt underflow at t={float(state.t):g} (dt={float(dtc):g})",
                    state=get_state(reghost_s(to_global(state))),
                )
            last_good = after_chunk(state, last_good)

    state = reghost_s(to_global(state))
    outputs = {
        k: p.finalize(initialized[k], get_state(state)) for k, p in processors.items()
    }
    return state, outputs


def _solve_halo(setup, ustart, tlims, method, mesh, dt, processors, max_chunk, nan_guard,
                precision, halo_psolver, theta, adapt):
    """`solve_unsteady` on the x-slab halo chain (every rank calls it);
    ``theta`` reaches the Smagorinsky force (0.17 where None).  The CFL
    limit is each slab's, then the minimum over the ranks."""
    import torch.distributed as dist

    from .parallel.halo import gather_interior, make_halo_fast_step, shard_interior

    step = make_halo_fast_step(setup, method, mesh, psolver=halo_psolver,
                               projection_precision=precision)
    to_hat, step_hat, from_hat = step.hat

    def cfl_of(s):
        lx = s.u.shape[1]
        c = _cfl_box(s.u, setup, (1 + mesh.rank * lx, 1, 1))
        dist.all_reduce(c, op=dist.ReduceOp.MIN, group=mesh.group)
        return c

    chain = _Chain(to_hat, lambda h, dt: step_hat(h, dt, theta), from_hat, cfl_of)
    ustart = torch.as_tensor(ustart, dtype=setup.dtype, device=mesh.device)
    state = strip_state(create_stepper(method, setup=setup, u=ustart, t=tlims[0]))
    return _drive(
        state, chain, reghost_state, tlims, dt, processors, max_chunk, nan_guard, setup, adapt,
        local=lambda s: s._replace(u=shard_interior(mesh, s.u)),
        to_global=lambda s: s._replace(u=gather_interior(mesh, s.u)),
    )
