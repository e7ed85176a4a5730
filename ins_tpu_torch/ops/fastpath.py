"""Ghost-free fast path for uniform periodic grids.

Port of `ins_tpu/ops/fastpath.py` for explicit RK tableaus and LMWray3,
with or without the Boussinesq temperature.  Fields are carried without
ghost cells (every stencil shift is a periodic roll); `strip_*`/`reghost*`
cross to and from the public ghosted layout.

Four chains:

- **The hat chain** (3-D cubes; classic-row tableaus such as RK44, and
  LMWray3): the carry is a `HatState` ``(ut, qhat, temp)`` — the
  uncorrected velocity, the pressure in the z/y eigen-basis and the
  temperature — and u is only materialised at chunk ends (`from_hat`).
  Every stage is one stage kernel (`pcmsd_hat_3d`, which rebuilds
  ``u = ut − ∇q`` inside) and pass B.  A chunk's first stage starts from
  a materialised u (`to_hat` sets ``qhat=None``), so it runs
  `momentum_stage_divhat_3d`, the same stage without the rebuild.  On
  CUDA tensors these are the hand-written kernels; on CPU tensors their
  plain versions.  A steady body force and the natural-form Smagorinsky
  closure (`smagorinsky_closure_natural`, recognised by its tag) ride
  every stage kernel's force stream; the Smagorinsky force is its own
  kernel, run on the rebuilt u just before each stage.  The temperature
  rides the stage kernels' temperature stream with the stage's own
  coefficients, mirroring the velocity's tableau streams: RK44's b-row
  accumulator, LMWray3's accumulator base.
- **The fused unmerged chain** (3-D cubes; explicit RK tableaus whose
  intermediate rows read earlier k's — SSP33, SSP42/43, SSP104, rSSPs3,
  RK56, DOPRI6, HEM3/5, RK44C2, Wray3 and the like — with no closure or
  the natural-form Smagorinsky one, a steady body force or none, no
  temperature): the JAX `step_unmerged`'s fused branch.  Each stage is
  one stage kernel (`momentum_stage_divhat_3d` on the stage's u with
  the streams ``[ustart, k_j for A[i][j] != 0]``, k emitted but at the
  last stage), pass B and the correction `pressure_correct_qhat_3d`; the
  Smagorinsky force rides the stage's force stream.  More than four k
  streams take the stage's many-stream kernel.
- **The per-op chain** (3-D with an untagged closure model, or
  ``differentiable=True``: the training unroll): `step_unmerged`'s
  per-op branch.  Each stage is the conv-diff kernel plus the closure
  force, then stage-div, the Poisson solve and the pressure correction,
  through the custom-VJP wrappers of `ops/diffkernels.py` (kernel
  forward, roll-graph adjoint backward); the Smagorinsky force goes
  through `make_smag_force_vjp`, differentiable in u and θ.  On the card
  the Poisson solve is the 3-pass `make_poisson_pallas` on a cube of at
  least `POISSON_PALLAS_MIN_N` cells a side when the chain is not
  differentiated, else the eigen-matmul `make_poisson_mm` (autograd
  differentiates it natively); on the CPU it is `torch.fft`.
- **The roll twin** (2-D, non-cubes, 2-D with a closure, and a tableau
  the two fused chains do not take: one whose rows read earlier k's, with
  the temperature): the same stage loop with conv-diff as a roll graph
  and the projection as roll-graph divergence and gradient around the
  solve; the Smagorinsky force as `smagorinsky_natural_interior`.

Every chain adds a steady body force to the momentum.  The per-op chain
and the roll twin carry the temperature as roll graphs
(`ops/temperature.py`).

Opt-in bf16 stream storage (``make_fast_timestep_hat(stream_dtype=
torch.bfloat16)``, as in the JAX package): the hat chain stores its ``ut``
carry, the emitted ustart and the b-row accumulator in bf16; a tableau
the hat chain does not take, on the fused unmerged chain, steps a bf16 u
(the stage's k streams and the correction's output bf16 too).  qhat, the
pass-B solve and all arithmetic stay at the setup's dtype, and the chunk
ends materialise u at it.  The steady body force is rounded to bf16 once.
With the temperature or the Smagorinsky closure the hat chain raises
NotImplementedError (ROADMAP queue 2 item 5); the unmerged chain then
has no bf16 form (None, as in the JAX package).
"""

from __future__ import annotations

import types
from typing import Any, NamedTuple

import torch

from ..boundary_conditions import PeriodicBC
from ..time_steppers.methods import ExplicitRungeKuttaMethod, LMWray3
from ..time_steppers.step import StepperState
from . import stage_kernels as sk
from .dft import make_poisson_mm
from .diffkernels import (
    convdiff_roll,
    make_convdiff_vjp,
    make_pressure_correct_vjp,
    make_smag_force_vjp,
    make_stage_div_vjp,
)
from .eddyviscosity import smagorinsky_natural_interior, theta_tensor
from .poisson_kernels import make_fused_projection, make_poisson_pallas
from .pressure import _spectral_solve, project_periodic, uniform_dxs
from .temperature import add_buoyancy, temp_rhs_roll

__all__ = [
    "fastpath_applicable",
    "strip_ghosts",
    "reghost",
    "strip_scalar",
    "reghost_scalar",
    "strip_state",
    "reghost_state",
    "make_fast_timestep",
    "make_fast_timestep_hat",
    "HatState",
    "hat_chain_applicable",
    "unmerged_chain_applicable",
]


class HatState(NamedTuple):
    """Carry of the step-boundary-merged chain: ``u = ut − ∇q`` with
    ``q = V_y·qhat·V_zᵀ``.  ``qhat=None`` means ``ut`` already is the
    corrected velocity (the state `to_hat` makes); ``temp`` is the
    interior temperature or None."""

    ut: Any
    qhat: Any
    temp: Any
    t: float
    n: int


# The per-op chain's Poisson solve on the card: the 3-pass kernels
# (`make_poisson_pallas`) on cubes from this extent up, `make_poisson_mm`'s
# contractions below it.  `chip_smoke.py`'s `solve_gate_times` measured the
# device time per solve on an H100 with the fused folded pass B (PERF.md
# §6): the contractions faster at 64³ (0.0436 against 0.0488 ms), the
# 3-pass kernels at 128³ (0.1043 against 0.1900) and 256³ (0.8814 against
# 1.8105).
POISSON_PALLAS_MIN_N = 128


def fastpath_applicable(setup, method, psolver):
    """The port's fast path: 2-D/3-D uniform periodic grid, an explicit
    RK tableau or LMWray3, the spectral pressure solver and, with a
    temperature equation, periodic temperature BCs."""
    g = setup.grid
    tq = setup.temperature
    temp_ok = tq is None or all(
        isinstance(b, PeriodicBC) for bcs in tq.boundary_conditions for b in bcs
    )
    return (
        all(g.periodic)
        and all(g.uniform)
        and temp_ok
        and isinstance(method, (ExplicitRungeKuttaMethod, LMWray3))
        and getattr(psolver, "is_spectral", False)
    )


def strip_ghosts(u):
    D = u.dim() - 1
    return u[(slice(None),) + (slice(1, -1),) * D].contiguous()


def reghost(u_int):
    """Periodic wrap pad == the periodic ghost fill."""
    D = u_int.dim() - 1
    for d in range(1, D + 1):
        n = u_int.shape[d]
        u_int = torch.cat(
            [u_int.narrow(d, n - 1, 1), u_int, u_int.narrow(d, 0, 1)], dim=d
        )
    return u_int


def strip_scalar(s):
    return s[(slice(1, -1),) * s.dim()].contiguous()


def reghost_scalar(s_int):
    """`reghost` of a scalar field."""
    return reghost(s_int[None])[0]


def strip_state(state):
    """Public (ghosted) -> fast-path (interior) state layout."""
    state = state._replace(u=strip_ghosts(state.u))
    if state.temp is not None:
        state = state._replace(temp=strip_scalar(state.temp))
    return state


def reghost_state(state):
    """Fast-path (interior) -> public (ghosted) state layout."""
    state = state._replace(u=reghost(state.u))
    if state.temp is not None:
        state = state._replace(temp=reghost_scalar(state.temp))
    return state


def _classic_lowstorage_rows(method):
    """True when every intermediate (shifted-tableau) row's only nonzero
    is its own stage's k (classic RK44 and friends), and for LMWray3 by
    construction."""
    if isinstance(method, LMWray3):
        return True
    A, ns = method.A, method.nstage
    return ns >= 2 and all(A[i][j] == 0.0 for i in range(ns - 1) for j in range(i))


def _is_smag(setup):
    """A natural-form Smagorinsky closure, recognised by its tag."""
    return getattr(setup.closure_model, "kind", None) == "smagorinsky_natural"


def hat_chain_applicable(setup, method):
    """Whether the fused hat chain runs this setup: 3-D cube, a
    classic-row tableau or LMWray3 (so the stage kernels' single tableau
    and accumulator streams hold each field, temperature included) and no
    closure model but the natural-form Smagorinsky one (another closure
    rides the per-op chain, as in the JAX package's `use_fused_stage`)."""
    g = setup.grid
    return (
        g.dim == 3
        and g.Np[0] == g.Np[1] == g.Np[2]
        and isinstance(method, (ExplicitRungeKuttaMethod, LMWray3))
        and _classic_lowstorage_rows(method)
        and (setup.closure_model is None or _is_smag(setup))
    )


def unmerged_chain_applicable(setup, method):
    """Whether the fused unmerged chain runs this setup: 3-D cube, an
    explicit RK tableau the hat chain does not take, no temperature and no
    closure model but the natural-form Smagorinsky one (the JAX package's
    `use_fused_stage` on such a tableau)."""
    g = setup.grid
    return (
        g.dim == 3
        and g.Np[0] == g.Np[1] == g.Np[2]
        and isinstance(method, ExplicitRungeKuttaMethod)
        and not _classic_lowstorage_rows(method)
        and setup.temperature is None
        and (setup.closure_model is None or _is_smag(setup))
    )


def _kernel_ops(plain):
    """The kernels of the hat chain: the wrappers (CUDA kernels on CUDA
    tensors, plain versions on CPU tensors) or, with ``plain``, the plain
    versions on any device (the reference chain a card's kernels are held
    against).  Pass B comes from the projection, which picks it (folded
    or dense)."""
    if plain:
        return types.SimpleNamespace(
            msd=sk.momentum_stage_divhat_3d_plain, pcmsd=sk.pcmsd_hat_3d_plain,
            correct=sk.pressure_correct_qhat_3d_plain,
        )
    return types.SimpleNamespace(
        msd=sk.momentum_stage_divhat_3d, pcmsd=sk.pcmsd_hat_3d,
        correct=sk.pressure_correct_qhat_3d,
    )


def _check_method(setup, method):
    if not isinstance(method, (ExplicitRungeKuttaMethod, LMWray3)):
        raise ValueError(
            f"{type(method).__name__} on the fast path: it steps explicit RK "
            "tableaus and LMWray3, as the JAX package's; AB-CN, one-leg and "
            "implicit RK methods step the general ghosted path "
            "(`time_steppers.step.timestep`, which `solve_unsteady` picks for them)"
        )


def _bodyforce_interior(setup):
    f = setup.bodyforce_field
    return None if f is None else strip_ghosts(f)


def _temp_consts(setup):
    """(gdir, alpha2, alpha4, dis) of the setup's temperature equation
    (``dis`` = Re·alpha1/gamma with dissipation, else None), or None."""
    tq = setup.temperature
    if tq is None:
        return None
    dis = setup.Re * tq.alpha1 / tq.gamma if tq.dodissipation else None
    return types.SimpleNamespace(gdir=tq.gdir, alpha2=tq.alpha2, alpha4=tq.alpha4, dis=dis)


def _stored_force(setup, sd):
    """The steady body force as the stage kernels read it: rounded to the
    stream storage dtype ``sd`` once (None: the setup's dtype)."""
    force = _bodyforce_interior(setup)
    return force if force is None or sd is None else force.to(sd)


def _make_hat_fns(setup, method, projection_precision, plain, sd=None):
    g = setup.grid
    dxs = uniform_dxs(setup)
    visc = 1.0 / setup.Re
    ops = _kernel_ops(plain)
    proj = make_fused_projection(
        g.Np, dxs, setup.dtype, precision=projection_precision, device=setup.device
    )
    passB = proj["passB_plain" if plain else "passB"]
    force = _stored_force(setup, sd)
    d2 = float(sum(d * d for d in dxs))
    tc = _temp_consts(setup)

    def temp_arg(T, tstart=None, tacc=None):
        """The stage kernels' ``temperature`` tuple: the stage's T, the
        tableau base (None: T itself) and the b-row accumulator base."""
        if T is None:
            return None
        return (T, tstart, tacc, tc.gdir, tc.alpha2, tc.alpha4, tc.dis)

    def stage(ut, qhat, base, coeff, *, unc=None, ub=None, smag=None, temp=None,
              emit_u=False):
        """One stage kernel, then pass B.  The merged stage rebuilds u from
        the carry's (ut, qhat); where ``qhat is None`` (ut is the corrected
        u) the stage without the rebuild runs, with the RECON base as its
        only stream.  Returns (ut, qhat, usnew, u, temp_next, tempnew):
        u the velocity (emitted with ``emit_u``), the last three None where
        not asked for."""
        kw = dict(precision=projection_precision, emit_k=False, usnew_coeff=unc,
                  usnew_base=ub, bodyforce=force, smag=smag, temperature=temp)
        if qhat is None:
            res = list(ops.msd(ut, (ut,), (coeff,), visc, dxs, proj["Vinv"], proj["VinvT"],
                               compute_dtype=setup.dtype, **kw))
            u = ut
        else:
            res = list(ops.pcmsd(ut, qhat, (base,), (coeff,), visc, dxs, proj,
                                 emit_u=emit_u, **kw))
            u = None
        ut, divhat = res.pop(0), res.pop(0)
        usnew = res.pop(0) if unc is not None else None
        if emit_u and qhat is not None:
            u = res.pop(0)
        tnext = res.pop(0) if temp is not None else None
        tnew = res.pop(0) if temp is not None and unc is not None else None
        return ut, passB(divhat), usnew, u, tnext, tnew

    def smag_arg(theta):
        # a tensor once per step, not once per launch
        if not _is_smag(setup):
            return None
        return (theta_tensor(theta, setup.dtype, setup.device), d2)

    if isinstance(method, ExplicitRungeKuttaMethod):
        A, ns = method.A, method.nstage

        def step_hat(h, dt, theta=None):
            """One RK step on the hat carry (the JAX `step_merged_hat`);
            the final pressure correction is deferred to the next step's
            stage 0 (or `from_hat`).  ``theta`` is the Smagorinsky
            constant where the setup has that closure.  The temperature
            mirrors the velocity's streams: base tempstart (the
            accumulator at the last stage), elided at stage 0 where T is
            the base."""
            smag = smag_arg(theta)
            ut, qhat, temp, t, n = h
            tempstart = tacc = temp
            for i in range(ns):
                last = i == ns - 1
                bcoef = A[ns - 1][i]
                unc = dt * bcoef if (bcoef != 0.0 and not last) else None
                tb = None if (unc is None or tacc is tempstart) else tacc
                if i == 0:
                    ut, qhat, usnew, ustart, tnext, tnew = stage(
                        ut, qhat, sk.RECON, dt * A[0][0], unc=unc, smag=smag,
                        temp=temp_arg(temp, None, tb), emit_u=ns > 1,
                    )
                    acc = usnew if unc is not None else ustart
                else:
                    ub = None if (unc is None or acc is ustart) else acc
                    ut, qhat, usnew, _, tnext, tnew = stage(
                        ut, qhat, acc if last else ustart, dt * A[i][i], unc=unc, ub=ub,
                        smag=smag, temp=temp_arg(temp, tacc if last else tempstart, tb),
                    )
                    if unc is not None:
                        acc = usnew
                if temp is not None:
                    temp = tnext
                    if unc is not None:
                        tacc = tnew
            return HatState(ut=ut, qhat=qhat, temp=temp, t=t + dt, n=n + 1)

    else:
        a, b = method.a, method.b
        ns = len(a)

        def step_hat(h, dt, theta=None):
            """One LMWray3 step on the hat carry (the JAX
            `step_merged_hat`): stage 0 takes the rebuilt u as its base
            and writes only the accumulator ``ustart + dt·b_0·f`` (later
            stages never read ustart itself); stage i takes that
            accumulator as its base.  A b_i of 0 leaves the accumulator as
            it is, so its (unchanged) copy is not written.  The
            temperature follows with its own accumulator."""
            smag = smag_arg(theta)
            ut, qhat, temp, t, n = h
            ustart = tempstart = None
            for i in range(ns):
                unc = None
                if i < ns - 1 and (i == 0 or b[i] != 0.0):
                    unc = dt * b[i]
                if i == 0:
                    ut, qhat, usnew, _, tnext, tnew = stage(
                        ut, qhat, sk.RECON, dt * a[0], unc=unc, smag=smag,
                        temp=temp_arg(temp),
                    )
                else:
                    ut, qhat, usnew, _, tnext, tnew = stage(
                        ut, qhat, ustart, dt * a[i], unc=unc, smag=smag,
                        temp=temp_arg(temp, tempstart),
                    )
                temp = tnext
                if unc is not None:
                    ustart, tempstart = usnew, tnew
            return HatState(ut=ut, qhat=qhat, temp=temp, t=t + dt, n=n + 1)

    def to_hat(state):
        # qhat=None: ut is the corrected velocity (no rebuild needed)
        ut = state.u if sd is None else state.u.to(sd)
        return HatState(ut=ut, qhat=None, temp=state.temp, t=state.t, n=state.n)

    def from_hat(h):
        u = h.ut.to(setup.dtype) if h.qhat is None else ops.correct(
            h.ut, h.qhat, dxs, proj["V"], proj["VT"], precision=projection_precision
        )
        return StepperState(u=u, temp=h.temp, t=h.t, n=h.n)

    return to_hat, step_hat, from_hat


def _make_unmerged_step(setup, method, projection_precision, plain, sd=None):
    """The fused unmerged chain: the JAX package's `step_unmerged` fused
    branch (``ins_tpu/ops/fastpath.py`` :755-771).  Stage i runs the stage
    kernel on its u with the streams ``[ustart, k_j for A[i][j] != 0]``
    and the coefficients ``dt·A[i][j]``, then ``dt·A[i][i]`` for its own k
    (emitted but at the last stage), pass B, and the correction, which
    emits the storage dtype.  ``sd`` (bf16) stores u, the k streams and
    the outputs in it; the arithmetic stays at the setup's dtype."""
    dxs = uniform_dxs(setup)
    visc = 1.0 / setup.Re
    ops = _kernel_ops(plain)
    proj = make_fused_projection(
        setup.grid.Np, dxs, setup.dtype, precision=projection_precision, device=setup.device
    )
    passB = proj["passB_plain" if plain else "passB"]
    force = _stored_force(setup, sd)
    smag = _is_smag(setup)
    d2 = float(sum(d * d for d in dxs))
    A, c, ns = method.A, method.c, method.nstage

    def step(state, dt, theta=None):
        """One RK step; ``theta`` is the Smagorinsky constant where the
        setup has that closure."""
        u, temp, tstart, n = state
        sm = (theta_tensor(theta, setup.dtype, setup.device), d2) if smag else None
        ustart, ku, t = u, [], tstart
        for i in range(ns):
            t = tstart + c[i] * dt
            streams, coeffs = [ustart], []
            for j in range(i):
                if A[i][j] != 0.0:
                    streams.append(ku[j])
                    coeffs.append(dt * A[i][j])
            coeffs.append(dt * A[i][i])
            emit_k = i < ns - 1
            res = ops.msd(u, streams, coeffs, visc, dxs, proj["Vinv"], proj["VinvT"],
                          precision=projection_precision, emit_k=emit_k, bodyforce=force,
                          smag=sm, compute_dtype=setup.dtype)
            if emit_k:
                ku.append(res[0])
            ut, divhat = res[-2:]
            u = ops.correct(ut, passB(divhat), dxs, proj["V"], proj["VT"],
                            precision=projection_precision, out_dtype=ut.dtype)
        return StepperState(u=u, temp=temp, t=t, n=n + 1)

    return step


def make_fast_timestep_hat(setup, method, *, projection_precision="manualhigh",
                           plain=False, stream_dtype=None):
    """``(to_hat, step_hat, from_hat)`` of the step-boundary-merged chain,
    or None where it does not apply (then use `make_fast_timestep`).
    ``plain=True`` builds it from the kernels' plain versions.
    ``step_hat(h, dt, theta=None)`` takes the Smagorinsky constant.

    ``stream_dtype`` (``torch.bfloat16``; None: the setup's dtype) stores
    the hat carry's ``ut``, the emitted ustart and the b-row accumulator
    in it; qhat, pass B and the arithmetic stay at the setup's dtype and
    `from_hat` returns u at it.  Where the hat chain does not apply but
    the fused unmerged chain does (a tableau whose rows read earlier k's,
    no Smagorinsky closure), the triple is ``(to_sd, step, from_sd)``: the
    unmerged chain on a u stored in ``stream_dtype``; elsewhere None, as
    in the JAX package."""
    _check_method(setup, method)
    sd = None if stream_dtype in (None, setup.dtype) else stream_dtype
    if hat_chain_applicable(setup, method):
        if sd is not None and (setup.temperature is not None or _is_smag(setup)):
            raise NotImplementedError(
                f"{sd} stream storage with the temperature or the Smagorinsky closure "
                "is not ported yet (ROADMAP queue 2 item 5)"
            )
        return _make_hat_fns(setup, method, projection_precision, plain, sd)
    if sd is None or not unmerged_chain_applicable(setup, method) or _is_smag(setup):
        return None
    step = _make_unmerged_step(setup, method, projection_precision, plain, sd)

    def to_sd(state):
        return state._replace(u=state.u.to(sd))

    def from_sd(state):
        return state._replace(u=state.u.to(setup.dtype))

    return to_sd, step, from_sd


def make_fast_timestep(setup, method, *, differentiable=False,
                       projection_precision="manualhigh", plain=False, _force_roll=False):
    """``step(state, dt, theta=None) -> state`` on the interior layout.

    With an untagged closure model or ``differentiable=True`` a 3-D setup
    runs the per-op chain (``theta`` goes to the closure); otherwise the
    hat chain materialised every step where it applies, else the fused
    unmerged chain where that applies, else the roll twin.
    ``plain=True`` builds the per-op and the unmerged chains from the
    kernels' plain versions (the reference chains on the card).
    ``_force_roll`` builds the roll twin whatever applies (the JAX
    package's hook of that name: a yardstick for the fused chains)."""
    _check_method(setup, method)
    smag = _is_smag(setup)
    per_op = (setup.closure_model is not None and not smag) or differentiable
    if not per_op and not _force_roll and hat_chain_applicable(setup, method):
        to_hat, step_hat, from_hat = _make_hat_fns(
            setup, method, projection_precision, plain=False
        )

        def step(state, dt, theta=None):
            return from_hat(step_hat(to_hat(state), dt, theta))

        return step
    if not per_op and not _force_roll and unmerged_chain_applicable(setup, method):
        return _make_unmerged_step(setup, method, projection_precision, plain)

    g = setup.grid
    D = g.dim
    dxs = uniform_dxs(setup)
    visc = 1.0 / setup.Re
    if setup.device.type == "cuda":
        # the 3-pass solve of hand kernels has no adjoint: a differentiated
        # chain contracts with the eigen-matrices, as the JAX package does
        if (D == 3 and len(set(g.Np)) == 1 and g.Np[0] >= POISSON_PALLAS_MIN_N
                and not differentiable):
            solve_p = make_poisson_pallas(g.Np, dxs, setup.dtype, precision=projection_precision,
                                          device=setup.device, plain=plain)
        else:
            solve_p = make_poisson_mm(g.Np, dxs, setup.dtype, setup.device)
    else:
        solve_p = _spectral_solve(g.Np, dxs, setup.dtype, setup.device)
    closure = setup.closure_model
    force = _bodyforce_interior(setup)
    tc = _temp_consts(setup)
    kernels = per_op and D == 3
    if kernels:
        convdiff = make_convdiff_vjp(visc, dxs, plain=plain)
        stage_div = make_stage_div_vjp(dxs, plain=plain)
        correct = make_pressure_correct_vjp(dxs, plain=plain)
        if smag:
            smag_force = make_smag_force_vjp(dxs, plain=plain)

    def momentum(u, temp, theta):
        F = convdiff(u) if kernels else convdiff_roll(u, visc, dxs)
        if temp is not None:
            F = add_buoyancy(F, temp, tc.gdir, tc.alpha2)
        if force is not None:
            F = F + force
        if smag:
            F = F + (smag_force(u, theta) if kernels
                     else smagorinsky_natural_interior(u, theta, dxs))
        elif closure is not None:
            # closures take the ghosted solver layout
            F = F + strip_ghosts(closure(reghost(u), theta))
        return F

    def temp_rhs(u, temp):
        return temp_rhs_roll(u, temp, dxs, tc.alpha4, visc, tc.dis)

    def stage_project(base, k, coeff):
        """Projected stage update P(base + coeff·k)."""
        if kernels:
            ut, div = stage_div(base, k, coeff)
            return correct(ut, solve_p(div))
        return project_periodic(base + coeff * k, dxs, solve_p)

    if isinstance(method, LMWray3):
        a, b = method.a, method.b

        def step(state, dt, theta=None):
            """The JAX package's LMWray3 `step_unmerged` per-op branch."""
            u, temp, tstart, n = state
            if smag:
                theta = theta_tensor(theta, setup.dtype, setup.device)
            ustart, tempstart = u, temp
            for i in range(len(a)):
                du = momentum(u, temp, theta)
                dtemp = temp_rhs(u, temp) if temp is not None else None
                u = stage_project(ustart, du, dt * a[i])
                if temp is not None:
                    temp = tempstart + dt * a[i] * dtemp
                if i < len(a) - 1:
                    ustart = ustart + dt * b[i] * du
                    if temp is not None:
                        tempstart = tempstart + dt * b[i] * dtemp
            return StepperState(u=u, temp=temp, t=tstart + dt, n=n + 1)

        return step

    A, c, ns = method.A, method.c, method.nstage

    def step(state, dt, theta=None):
        """The JAX package's `step_unmerged` per-op branch."""
        u, temp, tstart, n = state
        if smag:
            theta = theta_tensor(theta, setup.dtype, setup.device)
        ustart, tempstart = u, temp
        ku, kt = [], []
        t = tstart
        for i in range(ns):
            base = ustart
            for j in range(i):
                if A[i][j] != 0.0:
                    base = base + (dt * A[i][j]) * ku[j]
            ku.append(momentum(u, temp, theta))
            if temp is not None:
                kt.append(temp_rhs(u, temp))
            t = tstart + c[i] * dt
            if A[i][i] != 0.0:
                u = stage_project(base, ku[i], dt * A[i][i])
            else:  # degenerate diagonal entry: nothing new to add
                u = project_periodic(base, dxs, solve_p)
            if temp is not None:
                temp = tempstart
                for j in range(i + 1):
                    if A[i][j] != 0.0:
                        temp = temp + (dt * A[i][j]) * kt[j]
        return StepperState(u=u, temp=temp, t=t, n=n + 1)

    return step
