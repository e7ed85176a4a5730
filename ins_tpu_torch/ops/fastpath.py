"""Ghost-free fast path for uniform periodic grids.

Port of `ins_tpu/ops/fastpath.py` for explicit RK tableaus without
temperature.  Fields are carried without ghost cells
(every stencil shift is a periodic roll); `strip_*`/`reghost*` cross to
and from the public ghosted layout.

Three chains:

- **The hat chain** (3-D cubes, classic-row tableaus such as RK44): the
  carry is a `HatState` ``(ut, qhat)`` — the uncorrected velocity and
  the pressure in the z/y eigen-basis — and u is only materialised at
  chunk ends (`from_hat`).  Every RK stage is one stage kernel
  (`pcmsd_hat_3d`, which rebuilds ``u = ut − ∇q`` inside) and pass B.
  A chunk's first stage starts from a materialised u (`to_hat` sets
  ``qhat=None``), so it runs `momentum_stage_divhat_3d`, the same stage
  without the rebuild.  On CUDA tensors these are the hand-written
  kernels; on CPU tensors their plain versions.  A steady body force and
  the natural-form Smagorinsky closure (`smagorinsky_closure_natural`,
  recognised by its tag) ride every stage kernel's force stream; the
  Smagorinsky force is its own kernel, run on the rebuilt u just before
  each stage.
- **The per-op chain** (3-D with an untagged closure model, or
  ``differentiable=True``: the training unroll): `step_unmerged`'s
  per-op branch.  Each stage is the conv-diff kernel plus the closure
  force, then stage-div, the Poisson solve and the pressure correction,
  through the custom-VJP wrappers of `ops/diffkernels.py` (kernel
  forward, roll-graph adjoint backward); the Smagorinsky force goes
  through `make_smag_force_vjp`, differentiable in u and θ.  The Poisson
  solve is the eigen-matmul `make_poisson_mm` on the card and `torch.fft`
  on the CPU, as the JAX package picks it; both differentiate natively.
- **The roll twin** (2-D, non-cubes, other tableaus, and 2-D with a
  closure): the same stage loop with conv-diff as a roll graph and the
  projection as roll-graph divergence and gradient around the solve; the
  Smagorinsky force as `smagorinsky_natural_interior`.

Every chain adds a steady body force to the momentum.  LMWray3,
temperature and bf16 streams are ROADMAP queue 1 item 6.
"""

from __future__ import annotations

import types
from typing import Any, NamedTuple

import torch

from ..time_steppers.methods import ExplicitRungeKuttaMethod
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
from .poisson_kernels import make_fused_projection
from .pressure import _spectral_solve, project_periodic, uniform_dxs

__all__ = [
    "fastpath_applicable",
    "strip_ghosts",
    "reghost",
    "strip_state",
    "reghost_state",
    "make_fast_timestep",
    "make_fast_timestep_hat",
    "HatState",
    "hat_chain_applicable",
]


class HatState(NamedTuple):
    """Carry of the step-boundary-merged chain: ``u = ut − ∇q`` with
    ``q = V_y·qhat·V_zᵀ``.  ``qhat=None`` means ``ut`` already is the
    corrected velocity (the state `to_hat` makes)."""

    ut: Any
    qhat: Any
    temp: Any
    t: float
    n: int


def fastpath_applicable(setup, method, psolver):
    """The port's fast path: 2-D/3-D uniform periodic grid, an explicit
    RK tableau and the spectral pressure solver."""
    g = setup.grid
    return (
        all(g.periodic)
        and all(g.uniform)
        and isinstance(method, ExplicitRungeKuttaMethod)
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


def strip_state(state):
    """Public (ghosted) -> fast-path (interior) state layout."""
    return state._replace(u=strip_ghosts(state.u))


def reghost_state(state):
    """Fast-path (interior) -> public (ghosted) state layout."""
    return state._replace(u=reghost(state.u))


def _classic_lowstorage_rows(method):
    """True when every intermediate (shifted-tableau) row's only nonzero
    is its own stage's k (classic RK44 and friends)."""
    A, ns = method.A, method.nstage
    return ns >= 2 and all(A[i][j] == 0.0 for i in range(ns - 1) for j in range(i))


def _is_smag(setup):
    """A natural-form Smagorinsky closure, recognised by its tag."""
    return getattr(setup.closure_model, "kind", None) == "smagorinsky_natural"


def hat_chain_applicable(setup, method):
    """Whether the fused hat chain runs this setup: 3-D cube,
    classic-row tableau and no closure model but the natural-form
    Smagorinsky one (another closure rides the per-op chain, as in the
    JAX package's `use_fused_stage`)."""
    g = setup.grid
    return (
        g.dim == 3
        and g.Np[0] == g.Np[1] == g.Np[2]
        and isinstance(method, ExplicitRungeKuttaMethod)
        and _classic_lowstorage_rows(method)
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
    if not isinstance(method, ExplicitRungeKuttaMethod):
        raise NotImplementedError(
            f"{type(method).__name__} is not ported yet: the port's fast "
            "path steps explicit RK tableaus (LMWray3 is ROADMAP queue 1 item 6)"
        )


def _bodyforce_interior(setup):
    f = setup.bodyforce_field
    return None if f is None else strip_ghosts(f)


def _make_hat_fns(setup, method, projection_precision, plain):
    g = setup.grid
    dxs = uniform_dxs(setup)
    visc = 1.0 / setup.Re
    ops = _kernel_ops(plain)
    proj = make_fused_projection(
        g.Np, dxs, setup.dtype, precision=projection_precision, device=setup.device
    )
    passB = proj["passB_plain" if plain else "passB"]
    A, ns = method.A, method.nstage
    force = _bodyforce_interior(setup)
    d2 = float(sum(d * d for d in dxs))

    def stage0(ut, qhat, coeff, unc, smag):
        """Stage 0: from a materialised u (``qhat is None``) without the
        rebuild, else the step-boundary merge with the rebuilt u as base.
        Returns (ut, divhat, usnew, ustart)."""
        if qhat is None:
            res = ops.msd(
                ut, (ut,), (coeff,), visc, dxs, proj["Vinv"], proj["VinvT"],
                precision=projection_precision, emit_k=False, usnew_coeff=unc,
                bodyforce=force, smag=smag,
            )
            ustart = ut
        else:
            res = ops.pcmsd(
                ut, qhat, (sk.RECON,), (coeff,), visc, dxs, proj,
                precision=projection_precision, emit_k=False, usnew_coeff=unc,
                bodyforce=force, smag=smag, emit_u=ns > 1,
            )
            ustart = res[-1] if ns > 1 else None
        usnew = res[2] if unc is not None else None
        return res[0], res[1], usnew, ustart

    def step_hat(h, dt, theta=None):
        """One RK step on the hat carry; the final pressure correction is
        deferred to the next step's stage 0 (or `from_hat`).  ``theta``
        is the Smagorinsky constant where the setup has that closure (made
        a tensor once per step, not once per launch)."""
        smag = None
        if _is_smag(setup):
            smag = (theta_tensor(theta, setup.dtype, setup.device), d2)
        ut, qhat, _, t, n = h
        for i in range(ns):
            last = i == ns - 1
            bcoef = A[ns - 1][i]
            unc = dt * bcoef if (bcoef != 0.0 and not last) else None
            if i == 0:
                ut, divhat, usnew, ustart = stage0(ut, qhat, dt * A[0][0], unc, smag)
                acc = usnew if unc is not None else ustart
            else:
                ub = None if (unc is None or acc is ustart) else acc
                res = ops.pcmsd(
                    ut, qhat, ((acc,) if last else (ustart,)), (dt * A[i][i],),
                    visc, dxs, proj, precision=projection_precision,
                    emit_k=False, usnew_coeff=unc, usnew_base=ub,
                    bodyforce=force, smag=smag,
                )
                ut, divhat = res[0], res[1]
                if unc is not None:
                    acc = res[2]
            qhat = passB(divhat)
        return HatState(ut=ut, qhat=qhat, temp=None, t=t + dt, n=n + 1)

    def to_hat(state):
        # qhat=None: ut is the corrected velocity (no rebuild needed)
        return HatState(ut=state.u, qhat=None, temp=None, t=state.t, n=state.n)

    def from_hat(h):
        u = h.ut if h.qhat is None else ops.correct(
            h.ut, h.qhat, dxs, proj["V"], proj["VT"], precision=projection_precision
        )
        return StepperState(u=u, temp=None, t=h.t, n=h.n)

    return to_hat, step_hat, from_hat


def make_fast_timestep_hat(setup, method, *, projection_precision="manualhigh",
                           plain=False):
    """``(to_hat, step_hat, from_hat)`` of the step-boundary-merged chain,
    or None where it does not apply (then use `make_fast_timestep`).
    ``plain=True`` builds it from the kernels' plain versions.
    ``step_hat(h, dt, theta=None)`` takes the Smagorinsky constant."""
    _check_method(setup, method)
    if not hat_chain_applicable(setup, method):
        return None
    return _make_hat_fns(setup, method, projection_precision, plain)


def make_fast_timestep(setup, method, *, differentiable=False,
                       projection_precision="manualhigh", plain=False):
    """``step(state, dt, theta=None) -> state`` on the interior layout.

    With an untagged closure model or ``differentiable=True`` a 3-D setup
    runs the per-op chain (``theta`` goes to the closure); otherwise the
    hat chain materialised every step where it applies, else the roll
    twin.  ``plain=True`` builds the per-op chain from the kernels' plain
    versions (the reference chain on the card)."""
    _check_method(setup, method)
    smag = _is_smag(setup)
    per_op = (setup.closure_model is not None and not smag) or differentiable
    if not per_op and hat_chain_applicable(setup, method):
        to_hat, step_hat, from_hat = _make_hat_fns(
            setup, method, projection_precision, plain=False
        )

        def step(state, dt, theta=None):
            return from_hat(step_hat(to_hat(state), dt, theta))

        return step

    D = setup.grid.dim
    dxs = uniform_dxs(setup)
    visc = 1.0 / setup.Re
    if setup.device.type == "cuda":
        solve_p = make_poisson_mm(setup.grid.Np, dxs, setup.dtype, setup.device)
    else:
        solve_p = _spectral_solve(setup.grid.Np, dxs, setup.dtype, setup.device)
    closure = setup.closure_model
    force = _bodyforce_interior(setup)
    kernels = per_op and D == 3
    if kernels:
        convdiff = make_convdiff_vjp(visc, dxs, plain=plain)
        stage_div = make_stage_div_vjp(dxs, plain=plain)
        correct = make_pressure_correct_vjp(dxs, plain=plain)
        if smag:
            smag_force = make_smag_force_vjp(dxs, plain=plain)
    A, c, ns = method.A, method.c, method.nstage

    def momentum(u, theta):
        F = convdiff(u) if kernels else convdiff_roll(u, visc, dxs)
        if force is not None:
            F = F + force
        if smag:
            F = F + (smag_force(u, theta) if kernels
                     else smagorinsky_natural_interior(u, theta, dxs))
        elif closure is not None:
            # closures take the ghosted solver layout
            F = F + strip_ghosts(closure(reghost(u), theta))
        return F

    def stage_project(base, k, coeff):
        """Projected stage update P(base + coeff·k)."""
        if kernels:
            ut, div = stage_div(base, k, coeff)
            return correct(ut, solve_p(div))
        return project_periodic(base + coeff * k, dxs, solve_p)

    def step(state, dt, theta=None):
        """The JAX package's `step_unmerged` per-op branch."""
        u, _, tstart, n = state
        if smag:
            theta = theta_tensor(theta, setup.dtype, setup.device)
        ustart = u
        ku = []
        t = tstart
        for i in range(ns):
            base = ustart
            for j in range(i):
                if A[i][j] != 0.0:
                    base = base + (dt * A[i][j]) * ku[j]
            ku.append(momentum(u, theta))
            t = tstart + c[i] * dt
            if A[i][i] != 0.0:
                u = stage_project(base, ku[i], dt * A[i][i])
            else:  # degenerate diagonal entry: nothing new to add
                u = project_periodic(base, dxs, solve_p)
        return StepperState(u=u, temp=None, t=t, n=n + 1)

    return step
