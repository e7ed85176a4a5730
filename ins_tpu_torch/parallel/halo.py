"""The x-slab halo chain: explicit ring exchanges and transposes.

Port of the x-slab (1-D mesh) fused eigen chain of
`ins_tpu/parallel/halo.py` (`make_halo_fast_step`, :98-1339) on
`torch.distributed`: NCCL between cards, gloo on the CPU.  Each rank
holds a slab ``(3, lx, n, n)`` of the ghost-free velocity of a periodic
uniform cube (lx = n / ranks) and runs the per-shard kernels of
`ops/stage_kernels.py`:

- **halo exchange** (`_x_lo`, `_x_hi`, the JAX `ppermute` ring shifts,
  :277-291): the left neighbour's last k x-planes and the right
  neighbour's first k, by `batch_isend_irecv` to the ring neighbours.  In
  a ring of one the neighbour is the rank itself and the exchange is its
  own planes, so it takes the local slice (NCCL never sees a send to
  itself);
- **the stage** `momentum_stage_divhat_halo_3d` / `pcmsd_hat_halo_3d`
  (conv-diff, tableau, divergence and the plane-local z/y forward
  transform, exact on a shard since y and z are whole);
- **pass B** (`passB_dist`, :447-470): the x<->y transpose as
  `all_to_all_single`, the shard's (n, ly, n) y-slice solved with full x
  by `make_passB_sharded` at its y offset, and the transpose back;
- **the correction** `pressure_correct_qhat_halo_3d`.

Two forms, as in the JAX package: the per-step merged chain (`step`:
stage 0 the stage kernel on u, stages 1.. the merged kernel on the
previous stage's (ut, qhat), the correction at the end) and the per-shard
hat carry (`step.hat`: the correction deferred to the next step's stage
0, which rebuilds u with a RECON base).  As in the port's single-device
hat chain, `to_hat` marks u as corrected (``qhat=None``) and a chunk's
first stage runs the stage kernel on u, where the JAX package starts from
``qhat = 0``: the same numbers.  The classic-row RK tableaus (RK44) and
LMWray3 run here.

The natural-form Smagorinsky LES (`smagorinsky_closure_natural`, θ
through ``step(state, dt, theta)``, 0.17 where None) and a steady body
force ride the stage kernels' force stream, as in the JAX package's fused
chain (:751-789): with the closure the ghost exchanges widen to 3 lower
and 2 upper planes of u/ut and 3 and 3 of qhat, and each stage runs the
halo force kernel on planes −1 .. lx − 1 before the stage kernel (so the
closure needs x-slabs of at least 3 planes).  The body force is sharded
once and its plane −1 exchanged once, when the step is built: it is
steady.  An unsteady callable force raises ValueError, as in the JAX
package; 2-D pencil meshes, the CG and pencil-FFT solvers, the modular
(non-fused) kernels, the unmerged chain, other tableaus and temperature
raise NotImplementedError (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import stage_kernels as sk
from ..ops.eddyviscosity import theta_tensor
from ..ops.fastpath import HatState, _classic_lowstorage_rows, _is_smag, strip_ghosts
from ..ops.poisson_kernels import make_passB_sharded
from ..ops.pressure import uniform_dxs
from ..time_steppers.methods import ExplicitRungeKuttaMethod, LMWray3
from ..time_steppers.step import StepperState

__all__ = [
    "make_halo_fast_step",
    "shard_interior",
    "shard_scalar",
    "gather_interior",
]

_ITEM = "ROADMAP queue 1 item 11"


def _slab(mesh, n):
    if n % mesh.size:
        raise ValueError(f"extent {n} is not divisible by the mesh's {mesh.size} ranks")
    lx = n // mesh.size
    return slice(mesh.rank * lx, (mesh.rank + 1) * lx)


def shard_interior(mesh, u_int):
    """This rank's x-slab of a ghost-free field ``(D, nx, ny[, nz])`` (x is
    dim 1), contiguous on the mesh's device."""
    return u_int[:, _slab(mesh, u_int.shape[1])].to(mesh.device).contiguous()


def shard_scalar(mesh, s_int):
    """This rank's x-slab of a scalar interior field ``(nx, ny[, nz])``."""
    return s_int[_slab(mesh, s_int.shape[0])].to(mesh.device).contiguous()


def gather_interior(mesh, u_loc):
    """The global field from every rank's x-slab (``all_gather``): the
    inverse of `shard_interior`, on every rank."""
    parts = [torch.empty_like(u_loc) for _ in range(mesh.size)]
    dist.all_gather(parts, u_loc.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=-3)


def _peer(mesh, r):
    r %= mesh.size
    return r if mesh.group is None else dist.get_global_rank(mesh.group, r)


def _ring_shift(mesh, send, step):
    """Send ``send`` to the rank ``step`` along the ring and receive the
    same from the rank ``-step`` along it."""
    if mesh.size == 1:
        return send
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, _peer(mesh, mesh.rank + step), mesh.group),
           dist.P2POp(dist.irecv, recv, _peer(mesh, mesh.rank - step), mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def _x_lo(mesh, v, k):
    """The left ring neighbour's last k x-planes (this block's lower
    ghosts); x is dim -3 of vectors and scalars."""
    return _ring_shift(mesh, v[..., -k:, :, :].contiguous(), 1)


def _x_hi(mesh, v, k):
    """The right ring neighbour's first k x-planes (upper ghosts)."""
    return _ring_shift(mesh, v[..., :k, :, :].contiguous(), -1)


def _check(setup, method, mesh, psolver, merge, fused):
    g = setup.grid
    if g.dim != 3 or not (all(g.periodic) and all(g.uniform)):
        raise ValueError("the halo path steps a 3-D uniform periodic grid")
    if not isinstance(method, (ExplicitRungeKuttaMethod, LMWray3)):
        raise ValueError(
            f"{type(method).__name__} on the halo path: it steps explicit RK "
            "tableaus and LMWray3, as the JAX package's"
        )
    if psolver == "cg":
        raise NotImplementedError(f"halo_psolver='cg' is not ported yet ({_ITEM})")
    if psolver != "pencil":
        raise ValueError(f"unknown halo psolver {psolver!r}")
    if not fused:
        raise NotImplementedError(f"the modular halo kernels path is not ported yet ({_ITEM})")
    if merge is not True and merge != "auto":
        raise NotImplementedError(
            f"the unmerged fused halo chain (merge={merge!r}) is not ported yet ({_ITEM})"
        )
    if not _classic_lowstorage_rows(method):
        raise NotImplementedError(
            f"the halo path steps classic-row RK tableaus (RK44) and LMWray3; other "
            f"tableaus ride the unmerged chain ({_ITEM})"
        )
    if setup.temperature is not None:
        raise NotImplementedError(f"temperature on the halo path is not ported yet ({_ITEM})")
    if setup.unsteady_bodyforce is not None or (
        setup.bodyforce_field is not None and not torch.is_tensor(setup.bodyforce_field)
    ):
        raise ValueError(
            "halo fast path: unsteady callable body forces are not supported; "
            "precompute a steady field (issteadybodyforce)"
        )
    if setup.closure_model is not None and not _is_smag(setup):
        raise ValueError(
            "halo fast path: only the tagged natural-form Smagorinsky closure is "
            "supported (smagorinsky_closure_natural)"
        )
    n = g.Np[0]
    if not g.Np[0] == g.Np[1] == g.Np[2]:
        raise NotImplementedError(
            f"the halo path's pencil FFT (non-cube grids, here {tuple(g.Np)}) is not "
            f"ported yet ({_ITEM})"
        )
    # the Smagorinsky force's lower ghosts are the left neighbour's last 3
    # planes
    least = 3 if _is_smag(setup) else 2
    if n % mesh.size or n // mesh.size < least:
        raise ValueError(
            f"n = {n} must split into {mesh.size} x-slabs of at least {least} planes"
            + (" (the Smagorinsky closure's ghosts)" if least == 3 else "")
        )


def make_halo_fast_step(setup, method, mesh, *, psolver="pencil",
                        projection_precision="manualhigh", merge="auto", fused=True):
    """``step(state, dt, theta=None) -> state`` on this rank's x-slab of
    the interior velocity (``state.u`` of shape (3, lx, n, n) on
    ``mesh.device``), every rank calling it in step.  ``step.hat`` is
    ``(to_hat, step_hat, from_hat)`` of the per-shard hat carry (a
    `HatState` of this rank's slab; ``qhat=None``: ``ut`` is corrected);
    ``step.fused`` and ``step.merged`` are True (the only chain ported).
    ``merge="auto"`` takes the merged chain (the JAX package's VMEM gate
    `pcmsd_halo_profitable` has no counterpart here).  ``theta`` is the
    Smagorinsky constant where the setup has that closure."""
    _check(setup, method, mesh, psolver, merge, fused)
    n = setup.grid.Np[0]
    P = mesh.size
    ly = n // P
    dxs = uniform_dxs(setup)
    visc = 1.0 / setup.Re
    prec = projection_precision
    proj = make_passB_sharded(setup.grid.Np, dxs, setup.dtype, ly, precision=prec,
                              device=mesh.device)
    smag_on = _is_smag(setup)
    d2 = float(sum(d * d for d in dxs))
    # the ghost planes of u/ut (lower, upper); qhat takes one more above
    glo, ghi = (3, 2) if smag_on else (2, 1)

    def x_lo(v, k):
        return _x_lo(mesh, v, k)

    def x_hi(v, k):
        return _x_hi(mesh, v, k)

    # the steady body force: this rank's slab and its plane -1, once
    bf = bf_lo = None
    if setup.bodyforce_field is not None:
        bf = shard_interior(mesh, strip_ghosts(setup.bodyforce_field))
        bf_lo = x_lo(bf, 1)

    def smag_arg(theta):
        # a tensor once per step, not once per launch
        if not smag_on:
            return None
        return (theta_tensor(0.17 if theta is None else theta, setup.dtype, mesh.device), d2)

    def passB_dist(divhat):
        """(lx, n, n) divhat -> (lx, n, n) qhat: y chunked into P pieces,
        the all-to-all makes the leading index the source x-block, so the
        shard holds (n, ly, n) with full x; pass B at y offset rank·ly;
        the inverse transpose."""
        lx = divhat.shape[0]
        send = divhat.view(lx, P, ly, n).permute(1, 0, 2, 3).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=mesh.group)
        qh = proj["passB"](recv.view(P * lx, ly, n), mesh.rank * ly).contiguous()
        back = torch.empty_like(qh)
        dist.all_to_all_single(back, qh, group=mesh.group)
        return back.view(P, lx, ly, n).permute(1, 0, 2, 3).reshape(lx, n, n).contiguous()

    def stage_u(u, u_lo, u_lo1, coeff, unc, smag):
        """Stage 0 on a corrected u (its own tableau base; ``u_lo1`` is
        its plane −1)."""
        ut, divhat, *rest = sk.momentum_stage_divhat_halo_3d(
            u, u_lo, x_hi(u, ghi), (u,), (u_lo1,), (coeff,), visc, dxs, proj["Vinv"],
            proj["VinvT"], precision=prec, emit_k=False, usnew_coeff=unc, bodyforce=bf,
            bodyforce_lo=bf_lo, smag=smag,
        )
        return ut, passB_dist(divhat), rest[0] if rest else None

    def merged(ut, qhat, base, base_lo, coeff, unc, smag, ub=None, emit_u=False):
        """The merged stage on the previous stage's (ut, qhat); returns
        (ut, qhat, usnew or None, u or None)."""
        res = list(sk.pcmsd_hat_halo_3d(
            ut, x_lo(ut, glo), x_hi(ut, ghi), qhat, x_lo(qhat, glo), x_hi(qhat, ghi + 1),
            (base,), (base_lo,), (coeff,), visc, dxs, proj, precision=prec, emit_k=False,
            usnew_coeff=unc, bodyforce=bf, bodyforce_lo=bf_lo, usnew_base=ub, smag=smag,
            emit_u=emit_u,
        ))
        ut, divhat = res.pop(0), res.pop(0)
        usnew = res.pop(0) if unc is not None else None
        u = res.pop(0) if emit_u else None
        return ut, passB_dist(divhat), usnew, u

    def correct(ut, qhat):
        return sk.pressure_correct_qhat_halo_3d(ut, qhat, x_hi(qhat, 1), dxs, proj["V"],
                                                proj["VT"], precision=prec)

    def first_stage(ut, qhat, coeff, unc, smag, emit_u):
        """Stage 0 of a step: on the corrected u (``qhat is None``) or on
        the carry, rebuilt with a RECON base.  Returns (ut, qhat, usnew,
        u, u's plane −1), u and its plane only where ``emit_u``."""
        if qhat is None:
            u_lo = x_lo(ut, glo)
            u_lo1 = u_lo[:, -1:].contiguous()  # plane -1 rides the ghost exchange
            nut, nqhat, usnew = stage_u(ut, u_lo, u_lo1, coeff, unc, smag)
            return nut, nqhat, usnew, ut, u_lo1
        nut, nqhat, usnew, u = merged(ut, qhat, sk.RECON, sk.RECON, coeff, unc, smag,
                                      emit_u=emit_u)
        return nut, nqhat, usnew, u, x_lo(u, 1) if emit_u else None

    if isinstance(method, ExplicitRungeKuttaMethod):
        A, ns = method.A, method.nstage

        def step_hat(h, dt, theta=None):
            """One RK step (the JAX `step_hat_local`): the b-row
            accumulator rides usnew, the last stage takes it as its base;
            the final correction is left to the next step or `from_hat`."""
            smag = smag_arg(theta)
            ut, qhat = h.ut, h.qhat
            for i in range(ns):
                last = i == ns - 1
                bcoef = A[ns - 1][i]
                unc = dt * bcoef if (bcoef != 0.0 and not last) else None
                if i == 0:
                    ut, qhat, usnew, ustart, ustart_lo = first_stage(
                        ut, qhat, dt * A[0][0], unc, smag, emit_u=ns > 1
                    )
                    acc = usnew if unc is not None else ustart
                else:
                    ub = None if (unc is None or acc is ustart) else acc
                    base, base_lo = (acc, x_lo(acc, 1)) if last else (ustart, ustart_lo)
                    ut, qhat, usnew, _ = merged(ut, qhat, base, base_lo, dt * A[i][i], unc,
                                                smag, ub)
                    if unc is not None:
                        acc = usnew
            return HatState(ut=ut, qhat=qhat, temp=None, t=h.t + dt, n=h.n + 1)

    else:
        a, b = method.a, method.b
        ns = len(a)

        def step_hat(h, dt, theta=None):
            """One LMWray3 step (the JAX `step_hat_local`): stage 0 writes
            only the accumulator ``u + dt·b_0·f``, stage i takes it as its
            base; a b_i of 0 leaves it as it is (no copy written)."""
            smag = smag_arg(theta)
            ut, qhat = h.ut, h.qhat
            ustart = None
            for i in range(ns):
                unc = None
                if i < ns - 1 and (i == 0 or b[i] != 0.0):
                    unc = dt * b[i]
                if i == 0:
                    ut, qhat, usnew, *_ = first_stage(ut, qhat, dt * a[0], unc, smag,
                                                      emit_u=False)
                else:
                    ut, qhat, usnew, _ = merged(ut, qhat, ustart, x_lo(ustart, 1), dt * a[i],
                                                unc, smag)
                if unc is not None:
                    ustart = usnew
            return HatState(ut=ut, qhat=qhat, temp=None, t=h.t + dt, n=h.n + 1)

    def to_hat(state):
        # qhat=None: ut is the corrected velocity (stage 0 needs no rebuild)
        return HatState(ut=state.u, qhat=None, temp=state.temp, t=state.t, n=state.n)

    def from_hat(h):
        u = h.ut if h.qhat is None else correct(h.ut, h.qhat)
        return StepperState(u=u, temp=h.temp, t=h.t, n=h.n)

    def step(state, dt, theta=None):
        """The per-step merged chain: stage 0 on u, stages 1.. merged,
        the correction at the end."""
        return from_hat(step_hat(to_hat(state), dt, theta))

    step.fused = True
    step.merged = True
    step.hat = (to_hat, step_hat, from_hat)
    return step
