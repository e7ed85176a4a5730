"""Wall-bounded (channel-topology) fast path.

Port of `ins_tpu/ops/channelpath.py`: x/y periodic uniform, z Dirichlet
walls on a (possibly stretched) wall-normal grid, a steady body force,
explicit classic-row RK tableaus (the reference's
`examples/TurbulentChannel.jl`).

- **Interior layout, pinned wall slot.** Velocity is carried ghost-free
  as ``(3, nx, ny, nz)``.  u and v occupy all nz cell centres; w's DOFs
  are the nz-1 interior faces in slots 0..nz-2 and slot nz-1 holds the
  top-wall face (identically 0).  The bottom-wall face is 0 as well, so
  every periodic z-roll of w wraps the pinned slot around as exactly the
  right wall ghost: w needs no masking.  Only u/v z-shifts select the
  wall velocity at slots 0 and nz-1.
- **Static z-metric vectors** (`ChannelMetrics`): every stretched-grid
  coefficient is a 1-D vector over the interior slots, 0 at w's pinned
  slot so that masked terms vanish by construction.
- **Projection by fast diagonalization** (`ops/fdm.py`): dense per-axis
  eigen contractions.

The roll functions here are the float64-exact ground truth of the two
kernels of `ops/channel_kernels.py` and the CPU twin of the chain.  Two
step forms: the per-stage form (`make_channel_timestep`) and the
merged-projection hat chain
(`make_channel_timestep_hat`), whose carry `ChannelHat` holds the
unprojected target and q; u is materialised only at chunk ends.  The
kernel wrappers run their plain versions on CPU tensors, so both forms
exist on every device.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..boundary_conditions import _const_wall_values
from ..grid import _numpy_dtype
from ..time_steppers.methods import ExplicitRungeKuttaMethod
from .diffkernels import roll_m as _rm
from .diffkernels import roll_p as _rp
from .fastpath import _classic_lowstorage_rows, reghost, strip_ghosts
from .fdm import fdm_transform_roundoff, laplacian_box, om_box, psolver_fdm

__all__ = [
    "channelpath_applicable",
    "strip_channel",
    "reghost_channel",
    "ChannelMetrics",
    "make_channel_metrics",
    "channel_convdiff_roll",
    "channel_divergence_roll",
    "channel_correct_roll",
    "channel_laplacian_box",
    "make_channel_timestep",
    "ChannelHat",
    "make_channel_timestep_hat",
]


# --------------------------------------------------------------------------
# Applicability + layout
# --------------------------------------------------------------------------


def channelpath_applicable(setup, method=None):
    """Channel topology: 3-D, x/y periodic uniform, z Dirichlet walls with
    static wall velocities whose normal component is zero, no closure, no
    temperature, steady (or no) body force; with `method`, an explicit RK
    tableau with classic rows (or one stage).  An unsteady (callable) body
    force steps the general ghosted path: the channel kernels' force
    stream is steady (the JAX package's gate lets it through and then
    ignores the force)."""
    g = setup.grid
    if g.dim != 3 or setup.closure_model is not None or setup.temperature is not None:
        return False
    if setup.unsteady_bodyforce is not None:
        return False
    for d in (0, 1):
        if not (g.periodic[d] and g.uniform[d]):
            return False
    if g.periodic[2]:
        return False
    bcl, bcr = setup.boundary_conditions[2]
    gb = _const_wall_values(bcl, 3)
    gt = _const_wall_values(bcr, 3)
    if gb is None or gt is None or gb[2] != 0.0 or gt[2] != 0.0:
        return False
    if method is not None:
        if not isinstance(method, ExplicitRungeKuttaMethod):
            return False
        if method.nstage != 1 and not _classic_lowstorage_rows(method):
            return False
    return True


def strip_channel(u):
    """Ghosted -> interior channel layout: a plain 1-ghost strip.  The
    stripped w keeps the top-wall face (ghosted z slot nz) in its last
    slot: the pinned 0."""
    return strip_ghosts(u)


def reghost_channel(u_int, setup):
    """Interior channel layout -> ghosted, BC-filled field: periodic wraps
    in x/y, the static wall velocities as the z ghosts (w's walls 0)."""
    bcl, bcr = setup.boundary_conditions[2]
    gb = _const_wall_values(bcl, 3)
    gt = _const_wall_values(bcr, 3)
    u = reghost(u_int)
    for a in range(3):
        u[a, ..., 0] = 0.0 if a == 2 else gb[a]
        u[a, ..., -1] = 0.0 if a == 2 else gt[a]
    return u


# --------------------------------------------------------------------------
# Static metric vectors
# --------------------------------------------------------------------------


class ChannelMetrics(NamedTuple):
    """Interior-slot z-metric vectors, tensors in the setup's dtype on its
    device (`ins_tpu/ops/channelpath.py` `ChannelMetrics`).

    Tangential components (u, v; all nz slots are DOFs): ``inv_dz`` (1/cell
    width), ``inv_da_t`` / ``inv_db_t`` (eps-guarded 1/centre distance
    below / above).  Normal component (w; slots 0..nz-2, every vector 0 at
    slot nz-1): ``inv_duz`` (1/face distance), ``inv_da_n`` / ``inv_db_n``
    (eps-guarded 1/cell width below / above), ``az1``, ``az2`` (weights
    interpolating u/v along z to the face), ``azz_m1``, ``azz_m2``,
    ``azz_c1``, ``azz_c2`` (the w-on-w convection weights).  Shared:
    ``om_z`` (z factor of the cell volume), ``dx``, ``dy`` (uniform
    transverse spacings), ``gb``, ``gt`` (wall velocities) and ``zmet``,
    the 12 vectors packed ``(12, nz)`` for the kernels (`pack_zmet`)."""

    inv_dz: Any
    inv_da_t: Any
    inv_db_t: Any
    inv_duz: Any
    inv_da_n: Any
    inv_db_n: Any
    az1: Any
    az2: Any
    azz_m1: Any
    azz_m2: Any
    azz_c1: Any
    azz_c2: Any
    om_z: Any
    dx: float
    dy: float
    gb: tuple
    gt: tuple
    zmet: Any


def make_channel_metrics(setup):
    """Precompute the z-metric vectors by segmenting the ghosted grid
    arrays as the ghosted operators do (float64 on the host, then cast to
    the setup's dtype)."""
    from .channel_kernels import pack_zmet

    g = setup.grid
    nz = g.Np[2]
    grid_dtype = _numpy_dtype(setup.dtype)
    eps2 = 2 * float(np.finfo(grid_dtype).eps)

    delta = np.asarray(g.delta[2], np.float64)
    delta_u = np.asarray(g.delta_u[2], np.float64)

    def guard_inv(v):
        return np.where(v > eps2, 1.0 / np.maximum(v, eps2), 0.0)

    def pad0(v):
        """Pad an (nz-1,)-slot w-vector with 0 at the pinned slot."""
        return np.concatenate([v, [0.0]])

    vecs = {}
    # tangential (box z ghosted 1..nz+1 -> slots 0..nz-1)
    vecs["inv_dz"] = 1.0 / delta[1 : nz + 1]
    vecs["inv_da_t"] = guard_inv(delta_u[0:nz])
    vecs["inv_db_t"] = guard_inv(delta_u[1 : nz + 1])
    # normal (box z ghosted 1..nz -> slots 0..nz-2)
    vecs["inv_duz"] = pad0(1.0 / delta_u[1:nz])
    vecs["inv_da_n"] = pad0(guard_inv(delta[1:nz]))
    vecs["inv_db_n"] = pad0(guard_inv(delta[2 : nz + 1]))

    A1_t, A2_t = (np.asarray(v, np.float64) for v in g.A[0][2])
    A1b, A2b = (np.asarray(v, np.float64) for v in g.A[1][2])
    assert np.allclose(A1_t, A1b) and np.allclose(A2_t, A2b)
    vecs["az1"] = pad0(A1_t[2 : nz + 1])
    vecs["az2"] = pad0(A2_t[1:nz])
    A1n, A2n = (np.asarray(v, np.float64) for v in g.A[2][2])
    vecs["azz_m1"] = pad0(A1n[1:nz])
    vecs["azz_m2"] = pad0(A2n[0 : nz - 1])
    vecs["azz_c1"] = pad0(A1n[2 : nz + 1])
    vecs["azz_c2"] = pad0(A2n[1:nz])
    vecs["om_z"] = delta[1 : nz + 1]

    # on periodic-uniform x/y axes every A-weight segment the stencil reads
    # is 1/2 (within the coordinates' roundoff; the kernels use 0.5)
    dx = float(np.asarray(g.delta[0])[1])
    dy = float(np.asarray(g.delta[1])[1])
    eps = float(np.finfo(np.asarray(g.x[0]).dtype).eps)
    tol = max(1e-12, 64 * eps * max(g.N))
    for a in (0, 1):
        for b in range(3):
            A1, A2 = (np.asarray(v, np.float64) for v in g.A[b][a])
            assert np.allclose(A1[1:-1], 0.5, atol=tol), (a, b)
            assert np.allclose(A2[1:-1], 0.5, atol=tol), (a, b)

    bcl, bcr = setup.boundary_conditions[2]
    tens = {k: torch.as_tensor(v, dtype=setup.dtype, device=setup.device)
            for k, v in vecs.items()}
    met = ChannelMetrics(
        **tens, dx=dx, dy=dy,
        gb=_const_wall_values(bcl, 3), gt=_const_wall_values(bcr, 3), zmet=None,
    )
    return met._replace(zmet=pack_zmet(met))


# --------------------------------------------------------------------------
# Roll functions (ground truth of the kernels; the CPU twin)
# --------------------------------------------------------------------------


def _zvec(v, dtype):
    return v.to(dtype).reshape(1, 1, -1)


def _masked_zshift(v, hi_ghost, lo_ghost):
    """(v[z+1] with the top ghost, v[z-1] with the bottom ghost) of a
    cell-centred (tangential) component."""
    vp = _rp(v, 2).clone()
    vp[..., -1] = hi_ghost
    vm = _rm(v, 2).clone()
    vm[..., 0] = lo_ghost
    return vp, vm


def channel_convdiff_roll(u, met, visc):
    """Convection + diffusion on the interior channel layout; returns F of
    u's shape (w's pinned slot gets F = 0)."""
    dtype = u.dtype
    dx, dy = met.dx, met.dy

    def zv(name):
        return _zvec(getattr(met, name), dtype)

    u2 = u[2]
    F = []
    # ---- tangential components a = 0, 1 --------------------------------
    for a in (0, 1):
        ua = u[a]
        t = 1 - a  # the other tangential axis
        f = torch.zeros_like(ua)
        # b = a (own axis, uniform): convection + diffusion
        ua_p = _rp(ua, a)
        ua_m = _rm(ua, a)
        phi2 = (0.5 * (ua + ua_p)) ** 2
        phi1 = (0.5 * (ua_m + ua)) ** 2
        da = dx if a == 0 else dy
        f = f - (phi2 - phi1) / da
        f = f + visc * (ua_p - 2.0 * ua + ua_m) / (da * da)
        # b = t (the other tangential axis, uniform)
        ua_pt = _rp(ua, t)
        ua_mt = _rm(ua, t)
        ub = u[t]
        uab2 = 0.5 * (ua + ua_pt)
        uba2 = 0.5 * (ub + _rp(ub, a))
        phi2 = uab2 * uba2
        phi1 = _rm(phi2, t)
        db = dy if a == 0 else dx
        f = f - (phi2 - phi1) / db
        f = f + visc * (ua_pt - 2.0 * ua + ua_mt) / (db * db)
        # b = 2 (wall-normal, stretched)
        ua_zp, ua_zm = _masked_zshift(ua, met.gt[a], met.gb[a])
        uab2 = 0.5 * (ua + ua_zp)
        uba2 = 0.5 * (u2 + _rp(u2, a))  # w interpolated to the a-face
        phi2 = uab2 * uba2
        # the wrap of phi2 is the exact bottom-wall flux: slot nz-1 has
        # uba2 = 0 (pinned w), so phi2[nz-1] = 0
        phi1 = _rm(phi2, 2)
        f = f - (phi2 - phi1) * zv("inv_dz")
        d_hi = (ua_zp - ua) * zv("inv_db_t")
        d_lo = (ua - ua_zm) * zv("inv_da_t")
        f = f + visc * (d_hi - d_lo) * zv("inv_dz")
        F.append(f)

    # ---- normal component a = 2 ---------------------------------------
    w = u2
    f = torch.zeros_like(w)
    for b in (0, 1):
        ub = u[b]
        w_pb = _rp(w, b)
        w_mb = _rm(w, b)
        uab2 = 0.5 * (w + w_pb)
        uba2 = zv("az2") * ub + zv("az1") * _rp(ub, 2)  # u_b along z to the face
        phi2 = uab2 * uba2
        phi1 = _rm(phi2, b)
        db = dx if b == 0 else dy
        f = f - (phi2 - phi1) / db
        f = f + visc * (w_pb - 2.0 * w + w_mb) / (db * db)
    # b = 2 (own axis): every z-roll of w wraps the pinned slot as the 0 wall
    w_zp = _rp(w, 2)
    w_zm = _rm(w, 2)
    uab2 = 0.5 * (w + w_zp)
    uab1 = 0.5 * (w_zm + w)
    uba2 = zv("azz_c2") * w + zv("azz_c1") * w_zp
    uba1 = zv("azz_m2") * w_zm + zv("azz_m1") * w
    f = f - (uab2 * uba2 - uab1 * uba1) * zv("inv_duz")
    d_hi = (w_zp - w) * zv("inv_db_n")
    d_lo = (w - w_zm) * zv("inv_da_n")
    f = f + visc * (d_hi - d_lo) * zv("inv_duz")
    # the diffusion of the pinned-zero plane does not vanish by itself
    f = f.clone()
    f[..., -1] = 0.0
    F.append(f)
    return torch.stack(F)


def channel_divergence_roll(u, met):
    """Divergence at the pressure points of the interior layout (w's z-roll
    wraps the pinned slot as the bottom-wall 0)."""
    return (
        (u[0] - _rm(u[0], 0)) / met.dx
        + (u[1] - _rm(u[1], 1)) / met.dy
        + (u[2] - _rm(u[2], 2)) * _zvec(met.inv_dz, u.dtype)
    )


def channel_correct_roll(u, q, met):
    """``u - grad(q)/Delta_u``; the w divisor is 0 at the pinned slot,
    which keeps it exactly 0."""
    u0 = u[0] - (_rp(q, 0) - q) / met.dx
    u1 = u[1] - (_rp(q, 1) - q) / met.dy
    u2 = u[2] - (_rp(q, 2) - q) * _zvec(met.inv_duz, u.dtype)
    return torch.stack([u0, u1, u2])


def channel_laplacian_box(q, setup):
    """Volume-scaled pressure Laplacian on the interior box (the BC-aware
    `lap_c` rows; `ops/fdm.laplacian_box`)."""
    return laplacian_box(setup)(q)


# --------------------------------------------------------------------------
# Step drivers
# --------------------------------------------------------------------------


def _interior_force(setup):
    """The steady body force on the interior layout, or None."""
    if setup.bodyforce_field is not None:
        return strip_channel(setup.bodyforce_field)
    return None


class _ChannelCtx(NamedTuple):
    met: Any
    visc: float
    psolve: Any
    force: Any
    A: Any
    ns: int


def _channel_ctx(setup, method, nrefine):
    """Shared preamble of the channel step builders: metrics, the FDM
    projection solve, the steady force, the tableau."""
    if not channelpath_applicable(setup, method):
        raise NotImplementedError(
            "the channel path needs a channel setup (x/y periodic uniform, "
            "static z walls) and an explicit classic-row RK tableau"
        )
    met = make_channel_metrics(setup)
    visc = 1.0 / setup.Re
    if nrefine is None:
        # Unlike `psolver_fdm`'s default (one sweep in float32, which a
        # one-off initial projection affords), the chain projects every
        # stage and needs CG-tolerance accuracy only: it refines only where
        # the working-dtype transforms are too ill-conditioned to give it.
        nrefine = 1 if fdm_transform_roundoff(setup) > 1e-4 else 0
    solve = psolver_fdm(setup, nrefine=nrefine)
    om = om_box(setup)

    def psolve(div):
        """Projection potential q from the interior divergence."""
        return solve(om * div)

    return _ChannelCtx(met=met, visc=visc, psolve=psolve, force=_interior_force(setup),
                       A=method.A, ns=method.nstage)


def _kernels(plain):
    from . import channel_kernels as ck

    if plain:
        return ck.channel_msd_3d_plain, ck.channel_pressure_correct_3d_plain
    return ck.channel_msd_3d, ck.channel_pressure_correct_3d


def make_channel_timestep(setup, method, *, nrefine=None):
    """``step(state, dt, theta=None) -> state`` on the interior channel
    layout, classic-row explicit RK, projecting every stage:
    `channel_msd_3d` and `channel_pressure_correct_3d` each stage (their
    plain versions, the roll functions, on CPU tensors).  ``nrefine``:
    refinement sweeps of the FDM projection (default: 0 unless the
    working-dtype transforms are ill-conditioned)."""
    met, visc, psolve, force, A, ns = _channel_ctx(setup, method, nrefine)
    msd, correct = _kernels(plain=False)

    def step(state, dt, theta=None):
        ustart = u = state.u
        acc = None  # the accumulator starts at ustart
        for i in range(ns):
            last = i == ns - 1
            us, acc, div = msd(
                u, ustart, acc, met, visc=visc, ca=0.0 if last else float(A[i][i]),
                cb=float(A[ns - 1][i]), dt=dt, force=force, div_of_acc=last,
            )
            u = correct(acc if last else us, psolve(div), met)
        return state._replace(u=u, t=state.t + dt, n=state.n + 1)

    return step


class ChannelHat(NamedTuple):
    """Carry of the merged-projection channel chain: the stepper `state`
    with ``u`` holding the UNPROJECTED final-stage target, and the
    projection potential ``q``.  The corrected velocity
    ``u - grad(q)/Delta_u`` is materialised only at chunk ends
    (`from_hat`); inside a chunk each stage kernel rebuilds it
    (`channel_msd_3d(qrecon=...)`).  ``t`` and ``n`` read the state's."""

    state: Any
    q: Any

    @property
    def t(self):
        return self.state.t

    @property
    def n(self):
        return self.state.n


def make_channel_timestep_hat(setup, method, *, nrefine=None, plain=False):
    """``(to_hat, step_hat, from_hat)`` of the merged-projection channel
    chain over a `ChannelHat` carry: ``step_hat(h, dt)``.  ``plain=True``
    builds it from the kernels' plain versions (the reference chain on
    the card)."""
    met, visc, psolve, force, A, ns = _channel_ctx(setup, method, nrefine)
    msd, correct = _kernels(plain)
    g = setup.grid

    def to_hat(s):
        # q = 0 is an exact identity: u - grad(0) = u
        return ChannelHat(state=s, q=torch.zeros(tuple(g.Np), dtype=setup.dtype,
                                                 device=setup.device))

    def from_hat(h):
        return h.state._replace(u=correct(h.state.u, h.q, met))

    def step_hat(h, dt):
        s = h.state
        t_prev, q_prev = s.u, h.q
        ustart = acc = None
        for i in range(ns):
            last = i == ns - 1
            b = float(A[ns - 1][i])
            if i == 0 and ns > 1:
                ustart, us, acc, div = msd(
                    t_prev, None, None, met, visc=visc, ca=float(A[0][0]), cb=b, dt=dt,
                    force=force, qrecon=q_prev, emit_urec=True,
                )
                target = us
            else:
                us, acc, div = msd(
                    t_prev, ustart, acc, met, visc=visc,
                    ca=0.0 if last else float(A[i][i]), cb=b, dt=dt, force=force,
                    div_of_acc=last, qrecon=q_prev,
                )
                target = acc if last else us
            q_prev = psolve(div)
            t_prev = target
        return ChannelHat(state=s._replace(u=t_prev, t=s.t + dt, n=s.n + 1), q=q_prev)

    return to_hat, step_hat, from_hat
