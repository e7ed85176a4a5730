"""Carry solver state between the JAX package and the port.

Both sides use the same layouts (component-first velocity, eigen-basis
``qhat``, the interior channel layout), so a state crosses as numpy
arrays: `state_from_numpy` takes anything with the fields of `ins_tpu`'s
`StepperState` (u, temp, t, n), `ABCNState` (with c_prev, p),
`OneLegState` (with u_prev, p, p_prev), `HatState` (ut, qhat, temp, t,
n) or the channel path's `ChannelHat` (state, q) — JAX arrays convert
through ``numpy.asarray`` — and returns the port's on `device` (the card
by default); `state_to_numpy` returns the field dict from which the
caller rebuilds the JAX NamedTuple
(``ins_tpu.time_steppers.step.StepperState(**d)``,
``ins_tpu.time_steppers.imex.ABCNState(**d)``; for a `ChannelHat`,
``ChannelHat(state=StepperState(**d["state"]), q=d["q"])``).  This
module never imports JAX.  `check_setup_constants`
holds the port's setup-time constants — the fused projection's
eigen-matrices and grid spacings, the channel's z-metric vectors, the
steady body force, Re and the temperature coefficients — equal to the
JAX package's.
`cnn_params_from_numpy` / `cnn_params_to_numpy` carry a CNN closure's
parameters (flax's ``params`` dict, e.g. the ``theta`` of
`ins_tpu.models.cnn`) to the port's ``theta`` and back; both use
canonical ``(k, k, k, cin, cout)`` kernels, so the two packages then
compute the same closure.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.channel_kernels import _ZVECS
from .ops.channelpath import ChannelHat, make_channel_metrics
from .ops.fastpath import HatState
from .ops.poisson_kernels import make_fused_projection
from .ops.pressure import uniform_dxs
from .setup import resolve_device
from .time_steppers.imex import ABCNState, OneLegState
from .time_steppers.step import StepperState

__all__ = [
    "state_from_numpy",
    "state_to_numpy",
    "check_setup_constants",
    "cnn_params_from_numpy",
    "cnn_params_to_numpy",
]

# the channel metric vectors `check_setup_constants` compares
_CHANNEL_VECS = (*_ZVECS, "om_z")
# the scalar constants: Re and the temperature equation's coefficients
_TEMP_SCALARS = ("alpha1", "alpha2", "alpha3", "alpha4", "gamma")
_KNOWN_CONSTS = ("dxs", "V", "Vinv", "VT", "VinvT", *_CHANNEL_VECS, "bodyforce_field", "Re",
                 *_TEMP_SCALARS, "gdir")


def _tensor(a, dtype, device):
    if a is None:
        return None
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def state_from_numpy(state, *, dtype=torch.float32, device="cuda"):
    """A JAX `StepperState`/`HatState`/`ChannelHat` (or any object with its
    fields) as the port's state on `device`."""
    device = resolve_device(device)
    fields = state._asdict() if hasattr(state, "_asdict") else dict(state)
    if "q" in fields:
        return ChannelHat(
            state=state_from_numpy(fields["state"], dtype=dtype, device=device),
            q=_tensor(fields["q"], dtype, device),
        )
    t = float(np.asarray(fields["t"]))
    n = int(np.asarray(fields["n"]))
    temp = _tensor(fields.get("temp"), dtype, device)
    if "qhat" in fields:
        return HatState(
            ut=_tensor(fields["ut"], dtype, device),
            qhat=_tensor(fields["qhat"], dtype, device),
            temp=temp, t=t, n=n,
        )
    u = _tensor(fields["u"], dtype, device)
    if "c_prev" in fields:
        return ABCNState(u=u, temp=temp, t=t, n=n, c_prev=_tensor(fields["c_prev"], dtype, device),
                         p=_tensor(fields["p"], dtype, device))
    if "u_prev" in fields:
        return OneLegState(u=u, temp=temp, t=t, n=n, **{
            k: _tensor(fields[k], dtype, device) for k in ("u_prev", "p", "p_prev")})
    return StepperState(u=u, temp=temp, t=t, n=n)


def _arr(x):
    return None if x is None else x.detach().cpu().numpy()


def state_to_numpy(state):
    """The port's state as a dict of numpy fields named as in the JAX
    NamedTuple (a `StepperState`, `ABCNState` or `OneLegState` field by
    field).  A `HatState` whose ``qhat`` is None (u materialised)
    gets ``qhat = 0``, the JAX package's identity carry."""
    if isinstance(state, ChannelHat):
        return dict(state=state_to_numpy(state.state), q=_arr(state.q))
    if isinstance(state, HatState):
        ut = _arr(state.ut)
        qhat = _arr(state.qhat)
        if qhat is None:
            qhat = np.zeros(ut.shape[1:], ut.dtype)
        return dict(ut=ut, qhat=qhat, temp=_arr(state.temp), t=state.t, n=state.n)
    return {k: v if k in ("t", "n") else _arr(v) for k, v in state._asdict().items()}


def _rel_diff(name, mine, theirs):
    theirs = np.asarray(theirs, dtype=np.float64)
    mine = np.asarray(mine, dtype=np.float64)
    if mine.shape != theirs.shape:
        raise ValueError(f"{name}: shape {mine.shape} != {theirs.shape}")
    scale = max(float(np.max(np.abs(theirs))), 1e-300)
    return float(np.max(np.abs(mine - theirs))) / scale


def check_setup_constants(setup, jax_consts, *, rtol=None):
    """Compare the port's setup-time constants with the JAX package's,
    built in the setup's dtype.  ``jax_consts`` maps any of: "V", "Vinv",
    "VT", "VinvT" (numpy, e.g. from
    `ins_tpu.ops.poisson_pallas.make_fused_projection`) and "dxs"
    (sequence) for a periodic setup; the channel metric vectors by name
    (`ins_tpu.ops.channelpath.make_channel_metrics`) for a channel setup;
    "bodyforce_field" (`ins_tpu` setup's field); "Re", and "alpha1" to
    "alpha4", "gamma" and "gdir" of the temperature equation (`gdir` must
    be equal).  Returns the largest relative difference; raises
    ValueError above ``rtol`` (default 1e-12 in float64, 1e-6 in float32),
    and on a key it does not know or a mapping with no key at all."""
    unknown = sorted(set(jax_consts) - set(_KNOWN_CONSTS))
    if unknown or not jax_consts:
        raise ValueError(f"unknown setup constants {unknown}; known: {_KNOWN_CONSTS}")
    if rtol is None:
        rtol = 1e-12 if setup.dtype == torch.float64 else 1e-6
    worst = 0.0
    if "dxs" in jax_consts:
        dxs = uniform_dxs(setup)
        theirs = np.asarray(jax_consts["dxs"], float)
        worst = max(worst, float(np.max(np.abs(np.asarray(dxs) - theirs) / np.abs(np.asarray(dxs)))))
    keys = [k for k in ("V", "Vinv", "VT", "VinvT") if k in jax_consts]
    if keys:
        proj = make_fused_projection(setup.grid.Np, uniform_dxs(setup), setup.dtype, device="cpu")
        for key in keys:
            worst = max(worst, _rel_diff(key, proj[key].double().numpy(), jax_consts[key]))
    vecs = [k for k in _CHANNEL_VECS if k in jax_consts]
    if vecs:
        met = make_channel_metrics(setup)
        for key in vecs:
            worst = max(worst, _rel_diff(key, _arr(getattr(met, key)), jax_consts[key]))
    if "bodyforce_field" in jax_consts:
        worst = max(worst, _rel_diff("bodyforce_field", _arr(setup.bodyforce_field),
                                     jax_consts["bodyforce_field"]))
    scalars = {"Re": setup.Re}
    tq = setup.temperature
    if tq is not None:
        scalars.update({k: getattr(tq, k) for k in _TEMP_SCALARS})
        if "gdir" in jax_consts and int(jax_consts["gdir"]) != tq.gdir:
            raise ValueError(f"gdir {tq.gdir} != the JAX package's {int(jax_consts['gdir'])}")
    elif any(k in jax_consts for k in (*_TEMP_SCALARS, "gdir")):
        raise ValueError("temperature constants given for a setup without a temperature equation")
    for key in [k for k in scalars if k in jax_consts]:
        worst = max(worst, _rel_diff(key, np.asarray(scalars[key]), np.asarray(jax_consts[key])))
    if worst > rtol:
        raise ValueError(f"setup constants differ from the JAX package's by {worst:g}")
    return worst


def cnn_params_from_numpy(theta, *, device="cuda"):
    """A flax CNN ``params`` mapping (``conv{i}_kernel``, ``conv{i}_bias``
    -> arrays) as the port's ``theta``: a dict of leaf tensors on
    `device`, in the arrays' dtypes, that require grad."""
    device = resolve_device(device)
    return {
        name: torch.as_tensor(np.array(a), device=device).requires_grad_(True)
        for name, a in dict(theta).items()
    }


def cnn_params_to_numpy(theta):
    """The port's ``theta`` as a dict of numpy arrays (flax's layout)."""
    return {name: t.detach().cpu().numpy() for name, t in theta.items()}
