"""Carry solver state between the JAX package and the port.

Both sides use the same layouts (component-first velocity, eigen-basis
``qhat``), so a state crosses as numpy arrays: `state_from_numpy` takes
anything with the fields of `ins_tpu`'s `StepperState` (u, temp, t, n)
or `HatState` (ut, qhat, temp, t, n) — JAX arrays convert through
``numpy.asarray`` — and returns the port's; `state_to_numpy` returns the
field dict from which the caller rebuilds the JAX NamedTuple
(``ins_tpu.time_steppers.step.StepperState(**d)``).  This module never
imports JAX.  `check_setup_constants` holds the port's fused-projection
constants (the V/Vinv eigen-matrices and the grid spacings) equal to the
JAX package's.  `cnn_params_from_numpy` / `cnn_params_to_numpy` carry a
CNN closure's parameters (flax's ``params`` dict, e.g. the ``theta`` of
`ins_tpu.models.cnn`) to the port's ``theta`` and back; both use
canonical ``(k, k, k, cin, cout)`` kernels, so the two packages then
compute the same closure.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.fastpath import HatState
from .ops.poisson_kernels import make_fused_projection
from .ops.pressure import uniform_dxs
from .time_steppers.step import StepperState

__all__ = [
    "state_from_numpy",
    "state_to_numpy",
    "check_setup_constants",
    "cnn_params_from_numpy",
    "cnn_params_to_numpy",
]


def _tensor(a, dtype, device):
    if a is None:
        return None
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def state_from_numpy(state, *, dtype=torch.float32, device="cpu"):
    """A JAX `StepperState`/`HatState` (or any object with its fields)
    as the port's state on `device`."""
    fields = state._asdict() if hasattr(state, "_asdict") else dict(state)
    t = float(np.asarray(fields["t"]))
    n = int(np.asarray(fields["n"]))
    if "qhat" in fields:
        return HatState(
            ut=_tensor(fields["ut"], dtype, device),
            qhat=_tensor(fields["qhat"], dtype, device),
            temp=None, t=t, n=n,
        )
    if fields.get("temp") is not None:
        raise NotImplementedError("temperature is not ported yet (ROADMAP queue 1 item 6)")
    return StepperState(u=_tensor(fields["u"], dtype, device), temp=None, t=t, n=n)


def state_to_numpy(state):
    """The port's state as a dict of numpy fields named as in the JAX
    NamedTuple.  A `HatState` whose ``qhat`` is None (u materialised)
    gets ``qhat = 0``, the JAX package's identity carry."""
    def arr(x):
        return None if x is None else x.detach().cpu().numpy()

    if isinstance(state, HatState):
        ut = arr(state.ut)
        qhat = arr(state.qhat)
        if qhat is None:
            qhat = np.zeros(ut.shape[1:], ut.dtype)
        return dict(ut=ut, qhat=qhat, temp=None, t=state.t, n=state.n)
    return dict(u=arr(state.u), temp=None, t=state.t, n=state.n)


def check_setup_constants(setup, jax_consts, *, rtol=None):
    """Compare the port's projection constants for `setup` with the JAX
    package's: ``jax_consts`` maps "V", "Vinv", "VT", "VinvT" (numpy,
    e.g. from `ins_tpu.ops.poisson_pallas.make_fused_projection`) and
    "dxs" (sequence), built in the setup's dtype.  Returns the largest
    relative difference; raises ValueError above ``rtol`` (default 1e-12
    in float64, 1e-6 in float32)."""
    if rtol is None:
        rtol = 1e-12 if setup.dtype == torch.float64 else 1e-6
    dxs = uniform_dxs(setup)
    proj = make_fused_projection(setup.grid.Np, dxs, setup.dtype)
    worst = float(np.max(np.abs(np.asarray(dxs) - np.asarray(jax_consts["dxs"], float))
                         / np.abs(np.asarray(dxs))))
    for key in ("V", "Vinv", "VT", "VinvT"):
        mine = proj[key].double().numpy()
        theirs = np.asarray(jax_consts[key], dtype=np.float64)
        if mine.shape != theirs.shape:
            raise ValueError(f"{key}: shape {mine.shape} != {theirs.shape}")
        scale = max(float(np.max(np.abs(theirs))), 1e-300)
        worst = max(worst, float(np.max(np.abs(mine - theirs))) / scale)
    if worst > rtol:
        raise ValueError(f"projection constants differ from the JAX package's by {worst:g}")
    return worst


def cnn_params_from_numpy(theta, *, device="cpu"):
    """A flax CNN ``params`` mapping (``conv{i}_kernel``, ``conv{i}_bias``
    -> arrays) as the port's ``theta``: a dict of leaf tensors on
    `device`, in the arrays' dtypes, that require grad."""
    return {
        name: torch.as_tensor(np.array(a), device=device).requires_grad_(True)
        for name, a in dict(theta).items()
    }


def cnn_params_to_numpy(theta):
    """The port's ``theta`` as a dict of numpy arrays (flax's layout)."""
    return {name: t.detach().cpu().numpy() for name, t in theta.items()}
