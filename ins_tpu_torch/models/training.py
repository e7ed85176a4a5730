"""Closure-model training: dataloaders, losses, metrics, train loop.

Port of the a-posteriori part of `ins_tpu/models/training.py` (and its
two a-priori losses) on `torch.autograd` and `torch.optim`.  The
a-posteriori loss backpropagates through the unrolled solver: each step
is `make_fast_timestep(..., differentiable=True)`, the per-op chain with
custom-VJP kernels (`ops/diffkernels.py`) and the CNN's kernel layers;
``remat=True`` checkpoints each step (`torch.utils.checkpoint`,
non-reentrant), so the backward pass recomputes one step's forward at a
time instead of keeping every stage's activations.  Random draws come
from a numpy `Generator` in place of `jax.random` keys.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops.fastpath import fastpath_applicable, make_fast_timestep, strip_ghosts
from ..time_steppers.step import StepperState

__all__ = [
    "create_dataloader_post",
    "create_trainstate",
    "train",
    "create_loss_prior",
    "create_relerr_prior",
    "create_loss_post",
    "create_relerr_post",
]


def create_dataloader_post(trajectories, *, ntrajectory, nunroll):
    """Trajectory dataloader for a-posteriori training.  Each batch is a
    list of dicts (u, t) with ``u`` of shape ``(nunroll + 1, D, *N)``.
    Returns ``dataloader(rng) -> (batch, rng)`` for a numpy Generator."""

    def dataloader(rng):
        order = rng.permutation(len(trajectories))[:ntrajectory]
        hi = max(1, min(len(trajectories[i]["t"]) for i in order) - nunroll)
        starts = rng.integers(0, hi, size=len(order))
        batch = []
        for j, i in enumerate(order):
            traj = trajectories[i]
            nt = len(traj["t"])
            if nt <= nunroll:
                raise ValueError(f"trajectory too short for nunroll={nunroll}")
            s = int(starts[j]) % (nt - nunroll)
            batch.append(dict(u=traj["u"][s : s + nunroll + 1],
                              t=traj["t"][s : s + nunroll + 1]))
        return batch, rng

    return dataloader


def create_trainstate(theta, *, opt=None, lr=1e-3, rng=None):
    """Bundle (optimizer, theta, rng) for `train`: Adam with the
    learning rate ``lr`` (optax.adam's defaults) unless ``opt`` is given,
    over the leaf tensors of the dict ``theta``."""
    if opt is None:
        opt = torch.optim.Adam(list(theta.values()), lr=lr)
    if rng is None:
        rng = np.random.default_rng(0)
    return dict(opt=opt, theta=theta, rng=rng)


def train(*, dataloader, loss, trainstate, niter, callback=None, callbackstate=None,
          lam=None):
    """Gradient loop: grad of ``loss(batch, theta)``, optional weight
    decay ``lam`` added to the gradients, an optimizer step.  The
    trainstate gains ``loss``, the last loss value (a tensor)."""
    opt, theta = trainstate["opt"], trainstate["theta"]
    for _ in range(niter):
        batch, rng = dataloader(trainstate["rng"])
        opt.zero_grad(set_to_none=True)
        value = loss(batch, theta)
        value.backward()
        if lam is not None:
            with torch.no_grad():
                for p in theta.values():
                    p.grad.add_(p, alpha=lam)
        opt.step()
        trainstate = dict(trainstate, rng=rng, loss=value.detach())
        if callback is not None:
            callbackstate = callback(callbackstate, trainstate)
    return dict(trainstate=trainstate, callbackstate=callbackstate)


def create_loss_prior(f):
    """Relative MSE a-priori loss."""

    def loss_prior(batch, theta):
        x, y = batch
        return torch.sum((f(x, theta) - y) ** 2) / torch.sum(y**2)

    return loss_prior


def create_relerr_prior(f, x, y):
    """A-priori relative error."""

    def relerr(theta):
        with torch.no_grad():
            return torch.linalg.vector_norm(f(x, theta) - y) / torch.linalg.vector_norm(y)

    return relerr


def _unrolled_errors(u, t, theta, *, setup, method, psolver, nsubstep, sqrt_each,
                     remat=False, plain=False):
    """Step the LES solver with its closure from u[0] along the stored
    time stamps and average the relative errors of the interior field.
    ``remat=True`` checkpoints each solver step."""
    if not fastpath_applicable(setup, method, psolver):
        raise NotImplementedError(
            "a-posteriori training runs on the periodic fast path only (explicit "
            "RK, spectral solver, uniform periodic grid); training off it is "
            "ROADMAP queue 1 item 9"
        )
    ts = [float(v) for v in (t.tolist() if torch.is_tensor(t) else np.asarray(t))]
    step = make_fast_timestep(setup, method, differentiable=True, plain=plain)
    if remat:
        def one_step(state, dt, theta):
            return checkpoint(step, state, dt, theta, use_reentrant=False)
    else:
        one_step = step
    state = StepperState(u=strip_ghosts(u[0]), temp=None, t=ts[0], n=0)
    total = 0.0
    for it in range(1, len(ts)):
        dt = (ts[it] - ts[it - 1]) / nsubstep
        for _ in range(nsubstep):
            state = one_step(state, dt, theta)
        ref = strip_ghosts(u[it])
        err = torch.sum((state.u - ref) ** 2) / torch.sum(ref**2)
        total = total + (torch.sqrt(err) if sqrt_each else err)
    return total / (len(ts) - 1)


def _with_closure(setup, closure_model):
    return dataclasses.replace(setup, closure_model=closure_model)


def create_loss_post(*, setup, method, psolver, closure_model, nsubstep=1, remat=False,
                     plain=False):
    """A-posteriori loss: the relative trajectory error of the unrolled
    solver with ``closure_model``.  ``loss(data, theta)`` takes a list of
    dicts (u: ``(nt, D, *N)`` ghosted fields, t: ``(nt,)`` times).
    ``remat=True`` checkpoints each step (long unrolls); ``plain=True``
    runs the per-op kernels' plain versions on any device."""
    setup_c = _with_closure(setup, closure_model)

    def loss_post(data, theta):
        total = 0.0
        for traj in data:
            total = total + _unrolled_errors(
                traj["u"], traj["t"], theta, setup=setup_c, method=method,
                psolver=psolver, nsubstep=nsubstep, sqrt_each=False, remat=remat,
                plain=plain,
            )
        return total / len(data)

    return loss_post


def create_relerr_post(*, data, setup, method, psolver, closure_model, nsubstep=1):
    """A-posteriori relative error of one trajectory (no gradient)."""
    setup_c = _with_closure(setup, closure_model)

    def relerr_post(theta):
        with torch.no_grad():
            return _unrolled_errors(
                data["u"], data["t"], theta, setup=setup_c, method=method,
                psolver=psolver, nsubstep=nsubstep, sqrt_each=True,
            )

    return relerr_post
