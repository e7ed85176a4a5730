"""Closure-model training: dataloaders, losses, metrics, train loops.

Port of `ins_tpu/models/training.py` on `torch.autograd` and
`torch.optim`.  The a-posteriori loss backpropagates through the
unrolled solver.  On the periodic fast path each step is
`make_fast_timestep(..., differentiable=True)`, the per-op chain with
custom-VJP kernels (`ops/diffkernels.py`) and the CNN's kernel layers;
anywhere else it is the general path's `timestep` on the ghosted layout
(ghost fills, the staggered operators, `ops.pressure.project`), whose
Poisson solve is its own adjoint (`ops.pressure.poisson`, the JAX
package's custom VJP), so no solver's iterations are taped: the CG's
`device_while` and `psolver_direct`'s host solve run in the solve's
forward, and the backward pass solves once more.  ``remat=True``
checkpoints each step (`torch.utils.checkpoint`, non-reentrant), so the
backward pass recomputes one step's forward at a time instead of keeping
every stage's activations.  Random draws come from a numpy `Generator`
in place of `jax.random` keys; batches go where the parameters are.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops.fastpath import fastpath_applicable, make_fast_timestep, strip_ghosts
from ..setup import resolve_device
from ..time_steppers.rk_methods import RK44
from ..time_steppers.step import StepperState, timestep
from .groupconv import rot2stag

__all__ = [
    "create_dataloader_prior",
    "create_dataloader_post",
    "create_trainstate",
    "train",
    "trainepoch",
    "create_loss_prior",
    "create_relerr_prior",
    "create_loss_post",
    "create_relerr_post",
    "create_relerr_symmetry_prior",
    "create_relerr_symmetry_post",
    "create_callback",
]


def _rows(a, i, device):
    """Rows ``i`` of a numpy array or tensor, as a tensor on `device`."""
    return torch.as_tensor(a[i]).to(device)


def create_dataloader_prior(data, *, batchsize=50, device="cuda"):
    """Random-batch dataloader over the (x, y) arrays (numpy or tensors):
    ``batchsize`` rows drawn without replacement, in sorted order.
    Returns ``dataloader(rng) -> ((x, y), rng)`` for a numpy Generator,
    the batch on ``device``."""
    x, y = data
    device = resolve_device(device)

    def dataloader(rng):
        i = np.sort(rng.choice(x.shape[0], size=batchsize, replace=False))
        return (_rows(x, i, device), _rows(y, i, device)), rng

    return dataloader


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


def _update(opt, theta, value, lam):
    """One optimizer step on the gradient of ``value`` plus ``lam`` times
    the parameters (weight decay)."""
    opt.zero_grad(set_to_none=True)
    value.backward()
    if lam is not None:
        with torch.no_grad():
            for p in theta.values():
                p.grad.add_(p, alpha=lam)
    opt.step()


def train(*, dataloader, loss, trainstate, niter, callback=None, callbackstate=None,
          lam=None):
    """Gradient loop: grad of ``loss(batch, theta)``, optional weight
    decay ``lam`` added to the gradients, an optimizer step.  The
    trainstate gains ``loss``, the last loss value (a tensor)."""
    opt, theta = trainstate["opt"], trainstate["theta"]
    for _ in range(niter):
        batch, rng = dataloader(trainstate["rng"])
        value = loss(batch, theta)
        _update(opt, theta, value, lam)
        trainstate = dict(trainstate, rng=rng, loss=value.detach())
        if callback is not None:
            callbackstate = callback(callbackstate, trainstate)
    return dict(trainstate=trainstate, callbackstate=callbackstate)


def trainepoch(*, data, batchsize, loss, trainstate, callback=None, callbackstate=None,
               noiselevel=None, lam=None):
    """One pass over the whole (x, y) dataset in shuffled minibatches of
    ``batchsize`` (each in sorted order; the last partial one dropped),
    with optional input noise ``noiselevel`` times a standard normal
    draw, and weight decay ``lam``.  The order and the noise come from
    the trainstate's numpy Generator."""
    x, y = data
    opt, theta, rng = trainstate["opt"], trainstate["theta"], trainstate["rng"]
    device = next(iter(theta.values())).device
    order = rng.permutation(x.shape[0])
    for b in range(x.shape[0] // batchsize):
        i = np.sort(order[b * batchsize : (b + 1) * batchsize])
        xb, yb = _rows(x, i, device), _rows(y, i, device)
        if noiselevel is not None:
            noise = torch.as_tensor(rng.standard_normal(tuple(xb.shape)))
            xb = xb + noiselevel * noise.to(dtype=xb.dtype, device=device)
        value = loss((xb, yb), theta)
        _update(opt, theta, value, lam)
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


def _dof_boxes(setup, shift=0):
    """Each component's DOF box ``Iu[a]`` (shifted by ``shift``: -1 in the
    interior layout), or one box for all components where they are equal
    (periodic grids): ``[(a, slices)]`` with a None for all components.
    The JAX package slices every component by ``Iu[0]``, which on a
    wall-bounded grid cuts u_y with u_x's box (ROADMAP queue 3); where the
    boxes are equal this is its slice, bit for bit."""
    boxes = [tuple(slice(s + shift, e + shift) for (s, e) in box) for box in setup.grid.Iu]
    if all(b == boxes[0] for b in boxes):
        return [(slice(None), boxes[0])]
    return list(enumerate(boxes))


def _boxed_sq(x, boxes):
    """The sum of squares of ``x`` over the DOF boxes (`_dof_boxes`)."""
    return sum(torch.sum(x[(a, *b)] ** 2) for a, b in boxes)


def _boxed_err(got, got_boxes, ref, boxes):
    """sum |got - ref|² / sum |ref|² over the DOF boxes, got's own (its
    layout) beside ref's."""
    num = sum(torch.sum((got[(a, *gb)] - ref[(a, *b)]) ** 2)
              for (a, gb), (_, b) in zip(got_boxes, boxes))
    return num / _boxed_sq(ref, boxes)


def _unrolled_errors(u, t, theta, *, setup, method, psolver, nsubstep, sqrt_each,
                     remat=False, plain=False):
    """Step the LES solver with its closure from u[0] along the stored
    time stamps and average the relative errors on the DOF box.
    ``remat=True`` checkpoints each solver step; ``plain=True`` runs the
    per-op kernels' plain versions (fast path)."""
    u = torch.as_tensor(u, dtype=setup.dtype, device=setup.device)
    ts = [float(v) for v in (t.tolist() if torch.is_tensor(t) else np.asarray(t))]
    boxes = _dof_boxes(setup)
    if fastpath_applicable(setup, method, psolver):
        step = make_fast_timestep(setup, method, differentiable=True, plain=plain)
        # the interior layout: the ghosted DOF box shifts down by the
        # one-cell ghost border
        boxes_state = _dof_boxes(setup, -1)
        ustart = strip_ghosts(u[0])
    else:
        def step(state, dt, theta):
            return timestep(method, state, dt, setup=setup, psolver=psolver, theta=theta)

        boxes_state = boxes
        ustart = u[0]
    if remat:
        def one_step(state, dt, theta):
            return checkpoint(step, state, dt, theta, use_reentrant=False)
    else:
        one_step = step
    state = StepperState(u=ustart, temp=None, t=ts[0], n=0)
    total = 0.0
    for it in range(1, len(ts)):
        dt = (ts[it] - ts[it - 1]) / nsubstep
        for _ in range(nsubstep):
            state = one_step(state, dt, theta)
        err = _boxed_err(state.u, boxes_state, u[it], boxes)
        total = total + (torch.sqrt(err) if sqrt_each else err)
    return total / (len(ts) - 1)


def _with_closure(setup, closure_model):
    return dataclasses.replace(setup, closure_model=closure_model)


def create_loss_post(*, setup, method, psolver, closure_model, nsubstep=1, remat=False,
                     plain=False):
    """A-posteriori loss: the relative trajectory error of the unrolled
    solver with ``closure_model``.  ``loss(data, theta)`` takes a list of
    dicts (u: ``(nt, D, *N)`` ghosted fields, numpy or tensors; t:
    ``(nt,)`` times).  ``remat=True`` checkpoints each step (long
    unrolls); ``plain=True`` runs the per-op kernels' plain versions on
    any device."""
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


def _relerr(got, ref, boxes):
    return torch.sqrt(_boxed_err(got, boxes, ref, boxes))


def create_relerr_symmetry_prior(*, u, setup, g=1):
    """A-priori rotation-equivariance error of the setup's closure:
    closure-then-rotate against rotate-then-closure (`rot2stag` by ``g``
    quarter turns), averaged over the ghosted fields ``u``
    ``(nsample, 2, *N)``."""
    closure = setup.closure_model
    boxes = _dof_boxes(setup)
    u = torch.as_tensor(u, dtype=setup.dtype, device=setup.device)

    def err(theta):
        with torch.no_grad():
            total = 0.0
            for ui in u:
                cr = closure(rot2stag(ui, g), theta)
                total = total + _relerr(rot2stag(closure(ui, theta), g), cr, boxes)
            return total / u.shape[0]

    return err


def create_relerr_symmetry_post(*, u, setup, psolver, method=None, dt, nstep, g=1):
    """A-posteriori symmetry error: ``nstep`` steps of the general path's
    `timestep` from ``u`` and from its rotation, the first run rotated
    after each step against the second, averaged over the steps."""
    if method is None:
        method = RK44()
    boxes = _dof_boxes(setup)
    u = torch.as_tensor(u, dtype=setup.dtype, device=setup.device)

    def err(theta):
        with torch.no_grad():
            s1 = StepperState(u=u, temp=None, t=0.0, n=0)
            s2 = StepperState(u=rot2stag(u, g), temp=None, t=0.0, n=0)
            total = 0.0
            for _ in range(nstep):
                s1 = timestep(method, s1, dt, setup=setup, psolver=psolver, theta=theta)
                s2 = timestep(method, s2, dt, setup=setup, psolver=psolver, theta=theta)
                total = total + _relerr(s2.u, rot2stag(s1.u, g), boxes)
            return total / nstep

    return err


def create_callback(err, *, theta, nupdate=1, displayupdates=False):
    """Track the best parameters and the error history: returns
    ``(state, callback)``; every ``nupdate`` calls the callback
    evaluates ``err(theta)``, prints it and keeps a copy of the
    parameters with the lowest error so far (``theta_min``).
    ``displayupdates`` is accepted for parity (the JAX package has no
    plot either)."""
    state = dict(n=0, theta_min=theta, emin=float("inf"), hist=[], ctime=time.time())

    def callback(callbackstate, trainstate):
        cs = dict(callbackstate)
        if cs["n"] % nupdate == 0:
            e = float(err(trainstate["theta"]))
            now = time.time()
            itertime = (now - cs["ctime"]) / max(1, nupdate)
            cs["ctime"] = now
            print(f"Iteration {cs['n']}\trelative error: {e:.4g}\tsec/iter: {itertime:.4g}")
            cs["hist"] = cs["hist"] + [(cs["n"], e)]
            if e < cs["emin"]:
                # the optimizer updates theta in place: keep a copy
                cs["theta_min"] = {k: v.detach().clone() for k, v in trainstate["theta"].items()}
                cs["emin"] = e
        cs["n"] += 1
        return cs

    return state, callback
