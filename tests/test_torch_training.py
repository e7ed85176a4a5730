"""The port's a-posteriori training path, held against the JAX package.

A CNN closure (radii (1, 1), channels (4, 3), float64 convs) with the
JAX package's parameters carried by `convert`, an RK44 unroll on a 16³
periodic box: the loss and its gradient with respect to the CNN
parameters, with and without remat, two Adam `train` iterations against
the JAX package's `train`, and `solve_unsteady` with the closure
attached.  The JAX loss's value and gradient (with and without remat)
and its relative error are compiled once for the module.  On CPU
tensors the per-op chain runs the kernels' plain versions and their
custom VJPs; the card runs the same chain through the CUDA kernels
(`chip_smoke.py`).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ins_tpu as ins
import ins_tpu.models as jnc

from torch_jax_oracles import jax_cnn

import ins_tpu_torch as it
from ins_tpu_torch import models as nc
from ins_tpu_torch.convert import cnn_params_from_numpy
from ins_tpu_torch.ops import launches
from ins_tpu_torch.ops.fastpath import (
    hat_chain_applicable,
    make_fast_timestep,
    make_fast_timestep_hat,
    strip_ghosts,
)

N = 16
NUNROLL = 2
DT = 5e-4
# f64 on both sides; the chains agree to ~1e-15 per step, so 1e-9 relative
# on the loss and the gradient leaves a wide margin
TOL = 1e-9


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.fixture(scope="module")
def case():
    x = tuple(np.linspace(0.0, 1.0, N + 1) for _ in range(3))
    js = ins.Setup(x=x, Re=2000.0, dtype=jnp.float64)
    ts = it.Setup(device="cpu", x=x, Re=2000.0, dtype=torch.float64)
    kw = dict(radii=[1, 1], channels=[4, 3], use_bias=[True, False])
    jcl, jth = jax_cnn(setup=js, activations=[jax.nn.tanh, lambda v: v],
                       rng=jax.random.PRNGKey(0), compute_dtype=jnp.float64, **kw)
    tcl, _ = nc.cnn(setup=ts, activations=[torch.tanh, lambda v: v],
                    compute_dtype=torch.float64, **kw)
    u0 = np.array(jax.jit(lambda k: ins.random_field(js, kp=5, rng=k))(jax.random.PRNGKey(3)))
    us = np.stack([u0 * (1.0 - 0.01 * i) for i in range(NUNROLL + 1)])
    tt = np.arange(NUNROLL + 1) * DT
    return types.SimpleNamespace(
        x=x, js=js, ts=ts, jth=jth, jm=jnc.wrappedclosure(jcl, js),
        tm=nc.wrappedclosure(tcl, ts), u0=u0, us=us, tt=tt,
    )


@pytest.fixture(scope="module")
def jref(case):
    """The module's JAX oracles, each compiled once: the RK44 loss's value
    and gradient with respect to the CNN parameters at the case's
    parameters, with and without remat (``grads[remat]``), and the
    relative error of the same unroll (``relerr``, compiled with the
    gradient without remat)."""
    us, tt = jnp.asarray(case.us), jnp.asarray(case.tt)
    relerr = jnc.create_relerr_post(
        data={"u": case.us, "t": case.tt}, setup=case.js, method=ins.RKMethods.RK44(),
        psolver=ins.psolver_spectral(case.js), closure_model=case.jm,
    )
    grads = {}
    for remat in (False, True):
        jl, _ = _losses(case, remat)
        vg = jax.value_and_grad(lambda th, u, t, jl=jl: jl([{"u": u, "t": t}], th))
        if remat:
            grads[remat] = jax.jit(vg)(case.jth, us, tt)
        else:
            grads[remat], err = jax.jit(lambda th, u, t: (vg(th, u, t), relerr(th)))(
                case.jth, us, tt)
    return types.SimpleNamespace(grads=grads, relerr=err)


def _losses(c, remat):
    jl = jnc.create_loss_post(setup=c.js, method=ins.RKMethods.RK44(),
                              psolver=ins.psolver_spectral(c.js), closure_model=c.jm,
                              remat=remat)
    tl = nc.create_loss_post(setup=c.ts, method=it.RKMethods.RK44(),
                             psolver=it.psolver_spectral(c.ts), closure_model=c.tm,
                             remat=remat)
    return jl, tl


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_loss_post_and_gradient_match_jax(case, jref, remat):
    _, tl = _losses(case, remat)
    jv, jg = jref.grads[remat]
    theta = cnn_params_from_numpy(case.jth, device="cpu")
    launches.reset_counts()
    tv = tl([{"u": torch.from_numpy(case.us), "t": torch.from_numpy(case.tt)}], theta)
    tg = torch.autograd.grad(tv, list(theta.values()))
    assert not any(launches.LAUNCHES.values())  # CPU: plain versions only
    assert abs(tv.item() - float(jv)) < TOL * abs(float(jv))
    for name, g in zip(theta, tg):
        assert _rel(g.numpy(), jg[name]) < TOL, name


def test_train_matches_optax_adam(case):
    """Two Adam iterations with weight decay: the same parameters."""
    jl, tl = _losses(case, remat=False)
    lam = 0.1
    jtraj = [{"u": case.us, "t": case.tt}]
    jout = jnc.train(
        dataloader=jnc.create_dataloader_post(jtraj, ntrajectory=1, nunroll=NUNROLL),
        loss=jl, trainstate=jnc.create_trainstate(case.jth, lr=1e-3), niter=2, lam=lam,
    )
    theta = cnn_params_from_numpy(case.jth, device="cpu")
    theta0 = {k: v.detach().clone() for k, v in theta.items()}
    ttraj = [{"u": torch.from_numpy(case.us), "t": torch.from_numpy(case.tt)}]
    tout = nc.train(
        dataloader=nc.create_dataloader_post(ttraj, ntrajectory=1, nunroll=NUNROLL),
        loss=tl, trainstate=nc.create_trainstate(theta, lr=1e-3), niter=2, lam=lam,
    )
    assert tout["trainstate"]["theta"] is theta  # updated in place
    jnew = jout["trainstate"]["theta"]
    for name, t in theta.items():
        ref_step = np.asarray(jnew[name]) - np.asarray(case.jth[name])
        got_step = (t.detach() - theta0[name]).numpy()
        assert np.abs(ref_step).max() > 1e-4, name  # the parameters moved
        assert _rel(got_step, ref_step) < 1e-6, name
        assert _rel(t.detach().numpy(), jnew[name]) < TOL, name


def test_relerr_post_matches_jax(case, jref):
    ref = jref.relerr
    got = nc.create_relerr_post(
        data={"u": torch.from_numpy(case.us), "t": torch.from_numpy(case.tt)},
        setup=case.ts, method=it.RKMethods.RK44(), psolver=it.psolver_spectral(case.ts),
        closure_model=case.tm,
    )(cnn_params_from_numpy(case.jth, device="cpu"))
    assert not got.requires_grad
    assert abs(got.item() - float(ref)) < TOL * abs(float(ref))


def test_solve_unsteady_with_closure_matches_jax(case):
    jsc = ins.Setup(x=case.x, Re=2000.0, dtype=jnp.float64, closure_model=case.jm)
    tsc = it.Setup(device="cpu", x=case.x, Re=2000.0, dtype=torch.float64, closure_model=case.tm)
    kw = dict(tlims=(0.0, 3 * DT), dt=DT)
    ref, _ = ins.solve_unsteady(setup=jsc, ustart=jnp.asarray(case.u0), theta=case.jth,
                                psolver=ins.psolver_spectral(jsc), **kw)
    assert not hat_chain_applicable(tsc, it.RKMethods.RK44())
    assert make_fast_timestep_hat(tsc, it.RKMethods.RK44()) is None
    theta = cnn_params_from_numpy(case.jth, device="cpu")
    got, _ = it.solve_unsteady(setup=tsc, ustart=torch.from_numpy(case.u0), theta=theta, **kw)
    assert got.n == 3 and not got.u.requires_grad
    assert _rel(got.u.numpy(), ref.u) < TOL


def test_differentiable_chain_equals_hat_chain_without_closure(case):
    """With no closure the per-op chain (``differentiable=True``) steps
    the same RK44 as the fused hat chain."""
    method = it.RKMethods.RK44()
    s = it.create_stepper(method, setup=case.ts, u=strip_ghosts(torch.from_numpy(case.u0)))
    a = make_fast_timestep(case.ts, method)(s, 1e-2)
    b = make_fast_timestep(case.ts, method, differentiable=True)(s, 1e-2)
    assert a.n == b.n == 1 and b.t == pytest.approx(1e-2)
    assert _rel(b.u.numpy(), a.u.numpy()) < 1e-12


def test_two_d_closure_steps_the_roll_twin():
    """2-D setups keep the roll twin; a zero closure changes nothing."""
    x = (np.linspace(0, 2 * np.pi, 17),) * 2
    plain = it.Setup(device="cpu", x=x, Re=1e3, dtype=torch.float64)
    closed = it.Setup(device="cpu", x=x, Re=1e3, dtype=torch.float64,
                      closure_model=lambda u, theta: theta * u)
    u0 = strip_ghosts(it.random_field(plain, kp=2, generator=torch.Generator().manual_seed(5)))
    method = it.RKMethods.RK44()
    s = it.create_stepper(method, setup=plain, u=u0)
    ref = make_fast_timestep(plain, method)(s, 1e-2)
    got = make_fast_timestep(closed, method)(s, 1e-2, 0.0)
    assert _rel(got.u.numpy(), ref.u.numpy()) < 1e-14


def test_dataloader_post_windows():
    us = torch.arange(7.0).reshape(7, 1, 1, 1, 1)
    load = nc.create_dataloader_post([{"u": us, "t": torch.arange(7.0)}], ntrajectory=1, nunroll=3)
    rng = np.random.default_rng(0)
    starts = set()
    for _ in range(20):
        (traj,), rng = load(rng)
        assert traj["u"].shape[0] == traj["t"].shape[0] == 4
        assert torch.equal(traj["u"].flatten(), traj["t"])  # one window, in order
        starts.add(int(traj["t"][0]))
    assert starts <= {0, 1, 2, 3} and len(starts) > 1
    with pytest.raises(ValueError, match="too short"):
        nc.create_dataloader_post([{"u": us[:3], "t": torch.arange(3.0)}], ntrajectory=1,
                                  nunroll=3)(np.random.default_rng(0))


def test_prior_losses():
    rng = np.random.default_rng(12)
    x, y = (torch.from_numpy(rng.standard_normal((4, 5))) for _ in range(2))
    theta = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)

    def f(x, theta):
        return theta * x

    loss = nc.create_loss_prior(f)((x, y), theta)
    ref = np.sum((0.5 * x.numpy() - y.numpy()) ** 2) / np.sum(y.numpy() ** 2)
    assert loss.item() == pytest.approx(ref, rel=1e-14)
    (g,) = torch.autograd.grad(loss, theta)
    assert g.item() == pytest.approx(
        np.sum(2 * (0.5 * x.numpy() - y.numpy()) * x.numpy()) / np.sum(y.numpy() ** 2), rel=1e-12
    )
    err = nc.create_relerr_prior(f, x, y)(theta)
    assert err.item() == pytest.approx(
        np.linalg.norm(0.5 * x.numpy() - y.numpy()) / np.linalg.norm(y.numpy()), rel=1e-14
    )


def test_training_off_the_fast_path_raises(case):
    """LMWray3 trains through the per-op chain (loss and gradient equal
    `jax.grad`'s, the module's 16³ case); off the periodic fast path
    (here without the spectral solver) training still raises."""
    jl = jnc.create_loss_post(setup=case.js, method=ins.LMWray3(),
                              psolver=ins.psolver_spectral(case.js), closure_model=case.jm)
    f = jax.jit(jax.value_and_grad(lambda th, u, t: jl([{"u": u, "t": t}], th)))
    jv, jg = f(case.jth, jnp.asarray(case.us), jnp.asarray(case.tt))
    data = [{"u": torch.from_numpy(case.us), "t": torch.from_numpy(case.tt)}]
    theta = cnn_params_from_numpy(case.jth, device="cpu")
    tv = nc.create_loss_post(setup=case.ts, method=it.LMWray3(),
                             psolver=it.psolver_spectral(case.ts),
                             closure_model=case.tm)(data, theta)
    tg = torch.autograd.grad(tv, list(theta.values()))
    assert abs(tv.item() - float(jv)) < TOL * abs(float(jv))
    for name, g in zip(theta, tg):
        assert _rel(g.numpy(), jg[name]) < TOL, name
    off = nc.create_loss_post(setup=case.ts, method=it.LMWray3(), psolver=None,
                              closure_model=case.tm)
    with pytest.raises(NotImplementedError, match="fast path"):
        off(data, theta)
