"""The port's a-priori training, symmetry errors and a-posteriori training
off the fast path, held against the JAX package at float64.

- `create_dataloader_prior`: sorted rows drawn without replacement.
- `trainepoch` (a 2-D CNN on 8², batches of 3, input noise and weight
  decay) against optax Adam steps on the same minibatches, in the same
  order, with the same noise: the parameters to 1e-8.
- `create_callback`: the best parameters (a copy) and the history.
- `create_relerr_symmetry_prior` / `_post` of a 2-D CNN on 16² against
  the JAX package's, to 1e-10.
- The a-posteriori loss and its gradient off the fast path: RK44 on a
  16² periodic box with `psolver_cg` (the CNN closure), and on a 2-D
  lid-driven cavity with `psolver_direct` (a closure ``a·u + b·u²``), to
  1e-8, with the JAX package's ``Iu[0]`` slice of the errors (the port's
  own per-component boxes are `tests/test_torch_dofbox.py`'s).  The
  Poisson solve's VJP is the solve itself on both sides, so neither the
  CG loop nor the host LU is taped.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ins_tpu as ins
import ins_tpu.models as jnc
from ins_tpu.models.cnn import CNN as JCNN

import ins_tpu_torch as it
from ins_tpu_torch import models as nc
from ins_tpu_torch.convert import cnn_params_from_numpy, flax_params_from_numpy
from ins_tpu_torch.ops.fastpath import fastpath_applicable, reghost

TOL = 1e-10
TOL_POST = 1e-8
NSUB = 2  # substeps of a stored interval in the a-posteriori cases


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: many small float64 operations, which
    oversubscribed threads slow by orders of magnitude when the test lane
    runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _ident(x):
    return x


def _cnn2d(n):
    """The 2-D CNN on an n² periodic box on both sides: (JAX closure, its
    parameters, JAX setup, port closure, port setup)."""
    x = (np.linspace(0.0, 1.0, n + 1),) * 2
    js = ins.Setup(x=x, Re=2e3, dtype=jnp.float64)
    ts = it.Setup(device="cpu", x=x, Re=2e3, dtype=torch.float64)
    kw = dict(radii=(1, 1), channels=(4, 2), use_bias=(True, False))
    jm = JCNN(activations=(jnp.tanh, _ident), dtype=jnp.float64, **kw)
    jth = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.zeros((1, n, n, 2)))["params"]

    def jclosure(v, th):
        return jm.apply({"params": th}, v)

    tclosure, _ = nc.cnn(setup=ts, activations=(torch.tanh, _ident), **kw)
    return types.SimpleNamespace(jcl=jclosure, jth=jth, js=js, tcl=tclosure, ts=ts)


def test_dataloader_prior_draws_sorted_distinct_rows():
    x = np.arange(20.0).reshape(10, 2)
    y = -x
    dl = nc.create_dataloader_prior((x, y), batchsize=4, device="cpu")
    rng = np.random.default_rng(0)
    seen = []
    for _ in range(3):
        (xb, yb), rng = dl(rng)
        rows = xb[:, 0].numpy() / 2
        assert xb.shape == (4, 2) and torch.equal(yb, -xb)
        assert np.all(np.diff(rows) > 0)  # sorted, no repeats
        seen.append(tuple(rows))
    assert len(set(seen)) > 1  # the generator advances
    ref = np.sort(np.random.default_rng(0).choice(10, size=4, replace=False))
    assert np.array_equal(np.asarray(seen[0]), ref)


def test_trainepoch_matches_optax_adam():
    """Three minibatches of 3 out of 10 samples (the last sample dropped),
    noise 0.1, weight decay 0.01: the parameters after the epoch equal
    optax Adam's on the same batches, to 1e-8."""
    c = _cnn2d(8)
    x = np.random.default_rng(1).standard_normal((10, 8, 8, 2))
    y = np.random.default_rng(2).standard_normal((10, 8, 8, 2))
    noiselevel, lam, bs = 0.1, 0.01, 3

    # the port
    theta = cnn_params_from_numpy(c.jth, device="cpu")
    state = nc.create_trainstate(theta, lr=1e-3, rng=np.random.default_rng(5))
    losses = []
    out = nc.trainepoch(data=(x, y), batchsize=bs, loss=nc.create_loss_prior(c.tcl),
                        trainstate=state, noiselevel=noiselevel, lam=lam,
                        callback=lambda cs, ts: cs + [ts["loss"].item()], callbackstate=[])
    assert out["trainstate"]["theta"] is theta
    losses = out["callbackstate"]
    assert len(losses) == 3

    # optax on the same batches: the order, then one normal draw a batch
    rng = np.random.default_rng(5)
    order = rng.permutation(10)
    opt = optax.adam(1e-3)
    jth, ost = c.jth, opt.init(c.jth)
    jloss = jnc.create_loss_prior(c.jcl)

    @jax.jit
    def step(th, ost, xb, yb):
        v, g = jax.value_and_grad(lambda t: jloss((xb, yb), t))(th)
        g = jax.tree.map(lambda gi, ti: gi + lam * ti, g, th)
        upd, ost = opt.update(g, ost, th)
        return optax.apply_updates(th, upd), ost, v

    jlosses = []
    for b in range(3):
        i = np.sort(order[b * bs:(b + 1) * bs])
        xb = x[i] + noiselevel * rng.standard_normal(x[i].shape)
        jth, ost, v = step(jth, ost, jnp.asarray(xb), jnp.asarray(y[i]))
        jlosses.append(float(v))
    assert np.allclose(losses, jlosses, rtol=TOL_POST, atol=0)
    jflat = flax_params_from_numpy(jth, device="cpu")
    for name, t in theta.items():
        assert _rel(t.detach().numpy(), jflat[name].detach().numpy()) < TOL_POST, name


def test_callback_keeps_a_copy_of_the_best_parameters():
    theta = {"w": torch.tensor([1.0], dtype=torch.float64, requires_grad=True)}
    errs = iter([0.5, 0.2, 0.3, 0.1])
    state, cb = nc.create_callback(lambda th: next(errs), theta=theta, nupdate=2)
    assert state["theta_min"] is theta and state["emin"] == float("inf")
    for k in range(8):
        with torch.no_grad():
            theta["w"].fill_(float(k))
        state = cb(state, {"theta": theta})
    assert state["n"] == 8
    assert state["hist"] == [(0, 0.5), (2, 0.2), (4, 0.3), (6, 0.1)]
    assert state["emin"] == 0.1 and state["theta_min"]["w"].item() == 6.0
    assert state["theta_min"]["w"] is not theta["w"]


@pytest.fixture(scope="module")
def sym():
    c = _cnn2d(16)
    jm, tm = jnc.wrappedclosure(c.jcl, c.js), nc.wrappedclosure(c.tcl, c.ts)
    jsc = ins.Setup(x=(np.linspace(0.0, 1.0, 17),) * 2, Re=2e3, dtype=jnp.float64,
                    closure_model=jm)
    tsc = it.Setup(device="cpu", x=(np.linspace(0.0, 1.0, 17),) * 2, Re=2e3,
                   dtype=torch.float64, closure_model=tm)
    u = np.stack([reghost(torch.from_numpy(np.random.default_rng(k).standard_normal((2, 16, 16))))
                  .numpy() for k in (3, 4)])
    return types.SimpleNamespace(c=c, jsc=jsc, tsc=tsc, u=u,
                                 theta=cnn_params_from_numpy(c.jth, device="cpu"))


def test_relerr_symmetry_prior_matches_jax(sym):
    for g in (1, 3):
        ref = float(jnc.create_relerr_symmetry_prior(u=jnp.asarray(sym.u), setup=sym.jsc,
                                                     g=g)(sym.c.jth))
        got = nc.create_relerr_symmetry_prior(u=sym.u, setup=sym.tsc, g=g)(sym.theta)
        assert ref > 1e-3  # a CNN is not rotation-equivariant
        assert abs(got.item() - ref) < TOL * ref, g


def test_relerr_symmetry_post_matches_jax(sym):
    u0 = sym.u[0]
    ref = float(jnc.create_relerr_symmetry_post(
        u=jnp.asarray(u0), setup=sym.jsc, psolver=ins.psolver_spectral(sym.jsc), dt=1e-3,
        nstep=2)(sym.c.jth))
    got = nc.create_relerr_symmetry_post(u=u0, setup=sym.tsc,
                                         psolver=it.psolver_spectral(sym.tsc), dt=1e-3,
                                         nstep=2)(sym.theta)
    assert ref > 1e-6
    assert abs(got.item() - ref) < TOL * ref


def _cavity(pk, n=16):
    kw = dict(device="cpu") if pk is it else {}
    dtype = torch.float64 if pk is it else jnp.float64
    d = pk.DirichletBC()
    bc = ((d, d), (d, pk.DirichletBC((1.0, 0.0))))
    return pk.Setup(x=(np.linspace(0.0, 1.0, n + 1),) * 2, boundary_conditions=bc, Re=1e3,
                    dtype=dtype, **kw)


def _quad_closure(u, theta):
    return theta["a"] * u + theta["b"] * u**2


@pytest.fixture(scope="module", params=["cg16", "cavity_direct16"])
def post(request):
    """An RK44 unroll of 2 stored steps with 2 substeps off the fast path:
    the port's setup, solver, closure and theta, the data, and the JAX
    package's loss and gradient (jitted, once for the module)."""
    if request.param == "cg16":
        c = _cnn2d(16)
        jm, tm = jnc.wrappedclosure(c.jcl, c.js), nc.wrappedclosure(c.tcl, c.ts)
        js, ts, jth = c.js, c.ts, c.jth
        jps, tps = ins.psolver_cg(js), it.psolver_cg(ts)
        u0 = np.asarray(jax.jit(lambda k: ins.random_field(js, kp=4, rng=k))(
            jax.random.PRNGKey(3)))
        tth = cnn_params_from_numpy(jth, device="cpu")
    else:
        js, ts = _cavity(ins), _cavity(it)
        jm, tm = _quad_closure, _quad_closure
        jps, tps = ins.psolver_direct(js), it.psolver_direct(ts)
        jth = {"a": jnp.asarray(-0.5), "b": jnp.asarray(0.25)}
        tth = {k: torch.tensor(float(v), dtype=torch.float64, requires_grad=True)
               for k, v in jth.items()}
        # the flow 10 steps after rest (the port's run: the data only
        # needs to be shared)
        st, _ = it.solve_unsteady(setup=ts, ustart=it.vectorfield(ts), tlims=(0.0, 0.02),
                                  dt=2e-3, psolver=tps)
        u0 = st.u.numpy()
    us = np.stack([u0 * (1.0 - 0.01 * i) for i in range(3)])
    tt = np.arange(3) * 2e-3
    jl = jnc.create_loss_post(setup=js, method=ins.RKMethods.RK44(), psolver=jps,
                              closure_model=jm, nsubstep=NSUB)
    jv, jg = jax.jit(jax.value_and_grad(
        lambda th, u, t: jl([{"u": u, "t": t}], th)))(jth, jnp.asarray(us), jnp.asarray(tt))
    return types.SimpleNamespace(ts=ts, tps=tps, tm=tm, tth=tth, us=us, tt=tt, jv=float(jv),
                                 jg=flax_params_from_numpy(jg, device="cpu"))


def _jax_dof_boxes(setup, shift=0):
    """The JAX package's slice of the a-posteriori errors: every component
    by the first one's DOF box ``Iu[0]``."""
    return [(slice(None), tuple(slice(s + shift, e + shift) for (s, e) in setup.grid.Iu[0]))]


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_loss_post_off_the_fast_path_matches_jax(post, remat, monkeypatch):
    # the port takes each component's own DOF box where the JAX package
    # slices all by Iu[0] (ROADMAP queue 3, tests/test_torch_dofbox.py);
    # on the cavity the two differ, so the unrolled loss and its gradient
    # are held here with the JAX package's slice
    monkeypatch.setattr(nc.training, "_dof_boxes", _jax_dof_boxes)
    method = it.RKMethods.RK44()
    assert not fastpath_applicable(post.ts, method, post.tps)
    tl = nc.create_loss_post(setup=post.ts, method=method, psolver=post.tps,
                             closure_model=post.tm, nsubstep=NSUB, remat=remat)
    tv = tl([{"u": post.us, "t": post.tt}], post.tth)
    tg = torch.autograd.grad(tv, list(post.tth.values()))
    assert abs(tv.item() - post.jv) < TOL_POST * abs(post.jv)
    for k, g in zip(post.tth, tg):
        assert _rel(g.numpy(), post.jg[k].detach().numpy()) < TOL_POST, k
