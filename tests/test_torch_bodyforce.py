"""Unsteady body forces in the port against the JAX package (CPU, f64).

`Setup(bodyforce=f, issteadybodyforce=False)` keeps the callable and
evaluates it at each stage's time on the full staggered coordinates,
``t`` a 0-d tensor of the setup's dtype on its device
(`ops.operators.applybodyforce`).  A time-periodic force
``f = (sin(y) cos(3t), sin(2t) cos(x), ...)`` on the 16³ periodic roll
route (RK44, whose stage times are the shifted tableau's, and LMWray3,
whose are its c) and on a 2-D lid-driven cavity's general path (RK44 and
AB-CN, which takes the force at both ends of its step): three steps of
`solve_unsteady` held against the JAX package's to 1e-10.  The fused
chains decline the force (the route check: no hat, no unmerged chain),
as the JAX package's fused stage does, and so do the channel path (the
general path steps it) and the halo path (ValueError, as in the JAX
package).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ins_tpu as ins
from ins_tpu.time_steppers import methods as jmethods

import ins_tpu_torch as it
from ins_tpu_torch.ops import launches
from ins_tpu_torch.ops.channelpath import channelpath_applicable
from ins_tpu_torch.ops.fastpath import (
    hat_chain_applicable,
    make_fast_timestep_hat,
    unmerged_chain_applicable,
)
from ins_tpu_torch.parallel import make_halo_fast_step
from ins_tpu_torch.parallel.mesh import Mesh
from ins_tpu_torch.time_steppers import methods as tmethods

TOL = 1e-10


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


def _t(a):
    return torch.from_numpy(np.array(a, np.float64))


def _force(xp):
    """A time-periodic force in the array module ``xp`` (jnp or torch)."""

    def f(dim, *xt):
        x, y, t = xt[0], xt[1], xt[-1]
        if dim == 0:
            return xp.sin(y) * xp.cos(3 * t)
        if dim == 1:
            return 0.5 * xp.sin(2 * t) * xp.cos(x)
        return 0.25 * xp.cos(t) + 0 * x
    return f


@functools.lru_cache(maxsize=None)
def _setups(name):
    if name == "periodic":
        x = (np.linspace(0, 2 * np.pi, 17),) * 3
        kw = dict(Re=1e3)
    else:
        x = (ins.cosine_grid(0.0, 1.0, 10), np.linspace(0.0, 1.0, 11))

        def bc(pk):
            d = pk.DirichletBC()
            return ((d, d), (d, pk.DirichletBC((1.0, 0.0))))
    js = ins.Setup(x=x, dtype=jnp.float64, bodyforce=_force(jnp), issteadybodyforce=False,
                   **(kw if name == "periodic" else dict(Re=100.0, boundary_conditions=bc(ins))))
    ts = it.Setup(x=x, dtype=torch.float64, device="cpu", bodyforce=_force(torch),
                  issteadybodyforce=False,
                  **(kw if name == "periodic" else dict(Re=100.0, boundary_conditions=bc(it))))
    return js, ts


@functools.lru_cache(maxsize=None)
def _u0(name):
    js, _ = _setups(name)
    g = js.grid
    u = np.random.default_rng(4).standard_normal((g.dim, *g.N))
    ps = ins.psolver_spectral(js) if name == "periodic" else ins.default_psolver(js)
    return np.array(ins.project(ins.apply_bc_u(jnp.asarray(u), jnp.asarray(0.0), js), js,
                                psolver=ps))


def test_setup_keeps_the_callable():
    """The unsteady force is kept, not evaluated: `applybodyforce` at a
    time equals the JAX package's, on every staggered component."""
    js, ts = _setups("cavity")
    assert ts.bodyforce_field is None and ts.unsteady_bodyforce is ts.bodyforce
    for tval in (0.0, 0.37):
        ref = ins.applybodyforce(None, jnp.asarray(tval), js)
        got = it.applybodyforce(None, np.float64(tval), ts)
        assert got.shape == ref.shape and _rel(got.numpy(), ref) < 1e-15


METHODS = {
    "rk44": (lambda pk: pk.RKMethods.RK44(),),
    "lmwray3": (lambda pk: pk.LMWray3(),),
    "abcn": (lambda pk: (tmethods if pk is it else jmethods)
             .AdamsBashforthCrankNicolsonMethod(),),
}


@pytest.mark.parametrize("name,method", [("periodic", "rk44"), ("periodic", "lmwray3"),
                                         ("cavity", "rk44"), ("cavity", "abcn")])
def test_unsteady_force_matches_jax(name, method):
    """Three steps of `solve_unsteady` with the time-periodic force: the
    periodic roll route and the cavity's general path against the JAX
    package's, 1e-10."""
    js, ts = _setups(name)
    u0 = _u0(name)
    (mk,) = METHODS[method]
    kw = dict(tlims=(0.1, 0.1 + 3 * 0.02), dt=0.02)
    jst, _ = ins.solve_unsteady(setup=js, ustart=jnp.asarray(u0), method=mk(ins), **kw)
    launches.reset_counts()
    st, _ = it.solve_unsteady(setup=ts, ustart=_t(u0), method=mk(it), **kw)
    assert st.n == 3
    assert _rel(st.u.numpy(), jst.u) < TOL
    # the force moved the run: without it the state differs
    steady, _ = it.solve_unsteady(setup=it.Setup(x=tuple(np.asarray(v) for v in _x(ts)),
                                                 boundary_conditions=ts.boundary_conditions,
                                                 Re=ts.Re, dtype=torch.float64, device="cpu"),
                                  ustart=_t(u0), method=mk(it), **kw)
    assert _rel(steady.u.numpy(), jst.u) > 1e-4
    assert not any(launches.LAUNCHES.values())  # CPU: plain versions only


def _x(setup):
    """The volume boundaries of a setup without its ghosts."""
    return tuple(np.asarray(xd)[1:-1] for xd in setup.grid.x)


def test_fused_chains_and_channel_decline_it():
    """The route: the hat and unmerged chains decline the unsteady force
    (the roll twin steps it), the channel path declines it (the general
    path steps it), the halo path raises ValueError."""
    _, ts = _setups("periodic")
    rk44, ssp33 = it.RKMethods.RK44(), it.RKMethods.SSP33()
    assert not hat_chain_applicable(ts, rk44)
    assert not unmerged_chain_applicable(ts, ssp33)
    assert make_fast_timestep_hat(ts, rk44) is None
    assert make_fast_timestep_hat(ts, ssp33, stream_dtype=torch.bfloat16) is None
    steady = it.Setup(x=_x(ts), Re=1e3, dtype=torch.float64, device="cpu",
                      bodyforce=_force(torch))
    assert hat_chain_applicable(steady, rk44) and steady.unsteady_bodyforce is None
    p = (it.PeriodicBC(), it.PeriodicBC())
    walls = (p, p, (it.DirichletBC(), it.DirichletBC()))
    chan = it.Setup(x=_x(ts), boundary_conditions=walls, dtype=torch.float64, device="cpu",
                    bodyforce=_force(torch), issteadybodyforce=False)
    assert not channelpath_applicable(chan, rk44)
    assert channelpath_applicable(
        it.Setup(x=_x(ts), boundary_conditions=walls, dtype=torch.float64, device="cpu",
                 bodyforce=_force(torch)), rk44)
    one = Mesh(group=None, rank=0, size=1, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="unsteady callable"):
        make_halo_fast_step(ts, rk44, one)
