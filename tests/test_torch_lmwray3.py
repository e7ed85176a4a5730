"""The port's LMWray3 (low-storage Wray RK3) against the JAX package
(CPU, f64).

LMWray3 re-drives the stage kernels with its accumulator streams: stage 0
takes the rebuilt velocity as its tableau base and writes only the
accumulator ``ustart + dt·b_0·f``, the later stages take that
accumulator as their base.  On CPU tensors the kernels run their plain
versions, so these tests hold the port's LMWray3 chains — the hat chain
with and without temperature, the per-step chain, the roll twin, the
per-op (training) chain and `solve_unsteady` — against the JAX package's
fused interpret chain, its roll twin (which the JAX package pins to its
fused chain at 1e-10) and its solver.

Both sides are f64 and differ in summation order only: 1e-10 over a few
steps of a chain, 1e-9 relative where FFT and eigen-transform
projections meet.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ins_tpu as ins
from ins_tpu.ops.fastpath import make_fast_timestep as jax_make_fast_timestep
from ins_tpu.ops.fastpath import make_fast_timestep_hat as jax_make_fast_timestep_hat
from ins_tpu.ops.fastpath import strip_ghosts as jax_strip_ghosts
from ins_tpu.time_steppers.step import StepperState as JaxStepperState

import ins_tpu_torch as it
from ins_tpu_torch.ops import launches
from ins_tpu_torch.ops.fastpath import (
    hat_chain_applicable,
    make_fast_timestep,
    make_fast_timestep_hat,
    strip_ghosts,
)

TOL_CHAIN = 1e-10
TOL_REL = 1e-9


def _abs(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _t(a):
    return torch.from_numpy(np.array(a))


def _setups(n, D=3, Re=1e3):
    x = (np.linspace(0, 2 * np.pi, n + 1),) * D
    return (ins.Setup(x=x, Re=Re, dtype=jnp.float64),
            it.Setup(device="cpu", x=x, Re=Re, dtype=torch.float64))


@functools.lru_cache(maxsize=None)
def _u0(n, D=3, kp=4):
    jset, _ = _setups(n, D)
    return np.array(jax.jit(lambda k: ins.random_field(jset, kp=kp, rng=k))(jax.random.PRNGKey(0)))


def _jax_roll_steps(jset, u0, dt, nsteps):
    step = jax.jit(jax_make_fast_timestep(jset, ins.LMWray3(), _force_roll=True))
    s = ins.create_stepper(ins.LMWray3(), setup=jset, psolver=ins.psolver_spectral(jset),
                           u=jnp.asarray(u0))
    s = s._replace(u=jax_strip_ghosts(s.u))
    for _ in range(nsteps):
        s = step(s, jnp.asarray(dt), None)
    return np.asarray(s.u)


def test_lmwray3_hat_chain_matches_jax_roll_twin():
    """3 LMWray3 steps of the hat carry, and of the per-step chain that
    materialises u every step, == the JAX roll twin, 16³."""
    jset, tset = _setups(16)
    u0 = _u0(16)
    ref = _jax_roll_steps(jset, u0, 1e-2, 3)
    method = it.LMWray3()
    assert hat_chain_applicable(tset, method)
    to_hat, step_hat, from_hat = make_fast_timestep_hat(tset, method)
    s = it.create_stepper(method, setup=tset, u=strip_ghosts(_t(u0)))
    h = to_hat(s)
    for _ in range(3):
        h = step_hat(h, 1e-2)
    assert h.n == 3 and h.t == pytest.approx(3e-2)
    assert _rel(from_hat(h).u.numpy(), ref) < TOL_REL
    step = make_fast_timestep(tset, method)
    for _ in range(3):
        s = step(s, 1e-2)
    assert _rel(s.u.numpy(), ref) < TOL_REL


def test_lmwray3_temperature_hat_chain_matches_jax_fused_interpret_chain():
    """The LMWray3 hat carry with temperature (dissipation on, gdir 1) ==
    the JAX package's fused chain with every Pallas kernel in interpret
    mode, 3 steps at 8³."""
    n = 8
    x = (np.linspace(0.0, 1.0, n + 1),) * 3
    sets = []
    for pkg, dtype, kw in ((ins, jnp.float64, {}), (it, torch.float64, dict(device="cpu"))):
        bc = ((pkg.PeriodicBC(), pkg.PeriodicBC()),) * 3
        te = pkg.temperature_equation(Pr=0.71, Ra=1e5, Ge=0.4, boundary_conditions=bc, gdir=1,
                                      dodissipation=True, dtype=dtype)
        sets.append(pkg.Setup(x=x, boundary_conditions=bc, Re=500.0, temperature=te,
                              dtype=dtype, **kw))
    jset, tset = sets
    rng = np.random.default_rng(1)
    u, T = 0.1 * rng.standard_normal((3, n, n, n)), 0.5 + 0.1 * rng.standard_normal((n,) * 3)
    to_hat, step_hat, from_hat = jax_make_fast_timestep_hat(
        jset, ins.LMWray3(), projection_precision="highest", _fused_interpret=True)

    # one step compiled once and called three times (an unrolled jit of
    # three steps compiles the interpreted kernels three times over)
    step = jax.jit(lambda h: step_hat(h, 1e-3, None))
    h = jax.jit(to_hat)(JaxStepperState(u=jnp.asarray(u), temp=jnp.asarray(T),
                                        t=jnp.float64(0.0), n=0))
    for _ in range(3):
        h = step(h)
    ref = jax.jit(from_hat)(h)
    th, sh, fh = make_fast_timestep_hat(tset, it.LMWray3())
    h = th(it.create_stepper(it.LMWray3(), setup=tset, u=_t(u), temp=_t(T)))
    for _ in range(3):
        h = sh(h, 1e-3)
    got = fh(h)
    assert _abs(got.u.numpy(), ref.u) < TOL_CHAIN
    assert _abs(got.temp.numpy(), ref.temp) < TOL_CHAIN


@pytest.mark.parametrize("case", ["2d", "3d_noncube"])
def test_lmwray3_roll_twin_matches_jax(case):
    if case == "2d":
        jset, tset = _setups(32, 2)
        u0 = _u0(32, 2, kp=2)
    else:
        x = (np.linspace(0, 2 * np.pi, 9), np.linspace(0, 2 * np.pi, 9),
             np.linspace(0, np.pi, 5))
        jset = ins.Setup(x=x, Re=1e3, dtype=jnp.float64)
        tset = it.Setup(device="cpu", x=x, Re=1e3, dtype=torch.float64)
        u0 = np.array(jax.jit(lambda k: ins.random_field(jset, kp=2, rng=k))(
            jax.random.PRNGKey(0)))
    ref = _jax_roll_steps(jset, u0, 1e-2, 2)
    assert not hat_chain_applicable(tset, it.LMWray3())
    assert make_fast_timestep_hat(tset, it.LMWray3()) is None
    step = make_fast_timestep(tset, it.LMWray3())
    s = it.create_stepper(it.LMWray3(), setup=tset, u=strip_ghosts(_t(u0)))
    for _ in range(2):
        s = step(s, 1e-2)
    assert _rel(s.u.numpy(), ref) < TOL_REL


def test_lmwray3_per_op_chain_equals_hat_chain():
    """The differentiable per-op chain steps the same LMWray3 as the hat
    chain (no closure)."""
    _, tset = _setups(8)
    u = strip_ghosts(_t(_u0(8, kp=2)))
    s = it.create_stepper(it.LMWray3(), setup=tset, u=u)
    a = make_fast_timestep(tset, it.LMWray3())(s, 1e-2)
    b = make_fast_timestep(tset, it.LMWray3(), differentiable=True)(s, 1e-2)
    assert a.n == b.n == 1 and b.t == pytest.approx(1e-2)
    assert _rel(b.u.numpy(), a.u.numpy()) < 1e-12


def test_solve_unsteady_lmwray3_matches_jax():
    """`solve_unsteady(method=LMWray3())` on the fast path == the JAX
    package's, chunked by processors; energy does not grow."""
    jset, tset = _setups(16)
    u0 = _u0(16)
    kw = dict(tlims=(0.0, 0.04), dt=1e-2)
    ref, _ = ins.solve_unsteady(setup=jset, ustart=jnp.asarray(u0), method=ins.LMWray3(), **kw)
    launches.reset_counts()
    got, outs = it.solve_unsteady(
        setup=tset, ustart=_t(u0), method=it.LMWray3(), **kw,
        processors={"e": it.observefield(lambda s: it.total_kinetic_energy(s["u"], tset),
                                         nupdate=2)},
    )
    assert not any(launches.LAUNCHES.values())  # CPU: plain versions only
    assert got.n == 4 and got.t == pytest.approx(0.04) and got.temp is None
    assert _rel(got.u.numpy(), ref.u) < TOL_REL
    e0 = float(it.total_kinetic_energy(_t(u0), tset))
    assert outs["e"][1] <= outs["e"][0] <= e0


def test_lmwray3_on_the_channel_raises():
    """The channel path steps classic-row explicit RK only, as in the JAX
    package (`channelpath_applicable`); LMWray3 there steps the general
    ghosted path, held against the JAX solver (which does the same)."""
    x = (np.linspace(0, 1, 5), np.linspace(0, 1, 5), it.tanh_grid(0.0, 1.0, 4))
    wall = it.DirichletBC()
    s = it.Setup(x=x, device="cpu", dtype=torch.float64,
                 boundary_conditions=((it.PeriodicBC(), it.PeriodicBC()),
                                      (it.PeriodicBC(), it.PeriodicBC()), (wall, wall)))
    js = ins.Setup(x=x, dtype=jnp.float64,
                   boundary_conditions=((ins.PeriodicBC(), ins.PeriodicBC()),
                                        (ins.PeriodicBC(), ins.PeriodicBC()),
                                        (ins.DirichletBC(), ins.DirichletBC())))
    ju0 = ins.velocityfield(js, lambda d, x, y, z: jnp.sin(2 * np.pi * (x + d * y)) * z * (1 - z))
    tu0 = it.velocityfield(s, lambda d, x, y, z: torch.sin(2 * np.pi * (x + d * y)) * z * (1 - z))
    assert _rel(tu0.numpy(), ju0) < TOL_REL
    jst, _ = ins.solve_unsteady(setup=js, ustart=ju0, tlims=(0.0, 0.02), dt=1e-2,
                                method=ins.LMWray3())
    st, _ = it.solve_unsteady(setup=s, ustart=tu0, tlims=(0.0, 0.02), dt=1e-2,
                              method=it.LMWray3())
    assert st.n == 2 and _rel(st.u.numpy(), jst.u) < TOL_REL
