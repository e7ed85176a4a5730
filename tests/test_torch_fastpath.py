"""The port's fast path and solver against the JAX package (CPU, f64).

On CPU tensors the hat chain runs the four kernels' plain versions, so
these tests hold the port's chain arithmetic — the RECON merge, the
b-row accumulator, the deferred correction — against the JAX package's
roll-graph twin, which is the reference the Pallas chain is itself
tested against.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ins_tpu as ins
from ins_tpu.ops.fastpath import make_fast_timestep as jax_make_fast_timestep
from ins_tpu.ops.fastpath import strip_ghosts as jax_strip_ghosts
from ins_tpu.ops.operators import total_kinetic_energy as jax_total_kinetic_energy

import ins_tpu_torch as it
from ins_tpu_torch.ops import launches
from ins_tpu_torch.ops.fastpath import (
    HatState,
    hat_chain_applicable,
    make_fast_timestep,
    make_fast_timestep_hat,
    reghost,
    strip_ghosts,
)

# Both sides in f64; the hat chain's eigen-transforms and the JAX FFT
# projection agree to ~1e-14 per step, so 1e-9 over a few steps is the
# issue's bound with a wide margin.
TOL = 1e-9


def _x(n, D):
    return (np.linspace(0, 2 * np.pi, n + 1),) * D


def _setups(n, D, Re=1e3):
    jset = ins.Setup(x=_x(n, D), Re=Re, dtype=jnp.float64)
    tset = it.Setup(device="cpu", x=_x(n, D), Re=Re, dtype=torch.float64)
    return jset, tset


def _u0(jset, kp=4):
    return _cached_u0(jset.grid.xlims, jset.grid.N, kp).copy()


@functools.lru_cache(maxsize=None)
def _cached_u0(xlims, N, kp):
    x = tuple(np.linspace(a, b, n - 1) for (a, b), n in zip(xlims, N))
    jset = ins.Setup(x=x, dtype=jnp.float64)
    field = jax.jit(lambda key: ins.random_field(jset, kp=kp, rng=key))
    return np.array(field(jax.random.PRNGKey(0)))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _jax_steps(jset, method, u0, dt, nsteps):
    step = jax.jit(jax_make_fast_timestep(jset, method, _force_roll=True))
    s = ins.create_stepper(
        method, setup=jset, psolver=ins.psolver_spectral(jset), u=jnp.asarray(u0)
    )
    s = s._replace(u=jax_strip_ghosts(s.u))
    for _ in range(nsteps):
        s = step(s, jnp.asarray(dt), None)
    return np.asarray(s.u)


def test_hat_chain_matches_jax_roll_twin():
    """3 RK44 steps of the hat carry (and of the per-step chain that
    materialises u every step) == the JAX roll twin, 16³ f64."""
    jset, tset = _setups(16, 3)
    method_j, method_t = ins.RKMethods.RK44(), it.RKMethods.RK44()
    u0 = _u0(jset)
    dt = 1e-2
    ref = _jax_steps(jset, method_j, u0, dt, 3)

    assert hat_chain_applicable(tset, method_t)
    to_hat, step_hat, from_hat = make_fast_timestep_hat(tset, method_t)
    s = it.create_stepper(method_t, setup=tset, u=strip_ghosts(torch.from_numpy(u0)))
    h = to_hat(s)
    for _ in range(3):
        h = step_hat(h, dt)
    assert h.n == 3 and h.t == pytest.approx(3 * dt)
    assert _rel(from_hat(h).u.numpy(), ref) < TOL

    step = make_fast_timestep(tset, method_t)
    for _ in range(3):
        s = step(s, dt)
    assert _rel(s.u.numpy(), ref) < TOL


def test_solve_unsteady_matches_jax():
    """`solve_unsteady` on the same u0 (as tests/test_fastpath.py does for
    the JAX fast path), with processors splitting the run into chunks."""
    jset, tset = _setups(16, 3)
    u0 = _u0(jset)
    kw = dict(tlims=(0.0, 0.04), dt=1e-2)
    ref, _ = ins.solve_unsteady(setup=jset, ustart=jnp.asarray(u0), **kw)
    launches.reset_counts()
    got, outs = it.solve_unsteady(
        setup=tset, ustart=torch.from_numpy(u0), **kw,
        processors={"fields": it.fieldsaver(nupdate=2)},
    )
    assert got.u.shape == u0.shape  # public state is re-ghosted
    assert got.n == 4 and got.t == pytest.approx(0.04)
    assert _rel(got.u.numpy(), ref.u) < TOL
    assert [f["t"] for f in outs["fields"]] == pytest.approx([0.02, 0.04])
    assert _rel(outs["fields"][-1]["u"], ref.u) < TOL
    assert not any(launches.LAUNCHES.values())  # CPU: plain versions only


@pytest.mark.parametrize(
    "case", ["2d_rk44", "3d_ssp33", "3d_noncube"],
)
def test_roll_twin_matches_jax(case):
    """Where the hat chain does not apply — 2-D, non-classic tableau rows,
    non-cube boxes — the port steps its roll twin, but a tableau with
    non-classic rows on a cube (``3d_ssp33``), which steps the fused
    unmerged chain (`tests/test_torch_unmerged.py`); on CPU tensors both
    match the JAX roll twin."""
    if case == "2d_rk44":
        jset, tset = _setups(32, 2)
        mj, mt = ins.RKMethods.RK44(), it.RKMethods.RK44()
    elif case == "3d_ssp33":
        jset, tset = _setups(8, 3)
        mj, mt = ins.RKMethods.SSP33(), it.RKMethods.SSP33()
    else:
        x = (np.linspace(0, 2 * np.pi, 9), np.linspace(0, 2 * np.pi, 9),
             np.linspace(0, np.pi, 5))
        jset = ins.Setup(x=x, Re=1e3, dtype=jnp.float64)
        tset = it.Setup(device="cpu", x=x, Re=1e3, dtype=torch.float64)
        mj, mt = ins.RKMethods.RK44(), it.RKMethods.RK44()
    assert not hat_chain_applicable(tset, mt)
    assert make_fast_timestep_hat(tset, mt) is None
    u0 = _u0(jset, kp=2)
    ref = _jax_steps(jset, mj, u0, 1e-2, 2)
    step = make_fast_timestep(tset, mt)
    s = it.create_stepper(mt, setup=tset, u=strip_ghosts(torch.from_numpy(u0)))
    for _ in range(2):
        s = step(s, 1e-2)
    assert _rel(s.u.numpy(), ref) < TOL


def test_hat_recon_stage_equals_materialised_stage():
    """A carry entering with qhat = 0 (the JAX package's `to_hat`) takes
    the pcmsd RECON stage; the port's `qhat=None` carry takes the
    unmerged stage.  Both are the same step."""
    _, tset = _setups(8, 3)
    u0 = strip_ghosts(
        it.random_field(tset, kp=2, generator=torch.Generator().manual_seed(3))
    )
    _, step_hat, from_hat = make_fast_timestep_hat(tset, it.RKMethods.RK44())
    a = step_hat(HatState(ut=u0, qhat=None, temp=None, t=0.0, n=0), 1e-2)
    b = step_hat(HatState(ut=u0, qhat=torch.zeros(u0.shape[1:], dtype=u0.dtype),
                          temp=None, t=0.0, n=0), 1e-2)
    assert _rel(from_hat(a).u.numpy(), from_hat(b).u.numpy()) < 1e-13


def test_plain_chain_equals_wrapper_chain_on_cpu():
    _, tset = _setups(8, 3)
    u0 = strip_ghosts(
        it.random_field(tset, kp=2, generator=torch.Generator().manual_seed(4))
    )
    method = it.RKMethods.RK44()
    outs = []
    for plain in (False, True):
        to_hat, step_hat, from_hat = make_fast_timestep_hat(tset, method, plain=plain)
        h = to_hat(it.create_stepper(method, setup=tset, u=u0))
        for _ in range(2):
            h = step_hat(h, 1e-2)
        outs.append(from_hat(h).u)
    assert torch.equal(*outs)


def test_total_kinetic_energy_matches_jax():
    jset, tset = _setups(16, 3)
    u0 = _u0(jset)
    ref = float(jax_total_kinetic_energy(jnp.asarray(u0), jset))
    got = float(it.total_kinetic_energy(torch.from_numpy(u0), tset))
    assert got == pytest.approx(ref, rel=1e-13)


def test_nan_guard_raises_with_last_finite_state():
    _, tset = _setups(8, 3)
    u0 = it.random_field(tset, kp=2, generator=torch.Generator().manual_seed(5))
    u0[0, 3, 3, 3] = float("nan")
    with pytest.raises(it.SolverDivergedError, match="non-finite") as err:
        it.solve_unsteady(setup=tset, ustart=u0, tlims=(0.0, 0.02), dt=1e-2)
    assert err.value.state["n"] == 0


def test_timelogger_prints_each_chunk(capsys):
    _, tset = _setups(8, 3)
    u0 = it.random_field(tset, kp=2, generator=torch.Generator().manual_seed(6))
    it.solve_unsteady(
        setup=tset, ustart=u0, tlims=(0.0, 0.04), dt=1e-2,
        processors={"log": it.timelogger(nupdate=2)},
    )
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Iteration")]
    assert [ln.split()[1] for ln in lines] == ["2", "4"]


def test_reghost_is_periodic_wrap():
    u = torch.arange(2 * 4 * 5, dtype=torch.float64).reshape(2, 4, 5)
    ref = np.pad(u.numpy(), ((0, 0), (1, 1), (1, 1)), mode="wrap")
    assert np.array_equal(reghost(u).numpy(), ref)
    assert torch.equal(strip_ghosts(reghost(u)), u)


def _general_case(pk, what, u0):
    """(setup, ustart, tempstart, method) of a case the general ghosted
    path steps, in package `pk` (f64)."""
    kw = dict(device="cpu") if pk is it else {}
    dtype = torch.float64 if pk is it else jnp.float64
    arr = (lambda a: torch.from_numpy(np.array(a))) if pk is it else jnp.asarray
    wall = pk.DirichletBC()
    if what == "lmwray3":  # LMWray3 on a channel (the channel path takes classic rows)
        s = pk.Setup(x=(*_x(4, 2), ins.tanh_grid(0, 1, 4)), dtype=dtype,
                     boundary_conditions=((pk.PeriodicBC(), pk.PeriodicBC()),) * 2
                     + ((wall, pk.DirichletBC((1.0, 0.0, 0.0))),), **kw)
        return s, arr(np.zeros((3, 6, 6, 6))), None, pk.LMWray3()
    if what == "tempstart":  # temperature walls on a periodic velocity box
        walls = ((wall, wall),) * 3
        te = pk.temperature_equation(Pr=0.71, Ra=1e6, Ge=1.0, boundary_conditions=walls,
                                     dtype=dtype)
        s = pk.Setup(x=_x(8, 3), temperature=te, dtype=dtype, **kw)
        return s, arr(u0), arr(u0[0]), pk.RKMethods.RK44()
    # stretched wall-bounded 2-D box with a lid
    s = pk.Setup(x=(ins.tanh_grid(0, 1, 8),) * 2, dtype=dtype,
                 boundary_conditions=((wall, wall), (wall, pk.DirichletBC((1.0, 0.0)))), **kw)
    return s, arr(np.zeros((2, 10, 10))), None, pk.RKMethods.RK44()


@pytest.mark.parametrize(
    "what", ["lmwray3", "adaptive", "tempstart", "stretched"],
)
def test_unported_paths_raise(what):
    """What once raised and now runs, held against the JAX solver: adaptive
    dt (the hat chain with the CFL limit every step: the same steps, t
    and u); LMWray3 off the periodic fast path (here a channel),
    temperature with wall BCs and stretched wall-bounded grids step the
    general ghosted path (the JAX solver steps its own there)."""
    jset, tset = _setups(8, 3)
    u0 = it.random_field(tset, kp=2, generator=torch.Generator().manual_seed(7))
    if what == "adaptive":
        ref, _ = ins.solve_unsteady(setup=jset, ustart=jnp.asarray(u0.numpy()), tlims=(0.0, 0.2),
                                    dt=None)
        st, _ = it.solve_unsteady(setup=tset, ustart=u0, tlims=(0.0, 0.2), dt=None)
        assert st.n == int(ref.n) > 1 and abs(float(st.t) - float(ref.t)) < 1e-14
        assert _rel(st.u.numpy(), ref.u) < TOL
        return
    u0 = u0.numpy()
    js, ju, jT, jm = _general_case(ins, what, u0)
    ts, tu, tT, tm = _general_case(it, what, u0)
    jst, _ = ins.solve_unsteady(setup=js, ustart=ju, tempstart=jT, tlims=(0.0, 0.02), dt=1e-2,
                                method=jm)
    launches.reset_counts()
    st, _ = it.solve_unsteady(setup=ts, ustart=tu, tempstart=tT, tlims=(0.0, 0.02), dt=1e-2,
                              method=tm)
    assert not any(launches.LAUNCHES.values())
    assert st.n == 2 and _rel(st.u.numpy(), jst.u) < TOL
    assert float(np.abs(np.asarray(jst.u)).max()) > 0
    if tT is not None:
        assert _rel(st.temp.numpy(), jst.temp) < TOL
