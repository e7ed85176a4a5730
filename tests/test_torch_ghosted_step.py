"""The port's general ghosted stepper and `solve_unsteady`'s general
branch against the JAX package (CPU, f64).

`timestep` for RK44 and LMWray3, with the temperature (a time-dependent
Dirichlet inflow, a pressure outflow, symmetric and Dirichlet
temperature walls, a steady body force) and with the ghosted Smagorinsky
closure, three steps from the same ghosted state; then `solve_unsteady`
through the general branch from `velocityfield`'s initial field (held
too) on a 12³ lid-driven cavity with FDM-preconditioned CG, a 2-D
backward-facing step (pressure outflow) and an 8³ Rayleigh-Taylor box
(all-symmetric temperature walls).  Both sides are f64 and differ in
summation order only: 1e-9 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ins_tpu as ins

import ins_tpu_torch as it
from ins_tpu_torch.ops import launches

TOL = 1e-9


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


def _methods(name):
    if name == "lmwray3":
        return ins.LMWray3(), it.LMWray3()
    return ins.RKMethods.RK44(), it.RKMethods.RK44()


# --------------------------------------------------------------------------
# timestep
# --------------------------------------------------------------------------


def _inflow(xp):
    def u(alpha, x, y, t):
        return (alpha == 0) * (1 + 0.5 * xp.sin(3 * t)) * y * (1 - y) + 0 * x
    return u


def _channel_2d(pk, xp, dtype):
    """2-D: a time-dependent inflow and a pressure outflow in x, a
    symmetric bottom and a moving top wall in y; temperature with a
    Dirichlet wall, a symmetric one and the outflow; a steady force."""
    kw = dict(device="cpu") if pk is it else {}
    te = pk.temperature_equation(
        Pr=0.71, Ra=1e5, Ge=1.0, gdir=1, dtype=dtype,
        boundary_conditions=((pk.DirichletBC(0.5), pk.PressureBC()),
                             (pk.SymmetricBC(), pk.DirichletBC(0.0))))
    x = (ins.stretched_grid(0.0, 2.0, 12, 1.05), ins.cosine_grid(0.0, 1.0, 9))
    bc = ((pk.DirichletBC(_inflow(xp)), pk.PressureBC()),
          (pk.SymmetricBC(), pk.DirichletBC((0.2, 0.0))))
    return pk.Setup(x=x, boundary_conditions=bc, Re=200.0, temperature=te,
                    bodyforce=lambda dim, x, y, t: (dim == 1) * 0.3 * xp.sin(np.pi * x),
                    dtype=dtype, **kw)


def _les_3d(pk, dtype):
    """3-D: periodic x, no-slip y, a lid in z, stretched, with the ghosted
    natural-form Smagorinsky closure."""
    kw = dict(device="cpu") if pk is it else {}
    x = (np.linspace(0.0, 1.0, 7), ins.tanh_grid(0.0, 1.0, 6, 1.2), ins.cosine_grid(0.0, 1.0, 6))
    d = pk.DirichletBC()
    bc = ((pk.PeriodicBC(), pk.PeriodicBC()), (d, d), (d, pk.DirichletBC((1.0, 0.0, 0.0))))
    s = pk.Setup(x=x, boundary_conditions=bc, Re=1e3, dtype=dtype, **kw)
    return pk.Setup(x=x, boundary_conditions=bc, Re=1e3, dtype=dtype,
                    closure_model=pk.smagorinsky_closure_natural(s), **kw)


@pytest.mark.parametrize("method", ["rk44", "lmwray3"])
@pytest.mark.parametrize("case", ["temperature", "smagorinsky"])
def test_timestep_matches_jax(case, method):
    """Three ghosted steps from the same state against the JAX `timestep`."""
    jm, tm = _methods(method)
    rng = np.random.default_rng(1)
    if case == "temperature":
        js, ts = _channel_2d(ins, jnp, jnp.float64), _channel_2d(it, torch, torch.float64)
        jp, tp = ins.psolver_fdm(js), it.psolver_fdm(ts)
        T0 = rng.standard_normal(js.grid.N)
        theta = None
    else:
        js, ts = _les_3d(ins, jnp.float64), _les_3d(it, torch.float64)
        jp, tp = ins.psolver_fdm(js), it.psolver_fdm(ts)
        T0 = None
        theta = 0.17
    u0 = rng.standard_normal((js.grid.dim, *js.grid.N))
    u0 = np.asarray(jax.jit(lambda a: ins.project(ins.apply_bc_u(a, jnp.asarray(0.0), js), js,
                                                  psolver=jp))(jnp.asarray(u0)))
    jstep = jax.jit(lambda s: ins.timestep(jm, s, jnp.asarray(0.01), setup=js, psolver=jp,
                                           theta=theta))
    sj = ins.create_stepper(jm, setup=js, psolver=jp, u=jnp.asarray(u0),
                            temp=None if T0 is None else jnp.asarray(T0), t=0.0)
    st = it.create_stepper(tm, setup=ts, u=_t(u0), temp=None if T0 is None else _t(T0), t=0.0)
    u_first, u_in = st.u, st.u.clone()
    for _ in range(3):
        sj = jstep(sj)
        st = it.timestep(tm, st, 0.01, setup=ts, psolver=tp, theta=theta)
    assert torch.equal(u_first, u_in)  # the input state was not written
    assert st.n == 3 and st.t == pytest.approx(float(sj.t))
    assert _rel(st.u, sj.u) <= TOL
    if T0 is not None:
        assert _rel(st.temp, sj.temp) <= TOL


def test_timestep_leaves_its_input_unchanged():
    """A step builds a new state: the caller's tensors stay as they were."""
    ts = _channel_2d(it, torch, torch.float64)
    u = it.velocityfield(ts, lambda d, x, y: (d == 0) * y * (1 - y) + 0 * x)
    T = torch.ones(ts.grid.N, dtype=torch.float64)
    u_before, T_before = u.clone(), T.clone()
    s = it.timestep(it.RKMethods.RK44(), it.create_stepper(it.RKMethods.RK44(), setup=ts, u=u,
                                                           temp=T), 0.01,
                    setup=ts, psolver=it.psolver_fdm(ts))
    assert torch.equal(u, u_before) and torch.equal(T, T_before)
    assert s.u is not u


# --------------------------------------------------------------------------
# solve_unsteady's general branch
# --------------------------------------------------------------------------


def _cavity(pk, n=12):
    kw = dict(device="cpu") if pk is it else {}
    dtype = torch.float64 if pk is it else jnp.float64
    x = tuple(np.linspace(0.0, 1.0, n + 1) for _ in range(3))
    d = pk.DirichletBC()
    bc = ((d, d), (d, d), (d, pk.DirichletBC((1.0, 0.0, 0.0))))
    s = pk.Setup(x=x, boundary_conditions=bc, Re=1e3, dtype=dtype, **kw)
    return s, pk.psolver_cg(s, maxiter=8, reltol=1e-4, precond="fdm"), None, (0.0, 0.02), 5e-3


def _bfs(pk):
    """`examples/backward_facing_step_2d.py` cut to 24 × 8."""
    kw = dict(device="cpu") if pk is it else {}
    xp, dtype = (torch, torch.float64) if pk is it else (jnp, jnp.float64)

    def U(dim, x, y, t):
        return xp.where((dim == 0) & (y >= 0), 24 * y * (0.5 - y), 0.0)

    bc = ((pk.DirichletBC(U), pk.PressureBC()), (pk.DirichletBC(), pk.DirichletBC()))
    x = (np.linspace(0.0, 10.0, 25), ins.cosine_grid(-0.5, 0.5, 8))
    s = pk.Setup(x=x, Re=3e3, boundary_conditions=bc, dtype=dtype, **kw)
    return s, pk.default_psolver(s), lambda d, x, y: U(d, x, y, 0.0), (0.0, 0.02), 2e-3


def _rayleigh_taylor(pk, n=8):
    """`examples/rayleigh_taylor_3d.py` at its quick size (8 × 8 × 16)."""
    kw = dict(device="cpu") if pk is it else {}
    dtype = torch.float64 if pk is it else jnp.float64
    x = (ins.tanh_grid(0.0, 1.0, n, 1.3), ins.tanh_grid(0.0, 1.0, n, 1.3),
         ins.tanh_grid(0.0, 2.0, 2 * n, 1.3))
    te = pk.temperature_equation(Pr=0.71, Ra=1e6, Ge=1.0, dodissipation=True, gdir=2,
                                 boundary_conditions=((pk.SymmetricBC(), pk.SymmetricBC()),) * 3,
                                 dtype=dtype)
    d = pk.DirichletBC()
    s = pk.Setup(x=x, boundary_conditions=((d, d),) * 3, temperature=te, dtype=dtype, **kw)
    return s, pk.default_psolver(s), None, (0.0, 0.02), 5e-3


def _rt_temp(xp):
    return lambda x, y, z: 1.0 / (1 + xp.exp(40 * (z - 1 - (xp.sin(np.pi * x) + xp.sin(np.pi * y)) / 10)))


@pytest.mark.parametrize("case", ["cavity", "bfs", "rayleigh_taylor"])
def test_solve_unsteady_general_branch_matches_jax(case):
    """`velocityfield` (and `temperaturefield`) then `solve_unsteady`
    through the general branch, processors between chunks, against the
    JAX package's solver; no kernel runs."""
    make = {"cavity": _cavity, "bfs": _bfs, "rayleigh_taylor": _rayleigh_taylor}[case]
    js, jp, uf, tlims, dt = make(ins)
    ts, tp, _, _, _ = make(it)
    D = js.grid.dim
    if uf is None:
        def uf(d, *x):
            return 0.0 * x[0]
    if case == "bfs":
        _, _, tuf, _, _ = _bfs(it)
    else:
        tuf = uf
    ju0 = jax.jit(lambda: ins.velocityfield(js, uf, psolver=jp))()
    tu0 = it.velocityfield(ts, tuf, psolver=tp)
    assert _rel(tu0, ju0) <= TOL
    jT0 = tT0 = None
    if case == "rayleigh_taylor":
        jT0 = jax.jit(lambda: ins.temperaturefield(js, _rt_temp(jnp)))()
        tT0 = it.temperaturefield(ts, _rt_temp(torch))
        assert _rel(tT0, jT0) <= TOL
    jst, jout = ins.solve_unsteady(setup=js, ustart=ju0, tempstart=jT0, tlims=tlims, dt=dt,
                                   psolver=jp, processors={"ke": ins.observefield(
                                       lambda s: ins.total_kinetic_energy(s["u"], js), nupdate=2)})
    launches.reset_counts()
    tst, tout = it.solve_unsteady(setup=ts, ustart=tu0, tempstart=tT0, tlims=tlims, dt=dt,
                                  psolver=tp, processors={"ke": it.observefield(
                                      lambda s: it.total_kinetic_energy(s["u"], ts), nupdate=2)})
    assert not any(launches.LAUNCHES.values())
    assert tst.n == int(round((tlims[1] - tlims[0]) / dt)) == int(jst.n)
    assert tst.u.shape == (D, *js.grid.N)
    assert _rel(tst.u, jst.u) <= TOL
    if tT0 is not None:
        assert _rel(tst.temp, jst.temp) <= TOL
    assert np.allclose(np.asarray(tout["ke"]), np.asarray(jout["ke"]), rtol=TOL, atol=0)
    assert float(np.asarray(jst.u).__abs__().max()) > 0
