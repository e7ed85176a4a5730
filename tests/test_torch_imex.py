"""The port's IMEX and implicit Runge-Kutta steppers against the JAX
package (CPU, f64).

AB-CN and one-leg, with the RK44 startup step (and the pressure
re-solved each step) and with the first-order startup (and the pressure
updated by the correction), three steps through `solve_unsteady`'s
general branch from the same ghosted state on a 2-D inflow/outflow
channel (a time-dependent Dirichlet inflow, a pressure outflow, a
symmetric bottom, a moving top wall, a steady body force, stretched and
cosine grids), each case with another of `psolver_fdm`,
`psolver_cg_matrix`, `psolver_direct` and `psolver_cg`; every field of
the state is held, and the state crosses between the packages
(`convert`): a step from JAX's carried over equals one from the port's.
The implicit RK stepper: BE11 by Picard iteration, two steps through
`solve_unsteady` on a 2-D lid-driven cavity; one step of GL1 by full
Newton-Krylov and of SDIRK34 by the approximate Newton (stopped at two
Newton iterations) on a 4² periodic box.  `_gmres` on a fixed matrix,
also where the Krylov space closes after three vectors (a zero row in
the Hessenberg matrix: the minimum-norm least squares); the Newton
matvec's forward-mode derivative of the momentum and its fills against
`jax.jvp` for each BC family.  Both sides are f64 and differ in
summation order only: 1e-9 relative (the Newton loops stop on a
residual of 50 eps, so their iterates agree as closely).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ins_tpu as ins
from ins_tpu.time_steppers import methods as jmethods
from ins_tpu.time_steppers.implicit_rk import _gmres as jax_gmres

import ins_tpu_torch as it
from ins_tpu_torch import convert
from ins_tpu_torch.time_steppers import methods as tmethods
from ins_tpu_torch.time_steppers.implicit_rk import _gmres, _jvp, momentum_bc

TOL = 1e-9
DT = 0.01


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


def _pk(pk):
    return (dict(device="cpu"), torch, torch.float64) if pk is it else ({}, jnp, jnp.float64)


def _channel(pk):
    """Inflow u = (1 + sin(3t)/2) y (1 - y) and a pressure outflow in x, a
    symmetric bottom and a moving top wall in y, a steady force."""
    kw, xp, dtype = _pk(pk)

    def inflow(alpha, x, y, t):
        return (alpha == 0) * (1 + 0.5 * xp.sin(3 * t)) * y * (1 - y) + 0 * x

    x = (ins.stretched_grid(0.0, 2.0, 10, 1.05), ins.cosine_grid(0.0, 1.0, 7))
    bc = ((pk.DirichletBC(inflow), pk.PressureBC()),
          (pk.SymmetricBC(), pk.DirichletBC((0.2, 0.0))))
    return pk.Setup(x=x, boundary_conditions=bc, Re=100.0, dtype=dtype,
                    bodyforce=lambda dim, x, y, t: (dim == 1) * 0.3 * xp.sin(np.pi * x), **kw)


def _cavity(pk, n=8):
    kw, _, dtype = _pk(pk)
    x = (np.linspace(0.0, 1.0, n + 1), np.linspace(0.0, 1.0, n + 1))
    d = pk.DirichletBC()
    return pk.Setup(x=x, boundary_conditions=((d, d), (d, pk.DirichletBC((1.0, 0.0)))), Re=100.0,
                    dtype=dtype, **kw)


def _start(js, jp, seed):
    """A projected, ghost-filled random start (numpy)."""
    u0 = np.random.default_rng(seed).standard_normal((js.grid.dim, *js.grid.N))
    return np.asarray(jax.jit(lambda a: ins.project(ins.apply_bc_u(a, jnp.asarray(0.0), js), js,
                                                    psolver=jp))(jnp.asarray(u0)))


IMEX = {
    "abcn": (jmethods.AdamsBashforthCrankNicolsonMethod,
             tmethods.AdamsBashforthCrankNicolsonMethod),
    "oneleg": (jmethods.OneLegMethod, tmethods.OneLegMethod),
}


def _psolver(pk, name, setup):
    if name == "cg_matrix":
        return pk.psolver_cg_matrix(setup, reltol=1e-12)
    if name == "cg":
        return pk.psolver_cg(setup, reltol=1e-12, precond="fdm")
    return getattr(pk, f"psolver_{name}")(setup)


def _solve_both(jm, tm, js, ts, jp, tp, u0, nsteps):
    """`solve_unsteady` of both packages through the general branch, the
    kinetic energy observed between chunks: the final states."""
    kw = dict(tlims=(0.0, nsteps * DT), dt=DT)
    jst, jout = ins.solve_unsteady(setup=js, ustart=jnp.asarray(u0), psolver=jp, method=jm,
                                   processors={"ke": ins.observefield(
                                       lambda s: ins.total_kinetic_energy(s["u"], js))}, **kw)
    u_in = _t(u0)
    tst, tout = it.solve_unsteady(setup=ts, ustart=u_in, psolver=tp, method=tm,
                                  processors={"ke": it.observefield(
                                      lambda s: it.total_kinetic_energy(s["u"], ts))}, **kw)
    assert torch.equal(u_in, _t(u0))  # the run did not write its input
    assert tst.n == nsteps == int(jst.n) and tst.t == pytest.approx(float(jst.t))
    assert type(tst).__name__ == type(jst).__name__ and tst._fields == jst._fields
    assert np.allclose(np.asarray(tout["ke"]), np.asarray(jout["ke"]), rtol=TOL, atol=0)
    return jst, tst


IMEX_CASES = {"abcn-rk44-fdm": ("abcn", "rk44", "fdm"),
              "abcn-first_order-cg_matrix": ("abcn", "first_order", "cg_matrix"),
              "oneleg-rk44-direct": ("oneleg", "rk44", "direct"),
              "oneleg-first_order-cg": ("oneleg", "first_order", "cg")}


@pytest.mark.parametrize("case", list(IMEX_CASES))
def test_imex_solve_unsteady_matches_jax(case):
    """Three steps through `solve_unsteady`, each case with another of
    the four ghosted solvers; with ``method_startup=False`` the pressure
    is updated by the correction (``p_add_solve=False``), else re-solved.
    Every field of the final state is held."""
    name, startup, sname = IMEX_CASES[case]
    kw = {} if startup == "rk44" else dict(method_startup=False, p_add_solve=False)
    jm, tm = (cls(**kw) for cls in IMEX[name])
    js, ts = _channel(ins), _channel(it)
    jst, tst = _solve_both(jm, tm, js, ts, _psolver(ins, sname, js), _psolver(it, sname, ts),
                           _start(js, ins.psolver_fdm(js), 2), 3)
    assert tst.temp is None
    for f in tst._fields:
        if f not in ("temp", "t", "n"):
            assert _rel(getattr(tst, f), getattr(jst, f)) <= TOL, f
    # the history crosses between the packages: one more step from JAX's
    # state carried over equals one from the port's own
    carried = convert.state_from_numpy(jst, dtype=torch.float64, device="cpu")
    assert type(carried) is type(tst) and carried.n == tst.n
    assert type(jst)(**convert.state_to_numpy(tst))._fields == jst._fields
    with torch.no_grad():
        a = it.timestep(tm, carried, DT, setup=ts, psolver=_psolver(it, sname, ts))
        b = it.timestep(tm, tst, DT, setup=ts, psolver=_psolver(it, sname, ts))
    assert _rel(a.u, b.u) <= TOL


def test_implicit_rk_picard_solve_unsteady_matches_jax():
    """BE11 by Picard iteration, two steps through `solve_unsteady` on the
    lid-driven cavity."""
    js, ts = _cavity(ins), _cavity(it)
    u0 = _start(js, ins.psolver_fdm(js), 5)
    jst, tst = _solve_both(ins.RKMethods.BE11(newton_type="picard"),
                           it.RKMethods.BE11(newton_type="picard"), js, ts, ins.psolver_fdm(js),
                           it.psolver_fdm(ts), u0, 2)
    assert _rel(tst.u, jst.u) <= TOL
    assert _rel(tst.u, u0) > 1e-3  # the steps moved the field


def _periodic(pk):
    kw, _, dtype = _pk(pk)
    return pk.Setup(x=(np.linspace(0.0, 1.0, 5),) * 2, Re=10.0, dtype=dtype, **kw)


NEWTON = {"GL1-full": ("GL1", dict(newton_type="full"), 1),
          "SDIRK34-approximate": ("SDIRK34", dict(newton_type="approximate", maxiter=2), 1)}


@pytest.mark.parametrize("case", list(NEWTON))
def test_implicit_rk_newton_steps_match_jax(case):
    """One `timestep` of GL1 by full Newton-Krylov and of SDIRK34 by the
    approximate Newton (the Jacobian at u_0), stopped at two Newton
    iterations (``maxiter``), on a 4² periodic box with the spectral
    solve."""
    name, kw, nsteps = NEWTON[case]
    jm, tm = getattr(ins.RKMethods, name)(**kw), getattr(it.RKMethods, name)(**kw)
    js, ts = _periodic(ins), _periodic(it)
    jp, tp = ins.psolver_spectral(js), it.psolver_spectral(ts)
    xx, yy = np.meshgrid(ts.grid.xp[0], ts.grid.xp[1], indexing="ij")
    u0 = np.stack([np.sin(2 * np.pi * yy), np.cos(2 * np.pi * xx) + 0.3 * np.sin(2 * np.pi * yy)])
    u0 = np.asarray(jax.jit(lambda a: ins.project(a, js, psolver=jp))(jnp.asarray(u0)))
    sj = ins.create_stepper(jm, setup=js, psolver=jp, u=jnp.asarray(u0))
    st = it.create_stepper(tm, setup=ts, psolver=tp, u=_t(u0))
    step = jax.jit(lambda s: ins.timestep(jm, s, 0.05, setup=js, psolver=jp))
    for _ in range(nsteps):
        sj = step(sj)
        with torch.no_grad():
            st = it.timestep(tm, st, 0.05, setup=ts, psolver=tp)
    assert st.n == nsteps and st.t == pytest.approx(float(sj.t))
    assert _rel(st.u, sj.u) <= TOL
    assert _rel(st.u, u0) > 1e-3  # the steps moved the field


def _fixed_matvec(n, seed):
    rng = np.random.default_rng(seed)
    M = np.eye(n) + 0.3 * rng.standard_normal((n, n)) / np.sqrt(n)
    return M, rng.standard_normal(n)


@pytest.mark.parametrize("kind", ["dense", "breakdown"])
def test_gmres_matches_jax(kind):
    """GMRES(12), one cycle: on a nonsymmetric 40 x 40 matrix against
    JAX's `_gmres`; on a diagonal one with three distinct eigenvalues and
    a right-hand side in their span (the Krylov space closes at three
    vectors) against JAX's and the exact solution."""
    if kind == "dense":
        M, b = _fixed_matvec(40, 7)
    else:
        d = np.repeat([1.0, 2.5, 4.0], [10, 15, 15])
        M = np.diag(d)
        b = np.random.default_rng(8).standard_normal(40)
    ref = np.asarray(jax_gmres(lambda x: jnp.asarray(M) @ x, jnp.asarray(b), m=12, cycles=1))
    got = _gmres(lambda x: _t(M) @ x, _t(b), m=12, cycles=1).numpy()
    assert _rel(got, ref) <= TOL
    if kind == "breakdown":
        np.testing.assert_allclose(got, b / np.diag(M), rtol=1e-10, atol=0)
    else:
        # one cycle of 12 on a matrix with spread eigenvalues: a good but
        # inexact solve, the same one as JAX's
        assert np.linalg.norm(M @ got - b) < 1e-3 * np.linalg.norm(b)


def _family(pk, family):
    """2-D setups, one per BC family, each with a lid or an inflow that
    depends on t where the family allows (the ``dudt`` fill)."""
    kw, xp, dtype = _pk(pk)
    x = (ins.stretched_grid(0.0, 1.0, 8, 1.1), ins.cosine_grid(0.0, 1.0, 7))
    per = (pk.PeriodicBC(), pk.PeriodicBC())

    def lid(alpha, x, y, t):
        return (alpha == 0) * xp.sin(2 * t + 0.5) * x * (1 - x) + 0 * y

    if family == "periodic":
        x = (np.linspace(0.0, 1.0, 9), np.linspace(0.0, 1.0, 8))
        bc = (per, per)
    elif family == "dirichlet":
        bc = ((pk.DirichletBC(), pk.DirichletBC()), (pk.DirichletBC(), pk.DirichletBC(lid)))
    elif family == "symmetric":
        bc = (per, (pk.SymmetricBC(), pk.SymmetricBC()))
        x = (np.linspace(0.0, 1.0, 9), x[1])
    else:
        bc = ((pk.DirichletBC(lid), pk.PressureBC()), (pk.PressureBC(), pk.DirichletBC()))
    return pk.Setup(x=x, boundary_conditions=bc, Re=50.0, dtype=dtype, **kw)


@pytest.mark.parametrize("family", ["periodic", "dirichlet", "symmetric", "pressure"])
def test_newton_jvp_matches_jax(family):
    """The forward-mode derivative of F o BC (momentum, ghost fills with
    the Dirichlet values' time derivative) against `jax.jvp` of the JAX
    package's, at f64: primal and tangent."""
    js, ts = _family(ins, family), _family(it, family)
    rng = np.random.default_rng(13)
    u, v = (rng.standard_normal((2, *js.grid.N)) for _ in range(2))
    t = 0.37

    def jf(w):
        tt = jnp.asarray(t)
        F = ins.momentum(ins.apply_bc_u(w, tt, js), None, tt, js)
        return ins.apply_bc_u(F, tt, js, dudt=True)

    jprimal, jtangent = jax.jit(lambda a, b: jax.jvp(jf, (a,), (b,)))(jnp.asarray(u),
                                                                      jnp.asarray(v))
    tangent = _jvp(lambda w: momentum_bc(w, t, ts), _t(u), _t(v))
    assert _rel(momentum_bc(_t(u), t, ts), jprimal) <= TOL
    assert _rel(tangent, jtangent) <= TOL
    assert float(np.max(np.abs(np.asarray(jtangent)))) > 0
