"""The port's general ghosted path, piece by piece, against the JAX
package (CPU, f64).

Inputs are made by numpy from a seed and fed to both packages.  Held at
1e-12 relative: the ghost fills of all four BC families (a time-dependent
Dirichlet value, its time derivative with ``dudt=True``, ``homogeneous``)
and every staggered operator of `ops/operators.py` on small 2-D and 3-D
grids, stretched and uniform; the ghosted Smagorinsky closures; the
processors off periodic grids.  The solvers: `psolver_cg` with the
Jacobi and FDM preconditioners, with and without a `PressureBC`, in
iteration count and result; `psolver_fdm` with a `SymmetricBC`;
`project` divergence-free; `poisson`'s gradient against `jax.vjp`.  And
the invariants of `tests/test_operators.py` on the port, as cases of one
parametrised test.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ins_tpu as ins

import ins_tpu_torch as it
from ins_tpu_torch.ops._stencil import dseg, slc

# the module (`ins_tpu_torch.ops.pressure` is also the name of a function)
torch_pressure = importlib.import_module("ins_tpu_torch.ops.pressure")

TOL = 1e-12
# CG and the FDM solve: the same iterations in another summation order
# (Jacobi CG: ~100 iterations)
TOL_SOLVE = 1e-9


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


# --------------------------------------------------------------------------
# setups: each BC family on some side, stretched and uniform, 2-D and 3-D
# --------------------------------------------------------------------------


def _inflow(xp):
    """A time-dependent Dirichlet velocity (alpha, *x, t)."""
    def u(alpha, *xt):
        *x, t = xt
        return (alpha == 0) * xp.sin(2 * t + 1) * x[1] * (1 - x[1]) + 0.1 * alpha * xp.cos(t) + 0 * x[0]
    return u


def _wall_temp(xp):
    def T(*xt):
        *x, t = xt
        return 1 + 0.5 * xp.sin(3 * x[0] + t)
    return T


def _force(xp):
    def f(dim, *xt):
        return (dim == 0) * 5 * xp.sin(8 * np.pi * xt[1])
    return f


def _make(pk, xp, dtype, case):
    """(setup) of package `pk` for `case`; ``xp`` its array module."""
    kw = dict(device="cpu") if pk is it else {}
    if case == "2d":
        x = (ins.stretched_grid(0.0, 1.0, 10, 1.1), ins.cosine_grid(0.0, 1.0, 9))
        bc = ((pk.DirichletBC(_inflow(xp)), pk.PressureBC()),
              (pk.SymmetricBC(), pk.DirichletBC((0.3, 0.0))))
        tbc = ((pk.DirichletBC(_wall_temp(xp)), pk.PressureBC()),
               (pk.SymmetricBC(), pk.DirichletBC(1.0)))
        gdir = 1
    elif case == "3d":
        x = (np.linspace(0.0, 1.0, 9), ins.tanh_grid(0.0, 1.0, 8, 1.2),
             ins.cosine_grid(0.0, 2.0, 10))
        bc = ((pk.PeriodicBC(), pk.PeriodicBC()), (pk.SymmetricBC(), pk.PressureBC()),
              (pk.DirichletBC(_inflow(xp)), pk.DirichletBC((0.0, 0.2, 0.0))))
        tbc = ((pk.PeriodicBC(), pk.PeriodicBC()), (pk.SymmetricBC(), pk.SymmetricBC()),
               (pk.DirichletBC(_wall_temp(xp)), pk.DirichletBC(0.0)))
        gdir = 2
    else:  # "cavity": the uniform cube, walls and a lid
        x = (np.linspace(0.0, 1.0, 9),) * 3
        d = pk.DirichletBC()
        bc = ((d, d), (d, d), (d, pk.DirichletBC((1.0, 0.0, 0.0))))
        tbc = ((pk.SymmetricBC(), pk.SymmetricBC()),) * 2 + (
            (pk.DirichletBC(1.0), pk.DirichletBC(0.0)),)
        gdir = 2
    te = pk.temperature_equation(Pr=0.71, Ra=1e6, Ge=1.0, boundary_conditions=tbc, gdir=gdir,
                                 dtype=dtype)
    return pk.Setup(x=x, boundary_conditions=bc, Re=500.0, temperature=te,
                    bodyforce=_force(xp), dtype=dtype, **kw)


CASES = ["2d", "3d", "cavity"]
_CACHE = {}


def _pair(case):
    if case not in _CACHE:
        _CACHE[case] = (_make(ins, jnp, jnp.float64, case), _make(it, torch, torch.float64, case))
    return _CACHE[case]


def _fields(case, seed=0):
    js, _ = _pair(case)
    g = js.grid
    rng = np.random.default_rng(seed + 7 * CASES.index(case))
    return rng.standard_normal((g.dim, *g.N)), rng.standard_normal(g.N)


def _filled(case, t=0.3):
    """A ghost-filled velocity and temperature (the JAX fills)."""
    js, _ = _pair(case)
    u, p = _fields(case)
    tj = jnp.asarray(t, jnp.float64)
    return (np.asarray(ins.apply_bc_u(jnp.asarray(u), tj, js)),
            np.asarray(ins.apply_bc_temp(jnp.asarray(p), tj, js)))


# --------------------------------------------------------------------------
# ghost fills
# --------------------------------------------------------------------------


FILLS = ["u", "u_dudt", "u_homogeneous", "p", "temp", "sigma"]


def _sigma(case):
    D = _pair(case)[0].grid.dim
    return np.random.default_rng(3).standard_normal((*_pair(case)[0].grid.N, D, D))


def _jax_fills(case):
    """Every fill of `FILLS` at t = 0.3 from one jitted JAX function."""
    key = ("fills", case)
    if key not in _CACHE:
        js, _ = _pair(case)
        u, p = _fields(case)

        def fills(u, p, sig, t):
            return {"u": ins.apply_bc_u(u, t, js),
                    "u_homogeneous": ins.apply_bc_u(u, t, js, homogeneous=True),
                    "p": ins.apply_bc_p(p, t, js), "temp": ins.apply_bc_temp(p, t, js),
                    "sigma": ins.apply_bc_p(sig, t, js)}

        t = jnp.asarray(0.3, jnp.float64)
        out = jax.jit(fills)(jnp.asarray(u), jnp.asarray(p), jnp.asarray(_sigma(case)), t)
        # eager, as the port evaluates it: the central difference in t
        # amplifies a fused graph's other rounding by 1/h ~ 1e8
        out["u_dudt"] = ins.apply_bc_u(jnp.asarray(u), t, js, dudt=True)
        _CACHE[key] = {k: np.asarray(v) for k, v in out.items()}
    return _CACHE[key]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fill", FILLS)
def test_ghost_fills_match_jax(case, fill):
    """Each fill against the JAX one at t = 0.3 (sigma: a pressure-point
    tensor, whose trailing dims ride along); the caller's tensor is left
    as it was."""
    _, ts = _pair(case)
    u, p = _fields(case)
    before = u if fill.startswith("u") else _sigma(case) if fill == "sigma" else p
    arg = _t(before)
    if fill.startswith("u"):
        kw = {"u_dudt": dict(dudt=True), "u_homogeneous": dict(homogeneous=True)}.get(fill, {})
        got = it.apply_bc_u(arg, 0.3, ts, **kw)
    else:
        got = (it.apply_bc_temp if fill == "temp" else it.apply_bc_p)(arg, 0.3, ts)
    assert _rel(got, _jax_fills(case)[fill]) <= TOL
    assert np.array_equal(arg.numpy(), before)


def test_time_dependent_dirichlet_moves_with_t():
    """The inflow's ghosts follow t, and ``dudt`` gives their derivative:
    (g(t + h) - g(t - h)) / 2h of the filled planes."""
    _, ts = _pair("2d")
    u = torch.zeros((2, *ts.grid.N), dtype=torch.float64)
    a, b = it.apply_bc_u(u, 0.2, ts), it.apply_bc_u(u, 0.7, ts)
    assert not torch.equal(a[0, 0], b[0, 0])
    h = 1e-6
    fd = (it.apply_bc_u(u, 0.2 + h, ts) - it.apply_bc_u(u, 0.2 - h, ts)) / (2 * h)
    d = it.apply_bc_u(u, 0.2, ts, dudt=True)
    assert torch.allclose(d[:, 0], fd[:, 0], atol=1e-6)


# --------------------------------------------------------------------------
# operators
# --------------------------------------------------------------------------


def _ops():
    return {
        "scalewithvolume": lambda m, u, T, s: m.scalewithvolume(T, s),
        "divergence": lambda m, u, T, s: m.divergence(u, s),
        "pressuregradient": lambda m, u, T, s: m.pressuregradient(T, s),
        "applypressure": lambda m, u, T, s: m.applypressure(u, T, s),
        "laplacian": lambda m, u, T, s: m.laplacian(T, s),
        "convection": lambda m, u, T, s: m.convection(u, s),
        "diffusion": lambda m, u, T, s: m.diffusion(u, s),
        "diffusion_unit": lambda m, u, T, s: m.diffusion(u, s, use_viscosity=False),
        "convectiondiffusion": lambda m, u, T, s: m.convectiondiffusion(u, s),
        "convection_diffusion_temp": lambda m, u, T, s: m.convection_diffusion_temp(u, T, s),
        "wrap_periodic_ghosts": lambda m, u, T, s: _mod(m).wrap_periodic_ghosts(u, s),
        "dissipation": lambda m, u, T, s: m.dissipation(u, s),
        "dissipation_from_strain": lambda m, u, T, s: m.dissipation_from_strain(u, s),
        "applybodyforce": lambda m, u, T, s: m.applybodyforce(u, 0.0, s),
        "gravity": lambda m, u, T, s: m.gravity(T, s),
        "momentum": lambda m, u, T, s: m.momentum(u, T, 0.1, s),
        "momentum_no_temp": lambda m, u, T, s: m.momentum(u, None, 0.1, s),
        "vorticity": lambda m, u, T, s: m.vorticity(u, s),
        "interpolate_u_p": lambda m, u, T, s: m.interpolate_u_p(u, s),
        "interpolate_omega_p": lambda m, u, T, s: m.interpolate_omega_p(m.vorticity(u, s), s),
        "kinetic_energy": lambda m, u, T, s: m.kinetic_energy(u, s),
        "kinetic_energy_interp": lambda m, u, T, s: m.kinetic_energy(u, s, interpolate_first=True),
        "total_kinetic_energy": lambda m, u, T, s: m.total_kinetic_energy(u, s),
    }


def _mod(m):
    if m is ins:
        from ins_tpu.ops import operators
    else:
        from ins_tpu_torch.ops import operators
    return operators


def _jax_refs(case):
    """Every operator of `_ops` on the case's filled fields, from one
    jitted JAX function (one compile a case)."""
    key = ("refs", case)
    if key not in _CACHE:
        js, _ = _pair(case)
        u, T = _filled(case)
        ops = _ops()
        refs = jax.jit(lambda a, b: {k: f(ins, a, b, js) for k, f in ops.items()})(
            jnp.asarray(u), jnp.asarray(T))
        _CACHE[key] = {k: np.asarray(v) for k, v in refs.items()}
    return _CACHE[key]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("op", list(_ops()))
def test_operator_matches_jax(case, op):
    _, ts = _pair(case)
    u, T = _filled(case)
    ref = _jax_refs(case)[op]
    got = _ops()[op](it, _t(u), _t(T), ts)
    assert tuple(got.shape) == tuple(np.shape(ref))
    assert _rel(got, ref) <= TOL


# --------------------------------------------------------------------------
# the invariants of tests/test_operators.py, on the port
# --------------------------------------------------------------------------


def _weighted_inner_u(v, w, setup):
    """sum over a, Iu[a] of v[a] Ω_u[a] w[a] (the u-volume weights)."""
    g = setup.grid
    total = 0.0
    for a in range(g.dim):
        box = g.Iu[a]
        om = 1.0
        for b in range(g.dim):
            om = om * dseg(setup.dgrid.delta_u[b] if a == b else setup.dgrid.delta[b], box, b)
        total = total + torch.sum(v[(a,) + slc(box)] * om * w[(a,) + slc(box)])
    return float(total)


def _box(D, n=12):
    """`tests/conftest.py`'s `make_setup_2d` / `make_setup_3d` on the port:
    tanh and cosine stretched no-slip boxes (the reference's operator
    test fixtures)."""
    if D == 2:
        x = (ins.tanh_grid(0.0, 1.0, n), ins.tanh_grid(0.0, 1.0, n, 1.3))
    else:
        x = (ins.tanh_grid(0.0, 1.0, n, 1.2), ins.tanh_grid(0.0, 1.0, n, 1.1),
             ins.cosine_grid(0.0, 1.0, n))
    bc = ((it.DirichletBC(), it.DirichletBC()),) * D
    return it.Setup(x=x, boundary_conditions=bc, Re=1000.0, dtype=torch.float64, device="cpu")


def _invariant_setup(case):
    key = ("setup", case)
    if key not in _CACHE:
        _CACHE[key] = _box(2) if case == "box2d" else _box(3) if case == "box3d" else _pair(case)[1]
    return _CACHE[key]


def _divfree(case):
    """A divergence-free ghost-filled field of the port (tight CG)."""
    ts = _invariant_setup(case)
    key = ("divfree", case)
    if key not in _CACHE:
        def uref(dim, x, y, *z):
            return -(dim == 0) * torch.sin(x) * torch.cos(y) + (dim == 1) * torch.cos(x) * torch.sin(y)
        _CACHE[key] = it.velocityfield(ts, uref, 0.0, psolver=it.psolver_cg(ts, reltol=1e-13))
    return _CACHE[key]


# convection and diffusion on the no-slip boxes (inflow and lids carry
# energy through the boundary); the duality and the Laplacian on every case
_INVARIANTS = [(c, p) for c in ("box2d", "box3d") for p in (
    "duality", "laplacian_symmetry", "laplacian_negativity", "convection_skew_symmetry",
    "diffusion_dissipativity")] + [(c, p) for c in CASES for p in (
        "duality", "laplacian_symmetry", "laplacian_negativity")]


@pytest.mark.parametrize("case,prop", _INVARIANTS)
def test_operator_invariants(case, prop):
    """D = -Gᵀ under the volume weights (homogeneous velocity ghosts); the
    Laplacian symmetric and negative semi-definite; convection
    skew-symmetric on a divergence-free field; diffusion dissipative."""
    ts = _invariant_setup(case)
    ip = slc(ts.grid.Ip)
    rng = np.random.default_rng(11)
    v = it.apply_bc_u(_t(rng.standard_normal((ts.grid.dim, *ts.grid.N))), 0.0, ts,
                      homogeneous=True)
    p = it.apply_bc_p(_t(rng.standard_normal(ts.grid.N)), 0.0, ts)
    q = it.apply_bc_p(_t(rng.standard_normal(ts.grid.N)), 0.0, ts)
    if prop == "duality":
        pDv = float(torch.sum((p * it.scalewithvolume(it.divergence(v, ts), ts))[ip]))
        vGp = _weighted_inner_u(v, it.pressuregradient(p, ts), ts)
        assert pDv == pytest.approx(-vGp, rel=1e-10, abs=1e-10)
    elif prop == "laplacian_symmetry":
        a = float(torch.sum((q * it.laplacian(p, ts))[ip]))
        b = float(torch.sum((p * it.laplacian(q, ts))[ip]))
        assert a == pytest.approx(b, rel=1e-9, abs=1e-9)
    elif prop == "laplacian_negativity":
        assert float(torch.sum((p * it.laplacian(p, ts))[ip])) <= 0
    elif prop == "convection_skew_symmetry":
        u = _divfree(case)
        assert abs(_weighted_inner_u(u, it.convection(u, ts), ts)) < 1e-12
    else:
        u = _divfree(case)
        assert _weighted_inner_u(u, it.diffusion(u, ts), ts) <= 0


# --------------------------------------------------------------------------
# solvers, poisson, project
# --------------------------------------------------------------------------


def _solver_pair(case, which, **kw):
    js, ts = _pair(case)
    if which == "fdm":
        return ins.psolver_fdm(js, **kw), it.psolver_fdm(ts, **kw)
    precond = "fdm" if which == "fdm_cg" else which
    return (ins.psolver_cg(js, precond=precond, **kw), it.psolver_cg(ts, precond=precond, **kw))


def _jax_cg_iterations(js, precond, f, ref, reltol, maxiter_cap=256):
    """The JAX CG's iteration count: the least maxiter whose result is the
    unlimited run's (by bisection; a maxiter at or above the count gives
    that result)."""
    def same(k):
        got = ins.psolver_cg(js, precond=precond, reltol=reltol, maxiter=k)(f)
        return np.array_equal(np.asarray(got), np.asarray(ref))

    lo, hi = 0, maxiter_cap
    assert same(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if same(mid) else (mid, hi)
    return hi


@pytest.mark.parametrize("case", ["2d", "cavity"])  # with a PressureBC, and singular
@pytest.mark.parametrize("precond", ["jacobi", "fdm"])
def test_psolver_cg_matches_jax(case, precond, monkeypatch):
    """Iteration count and solution against the JAX `lax.while_loop` CG,
    with the host reading the stop flag after the first iteration and
    then every 3 (`CG_POLL`), and after the first only (the iterations
    past convergence run frozen up to maxiter)."""
    js, ts = _pair(case)
    u, _ = _filled(case)
    f = np.asarray(ins.scalewithvolume(ins.divergence(jnp.asarray(u), js), js))
    reltol = 1e-9
    ref = ins.psolver_cg(js, precond=precond, reltol=reltol)(jnp.asarray(f))
    nj = _jax_cg_iterations(js, precond, jnp.asarray(f), ref, reltol)
    ip = slc(ts.grid.Ip)
    for cg_poll, maxiter in ((3, None), (10**9, nj + 5)):
        monkeypatch.setattr(torch_pressure, "CG_POLL", cg_poll)
        ps = it.psolver_cg(ts, precond=precond, reltol=reltol, maxiter=maxiter)
        got = ps(_t(f)[ip])
        assert int(ps.iterations) == nj
        assert _rel(got, np.asarray(ref)[ip]) <= TOL_SOLVE
    if precond == "fdm":
        assert nj <= 2  # the exact inverse on a separable grid


def test_psolver_cg_maxiter_stops_like_jax():
    """A maxiter below convergence stops both at the same iterate."""
    js, ts = _pair("3d")
    u, _ = _filled("3d")
    f = np.asarray(ins.scalewithvolume(ins.divergence(jnp.asarray(u), js), js))
    ref = ins.psolver_cg(js, precond="jacobi", maxiter=5)(jnp.asarray(f))
    ps = it.psolver_cg(ts, precond="jacobi", maxiter=5)
    ip = slc(ts.grid.Ip)
    assert _rel(ps(_t(f)[ip]), np.asarray(ref)[ip]) <= TOL_SOLVE
    assert int(ps.iterations) == 5


@pytest.mark.parametrize("nrefine", [0, 1])
@pytest.mark.parametrize("case", CASES)
def test_psolver_fdm_matches_jax(case, nrefine):
    """The FDM solve with its refinement against the ghosted Laplacian,
    a `SymmetricBC` among the sides ("2d", "3d")."""
    js, ts = _pair(case)
    u, _ = _filled(case)
    f = np.asarray(ins.scalewithvolume(ins.divergence(jnp.asarray(u), js), js))
    ref = ins.psolver_fdm(js, nrefine=nrefine)(jnp.asarray(f))
    ip = slc(ts.grid.Ip)
    got = it.psolver_fdm(ts, nrefine=nrefine)(_t(f)[ip])
    assert _rel(got, np.asarray(ref)[ip]) <= TOL_SOLVE


def test_laplacian_box_is_the_ghosted_laplacian():
    """`fdm.laplacian_box` (the CG and refinement operator) equals the
    ghosted Laplacian after the pressure ghost fill, symmetric sides
    included."""
    from ins_tpu_torch.ops.fdm import laplacian_box

    for case in CASES:
        _, ts = _pair(case)
        ip = slc(ts.grid.Ip)
        q = _t(np.random.default_rng(5).standard_normal(ts.grid.Np))
        full = torch.zeros(ts.grid.N, dtype=torch.float64)
        full[ip] = q
        ref = it.laplacian(it.apply_bc_p(full, 0.0, ts), ts)[ip]
        assert _rel(laplacian_box(ts)(q), ref) <= TOL


@pytest.mark.parametrize("which", ["jacobi", "fdm_cg", "fdm"])
@pytest.mark.parametrize("case", CASES)
def test_project_matches_jax_and_is_divergence_free(case, which):
    js, ts = _pair(case)
    u, _ = _filled(case)
    if which == "fdm":
        jp, tp = _solver_pair(case, "fdm")
    else:
        jp, tp = _solver_pair(case, "jacobi" if which == "jacobi" else "fdm_cg", reltol=1e-12)
    ref = jax.jit(lambda a: ins.project(a, js, psolver=jp))(jnp.asarray(u))
    got = it.project(_t(u), ts, psolver=tp)
    assert _rel(got, ref) <= TOL_SOLVE
    # the periodic ghosts are filled after a projection, as the stepper does
    div = it.divergence(it.apply_bc_u(got, 0.3, ts), ts)[slc(ts.grid.Ip)]
    div0 = it.divergence(_t(u), ts)[slc(ts.grid.Ip)]
    assert float(div.abs().max()) <= 1e-9 * float(div0.abs().max())


def test_pressure_matches_jax():
    js, ts = _pair("2d")
    u, T = _filled("2d")
    jp, tp = _solver_pair("2d", "fdm")
    ref = ins.pressure(jnp.asarray(u), jnp.asarray(T), jnp.asarray(0.4), js, psolver=jp)
    got = it.pressure(_t(u), _t(T), 0.4, ts, psolver=tp)
    assert _rel(got, ref) <= TOL_SOLVE


@pytest.mark.parametrize("case", ["2d", "cavity"])
def test_poisson_gradient_matches_jax_vjp(case):
    """`poisson` is its own adjoint: the gradient of <w, poisson(f)> in f
    against `jax.vjp` of the JAX `poisson`, on the pressure box (the
    port's solvers, and so its `poisson`, act on the interior box; the
    JAX ones pass the ghosts through)."""
    js, ts = _pair(case)
    rng = np.random.default_rng(2)
    f = rng.standard_normal(js.grid.N)
    w = rng.standard_normal(js.grid.N)
    jp, tp = _solver_pair(case, "fdm")
    out, vjp = jax.vjp(lambda a: ins.poisson(jp, a), jnp.asarray(f))
    (ref,) = vjp(jnp.asarray(w))
    ip = slc(ts.grid.Ip)
    ft = _t(f)[ip].requires_grad_(True)
    got = it.poisson(tp, ft)
    assert _rel(got.detach(), np.asarray(out)[ip]) <= TOL_SOLVE
    (grad,) = torch.autograd.grad(got, ft, _t(w)[ip])
    assert _rel(grad, np.asarray(ref)[ip]) <= TOL_SOLVE


def test_project_gradient_through_fills():
    """Autograd through a fill and a projection: the gradient of a scalar
    of `project(apply_bc_u(u))` against `jax.grad` of the same."""
    js, ts = _pair("3d")
    u, _ = _filled("3d")
    jp, tp = _solver_pair("3d", "fdm")
    w = np.random.default_rng(4).standard_normal(u.shape)

    def jloss(a):
        return jnp.sum(jnp.asarray(w) * ins.project(ins.apply_bc_u(a, jnp.asarray(0.2), js), js,
                                                   psolver=jp) ** 2)

    ref = jax.jit(jax.grad(jloss))(jnp.asarray(u))
    ut = _t(u).requires_grad_(True)
    loss = torch.sum(_t(w) * it.project(it.apply_bc_u(ut, 0.2, ts), ts, psolver=tp) ** 2)
    (grad,) = torch.autograd.grad(loss, ut)
    assert _rel(grad, ref) <= TOL_SOLVE


# --------------------------------------------------------------------------
# the ghosted Smagorinsky closures, the processors off periodic grids
# --------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["natural", "pressure_point"])
@pytest.mark.parametrize("case", CASES)
def test_smagorinsky_closures_match_jax(case, form):
    js, ts = _pair(case)
    u, _ = _filled(case)
    if form == "natural":
        jm, tm = ins.smagorinsky_closure_natural(js), it.smagorinsky_closure_natural(ts)
        assert tm.kind == "smagorinsky_natural"
    else:
        jm, tm = ins.smagorinsky_closure(js), it.smagorinsky_closure(ts)
    ref = jax.jit(lambda a: jm(a, 0.17))(jnp.asarray(u))
    assert _rel(tm(_t(u), 0.17), ref) <= TOL


@pytest.mark.parametrize("case", CASES)
def test_processors_off_periodic_grids(case):
    """`observe_nusselt` and `total_kinetic_energy` on walls and stretched
    grids against the JAX package."""
    js, ts = _pair(case)
    u, T = _filled(case)
    state_j = dict(u=jnp.asarray(u), temp=jnp.asarray(T), t=0.0, n=0)
    state_t = dict(u=_t(u), temp=_t(T), t=0.0, n=0)
    ref = ins.observe_nusselt(js).initialize(state_j)["Nu"][0]
    got = it.observe_nusselt(ts).initialize(state_t)["Nu"][0]
    assert got == pytest.approx(ref, rel=TOL)
    ke = it.total_kinetic_energy(_t(u), ts)
    assert float(ke) == pytest.approx(float(ins.total_kinetic_energy(jnp.asarray(u), js)), rel=TOL)
