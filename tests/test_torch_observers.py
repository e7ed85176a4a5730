"""The port's derived fields, tensor basis and observers against the JAX
package (CPU, f64).

`Dfield`, `Qfield` (2-D and 3-D), `eig2field` and `get_scale_numbers`
(3-D, periodic and walled) of the same fields; `tensorbasis` in 2-D and 3-D with
`lastdimcontract`; `monitor`'s forward and backward (identity, logged);
`fieldobserver` for every name (the components, "velocity",
"velocitynorm", "vorticity", "streamfunction", "pressure", "Dfield",
"Qfield", "eig2field", "temperature", "B1".. and "V1.."); and
`observe_wallshear`: exact on a Couette profile (the linear-profile case
of `tests/test_observables.py`), against JAX's on a random field, and on
the channel path, whose processors see the state through
`reghost_channel` (filled wall ghosts).  1e-9 relative (f64, summation
order only); 1e-12 absolute on the Couette profile.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ins_tpu as ins
import ins_tpu.ops.operators as jops
from ins_tpu.ops.tensorbasis import lastdimcontract as jlastdimcontract
from ins_tpu.ops.tensorbasis import tensorbasis as jtensorbasis

import ins_tpu_torch as it
import ins_tpu_torch.ops.operators as tops
from ins_tpu_torch.ops.channelpath import channelpath_applicable

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


def _pk(pk):
    return (dict(device="cpu"), torch.float64) if pk is it else ({}, jnp.float64)


def _walls_3d(pk):
    """3-D: periodic x, no-slip y, a lid in z, stretched; with a
    temperature equation (Dirichlet walls in z)."""
    kw, dtype = _pk(pk)
    x = (np.linspace(0.0, 1.0, 9), ins.tanh_grid(0.0, 1.0, 8, 1.2), ins.cosine_grid(0.0, 1.0, 8))
    d = pk.DirichletBC()
    per = (pk.PeriodicBC(), pk.PeriodicBC())
    te = pk.temperature_equation(Pr=0.71, Ra=1e5, Ge=1.0, gdir=2, dtype=dtype,
                                 boundary_conditions=(per, (pk.SymmetricBC(),) * 2,
                                                      (pk.DirichletBC(1.0), pk.DirichletBC(0.0))))
    return pk.Setup(x=x, boundary_conditions=(per, (d, d), (d, pk.DirichletBC((1.0, 0.0, 0.0)))),
                    Re=500.0, temperature=te, dtype=dtype, **kw)


def _periodic(pk, dim):
    kw, dtype = _pk(pk)
    x = (np.linspace(0.0, 2 * np.pi, 9),) * dim
    return pk.Setup(x=x, Re=300.0, dtype=dtype, **kw)


def _walls_2d(pk):
    kw, dtype = _pk(pk)
    x = (np.linspace(0.0, 1.0, 9), ins.cosine_grid(0.0, 1.0, 8))
    d = pk.DirichletBC()
    return pk.Setup(x=x, boundary_conditions=((pk.PeriodicBC(), pk.PeriodicBC()),
                                              (d, pk.DirichletBC((1.0, 0.0)))),
                    Re=100.0, dtype=dtype, **kw)


SETUPS = {"2d": _walls_2d, "3d": _walls_3d, "periodic2d": lambda pk: _periodic(pk, 2),
          "periodic3d": lambda pk: _periodic(pk, 3)}


def _fields(js, seed):
    """A ghost-filled random velocity, pressure and temperature (numpy)."""
    g = js.grid
    rng = np.random.default_rng(seed)
    u = np.asarray(ins.apply_bc_u(jnp.asarray(rng.standard_normal((g.dim, *g.N))),
                                  jnp.asarray(0.0), js))
    p = np.asarray(ins.apply_bc_p(jnp.asarray(rng.standard_normal(g.N)), jnp.asarray(0.0), js))
    return u, p, rng.standard_normal(g.N)


@pytest.mark.parametrize("case", ["2d", "3d"])
def test_vortex_criteria_match_jax(case):
    js, ts = SETUPS[case](ins), SETUPS[case](it)
    u, p, _ = _fields(js, 1)
    three = case == "3d"
    ref = jax.jit(lambda u, p: (jops.Dfield(p, js), jops.Qfield(u, js),
                                jops.eig2field(u, js) if three else None))(jnp.asarray(u),
                                                                           jnp.asarray(p))
    assert _rel(tops.Dfield(_t(p), ts), ref[0]) <= TOL
    assert _rel(tops.Qfield(_t(u), ts), ref[1]) <= TOL
    if three:
        assert _rel(tops.eig2field(_t(u), ts), ref[2]) <= TOL
    else:
        with pytest.raises(ValueError, match="3-D"):
            tops.eig2field(_t(u), ts)


def test_eigvals2_sym3_degenerate_spectra():
    """The middle eigenvalue of symmetric 3x3 matrices, also with equal
    eigenvalues (the closed form's guards), against JAX's closed form
    (1e-12) and numpy's eigenvalues (1e-7: at a double eigenvalue the
    arccos of the closed form keeps half the digits, in both packages)."""
    rng = np.random.default_rng(4)
    A = rng.standard_normal((6, 3, 3))
    M = A + np.swapaxes(A, -1, -2)
    Q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    M[0] = 2.0 * np.eye(3)  # triple eigenvalue
    M[1] = Q @ np.diag([1.0, 1.0, -3.0]) @ Q.T  # double
    got = tops._eigvals2_sym3(_t(M)).numpy()
    np.testing.assert_allclose(got, np.asarray(jops._eigvals2_sym3(jnp.asarray(M))), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(got, np.sort(np.linalg.eigvalsh(M), -1)[..., 1], rtol=1e-7,
                               atol=0)


@pytest.mark.parametrize("case", ["periodic3d", "3d"])
def test_scale_numbers_match_jax(case):
    """Also on walls and a stretched grid, where the velocity boxes differ
    per component and every component is averaged over ``Iu[0]``, as in
    the JAX package (its integral scale L assumes a uniform periodic
    grid, and is compared as computed)."""
    js, ts = SETUPS[case](ins), SETUPS[case](it)
    u, _, _ = _fields(js, 2)
    ref = jax.jit(lambda u: jops.get_scale_numbers(u, js))(jnp.asarray(u))
    got = tops.get_scale_numbers(_t(u), ts)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == () and _rel(got[k], ref[k]) <= TOL, k


@pytest.mark.parametrize("case", ["2d", "3d"])
def test_tensorbasis_matches_jax(case):
    js, ts = SETUPS[case](ins), SETUPS[case](it)
    u, _, _ = _fields(js, 3)
    c = np.random.default_rng(6).standard_normal((11 if case == "3d" else 3, *js.grid.N))

    def ref(u, c):
        B, V = jtensorbasis(u, js)
        return B, V, jlastdimcontract(c, B)

    jB, jV, jC = jax.jit(ref)(jnp.asarray(u), jnp.asarray(c))
    B, V = it.tensorbasis(_t(u), ts)
    assert B.shape == jB.shape and V.shape == jV.shape
    assert _rel(B, jB) <= TOL and _rel(V, jV) <= TOL
    assert _rel(it.lastdimcontract(_t(c), B), jC) <= TOL


def test_monitor_is_a_logged_identity(caplog):
    """Forward and backward pass the values through unchanged (the JAX
    custom VJP's identity) and each logs dtype and shape once."""
    x = torch.arange(6.0, dtype=torch.float64).reshape(2, 3).requires_grad_(True)
    with caplog.at_level(logging.INFO, logger="ins_tpu_torch.ops.tensorbasis"):
        y = it.monitor(x)
        assert torch.equal(y, x)
        (g,) = torch.autograd.grad((y * 3.0).sum(), x)
    assert torch.equal(g, torch.full_like(x, 3.0))
    msgs = [r.getMessage() for r in caplog.records]
    assert msgs == ["Forward monitor: torch.float64 (2, 3)",
                    "Pullback monitor: torch.float64 (2, 3)"]


def _names(case):
    """The names of `fieldobserver` but the tensor-basis channels."""
    names = list(range(3 if case == "3d" else 2))
    names += ["velocity", "velocitynorm", "vorticity", "pressure", "Dfield", "Qfield"]
    return names + (["eig2field", "temperature"] if case == "3d" else ["streamfunction"])


@pytest.mark.parametrize("case", ["3d", "periodic2d"])
def test_fieldobserver_matches_jax(case):
    """Every name of `fieldobserver` (the pressure and D-field through
    `psolver_fdm`) against JAX's compute on the same state (one jit of
    them all); the tensor-basis channels "B1".. and "V1.." against the
    slices of JAX's `tensorbasis` that its observer returns."""
    js, ts = SETUPS[case](ins), SETUPS[case](it)
    u, _, T = _fields(js, 7)
    if ts.temperature is None:
        T = None
    jstate = dict(u=jnp.asarray(u), temp=None if T is None else jnp.asarray(T), t=0.0, n=0)
    tstate = dict(u=_t(u), temp=None if T is None else _t(T), t=0.0, n=0)
    jp, tp = ins.psolver_fdm(js), it.psolver_fdm(ts)
    names = _names(case)
    refs = jax.jit(lambda st: [ins.fieldobserver(js, n, psolver=jp).__wrapped__(st)
                               for n in names])(jstate)
    ip = tuple(slice(a, b) for a, b in js.grid.Ip)
    jB, jV = jax.jit(lambda u: jtensorbasis(u, js))(jstate["u"])
    names += [f"B{i + 1}" for i in range(jB.shape[0])] + [f"V{i + 1}" for i in range(jV.shape[0])]
    refs += [jB[i][ip] for i in range(jB.shape[0])] + [jV[i][ip] for i in range(jV.shape[0])]
    for name, ref in zip(names, refs):
        got = it.fieldobserver(ts, name, psolver=tp)(tstate)
        assert got.shape == ref.shape, name
        assert _rel(got, ref) <= TOL, name
    with pytest.raises(ValueError, match="fieldname"):
        it.fieldobserver(ts, "nonsense")(tstate)


def test_wallshear_linear_profile():
    """u_x(y) = y (a Couette profile) -> tau_w = 1/Re on both walls."""
    n = 16
    x = (np.linspace(0, 1.0, n + 1), ins.cosine_grid(0.0, 1.0, n))
    bc = ((it.PeriodicBC(), it.PeriodicBC()), (it.DirichletBC(), it.DirichletBC((1.0, 0.0))))
    setup = it.Setup(x=x, boundary_conditions=bc, Re=100.0, dtype=torch.float64, device="cpu")
    g = setup.grid
    u = torch.zeros((2, *g.N), dtype=torch.float64)
    u[0] = torch.as_tensor(np.asarray(g.xp[1]))[None, :]
    st = {"u": u, "temp": None, "t": 0.0, "n": 0}
    for side in (0, 1):
        tau = it.observe_wallshear(setup, dim=1, side=side, component=0).initialize(st)["tau"][0]
        assert abs(tau - 1.0 / 100.0) < 1e-12
    with pytest.raises(ValueError, match="tangential"):
        it.observe_wallshear(setup, dim=1, side=0, component=1)


def test_wallshear_matches_jax():
    js, ts = SETUPS["3d"](ins), SETUPS["3d"](it)
    u, _, _ = _fields(js, 8)
    for dim, comp in ((1, 0), (2, 0), (2, 1)):
        for side in (0, 1):
            ref = ins.observe_wallshear(js, dim=dim, side=side, component=comp).initialize(
                dict(u=jnp.asarray(u), t=0.0))["tau"][0]
            got = it.observe_wallshear(ts, dim=dim, side=side, component=comp).initialize(
                dict(u=_t(u), t=0.0))["tau"][0]
            assert abs(got - ref) <= TOL * abs(ref), (dim, side, comp)


def test_wallshear_on_the_channel_path():
    """Two RK44 steps of a 3-D channel (x/y periodic, no-slip z walls, a
    steady force, `psolver_fdm`) through the channel path: the processor
    on each wall reads the ghosts `reghost_channel` fills, so its values
    equal JAX's observer on the same states and the shear of the state
    after a ghost fill."""
    x = (np.linspace(0.0, 2.0, 9), np.linspace(0.0, 1.0, 5), ins.cosine_grid(0.0, 1.0, 8))
    per = (it.PeriodicBC(), it.PeriodicBC())
    bc = (per, per, (it.DirichletBC(), it.DirichletBC()))
    ts = it.Setup(x=x, boundary_conditions=bc, Re=180.0, dtype=torch.float64, device="cpu",
                  bodyforce=lambda dim, x, y, z, t: (dim == 0) * 1.0 + 0 * x)
    tp = it.psolver_fdm(ts)
    assert channelpath_applicable(ts, it.RKMethods.RK44())
    jx = tuple(np.asarray(v) for v in x)
    jper = (ins.PeriodicBC(), ins.PeriodicBC())
    js = ins.Setup(x=jx, boundary_conditions=(jper, jper, (ins.DirichletBC(), ins.DirichletBC())),
                   Re=180.0, dtype=jnp.float64)
    g = ts.grid
    zz = np.asarray(g.xp[2])
    u0 = np.zeros((3, *g.N))
    xx = np.asarray(g.xp[0])
    u0[0] = (zz * (1 - zz))[None, None, :] * (1 + 0.1 * np.sin(np.pi * xx))[:, None, None]
    u0 = it.project(it.apply_bc_u(_t(u0), 0.0, ts), ts, psolver=tp)
    procs = {f"{side}": it.observe_wallshear(ts, dim=2, side=side, component=0)
             for side in (0, 1)}
    procs["u"] = it.fieldsaver()
    state, out = it.solve_unsteady(setup=ts, ustart=u0, tlims=(0.0, 0.02), dt=0.01,
                                   psolver=tp, processors=procs)
    for side in (0, 1):
        taus = out[f"{side}"]["tau"]
        assert len(taus) == 3 and len(out["u"]) == 2  # the saver keeps no initial state
        jobs = ins.observe_wallshear(js, dim=2, side=side, component=0)
        for tau, saved in zip(taus[1:], out["u"]):
            ref = jobs.initialize(dict(u=jnp.asarray(saved["u"]), t=saved["t"]))["tau"][0]
            filled = it.apply_bc_u(_t(saved["u"]), saved["t"], ts)
            own = it.observe_wallshear(ts, dim=2, side=side, component=0).initialize(
                dict(u=filled, t=saved["t"]))["tau"][0]
            assert abs(tau - ref) <= TOL * abs(ref) and abs(tau - own) <= TOL * abs(own)
        assert abs(taus[-1]) > 0
