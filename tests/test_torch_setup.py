"""The port's host-side pieces against the JAX package: grid, setup,
tableaus, eigenbasis, `random_field` (fed JAX's own uniform draws),
`convert.py`, and that the port imports without JAX."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ins_tpu as ins
from ins_tpu.ops.dft import fourier_eigenbasis as jax_fourier_eigenbasis
from ins_tpu.ops.poisson_pallas import make_fused_projection as jax_fused_projection
from ins_tpu.time_steppers import rk_methods as jax_rk
from ins_tpu.time_steppers.step import StepperState as JaxStepperState

import ins_tpu_torch as it
from ins_tpu_torch import convert
from ins_tpu_torch.ops.dft import fourier_eigenbasis
from ins_tpu_torch.ops.fastpath import HatState, strip_ghosts
from ins_tpu_torch.ops.initializers import spectrum_draw_shapes
from ins_tpu_torch.time_steppers import rk_methods as torch_rk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GRIDS = {
    "periodic3d": lambda: (
        (np.linspace(0, 2 * np.pi, 9),) * 3,
        ((ins.PeriodicBC(), ins.PeriodicBC()),) * 3,
        ((it.PeriodicBC(), it.PeriodicBC()),) * 3,
    ),
    "mixed2d": lambda: (
        (ins.tanh_grid(0.0, 1.0, 8), ins.stretched_grid(0.0, 2.0, 6, 1.1)),
        ((ins.DirichletBC(), ins.PressureBC()), (ins.SymmetricBC(), ins.SymmetricBC())),
        ((it.DirichletBC(), it.PressureBC()), (it.SymmetricBC(), it.SymmetricBC())),
    ),
    "cosine3d": lambda: (
        (ins.cosine_grid(0.0, 1.0, 6), np.linspace(0, 1, 5), ins.tanh_grid(0, 1, 4, 1.2)),
        ((ins.DirichletBC(), ins.DirichletBC()),) * 3,
        ((it.DirichletBC(), it.DirichletBC()),) * 3,
    ),
}


def _leaves(t):
    if isinstance(t, tuple):
        for v in t:
            yield from _leaves(v)
    else:
        yield np.asarray(t)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_grid_matches_jax(name, dtype):
    x, bc_j, bc_t = GRIDS[name]()
    gj = ins.make_grid(x=x, boundary_conditions=bc_j, dtype=getattr(jnp, dtype))
    gt = it.make_grid(x=x, boundary_conditions=bc_t, dtype=getattr(torch, dtype))
    for f in dataclasses.fields(gt):
        a, b = getattr(gt, f.name), getattr(gj, f.name)
        if f.name in ("dim", "N", "Nu", "Np", "Iu", "Ip", "xlims", "periodic", "uniform"):
            assert a == b, f.name
            continue
        la, lb = list(_leaves(a)), list(_leaves(b))
        assert len(la) == len(lb), f.name
        for u, v in zip(la, lb):
            assert u.dtype == v.dtype and np.array_equal(u, v), f.name
    assert it.max_size(gt) == pytest.approx(ins.max_size(gj), rel=1e-6)


def test_setup_matches_jax_and_keeps_its_device():
    x = (np.linspace(0, 2 * np.pi, 9),) * 3
    sj = ins.Setup(x=x, Re=4000.0, dtype=jnp.float32)
    st = it.Setup(device="cpu", x=x, Re=4000.0, dtype=torch.float32)
    assert st.dim == sj.dim == 3
    assert st.Re == float(sj.Re)
    assert st.device == torch.device("cpu")
    assert st.boundary_conditions == tuple(
        tuple(it.PeriodicBC() for _ in bc) for bc in sj.boundary_conditions
    )
    u = it.random_field(st, kp=2, generator=torch.Generator().manual_seed(0))
    assert u.device == st.device and u.dtype == torch.float32


def _nonperiodic_smagorinsky():
    """The natural-form Smagorinsky closure of a wall-bounded setup: the
    ghosted pipeline."""
    s = it.Setup(device="cpu", x=(it.tanh_grid(0, 1, 4),) * 2,
                 boundary_conditions=((it.DirichletBC(), it.DirichletBC()),) * 2)
    return it.smagorinsky_closure_natural(s)


def _nonperiodic_temperature():
    """A temperature equation with wall BCs (the general ghosted path)."""
    walls = ((it.DirichletBC(), it.DirichletBC()),) * 2
    return it.temperature_equation(Pr=0.71, Ra=1e6, Ge=1.0, boundary_conditions=walls)


@pytest.mark.parametrize(
    "kw", [lambda: dict(temperature=_nonperiodic_temperature()), _nonperiodic_smagorinsky,
           dict(bodyforce=lambda dim, x, y, t: (dim + 1) * torch.sin(x - t) * y,
                issteadybodyforce=False)],
    ids=["temperature", "closure", "bodyforce"],
)
def test_setup_unported_options_raise(kw):
    """What once raised and now builds: an unsteady force is kept as its
    callable (no steady field) and evaluated at a time, as the JAX
    package's; temperature with non-periodic BCs and the Smagorinsky
    closure off uniform periodic grids run on the general ghosted path:
    the setup builds, and its closure gives a force on the ghosted
    layout."""
    if isinstance(kw, dict):
        s = it.Setup(device="cpu", x=(np.linspace(0, 1, 5),) * 2, dtype=torch.float64, **kw)
        js = ins.Setup(x=(np.linspace(0, 1, 5),) * 2, dtype=jnp.float64,
                       bodyforce=lambda dim, x, y, t: (dim + 1) * jnp.sin(x - t) * y,
                       issteadybodyforce=False)
        assert s.bodyforce_field is None and s.unsteady_bodyforce is kw["bodyforce"]
        got = it.applybodyforce(None, 0.3, s)
        assert got.shape == (2, 6, 6)
        assert torch.allclose(got, torch.from_numpy(np.asarray(
            ins.applybodyforce(None, jnp.asarray(0.3), js))), rtol=1e-15, atol=0.0)
        return
    made = kw()
    kw = made if isinstance(made, dict) else dict(closure_model=made)
    s = it.Setup(device="cpu", x=(np.linspace(0, 1, 5),) * 2, **kw)
    if s.closure_model is not None:
        u = torch.randn((2, *s.grid.N), dtype=torch.float32)
        f = s.closure_model(it.apply_bc_u(u, 0.0, s), 0.17)
        assert f.shape == u.shape and bool(torch.isfinite(f).all())
    else:
        assert s.temperature.boundary_conditions == kw["temperature"].boundary_conditions


def test_setup_defaults_to_the_card(monkeypatch):
    """Without `device` a setup targets cuda; without a card it raises and
    names the way out, as the convert functions do."""
    x = (np.linspace(0, 1, 5),) * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert it.Setup(x=x).device.type == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    js = JaxStepperState(u=np.zeros((2, 4, 4)), temp=None, t=0.0, n=0)
    for make in (lambda: it.Setup(x=x), lambda: convert.state_from_numpy(js),
                 lambda: convert.cnn_params_from_numpy({"w": np.zeros(2)})):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()


def test_tableaus_match_jax():
    assert set(torch_rk.__all__) == set(jax_rk.__all__)
    for name in jax_rk.__all__:
        mj, mt = getattr(jax_rk, name)(), getattr(torch_rk, name)()
        assert type(mj).__name__ == type(mt).__name__, name
        for field in ("A", "b", "c", "r"):
            assert getattr(mj, field) == getattr(mt, field), (name, field)
    assert dataclasses.astuple(it.LMWray3()) == dataclasses.astuple(ins.LMWray3())


@pytest.mark.parametrize("n", [7, 8])
def test_fourier_eigenbasis_matches_jax(n):
    for a, b in zip(fourier_eigenbasis(n, 0.3), jax_fourier_eigenbasis(n, 0.3)):
        assert np.array_equal(a, b)


def _jax_draws(jset, key):
    """The uniform draws `ins_tpu.random_field` makes from `key`, in the
    order `create_spectrum` consumes them."""
    D = jset.grid.dim
    K = tuple((n - 2) // 2 for n in jset.grid.N)
    KK = tuple(2 * k for k in K)
    keys = jax.random.split(key, D + 2)
    draws = [jax.random.uniform(keys[d], K, dtype=jset.dtype) for d in range(D)]
    draws += [jax.random.uniform(keys[d], KK, dtype=jset.dtype)
              for d in range(D, D + (1 if D == 2 else 2))]
    return [np.asarray(v) for v in draws]


@pytest.mark.parametrize("D,n", [(3, 16), (2, 32)])
def test_random_field_matches_jax_draws(D, n):
    x = (np.linspace(0, 2 * np.pi, n + 1),) * D
    jset = ins.Setup(x=x, dtype=jnp.float64)
    tset = it.Setup(device="cpu", x=x, dtype=torch.float64)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jax.jit(lambda k: ins.random_field(jset, kp=4, rng=k))(key))
    draws = _jax_draws(jset, key)
    assert [d.shape for d in draws] == [tuple(s) for s in spectrum_draw_shapes(tset)]
    got = it.random_field(tset, kp=4, uniforms=draws).numpy()
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) < 1e-11 * np.max(np.abs(ref))


def test_random_field_generator_is_reproducible_and_divergence_free():
    x = (np.linspace(0, 2 * np.pi, 17),) * 3
    tset = it.Setup(device="cpu", x=x, dtype=torch.float64)
    a = it.random_field(tset, kp=4, generator=torch.Generator().manual_seed(11))
    b = it.random_field(tset, kp=4, generator=torch.Generator().manual_seed(11))
    assert torch.equal(a, b)
    u = strip_ghosts(a)
    dx = 2 * np.pi / 16
    div = sum(u[d] - torch.roll(u[d], 1, dims=d) for d in range(3)) / dx
    assert float(div.abs().max()) < 1e-10 * float(u.abs().max()) / dx


def test_convert_round_trip():
    rng = np.random.default_rng(0)
    u = rng.standard_normal((3, 8, 8, 8))
    js = JaxStepperState(u=jnp.asarray(u), temp=None, t=jnp.asarray(0.25), n=jnp.asarray(3))
    ts = convert.state_from_numpy(js, dtype=torch.float64, device="cpu")
    assert isinstance(ts, it.time_steppers.StepperState)
    assert ts.t == 0.25 and ts.n == 3 and np.array_equal(ts.u.numpy(), u)
    back = JaxStepperState(**convert.state_to_numpy(ts))
    assert np.array_equal(np.asarray(back.u), u) and back.n == 3

    from ins_tpu.ops.fastpath import HatState as JaxHatState

    q = rng.standard_normal((8, 8, 8))
    jh = JaxHatState(ut=jnp.asarray(u), qhat=jnp.asarray(q), temp=None,
                     t=jnp.asarray(0.5), n=jnp.asarray(4))
    th = convert.state_from_numpy(jh, dtype=torch.float64, device="cpu")
    assert isinstance(th, HatState) and np.array_equal(th.qhat.numpy(), q)
    back = JaxHatState(**convert.state_to_numpy(th))
    assert np.array_equal(np.asarray(back.qhat), q) and back.t == 0.5
    # the port's materialised carry (qhat None) maps to JAX's qhat = 0
    zero = convert.state_to_numpy(th._replace(qhat=None))
    assert not zero["qhat"].any() and zero["qhat"].shape == (8, 8, 8)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_setup_constants_match_jax(dtype):
    n = 16
    x = (np.linspace(0, 2 * np.pi, n + 1),) * 3
    tset = it.Setup(device="cpu", x=x, dtype=getattr(torch, dtype))
    jset = ins.Setup(x=x, dtype=getattr(jnp, dtype))
    dxs = tuple(float(np.asarray(jset.grid.delta[d])[0]) for d in range(3))
    jp = jax_fused_projection((n,) * 3, dxs, getattr(jnp, dtype))
    consts = {k: np.asarray(jp[k]) for k in ("V", "Vinv", "VT", "VinvT")}
    consts["dxs"] = dxs
    assert convert.check_setup_constants(tset, consts) <= 1e-12
    consts["V"] = consts["V"] * 1.01
    with pytest.raises(ValueError, match="differ"):
        convert.check_setup_constants(tset, consts)


def test_port_imports_without_jax():
    """`import ins_tpu_torch` (and every submodule) with jax blocked."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import ins_tpu_torch\n"
        "for m in pkgutil.walk_packages(ins_tpu_torch.__path__, 'ins_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m, v in sys.modules.items()\n"
        "       if v is not None and m.split('.')[0] in ('jax', 'jaxlib', 'ins_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_create_stepper_rejects_unported_methods():
    """Explicit RK and LMWray3 (with a temperature) make a state, and so
    do the implicit tableaus, whose steps now run: one BE11 step by
    Picard iteration (a 4² periodic box, f64) equals the JAX package's
    to 1e-9 relative."""
    tset = it.Setup(device="cpu", x=(np.linspace(0, 1, 5),) * 2)
    u, T = torch.zeros(2, 6, 6), torch.ones(6, 6)
    s = it.create_stepper(it.LMWray3(), setup=tset, u=u, temp=T, t=0.5)
    assert s.temp is T and s.t == 0.5 and s.n == 0
    x = (np.linspace(0, 1, 5),) * 2
    js = ins.Setup(x=x, Re=10.0, dtype=jnp.float64)
    ts = it.Setup(device="cpu", x=x, Re=10.0, dtype=torch.float64)
    jm, tm = ins.RKMethods.BE11(newton_type="picard"), it.RKMethods.BE11(newton_type="picard")
    xx, yy = np.meshgrid(ts.grid.xp[0], ts.grid.xp[1], indexing="ij")
    u0 = np.stack([np.sin(2 * np.pi * yy), np.cos(2 * np.pi * xx) + 0.3 * np.sin(2 * np.pi * yy)])
    jp, tp = ins.psolver_spectral(js), it.psolver_spectral(ts)
    u0 = np.asarray(jax.jit(lambda a: ins.project(a, js, psolver=jp))(jnp.asarray(u0)))
    sj = jax.jit(lambda s: ins.timestep(jm, s, 0.05, setup=js, psolver=jp))(
        ins.create_stepper(jm, setup=js, psolver=jp, u=jnp.asarray(u0)))
    st = it.create_stepper(tm, setup=ts, psolver=tp, u=torch.from_numpy(u0))
    assert isinstance(st, it.time_steppers.StepperState)
    with torch.no_grad():
        st = it.timestep(tm, st, 0.05, setup=ts, psolver=tp)
    ref = np.asarray(sj.u)
    assert st.n == 1 and np.max(np.abs(st.u.numpy() - ref)) <= 1e-9 * np.max(np.abs(ref))
    assert np.max(np.abs(st.u.numpy() - u0)) > 1e-3
