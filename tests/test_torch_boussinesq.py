"""The port's Boussinesq convection against the JAX package (CPU, f64).

On CPU tensors the stage kernels' temperature stream and the 3-pass
Poisson solve run their plain versions, so these tests hold the port's
convection arithmetic — the temperature coefficients and field, the
buoyancy and temperature RHS of the stage kernels, the hat chain with
temperature, the roll twin, `solve_unsteady` with `tempstart` and
`observe_nusselt`, and the state conversion — against the JAX package:
its Pallas kernels in interpret mode at ``precision="highest"``, its
fused interpret chain and roll twin, its solver.  The CUDA kernels run
only on the card: `chip_smoke.py` holds each against its plain version.

Both sides are f64.  A kernel or a single stage differs from its JAX
twin in summation order only (~1e-14 absolute at these sizes; bound
1e-11); a chain of steps drifts to ~1e-16 per step (bound 1e-10); the
solver's FFT and eigen-transform projections, 1e-8.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ins_tpu as ins
from ins_tpu.ops import pallas_kernels as jpk
from ins_tpu.ops.fastpath import HatState as JaxHatState
from ins_tpu.ops.fastpath import make_fast_timestep as jax_make_fast_timestep
from ins_tpu.ops.fastpath import make_fast_timestep_hat as jax_make_fast_timestep_hat
from ins_tpu.ops.poisson_pallas import make_fused_projection as jax_make_fused_projection
from ins_tpu.ops.poisson_pallas import make_poisson_pallas as jax_make_poisson_pallas
from ins_tpu.time_steppers.step import StepperState as JaxStepperState

import ins_tpu_torch as it
from ins_tpu_torch import convert
from ins_tpu_torch.ops import launches
from ins_tpu_torch.ops import stage_kernels as sk
from ins_tpu_torch.ops.dft import make_poisson_mm
from ins_tpu_torch.ops.fastpath import (
    HatState,
    hat_chain_applicable,
    make_fast_timestep,
    make_fast_timestep_hat,
    strip_ghosts,
)
from ins_tpu_torch.ops.poisson_kernels import make_fused_projection, make_poisson_pallas

TOL_KERNEL = 1e-11
TOL_CHAIN = 1e-10
TOL_SOLVE = 1e-8
N = 8
DXS = (1.0 / N, 0.9 / N, 1.1 / N)
VISC = 2e-3
ALPHA2, ALPHA4, DIS = 0.3, 4e-3, 0.7


def _abs(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _fields(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in shapes]


def _bcs(pkg, D):
    return ((pkg.PeriodicBC(), pkg.PeriodicBC()),) * D


def _setups(n, D=3, *, gdir=1, dodissipation=True, Re=500.0, **tkw):
    """The JAX and the port's periodic setups with a temperature equation."""
    x = (np.linspace(0.0, 1.0, n + 1),) * D
    out = []
    for pkg, dtype, kw in ((ins, jnp.float64, {}), (it, torch.float64, dict(device="cpu"))):
        te = pkg.temperature_equation(Pr=0.71, Ra=1e5, Ge=0.4, boundary_conditions=_bcs(pkg, D),
                                      gdir=gdir, dodissipation=dodissipation, dtype=dtype, **tkw)
        out.append(pkg.Setup(x=x, boundary_conditions=_bcs(pkg, D), Re=Re, temperature=te,
                             dtype=dtype, **kw))
    return out


def _state(n, D=3, seed=0):
    rng = np.random.default_rng(seed)
    return 0.1 * rng.standard_normal((D,) + (n,) * D), 0.5 + 0.1 * rng.standard_normal((n,) * D)


# --------------------------------------------------------------------------
# coefficients and initial fields
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("nondim_type", [1, 2, 3])
def test_temperature_equation_matches_jax(nondim_type, dtype):
    """The coefficients equal the JAX package's in the working dtype, and
    so does Setup's default Re = 1/alpha1."""
    kw = dict(Pr=0.71, Ra=1e7, Ge=1.0, dodissipation=True, gdir=2, nondim_type=nondim_type)
    tj = ins.temperature_equation(boundary_conditions=_bcs(ins, 3), dtype=getattr(jnp, dtype),
                                  **kw)
    tt = it.temperature_equation(boundary_conditions=_bcs(it, 3), dtype=getattr(torch, dtype),
                                 **kw)
    for name in ("alpha1", "alpha2", "alpha3", "alpha4", "gamma"):
        assert getattr(tt, name) == float(getattr(tj, name)), name
    assert tt.gdir == tj.gdir == 2 and tt.dodissipation is tj.dodissipation is True
    x = (np.linspace(0.0, 1.0, 5),) * 3
    sj = ins.Setup(x=x, temperature=tj, dtype=getattr(jnp, dtype))
    st = it.Setup(x=x, temperature=tt, dtype=getattr(torch, dtype), device="cpu")
    assert np.asarray(st.Re, dtype=dtype) == np.asarray(sj.Re)
    assert st.temperature is tt


@pytest.mark.parametrize("D", [2, 3])
def test_temperaturefield_matches_jax(D):
    sj, st = _setups(6 if D == 3 else 10, D)

    def f(pkg):
        return lambda *x: 0.5 + 0.1 * pkg.sin(2 * np.pi * x[0]) * pkg.cos(2 * np.pi * x[-1])

    ref = np.asarray(jax.jit(lambda: ins.temperaturefield(sj, f(jnp)))())
    got = it.temperaturefield(st, f(torch))
    assert got.shape == ref.shape and got.dtype == torch.float64
    assert _abs(got.numpy(), ref) < 1e-15
    assert torch.equal(it.scalarfield(st), torch.zeros(st.grid.N, dtype=torch.float64))


# --------------------------------------------------------------------------
# the stage kernels' temperature stream
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def projs():
    jp = jax_make_fused_projection((N,) * 3, DXS, jnp.float64, precision="highest",
                                   interpret=True)
    tp = make_fused_projection((N,) * 3, DXS, torch.float64, precision="highest", device="cpu")
    return jp, tp


# the three stream layouts (T elided with usnew; tstart; tstart + tacc
# with usnew), each met twice over the six (gdir, dissipation) pairs
MSD_CASES = [(0, True, "elided"), (0, False, "tstart"), (1, True, "tstart+tacc"),
             (1, False, "elided"), (2, True, "tstart"), (2, False, "tstart+tacc")]


@pytest.mark.parametrize("gdir,dis,layout", MSD_CASES,
                         ids=[f"g{g}-dis{int(d)}-{lay}" for g, d, lay in MSD_CASES])
def test_momentum_stage_divhat_3d_temperature_matches_pallas(projs, gdir, dis, layout):
    jp, tp = projs
    u, T, Ts, Ta = _fields(10 + gdir, (3, N, N, N), (N,) * 3, (N,) * 3, (N,) * 3)
    tstart = None if layout == "elided" else Ts
    tacc = Ta if layout == "tstart+tacc" else None
    unc = None if layout == "tstart" else 0.4
    temp = lambda c: (c(T), c(tstart) if tstart is not None else None,  # noqa: E731
                      c(tacc) if tacc is not None else None, gdir, ALPHA2, ALPHA4,
                      DIS if dis else None)
    ref = jpk.momentum_stage_divhat_3d(
        jnp.asarray(u), (jnp.asarray(u),), (0.17,), VISC, DXS, jp["Vinv"], jp["VinvT"],
        precision="highest", interpret=True, usnew_coeff=unc, temperature=temp(jnp.asarray),
    )
    got = sk.momentum_stage_divhat_3d_plain(
        _t(u), (_t(u),), (0.17,), VISC, DXS, tp["Vinv"], tp["VinvT"], precision="highest",
        usnew_coeff=unc, temperature=temp(_t),
    )
    # (k, ut, divhat, usnew?, temp_next, tempnew?)
    assert len(got) == len(ref) == (6 if unc is not None else 4)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert _abs(g.numpy(), r) < TOL_KERNEL, i
    # the wrapper takes the plain version on CPU tensors
    wrapped = sk.momentum_stage_divhat_3d(
        _t(u), (_t(u),), (0.17,), VISC, DXS, tp["Vinv"], tp["VinvT"], usnew_coeff=unc,
        temperature=temp(_t))
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))


@pytest.mark.parametrize("layout", ["recon+emit_u+usnew", "stream+tstart"])
def test_pcmsd_hat_3d_temperature_matches_pallas(projs, layout):
    jp, tp = projs
    ut_prev, qhat, ustart, T, Ts = _fields(20, (3, N, N, N), (N,) * 3, (3, N, N, N), (N,) * 3,
                                           (N,) * 3)
    qhat = 0.1 * qhat
    if layout == "recon+emit_u+usnew":
        jstreams, tstreams = (jpk.RECON,), (sk.RECON,)
        kw = dict(emit_k=False, usnew_coeff=0.35, emit_u=True)
        tstart, gdir, dis = None, 2, DIS
    else:
        jstreams, tstreams = (jnp.asarray(ustart),), (_t(ustart),)
        kw = dict(emit_k=True)
        tstart, gdir, dis = Ts, 0, None
    ref = jpk.pcmsd_hat_3d(
        jnp.asarray(ut_prev), jnp.asarray(qhat), jstreams, (0.21,), VISC, DXS, jp,
        precision="highest", interpret=True,
        temperature=(jnp.asarray(T), _j(tstart), None, gdir, ALPHA2, ALPHA4, dis), **kw,
    )
    got = sk.pcmsd_hat_3d_plain(
        _t(ut_prev), _t(qhat), tstreams, (0.21,), VISC, DXS, tp, precision="highest",
        temperature=(_t(T), None if tstart is None else _t(tstart), None, gdir, ALPHA2,
                     ALPHA4, dis), **kw,
    )
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert _abs(g.numpy(), r) < TOL_KERNEL, i


def test_temperature_stream_rules(projs):
    """The JAX wrappers' asserts: tacc needs tstart and usnew, and the
    stage takes no k streams; a bad gdir raises too."""
    _, tp = projs
    u, T = (_t(a) for a in _fields(30, (3, N, N, N), (N,) * 3))
    args = (u, (u,), (0.2,), VISC, DXS, tp["Vinv"], tp["VinvT"])
    bad = [
        dict(temperature=(T, None, T, 0, 1.0, 1.0, None), usnew_coeff=0.1),
        dict(temperature=(T, T, T, 0, 1.0, 1.0, None)),
        dict(temperature=(T, None, None, 3, 1.0, 1.0, None)),
    ]
    for kw in bad:
        with pytest.raises(ValueError, match="temperature"):
            sk.momentum_stage_divhat_3d(*args, **kw)
    with pytest.raises(ValueError, match="k streams"):
        sk.momentum_stage_divhat_3d(u, (u, u), (0.1, 0.2), *args[3:],
                                    temperature=(T, None, None, 0, 1.0, 1.0, None))


# --------------------------------------------------------------------------
# the 3-pass Poisson solve
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 6], ids=["folded", "dense"])
def test_make_poisson_pallas_matches_jax(n):
    dxs = (1.0 / n, 0.7 / n, 1.3 / n)
    (f,) = _fields(40 + n, (n,) * 3)
    f = f - f.mean()
    ref = jax_make_poisson_pallas((n,) * 3, dxs, jnp.float64, precision="highest",
                                  interpret=True)(jnp.asarray(f))
    launches.reset_counts()
    got = make_poisson_pallas((n,) * 3, dxs, torch.float64, precision="highest",
                              device="cpu")(_t(f))
    plain = make_poisson_pallas((n,) * 3, dxs, torch.float64, device="cpu", plain=True)(_t(f))
    mm = make_poisson_mm((n,) * 3, dxs, torch.float64, device="cpu")(_t(f))
    assert not any(launches.LAUNCHES.values())  # CPU: plain versions only
    scale = float(np.max(np.abs(np.asarray(ref))))
    assert _abs(got.numpy(), ref) < 1e-12 * scale
    assert torch.equal(got, plain)
    assert _abs(got.numpy(), mm.numpy()) < 1e-12 * scale


# --------------------------------------------------------------------------
# the chains
# --------------------------------------------------------------------------


def _jax_roll_steps(jset, method, u, T, dt, nsteps):
    step = jax.jit(jax_make_fast_timestep(jset, method, _force_roll=True))
    s = JaxStepperState(u=jnp.asarray(u), temp=jnp.asarray(T), t=jnp.float64(0.0), n=0)
    for _ in range(nsteps):
        s = step(s, jnp.asarray(dt), None)
    return np.asarray(s.u), np.asarray(s.temp)


def _port_hat_steps(tset, method, u, T, dt, nsteps):
    to_hat, step_hat, from_hat = make_fast_timestep_hat(tset, method)
    h = to_hat(it.create_stepper(method, setup=tset, u=_t(u), temp=_t(T)))
    for _ in range(nsteps):
        h = step_hat(h, dt)
    assert h.n == nsteps and h.t == pytest.approx(nsteps * dt)
    return from_hat(h)


def test_rk44_hat_chain_matches_jax_fused_interpret_chain():
    """3 RK44 steps of the hat carry with temperature (dissipation on,
    gdir 1) == the JAX package's fused chain with every Pallas kernel in
    interpret mode, 8³."""
    jset, tset = _setups(N)
    u, T = _state(N)
    to_hat, step_hat, from_hat = jax_make_fast_timestep_hat(
        jset, ins.RKMethods.RK44(), projection_precision="highest", _fused_interpret=True)

    # one step compiled once and called three times (an unrolled jit of
    # three steps compiles the interpreted kernels three times over)
    step = jax.jit(lambda h: step_hat(h, 1e-3, None))
    h = jax.jit(to_hat)(JaxStepperState(u=jnp.asarray(u), temp=jnp.asarray(T),
                                        t=jnp.float64(0.0), n=0))
    for _ in range(3):
        h = step(h)
    ref = jax.jit(from_hat)(h)
    assert hat_chain_applicable(tset, it.RKMethods.RK44())
    got = _port_hat_steps(tset, it.RKMethods.RK44(), u, T, 1e-3, 3)
    assert _abs(got.u.numpy(), ref.u) < TOL_CHAIN
    assert _abs(got.temp.numpy(), ref.temp) < TOL_CHAIN


@pytest.mark.parametrize("dis,gdir", [(False, 0), (True, 2)], ids=["g0-nodis", "g2-dis"])
def test_rk44_temperature_chains_match_jax_roll_twin(dis, gdir):
    """The hat chain and the per-step chain with temperature == the JAX
    roll twin (which the JAX package pins to its fused chain), 16³."""
    jset, tset = _setups(16, gdir=gdir, dodissipation=dis)
    u, T = _state(16, seed=2)
    ru, rT = _jax_roll_steps(jset, ins.RKMethods.RK44(), u, T, 1e-3, 3)
    got = _port_hat_steps(tset, it.RKMethods.RK44(), u, T, 1e-3, 3)
    assert _abs(got.u.numpy(), ru) < TOL_CHAIN and _abs(got.temp.numpy(), rT) < TOL_CHAIN
    step = make_fast_timestep(tset, it.RKMethods.RK44())
    s = it.create_stepper(it.RKMethods.RK44(), setup=tset, u=_t(u), temp=_t(T))
    for _ in range(3):
        s = step(s, 1e-3)
    assert _abs(s.u.numpy(), ru) < TOL_CHAIN and _abs(s.temp.numpy(), rT) < TOL_CHAIN


@pytest.mark.parametrize("method", ["rk44", "lmwray3"])
def test_roll_twin_2d_temperature_matches_jax(method):
    jset, tset = _setups(16, D=2, gdir=1)
    mj, mt = ((ins.RKMethods.RK44(), it.RKMethods.RK44()) if method == "rk44"
              else (ins.LMWray3(), it.LMWray3()))
    u, T = _state(16, D=2, seed=3)
    ru, rT = _jax_roll_steps(jset, mj, u, T, 1e-3, 3)
    assert not hat_chain_applicable(tset, mt)
    step = make_fast_timestep(tset, mt)
    s = it.create_stepper(mt, setup=tset, u=_t(u), temp=_t(T))
    for _ in range(3):
        s = step(s, 1e-3)
    assert _abs(s.u.numpy(), ru) < TOL_CHAIN and _abs(s.temp.numpy(), rT) < TOL_CHAIN


def test_temperature_mean_is_conserved_without_dissipation():
    """The temperature RHS is a flux divergence: with no dissipation the
    mean of T holds to round-off over 5 steps of the hat chain."""
    _, tset = _setups(N, gdir=2, dodissipation=False)
    u, T = _state(N, seed=4)
    u = strip_ghosts(it.velocityfield(tset, lambda a, x, y, z: 0.0 * x + float(a == 0)
                                      + 0.1 * torch.sin(2 * np.pi * y)))
    for method in (it.RKMethods.RK44(), it.LMWray3()):
        got = _port_hat_steps(tset, method, u.numpy(), T, 1e-3, 5)
        assert abs(float(got.temp.mean()) - float(T.mean())) < 1e-13
        assert _abs(got.temp.numpy(), T) > 1e-6  # T did move


# --------------------------------------------------------------------------
# the solver and the observer
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _solver_u0(n):
    jset, _ = _setups(n)
    return np.array(jax.jit(lambda k: ins.random_field(jset, kp=3, rng=k))(jax.random.PRNGKey(5)))


@pytest.mark.parametrize("method", ["rk44", "lmwray3"])
def test_solve_unsteady_with_temperature_matches_jax(method, capsys):
    """`solve_unsteady(tempstart=)` with `timelogger` and `observe_nusselt`
    == `ins.solve_unsteady`, 16³, 4 steps in chunks of 2."""
    n = 16
    jset, tset = _setups(n, gdir=1)
    mj, mt = ((ins.RKMethods.RK44(), it.RKMethods.RK44()) if method == "rk44"
              else (ins.LMWray3(), it.LMWray3()))
    u0 = _solver_u0(n)

    def t0(lib):
        return lambda x, y, z: 0.5 + 0.1 * lib.sin(2 * np.pi * x) + 0.05 * lib.cos(2 * np.pi * z)

    T0j = jax.jit(lambda: ins.temperaturefield(jset, t0(jnp)))()
    T0t = it.temperaturefield(tset, t0(torch))
    assert _abs(T0t.numpy(), T0j) < 1e-15
    kw = dict(tlims=(0.0, 4e-3), dt=1e-3)
    ref, rout = ins.solve_unsteady(setup=jset, ustart=jnp.asarray(u0), tempstart=T0j, method=mj,
                                   processors={"nu": ins.processors.observe_nusselt(jset,
                                                                                     nupdate=2)},
                                   **kw)
    launches.reset_counts()
    got, outs = it.solve_unsteady(
        setup=tset, ustart=_t(u0), tempstart=T0t, method=mt, **kw,
        processors={"nu": it.observe_nusselt(tset, nupdate=2), "log": it.timelogger(nupdate=2)},
    )
    assert not any(launches.LAUNCHES.values())  # CPU: plain versions only
    assert got.n == 4 and got.t == pytest.approx(4e-3)
    assert got.u.shape == u0.shape and got.temp.shape == T0t.shape
    scale = float(np.max(np.abs(np.asarray(ref.u))))
    assert _abs(got.u.numpy(), ref.u) < TOL_SOLVE * scale
    assert _abs(got.temp.numpy(), ref.temp) < TOL_SOLVE
    assert outs["nu"]["t"] == pytest.approx(rout["nu"]["t"]) and len(outs["nu"]["Nu"]) == 3
    assert np.max(np.abs(np.array(outs["nu"]["Nu"]) - np.array(rout["nu"]["Nu"]))) < TOL_SOLVE
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Iteration")]
    assert [ln.split()[1] for ln in lines] == ["2", "4"]


def test_observe_nusselt_matches_jax_and_needs_temperature():
    jset, tset = _setups(8, D=2, gdir=1)
    rng = np.random.default_rng(6)
    u = rng.standard_normal((2, 10, 10))
    T = np.asarray(jax.jit(lambda: ins.temperaturefield(
        jset, lambda x, y: 0.5 + 0.2 * jnp.sin(2 * np.pi * y)))())
    st = {"u": u, "temp": T, "t": 0.0, "n": 0}
    ref = ins.processors.observe_nusselt(jset).initialize(
        dict(st, u=jnp.asarray(u), temp=jnp.asarray(T)))
    got = it.observe_nusselt(tset).initialize(dict(st, u=_t(u), temp=_t(T)))
    assert got["Nu"][0] == pytest.approx(ref["Nu"][0], rel=1e-14)
    plain = it.Setup(x=(np.linspace(0, 1, 9),) * 2, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="temperature"):
        it.observe_nusselt(plain)


def test_nan_guard_checks_temperature():
    _, tset = _setups(N, gdir=2)
    u0 = it.random_field(tset, kp=2, generator=torch.Generator().manual_seed(8))
    T0 = it.temperaturefield(tset, lambda x, y, z: 0.5 + 0.0 * x)
    T0[3, 3, 3] = float("nan")
    with pytest.raises(it.SolverDivergedError, match="non-finite") as err:
        it.solve_unsteady(setup=tset, ustart=u0, tempstart=T0, tlims=(0.0, 2e-3), dt=1e-3)
    assert err.value.state["n"] == 0


# --------------------------------------------------------------------------
# state and constants across the packages
# --------------------------------------------------------------------------


def test_convert_carries_temperature():
    rng = np.random.default_rng(9)
    u, T, q = rng.standard_normal((3, 8, 8, 8)), rng.standard_normal((8, 8, 8)), \
        rng.standard_normal((8, 8, 8))
    js = JaxStepperState(u=jnp.asarray(u), temp=jnp.asarray(T), t=jnp.asarray(0.5),
                         n=jnp.asarray(2))
    ts = convert.state_from_numpy(js, dtype=torch.float64, device="cpu")
    assert np.array_equal(ts.temp.numpy(), T)
    back = JaxStepperState(**convert.state_to_numpy(ts))
    assert np.array_equal(np.asarray(back.temp), T) and np.array_equal(np.asarray(back.u), u)
    jh = JaxHatState(ut=jnp.asarray(u), qhat=jnp.asarray(q), temp=jnp.asarray(T),
                     t=jnp.asarray(0.25), n=jnp.asarray(1))
    th = convert.state_from_numpy(jh, dtype=torch.float64, device="cpu")
    assert isinstance(th, HatState) and np.array_equal(th.temp.numpy(), T)
    back = JaxHatState(**convert.state_to_numpy(th))
    assert np.array_equal(np.asarray(back.temp), T) and np.array_equal(np.asarray(back.qhat), q)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_setup_constants_with_temperature_match_jax(dtype):
    x = (np.linspace(0, 1, 9),) * 3
    te_j = ins.temperature_equation(Pr=0.71, Ra=1e7, Ge=1.0, boundary_conditions=_bcs(ins, 3),
                                    gdir=2, dtype=getattr(jnp, dtype))
    te_t = it.temperature_equation(Pr=0.71, Ra=1e7, Ge=1.0, boundary_conditions=_bcs(it, 3),
                                   gdir=2, dtype=getattr(torch, dtype))
    sj = ins.Setup(x=x, temperature=te_j, dtype=getattr(jnp, dtype))
    st = it.Setup(x=x, temperature=te_t, dtype=getattr(torch, dtype), device="cpu")
    consts = {k: np.asarray(getattr(te_j, k)) for k in ("alpha1", "alpha2", "alpha3", "alpha4",
                                                        "gamma")}
    consts.update(Re=np.asarray(sj.Re), gdir=te_j.gdir)
    assert convert.check_setup_constants(st, consts) <= (1e-12 if dtype == "float64" else 1e-7)
    with pytest.raises(ValueError, match="gdir"):
        convert.check_setup_constants(st, dict(consts, gdir=1))
    with pytest.raises(ValueError, match="differ"):
        convert.check_setup_constants(st, dict(consts, alpha4=consts["alpha4"] * 1.01))
