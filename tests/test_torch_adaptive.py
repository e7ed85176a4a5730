"""Adaptive (CFL) time stepping in the port against the JAX package (CPU,
f64).

`get_cfl_timestep` on a periodic cube, a walled stretched box, a channel
and a 2-D cavity, ghosted and (where a path carries it) interior, and on
the x-slabs of a halo mesh: equal to the JAX package's bit for bit.
`solve_unsteady(dt=None)` on the 16³ RK44 hat chain (cfl 0.5, the CFL
recomputed every step and every second step, with processors at
`nupdate` 3, which cut the run into chunks of 3, and with a `dt_min`
above the CFL limit), its Smagorinsky LES, the SSP33 fused unmerged
chain, the 8³ periodic Boussinesq hat chain, and the general path on a
2-D lid-driven cavity (a cosine grid) with RK44 and `psolver_cg`, AB-CN,
one-leg, LMWray3 and BE11 by Picard iteration: the same step count as
the JAX package's run (which steps its roll route on the CPU), the final
t within 1e-14 and u (and the temperature) within 1e-10.  A dt that no
longer advances t raises `SolverDivergedError`.

Where the JAX package cannot run the case, the port's adaptive run is
held bit for bit against its own chain stepped by hand with the dt that
`get_cfl_timestep` gives: the bf16 hat chain (the JAX package's bf16
storage lives in its Pallas kernels only, so its CPU run is float64:
the step count equals it and u lies within the bf16 chains' 5e-2 of it),
and the 64×32×32 channel (also held against the JAX package's CPU run,
its per-stage channel step: its adaptive loop reads ``t`` of its
`ChannelHat` carry, which has none, so on its kernels' path it raises
AttributeError).  The halo chain on 2 spawned gloo ranks equals the
single-device run to 1e-12.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import ins_tpu as ins
from ins_tpu.time_steppers import methods as jmethods

import ins_tpu_torch as it
import torch_halo_worker as worker
from ins_tpu_torch.ops.channelpath import make_channel_timestep_hat, strip_channel
from ins_tpu_torch.ops.fastpath import make_fast_timestep_hat, strip_ghosts
from ins_tpu_torch.solver import _cfl_box
from ins_tpu_torch.time_steppers import methods as tmethods

TOL = 1e-10
TOL_T = 1e-14
# a bf16 stream chain against its float run: the JAX package's bound
# (`tests/test_fastpath.py`), as `tests/test_torch_bf16.py` takes it
TOL_BF16 = 5e-2


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
# setups, built once per module (the JAX runs compile per setup)
# --------------------------------------------------------------------------


def _periodic_x(n=16, D=3):
    return (np.linspace(0, 2 * np.pi, n + 1),) * D


@functools.lru_cache(maxsize=None)
def _setups(name):
    """(JAX setup, port setup) of a case."""
    if name == "periodic":
        kw, x = dict(Re=1e3), _periodic_x()
    elif name == "les":
        x = _periodic_x()

        def kw_of(pk, dtype):
            base = pk.Setup(x=x, Re=1e3, dtype=dtype, **({"device": "cpu"} if pk is it else {}))
            return dict(Re=1e3, closure_model=pk.smagorinsky_closure_natural(base))
    elif name == "boussinesq":
        x = _periodic_x(8)

        def kw_of(pk, dtype):
            bc = ((pk.PeriodicBC(), pk.PeriodicBC()),) * 3
            return dict(temperature=pk.temperature_equation(
                Pr=0.71, Ra=1e5, Ge=0.1, boundary_conditions=bc, gdir=2, dtype=dtype))
    elif name == "cavity":
        x = (ins.cosine_grid(0.0, 1.0, 12), np.linspace(0.0, 1.0, 13))

        def kw_of(pk, dtype):
            d = pk.DirichletBC()
            return dict(Re=100.0, boundary_conditions=((d, d), (d, pk.DirichletBC((1.0, 0.0)))))
    elif name == "walled":
        x = (ins.tanh_grid(0, 1, 10, 1.3), ins.stretched_grid(0, 1, 8, 1.2), np.linspace(0, 1, 7))

        def kw_of(pk, dtype):
            d = pk.DirichletBC()
            return dict(Re=300.0, boundary_conditions=((d, d), (pk.SymmetricBC(), d),
                                                       (pk.PressureBC(), pk.PressureBC())))
    elif name == "channel":
        x = (np.linspace(0.0, 4 * np.pi, 65), np.linspace(0.0, 2 * np.pi, 33),
             ins.tanh_grid(0.0, 2.0, 32, 1.3))

        def kw_of(pk, dtype):
            p = (pk.PeriodicBC(), pk.PeriodicBC())
            return dict(Re=700.0, boundary_conditions=(p, p, (pk.DirichletBC(), pk.DirichletBC())))
    else:
        raise KeyError(name)
    if name == "periodic":
        return (ins.Setup(x=x, dtype=jnp.float64, **kw),
                it.Setup(x=x, dtype=torch.float64, device="cpu", **kw))
    return (ins.Setup(x=x, dtype=jnp.float64, **kw_of(ins, jnp.float64)),
            it.Setup(x=x, dtype=torch.float64, device="cpu", **kw_of(it, torch.float64)))


@functools.lru_cache(maxsize=None)
def _u0(name):
    """A ghosted start of the case (numpy): the JAX package's
    `random_field` on the periodic boxes, a projected random field
    elsewhere."""
    if name == "les":
        return _u0("periodic")
    js, _ = _setups(name)
    if all(js.grid.periodic):
        return np.array(jax.jit(lambda k: ins.random_field(js, kp=2 if js.grid.N[0] < 16 else 4,
                                                           rng=k))(jax.random.PRNGKey(0)))
    g = js.grid
    u = np.random.default_rng(3).standard_normal((g.dim, *g.N))
    ps = ins.default_psolver(js)
    return np.array(ins.project(ins.apply_bc_u(jnp.asarray(u), jnp.asarray(0.0), js), js,
                                psolver=ps))


def _temp0(js):
    g = js.grid
    T = 0.1 * np.random.default_rng(5).standard_normal(g.N)
    return ins.apply_bc_temp(jnp.asarray(T), jnp.asarray(0.0), js)


# --------------------------------------------------------------------------
# get_cfl_timestep
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["periodic", "walled", "channel", "cavity"])
def test_cfl_timestep_matches_jax(name):
    """The CFL limit of the ghosted field, and of the interior layout the
    periodic and channel paths carry (cut by `strip_ghosts` /
    `strip_channel`), equals the JAX package's; a zero field has only the
    diffusive limit."""
    js, ts = _setups(name)
    u = _u0(name) if name != "walled" else np.random.default_rng(2).standard_normal(
        (3, *js.grid.N))
    ref = float(ins.get_cfl_timestep(jnp.asarray(u), js))
    got = it.get_cfl_timestep(_t(u), ts)
    assert got.dtype == torch.float64 and got.dim() == 0
    assert got.item() == ref  # the same divisions and minima, bit for bit
    if name in ("periodic", "channel"):
        inner = (strip_ghosts if name == "periodic" else strip_channel)(_t(u))
        assert it.get_cfl_timestep(inner, ts).item() == got.item()
    zero = float(ins.get_cfl_timestep(jnp.zeros_like(jnp.asarray(u)), js))
    assert it.get_cfl_timestep(torch.zeros(u.shape, dtype=torch.float64), ts).item() == zero
    with pytest.raises(ValueError, match="layout"):
        it.get_cfl_timestep(_t(u)[:, 1:], ts)


def test_cfl_of_halo_slabs_is_the_global_limit():
    """Each rank's limit over its x-slab (the ghosted origin 1 + x0),
    reduced by the minimum, is the whole field's."""
    js, ts = _setups("periodic")
    u = strip_ghosts(_t(_u0("periodic")))
    whole = it.get_cfl_timestep(u, ts).item()
    for ranks in (2, 4):
        lx = u.shape[1] // ranks
        parts = [_cfl_box(u[:, r * lx:(r + 1) * lx], ts, (1 + r * lx, 1, 1)).item()
                 for r in range(ranks)]
        assert min(parts) == whole


# --------------------------------------------------------------------------
# solve_unsteady(dt=None) against the JAX package
# --------------------------------------------------------------------------


def _jax_psolver(name, js):
    return ins.psolver_cg(js, reltol=1e-12, maxiter=400) if name == "cavity" else None


def _port_psolver(name, ts):
    return it.psolver_cg(ts, reltol=1e-12, maxiter=400) if name == "cavity" else None


CASES = {
    # id: (setup, method name, tlims, solve keywords, processors' nupdate)
    "hat_n1": ("periodic", "RK44", (0.0, 0.3), dict(cfl=0.5), None),
    "hat_n2": ("periodic", "RK44", (0.0, 0.3), dict(cfl=0.5, n_adapt_dt=2), None),
    "hat_nupdate3": ("periodic", "RK44", (0.0, 0.3), dict(cfl=0.5), 3),
    "hat_dt_min": ("periodic", "RK44", (0.0, 0.2), dict(cfl=0.5, dt_min=0.05), None),
    "ssp33": ("periodic", "SSP33", (0.0, 0.2), dict(cfl=0.5), None),
    "boussinesq": ("boussinesq", "RK44", (0.0, 0.4), dict(cfl=0.9), None),
    "cavity_cg": ("cavity", "RK44", (0.0, 0.2), dict(cfl=0.9), None),
    "cavity_abcn": ("cavity", "ABCN", (0.0, 0.1), dict(cfl=0.5), None),
    "cavity_oneleg": ("cavity", "OneLeg", (0.0, 0.1), dict(cfl=0.5), None),
    "cavity_lmwray3": ("cavity", "LMWray3", (0.0, 0.1), dict(cfl=0.9), None),
    "cavity_be11": ("cavity", "BE11", (0.0, 0.03), dict(cfl=0.2), None),
    "les": ("les", "RK44", (0.0, 0.3), dict(cfl=0.5, theta=0.17), None),
}


def _method(pk, name):
    if name == "ABCN":
        return (tmethods if pk is it else jmethods).AdamsBashforthCrankNicolsonMethod()
    if name == "OneLeg":
        return (tmethods if pk is it else jmethods).OneLegMethod()
    if name == "LMWray3":
        return pk.LMWray3()
    if name == "BE11":
        return pk.RKMethods.BE11(newton_type="picard")
    return getattr(pk.RKMethods, name)()


@pytest.mark.parametrize("case", list(CASES))
def test_adaptive_matches_jax(case):
    """Same step count, final t to 1e-14 and u (and the temperature) to
    1e-10; with processors, their records at the same steps."""
    name, mname, tlims, kw, nupdate = CASES[case]
    js, ts = _setups(name)
    u0 = _u0(name)
    jT = _temp0(js) if js.temperature is not None else None
    procs = {}
    if nupdate:
        procs = {pk: {"ke": pk.observefield(
            lambda s, pk=pk, st=st: pk.total_kinetic_energy(s["u"], st), nupdate=nupdate)}
            for pk, st in ((ins, js), (it, ts))}
    jst, jout = ins.solve_unsteady(setup=js, ustart=jnp.asarray(u0), tempstart=jT, tlims=tlims,
                                   dt=None, method=_method(ins, mname),
                                   psolver=_jax_psolver(name, js), processors=procs.get(ins),
                                   **kw)
    st, out = it.solve_unsteady(setup=ts, ustart=_t(u0),
                                tempstart=None if jT is None else _t(jT), tlims=tlims, dt=None,
                                method=_method(it, mname), psolver=_port_psolver(name, ts),
                                processors=procs.get(it), **kw)
    assert st.n == int(jst.n) and st.n > 2
    assert abs(float(st.t) - float(jst.t)) <= TOL_T
    assert isinstance(st.t, np.float64)
    assert _rel(st.u.numpy(), jst.u) < TOL
    if jT is not None:
        assert _rel(st.temp.numpy(), jst.temp) < TOL
    if nupdate:
        assert len(out["ke"]) == len(jout["ke"]) == st.n // nupdate
        assert _rel([float(e) for e in out["ke"]], [float(e) for e in jout["ke"]]) < TOL
    if "dt_min" in kw:
        assert st.n == round((tlims[1] - tlims[0]) / kw["dt_min"])


def test_dt_underflow_raises():
    """A CFL limit too small to advance t (a Reynolds number of 1e-300
    at t = 1) raises SolverDivergedError with the last state; a
    ``dt_min`` that does advance it steps."""
    x = _periodic_x(8)
    s = it.Setup(x=x, Re=1e-300, dtype=torch.float64, device="cpu")
    u0 = torch.zeros((3, 10, 10, 10), dtype=torch.float64)
    with pytest.raises(it.SolverDivergedError, match="underflow") as err:
        it.solve_unsteady(setup=s, ustart=u0, tlims=(1.0, 2.0), dt=None)
    assert err.value.state["n"] == 0 and err.value.state["t"] == 1.0
    st, _ = it.solve_unsteady(setup=s, ustart=u0, tlims=(1.0, 2.0), dt=None, dt_min=0.25)
    assert st.n == 4 and st.t == 2.0


# --------------------------------------------------------------------------
# the port's own oracles: the chain stepped by hand with the CFL dt
# --------------------------------------------------------------------------


def _by_hand(to_c, step, from_c, state, setup, tlims, cfl):
    """The adaptive loop written out: each step's dt is cfl times the
    CFL limit of the corrected u, cut to what is left to tend."""
    c, dts = to_c(state._replace(t=np.float64(tlims[0]))), []
    tend = np.float64(tlims[1])
    while c.t < tend - 1e-14 * max(1.0, abs(tend)):
        dt = np.float64(cfl) * np.float64(it.get_cfl_timestep(from_c(c).u, setup).item())
        dt = min(dt, tend - c.t)
        dts.append(dt)
        c = step(c, dt)
    return from_c(c), dts


def test_bf16_hat_chain_adaptive():
    """The bf16 hat chain's adaptive run is its own chain stepped by hand
    bit for bit; its step count is the JAX package's float64 run's and u
    lies within the bf16 chains' bound of it."""
    js, ts = _setups("periodic")
    u0 = _u0("periodic")
    tlims, cfl = (0.0, 0.3), 0.5
    st, _ = it.solve_unsteady(setup=ts, ustart=_t(u0), tlims=tlims, dt=None, cfl=cfl,
                              stream_dtype=torch.bfloat16)
    to_hat, step_hat, from_hat = make_fast_timestep_hat(ts, it.RKMethods.RK44(),
                                                        stream_dtype=torch.bfloat16)
    s0 = it.create_stepper(it.RKMethods.RK44(), setup=ts, u=strip_ghosts(_t(u0)))
    ref, dts = _by_hand(to_hat, step_hat, from_hat, s0, ts, tlims, cfl)
    assert st.n == len(dts) and torch.equal(strip_ghosts(st.u), ref.u)
    jst, _ = ins.solve_unsteady(setup=js, ustart=jnp.asarray(u0), tlims=tlims, dt=None, cfl=cfl)
    assert st.n == int(jst.n)
    assert _rel(st.u.numpy(), jst.u) < TOL_BF16


def test_channel_adaptive_equals_fixed_step_chain():
    """The 64×32×32 channel: the adaptive run is the `ChannelHat` chain
    stepped by hand with `get_cfl_timestep`'s dt sequence, bit for bit,
    and the JAX package's run on the CPU, which steps its per-stage
    channel chain (its `ChannelHat` chain, which has no t, runs only with
    its Pallas kernels)."""
    js, ts = _setups("channel")
    u0 = _u0("channel")
    tlims, cfl = (0.0, 0.06), 0.9
    st, _ = it.solve_unsteady(setup=ts, ustart=_t(u0), tlims=tlims, dt=None, cfl=cfl)
    to_hat, step_hat, from_hat = make_channel_timestep_hat(ts, it.RKMethods.RK44())
    s0 = it.create_stepper(it.RKMethods.RK44(), setup=ts, u=strip_channel(_t(u0)))
    ref, dts = _by_hand(to_hat, step_hat, from_hat, s0, ts, tlims, cfl)
    assert st.n == len(dts) >= 3 and len(set(dts)) > 1
    assert torch.equal(strip_channel(st.u), ref.u) and st.t == ref.t
    jst, _ = ins.solve_unsteady(setup=js, ustart=jnp.asarray(u0), tlims=tlims, dt=None, cfl=cfl)
    assert st.n == int(jst.n) and abs(float(st.t) - float(jst.t)) <= TOL_T
    assert _rel(st.u.numpy(), jst.u) < TOL


# --------------------------------------------------------------------------
# the halo chain on 2 gloo ranks
# --------------------------------------------------------------------------


def test_halo_adaptive_on_two_ranks(tmp_path):
    """`solve_unsteady(mesh=, halo=True, dt=None)` on 2 spawned gloo
    ranks (each slab's CFL limit, then all_reduce MIN) == the
    single-device run: the same steps, u to 1e-12."""
    ts = worker.setup_f64("dns")
    u0 = _u0("periodic")
    np.save(tmp_path / "u0.npy", u0)
    mp.spawn(worker.run_adaptive, args=(2, str(tmp_path / "store"), str(tmp_path)), nprocs=2,
             join=True)
    ref, _ = it.solve_unsteady(setup=ts, ustart=_t(u0), dt=None, **worker.ADAPTIVE)
    for r in range(2):
        got = np.load(tmp_path / f"adaptive_r{r}.npy")
        n, t = np.load(tmp_path / f"adaptive_nt_r{r}.npy")
        assert n == ref.n and t == ref.t
        assert _rel(got, ref.u.numpy()) < 1e-12
