"""The port's x-slab halo chain against the JAX package (CPU).

- The plain versions of the four halo kernels (`momentum_stage_divhat_halo_3d`,
  `pcmsd_hat_halo_3d`, `pressure_correct_qhat_halo_3d`, the sharded pass
  B) against the JAX kernels in Pallas interpret mode on a 16³ cube cut
  into x-slabs of 8 planes (ghost planes sliced from the global field,
  a nonzero y offset for pass B), in float64 with
  ``projection_precision="highest"``: 1e-10 relative (sums in another
  order only; measured ~1e-15).
- The port's halo chain on 2 gloo ranks, and on 4 (with 2 the left and
  right ring neighbours coincide), in spawned processes that import no
  jax (`tests/torch_halo_worker.py`), against the JAX package's
  single-device fast path from the same u0, 3 steps at 16³, RK44 and
  LMWray3, both forms (the per-step merged chain and the hat carry), and
  `solve_unsteady(halo=True)` on those ranks against the port's
  single-device `solve_unsteady`: float64, 1e-9 relative (the FFT
  projection of the reference against eigen-transforms).
- `solve_unsteady(halo=True)` on a one-rank group in this process
  against the port's single-device `solve_unsteady`: the same plain
  arithmetic, 1e-12.
- The options the port does not run raise NotImplementedError (the LES
  and the body force on this chain: `tests/test_torch_halo_les.py`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import ins_tpu as ins
from ins_tpu.ops import pallas_kernels as jpk
from ins_tpu.ops.fastpath import make_fast_timestep as jax_make_fast_timestep
from ins_tpu.ops.fastpath import strip_ghosts as jax_strip_ghosts
from ins_tpu.ops.poisson_pallas import make_fused_projection as jax_make_fused_projection
from ins_tpu.ops.poisson_pallas import make_passB_sharded as jax_make_passB_sharded
from ins_tpu.time_steppers.step import StepperState as JaxStepperState

import ins_tpu_torch as it
import torch_halo_helpers as hp
import torch_halo_worker as worker
from ins_tpu_torch.ops import launches
from ins_tpu_torch.ops import stage_kernels as sk
from ins_tpu_torch.ops.poisson_kernels import make_passB_sharded
from ins_tpu_torch.parallel import make_halo_fast_step, make_mesh
from torch_halo_helpers import one_rank  # noqa: F401  (a fixture)

TOL_KERNEL = 1e-10
TOL_CHAIN = 1e-9
TOL_SAME = 1e-12
N, LX, X0 = 16, 8, 8  # the second of two x-slabs
DXS = (2 * np.pi / N,) * 3
VISC = 1e-3
U0_KEY = 3
_rel, _t, _j = hp.rel, hp.t, hp.j
_blk = functools.partial(hp.blk, x0=X0, lx=LX)
_lo = functools.partial(hp.lo, x0=X0)
_hi = functools.partial(hp.hi, x0=X0, lx=LX)


@functools.lru_cache(maxsize=None)
def _fields():
    rng = np.random.default_rng(61)
    u, s, k, ab = (rng.standard_normal((3, N, N, N)) for _ in range(4))
    return u, 0.1 * rng.standard_normal((N, N, N)), s, k, ab


@functools.lru_cache(maxsize=None)
def _projs():
    jp = jax_make_fused_projection((N,) * 3, DXS, jnp.float64, interpret=True,
                                   precision="highest")
    return jp, make_passB_sharded((N,) * 3, DXS, torch.float64, LX, device="cpu")


def _msd_case(pkg, streams_kind, wrapper=False):
    u, _, s, k, ab = _fields()
    jp, tp = _projs()
    cv = _j if pkg == "jax" else _t
    ul = cv(_blk(u))
    if streams_kind == "u":  # stage 0: u is its own tableau base, usnew
        streams, lo, coeffs, kw = (ul,), (cv(_lo(u, 1)),), (0.3,), dict(emit_k=False,
                                                                         usnew_coeff=0.1)
    else:  # a k stream, emit_k, an accumulator base
        streams = (cv(_blk(s)), cv(_blk(k)))
        lo = (cv(_lo(s, 1)), cv(_lo(k, 1)))
        coeffs, kw = (0.2, 0.3), dict(emit_k=True, usnew_coeff=0.1,
                                      usnew_base=cv(_blk(ab)))
    args = (ul, cv(_lo(u, 2)), cv(_hi(u, 1)), streams, lo, coeffs, VISC, DXS)
    if pkg == "jax":
        return jpk.momentum_stage_divhat_halo_3d(*args, jp["Vinv"], jp["VinvT"],
                                                 interpret=True, precision="highest", **kw)
    fn = sk.momentum_stage_divhat_halo_3d if wrapper else sk.momentum_stage_divhat_halo_3d_plain
    return fn(*args, tp["Vinv"], tp["VinvT"], **kw)


def _pcmsd_case(pkg, base, wrapper=False):
    u, q, s, _, ab = _fields()
    jp, tp = _projs()
    cv = _j if pkg == "jax" else _t
    mod = jpk if pkg == "jax" else sk
    if base == "recon":  # the hat carry's stage 0
        streams, lo, kw = (mod.RECON,), (mod.RECON,), dict(usnew_coeff=0.1, emit_u=True)
    else:  # an interior stage
        streams, lo, kw = (cv(_blk(s)),), (cv(_lo(s, 1)),), dict(usnew_coeff=0.1,
                                                                 usnew_base=cv(_blk(ab)))
    args = (cv(_blk(u)), cv(_lo(u, 2)), cv(_hi(u, 1)), cv(_blk(q)), cv(_lo(q, 2)),
            cv(_hi(q, 2)), streams, lo, (0.3,), VISC, DXS)
    if pkg == "jax":
        return jpk.pcmsd_hat_halo_3d(*args, jp, interpret=True, precision="highest",
                                     emit_k=False, **kw)
    fn = sk.pcmsd_hat_halo_3d if wrapper else sk.pcmsd_hat_halo_3d_plain
    return fn(*args, tp, emit_k=False, **kw)


def _correct_case(pkg):
    u, q, *_ = _fields()
    jp, tp = _projs()
    if pkg == "jax":
        return (jpk.pressure_correct_qhat_halo_3d(
            _j(_blk(u)), _j(_blk(q)), _j(_hi(q, 1)), DXS, jp["V"], jp["VT"],
            interpret=True, precision="highest"),)
    return (sk.pressure_correct_qhat_halo_3d_plain(
        _t(_blk(u)), _t(_blk(q)), _t(_hi(q, 1)), DXS, tp["V"], tp["VT"]),)


def _passB_case(pkg, n):
    """Shard 1 of 2: the y-columns [n/2, n) with full x at yoff = n/2; the
    folded pass B at n = 16, the dense one at n = 18."""
    ly = n // 2
    dxs = (2 * np.pi / n,) * 3
    h = np.random.default_rng(n).standard_normal((n, n, n))[:, ly:]
    if pkg == "jax":
        proj = jax_make_passB_sharded((n,) * 3, dxs, jnp.float64, ly, interpret=True,
                                      precision="highest")
        return (proj["passB"](_j(h), ly),)
    proj = make_passB_sharded((n,) * 3, dxs, torch.float64, ly, device="cpu")
    return (proj["passB_plain"](_t(h), ly),)


KERNEL_CASES = {
    "msd_u_base_usnew": functools.partial(_msd_case, streams_kind="u"),
    "msd_k_stream_emit_k_accbase": functools.partial(_msd_case, streams_kind="k"),
    "pcmsd_recon_emit_u_usnew": functools.partial(_pcmsd_case, base="recon"),
    "pcmsd_stream_base_accbase": functools.partial(_pcmsd_case, base="stream"),
    "correct": _correct_case,
    "passB_fold_yoff": functools.partial(_passB_case, n=16),
    "passB_dense_yoff": functools.partial(_passB_case, n=18),
}


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_halo_plain_versions_match_pallas_interpret(case):
    """Each halo kernel's plain version == the JAX halo kernel (interpret
    mode), f64, on the second of two x-slabs of a 16³ cube."""
    ref = KERNEL_CASES[case]("jax")
    got = KERNEL_CASES[case]("torch")
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        assert _rel(g.numpy(), r) < TOL_KERNEL


def test_halo_wrappers_run_plain_on_cpu():
    """On CPU tensors the wrappers return their plain versions' results
    and launch nothing."""
    launches.reset_counts()
    for got, ref in ((_msd_case("torch", "k", wrapper=True), _msd_case("torch", "k")),
                     (_pcmsd_case("torch", "recon", wrapper=True),
                      _pcmsd_case("torch", "recon"))):
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    u, q, *_ = _fields()
    _, tp = _projs()
    got = sk.pressure_correct_qhat_halo_3d(_t(_blk(u)), _t(_blk(q)), _t(_hi(q, 1)), DXS,
                                           tp["V"], tp["VT"])
    assert torch.equal(got, _correct_case("torch")[0])
    h = _t(np.ones((N, LX, N)))
    assert torch.equal(tp["passB"](h, LX), tp["passB_plain"](h, LX))
    assert all(v == 0 for v in launches.LAUNCHES.values())


# --------------------------------------------------------------------------
# the chain on 2 gloo ranks
# --------------------------------------------------------------------------


def _jax_steps(method, nsteps):
    x = (np.linspace(0, 2 * np.pi, worker.N + 1),) * 3
    jset = ins.Setup(x=x, Re=1e3, dtype=jnp.float64)
    step = jax.jit(jax_make_fast_timestep(jset, method))
    s = JaxStepperState(u=jax_strip_ghosts(jnp.asarray(hp.u0(U0_KEY))), temp=None,
                        t=jnp.asarray(0.0), n=jnp.asarray(0))
    for _ in range(nsteps):
        s = step(s, jnp.asarray(worker.DT), None)
    return np.asarray(s.u)


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, tmp_path_factory):
    """Run `torch_halo_worker.run` (the "dns" setup) on 2 (and 4) spawned
    gloo ranks; the world size and the directory of their results.  With
    2 ranks the left and right ring neighbours are one rank, so only 4
    tell the ring's two directions apart."""
    world = request.param
    data = tmp_path_factory.mktemp(f"halo{world}")
    np.save(data / "u0.npy", hp.u0(U0_KEY))
    mp.spawn(worker.run, args=(world, str(data / "store"), str(data), ("dns",), "dns"),
             nprocs=world, join=True)
    return world, data


@pytest.mark.parametrize("form", ["step", "hat"])
@pytest.mark.parametrize("method", ["rk44", "lmwray3"])
def test_halo_chain_on_gloo_ranks_matches_jax_fast_path(ranks, method, form):
    """3 steps of the halo chain on 2 and 4 gloo ranks (the per-step
    merged chain and the hat carry) == the JAX single-device fast path."""
    world, data = ranks
    m = ins.RKMethods.RK44() if method == "rk44" else ins.LMWray3()
    ref = _jax_steps(m, worker.NSTEPS)
    for rank in range(world):
        got = np.load(data / f"dns_{method}_{form}_r{rank}.npy")
        assert got.shape == ref.shape
        assert _rel(got, ref) < TOL_CHAIN


def _single_device_solve(nsteps, chunk):
    setup = worker.setup_f64()
    return it.solve_unsteady(
        setup=setup, ustart=_t(hp.u0(U0_KEY)), tlims=(0.0, nsteps * worker.DT), dt=worker.DT,
        processors={"e": it.observefield(
            lambda st: it.total_kinetic_energy(st["u"], setup), nupdate=chunk)},
    )


def test_solve_unsteady_on_gloo_ranks_matches_single_device(ranks):
    """`solve_unsteady(halo=True)` on 2 and 4 ranks returns the global
    ghosted field on each, and its processors see the global field: both
    equal the single-device run's."""
    world, data = ranks
    ref, outs = _single_device_solve(4, 2)
    e_ref = np.array([float(e) for e in outs["e"]])
    for rank in range(world):
        assert _rel(np.load(data / f"solve_r{rank}.npy"), ref.u.numpy()) < TOL_CHAIN
        assert _rel(np.load(data / f"solve_e_r{rank}.npy"), e_ref) < TOL_CHAIN


# --------------------------------------------------------------------------
# one rank in this process
# --------------------------------------------------------------------------


def test_one_rank_solve_unsteady_halo_matches_single_device(one_rank):
    assert (one_rank.rank, one_rank.size) == (0, 1)
    setup = worker.setup_f64()
    ref, outs = _single_device_solve(4, 2)
    state, got = it.solve_unsteady(
        setup=setup, ustart=_t(hp.u0(U0_KEY)), tlims=(0.0, 4 * worker.DT), dt=worker.DT,
        mesh=one_rank, halo=True,
        processors={"e": it.observefield(
            lambda st: it.total_kinetic_energy(st["u"], setup), nupdate=2)},
    )
    assert state.n == 4 and state.u.shape == ref.u.shape
    assert _rel(state.u.numpy(), ref.u.numpy()) < TOL_SAME
    assert _rel([float(e) for e in got["e"]], [float(e) for e in outs["e"]]) < TOL_SAME


def _cube(n=16, **kw):
    x = (np.linspace(0, 2 * np.pi, n + 1),) * 3
    return it.Setup(device="cpu", x=x, Re=1e3, dtype=torch.float64, **kw)


UNPORTED = {
    "cg": (dict(psolver="cg"), {}, NotImplementedError, "cg"),
    "modular": (dict(fused=False), {}, NotImplementedError, "modular"),
    "unmerged": (dict(merge=False), {}, NotImplementedError, "unmerged"),
    "wray3": (dict(method="wray3"), {}, NotImplementedError, "classic-row"),
    "temperature": ({}, dict(temperature=True), NotImplementedError, "temperature"),
    "non_cube": ({}, dict(x=(np.linspace(0, 1, 17), np.linspace(0, 1, 9),
                             np.linspace(0, 1, 9))), NotImplementedError, "pencil FFT"),
}


@pytest.mark.parametrize("case", list(UNPORTED))
def test_unported_halo_options_raise(one_rank, case):
    kw, setup_kw, err, match = UNPORTED[case]
    kw = dict(kw)
    method = it.RKMethods.Wray3() if kw.pop("method", None) else it.RKMethods.RK44()
    if setup_kw.get("temperature"):
        bc = ((it.PeriodicBC(), it.PeriodicBC()),) * 3
        setup_kw = dict(temperature=it.temperature_equation(
            Pr=0.71, Ra=1e5, Ge=0.1, boundary_conditions=bc, dtype=torch.float64))
    if "x" in setup_kw:
        setup = it.Setup(device="cpu", dtype=torch.float64, **setup_kw)
    else:
        setup = _cube(**setup_kw)
    with pytest.raises(err, match=match):
        make_halo_fast_step(setup, method, one_rank, **kw)


def test_unported_meshes_and_solver_options_raise(one_rank):
    with pytest.raises(NotImplementedError, match="2-D pencil"):
        make_mesh((2, 2), device="cpu")
    setup = _cube()
    u0 = torch.zeros(3, 18, 18, 18, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="GSPMD"):
        it.solve_unsteady(setup=setup, ustart=u0, tlims=(0.0, 0.1), dt=0.1, mesh=one_rank)
    with pytest.raises(ValueError, match="requires a mesh"):
        it.solve_unsteady(setup=setup, ustart=u0, tlims=(0.0, 0.1), dt=0.1, halo=True)
