"""The port's Smagorinsky LES and steady body force on the x-slab halo
chain against the JAX package (CPU, f64).

On CPU tensors the halo force kernel and the halo stage kernels' force
stream run their plain versions, so these tests hold the port's
arithmetic against the JAX package: its Pallas kernels in interpret mode
at ``precision="highest"`` and its single-device fast path.  The CUDA
kernels run only on the card: `chip_smoke.py` holds each against its
plain version and against the single-device kernels' rows.

- The plain `smagorinsky_force_halo_3d` against the JAX kernel on x-slabs
  of 4 and 8 planes of a 16³ cube (ghost planes cut from the global
  field), with and without a body force and on u rebuilt from a pressure:
  1e-12 relative (summation order only; measured ~2e-16).
- The plain halo stage kernels with ``bodyforce=``/``bodyforce_lo=`` and
  with ``smag=`` (the widened ghosts (3, 2) and (3, 3)) against the JAX
  halo kernels, whose ``smag=`` fuses the force: 1e-12.
- The halo chain on 2 and 4 spawned gloo ranks (`torch_halo_worker`,
  which imports no jax), RK44 and LMWray3, both forms, with the LES (θ =
  0.17), with the LES plus a steady body force and with the body force
  alone, against the JAX single-device fast path from the same u0 (3
  steps), and
  `solve_unsteady(halo=True, theta=)` on those ranks against the port's
  single-device LES: 1e-9 (the FFT projection of the reference against
  eigen-transforms).
- `solve_unsteady(halo=True, theta=)` on one rank in this process
  against the port's single-device `solve_unsteady`, for the same three
  setups: 1e-12.
- The options that stay unported raise.
"""

import dataclasses
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
from ins_tpu.time_steppers.step import StepperState as JaxStepperState

import ins_tpu_torch as it
import torch_halo_helpers as hp
import torch_halo_worker as worker
from ins_tpu_torch.ops import launches
from ins_tpu_torch.ops import smag_kernels as smk
from ins_tpu_torch.ops import stage_kernels as sk
from ins_tpu_torch.ops.poisson_kernels import make_passB_sharded
from ins_tpu_torch.parallel import make_halo_fast_step
from ins_tpu_torch.parallel.mesh import Mesh
from torch_halo_helpers import one_rank  # noqa: F401  (a fixture)

TOL_KERNEL = 1e-12
TOL_CHAIN = 1e-9
TOL_SAME = 1e-12
N = 16
DXS = (2 * np.pi / N,) * 3
D2 = float(sum(d * d for d in DXS))
VISC = 1e-3
THETA = worker.THETA
SLABS = {4: 12, 8: 8}  # lx: x0 (the last of 4 slabs, the second of 2)


U0_KEY = 5
_rel, _t, _j = hp.rel, hp.t, hp.j


def _blk(a, lx):
    return hp.blk(a, SLABS[lx], lx)


def _lo(a, k, lx):
    return hp.lo(a, k, SLABS[lx])


def _hi(a, k, lx):
    return hp.hi(a, k, SLABS[lx], lx)


def _grad(q):
    return np.stack([(np.roll(q, -1, axis=a) - q) / DXS[a] for a in range(3)])


@functools.lru_cache(maxsize=None)
def _fields():
    rng = np.random.default_rng(71)
    u, s, k, ab, bf = (rng.standard_normal((3, N, N, N)) for _ in range(5))
    return u, 0.1 * rng.standard_normal((N, N, N)), s, k, ab, bf


@functools.lru_cache(maxsize=None)
def _projs():
    jp = jax_make_fused_projection((N,) * 3, DXS, jnp.float64, interpret=True,
                                   precision="highest")
    return jp, {lx: make_passB_sharded((N,) * 3, DXS, torch.float64, lx, device="cpu")
                for lx in SLABS}


# --------------------------------------------------------------------------
# the halo force kernel
# --------------------------------------------------------------------------


@pytest.mark.parametrize("lx", list(SLABS))
@pytest.mark.parametrize("mode", ["u", "bodyforce", "rebuild"])
def test_smagorinsky_force_halo_plain_matches_pallas(lx, mode):
    """The plain version == the JAX kernel (interpret) on x-slabs of 4
    and 8 planes; ``rebuild`` evaluates it on u − ∇q, against the JAX
    kernel on that field's block and ghosts."""
    u, q, *_, bf = _fields()
    ur = u - _grad(q) if mode == "rebuild" else u
    kw_j = dict(bodyforce=_j(_blk(bf, lx))) if mode == "bodyforce" else {}
    ref = jpk.smagorinsky_force_halo_3d(_j(_blk(ur, lx)), _j(_lo(ur, 2, lx)), _j(_hi(ur, 2, lx)),
                                        jnp.asarray(THETA), DXS, interpret=True, **kw_j)
    kw = {}
    if mode == "bodyforce":
        kw["bodyforce"] = _t(_blk(bf, lx))
    if mode == "rebuild":
        kw["rebuild_q"] = (_t(_blk(q, lx)), _t(_lo(q, 2, lx)), _t(_hi(q, 3, lx)))
    got = smk.smagorinsky_force_halo_3d_plain(_t(_blk(u, lx)), _t(_lo(u, 2, lx)),
                                              _t(_hi(u, 2, lx)), THETA, DXS, **kw)
    assert tuple(got.shape) == ref.shape == (3, lx, N, N)
    assert _rel(got.numpy(), ref) < TOL_KERNEL


def test_smagorinsky_force_halo_plane_minus_one():
    """With 3 lower ghost planes the force also comes at plane −1, equal to
    the periodic force's plane there (body force folded in)."""
    u, *_, bf = _fields()
    lx = 8
    full = smk.smagorinsky_force_3d_plain(_t(u), THETA, DXS, bodyforce=_t(bf)).numpy()
    f, f_lo = smk._force_halo(_t(_blk(u, lx)), _t(_lo(u, 3, lx)), _t(_hi(u, 2, lx)), THETA,
                              DXS, D2, bodyforce=_t(_blk(bf, lx)),
                              bodyforce_lo=_t(_lo(bf, 1, lx)), x_first=-1)
    assert _rel(f.numpy(), _blk(full, lx)) < TOL_KERNEL
    assert _rel(f_lo.numpy(), _lo(full, 1, lx)) < TOL_KERNEL


# --------------------------------------------------------------------------
# the halo stage kernels' force stream and smag=
# --------------------------------------------------------------------------


def _msd_case(pkg, lx, streams_kind, force, wrapper=False):
    u, _, s, k, ab, bf = _fields()
    jp, tps = _projs()
    cv = _j if pkg == "jax" else _t
    smag = "smag" in force
    glo, ghi = (3, 2) if smag else (2, 1)
    ul = cv(_blk(u, lx))
    if streams_kind == "u":  # stage 0: u is its own tableau base, usnew
        streams, lo = (ul,), (cv(_lo(u, 1, lx)),)
        coeffs, kw = (0.3,), dict(emit_k=False, usnew_coeff=0.1)
    else:  # a k stream, emit_k, an accumulator base
        streams = (cv(_blk(s, lx)), cv(_blk(k, lx)))
        lo = (cv(_lo(s, 1, lx)), cv(_lo(k, 1, lx)))
        coeffs, kw = (0.2, 0.3), dict(emit_k=True, usnew_coeff=0.1,
                                      usnew_base=cv(_blk(ab, lx)))
    if "bf" in force:
        kw.update(bodyforce=cv(_blk(bf, lx)), bodyforce_lo=cv(_lo(bf, 1, lx)))
    args = (ul, cv(_lo(u, glo, lx)), cv(_hi(u, ghi, lx)), streams, lo, coeffs, VISC, DXS)
    if pkg == "jax":
        if smag:
            kw["smag"] = (jnp.asarray(THETA), D2)
        return jpk.momentum_stage_divhat_halo_3d(*args, jp["Vinv"], jp["VinvT"],
                                                 interpret=True, precision="highest", **kw)
    if smag:
        kw["smag"] = (THETA, D2)
    fn = sk.momentum_stage_divhat_halo_3d if wrapper else sk.momentum_stage_divhat_halo_3d_plain
    return fn(*args, tps[lx]["Vinv"], tps[lx]["VinvT"], **kw)


def _pcmsd_case(pkg, lx, base, force, wrapper=False):
    u, q, s, _, ab, bf = _fields()
    jp, tps = _projs()
    cv = _j if pkg == "jax" else _t
    mod = jpk if pkg == "jax" else sk
    smag = "smag" in force
    glo, ghi = (3, 2) if smag else (2, 1)
    if base == "recon":  # the hat carry's stage 0
        streams, lo, kw = (mod.RECON,), (mod.RECON,), dict(usnew_coeff=0.1, emit_u=True)
    else:  # an interior stage
        streams, lo = (cv(_blk(s, lx)),), (cv(_lo(s, 1, lx)),)
        kw = dict(usnew_coeff=0.1, usnew_base=cv(_blk(ab, lx)))
    if "bf" in force:
        kw.update(bodyforce=cv(_blk(bf, lx)), bodyforce_lo=cv(_lo(bf, 1, lx)))
    args = (cv(_blk(u, lx)), cv(_lo(u, glo, lx)), cv(_hi(u, ghi, lx)), cv(_blk(q, lx)),
            cv(_lo(q, glo, lx)), cv(_hi(q, ghi + 1, lx)), streams, lo, (0.3,), VISC, DXS)
    if pkg == "jax":
        if smag:
            kw["smag"] = (jnp.asarray(THETA), D2)
        return jpk.pcmsd_hat_halo_3d(*args, jp, interpret=True, precision="highest",
                                     emit_k=False, **kw)
    if smag:
        kw["smag"] = (THETA, D2)
    fn = sk.pcmsd_hat_halo_3d if wrapper else sk.pcmsd_hat_halo_3d_plain
    return fn(*args, tps[lx], emit_k=False, **kw)


STAGE_CASES = {
    "msd_u_base_usnew_bf": functools.partial(_msd_case, lx=8, streams_kind="u", force="bf"),
    "msd_u_base_usnew_smag": functools.partial(_msd_case, lx=8, streams_kind="u",
                                               force="smag"),
    "msd_k_stream_emit_k_accbase_smag_bf": functools.partial(_msd_case, lx=8,
                                                             streams_kind="k",
                                                             force="smag+bf"),
    "pcmsd_stream_base_accbase_bf": functools.partial(_pcmsd_case, lx=8, base="stream",
                                                      force="bf"),
    "pcmsd_recon_emit_u_usnew_smag": functools.partial(_pcmsd_case, lx=8, base="recon",
                                                       force="smag"),
    "pcmsd_stream_base_accbase_smag_bf": functools.partial(_pcmsd_case, lx=8, base="stream",
                                                           force="smag+bf"),
    "pcmsd_recon_emit_u_usnew_smag_bf_lx4": functools.partial(_pcmsd_case, lx=4,
                                                              base="recon", force="smag+bf"),
}


@pytest.mark.parametrize("case", list(STAGE_CASES))
def test_halo_stage_force_stream_matches_pallas(case):
    """The plain halo stages with the body force and ``smag=`` == the JAX
    halo kernels (interpret; their ``smag=`` fused in the stage)."""
    ref = STAGE_CASES[case]("jax")
    got = STAGE_CASES[case]("torch")
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        assert _rel(g.numpy(), r) < TOL_KERNEL


def test_halo_les_wrappers_run_plain_on_cpu():
    """On CPU tensors the wrappers return their plain versions' results
    and launch nothing."""
    launches.reset_counts()
    cases = (functools.partial(_msd_case, "torch", 8, "k", "smag+bf"),
             functools.partial(_pcmsd_case, "torch", 4, "recon", "smag+bf"))
    for case in cases:
        got, ref = case(wrapper=True), case()
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    u, *_, bf = _fields()
    args = (_t(_blk(u, 8)), _t(_lo(u, 2, 8)), _t(_hi(u, 2, 8)), THETA, DXS)
    assert torch.equal(smk.smagorinsky_force_halo_3d(*args, bodyforce=_t(_blk(bf, 8))),
                       smk.smagorinsky_force_halo_3d_plain(*args, bodyforce=_t(_blk(bf, 8))))
    assert all(v == 0 for v in launches.LAUNCHES.values())


def test_halo_ghost_counts_are_checked():
    """``smag=`` needs the widened ghosts, the body force its plane −1,
    the halo force kernel its 2 + 2 (or 3 + 2) ghosts."""
    u, q, *_, bf = _fields()
    _, tps = _projs()
    args = (_t(_blk(u, 8)), _t(_lo(u, 2, 8)), _t(_hi(u, 1, 8)), _t(_blk(q, 8)),
            _t(_lo(q, 2, 8)), _t(_hi(q, 2, 8)), (sk.RECON,), (sk.RECON,), (0.3,), VISC, DXS,
            tps[8])
    with pytest.raises(ValueError, match="x-planes, expected 3"):
        sk.pcmsd_hat_halo_3d(*args, smag=(THETA, D2))
    with pytest.raises(ValueError, match="bodyforce_lo"):
        sk.pcmsd_hat_halo_3d(*args, bodyforce=_t(_blk(bf, 8)))
    with pytest.raises(ValueError, match="u_hi has shape"):
        smk.smagorinsky_force_halo_3d(_t(_blk(u, 8)), _t(_lo(u, 2, 8)), _t(_hi(u, 1, 8)),
                                      THETA, DXS)


# --------------------------------------------------------------------------
# the chain on 2 and 4 gloo ranks
# --------------------------------------------------------------------------


def _jforce(dim, *xt):
    return (dim == 0) * 0.5 * jnp.sin(xt[1]) + (dim == 1) * 0.25 * jnp.cos(xt[0])


@functools.lru_cache(maxsize=None)
def _jax_steps(method, tag):
    closure, force = worker.CASES[tag]
    x = (np.linspace(0, 2 * np.pi, N + 1),) * 3
    jbase = ins.Setup(x=x, Re=1e3, dtype=jnp.float64)
    jset = ins.Setup(x=x, Re=1e3, dtype=jnp.float64,
                     closure_model=ins.smagorinsky_closure_natural(jbase) if closure else None,
                     bodyforce=_jforce if force else None, issteadybodyforce=True)
    m = ins.RKMethods.RK44() if method == "rk44" else ins.LMWray3()
    step = jax.jit(jax_make_fast_timestep(jset, m))
    s = JaxStepperState(u=jax_strip_ghosts(jnp.asarray(hp.u0(U0_KEY))), temp=None,
                        t=jnp.asarray(0.0), n=jnp.asarray(0))
    theta = jnp.asarray(THETA) if closure else None
    for _ in range(worker.NSTEPS):
        s = step(s, jnp.asarray(worker.DT), theta)
    return np.asarray(s.u)


# worker setup tag: test id
CHAIN_CASES = {"les": "les", "les_bf": "les_bodyforce", "bf": "bodyforce"}


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, tmp_path_factory):
    """Run `torch_halo_worker.run` (the setups of `CHAIN_CASES`; the
    solve of "les_bf") on 2 (and 4: x-slabs of 4 planes, left and right
    ring neighbours apart) spawned gloo ranks; the world size and the
    directory of their results."""
    world = request.param
    data = tmp_path_factory.mktemp(f"halo_les{world}")
    np.save(data / "u0.npy", hp.u0(U0_KEY))
    mp.spawn(worker.run, args=(world, str(data / "store"), str(data), tuple(CHAIN_CASES),
                               "les_bf"), nprocs=world, join=True)
    return world, data


@pytest.mark.parametrize("tag", list(CHAIN_CASES), ids=list(CHAIN_CASES.values()))
@pytest.mark.parametrize("form", ["step", "hat"])
@pytest.mark.parametrize("method", ["rk44", "lmwray3"])
def test_halo_les_on_gloo_ranks_matches_jax_fast_path(ranks, method, form, tag):
    """3 steps of the halo LES, LES + body force and body force alone on
    2 and 4 gloo ranks, both forms, == the JAX single-device fast path."""
    world, data = ranks
    ref = _jax_steps(method, tag)
    for rank in range(world):
        got = np.load(data / f"{tag}_{method}_{form}_r{rank}.npy")
        assert got.shape == ref.shape
        assert _rel(got, ref) < TOL_CHAIN


def _single_device_les(tag, nsteps, chunk):
    setup = worker.setup_f64(tag)
    return it.solve_unsteady(
        setup=setup, ustart=_t(hp.u0(U0_KEY)), tlims=(0.0, nsteps * worker.DT), dt=worker.DT,
        theta=worker.theta(tag),
        processors={"e": it.observefield(
            lambda st: it.total_kinetic_energy(st["u"], setup), nupdate=chunk),
            "spec": it.observespectrum(setup, nupdate=chunk)},
    )


def test_halo_les_solve_unsteady_on_gloo_ranks_matches_single_device(ranks):
    """`solve_unsteady(halo=True, theta=)` of the LES with a body force on
    2 and 4 ranks: the field and the processors' records (energy and
    spectrum, on the gathered field) equal the single-device run's."""
    world, data = ranks
    ref, outs = _single_device_les("les_bf", 4, 2)
    e_ref = np.array([float(e) for e in outs["e"]])
    spec_ref = np.stack(outs["spec"]["ehat"])
    for rank in range(world):
        assert _rel(np.load(data / f"solve_r{rank}.npy"), ref.u.numpy()) < TOL_CHAIN
        assert _rel(np.load(data / f"solve_e_r{rank}.npy"), e_ref) < TOL_CHAIN
        assert _rel(np.load(data / f"solve_spec_r{rank}.npy"), spec_ref) < TOL_CHAIN


# --------------------------------------------------------------------------
# one rank in this process
# --------------------------------------------------------------------------


@pytest.mark.parametrize("tag", list(CHAIN_CASES), ids=list(CHAIN_CASES.values()))
def test_one_rank_halo_les_matches_single_device(one_rank, tag):
    setup = worker.setup_f64(tag)
    ref, outs = _single_device_les(tag, 4, 2)
    state, got = it.solve_unsteady(
        setup=setup, ustart=_t(hp.u0(U0_KEY)), tlims=(0.0, 4 * worker.DT), dt=worker.DT,
        mesh=one_rank, halo=True, theta=worker.theta(tag),
        processors={"e": it.observefield(
            lambda st: it.total_kinetic_energy(st["u"], setup), nupdate=2),
            "spec": it.observespectrum(setup, nupdate=2)},
    )
    assert state.n == 4 and state.u.shape == ref.u.shape
    assert _rel(state.u.numpy(), ref.u.numpy()) < TOL_SAME
    assert _rel([float(e) for e in got["e"]], [float(e) for e in outs["e"]]) < TOL_SAME
    assert _rel(np.stack(got["spec"]["ehat"]), np.stack(outs["spec"]["ehat"])) < TOL_SAME


def test_one_rank_halo_les_theta_defaults_to_0_17(one_rank):
    """θ None on the halo chain is the JAX package's default 0.17."""
    setup = worker.setup_f64("les")
    kw = dict(setup=setup, ustart=_t(hp.u0(U0_KEY)), tlims=(0.0, 2 * worker.DT), dt=worker.DT,
              mesh=one_rank, halo=True)
    a, _ = it.solve_unsteady(**kw)
    b, _ = it.solve_unsteady(theta=0.17, **kw)
    assert torch.equal(a.u, b.u)


def _les_cube(n=N, **kw):
    x = (np.linspace(0, 2 * np.pi, n + 1),) * 3
    base = it.Setup(device="cpu", x=x, Re=1e3, dtype=torch.float64)
    return it.Setup(device="cpu", x=x, Re=1e3, dtype=torch.float64,
                    closure_model=it.smagorinsky_closure_natural(base), **kw)


UNPORTED_LES = {
    "cg": (dict(psolver="cg"), NotImplementedError, "cg"),
    "modular": (dict(fused=False), NotImplementedError, "modular"),
    "unmerged": (dict(merge=False), NotImplementedError, "unmerged"),
    "wray3": (dict(method="wray3"), NotImplementedError, "classic-row"),
}


@pytest.mark.parametrize("case", list(UNPORTED_LES))
def test_unported_halo_les_options_raise(one_rank, case):
    kw, err, match = UNPORTED_LES[case]
    kw = dict(kw)
    method = it.RKMethods.Wray3() if kw.pop("method", None) else it.RKMethods.RK44()
    with pytest.raises(err, match=match):
        make_halo_fast_step(_les_cube(bodyforce=worker.bodyforce), method, one_rank, **kw)


def test_halo_les_setups_that_raise(one_rank):
    """Temperature and non-cube grids stay unported; an unsteady callable
    force, another closure and x-slabs under 3 planes with the closure
    raise ValueError, as in the JAX package."""
    rk = it.RKMethods.RK44()
    bc = ((it.PeriodicBC(), it.PeriodicBC()),) * 3
    temp = it.temperature_equation(Pr=0.71, Ra=1e5, Ge=0.1, boundary_conditions=bc,
                                   dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="temperature"):
        make_halo_fast_step(_les_cube(temperature=temp), rk, one_rank)
    x = (np.linspace(0, 1, 17), np.linspace(0, 1, 9), np.linspace(0, 1, 9))
    base = it.Setup(device="cpu", x=x, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="pencil FFT"):
        make_halo_fast_step(dataclasses.replace(
            base, closure_model=it.smagorinsky_closure_natural(_les_cube())), rk, one_rank)
    unsteady = dataclasses.replace(_les_cube(), bodyforce_field=worker.bodyforce)
    with pytest.raises(ValueError, match="unsteady callable"):
        make_halo_fast_step(unsteady, rk, one_rank)
    # an unsteady force builds a setup now; the halo path declines it
    with pytest.raises(ValueError, match="unsteady callable"):
        make_halo_fast_step(_les_cube(bodyforce=worker.bodyforce, issteadybodyforce=False),
                            rk, one_rank)
    other = dataclasses.replace(_les_cube(), closure_model=lambda u, theta: u)
    with pytest.raises(ValueError, match="natural-form Smagorinsky"):
        make_halo_fast_step(other, rk, one_rank)
    eight = Mesh(group=None, rank=0, size=8, device=torch.device("cpu"))  # lx = 2
    with pytest.raises(ValueError, match="at least 3 planes"):
        make_halo_fast_step(_les_cube(), rk, eight)
