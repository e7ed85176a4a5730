"""bf16 stream storage in the port against the JAX package (CPU).

The velocity-like arrays (u or ut_prev, the tableau streams, the k, ut,
usnew and emitted-u outputs) are stored in bf16; qhat, divhat and all
arithmetic stay float32.  On CPU tensors the kernel wrappers run their
plain versions, which round where the JAX kernels round: inputs widened
before any arithmetic, the body force rounded to the storage dtype,
outputs rounded on the store.  These tests hold them against the JAX
kernels in interpret mode at 8³ (``precision="highest"``), and the port's
bf16 chains (the hat chain on RK44, the unmerged fallback on SSP33)
against the JAX package's at the same settings.

Tolerances.  torch's and JAX's float32 -> bf16 casts round to nearest
even: equal bit for bit.  Kernel outputs: float32 ones within 1e-5
relative (summation order only); bf16 ones within one bf16 ulp of the
reference elementwise, |Δ| <= 2⁻⁷·|ref| + 1e-6·max|ref| (a float32 value
that the two sides compute a few float32 ulps apart may round to the
neighbouring bf16).  Chains: within 1e-2 of max|u| of the JAX chain (a
few steps of bf16 roundings taken at other places), and within 5e-2 of
the chain's own float32 run, the JAX package's bound for the same
comparison (`tests/test_fastpath.py`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ins_tpu as ins
from ins_tpu.ops import pallas_kernels as jpk
from ins_tpu.ops.fastpath import make_fast_timestep_hat as jax_make_fast_timestep_hat
from ins_tpu.ops.poisson_pallas import make_fused_projection as jax_make_fused_projection
from ins_tpu.time_steppers.step import StepperState as JaxStepperState

import ins_tpu_torch as it
from ins_tpu_torch.ops import stage_kernels as sk
from ins_tpu_torch.ops.fastpath import make_fast_timestep, make_fast_timestep_hat
from ins_tpu_torch.ops.poisson_kernels import make_fused_projection
from ins_tpu_torch.time_steppers.step import StepperState

N = 8
DXS = (2 * np.pi / N, 1.0 / N, 0.5 / N)
VISC = 1e-3
TOL_F32 = 1e-5
TOL_CHAIN = 1e-2
TOL_OWN_F32 = 5e-2
DT = 5e-3
BF16 = torch.bfloat16


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(t, dtype=np.float32)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _assert_close(got, ref, name):
    """float32 outputs within 1e-5 relative, bf16 ones within one ulp."""
    if got.dtype == BF16:
        g, r = _np(got), _np(ref)
        assert ref.dtype == jnp.bfloat16, name
        bound = 2.0**-7 * np.abs(r) + 1e-6 * np.max(np.abs(r))
        assert np.all(np.abs(g - r) <= bound), (name, float(np.max(np.abs(g - r) - bound)))
    else:
        assert got.dtype == torch.float32 and ref.dtype == jnp.float32, name
        assert _rel(got, ref) < TOL_F32, name


def _fields(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _pair(a, bf16=True):
    """The same array for both sides: (torch, jax), stored bf16 or float32."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    j = jnp.asarray(a)
    return (t.to(BF16), j.astype(jnp.bfloat16)) if bf16 else (t, j)


@pytest.fixture(scope="module")
def projs():
    jp = jax_make_fused_projection((N,) * 3, DXS, jnp.float32, precision="highest",
                                   interpret=True)
    tp = make_fused_projection((N,) * 3, DXS, torch.float32, precision="highest",
                               device="cpu")
    return jp, tp


def test_bf16_casts_match_jax():
    """torch's and JAX's float32 -> bf16 casts agree bit for bit: random
    values over many binades, exact ties, and values next to ties."""
    rng = np.random.default_rng(1)
    a = (rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096)).astype(np.float32)
    bits = rng.integers(0, 2**16, 4096).astype(np.uint32) << 16
    ties = (bits | 0x8000).view(np.float32)
    near = np.concatenate([(bits | 0x7FFF).view(np.float32), (bits | 0x8001).view(np.float32)])
    x = np.concatenate([a, ties, near, np.float32([0.0, -0.0, 1e-40, 3.4e38])])
    x = x[np.isfinite(x)]
    t = torch.from_numpy(x).to(BF16).view(torch.int16).numpy()
    j = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).view(jnp.int16))
    assert np.array_equal(t, j)


@pytest.mark.parametrize("case", ["stage0", "streams"])
def test_momentum_stage_divhat_3d_bf16_matches_pallas(projs, case):
    """``compute_dtype=float32`` on bf16 storage: stage 0 (u is the base)
    with usnew, and a stage with a k stream, the k output, a separate
    usnew base and a body force (float32, rounded to bf16 by both)."""
    jp, tp = projs
    u, ustart, k1, accb, bf = _fields(2, *[(3, N, N, N)] * 5)
    (tu, ju) = _pair(u)
    kw = dict(precision="highest", usnew_coeff=0.25)
    if case == "stage0":
        ts, js, coeffs = (tu,), (ju,), (0.3,)
        tkw = jkw = dict(kw, emit_k=False)
    else:
        (ts0, js0), (tk, jk), (ta, ja) = _pair(ustart), _pair(k1), _pair(accb)
        ts, js, coeffs = (ts0, tk), (js0, jk), (0.3, 0.17)
        tkw = dict(kw, usnew_base=ta, bodyforce=torch.from_numpy(bf))
        jkw = dict(kw, usnew_base=ja, bodyforce=jnp.asarray(bf))
    ref = jpk.momentum_stage_divhat_3d(
        ju, js, coeffs, VISC, DXS, jp["Vinv"], jp["VinvT"], interpret=True,
        compute_dtype=jnp.float32, **jkw)
    got = sk.momentum_stage_divhat_3d_plain(
        tu, ts, coeffs, VISC, DXS, tp["Vinv"], tp["VinvT"], compute_dtype=torch.float32,
        **tkw)
    names = (("k",) if case == "streams" else ()) + ("ut", "divhat", "usnew")
    assert len(got) == len(ref) == len(names)
    for name, g, r in zip(names, got, ref):
        _assert_close(g, r, name)


@pytest.mark.parametrize("case", ["recon", "base"])
def test_pcmsd_hat_3d_bf16_matches_pallas(projs, case):
    """A bf16 ``ut_prev`` with a float32 qhat: the RECON base with emit_u
    and usnew (the hat chain's stage 0), and a stream base with a
    separate usnew base and a body force (its later stages)."""
    jp, tp = projs
    ut, qhat, ustart, accb, bf = _fields(3, (3, N, N, N), (N, N, N), *[(3, N, N, N)] * 3)
    qhat = 0.1 * qhat
    (tut, jut), (tq, jq) = _pair(ut), _pair(qhat, bf16=False)
    if case == "recon":
        ts, js = (sk.RECON,), (jpk.RECON,)
        tkw = jkw = dict(emit_k=False, usnew_coeff=0.4, emit_u=True)
        names = ("ut", "divhat", "usnew", "u")
    else:
        (ts0, js0), (ta, ja) = _pair(ustart), _pair(accb)
        ts, js = (ts0,), (js0,)
        kw = dict(emit_k=False, usnew_coeff=0.4)
        tkw = dict(kw, usnew_base=ta, bodyforce=torch.from_numpy(bf))
        jkw = dict(kw, usnew_base=ja, bodyforce=jnp.asarray(bf))
        names = ("ut", "divhat", "usnew")
    ref = jpk.pcmsd_hat_3d(jut, jq, js, (0.21,), VISC, DXS, jp, precision="highest",
                           interpret=True, **jkw)
    got = sk.pcmsd_hat_3d_plain(tut, tq, ts, (0.21,), VISC, DXS, tp, precision="highest",
                                **tkw)
    assert len(got) == len(ref) == len(names)
    for name, g, r in zip(names, got, ref):
        _assert_close(g, r, name)


@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_pressure_correct_qhat_3d_bf16_matches_pallas(projs, out):
    """A bf16 ut corrected with a float32 qhat, emitted as float32 (qhat's
    dtype: the chunk end of the hat chain) or as bf16 (``out_dtype``: the
    unmerged chain's stages)."""
    jp, tp = projs
    ut, qhat = _fields(4, (3, N, N, N), (N, N, N))
    (tut, jut), (tq, jq) = _pair(ut), _pair(qhat, bf16=False)
    odt = dict(f32=(None, None), bf16=(BF16, jnp.bfloat16))[out]
    ref = jpk.pressure_correct_qhat_3d(jut, jq, DXS, jp["V"], jp["VT"], precision="highest",
                                       interpret=True, out_dtype=odt[1])
    got = sk.pressure_correct_qhat_3d_plain(tut, tq, DXS, tp["V"], tp["VT"],
                                            precision="highest", out_dtype=odt[0])
    _assert_close(got, ref, "u")
    wrapped = sk.pressure_correct_qhat_3d(tut, tq, DXS, tp["V"], tp["VT"], precision="highest",
                                          out_dtype=odt[0])
    assert torch.equal(wrapped, got)


# --------------------------------------------------------------------------
# the chains
# --------------------------------------------------------------------------


def _setups():
    x = (np.linspace(0, 2 * np.pi, N + 1),) * 3
    return (ins.Setup(x=x, Re=1e3, dtype=jnp.float32),
            it.Setup(x=x, Re=1e3, dtype=torch.float32, device="cpu"))


@functools.lru_cache(maxsize=None)
def _u0_cached():
    jset = ins.Setup(x=(np.linspace(0, 2 * np.pi, N + 1),) * 3, dtype=jnp.float64)
    field = jax.jit(lambda key: ins.random_field(jset, kp=2, rng=key))
    return np.array(field(jax.random.PRNGKey(0))).astype(np.float32)


def _u0_int():
    u0 = _u0_cached()
    return np.ascontiguousarray(u0[:, 1:-1, 1:-1, 1:-1])


def _jax_bf16_chain(jset, method, u0, nsteps):
    to, step, frm = jax_make_fast_timestep_hat(
        jset, method, stream_dtype=jnp.bfloat16, projection_precision="highest",
        _fused_interpret=True)
    step = jax.jit(step)
    h = to(JaxStepperState(u=jnp.asarray(u0), temp=None, t=jnp.float32(0), n=jnp.asarray(0)))
    for _ in range(nsteps):
        h = step(h, jnp.float32(DT), None)
    return np.asarray(frm(h).u)


def _run(fns, u0, nsteps):
    """Step a triple from u0; returns (the final state, the carries)."""
    to, step, frm = fns
    h = to(StepperState(u=torch.from_numpy(u0), temp=None, t=0.0, n=0))
    carries = [h]
    for _ in range(nsteps):
        h = step(h, DT)
        carries.append(h)
    return frm(h), carries


def test_hat_chain_bf16_matches_jax():
    """3 RK44 steps of the hat chain with bf16 streams: the carry holds a
    bf16 ut and a float32 qhat, `from_hat` returns float32, and the run
    agrees with the JAX package's bf16 chain and with its own float32
    chain."""
    jset, tset = _setups()
    u0 = _u0_int()
    ref = _jax_bf16_chain(jset, ins.RKMethods.RK44(), u0, 3)
    method = it.RKMethods.RK44()
    hat = make_fast_timestep_hat(tset, method, stream_dtype=BF16,
                                 projection_precision="highest")
    s, carries = _run(hat, u0, 3)
    assert all(h.ut.dtype == BF16 for h in carries)
    assert carries[0].qhat is None
    assert all(h.qhat.dtype == torch.float32 for h in carries[1:])
    assert s.u.dtype == torch.float32
    assert _rel(s.u, ref) < TOL_CHAIN
    f32, _ = _run(make_fast_timestep_hat(tset, method, projection_precision="highest"), u0, 3)
    assert _rel(s.u, f32.u) < TOL_OWN_F32


def test_unmerged_bf16_fallback_matches_jax():
    """2 SSP33 steps of the unmerged chain on a bf16 u (the triple a
    tableau that the hat chain does not take gets): bf16 carry, float32
    result, against the JAX package's fallback and the float32 chain."""
    jset, tset = _setups()
    u0 = _u0_int()
    ref = _jax_bf16_chain(jset, ins.RKMethods.SSP33(), u0, 2)
    method = it.RKMethods.SSP33()
    hat = make_fast_timestep_hat(tset, method, stream_dtype=BF16,
                                 projection_precision="highest")
    s, carries = _run(hat, u0, 2)
    assert all(h.u.dtype == BF16 for h in carries)
    assert s.u.dtype == torch.float32
    assert _rel(s.u, ref) < TOL_CHAIN
    step = make_fast_timestep(tset, method, projection_precision="highest")
    f32 = StepperState(u=torch.from_numpy(u0), temp=None, t=0.0, n=0)
    for _ in range(2):
        f32 = step(f32, DT)
    assert _rel(s.u, f32.u) < TOL_OWN_F32


@pytest.mark.parametrize("name", ["RK44", "SSP33"])
def test_solve_unsteady_bf16_returns_float32(name):
    """`solve_unsteady(stream_dtype=torch.bfloat16)` returns a float32
    state (the processors see it too) close to the float32 run."""
    _, tset = _setups()
    u0 = torch.from_numpy(_u0_cached())
    method = getattr(it.RKMethods, name)()
    kw = dict(setup=tset, ustart=u0, tlims=(0.0, 4 * DT), dt=DT, method=method)
    seen = []
    got, _ = it.solve_unsteady(
        stream_dtype=BF16, **kw,
        processors={"u": it.observefield(lambda s: seen.append(s["u"].dtype), nupdate=2)})
    ref, _ = it.solve_unsteady(**kw)
    assert got.u.dtype == torch.float32 and got.n == 4
    assert seen and all(d == torch.float32 for d in seen)
    assert _rel(got.u, ref.u) < TOL_OWN_F32


@pytest.mark.parametrize("what", ["smag", "temperature", "halo"])
def test_bf16_unported_cases_raise(projs, what):
    """bf16 storage with the Smagorinsky force or the temperature stream
    (chain and stage wrappers), and on a shard block, raise naming the
    ROADMAP item."""
    _, tp = projs
    x = (np.linspace(0, 2 * np.pi, N + 1),) * 3
    (u,) = _fields(5, (3, N, N, N))
    u = torch.from_numpy(u).to(BF16)
    match = "queue 2 item 5"
    if what == "halo":
        with pytest.raises(NotImplementedError, match=match):
            sk.pressure_correct_qhat_halo_3d(u[:, :4].contiguous(), torch.zeros(4, N, N),
                                             torch.zeros(1, N, N), DXS, tp["V"], tp["VT"])
        return
    if what == "smag":
        base = it.Setup(x=x, device="cpu")
        setup = it.Setup(x=x, device="cpu", closure_model=it.smagorinsky_closure_natural(base))
        kw = dict(smag=(torch.tensor(0.17), 0.1))
    else:
        te = it.temperature_equation(Pr=0.71, Ra=1e6, Ge=1.0,
                                     boundary_conditions=((it.PeriodicBC(),) * 2,) * 3)
        setup = it.Setup(x=x, device="cpu", temperature=te)
        kw = dict(temperature=(torch.zeros(N, N, N), None, None, 2, 1.0, 0.1, None))
    with pytest.raises(NotImplementedError, match=match):
        make_fast_timestep_hat(setup, it.RKMethods.RK44(), stream_dtype=BF16)
    with pytest.raises(NotImplementedError, match=match):
        sk.momentum_stage_divhat_3d(u, (u,), (0.2,), VISC, DXS, tp["Vinv"], tp["VinvT"],
                                    compute_dtype=torch.float32, **kw)
