"""The port's Smagorinsky LES against the JAX package (CPU, f64).

On CPU tensors the force kernel, the stage kernels' force stream and the
folded pass B run their plain versions, so these tests hold the port's
LES arithmetic — the force, its options on the stage kernels, the hat
chain with a steady body force, the roll twin, the differentiable chain
and the spectrum observer — against the JAX package: its Pallas kernels
in interpret mode at ``precision="highest"``, its chains and observers
as they run on the CPU.  The CUDA kernels run only on the card:
`chip_smoke.py` holds each against its plain version.

Both sides are f64.  A kernel or a single stage differs from its JAX
twin in summation order only (~1e-15 relative; bound 1e-12); a chain of
steps with FFT or eigen-transform projections on either side drifts to
~1e-13 (bound 1e-9).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ins_tpu as ins
from ins_tpu.ops import diffkernels as jdk
from ins_tpu.ops import pallas_kernels as jpk
from ins_tpu.ops.eddyviscosity import smagorinsky_natural_interior as jax_smag_interior
from ins_tpu.ops.fastpath import make_fast_timestep as jax_make_fast_timestep
from ins_tpu.ops.fastpath import make_fast_timestep_hat as jax_make_fast_timestep_hat
from ins_tpu.ops.fastpath import strip_ghosts as jax_strip_ghosts
from ins_tpu.ops.poisson_pallas import make_fused_projection as jax_make_fused_projection

import ins_tpu_torch as it
from ins_tpu_torch.ops import diffkernels as tdk
from ins_tpu_torch.ops import launches
from ins_tpu_torch.ops import stage_kernels as sk
from ins_tpu_torch.ops.fastpath import (
    hat_chain_applicable,
    make_fast_timestep,
    make_fast_timestep_hat,
    strip_ghosts,
)
from ins_tpu_torch.ops.poisson_kernels import make_fused_projection
from ins_tpu_torch.ops.smag_kernels import smagorinsky_force_3d, smagorinsky_force_3d_plain

TOL_KERNEL = 1e-12
TOL_CHAIN = 1e-9
THETA = 0.17


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _fields(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in shapes]


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _grad(q, dxs):
    return np.stack([(np.roll(q, -1, axis=a) - q) / dxs[a] for a in range(3)])


def _jforce(dim, *xt):
    return (dim == 0) * 0.5 * jnp.sin(xt[1]) + (dim == 1) * 0.25 * jnp.cos(xt[0])


def _tforce(dim, *xt):
    return (dim == 0) * 0.5 * torch.sin(xt[1]) + (dim == 1) * 0.25 * torch.cos(xt[0])


def _les_setups(n, D=3, force=False, Re=1e3):
    """The JAX and port LES setups (`bench.py`'s `run_case(les=True)`
    layout at size n, with an optional steady body force)."""
    x = (np.linspace(0, 2 * np.pi, n + 1),) * D
    jbase = ins.Setup(x=x, Re=Re, dtype=jnp.float64)
    tbase = it.Setup(x=x, Re=Re, dtype=torch.float64, device="cpu")
    jset = ins.Setup(x=x, Re=Re, dtype=jnp.float64,
                     closure_model=ins.smagorinsky_closure_natural(jbase),
                     bodyforce=_jforce if force else None, issteadybodyforce=True)
    tset = it.Setup(x=x, Re=Re, dtype=torch.float64, device="cpu",
                    closure_model=it.smagorinsky_closure_natural(tbase),
                    bodyforce=_tforce if force else None)
    return jset, tset


@functools.lru_cache(maxsize=None)
def _u0_cached(n, D, kp):
    jset = ins.Setup(x=(np.linspace(0, 2 * np.pi, n + 1),) * D, dtype=jnp.float64)
    field = jax.jit(lambda key: ins.random_field(jset, kp=kp, rng=key))
    return np.array(field(jax.random.PRNGKey(0)))


def _u0(n, D=3, kp=4):
    return _u0_cached(n, D, kp).copy()


def _jax_state(jset, method, u0):
    s = ins.create_stepper(method, setup=jset, psolver=ins.psolver_spectral(jset),
                           u=jnp.asarray(u0))
    return s._replace(u=jax_strip_ghosts(s.u))


# --------------------------------------------------------------------------
# the force kernel (plain version) and the closure
# --------------------------------------------------------------------------


@pytest.mark.parametrize("box", [(16, 16, 16), (12, 10, 8)], ids=["16^3", "12x10x8"])
@pytest.mark.parametrize("mode", ["plain", "bodyforce", "rebuild"])
def test_smagorinsky_force_3d_matches_pallas(box, mode):
    """The plain version against `smagorinsky_force_3d` in interpret
    mode, with and without the steady body force; ``rebuild`` evaluates
    the force (+ body force) on u = ut − ∇q rebuilt from a pressure."""
    dxs = (0.3, 0.25, 0.2)
    u, bf, q = _fields(1, (3, *box), (3, *box), box)
    ju = u - _grad(q, dxs) if mode == "rebuild" else u
    jbf = None if mode == "plain" else jnp.asarray(bf)
    ref = jpk.smagorinsky_force_3d(jnp.asarray(ju), THETA, dxs, bodyforce=jbf,
                                   interpret=True)
    kw = dict(bodyforce=None if mode == "plain" else _t(bf),
              rebuild_q=_t(q) if mode == "rebuild" else None)
    got = smagorinsky_force_3d_plain(_t(u), THETA, dxs, **kw)
    assert _rel(got.numpy(), ref) < TOL_KERNEL
    launches.reset_counts()
    assert torch.equal(smagorinsky_force_3d(_t(u), THETA, dxs, **kw), got)
    assert not any(launches.LAUNCHES.values())


@pytest.mark.parametrize("D", [2, 3])
def test_smagorinsky_natural_interior_matches_jax(D):
    n = (12,) * D
    (u,) = _fields(2, (D, *n))
    dxs = (0.3, 0.2, 0.25)[:D]
    ref = jax_smag_interior(jnp.asarray(u), jnp.asarray(THETA), dxs)
    got = it.smagorinsky_natural_interior(_t(u), torch.tensor(THETA, dtype=torch.float64), dxs)
    assert _rel(got.numpy(), ref) < TOL_KERNEL


@pytest.mark.parametrize("D", [2, 3])
def test_smagorinsky_closure_natural_matches_jax(D):
    """On the ghosted layout the tagged closure equals the JAX package's
    ghosted pipeline on the interior."""
    jset, tset = _les_setups(8 if D == 3 else 16, D)
    u0 = _u0(8 if D == 3 else 16, D, kp=2)
    ref = jax.jit(jset.closure_model)(jnp.asarray(u0), jnp.asarray(THETA))
    got = tset.closure_model(_t(u0), THETA)
    assert tset.closure_model.kind == "smagorinsky_natural"
    assert got.shape == u0.shape
    inner = (slice(None),) + (slice(1, -1),) * D
    assert _rel(got.numpy()[inner], np.asarray(ref)[inner]) < TOL_KERNEL


def test_smagorinsky_closure_raises_off_periodic_grids():
    """A wall-bounded setup runs the ghosted pipeline (`strain_natural` ...
    `divoftensor_natural`, the intermediate ghosts wrapped on the periodic
    dimensions), held against the JAX closure."""
    wall = (it.DirichletBC(), it.DirichletBC())
    per = (it.PeriodicBC(), it.PeriodicBC())
    x = (np.linspace(0, 1, 9),) * 2 + (it.tanh_grid(0, 2, 8),)
    s = it.Setup(device="cpu", x=x, boundary_conditions=(per, per, wall), dtype=torch.float64)
    jwall = (ins.DirichletBC(), ins.DirichletBC())
    jper = (ins.PeriodicBC(), ins.PeriodicBC())
    js = ins.Setup(x=x, boundary_conditions=(jper, jper, jwall), dtype=jnp.float64)
    m = it.smagorinsky_closure_natural(s)
    assert m.kind == "smagorinsky_natural"
    u = np.random.default_rng(8).standard_normal((3, *s.grid.N))
    u = np.asarray(ins.apply_bc_u(jnp.asarray(u), jnp.asarray(0.0), js))
    ref = ins.smagorinsky_closure_natural(js)(jnp.asarray(u), 0.17)
    got = m(torch.from_numpy(np.array(u)), 0.17)
    assert _rel(got.numpy(), np.asarray(ref)) < TOL_KERNEL


def test_smag_force_vjp_matches_jax():
    """Forward the force + body force, backward the roll twin's VJP in u
    and θ, against `make_smag_force_vjp` of the JAX package."""
    dxs = (0.3, 0.25, 0.2)
    u, bf, ct = _fields(3, (3, 8, 8, 8), (3, 8, 8, 8), (3, 8, 8, 8))
    f = jdk.make_smag_force_vjp(dxs, bodyforce=jnp.asarray(bf), interpret=True)
    ref_y, vjp = jax.vjp(f, jnp.asarray(u), jnp.asarray(THETA))
    ref_gu, ref_gth = vjp(jnp.asarray(ct))
    ut = _t(u, True)
    th = torch.tensor(THETA, dtype=torch.float64, requires_grad=True)
    y = tdk.make_smag_force_vjp(dxs, bodyforce=_t(bf))(ut, th)
    gu, gth = torch.autograd.grad(y, (ut, th), _t(ct))
    assert _rel(y.detach().numpy(), ref_y) < TOL_KERNEL
    assert _rel(gu.numpy(), ref_gu) < TOL_KERNEL
    assert gth.shape == () and _rel(gth.numpy(), ref_gth) < TOL_KERNEL


# --------------------------------------------------------------------------
# the stage kernels' force stream
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def projs():
    n = 16
    dxs = (2 * np.pi / n,) * 3
    jp = jax_make_fused_projection((n,) * 3, dxs, jnp.float64, precision="highest",
                                   interpret=True)
    tp = make_fused_projection((n,) * 3, dxs, torch.float64, device="cpu")
    return n, dxs, jp, tp


@pytest.mark.parametrize("kernel", ["momentum_stage_divhat_3d", "pcmsd_hat_3d"])
def test_stage_smag_and_bodyforce_match_pallas(projs, kernel):
    """``smag=(θ, d2)`` and ``bodyforce=`` together (k, ut, divhat, usnew
    and, for the merged stage, the rebuilt u) against the JAX kernels,
    which form the force inside the stage."""
    n, dxs, jp, tp = projs
    ut, bf, qhat = _fields(4, (3, n, n, n), (3, n, n, n), (n, n, n))
    qhat = 1e-3 * qhat
    d2 = sum(d * d for d in dxs)
    kw = dict(emit_k=True, usnew_coeff=1e-3 / 6)
    if kernel == "pcmsd_hat_3d":
        ref = jpk.pcmsd_hat_3d(
            jnp.asarray(ut), jnp.asarray(qhat), (jpk.RECON,), (1e-3,), 1e-3, dxs, jp,
            precision="highest", interpret=True, bodyforce=jnp.asarray(bf),
            smag=(jnp.asarray(THETA), d2), emit_u=True, **kw)
        got = sk.pcmsd_hat_3d(_t(ut), _t(qhat), (sk.RECON,), (1e-3,), 1e-3, dxs, tp,
                              bodyforce=_t(bf), smag=(THETA, d2), emit_u=True, **kw)
    else:
        ref = jpk.momentum_stage_divhat_3d(
            jnp.asarray(ut), (jnp.asarray(ut),), (1e-3,), 1e-3, dxs, jp["Vinv"],
            jp["VinvT"], precision="highest", interpret=True, bodyforce=jnp.asarray(bf),
            smag=(jnp.asarray(THETA), d2), **kw)
        got = sk.momentum_stage_divhat_3d(_t(ut), (_t(ut),), (1e-3,), 1e-3, dxs,
                                          tp["Vinv"], tp["VinvT"], bodyforce=_t(bf),
                                          smag=(THETA, d2), **kw)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert _rel(g.numpy(), r) < TOL_KERNEL


def test_stage_smag_is_the_force_stream_of_its_force(projs):
    """The two-pass form the CUDA path takes: the stage with ``smag=`` and
    a body force equals the stage whose force stream is
    `smagorinsky_force_3d` (+ body force) of the rebuilt u."""
    n, dxs, _, tp = projs
    ut, bf, qhat = (_t(a) for a in _fields(5, (3, n, n, n), (3, n, n, n), (n, n, n)))
    qhat = 1e-3 * qhat
    d2 = sum(d * d for d in dxs)
    kw = dict(emit_k=True, usnew_coeff=1e-3 / 6, emit_u=True)
    fused = sk.pcmsd_hat_3d(ut, qhat, (sk.RECON,), (1e-3,), 1e-3, dxs, tp, bodyforce=bf,
                            smag=(THETA, d2), **kw)
    q = torch.einsum("yj,xjl->xyl", tp["V"], torch.einsum("xjk,kl->xjl", qhat, tp["VT"]))
    force = smagorinsky_force_3d(ut, THETA, dxs, bodyforce=bf, rebuild_q=q)
    two_pass = sk.pcmsd_hat_3d(ut, qhat, (sk.RECON,), (1e-3,), 1e-3, dxs, tp,
                               bodyforce=force, **kw)
    for a, b in zip(fused, two_pass):
        assert _rel(a.numpy(), b.numpy()) < TOL_KERNEL


# --------------------------------------------------------------------------
# the chains
# --------------------------------------------------------------------------


def test_les_hat_chain_matches_jax():
    """3 RK44 steps of the LES hat chain with a steady body force (the
    merged stage kernels with ``smag=`` and ``bodyforce=``, the folded
    pass B) against the JAX package's fused chain in interpret mode, 16³."""
    n = 16
    jset, tset = _les_setups(n, force=True)
    mj, mt = ins.RKMethods.RK44(), it.RKMethods.RK44()
    u0 = _u0(n)
    dt = 1e-2
    to_hat, step_hat, from_hat = jax_make_fast_timestep_hat(
        jset, mj, projection_precision="highest", _fused_interpret=True)
    step_j = jax.jit(step_hat)
    h = to_hat(_jax_state(jset, mj, u0))
    for _ in range(3):
        h = step_j(h, dt, jnp.asarray(THETA))
    ref = np.asarray(from_hat(h).u)

    assert hat_chain_applicable(tset, mt)
    t_to, t_step, t_from = make_fast_timestep_hat(tset, mt)
    s = it.create_stepper(mt, setup=tset, u=strip_ghosts(_t(u0)))
    th = t_to(s)
    for _ in range(3):
        th = t_step(th, dt, THETA)
    got = t_from(th).u
    assert _rel(got.numpy(), ref) < TOL_CHAIN


def test_solve_unsteady_les_matches_jax():
    """`solve_unsteady` with the closure, θ and a steady body force, with
    `timelogger` and `observespectrum` attached, against
    `ins.solve_unsteady` (16³, 4 steps in chunks of 2)."""
    n = 16
    jset, tset = _les_setups(n, force=True)
    u0 = _u0(n)
    kw = dict(tlims=(0.0, 0.04), dt=1e-2)
    ref, jout = ins.solve_unsteady(setup=jset, ustart=jnp.asarray(u0),
                                   theta=jnp.asarray(THETA),
                                   processors={"spec": ins.observespectrum(jset, nupdate=2)},
                                   **kw)
    launches.reset_counts()
    got, outs = it.solve_unsteady(
        setup=tset, ustart=_t(u0), theta=THETA, **kw,
        processors={"log": it.timelogger(nupdate=2),
                    "spec": it.observespectrum(tset, nupdate=2)},
    )
    assert got.n == 4 and got.t == pytest.approx(0.04)
    assert _rel(got.u.numpy(), ref.u) < TOL_CHAIN
    spec, jspec = outs["spec"], jout["spec"]
    np.testing.assert_array_equal(spec["kappa"], np.asarray(jspec["kappa"]))
    assert spec["t"] == pytest.approx(jspec["t"])
    for e, je in zip(spec["ehat"], jspec["ehat"]):
        assert _rel(e, je) < TOL_CHAIN
    assert not any(launches.LAUNCHES.values())  # CPU: plain versions only


@pytest.mark.parametrize("force", [False, True], ids=["les", "les+force"])
def test_roll_twin_2d_les_matches_jax(force):
    """2-D: the roll twin with `smagorinsky_natural_interior` (and the
    body force) in the momentum, against JAX's roll twin."""
    n = 32
    x = (np.linspace(0, 2 * np.pi, n + 1),) * 2
    jbase = ins.Setup(x=x, Re=1e3, dtype=jnp.float64)
    tbase = it.Setup(x=x, Re=1e3, dtype=torch.float64, device="cpu")
    jf = (lambda dim, x, y, t: (dim == 0) * 0.5 * jnp.sin(y)) if force else None
    tf = (lambda dim, x, y, t: (dim == 0) * 0.5 * torch.sin(y)) if force else None
    jset = ins.Setup(x=x, Re=1e3, dtype=jnp.float64, bodyforce=jf, issteadybodyforce=True,
                     closure_model=ins.smagorinsky_closure_natural(jbase))
    tset = it.Setup(x=x, Re=1e3, dtype=torch.float64, device="cpu", bodyforce=tf,
                    closure_model=it.smagorinsky_closure_natural(tbase))
    mj, mt = ins.RKMethods.RK44(), it.RKMethods.RK44()
    u0 = _u0(n, D=2, kp=3)
    step_j = jax.jit(jax_make_fast_timestep(jset, mj, _force_roll=True))
    s = _jax_state(jset, mj, u0)
    for _ in range(2):
        s = step_j(s, jnp.asarray(1e-2), jnp.asarray(THETA))
    assert make_fast_timestep_hat(tset, mt) is None
    step = make_fast_timestep(tset, mt)
    st = it.create_stepper(mt, setup=tset, u=strip_ghosts(_t(u0)))
    for _ in range(2):
        st = step(st, 1e-2, THETA)
    assert _rel(st.u.numpy(), s.u) < TOL_CHAIN


def test_les_gradients_match_jax():
    """The θ and u0 gradients of a loss after 2 steps of the
    differentiable chain (per-op kernels, `make_smag_force_vjp`) against
    `jax.grad` through `make_fast_timestep(differentiable=True)`, 8³."""
    n = 8
    jset, tset = _les_setups(n, force=True)
    mj, mt = ins.RKMethods.RK44(), it.RKMethods.RK44()
    u0 = np.array(jax_strip_ghosts(jnp.asarray(_u0(n, kp=2))))
    (w,) = _fields(6, u0.shape)
    step_j = jax_make_fast_timestep(jset, mj, differentiable=True)

    def jloss(u, theta):
        s = ins.create_stepper(mj, setup=jset, psolver=None, u=u)
        for _ in range(2):
            s = step_j(s, 1e-2, theta)
        return jnp.sum(s.u * jnp.asarray(w))

    jl, (jgu, jgth) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(u0), jnp.asarray(THETA))

    step = make_fast_timestep(tset, mt, differentiable=True)
    u = _t(u0, True)
    th = torch.tensor(THETA, dtype=torch.float64, requires_grad=True)
    s = it.create_stepper(mt, setup=tset, u=u)
    for _ in range(2):
        s = step(s, 1e-2, th)
    loss = torch.sum(s.u * _t(w))
    gu, gth = torch.autograd.grad(loss, (u, th))
    assert abs(loss.item() - float(jl)) <= TOL_CHAIN * abs(float(jl))
    assert _rel(gu.numpy(), jgu) < TOL_CHAIN
    assert gth.shape == () and _rel(gth.numpy(), jgth) < TOL_CHAIN


def test_les_without_theta_raises():
    _, tset = _les_setups(8)
    u0 = _t(_u0(8, kp=2))
    with pytest.raises(ValueError, match="theta"):
        it.solve_unsteady(setup=tset, ustart=u0, tlims=(0.0, 0.02), dt=1e-2)


# --------------------------------------------------------------------------
# observers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("D,n", [(2, 32), (3, 16)])
def test_observespectrum_matches_jax(D, n):
    """Kappa, bins and binned energy of one snapshot (dyadic masks in 2-D,
    the segment sum in 3-D)."""
    x = (np.linspace(0, 2 * np.pi, n + 1),) * D
    jset = ins.Setup(x=x, dtype=jnp.float64)
    tset = it.Setup(x=x, dtype=torch.float64, device="cpu")
    u0 = _u0(n, D=D, kp=3)
    jp, tp = ins.observespectrum(jset, npoint=40), it.observespectrum(tset, npoint=40)
    state = dict(u=u0, temp=None, t=0.5, n=3)
    jstate = jp.update(jp.initialize(state), dict(state, u=jnp.asarray(u0)))
    tstate = tp.update(tp.initialize(state), dict(state, u=_t(u0)))
    np.testing.assert_array_equal(tstate["kappa"], np.asarray(jstate["kappa"]))
    assert tstate["t"] == [0.5]
    assert _rel(tstate["ehat"][0], jstate["ehat"][0]) < TOL_KERNEL


def test_observefield_records_host_values():
    _, tset = _les_setups(8)
    proc = it.observefield(
        lambda s: (float(s["t"]), it.total_kinetic_energy(s["u"], tset), {"u": s["u"][0]}),
        nupdate=2,
    )
    assert proc.nupdate == 2
    u = _t(_u0(8, kp=2))
    vals = proc.update(proc.initialize({}), dict(u=u, temp=None, t=0.25, n=2))
    t, e, d = vals[0]
    assert t == 0.25 and isinstance(e, np.ndarray) and isinstance(d["u"], np.ndarray)
    assert e == pytest.approx(it.total_kinetic_energy(u, tset).item(), rel=1e-15)
