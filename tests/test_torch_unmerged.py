"""The port's fused unmerged chain against the JAX package (CPU, f64, 8³).

Explicit RK tableaus whose intermediate rows read earlier k's (SSP33,
RK56, SSP104, ...) step the fused unmerged chain on a 3-D cube: per stage
the stage kernel with the k streams ``[ustart, k_j for A[i][j] != 0]``,
pass B and the correction.  On CPU tensors the kernels run their plain
versions, so these tests hold the chain's tableau algebra against the JAX
package: SSP33 against its fused unmerged chain with the Pallas kernels
in interpret mode (``_fused_interpret=True``); the body force, the
Smagorinsky closure, RK56 (4 k streams) and SSP104 (9) against its
`make_fast_timestep`, which on the CPU is the roll graph, the same
arithmetic at a fraction of the interpret cost; and the many-stream stage
against `_msd_hat_stream_kernel` (``stream_accum=True``) in interpret
mode.

Both sides are f64.  A stage differs from its JAX twin in summation order
only (~1e-15 relative; bound 1e-12); a chain of steps with eigen-transform
or FFT projections on either side drifts to ~1e-13 (bound 1e-9).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ins_tpu as ins
from ins_tpu.ops import pallas_kernels as jpk
from ins_tpu.ops.fastpath import make_fast_timestep as jax_make_fast_timestep
from ins_tpu.ops.fastpath import strip_ghosts as jax_strip_ghosts
from ins_tpu.ops.poisson_pallas import make_fused_projection as jax_make_fused_projection

import ins_tpu_torch as it
from ins_tpu_torch.ops import launches
from ins_tpu_torch.ops import stage_kernels as sk
from ins_tpu_torch.ops.fastpath import (
    hat_chain_applicable,
    make_fast_timestep,
    make_fast_timestep_hat,
    strip_ghosts,
    unmerged_chain_applicable,
)
from ins_tpu_torch.ops.poisson_kernels import make_fused_projection

N = 8
TOL_KERNEL = 1e-12
TOL_CHAIN = 1e-9
THETA = 0.17
DT = 1e-2


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jforce(dim, *xt):
    return (dim == 0) * 0.5 * jnp.sin(xt[1]) + (dim == 1) * 0.25 * jnp.cos(xt[0])


def _tforce(dim, *xt):
    return (dim == 0) * 0.5 * torch.sin(xt[1]) + (dim == 1) * 0.25 * torch.cos(xt[0])


def _setups(force=False, smag=False, Re=1e3):
    x = (np.linspace(0, 2 * np.pi, N + 1),) * 3
    jkw = dict(x=x, Re=Re, dtype=jnp.float64)
    tkw = dict(x=x, Re=Re, dtype=torch.float64, device="cpu")
    if smag:
        jkw["closure_model"] = ins.smagorinsky_closure_natural(ins.Setup(**jkw))
        tkw["closure_model"] = it.smagorinsky_closure_natural(it.Setup(**tkw))
    if force:
        jkw.update(bodyforce=_jforce, issteadybodyforce=True)
        tkw["bodyforce"] = _tforce
    return ins.Setup(**jkw), it.Setup(**tkw)


@functools.lru_cache(maxsize=None)
def _u0_cached(kp):
    jset = ins.Setup(x=(np.linspace(0, 2 * np.pi, N + 1),) * 3, dtype=jnp.float64)
    field = jax.jit(lambda key: ins.random_field(jset, kp=kp, rng=key))
    return np.array(field(jax.random.PRNGKey(0)))


def _u0(kp=2):
    return _u0_cached(kp).copy()


def _jax_steps(jset, method, u0, nsteps, theta=None, **kw):
    step = jax.jit(jax_make_fast_timestep(jset, method, **kw))
    s = ins.create_stepper(method, setup=jset, psolver=ins.psolver_spectral(jset),
                           u=jnp.asarray(u0))
    s = s._replace(u=jax_strip_ghosts(s.u))
    th = None if theta is None else jnp.asarray(theta)
    for _ in range(nsteps):
        s = step(s, jnp.asarray(DT), th)
    return np.asarray(s.u), s


def _port_steps(tset, method, u0, nsteps, theta=None, **kw):
    step = make_fast_timestep(tset, method, **kw)
    s = it.create_stepper(method, setup=tset, u=strip_ghosts(_t(u0)))
    for _ in range(nsteps):
        s = step(s, DT, theta)
    return s


def test_ssp33_matches_jax_fused_unmerged_chain():
    """2 SSP33 steps against the JAX package's fused unmerged chain with
    its Pallas kernels in interpret mode; the chain takes no hat form
    and, on CPU tensors, launches nothing."""
    jset, tset = _setups()
    mj, mt = ins.RKMethods.SSP33(), it.RKMethods.SSP33()
    u0 = _u0()
    ref, js = _jax_steps(jset, mj, u0, 2, _fused_interpret=True,
                         projection_precision="highest")
    assert unmerged_chain_applicable(tset, mt) and not hat_chain_applicable(tset, mt)
    assert make_fast_timestep_hat(tset, mt) is None
    launches.reset_counts()
    s = _port_steps(tset, mt, u0, 2)
    assert not any(launches.LAUNCHES.values())
    assert s.n == 2 and s.t == pytest.approx(float(js.t))
    assert s.u.dtype == torch.float64
    assert _rel(s.u.numpy(), ref) < TOL_CHAIN


@pytest.mark.parametrize("case", ["bodyforce", "smag", "rk56", "ssp104"])
def test_unmerged_chain_matches_jax(case):
    """SSP33 with a steady body force, SSP33 with the natural-form
    Smagorinsky closure and θ, RK56 (4 k streams at its last stages) and
    one step of SSP104 (9 k streams at its last stage: the many-stream
    stage) against the JAX `make_fast_timestep`."""
    jset, tset = _setups(force=case == "bodyforce", smag=case == "smag")
    name = {"rk56": "RK56", "ssp104": "SSP104"}.get(case, "SSP33")
    mj, mt = getattr(ins.RKMethods, name)(), getattr(it.RKMethods, name)()
    nsteps = 1 if case == "ssp104" else 2
    theta = THETA if case == "smag" else None
    u0 = _u0()
    ref, _ = _jax_steps(jset, mj, u0, nsteps, theta)
    assert unmerged_chain_applicable(tset, mt)
    s = _port_steps(tset, mt, u0, nsteps, theta)
    assert _rel(s.u.numpy(), ref) < TOL_CHAIN
    if case == "ssp104":
        A = mt.A
        assert max(sum(a != 0.0 for a in A[i][:i]) for i in range(mt.nstage)) == 9


def test_force_roll_and_solve_unsteady_step_the_same_ssp33():
    """``_force_roll`` builds the roll twin; it and `solve_unsteady` (which
    steps the unmerged chain) agree with the JAX solver."""
    jset, tset = _setups()
    u0 = _u0()
    kw = dict(tlims=(0.0, 2 * DT), dt=DT)
    ref, _ = ins.solve_unsteady(setup=jset, ustart=jnp.asarray(u0),
                                method=ins.RKMethods.SSP33(), **kw)
    got, _ = it.solve_unsteady(setup=tset, ustart=_t(u0), method=it.RKMethods.SSP33(), **kw)
    assert got.n == 2 and _rel(got.u.numpy(), ref.u) < TOL_CHAIN
    roll = _port_steps(tset, it.RKMethods.SSP33(), u0, 2, _force_roll=True)
    assert _rel(strip_ghosts(got.u).numpy(), roll.u.numpy()) < TOL_CHAIN


def test_many_stream_stage_matches_stream_kernel():
    """The stage with m = 9 k streams (emit_k, no usnew) against the JAX
    package's `_msd_hat_stream_kernel` (``stream_accum=True``) in interpret
    mode; the wrapper on CPU tensors is the plain version."""
    dxs = (2 * np.pi / N, 1.0 / N, 0.5 / N)
    visc = 1e-3
    jp = jax_make_fused_projection((N,) * 3, dxs, jnp.float64, precision="highest",
                                   interpret=True)
    tp = make_fused_projection((N,) * 3, dxs, torch.float64, precision="highest",
                               device="cpu")
    rng = np.random.default_rng(11)
    u, *streams = (rng.standard_normal((3, N, N, N)) for _ in range(11))
    coeffs = tuple(0.05 * (j + 1) * (-1) ** j for j in range(10))
    ref = jpk.momentum_stage_divhat_3d(
        jnp.asarray(u), tuple(map(jnp.asarray, streams)), coeffs, visc, dxs, jp["Vinv"],
        jp["VinvT"], precision="highest", interpret=True, stream_accum=True,
    )
    args = (_t(u), tuple(map(_t, streams)), coeffs, visc, dxs, tp["Vinv"], tp["VinvT"])
    got = sk.momentum_stage_divhat_3d_plain(*args, precision="highest")
    assert len(got) == len(ref) == 3  # k, ut, divhat
    for name, g, r in zip(("k", "ut", "divhat"), got, ref):
        assert _rel(g.numpy(), r) < TOL_KERNEL, name
    launches.reset_counts()
    wrapped = sk.momentum_stage_divhat_3d(*args, precision="highest")
    assert all(torch.equal(g, w) for g, w in zip(got, wrapped))
    assert not any(launches.LAUNCHES.values())
