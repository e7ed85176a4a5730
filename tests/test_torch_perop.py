"""The port's per-op kernels and their VJPs, held against the JAX package.

Each plain version (what the wrapper runs on a CPU tensor) is compared
with the Pallas kernel run in interpret mode on a non-cube box at
float64, and each custom VJP of `ins_tpu_torch.ops.diffkernels` with
`ins_tpu.ops.diffkernels`'s.  The CUDA kernels run only on the card:
`chip_smoke.py` holds each against its plain version at 64³ and 128³.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ins_tpu.ops import diffkernels as jdk
from ins_tpu.ops import pallas_kernels as jpk
from ins_tpu.ops.dft import make_poisson_mm as jax_make_poisson_mm

from ins_tpu_torch.ops import diffkernels as tdk
from ins_tpu_torch.ops import launches
from ins_tpu_torch.ops import perop_kernels as pk
from ins_tpu_torch.ops.dft import make_poisson_mm

BOX = (8, 12, 16)
DXS = (0.3, 0.2, 0.1)
VISC = 1e-2
# f64 on both sides: the two differ only in summation order, ~1e-15
# relative; 1e-10 leaves room without hiding a wrong term.
TOL_F64 = 1e-10


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _fields(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in shapes]


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


VEC, SCA = (3, *BOX), BOX


def test_convdiff_interior_3d_matches_pallas():
    (u,) = _fields(1, VEC)
    ref = jpk.convdiff_interior_3d(jnp.asarray(u), VISC, DXS, interpret=True)
    got = pk.convdiff_interior_3d_plain(_t(u), VISC, DXS)
    assert _rel(got.numpy(), ref) < TOL_F64


def test_stage_div_3d_matches_pallas():
    base, k = _fields(2, VEC, VEC)
    ref = jpk.stage_div_3d(jnp.asarray(base), jnp.asarray(k), 0.37, DXS, interpret=True)
    got = pk.stage_div_3d_plain(_t(base), _t(k), 0.37, DXS)
    for name, g, r in zip(("ut", "div"), got, ref):
        assert _rel(g.numpy(), r) < TOL_F64, name


def test_pressure_correct_3d_matches_pallas():
    ut, q = _fields(3, VEC, SCA)
    ref = jpk.pressure_correct_3d(jnp.asarray(ut), jnp.asarray(q), DXS, interpret=True)
    got = pk.pressure_correct_3d_plain(_t(ut), _t(q), DXS)
    assert _rel(got.numpy(), ref) < TOL_F64


def test_wrappers_run_plain_on_cpu():
    """On CPU tensors every wrapper returns its plain version's result
    and launches nothing."""
    base, k, q = (_t(a) for a in _fields(4, VEC, VEC, SCA))
    launches.reset_counts()
    assert torch.equal(pk.convdiff_interior_3d(base, VISC, DXS),
                       pk.convdiff_interior_3d_plain(base, VISC, DXS))
    for g, r in zip(pk.stage_div_3d(base, k, 0.2, DXS), pk.stage_div_3d_plain(base, k, 0.2, DXS)):
        assert torch.equal(g, r)
    assert torch.equal(pk.pressure_correct_3d(base, q, DXS),
                       pk.pressure_correct_3d_plain(base, q, DXS))
    assert not any(launches.LAUNCHES.values())
    assert not any(launches.PLAIN_ON_CUDA.values())


@pytest.mark.parametrize(
    "bad", ["2d", "channels"],
)
def test_wrappers_reject_other_layouts(bad):
    a = torch.zeros((2, *BOX)) if bad == "channels" else torch.zeros((3, 8, 12))
    with pytest.raises(ValueError, match=r"\(3, nx, ny, nz\)"):
        pk.convdiff_interior_3d(a, VISC, DXS)


def test_convdiff_vjp_matches_jax():
    u, ct = _fields(5, VEC, VEC)
    f = jdk.make_convdiff_vjp(VISC, DXS, interpret=True)
    ref_y, vjp = jax.vjp(f, jnp.asarray(u))
    (ref_g,) = vjp(jnp.asarray(ct))
    ut = _t(u, grad=True)
    y = tdk.make_convdiff_vjp(VISC, DXS)(ut)
    (g,) = torch.autograd.grad(y, ut, _t(ct))
    assert _rel(y.detach().numpy(), ref_y) < TOL_F64
    assert _rel(g.numpy(), ref_g) < TOL_F64


def test_stage_div_vjp_matches_jax_with_ct_coeff():
    """All three cotangents, the coefficient's included (a tensor that
    requires grad)."""
    base, k, ct_ut, ct_div = _fields(6, VEC, VEC, VEC, SCA)
    coeff = 0.29
    f = jdk.make_stage_div_vjp(DXS, interpret=True)
    ref_y, vjp = jax.vjp(f, jnp.asarray(base), jnp.asarray(k), jnp.asarray(coeff))
    ref_g = vjp((jnp.asarray(ct_ut), jnp.asarray(ct_div)))
    args = (_t(base, True), _t(k, True), torch.tensor(coeff, dtype=torch.float64,
                                                      requires_grad=True))
    ut, div = tdk.make_stage_div_vjp(DXS)(*args)
    g = torch.autograd.grad((ut, div), args, (_t(ct_ut), _t(ct_div)))
    assert _rel(ut.detach().numpy(), ref_y[0]) < TOL_F64
    assert _rel(div.detach().numpy(), ref_y[1]) < TOL_F64
    for name, gi, ri in zip(("base", "k", "coeff"), g, ref_g):
        assert gi.shape == tuple(np.shape(ri)), name
        assert _rel(gi.numpy(), ri) < TOL_F64, name


def test_stage_div_vjp_with_float_coeff():
    base, k, ct_ut, ct_div = _fields(7, VEC, VEC, VEC, SCA)
    args = (_t(base, True), _t(k, True))
    ut, div = tdk.make_stage_div_vjp(DXS)(*args, 0.5)
    gb, gk = torch.autograd.grad((ut, div), args, (_t(ct_ut), _t(ct_div)))
    assert torch.allclose(gk, 0.5 * gb, rtol=1e-14, atol=0)


def test_pressure_correct_vjp_matches_jax():
    ut, q, ct = _fields(8, VEC, SCA, VEC)
    f = jdk.make_pressure_correct_vjp(DXS, interpret=True)
    ref_y, vjp = jax.vjp(f, jnp.asarray(ut), jnp.asarray(q))
    ref_g = vjp(jnp.asarray(ct))
    args = (_t(ut, True), _t(q, True))
    y = tdk.make_pressure_correct_vjp(DXS)(*args)
    g = torch.autograd.grad(y, args, _t(ct))
    assert _rel(y.detach().numpy(), ref_y) < TOL_F64
    for gi, ri in zip(g, ref_g):
        assert _rel(gi.numpy(), ri) < TOL_F64


def test_vjps_are_adjoints_of_their_forwards():
    """<J v, w> == <v, Jᵀ w> for the linear maps (dot-product test)."""
    ut, q, ct = (_t(a) for a in _fields(9, VEC, SCA, VEC))
    args = (ut.clone().requires_grad_(), q.clone().requires_grad_())
    y = tdk.make_pressure_correct_vjp(DXS)(*args)
    g_ut, g_q = torch.autograd.grad(y, args, ct)
    lhs = torch.sum(y * ct)
    rhs = torch.sum(ut * g_ut) + torch.sum(q * g_q)
    assert abs((lhs - rhs).item()) < 1e-10 * abs(lhs.item())


def test_poisson_mm_matches_jax():
    (f,) = _fields(10, SCA)
    f = f - f.mean()
    ref = jax_make_poisson_mm(BOX, DXS, jnp.float64)(jnp.asarray(f))
    got = make_poisson_mm(BOX, DXS, torch.float64, device="cpu")(_t(f))
    assert _rel(got.numpy(), ref) < TOL_F64


def test_poisson_mm_inverts_the_laplacian_and_differentiates():
    """L p = f for zero-mean f (L the volume-scaled periodic Laplacian),
    and autograd through the solve gives its (self-adjoint) transpose."""
    f, w = _fields(11, SCA, SCA)
    f, w = f - f.mean(), w - w.mean()
    solve = make_poisson_mm(BOX, DXS, torch.float64, device="cpu")
    ft = _t(f, True)
    p = solve(ft)
    vol = float(np.prod(DXS))
    lap = sum((torch.roll(p, -1, a) - 2 * p + torch.roll(p, 1, a)) * vol / DXS[a] ** 2
              for a in range(3))
    assert _rel(lap.detach().numpy(), f) < 1e-10
    (g,) = torch.autograd.grad(p, ft, _t(w))
    assert _rel(g.numpy(), solve(_t(w)).numpy()) < 1e-10
