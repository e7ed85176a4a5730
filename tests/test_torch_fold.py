"""The radix-2 folded pass B of the port against the JAX package (CPU, f64).

On CPU tensors `passB_fold` runs its plain version, the recursion of the
JAX package's `_passB_fold_body` in torch.  The JAX kernels run in
interpret mode at ``precision="highest"`` (``"manualhigh"`` splits the
operands into bf16 and would break f64 parity).  Both sides compute the
same fast-diagonalization solve in f64, so they agree to ~1e-14; 1e-12
is the bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ins_tpu.ops import poisson_pallas as jpp

from ins_tpu_torch.ops import launches
from ins_tpu_torch.ops.poisson_kernels import (
    fold_levels_default,
    make_fused_projection,
    passB,
    passB_fold,
    passB_fold_plain,
    passB_plain,
    poisson_fold_consts,
)
from ins_tpu_torch.ops.transforms import yz_transform_plain

TOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _dxs(n):
    return (2 * np.pi / n, 2 * np.pi / n, np.pi / n)


def _field(seed, n):
    return np.random.default_rng(seed).standard_normal((n, n, n))


@pytest.mark.parametrize("n", [8, 16, 18, 64, 128, 256, 512])
def test_fold_levels_default_matches_jax(n):
    assert fold_levels_default(n) == jpp.fold_levels_default(n)


@pytest.mark.parametrize("n,levels", [(16, None), (32, 2)])
def test_fold_consts_match_jax(n, levels):
    dxs = _dxs(n)
    mats, lv, eps = poisson_fold_consts((n,) * 3, dxs, torch.float64, levels=levels,
                                        device="cpu")
    jmats, jlv, jeps = jpp.poisson_fold_consts((n,) * 3, dxs, jnp.float64, levels=levels)
    assert lv == jlv and eps == pytest.approx(jeps, rel=1e-15)
    assert len(mats) == len(jmats) == 2 * lv + 2
    for m, jm in zip(mats, jmats):
        assert m.shape == jm.shape
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=0, atol=1e-15)


def test_passB_fold_matches_pallas():
    """16³ (one level): the port's folded and dense plain pass B against
    the JAX package's `make_fused_projection` pass B (which folds at
    n % 4 == 0), interpret mode."""
    n = 16
    dxs = _dxs(n)
    h = _field(1, n)
    jproj = jpp.make_fused_projection((n,) * 3, dxs, jnp.float64, precision="highest",
                                      interpret=True)
    ref = np.asarray(jproj["passB"](jnp.asarray(h)))
    proj = make_fused_projection((n,) * 3, dxs, torch.float64, device="cpu")
    assert proj["fold_levels"] == 1
    got = passB_fold_plain(torch.from_numpy(h), proj)
    assert _rel(got.numpy(), ref) < TOL
    assert _rel(passB_plain(torch.from_numpy(h), proj).numpy(), ref) < TOL


def test_passB_fold_two_levels_matches_pallas():
    """32³ with two fold levels (the recursion): the full solve through
    the port's plane transforms and the folded pass B against the JAX
    package's 3-pass `make_poisson_pallas(fold_levels=2)`."""
    n = 32
    dxs = _dxs(n)
    f = _field(2, n)
    jsolve = jpp.make_poisson_pallas((n,) * 3, dxs, jnp.float64, precision="highest",
                                     interpret=True, fold_levels=2)
    ref = np.asarray(jsolve(jnp.asarray(f)))
    proj = make_fused_projection((n,) * 3, dxs, torch.float64, device="cpu")
    mats, levels, _ = poisson_fold_consts((n,) * 3, dxs, torch.float64, levels=2,
                                          device="cpu")
    proj2 = dict(proj, fold_mats=mats, fold_levels=levels)
    h = yz_transform_plain(torch.from_numpy(f), proj["Vinv"], proj["VinvT"])
    got = yz_transform_plain(passB_fold_plain(h, proj2), proj["V"], proj["VT"])
    assert _rel(got.numpy(), ref) < TOL
    # the same qhat as one level and as the dense pass B
    assert _rel(passB_fold_plain(h, proj2).numpy(), passB_plain(h, proj).numpy()) < TOL
    assert _rel(passB_fold_plain(h, proj).numpy(), passB_plain(h, proj).numpy()) < TOL


@pytest.mark.parametrize("n,fold", [(16, True), (18, False)])
def test_make_fused_projection_picks_the_fold(n, fold):
    """The fold wherever n % 4 == 0, the dense pass B otherwise; on CPU
    tensors the wrappers run the plain versions and launch nothing."""
    proj = make_fused_projection((n,) * 3, _dxs(n), torch.float64, device="cpu")
    h = torch.from_numpy(_field(3, n))
    launches.reset_counts()
    if fold:
        assert proj["fold_levels"] == 1
        ref = passB_fold_plain(h, proj)
        assert torch.equal(passB_fold(h, proj), ref)
    else:
        assert proj["fold_levels"] is None and proj["fold_mats"] is None
        ref = passB_plain(h, proj)
        assert torch.equal(passB(h, proj), ref)
    assert torch.equal(proj["passB"](h), ref)
    assert torch.equal(proj["passB_plain"](h), ref)
    assert not any(launches.LAUNCHES.values())


def test_fold_consts_reject_too_many_levels():
    with pytest.raises(ValueError, match="fold levels"):
        poisson_fold_consts((12,) * 3, _dxs(12), torch.float64, levels=2, device="cpu")
