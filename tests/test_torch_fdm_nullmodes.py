"""The fast diagonalization's null modes (CPU, f64).

`fdm_solve_box` pins a mode to zero only where every axis's eigenvalue
is that axis's null one (the smallest |lambda_d| of an axis with no
pressure side).  The JAX package's test, |sum_d lambda_d| below 1e-8 of
its maximum, also cuts true modes once a grid's cells span a ratio of a
few thousand: a 2-D wall-bounded box at n = 48 .. 128 stretched by 1.2 ..
1.07 a cell along x, where the JAX package's solve leaves a relative
residual of 3.6e-2 to 8.7e-2 (4 to 23 modes cut, 1 of them null).  There
the port's solve leaves 2e-11 to 3e-10, agrees
with `psolver_direct` (a sparse LU) and makes the FDM-preconditioned
`psolver_cg` converge in a few iterations, finite.  On grids where the
JAX package's test cuts only the null mode (uniform, cosine, tanh and
channel grids, symmetric and pressure sides) both tests pick the same
modes, so the solve's eigenvalue scaling is the old one entry for entry,
and the port equals the JAX package's solve to 1e-12.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ins_tpu as ins

import ins_tpu_torch as it
from ins_tpu_torch.ops import fdm

TOL = 1e-9
# (n, the cell ratio along x): the JAX package's test cuts true modes here
STRETCHED = [(48, 1.2), (64, 1.15), (96, 1.1), (128, 1.07)]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: many small float64 operations, which
    oversubscribed threads slow by orders of magnitude when the test lane
    runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _box(pk, x, bcs, dtype=None, **kw):
    return pk.Setup(x=x, boundary_conditions=bcs(pk), Re=100.0,
                    dtype=dtype or (torch.float64 if pk is it else jnp.float64), **kw)


def _walls(pk):
    d = pk.DirichletBC()
    return ((d, d), (d, pk.DirichletBC((1.0, 0.0))))


@functools.lru_cache(maxsize=None)
def _stretched(n, s):
    x = (ins.stretched_grid(0.0, 1.0, n, s), np.linspace(0.0, 1.0, n + 1))
    return x, _box(it, x, _walls, device="cpu")


def _rhs(setup, seed=0):
    f = np.random.default_rng(seed).standard_normal(setup.grid.Np)
    return torch.from_numpy(f - f.mean())


def _residual(setup, p, f):
    lap = fdm.laplacian_box(setup)
    return float((lap(p) - f).norm() / f.norm())


def _lams(setup):
    return [lam for lam, _, _ in fdm._axis_spectra(setup)]


@pytest.mark.parametrize("n,s", STRETCHED)
def test_stretched_solve_against_direct(n, s):
    """The JAX package's test cuts true modes; the port's keeps them: its
    residual is below 1e-9, and its solution is `psolver_direct`'s (up to
    the constant the null mode leaves free) to 1e-8 of its range."""
    _, st = _stretched(n, s)
    per_axis, by_sum = fdm.fdm_null_modes(st)
    assert per_axis == 1 and by_sum > 1
    f = _rhs(st)
    p = fdm.psolver_fdm(st)(f)
    assert _residual(st, p, f) < TOL
    pd = it.psolver_direct(st)(f)
    assert _residual(st, pd, f) < TOL
    d = (p - pd) - (p - pd).mean()
    assert float(d.abs().max() / (pd.max() - pd.min())) < 1e-8


@pytest.mark.parametrize("n,s", STRETCHED)
def test_fdm_preconditioned_cg_converges(n, s):
    """`psolver_cg(precond="fdm")` on the stretched grids: finite, to a
    residual of 1e-10 in at most 3 iterations."""
    _, st = _stretched(n, s)
    f = _rhs(st, 1)
    ps = it.psolver_cg(st, precond="fdm", reltol=1e-10, maxiter=50)
    p = ps(f)
    assert bool(torch.isfinite(p).all())
    assert _residual(st, p, f) < 1e-9 and int(ps.iterations) <= 3


def test_jax_cut_drops_true_modes():
    """The fault the port does not copy: the JAX package's solve on the
    64² grid stretched by 1.15 leaves a residual above 1e-2."""
    x, st = _stretched(64, 1.15)
    js = _box(ins, x, _walls)
    f = _rhs(st).numpy()
    fj = np.zeros(js.grid.N)
    fj[1:-1, 1:-1] = f
    p = np.array(jax.jit(ins.psolver_fdm(js))(jnp.asarray(fj)))[1:-1, 1:-1]
    assert _residual(st, torch.from_numpy(p), torch.from_numpy(f)) > 1e-2


def _symmetric(pk):
    return ((pk.SymmetricBC(), pk.SymmetricBC()), (pk.DirichletBC(), pk.DirichletBC()))


def _outlet(pk):
    return ((pk.DirichletBC(), pk.PressureBC()), (pk.SymmetricBC(), pk.DirichletBC()))


def _channel(pk):
    p = (pk.PeriodicBC(), pk.PeriodicBC())
    return (p, p, (pk.DirichletBC(), pk.DirichletBC()))


SAME = {
    "uniform": ((np.linspace(0, 1, 17),) * 2, _walls),
    "cosine": ((ins.cosine_grid(0, 1, 32),) * 2, _walls),
    "tanh_symmetric": ((ins.tanh_grid(0, 1, 12, 1.5), np.linspace(0, 1, 9)), _symmetric),
    "outlet": ((ins.stretched_grid(0, 2, 12, 1.05), ins.cosine_grid(0, 1, 10)), _outlet),
    "channel": ((np.linspace(0, 4 * np.pi, 13), np.linspace(0, 2 * np.pi, 11),
                 ins.tanh_grid(0, 2, 8, 1.3)), _channel),
}


@pytest.mark.parametrize("name", list(SAME))
def test_same_modes_as_jax_where_it_drops_none(name):
    """Both tests pick the same modes (so the eigenvalue scaling is the
    old one entry for entry) and the port's solve equals the JAX
    package's to 1e-12."""
    x, bcs = SAME[name]
    st, js = _box(it, x, bcs, device="cpu"), _box(ins, x, bcs)
    lams = _lams(st)
    small = fdm._null_mask(st, lams)
    assert np.array_equal(small, fdm._sum_cut(fdm._denominator(lams)))
    assert int(small.sum()) == (0 if name == "outlet" else 1)
    f = np.random.default_rng(2).standard_normal(st.grid.Np)
    ip = tuple(slice(a, b) for a, b in js.grid.Ip)
    fj = np.zeros(js.grid.N)
    fj[ip] = f
    ref = np.array(jax.jit(ins.psolver_fdm(js))(jnp.asarray(fj)))[ip]
    got = fdm.psolver_fdm(st)(torch.from_numpy(f)).numpy()
    assert float(np.abs(got - ref).max() / np.abs(ref).max()) < 1e-12


@pytest.mark.parametrize("name", ["channel", "rb3d"])
def test_float32_grids_keep_one_null_mode(name):
    """A float32 setup's operator carries its entries' rounding: its
    computed null modes sit at 3e-10 to 4e-9 of max|lambda_d| on the
    channel's grid, above the lowest true mode of a 512² cosine grid
    (1.3e-9 of it), so the test picks each axis's smallest mode, not one
    under an epsilon: one null mode, the JAX package's here."""
    if name == "channel":
        x = (np.linspace(0, 4 * np.pi, 257), np.linspace(0, 2 * np.pi, 129),
             ins.tanh_grid(0, 2, 128, 1.2))
        st = _box(it, x, _channel, device="cpu", dtype=torch.float32)
    else:
        x = (ins.stretched_grid(0, 2, 120), ins.stretched_grid(0, 1, 60),
             ins.tanh_grid(0, 1, 60, 1.2))
        p, d = (it.PeriodicBC(), it.PeriodicBC()), (it.DirichletBC(), it.DirichletBC())
        st = it.Setup(x=x, boundary_conditions=(p, d, d), device="cpu", dtype=torch.float32)
    lams = _lams(st)
    small = fdm._null_mask(st, lams)
    assert int(small.sum()) == 1
    assert np.array_equal(small, fdm._sum_cut(fdm._denominator(lams)))
    eps = float(np.finfo(np.float64).eps)
    assert max(float(np.min(np.abs(lam)) / np.max(np.abs(lam))) for lam in lams) > 8 * eps
