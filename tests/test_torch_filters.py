"""The port's DNS -> LES filters and the Gaussian force, held against the
JAX package at float64.

`FaceAverage`, `VolumeAverage` and `reconstruct` on random ghosted fields
in 2-D (32² -> 16², compression 2; 36² -> 12², compression 3: the odd
window of `VolumeAverage`) and 3-D (16³ -> 8³), to 1e-13 relative;
`gaussian_force` from the same three uniform draws, to 1e-13.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ins_tpu as ins
import ins_tpu.models as jnc

import ins_tpu_torch as it
from ins_tpu_torch import models as nc

TOL = 1e-13
CASES = [(2, 32, 16), (2, 36, 12), (3, 16, 8)]


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


def _setups(D, n):
    x = (np.linspace(0.0, 1.0, n + 1),) * D
    return (ins.Setup(x=x, Re=2e3, dtype=jnp.float64),
            it.Setup(device="cpu", x=x, Re=2e3, dtype=torch.float64))


@pytest.mark.parametrize("D,ndns,nles", CASES, ids=[f"{d}d_{a}_to_{b}" for d, a, b in CASES])
@pytest.mark.parametrize("name", ["FaceAverage", "VolumeAverage"])
def test_filter_matches_jax(D, ndns, nles, name):
    jd, td = _setups(D, ndns)
    jl, tl = _setups(D, nles)
    comp = ndns // nles
    u = np.random.default_rng(D * ndns).standard_normal((D, *td.grid.N))
    ref = np.asarray(getattr(jnc, name)()(jnp.asarray(u), jl, comp))
    got = getattr(nc, name)()(torch.from_numpy(u), tl, comp).numpy()
    assert got.shape == ref.shape == (D, *tl.grid.N)
    assert _rel(got, ref) < TOL
    # the ghost cells stay zero, as in the JAX package
    assert np.all(got[(slice(None),) + (0,) * D] == 0)


@pytest.mark.parametrize("D,ndns,nles", CASES, ids=[f"{d}d_{a}_to_{b}" for d, a, b in CASES])
def test_reconstruct_matches_jax(D, ndns, nles):
    jd, td = _setups(D, ndns)
    jl, tl = _setups(D, nles)
    comp = ndns // nles
    v = np.random.default_rng(7 + D).standard_normal((D, *tl.grid.N))
    ref = np.asarray(jnc.reconstruct(jnp.asarray(v), jd, jl, comp))
    got = nc.reconstruct(torch.from_numpy(v), td, tl, comp).numpy()
    assert got.shape == ref.shape == (D, *td.grid.N)
    assert _rel(got, ref) < TOL


def test_filter_of_a_constant_is_the_constant():
    """Both filters average: a constant field filters to itself on every
    DOF (3-D, compression 2 and 4)."""
    _, td = _setups(3, 16)
    u = torch.full((3, *td.grid.N), 0.75, dtype=torch.float64)
    for nles in (8, 4):
        _, tl = _setups(3, nles)
        for phi in (nc.FaceAverage(), nc.VolumeAverage()):
            v = phi(u, tl, 16 // nles)
            inner = v[(slice(None),) + (slice(1, -1),) * 3]
            assert torch.allclose(inner, torch.full_like(inner, 0.75), rtol=1e-15, atol=0)


@pytest.mark.parametrize("key", [0, 5])
def test_gaussian_force_matches_jax(key):
    x = (np.linspace(0.0, 1.0, 33), np.linspace(-0.5, 1.5, 41))
    js = ins.Setup(x=x, Re=2e3, dtype=jnp.float64)
    ts = it.Setup(device="cpu", x=x, Re=2e3, dtype=torch.float64)
    rng = jax.random.PRNGKey(key)
    ref = np.asarray(jnc.gaussian_force(js, rng=rng))
    # the JAX package's three draws, fed to the port's formula
    k1, k2, k3 = jax.random.split(rng, 3)
    (x0, x1), (y0, y1) = js.grid.xlims
    a, b, c = (float(jax.random.uniform(k, dtype=jnp.float64)) for k in (k1, k2, k3))
    got = nc.gaussian_bump(ts, x0 + a * (x1 - x0), y0 + b * (y1 - y0), 2 * np.pi * c).numpy()
    assert got.shape == ref.shape == (2, *ts.grid.N)
    assert _rel(got, ref) < TOL
    # gaussian_force draws its three numbers from a numpy Generator
    f = nc.gaussian_force(ts, rng=np.random.default_rng(key))
    assert f.shape == (2, *ts.grid.N) and abs(float(f.mean())) < 1e-18
