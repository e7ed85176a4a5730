"""The port's filtered-DNS data generation, held against the JAX package
at float64.

`create_les_data` in 2-D (32² DNS -> 16² and 8² LES, both filters, a
2-step burn-in, then 6 steps saved every 2) and in 3-D (16³ -> 8³, the
DNS on the periodic fast path), the initial field shared through the
JAX package's uniform draws (`random_field(uniforms=...)` in ``icfunc``);
``u``, ``c`` and ``t`` to 1e-9 relative, `create_io_arrays` exactly on
the same snapshots.  The JAX runs are made once for the module.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ins_tpu as ins
import ins_tpu.models as jnc

import ins_tpu_torch as it
from ins_tpu_torch import models as nc
from ins_tpu_torch.ops.fastpath import hat_chain_applicable

TOL = 1e-9
DT = 1e-3
CASES = {"2d": (2, 32, [16, 8]), "3d": (3, 16, [8])}


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


def _jax_draws(jset, key):
    """The uniform draws `ins_tpu.random_field` makes from `key`, in the
    order `create_spectrum` consumes them."""
    D = jset.grid.dim
    K = tuple((n - 2) // 2 for n in jset.grid.N)
    KK = tuple(2 * k for k in K)
    keys = jax.random.split(key, D + 2)
    draws = [jax.random.uniform(keys[d], K, dtype=jset.dtype) for d in range(D)]
    draws += [jax.random.uniform(keys[d], KK, dtype=jset.dtype)
              for d in range(D, D + (1 if D == 2 else 2))]
    return [np.asarray(v) for v in draws]


def _kw(D, ndns, nles):
    filters = ("FaceAverage", "VolumeAverage") if D == 2 else ("FaceAverage",)
    return dict(D=D, Re=2e3, lims=(0.0, 1.0), nles=nles, ndns=ndns, tburn=2 * DT,
                tsim=6 * DT, savefreq=2, dt=DT, processors={}), filters


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    D, ndns, nles = CASES[request.param]
    kw, filters = _kw(D, ndns, nles)
    key = jax.random.PRNGKey(11)
    ref = jnc.create_les_data(filters=tuple(getattr(jnc, f)() for f in filters), rng=key,
                              dtype=jnp.float64, **kw)
    x = (np.linspace(0.0, 1.0, ndns + 1),) * D
    draws = _jax_draws(ins.Setup(x=x, Re=2e3, dtype=jnp.float64), key)

    def icfunc(dns, psolver, rng):
        assert rng is None
        return it.random_field(dns, psolver=psolver, uniforms=draws)

    got = nc.create_les_data(filters=tuple(getattr(nc, f)() for f in filters), icfunc=icfunc,
                             dtype=torch.float64, device="cpu", **kw)
    les = [it.Setup(device="cpu", x=(np.linspace(0.0, 1.0, n + 1),) * D, Re=2e3,
                    dtype=torch.float64) for n in nles]
    dns = it.Setup(device="cpu", x=x, Re=2e3, dtype=torch.float64)
    return types.SimpleNamespace(ref=ref, got=got, dns=dns, les=les, nfilter=len(filters))


def test_the_3d_dns_steps_the_hat_chain(runs):
    """The 3-D DNS is a periodic cube under RK44: `solve_unsteady` steps it
    on the fused hat chain (its kernels on the card); the 2-D one on the
    roll twin."""
    assert hat_chain_applicable(runs.dns, it.RKMethods.RK44()) == (runs.dns.grid.dim == 3)


def test_create_les_data_matches_jax(runs):
    assert len(runs.got) == len(runs.ref) == len(runs.les) * runs.nfilter
    for g, r in zip(runs.got, runs.ref):
        assert set(g) == set(r)
        assert g["u"].shape == r["u"].shape and g["u"].shape[0] == 4  # t = 0, 2, 4, 6 dt
        assert _rel(g["t"], r["t"]) < TOL
        assert _rel(g["u"], r["u"]) < TOL
        assert _rel(g["c"], r["c"]) < TOL
        assert np.all(np.isfinite(g["c"])) and np.max(np.abs(g["c"])) > 0


def test_create_io_arrays_matches_jax(runs):
    for k, les in enumerate(runs.les):
        pairs = slice(k * runs.nfilter, (k + 1) * runs.nfilter)
        got = nc.create_io_arrays(runs.got[pairs], les)
        ref = jnc.create_io_arrays(runs.got[pairs], ins.Setup(
            x=(np.linspace(0.0, 1.0, les.grid.N[0] - 1),) * les.grid.dim, Re=2e3,
            dtype=jnp.float64))
        for key in ("u", "c"):
            assert got[key].shape == ref[key].shape
            assert np.array_equal(got[key], np.asarray(ref[key]))
