"""Helpers shared by the halo chain's tests (`tests/test_torch_halo.py`,
`tests/test_torch_halo_les.py`): relative error, array conversion, an
x-slab and its ghost planes cut from a global field, the JAX package's
random 16³ velocity, and a one-rank gloo mesh."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import ins_tpu as ins
from ins_tpu_torch.parallel import make_mesh

N = 16


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def j(a):
    return jnp.asarray(a, jnp.float64)


def blk(a, x0, lx):
    """The x-planes x0 .. x0 + lx - 1 of ``a`` (x is axis -3)."""
    return np.take(a, range(x0, x0 + lx), axis=-3)


def lo(a, k, x0):
    """The k ghost planes below plane x0, wrapped."""
    return np.take(a, range(x0 - k, x0), axis=-3, mode="wrap")


def hi(a, k, x0, lx):
    """The k ghost planes above the slab x0 .. x0 + lx - 1, wrapped."""
    return np.take(a, range(x0 + lx, x0 + lx + k), axis=-3, mode="wrap")


@functools.lru_cache(maxsize=None)
def u0(key):
    """The JAX package's ghosted `random_field(kp=4)` on the 16³ cube
    from ``PRNGKey(key)``, f64."""
    x = (np.linspace(0, 2 * np.pi, N + 1),) * 3
    jset = ins.Setup(x=x, Re=1e3, dtype=jnp.float64)
    return np.array(jax.jit(lambda k: ins.random_field(jset, kp=4, rng=k))(
        jax.random.PRNGKey(key)))


@pytest.fixture
def one_rank():
    """A one-rank gloo mesh that `make_mesh` makes itself (in-memory
    store), torn down afterwards."""
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()
