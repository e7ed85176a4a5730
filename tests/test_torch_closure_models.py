"""The port's FNO, G-CNN and library-convolution CNN closures, held against
the JAX package at float64.

Each model is built on both sides; the JAX package's parameters (drawn
by flax under `jax.jit`) are carried to the port by `convert`, and the
forward pass and the gradient of `create_loss_prior` agree to 1e-10
relative.  Cases: the FNO in 2-D (16², gelu) and 3-D (8³), the G-CNN
(16²), the 2-D CNN (16², tanh) and a 3-D CNN with gelu and relu (8³),
which leaves the kernel layers for the library convolution, as the JAX
package leaves Pallas.  Also: the G-CNN's rotation equivariance to
1e-12, the conversion's round trip, and the port's initialisers against
flax's in distribution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import ins_tpu.models as jnc
from ins_tpu.models.cnn import CNN as JCNN
from ins_tpu.models.fno import FNO as JFNO
from ins_tpu.models.groupconv import GCNN as JGCNN

import ins_tpu_torch as it
from ins_tpu_torch import models as nc
from ins_tpu_torch.convert import (
    cnn_params_from_numpy,
    cnn_params_to_numpy,
    flax_params_from_numpy,
    fno_params_from_numpy,
    fno_params_to_numpy,
    gcnn_params_from_numpy,
    gcnn_params_to_numpy,
)
from ins_tpu_torch.ops.fastpath import reghost

TOL = 1e-10


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


def _tgelu(x):
    return F.gelu(x, approximate="tanh")


def _ident(x):
    return x


def _setup(D, n):
    x = (np.linspace(0.0, 1.0, n + 1),) * D
    return it.Setup(device="cpu", x=x, Re=2e3, dtype=torch.float64)


# name: (D, n, JAX module, port builder)
MODELS = {
    "fno2d": (2, 16,
              lambda: JFNO(kmax=(3, 2), channels=(4, 5), activations=(jax.nn.gelu, jax.nn.gelu),
                           psi=jax.nn.gelu, dtype=jnp.float64),
              lambda s: nc.fno(setup=s, kmax=(3, 2), c=(4, 5), sigma=(_tgelu, _tgelu),
                               psi=_tgelu)),
    "fno3d": (3, 8,
              lambda: JFNO(kmax=(1, 1), channels=(3, 4), activations=(jnp.tanh, _ident),
                           psi=jax.nn.gelu, dtype=jnp.float64),
              lambda s: nc.fno(setup=s, kmax=(1, 1), c=(3, 4), sigma=(torch.tanh, _ident),
                               psi=_tgelu)),
    "gcnn": (2, 16,
             lambda: JGCNN(radii=(1, 2, 1), channels=(2, 3, 1),
                           activations=(jnp.tanh, jnp.tanh, _ident),
                           use_bias=(True, True, False), dtype=jnp.float64),
             lambda s: nc.gcnn(setup=s, radii=(1, 2, 1), channels=(2, 3, 1),
                               activations=(torch.tanh, torch.tanh, _ident),
                               use_bias=(True, True, False))),
    "cnn2d": (2, 16,
              lambda: JCNN(radii=(2, 1), channels=(4, 2), activations=(jnp.tanh, _ident),
                           use_bias=(True, False), dtype=jnp.float64),
              lambda s: nc.cnn(setup=s, radii=(2, 1), channels=(4, 2),
                               activations=(torch.tanh, _ident), use_bias=(True, False))),
    "cnn3d_gelu_relu": (3, 8,
                        lambda: JCNN(radii=(1, 1), channels=(4, 3),
                                     activations=(jax.nn.gelu, jax.nn.relu),
                                     use_bias=(True, True), dtype=jnp.float64),
                        lambda s: nc.cnn(setup=s, radii=(1, 1), channels=(4, 3),
                                         activations=(_tgelu, F.relu),
                                         use_bias=(True, True))),
}
# each model's (from_numpy, to_numpy) pair in `convert`
CONVERT = {"fno2d": (fno_params_from_numpy, fno_params_to_numpy),
           "fno3d": (fno_params_from_numpy, fno_params_to_numpy),
           "gcnn": (gcnn_params_from_numpy, gcnn_params_to_numpy),
           "cnn2d": (cnn_params_from_numpy, cnn_params_to_numpy),
           "cnn3d_gelu_relu": (cnn_params_from_numpy, cnn_params_to_numpy)}


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    """Both sides of one model: the JAX closure and its parameters, the
    port's closure, its own drawn theta, and a batch (x, y)."""
    name = request.param
    D, n, jmodel, build = MODELS[name]
    jm = jmodel()
    x = np.random.default_rng(3).standard_normal((2, *(n,) * D, D))
    y = np.random.default_rng(4).standard_normal((2, *(n,) * D, D))
    jth = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x[:1]))["params"]

    def jclosure(v, th):
        return jm.apply({"params": th}, v)

    jloss = jnc.create_loss_prior(jclosure)
    jout = np.asarray(jax.jit(jclosure)(jnp.asarray(x), jth))
    jval, jgrad = jax.jit(jax.value_and_grad(lambda th: jloss((jnp.asarray(x), jnp.asarray(y)),
                                                              th)))(jth)
    closure, theta = build(_setup(D, n))
    return dict(name=name, D=D, n=n, jth=jth, jout=jout, jval=float(jval),
                jgrad=flax_params_from_numpy(jgrad, device="cpu"), closure=closure,
                theta=theta, x=torch.from_numpy(x), y=torch.from_numpy(y))


def test_parameters_have_flax_names_and_shapes(model):
    jflat = flax_params_from_numpy(model["jth"], device="cpu")
    assert {k: tuple(v.shape) for k, v in model["theta"].items()} == {
        k: tuple(v.shape) for k, v in jflat.items()}


def test_forward_matches_jax(model):
    theta = CONVERT[model["name"]][0](model["jth"], device="cpu")
    got = model["closure"](model["x"], theta).detach().numpy()
    assert got.shape == model["jout"].shape
    assert _rel(got, model["jout"]) < TOL


def test_loss_prior_gradient_matches_jax(model):
    theta = CONVERT[model["name"]][0](model["jth"], device="cpu")
    value = nc.create_loss_prior(model["closure"])((model["x"], model["y"]), theta)
    grads = torch.autograd.grad(value, list(theta.values()))
    assert abs(value.item() - model["jval"]) < TOL * abs(model["jval"])
    for name, g in zip(theta, grads):
        assert _rel(g.numpy(), model["jgrad"][name].detach().numpy()) < TOL, name


def test_conversion_round_trip(model):
    from_numpy, to_numpy = CONVERT[model["name"]]
    first = from_numpy(model["jth"], device="cpu")
    tree = to_numpy(first)
    flat_j = jax.tree_util.tree_flatten_with_path(model["jth"])[0]
    flat_t = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (_, a), (_, b) in zip(flat_j, flat_t):
        assert np.array_equal(np.asarray(a), b) and b.dtype == np.float64
    back = from_numpy(tree, device="cpu")
    assert set(back) == set(model["theta"]) == set(first)
    assert all(torch.equal(back[k], first[k]) and back[k].requires_grad for k in back)


def test_gcnn_is_rotation_equivariant():
    """Rotating the input field by a quarter turn rotates the closure's
    force (16² periodic box, the module's G-CNN), to 1e-12."""
    s = _setup(2, 16)
    closure, theta = MODELS["gcnn"][3](s)
    m = nc.wrappedclosure(closure, s)
    u = reghost(torch.from_numpy(np.random.default_rng(9).standard_normal((2, 16, 16))))
    sl = (slice(None), slice(1, -1), slice(1, -1))
    with torch.no_grad():
        for g in (1, 2, 3):
            a = nc.rot2stag(m(u, theta), g)[sl]
            b = m(nc.rot2stag(u, g), theta)[sl]
            assert _rel(a.numpy(), b.numpy()) < 1e-12, g
        # the CNN of the same widths is not equivariant
        cl, th = MODELS["cnn2d"][3](s)
        mc = nc.wrappedclosure(cl, s)
        a = nc.rot2stag(mc(u, th), 1)[sl]
        b = mc(nc.rot2stag(u, 1), th)[sl]
        assert _rel(a.numpy(), b.numpy()) > 1e-3


def test_rot2stag_matches_jax():
    u = np.random.default_rng(2).standard_normal((2, 10, 10))
    for g in range(4):
        ref = np.asarray(jnc.rot2stag(jnp.asarray(u), g))
        assert np.array_equal(nc.rot2stag(torch.from_numpy(u), g).numpy(), ref), g
        assert np.array_equal(nc.vecrot2(torch.from_numpy(u.transpose(1, 2, 0)), g).numpy(),
                              np.asarray(jnc.vecrot2(jnp.asarray(u.transpose(1, 2, 0)), g)))


def _same_distribution(a, b, name):
    """Two draws of one initialiser: the same bound (within 5 %) and
    standard deviations within four of their sampling spreads (a uniform
    or truncated normal sample's std spreads by < 0.7/sqrt(size))."""
    a, b = np.asarray(a), np.asarray(b)
    if np.all(b == 0):
        assert np.all(a == 0), name
        return
    assert abs(np.std(a) / np.std(b) - 1) < 4 / np.sqrt(a.size), name
    assert np.max(np.abs(a)) <= np.max(np.abs(b)) * 1.05 or a.size < 2000, name


def test_initialisers_follow_flax_in_distribution():
    """The FNO's and the G-CNN's parameters drawn by the port and by flax:
    glorot-uniform weights over the axes the JAX package names,
    lecun-normal 1x1 kernels, zero biases."""
    s = _setup(2, 64)
    x0 = jnp.zeros((1, 64, 64, 2))
    _, th = nc.fno(setup=s, kmax=(7,), c=(32,), sigma=(_ident,), psi=_ident,
                   generator=torch.Generator().manual_seed(0))
    jm = JFNO(kmax=(7,), channels=(32,), activations=(_ident,), psi=_ident, dtype=jnp.float64)
    jth = flax_params_from_numpy(jax.jit(jm.init)(jax.random.PRNGKey(0), x0)["params"],
                                 device="cpu")
    for name in th:
        _same_distribution(th[name].detach(), jth[name].detach(), name)
    _, th = nc.gcnn(setup=s, radii=(2, 2), channels=(16, 1), activations=(_ident, _ident),
                    use_bias=(True, False), generator=torch.Generator().manual_seed(0))
    jm = JGCNN(radii=(2, 2), channels=(16, 1), activations=(_ident, _ident),
               use_bias=(True, False), dtype=jnp.float64)
    jth = flax_params_from_numpy(jax.jit(jm.init)(jax.random.PRNGKey(0), x0)["params"],
                                 device="cpu")
    for name in th:
        _same_distribution(th[name].detach(), jth[name].detach(), name)
