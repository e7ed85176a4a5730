"""The port's closure convolutions and CNN, held against the JAX package.

The plain versions of the conv kernels (what the wrappers run on CPU
tensors) are compared with the JAX package's fused-fold Pallas kernels
in interpret mode, float32 (the Pallas kernels accumulate in float32);
the weights go through `pack_ws` / `unpack_dws` on the JAX side only.
The CNN is compared with `ins_tpu.models.cnn` with the parameters
carried by `convert`.  The CUDA kernels run only on the card:
`chip_smoke.py` holds each against its plain version at 64³ and 128³.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ins_tpu as ins
from ins_tpu.ops import convkernels as jck

from torch_jax_oracles import jax_cnn

import ins_tpu_torch as it
from ins_tpu_torch import models as nc
from ins_tpu_torch.convert import cnn_params_from_numpy, cnn_params_to_numpy
from ins_tpu_torch.ops import conv_kernels as ck
from ins_tpu_torch.ops import launches

# float32 on both sides, sums in another order: ~1e-7 relative
TOL_F32 = 1e-5
TOL_F64 = 1e-10
# bf16 operands: the JAX CPU path rounds its conv output to bf16 before
# the bias, the port (like the JAX kernel path) after the activation
TOL_BF16 = 1e-2

BOX = (6, 8, 16)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _case(cin, cout, k, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((*BOX, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, k, cin, cout)) / np.sqrt(k**3 * cin)).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    return h, w, b


def _lanes(a):
    """Pad channels to the JAX kernels' 128-lane carry."""
    return jnp.pad(jnp.asarray(a), ((0, 0),) * 3 + ((0, 128 - a.shape[-1]),))


@pytest.mark.parametrize(
    "cin,cout,act,has_bias", [(3, 4, "tanh", True), (4, 3, "id", False)],
)
def test_fusedconv_plain_matches_pallas(cin, cout, act, has_bias):
    h, w, b = _case(cin, cout, 3, seed=cin)
    ref = jck.fusedconv_3d(
        _lanes(h), jck.pack_ws(jnp.asarray(w), jnp.float32), jnp.asarray(b) if has_bias else None,
        jnp.tanh if act == "tanh" else None, cin=cin, cout=cout, k=3, interpret=True,
    )[..., :cout]
    got = ck.fusedconv_3d_plain(torch.from_numpy(h), torch.from_numpy(w),
                                torch.from_numpy(b) if has_bias else None, act)
    assert got.dtype == torch.float32 and got.shape == (*BOX, cout)
    assert _rel(got.numpy(), ref) < TOL_F32


def test_fusedconv_wgrad_plain_matches_pallas():
    cin, cout, k = 3, 4, 3
    h, _, _ = _case(cin, cout, k, seed=5)
    d = np.random.default_rng(6).standard_normal((*BOX, cout)).astype(np.float32)
    dws = jck.fusedconv_wgrad_3d(_lanes(h), _lanes(d), cin=cin, cout=cout, k=k, interpret=True)
    ref = jck.unpack_dws(dws, k, k, k, cin, cout)
    got = ck.fusedconv_wgrad_3d_plain(torch.from_numpy(h), torch.from_numpy(d), k)
    assert got.shape == (k, k, k, cin, cout) and got.dtype == torch.float32
    assert _rel(got.numpy(), ref) < TOL_F32


def test_input_gradient_is_the_flipped_tap_conv():
    """<conv(h, w), d> == <h, conv(d, flip_taps(w))> (periodic)."""
    h, w, _ = _case(3, 4, 5, seed=7)
    d = np.random.default_rng(8).standard_normal((*BOX, 4))
    h, w, d = (torch.from_numpy(a).double() for a in (h, w, d))
    lhs = torch.sum(ck.fusedconv_3d_plain(h, w) * d)
    rhs = torch.sum(h * ck.fusedconv_3d_plain(d, ck.flip_taps(w)))
    assert abs((lhs - rhs).item()) < 1e-12 * abs(lhs.item())


@pytest.mark.parametrize("actname,has_bias", [("tanh", True), ("id", False)])
def test_fused_layer_gradient_matches_pallas(actname, has_bias):
    cin, cout, k = 3, 4, 3
    h, w, b = _case(cin, cout, k, seed=9)
    jlayer = jck.make_fused_layer(actname, has_bias, cin=cin, cout=cout, k=k, interpret=True)

    def f_jax(h, w, b):
        return jnp.sum(jnp.sin(jlayer(h, w, b)[..., :cout]))

    vr, gr = jax.jit(jax.value_and_grad(f_jax, argnums=(0, 1, 2)))(_lanes(h), jnp.asarray(w),
                                                                    jnp.asarray(b))
    layer = ck.make_fused_layer(actname, has_bias, cin=cin, cout=cout, k=k)
    args = [torch.from_numpy(a).requires_grad_() for a in (h, w, b)]
    v = torch.sum(torch.sin(layer(*args)))
    g = torch.autograd.grad(v, args if has_bias else args[:2])
    assert abs(v.item() - float(vr)) < TOL_F32 * abs(float(vr))
    assert _rel(g[0].numpy(), np.asarray(gr[0])[..., :cin]) < TOL_F32
    assert _rel(g[1].numpy(), gr[1]) < TOL_F32
    if has_bias:
        assert _rel(g[2].numpy(), gr[2]) < TOL_F32


def test_fused_layer_skips_dh_for_inputs_without_grad():
    h, w, b = _case(3, 4, 3, seed=10)
    layer = ck.make_fused_layer("tanh", True, cin=3, cout=4, k=3)
    wt = torch.from_numpy(w).requires_grad_()
    y = layer(torch.from_numpy(h), wt, torch.from_numpy(b))
    (gw,) = torch.autograd.grad(y.sum(), wt)
    assert gw.shape == wt.shape


def _setups(n, dtype):
    x = tuple(np.linspace(0.0, 1.0, n + 1) for _ in range(3))
    jt = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    return ins.Setup(x=x, Re=2000.0, dtype=jt), it.Setup(device="cpu", x=x, Re=2000.0, dtype=dtype)


@pytest.fixture(scope="module", params=["f64", "bf16"])
def cnns(request):
    """The JAX and the port's CNN (radii (1, 1), channels (4, 3)) with the
    JAX parameters carried over: float64 convs at float64, and the default
    bf16 convs at float32."""
    f64 = request.param == "f64"
    js, ts = _setups(8, torch.float64 if f64 else torch.float32)
    kw = dict(radii=[1, 1], channels=[4, 3], use_bias=[True, False])
    jcl, jth = jax_cnn(setup=js, activations=[jax.nn.tanh, lambda v: v],
                       rng=jax.random.PRNGKey(0), compute_dtype=jnp.float64 if f64 else None,
                       **kw)
    tcl, _ = nc.cnn(setup=ts, activations=[torch.tanh, lambda v: v],
                    compute_dtype=torch.float64 if f64 else None, **kw)
    return types.SimpleNamespace(prec=request.param, jcl=jcl, jth=jth, tcl=tcl,
                                 tth=cnn_params_from_numpy(jth, device="cpu"))


def test_cnn_matches_jax(cnns):
    x = np.random.default_rng(11).standard_normal((2, 8, 8, 8, 3))
    x = x.astype(np.float64 if cnns.prec == "f64" else np.float32)
    ref = jax.jit(cnns.jcl)(jnp.asarray(x), cnns.jth)
    got = cnns.tcl(torch.from_numpy(x), cnns.tth)
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == x.shape
    assert _rel(got.detach().numpy(), ref) < (TOL_F64 if cnns.prec == "f64" else TOL_BF16)


def test_cnn_params_round_trip(cnns):
    jth, tth = cnns.jth, cnns.tth
    back = cnn_params_to_numpy(tth)
    assert set(back) == set(jth) == {"conv0_kernel", "conv0_bias", "conv1_kernel"}
    for k in back:
        assert np.array_equal(back[k], np.asarray(jth[k]))
        assert tth[k].is_leaf and tth[k].requires_grad


def test_cnn_init_is_lecun_normal():
    """The port's own init: lecun-normal (fan_in = taps × cin), zero bias."""
    _, ts = _setups(8, torch.float32)
    _, theta = nc.cnn(setup=ts, radii=[2, 1], channels=[64, 3], activations=[torch.tanh] * 2,
                      use_bias=[True, False], generator=torch.Generator().manual_seed(1))
    w = theta["conv0_kernel"]
    assert w.shape == (5, 5, 5, 3, 64)
    assert abs(w.std().item() * np.sqrt(125 * 3) - 1.0) < 0.05
    assert w.abs().max().item() <= 2 / 0.87962566103423978 / np.sqrt(375) + 1e-7
    assert torch.equal(theta["conv0_bias"], torch.zeros(64))


def test_cnn_runs_plain_layers_on_cpu():
    _, ts = _setups(8, torch.float32)
    closure, theta = nc.cnn(setup=ts, radii=[1], channels=[3], activations=[torch.tanh],
                            use_bias=[True], generator=torch.Generator().manual_seed(2))
    launches.reset_counts()
    y = closure(torch.randn(1, 8, 8, 8, 3, generator=torch.Generator().manual_seed(3)), theta)
    assert y.shape == (1, 8, 8, 8, 3) and bool(torch.isfinite(y).all())
    assert not any(launches.LAUNCHES.values())


def test_cnn_rejects_activations_without_a_kernel():
    """A relu layer has no kernel: the kernel layers reject the stack,
    which runs on the library convolution instead (all or nothing, as the
    JAX package leaves Pallas for ``lax.conv``) and equals the JAX
    package's CNN at float64; a tanh stack stays on the kernel layers."""
    js, ts = _setups(8, torch.float64)
    kw = dict(radii=[1], channels=[3], use_bias=[True])
    jcl, jth = jax_cnn(setup=js, activations=[jax.nn.relu], rng=jax.random.PRNGKey(4),
                       compute_dtype=jnp.float64, **kw)
    closure, _ = nc.cnn(setup=ts, activations=[torch.relu], **kw)
    assert not nc.CNN(activations=[torch.relu], **kw).on_kernels
    x = np.random.default_rng(12).standard_normal((2, 8, 8, 8, 3))
    got = closure(torch.from_numpy(x), cnn_params_from_numpy(jth, device="cpu"))
    assert _rel(got.detach().numpy(), jax.jit(jcl)(jnp.asarray(x), jth)) < TOL_F64
    assert nc.CNN(activations=[torch.tanh], **kw).on_kernels


def test_conv_gate_rejects_even_taps():
    h = torch.zeros(*BOX, 3)
    with pytest.raises(ValueError, match="odd"):
        ck.fusedconv_3d(h, torch.zeros(2, 2, 2, 3, 3))
