"""The port's tap-matmul / pack-tile conv layer, held against the JAX package.

The plain versions (what the wrappers run on CPU tensors) are compared
with `ins_tpu.ops.convkernels`' Pallas kernels in interpret mode, as
`tests/test_convkernels.py` runs them: the JAX kernels need nz and kc in
multiples of 128, so nz = 128 and nx, ny stay small.  The port takes the
JAX glue's 128-lane zero-padded g as it is and the unpadded one alike.
`make_conv_layer`'s custom VJP is compared with `jax.value_and_grad` of
the JAX layer, and the z-fold glue (`models.cnn._pallas_conv_layer`)
with the JAX one.  The CUDA kernels run only on the card: `chip_smoke.py`
holds each against its plain version at the closure stack's full width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ins_tpu.models.cnn import _pallas_conv_layer as jax_conv_layer
from ins_tpu.ops import convkernels as jck

from ins_tpu_torch.models.cnn import _pallas_conv_layer
from ins_tpu_torch.ops import conv_kernels as ck

# float32 on both sides, sums in another order: the JAX tests' own bounds
ATOL_F32 = 1e-5
# the layer's gradients: the JAX test's bound against its einsum reference
VJP_TOL = 2e-4
# bf16 operands: a layer output that rounds the other way is one bf16 ulp
TOL_BF16 = 1e-2
TOL_F64 = 1e-12


def _mk(nx=5, ny=6, nz=128, cin=24, cout=24, kx=3, ky=3, seed=0):
    """`tests/test_convkernels.py`'s inputs: g zero-padded to 128 lanes
    (its first cin channels drawn), w2 likewise, a bias."""
    rng = np.random.default_rng(seed)
    kc = jck.lanes(cin)
    g = np.zeros((nx + kx - 1, ny + ky - 1, nz, kc), np.float32)
    g[..., :cin] = rng.standard_normal((nx + kx - 1, ny + ky - 1, nz, cin))
    w2 = np.zeros((kx, ky, kc, cout), np.float32)
    w2[:, :, :cin] = 0.3 * rng.standard_normal((kx, ky, cin, cout))
    b = (0.1 * rng.standard_normal((cout,))).astype(np.float32)
    return g, w2, b


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


@pytest.mark.parametrize(
    "act,has_bias,mk",  # `tests/test_convkernels.py`'s two tap cases
    [("tanh", True, {}), ("id", False, dict(nx=4, ny=4, cin=8, cout=128, seed=1))],
)
def test_tapconv_plain_matches_pallas(act, has_bias, mk):
    g, w2, b = _mk(**mk)
    cin, cout = mk.get("cin", 24), w2.shape[-1]
    assert ck.lanes(cin) == jck.lanes(cin) == g.shape[-1]
    bias = b if has_bias else None
    ref = jck.tapconv_3d(jnp.asarray(g), jnp.asarray(w2),
                         None if bias is None else jnp.asarray(bias),
                         jnp.tanh if act == "tanh" else None, interpret=True)[..., :cout]
    tb = None if bias is None else _t(bias)
    got = ck.tapconv_3d_plain(_t(g), _t(w2), tb, act)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL_F32)
    # the unpadded channels give the same result
    got_u = ck.tapconv_3d_plain(_t(g[..., :cin]), _t(w2[:, :, :cin]), tb, act)
    np.testing.assert_allclose(got_u.numpy(), got.numpy(), rtol=0, atol=ATOL_F32)
    # the wrapper runs the plain version on CPU tensors
    assert torch.equal(ck.tapconv_3d(_t(g), _t(w2), tb, act), got)


@pytest.mark.parametrize(
    "cin,cout,kx,ky",
    [(24, 24, 3, 3),  # per-dx tiles in the JAX kernel (ky*cout <= 128 < kx*ky*cout)
     (16, 8, 3, 3)],  # all taps in one tile (kx*ky*cout <= 128)
)
def test_packconv_plain_matches_pallas(cin, cout, kx, ky):
    g, w2, b = _mk(nx=4, ny=6, cin=cin, cout=cout, kx=kx, ky=ky, seed=5)
    ref = jck.packconv_3d(jnp.asarray(g), jnp.asarray(w2), jnp.asarray(b), jnp.tanh,
                          interpret=True)[..., :cout]
    got = ck.packconv_3d_plain(_t(g), _t(w2), _t(b), "tanh")
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL_F32)
    # y strips (ky - 1 rows recomputed) give the full-height result
    for nys in (1, 2, 3):
        strip = ck.packconv_3d_plain(_t(g), _t(w2), _t(b), "tanh", nys=nys)
        np.testing.assert_allclose(strip.numpy(), got.numpy(), rtol=0, atol=1e-6)
    assert torch.equal(ck.packconv_3d(_t(g), _t(w2), _t(b), "tanh"), got)
    with pytest.raises(ValueError):
        ck.packconv_3d_plain(_t(g), _t(w2), _t(b), "tanh", nys=4)


def test_packconv_strips_match_pallas():
    g, w2, b = _mk(nx=4, ny=6, cin=8, cout=8, seed=6)
    ref = jck.packconv_3d(jnp.asarray(g), jnp.asarray(w2), jnp.asarray(b), None, nys=3,
                          interpret=True)[..., :8]
    got = ck.packconv_3d_plain(_t(g), _t(w2), _t(b), None, nys=3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_tapconv_wgrad_plain_matches_pallas():
    g, w2, _ = _mk(seed=2)
    kx, ky, kc, cout = w2.shape
    nx, ny = g.shape[0] - kx + 1, g.shape[1] - ky + 1
    ct = np.random.default_rng(3).standard_normal((nx, ny, g.shape[2], cout)).astype(np.float32)
    ctp = np.zeros((*ct.shape[:3], jck.lanes(cout)), np.float32)
    ctp[..., :cout] = ct
    ref = np.asarray(jck.tapconv_wgrad_3d(jnp.asarray(g), jnp.asarray(ctp), kx, ky,
                                          interpret=True))[..., :cout]
    got = ck.tapconv_wgrad_3d_plain(_t(g), _t(ct), kx, ky)
    assert got.shape == (kx, ky, kc, cout) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-3)
    assert torch.equal(ck.tapconv_wgrad_3d(_t(g), _t(ct), kx, ky), got)


@pytest.mark.parametrize(
    "actname,has_bias,pack",
    [("tanh", True, False), ("id", False, False), ("tanh", True, True)],
)
def test_conv_layer_vjp_matches_jax(actname, has_bias, pack):
    g, w2, b = _mk(nx=4, ny=5, cin=16, cout=8, seed=4)
    cout = w2.shape[-1]
    jlayer = jck.make_conv_layer(actname, has_bias, interpret=True, pack=pack)

    def f_jax(g, w2, b):
        return jnp.sum(jnp.sin(jlayer(g, w2, b)[..., :cout]))

    v_ref, grads_ref = jax.value_and_grad(f_jax, argnums=(0, 1, 2))(
        jnp.asarray(g), jnp.asarray(w2), jnp.asarray(b))
    layer = ck.make_conv_layer(actname, has_bias, pack=pack)
    leaves = (_t(g, True), _t(w2, True), _t(b, True))
    value = torch.sin(layer(*leaves)).sum()
    grads = torch.autograd.grad(value, leaves)
    assert abs(value.item() - float(v_ref)) < VJP_TOL * max(1.0, abs(float(v_ref)))
    for name, got, ref in zip(("dg", "dw", "db"), grads, grads_ref):
        ref = np.asarray(ref)
        assert got.shape == ref.shape, name
        scale = max(1.0, float(np.max(np.abs(ref))))
        assert float(np.max(np.abs(got.numpy() - ref))) < VJP_TOL * scale, name
    if not has_bias:
        assert not grads[2].any()


@pytest.mark.parametrize("pack", [False, True])
def test_conv_layer_gradcheck(pack):
    rng = np.random.default_rng(7)
    g = _t(rng.standard_normal((5, 4, 3, 4)), True)
    w2 = _t(0.3 * rng.standard_normal((3, 2, 4, 3)), True)
    b = _t(0.1 * rng.standard_normal(3), True)
    layer = ck.make_conv_layer("tanh", True, pack=pack, plain=True)
    assert torch.autograd.gradcheck(layer, (g, w2, b))


def _stack_inputs(seed=11):
    """A two-layer stack: 3 -> 8 (tanh, bias) and 8 -> 3 (identity, no
    bias), radius 1, on one sample (6, 5, 128, 3)."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((6, 5, 128, 3)).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, 3, 3, 8)) / np.sqrt(27 * 3)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(8)).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, 3, 8, 3)) / np.sqrt(27 * 8)).astype(np.float32)
    return h, w1, b1, w2


@pytest.mark.parametrize("dtype,tol", [("float32", ATOL_F32), ("bfloat16", TOL_BF16)])
def test_pallas_conv_layer_stack_matches_jax(dtype, tol):
    h, w1, b1, w2 = _stack_inputs()

    def f_jax(h, w1, b1, w2):
        cdt = jnp.dtype(dtype)
        y = jax_conv_layer(h, w1, b1, 1, True, "tanh", cdt, True)
        y = jax_conv_layer(y, w2, None, 1, True, "id", cdt, True)
        return jnp.sum(y * y), y

    (v_ref, y_ref), grads_ref = jax.value_and_grad(f_jax, argnums=(0, 1, 2, 3), has_aux=True)(
        *map(jnp.asarray, (h, w1, b1, w2)))
    leaves = tuple(_t(a, True) for a in (h, w1, b1, w2))
    cdt = getattr(torch, dtype)
    y = _pallas_conv_layer(leaves[0], leaves[1], leaves[2], 1, True, "tanh", cdt)
    y = _pallas_conv_layer(y, leaves[3], None, 1, True, "id", cdt)
    value = (y * y).sum()
    grads = torch.autograd.grad(value, leaves)
    assert y.dtype == torch.float32 and y.shape == (6, 5, 128, 3)

    def rel(a, b):
        b = np.asarray(b, np.float64)
        return float(np.max(np.abs(np.asarray(a, np.float64) - b)) / np.max(np.abs(b)))

    assert rel(y.detach().numpy(), y_ref) < tol
    for got, ref in zip(grads, grads_ref):
        assert rel(got.numpy(), ref) < tol


def test_tap_stack_matches_fused_layers_f64():
    """On the port alone: the tap layer (z-fold, pads, pack and tap
    forms) against the production fused layers at float64."""
    rng = np.random.default_rng(13)
    h = _t(rng.standard_normal((6, 5, 7, 3)), True)
    w1 = _t(rng.standard_normal((5, 5, 5, 3, 4)) / 20, True)
    b1 = _t(0.1 * rng.standard_normal(4), True)
    w2 = _t(rng.standard_normal((5, 5, 5, 4, 3)) / 20, True)
    f64 = torch.float64

    def tap(pack):
        y = _pallas_conv_layer(h, w1, b1, 2, True, "tanh", f64, pack=pack)
        return _pallas_conv_layer(y, w2, None, 2, True, "id", f64, pack=pack)

    def fused():
        y = ck.make_fused_layer("tanh", True, cin=3, cout=4, k=5)(h, w1, b1)
        return ck.make_fused_layer("id", False, cin=4, cout=3, k=5)(y, w2)

    ref = fused()
    ref_grads = torch.autograd.grad((ref * ref).sum(), (h, w1, b1, w2))
    for pack in (None, False):
        y = tap(pack)
        grads = torch.autograd.grad((y * y).sum(), (h, w1, b1, w2))
        assert (y - ref).abs().max().item() < TOL_F64 * ref.abs().max().item()
        for got, want in zip(grads, ref_grads):
            assert (got - want).abs().max().item() < TOL_F64 * want.abs().max().item()
