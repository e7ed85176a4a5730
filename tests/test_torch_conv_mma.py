"""The tensor-core route of the fused conv layer, held on the CPU.

The bf16 kernels of `csrc/conv.cu` fold the z taps into the contraction:
for tap (dx, dy) and input chunk ch, cell (x, y, z) reads the window
``row[z·cw : z·cw + kp]`` of the wrap-padded, channel-padded input row
(x + dx − r, y + dy − r), which carries ``kp − k·cw`` zeros past its last
cell, and multiplies it by that tap's (kp, np) block of the packed
weights (`pack_conv_weights`); the weight gradient is the same windows
transposed times d, unpacked by `unpack_conv_wgrad`.  These tests rebuild
both products from the wrapper's packing through that window formula and
hold them against the plain versions at float64 (1e-12), for the
closure's layers and their input-gradient forms at k = 3, 5, 7, and
against the JAX fused layer in interpret mode at float32.  The kernels
themselves run only on the card: `chip_smoke.py` holds them against the
plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ins_tpu.ops import convkernels as jck

from ins_tpu_torch.ops import conv_kernels as ck

TOL_F64 = 1e-12
# float32 on both sides, sums in another order: ~1e-7 relative
TOL_F32 = 1e-5

BOXES = ((8, 8, 8), (6, 10, 12))
# the closure's layers (cin, cout, act, bias) and the input-gradient
# forms of its backward pass (the forward on d with flipped taps)
LAYERS = ((3, 24, "tanh", True), (24, 24, "tanh", True), (24, 3, "id", False))
SHAPES = [(cin, cout, act, bias, False) for cin, cout, act, bias in LAYERS] + [
    (cout, cin, "id", False, True) for cin, cout, _, _ in LAYERS
]
# wider and odd layers: two input chunks and two output blocks (40 -> 40),
# chunks of 16 channels and two n8 tiles (16 -> 13, 13 -> 16)
WIDE = [(40, 40, "tanh", True, False), (16, 13, "id", False, False), (13, 16, "id", False, True)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _inputs(box, cin, cout, k, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((*box, cin)).astype(dtype)
    w = (rng.standard_normal((k, k, k, cin, cout)) / np.sqrt(k**3 * cin)).astype(dtype)
    b = (0.1 * rng.standard_normal(cout)).astype(dtype)
    d = rng.standard_normal((*box, cout)).astype(dtype)
    return (torch.from_numpy(a) for a in (h, w, b, d))


def _weights(cin, cout, k, dh, seed):
    """(k, k, k, cin, cout) taps: a layer's, or for an input-gradient form
    the flipped, transposed taps of a cout -> cin layer."""
    if not dh:
        return list(_inputs((1, 1, 1), cin, cout, k, seed))[1]
    return ck.flip_taps(list(_inputs((1, 1, 1), cout, cin, k, seed))[1])


def _windows(h, k, g):
    """Per chunk, the (nx + 2r, ny + 2r, nz, kp) windows the kernels read:
    each row wrap-padded by r, its channels padded to nch·cw, the chunk's
    cells laid out cell-major and followed by kp − k·cw zeros."""
    r = k // 2
    nx, ny, nz, cin = h.shape
    hc = F.pad(h, (0, g.nch * g.cw - cin))
    for dim in range(3):
        n = hc.shape[dim]
        hc = torch.cat([hc.narrow(dim, n - r, r), hc, hc.narrow(dim, 0, r)], dim=dim)
    out = []
    for ch in range(g.nch):
        rows = hc[..., ch * g.cw:(ch + 1) * g.cw].reshape(nx + 2 * r, ny + 2 * r, -1)
        rows = F.pad(rows, (0, g.kp - k * g.cw))
        out.append(rows.unfold(2, g.kp, g.cw))
    return out


def _window_forward(h, wp, k, cout, bias, act):
    """The forward as the tensor-core kernel sums it, from packed weights."""
    nx, ny, nz, cin = h.shape
    g = ck.mma_geometry(cin, cout, k)
    wpr = wp.reshape(k, k, g.nch, g.kp, g.np)
    y = h.new_zeros((nx, ny, nz, g.np))
    for ch, win in enumerate(_windows(h, k, g)):
        for dx in range(k):
            for dy in range(k):
                y += win[dx:dx + nx, dy:dy + ny] @ wpr[dx, dy, ch]
    y = y[..., :cout]
    if bias is not None:
        y = y + bias
    return torch.tanh(y) if act == "tanh" else y


def _window_wgrad(h, d, k):
    """The packed weight gradient as the tensor-core kernel sums it:
    windows transposed times d (channels padded to np)."""
    nx, ny, nz, cin = h.shape
    cout = d.shape[-1]
    g = ck.mma_geometry(cin, cout, k)
    dp = F.pad(d, (0, g.np - cout)).reshape(-1, g.np)
    dwp = h.new_zeros((k, k, g.nch, g.kp, g.np))
    for ch, win in enumerate(_windows(h, k, g)):
        for dx in range(k):
            for dy in range(k):
                a = win[dx:dx + nx, dy:dy + ny].reshape(-1, g.kp)
                dwp[dx, dy, ch] = a.T @ dp
    return dwp.reshape(k, k, g.nch * g.kp, g.np)


def test_geometry_of_the_closure_layers():
    assert ck.mma_geometry(24, 24, 5) == (24, 1, 128, 3, 24)
    assert ck.mma_geometry(3, 24, 5) == (8, 1, 48, 3, 24)
    assert ck.mma_geometry(24, 3, 5) == (24, 1, 128, 1, 8)
    assert ck.mma_geometry(24, 24, 7) == (24, 1, 176, 3, 24)
    # wider layers: chunks of at most 24 channels, blocks of at most 3 n8 tiles
    assert ck.mma_geometry(64, 64, 3) == (24, 3, 80, 3, 72)
    assert ck.mma_geometry(32, 32, 5) == (16, 2, 80, 2, 32)


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("cin,cout,act,has_bias,dh", SHAPES + WIDE)
def test_packing_pads_with_zeros(cin, cout, act, has_bias, dh, k):
    w = _weights(cin, cout, k, dh, seed=k)
    g = ck.mma_geometry(cin, cout, k)
    wp = ck.pack_conv_weights(w)
    assert wp.shape == (k, k, g.nch * g.kp, g.np) and wp.dtype == w.dtype
    blocks = wp.reshape(k, k, g.nch, g.kp, g.np)
    assert not blocks[..., cout:].any()
    assert not blocks[:, :, :, k * g.cw:, :].any()
    rows = blocks[:, :, :, :k * g.cw, :].reshape(k, k, g.nch, k, g.cw, g.np)
    chan = torch.arange(g.nch)[:, None] * g.cw + torch.arange(g.cw)[None, :]
    assert not rows.permute(0, 1, 3, 2, 4, 5)[:, :, :, chan >= cin].any()
    # every canonical weight lands once
    assert torch.equal(ck.unpack_conv_wgrad(wp, k, cin, cout), w)


@pytest.mark.parametrize("box", BOXES)
@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("cin,cout,act,has_bias,dh", SHAPES)
def test_window_forward_matches_plain(cin, cout, act, has_bias, dh, k, box):
    h, _, b, _ = _inputs(box, cin, cout, k, seed=10 * k + cin)
    w = _weights(cin, cout, k, dh, seed=k)
    b = b if has_bias else None
    got = _window_forward(h, ck.pack_conv_weights(w), k, cout, b, act)
    ref = ck.fusedconv_3d_plain(h, w, b, act)
    assert got.shape == ref.shape == (*box, cout)
    assert _rel(got, ref) < TOL_F64


@pytest.mark.parametrize("cin,cout,act,has_bias,dh", WIDE)
def test_window_forward_matches_plain_wide(cin, cout, act, has_bias, dh):
    k, box = 3, BOXES[1]
    h, _, b, _ = _inputs(box, cin, cout, k, seed=cin + cout)
    w = _weights(cin, cout, k, dh, seed=cout)
    b = b if has_bias else None
    got = _window_forward(h, ck.pack_conv_weights(w), k, cout, b, act)
    assert _rel(got, ck.fusedconv_3d_plain(h, w, b, act)) < TOL_F64


@pytest.mark.parametrize("box", BOXES)
@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("cin,cout", [(3, 24), (24, 24), (24, 3), (40, 40), (13, 16)])
def test_window_wgrad_matches_plain(cin, cout, k, box):
    h, _, _, d = _inputs(box, cin, cout, k, seed=100 + 10 * k + cin)
    dwp = _window_wgrad(h, d, k)
    got = ck.unpack_conv_wgrad(dwp, k, cin, cout)
    ref = ck.fusedconv_wgrad_3d_plain(h, d, k)
    assert got.shape == ref.shape == (k, k, k, cin, cout)
    assert _rel(got, ref) < TOL_F64


@pytest.mark.parametrize("cin,cout,act,has_bias", [(3, 24, "tanh", True)])
def test_window_products_match_jax_fused_layer(cin, cout, act, has_bias):
    """The same float32 inputs (numpy seed) through the window formula on
    the packed weights and through the JAX fused layer (Pallas interpret):
    its value and the weight gradient of a sum, to 1e-5 relative."""
    k, box = 3, (4, 8, 16)
    h, w, b, ct = _inputs(box, cin, cout, k, seed=7 + cin, dtype=np.float32)
    b = b if has_bias else None
    jlayer = jck.make_fused_layer(act, has_bias, cin=cin, cout=cout, k=k, interpret=True)
    hl = jnp.pad(jnp.asarray(h.numpy()), ((0, 0),) * 3 + ((0, 128 - cin),))

    def f_jax(w_):
        y = jlayer(hl, w_, None if b is None else jnp.asarray(b.numpy()))[..., :cout]
        return jnp.sum(y * jnp.asarray(ct.numpy())), y

    (_, yj), gw = jax.jit(jax.value_and_grad(f_jax, has_aux=True))(jnp.asarray(w.numpy()))
    y = _window_forward(h, ck.pack_conv_weights(w), k, cout, b, act)
    assert _rel(y.numpy(), yj) < TOL_F32
    dpre = ct * (1.0 - y * y) if act == "tanh" else ct
    dw = ck.unpack_conv_wgrad(_window_wgrad(h, dpre, k), k, cin, cout)
    assert _rel(dw.numpy(), gw) < TOL_F32
