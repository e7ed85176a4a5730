"""The tensor-core route of the tap layer, held on the CPU.

For bf16 operands `tapconv_3d` runs the output-first tap kernel of
`csrc/tapconv_mma.cu`: for tap (dx, dy) the A rows of output row (x, y)
are the contiguous (cells, kp) block of the channel-padded g at
(x + dx, y + dy), times that tap's (kp, np) block of `pack_tap_weights`,
in blocks of 8·nt output channels (`tap_mma_geometry`).  `packconv_3d`
runs the weight-first pack kernel where `pack_mma_takes` (every tap packs
into one tile): per 16-row strip of an input plane the products with
`pack_all_taps`, then the shifted column-group sums into the output
planes; elsewhere the tap kernel.  These tests rebuild both from the
wrapper's packing through those formulas and hold them against the plain
versions at float64 (1e-12), for the closure stack's three layers and
their input-gradient shapes at ky = 3, 5, 7 on boxes with odd nz and nyp,
and one layer of each form against the JAX kernels in interpret mode at
float32.  The kernels themselves run only on the card: `chip_smoke.py`
holds them against the plain versions there.  Also here: the fused
layer's weight gradient rounds a float32 cotangent to h's dtype, as the
JAX kernel does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ins_tpu.ops import convkernels as jck

from ins_tpu_torch.models.cnn import _fold_w, _FoldPadFn, _zfold
from ins_tpu_torch.ops import conv_kernels as ck

TOL_F64 = 1e-12
# float32 on both sides, sums in another order: ~1e-7 relative
TOL_F32 = 1e-5

# (kc, cout, act, bias) of the stack's forwards (3 -> 24 folds 15
# channels, padded to 16; 24 -> 24 and 24 -> 3 fold 120) and of their
# input gradients (kc: the cotangent's channels, 3 padded to 8; cout: the
# layer's kc), which run the tap form only
FORWARDS = [(15, 24, "tanh", True), (120, 24, "tanh", True), (120, 3, "id", False)]
GRADIENTS = [(24, 16, "id", False), (24, 120, "id", False), (3, 120, "id", False)]
# (nx, ny, nz) output boxes: odd nz, odd nyp (ny + ky - 1 with ky odd)
BOXES = ((3, 5, 9), (2, 7, 5))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _operands(box, kc, cout, k, seed, dtype=torch.float64):
    """g (nx + k − 1, ny + k − 1, nz, kc), w2 (k, k, kc, cout), bias."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = box
    g = rng.standard_normal((nx + k - 1, ny + k - 1, nz, kc))
    w2 = rng.standard_normal((k, k, kc, cout)) / np.sqrt(k * k * kc)
    b = 0.1 * rng.standard_normal(cout)
    return (torch.from_numpy(a).to(dtype) for a in (g, w2, b))


def _staged(g, w2):
    """g and w2 as the wrapper hands them to the card: g's channels padded
    to a multiple of 8 (`stage_channels` for bfloat16), w2's zero rows."""
    c = ck.stage_channels(g.shape[-1], torch.bfloat16)
    return F.pad(g, (0, c - g.shape[-1])), F.pad(w2, (0, 0, 0, c - w2.shape[2]))


def _epilogue(y, bias, act):
    if bias is not None:
        y = y + bias
    return torch.tanh(y) if act == "tanh" else y


def _tap_formula(g, w2, bias, act):
    """The tap kernel's sum: per block of 8·nt output channels, for each
    (dx, dy) the (cells, kp) block of g at (x + dx, y + dy), its channels
    zero-padded to kp, times that tap's (kp, np) block."""
    gs, ws = _staged(g, w2)
    kx, ky, kc, cout = ws.shape
    geo = ck.tap_mma_geometry(kc, cout)
    wp = ck.pack_tap_weights(ws)
    ga = F.pad(gs, (0, geo.kp - kc))
    nx, ny = ga.shape[0] - kx + 1, ga.shape[1] - ky + 1
    y = ga.new_zeros((nx, ny, ga.shape[2], geo.np))
    for n0 in range(0, geo.np, 8 * geo.nt):
        cols = slice(n0, n0 + 8 * geo.nt)
        for dx in range(kx):
            for dy in range(ky):
                y[..., cols] += ga[dx:dx + nx, dy:dy + ny] @ wp[dx, dy, :, cols]
    return _epilogue(y[..., :cout], bias, act)


def _pack_formula(g, w2, bias, act):
    """The pack kernel's sum: per strip of 16 input rows (17 − ky output
    rows; rows past the field are zero), each input plane's products with
    every tap (`pack_all_taps`), then the column group (dx, dy) of input
    row y + dy added into output plane x = plane − dx, in the order (dx,
    dy)."""
    gs, ws = _staged(g, w2)
    kx, ky, kc, cout = ws.shape
    assert ck.pack_mma_takes(kx, ky, kc, cout)
    wall = ck.pack_all_taps(ws)
    ga = F.pad(gs, (0, wall.shape[0] - kc))
    nx, ny, nz = ga.shape[0] - kx + 1, ga.shape[1] - ky + 1, ga.shape[2]
    ty = 16 - ky + 1
    out = ga.new_zeros((nx, ny, nz, cout))
    for y0 in range(0, ny, ty):
        rows = F.pad(ga[:, y0:y0 + 16], (0, 0, 0, 0, 0, 16 - ga[:, y0:y0 + 16].shape[1]))
        P = rows @ wall  # (planes, 16, nz, np)
        acc = ga.new_zeros((nx, ty, nz, cout))
        for x in range(nx):
            for dx in range(kx):
                for dy in range(ky):
                    t = (dx * ky + dy) * cout
                    acc[x] += P[x + dx, dy:dy + ty, :, t:t + cout]
        out[:, y0:y0 + ty] = acc[:, :ny - y0]
    return _epilogue(out, bias, act)


def test_geometry_of_the_stack():
    assert ck.tap_mma_geometry(120, 24) == (128, 3, 24)
    assert ck.tap_mma_geometry(16, 24) == (16, 3, 24)
    assert ck.tap_mma_geometry(120, 3) == (128, 1, 8)
    assert ck.tap_mma_geometry(24, 120) == (32, 5, 120)  # the input gradient
    assert ck.tap_mma_geometry(8, 120) == (16, 5, 120)
    assert ck.tap_mma_geometry(24, 16) == (32, 2, 16)
    assert ck.tap_mma_geometry(120, 13) == (128, 2, 16)
    assert ck.tap_mma_geometry(8, 48) == (16, 3, 48)  # two blocks of three n8 tiles
    assert [ck.stage_channels(c, torch.bfloat16) for c in (3, 15, 16, 120)] == [8, 16, 16, 120]
    assert ck.stage_channels(15, torch.float32) == 15
    # the pack kernel takes the 24 -> 3 layer (75 packed columns), not the
    # 24-channel outputs (600), nor a contraction past one 8-step chain
    assert ck.pack_mma_takes(5, 5, 120, 3)
    assert not ck.pack_mma_takes(5, 5, 120, 24) and not ck.pack_mma_takes(5, 5, 16, 24)
    assert not ck.pack_mma_takes(5, 5, 136, 3) and not ck.pack_mma_takes(7, 7, 120, 3)
    # nor one whose float32 products of a strip overflow shared memory
    assert ck.pack_mma_takes(3, 3, 128, 8) and not ck.pack_mma_takes(3, 3, 120, 13)


@pytest.mark.parametrize("ky", [3, 5, 7])
@pytest.mark.parametrize("kc,cout,act,has_bias", FORWARDS + GRADIENTS)
def test_packing_pads_with_zeros(kc, cout, act, has_bias, ky):
    _, w2, _ = _operands((1, 1, 1), kc, cout, ky, seed=ky)
    geo = ck.tap_mma_geometry(kc, cout)
    wp = ck.pack_tap_weights(w2)
    assert wp.shape == (ky, ky, geo.kp, geo.np)
    assert not wp[:, :, kc:].any() and not wp[..., cout:].any()
    assert torch.equal(wp[:, :, :kc, :cout], w2)
    wall = ck.pack_all_taps(w2)
    n = ky * ky * cout
    assert wall.shape == (geo.kp, -(-n // 8) * 8)
    assert not wall[kc:].any() and not wall[:, n:].any()
    for dx, dy in ((0, 0), (ky - 1, 1), (1, ky - 1)):
        t = (dx * ky + dy) * cout
        assert torch.equal(wall[:kc, t:t + cout], w2[dx, dy])


@pytest.mark.parametrize("box", BOXES)
@pytest.mark.parametrize("ky", [3, 5, 7])
@pytest.mark.parametrize("kc,cout,act,has_bias", FORWARDS + GRADIENTS)
def test_tap_formula_matches_plain(kc, cout, act, has_bias, ky, box):
    g, w2, b = _operands(box, kc, cout, ky, seed=10 * ky + kc)
    b = b if has_bias else None
    got = _tap_formula(g, w2, b, act)
    ref = ck.tapconv_3d_plain(g, w2, b, act)
    assert got.shape == ref.shape == (*box, cout)
    assert _rel(got, ref) < TOL_F64


@pytest.mark.parametrize("box", BOXES + ((2, 19, 5),))  # two y strips
@pytest.mark.parametrize("ky", [3, 5, 7])
@pytest.mark.parametrize("kc,cout,act,has_bias", FORWARDS + [(120, 8, "tanh", True)])
def test_pack_route_matches_plain(kc, cout, act, has_bias, ky, box):
    """`packconv_3d`'s route: the pack kernel's sums where it takes the
    layer, the tap kernel's elsewhere."""
    g, w2, b = _operands(box, kc, cout, ky, seed=20 * ky + kc)
    b = b if has_bias else None
    takes = ck.pack_mma_takes(ky, ky, ck.stage_channels(kc, torch.bfloat16), cout)
    got = (_pack_formula if takes else _tap_formula)(g, w2, b, act)
    ref = ck.packconv_3d_plain(g, w2, b, act)
    assert got.shape == ref.shape == (*box, cout)
    assert _rel(got, ref) < TOL_F64


def test_stack_layers_reach_both_kernels():
    """At radius 2 the stack's 24 -> 3 forward packs every tap; 3 -> 24 and
    24 -> 24 run the tap kernel."""
    routes = [ck.pack_mma_takes(5, 5, ck.stage_channels(5 * cin, torch.bfloat16), cout)
              for cin, cout in ((3, 24), (24, 24), (24, 3))]
    assert routes == [False, False, True]


def test_zfold_pads_bf16_channels():
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.standard_normal((4, 5, 6, 3)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((5, 5, 5, 3, 4)).astype(np.float32))
    gb, wb = _zfold(h.to(torch.bfloat16), 2), _fold_w(w, torch.bfloat16)
    assert gb.shape == (4, 5, 6, 16) and wb.shape == (5, 5, 16, 4)
    assert not gb[..., 15:].any() and not wb[:, :, 15:].any()
    g32, w32 = _zfold(h, 2), _fold_w(w, torch.float32)
    assert g32.shape == (4, 5, 6, 15) and w32.shape == (5, 5, 15, 4)
    assert torch.equal(gb[..., :15], g32.to(torch.bfloat16))


@pytest.mark.parametrize("r,pad_x", [(1, True), (2, True), (2, False)])
def test_fold_pad_backward(r, pad_x):
    """The tap glue's z-fold and wrap pads (`_FoldPadFn`): its forward is
    the copies', its backward their adjoint (gradcheck at float64), and in
    bf16 it rounds once: within one bf16 rounding of the float64
    gradient."""
    rng = np.random.default_rng(r)
    h = torch.from_numpy(rng.standard_normal((5, 4, 6, 3))).requires_grad_(True)
    g = _FoldPadFn.apply(h, r, pad_x, torch.float64)
    want = _zfold(h.detach(), r)
    pads = ((r, 0),) if pad_x else ()
    for n, dim in pads + ((r, 1),):
        want = torch.cat([want.narrow(dim, want.shape[dim] - n, n), want, want.narrow(dim, 0, n)],
                         dim=dim)
    assert torch.equal(g, want)
    assert torch.autograd.gradcheck(lambda t: _FoldPadFn.apply(t, r, pad_x, torch.float64), (h,))
    gb = _FoldPadFn.apply(h, r, pad_x, torch.bfloat16)  # channels padded to 16
    ct = torch.from_numpy(rng.standard_normal(gb.shape))
    c = g.shape[-1]
    (ref,) = torch.autograd.grad(g, h, ct[..., :c])
    (got,) = torch.autograd.grad(gb, h, ct.to(torch.bfloat16))
    assert got.dtype == torch.float64
    # the same sums on the rounded cotangent
    (exact,) = torch.autograd.grad(g, h, ct[..., :c].to(torch.bfloat16).double())
    assert torch.allclose(got, exact, rtol=1e-6, atol=1e-6)
    assert _rel(got, ref) < 2.0**-8


@pytest.mark.parametrize("form", ["tap", "pack"])
def test_formulas_match_jax_kernels(form):
    """The same float32 inputs (numpy seed), the JAX glue's 128-lane g and
    w2, through the rebuilt kernel sums and through the JAX kernels in
    interpret mode (`tapconv_3d`; `packconv_3d` with every tap in one
    tile), to 1e-5 relative."""
    kx = ky = 3
    cin, cout = (24, 24) if form == "tap" else (16, 8)
    rng = np.random.default_rng(5)
    g = np.zeros((4 + kx - 1, 5 + ky - 1, 128, 128), np.float32)
    g[..., :cin] = rng.standard_normal((*g.shape[:3], cin))
    w2 = np.zeros((kx, ky, 128, cout), np.float32)
    w2[:, :, :cin] = 0.3 * rng.standard_normal((kx, ky, cin, cout))
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    jkernel = jck.tapconv_3d if form == "tap" else jck.packconv_3d
    ref = np.asarray(jkernel(jnp.asarray(g), jnp.asarray(w2), jnp.asarray(b), jnp.tanh,
                             interpret=True))[..., :cout]
    tg, tw, tb = (torch.from_numpy(a) for a in (g, w2, b))
    if form == "pack":
        assert ck.pack_mma_takes(kx, ky, 128, cout)
    got = (_tap_formula if form == "tap" else _pack_formula)(tg, tw, tb, "tanh")
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got.numpy(), ref) < TOL_F32


def test_fused_wgrad_rounds_the_cotangent_to_h():
    """bf16 h with a float32 cotangent: the JAX wrapper rounds the
    cotangent to h's dtype before its kernel sums (`ct.astype(h.dtype)`);
    so does the port, to float32 sums in another order (1e-5 relative).
    The JAX kernel is handed the rounded cotangent itself: in interpret
    mode it cannot take a float32 one with a bf16 h (its cotangent ring is
    declared in the dtype before the cast).  Without the rounding the port
    would differ by far more."""
    cin, cout, k = 3, 4, 3
    box = (6, 8, 16)
    rng = np.random.default_rng(17)
    h = torch.from_numpy(rng.standard_normal((*box, cin)).astype(np.float32)).to(torch.bfloat16)
    d = torch.from_numpy(rng.standard_normal((*box, cout)).astype(np.float32))

    def lanes(t):  # bf16, padded to the JAX kernels' 128 lanes
        a = jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.pad(a, ((0, 0),) * 3 + ((0, 128 - t.shape[-1]),))

    dws = jck.fusedconv_wgrad_3d(lanes(h), lanes(d), cin=cin, cout=cout, k=k, interpret=True)
    ref = np.asarray(jck.unpack_dws(dws, k, k, k, cin, cout), np.float64)
    got = ck.fusedconv_wgrad_3d(h, d, k)  # the CPU wrapper: the plain version
    assert got.dtype == torch.float32 and got.shape == (k, k, k, cin, cout)
    assert _rel(got.numpy(), ref) < TOL_F32
    unrounded = ck.fusedconv_wgrad_3d_plain(h.float(), d, k)
    assert _rel(unrounded.numpy(), ref) > 10 * TOL_F32
