"""The tap layer's bf16 weight gradient and float32 tap forward, held on the CPU.

For bf16 operands `tapconv_wgrad_3d` runs the tensor-core kernel of
`csrc/tapwgrad_mma.cu`: g's and the cotangent's channels padded to
multiples of 8, then to ``kp`` rows (m16 tiles) and ``np`` columns (n8
tiles), and per cell chunk of `tap_wgrad_plan` (8 y x 16 z cells over a
run of ``xb`` x-planes) the sum over its cells of g[x+dx, y+dy]ᵀ·ct[x, y]
for every (dx, dy), the chunks' partial sums added in a fixed order.
These tests rebuild that sum from the plan and hold it against the plain
version at float64 (1e-12), for the closure stack's three layers at
ky = 3, 5, 7 on boxes with odd nz and nyp, and one case against the JAX
kernel in interpret mode at float32.

For float32 operands `tapconv_3d` runs the 3xTF32 tensor-core kernel of
`csrc/tapconv_tf32.cu`: each operand split into TF32 parts, big =
rna(x) and small = rna(x − big), and each product formed as
small·big + big·small + big·big.  The tests emulate that split (the
card's round-to-nearest, ties away, 10-bit mantissa) on the forward and
input-gradient shapes: the three products stay within 1e-6 of float64,
while a single TF32 pass is outside 1e-4; and they check the host's
packing of the split B fragments into `mma.m16n8k8` lane order.

The routing: on the card g's dtype picks each kernel with no fallback
(bf16: the bf16 tensor-core kernels; float32: the ``+f32`` ones).  A
fake kernel library and meta tensors stand in for the card here, so the
wrappers' dispatch runs on the CPU and its calls can be seen.  The
kernels themselves run only on the card: `chip_smoke.py` holds them
against the plain versions there.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ins_tpu.ops import convkernels as jck

from ins_tpu_torch.ops import conv_kernels as ck
from ins_tpu_torch.ops import launches

TOL_F64 = 1e-12
# (kc, cout) of the stack's three layers: 3 -> 24 folds 15 channels
# (padded to 16 for bf16), 24 -> 24 and 24 -> 3 fold 120
LAYERS = [(15, 24), (120, 24), (120, 3)]
# (nx, ny, nz) cotangent boxes: odd nz, odd nyp (ny + ky - 1 with ky odd)
BOXES = ((3, 5, 9), (2, 7, 5))
# 3xTF32 against float64: about 2^-21 a product; one TF32 pass: 2^-11
TOL_3XTF32 = 1e-6
TF32_ONE_PASS_OFF = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _wgrad_operands(box, kc, cout, kx, ky, seed, dtype=torch.float64):
    """g (nx + kx − 1, ny + ky − 1, nz, kc) and ct (nx, ny, nz, cout)."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = box
    g = rng.standard_normal((nx + kx - 1, ny + ky - 1, nz, kc))
    ct = rng.standard_normal((nx, ny, nz, cout))
    return torch.from_numpy(g).to(dtype), torch.from_numpy(ct).to(dtype)


def _wgrad_formula(g, ct, kx, ky):
    """The bf16 kernel's sum: the channels padded to multiples of 8 (the
    wrapper's `_stageable`) and then to the plan's kp rows and np columns;
    per cell chunk, in the kernel's order (z tiles fastest, then y, then
    x runs), the chunk's partial Σ_cells g[x+dx, y+dy]ᵀ·ct[x, y] for every
    (dx, dy), cells past the box zero; the partials added in that order."""
    box = tuple(ct.shape[:3])
    kc, cout = g.shape[-1], ct.shape[-1]
    gs = F.pad(g, (0, ck.stage_channels(kc, torch.bfloat16) - kc))
    cs = F.pad(ct, (0, ck.stage_channels(cout, torch.bfloat16) - cout))
    plan = ck.tap_wgrad_plan(box, gs.shape[-1], cs.shape[-1], kx, ky)
    ga = F.pad(gs, (0, plan.kp - gs.shape[-1]))
    ca = F.pad(cs, (0, plan.np - cs.shape[-1]))
    nx, ny, nz = box
    ty, tz = 8, 16
    dw = g.new_zeros((kx, ky, plan.kp, plan.np))
    chunks = 0
    for x0 in range(0, nx, plan.xb):
        x1 = min(nx, x0 + plan.xb)
        for y0 in range(0, ny, ty):
            y1 = min(ny, y0 + ty)
            for z0 in range(0, nz, tz):
                z1 = min(nz, z0 + tz)
                part = torch.stack([torch.stack([
                    torch.einsum("xyzc,xyzo->co", ga[x0 + dx:x1 + dx, y0 + dy:y1 + dy, z0:z1],
                                 ca[x0:x1, y0:y1, z0:z1]) for dy in range(ky)])
                    for dx in range(kx)])
                dw += part
                chunks += 1
    assert chunks == plan.nchunk
    return dw[:, :, :kc, :cout]


@pytest.mark.parametrize("box", BOXES)
@pytest.mark.parametrize("ky", [3, 5, 7])
@pytest.mark.parametrize("kc,cout", LAYERS)
def test_wgrad_formula_matches_plain(kc, cout, ky, box):
    g, ct = _wgrad_operands(box, kc, cout, ky, ky, seed=kc + cout + ky)
    got = _wgrad_formula(g, ct, ky, ky)
    ref = ck.tapconv_wgrad_3d_plain(g, ct, ky, ky)
    assert got.shape == ref.shape == (ky, ky, kc, cout)
    assert _rel(got, ref) < TOL_F64


def test_wgrad_plan_of_the_stack():
    box = (128, 128, 128)
    # 24 -> 24: 8 m16 tiles in chunks of 2 (2 x 25 items, a block's
    # warps hold 50), 24 columns in one block of three n8 tiles; 3 -> 24
    # (kc 15 -> 16) one tile; 24 -> 3 one n8 tile
    assert ck.tap_wgrad_plan(box, 120, 24, 5, 5) == (128, 3, 24, 2, 2, 64, 256)
    assert ck.tap_wgrad_plan(box, 16, 24, 5, 5)[:5] == (16, 3, 24, 1, 3)
    assert ck.tap_wgrad_plan(box, 120, 8, 5, 5)[:5] == (128, 1, 8, 2, 3)
    # the kernel's limits: items, channel tiles, shared memory, chunk count
    for kx, ky in ((1, 1), (3, 3), (5, 5), (7, 7), (3, 5)):
        for kc, cd in ((16, 24), (120, 24), (120, 8), (24, 120), (288, 16)):
            p = ck.tap_wgrad_plan((37, 21, 67), kc, cd, kx, ky)
            assert kx * ky * p.mc <= ck._WGRAD_ITEMS and 1 <= p.mc <= min(8, p.kp // 16)
            assert p.nbuf in (2, 3) and ck._wgrad_mma_smem(kx, ky, p.mc, p.nt, p.nbuf) <= 232448
            assert p.np % (8 * p.nt) == 0 and p.np - 8 * p.nt < cd <= p.np and p.nt <= 3
            assert p.nchunk == -(-37 // p.xb) * -(-21 // 8) * -(-67 // 16)
    with pytest.raises(NotImplementedError):
        ck.tap_wgrad_plan(box, 120, 24, 9, 7)


def test_tf32_geometry():
    # k8 steps over kc padded to 8; output blocks of at most three n8 tiles
    assert ck.tap_tf32_geometry(120, 24) == (120, 3, 24)
    assert ck.tap_tf32_geometry(24, 120) == (24, 3, 120)  # the input gradient: five blocks
    assert ck.tap_tf32_geometry(16, 15) == (16, 2, 16)
    assert ck.tap_tf32_geometry(4, 120) == (8, 3, 120)
    assert ck.tap_tf32_geometry(120, 3) == (120, 1, 8)


def test_wgrad_matches_pallas():
    """One layer against the JAX kernel in interpret mode at float32, g and
    ct lane-padded as the JAX glue pads them (nz = 128, the JAX kernels'
    lane rule)."""
    rng = np.random.default_rng(3)
    kx = ky = 3
    nx, ny, nz, cin, cout = 3, 4, 128, 24, 24
    g = np.zeros((nx + kx - 1, ny + ky - 1, nz, jck.lanes(cin)), np.float32)
    g[..., :cin] = rng.standard_normal((*g.shape[:3], cin))
    ct = rng.standard_normal((nx, ny, nz, cout)).astype(np.float32)
    ctp = np.zeros((nx, ny, nz, jck.lanes(cout)), np.float32)
    ctp[..., :cout] = ct
    ref = np.asarray(jck.tapconv_wgrad_3d(jnp.asarray(g), jnp.asarray(ctp), kx, ky,
                                          interpret=True))[..., :cout]
    gt, ctt = torch.from_numpy(g), torch.from_numpy(ct)
    got = _wgrad_formula(gt.double(), ctt.double(), kx, ky)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-3)
    assert torch.equal(ck.tapconv_wgrad_3d(gt, ctt, kx, ky),
                       ck.tapconv_wgrad_3d_plain(gt, ctt, kx, ky))


# --------------------------------------------------------------------------
# 3xTF32
# --------------------------------------------------------------------------


def test_tf32_round_is_the_cards_cvt_rna():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-11),
                      1.0 + 2**-11 - 2**-23, 3.0e-39, -7.25, 65504.0 + 16.0], dtype=torch.float32)
    r = ck.tf32_round(x)
    # ties go away from zero; below a tie rounds down; exact values stay
    want = [1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0 + 4 * 2**-11, -(1.0 + 2**-10), 1.0, None,
            -7.25, 65504.0 + 32.0]
    for got, w, xi in zip(r.tolist(), want, x.tolist()):
        if w is not None:
            assert got == w, (xi, got, w)
    bits = r.view(torch.int32)
    assert not (bits & 0x1FFF).any()  # a 10-bit mantissa
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    big = ck.tf32_round(v)
    small = ck.tf32_round(v - big)
    assert float(((big - v).abs() / v.abs()).max()) <= 2.0**-11
    assert float(((big.double() + small.double() - v.double()).abs() / v.abs().double()).max()) \
        <= 2.0**-22


def _unpack_tf32(wp, kp, np_):
    """The packed (kx, ky, kp/8, np/8, 32, 4) fragments back to (big,
    small) weights (kx, ky, kp, np): lane 4·g + t, value j of each half is
    row 8·step + 4·j + t, column 8·tile + g."""
    kx, ky = wp.shape[:2]
    halves = []
    for h in (wp[..., :2], wp[..., 2:]):
        h = h.reshape(kx, ky, kp // 8, np_ // 8, 8, 4, 2).permute(0, 1, 2, 6, 5, 3, 4)
        halves.append(h.reshape(kx, ky, kp, np_))
    return halves


@pytest.mark.parametrize("kc,cout", [(120, 24), (24, 120), (16, 24), (4, 13)])
def test_tf32_packing_is_fragment_order(kc, cout):
    w2 = torch.from_numpy(np.random.default_rng(kc).standard_normal((5, 5, kc, cout))
                          .astype(np.float32))
    geo = ck.tap_tf32_geometry(kc, cout)
    wp = ck.pack_tap_weights_tf32(w2)
    assert wp.shape == (5, 5, geo.kp // 8, geo.np // 8, 32, 4) and wp.dtype == torch.float32
    # lane l holds B[k = l % 4 (+ 4)][n = l // 4] of its (k8 step, n8 tile)
    wpad = F.pad(w2, (0, geo.np - cout, 0, geo.kp - kc))
    lane = torch.arange(32)
    for s, t in ((0, 0), (geo.kp // 8 - 1, geo.np // 8 - 1)):
        for j in (0, 1):
            w = wpad[2, 3, 8 * s + lane % 4 + 4 * j, 8 * t + lane // 4]
            assert torch.equal(wp[2, 3, s, t, :, j], ck.tf32_round(w))
            assert torch.equal(wp[2, 3, s, t, :, 2 + j], ck.tf32_round(w - ck.tf32_round(w)))
    big, small = _unpack_tf32(wp, geo.kp, geo.np)
    assert torch.equal(big, ck.tf32_round(wpad))
    assert not big[:, :, kc:].any() and not big[..., cout:].any() and not small[..., cout:].any()
    assert _rel(big.double() + small.double(), wpad.double()) <= 2.0**-22


def _tf32_products(g, w2, passes):
    """The TF32 tap kernel's sum in float64: g's channels padded to kp,
    the split A (big, small) of each cell's channels times the packed
    split B of each tap; ``passes`` 3: small·big + big·small + big·big,
    1: big·big (one TF32 pass).  TF32 products are exact in float32, so
    float64 sums isolate the split's error."""
    kx, ky, kc, cout = w2.shape
    geo = ck.tap_tf32_geometry(kc, cout)
    ga = F.pad(g, (0, geo.kp - kc))
    ab = ck.tf32_round(ga)
    asm = ck.tf32_round(ga - ab)
    bb, bs = _unpack_tf32(ck.pack_tap_weights_tf32(w2), geo.kp, geo.np)
    ab, asm, bb, bs = (t.double() for t in (ab, asm, bb, bs))
    nx, ny = g.shape[0] - kx + 1, g.shape[1] - ky + 1
    out = torch.zeros((nx, ny, g.shape[2], geo.np), dtype=torch.float64)
    for dx in range(kx):
        for dy in range(ky):
            a_big, a_small = ab[dx:dx + nx, dy:dy + ny], asm[dx:dx + nx, dy:dy + ny]
            out += a_big @ bb[dx, dy]
            if passes == 3:
                out += a_small @ bb[dx, dy] + a_big @ bs[dx, dy]
    return out[..., :cout]


@pytest.mark.parametrize("kc,cout,label", [(120, 24, "24->24"), (24, 120, "dG 24->120")])
def test_3xtf32_is_float32_class(kc, cout, label):
    """The forward's and the input gradient's shapes at ky = 5: the three
    split products within 1e-6 (relative to max|out|) of float64; one
    TF32 pass outside 1e-4."""
    rng = np.random.default_rng(kc * cout)
    nx, ny, nz = 3, 4, 9
    g = torch.from_numpy(rng.standard_normal((nx + 4, ny + 4, nz, kc)).astype(np.float32))
    w2 = torch.from_numpy((rng.standard_normal((5, 5, kc, cout)) / np.sqrt(25 * kc))
                          .astype(np.float32))
    ref = ck.tapconv_3d_plain(g.double(), w2.double())
    three = _rel(_tf32_products(g, w2, 3), ref)
    one = _rel(_tf32_products(g, w2, 1), ref)
    assert three < TOL_3XTF32, (label, three)
    assert one > TF32_ONE_PASS_OFF, (label, one)


# --------------------------------------------------------------------------
# Routing: g's dtype picks the kernel, no fallback
# --------------------------------------------------------------------------


class _FakeLib:
    """Stands in for the kernel library: records each entry point called
    with its arguments and returns success (one cell chunk for a chunk
    count)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("ins_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 1 if name.endswith("_chunks") else 0

        return entry

    def names(self):
        return [n for n, _ in self.calls]


@pytest.fixture
def fake_card(monkeypatch):
    """Meta tensors take the wrappers' card branch; the library, the
    device checks and the stream are stood in for."""
    lib = _FakeLib()

    def check(name, dtypes, **operands):
        for t, shape, *own in operands.values():
            if t is not None:
                assert t.dtype in (own[0] if own else dtypes) and tuple(t.shape) == tuple(shape)
        return next(iter(operands.values()))[0].device

    monkeypatch.setattr(ck._build, "load", lambda: lib)
    monkeypatch.setattr(ck, "check_cuda_tensors", check)
    monkeypatch.setattr(ck, "current_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    launches.reset_counts()
    yield lib
    launches.reset_counts()


def _meta(*shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgrad_route_by_dtype(fake_card, dtype):
    kx = ky = 5
    g, ct = _meta(12, 13, 9, 15, dtype=dtype), _meta(8, 9, 9, 3, dtype=dtype)
    dw = ck.tapconv_wgrad_3d(g, ct, kx, ky)
    assert dw.shape == (kx, ky, 15, 3) and dw.dtype == torch.float32
    counts = {k: launches.LAUNCHES[k] for k in ("tapconv_wgrad_3d", "tapconv_wgrad_3d+f32")}
    if dtype == torch.bfloat16:
        assert fake_card.names() == ["ins_tapconv_wgrad_mma"]
        assert counts == {"tapconv_wgrad_3d": 1, "tapconv_wgrad_3d+f32": 0}
        # the wrapper pads kc 15 -> 16 and the 3 cotangent channels -> 8
        args = fake_card.calls[0][1]
        assert args[4:10] == (12, 13, 9, 16, 8, kx)
        assert args[10:18] == (ky, *ck.tap_wgrad_plan((8, 9, 9), 16, 8, kx, ky))
    else:
        assert fake_card.names() == ["ins_tapconv_wgrad_tf32"]
        assert counts == {"tapconv_wgrad_3d": 0, "tapconv_wgrad_3d+f32": 1}
        # the 3xTF32 kernel pads kc 15 -> 16 and the 3 cotangent channels
        # -> 4 (16-byte units of 4 floats)
        args = fake_card.calls[0][1]
        assert args[4:11] == (12, 13, 9, 16, 4, kx, ky)
        assert args[11:19] == tuple(ck.tap_wgrad_tf32_plan((8, 9, 9), 16, 4, kx, ky))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tap_forward_route_by_dtype(fake_card, dtype):
    g, w2 = _meta(9, 10, 7, 15, dtype=dtype), _meta(5, 5, 15, 24, dtype=torch.float32)
    out = ck.tapconv_3d(g, w2, None, "tanh", out_dtype=torch.float32)
    assert out.shape == (5, 6, 7, 24)
    if dtype == torch.bfloat16:
        assert fake_card.names() == ["ins_tapconv_fwd_mma"]
        assert launches.LAUNCHES["tapconv_3d"] == 1 and launches.LAUNCHES["tapconv_3d+f32"] == 0
    else:
        assert fake_card.names() == ["ins_tapconv_fwd_tf32"]
        assert launches.LAUNCHES["tapconv_3d+f32"] == 1 and launches.LAUNCHES["tapconv_3d"] == 0
        # g's 15 channels padded to 16 (16-byte units of 4), kp 16, (nt, np) (3, 24)
        assert fake_card.calls[0][1][6:16] == (9, 10, 7, 16, 5, 5, 24, 16, 3, 24)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_backward_routes(fake_card, dtype):
    """The layer's forward (pack form) and backward launch only their
    dtype's kernels: 1 pack forward, then 1 tap forward (dG) and 1 wgrad."""
    g = _meta(9, 10, 7, 16, dtype=dtype).requires_grad_(True)
    w2 = _meta(5, 5, 16, 3, dtype=dtype).requires_grad_(True)
    layer = ck.make_conv_layer("id", False)
    y = layer(g, w2)
    fwd = dict(launches.LAUNCHES)
    torch.autograd.grad(y.float().sum(), [g, w2])
    sfx, other = ("", "+f32") if dtype == torch.bfloat16 else ("+f32", "")
    bwd = {k: launches.LAUNCHES[k] - fwd[k] for k in fwd}
    assert {k: fwd[k + s] for k in ("packconv_3d", "tapconv_3d", "tapconv_wgrad_3d")
            for s in (sfx,)} == {"packconv_3d": 1, "tapconv_3d": 0, "tapconv_wgrad_3d": 0}
    assert {k: bwd[k + sfx] for k in ("packconv_3d", "tapconv_3d", "tapconv_wgrad_3d")} \
        == {"packconv_3d": 0, "tapconv_3d": 1, "tapconv_wgrad_3d": 1}
    assert not any(launches.LAUNCHES[k + other] for k in ("packconv_3d", "tapconv_3d",
                                                          "tapconv_wgrad_3d"))
