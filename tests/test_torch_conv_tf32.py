"""The float32 route of the fused conv layer (3xTF32), held on the CPU.

For float32 operands `fusedconv_3d` and `fusedconv_wgrad_3d` run the
3xTF32 tensor-core kernels of `csrc/conv.cu`: the z taps folded into the
contraction as in the bf16 route (the window ``row[z·cw : z·cw + kp]`` of
the wrap-padded, channel-padded input row), each operand split into TF32
parts, big = rna(x) and small = rna(x − big), and each product formed as
small·big + big·small + big·big.  Each kernel has its own chunk geometry
(`tf32_geometry`): the forward's A fragments come by ldmatrix on rows cw
floats apart, the weight gradient's by 32-bit loads at ``t·cw + g``, so
each picks the chunk widths whose loads hit distinct banks.  The forward's
B fragments come split from the host (`pack_conv_weights_tf32`).

These tests check the geometry, the packing of the split fragments, and
an emulation of the kernels' split products in float64 on the window
formula: within 1e-6 of the float64 plain version while one TF32 pass is
outside 1e-4, and within 1e-5 of the JAX fused layer's kernels in
interpret mode at float32.  A stand-in kernel library shows the routes:
float32 operands on the card take the new entry points with split weights
and channels padded to a multiple of 4, and no FMA entry point is left.
The kernels themselves run only on the card: `chip_smoke.py` holds them
against the plain versions there.
"""

import contextlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ins_tpu.ops import convkernels as jck

from ins_tpu_torch import _build
from ins_tpu_torch.ops import conv_kernels as ck
from ins_tpu_torch.ops import launches
from test_torch_conv_mma import _windows

# 3xTF32 against float64: about 2^-21 a product; one TF32 pass: 2^-11
TOL_3XTF32 = 1e-6
TF32_ONE_PASS_OFF = 1e-4
# float32 on both sides, sums in another order
TOL_F32 = 1e-5
# the JAX fused kernel needs nz % 16 == 0
BOX = (6, 8, 16)
# the closure's layers and their input-gradient twins, and wider ones: two
# input chunks and two output blocks (40 -> 40), 13 output channels
LAYERS = [(24, 24), (3, 24), (24, 3), (40, 40), (16, 13)]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the emulations are many small float64 products,
    which oversubscribed threads slow by orders of magnitude when the test
    lane runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _inputs(box, cin, cout, k, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((*box, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, k, cin, cout)) / np.sqrt(k**3 * cin)).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    d = rng.standard_normal((*box, cout)).astype(np.float32)
    return (torch.from_numpy(a) for a in (h, w, b, d))


# --------------------------------------------------------------------------
# Geometry
# --------------------------------------------------------------------------


def test_geometry_of_the_closure_layers():
    assert ck.tf32_geometry(24, 24, 5) == (12, 2, 64, 3, 24)
    assert ck.tf32_geometry(3, 24, 5) == (4, 1, 24, 3, 24)
    assert ck.tf32_geometry(24, 3, 5) == (12, 2, 64, 1, 8)
    assert ck.tf32_geometry(24, 24, 5, wgrad=True) == (24, 1, 128, 3, 24)
    assert ck.tf32_geometry(3, 24, 5, wgrad=True) == (4, 1, 32, 3, 24)
    assert ck.tf32_geometry(24, 3, 5, wgrad=True) == (24, 1, 128, 1, 8)
    # k = 7: two 12-channel stages of split weights would not fit, so 4
    assert ck.tf32_geometry(24, 24, 7) == (4, 6, 32, 3, 24)


def _banks_distinct(words):
    """Whether a warp's 32-bit shared loads of these word offsets take one
    wavefront: distinct words on distinct banks (equal words broadcast)."""
    words = set(words)
    return len({w % 32 for w in words}) == len(words)


@pytest.mark.parametrize("wgrad", [False, True])
@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("cin,cout", LAYERS)
def test_geometry(cin, cout, k, wgrad):
    g = ck.tf32_geometry(cin, cout, k, wgrad=wgrad)
    c4 = -(-cin // 4) * 4
    widths = ck._TF32_WGRAD_CW if wgrad else ck._TF32_FWD_CW
    step = 16 if wgrad else 8
    assert g.cw in widths and g.nch * g.cw >= c4 > (g.nch - 1) * g.cw
    assert g.kp == -(-k * g.cw // step) * step
    nblk, nt = ck._col_blocks(cout, 3)
    assert (g.nt, g.np) == (nt, nblk * nt * 8)
    if wgrad:
        # a0 of lane 4g + t at window word t·cw + g (a1 +8, a2 +4cw, a3 +4cw+8)
        for off in (0, 8, 4 * g.cw, 4 * g.cw + 8):
            assert _banks_distinct(t * g.cw + gg + off for t in range(4) for gg in range(8))
    else:
        # an ldmatrix phase: 8 rows (cells) cw floats apart, 16 bytes each
        assert len({(r * g.cw // 4) % 8 for r in range(8)}) == 8
        assert 2 * ck._fwd_tf32_smem(k, g.cw, g.kp, g.nt) <= ck._SMEM_MAX
    # no other width has fewer contraction rows (ties: fewer chunks)
    for cw in widths:
        kp = -(-k * cw // step) * step
        if wgrad or 2 * ck._fwd_tf32_smem(k, cw, kp, g.nt) <= ck._SMEM_MAX:
            nch = -(-c4 // cw)
            assert (nch * kp, nch) >= (g.nch * g.kp, g.nch)


# --------------------------------------------------------------------------
# The split B fragments of the forward
# --------------------------------------------------------------------------


def _unpack_split(wp):
    """(k, k, steps, tiles, 32, 4) split fragments -> (big, small) rows
    (k, k, 8·steps, 8·tiles): lane 4·g + t holds rows t and t + 4 of
    column g of its k8 step and n8 tile."""
    k, _, steps, tiles = wp.shape[:4]
    f = wp.reshape(k, k, steps, tiles, 8, 4, 2, 2)  # (.., g, t, part, half)
    f = f.permute(6, 0, 1, 2, 7, 5, 3, 4)  # (part, .., step, half, t, tile, g)
    big, small = f.reshape(2, k, k, 8 * steps, 8 * tiles)
    return big, small


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("cin,cout", LAYERS)
def test_packing_is_split_fragment_order(cin, cout, k):
    _, w, _, _ = _inputs((1, 1, 1), cin, cout, k, seed=cin * cout + k)
    g = ck.tf32_geometry(cin, cout, k)
    wp = ck.pack_conv_weights_tf32(w)
    assert wp.shape == (k, k, g.nch * g.kp // 8, g.np // 8, 32, 4) and wp.dtype == torch.float32
    big, small = _unpack_split(wp)
    rows = ck.pack_conv_weights(w, g)  # zero past cin, k·cw rows of a chunk and cout
    assert torch.equal(big, ck.tf32_round(rows))
    assert torch.equal(small, ck.tf32_round(rows - big))
    # the parts reassemble w: every canonical weight lands once, to 2^-22
    back = ck.unpack_conv_wgrad((big.double() + small.double()), k, cin, cout, g)
    assert torch.all((back - w.double()).abs() <= 2.0**-22 * w.double().abs())
    assert not big[..., cout:].any() and not small[..., cout:].any()


# --------------------------------------------------------------------------
# The kernels' split products, emulated in float64
# --------------------------------------------------------------------------


def _split(x):
    big = ck.tf32_round(x)
    return big.double(), ck.tf32_round(x - big).double()


def _tf32_forward(h, w, b=None, act=None):
    """The forward as the 3xTF32 kernel sums it, and as one TF32 pass
    would: per (dx, dy, chunk) the split windows times the split fragments
    of the packed weights; (three products, big·big only)."""
    nx, ny, _, cin = h.shape
    k, cout = w.shape[0], w.shape[-1]
    g = ck.tf32_geometry(cin, cout, k)
    wp = ck.pack_conv_weights_tf32(w)
    bb, bs = (t.double().reshape(k, k, g.nch, g.kp, g.np) for t in _unpack_split(wp))
    one = torch.zeros((*h.shape[:3], g.np), dtype=torch.float64)
    rest = torch.zeros_like(one)  # small·big + big·small
    for ch, win in enumerate(_windows(h, k, g)):
        ab, as_ = _split(win)
        for dx in range(k):
            for dy in range(k):
                a_b, a_s = ab[dx:dx + nx, dy:dy + ny], as_[dx:dx + nx, dy:dy + ny]
                one += a_b @ bb[dx, dy, ch]
                rest += a_s @ bb[dx, dy, ch] + a_b @ bs[dx, dy, ch]

    def epilogue(y):
        y = y[..., :cout] + (0.0 if b is None else b.double())
        return torch.tanh(y) if act == "tanh" else y

    return epilogue(one + rest), epilogue(one)


def _tf32_wgrad(h, d, k):
    """The weight gradient as the 3xTF32 kernel sums it, and as one TF32
    pass would: per (dx, dy, chunk) the split windows transposed times the
    split d; (three products, big·big only)."""
    nx, ny, _, cin = h.shape
    cout = d.shape[-1]
    g = ck.tf32_geometry(cin, cout, k, wgrad=True)
    db, ds = _split(F.pad(d, (0, g.np - cout)).reshape(-1, g.np))
    one = torch.zeros((k, k, g.nch, g.kp, g.np), dtype=torch.float64)
    rest = torch.zeros_like(one)
    for ch, win in enumerate(_windows(h, k, g)):
        for dx in range(k):
            for dy in range(k):
                ab, as_ = _split(win[dx:dx + nx, dy:dy + ny].reshape(-1, g.kp))
                one[dx, dy, ch] = ab.T @ db
                rest[dx, dy, ch] = as_.T @ db + ab.T @ ds
    return tuple(ck.unpack_conv_wgrad(t.reshape(k, k, g.nch * g.kp, g.np), k, cin, cout, g)
                 for t in (one + rest, one))


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("cin,cout", LAYERS)
def test_3xtf32_forward_is_float32_class(cin, cout, k):
    """The forward and (with cin and cout swapped) its input-gradient
    shapes: the three split products within 1e-6 (relative to max|out|)
    of float64, one TF32 pass outside 1e-4."""
    h, w, _, _ = _inputs(BOX, cin, cout, k, seed=10 * k + cin)
    ref = ck.fusedconv_3d_plain(h.double(), w.double())
    three, one = (_rel(y, ref) for y in _tf32_forward(h, w))
    assert three < TOL_3XTF32 and one > TF32_ONE_PASS_OFF, (three, one)


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("cin,cout", LAYERS)
def test_3xtf32_wgrad_is_float32_class(cin, cout, k):
    h, _, _, d = _inputs(BOX, cin, cout, k, seed=100 + 10 * k + cin)
    ref = ck.fusedconv_wgrad_3d_plain(h.double(), d.double(), k)
    three, one = (_rel(dw, ref) for dw in _tf32_wgrad(h, d, k))
    assert three < TOL_3XTF32 and one > TF32_ONE_PASS_OFF, (three, one)


def _lanes(a):
    """Pad channels to the JAX kernels' 128-lane carry."""
    return jnp.pad(jnp.asarray(a.numpy()), ((0, 0),) * 3 + ((0, 128 - a.shape[-1]),))


@pytest.mark.parametrize("cin,cout,k,act", [(3, 24, 5, "tanh"), (24, 3, 3, None)])
def test_3xtf32_matches_jax_fused_kernels(cin, cout, k, act):
    """The same float32 inputs (numpy seed) through the emulated 3xTF32
    sums and through the JAX fused kernels (Pallas interpret): the forward
    with its bias and activation, and the weight gradient, to 1e-5."""
    h, w, b, d = _inputs(BOX, cin, cout, k, seed=7 + cin + k)
    yj = jck.fusedconv_3d(_lanes(h), jck.pack_ws(jnp.asarray(w.numpy()), jnp.float32),
                          jnp.asarray(b.numpy()), jnp.tanh if act == "tanh" else None,
                          cin=cin, cout=cout, k=k, interpret=True)[..., :cout]
    assert _rel(_tf32_forward(h, w, b, act)[0], yj) < TOL_F32
    dws = jck.fusedconv_wgrad_3d(_lanes(h), _lanes(d), cin=cin, cout=cout, k=k, interpret=True)
    assert _rel(_tf32_wgrad(h, d, k)[0], jck.unpack_dws(dws, k, k, k, cin, cout)) < TOL_F32


# --------------------------------------------------------------------------
# The routes, through a stand-in kernel library
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
    device checks and the stream are stood in for, and the staging and
    packing the wrappers call are recorded."""
    lib = _FakeLib()
    lib.staged, lib.packed = [], []

    def check(name, dtypes, **operands):
        for t, shape in operands.values():
            assert t.dtype in dtypes and tuple(t.shape) == tuple(shape)
        return next(iter(operands.values()))[0].device

    def stageable(t, mult=8, _real=ck._stageable):
        lib.staged.append((t.shape[-1], mult))
        return _real(t, mult)

    def pack_tf32(w, _real=ck.pack_conv_weights_tf32):
        lib.packed.append(tuple(w.shape))
        return _real(w)

    monkeypatch.setattr(ck._build, "load", lambda: lib)
    monkeypatch.setattr(ck, "check_cuda_tensors", check)
    monkeypatch.setattr(ck, "current_stream", lambda device: 0)
    monkeypatch.setattr(ck, "_stageable", stageable)
    monkeypatch.setattr(ck, "pack_conv_weights_tf32", pack_tf32)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    launches.reset_counts()
    yield lib
    launches.reset_counts()


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("cin,cout", [(3, 24), (24, 3), (13, 16)])
def test_float32_forward_takes_the_tf32_kernel(fake_card, cin, cout):
    k = 5
    out = ck.fusedconv_3d(_meta(6, 8, 16, cin), _meta(k, k, k, cin, cout), _meta(cout), "tanh")
    assert out.shape == (6, 8, 16, cout) and out.dtype == torch.float32
    ((name, args),) = fake_card.calls
    assert name == "ins_conv_fwd_tf32"
    c4 = -(-cin // 4) * 4
    # act, out dtype, box, h's channels padded to a multiple of 4, cout, k, geometry
    assert args[3] == 1 and args[5:] == (0, 6, 8, 16, c4, cout, k,
                                         *ck.tf32_geometry(cin, cout, k), 0)
    assert fake_card.staged == [(cin, 4)] and fake_card.packed == [(k, k, k, cin, cout)]
    assert launches.LAUNCHES["fusedconv_3d+f32"] == 1 and launches.LAUNCHES["fusedconv_3d"] == 0


@pytest.mark.parametrize("cin,cout", [(3, 24), (24, 3), (13, 16)])
def test_float32_wgrad_takes_the_tf32_kernel(fake_card, cin, cout):
    k = 5
    dw = ck.fusedconv_wgrad_3d(_meta(6, 8, 16, cin), _meta(6, 8, 16, cout), k)
    assert dw.shape == (k, k, k, cin, cout) and dw.dtype == torch.float32
    g = ck.tf32_geometry(cin, cout, k, wgrad=True)
    assert fake_card.names() == ["ins_conv_wgrad_tf32_chunks", "ins_conv_wgrad_tf32"]
    assert fake_card.calls[0][1] == (6, 8, 16, k, g.nch, g.np // (8 * g.nt), g.kp)
    c4, o4 = -(-cin // 4) * 4, -(-cout // 4) * 4
    assert fake_card.calls[1][1][4:] == (6, 8, 16, c4, o4, k, *g, 0)
    assert fake_card.staged == [(cin, 4), (cout, 4)]
    assert launches.LAUNCHES["fusedconv_wgrad_3d+f32"] == 1
    assert launches.LAUNCHES["fusedconv_wgrad_3d"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_routes_by_dtype(fake_card, dtype):
    """The fused layer's forward and backward (dh and dw) launch only their
    dtype's kernels: bf16 the bf16 entry points, float32 the 3xTF32 ones."""
    h = _meta(6, 8, 16, 24, dtype=dtype).requires_grad_(True)
    w = _meta(5, 5, 5, 24, 3).requires_grad_(True)
    layer = ck.make_fused_layer("id", False, cin=24, cout=3, k=5)
    y = layer(h, w)
    torch.autograd.grad(y.float().sum(), [h, w])
    tf32 = dtype == torch.float32
    want = (["ins_conv_fwd_tf32", "ins_conv_wgrad_tf32_chunks", "ins_conv_wgrad_tf32",
             "ins_conv_fwd_tf32"] if tf32 else
            ["ins_conv_fwd_mma", "ins_conv_wgrad_mma_chunks", "ins_conv_wgrad_mma",
             "ins_conv_fwd_mma"])
    assert fake_card.names() == want
    sfx, other = ("+f32", "") if tf32 else ("", "+f32")
    assert launches.LAUNCHES["fusedconv_3d" + sfx] == 2
    assert launches.LAUNCHES["fusedconv_wgrad_3d" + sfx] == 1
    assert not launches.LAUNCHES["fusedconv_3d" + other]
    assert not launches.LAUNCHES["fusedconv_wgrad_3d" + other]


def test_no_fma_entry_point_is_left():
    """The FP32 FMA kernels of the fused layer are gone: no binding, no
    exported entry point, no kernel of that name in `csrc/conv.cu`."""
    for name in ("ins_conv_fwd", "ins_conv_wgrad", "ins_conv_wgrad_chunks"):
        assert name not in _build._SIGNATURES
    src = (Path(_build.CSRC) / "conv.cu").read_text()
    exported = set(re.findall(r'extern "C" int (\w+)\(', src))
    assert exported == {"ins_conv_fwd_mma", "ins_conv_wgrad_mma_chunks", "ins_conv_wgrad_mma",
                        "ins_conv_fwd_tf32", "ins_conv_wgrad_tf32_chunks", "ins_conv_wgrad_tf32"}
    assert not re.search(r"\b(conv_fwd_kernel|wgrad_kernel)\b", src)
    assert all(name in _build._SIGNATURES for name in exported)
