"""The float32 pack forward in 3xTF32 (`csrc/tapconv_tf32.cu`), held on
the CPU.

On the card `packconv_3d` on float32 g runs, where `pack_tf32_takes`
(every tap packs into one tile of at most 80 columns: the closure's
24 -> 3 layer), the weight-first pack kernel `pack_tf32_kernel`: each
input plane's products with every tap once, on the tensor cores in 3xTF32
(g split into TF32 big and small parts in registers, the packed weights
split on the host into fragment order by `pack_all_taps_tf32`; every 16
channels, two k8 steps, one tensor-core chain added to float32 sums), then the
shifted tap sums in float32, in the order (dx, dy).  Elsewhere (3 -> 24,
24 -> 24) it runs the 3xTF32 tap kernel.  Both count under
``packconv_3d+f32``.  The kernel runs only on the card, where
`chip_smoke.py` holds it against the plain version in float32 and in
float64.  Here:

- the split fragments rebuild the packed weights (big + small within
  2^-21 of each weight), with zeros past kc rows and past the packed
  columns;
- the rule for which layers the kernel takes, `pack_tf32_takes`, against
  `csrc/pack_geometry.cuh`'s, built by the host C++ compiler, and the C
  entry's parameters against its ctypes signature;
- the route through a stand-in library on meta tensors: 24 -> 3 calls the
  pack entry once, 24 -> 24 and 3 -> 24 the tap entry, one
  ``packconv_3d+f32`` launch a call, and no FMA entry is left;
- the kernel's arithmetic emulated in its order against the float64 plain
  version and the JAX `packconv_3d` in interpret mode, on small z-folded
  layers.
"""

import contextlib
import ctypes
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ins_tpu.ops import convkernels as jck

from ins_tpu_torch import _build
from ins_tpu_torch.ops import conv_kernels as ck
from ins_tpu_torch.ops import launches

# 3xTF32 sums against float64 (the float32 class; sums of up to 25·kc
# split products); one TF32 pass is ~1e-3 off
TOL_3XTF32 = 1e-5
TF32_ONE_PASS_OFF = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the emulation is many small float64 products,
    which oversubscribed threads slow by orders of magnitude when the test
    lane runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _operands(box, kc, cout, k, seed):
    """float32 g (nx + k − 1, ny + k − 1, nz, kc) with full mantissas, w2
    (k, k, kc, cout), bias."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = box
    g = rng.standard_normal((nx + k - 1, ny + k - 1, nz, kc))
    w2 = rng.standard_normal((k, k, kc, cout)) / np.sqrt(k * k * kc)
    b = 0.1 * rng.standard_normal(cout)
    return (torch.from_numpy(a.astype(np.float32)) for a in (g, w2, b))


# --------------------------------------------------------------------------
# (a) the split fragments
# --------------------------------------------------------------------------


def _unpack(frags):
    """`pack_all_taps_tf32`'s (kp/8, nt, 32, 4) back to (big, small), each
    (kp, 8·nt): lane 4·g + t of step s, tile u holds rows 8·s + t and
    8·s + t + 4 of column 8·u + g."""
    ks, nt = frags.shape[:2]
    f = frags.reshape(ks, nt, 8, 4, 4)  # step, tile, g, t, (big0, big1, small0, small1)
    out = []
    for j0 in (0, 2):
        part = f[..., j0:j0 + 2]  # step, tile, g, t, j
        out.append(part.permute(0, 4, 3, 1, 2).reshape(8 * ks, 8 * nt))
    return out


@pytest.mark.parametrize("kx,ky,kc,cout", [(5, 5, 120, 3), (3, 3, 16, 8), (5, 5, 24, 3),
                                           (1, 1, 4, 1), (7, 7, 12, 1)])
def test_fragments_rebuild_the_weights(kx, ky, kc, cout):
    w2 = torch.from_numpy(np.random.default_rng(kc + cout).standard_normal(
        (kx, ky, kc, cout)).astype(np.float32))
    frags = ck.pack_all_taps_tf32(w2)
    n = kx * ky * cout
    assert frags.shape == (-(-kc // 8), -(-n // 8), 32, 4) and frags.dtype == torch.float32
    big, small = _unpack(frags)
    assert torch.equal(big, ck.tf32_round(big)) and torch.equal(small, ck.tf32_round(small))
    ws = F.pad(ck.pack_all_taps(w2)[:kc, :n], (0, big.shape[1] - n, 0, big.shape[0] - kc))
    rebuilt = big.double() + small.double()
    assert torch.all((rebuilt - ws.double()).abs() <= 2.0**-21 * ws.double().abs())
    assert not big[kc:].any() and not big[:, n:].any() and not small[kc:].any()


# --------------------------------------------------------------------------
# (b) the rule for which layers the kernel takes, and the C entry
# --------------------------------------------------------------------------

_RULE_MAIN = r"""
#include <cstdio>
#include <cstdlib>

#include "pack_geometry.cuh"

int main(int argc, char** argv) {
    for (int i = 1; i + 3 < argc; i += 4) {
        const int kc = std::atoi(argv[i]), kx = std::atoi(argv[i + 1]);
        const int ky = std::atoi(argv[i + 2]), cout = std::atoi(argv[i + 3]);
        const int nt = (kx * ky * cout + 7) / 8;
        std::printf("%d %zu %d\n", (int)pack_tf32_takes(kc, kx, ky, cout),
                    pack_tf32_smem(2, nt, kx, ky, cout), pack_tf32_nbuf(nt, kx, ky, cout));
    }
    return 0;
}
"""


@pytest.fixture(scope="module")
def c_rule(tmp_path_factory):
    """`pack_tf32_takes`, `pack_tf32_smem(2, ...)` and `pack_tf32_nbuf` of
    `csrc/pack_geometry.cuh`, the C entry's own rule, built by the host
    C++ compiler: (kc, kx, ky, cout) -> (takes, bytes, stages)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/pack_geometry.cuh")
    d = tmp_path_factory.mktemp("pack_geometry")
    (d / "main.cpp").write_text(_RULE_MAIN)
    subprocess.run([cxx, "-std=c++17", "-I", str(_build.CSRC), "-o", str(d / "rule"),
                    str(d / "main.cpp")], check=True, capture_output=True)

    def rule(kc, kx, ky, cout):
        out = subprocess.run([str(d / "rule"), *map(str, (kc, kx, ky, cout))], check=True,
                             capture_output=True, text=True).stdout.split()
        return bool(int(out[0])), int(out[1]), int(out[2])

    return rule


# (kc, kx, ky, cout, takes): the stack's 24 -> 3 (kc 120) and 24 -> 24 and
# 3 -> 24 layers (kc 120, 16), 80 columns and one more, seven y-taps and
# nine, kc no multiple of 4, any contraction (kc 1200: the fragments
# stream with the stages), and 40 x-taps and 80 (the accumulators' ring)
RULE_CASES = [(120, 5, 5, 3, True), (120, 5, 5, 24, False), (16, 5, 5, 24, False),
              (16, 3, 3, 8, True), (24, 3, 3, 8, True), (8, 1, 5, 16, True),
              (8, 1, 3, 27, False), (128, 1, 7, 7, True), (4, 1, 9, 1, False),
              (6, 3, 3, 3, False), (4, 1, 1, 1, True), (1200, 5, 5, 3, True),
              (8, 40, 1, 1, True), (8, 80, 1, 1, False)]


@pytest.mark.parametrize("kc,kx,ky,cout,takes", RULE_CASES)
def test_rule_matches_the_c_entry(c_rule, kc, kx, ky, cout, takes):
    """The wrapper's rule is the C entry's, and its shared memory the
    kernel's (an H100 block's 227 KB at most where it takes the layer: a
    ring of two 32-channel stages at 24 -> 3)."""
    got, smem, nbuf = c_rule(kc, kx, ky, cout)
    assert ck.pack_tf32_takes(kx, ky, kc, cout) == got == takes
    nt = -(-kx * ky * cout // 8)
    assert ck._pack_tf32_smem(kx, ky, nt, cout) == smem
    if takes:
        assert smem <= 232448 and 2 <= nbuf <= 4
        assert ck._pack_tf32_smem(kx, ky, nt, cout, nbuf) <= 232448
        assert nbuf == 4 or ck._pack_tf32_smem(kx, ky, nt, cout, nbuf + 1) > 232448
    if (kc, kx, ky, cout) == (120, 5, 5, 3):
        assert nbuf == 2 and smem == 212224


def test_stack_layers_reach_both_kernels():
    """At radius 2 the float32 stack's 24 -> 3 forward packs every tap;
    3 -> 24 (15 channels staged as 16) and 24 -> 24 run the tap kernel."""
    routes = [ck.pack_tf32_takes(5, 5, -(-5 * cin // 4) * 4, cout)
              for cin, cout in ((3, 24), (24, 24), (24, 3))]
    assert routes == [False, False, True]


@pytest.mark.parametrize("name,first_names", [
    ("ins_packconv_tf32", ["g", "ws", "bias", "act", "out", "out_bf16", "nxp", "nyp", "nz",
                           "kc", "kx", "ky", "cout", "kp", "nt", "stream"]),
])
def test_c_entry_matches_its_signature(name, first_names):
    """The entry's parameters, in order, are its ctypes signature."""
    src = (_build.CSRC / "tapconv_tf32.cu").read_text()
    decl = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
    args = [a.strip() for a in decl.split(",")]
    kinds = [ctypes.c_void_p if "*" in a else ctypes.c_int for a in args]
    assert kinds == _build._SIGNATURES[name][0]
    assert [a.split()[-1].lstrip("*") for a in args] == first_names


# --------------------------------------------------------------------------
# (c) the route through a stand-in library
# --------------------------------------------------------------------------


class _FakeLib:
    """Stands in for the kernel library: records each entry point called."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("ins_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0

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


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# (kc, cout, entry): the float32 stack's three forwards at radius 2
ROUTES = [(120, 3, "ins_packconv_tf32"), (120, 24, "ins_tapconv_fwd_tf32"),
          (15, 24, "ins_tapconv_fwd_tf32")]


@pytest.mark.parametrize("kc,cout,entry", ROUTES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_route(fake_card, kc, cout, entry, out_dtype):
    g, w2 = _meta(9, 10, 7, kc), _meta(5, 5, kc, cout)
    out = ck.packconv_3d(g, w2, None, "id", out_dtype=out_dtype)
    assert out.shape == (5, 6, 7, cout) and out.dtype == out_dtype
    assert fake_card.names() == [entry]
    assert launches.LAUNCHES["packconv_3d+f32"] == 1
    assert sum(launches.LAUNCHES.values()) == 1
    args = fake_card.calls[0][1]
    kcs = -(-kc // 4) * 4  # g's channels staged as 16-byte units of 4
    if entry == "ins_packconv_tf32":
        assert args[3:16] == (0, args[4], int(out_dtype == torch.bfloat16), 9, 10, 7, kcs, 5, 5,
                              cout, -(-kcs // 8) * 8, -(-25 * cout // 8), 0)
    else:
        assert args[6:16] == (9, 10, 7, kcs, 5, 5, cout, *ck.tap_tf32_geometry(kcs, cout))
    assert len(args) == len(_build._SIGNATURES[entry][0])


def test_no_fma_conv_entry_is_left():
    """No FMA convolution remains: no binding, no source of its own, and
    no kernel source that declares one."""
    assert not (_build.CSRC / "tapconv.cu").exists()
    for name in ("ins_packconv", "ins_tapconv_wgrad", "ins_tapconv_wgrad_chunks",
                 "ins_conv_fwd", "ins_conv_wgrad"):
        assert name not in _build._SIGNATURES
    for p in _build.CSRC.glob("*.cu"):
        src = p.read_text()
        assert not re.search(r"\b(pack_products_kernel|pack_combine_kernel)\b", src), p.name


# --------------------------------------------------------------------------
# (d) the kernel's arithmetic, emulated in its order
# --------------------------------------------------------------------------


def _emulated(g, w2, bias, act, passes=3):
    """The pack kernel's output on float32 g and w2: g's channels staged
    to a multiple of 4 and the contraction padded to kp (a multiple of 8),
    each input plane's products in chains of 16 channels, two k8 steps (TF32
    big and small parts: small·big + big·small + big·big; TF32 products
    are exact, so float64 isolates the split), each chain rounded to
    float32 and added to a float32 sum; then the tap sums in float32 in the
    order (dx, dy), the bias and the activation."""
    kx, ky, kc, cout = w2.shape
    kp = -(-kc // 8) * 8
    gs = F.pad(g, (0, kp - kc))
    ws = F.pad(ck._pack_weights(w2), (0, 0, 0, kp - kc))  # (kp, kx·ky·cout)
    gb, wb = ck.tf32_round(gs), ck.tf32_round(ws)
    gsm, wsm = ck.tf32_round(gs - gb), ck.tf32_round(ws - wb)
    P = torch.zeros((*g.shape[:3], ws.shape[1]), dtype=torch.float32)
    for c0 in range(0, kp, 16):
        sl = slice(c0, c0 + 16)
        part = gb[..., sl].double() @ wb[sl].double()
        if passes == 3:
            part += gsm[..., sl].double() @ wb[sl].double() + gb[..., sl].double() @ wsm[sl].double()
        P = P + part.float()
    nx, ny = g.shape[0] - kx + 1, g.shape[1] - ky + 1
    out = torch.zeros((nx, ny, g.shape[2], cout), dtype=torch.float32)
    for dx in range(kx):
        for dy in range(ky):
            col = (dx * ky + dy) * cout
            out = out + P[dx:dx + nx, dy:dy + ny, :, col:col + cout]
    if bias is not None:
        out = out + bias
    return torch.tanh(out) if act == "tanh" else out


# (box, kc, cout, k, act): the small z-folded layers of 10 x 10 cells x 8
# (kc 15 and 24, cout 3 and 8: every tap packs at k = 5 with 3 outputs and
# at k = 3 with 8), the stack's 24 -> 3 layer (kc 120) on a ragged box,
# and seven y-taps
ARITH_CASES = [((10, 10, 8), 15, 3, 5, "id"), ((10, 10, 8), 24, 3, 5, "tanh"),
               ((10, 10, 8), 15, 8, 3, "tanh"), ((10, 10, 8), 24, 8, 3, "id"),
               ((3, 5, 9), 120, 3, 5, "id"), ((4, 3, 5), 12, 1, 7, "tanh")]


@pytest.mark.parametrize("box,kc,cout,k,act", ARITH_CASES)
def test_emulated_kernel_is_float32_class(box, kc, cout, k, act):
    g, w2, b = _operands(box, kc, cout, k, seed=kc + 7 * cout + k)
    assert ck.pack_tf32_takes(k, k, -(-kc // 4) * 4, cout)
    got = _emulated(g, w2, b, act)
    ref64 = ck.packconv_3d_plain(g.double(), w2.double(), b.double(), act)
    assert got.shape == ref64.shape == (*box, cout)
    off = _rel(got, ref64)
    assert off <= TOL_3XTF32, off
    # one TF32 pass is outside the float32 class
    assert _rel(_emulated(g, w2, b, act, passes=1), ref64) > TF32_ONE_PASS_OFF
    # and the float32 plain version (the kernel's yardstick on the card) is in it
    assert _rel(ck.packconv_3d_plain(g, w2, b, act), ref64) <= TOL_3XTF32


@pytest.mark.parametrize("kc,cout,k", [(15, 3, 5), (24, 8, 3)])
def test_emulated_kernel_matches_jax(kc, cout, k):
    """The same float32 inputs (numpy seed) in the JAX glue's 128 lanes
    (nz 128) through the JAX `packconv_3d` in interpret mode (every tap in
    one tile) and through the emulated kernel, to the float32 class."""
    rng = np.random.default_rng(kc * cout)
    nx, ny, nz = 3, 4, 128
    g = np.zeros((nx + k - 1, ny + k - 1, nz, 128), np.float32)
    g[..., :kc] = rng.standard_normal((*g.shape[:3], kc))
    w2 = np.zeros((k, k, 128, cout), np.float32)
    w2[:, :, :kc] = rng.standard_normal((k, k, kc, cout)) / np.sqrt(k * k * kc)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    ref = np.asarray(jck.packconv_3d(jnp.asarray(g), jnp.asarray(w2), jnp.asarray(b), jnp.tanh,
                                     interpret=True))[..., :cout]
    tg, tw, tb = (torch.from_numpy(a) for a in (g[..., :kc], w2[:, :, :kc], b))
    got = _emulated(tg, tw, tb, "tanh")
    assert got.shape == ref.shape
    assert _rel(got.numpy(), ref) <= TOL_3XTF32
