"""The tap layer's float32 weight gradient in 3xTF32, held on the CPU.

For float32 operands `tapconv_wgrad_3d` runs `csrc/tapwgrad_tf32.cu`'s
`tap_wgrad_tf32_kernel` on the card: the bf16 kernel's structure (a ring
of staged g planes, each feeding every dx; (dx, dy, m16 tile) items over 8
warps; the B fragments loaded once a cotangent row; a fixed-order sum of
block partials) with `mma.sync.m16n8k8` on TF32 operands, each operand
split in registers into a big part rna(x) and a small part rna(x − big),
a product small·big + big·small + big·big.  The kernel runs only on the
card, where `chip_smoke.py` holds it against float64 and the plain
version.  Here:

- the plan (`tap_wgrad_tf32_plan`): the main path's shapes, and every
  shape the FMA kernel it replaces took (any kc, cout and kx) within the
  kernel's items, shared memory and chunk count;
- the fragments: a warp's 32-bit loads at the kernel's offsets from the
  staged layout (cell pitch 16·mc + 8, cotangent pitch 8 or 24) hit 32
  distinct banks, and an emulated m16n8k8 on them is the tile's product;
- the split, and the whole sum emulated in the kernel's order (chunks,
  k8 steps of three-product chains added to float32 accumulators, the
  partials in order) for the 120 x 24 and 120 x 3 layers on a small box,
  within 1e-5 of float64 (one TF32 pass is outside 1e-4);
- the route: float32 g launches the 3xTF32 entry alone (a stand-in
  library on meta tensors), and no FMA weight gradient is left.
"""

import contextlib
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ins_tpu_torch import _build
from ins_tpu_torch.ops import conv_kernels as ck
from ins_tpu_torch.ops import launches

TOL_3XTF32 = 1e-5
TF32_ONE_PASS_OFF = 1e-4
MAIN = (128, 128, 128)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the test lane runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


# --------------------------------------------------------------------------
# (a) the plan
# --------------------------------------------------------------------------


def test_plan_of_the_stack():
    # 24 -> 24: 8 m16 tiles in chunks of 2 (50 items of the 56 a block
    # holds), every dx in one group, two buffers (102 KB: two blocks an
    # SM), one x run; 3 -> 24 (kc 15, staged as 16) one tile; 24 -> 3 one
    # n8 tile
    assert ck.tap_wgrad_tf32_plan(MAIN, 120, 24, 5, 5) == (128, 3, 24, 2, 5, 2, 128, 256)
    assert ck.tap_wgrad_tf32_plan(MAIN, 16, 24, 5, 5)[:6] == (16, 3, 24, 1, 5, 3)
    assert ck.tap_wgrad_tf32_plan(MAIN, 120, 4, 5, 5)[:6] == (128, 1, 8, 2, 5, 3)


_SHAPES = [(kc, cd, kx, ky) for kc in (4, 16, 120, 288, 1024) for cd in (4, 16, 24, 120)
           for kx, ky in ((1, 1), (3, 3), (5, 5), (7, 7), (3, 5), (9, 7), (12, 1))]


@pytest.mark.parametrize("box", [(37, 21, 67), (1, 1, 1), MAIN])
def test_plan_takes_every_shape(box):
    """Any kc, cout (multiples of 4) and kx at ky in 1, 3, 5, 7 (the FMA
    kernel took ~290 channels at ky = 5): the items of a block's dx group
    fit its 8 warps of 7, the shared memory a block (and, where the plan
    says so, two an SM), the columns n8 tiles of at most 3."""
    nx, ny, nz = box
    for kc, cd, kx, ky in _SHAPES:
        p = ck.tap_wgrad_tf32_plan(box, kc, cd, kx, ky)
        ndx = -(-kx // p.kxb)
        assert p.kxb * ky * p.mc <= 56 and (ndx - 1) * p.kxb < kx <= ndx * p.kxb
        assert 1 <= p.mc <= min(8, p.kp // 16) and p.kp == -(-kc // 16) * 16
        smem = ck._wgrad_tf32_smem(p.kxb, ky, p.mc, p.nt, p.nbuf)
        assert p.nbuf in (2, 3) and smem + 224 <= 232448
        assert p.np % (8 * p.nt) == 0 and p.np - 8 * p.nt < cd <= p.np and p.nt <= 3
        assert p.nchunk == -(-nx // p.xb) * -(-ny // 8) * -(-nz // 8)
    # the stack's shapes keep two blocks an SM
    for kc, cd in ((120, 24), (16, 24), (120, 4)):
        p = ck.tap_wgrad_tf32_plan(box, kc, cd, 5, 5)
        assert 2 * (ck._wgrad_tf32_smem(p.kxb, 5, p.mc, p.nt, p.nbuf) + 224 + 1024) <= 228 * 1024


_SMEM_MAIN = r"""
#include <cstddef>
#include <cstdio>
#include <initializer_list>
#define __host__
#define __device__
%s
int main() {
    for (int ky : {1, 3, 5, 7})
        for (int mc = 1; mc <= 8; ++mc)
            for (int nt = 1; nt <= 3; ++nt)
                for (int nbuf = 2; nbuf <= 3; ++nbuf)
                    std::printf("%%d %%d %%d %%d %%zu\n", ky, mc, nt, nbuf,
                                wgrad_tf32_smem(5, ky, mc, nt, nbuf));
    return 0;
}
"""


def test_smem_rule_matches_the_kernel(tmp_path):
    """`_wgrad_tf32_smem` is the kernel's `wgrad_tf32_smem` (its tile
    constants, pitch rule and formula cut from the source and built by the
    host C++ compiler)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = (_build.CSRC / "tapwgrad_tf32.cu").read_text()
    parts = [re.search(r"constexpr int WTY = \d+;", src).group(0),
             re.search(r"constexpr int WTZ = \d+;", src).group(0),
             re.search(r"__host__ __device__ constexpr int wt_dpitch\(.*?\n", src).group(0),
             re.search(r"__host__ __device__ constexpr size_t wgrad_tf32_smem\(.*?\n}\n", src,
                       re.S).group(0)]
    (tmp_path / "main.cpp").write_text(_SMEM_MAIN % "\n".join(parts))
    subprocess.run([cxx, "-std=c++17", "-o", str(tmp_path / "smem"), str(tmp_path / "main.cpp")],
                   check=True, capture_output=True)
    out = subprocess.run([str(tmp_path / "smem")], check=True, capture_output=True,
                         text=True).stdout.splitlines()
    assert len(out) == 4 * 8 * 3 * 2
    for line in out:
        ky, mc, nt, nbuf, smem = map(int, line.split())
        assert ck._wgrad_tf32_smem(5, ky, mc, nt, nbuf) == smem


# --------------------------------------------------------------------------
# (b) the fragments
# --------------------------------------------------------------------------


def _lanes():
    lane = np.arange(32)
    return lane >> 2, lane & 3  # g, t


@pytest.mark.parametrize("mc", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("nt", [1, 2, 3])
def test_fragment_loads_hit_distinct_banks(mc, nt):
    """The A loads at t·P + g (+ 8, + 4P, + 4P + 8) with P = 16·mc + 8 and
    the B loads at t·DP + g (+ 4·DP) with DP = 8 or 24: 32 banks."""
    g, t = _lanes()
    P, DP = 16 * mc + 8, ck._wt_dpitch(nt)
    for off in (0, 8, 4 * P, 4 * P + 8):
        assert len(set((t * P + g + off) % 32)) == 32
    for n in range(nt):
        for off in (0, 4 * DP):
            assert len(set((t * DP + g + off + 8 * n) % 32)) == 32
    assert DP >= 8 * nt and DP % 8 == 0 and P % 8 == 0


def _mma(a, b0, b1):
    """m16n8k8 on the 32 lanes' fragments (a: (32, 4), b0, b1: (32,)):
    D (16 x 8), lane (g, t) holding a0 = A(g, t), a1 = A(g + 8, t), a2 =
    A(g, t + 4), a3 = A(g + 8, t + 4), b0 = B(t, g), b1 = B(t + 4, g)."""
    g, t = _lanes()
    A = np.zeros((16, 8))
    B = np.zeros((8, 8))
    A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a[:, 0], a[:, 1], a[:, 2], a[:, 3]
    B[t, g], B[t + 4, g] = b0, b1
    return A @ B


@pytest.mark.parametrize("mc,m,nt,n", [(2, 1, 3, 2), (1, 0, 1, 0), (3, 2, 2, 1)])
def test_fragments_are_the_tiles_product(mc, m, nt, n):
    """A warp's fragments read from one staged row (8 cells of 16·mc + 8
    floats, m16 tile m) and one staged cotangent row (8 cells of DP
    floats, n8 tile n) at the kernel's offsets multiply to gᵀ·d of that
    k8 step: the channels 16m .. 16m + 15 by the columns 8n .. 8n + 7."""
    rng = np.random.default_rng(mc * 10 + n)
    P, DP = 16 * mc + 8, ck._wt_dpitch(nt)
    gcell = rng.standard_normal((8, 16 * mc))
    dcell = rng.standard_normal((8, 8 * nt))
    sg = np.full((8, P), np.nan)
    sg[:, :16 * mc] = gcell
    sd = np.full((8, DP), np.nan)
    sd[:, :8 * nt] = dcell
    sg, sd = sg.reshape(-1), sd.reshape(-1)
    g, t = _lanes()
    a_lane, b_lane = t * P + g + 16 * m, t * DP + g + 8 * n
    a = np.stack([sg[a_lane], sg[a_lane + 8], sg[a_lane + 4 * P], sg[a_lane + 4 * P + 8]], 1)
    got = _mma(a, sd[b_lane], sd[b_lane + 4 * DP])
    want = gcell[:, 16 * m:16 * m + 16].T @ dcell[:, 8 * n:8 * n + 8]
    assert np.allclose(got, want, rtol=1e-14, atol=1e-14)


# --------------------------------------------------------------------------
# (c) the split and the whole sum
# --------------------------------------------------------------------------


def test_split_of_an_operand():
    """big = rna(x) (ties away: the card's cvt.rna.tf32.f32), small =
    rna(x − big): big + small within 2^-22 of x, big alone 2^-11."""
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    big = ck.tf32_round(v)
    small = ck.tf32_round(v - big)
    assert not (big.view(torch.int32) & 0x1FFF).any()
    assert not (small.view(torch.int32) & 0x1FFF).any()
    assert float(((big - v).abs() / v.abs()).max()) <= 2.0**-11
    assert float(((big.double() + small.double() - v.double()).abs()
                  / v.abs().double()).max()) <= 2.0**-22


def _split(x):
    big = ck.tf32_round(x)
    return big.double(), ck.tf32_round(x - big).double()


def _kernel_sum(g, ct, kx, ky, passes=3):
    """The kernel's sum for float32 g and ct: channels padded to 4, then to
    the plan's kp rows and np columns; per cell chunk of the plan (8 y x 8
    z cells over a run of xb planes; z fastest, then y, then x runs), per
    k8 step (one row of 8 cells, planes then rows in order) the step's
    products small·big + big·small + big·big (``passes`` 1: big·big) as
    one chain (exact TF32 products summed in float64, rounded to float32
    once), added to the float32 accumulators; the chunks' partials added
    in order in float32."""
    box = tuple(ct.shape[:3])
    gs, cs = ck._stageable(g, 4), ck._stageable(ct, 4)
    p = ck.tap_wgrad_tf32_plan(box, gs.shape[-1], cs.shape[-1], kx, ky)
    ga = F.pad(gs, (0, p.kp - gs.shape[-1]))
    ca = F.pad(cs, (0, p.np - cs.shape[-1]))
    nx, ny, nz = box
    gb, gsm = _split(ga)
    cb, csm = _split(ca)
    dw = torch.zeros((kx, ky, p.kp, p.np), dtype=torch.float32)
    chunks = 0
    for x0 in range(0, nx, p.xb):
        for y0 in range(0, ny, 8):
            for z0 in range(0, nz, 8):
                acc = torch.zeros_like(dw)
                z1 = min(nz, z0 + 8)
                for x in range(x0, min(nx, x0 + p.xb)):
                    for y in range(y0, min(ny, y0 + 8)):
                        # rows g[x + dx, y + dy, z0:z1], the cotangent row
                        gr = torch.stack([torch.stack([
                            gb[x + dx, y + dy, z0:z1] for dy in range(ky)])
                            for dx in range(kx)])
                        gr_s = torch.stack([torch.stack([
                            gsm[x + dx, y + dy, z0:z1] for dy in range(ky)])
                            for dx in range(kx)])
                        d_b, d_s = cb[x, y, z0:z1], csm[x, y, z0:z1]
                        chain = torch.einsum("abzc,zo->abco", gr, d_b)
                        if passes == 3:
                            chain = (chain + torch.einsum("abzc,zo->abco", gr_s, d_b)
                                     + torch.einsum("abzc,zo->abco", gr, d_s))
                        acc = acc + chain.float()
                dw = dw + acc
                chunks += 1
    assert chunks == p.nchunk
    return dw[:, :, :g.shape[-1], :ct.shape[-1]]


@pytest.mark.parametrize("kc,cout,label", [(120, 24, "24x24"), (120, 3, "24x3")])
def test_3xtf32_is_float32_class(kc, cout, label):
    """The 120 x 24 and 120 x 3 layers (ky = 5) on a small box: the kernel's
    sum within 1e-5 of float64 (relative to max|dW|); one TF32 pass
    outside 1e-4."""
    rng = np.random.default_rng(kc + cout)
    nx, ny, nz = 3, 5, 11
    g = torch.from_numpy(rng.standard_normal((nx + 4, ny + 4, nz, kc)).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((nx, ny, nz, cout)).astype(np.float32))
    ref = ck.tapconv_wgrad_3d_plain(g.double(), ct.double(), 5, 5)
    three = _rel(_kernel_sum(g, ct, 5, 5), ref)
    one = _rel(_kernel_sum(g, ct, 5, 5, passes=1), ref)
    assert three < TOL_3XTF32, (label, three)
    assert one > TF32_ONE_PASS_OFF, (label, one)


def test_kernel_sum_pads_channels_and_splits_dx():
    """A 15-channel g (staged as 16) and 9 x 7 taps (two dx groups): the
    emulated sum is the plain version's."""
    rng = np.random.default_rng(9)
    nx, ny, nz, kx, ky = 2, 3, 9, 9, 7
    g = torch.from_numpy(rng.standard_normal((nx + kx - 1, ny + ky - 1, nz, 15))
                         .astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((nx, ny, nz, 6)).astype(np.float32))
    assert ck.tap_wgrad_tf32_plan((nx, ny, nz), 16, 8, kx, ky).kxb < kx
    ref = ck.tapconv_wgrad_3d_plain(g.double(), ct.double(), kx, ky)
    assert _rel(_kernel_sum(g, ct, kx, ky), ref) < TOL_3XTF32


# --------------------------------------------------------------------------
# (d) the route and the entry
# --------------------------------------------------------------------------


class _FakeLib:
    """Stands in for the kernel library: records each entry point called
    with its arguments and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("ins_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


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


@pytest.mark.parametrize("kc,cout,kx,ky", [(15, 3, 5, 5), (120, 24, 5, 5), (24, 120, 3, 3),
                                           (300, 16, 9, 7)])
def test_float32_wgrad_takes_the_tf32_kernel(fake_card, kc, cout, kx, ky):
    box = (8, 9, 9)
    g = torch.empty((box[0] + kx - 1, box[1] + ky - 1, box[2], kc), device="meta")
    ct = torch.empty((*box, cout), device="meta")
    dw = ck.tapconv_wgrad_3d(g, ct, kx, ky)
    assert dw.shape == (kx, ky, kc, cout) and dw.dtype == torch.float32
    ((name, args),) = fake_card.calls
    assert name == "ins_tapconv_wgrad_tf32"
    assert len(args) == len(_build._SIGNATURES[name][0])
    k4, c4 = -(-kc // 4) * 4, -(-cout // 4) * 4
    assert args[4:11] == (*g.shape[:3], k4, c4, kx, ky)
    assert args[11:19] == tuple(ck.tap_wgrad_tf32_plan(box, k4, c4, kx, ky))
    assert launches.LAUNCHES["tapconv_wgrad_3d+f32"] == 1
    assert launches.LAUNCHES["tapconv_wgrad_3d"] == 0


def test_entry_matches_its_ctypes_signature():
    """`ins_tapconv_wgrad_tf32` takes g, d, partial, dW, the shapes, the
    taps, the plan and the stream: the wrapper's ctypes signature."""
    src = (_build.CSRC / "tapwgrad_tf32.cu").read_text()
    decl = re.search(r'extern "C" int ins_tapconv_wgrad_tf32\(([^)]*)\)', src).group(1)
    kinds = {"ptr": ctypes.c_void_p, "int": ctypes.c_int}
    got = [kinds["ptr" if "*" in a else a.split()[0]] for a in decl.split(",")]
    assert got == _build._SIGNATURES["ins_tapconv_wgrad_tf32"][0]
    names = [a.split()[-1].lstrip("*") for a in decl.split(",")]
    assert names[11:19] == list(ck.TapWgradTf32Plan._fields)


def test_no_fma_wgrad_is_left():
    """No FP32 FMA convolution entry remains: neither the weight gradient's
    nor the pack forward's has a binding, and no source exports or defines
    one (`csrc/tapconv.cu`, which held them, is gone)."""
    for name in ("ins_tapconv_wgrad", "ins_tapconv_wgrad_chunks", "ins_packconv"):
        assert name not in _build._SIGNATURES
    assert not (_build.CSRC / "tapconv.cu").exists()
    for p in _build.CSRC.glob("*.cu"):
        src = p.read_text()
        assert not {"ins_tapconv_wgrad", "ins_packconv"} & set(
            re.findall(r'extern "C" int (\w+)\(', src)), p.name
        assert not re.search(r"\btap_wgrad_kernel\b", src), p.name
