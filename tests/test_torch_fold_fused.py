"""The fused folded pass B (`csrc/fold.cu`), held on the CPU.

On the card `passB_fold` and `passB_sharded` (n % 4 == 0) are one launch
of `passb_fold_kernel`: a block's panel of columns with all n x-rows in
shared memory, the fold split on load, the half-size x products in 3xTF32
on the tensor cores (the basis split on the host, `pack_basis_a`; the
panel split into TF32 big and small parts in registers; chains of one
stage's K added to float32 sums), the eigen-scale and the combine in
their epilogues.  The kernel runs only on the card, where `chip_smoke.py`
holds it against the plain version in float64 and in float32.  Here:

- the launch each wrapper makes, through a stand-in library on meta
  tensors: one call of the fused entry with the right shape, y offset,
  level count and split fold matrices, and no plane GEMM, eigen-scale,
  split or combine; a refused launch raises;
- the geometry the C entry picks (`csrc/fold_geometry.cuh`, built here
  by the host C++ compiler: panel width, stage depth, ring) fits an H100
  block's shared memory and covers a product's rows, up to n = 1024;
- the kernel's arithmetic emulated in its order (split on load, TF32
  parts, chains of one stage's K, the closed-form scale, the combine)
  against the float64 plain version and the JAX package's pass B in
  interpret mode at Precision.HIGHEST, on a cube at one and two levels
  and on a shard at a nonzero y offset, with chains of 32, 16 and 8 of K.
"""

import contextlib
import shutil
import subprocess
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ins_tpu.ops import poisson_pallas as jpp

from ins_tpu_torch import _build
from ins_tpu_torch.ops import launches
from ins_tpu_torch.ops import poisson_kernels as pk
from ins_tpu_torch.ops.conv_kernels import tf32_round

# 3xTF32 sums against float64 (the float32 class); one TF32 pass is ~1e-3 off
TOL_3XTF32 = 1e-6
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


def _dxs(n):
    return (2 * np.pi / n, 2 * np.pi / n, np.pi / n)


def _proj(n, levels, ly, dtype=torch.float32):
    """The fused projection (ly = n) or a shard's (ly < n), with the
    fold's level count set, in the 3xTF32 form ("highest")."""
    dxs = _dxs(n)
    proj = (pk.make_fused_projection((n,) * 3, dxs, dtype, precision="highest", device="cpu")
            if ly == n else pk.make_passB_sharded((n,) * 3, dxs, dtype, ly, precision="highest",
                                                  device="cpu"))
    if levels != proj["fold_levels"]:
        mats, _, _ = pk.poisson_fold_consts((n,) * 3, dxs, dtype, levels=levels, device="cpu")
        proj = dict(proj, fold_mats=mats, fold_levels=levels)
    return proj


# --------------------------------------------------------------------------
# (a) the launches the wrappers make, through a stand-in library
# --------------------------------------------------------------------------


class _FakeLib:
    """Stands in for the kernel library: records each entry point called
    with its arguments and returns ``status`` (0: success)."""

    def __init__(self):
        self.calls = []
        self.status = 0

    def ins_error_string(self, err):
        return b"invalid argument"

    def __getattr__(self, name):
        if not name.startswith("ins_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return self.status

        return entry


@pytest.fixture
def fake_card(monkeypatch):
    """Meta tensors take the wrappers' card branch; the library, the
    device checks, the stream and the split of the fold matrices (each a
    stand-in with a pointer of its own) are stood in for."""
    lib = _FakeLib()
    splits = {}

    def check(name, dtypes, **operands):
        for t, shape, *_ in operands.values():
            assert t.dtype in dtypes and tuple(t.shape) == tuple(shape)
        return torch.device("meta")

    def split_basis(w, side, precision="highest"):
        splits.setdefault(id(w), (side, 0x1000 * (len(splits) + 1)))
        return types.SimpleNamespace(data_ptr=lambda: splits[id(w)][1])

    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(pk, "check_cuda_tensors", check)
    monkeypatch.setattr(pk, "current_stream", lambda device: 0)
    monkeypatch.setattr(pk, "split_basis", split_basis)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    launches.reset_counts()
    lib.splits = splits
    yield lib
    launches.reset_counts()


# (n, levels, ly, yoff): cubes at one and two levels, the ragged n = 100
# (halves of 50), 4-way shards of 256³ and 1024³
LAUNCH_CASES = [(64, 1, 64, 0), (64, 2, 64, 0), (100, 1, 100, 0), (256, 1, 256, 0),
                (256, 2, 256, 0), (512, 2, 512, 0), (256, 1, 64, 128), (256, 2, 64, 128),
                (1024, 2, 256, 512)]


def _call(n, levels, ly, yoff):
    """The wrapper's call on a meta h: (projection, output, launch key)."""
    proj = _proj(n, levels, ly)
    h = torch.empty((n, ly, n), dtype=torch.float32, device="meta")
    if ly == n:
        return proj, pk.passB_fold(h, proj), "passB_fold"
    return proj, pk.passB_sharded(h, proj, yoff), "passB_sharded"


@pytest.mark.parametrize("n,levels,ly,yoff", LAUNCH_CASES)
def test_one_fused_launch(fake_card, monkeypatch, n, levels, ly, yoff):
    """One launch of the fused entry, with the gate raised where n lies
    above it (the kernel takes any n % 4 == 0 up to 1024; the wrappers
    route n above the gate to the level route, tests/test_torch_passb_route.py)."""
    monkeypatch.setattr(pk, "FOLD_FUSED_MAX_N", max(pk.FOLD_FUSED_MAX_N, n))
    proj, out, key = _call(n, levels, ly, yoff)
    assert out.shape == (n, ly, n) and out.dtype == torch.float32
    (name, args), = fake_card.calls
    assert name == "ins_passb_fold_f32"
    assert args[8:12] == (n, ly, yoff, levels)
    # the fold matrices split as A operands, in order, the rest null
    ptrs = [fake_card.splits[id(w)] for w in proj["fold_mats"]]
    assert all(side == "a" for side, _ in ptrs)
    assert list(args[2:8]) == [p for _, p in ptrs] + [None] * (6 - len(ptrs))
    assert len(ptrs) == 2 * levels + 2
    assert args[12:17] == (*proj["dxs"], proj["vol"], proj["eps"])
    assert len(args) == len(_build._SIGNATURES[name][0])
    assert launches.LAUNCHES[key] == 1
    assert sum(launches.LAUNCHES.values()) == 1 and not any(launches.PLAIN_ON_CUDA.values())


@pytest.mark.parametrize("n,levels,ly,yoff", [(64, 1, 64, 0), (256, 1, 64, 128)])
def test_refused_launch_raises(fake_card, n, levels, ly, yoff):
    """A launch the entry refuses (cudaErrorInvalidValue: no geometry, as
    above n = 1024) raises and counts no launch."""
    fake_card.status = 1
    with pytest.raises(RuntimeError, match="invalid argument"):
        _call(n, levels, ly, yoff)
    assert len(fake_card.calls) == 1 and not any(launches.LAUNCHES.values())


def test_parent_route_is_gone(fake_card):
    """The eight-launch route is gone from the fused kernel's range: up to
    the gate the wrappers launch only the fused entry (the route's split
    and combine kernels serve the level route above the gate alone)."""
    assert "ins_passb_fold_f32" in _build._SIGNATURES
    assert "ins_eigen_scale_f32" in _build._SIGNATURES
    for n, levels, ly, yoff in LAUNCH_CASES:
        if n > pk.FOLD_FUSED_MAX_N:
            continue
        fake_card.calls.clear()
        _call(n, levels, ly, yoff)
        assert [name for name, _ in fake_card.calls] == ["ins_passb_fold_f32"]


# --------------------------------------------------------------------------
# (b) the geometry
# --------------------------------------------------------------------------


_GEOMETRY_MAIN = r"""
#include <cstdio>
#include <cstdlib>

#include "fold_geometry.cuh"

int main(int argc, char** argv) {
    for (int i = 1; i < argc; ++i) {
        const FoldGeometry g = fold_geometry(std::atoi(argv[i]));
        std::printf("%d %d %zu\n", g.nc, g.ks, g.smem);
    }
    return 0;
}
"""


@pytest.fixture(scope="module")
def geometry(tmp_path_factory):
    """`fold_geometry(n)` of `csrc/fold_geometry.cuh`, the C entry's own
    choice, built by the host C++ compiler: n -> (nc, ks, smem bytes)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/fold_geometry.cuh")
    d = tmp_path_factory.mktemp("fold_geometry")
    (d / "main.cpp").write_text(_GEOMETRY_MAIN)
    subprocess.run([cxx, "-std=c++17", "-I", str(_build.CSRC), "-o", str(d / "geometry"),
                    str(d / "main.cpp")], check=True, capture_output=True)

    def pick(n):
        out = subprocess.run([str(d / "geometry"), str(n)], check=True, capture_output=True,
                             text=True).stdout
        return tuple(int(v) for v in out.split())

    return pick


# the sizes of the launch cases, the chip's (64, 128, 256, 512, 1024) and
# ragged ones; the geometry depends on n alone (any levels, ly, yoff)
GEOMETRY_NS = sorted({n for n, *_ in LAUNCH_CASES} | {4, 8, 52, 128, 384, 768})
# the geometries timed on the card (PERF.md): (nc, ks)
TIMED_GEOMETRY = {64: (256, 4), 128: (256, 4), 256: (128, 4), 512: (64, 2), 1024: (32, 1)}


@pytest.mark.parametrize("n", GEOMETRY_NS)
def test_geometry_fits_a_block(geometry, n):
    """The launch fits an H100 block's 227 KB and holds what the kernel
    touches (the panel's n rows, rows nc + 8 floats apart; two stages of
    the largest product's m16 tiles; the eigenvalue tables); the warps
    (64 rows each, nc / 32 across) cover a product's rows (at most n / 2)
    in one pass; a stage is one chain of at most 32 of K."""
    nc, ks, smem = geometry(n)
    assert nc in (32, 64, 128, 256) and 64 * 256 // nc >= n // 2
    assert ks in (1, 2, 4)
    assert smem <= 232448
    touched = n * (nc + 8) + 2 * -(-(n // 2) // 16) * ks * 256 + n // 2 + 1 + 2 * nc
    assert smem >= 4 * touched
    assert (nc + 8) % 32 == 8  # B fragment loads: 32 lanes, 32 banks
    assert TIMED_GEOMETRY.get(n, (nc, ks)) == (nc, ks)


@pytest.mark.parametrize("n", [1028, 1032, 2048, 4096])
def test_geometry_refuses(geometry, n):
    """Above n = 1024 no panel of all n rows fits: the entry refuses."""
    assert geometry(n) == (0, 0, 0)


# --------------------------------------------------------------------------
# (c) the kernel's arithmetic, emulated in its order
# --------------------------------------------------------------------------


def _product(w, x, bk, passes=3):
    """w @ x as the kernel sums it: w (the basis) and x (the panel) each
    split into TF32 parts, chains of bk of K (small·big + big·small +
    big·big; TF32 products are exact, so float64 isolates the split),
    each chain rounded to float32 and added to a float32 sum."""
    wb, xb = tf32_round(w), tf32_round(x)
    ws, xs = tf32_round(w - wb), tf32_round(x - xb)
    acc = torch.zeros(w.shape[0], x.shape[1], dtype=torch.float32)
    for k in range(0, w.shape[1], bk):
        sl = slice(k, k + bk)
        part = wb[:, sl].double() @ xb[sl].double()
        if passes == 3:
            part += ws[:, sl].double() @ xb[sl].double() + wb[:, sl].double() @ xs[sl].double()
        acc = acc + part.float()
    return acc


def _lam(k, n, dx):
    s = np.sin(np.pi * np.asarray(k, np.float64) / n).astype(np.float32)
    return np.float32(-4.0 / (dx * dx)) * s * s


def _scale(g, kx, proj, n, ly, yoff):
    """g *= 1 / den, den = vol·((λx + λy) + λz) in float32 as the kernel
    forms it, 0 where |den| < eps."""
    dx0, dx1, dx2 = (np.float32(d) for d in proj["dxs"])
    col = np.arange(ly * n)
    y, z = col // n, col % n
    lyz = (_lam((y + yoff + 1) // 2, n, dx1), _lam((z + 1) // 2, n, dx2))
    den = np.float32(proj["vol"]) * ((_lam(kx, n, dx0)[:, None] + lyz[0][None]) + lyz[1][None])
    inv = np.where(np.abs(den) < proj["eps"], np.float32(0),
                   np.float32(1) / np.where(den == 0, np.float32(1), den))
    return g * torch.from_numpy(inv.astype(np.float32))


def _emulated(h, proj, yoff, bk, passes=3):
    """The fused kernel's qhat in its order, on an (n, ly, n) float32 h,
    with chains of bk of K."""
    n, ly = h.shape[0], h.shape[1]
    mats, levels = proj["fold_mats"], proj["fold_levels"]

    def solve(hb, lvl, kmul):
        r = np.arange(hb.shape[0])
        if lvl == levels:
            g = _scale(_product(mats[2 * levels], hb, bk, passes), kmul * ((r + 1) // 2),
                       proj, n, ly, yoff)
            return _product(mats[2 * levels + 1], g, bk, passes)
        s = hb.shape[0] // 2
        e, o = hb[:s] + hb[s:], hb[:s] - hb[s:]  # the split on load, float32
        go = _scale(_product(mats[2 * lvl], o, bk, passes), kmul * (2 * (r[:s] // 2) + 1),
                    proj, n, ly, yoff)
        qe = 0.5 * solve(e, lvl + 1, 2 * kmul)  # the even half first: its rows hold it
        qo = _product(mats[2 * lvl + 1], go, bk, passes)
        return torch.cat([qe + qo, qe - qo])

    return solve(h.reshape(n, ly * n), 0, 1).reshape(n, ly, n)


# (n, levels, ly, yoff, bk): the cube at one and two levels, and a shard
# at a nonzero y offset whose products take two chains (K = 64), with the
# 32-K chains the kernel sums at these sizes; then the 16- and 8-K chains
# it sums at n = 512 and 1024, on the same small shapes
ARITH_CASES = [(16, 1, 16, 0, 32), (32, 2, 32, 0, 32), (128, 1, 8, 40, 32),
               (32, 2, 32, 0, 16), (128, 1, 8, 40, 8)]


@pytest.mark.parametrize("n,levels,ly,yoff,bk", ARITH_CASES)
def test_emulated_kernel_is_float32_class(n, levels, ly, yoff, bk):
    h64 = np.random.default_rng(n + ly + levels).standard_normal((n, ly, n))
    h = torch.from_numpy(h64.astype(np.float32))
    proj = _proj(n, levels, ly)
    got = _emulated(h, proj, yoff, bk)
    # the plain version in float64 (float64 fold matrices)
    p64 = _proj(n, levels, ly, torch.float64)
    ref64 = pk.passB_sharded_plain(h.double(), p64, yoff)
    # the JAX package's pass B, interpret mode, Precision.HIGHEST, float64
    if ly == n:
        jproj = jpp.make_fused_projection((n,) * 3, _dxs(n), jnp.float64, precision="highest",
                                          interpret=True)
        ref_jax = np.asarray(jproj["passB"](jnp.asarray(h.double().numpy())))
    else:
        jproj = jpp.make_passB_sharded((n,) * 3, _dxs(n), jnp.float64, ly,
                                       precision="highest", interpret=True)
        ref_jax = np.asarray(jproj["passB"](jnp.asarray(h.double().numpy()), yoff))
    assert _rel(ref64, ref_jax) <= 1e-12
    off64, off_jax = _rel(got, ref64), _rel(got, ref_jax)
    assert off64 <= TOL_3XTF32, off64
    assert off_jax <= TOL_3XTF32, off_jax
    # one TF32 pass is outside the float32 class
    assert _rel(_emulated(h, proj, yoff, bk, passes=1), ref64) > TF32_ONE_PASS_OFF
    # and the float32 plain version is in it (the kernel's yardstick on the card)
    assert _rel(pk.passB_sharded_plain(h, proj, yoff), ref64) <= TOL_3XTF32
