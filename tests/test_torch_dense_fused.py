"""The fused dense pass B (`csrc/fold.cu` with no fold level), held on the
CPU.

Where n % 4 != 0 the projection's pass B is dense.  On the card `passB`
and `passB_sharded` pick its route from n before any launch
(`poisson_kernels.dense_route`): up to `DENSE_FUSED_MAX_N` one launch of
`passb_fold_kernel<0, KS>` (a block's panel of columns with all n x-rows
in shared memory; g = Vinv h in 3xTF32 on the tensor cores with the
eigen-scale in its epilogue, then qhat = V g stored; the basis split on
the host, `pack_basis_a`, the panel in registers; chains of one stage's K
added to float32 sums), above it the GEMM route (x-product, eigen-scale,
x-product; launch keys ``+gemm``).  The kernel runs only on the card,
where `chip_smoke.py` holds it against the plain version in float64 and
in float32.  Here:

- the geometry the C entry picks (`csrc/fold_geometry.cuh`
  `dense_geometry`, built by the host C++ compiler) fits an H100 block
  and covers a product's n rows up to the gate, and refuses above
  n = 512;
- the launches each wrapper makes, through a stand-in library on meta
  tensors: one call of the fused entry with the right shape and y offset
  and the split basis pair below the gate, no plane GEMM or eigen-scale;
  the GEMM route above it; a refused launch raises;
- the kernel's arithmetic emulated in its order against the float64
  plain version and the JAX package's pass B (`make_fused_projection`,
  `make_passB_sharded`; interpret mode, Precision.HIGHEST) at n % 4 != 0,
  on cubes and on a shard at a nonzero y offset.
"""

import contextlib
import ctypes
import re
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
from ins_tpu_torch.ops import transforms
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


def _proj(n, ly, dtype=torch.float32):
    """The fused projection (ly = n) or a shard's (ly < n); dense at
    n % 4 != 0; in the 3xTF32 form ("highest")."""
    dxs = _dxs(n)
    proj = (pk.make_fused_projection((n,) * 3, dxs, dtype, precision="highest", device="cpu")
            if ly == n else pk.make_passB_sharded((n,) * 3, dxs, dtype, ly, precision="highest",
                                                  device="cpu"))
    assert proj["fold_levels"] is None
    return proj


# --------------------------------------------------------------------------
# (a) the geometry and the route
# --------------------------------------------------------------------------

_GEOMETRY_MAIN = r"""
#include <cstdio>
#include <cstdlib>

#include "fold_geometry.cuh"

int main(int argc, char** argv) {
    for (int i = 1; i < argc; ++i) {
        const FoldGeometry g = dense_geometry(std::atoi(argv[i]));
        std::printf("%d %d %zu\n", g.nc, g.ks, g.smem);
    }
    return 0;
}
"""


@pytest.fixture(scope="module")
def geometry(tmp_path_factory):
    """`dense_geometry(n)` of `csrc/fold_geometry.cuh`, the C entry's own
    choice, built by the host C++ compiler: n -> (nc, ks, smem bytes)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/fold_geometry.cuh")
    d = tmp_path_factory.mktemp("dense_geometry")
    (d / "main.cpp").write_text(_GEOMETRY_MAIN)
    subprocess.run([cxx, "-std=c++17", "-I", str(_build.CSRC), "-o", str(d / "geometry"),
                    str(d / "main.cpp")], check=True, capture_output=True)

    def pick(n):
        out = subprocess.run([str(d / "geometry"), str(n)], check=True, capture_output=True,
                             text=True).stdout
        return tuple(int(v) for v in out.split())

    return pick


# sizes up to the kernel's reach (n = 512), the chip's dense cases (250,
# 256 forced, 382, 510) among them; the geometry depends on n alone
GEOMETRY_NS = [1, 2, 10, 18, 50, 64, 66, 100, 128, 130, 250, 254, 256, 258, 382, 510, 511, 512]
# (nc, ks) of the chip's cases
CHIP_GEOMETRY = {250: (64, 4), 256: (64, 4), 382: (32, 2), 510: (32, 2)}


@pytest.mark.parametrize("n", GEOMETRY_NS)
def test_geometry_fits_a_block(geometry, n):
    """The launch fits an H100 block's 227 KB and holds what the kernel
    touches (the panel's n rows and a zero tail to the stage's K, rows
    nc + 8 floats apart; two stages of the product's m16 tiles; the
    eigenvalue tables); the warps (64 rows each, nc / 32 across) cover a
    product's n rows in one pass; a stage is one chain of at most 32 of
    K."""
    nc, ks, smem = geometry(n)
    assert nc in (32, 64, 128, 256) and 64 * 256 // nc >= n
    assert ks in (2, 4)  # the entry instantiates these two
    assert smem <= 232448
    tail = -(-n // (8 * ks)) * 8 * ks - n
    touched = (n + tail) * (nc + 8) + 2 * -(-n // 16) * ks * 256 + n // 2 + 1 + 2 * nc
    assert smem >= 4 * touched
    assert (nc + 8) % 32 == 8  # B fragment loads: 32 lanes, 32 banks
    assert CHIP_GEOMETRY.get(n, (nc, ks)) == (nc, ks)


@pytest.mark.parametrize("n", [513, 514, 766, 1000, 1022])
def test_geometry_refuses(geometry, n):
    """Above n = 512 no panel whose warps cover n product rows fits: the
    entry refuses."""
    assert geometry(n) == (0, 0, 0)


ROUTES = [(2, "fused"), (10, "fused"), (250, "fused"), (254, "fused"), (256, "fused"),
          (258, "gemm"), (382, "gemm"), (510, "gemm"), (514, "gemm"), (1022, "gemm"),
          (2046, "gemm")]


@pytest.mark.parametrize("n,route", ROUTES)
def test_route_for_n(n, route):
    assert pk.dense_route(n) == route


def test_gate_is_inside_the_fused_kernels_range(geometry):
    """The gate lies where the fused kernel has a geometry (n <= 512) and
    splits the routes."""
    g = pk.DENSE_FUSED_MAX_N
    assert 250 <= g <= 512 and geometry(g)[0] > 0
    assert pk.dense_route(g) == "fused" and pk.dense_route(g + 1) == "gemm"


def test_c_entry_matches_its_signature():
    """`ins_passb_dense_f32`'s parameters, in order, are its ctypes
    signature."""
    src = (_build.CSRC / "fold.cu").read_text()
    decl = re.search(r'extern "C" int ins_passb_dense_f32\(([^)]*)\)', src).group(1)
    args = [a.strip() for a in decl.split(",")]
    kinds = {"ptr": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
    got = [kinds["ptr" if "*" in a else a.split()[0]] for a in args]
    assert got == _build._SIGNATURES["ins_passb_dense_f32"][0]
    assert [a.split()[-1].lstrip("*") for a in args] == [
        "h", "out", "vinv", "v", "n", "ly", "yoff", "dx0", "dx1", "dx2", "vol", "eps", "stream"]


# --------------------------------------------------------------------------
# (b) the launches the wrappers make, through a stand-in library
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
    """Meta tensors take the wrappers' card branch (the pass B wrappers'
    and the plane transform's); the library, the device checks, the
    stream and the basis split (each matrix a stand-in with a pointer of
    its own) are stood in for."""
    lib = _FakeLib()
    splits = {}

    def check(name, dtypes, **operands):
        for t, shape, *_ in operands.values():
            assert t is None or (t.dtype in dtypes and tuple(t.shape) == tuple(shape))
        return torch.device("meta")

    def check_operands(name, n, **operands):
        for t, kind in operands.values():
            assert t.dtype == torch.float32 and t.shape[-1] == n
        return torch.device("meta")

    def split_basis(w, side, precision="highest"):
        splits.setdefault(id(w), (side, 0x1000 * (len(splits) + 1)))
        return types.SimpleNamespace(data_ptr=lambda: splits[id(w)][1])

    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(pk, "check_cuda_operands", check_operands)
    for mod in (pk, transforms):
        monkeypatch.setattr(mod, "check_cuda_tensors", check)
        monkeypatch.setattr(mod, "current_stream", lambda device: 0)
        monkeypatch.setattr(mod, "split_basis", split_basis)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    launches.reset_counts()
    lib.splits = splits
    yield lib
    launches.reset_counts()


def _call(n, ly, yoff):
    """The wrapper's call on a meta h: (projection, output, launch key)."""
    proj = _proj(n, ly)
    h = torch.empty((n, ly, n), dtype=torch.float32, device="meta")
    if ly == n:
        return proj, pk.passB(h, proj), "passB"
    return proj, pk.passB_sharded(h, proj, yoff), "passB_sharded"


# (n, ly, yoff): the chip's cube 250³ and its 2-way shard at yoff 125,
# small and odd cubes, a 3-way shard of 18³, the largest n the kernel takes
LAUNCH_CASES = [(250, 250, 0), (250, 125, 125), (10, 10, 0), (25, 25, 0), (18, 6, 12),
                (510, 510, 0)]


@pytest.mark.parametrize("n,ly,yoff", LAUNCH_CASES)
def test_one_fused_launch(fake_card, monkeypatch, n, ly, yoff):
    """One launch of the fused entry, with the gate raised where n lies
    above it (the kernel takes any n up to 512)."""
    monkeypatch.setattr(pk, "DENSE_FUSED_MAX_N", max(pk.DENSE_FUSED_MAX_N, n))
    proj, out, key = _call(n, ly, yoff)
    assert out.shape == (n, ly, n) and out.dtype == torch.float32
    (name, args), = fake_card.calls
    assert name == "ins_passb_dense_f32"
    assert fake_card.splits[id(proj["Vinv"])][0] == fake_card.splits[id(proj["V"])][0] == "a"
    assert args[2:4] == (fake_card.splits[id(proj["Vinv"])][1], fake_card.splits[id(proj["V"])][1])
    assert args[4:7] == (n, ly, yoff)
    assert args[7:12] == (*proj["dxs"], proj["vol"], proj["eps"])
    assert len(args) == len(_build._SIGNATURES[name][0])
    assert launches.LAUNCHES[key] == 1
    assert sum(launches.LAUNCHES.values()) == 1 and not any(launches.PLAIN_ON_CUDA.values())


@pytest.mark.parametrize("n,ly,yoff", [(250, 250, 0), (250, 125, 125), (18, 6, 12)])
def test_gemm_route_above_the_gate(fake_card, monkeypatch, n, ly, yoff):
    """With the gate below n the wrappers run the GEMM route: x-product,
    eigen-scale (kmul 1, even rows, the y offset), x-product, under the
    ``+gemm`` key, and no fused launch."""
    monkeypatch.setattr(pk, "DENSE_FUSED_MAX_N", n - 1)
    _, out, key = _call(n, ly, yoff)
    assert out.shape == (n, ly, n)
    assert [name for name, _ in fake_card.calls] == [
        "ins_plane_gemm_tf32", "ins_eigen_scale_f32", "ins_plane_gemm_tf32"]
    assert fake_card.calls[1][1][1:7] == (n, n, ly, yoff, 1, 0)
    assert launches.LAUNCHES[key + "+gemm"] == 1 and launches.LAUNCHES[key] == 0
    assert launches.LAUNCHES["plane_transform"] == 2
    assert sum(launches.LAUNCHES.values()) == 3


@pytest.mark.parametrize("n,ly,yoff", [(250, 250, 0), (250, 125, 125)])
def test_refused_launch_raises(fake_card, n, ly, yoff):
    """A launch the entry refuses (cudaErrorInvalidValue) raises and counts
    no launch."""
    fake_card.status = 1
    with pytest.raises(RuntimeError, match="invalid argument"):
        _call(n, ly, yoff)
    assert len(fake_card.calls) == 1 and not any(launches.LAUNCHES.values())


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


def _emulated(h, proj, yoff, bk, passes=3):
    """The kernel's qhat in its order on an (n, ly, n) float32 h: g = Vinv
    h, scaled in its epilogue by 1 / den (den = vol·((λx + λy) + λz) in
    float32 as the kernel forms it, 0 where |den| < eps), then V g."""
    n, ly = h.shape[0], h.shape[1]
    g = _product(proj["Vinv"], h.reshape(n, ly * n), bk, passes)
    dx0, dx1, dx2 = (np.float32(d) for d in proj["dxs"])
    col = np.arange(ly * n)
    y, z = col // n, col % n
    lyz = (_lam((y + yoff + 1) // 2, n, dx1), _lam((z + 1) // 2, n, dx2))
    den = np.float32(proj["vol"]) * ((_lam((np.arange(n) + 1) // 2, n, dx0)[:, None]
                                      + lyz[0][None]) + lyz[1][None])
    inv = np.where(np.abs(den) < proj["eps"], np.float32(0),
                   np.float32(1) / np.where(den == 0, np.float32(1), den))
    g = g * torch.from_numpy(inv.astype(np.float32))
    return _product(proj["V"], g, bk, passes).reshape(n, ly, n)


# (n, ly, yoff, bk): cubes at n % 4 == 2 and odd n, the 32-K chains the
# kernel sums up to n = 256, the 16-K chains above; a 3-way shard at
# yoff 12 and a 2-way one at yoff 13 (n = 26), and 8-K chains (three a
# product at n = 18)
ARITH_CASES = [(10, 10, 0, 32), (18, 18, 0, 32), (18, 6, 12, 32), (26, 13, 13, 16),
               (18, 18, 0, 8), (25, 25, 0, 16)]


@pytest.mark.parametrize("n,ly,yoff,bk", ARITH_CASES)
def test_emulated_kernel_is_float32_class(n, ly, yoff, bk):
    h64 = np.random.default_rng(n + ly + bk).standard_normal((n, ly, n))
    h = torch.from_numpy(h64.astype(np.float32))
    proj = _proj(n, ly)
    got = _emulated(h, proj, yoff, bk)
    # the plain version in float64 (the float64 eigenbasis)
    ref64 = pk.passB_sharded_plain(h.double(), _proj(n, ly, torch.float64), yoff)
    # the JAX package's dense pass B, interpret mode, Precision.HIGHEST, float64
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
