"""The folded pass B's two routes on the card, held on the CPU.

`passB_fold` and `passB_sharded` (n % 4 == 0) pick their route from n
before any launch (`poisson_kernels.fold_route`): up to
`FOLD_FUSED_MAX_N` one launch of the fused kernel (`csrc/fold.cu`, held
in `tests/test_torch_fold_fused.py`), above it the level route: the
recursion `_fold_levels` of x-products (the plane GEMM) around the split,
eigen-scale and combine kernels of `csrc/poisson.cu`, which has no size
limit.  Here:

- the route for a table of n, and the gate where the fused kernel still
  has a geometry;
- the level route run on the CPU, where each of its pieces runs its plain
  version, against the JAX package's folded pass B in interpret mode at
  float64 (cube and shard, one and two levels, a nonzero y offset), with
  the gate forced low so that the wrappers' own dispatch takes it;
- the launches the wrappers make above the gate, through a stand-in
  library on meta tensors: split, x-products, eigen-scale (kmul, odd,
  y offset), recursion and combine in order, under the launch keys
  ``passB_fold+levels`` and ``passB_sharded+levels``.
"""

import contextlib
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

TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the test lane runs several files side by
    side, and oversubscribed threads slow small float64 products."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _dxs(n):
    return (2 * np.pi / n, 2 * np.pi / n, np.pi / n)


def _proj(n, levels, ly, dtype=torch.float64, device="cpu"):
    """The projection in the 3xTF32 form ("highest"; float64 is exact
    under either name)."""
    dxs = _dxs(n)
    proj = (pk.make_fused_projection((n,) * 3, dxs, dtype, precision="highest", device=device)
            if ly == n else pk.make_passB_sharded((n,) * 3, dxs, dtype, ly, precision="highest",
                                                  device=device))
    if levels != proj["fold_levels"]:
        mats, _, _ = pk.poisson_fold_consts((n,) * 3, dxs, dtype, levels=levels, device=device)
        proj = dict(proj, fold_mats=mats, fold_levels=levels)
    return proj


# --------------------------------------------------------------------------
# (a) the route for n
# --------------------------------------------------------------------------


ROUTES = [(4, "fused"), (64, "fused"), (100, "fused"), (256, "fused"), (512, "fused"),
          (516, "levels"), (768, "levels"), (1024, "levels"), (1152, "levels"),
          (2048, "levels"), (4096, "levels")]


@pytest.mark.parametrize("n,route", ROUTES)
def test_route_for_n(n, route):
    assert pk.fold_route(n) == route


def test_gate_is_inside_the_fused_kernels_range():
    """The gate lies where the fused kernel has a geometry (n <= 1024,
    `fold_geometry.cuh`), on a multiple of 4, and splits the routes."""
    g = pk.FOLD_FUSED_MAX_N
    assert g % 4 == 0 and 256 <= g <= 1024
    assert pk.fold_route(g) == "fused" and pk.fold_route(g + 4) == "levels"


# --------------------------------------------------------------------------
# (b) the level route on the CPU against the JAX package
# --------------------------------------------------------------------------


def _jax_passB(h, n, ly, yoff):
    """The JAX package's folded pass B (its default level count; every
    level count solves the same system) on an (n, ly, n) float64 h,
    interpret mode, Precision.HIGHEST."""
    if ly == n:
        jproj = jpp.make_fused_projection((n,) * 3, _dxs(n), jnp.float64, precision="highest",
                                          interpret=True)
        return np.asarray(jproj["passB"](jnp.asarray(h)))
    jproj = jpp.make_passB_sharded((n,) * 3, _dxs(n), jnp.float64, ly, precision="highest",
                                   interpret=True)
    return np.asarray(jproj["passB"](jnp.asarray(h), yoff))


# (n, levels, ly, yoff): cubes at one and two levels, shards of 32³ at
# nonzero y offsets at one and two levels
LEVEL_CASES = [(16, 1, 16, 0), (32, 2, 32, 0), (32, 1, 8, 8), (32, 2, 8, 16), (16, 1, 4, 12)]


@pytest.mark.parametrize("n,levels,ly,yoff", LEVEL_CASES)
def test_level_route_matches_jax(monkeypatch, n, levels, ly, yoff):
    monkeypatch.setattr(pk, "FOLD_FUSED_MAX_N", 0)  # every n takes the level route
    h = np.random.default_rng(n + ly + levels).standard_normal((n, ly, n))
    proj = _proj(n, levels, ly)
    got, route = pk._fold_run(torch.from_numpy(h), proj, yoff, ly)
    assert route == "+levels"
    ref = _jax_passB(h, n, ly, yoff)
    assert _rel(got.numpy(), ref) <= TOL
    # and the plain recursion, the kernels' yardstick on the card
    assert _rel(got.numpy(), pk._fold_plain(torch.from_numpy(h), proj, 0, 1, yoff).numpy()) \
        <= TOL


@pytest.mark.parametrize("kmul,odd", [(1, False), (2, False), (1, True), (4, True)])
def test_eigen_scale_rows(kmul, odd):
    """The eigen-scale's row -> x-frequency map (kmul ceil(r/2), or kmul
    (2 floor(r/2) + 1) on an odd half) at a y offset, against the
    closed form in numpy."""
    n, nr, ly, yoff = 16, 8, 4, 6
    proj = _proj(n, 1, n)
    g = np.random.default_rng(kmul).standard_normal((nr, ly, n))
    got = pk._eigen_scale(torch.from_numpy(g), kmul, odd, proj, yoff).numpy()
    r = np.arange(nr)
    kx = kmul * (2 * (r // 2) + 1 if odd else (r + 1) // 2)

    def lam(k, dx):
        return -4.0 * np.sin(np.pi * k / n) ** 2 / dx**2

    dx0, dx1, dx2 = proj["dxs"]
    y, z = np.arange(yoff, yoff + ly), np.arange(n)
    den = proj["vol"] * (lam(kx, dx0)[:, None, None] + lam((y + 1) // 2, dx1)[None, :, None]
                         + lam((z + 1) // 2, dx2)[None, None, :])
    inv = np.where(np.abs(den) < proj["eps"], 0.0, 1.0 / np.where(den == 0, 1.0, den))
    assert _rel(got, g * inv) <= TOL


def test_split_and_combine_invert():
    """combine(split) on the CPU: [e/2 + o/2; e/2 − o/2] gives h back
    (the combine halves qe), exactly for these binary fractions."""
    h = torch.arange(2 * 3 * 4 * 4, dtype=torch.float64).reshape(6, 4, 4) / 8
    e, o = pk._fold_split(h)
    assert torch.equal(e, h[:3] + h[3:]) and torch.equal(o, h[:3] - h[3:])
    assert torch.equal(pk._fold_combine(e, 0.5 * o), h)


# --------------------------------------------------------------------------
# (c) the launches above the gate, through a stand-in library
# --------------------------------------------------------------------------


class _FakeLib:
    """Stands in for the kernel library: records each entry point called
    with its arguments and returns 0."""

    def __init__(self):
        self.calls = []

    def ins_error_string(self, err):
        return b"invalid argument"

    def __getattr__(self, name):
        if not name.startswith("ins_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


@pytest.fixture
def fake_card(monkeypatch):
    """Meta tensors take the wrappers' card branch (the pass B wrappers'
    and the plane transform's); the library, the device checks, the
    stream and the basis split are stood in for."""
    lib = _FakeLib()

    def check(name, dtypes, **operands):
        for t, shape, *_ in operands.values():
            assert t is None or (t.dtype in dtypes and tuple(t.shape) == tuple(shape))
        return torch.device("meta")

    split = types.SimpleNamespace(data_ptr=lambda: 0x1000)
    monkeypatch.setattr(_build, "load", lambda: lib)
    for mod in (pk, transforms):
        monkeypatch.setattr(mod, "check_cuda_tensors", check)
        monkeypatch.setattr(mod, "current_stream", lambda device: 0)
        monkeypatch.setattr(mod, "split_basis", lambda w, side, precision="highest": split)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    launches.reset_counts()
    yield lib
    launches.reset_counts()


def _expected(n, ly, yoff, levels):
    """The level route's entry calls in order: (name, key arguments)."""
    calls, nn, kmul = [], n, 1
    for _ in range(levels):
        half = nn // 2 * ly * n
        calls += [("ins_fold_split_f32", half),
                  ("ins_plane_gemm_tf32", (nn // 2, ly * n, nn // 2)),
                  ("ins_eigen_scale_f32", (nn // 2, n, ly, yoff, kmul, 1)),
                  ("ins_plane_gemm_tf32", (nn // 2, ly * n, nn // 2))]
        nn, kmul = nn // 2, 2 * kmul
    calls += [("ins_plane_gemm_tf32", (nn, ly * n, nn)),
              ("ins_eigen_scale_f32", (nn, n, ly, yoff, kmul, 0)),
              ("ins_plane_gemm_tf32", (nn, ly * n, nn))]
    nn = n >> levels
    for _ in range(levels):
        calls.append(("ins_fold_combine_f32", nn * ly * n))
        nn *= 2
    return calls


def _key_args(name, args):
    if name in ("ins_fold_split_f32", "ins_fold_combine_f32"):
        return args[3]
    if name == "ins_plane_gemm_tf32":
        return args[5:8]  # M, N, K
    return args[1:7]  # nr, n, ly, yoff, kmul, odd


# (n, levels, ly, yoff): the 1152³ cube (two levels, leaf 288), 4-way
# shards of 2048³ and 1024³, and a cube just above the gate
ABOVE_GATE = [(1152, 2, 1152, 0), (2048, 2, 512, 1536), (1024, 2, 256, 512),
              (1024, 1, 256, 0), (516, 1, 516, 0)]


@pytest.mark.parametrize("n,levels,ly,yoff", ABOVE_GATE)
def test_level_route_launches(fake_card, n, levels, ly, yoff):
    proj = _proj(n, levels, ly, torch.float32)
    h = torch.empty((n, ly, n), dtype=torch.float32, device="meta")
    if ly == n:
        out, key = pk.passB_fold(h, proj), "passB_fold+levels"
    else:
        out, key = pk.passB_sharded(h, proj, yoff), "passB_sharded+levels"
    assert out.shape == (n, ly, n) and out.dtype == torch.float32
    got = [(name, _key_args(name, args)) for name, args in fake_card.calls]
    assert got == _expected(n, ly, yoff, levels)
    for name, args in fake_card.calls:
        assert len(args) == len(_build._SIGNATURES[name][0])
    assert "ins_passb_fold_f32" not in {name for name, _ in fake_card.calls}
    assert launches.LAUNCHES[key] == 1
    assert launches.LAUNCHES["plane_transform"] == 2 * levels + 2
    assert sum(launches.LAUNCHES.values()) == 2 * levels + 3
    assert not any(launches.PLAIN_ON_CUDA.values())


@pytest.mark.parametrize("n,ly,yoff", [(256, 256, 0), (256, 64, 64), (512, 512, 0)])
def test_fused_at_and_below_the_gate(fake_card, n, ly, yoff):
    """256³, the 4-way 256³ shard and the gate itself take one fused
    launch and nothing else."""
    proj = _proj(n, pk.fold_levels_default(n), ly, torch.float32)
    h = torch.empty((n, ly, n), dtype=torch.float32, device="meta")
    key = "passB_fold" if ly == n else "passB_sharded"
    if ly == n:
        pk.passB_fold(h, proj)
    else:
        pk.passB_sharded(h, proj, yoff)
    assert [name for name, _ in fake_card.calls] == ["ins_passb_fold_f32"]
    assert launches.LAUNCHES[key] == 1 and sum(launches.LAUNCHES.values()) == 1
