"""The redesigned channel stage kernel's host-side pieces, held on the CPU.

`channel_msd_3d` launches `csrc/channel.cu`'s `channel_msd_kernel` on the
card: 16 x 32 (y, z) tiles of 8 warps walking 16 x-planes (`CH_XB`), the
t/u and q planes and the pointwise streams staged by cp.async a plane
ahead, the rebuild formed once per staged element, the targets exchanged
through shared memory, every 1/dx a multiply by a host reciprocal.  The
kernel runs only on the card, where `chip_smoke.py` holds it against the
plain version in every mode.  Here:

- the reciprocals the host hands it (`channel_recips`) against the JAX
  package's metrics at float64, and the C entry's parameters against the
  wrapper's ctypes signature;
- its tile and shared-memory layout (`csrc/channel_geometry.cuh`, built
  by the host C++ compiler): the windows cover the stencil, every region
  is 16-byte aligned and disjoint, and every mode fits two blocks an SM;
- the plain version, which the kernel is held to on the card, against the
  JAX package's Pallas kernel in interpret mode on a ragged box (ny and
  nz no multiples of the tile) in the four modes of the hat chain.
"""

import ctypes
import functools
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ins_tpu as ins
from ins_tpu.ops import channel_kernels as jck
from ins_tpu.ops import channelpath as jcp

import ins_tpu_torch as it
from ins_tpu_torch import _build
from ins_tpu_torch.ops import channel_kernels as ck
from ins_tpu_torch.ops import channelpath as cp

TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the test lane runs several files side by
    side, and oversubscribed threads slow the interpret-mode kernels."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@functools.lru_cache(maxsize=None)
def _setups(box, lid=False):
    """The same channel in both packages: x/y periodic, z walls (a sliding
    top wall with `lid`), tanh-stretched z, Re = 700, f64."""
    nx, ny, nz = box
    x = (np.linspace(0.0, 4 * np.pi, nx + 1), np.linspace(0.0, 2 * np.pi, ny + 1),
         ins.tanh_grid(0.0, 2.0, nz, 1.3))
    top = (0.3, -0.2, 0.0) if lid else None

    def bcs(pkg):
        return ((pkg.PeriodicBC(), pkg.PeriodicBC()), (pkg.PeriodicBC(), pkg.PeriodicBC()),
                (pkg.DirichletBC(), pkg.DirichletBC(top)))

    jset = ins.Setup(x=x, boundary_conditions=bcs(ins), Re=700.0, dtype=jnp.float64)
    tset = it.Setup(x=x, boundary_conditions=bcs(it), Re=700.0, dtype=torch.float64,
                    device="cpu")
    return jset, tset


# --------------------------------------------------------------------------
# (a) the host reciprocals
# --------------------------------------------------------------------------


@pytest.mark.parametrize("box", [(12, 10, 8), (256, 128, 128), (48, 24, 40)])
def test_recips_match_jax_metrics(box):
    """(1/dx, 1/dy, 1/dx², 1/dy²) from the port's metrics against the
    JAX package's dx and dy, at float64; the z rows the kernel reads are
    the JAX vectors, packed in `pack_zmet`'s order."""
    jset, tset = _setups(box)
    jm, tm = jcp.make_channel_metrics(jset), cp.make_channel_metrics(tset)
    dx, dy = float(jm.dx), float(jm.dy)
    want = (1 / dx, 1 / dy, 1 / dx**2, 1 / dy**2)
    got = ck.channel_recips(tm)
    assert all(abs(g - w) <= 1e-15 * abs(w) for g, w in zip(got, want))
    # the float32 reciprocals the kernel multiplies by, within an ulp of
    # the float32 quotient it replaces
    for g, d, p in zip(got, (dx, dy, dx, dy), (1, 1, 2, 2)):
        assert abs(float(np.float32(g)) * d**p - 1.0) <= 2.0**-23
    ref = np.stack([np.asarray(getattr(jm, k)) for k in ck._ZVECS])
    assert _rel(tm.zmet.numpy(), ref) <= TOL and tm.zmet.shape == (12, box[2])


def test_entry_matches_its_ctypes_signature():
    """The C entry `ins_channel_msd_f32` takes the arguments the wrapper's
    ctypes signature passes, in order: 10 pointers, the box, visc, the
    four reciprocals, the walls, the dt-scaled coefficients, the two flags
    and the stream."""
    src = (_build.CSRC / "channel.cu").read_text()
    decl = re.search(r'extern "C" int ins_channel_msd_f32\(([^)]*)\)', src).group(1)
    kinds = {"ptr": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
    got = [kinds["ptr" if "*" in a else a.split()[0]] for a in decl.split(",")]
    assert got == _build._SIGNATURES["ins_channel_msd_f32"][0]
    assert got == [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_float] * 11 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]


# --------------------------------------------------------------------------
# (b) the tile and shared-memory layout
# --------------------------------------------------------------------------


_LAYOUT_MAIN = r"""
#include <cstdio>

#include "channel_geometry.cuh"

int main() {
    std::printf("%d %d %d %d %d %d %d %d %d %d %d %d %d %d\n", CH_TZ, CH_TY, CH_NT, CH_ZLO,
                CH_HY, CH_QY, CH_HZ, CH_RZ0, CH_RW, CH_UR, CH_QR, CH_SR, CH_VSZ,
                CH_SMEM_2BLOCKS);
    for (int m = 0; m < 16; ++m) {
        const ChannelLayout L = channel_layout(m & 1, m & 2, m & 4, m & 8);
        std::printf("%d %d %d %d %d %d %d %d %d %d %ld\n", L.q, L.met, L.t1, L.t2, L.streams,
                    L.base, L.acc, L.force, L.plane, L.total, channel_smem(L));
    }
    return 0;
}
"""


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """`csrc/channel_geometry.cuh` built by the host C++ compiler: the
    constants, then the layout of each (recon, base, acc, force)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/channel_geometry.cuh")
    d = tmp_path_factory.mktemp("channel_geometry")
    (d / "main.cpp").write_text(_LAYOUT_MAIN)
    subprocess.run([cxx, "-std=c++17", "-I", str(_build.CSRC), "-o", str(d / "layout"),
                    str(d / "main.cpp")], check=True, capture_output=True)
    out = subprocess.run([str(d / "layout")], check=True, capture_output=True,
                         text=True).stdout.splitlines()
    names = "tz ty nt zlo hy qy hz rz0 rw ur qr sr vsz smem2".split()
    consts = dict(zip(names, map(int, out[0].split())))
    modes = {}
    for m, line in enumerate(out[1:]):
        v = list(map(int, line.split()))
        modes[(bool(m & 1), bool(m & 2), bool(m & 4), bool(m & 8))] = dict(
            zip("q met t1 t2 streams base acc force plane total smem".split(), v))
    return consts, modes


def test_windows_cover_the_stencil(layout):
    """Each thread one z and RY rows; the u window reaches 2 rows below
    the tile and 1 above (the v target at y0 - 1 reads y0 - 2), the q
    window one row more (the rebuild's forward difference); the rebuilt
    columns z0 - 2 .. z0 + TZ lie inside the window with q at z + 1, and
    the window starts on a 16-byte chunk."""
    c, _ = layout
    assert c["nt"] == 32 * c["ty"] // 2 and c["tz"] == 32
    assert c["hy"] == c["ty"] + 3 and c["qy"] == c["hy"] + 1
    assert c["zlo"] % 4 == 0 and c["hz"] % 4 == 0
    assert c["rz0"] == c["zlo"] - 2 and c["rw"] == c["tz"] + 3
    assert c["rz0"] + c["rw"] + 1 <= c["hz"]  # q at z + 1 of the last rebuilt column
    assert c["vsz"] == 3 * c["ty"] * c["tz"] + c["tz"] + c["ty"]
    # the ring depths the phase schedule needs: u copied, rebuilt, read by
    # three planes; q read by two rebuilds while the next lands
    assert (c["ur"], c["qr"], c["sr"]) == (5, 3, 2)


@pytest.mark.parametrize("recon,base,acc,force", [
    (True, True, True, True), (True, False, False, True), (True, True, True, False),
    (True, False, False, False), (False, True, False, True), (False, True, True, False),
    (False, True, False, False), (False, False, False, False)])
def test_layout_fits_two_blocks_an_sm(layout, recon, base, acc, force):
    c, modes = layout
    L = modes[(recon, base, acc, force)]
    hw = c["hy"] * c["hz"]
    regions = [(0, c["ur"] * 3 * hw)]
    if recon:
        regions.append((L["q"], c["qr"] * c["qy"] * c["hz"]))
    else:
        assert L["q"] == -1
    regions += [(L["met"], 12 * c["hz"]), (L["t1"], (c["ty"] + 1) * c["tz"]),
                (L["t2"], c["ty"] * (c["tz"] + 1)), (L["streams"], c["sr"] * L["plane"])]
    regions.sort()
    for (a, n), (b, _) in zip(regions, regions[1:]):
        assert a + n <= b  # disjoint, in order
    assert regions[-1][0] + regions[-1][1] == L["total"]
    # 16-byte cp.async destinations: every region and staged stream on 4 floats
    offs = [o for o, _ in regions] + [L[k] for k in ("base", "acc", "force") if L[k] >= 0]
    assert all(o % 4 == 0 for o in offs) and L["plane"] % 4 == 0 and hw % 4 == 0
    present = [L[k] for k in ("base", "acc", "force") if L[k] >= 0]
    assert len(present) == base + acc + force and L["plane"] == c["vsz"] * len(present)
    assert L["smem"] == 4 * L["total"] <= c["smem2"]


# --------------------------------------------------------------------------
# (c) the plain version on ragged boxes against the JAX package
# --------------------------------------------------------------------------

# the hat chain's four modes: (ustart, acc, force, div_of_acc, emit_urec, cb)
HAT_MODES = {
    "stage 0: emit_urec": (False, False, True, False, True, 1 / 6),
    "stages 1-2": (True, True, True, False, False, 1 / 3),
    "stage 3: div_of_acc": (True, True, True, True, False, 1 / 6),
    "single stage": (False, False, False, True, False, 1.0),
}


@pytest.mark.parametrize("box", [(4, 18, 20)])
@pytest.mark.parametrize("mode", list(HAT_MODES))
def test_plain_matches_pallas_on_ragged_box(box, mode):
    has_us, has_acc, has_force, div_of_acc, emit_urec, cb = HAT_MODES[mode]
    jset, tset = _setups(box, lid=True)
    jm, tm = jcp.make_channel_metrics(jset), cp.make_channel_metrics(tset)
    rng = np.random.default_rng(sum(box) + len(mode))
    u, us0, acc0, force = (rng.standard_normal((3, *box)) for _ in range(4))
    for a in (u, us0, acc0, force):
        a[2, ..., -1] = 0.0
    q = 0.1 * rng.standard_normal(box)
    args = dict(visc=1 / 700, ca=0.0 if div_of_acc else 0.5, cb=cb, dt=1e-2,
                div_of_acc=div_of_acc, emit_urec=emit_urec)
    pick = [(us0, has_us), (acc0, has_acc)]
    ref = jck.channel_msd_3d(
        jnp.asarray(u), *(jnp.asarray(a) if on else None for a, on in pick), jm,
        force=jnp.asarray(force) if has_force else None, qrecon=jnp.asarray(q),
        interpret=True, **args,
    )
    got = ck.channel_msd_3d(
        torch.from_numpy(u), *(torch.from_numpy(a) if on else None for a, on in pick), tm,
        force=torch.from_numpy(force) if has_force else None, qrecon=torch.from_numpy(q),
        **args,
    )
    assert len(got) == len(ref) == (4 if emit_urec else 3)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            assert _rel(g.numpy(), r) <= TOL
