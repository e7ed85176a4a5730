"""The redesigned per-op conv-diff kernel's host-side pieces, held on the CPU.

`convdiff_interior_3d` launches `csrc/perop.cu`'s `convdiff_kernel` on the
card: 16 x 32 (y, z) tiles of 8 warps walking `CD_XB` x-planes, the three
components of u staged by cp.async a plane ahead into a ring of three
slots, each face flux phi_ab = uab2·uba2 formed once a cell (the lower
face's from the previous plane's registers, the previous row or the next
lane down), every 1/dx and visc/dx² a multiply by a host reciprocal.  The
kernel runs only on the card, where `chip_smoke.py` holds it against the
plain version in float64.  Here:

- its tile and window (`csrc/perop_geometry.cuh`, built by the host C++
  compiler): the window covers every read of the stencil and the halo
  fluxes, a window element read through `cd_elem` is the wrapped cell of
  the box on ragged boxes, its 16-byte regions are aligned, and the ring
  fits the blocks an SM the launch bounds ask for;
- the C entry's parameters against the wrapper's ctypes signature, and
  the reciprocals the host hands it;
- the kernel's order of arithmetic (each face flux once, the reciprocals)
  emulated in torch and held against the JAX kernel in interpret mode at
  float64, on ragged boxes with nz % 4 != 0, and against the plain version.
"""

import ctypes
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ins_tpu.ops import pallas_kernels as jpk

from ins_tpu_torch import _build
from ins_tpu_torch.ops import launches
from ins_tpu_torch.ops import perop_kernels as pk

TOL = 1e-12
VISC = 1e-2
# ragged boxes: ny no multiple of the 16-row tile, nz % 4 != 0 (the
# kernel's 4-byte staging) or nz % 4 == 0 with nz below the tile
BOXES = [(6, 19, 13), (5, 7, 21), (4, 18, 20), (3, 33, 1)]


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


def _dxs(box):
    return tuple(2 * np.pi / n for n in box)


# --------------------------------------------------------------------------
# (a) the tile, the window and the ring
# --------------------------------------------------------------------------

_GEOMETRY_MAIN = r"""
#include <cstdio>

#include "perop_geometry.cuh"

int main() {
    std::printf("%d %d %d %d %d %d %d %d %d %d %d %d %d\n", CD_TZ, CD_RY, CD_NW, CD_TY, CD_NT,
                CD_XB, CD_ZLO, CD_HY, CD_HZ, CD_HW, CD_PL, CD_RING, CD_SMEM);
    std::printf("%d\n", CD_SM_BLOCKS);
    for (int ty = -1; ty <= CD_TY; ++ty)
        for (int tz = -1; tz <= CD_TZ; ++tz) std::printf("%d ", cd_elem(ty, tz, 0, 0));
    std::printf("\n");
    return 0;
}
"""


@pytest.fixture(scope="module")
def geometry(tmp_path_factory):
    """`csrc/perop_geometry.cuh` built by the host C++ compiler: its
    constants and `cd_elem` of every tile cell and halo cell."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/perop_geometry.cuh")
    d = tmp_path_factory.mktemp("perop_geometry")
    (d / "main.cpp").write_text(_GEOMETRY_MAIN)
    subprocess.run([cxx, "-std=c++17", "-I", str(_build.CSRC), "-o", str(d / "geometry"),
                    str(d / "main.cpp")], check=True, capture_output=True)
    out = subprocess.run([str(d / "geometry")], check=True, capture_output=True,
                         text=True).stdout.splitlines()
    names = "tz ry nw ty nt xb zlo hy hz hw pl ring smem".split()
    c = dict(zip(names, map(int, out[0].split())))
    c["sm_blocks"] = int(out[1])
    elem = np.array(list(map(int, out[2].split()))).reshape(c["ty"] + 2, c["tz"] + 2)
    return c, elem  # elem[ty + 1, tz + 1] = cd_elem(ty, tz, 0, 0)


def test_tile_and_threads(geometry):
    """Each thread one z and RY rows: a warp's lanes span the tile's z, the
    warps stack in y; the tile is 16 x 32 and a block walks CD_XB planes."""
    c, _ = geometry
    assert c["tz"] == 32 and c["ty"] == c["ry"] * c["nw"] == 16
    assert c["nt"] == 32 * c["nw"] == 256
    assert c["xb"] >= 1 and c["ring"] == 3


def test_window_covers_the_stencil(geometry):
    """Every read lies in the window: a tile cell's u(c, I + (0|1, oy, oz))
    with |oy|, |oz| <= 1, the row below the tile (the lower y-face fluxes
    of each warp's first row read it and the row above) and the column
    before it (the lower z-face fluxes of lane 0, which read it and the
    column after, and the next row for phi_12)."""
    c, elem = geometry
    hy, hz = c["hy"], c["hz"]
    assert hy == c["ty"] + 2 and hz == c["tz"] + 2 * c["zlo"]
    rows, cols = np.divmod(elem, hz)
    # cd_elem(ty, tz) is window row ty + 1, column tz + zlo: rows -1 .. TY,
    # columns -1 .. TZ all inside the window
    assert rows.min() == 0 and rows.max() == hy - 1
    assert cols.min() >= 0 and cols.max() < hz
    assert np.array_equal(rows[:, 0], np.arange(hy))
    assert np.array_equal(cols[0], np.arange(c["zlo"] - 1, c["zlo"] + c["tz"] + 1))


def test_regions_are_aligned_and_fit(geometry):
    """16-byte copies: the window starts on a chunk (zlo % 4 == 0) and is a
    whole number of chunks wide; each component's window and each slot
    start on 16 bytes; the ring is static shared memory (<= 48 KB) and
    fits the blocks an SM the launch bounds ask for."""
    c, _ = geometry
    assert c["zlo"] % 4 == 0 and c["hz"] % 4 == 0
    assert c["hw"] == c["hy"] * c["hz"] and c["hw"] % 4 == 0
    assert c["pl"] == 3 * c["hw"] and c["pl"] % 4 == 0
    assert c["smem"] == 4 * c["ring"] * c["pl"] <= 48 * 1024
    assert c["sm_blocks"] * (c["smem"] + 1024) <= 228 * 1024
    # three blocks an SM of 256 threads leave 85 registers a thread (ptxas
    # gave the kernel 70-72)
    assert 65536 // (c["sm_blocks"] * c["nt"]) >= 72


def _window(u, y0, z0, c):
    """The staged window of one plane, as the wrapped offsets of
    `Window`/`Window4` (ring.cuh) lay it out: rows y0 - 1 .., columns
    z0 - zlo .., each wrapped onto the box."""
    ny, nz = u.shape
    ys = (y0 - 1 + np.arange(c["hy"])) % ny
    zs = (z0 - c["zlo"] + np.arange(c["hz"])) % nz
    return u[np.ix_(ys, zs)].reshape(-1)


@pytest.mark.parametrize("ny,nz", [(19, 13), (7, 21), (40, 72), (3, 1)])
def test_window_reads_are_the_wrapped_cells(geometry, ny, nz):
    """On ragged planes a read through `cd_elem` of every block's window is
    the cell (y + oy, z + oz) of the box, wrapped: the tile's cells, the
    halo row below and the halo column before it."""
    c, elem = geometry
    u = np.arange(ny * nz, dtype=np.int64).reshape(ny, nz)
    for y0 in range(0, ny, c["ty"]):
        for z0 in range(0, nz, c["tz"]):
            w = _window(u, y0, z0, c)
            for ty in range(-1, c["ty"]):
                for tz in range(-1, c["tz"]):
                    for oy, oz in ((0, 0), (1, 0), (0, 1), (1, 1), (-1, 0), (0, -1)):
                        if (ty < 0 and oy < 0) or (tz < 0 and oz < 0):
                            continue  # the halo cells read only upwards
                        e = elem[ty + 1, tz + 1] + oy * c["hz"] + oz
                        want = u[(y0 + ty + oy) % ny, (z0 + tz + oz) % nz]
                        assert w[e] == want


def test_blocks_at_the_main_path_size(geometry):
    """At 128³: 4 x 8 tiles a plane and ceil(128 / CD_XB) runs, one wave
    at three blocks an SM (what the kernel's 70-72 registers and its ring
    leave room for) on the H100's 132 SMs."""
    c, _ = geometry
    n = 128
    blocks = -(-n // c["tz"]) * -(-n // c["ty"]) * -(-n // c["xb"])
    assert blocks == 32 * -(-n // c["xb"]) <= c["sm_blocks"] * 132


# --------------------------------------------------------------------------
# (b) the C entry and the reciprocals
# --------------------------------------------------------------------------


def test_entry_matches_its_ctypes_signature():
    """`ins_convdiff_f32` takes u, f, the box, the three 1/dx, the three
    visc/dx² and the stream: the wrapper's ctypes signature, in order."""
    src = (_build.CSRC / "perop.cu").read_text()
    decl = re.search(r'extern "C" int ins_convdiff_f32\(([^)]*)\)', src).group(1)
    kinds = {"ptr": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
    got = [kinds["ptr" if "*" in a else a.split()[0]] for a in decl.split(",")]
    assert got == _build._SIGNATURES["ins_convdiff_f32"][0]
    assert got == [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_float] * 6 + [
        ctypes.c_void_p]
    assert [a.split()[-1] for a in decl.split(",")][5:11] == [
        "rdx0", "rdx1", "rdx2", "cd0", "cd1", "cd2"]


@pytest.mark.parametrize("visc,dx", [(1 / 2000, (1 / 128,) * 3), (VISC, (0.3, 0.2, 0.1)),
                                     (1 / 4000, _dxs((61, 101, 107)))])
def test_recips(visc, dx):
    """(1/dx_b, visc/dx_b²) in float64; rounded to float32 (as ctypes hands
    them over) each within an ulp of the float32 quotient it replaces."""
    got = pk.convdiff_recips(visc, dx)
    want = tuple(1 / d for d in dx) + tuple(visc / d**2 for d in dx)
    assert all(abs(g - w) <= 1e-15 * abs(w) for g, w in zip(got, want))
    for g, w in zip(got, want):
        g32, w32 = np.float32(g), np.float32(w)
        assert abs(float(g32) - float(w32)) <= float(np.spacing(w32))


# --------------------------------------------------------------------------
# (c) the kernel's order of arithmetic against the JAX kernel
# --------------------------------------------------------------------------


def _flux_once(u, visc, dx):
    """`convdiff_kernel`'s sum: per component a and direction b the
    upper-face flux phi_ab = uab2·uba2 once a cell, its lower face the
    neighbour's phi_ab(I − e_b), f_a = Σ_b (cd_b (u_a(I+e_b) − 2u_a +
    u_a(I−e_b)) − (phi_ab − phi_ab(I − e_b))·rdx_b) with the host's
    reciprocals."""
    rc = pk.convdiff_recips(visc, dx)
    rdx, cd = rc[:3], rc[3:]

    def up(v, b):
        return torch.roll(v, -1, b)

    def down(v, b):
        return torch.roll(v, 1, b)

    out = []
    for a in range(3):
        ua = u[a]
        f = torch.zeros_like(ua)
        for b in range(3):
            uab = 0.5 * (ua + up(ua, b))
            uba = uab if a == b else 0.5 * (u[b] + up(u[b], a))
            phi = uab * uba
            fd = cd[b] * (up(ua, b) - 2.0 * ua + down(ua, b))
            f = f + (fd - (phi - down(phi, b)) * rdx[b])
        out.append(f)
    return torch.stack(out)


@pytest.mark.parametrize("box", BOXES)
def test_flux_once_matches_pallas(box):
    """The emulated kernel order at float64 against the JAX kernel in
    interpret mode and against the plain version (the card's reference):
    the flux identity and the reciprocals change only rounding."""
    rng = np.random.default_rng(sum(box))
    u = rng.standard_normal((3, *box))
    dx = _dxs(box)
    ref = np.asarray(jpk.convdiff_interior_3d(jnp.asarray(u), VISC, dx, interpret=True))
    got = _flux_once(torch.from_numpy(u), VISC, dx)
    assert _rel(got.numpy(), ref) < TOL
    plain = pk.convdiff_interior_3d_plain(torch.from_numpy(u), VISC, dx)
    assert _rel(got.numpy(), plain.numpy()) < TOL


def test_flux_once_in_float32_is_within_the_cards_bound():
    """In float32 the emulated order stays within the 1e-4 the card's
    check allows of the float64 plain version (it is ~1e-7 off)."""
    box = (6, 19, 13)
    u = torch.from_numpy(np.random.default_rng(5).standard_normal((3, *box)))
    dx = _dxs(box)
    got = _flux_once(u.float(), VISC, dx)
    ref = pk.convdiff_interior_3d_plain(u, VISC, dx)
    assert _rel(got.numpy(), ref.numpy()) < 1e-6


def test_wrapper_runs_plain_on_cpu():
    """On a CPU tensor the wrapper is its plain version and launches
    nothing."""
    box = (5, 7, 21)
    u = torch.from_numpy(np.random.default_rng(6).standard_normal((3, *box)))
    launches.reset_counts()
    assert torch.equal(pk.convdiff_interior_3d(u, VISC, _dxs(box)),
                       pk.convdiff_interior_3d_plain(u, VISC, _dxs(box)))
    assert launches.LAUNCHES["convdiff_interior_3d"] == 0
