"""The two reformulations the redesigned stencil kernels make, emulated in
torch at float64 and held against the JAX package and the port's plain
versions (CPU only).

* The stage kernel (`csrc/stage.cu`, TEMP) forms the temperature RHS's
  dissipation g_b = u_b * visc * Laplacian(u_b) once a cell, with the
  Laplacian summed from the diffusion terms its conv-diff has just formed,
  and takes g_b(I - e_b) from the neighbouring cell's value (registers,
  the previous row, a warp shuffle) instead of forming it again; every
  1/dx is a multiply by a reciprocal.  `_temp_staged` does the same on
  whole fields: against `momentum_stage_divhat_3d(temperature=...)` in
  interpret mode and against `stage_kernels._temp_plain`.
* The Smagorinsky force kernel (`csrc/smag.cu`) stages the six strain
  components once a point, forms nu from the staged strain and the
  stresses and their divergence from staged strain and nu.
  `_smag_staged` does the same: against `smagorinsky_force_3d` in
  interpret mode and `smag_kernels._force_plain`, on a cube and on a
  ragged box.

Tolerance: TOL = 1e-12 relative to max|reference| (float64; the
reformulations reorder float sums and replace divisions by multiplies).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ins_tpu.ops import pallas_kernels as jpk
from ins_tpu.ops.poisson_pallas import make_fused_projection as jax_make_fused_projection

from ins_tpu_torch.ops import smag_kernels as smk
from ins_tpu_torch.ops import stage_kernels as sk

TOL = 1e-12
VISC = 2e-3
ALPHA2, ALPHA4, DIS = 0.3, 4e-3, 0.7
THETA = 0.17


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _fields(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in shapes]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _p(f, a):
    """f(I + e_a) on a periodic field."""
    return torch.roll(f, -1, a)


def _m(f, a):
    """f(I - e_a)."""
    return torch.roll(f, 1, a)


def _convdiff_laplacians(u, visc, dxs):
    """visc * Laplacian(u_A) of each component as the stage kernel forms
    it: the sum over b of its conv-diff's diffusion terms
    visc / dx_b^2 * (u_A(+e_b) - 2 u_A + u_A(-e_b)) (`convdiff_r`)."""
    cd = [visc * ((1.0 / d) * (1.0 / d)) for d in dxs]
    laps = []
    for a in range(3):
        lap = torch.zeros_like(u[a])
        for b in range(3):
            lap = lap + cd[b] * (_p(u[a], b) - 2.0 * u[a] + _m(u[a], b))
        laps.append(lap)
    return laps


def _temp_staged(u, T, tstart, tacc, cnew, cus, visc, dxs, dis):
    """(temp_next, tempnew) of the TEMP stage, its dissipation from the
    conv-diff's diffusion terms, formed once a cell and shifted for
    I - e_b (`temperature` of stage.cu)."""
    r = [1.0 / d for d in dxs]
    g = [u[b] * lap for b, lap in enumerate(_convdiff_laplacians(u, visc, dxs))]
    kt = torch.zeros_like(T)
    for b in range(3):
        tp, tm = _p(T, b), _m(T, b)
        ut2 = u[b] * (0.5 * (T + tp))
        ut1 = _m(u[b], b) * (0.5 * (tm + T))
        dt2 = (tp - T) * r[b]
        dt1 = (T - tm) * r[b]
        kt = kt + (-(ut2 - ut1) + ALPHA4 * (dt2 - dt1)) * r[b]
    if dis is not None:
        dacc = torch.zeros_like(T)
        for b in range(3):
            dacc = dacc + 0.5 * (g[b] + _m(g[b], b))
        kt = kt + dis * dacc
    tb = T if tstart is None else tstart
    ta = tb if tacc is None else tacc
    return tb + cnew * kt, ta + cus * kt


def _smag_staged(u, theta, dxs, d2):
    """The natural-form Smagorinsky force as smag.cu forms it: the six
    strain components once a point, nu from them, the stresses from
    staged strain and nu, every 1/dx a multiply."""
    r = [1.0 / d for d in dxs]
    s = {(a, a): (u[a] - _m(u[a], a)) * r[a] for a in range(3)}
    pairs = ((0, 1), (0, 2), (1, 2))
    for a, b in pairs:
        s[a, b] = 0.5 * ((_p(u[a], b) - u[a]) * r[b] + (_p(u[b], a) - u[b]) * r[a])
    acc = 2.0 * (s[0, 0] * s[0, 0] + s[1, 1] * s[1, 1] + s[2, 2] * s[2, 2])
    for a, b in pairs:
        s0, s1, s2, s3 = s[a, b], _m(s[a, b], a), _m(s[a, b], b), _m(_m(s[a, b], a), b)
        acc = acc + (s0 * s0 + s1 * s1 + s2 * s2 + s3 * s3)
    nu = (theta * theta * d2) * torch.sqrt(acc)
    sig = {(a, a): 2.0 * nu * s[a, a] for a in range(3)}
    for a, b in pairs:
        nue = nu + _p(nu, a) + _p(nu, b) + _p(_p(nu, a), b)
        sig[a, b] = sig[b, a] = 0.5 * nue * s[a, b]
    # component a's terms by direction 0, 1, 2 (its diagonal term where
    # b = a), the kernel's order of additions
    out = []
    for a in range(3):
        f = None
        for b in range(3):
            term = ((_p(sig[a, a], a) - sig[a, a]) if b == a
                    else (sig[a, b] - _m(sig[a, b], b))) * r[b]
            f = term if f is None else f + term
        out.append(f)
    return torch.stack(out)


# --------------------------------------------------------------------------
# the temperature stage's dissipation from the conv-diff
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def projs():
    return {n: jax_make_fused_projection((n,) * 3, (1.0 / n, 0.9 / n, 1.1 / n), jnp.float64,
                                         precision="highest", interpret=True)
            for n in (8, 12)}


# (n, gdir, layout): T elided with usnew, or tstart + tacc with usnew
TEMP_CASES = [(8, 0, "elided"), (8, 2, "tstart+tacc"), (12, 0, "tstart+tacc"),
              (12, 2, "elided")]


@pytest.mark.parametrize("n,gdir,layout", TEMP_CASES,
                         ids=[f"{n}^3-g{g}-{lay}" for n, g, lay in TEMP_CASES])
def test_temperature_dissipation_from_convdiff(projs, n, gdir, layout):
    """temp_out and tempnew with g_b formed once from the conv-diff's
    diffusion terms, against the JAX stage in interpret mode and the
    port's plain version (dissipation on)."""
    dxs = (1.0 / n, 0.9 / n, 1.1 / n)
    u, T, Ts, Ta = _fields(40 + n + gdir, (3, n, n, n), (n,) * 3, (n,) * 3, (n,) * 3)
    u = 0.5 * u
    tstart, tacc = (None, None) if layout == "elided" else (Ts, Ta)
    cnew, cus = 0.17, 0.4
    jp = projs[n]

    def temp(c):
        return (c(T), None if tstart is None else c(tstart), None if tacc is None else c(tacc),
                gdir, ALPHA2, ALPHA4, DIS)

    ref = jpk.momentum_stage_divhat_3d(
        jnp.asarray(u), (jnp.asarray(u),), (cnew,), VISC, dxs, jp["Vinv"], jp["VinvT"],
        precision="highest", interpret=True, usnew_coeff=cus, temperature=temp(jnp.asarray),
    )
    got = _temp_staged(_t(u), _t(T), None if tstart is None else _t(tstart),
                       None if tacc is None else _t(tacc), cnew, cus, VISC, dxs, DIS)
    plain = sk._temp_plain(_t(u), temp(_t), cnew, cus, VISC, dxs)
    for g, r, q in zip(got, ref[-2:], plain):
        assert _rel(g.numpy(), r) < TOL
        assert _rel(g.numpy(), q.numpy()) < TOL


@pytest.mark.parametrize("n", [8, 12])
def test_convdiff_laplacian_is_the_diffusion_sum(n):
    """The Laplacians the stage kernel sums from its conv-diff's diffusion
    terms equal the plain version's dissipation Laplacian (visc * the
    second differences, each divided by dx_b^2)."""
    dxs = (1.0 / n, 0.9 / n, 1.1 / n)
    (u,) = _fields(70 + n, (3, n, n, n))
    u = _t(u)
    got = _convdiff_laplacians(u, VISC, dxs)
    for a in range(3):
        ref = sum((_p(u[a], b) - 2.0 * u[a] + _m(u[a], b)) / (dxs[b] * dxs[b])
                  for b in range(3)) * VISC
        assert _rel(got[a].numpy(), ref.numpy()) < TOL


# --------------------------------------------------------------------------
# the Smagorinsky force from staged strain
# --------------------------------------------------------------------------


@pytest.mark.parametrize("box", [(12, 12, 12), (10, 7, 9)], ids=["12^3", "10x7x9"])
@pytest.mark.parametrize("mode", ["u", "rebuild"])
def test_smagorinsky_force_from_staged_strain(box, mode):
    """The force from staged strain and nu against `smagorinsky_force_3d`
    in interpret mode and the plain version; ``rebuild`` evaluates it on
    u = ut - grad q, as the stage wrappers' force kernel does."""
    dxs = (0.3, 0.25, 0.2)
    d2 = smk._d2(dxs)
    u, q = _fields(80 + sum(box), (3, *box), box)
    ut = _t(u)
    if mode == "rebuild":
        ut = ut - torch.stack([(_p(_t(q), a) - _t(q)) / dxs[a] for a in range(3)])
    ref = jpk.smagorinsky_force_3d(jnp.asarray(ut.numpy()), THETA, dxs, interpret=True)
    got = _smag_staged(ut, THETA, dxs, d2)
    plain = smk._force_plain(_t(u), THETA, dxs, d2,
                             rebuild_q=_t(q) if mode == "rebuild" else None)
    assert _rel(got.numpy(), ref) < TOL
    assert _rel(got.numpy(), plain.numpy()) < TOL
