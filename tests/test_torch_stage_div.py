"""The unfused projection step's stage, held against the JAX package.

`momentum_stage_div_3d` (k = convdiff(u), ut = base + coeff·k, vol·div ut)
and `convdiff_periodic_uniform_3d` run their plain versions on CPU
tensors; they are compared with the Pallas kernels in interpret mode at
float64.  The unfused step built on them (stage -> `make_poisson_mm` ->
`pressure_correct_3d`) is compared with the JAX package's and with the
port's fused hat step (`momentum_stage_divhat_3d` -> pass B ->
`pressure_correct_qhat_3d`), the port of `tests/test_pallas_kernel.py`'s
`test_fused_projection_chain_matches_unfused`.  On the card the stage is
`csrc/stage.cu`'s; `chip_smoke.py` holds it against its plain version at
256³ and runs both steps there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ins_tpu.ops import pallas_kernels as jpk
from ins_tpu.ops.dft import make_poisson_mm as jax_make_poisson_mm

from ins_tpu_torch.ops import launches
from ins_tpu_torch.ops import perop_kernels as pk
from ins_tpu_torch.ops import stage_kernels as sk
from ins_tpu_torch.ops.dft import make_poisson_mm
from ins_tpu_torch.ops.poisson_kernels import make_fused_projection

N = 16
DXS = (2 * np.pi / N,) * 3
VISC = 1e-3
COEFF = 0.13
# float64 on both sides, sums in another order (~1e-15 relative)
TOL_F64 = 1e-12
# the unfused step: an eigen-solve in each package (1e-10) and the fused
# step's folded pass B against the dense solve (1e-9)
TOL_STEP_JAX = 1e-10
TOL_STEP_FUSED = 1e-9


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _fields(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in shapes]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_momentum_stage_div_3d_matches_pallas():
    u, base = _fields(1, (3, N, N, N), (3, N, N, N))
    ref = jpk.momentum_stage_div_3d(jnp.asarray(u), jnp.asarray(base), COEFF, VISC, DXS,
                                    interpret=True)
    launches.reset_counts()
    got = pk.momentum_stage_div_3d(_t(u), _t(base), COEFF, VISC, DXS)
    assert launches.LAUNCHES["momentum_stage_div_3d"] == 0  # CPU tensors: the plain version
    assert len(got) == 3 and got[2].shape == (N, N, N)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float64
        assert _rel(g.numpy(), r) < TOL_F64
    # coeff as a 0-d tensor gives the same
    got_t = pk.momentum_stage_div_3d(_t(u), _t(base), torch.tensor(COEFF, dtype=torch.float64),
                                     VISC, DXS)
    for g, gt in zip(got, got_t):
        assert torch.equal(g, gt)


def test_momentum_stage_div_3d_rejects_non_cube():
    u, base = _fields(2, (3, N, N, N // 2), (3, N, N, N // 2))
    with pytest.raises(ValueError):
        pk.momentum_stage_div_3d(_t(u), _t(base), COEFF, VISC, DXS)


@pytest.mark.parametrize("box", [(N, N, N), (8, 12, 16)])
def test_convdiff_periodic_uniform_3d_matches_pallas(box):
    (u,) = _fields(3, (3, *(n + 2 for n in box)))
    dxs = tuple(2 * np.pi / n for n in box)
    got = pk.convdiff_periodic_uniform_3d(_t(u), VISC, dxs)
    assert got.shape == u.shape
    inner = got[:, 1:-1, 1:-1, 1:-1]
    assert not got.sum().isnan() and got.abs().sum() == inner.abs().sum()  # ghosts are 0
    if box[0] == box[1] == box[2]:  # the JAX wrapper is for a cube
        ref = jpk.convdiff_periodic_uniform_3d(jnp.asarray(u), VISC, dxs, interpret=True)
        assert _rel(got.numpy(), ref) < TOL_F64
    ref_int = jpk.convdiff_interior_3d(jnp.asarray(u[:, 1:-1, 1:-1, 1:-1]), VISC, dxs,
                                       interpret=True)
    assert _rel(inner.numpy(), ref_int) < TOL_F64


def _unfused_jax(u, base):
    k, ut, div = jpk.momentum_stage_div_3d(jnp.asarray(u), jnp.asarray(base), COEFF, VISC, DXS,
                                           interpret=True)
    q = jax_make_poisson_mm((N,) * 3, DXS, jnp.float64)(div)
    return k, ut, jpk.pressure_correct_3d(ut, q, DXS, interpret=True)


def _unfused(u, base):
    k, ut, div = pk.momentum_stage_div_3d(u, base, COEFF, VISC, DXS)
    q = make_poisson_mm((N,) * 3, DXS, torch.float64, "cpu")(div)
    return k, ut, pk.pressure_correct_3d(ut, q, DXS)


def _fused(u, base):
    proj = make_fused_projection((N,) * 3, DXS, torch.float64, device="cpu")
    k, ut, divhat = sk.momentum_stage_divhat_3d(u, (base,), (COEFF,), VISC, DXS, proj["Vinv"],
                                                proj["VinvT"])
    return k, ut, sk.pressure_correct_qhat_3d(ut, proj["passB"](divhat), DXS, proj["V"],
                                              proj["VT"])


def test_unfused_projection_step_matches_jax_and_fused():
    u, base = _fields(4, (3, N, N, N), (3, N, N, N))
    got = _unfused(_t(u), _t(base))
    for g, r in zip(got, _unfused_jax(u, base)):
        assert _rel(g.numpy(), r) < TOL_STEP_JAX
    for g, r in zip(got, _fused(_t(u), _t(base))):
        assert _rel(g.numpy(), r.numpy()) < TOL_STEP_FUSED
    # the step projects: the corrected velocity is divergence-free
    unew = got[2]
    div = sum((unew[a] - torch.roll(unew[a], 1, a)) / DXS[a] for a in range(3))
    assert div.abs().max().item() < 1e-9 * unew.abs().max().item() / DXS[0]
