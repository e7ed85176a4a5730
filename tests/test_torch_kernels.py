"""The port's four stage/projection kernels, held against the JAX package.

Each kernel's plain PyTorch version (what the wrapper runs on a CPU
tensor) is compared with the Pallas kernel run in interpret mode at
16³, float64, ``projection_precision="highest"`` (the Pallas kernels
accept f64 there and then compute in f64).  The CUDA kernels themselves
run only on the card: `chip_smoke.py` holds each against its plain
version at 64³ and 256³.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ins_tpu.ops import pallas_kernels as pk
from ins_tpu.ops.diffkernels import convdiff_roll as jax_convdiff_roll
from ins_tpu.ops.poisson_pallas import make_fused_projection as jax_fused_projection

from ins_tpu_torch import _build
from ins_tpu_torch.ops import launches
from ins_tpu_torch.ops import stage_kernels as sk
from ins_tpu_torch.ops.diffkernels import convdiff_roll
from ins_tpu_torch.ops.poisson_kernels import make_fused_projection, passB, passB_plain
from ins_tpu_torch.ops.transforms import x_transform_plain, yz_transform_plain

N = 16
DXS = (2 * np.pi / N, 1.0 / N, 0.5 / N)
VISC = 1e-3
# f64 on both sides: the two differ only in summation order (n = 16 term
# sums), ~1e-15 relative; 1e-10 leaves room without hiding a wrong term.
TOL_F64 = 1e-10


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def projs():
    """The JAX and the port's fused projections for the test cube (f64)."""
    jp = jax_fused_projection(
        (N,) * 3, DXS, jnp.float64, precision="highest", interpret=True
    )
    tp = make_fused_projection((N,) * 3, DXS, torch.float64, precision="highest", device="cpu")
    return jp, tp


def _fields(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in shapes]


VEC, SCA = (3, N, N, N), (N, N, N)


def test_projection_constants_match(projs):
    jp, tp = projs
    for key in ("V", "Vinv", "VT", "VinvT"):
        assert _rel(tp[key].numpy(), jp[key]) < 1e-14, key


def test_pcmsd_hat_3d_recon_emit_u_matches_pallas(projs):
    """Stage 0 of the hat chain: RECON base, usnew and emit_u."""
    jp, tp = projs
    ut_prev, qhat = _fields(1, VEC, SCA)
    qhat = 0.1 * qhat
    cn, cu = 0.21, 0.4
    ref = pk.pcmsd_hat_3d(
        jnp.asarray(ut_prev), jnp.asarray(qhat), (pk.RECON,), (cn,), VISC, DXS, jp,
        precision="highest", interpret=True, emit_k=False, usnew_coeff=cu,
        emit_u=True,
    )
    got = sk.pcmsd_hat_3d_plain(
        _t(ut_prev), _t(qhat), (sk.RECON,), (cn,), VISC, DXS, tp,
        precision="highest", emit_k=False, usnew_coeff=cu, emit_u=True,
    )
    assert len(got) == len(ref) == 4  # ut, divhat, usnew, u
    for name, g, r in zip(("ut", "divhat", "usnew", "u"), got, ref):
        assert _rel(g.numpy(), r) < TOL_F64, name


def test_momentum_stage_divhat_3d_matches_pallas(projs):
    """A k stream, the k output and a separate usnew base."""
    jp, tp = projs
    u, ustart, k1, accb = _fields(2, VEC, VEC, VEC, VEC)
    coeffs, cu = (0.3, 0.17), 0.25
    ref = pk.momentum_stage_divhat_3d(
        jnp.asarray(u), (jnp.asarray(ustart), jnp.asarray(k1)), coeffs, VISC, DXS,
        jp["Vinv"], jp["VinvT"], precision="highest", interpret=True,
        usnew_coeff=cu, usnew_base=jnp.asarray(accb),
    )
    got = sk.momentum_stage_divhat_3d_plain(
        _t(u), (_t(ustart), _t(k1)), coeffs, VISC, DXS, tp["Vinv"], tp["VinvT"],
        precision="highest", usnew_coeff=cu, usnew_base=_t(accb),
    )
    assert len(got) == len(ref) == 4  # k, ut, divhat, usnew
    for name, g, r in zip(("k", "ut", "divhat", "usnew"), got, ref):
        assert _rel(g.numpy(), r) < TOL_F64, name


def test_passB_matches_pallas(projs):
    """The dense x-solve equals the JAX package's (folded at n % 4 == 0)."""
    jp, tp = projs
    (h,) = _fields(3, SCA)
    ref = jp["passB"](jnp.asarray(h))
    got = passB_plain(_t(h), tp)
    assert _rel(got.numpy(), ref) < TOL_F64


def test_pressure_correct_qhat_3d_matches_pallas(projs):
    jp, tp = projs
    ut, qhat = _fields(4, VEC, SCA)
    ref = pk.pressure_correct_qhat_3d(
        jnp.asarray(ut), jnp.asarray(qhat), DXS, jp["V"], jp["VT"],
        precision="highest", interpret=True,
    )
    got = sk.pressure_correct_qhat_3d_plain(
        _t(ut), _t(qhat), DXS, tp["V"], tp["VT"], precision="highest"
    )
    assert _rel(got.numpy(), ref) < TOL_F64


def test_pcmsd_equals_correct_then_msd(projs):
    """pcmsd(ut_prev, qhat) == msd(pressure_correct(ut_prev, qhat)), with
    a stream base, a k stream and a usnew base (exact arithmetic)."""
    _, tp = projs
    ut_prev, qhat, ustart, k1, accb = _fields(5, VEC, SCA, VEC, VEC, VEC)
    kw = dict(emit_k=True, usnew_coeff=0.25, usnew_base=_t(accb))
    got = sk.pcmsd_hat_3d_plain(
        _t(ut_prev), _t(qhat), (_t(ustart), _t(k1)), (0.4, 0.17), VISC, DXS, tp, **kw
    )
    u = sk.pressure_correct_qhat_3d_plain(_t(ut_prev), _t(qhat), DXS, tp["V"], tp["VT"])
    ref = sk.momentum_stage_divhat_3d_plain(
        u, (_t(ustart), _t(k1)), (0.4, 0.17), VISC, DXS, tp["Vinv"], tp["VinvT"], **kw
    )
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("D", [2, 3])
def test_convdiff_roll_matches_jax(D):
    n = 12
    dxs = (0.3, 0.2, 0.1)[:D]
    (u,) = _fields(6, (D,) + (n,) * D)
    ref = jax_convdiff_roll(jnp.asarray(u), VISC, dxs)
    got = convdiff_roll(_t(u), VISC, dxs)
    assert _rel(got.numpy(), ref) < 1e-13


def test_transforms_plain_match_numpy():
    f, my, mz = _fields(7, SCA, (N, N), (N, N))
    ref = np.einsum("yj,xjk,lk->xyl", my, f, mz)
    got = yz_transform_plain(_t(f), _t(my), _t(mz.T))
    assert _rel(got.numpy(), ref) < 1e-13
    ref = np.einsum("ix,xyz->iyz", my, f)
    assert _rel(x_transform_plain(_t(my), _t(f)).numpy(), ref) < 1e-13


def test_wrappers_run_plain_on_cpu(projs):
    """On CPU tensors every wrapper returns its plain version's result
    and launches nothing."""
    _, tp = projs
    ut, qhat = _fields(8, VEC, SCA)
    ut, qhat = _t(ut), _t(qhat)
    launches.reset_counts()
    pairs = [
        (sk.pcmsd_hat_3d(ut, qhat, (sk.RECON,), (0.2,), VISC, DXS, tp, emit_u=True),
         sk.pcmsd_hat_3d_plain(ut, qhat, (sk.RECON,), (0.2,), VISC, DXS, tp, emit_u=True)),
        (sk.momentum_stage_divhat_3d(ut, (ut,), (0.2,), VISC, DXS, tp["Vinv"], tp["VinvT"]),
         sk.momentum_stage_divhat_3d_plain(ut, (ut,), (0.2,), VISC, DXS, tp["Vinv"], tp["VinvT"])),
        ((passB(qhat, tp),), (passB_plain(qhat, tp),)),
        ((sk.pressure_correct_qhat_3d(ut, qhat, DXS, tp["V"], tp["VT"]),),
         (sk.pressure_correct_qhat_3d_plain(ut, qhat, DXS, tp["V"], tp["VT"]),)),
    ]
    for got, ref in pairs:
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert all(v == 0 for v in launches.LAUNCHES.values())
    assert all(v == 0 for v in launches.PLAIN_ON_CUDA.values())


@pytest.mark.parametrize(
    "kw",
    [dict(bodyforce=torch.zeros(2, dtype=torch.float64)), dict(smag=(0.1,)),
     dict(temperature=(0,) * 7)],
    ids=["bodyforce", "smag", "temperature"],
)
def test_unported_options_raise(projs, kw):
    """The body force, Smagorinsky and temperature options are ported
    (tests/test_torch_les.py, tests/test_torch_boussinesq.py) and raise
    only on a malformed value: a force that is not a vector field of the
    cube, a ``smag`` that is not ``(theta, d2)``, a temperature tuple whose
    accumulator base has no usnew output."""
    _, tp = projs
    ut, qhat = _fields(9, VEC, SCA)
    err = (ValueError, "temperature" if "temperature" in kw else None)
    with pytest.raises(err[0], match=err[1]):
        sk.pcmsd_hat_3d(_t(ut), _t(qhat), (sk.RECON,), (0.2,), VISC, DXS, tp, **kw)
    with pytest.raises(err[0], match=err[1]):
        sk.momentum_stage_divhat_3d(
            _t(ut), (_t(ut),), (0.2,), VISC, DXS, tp["Vinv"], tp["VinvT"], **kw
        )


def test_bf16_compute_dtype_raises(projs):
    _, tp = projs
    (ut,) = _fields(10, VEC)
    with pytest.raises(NotImplementedError, match="bf16"):
        sk.momentum_stage_divhat_3d(
            _t(ut), (_t(ut),), (0.2,), VISC, DXS, tp["Vinv"], tp["VinvT"],
            compute_dtype=torch.bfloat16,
        )


def test_cuda_operand_checks_reject_cpu_tensors():
    t = torch.zeros(VEC, dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        launches.check_cuda_operands("k", N, u=(t, "vec"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No compiler: the build raises a clear error instead of falling back."""
    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build()


def test_kernel_sources_carry_their_notes():
    """Every CUDA source names the TPU kernel it replaces and what bounds
    it on the card; the build hashes every source."""
    srcs = sorted(_build.CSRC.glob("*.cu"))
    assert {p.name for p in srcs} == {
        "transforms.cu", "stage.cu", "poisson.cu", "correct.cu", "perop.cu", "conv.cu",
        "channel.cu", "smag.cu", "tapconv_mma.cu", "tapconv_tf32.cu",
        "tapwgrad_mma.cu", "tapwgrad_tf32.cu", "fold.cu",
    }
    for p in srcs:
        text = p.read_text()
        assert "Replaces:" in text and "ins_tpu/ops/" in text, p.name
        assert "What bounds it on an H100" in text, p.name
    assert len(_build._source_hash()) == 16
