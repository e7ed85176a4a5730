"""The fused stage and correction kernels of the periodic-cube fast path.

Port of `RECON`, `momentum_stage_divhat_3d`, `pcmsd_hat_3d` and
`pressure_correct_qhat_3d` from `ins_tpu/ops/pallas_kernels.py`, with the
JAX functions' signatures and layouts (component-first interior
velocity ``(3, n, n, n)``, scalars ``(n, n, n)``, eigen-basis ``qhat``):

    momentum_stage_divhat_3d   k = convdiff(u); ut = base + Σ c_j k_j + c·k;
                               optional usnew; divhat = Vinv_y·(vol·div ut)·Vinv_zᵀ
    pcmsd_hat_3d               the same stage on u = ut_prev − ∇(V_y·qhat·V_zᵀ),
                               rebuilt in the kernel (``RECON`` base, ``emit_u``)
    pressure_correct_qhat_3d   u = ut − ∇(V_y·qhat·V_zᵀ)

Each wrapper runs its hand-written CUDA kernel for CUDA tensors
(`csrc/stage.cu`, `csrc/correct.cu`, with the z/y transforms as GEMMs of
`csrc/transforms.cu`) and its plain PyTorch version, beside it here, for
CPU tensors.  A CUDA call either launches the kernel or raises: there is
no fallback.  ``bodyforce`` (a steady force, interior layout) rides the
stage kernel's force stream; ``smag=(theta, d2)`` runs the Smagorinsky
force kernel (`ops/smag_kernels.py`, on the rebuilt u for `pcmsd_hat_3d`)
with the body force folded in and feeds its output to the same stream.
The plain versions add both where the JAX package's `_stage_tail` does:
f = convdiff + smag + buoyancy + bodyforce.

``precision`` ("manualhigh", the default, or "highest") is the form of
the z/y transforms (`ops/transforms.py`'s contract: the JAX package's
3-pass bf16 class or the float32 class on float32 operands, exact on
float64), in the kernel runs and the plain versions alike.

``temperature=(T, tstart, tacc, gdir, alpha2, alpha4, dis)`` rides the
Boussinesq temperature on the same pass, as in the JAX wrappers: the
buoyancy ``alpha2·½(T + T[I + e_gdir])`` joins component gdir of the
momentum (so k and the divergence include it), and the temperature RHS
kt (`ops/temperature.temp_rhs_roll` of the stage's velocity, the rebuilt
one for `pcmsd_hat_3d`) advances with the stage's own coefficients:
``temp_next = (tstart or T) + coeffs[-1]·kt`` and, with ``usnew_coeff``,
``tempnew = (tacc or tstart or T) + usnew_coeff·kt``, appended to the
outputs in that order.  The stage then takes no k streams, and ``tacc``
needs ``tstart`` and ``usnew_coeff``.

Stream storage, as in the JAX wrappers: the velocity-like arrays (u or
``ut_prev``, the tableau streams, ``usnew_base``, and the k, ut, usnew
and emitted-u outputs) may be stored in bf16 while everything else (qhat,
divhat, the temperature) and all arithmetic stay at the compute dtype:
``compute_dtype`` for `momentum_stage_divhat_3d`, qhat's dtype for
`pcmsd_hat_3d` and `pressure_correct_qhat_3d`.  Inputs are widened before
any arithmetic, the divergence is that of the unrounded ut, and outputs are
rounded to the storage dtype; the correction emits ``out_dtype``, else
qhat's dtype.  The steady body force is rounded to the storage dtype
first (the JAX kernels carry it in the streams' scratch).  On the card
the storage is float32 or bfloat16 and the arithmetic float32 (the
kernels' S template type, `csrc/stage.cu`, `csrc/correct.cu`); bf16
storage with ``smag`` or ``temperature`` raises NotImplementedError
(ROADMAP queue 2 item 5), as does a bf16 compute dtype.  A stage with
more than four k streams runs the STREAMS kernel (the port of
`_msd_hat_stream_kernel`), which reads them from a device table.

The ``*_halo_3d`` wrappers (`momentum_stage_divhat_halo_3d`,
`pcmsd_hat_halo_3d`, `pressure_correct_qhat_halo_3d`, ports of the JAX
functions of those names) run the same stages and correction on an
x-slab shard block ``(3, lx, n, n)`` of a 1-D mesh (`parallel/halo.py`),
with the JAX signatures: the ring neighbours' boundary planes come as
separate ghost arrays (2 lower and 1 upper of u or ut, 2 and 2 of qhat,
1 upper of qhat for the correction) and each tableau stream brings its
plane −1 in ``streams_lo``.  The CUDA side is the ``HALO`` flag of
`csrc/stage.cu` and `ins_correct_halo_f32` of `csrc/correct.cu`.  The
exchanged qhat ghost planes are transformed to q beside the block's (the
JAX order; the transform is per plane, so transforming the block first
and exchanging q planes would give the same q).  The plain versions
concatenate the ghosts around the block and run the cube's plain stage on
it, keeping the planes whose stencils the ghosts cover.  On a shard block
``bodyforce`` comes with its plane −1 in ``bodyforce_lo`` and rides the
HALO stage's force stream; ``smag=(theta, d2)`` widens the ghosts as the
JAX kernels do (3 lower and 2 upper planes of u or ut, 3 and 3 of qhat)
and runs the halo force kernel (`smag_kernels._force_halo`, on the
rebuilt u for `pcmsd_hat_halo_3d`) on planes −1 .. lx − 1 first, with the
body force folded in; the stage takes its output as the force stream.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .diffkernels import convdiff_roll, roll_m, roll_p
from .launches import (
    LAUNCHES,
    check_cuda_operands,
    check_cuda_tensors,
    current_stream,
    note_plain,
    ptr,
)
from .smag_kernels import _force as smag_force
from .smag_kernels import _force_halo as smag_force_halo
from .smag_kernels import _force_halo_plain as smag_force_halo_plain
from .smag_kernels import _force_plain as smag_force_plain
from .temperature import add_buoyancy, temp_rhs_roll
from .transforms import yz_transform, yz_transform_plain

__all__ = [
    "RECON",
    "momentum_stage_divhat_3d",
    "momentum_stage_divhat_3d_plain",
    "pcmsd_hat_3d",
    "pcmsd_hat_3d_plain",
    "pressure_correct_qhat_3d",
    "pressure_correct_qhat_3d_plain",
    "momentum_stage_divhat_halo_3d",
    "momentum_stage_divhat_halo_3d_plain",
    "pcmsd_hat_halo_3d",
    "pcmsd_hat_halo_3d_plain",
    "pressure_correct_qhat_halo_3d",
    "pressure_correct_qhat_halo_3d_plain",
]


class _Recon:
    def __repr__(self):
        return "RECON"


# Sentinel for `pcmsd_hat_3d(streams=(RECON,))`: the tableau base is the
# kernel's own rebuilt velocity (the step-boundary merge).
RECON = _Recon()

_MAXK = 4  # k streams of the unrolled CUDA stage (csrc/stage.cu MAXK); more: STREAMS


def _compute_dtype(u, compute_dtype):
    """The stage's arithmetic dtype: ``compute_dtype``, else u's own."""
    cdt = u.dtype if compute_dtype is None else compute_dtype
    if cdt not in (torch.float32, torch.float64):
        raise NotImplementedError(
            f"bf16 arithmetic (compute dtype {cdt}) is not ported: the stage computes in "
            "float32 or float64 (ROADMAP queue 2 item 5)"
        )
    return cdt


def _reject_unported(sdt, cdt, smag=None, temperature=None):
    """Narrow stream storage is ported without the force kernel and the
    temperature stream."""
    if sdt != cdt and (smag is not None or temperature is not None):
        raise NotImplementedError(
            f"{sdt} stream storage with smag= or temperature= is not ported yet "
            "(ROADMAP queue 2 item 5)"
        )


def _reject_halo_bf16(u):
    """The shard blocks store float (the JAX halo kernels have no stream
    dtype)."""
    if u.dtype == torch.bfloat16:
        raise NotImplementedError(
            "bf16 stream storage on a shard block is not ported yet (ROADMAP queue 2 item 5)"
        )


def _as(t, dtype):
    return None if t is None else t.to(dtype)


def _stored(t, sdt, cdt):
    """A stream as the kernels read it: stored as ``sdt``, widened to
    ``cdt`` (no copy where both are its own dtype)."""
    return None if t is None else t.to(sdt).to(cdt)


def _vec_dtype(sdt):
    """The storage dtype the CUDA kernels take for ``sdt`` (float32 unless
    bf16; a float64 tensor then fails the operand check)."""
    return torch.bfloat16 if sdt == torch.bfloat16 else torch.float32


def _stage_key(name, sdt, m):
    """The launch-count key of a stage: bf16 storage, or the many-stream
    kernel, or the stage itself."""
    if sdt == torch.bfloat16:
        return name + "+bf16"
    return name + "+streams" if m > _MAXK else name


def _split_temperature(temperature, streams, usnew_coeff):
    """The ``temperature`` tuple with the JAX wrappers' rules checked,
    gdir an int and the coefficients floats (``dis`` None: off)."""
    if temperature is None:
        return None
    T, tstart, tacc, gdir, alpha2, alpha4, dis = temperature
    if tacc is not None and tstart is None:
        raise ValueError("temperature: tempacc needs tempstart")
    if tacc is not None and usnew_coeff is None:
        raise ValueError("temperature: tempacc needs usnew_coeff")
    if len(tuple(streams)) != 1:
        raise ValueError("temperature: the stage takes no k streams (m == 0)")
    if int(gdir) not in (0, 1, 2):
        raise ValueError(f"temperature: gdir must be 0, 1 or 2, got {gdir}")
    return (T, tstart, tacc, int(gdir), float(alpha2), float(alpha4),
            None if dis is None else float(dis))


def _temp_plain(u, temp, cnew, usnew_coeff, visc, dxs):
    """(temp_next, tempnew | None) of the stage's temperature stream."""
    T, tstart, tacc, _, _, alpha4, dis = temp
    kt = temp_rhs_roll(u, T, dxs, alpha4, visc, dis)
    tb = tstart if tstart is not None else T
    tnew = None
    if usnew_coeff is not None:
        tnew = (tacc if tacc is not None else tb) + float(usnew_coeff) * kt
    return tb + cnew * kt, tnew


def _split_streams(streams, coeffs):
    streams = tuple(streams)
    coeffs = tuple(float(c) for c in coeffs)
    if len(coeffs) != len(streams):
        raise ValueError(
            f"{len(streams)} streams need {len(streams)} coefficients, got {len(coeffs)}"
        )
    return streams[0], streams[1:], coeffs[:-1], coeffs[-1]


def _check_cube(name, *tensors):
    n = tensors[0].shape[-1]
    for t in tensors:
        if t is not None and (t.dim() < 3 or tuple(t.shape[-3:]) != (n, n, n)):
            raise ValueError(f"{name}: expected cube fields, got shape {tuple(t.shape)}")
    return n


def _grad(q, dxs):
    return torch.stack([(roll_p(q, a) - q) / dxs[a] for a in range(3)])


def _stage_plain(u, base, ks, cks, cnew, visc, dxs, usnew_coeff, usnew_base,
                 bodyforce, smag, temp=None):
    """The stage-tail math (`_stage_tail`, pallas_kernels.py:972)."""
    f = convdiff_roll(u, visc, dxs)
    if smag is not None:
        theta, d2 = smag
        f = f + smag_force_plain(u, theta, dxs, d2)
    if temp is not None:
        f = add_buoyancy(f, temp[0], temp[3], temp[4])
    if bodyforce is not None:
        f = f + bodyforce
    ut = base
    for c, k in zip(cks, ks):
        ut = ut + c * k
    ut = ut + cnew * f
    usnew = None
    if usnew_coeff is not None:
        b0 = usnew_base if usnew_base is not None else base
        usnew = b0 + float(usnew_coeff) * f
    vol = float(np.prod(dxs))
    div = sum((ut[a] - roll_m(ut[a], a)) / dxs[a] for a in range(3)) * vol
    return f, ut, div, usnew


def _pack(emit_k, k, ut, divhat, usnew, u=None, temps=None):
    """(k?, ut, divhat, usnew?, u?, temp_next, tempnew?): the JAX
    wrappers' output order."""
    out = ([k] if emit_k else []) + [ut, divhat]
    if usnew is not None:
        out.append(usnew)
    if u is not None:
        out.append(u)
    if temps is not None:
        out += [t for t in temps if t is not None]
    return tuple(out)


def momentum_stage_divhat_3d_plain(
    u_int, streams, coeffs, visc, dxs, vinvy, vinvzT,
    *, precision="manualhigh", emit_k=True, usnew_coeff=None, bodyforce=None,
    usnew_base=None, smag=None, temperature=None, compute_dtype=None,
):
    """Plain PyTorch version of `momentum_stage_divhat_3d`."""
    sdt, cdt = u_int.dtype, _compute_dtype(u_int, compute_dtype)
    _reject_unported(sdt, cdt, smag, temperature)
    temp = _split_temperature(temperature, streams, usnew_coeff)
    base, ks, cks, cnew = _split_streams(streams, coeffs)
    note_plain(_stage_key("momentum_stage_divhat_3d", sdt, len(ks)), u_int)
    _check_cube("momentum_stage_divhat_3d", u_int, base, *ks, bodyforce,
                *(temp[:3] if temp else ()))
    f, ut, div, usnew = _stage_plain(
        u_int.to(cdt), _stored(base, sdt, cdt), [_stored(k, sdt, cdt) for k in ks], cks,
        cnew, visc, dxs, usnew_coeff, _stored(usnew_base, sdt, cdt),
        _stored(bodyforce, sdt, cdt), smag, temp,
    )
    divhat = yz_transform_plain(div, vinvy, vinvzT, precision)
    temps = _temp_plain(u_int, temp, cnew, usnew_coeff, visc, dxs) if temp else None
    return _pack(emit_k, f.to(sdt), ut.to(sdt), divhat, _as(usnew, sdt), temps=temps)


def pcmsd_hat_3d_plain(
    ut_prev, qhat, streams, coeffs, visc, dxs, proj,
    *, precision="manualhigh", emit_k=True, usnew_coeff=None, bodyforce=None,
    usnew_base=None, smag=None, emit_u=False, temperature=None,
):
    """Plain PyTorch version of `pcmsd_hat_3d`."""
    sdt, cdt = ut_prev.dtype, qhat.dtype
    _reject_unported(sdt, cdt, smag, temperature)
    temp = _split_temperature(temperature, streams, usnew_coeff)
    base, ks, cks, cnew = _split_streams(streams, coeffs)
    note_plain(_stage_key("pcmsd_hat_3d", sdt, 0), ut_prev)
    q = yz_transform_plain(qhat, proj["V"], proj["VT"], precision, inverse=True)
    u = ut_prev.to(cdt) - _grad(q, dxs)
    if base is RECON:
        if ks:
            raise ValueError("RECON base allows no k streams")
        base = u  # the rebuilt u itself, not rounded
    else:
        base = _stored(base, sdt, cdt)
    _check_cube("pcmsd_hat_3d", ut_prev, qhat, base, *ks, bodyforce,
                *(temp[:3] if temp else ()))
    f, ut, div, usnew = _stage_plain(
        u, base, [_stored(k, sdt, cdt) for k in ks], cks, cnew, visc, dxs, usnew_coeff,
        _stored(usnew_base, sdt, cdt), _stored(bodyforce, sdt, cdt), smag, temp,
    )
    divhat = yz_transform_plain(div, proj["Vinv"], proj["VinvT"], precision)
    temps = _temp_plain(u, temp, cnew, usnew_coeff, visc, dxs) if temp else None
    return _pack(emit_k, f.to(sdt), ut.to(sdt), divhat, _as(usnew, sdt),
                 u.to(sdt) if emit_u else None, temps)


def pressure_correct_qhat_3d_plain(
    ut_int, qhat, dxs, vy, vzT, *, precision="manualhigh", out_dtype=None
):
    """Plain PyTorch version of `pressure_correct_qhat_3d`."""
    note_plain(_correct_key(ut_int.dtype, out_dtype), ut_int)
    _check_cube("pressure_correct_qhat_3d", ut_int, qhat)
    q = yz_transform_plain(qhat, vy, vzT, precision, inverse=True)
    u = ut_int.to(qhat.dtype) - _grad(q, dxs)
    return u if out_dtype is None else u.to(out_dtype)


def _correct_key(sdt, out_dtype):
    bf16 = torch.bfloat16 in (sdt, out_dtype)
    return "pressure_correct_qhat_3d" + ("+bf16" if bf16 else "")


def _stage_force(u, q, dxs, bodyforce, smag):
    """The stage kernel's force stream: the body force, or the Smagorinsky
    kernel's output on u (rebuilt from ``q`` when given) with the body
    force folded in."""
    if smag is None:
        return bodyforce
    theta, d2 = smag
    return smag_force(u, theta, dxs, d2, bodyforce=bodyforce, rebuild_q=q)


def _stream_table(ks, cks, device):
    """The STREAMS kernel's device table: the k streams' m pointers
    (64-bit), then their m float32 coefficients."""
    ptrs = np.array([k.data_ptr() for k in ks], dtype=np.uint64).tobytes()
    coefs = np.array(cks, dtype=np.float32).tobytes()
    return torch.frombuffer(bytearray(ptrs + coefs), dtype=torch.uint8).to(device)


def _launch_stage(name, u, q, base, ks, cks, cnew, visc, dxs, *, emit_k,
                  usnew_coeff, usnew_base, emit_u, force, temp):
    """One launch of the stage kernel, storing the velocity-like streams
    as u's dtype (float32 or bfloat16); returns (k, ut, div, usnew, u,
    (temp_next, tempnew) or None)."""
    n = u.shape[1]
    many = len(ks) > _MAXK
    if many and q is not None:
        raise ValueError(f"{name}: at most {_MAXK} k streams with the rebuild, got {len(ks)}")
    T, tstart, tacc, gdir, alpha2, alpha4, dis = (
        temp if temp else (None, None, None, 0, 0.0, 0.0, None)
    )
    operands = dict(u=(u, "vec"), q=(q, "sca"), usnew_base=(usnew_base, "vec"),
                    force=(force, "vec"), T=(T, "sca"), tstart=(tstart, "sca"),
                    tacc=(tacc, "sca"))
    if base is not None:
        operands["base"] = (base, "vec")
    for j, k in enumerate(ks):
        operands[f"k{j + 1}"] = (k, "vec")
    device = check_cuda_operands(name, n, vec_dtype=_vec_dtype(u.dtype), **operands)
    with torch.cuda.device(device):
        ut = torch.empty_like(u)
        div = torch.empty((n, n, n), dtype=torch.float32, device=device)
        k_out = torch.empty_like(u) if emit_k else None
        usnew = torch.empty_like(u) if usnew_coeff is not None else None
        u_out = torch.empty_like(u) if emit_u else None
        temp_out = torch.empty_like(div) if temp else None
        tempnew = torch.empty_like(div) if temp and usnew_coeff is not None else None
        table = _stream_table(ks, cks, device) if many else None
        kptrs = (ctypes.c_void_p * _MAXK)(*([] if many else [k.data_ptr() for k in ks]))
        kcoef = (ctypes.c_float * _MAXK)(*([] if many else cks))
        lib = _build.load()
        err = (lib.ins_stage_bf16 if u.dtype == torch.bfloat16 else lib.ins_stage_f32)(
            u.data_ptr(), ptr(q), ptr(base), kptrs, kcoef, len(ks), cnew,
            ptr(usnew_base), ptr(force), 0.0 if usnew_coeff is None else float(usnew_coeff),
            int(usnew_coeff is not None), ptr(k_out), ut.data_ptr(), ptr(usnew),
            ptr(u_out), div.data_ptr(), n, float(visc),
            float(dxs[0]), float(dxs[1]), float(dxs[2]), float(np.prod(dxs)),
            ptr(T), ptr(tstart), ptr(tacc), ptr(temp_out), ptr(tempnew), gdir, alpha2,
            alpha4, 0.0 if dis is None else dis, int(dis is not None), ptr(table),
            current_stream(device),
        )
        _build.check(err, name)
        LAUNCHES[_stage_key(name, u.dtype, len(ks))] += 1
    return k_out, ut, div, usnew, u_out, (temp_out, tempnew) if temp else None


def momentum_stage_divhat_3d(
    u_int, streams, coeffs, visc, dxs, vinvy, vinvzT,
    *, precision="manualhigh", emit_k=True, usnew_coeff=None, bodyforce=None,
    usnew_base=None, smag=None, temperature=None, compute_dtype=None,
):
    """Fused momentum + RK tableau accumulation + divergence + z/y-forward
    eigen-transform.  ``streams`` is (ustart, k_1, ..., k_m) and
    ``coeffs`` their m + 1 coefficients, the new k's last.  Returns
    ``(k, ut, divhat)``, without k when ``emit_k=False``, plus
    ``usnew = (usnew_base or ustart) + usnew_coeff·k`` when
    ``usnew_coeff`` is given.  ``bodyforce`` (steady) and ``smag=(theta,
    d2)`` (the Smagorinsky force) join the momentum, so k includes them;
    ``temperature`` rides the temperature stream (module docstring).  u,
    the streams and the vector outputs are stored as u's dtype, the
    arithmetic is ``compute_dtype`` (float32 on the card)."""
    if u_int.device.type == "cpu":
        return momentum_stage_divhat_3d_plain(
            u_int, streams, coeffs, visc, dxs, vinvy, vinvzT,
            precision=precision, emit_k=emit_k, usnew_coeff=usnew_coeff,
            bodyforce=bodyforce, usnew_base=usnew_base, smag=smag,
            temperature=temperature, compute_dtype=compute_dtype,
        )
    sdt, cdt = u_int.dtype, _compute_dtype(u_int, compute_dtype)
    _reject_unported(sdt, cdt, smag, temperature)
    temp = _split_temperature(temperature, streams, usnew_coeff)
    base, ks, cks, cnew = _split_streams(streams, coeffs)
    n = u_int.shape[1]
    bodyforce = _as(bodyforce, sdt)
    check_cuda_operands(
        "momentum_stage_divhat_3d", n, vec_dtype=_vec_dtype(sdt), u=(u_int, "vec"),
        vinvy=(vinvy, "mat"), vinvzT=(vinvzT, "mat"), bodyforce=(bodyforce, "vec"),
    )
    if cdt != torch.float32:
        raise TypeError(f"momentum_stage_divhat_3d: the CUDA kernel computes in float32, "
                        f"not {cdt}")
    k, ut, div, usnew, _, temps = _launch_stage(
        "momentum_stage_divhat_3d", u_int, None, base, ks, cks, cnew, visc, dxs,
        emit_k=emit_k, usnew_coeff=usnew_coeff, usnew_base=usnew_base,
        emit_u=False, force=_stage_force(u_int, None, dxs, bodyforce, smag), temp=temp,
    )
    divhat = yz_transform(div, vinvy, vinvzT, precision)
    return _pack(emit_k, k, ut, divhat, usnew, temps=temps)


def pcmsd_hat_3d(
    ut_prev, qhat, streams, coeffs, visc, dxs, proj,
    *, precision="manualhigh", emit_k=True, usnew_coeff=None, bodyforce=None,
    usnew_base=None, smag=None, emit_u=False, temperature=None,
):
    """Merged pressure correction + momentum + stage + divergence: the
    stage of `momentum_stage_divhat_3d` evaluated on
    ``u = ut_prev − ∇q``, ``q = V_y·qhat·V_zᵀ``, rebuilt inside the stage
    kernel.  ``streams[0] is RECON`` makes the rebuilt u the tableau
    base; ``emit_u`` appends it to the outputs.  ``proj`` is a
    `make_fused_projection` dict.  ``temperature`` rides the temperature
    stream on the rebuilt u (module docstring).  ``ut_prev``, the streams
    and the vector outputs are stored as ut_prev's dtype, the arithmetic is
    qhat's."""
    if ut_prev.device.type == "cpu":
        return pcmsd_hat_3d_plain(
            ut_prev, qhat, streams, coeffs, visc, dxs, proj,
            precision=precision, emit_k=emit_k, usnew_coeff=usnew_coeff,
            bodyforce=bodyforce, usnew_base=usnew_base, smag=smag,
            emit_u=emit_u, temperature=temperature,
        )
    _reject_unported(ut_prev.dtype, qhat.dtype, smag, temperature)
    temp = _split_temperature(temperature, streams, usnew_coeff)
    base, ks, cks, cnew = _split_streams(streams, coeffs)
    if base is RECON:
        if ks:
            raise ValueError("RECON base allows no k streams")
        base = None
    n = ut_prev.shape[1]
    bodyforce = _as(bodyforce, ut_prev.dtype)
    check_cuda_operands(
        "pcmsd_hat_3d", n, vec_dtype=_vec_dtype(ut_prev.dtype), ut_prev=(ut_prev, "vec"),
        qhat=(qhat, "sca"), bodyforce=(bodyforce, "vec"),
    )
    # q and div each make one scalar round trip through device memory
    # here (the TPU kernel transforms them in the same pass)
    q = yz_transform(qhat, proj["V"], proj["VT"], precision, inverse=True)
    k, ut, div, usnew, u, temps = _launch_stage(
        "pcmsd_hat_3d", ut_prev, q, base, ks, cks, cnew, visc, dxs,
        emit_k=emit_k, usnew_coeff=usnew_coeff, usnew_base=usnew_base,
        emit_u=emit_u, force=_stage_force(ut_prev, q, dxs, bodyforce, smag), temp=temp,
    )
    divhat = yz_transform(div, proj["Vinv"], proj["VinvT"], precision)
    return _pack(emit_k, k, ut, divhat, usnew, u, temps)


def pressure_correct_qhat_3d(
    ut_int, qhat, dxs, vy, vzT, *, precision="manualhigh", out_dtype=None
):
    """u = ut − ∇q with q given in the z/y eigen-basis (``qhat``).  ``ut_int``
    may be stored in bf16; u is computed at qhat's dtype and emitted as
    ``out_dtype`` (float32 or bfloat16 on the card), else qhat's dtype."""
    if ut_int.device.type == "cpu":
        return pressure_correct_qhat_3d_plain(
            ut_int, qhat, dxs, vy, vzT, precision=precision, out_dtype=out_dtype
        )
    n = ut_int.shape[1]
    sdt = ut_int.dtype
    odt = qhat.dtype if out_dtype is None else out_dtype
    device = check_cuda_operands(
        "pressure_correct_qhat_3d", n, vec_dtype=_vec_dtype(sdt), ut=(ut_int, "vec"),
        qhat=(qhat, "sca"), vy=(vy, "mat"), vzT=(vzT, "mat"),
    )
    if odt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pressure_correct_qhat_3d: the CUDA kernel emits float32 or "
                        f"bfloat16, not {odt}")
    key = _correct_key(sdt, odt)
    with torch.cuda.device(device):
        q = yz_transform(qhat, vy, vzT, precision, inverse=True)
        u = torch.empty(ut_int.shape, dtype=odt, device=device)
        lib, dx = _build.load(), (float(dxs[0]), float(dxs[1]), float(dxs[2]))
        if key == "pressure_correct_qhat_3d":
            err = lib.ins_correct_f32(ut_int.data_ptr(), q.data_ptr(), u.data_ptr(), n, *dx,
                                      current_stream(device))
        else:
            err = lib.ins_correct_bf16(ut_int.data_ptr(), int(sdt == torch.bfloat16),
                                       q.data_ptr(), u.data_ptr(), int(odt == torch.bfloat16),
                                       n, *dx, current_stream(device))
        _build.check(err, "pressure_correct_qhat_3d")
        LAUNCHES[key] += 1
    return u


# ----------------------------------------------------------------------
# the x-slab shard block (parallel/halo.py)
# ----------------------------------------------------------------------


def _xcat(*parts):
    """Concatenate blocks along x (dim -3 of vectors and scalars)."""
    return torch.cat(parts, dim=-3)


def _ext_stream(v, v_lo):
    """A stream on the ghost-extended x range -2 .. lx: its plane −1 from
    ``v_lo``; planes −2 and lx, which no kept stencil reads, 0."""
    z = torch.zeros_like(v[:, :1])
    return _xcat(z, v_lo, v, z)


def _halo_ghosts(name, smag, bodyforce, bodyforce_lo, u_lo, u_hi, qhat_lo=None,
                 qhat_hi=None):
    """(glo, ghi), the JAX kernels' ghost counts: 3 lower and 2 upper
    planes of u (ut) with ``smag``, else 2 and 1; qhat has glo and ghi + 1.
    Raises where the ghosts or the body force's plane −1 disagree."""
    glo, ghi = (3, 2) if smag is not None else (2, 1)
    for label, t, k in (("lower ghosts of u", u_lo, glo), ("upper ghosts of u", u_hi, ghi),
                        ("qhat_lo", qhat_lo, glo), ("qhat_hi", qhat_hi, ghi + 1)):
        if t is not None and t.shape[-3] != k:
            raise ValueError(
                f"{name}: {label} has {t.shape[-3]} x-planes, expected {k} "
                f"({'with' if smag is not None else 'without'} smag=)"
            )
    if (bodyforce is None) != (bodyforce_lo is None):
        raise ValueError(f"{name}: bodyforce and bodyforce_lo (its plane -1) go together")
    return glo, ghi


def _halo_force(u, u_lo, u_hi, dxs, bodyforce, bodyforce_lo, smag, rebuild_q=None,
                plain=False):
    """The shard stage's force stream (block, plane −1): the body force,
    or the halo force kernel's output on planes −1 .. lx − 1 (on u rebuilt
    from ``rebuild_q``) with the body force folded in; (None, None)
    without either."""
    if smag is None:
        return bodyforce, bodyforce_lo
    theta, d2 = smag
    fn = smag_force_halo_plain if plain else smag_force_halo
    return fn(u, u_lo, u_hi, theta, dxs, d2, bodyforce, bodyforce_lo, rebuild_q, x_first=-1)


def _stage_halo_plain(u_ext, lx, streams, streams_lo, coeffs, visc, dxs, vinvy,
                      vinvzT, emit_k, usnew_coeff, usnew_base, base_is_u, force, force_lo,
                      precision):
    """The cube's plain stage on the ghost-extended block u_ext (x planes
    −2 .. lx) with the force stream on planes −1 .. lx − 1; returns the
    outputs on planes 0 .. lx − 1."""
    base, ks, cks, cnew = _split_streams(streams, coeffs)
    ks_lo = streams_lo[1:]
    base_ext = u_ext if base_is_u else _ext_stream(base, streams_lo[0])
    ks_ext = [_ext_stream(k, k_lo) for k, k_lo in zip(ks, ks_lo)]
    ub_ext = None
    if usnew_base is not None:
        z = torch.zeros_like(usnew_base[:, :1])
        ub_ext = _xcat(z, z, usnew_base, z)
    f_ext = None if force is None else _ext_stream(force, force_lo)
    f, ut, div, usnew = _stage_plain(u_ext, base_ext, ks_ext, cks, cnew, visc, dxs,
                                     usnew_coeff, ub_ext, f_ext, None)
    keep = slice(2, 2 + lx)
    divhat = yz_transform_plain(div[keep], vinvy, vinvzT, precision)
    usnew = None if usnew is None else usnew[:, keep]
    return f[:, keep], ut[:, keep], divhat, usnew


def _halo_streams(name, streams, streams_lo):
    streams, streams_lo = tuple(streams), tuple(streams_lo)
    if len(streams_lo) != len(streams):
        raise ValueError(f"{name}: {len(streams)} streams need as many lower ghost planes")
    return streams, streams_lo


def momentum_stage_divhat_halo_3d_plain(
    u_loc, u_lo, u_hi, streams, streams_lo, coeffs, visc, dxs, vinvy, vinvzT,
    *, precision="manualhigh", emit_k=True, usnew_coeff=None, bodyforce=None,
    bodyforce_lo=None, usnew_base=None, smag=None,
):
    """Plain PyTorch version of `momentum_stage_divhat_halo_3d`."""
    name = "momentum_stage_divhat_halo_3d"
    note_plain(name, u_loc)
    streams, streams_lo = _halo_streams(name, streams, streams_lo)
    glo, _ = _halo_ghosts(name, smag, bodyforce, bodyforce_lo, u_lo, u_hi)
    lx = u_loc.shape[1]
    force, force_lo = _halo_force(u_loc, u_lo, u_hi, dxs, bodyforce, bodyforce_lo, smag,
                                  plain=True)
    u_ext = _xcat(u_lo[:, glo - 2:], u_loc, u_hi[:, :1])
    k, ut, divhat, usnew = _stage_halo_plain(
        u_ext, lx, streams, streams_lo, coeffs, visc, dxs,
        vinvy, vinvzT, emit_k, usnew_coeff, usnew_base,
        len(streams) == 1 and streams[0] is u_loc, force, force_lo, precision,
    )
    return _pack(emit_k, k, ut, divhat, usnew)


def pcmsd_hat_halo_3d_plain(
    ut_loc, ut_lo, ut_hi, qhat_loc, qhat_lo, qhat_hi, streams, streams_lo, coeffs, visc,
    dxs, proj, *, precision="manualhigh", emit_k=True, usnew_coeff=None, bodyforce=None,
    bodyforce_lo=None, usnew_base=None, smag=None, emit_u=False,
):
    """Plain PyTorch version of `pcmsd_hat_halo_3d`."""
    name = "pcmsd_hat_halo_3d"
    note_plain(name, ut_loc)
    streams, streams_lo = _halo_streams(name, streams, streams_lo)
    recon = streams[0] is RECON
    if recon and (len(streams) != 1 or streams_lo[0] is not RECON):
        raise ValueError("RECON base allows no k streams, and its lower plane is RECON too")
    glo, ghi = _halo_ghosts(name, smag, bodyforce, bodyforce_lo, ut_lo, ut_hi, qhat_lo,
                            qhat_hi)
    lx = ut_loc.shape[1]
    # q on planes -glo .. lx + ghi; u = ut - grad q on planes -glo .. lx + ghi
    # - 1 (the x-roll's wrap at the last q plane falls on the dropped plane)
    q_ext = yz_transform_plain(_xcat(qhat_lo, qhat_loc, qhat_hi), proj["V"], proj["VT"],
                               precision, inverse=True)
    u_full = _xcat(ut_lo, ut_loc, ut_hi) - _grad(q_ext, dxs)[:, : lx + glo + ghi]
    q3 = (q_ext[glo:glo + lx], q_ext[:glo], q_ext[glo + lx:])
    force, force_lo = _halo_force(ut_loc, ut_lo, ut_hi, dxs, bodyforce, bodyforce_lo, smag,
                                  rebuild_q=q3, plain=True)
    k, ut, divhat, usnew = _stage_halo_plain(
        u_full[:, glo - 2: glo + lx + 1], lx, streams, streams_lo, coeffs, visc, dxs,
        proj["Vinv"], proj["VinvT"], emit_k, usnew_coeff, usnew_base, recon, force,
        force_lo, precision,
    )
    return _pack(emit_k, k, ut, divhat, usnew, u_full[:, glo:glo + lx] if emit_u else None)


def pressure_correct_qhat_halo_3d_plain(ut_loc, qhat_loc, qhat_hi, dxs, vy, vzT,
                                        *, precision="manualhigh"):
    """Plain PyTorch version of `pressure_correct_qhat_halo_3d`."""
    note_plain("pressure_correct_qhat_halo_3d", ut_loc)
    lx = ut_loc.shape[1]
    q_ext = yz_transform_plain(_xcat(qhat_loc, qhat_hi), vy, vzT, precision, inverse=True)
    return ut_loc - _grad(q_ext, dxs)[:, :lx]


def _halo_shapes(n, lx, glo, ghi):
    return {"vec": (3, lx, n, n), "sca": (lx, n, n), "ulo": (3, glo, n, n),
            "uhi": (3, ghi, n, n), "slo": (3, 1, n, n), "qlo": (glo, n, n),
            "qhi": (ghi + 1, n, n), "qhi1": (1, n, n), "mat": (n, n)}


def _check_halo(name, n, lx, glo=2, ghi=1, **operands):
    """`check_cuda_tensors` (float32) for a shard block: each value is
    ``(tensor, kind)`` with the kinds of `_halo_shapes`."""
    shapes = _halo_shapes(n, lx, glo, ghi)
    return check_cuda_tensors(
        name, (torch.float32,), **{k: (t, shapes[kind]) for k, (t, kind) in operands.items()}
    )


def _launch_stage_halo(name, u, u_lo, u_hi, q, q_lo, q_hi, streams, streams_lo, coeffs,
                       visc, dxs, *, base_is_u, emit_k, usnew_coeff, usnew_base, emit_u,
                       force, force_lo, glo, ghi):
    """One launch of the HALO stage kernel (with its force stream where
    ``force`` is given); returns (k, ut, div, usnew, u)."""
    _, lx, n, _ = u.shape
    base, ks, cks, cnew = _split_streams(streams, coeffs)
    base_lo, ks_lo = streams_lo[0], streams_lo[1:]
    if base_is_u:
        base = base_lo = None
    if len(ks) > _MAXK:
        raise ValueError(f"{name}: at most {_MAXK} k streams, got {len(ks)}")
    operands = dict(u=(u, "vec"), u_lo=(u_lo, "ulo"), u_hi=(u_hi, "uhi"), q=(q, "sca"),
                    q_lo=(q_lo, "qlo"), q_hi=(q_hi, "qhi"), base=(base, "vec"),
                    base_lo=(base_lo, "slo"), usnew_base=(usnew_base, "vec"),
                    force=(force, "vec"), force_lo=(force_lo, "slo"))
    for j, (k, k_lo) in enumerate(zip(ks, ks_lo)):
        operands[f"k{j + 1}"] = (k, "vec")
        operands[f"k{j + 1}_lo"] = (k_lo, "slo")
    device = _check_halo(name, n, lx, glo, ghi, **operands)
    with torch.cuda.device(device):
        ut = torch.empty_like(u)
        div = torch.empty((lx, n, n), dtype=u.dtype, device=device)
        k_out = torch.empty_like(u) if emit_k else None
        usnew = torch.empty_like(u) if usnew_coeff is not None else None
        u_out = torch.empty_like(u) if emit_u else None
        kptrs = (ctypes.c_void_p * _MAXK)(*[k.data_ptr() for k in ks])
        klo = (ctypes.c_void_p * _MAXK)(*[k.data_ptr() for k in ks_lo])
        kcoef = (ctypes.c_float * _MAXK)(*cks)
        err = _build.load().ins_stage_halo_f32(
            u.data_ptr(), u_lo.data_ptr(), u_hi.data_ptr(), ptr(q), ptr(q_lo), ptr(q_hi),
            ptr(base), ptr(base_lo), kptrs, klo, kcoef, len(ks), cnew, ptr(usnew_base),
            0.0 if usnew_coeff is None else float(usnew_coeff), int(usnew_coeff is not None),
            ptr(k_out), ut.data_ptr(), ptr(usnew), ptr(u_out), div.data_ptr(), lx, n,
            float(visc), float(dxs[0]), float(dxs[1]), float(dxs[2]), float(np.prod(dxs)),
            ptr(force), ptr(force_lo), glo, ghi, current_stream(device),
        )
        _build.check(err, name)
        LAUNCHES[name if force is None else name + "+force"] += 1
    return k_out, ut, div, usnew, u_out


def momentum_stage_divhat_halo_3d(
    u_loc, u_lo, u_hi, streams, streams_lo, coeffs, visc, dxs, vinvy, vinvzT,
    *, precision="manualhigh", emit_k=True, usnew_coeff=None, bodyforce=None,
    bodyforce_lo=None, usnew_base=None, smag=None,
):
    """`momentum_stage_divhat_3d` on an x-slab shard block: ``u_loc``
    (3, lx, n, n), ``u_lo`` (3, 2, n, n) and ``u_hi`` (3, 1, n, n) the ring
    neighbours' boundary planes ((3, 3, n, n) and (3, 2, n, n) with
    ``smag``), each stream (3, lx, n, n) with its plane −1 (3, 1, n, n) in
    ``streams_lo``, ``bodyforce`` likewise with ``bodyforce_lo``.  A
    stream base that is ``u_loc`` itself (and no k streams) is read from
    the stage's own velocity.  Outputs have the block's extent;
    ``divhat`` is (lx, n, n)."""
    _reject_halo_bf16(u_loc)
    if u_loc.device.type == "cpu":
        return momentum_stage_divhat_halo_3d_plain(
            u_loc, u_lo, u_hi, streams, streams_lo, coeffs, visc, dxs, vinvy, vinvzT,
            precision=precision, emit_k=emit_k, usnew_coeff=usnew_coeff,
            bodyforce=bodyforce, bodyforce_lo=bodyforce_lo, usnew_base=usnew_base,
            smag=smag,
        )
    name = "momentum_stage_divhat_halo_3d"
    streams, streams_lo = _halo_streams(name, streams, streams_lo)
    glo, ghi = _halo_ghosts(name, smag, bodyforce, bodyforce_lo, u_lo, u_hi)
    _, lx, n, _ = u_loc.shape
    _check_halo(name, n, lx, vinvy=(vinvy, "mat"), vinvzT=(vinvzT, "mat"))
    force, force_lo = _halo_force(u_loc, u_lo, u_hi, dxs, bodyforce, bodyforce_lo, smag)
    k, ut, div, usnew, _ = _launch_stage_halo(
        name, u_loc, u_lo, u_hi, None, None, None, streams, streams_lo, coeffs, visc, dxs,
        base_is_u=len(streams) == 1 and streams[0] is u_loc, emit_k=emit_k,
        usnew_coeff=usnew_coeff, usnew_base=usnew_base, emit_u=False, force=force,
        force_lo=force_lo, glo=glo, ghi=ghi,
    )
    return _pack(emit_k, k, ut, yz_transform(div, vinvy, vinvzT, precision), usnew)


def pcmsd_hat_halo_3d(
    ut_loc, ut_lo, ut_hi, qhat_loc, qhat_lo, qhat_hi, streams, streams_lo, coeffs, visc,
    dxs, proj, *, precision="manualhigh", emit_k=True, usnew_coeff=None, bodyforce=None,
    bodyforce_lo=None, usnew_base=None, smag=None, emit_u=False,
):
    """`pcmsd_hat_3d` on an x-slab shard block: ``ut_loc`` (3, lx, n, n)
    and ``qhat_loc`` (lx, n, n), ``ut_lo``/``ut_hi`` the ring neighbours'
    2 lower / 1 upper planes of ut, ``qhat_lo``/``qhat_hi`` their 2 / 2
    planes of qhat (the rebuild's x-gradient reads one q plane above the
    velocity's); with ``smag`` 3 / 2 and 3 / 3.  ``streams[0] is RECON``
    (with ``streams_lo[0]`` RECON too) makes the rebuilt u the tableau
    base; ``emit_u`` appends it."""
    _reject_halo_bf16(ut_loc)
    if ut_loc.device.type == "cpu":
        return pcmsd_hat_halo_3d_plain(
            ut_loc, ut_lo, ut_hi, qhat_loc, qhat_lo, qhat_hi, streams, streams_lo, coeffs,
            visc, dxs, proj, precision=precision, emit_k=emit_k, usnew_coeff=usnew_coeff,
            bodyforce=bodyforce, bodyforce_lo=bodyforce_lo, usnew_base=usnew_base,
            smag=smag, emit_u=emit_u,
        )
    name = "pcmsd_hat_halo_3d"
    streams, streams_lo = _halo_streams(name, streams, streams_lo)
    recon = streams[0] is RECON
    if recon and (len(streams) != 1 or streams_lo[0] is not RECON):
        raise ValueError("RECON base allows no k streams, and its lower plane is RECON too")
    glo, ghi = _halo_ghosts(name, smag, bodyforce, bodyforce_lo, ut_lo, ut_hi, qhat_lo,
                            qhat_hi)
    _, lx, n, _ = ut_loc.shape
    _check_halo(name, n, lx, glo, ghi, qhat=(qhat_loc, "sca"), qhat_lo=(qhat_lo, "qlo"),
                qhat_hi=(qhat_hi, "qhi"))
    # q of the block and of its exchanged ghost planes (one transform)
    q = yz_transform(qhat_loc, proj["V"], proj["VT"], precision, inverse=True)
    q_g = yz_transform(torch.cat([qhat_lo, qhat_hi]), proj["V"], proj["VT"], precision,
                       inverse=True)
    q_lo, q_hi = q_g[:glo], q_g[glo:]
    force, force_lo = _halo_force(ut_loc, ut_lo, ut_hi, dxs, bodyforce, bodyforce_lo, smag,
                                  rebuild_q=(q, q_lo, q_hi))
    k, ut, div, usnew, u = _launch_stage_halo(
        name, ut_loc, ut_lo, ut_hi, q, q_lo, q_hi, streams, streams_lo, coeffs, visc,
        dxs, base_is_u=recon, emit_k=emit_k, usnew_coeff=usnew_coeff,
        usnew_base=usnew_base, emit_u=emit_u, force=force, force_lo=force_lo, glo=glo,
        ghi=ghi,
    )
    divhat = yz_transform(div, proj["Vinv"], proj["VinvT"], precision)
    return _pack(emit_k, k, ut, divhat, usnew, u)


def pressure_correct_qhat_halo_3d(ut_loc, qhat_loc, qhat_hi, dxs, vy, vzT,
                                  *, precision="manualhigh"):
    """`pressure_correct_qhat_3d` on an x-slab shard block: ``ut_loc``
    (3, lx, n, n), ``qhat_loc`` (lx, n, n) and ``qhat_hi`` (1, n, n), the
    right ring neighbour's first qhat plane."""
    _reject_halo_bf16(ut_loc)
    if ut_loc.device.type == "cpu":
        return pressure_correct_qhat_halo_3d_plain(ut_loc, qhat_loc, qhat_hi, dxs, vy, vzT,
                                                   precision=precision)
    name = "pressure_correct_qhat_halo_3d"
    _, lx, n, _ = ut_loc.shape
    device = _check_halo(name, n, lx, ut=(ut_loc, "vec"), qhat=(qhat_loc, "sca"),
                         qhat_hi=(qhat_hi, "qhi1"), vy=(vy, "mat"), vzT=(vzT, "mat"))
    with torch.cuda.device(device):
        q = yz_transform(qhat_loc, vy, vzT, precision, inverse=True)
        q_hi = yz_transform(qhat_hi, vy, vzT, precision, inverse=True)
        u = torch.empty_like(ut_loc)
        err = _build.load().ins_correct_halo_f32(
            ut_loc.data_ptr(), q.data_ptr(), q_hi.data_ptr(), u.data_ptr(), lx, n,
            float(dxs[0]), float(dxs[1]), float(dxs[2]), current_stream(device),
        )
        _build.check(err, name)
        LAUNCHES[name] += 1
    return u
