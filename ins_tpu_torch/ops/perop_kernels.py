"""The per-op kernels of the differentiable fast path.

Port of `convdiff_interior_3d`, `stage_div_3d` and `pressure_correct_3d`
from `ins_tpu/ops/pallas_kernels.py`, with the JAX functions' signatures
and layouts (component-first interior velocity ``(3, nx, ny, nz)`` on any
periodic box, scalars ``(nx, ny, nz)``, physical pressure):

    convdiff_interior_3d   F = convdiff_roll(u)
    stage_div_3d           ut = base + coeff·k;
                           div = vol·Σ_a (ut_a − ut_a[I − e_a]) / dx_a
    pressure_correct_3d    u = ut − ∇q   (forward differences)

Each wrapper runs its hand-written CUDA kernel (`csrc/perop.cu`) for
float32 CUDA tensors and raises on anything else on the card; for CPU
tensors it runs its plain PyTorch version, beside it here.  The
conv-diff kernel multiplies by the reciprocals `convdiff_recips` hands
it (1/dx_b and visc/dx_b², formed in float64) and forms each face flux
once a cell, as the JAX kernel's shifted-flux identity does.  The
differentiable wrappers around them are in `ops/diffkernels.py`.

The stage of the unfused projection step (`momentum_stage_div_3d` →
Poisson solve → `pressure_correct_3d`, which the fused hat step
replaces) and the ghosted form of the conv-diff are here too:

    momentum_stage_div_3d          k = convdiff(u); ut = base + coeff·k;
                                   div = vol·div(ut)   (a cube)
    convdiff_periodic_uniform_3d   convdiff_interior_3d on the interior of
                                   a ghosted (3, nx+2, ny+2, nz+2) field,
                                   the ghost entries zero

On the card `momentum_stage_div_3d` is `csrc/stage.cu`'s float32 stage
with a stream base, no k streams, ``cnew = coeff``, k emitted and no
transform after it (launch key ``"momentum_stage_div_3d"``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .diffkernels import convdiff_roll, roll_m, roll_p
from .launches import LAUNCHES, check_cuda_tensors, current_stream, note_plain
from .stage_kernels import _check_cube, _launch_stage, _stage_plain

__all__ = [
    "convdiff_interior_3d",
    "convdiff_interior_3d_plain",
    "convdiff_recips",
    "stage_div_3d",
    "stage_div_3d_plain",
    "pressure_correct_3d",
    "pressure_correct_3d_plain",
    "momentum_stage_div_3d",
    "momentum_stage_div_3d_plain",
    "convdiff_periodic_uniform_3d",
    "convdiff_periodic_uniform_3d_plain",
]

_F32 = (torch.float32,)


def _box(name, u):
    if u.dim() != 4 or u.shape[0] != 3:
        raise ValueError(f"{name}: expected a (3, nx, ny, nz) field, got {tuple(u.shape)}")
    return tuple(u.shape[1:])


def convdiff_interior_3d_plain(u_int, visc, dx):
    """Plain PyTorch version of `convdiff_interior_3d`."""
    note_plain("convdiff_interior_3d", u_int)
    _box("convdiff_interior_3d", u_int)
    return convdiff_roll(u_int, visc, dx)


def stage_div_3d_plain(base_int, k_int, coeff, dxs):
    """Plain PyTorch version of `stage_div_3d`."""
    note_plain("stage_div_3d", base_int)
    _box("stage_div_3d", base_int)
    ut = base_int + coeff * k_int
    vol = float(np.prod(dxs))
    div = sum((ut[a] - roll_m(ut[a], a)) / dxs[a] for a in range(3)) * vol
    return ut, div


def pressure_correct_3d_plain(ut_int, q_int, dxs):
    """Plain PyTorch version of `pressure_correct_3d`."""
    note_plain("pressure_correct_3d", ut_int)
    _box("pressure_correct_3d", ut_int)
    return ut_int - torch.stack([(roll_p(q_int, a) - q_int) / dxs[a] for a in range(3)])


def convdiff_recips(visc, dx):
    """``(1/dx_0, 1/dx_1, 1/dx_2, visc/dx_0², visc/dx_1², visc/dx_2²)`` in
    float64: the conv-diff kernel multiplies by them (rounded to float32)
    where `convdiff_roll` divides."""
    rdx = tuple(1.0 / float(d) for d in dx)
    return rdx + tuple(float(visc) / (float(d) * float(d)) for d in dx)


def convdiff_interior_3d(u_int, visc, dx):
    """Convection + diffusion on the ghost-free periodic interior field
    ``(3, nx, ny, nz)``; returns F of the same shape."""
    if u_int.device.type == "cpu":
        return convdiff_interior_3d_plain(u_int, visc, dx)
    box = _box("convdiff_interior_3d", u_int)
    device = check_cuda_tensors("convdiff_interior_3d", _F32, u=(u_int, (3, *box)))
    with torch.cuda.device(device):
        f = torch.empty_like(u_int)
        err = _build.load().ins_convdiff_f32(
            u_int.data_ptr(), f.data_ptr(), *box, *convdiff_recips(visc, dx),
            current_stream(device),
        )
        _build.check(err, "convdiff_interior_3d")
        LAUNCHES["convdiff_interior_3d"] += 1
    return f


def stage_div_3d(base_int, k_int, coeff, dxs):
    """RK stage update and volume-scaled divergence in one pass:
    ``ut = base + coeff·k``, ``div = vol·div(ut)``.  ``coeff`` is a
    number (a tensor is read back to the host once)."""
    if base_int.device.type == "cpu":
        return stage_div_3d_plain(base_int, k_int, coeff, dxs)
    box = _box("stage_div_3d", base_int)
    device = check_cuda_tensors(
        "stage_div_3d", _F32, base=(base_int, (3, *box)), k=(k_int, (3, *box))
    )
    with torch.cuda.device(device):
        ut = torch.empty_like(base_int)
        div = torch.empty(box, dtype=base_int.dtype, device=device)
        err = _build.load().ins_stage_div_f32(
            base_int.data_ptr(), k_int.data_ptr(), float(coeff), ut.data_ptr(),
            div.data_ptr(), *box, float(dxs[0]), float(dxs[1]), float(dxs[2]),
            float(np.prod(dxs)), current_stream(device),
        )
        _build.check(err, "stage_div_3d")
        LAUNCHES["stage_div_3d"] += 1
    return ut, div


def pressure_correct_3d(ut_int, q_int, dxs):
    """Pressure correction ``u = ut − ∇q`` on the interior layout, q
    physical."""
    if ut_int.device.type == "cpu":
        return pressure_correct_3d_plain(ut_int, q_int, dxs)
    box = _box("pressure_correct_3d", ut_int)
    device = check_cuda_tensors(
        "pressure_correct_3d", _F32, ut=(ut_int, (3, *box)), q=(q_int, box)
    )
    with torch.cuda.device(device):
        u = torch.empty_like(ut_int)
        err = _build.load().ins_pressure_correct_f32(
            ut_int.data_ptr(), q_int.data_ptr(), u.data_ptr(), *box,
            float(dxs[0]), float(dxs[1]), float(dxs[2]), current_stream(device),
        )
        _build.check(err, "pressure_correct_3d")
        LAUNCHES["pressure_correct_3d"] += 1
    return u


def momentum_stage_div_3d_plain(u_int, base_int, coeff, visc, dxs):
    """Plain PyTorch version of `momentum_stage_div_3d`."""
    note_plain("momentum_stage_div_3d", u_int)
    _check_cube("momentum_stage_div_3d", u_int, base_int)
    k, ut, div, _ = _stage_plain(u_int, base_int, [], [], coeff, visc, dxs, None, None, None,
                                 None)
    return k, ut, div


def momentum_stage_div_3d(u_int, base_int, coeff, visc, dxs):
    """Momentum, RK stage update and volume-scaled divergence in one pass
    on the interior layout of a cube: ``k = convdiff(u)``, ``ut = base +
    coeff·k``, ``div = vol·div(ut)``; returns ``(k, ut, div)``.
    ``coeff`` is a number or a 0-d tensor (on the card the kernel takes
    it as a float: a tensor there costs one host read)."""
    if u_int.device.type == "cpu":
        return momentum_stage_div_3d_plain(u_int, base_int, coeff, visc, dxs)
    n = _check_cube("momentum_stage_div_3d", u_int, base_int)
    check_cuda_tensors("momentum_stage_div_3d", _F32, u=(u_int, (3, n, n, n)),
                       base=(base_int, (3, n, n, n)))
    k, ut, div, *_ = _launch_stage(
        "momentum_stage_div_3d", u_int, None, base_int, (), (), float(coeff), visc, dxs,
        emit_k=True, usnew_coeff=None, usnew_base=None, emit_u=False, force=None, temp=None,
    )
    return k, ut, div


def _ghost_pad(f):
    return torch.nn.functional.pad(f, (1,) * 6)


def convdiff_periodic_uniform_3d_plain(u, visc, dx):
    """Plain PyTorch version of `convdiff_periodic_uniform_3d`."""
    return _ghost_pad(convdiff_interior_3d_plain(u[:, 1:-1, 1:-1, 1:-1], visc, dx))


def convdiff_periodic_uniform_3d(u, visc, dx):
    """Convection + diffusion of a ghosted periodic field ``(3, nx+2,
    ny+2, nz+2)`` (its ghosts are not read: the interior wraps); returns
    F of the same shape with zero ghost entries."""
    if u.device.type == "cpu":
        return convdiff_periodic_uniform_3d_plain(u, visc, dx)
    return _ghost_pad(convdiff_interior_3d(u[:, 1:-1, 1:-1, 1:-1].contiguous(), visc, dx))
