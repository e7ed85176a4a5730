"""The wall-bounded channel's kernels.

Port of `channel_msd_3d` and `channel_pressure_correct_3d` from
`ins_tpu/ops/channel_kernels.py`, with the JAX functions' argument
contract, on the interior channel layout (``(3, nx, ny, nz)`` velocity,
``(nx, ny, nz)`` scalars, any box; see `ops/channelpath.py`):

    channel_msd_3d               [u = t − ∇q/Δu (qrecon)]; k = convdiff(u) + force;
                                 us = ustart + dt·ca·k; acc' = acc + dt·cb·k;
                                 div of the projection target
    channel_pressure_correct_3d  u = target − ∇q/Δu

Each wrapper launches its hand-written CUDA kernel (`csrc/channel.cu`)
for float32 CUDA tensors and raises on anything else on the card; for
CPU tensors it runs its plain PyTorch version, beside it here: the roll
functions of `ops/channelpath.py` composed, in the tensors' dtype.  The
stage kernel takes 1/dx, 1/dy, 1/dx², 1/dy² from the host
(`channel_recips`) and walks 16 x-planes a block (`CH_XB`,
`csrc/channel_geometry.cuh`).
"""

from __future__ import annotations

import torch

from .. import _build
from .channelpath import (
    channel_convdiff_roll,
    channel_correct_roll,
    channel_divergence_roll,
)
from .launches import LAUNCHES, check_cuda_tensors, current_stream, note_plain, ptr
from .perop_kernels import _box

__all__ = [
    "channel_recips",
    "pack_zmet",
    "channel_msd_3d",
    "channel_msd_3d_plain",
    "channel_pressure_correct_3d",
    "channel_pressure_correct_3d_plain",
]

# row order of the packed metric block (csrc/channel.cu reads it so)
_ZVECS = (
    "inv_dz", "inv_da_t", "inv_db_t", "inv_duz", "inv_da_n", "inv_db_n",
    "az1", "az2", "azz_m1", "azz_m2", "azz_c1", "azz_c2",
)
_F32 = (torch.float32,)


def pack_zmet(met):
    """The 12 z-metric vectors of `met` packed into one ``(12, nz)`` tensor
    (dtype and device of the vectors)."""
    return torch.stack([getattr(met, name) for name in _ZVECS]).contiguous()


def channel_recips(met):
    """(1/dx, 1/dy, 1/dx², 1/dy²) of the uniform transverse spacings, in
    float64: the stage kernel multiplies by them (in float32) where the
    roll functions divide."""
    dx, dy = float(met.dx), float(met.dy)
    return 1.0 / dx, 1.0 / dy, 1.0 / (dx * dx), 1.0 / (dy * dy)


def _check_modes(ustart, qrecon, emit_urec):
    if ustart is None and qrecon is None:
        raise ValueError("channel_msd_3d: ustart=None needs qrecon (stage 0 of the hat chain)")
    if emit_urec and (qrecon is None or ustart is not None):
        raise ValueError("channel_msd_3d: emit_urec needs qrecon and ustart=None")


def channel_msd_3d_plain(u, ustart, acc, met, *, visc, ca, cb, dt, force=None,
                         div_of_acc=False, qrecon=None, emit_urec=False):
    """Plain PyTorch version of `channel_msd_3d`."""
    note_plain("channel_msd_3d", u)
    _box("channel_msd_3d", u)
    _check_modes(ustart, qrecon, emit_urec)
    urec = u if qrecon is None else channel_correct_roll(u, qrecon, met)
    k = channel_convdiff_roll(urec, met, visc)
    if force is not None:
        k = k + force
    base = urec if ustart is None else ustart
    acc_base = base if acc is None else acc
    acc_out = acc_base + (dt * cb) * k if cb != 0.0 else acc_base
    us = None if div_of_acc else base + (dt * ca) * k
    div = channel_divergence_roll(acc_out if div_of_acc else us, met)
    if emit_urec:
        return urec, us, acc_out, div
    return us, acc_out, div


def channel_msd_3d(u, ustart, acc, met, *, visc, ca, cb, dt, force=None,
                   div_of_acc=False, qrecon=None, emit_urec=False):
    """Fused momentum + classic-row tableau + stage divergence.

    Returns ``(us, acc_out, div)`` (``(urec, us, acc_out, div)`` with
    ``emit_urec``): the stage velocity ``ustart + dt·ca·k`` (None when
    ``div_of_acc``), the b-row accumulator ``acc + dt·cb·k`` (``acc=None``:
    the accumulator is still ustart) and the divergence of the projection
    target (``acc_out`` when ``div_of_acc``, else ``us``); k is the
    conv-diff plus the steady ``force``.  With ``qrecon``, ``u`` is the
    previous stage's unprojected target and the kernel rebuilds
    ``u − ∇qrecon/Δu`` on chip; ``ustart=None`` then means stage 0 of the
    hat chain, where the rebuilt velocity is the tableau base (written out
    once with ``emit_urec``)."""
    if u.device.type == "cpu":
        return channel_msd_3d_plain(
            u, ustart, acc, met, visc=visc, ca=ca, cb=cb, dt=dt, force=force,
            div_of_acc=div_of_acc, qrecon=qrecon, emit_urec=emit_urec,
        )
    box = _box("channel_msd_3d", u)
    _check_modes(ustart, qrecon, emit_urec)
    # the base is read only where a stage velocity is formed or the
    # accumulator starts from it
    if div_of_acc and acc is not None:
        ustart = None
    vec = (3, *box)
    device = check_cuda_tensors(
        "channel_msd_3d", _F32, u=(u, vec), qrecon=(qrecon, box), ustart=(ustart, vec),
        acc=(acc, vec), force=(force, vec), zmet=(met.zmet, (12, box[2])),
    )
    with torch.cuda.device(device):
        urec = torch.empty_like(u) if emit_urec else None
        us = None if div_of_acc else torch.empty_like(u)
        acc_out = torch.empty_like(u)
        div = torch.empty(box, dtype=u.dtype, device=device)
        err = _build.load().ins_channel_msd_f32(
            u.data_ptr(), ptr(qrecon), ptr(ustart), ptr(acc), ptr(force), met.zmet.data_ptr(),
            ptr(urec), ptr(us), acc_out.data_ptr(), div.data_ptr(), *box,
            float(visc), *channel_recips(met), float(met.gb[0]), float(met.gb[1]),
            float(met.gt[0]), float(met.gt[1]), float(dt * ca), float(dt * cb),
            int(cb != 0.0), int(div_of_acc), current_stream(device),
        )
        _build.check(err, "channel_msd_3d")
        LAUNCHES["channel_msd_3d"] += 1
    if emit_urec:
        return urec, us, acc_out, div
    return us, acc_out, div


def channel_pressure_correct_3d_plain(target, q, met):
    """Plain PyTorch version of `channel_pressure_correct_3d`."""
    note_plain("channel_pressure_correct_3d", target)
    _box("channel_pressure_correct_3d", target)
    return channel_correct_roll(target, q, met)


def channel_pressure_correct_3d(target, q, met):
    """``u = target − ∇q/Δu`` on the interior channel layout (the w divisor
    is 0 at the pinned slot, which keeps it 0)."""
    if target.device.type == "cpu":
        return channel_pressure_correct_3d_plain(target, q, met)
    box = _box("channel_pressure_correct_3d", target)
    device = check_cuda_tensors(
        "channel_pressure_correct_3d", _F32, target=(target, (3, *box)), q=(q, box),
        zmet=(met.zmet, (12, box[2])),
    )
    with torch.cuda.device(device):
        u = torch.empty_like(target)
        err = _build.load().ins_channel_correct_f32(
            target.data_ptr(), q.data_ptr(), met.zmet.data_ptr(), u.data_ptr(), *box,
            float(met.dx), float(met.dy), current_stream(device),
        )
        _build.check(err, "channel_pressure_correct_3d")
        LAUNCHES["channel_pressure_correct_3d"] += 1
    return u
