"""The Smagorinsky force kernel.

Port of `smagorinsky_force_3d` from `ins_tpu/ops/pallas_kernels.py`: the
natural-form Smagorinsky force ``∇·(2 ν_t S)`` (strain, eddy viscosity,
stress, tensor divergence) on a periodic ``(3, nx, ny, nz)`` field, with
an optional steady body force added, in one pass.  ``rebuild_q`` (a
physical pressure ``(nx, ny, nz)``) makes the kernel evaluate the force
on ``u − ∇q`` rebuilt while loading, as the merged stage does, so the
hat chain never materialises u for it.

On CUDA tensors the wrapper launches the hand-written kernel of
`csrc/smag.cu` (float32; θ is read from a one-element device tensor, so
the chain never syncs the host for it); on CPU tensors it runs the plain
version, the roll twin `smagorinsky_natural_interior`.  A CUDA call
either launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .. import _build
from .diffkernels import roll_p
from .eddyviscosity import _natural_interior, theta_tensor
from .launches import LAUNCHES, check_cuda_tensors, current_stream, note_plain, ptr

__all__ = ["smagorinsky_force_3d", "smagorinsky_force_3d_plain"]


def _d2(dxs):
    return float(sum(dx * dx for dx in dxs))


def _force_plain(u, theta, dxs, d2, bodyforce=None, rebuild_q=None):
    note_plain("smagorinsky_force_3d", u)
    if rebuild_q is not None:
        u = u - torch.stack([(roll_p(rebuild_q, a) - rebuild_q) / dxs[a] for a in range(3)])
    f = _natural_interior(u, theta, dxs, d2)
    return f if bodyforce is None else f + bodyforce


def _force(u, theta, dxs, d2, bodyforce=None, rebuild_q=None):
    """The force with filter width ``d2`` (the stage kernels' ``smag=``
    passes its own): the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if u.device.type == "cpu":
        return _force_plain(u, theta, dxs, d2, bodyforce, rebuild_q)
    if u.dim() != 4 or u.shape[0] != 3:
        raise ValueError(f"smagorinsky_force_3d: expected (3, nx, ny, nz), got {tuple(u.shape)}")
    box = tuple(u.shape[1:])
    device = check_cuda_tensors(
        "smagorinsky_force_3d", (torch.float32,), u=(u, u.shape),
        rebuild_q=(rebuild_q, box), bodyforce=(bodyforce, u.shape),
    )
    with torch.cuda.device(device):
        th = theta_tensor(theta, torch.float32, device).detach()
        out = torch.empty_like(u)
        err = _build.load().ins_smag_f32(
            u.data_ptr(), ptr(rebuild_q), ptr(bodyforce), th.data_ptr(), out.data_ptr(),
            *box, float(dxs[0]), float(dxs[1]), float(dxs[2]), float(d2),
            current_stream(device),
        )
        _build.check(err, "smagorinsky_force_3d")
        LAUNCHES["smagorinsky_force_3d"] += 1
    return out


def smagorinsky_force_3d_plain(u, theta, dxs, *, bodyforce=None, rebuild_q=None):
    """Plain PyTorch version of `smagorinsky_force_3d`."""
    return _force_plain(u, theta, dxs, _d2(dxs), bodyforce, rebuild_q)


def smagorinsky_force_3d(u, theta, dxs, *, bodyforce=None, rebuild_q=None):
    """Natural-form Smagorinsky force (+ ``bodyforce``) on the interior
    periodic field ``u`` — or, with ``rebuild_q``, on ``u − ∇q``."""
    return _force(u, theta, dxs, _d2(dxs), bodyforce, rebuild_q)
