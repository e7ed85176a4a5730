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

`smagorinsky_force_halo_3d` (port of the JAX function of that name) is
the same force on an x-slab shard block ``(3, lx, ny, nz)`` of a 1-D mesh
(`parallel/halo.py`), the ring neighbours' 2 lower and 2 upper x-planes
given as separate ghost arrays; the CUDA side is the ``HALO`` flag of
`csrc/smag.cu`.  `_force_halo` is its general form for the halo stage
kernels' ``smag=`` option (`ops/stage_kernels.py`): 3 lower ghost planes
give the force at plane −1 too, which the stage's backward divergence at
x = 0 reads.  The plain version concatenates the ghosts around the block,
runs the periodic roll twin on it and keeps the planes whose stencils
the ghosts cover.
"""

from __future__ import annotations

import torch

from .. import _build
from .diffkernels import roll_p
from .eddyviscosity import _natural_interior, theta_tensor
from .launches import LAUNCHES, check_cuda_tensors, current_stream, note_plain, ptr

__all__ = [
    "smagorinsky_force_3d",
    "smagorinsky_force_3d_plain",
    "smagorinsky_force_halo_3d",
    "smagorinsky_force_halo_3d_plain",
]


def _d2(dxs):
    return float(sum(dx * dx for dx in dxs))


def _grad(q, dxs):
    return torch.stack([(roll_p(q, a) - q) / dxs[a] for a in range(3)])


def _force_plain(u, theta, dxs, d2, bodyforce=None, rebuild_q=None):
    note_plain("smagorinsky_force_3d", u)
    if rebuild_q is not None:
        u = u - _grad(rebuild_q, dxs)
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


# ----------------------------------------------------------------------
# the x-slab shard block (parallel/halo.py)
# ----------------------------------------------------------------------

_NAME_HALO = "smagorinsky_force_halo_3d"


def _halo_args(u, u_lo, u_hi, bodyforce, bodyforce_lo, rebuild_q, x_first):
    """Check the shard block's ghost counts: glo lower (2, or 3 where the
    output starts at plane −1) and 2 upper planes of u, glo and 3 of q,
    the body force's plane −1 where the output has it."""
    if u.dim() != 4 or u.shape[0] != 3:
        raise ValueError(f"{_NAME_HALO}: expected (3, lx, ny, nz), got {tuple(u.shape)}")
    if x_first not in (0, -1):
        raise ValueError(f"{_NAME_HALO}: the output starts at plane 0 or -1, not {x_first}")
    glo = 2 - x_first
    _, lx, ny, nz = u.shape
    want = {"u_lo": (u_lo, (3, glo, ny, nz)), "u_hi": (u_hi, (3, 2, ny, nz)),
            "bodyforce": (bodyforce, u.shape)}
    if x_first < 0 and bodyforce is not None:
        want["bodyforce_lo"] = (bodyforce_lo, (3, 1, ny, nz))
    if rebuild_q is not None:
        q, q_lo, q_hi = rebuild_q
        want.update(q=(q, (lx, ny, nz)), q_lo=(q_lo, (glo, ny, nz)), q_hi=(q_hi, (3, ny, nz)))
    for label, (t, shape) in want.items():
        if t is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{_NAME_HALO}: {label} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t is None and label.endswith("_lo"):
            raise ValueError(f"{_NAME_HALO}: {label} is required here")
    return glo


def _force_halo_plain(u, u_lo, u_hi, theta, dxs, d2, bodyforce=None, bodyforce_lo=None,
                      rebuild_q=None, x_first=0):
    """(force on planes 0 .. lx − 1, force at plane −1 or None)."""
    note_plain(_NAME_HALO, u)
    glo = _halo_args(u, u_lo, u_hi, bodyforce, bodyforce_lo, rebuild_q, x_first)
    lx = u.shape[1]
    u_ext = torch.cat([u_lo, u, u_hi], dim=1)  # planes -glo .. lx + 1
    if rebuild_q is not None:
        # q on planes -glo .. lx + 2: the x-roll's wrap at the last q plane
        # falls on the dropped plane lx + 2
        q, q_lo, q_hi = rebuild_q
        u_ext = u_ext - _grad(torch.cat([q_lo, q, q_hi]), dxs)[:, : u_ext.shape[1]]
    # the force of plane x reads u on x - 2 .. x + 2: the roll's wrap
    # reaches only the dropped edge planes
    f = _natural_interior(u_ext, theta, dxs, d2)[:, glo + x_first: glo + lx]
    if bodyforce is not None:
        f = f + (bodyforce if x_first == 0 else torch.cat([bodyforce_lo, bodyforce], dim=1))
    return (f, None) if x_first == 0 else (f[:, 1:], f[:, :1])


def _force_halo(u, u_lo, u_hi, theta, dxs, d2, bodyforce=None, bodyforce_lo=None,
                rebuild_q=None, x_first=0):
    """`_force_halo_plain` on CPU tensors, the kernel on CUDA tensors:
    ``rebuild_q = (q, q_lo, q_hi)`` evaluates the force on u − ∇q (q
    physical); ``x_first = -1`` also returns the force at plane −1 (3
    lower ghost planes; the body force there is ``bodyforce_lo``)."""
    if u.device.type == "cpu":
        return _force_halo_plain(u, u_lo, u_hi, theta, dxs, d2, bodyforce, bodyforce_lo,
                                 rebuild_q, x_first)
    glo = _halo_args(u, u_lo, u_hi, bodyforce, bodyforce_lo, rebuild_q, x_first)
    _, lx, ny, nz = u.shape
    q, q_lo, q_hi = rebuild_q if rebuild_q is not None else (None, None, None)
    bf_lo = bodyforce_lo if x_first < 0 else None
    device = check_cuda_tensors(
        _NAME_HALO, (torch.float32,), u=(u, u.shape), u_lo=(u_lo, u_lo.shape),
        u_hi=(u_hi, u_hi.shape), q=(q, (lx, ny, nz)), q_lo=(q_lo, (glo, ny, nz)),
        q_hi=(q_hi, (3, ny, nz)), bodyforce=(bodyforce, u.shape),
        bodyforce_lo=(bf_lo, (3, 1, ny, nz)),
    )
    with torch.cuda.device(device):
        th = theta_tensor(theta, torch.float32, device).detach()
        out = torch.empty_like(u)
        out_lo = torch.empty((3, 1, ny, nz), dtype=u.dtype, device=device) if x_first else None
        err = _build.load().ins_smag_halo_f32(
            u.data_ptr(), u_lo.data_ptr(), u_hi.data_ptr(), ptr(q), ptr(q_lo), ptr(q_hi),
            ptr(bodyforce), ptr(bf_lo), th.data_ptr(), out.data_ptr(), ptr(out_lo), lx, ny,
            nz, glo, x_first, float(dxs[0]), float(dxs[1]), float(dxs[2]), float(d2),
            current_stream(device),
        )
        _build.check(err, _NAME_HALO)
        LAUNCHES[_NAME_HALO] += 1
    return out, out_lo


def smagorinsky_force_halo_3d_plain(u_loc, u_lo, u_hi, theta, dxs, *, bodyforce=None,
                                    rebuild_q=None):
    """Plain PyTorch version of `smagorinsky_force_halo_3d`."""
    return _force_halo_plain(u_loc, u_lo, u_hi, theta, dxs, _d2(dxs), bodyforce,
                             rebuild_q=rebuild_q)[0]


def smagorinsky_force_halo_3d(u_loc, u_lo, u_hi, theta, dxs, *, bodyforce=None,
                              rebuild_q=None):
    """`smagorinsky_force_3d` on an x-slab shard block: ``u_loc`` (3, lx,
    ny, nz), ``u_lo``/``u_hi`` (3, 2, ny, nz) the ring neighbours' boundary
    planes, ``bodyforce`` (steady) the block's; returns (3, lx, ny, nz).
    ``rebuild_q = (q_loc, q_lo, q_hi)`` ((lx, ny, nz), 2 lower and 3 upper
    planes of a physical pressure) evaluates the force on u − ∇q."""
    return _force_halo(u_loc, u_lo, u_hi, theta, dxs, _d2(dxs), bodyforce,
                       rebuild_q=rebuild_q)[0]
