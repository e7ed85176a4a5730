"""Launch accounting and operand checks shared by the kernel wrappers.

`LAUNCHES[name]` counts the launches of a kernel wrapper's CUDA kernel;
it is incremented right after that launch and nowhere else.
`PLAIN_ON_CUDA[name]` counts calls of the wrapper's plain PyTorch version
on CUDA tensors, which only a deliberate plain-chain run makes.  A run
resets both, drives the solver and reads them back to show which path
it took (see `chip_smoke.py`).
"""

from __future__ import annotations

import torch

__all__ = [
    "KERNELS",
    "LAUNCHES",
    "PLAIN_ON_CUDA",
    "reset_counts",
    "note_plain",
    "check_cuda_operands",
    "ptr",
    "current_stream",
]

KERNELS = (
    "plane_transform",
    "pcmsd_hat_3d",
    "momentum_stage_divhat_3d",
    "passB",
    "pressure_correct_qhat_3d",
)
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_ON_CUDA = dict.fromkeys(KERNELS, 0)


def reset_counts():
    for name in KERNELS:
        LAUNCHES[name] = 0
        PLAIN_ON_CUDA[name] = 0


def note_plain(name, t):
    """Record a plain-version call (counted only on CUDA tensors)."""
    if t.is_cuda:
        PLAIN_ON_CUDA[name] += 1


def check_cuda_operands(name, n, **operands):
    """Raise unless every operand is a contiguous float32 CUDA tensor on
    one device with its expected shape.  Each value is ``(tensor, kind)``
    with kind ``"vec"`` (3, n, n, n), ``"sca"`` (n, n, n) or ``"mat"``
    (n, n); None tensors are skipped."""
    shapes = {"vec": (3, n, n, n), "sca": (n, n, n), "mat": (n, n)}
    device = None
    for label, (t, kind) in operands.items():
        if t is None:
            continue
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name}: {label} must be a CUDA tensor")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: {label} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(
                f"{name}: {label} has dtype {t.dtype}; the CUDA kernels take "
                "float32 (bf16 streams are ROADMAP queue 1 item 6)"
            )
        if tuple(t.shape) != shapes[kind]:
            raise ValueError(
                f"{name}: {label} has shape {tuple(t.shape)}, expected {shapes[kind]}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    return device


def ptr(t):
    return None if t is None else t.data_ptr()


def current_stream(device):
    return torch.cuda.current_stream(device).cuda_stream
