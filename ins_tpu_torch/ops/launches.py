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
    "check_cuda_tensors",
    "ptr",
    "current_stream",
]

KERNELS = (
    # the hat chain (ops/stage_kernels.py, poisson_kernels.py, transforms.py)
    "plane_transform",
    "pcmsd_hat_3d",
    "momentum_stage_divhat_3d",
    "passB",
    "passB_fold",
    # the same under projection_precision "manualhigh" (the JAX package's
    # default): the plane GEMM and the fused pass B in bf16x3 (three bf16
    # products a multiply-add); the keys above are their 3xTF32 forms
    # ("highest")
    "plane_transform+bf16x3",
    "passB+bf16x3",
    "passB_fold+bf16x3",
    "passB_sharded+bf16x3",
    # the folded pass B's level route above `FOLD_FUSED_MAX_N` (cube, shard)
    "passB_fold+levels",
    "passB_sharded+levels",
    # the dense pass B's GEMM route above `DENSE_FUSED_MAX_N` (cube, shard)
    "passB+gemm",
    "passB_sharded+gemm",
    "pressure_correct_qhat_3d",
    # the same with bf16 stream storage, and the stage with more than 4 k
    # streams (the unmerged chain's deep tableau rows)
    "pcmsd_hat_3d+bf16",
    "momentum_stage_divhat_3d+bf16",
    "momentum_stage_divhat_3d+streams",
    "pressure_correct_qhat_3d+bf16",
    # the x-slab halo chain (ops/stage_kernels.py, poisson_kernels.py,
    # smag_kernels.py); "+force": the halo stage with its force stream
    "momentum_stage_divhat_halo_3d",
    "pcmsd_hat_halo_3d",
    "momentum_stage_divhat_halo_3d+force",
    "pcmsd_hat_halo_3d+force",
    "pressure_correct_qhat_halo_3d",
    "passB_sharded",
    "smagorinsky_force_halo_3d",
    # the per-op chain's 3-pass Poisson solve (ops/poisson_kernels.py)
    "poisson_pallas",
    # the Smagorinsky force (ops/smag_kernels.py)
    "smagorinsky_force_3d",
    # the per-op chain (ops/perop_kernels.py)
    "convdiff_interior_3d",
    "stage_div_3d",
    "pressure_correct_3d",
    # the unfused projection step's stage (ops/perop_kernels.py)
    "momentum_stage_div_3d",
    # the closure convolutions (ops/conv_kernels.py): the fused layer (bf16
    # operands on the tensor cores; "+f32": float32 operands in 3xTF32 on
    # the tensor cores) and the tap-matmul / pack-tile layer on z-folded
    # channels (likewise: bf16 on the tensor cores; "+f32" on float32
    # operands: the forwards and the weight gradient in 3xTF32 on the
    # tensor cores)
    "fusedconv_3d",
    "fusedconv_wgrad_3d",
    "fusedconv_3d+f32",
    "fusedconv_wgrad_3d+f32",
    "tapconv_3d",
    "packconv_3d",
    "tapconv_3d+f32",
    "packconv_3d+f32",
    "tapconv_wgrad_3d",
    "tapconv_wgrad_3d+f32",
    # the wall-bounded channel (ops/channel_kernels.py)
    "channel_msd_3d",
    "channel_pressure_correct_3d",
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


def check_cuda_tensors(name, dtypes, **operands):
    """Raise unless every operand is a contiguous CUDA tensor on one
    device with a dtype in ``dtypes`` and its expected shape.  Each value
    is ``(tensor, shape)``, or ``(tensor, shape, dtypes)`` for an operand
    of other dtypes; None tensors are skipped.  Returns the device."""
    device = None
    for label, (t, shape, *own) in operands.items():
        ok = own[0] if own else dtypes
        if t is None:
            continue
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name}: {label} must be a CUDA tensor")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: {label} is on {t.device}, expected {device}")
        if t.dtype not in ok:
            raise TypeError(
                f"{name}: {label} has dtype {t.dtype}; the CUDA kernel takes "
                + " or ".join(str(d) for d in ok)
            )
        if tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{name}: {label} has shape {tuple(t.shape)}, expected {tuple(shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    return device


def check_cuda_operands(name, n, vec_dtype=torch.float32, **operands):
    """`check_cuda_tensors` for the cube kernels: each value is
    ``(tensor, kind)`` with kind ``"vec"`` (3, n, n, n), ``"sca"``
    (n, n, n) or ``"mat"`` (n, n).  The vector fields (velocity-like
    streams) are of ``vec_dtype`` (float32, or bfloat16 for bf16 stream
    storage), the others float32."""
    shapes = {"vec": (3, n, n, n), "sca": (n, n, n), "mat": (n, n)}
    return check_cuda_tensors(
        name, (torch.float32,),
        **{k: (t, shapes[kind]) + (((vec_dtype,),) if kind == "vec" else ())
           for k, (t, kind) in operands.items()},
    )


def ptr(t):
    return None if t is None else t.data_ptr()


def current_stream(device):
    return torch.cuda.current_stream(device).cuda_stream
