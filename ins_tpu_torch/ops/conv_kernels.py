"""The CNN closure's convolution layer: periodic k³ conv, bias and
activation, and its gradients.

Port of the fused-layer part of `ins_tpu/ops/convkernels.py`
(`fusedconv_3d`, `fusedconv_wgrad_3d`, `make_fused_layer`).  The contract
is per sample and channels last, with canonical weights:

    fusedconv_3d(h, w, bias, act)   h (nx, ny, nz, cin), w (k, k, k, cin, cout)
                                    -> act(conv(h, w) + bias) (nx, ny, nz, cout)
    fusedconv_wgrad_3d(h, d, k)     -> dw (k, k, k, cin, cout), float32

on a periodic box (every index wraps).  The weights are rounded to h's
dtype, every sum is taken in float32 (float64 for float64 operands) and
the output is stored in ``out_dtype`` (h's dtype by default); ``act`` is
"tanh" or "id" (None).  The TPU plumbing of the JAX kernels (128-lane
padded carry, packed weight tiles, VMEM strips and their shape gates)
does not carry over: the port's gate is 3-D, odd k (3, 5 or 7 on the
card), tanh or identity, float32 or bfloat16.

Each wrapper runs its hand-written CUDA kernel (`csrc/conv.cu`) for CUDA
tensors and raises on what the kernel does not take; for CPU tensors it
runs its plain version beside it (circular pad and ``F.conv3d`` on the
rounded operands).  `make_fused_layer` wraps both kernels as a
`torch.autograd.Function`: forward kernel; backward ``dpre = dact(y, ct)``
in float32 cast to h's dtype, the wgrad kernel for dw, the float32 sum of
dpre for the bias and the forward kernel on dpre with flipped,
transposed taps for dh.  On the card the plain convolution goes through
cuDNN: set ``torch.backends.cudnn.allow_tf32 = False`` for a float32
reference (cuDNN defaults to TF32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build
from .launches import LAUNCHES, check_cuda_tensors, current_stream, note_plain

__all__ = [
    "ACTIVATIONS",
    "fusedconv_3d",
    "fusedconv_3d_plain",
    "fusedconv_wgrad_3d",
    "fusedconv_wgrad_3d_plain",
    "flip_taps",
    "make_fused_layer",
]

# name -> (activation, d(act) from the activation's output y and the
# cotangent ct)
ACTIVATIONS = {
    "id": (None, lambda y, ct: ct),
    "tanh": (torch.tanh, lambda y, ct: ct * (1.0 - y * y)),
}
_KERNEL_K = (3, 5, 7)  # tap counts compiled into csrc/conv.cu
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _actname(act):
    act = "id" if act is None else act
    if act not in ACTIVATIONS:
        raise ValueError(f"act must be one of {sorted(ACTIVATIONS)}, got {act!r}")
    return act


def _acc_dtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def _check_shapes(name, h, k, c):
    if h.dim() != 4:
        raise ValueError(f"{name}: expected a (nx, ny, nz, c) field, got {tuple(h.shape)}")
    if k % 2 != 1:
        raise ValueError(f"{name}: k must be odd, got {k}")
    if h.shape[-1] != c:
        raise ValueError(f"{name}: {h.shape[-1]} channels, the weights take {c}")


def _padded(h, k, dtype):
    """(1, c, nx + k − 1, ...) circularly padded, in `dtype`."""
    r = k // 2
    x = h.to(dtype).permute(3, 0, 1, 2).unsqueeze(0)
    return F.pad(x, (r,) * 6, mode="circular") if r else x


def flip_taps(w):
    """Taps of the input-gradient convolution: w'[dx, dy, dz, o, c] =
    w[k−1−dx, k−1−dy, k−1−dz, c, o]."""
    return w.flip(0, 1, 2).transpose(3, 4)


def fusedconv_3d_plain(h, w, bias=None, act=None, *, out_dtype=None):
    """Plain PyTorch version of `fusedconv_3d`."""
    note_plain("fusedconv_3d", h)
    k = w.shape[0]
    _check_shapes("fusedconv_3d", h, k, w.shape[3])
    act_fn = ACTIVATIONS[_actname(act)][0]
    acc = _acc_dtype(h.dtype)
    wt = w.to(h.dtype).to(acc).permute(4, 3, 0, 1, 2)  # (cout, cin, kx, ky, kz)
    y = F.conv3d(_padded(h, k, acc), wt)[0].permute(1, 2, 3, 0)
    if bias is not None:
        y = y + bias.to(acc)
    if act_fn is not None:
        y = act_fn(y)
    return y.to(out_dtype or h.dtype)


def fusedconv_wgrad_3d_plain(h, d, k):
    """Plain PyTorch version of `fusedconv_wgrad_3d`."""
    note_plain("fusedconv_wgrad_3d", h)
    _check_shapes("fusedconv_wgrad_3d", h, k, h.shape[-1])
    acc = _acc_dtype(h.dtype)
    cin, cout = h.shape[-1], d.shape[-1]
    dw = torch.nn.grad.conv3d_weight(
        _padded(h, k, acc), (cout, cin, k, k, k), d.to(acc).permute(3, 0, 1, 2).unsqueeze(0)
    )
    return dw.permute(2, 3, 4, 1, 0).to(torch.promote_types(acc, torch.float32))


def _check_kernel_operands(name, k, **operands):
    if k not in _KERNEL_K:
        raise NotImplementedError(f"{name}: the CUDA kernel is built for k in {_KERNEL_K}")
    return check_cuda_tensors(name, _KERNEL_DTYPES, **operands)


def fusedconv_3d(h, w, bias=None, act=None, *, out_dtype=None):
    """Periodic k³ convolution + bias + activation, channels last:
    ``h (nx, ny, nz, cin)``, ``w (k, k, k, cin, cout)``, ``bias (cout,)``
    or None, ``act`` "tanh" or "id"/None.  Returns
    ``(nx, ny, nz, cout)`` in ``out_dtype`` (default h's dtype)."""
    if h.device.type == "cpu":
        return fusedconv_3d_plain(h, w, bias, act, out_dtype=out_dtype)
    k, cin, cout = w.shape[0], w.shape[3], w.shape[4]
    _check_shapes("fusedconv_3d", h, k, cin)
    act = _actname(act)
    out_dtype = out_dtype or h.dtype
    if w.shape != (k, k, k, cin, cout):
        raise ValueError(f"fusedconv_3d: weights of shape {tuple(w.shape)}")
    if out_dtype not in _KERNEL_DTYPES:
        raise TypeError(f"fusedconv_3d: out_dtype {out_dtype} is not float32 or bfloat16")
    box = tuple(h.shape[:3])
    device = _check_kernel_operands("fusedconv_3d", k, h=(h, (*box, cin)))
    with torch.cuda.device(device):
        wk = w.detach().to(device=device, dtype=h.dtype).float().contiguous()
        bk = None if bias is None else bias.detach().to(device, torch.float32).contiguous()
        if bk is not None and bk.shape != (cout,):
            raise ValueError(f"fusedconv_3d: bias of shape {tuple(bk.shape)}")
        out = torch.empty((*box, cout), dtype=out_dtype, device=device)
        err = _build.load().ins_conv_fwd(
            h.data_ptr(), int(h.dtype == torch.bfloat16), wk.data_ptr(),
            None if bk is None else bk.data_ptr(), int(act == "tanh"), out.data_ptr(),
            int(out_dtype == torch.bfloat16), *box, cin, cout, k, current_stream(device),
        )
        _build.check(err, "fusedconv_3d")
        LAUNCHES["fusedconv_3d"] += 1
    return out


def fusedconv_wgrad_3d(h, d, k):
    """Weight gradient of the periodic k³ convolution:
    ``dw[dx, dy, dz, c, o] = Σ_cells h[x+dx−r, y+dy−r, z+dz−r, c]·d[x, y, z, o]``
    for ``h (nx, ny, nz, cin)`` and the pre-activation cotangent
    ``d (nx, ny, nz, cout)``; float32 ``(k, k, k, cin, cout)``, the same
    on every run."""
    if h.device.type == "cpu":
        return fusedconv_wgrad_3d_plain(h, d, k)
    _check_shapes("fusedconv_wgrad_3d", h, k, h.shape[-1])
    box, cin, cout = tuple(h.shape[:3]), h.shape[-1], d.shape[-1]
    device = _check_kernel_operands(
        "fusedconv_wgrad_3d", k, h=(h, (*box, cin)), d=(d, (*box, cout))
    )
    with torch.cuda.device(device):
        lib = _build.load()
        nchunk = lib.ins_conv_wgrad_chunks(*box)
        partial = torch.empty((nchunk, k, k, k, cin, cout), dtype=torch.float32, device=device)
        dw = torch.empty((k, k, k, cin, cout), dtype=torch.float32, device=device)
        err = lib.ins_conv_wgrad(
            h.data_ptr(), int(h.dtype == torch.bfloat16), d.data_ptr(),
            int(d.dtype == torch.bfloat16), partial.data_ptr(), dw.data_ptr(), *box,
            cin, cout, k, current_stream(device),
        )
        _build.check(err, "fusedconv_wgrad_3d")
        LAUNCHES["fusedconv_wgrad_3d"] += 1
    return dw


class _FusedLayerFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, bias, actname, ops):
        fwd, _ = ops
        y = fwd(h, w, bias, actname)
        ctx.save_for_backward(h, w, y)
        ctx.actname, ctx.ops, ctx.has_bias = actname, ops, bias is not None
        return y

    @staticmethod
    def backward(ctx, ct):
        h, w, y = ctx.saved_tensors
        fwd, wgrad = ctx.ops
        acc = _acc_dtype(h.dtype)
        dpre32 = ACTIVATIONS[ctx.actname][1](y.to(acc), ct.to(acc))
        dpre = dpre32.to(h.dtype).contiguous()
        dw = wgrad(h, dpre, w.shape[0]).to(w.dtype) if ctx.needs_input_grad[1] else None
        db = dpre32.sum(dim=(0, 1, 2)).to(w.dtype) if ctx.has_bias else None
        dh = None
        if ctx.needs_input_grad[0]:
            dh = fwd(dpre, flip_taps(w), None, "id")
        return dh, dw, db, None, None


def make_fused_layer(actname, has_bias, *, cin, cout, k, plain=False):
    """Differentiable conv layer over canonical weights:
    ``layer(h, w, bias) -> act(conv(h, w) + bias)`` with kernel forward
    and backward (dh: the forward kernel with flipped, transposed taps;
    dw: the wgrad kernel).  h: (nx, ny, nz, cin); w: (k, k, k, cin,
    cout); bias: (cout,) or None; returns (nx, ny, nz, cout) in h's
    dtype.  ``plain=True`` puts the plain versions in both passes."""
    actname = _actname(actname)
    fwd = fusedconv_3d_plain if plain else fusedconv_3d
    ops = (fwd, fusedconv_wgrad_3d_plain if plain else fusedconv_wgrad_3d)

    def layer(h, w, bias=None):
        if h.shape[-1] != cin or w.shape != (k, k, k, cin, cout):
            raise ValueError(
                f"layer ({cin} -> {cout}, k={k}) got h {tuple(h.shape)}, w {tuple(w.shape)}"
            )
        return _FusedLayerFn.apply(h, w, bias if has_bias else None, actname, ops)

    return layer
