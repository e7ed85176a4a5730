"""CNN closure model.

Port of `ins_tpu/models/cnn.py`: a stack of circular-padded k^D
convolutions on the collocated velocity, its output interpolated back to
the staggered faces.  A 3-D stack whose activations are all tanh or the
identity runs every layer as the fused conv layer of
`ops/conv_kernels.py` (conv + bias + tanh/identity): the hand-written
CUDA kernels for tensors on the card, their plain versions on the CPU.
As in the JAX package's kernel path, the input is cast to the compute
dtype once and each layer stores its output in it (float32 sums, bias
and activation in between); ``compute_dtype=None`` means bfloat16 for a
float32 model.

Any other stack (every 2-D CNN, and a 3-D one with another activation)
runs as the JAX package runs it outside its Pallas kernels
(`_fold_conv`, a ``lax.conv`` per layer): each layer a circular pad and
``F.conv2d`` / ``F.conv3d`` on operands rounded to the compute dtype,
its output cast back to the model's dtype, then the bias and the
activation.  The rule is all or nothing, as in the JAX package: a 3-D
tanh/identity stack never takes the library convolution.  The JAX
package's tap folding and x-chunking of that path are TPU devices (the
MXU's contraction fill, and its HBM at 128³); 80 GB holds a 128³ stack
unchunked, so neither has a counterpart.

Parameters live in a plain dict ``theta`` of leaf tensors named as
flax names them (``conv{i}_kernel`` with canonical shape
``(k,) * D + (cin, cout)``, ``conv{i}_bias``), so `convert` carries them
between the two packages.

`_pallas_conv_layer` is the JAX package's other form of one layer (its
probe path; `CNN` calls it in neither package): the z taps folded into
channels (`_zfold`), x/y wrap pads and the tap layer of
`ops/conv_kernels.py` (`make_conv_layer`: the pack-tile or tap-matmul
kernels) on the same canonical weights (`_fold_w`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv_kernels import make_conv_layer, make_fused_layer, stage_channels
from .closure import collocate, create_closure, decollocate

__all__ = ["cnn", "CNN"]


def _actname(act):
    """Map an activation callable to a kernel activation name: "tanh"
    or "id" (probed on a small tensor); None for anything else."""
    if act in (torch.tanh, torch.nn.functional.tanh):
        return "tanh"
    probe = torch.tensor([[0.625, -1.5]], dtype=torch.float32)
    with torch.no_grad():
        out = act(probe)
    if torch.equal(out, probe):
        return "id"
    if torch.allclose(out, torch.tanh(probe)):
        return "tanh"
    return None


def lecun_normal_(w, generator=None):
    """flax's ``lecun_normal``: truncated normal on ±2σ with σ² = 1/fan_in
    (fan_in = taps × input channels), rescaled to that variance."""
    fan_in = math.prod(w.shape[:-1])
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


def glorot_uniform_(w, in_axis=-2, out_axis=-1, generator=None):
    """flax's ``glorot_uniform(in_axis, out_axis)``: uniform on ±√(6 /
    (fan_in + fan_out)), each fan its axis's size times the receptive
    field (the product of the other axes)."""
    shape = w.shape
    receptive = math.prod(shape) // (shape[in_axis] * shape[out_axis])
    limit = math.sqrt(6.0 / ((shape[in_axis] + shape[out_axis]) * receptive))
    return nn.init.uniform_(w, -limit, limit, generator=generator)


def _zfold(h, r):
    """Fold the z taps into channels: wrap-pad z by r and concatenate the
    k = 2r + 1 z-shifted slices on channels, dz major, then zero channels
    up to `stage_channels` (a multiple of 8 for bfloat16, which the
    card's tensor-core kernels stage 8 channels a copy; the JAX glue pads
    to 128 lanes)."""
    nz, cin = h.shape[2], h.shape[3]
    hz = torch.cat([h[:, :, nz - r:], h, h[:, :, :r]], dim=2)
    parts = [hz[:, :, dz:dz + nz] for dz in range(2 * r + 1)]
    pad = stage_channels((2 * r + 1) * cin, h.dtype) - (2 * r + 1) * cin
    if pad:
        parts.append(h.new_zeros((*h.shape[:3], pad)))
    return torch.cat(parts, dim=-1)


def _fold_w(w, dtype):
    """Canonical (kx, ky, kz, cin, cout) weights -> z-folded (kx, ky,
    kz·cin, cout) in ``dtype`` (dz major, as `_zfold` concatenates), with
    zero rows for `_zfold`'s zero channels."""
    kx, ky, kz, cin, cout = w.shape
    wf = w.reshape(kx, ky, kz * cin, cout).to(dtype)
    return F.pad(wf, (0, 0, 0, stage_channels(kz * cin, dtype) - kz * cin))


def _wrap_pad(g, r, dim):
    n = g.shape[dim]
    return torch.cat([g.narrow(dim, n - r, r), g, g.narrow(dim, 0, r)], dim=dim)


def _unwrap(t, r, dim):
    """The adjoint of `_wrap_pad`: the halo rows added back onto the rows
    they copy."""
    n = t.shape[dim] - 2 * r
    out = t.narrow(dim, r, n).clone()
    out.narrow(dim, n - r, r).add_(t.narrow(dim, 0, r))
    out.narrow(dim, 0, r).add_(t.narrow(dim, n + r, r))
    return out


class _FoldPadFn(torch.autograd.Function):
    """`_zfold` of h in ``dtype``, then the y (and, with ``pad_x``, x)
    wrap pads.  The backward adds the gradient's z-shifted slices and
    wrapped halo rows in float32 (float64 for float64) and rounds once,
    to h's dtype; autograd of the copies would add them in ``dtype``,
    in bf16 several roundings a cell."""

    @staticmethod
    def forward(ctx, h, r, pad_x, dtype):
        ctx.r, ctx.pad_x, ctx.cin = r, pad_x, h.shape[-1]
        g = _zfold(h.to(dtype), r)
        if pad_x:
            g = _wrap_pad(g, r, 0)
        return _wrap_pad(g, r, 1).contiguous()

    @staticmethod
    def backward(ctx, gg):
        r, cin = ctx.r, ctx.cin
        acc = torch.promote_types(gg.dtype, torch.float32)
        dh = None
        for dz in range(2 * r + 1):
            d = _unwrap(gg[..., dz * cin:(dz + 1) * cin].to(acc), r, 1)
            if ctx.pad_x:
                d = _unwrap(d, r, 0)
            # slice dz of cell z copies h at z + dz − r (wrapped)
            d = torch.roll(d, dz - r, dims=2)
            dh = d if dh is None else dh + d
        return dh, None, None, None


def _pallas_conv_layer(h, w, b, r, pad_x, actname, compute_dtype, *, plain=False, pack=None):
    """One closure conv layer through the tap layer: ``h`` per sample
    (nx, ny, nz, cin), ``w`` canonical (k, k, k, cin, cout), ``b`` (cout,)
    or None, ``actname`` "tanh" or "id".  Without ``pad_x`` the caller
    supplies the x halo and the output has nx − 2r planes.  The operands
    are rounded to ``compute_dtype``, the sums float32; returns (nx, ny,
    nz, cout) in h's dtype.  ``plain=True`` runs the plain versions;
    ``pack`` overrides `make_conv_layer`'s choice of forward.  The input
    gradient's z-fold and wrap contributions are added in float32
    (`_FoldPadFn`)."""
    g = _FoldPadFn.apply(h, r, pad_x, compute_dtype)
    layer = make_conv_layer(actname, b is not None, pack=pack, plain=plain)
    return layer(g, _fold_w(w, compute_dtype), b).to(h.dtype)


def _conv_layer(h, w, b, act, compute_dtype):
    """One layer off the kernel path (the JAX package's `_fold_conv`, bias
    and activation): h (nsample, *spatial, cin) circularly padded by r,
    a VALID ``F.conv{D}d`` on operands in ``compute_dtype``, the output
    cast back to h's dtype, then ``act(out + b)``."""
    D = h.dim() - 2
    r = w.shape[0] // 2
    x = torch.movedim(h.to(compute_dtype), -1, 1)
    if r:
        x = F.pad(x, (r,) * (2 * D), mode="circular")
    wt = torch.movedim(w.to(compute_dtype), (-1, -2), (0, 1))  # (cout, cin, *taps)
    y = torch.movedim((F.conv2d if D == 2 else F.conv3d)(x, wt), 1, -1).to(h.dtype)
    if b is not None:
        y = y + b
    return act(y)


class CNN(nn.Module):
    """Conv stack on ``(nsample, *n, D)`` staggered velocities, D = 2 or 3."""

    def __init__(self, *, radii, channels, activations, use_bias, D=3,
                 dtype=torch.float32, compute_dtype=None, plain=False):
        super().__init__()
        if D not in (2, 3):
            raise ValueError(f"the CNN closure is 2-D or 3-D, not {D}-D")
        if channels[-1] != D:
            raise ValueError("the last layer must output D force channels")
        self.radii = tuple(radii)
        self.channels = tuple(channels)
        self.use_bias = tuple(use_bias)
        self.activations = tuple(activations)
        self.dtype = dtype
        self.compute_dtype = compute_dtype or (
            torch.bfloat16 if dtype == torch.float32 else dtype
        )
        actnames = [_actname(a) for a in self.activations]
        # all or nothing: the kernel layers take 3-D tanh/identity stacks
        self.on_kernels = D == 3 and None not in actnames
        self.layers = []
        cin = D
        for i, (r, cout) in enumerate(zip(self.radii, self.channels)):
            k = 2 * r + 1
            self.register_parameter(
                f"conv{i}_kernel", nn.Parameter(torch.empty((k,) * D + (cin, cout), dtype=dtype))
            )
            if self.use_bias[i]:
                self.register_parameter(
                    f"conv{i}_bias", nn.Parameter(torch.zeros(cout, dtype=dtype))
                )
            if self.on_kernels:
                self.layers.append(make_fused_layer(
                    actnames[i], self.use_bias[i], cin=cin, cout=cout, k=k, plain=plain,
                ))
            cin = cout

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            for i in range(len(self.radii)):
                lecun_normal_(getattr(self, f"conv{i}_kernel"), generator)
                if self.use_bias[i]:
                    getattr(self, f"conv{i}_bias").zero_()

    def _weights(self, i):
        return getattr(self, f"conv{i}_kernel"), getattr(self, f"conv{i}_bias", None)

    def forward(self, x):
        in_dtype = x.dtype
        x = collocate(x.to(self.dtype))
        if not self.on_kernels:
            for i, act in enumerate(self.activations):
                x = _conv_layer(x, *self._weights(i), act, self.compute_dtype)
            return decollocate(x.to(in_dtype))
        outs = []
        for s in range(x.shape[0]):
            h = x[s].to(self.compute_dtype).contiguous()
            for i, layer in enumerate(self.layers):
                h = layer(h, *self._weights(i))
            outs.append(h)
        return decollocate(torch.stack(outs).to(in_dtype))


def cnn(*, setup, radii, channels, activations, use_bias, generator=None,
        compute_dtype=None, plain=False):
    """Build ``(closure, theta)``: ``closure(x, theta)`` on
    ``(nsample, *n, D)`` and theta, the dict of its parameters
    (lecun-normal kernels drawn on the CPU from `generator`, a CPU
    `torch.Generator`; zero biases) on ``setup.device``.
    ``compute_dtype``: the conv operand dtype — None is bfloat16 for a
    float32 setup; pass ``torch.float32`` for float32 convs.
    ``plain=True`` runs the kernel layers' plain versions on any device
    (the reference closure on the card)."""
    model = CNN(
        radii=radii, channels=channels, activations=activations, use_bias=use_bias,
        D=setup.grid.dim, dtype=setup.dtype, compute_dtype=compute_dtype, plain=plain,
    )
    model.reset_parameters(generator)
    model.to(setup.device)
    theta = {
        name: p.detach().clone().requires_grad_(True) for name, p in model.named_parameters()
    }
    return create_closure(model, theta)
