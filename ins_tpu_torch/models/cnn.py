"""CNN closure model.

Port of `ins_tpu/models/cnn.py`: a stack of circular-padded k³
convolutions on the collocated velocity, its output interpolated back to
the staggered faces.  Every layer is the fused conv layer of
`ops/conv_kernels.py` (conv + bias + tanh/identity): the hand-written
CUDA kernels for tensors on the card, their plain versions on the CPU.
As in the JAX package's kernel path, the input is cast to the compute
dtype once and each layer stores its output in it (float32 sums, bias
and activation in between); ``compute_dtype=None`` means bfloat16 for a
float32 model.  The JAX package's XLA tap-folding path and its x-chunking
are TPU memory devices and have no counterpart.

Parameters live in a plain dict ``theta`` of leaf tensors named as
flax names them (``conv{i}_kernel`` with canonical shape
``(k, k, k, cin, cout)``, ``conv{i}_bias``), so `convert` carries them
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
    or "id" (probed on a small tensor); raise for anything else."""
    if act in (torch.tanh, torch.nn.functional.tanh):
        return "tanh"
    probe = torch.tensor([[0.625, -1.5]], dtype=torch.float32)
    with torch.no_grad():
        out = act(probe)
    if torch.equal(out, probe):
        return "id"
    if torch.allclose(out, torch.tanh(probe)):
        return "tanh"
    raise NotImplementedError(
        f"activation {act!r} is not tanh or the identity: the port's conv "
        "layers fuse only those two (ROADMAP queue 1 item 9)"
    )


def lecun_normal_(w, generator=None):
    """flax's ``lecun_normal``: truncated normal on ±2σ with σ² = 1/fan_in
    (fan_in = taps × input channels), rescaled to that variance."""
    fan_in = math.prod(w.shape[:-1])
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


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


class CNN(nn.Module):
    """Conv stack on ``(nsample, nx, ny, nz, 3)`` staggered velocities."""

    def __init__(self, *, radii, channels, activations, use_bias, D=3,
                 dtype=torch.float32, compute_dtype=None, plain=False):
        super().__init__()
        if D != 3:
            raise NotImplementedError(
                "the port's CNN closure is 3-D (its conv layers are 3-D kernels)"
            )
        if channels[-1] != D:
            raise ValueError("the last layer must output D force channels")
        self.radii = tuple(radii)
        self.channels = tuple(channels)
        self.use_bias = tuple(use_bias)
        self.dtype = dtype
        self.compute_dtype = compute_dtype or (
            torch.bfloat16 if dtype == torch.float32 else dtype
        )
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
            self.layers.append(make_fused_layer(
                _actname(activations[i]), self.use_bias[i], cin=cin, cout=cout, k=k,
                plain=plain,
            ))
            cin = cout

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            for i in range(len(self.radii)):
                lecun_normal_(getattr(self, f"conv{i}_kernel"), generator)
                if self.use_bias[i]:
                    getattr(self, f"conv{i}_bias").zero_()

    def forward(self, x):
        in_dtype = x.dtype
        x = collocate(x.to(self.dtype))
        outs = []
        for s in range(x.shape[0]):
            h = x[s].to(self.compute_dtype).contiguous()
            for i, layer in enumerate(self.layers):
                h = layer(h, getattr(self, f"conv{i}_kernel"),
                          getattr(self, f"conv{i}_bias", None))
            outs.append(h)
        return decollocate(torch.stack(outs).to(in_dtype))


def cnn(*, setup, radii, channels, activations, use_bias, generator=None,
        compute_dtype=None, plain=False):
    """Build ``(closure, theta)``: ``closure(x, theta)`` on
    ``(nsample, nx, ny, nz, 3)`` and theta, the dict of its parameters
    (lecun-normal kernels drawn on the CPU from `generator`, a CPU
    `torch.Generator`; zero biases) on ``setup.device``.
    ``compute_dtype``: the conv operand dtype — None is bfloat16 for a
    float32 setup; pass ``torch.float32`` for float32 convs.
    ``plain=True`` runs the layers' plain versions on any device (the
    reference closure on the card)."""
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
