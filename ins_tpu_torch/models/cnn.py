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
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.conv_kernels import make_fused_layer
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
