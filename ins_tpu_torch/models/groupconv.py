"""p4 group-equivariant CNN closure (2-D).

Port of `ins_tpu/models/groupconv.py`.  Equivariant to 90-degree
rotations and translations of the staggered velocity field: each layer's
kernel over the rotation states is assembled at call time from a small
set of weights and their rotated copies (weight sharing), then one
circularly padded ``F.conv2d`` runs the layer (the JAX package's
``lax.conv_general_dilated``, outside any Pallas kernel).  Channels are
last and ordered state-major (channel ``n·cout + c``); a lifting layer
takes the two velocity components (x channels, then y channels), a
projecting layer returns them.

Parameters are named as flax names them (``GroupConv2D_{i}.w1`` ...
``.w4`` of shape ``(k, k, cin, cout)``, ``.bias`` ``(cout,)``), the
weights drawn glorot-uniform over axes 2 and 3 and the biases zero.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .closure import collocate, create_closure, decollocate
from .cnn import glorot_uniform_

__all__ = ["rot2", "vecrot2", "rot2stag", "GroupConv2D", "GCNN", "gcnn"]

_GROUP = (0, 1, 2, 3)


def rot2(u, r):
    """Rotate a field 90 degrees counter-clockwise ``r`` times in its first
    two axes."""
    return torch.rot90(u, k=r % 4, dims=(0, 1))


def _vec_mix(rx, ry, r):
    r = r % 4
    if r == 0:
        return rx, ry
    if r == 1:
        return -ry, rx
    if r == 2:
        return -rx, -ry
    return ry, -rx


def vecrot2(u, r):
    """Rotate a 2-D vector field ``(nx, ny, 2)`` (components last)."""
    rx, ry = _vec_mix(rot2(u[..., 0], r), rot2(u[..., 1], r), r)
    return torch.stack([rx, ry], dim=-1)


def rot2stag(u, g):
    """Rotate a staggered ghosted solver field ``(2, N, N)`` by 90 degrees
    ``g`` times, shifting the staggered components back onto their
    faces (the last row or column copies the first interior one)."""
    g = g % 4
    v = vecrot2(torch.stack([u[0], u[1]], dim=-1), g)
    ux, uy = v[..., 0], v[..., 1]
    if g in (1, 2):
        ux = torch.roll(ux, -1, dims=0)
        ux = torch.cat([ux[:-1], ux[1:2]], dim=0)
    if g in (2, 3):
        uy = torch.roll(uy, -1, dims=1)
        uy = torch.cat([uy[:, :-1], uy[:, 1:2]], dim=1)
    return torch.stack([ux, uy])


def _identity(x):
    return x


class GroupConv2D(nn.Module):
    """p4 group convolution: lifting (vector -> 4 rotation states), regular
    (states -> states) or projecting (states -> vector)."""

    def __init__(self, *, kernel_size, cin, cout, activation=_identity, islifting=False,
                 isprojecting=False, use_bias=True, dtype=torch.float32):
        super().__init__()
        if islifting and isprojecting:
            raise ValueError("a group conv lifts or projects, not both")
        self.kernel_size = tuple(kernel_size)
        self.activation = activation
        self.islifting, self.isprojecting = islifting, isprojecting
        nw = 2 if (islifting or isprojecting) else 4
        self.nw = nw
        for i in range(nw):
            self.register_parameter(
                f"w{i + 1}", nn.Parameter(torch.empty((*self.kernel_size, cin, cout), dtype=dtype)))
        self.bias = nn.Parameter(torch.zeros(cout, dtype=dtype)) if use_bias else None

    def reset_parameters(self, generator=None):
        for i in range(self.nw):
            glorot_uniform_(getattr(self, f"w{i + 1}"), in_axis=2, out_axis=3, generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def kernel(self):
        """The layer's (k, k, channels in, channels out) kernel over the
        rotation states."""
        ws = [getattr(self, f"w{i + 1}") for i in range(self.nw)]
        if self.islifting:
            w1, w2 = ws
            return torch.cat([torch.cat(_vec_mix(rot2(w1, n), rot2(w2, n), n), dim=2)
                              for n in _GROUP], dim=3)  # (k, k, 2 cin, 4 cout)
        if self.isprojecting:
            w1, w2 = ws
            return torch.cat([torch.cat(_vec_mix(rot2(w1, m), rot2(w2, m), m), dim=3)
                              for m in _GROUP], dim=2)  # (k, k, 4 cin, 2 cout)
        return torch.cat([torch.cat([rot2(ws[(n - m) % 4], n) for m in _GROUP], dim=2)
                          for n in _GROUP], dim=3)  # (k, k, 4 cin, 4 cout)

    def forward(self, x):
        kh, kw = self.kernel_size
        xp = F.pad(torch.movedim(x, -1, 1), (kw // 2, kw // 2, kh // 2, kh // 2),
                   mode="circular")
        w = torch.movedim(self.kernel().to(x.dtype), (3, 2), (0, 1))  # (out, in, k, k)
        y = torch.movedim(F.conv2d(xp, w), 1, -1)
        if self.bias is not None:
            y = y + self.bias.repeat(2 if self.isprojecting else 4)
        return self.activation(y)


class GCNN(nn.Module):
    """Lifting, regular and projecting group convolutions on the
    collocated 2-D velocity."""

    def __init__(self, *, radii, channels, activations, use_bias, dtype=torch.float32):
        super().__init__()
        self.nlayer = len(radii)
        c = (1,) + tuple(channels)
        for i in range(self.nlayer):
            self.add_module(f"GroupConv2D_{i}", GroupConv2D(
                kernel_size=(2 * radii[i] + 1,) * 2, cin=c[i], cout=c[i + 1],
                activation=activations[i], islifting=i == 0,
                isprojecting=i == self.nlayer - 1, use_bias=use_bias[i], dtype=dtype,
            ))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            for i in range(self.nlayer):
                getattr(self, f"GroupConv2D_{i}").reset_parameters(generator)

    def forward(self, x):
        x = collocate(x)
        for i in range(self.nlayer):
            x = getattr(self, f"GroupConv2D_{i}")(x)
        return decollocate(x)


def gcnn(*, setup, radii, channels, activations, use_bias, generator=None):
    """Build ``(closure, theta)`` of a 2-D p4 G-CNN: ``channels`` count
    rotation-state multiplets, the last must be 1 (one vector field out).
    theta is drawn on the CPU from ``generator`` (a CPU
    `torch.Generator`) and placed on ``setup.device``."""
    if setup.grid.dim != 2:
        raise ValueError("gcnn is 2-D only")
    model = GCNN(radii=tuple(radii), channels=tuple(channels),
                 activations=tuple(activations), use_bias=tuple(use_bias), dtype=setup.dtype)
    model.reset_parameters(generator)
    model.to(setup.device)
    theta = {name: p.detach().clone().requires_grad_(True)
             for name, p in model.named_parameters()}
    return create_closure(model, theta)
