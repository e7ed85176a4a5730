"""Fourier neural operator closure.

Port of `ins_tpu/models/fno.py` on `torch.fft`.  Each `FourierLayer`
adds a pointwise (1x1) path to a spectral one: FFT, keep the modes of
the low and high bands (2(kmax + 1) per dim), mix the channels per mode
with the complex weights ``R[..., 0] + i R[..., 1]``, zero-pad back to
the grid and take the real part of the inverse FFT.  `FNO` stacks the
layers between `collocate` and `decollocate`, then two 1x1 convolutions
(the second without bias).  Channels last, plain PyTorch (the JAX
package computes it outside any Pallas kernel too).

Parameters are named as flax names them (``FourierLayer_{i}.spatial_weight``
``(cin, cout)``, ``FourierLayer_{i}.spectral_weights`` ``(nk,) * D +
(cout, cin, 2)``, ``Conv_0.kernel`` / ``.bias``, ``Conv_1.kernel``, the
kernels ``(1,) * D + (cin, cout)``) and drawn with flax's initialisers
(glorot-uniform weights, lecun-normal convolution kernels, zero biases).
The JAX package passes ``jax.nn.gelu``, whose default is the tanh
approximation: its counterpart is ``F.gelu(x, approximate="tanh")``.
"""

from __future__ import annotations

import string

import torch
from torch import nn

from .closure import collocate, create_closure, decollocate
from .cnn import glorot_uniform_, lecun_normal_

__all__ = ["fno", "FNO", "FourierLayer"]


def _identity(x):
    return x


class FourierLayer(nn.Module):
    """One Fourier layer on ``(b, *nx, cin)`` with all nx equal and
    2(kmax + 1) <= nx."""

    def __init__(self, *, kmax, cin, cout, D, activation=_identity, dtype=torch.float32):
        super().__init__()
        self.kmax, self.activation = kmax, activation
        nk = 2 * (kmax + 1)
        self.spatial_weight = nn.Parameter(torch.empty((cin, cout), dtype=dtype))
        self.spectral_weights = nn.Parameter(torch.empty((nk,) * D + (cout, cin, 2), dtype=dtype))
        modes = string.ascii_lowercase[:D]
        self._mix = f"{modes}yz,n{modes}z->n{modes}y"

    def reset_parameters(self, generator=None):
        glorot_uniform_(self.spatial_weight, generator=generator)
        glorot_uniform_(self.spectral_weights, in_axis=-2, out_axis=-3, generator=generator)

    def forward(self, x):
        D = x.dim() - 2
        K = x.shape[1]
        if any(s != K for s in x.shape[1:-1]):
            raise ValueError("the FNO needs a cubic grid")
        kmax = self.kmax
        nk = 2 * (kmax + 1)
        if nk > K:
            raise ValueError(f"kmax = {kmax} too large for a grid of {K}")
        y = torch.einsum("...a,ab->...b", x, self.spatial_weight)

        dims = tuple(range(1, D + 1))
        keep = torch.cat([torch.arange(kmax + 1), torch.arange(K - kmax - 1, K)]).to(x.device)
        xhat = torch.fft.fftn(x, dim=dims)
        for d in dims:
            xhat = xhat.index_select(d, keep)
        R = self.spectral_weights
        z = torch.einsum(self._mix, torch.complex(R[..., 0], R[..., 1]), xhat)
        for d in dims:
            lo, hi = z.narrow(d, 0, kmax + 1), z.narrow(d, kmax + 1, kmax + 1)
            pad = list(lo.shape)
            pad[d] = K - nk
            z = torch.cat([lo, z.new_zeros(pad), hi], dim=d)
        z = torch.fft.ifftn(z, dim=dims).real.to(x.dtype)
        return self.activation(y + z)


class _Conv1x1(nn.Module):
    """flax's ``nn.Conv`` with a 1x1 kernel ``(1,) * D + (cin, cout)``."""

    def __init__(self, cin, cout, D, use_bias, dtype):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty((1,) * D + (cin, cout), dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(cout, dtype=dtype)) if use_bias else None

    def reset_parameters(self, generator=None):
        lecun_normal_(self.kernel, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        y = torch.einsum("...a,ab->...b", x, self.kernel.reshape(self.kernel.shape[-2:]))
        return y if self.bias is None else y + self.bias


class FNO(nn.Module):
    """Fourier layers on the collocated velocity, then 1x1 convolutions to
    2c channels (``psi``) and to D force channels."""

    def __init__(self, *, kmax, channels, activations, psi, D, dtype=torch.float32):
        super().__init__()
        self.psi = psi
        cin = D
        self.nlayer = len(kmax)
        for i, (k, c, act) in enumerate(zip(kmax, channels, activations)):
            self.add_module(f"FourierLayer_{i}", FourierLayer(
                kmax=k, cin=cin, cout=c, D=D, activation=act, dtype=dtype))
            cin = c
        self.Conv_0 = _Conv1x1(cin, 2 * cin, D, True, dtype)
        self.Conv_1 = _Conv1x1(2 * cin, D, D, False, dtype)

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            for i in range(self.nlayer):
                getattr(self, f"FourierLayer_{i}").reset_parameters(generator)
            self.Conv_0.reset_parameters(generator)
            self.Conv_1.reset_parameters(generator)

    def forward(self, x):
        x = collocate(x)
        for i in range(self.nlayer):
            x = getattr(self, f"FourierLayer_{i}")(x)
        return decollocate(self.Conv_1(self.psi(self.Conv_0(x))))


def fno(*, setup, kmax, c, sigma, psi, generator=None):
    """Build ``(closure, theta)``: ``closure(x, theta)`` on ``(nsample,
    *n, D)`` (n equal in every dim) and theta, the dict of its
    parameters, drawn on the CPU from ``generator`` (a CPU
    `torch.Generator`) and placed on ``setup.device``."""
    g = setup.grid
    n = tuple(e - s for (s, e) in g.Iu[0])
    if any(m != n[0] for m in n):
        raise ValueError("the FNO needs a cubic grid")
    model = FNO(kmax=tuple(kmax), channels=tuple(c), activations=tuple(sigma), psi=psi,
                D=g.dim, dtype=setup.dtype)
    model.reset_parameters(generator)
    model.to(setup.device)
    theta = {name: p.detach().clone().requires_grad_(True)
             for name, p in model.named_parameters()}
    return create_closure(model, theta)
