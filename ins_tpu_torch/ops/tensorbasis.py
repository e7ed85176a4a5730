"""Pope/Silvis symmetry tensor basis for structural closure models.

Port of `ins_tpu/ops/tensorbasis.py`: three basis tensors and two
invariants in 2-D, eleven and five in 3-D (Silvis 2017, eqs. (9) and
(11)), from the velocity gradient at the pressure points.  Tensors are
stacked channel first, ``(nb, *N, D, D)``, invariants ``(nv, *N)``,
written on the pressure DOF box; `lastdimcontract` contracts
coefficients with the basis.  Gradients come from autograd; `monitor`
is an identity that logs what passes through it on the forward and
the backward pass.
"""

from __future__ import annotations

import logging

import torch

from ._stencil import slc
from .operators import _gradient_matrix

__all__ = ["tensorbasis", "lastdimcontract", "monitor"]

_log = logging.getLogger(__name__)


def tensorbasis(u, setup):
    """``(B, V)``: the tensor basis ``(nb, *N, D, D)`` and the invariants
    ``(nv, *N)`` of the ghosted velocity `u`, zero off the pressure DOF
    box."""
    g = setup.grid
    D = g.dim
    G = _gradient_matrix(u, setup, g.Ip)
    S = (G + G.mT) / 2
    R = (G - G.mT) / 2
    eye = torch.eye(D, dtype=u.dtype, device=u.device).expand(S.shape)

    def tr(x):
        return x.diagonal(dim1=-2, dim2=-1).sum(-1)

    if D == 2:
        Bs = [eye, S, S @ R - R @ S]
        Vs = [torch.sum(S * S, (-2, -1)), torch.sum(R * R, (-2, -1))]
    else:
        SS = S @ S
        RR = R @ R
        Bs = [
            eye,
            S,
            S @ R - R @ S,
            SS,
            RR,
            SS @ R - R @ SS,
            S @ RR + RR @ S,
            R @ S @ RR - RR @ S @ R,
            S @ R @ SS - SS @ R @ S,
            SS @ RR + RR @ SS,
            R @ SS @ RR - RR @ SS @ R,
        ]
        Vs = [tr(SS), tr(RR), tr(SS @ S), tr(S @ RR), tr(SS @ RR)]

    sl = slc(g.Ip)
    B = torch.zeros((len(Bs), *g.N, D, D), dtype=u.dtype, device=u.device)
    V = torch.zeros((len(Vs), *g.N), dtype=u.dtype, device=u.device)
    B[(slice(None),) + sl] = torch.stack(Bs)
    V[(slice(None),) + sl] = torch.stack(Vs)
    return B, V


class _Monitor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tau):
        _log.info("Forward monitor: %s %s", tau.dtype, tuple(tau.shape))
        return tau.view_as(tau)

    @staticmethod
    def backward(ctx, tbar):
        _log.info("Pullback monitor: %s %s", tbar.dtype, tuple(tbar.shape))
        return tbar


def monitor(tau):
    """Identity that logs the dtype and shape of `tau` on the forward pass
    and of its cotangent on the backward pass: dropped into a closure
    chain, it shows what flows through autograd."""
    return _Monitor.apply(tau)


def lastdimcontract(a, b):
    """``c[I] = sum_i a[i, I] b[i, I]``: `a` is ``(n, *N)`` coefficients,
    `b` is ``(n, *N, D, D)`` tensors."""
    return torch.sum(a[..., None, None] * b, 0)
