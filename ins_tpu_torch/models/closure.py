"""Closure-model wrapping and staggered <-> collocated adapters.

Port of `ins_tpu/models/closure.py`.  NN tensors are batch-first,
channels last ``(nsample, *nx, D)``; solver fields are component-first
ghosted ``(D, *N)``.  `wrappedclosure` adapts between them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["collocate", "decollocate", "create_closure", "wrappedclosure"]


def collocate(u):
    """Interpolate velocity components from right faces to volume centres
    (periodic): channel a averaged with its roll(+1) along axis a.
    `u`: (nsample, *nx, D)."""
    D = u.shape[-1]
    return torch.stack(
        [(u[..., a] + torch.roll(u[..., a], 1, dims=1 + a)) / 2 for a in range(D)], dim=-1
    )


def decollocate(u):
    """Interpolate the closure force from volume centres back to faces."""
    D = u.shape[-1]
    return torch.stack(
        [(u[..., a] + torch.roll(u[..., a], -1, dims=1 + a)) / 2 for a in range(D)], dim=-1
    )


def create_closure(module, theta):
    """``closure(x, theta)`` evaluating `module` with the parameters in
    the dict `theta` (`torch.func.functional_call`); returns
    ``(closure, theta)``."""

    def closure(x, theta):
        return torch.func.functional_call(module, theta, (x,))

    return closure, theta


def wrappedclosure(m, setup):
    """Adapt an NN closure ``(nsample, *nx, D) -> (nsample, *nx, D)`` to
    the solver's field convention ``(D, *N)`` with ghost volumes.
    Periodic grids only."""
    g = setup.grid
    D = g.dim
    inside = g.Iu[0]
    if not all(box == inside for box in g.Iu):
        raise ValueError("wrappedclosure supports periodic grids only")
    sl = (slice(None),) + tuple(slice(s, e) for (s, e) in inside)

    def neuralclosure(u, theta):
        ui = u[sl]  # (D, *n)
        x = torch.movedim(ui, 0, -1).unsqueeze(0)  # (1, *n, D)
        mu = torch.movedim(m(x, theta)[0], -1, 0)  # (D, *n)
        # restore the ghost shape with circular padding
        return F.pad(mu.unsqueeze(0), (1,) * (2 * D), mode="circular")[0]

    return neuralclosure
