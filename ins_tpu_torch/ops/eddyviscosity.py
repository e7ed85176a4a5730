"""The natural-form Smagorinsky closure on uniform periodic grids.

Port of `smagorinsky_natural_interior` and `smagorinsky_closure_natural`
from `ins_tpu/ops/eddyviscosity.py`.  Strain components live at their
natural staggered positions; the eddy viscosity ``θ² d² √(2 S:S)`` (with
the off-diagonal strains averaged from their four edges) multiplies the
strain into the stress ``σ = 2 ν S`` (viscosity averaged to the edges),
and the closure force is the stress divergence.  On a uniform periodic
grid every stencil shift is a circular roll (the interior form); the
fast path runs the same force through `ops/smag_kernels.py`.  The ghosted
pipeline for other grids (`strain_natural`, `divoftensor_natural`) waits
for ROADMAP queue 1 item 7.
"""

from __future__ import annotations

import torch

from .diffkernels import roll_m, roll_p

__all__ = ["smagorinsky_natural_interior", "smagorinsky_closure_natural"]


def theta_tensor(theta, dtype, device):
    """θ (a float or a one-element tensor) as a 0-d tensor of ``dtype`` on
    ``device``: a tensor stays differentiable (a view where it already has
    the dtype and device), a float becomes a fill kernel, not a host copy."""
    if theta is None:
        raise ValueError("the Smagorinsky closure needs theta (its constant)")
    if torch.is_tensor(theta):
        if theta.numel() != 1:
            raise ValueError(f"theta must be a scalar, got shape {tuple(theta.shape)}")
        return theta.reshape(()).to(device=device, dtype=dtype)
    return torch.full((), float(theta), dtype=dtype, device=device)


def _natural_interior(u, theta, dxs, d2):
    """`smagorinsky_natural_interior` with the filter width ``d2`` given."""
    D = u.shape[0]
    if torch.is_tensor(theta):
        theta = theta.reshape(())
    S = {}
    for a in range(D):
        S[(a, a)] = (u[a] - roll_m(u[a], a)) / dxs[a]
        for b in range(a + 1, D):
            S[(a, b)] = 0.5 * (
                (roll_p(u[a], b) - u[a]) / dxs[b] + (roll_p(u[b], a) - u[b]) / dxs[a]
            )
    acc = 0.0
    for a in range(D):
        acc = acc + 2.0 * S[(a, a)] ** 2
        for b in range(a + 1, D):
            s = S[(a, b)]
            acc = acc + (
                s**2 + roll_m(s, a) ** 2 + roll_m(s, b) ** 2
                + roll_m(roll_m(s, a), b) ** 2
            )
    nu = theta**2 * d2 * torch.sqrt(acc)
    sig = {}
    for a in range(D):
        sig[(a, a)] = 2.0 * nu * S[(a, a)]
        for b in range(a + 1, D):
            nue = (nu + roll_p(nu, a) + roll_p(nu, b) + roll_p(roll_p(nu, a), b)) / 4
            sig[(a, b)] = 2.0 * nue * S[(a, b)]
    out = []
    for a in range(D):
        c = 0.0
        for b in range(D):
            s = sig[(min(a, b), max(a, b))]
            if a == b:
                c = c + (roll_p(s, a) - s) / dxs[a]
            else:
                c = c + (s - roll_m(s, b)) / dxs[b]
        out.append(c)
    return torch.stack(out)


def smagorinsky_natural_interior(u, theta, dxs):
    """Natural-form Smagorinsky force on a ghost-free uniform periodic
    interior field ``(D, *n)`` (any D), every stencil shift a circular
    roll.  ``theta`` is a float or a 0-d tensor and stays differentiable.
    The plain version of the force kernel and the oracle of its tests."""
    return _natural_interior(u, theta, dxs, sum(dx * dx for dx in dxs))


def smagorinsky_closure_natural(setup):
    """The natural-form Smagorinsky closure ``m(u, θ)`` on the ghosted
    layout, tagged ``kind = "smagorinsky_natural"`` so the periodic fast
    path runs its force kernel instead.  Uniform periodic grids only."""
    g = setup.grid
    if not (all(g.periodic) and all(g.uniform)):
        raise NotImplementedError(
            "the natural-form Smagorinsky closure is ported for uniform periodic "
            "grids; other grids need the ghosted strain_natural / "
            "divoftensor_natural pipeline (ROADMAP queue 1 item 7)"
        )
    from .fastpath import reghost, strip_ghosts
    from .pressure import uniform_dxs

    dxs = uniform_dxs(setup)

    def closure(u, theta):
        return reghost(smagorinsky_natural_interior(strip_ghosts(u), theta, dxs))

    closure.kind = "smagorinsky_natural"
    return closure
