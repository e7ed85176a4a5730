"""Smagorinsky eddy-viscosity closures.

Port of `ins_tpu/ops/eddyviscosity.py`, in its two forms:

- **Natural-position form** (`smagorinsky_closure_natural`): the strain
  components live at their natural staggered positions
  (`strain_natural`); the eddy viscosity ``θ² d² √(2 S:S)``
  (`smagorinsky_viscosity`, the off-diagonal strains averaged from their
  four edges) multiplies the strain into the stress ``σ = 2 ν S``
  (`apply_eddy_viscosity`, the viscosity averaged to the edges), and the
  force is the stress divergence (`divoftensor_natural`).  The ghosts of
  the intermediate fields are wrapped on periodic dimensions.  On a
  uniform periodic grid every stencil shift is a circular roll (the
  interior form, `smagorinsky_natural_interior`), which the fast path
  runs through its force kernel (`ops/smag_kernels.py`); on any other
  grid the closure runs the ghosted pipeline on the general path.
- **Pressure-point form** (`smagorinsky_closure`): the full D×D stress at
  the pressure points (`_smagtensor`), ghost-filled by `apply_bc_p`, and
  its interpolated divergence (`divoftensor`).
"""

from __future__ import annotations

import torch

from ..boundary_conditions import apply_bc_p
from ._stencil import dseg, slc, take, take2
from .diffkernels import roll_m, roll_p
from .operators import _gradient_tensor, _on_box, wrap_periodic_ghosts

__all__ = [
    "strain_natural",
    "smagorinsky_viscosity",
    "apply_eddy_viscosity",
    "divoftensor_natural",
    "smagorinsky_natural_interior",
    "smagorinsky_closure_natural",
    "smagorinsky_closure",
    "divoftensor",
]

# natural strain component order: 2-D (xx, yy, xy); 3-D (xx, yy, zz, xy, xz, yz)
_PAIRS = {2: [(0, 0), (1, 1), (0, 1)], 3: [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)]}


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


def strain_natural(u, setup):
    """Strain-rate components at their natural staggered positions: a dict
    keyed by (a, b), a <= b, of full-N fields written on ``Ip``."""
    g = setup.grid
    box = g.Ip

    def ddiag(a):
        return (take(u[a], box) - take(u[a], box, a, -1)) / dseg(setup.dgrid.delta_u[a], box, a)

    def doff(a, b):
        dab = (take(u[a], box, b, +1) - take(u[a], box)) / dseg(setup.dgrid.delta[b], box, b)
        dba = (take(u[b], box, a, +1) - take(u[b], box)) / dseg(setup.dgrid.delta[a], box, a)
        return (dab + dba) / 2

    return {(a, b): _on_box(setup, box, ddiag(a) if a == b else doff(a, b))
            for (a, b) in _PAIRS[g.dim]}


def smagorinsky_viscosity(S, theta, setup):
    """Eddy viscosity θ²d²√(2 S:S), the off-diagonal components averaged
    from the four surrounding edges."""
    g = setup.grid
    box = g.Ip
    d2 = 0.0
    for d in range(g.dim):
        d2 = d2 + dseg(setup.dgrid.delta[d], box, d) ** 2
    acc = 0.0
    for (a, b) in _PAIRS[g.dim]:
        sab = S[(a, b)]
        if a == b:
            acc = acc + 2 * take(sab, box) ** 2
        else:
            avg4 = (
                take(sab, box) ** 2
                + take(sab, box, a, -1) ** 2
                + take(sab, box, b, -1) ** 2
                + take2(sab, box, a, -1, b, -1) ** 2
            ) / 4
            acc = acc + 4 * avg4
    return _on_box(setup, box, theta**2 * d2 * torch.sqrt(acc))


def apply_eddy_viscosity(S, visc, setup):
    """σ = 2 ν_t S, the viscosity averaged to the edge positions."""
    g = setup.grid
    box = g.Ip
    out = {}
    for (a, b) in _PAIRS[g.dim]:
        if a == b:
            v = take(visc, box)
        else:
            v = (
                take(visc, box)
                + take(visc, box, a, +1)
                + take(visc, box, b, +1)
                + take2(visc, box, a, +1, b, +1)
            ) / 4
        out[(a, b)] = _on_box(setup, box, 2 * v * take(S[(a, b)], box))
    return out


def divoftensor_natural(sigma, setup):
    """Divergence of a natural-position symmetric tensor at the velocity
    points (written on ``Ip``)."""
    g = setup.grid
    box = g.Ip
    ref = sigma[(0, 0)]
    c = torch.zeros((g.dim, *g.N), dtype=ref.dtype, device=ref.device)
    for a in range(g.dim):
        acc = 0.0
        for b in range(g.dim):
            s = sigma[(min(a, b), max(a, b))]
            if a == b:
                acc = acc + (take(s, box, a, +1) - take(s, box)) / dseg(setup.dgrid.delta_u[a], box, a)
            else:
                acc = acc + (take(s, box) - take(s, box, b, -1)) / dseg(setup.dgrid.delta[b], box, b)
        c[(a,) + slc(box)] = acc
    return c


def smagorinsky_closure_natural(setup):
    """The natural-form Smagorinsky closure ``m(u, θ)`` on the ghosted
    layout, tagged ``kind = "smagorinsky_natural"`` so the periodic fast
    path runs its force kernel instead.  ``theta`` is a float or a 0-d
    tensor.  On a uniform periodic grid the closure is the interior roll
    form, on any other the ghosted pipeline with the intermediate ghosts
    wrapped on periodic dimensions."""
    g = setup.grid
    if all(g.periodic) and all(g.uniform):
        from .fastpath import reghost, strip_ghosts
        from .pressure import uniform_dxs

        dxs = uniform_dxs(setup)

        def closure(u, theta):
            return reghost(smagorinsky_natural_interior(strip_ghosts(u), theta, dxs))
    else:

        def closure(u, theta):
            if theta is None:
                raise ValueError("the Smagorinsky closure needs theta (its constant)")
            S = {k: wrap_periodic_ghosts(v, setup) for k, v in strain_natural(u, setup).items()}
            visc = wrap_periodic_ghosts(smagorinsky_viscosity(S, theta, setup), setup)
            sigma = {k: wrap_periodic_ghosts(v, setup)
                     for k, v in apply_eddy_viscosity(S, visc, setup).items()}
            return divoftensor_natural(sigma, setup)

    closure.kind = "smagorinsky_natural"
    return closure


# --------------------------------------------------------------------------
# Pressure-point (full-tensor) form
# --------------------------------------------------------------------------


def _smagtensor(u, theta, setup):
    """Stress tensor σ = 2 ν_t S at the pressure points, ``(*N, D, D)``."""
    g = setup.grid
    D = g.dim
    box = g.Ip
    gu = _gradient_tensor(u, setup, box)
    G = torch.stack([torch.stack(row, -1) for row in gu], -2)
    S = (G + G.transpose(-1, -2)) / 2
    d2 = 0.0
    for d in range(D):
        d2 = d2 + dseg(setup.dgrid.delta[d], box, d) ** 2
    eddyvisc = theta**2 * d2 * torch.sqrt(2 * torch.sum(S * S, dim=(-2, -1)))
    full = torch.zeros((*g.N, D, D), dtype=u.dtype, device=u.device)
    full[slc(box)] = 2 * eddyvisc[..., None, None] * S
    return full


def divoftensor(sigma, setup):
    """Divergence of a pressure-point tensor field at the velocity points."""
    g = setup.grid
    D = g.dim
    out = torch.zeros((D, *g.N), dtype=sigma.dtype, device=sigma.device)
    for a in range(D):
        box = g.Iu[a]
        acc = 0.0
        for b in range(D):
            sab = sigma[..., a, b]
            if a == b:
                s2 = take(sab, box, b, +1)
                s1 = take(sab, box)
                dl = dseg(setup.dgrid.delta_u[b], box, b)
            else:
                s2 = (
                    take(sab, box)
                    + take(sab, box, b, +1)
                    + take2(sab, box, a, +1, b, +1)
                    + take(sab, box, a, +1)
                ) / 4
                s1 = (
                    take(sab, box, b, -1)
                    + take(sab, box)
                    + take2(sab, box, a, +1, b, -1)
                    + take(sab, box, a, +1)
                ) / 4
                dl = dseg(setup.dgrid.delta[b], box, b)
            acc = acc + (s2 - s1) / dl
        out[(a,) + slc(box)] = acc
    return out


def smagorinsky_closure(setup):
    """Pressure-point Smagorinsky closure ``m(u, θ)``: the stress tensor,
    its ghosts filled by `apply_bc_p`, and its divergence."""

    def closure(u, theta):
        sigma = apply_bc_p(_smagtensor(u, theta, setup), 0.0, setup)
        return divoftensor(sigma, setup)

    return closure
