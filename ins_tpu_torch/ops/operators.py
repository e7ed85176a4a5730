"""Differential operators on the staggered grid (the general ghosted path).

Port of `ins_tpu/ops/operators.py`.  Every operator is a plain function
of ghost-padded tensors built from static-slice stencil arithmetic
(`_stencil.take`: views of the field), differentiable by autograd.
Fields: velocity ``u: (D, *N)`` (component first), scalars ``(*N)``,
ghosts included.  Operators write only the DOF boxes ``Iu[alpha]`` /
``Ip`` of their output (zeros elsewhere); boundary values are filled
separately by `apply_bc_*`.  The grid's 1-D metadata is read from its
copy on the setup's device (`setup.dgrid`, through `_stencil.dseg`).

`Dfield`, `Qfield`, `eig2field` and `get_scale_numbers` wait for ROADMAP
queue 1 item 10, unsteady body forces for item 6.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid import _numpy_dtype
from ._stencil import dseg, slc, take, take2

__all__ = [
    "scalewithvolume",
    "divergence",
    "pressuregradient",
    "applypressure",
    "laplacian",
    "convection",
    "diffusion",
    "convectiondiffusion",
    "convection_diffusion_temp",
    "wrap_periodic_ghosts",
    "dissipation",
    "dissipation_from_strain",
    "applybodyforce",
    "gravity",
    "momentum",
    "vorticity",
    "interpolate_u_p",
    "interpolate_omega_p",
    "kinetic_energy",
    "total_kinetic_energy",
]


def _on_box(setup, box, val):
    """A zero scalar field with `val` (a tensor) on `box`."""
    out = torch.zeros(setup.grid.N, dtype=val.dtype, device=val.device)
    out[slc(box)] = val
    return out


def _volume(setup, box):
    """Volume sizes Omega_I over `box` (broadcast product of widths)."""
    g = setup.grid
    om = dseg(setup.dgrid.delta[0], box, 0)
    for d in range(1, g.dim):
        om = om * dseg(setup.dgrid.delta[d], box, d)
    return om


def scalewithvolume(p, setup):
    """Scale a scalar field with the volume sizes."""
    g = setup.grid
    full = tuple((0, n) for n in g.N)
    out = p
    for d in range(g.dim):
        out = out * dseg(setup.dgrid.delta[d], full, d)
    return out


# --------------------------------------------------------------------------
# Divergence / gradient / projection pieces
# --------------------------------------------------------------------------


def divergence(u, setup):
    """Divergence of the velocity at the pressure points."""
    g = setup.grid
    box = g.Ip
    acc = 0.0
    for a in range(g.dim):
        acc = acc + (take(u[a], box) - take(u[a], box, a, -1)) / dseg(setup.dgrid.delta[a], box, a)
    return _on_box(setup, box, acc)


def _grad_component(p, setup, a):
    g = setup.grid
    box = g.Iu[a]
    return box, (take(p, box, a, +1) - take(p, box)) / dseg(setup.dgrid.delta_u[a], box, a)


def pressuregradient(p, setup):
    """Pressure gradient at the velocity points."""
    g = setup.grid
    G = torch.zeros((g.dim, *g.N), dtype=p.dtype, device=p.device)
    for a in range(g.dim):
        box, val = _grad_component(p, setup, a)
        G[(a,) + slc(box)] = val
    return G


def applypressure(u, p, setup):
    """``u − G p`` on the velocity DOFs (a new tensor; ghosts of `u` kept)."""
    g = setup.grid
    u = u.clone()
    for a in range(g.dim):
        box, val = _grad_component(p, setup, a)
        u[(a,) + slc(box)] -= val
    return u


def laplacian(p, setup):
    """Volume-scaled, BC-aware pressure Laplacian from the grid's row
    coefficients `lap_c` (boundary rows modified for Dirichlet and
    pressure BCs)."""
    g = setup.grid
    box = g.Ip
    om = _volume(setup, box)
    acc = 0.0
    for d in range(g.dim):
        cl, cc, cr = setup.dgrid.lap_c[d]
        part = cr * take(p, box, d, +1) + cc * take(p, box) + cl * take(p, box, d, -1)
        acc = acc + om / dseg(setup.dgrid.delta[d], box, d) * part
    return _on_box(setup, box, acc)


# --------------------------------------------------------------------------
# Convection / diffusion
# --------------------------------------------------------------------------


def _lower_ext(box, b):
    """`box` with one more plane below along `b`: the faces of its cells."""
    return tuple((s - 1, e) if d == b else (s, e) for d, (s, e) in enumerate(box))


def _hi_minus_lo(face, b, n):
    """face[I + 1/2] − face[I − 1/2] over the n cells along `b` (`face`
    on `_lower_ext` of the cells' box)."""
    return face.narrow(b, 1, n) - face.narrow(b, 0, n)


def _guarded(grad, width, dwidth, ext, b, shift, eps2):
    """``where(width > eps2, grad, 0)`` (a zero derivative across an
    infinitely thin ghost volume); no kernel where every width of the
    segment is thick, which the host reads off the numpy metadata
    (`width`; `dwidth` is its device copy)."""
    s, e = ext[b]
    if np.all(width[s + shift : e + shift] > eps2):
        return grad
    return torch.where(dseg(dwidth, ext, b, shift) > eps2, grad, 0.0)


def _convdiff_component(u, setup, a, *, do_conv, do_diff, visc=None):
    """Convection and/or diffusion flux divergence of component `a` over
    its box ``Iu[a]``: the skew-symmetric convective form with the face
    interpolation weights A, and the diffusion with derivatives across
    infinitely thin ghost volumes set to zero.  Each face's flux (and
    derivative) is formed once, on the box with one more plane below
    along b, and differenced: the lower face of a cell is the upper face
    of the cell below, the same operands in the same order as the JAX
    package's two per-cell evaluations, so the result is the same bits."""
    g, dg = setup.grid, setup.dgrid
    box = g.Iu[a]
    eps2 = 2 * float(np.finfo(_numpy_dtype(setup.dtype)).eps)
    f = 0.0
    for b in range(g.dim):
        div_b = dseg(dg.delta_u[b] if a == b else dg.delta[b], box, b)
        ext = _lower_ext(box, b)
        n = box[b][1] - box[b][0]
        if do_conv:
            A1, A2 = dg.A[b][a]
            uab = (take(u[a], ext) + take(u[a], ext, b, +1)) / 2
            # u[b] interpolated to the corners of the u[a] control volume
            uba = dseg(A2, ext, a) * take(u[b], ext) + dseg(A1, ext, a, +1) * take(
                u[b], ext, a, +1)
            f = f - _hi_minus_lo(uab * uba, b, n) / div_b
        if do_diff:
            if b == a:
                width, dwidth, shift = g.delta[b], dg.delta[b], +1
            else:
                width, dwidth, shift = g.delta_u[b], dg.delta_u[b], 0
            grad = (take(u[a], ext, b, +1) - take(u[a], ext)) / dseg(dwidth, ext, b, shift)
            grad = _guarded(grad, width, dwidth, ext, b, shift, eps2)
            f = f + visc * _hi_minus_lo(grad, b, n) / div_b
    return box, f


def _convdiff(u, setup, **kw):
    F = torch.zeros_like(u)
    for a in range(setup.grid.dim):
        box, f = _convdiff_component(u, setup, a, **kw)
        F[(a,) + slc(box)] = f
    return F


def convection(u, setup):
    """Convective term −∇·(u uᵀ) at the velocity points."""
    return _convdiff(u, setup, do_conv=True, do_diff=False)


def diffusion(u, setup, *, use_viscosity=True):
    """Diffusive term ν∇²u at the velocity points."""
    visc = 1 / setup.Re if use_viscosity else 1.0
    return _convdiff(u, setup, do_conv=False, do_diff=True, visc=visc)


def convectiondiffusion(u, setup):
    """Convection and diffusion in one pass per component."""
    return _convdiff(u, setup, do_conv=True, do_diff=True, visc=1 / setup.Re)


# --------------------------------------------------------------------------
# Temperature equation terms (Boussinesq)
# --------------------------------------------------------------------------


def _avg(phi, delta_d, box, d, shift=0):
    """delta-weighted average of the scalar `phi` in direction `d` at
    ``I + shift e_d``."""
    d0 = dseg(delta_d, box, d, shift)
    d1 = dseg(delta_d, box, d, shift + 1)
    return (d1 * take(phi, box, d, shift) + d0 * take(phi, box, d, shift + 1)) / (d0 + d1)


def convection_diffusion_temp(u, temp, setup):
    """Temperature convection-diffusion at the pressure points (each face's
    flux and gradient formed once, as in `_convdiff_component`)."""
    g = setup.grid
    box = g.Ip
    a4 = setup.temperature.alpha4
    acc = 0.0
    for b in range(g.dim):
        ext = _lower_ext(box, b)
        n = box[b][1] - box[b][0]
        dT = (take(temp, ext, b, +1) - take(temp, ext)) / dseg(setup.dgrid.delta_u[b], ext, b)
        uT = take(u[b], ext) * _avg(temp, setup.dgrid.delta[b], ext, b, 0)
        acc = acc + (-_hi_minus_lo(uT, b, n) + a4 * _hi_minus_lo(dT, b, n)) / dseg(
            setup.dgrid.delta[b], box, b)
    return _on_box(setup, box, acc)


def wrap_periodic_ghosts(f, setup):
    """Fill the ghost planes of every periodic dimension of a full-N field
    (trailing dims spatial) by wrapping; a new tensor.  Used where an
    intermediate field's ghosts would otherwise be stale zeros at
    periodic edges (the dissipation's diffusion, the natural Smagorinsky
    sweeps); non-periodic dimensions are left untouched."""
    g = setup.grid
    if not any(g.periodic):
        return f
    f = f.clone()
    for d in range(g.dim):
        if g.periodic[d]:
            axis = f.dim() - g.dim + d
            n = g.N[d]
            f.narrow(axis, 0, 1).copy_(f.narrow(axis, n - 2, 1))
            f.narrow(axis, n - 1, 1).copy_(f.narrow(axis, 1, 1))
    return f


def dissipation(u, setup):
    """Dissipation term of the temperature equation: Re·α1/γ times u ⊙
    diffusion(u) interpolated to the pressure points."""
    g = setup.grid
    t = setup.temperature
    diff = wrap_periodic_ghosts(diffusion(u, setup), setup)
    box = g.Ip
    coef = setup.Re * t.alpha1 / t.gamma
    acc = 0.0
    for b in range(g.dim):
        acc = acc + (
            take(u[b], box, b, -1) * take(diff[b], box, b, -1) + take(u[b], box) * take(diff[b], box)
        ) / 2
    return _on_box(setup, box, coef * acc)


def _dx(u, setup, box, a, b):
    """∂u[a]/∂x[b] at the pressure points over `box`."""
    g = setup.grid
    if a == b:
        return (take(u[a], box) - take(u[a], box, b, -1)) / dseg(setup.dgrid.delta[b], box, b)
    d_hi = dseg(setup.dgrid.delta_u[b], box, b)
    d_lo = dseg(setup.dgrid.delta_u[b], box, b, -1)
    return (
        (take(u[a], box, b, +1) - take(u[a], box)) / d_hi
        + (take2(u[a], box, a, -1, b, +1) - take(u[a], box, a, -1)) / d_hi
        + (take(u[a], box) - take(u[a], box, b, -1)) / d_lo
        + (take(u[a], box, a, -1) - take2(u[a], box, a, -1, b, -1)) / d_lo
    ) / 4


def _gradient_tensor(u, setup, box):
    """Velocity gradient at the pressure points: ``gu[a][b] = ∂u[a]/∂x[b]``."""
    D = setup.grid.dim
    return [[_dx(u, setup, box, a, b) for b in range(D)] for a in range(D)]


def dissipation_from_strain(u, setup):
    """Dissipation 2ν⟨S:S⟩ from the strain-rate tensor."""
    g = setup.grid
    box = g.Ip
    gu = _gradient_tensor(u, setup, box)
    acc = 0.0
    for i in range(g.dim):
        for j in range(g.dim):
            S = (gu[i][j] + gu[j][i]) / 2
            acc = acc + S * S
    return _on_box(setup, box, 2 / setup.Re * acc)


def applybodyforce(u, t, setup):
    """The steady body force field `Setup` evaluated once (unsteady
    forces are ROADMAP queue 1 item 6)."""
    return setup.bodyforce_field


def gravity(temp, setup):
    """Buoyancy α2·avg(temp) in the gravity direction."""
    g = setup.grid
    tq = setup.temperature
    gdir = tq.gdir
    box = g.Iu[gdir]
    F = torch.zeros((g.dim, *g.N), dtype=temp.dtype, device=temp.device)
    F[(gdir,) + slc(box)] = tq.alpha2 * _avg(temp, setup.dgrid.delta[gdir], box, gdir, 0)
    return F


def momentum(u, temp, t, setup):
    """Right-hand side of the momentum equation without the pressure
    gradient: convection-diffusion, the body force and the buoyancy."""
    F = convectiondiffusion(u, setup)
    if setup.bodyforce_field is not None:
        F = F + applybodyforce(u, t, setup)
    if temp is not None:
        F = F + gravity(temp, setup)
    return F


# --------------------------------------------------------------------------
# Derived fields
# --------------------------------------------------------------------------


def vorticity(u, setup):
    """Vorticity: a scalar field in 2-D, a vector field in 3-D."""
    g = setup.grid
    box = tuple((0, n - 1) for n in g.N)

    def curl(a_hi, a_lo, d_hi, d_lo):
        return (take(u[a_hi], box, d_hi, +1) - take(u[a_hi], box)) / dseg(
            setup.dgrid.delta_u[d_hi], box, d_hi
        ) - (take(u[a_lo], box, d_lo, +1) - take(u[a_lo], box)) / dseg(
            setup.dgrid.delta_u[d_lo], box, d_lo
        )

    if g.dim == 2:
        return _on_box(setup, box, curl(1, 0, 0, 1))
    out = torch.zeros((3, *g.N), dtype=u.dtype, device=u.device)
    for a, ap, am in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        out[(a,) + slc(box)] = curl(am, ap, ap, am)
    return out


def interpolate_u_p(u, setup):
    """Velocity interpolated to the pressure points."""
    g = setup.grid
    box = g.Ip
    out = torch.zeros((g.dim, *g.N), dtype=u.dtype, device=u.device)
    for a in range(g.dim):
        out[(a,) + slc(box)] = (take(u[a], box, a, -1) + take(u[a], box)) / 2
    return out


def interpolate_omega_p(w, setup):
    """Vorticity interpolated to the pressure points."""
    g = setup.grid
    box = g.Ip
    if g.dim == 2:
        return _on_box(setup, box, (take2(w, box, 0, -1, 1, -1) + take(w, box)) / 2)
    out = torch.zeros((3, *g.N), dtype=w.dtype, device=w.device)
    for a in range(3):
        ap, am = (a + 1) % 3, (a - 1) % 3
        out[(a,) + slc(box)] = (take2(w[a], box, ap, -1, am, -1) + take(w[a], box)) / 2
    return out


def kinetic_energy(u, setup, *, interpolate_first=False):
    """Kinetic-energy field at the pressure points."""
    g = setup.grid
    box = g.Ip
    acc = 0.0
    if interpolate_first:
        for a in range(g.dim):
            s = take(u[a], box) + take(u[a], box, a, -1)
            acc = acc + s * s
        acc = acc / 8
    else:
        for a in range(g.dim):
            acc = acc + take(u[a], box) ** 2 + take(u[a], box, a, -1) ** 2
        acc = acc / 4
    return _on_box(setup, box, acc)


def total_kinetic_energy(u, setup, **kwargs):
    """Volume-integrated kinetic energy (a 0-d tensor on u's device)."""
    k = scalewithvolume(kinetic_energy(u, setup, **kwargs), setup)
    return torch.sum(k[slc(setup.grid.Ip)])
