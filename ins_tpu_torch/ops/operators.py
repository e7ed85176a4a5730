"""Differential operators on the staggered grid (the general ghosted path).

Port of `ins_tpu/ops/operators.py`.  Every operator is a plain function
of ghost-padded tensors built from static-slice stencil arithmetic
(`_stencil.take`: views of the field), differentiable by autograd.
Fields: velocity ``u: (D, *N)`` (component first), scalars ``(*N)``,
ghosts included.  Operators write only the DOF boxes ``Iu[alpha]`` /
``Ip`` of their output (zeros elsewhere); boundary values are filled
separately by `apply_bc_*`.  The grid's 1-D metadata is read from its
copy on the setup's device (`setup.dgrid`, through `_stencil.dseg`).

The derived fields `Dfield`, `Qfield` and `eig2field` (vortex criteria)
and `get_scale_numbers` (turbulence scales) serve the processors.
Unsteady body forces wait for ROADMAP queue 1 item 6.
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
    "Dfield",
    "Qfield",
    "eig2field",
    "get_scale_numbers",
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


def bodyforce_on_grid(bodyforce, xu, t, shape, dtype, device):
    """``bodyforce`` at time ``t`` on the full staggered coordinates
    (``xu[a]``: component a's coordinate vectors, each shaped to
    broadcast along its dimension), as `ins_tpu.ops.operators.
    applybodyforce` evaluates it: a ``(D, *shape)`` field."""
    t = torch.full((), t, dtype=dtype, device=device)
    ones = torch.ones(shape, dtype=dtype, device=device)
    return torch.stack([bodyforce(a, *xu[a], t) * ones for a in range(len(xu))])


def applybodyforce(u, t, setup):
    """The body force at time ``t``: the steady field `Setup` evaluated
    once, or the unsteady callable on the full staggered coordinates (the
    JAX package's `applybodyforce`)."""
    f = setup.unsteady_bodyforce
    if f is None:
        return setup.bodyforce_field
    g = setup.grid
    return bodyforce_on_grid(f, setup.dgrid.xu, t, g.N, setup.dtype, setup.device)


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
    if setup.bodyforce_field is not None or setup.unsteady_bodyforce is not None:
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


def Dfield(p, setup, *, eps=None):
    """Low-pressure vortex criterion D = |∇p| / (2 ∇²p) at the pressure
    points, the Laplacian kept at least `eps` (the dtype's) from zero."""
    g = setup.grid
    if eps is None:
        eps = float(np.finfo(_numpy_dtype(setup.dtype)).eps)
    G = pressuregradient(p, setup)
    box = g.Ip
    gsum = 0.0
    lap = 0.0
    for a in range(g.dim):
        gc = take(G[a], box)
        gm = take(G[a], box, a, -1)
        gsum = gsum + (gm + gc) ** 2
        lap = lap + (gc - gm) / dseg(setup.dgrid.delta[a], box, a)
    lap = torch.where(lap > 0, torch.clamp(lap, min=eps), torch.clamp(lap, max=-eps))
    return _on_box(setup, box, torch.sqrt(gsum) / 2 / lap)


def Qfield(u, setup):
    """Q-criterion at the pressure points."""
    g = setup.grid
    box = g.Ip
    q = 0.0
    for a in range(g.dim):
        for b in range(g.dim):
            q = q - (
                (take(u[a], box) - take(u[a], box, b, -1))
                / dseg(setup.dgrid.delta[b], box, b)
                * (take(u[b], box) - take(u[b], box, a, -1))
                / dseg(setup.dgrid.delta[a], box, a)
                / 2
            )
    return _on_box(setup, box, q)


def _gradient_matrix(u, setup, box):
    """∇u at the pressure points of `box` as ``(*box, D, D)`` matrices."""
    gu = _gradient_tensor(u, setup, box)
    return torch.stack([torch.stack(row, -1) for row in gu], -2)


def _eigvals2_sym3(M):
    """Middle eigenvalue of batched symmetric 3x3 matrices by the
    closed-form trigonometric formula (robust for degenerate spectra)."""
    a00, a01, a02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    a11, a12, a22 = M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]
    q = (a00 + a11 + a22) / 3
    p1 = a01**2 + a02**2 + a12**2
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2 * p1
    p = torch.sqrt(torch.clamp(p2 / 6, min=0.0))
    psafe = torch.where(p > 0, p, 1.0)
    b00, b11, b22 = (a00 - q) / psafe, (a11 - q) / psafe, (a22 - q) / psafe
    b01, b02, b12 = a01 / psafe, a02 / psafe, a12 / psafe
    detb = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    phi = torch.arccos(torch.clamp(detb / 2, -1.0, 1.0)) / 3
    e1 = q + 2 * p * torch.cos(phi)  # largest
    e3 = q + 2 * p * torch.cos(phi + 2 * np.pi / 3)  # smallest
    return torch.where(p > 0, 3 * q - e1 - e3, q)


def eig2field(u, setup):
    """λ₂ vortex criterion: the middle eigenvalue of S² + R² (3-D only)."""
    g = setup.grid
    if g.dim != 3:
        raise ValueError("eig2field is defined in 3-D only")
    G = _gradient_matrix(u, setup, g.Ip)
    S = (G + G.mT) / 2
    R = (G - G.mT) / 2
    return _on_box(setup, g.Ip, _eigvals2_sym3(S @ S + R @ R))


def get_scale_numbers(u, setup):
    """Dimensional turbulence scale numbers: a dict of 0-d tensors uavg,
    eps (dissipation), eta, lam, Re_lam, L (integral scale, from the
    energy spectrum: a uniform periodic grid), tau and Re_int.  Every
    velocity component is averaged over the first component's box
    ``Iu[0]``, as in the JAX package."""
    g = setup.grid
    D = g.dim
    visc = 1 / setup.Re
    full = tuple((0, n) for n in g.N)
    dg = setup.dgrid

    uavg_sq = 0.0
    for a in range(D):
        om = 1.0
        for b in range(D):
            om = om * dseg(dg.delta_u[b] if a == b else dg.delta[b], full, b)
        om = om * torch.ones(g.N, dtype=u.dtype, device=u.device)
        sl = slc(g.Iu[0])
        uavg_sq = uavg_sq + torch.sum((u[a] ** 2 * om)[sl]) / torch.sum(om[sl])
    uavg = torch.sqrt(uavg_sq)

    ip = slc(g.Ip)
    om = scalewithvolume(torch.ones(g.N, dtype=u.dtype, device=u.device), setup)
    eps_ = torch.sum((om * dissipation_from_strain(u, setup))[ip]) / torch.sum(om[ip])
    eta = (visc**3 / eps_) ** 0.25
    lam = torch.sqrt(5 * visc / eps_) * uavg
    re_lam = lam * uavg / np.sqrt(3.0) / visc

    K = tuple(n // 2 for n in g.Np)
    uhat = torch.fft.fftn(torch.stack([u[a][ip] for a in range(D)]), dim=tuple(range(1, D + 1)))
    uhat = uhat[(slice(None),) + tuple(slice(0, k) for k in K)]
    e = uhat.abs() ** 2 / (2 * float(np.prod(g.Np)) ** 2)
    kk = sum(np.reshape(np.arange(K[d], dtype=np.float64) ** 2,
                        tuple(K[d] if i == d else 1 for i in range(D))) for d in range(D))
    inv_knorm = 1.0 / np.sqrt(np.where(kk == 0, 1.0, kk))
    inv_knorm[(0,) * D] = 0.0
    e = torch.sum(e, 0) * torch.as_tensor(inv_knorm, dtype=u.dtype, device=u.device)
    L = 3 * np.pi / 2 / uavg_sq * torch.sum(e)
    return dict(uavg=uavg, eps=eps_, eta=eta, lam=lam, Re_lam=re_lam, L=L, tau=L / uavg,
                Re_int=L * uavg / visc)
