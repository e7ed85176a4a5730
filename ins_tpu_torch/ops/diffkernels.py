"""The periodic-uniform convection-diffusion as a roll graph, and the
differentiable per-op kernels.

Port of `ins_tpu/ops/diffkernels.py`.  `convdiff_roll` is the single
definition of the fast path's momentum math: the plain version inside
the stage and per-op kernels' plain twins and the momentum of the roll
twin.  The ``make_*_vjp`` functions wrap the per-op kernels
(`ops/perop_kernels.py`) as `torch.autograd.Function`s whose forward is
the kernel wrapper and whose backward is the JAX package's adjoint:

- ``convdiff_interior_3d``: the VJP of `convdiff_roll`, linearised at the
  saved input (autograd of the roll graph);
- ``stage_div_3d``, ``pressure_correct_3d`` (linear): the hand-derived
  adjoints, themselves small roll graphs (D = −Gᵀ);
- ``smagorinsky_force_3d`` (`ops/smag_kernels.py`): autograd of the roll
  twin `smagorinsky_natural_interior` in u and θ, linearised at the saved
  inputs (an additive body force drops out).

The backwards are roll graphs in the JAX package too, not Pallas
kernels, so they stay plain PyTorch here.  ``plain=True`` puts the plain
versions in the forward (the reference chain on the card).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "convdiff_roll",
    "roll_p",
    "roll_m",
    "make_convdiff_vjp",
    "make_stage_div_vjp",
    "make_pressure_correct_vjp",
    "make_smag_force_vjp",
]


def roll_p(v, d):  # v[I + e_d]
    return torch.roll(v, -1, dims=d)


def roll_m(v, d):  # v[I - e_d]
    return torch.roll(v, 1, dims=d)


def convdiff_roll(u, visc, dxs):
    """Convection + diffusion on ghost-free periodic-uniform interior
    fields `(D, *n)` (any D): second-order diffusion plus the
    energy-conserving face-averaged convection, all interpolation
    weights 1/2."""
    D = u.shape[0]
    F = []
    for a in range(D):
        ua = u[a]
        f = 0.0
        for b in range(D):
            upb, umb = roll_p(ua, b), roll_m(ua, b)
            f = f + (visc / dxs[b] ** 2) * (upb - 2.0 * ua + umb)
            uab1 = 0.5 * (umb + ua)
            uab2 = 0.5 * (ua + upb)
            if a == b:
                uba1, uba2 = uab1, uab2
            else:
                ub = u[b]
                ub_pa = roll_p(ub, a)
                uba1 = 0.5 * (roll_m(ub, b) + roll_m(ub_pa, b))
                uba2 = 0.5 * (ub + ub_pa)
            f = f - (uab2 * uba2 - uab1 * uba1) / dxs[b]
        F.append(f)
    return torch.stack(F)


def _perop(name, plain):
    from . import perop_kernels

    return getattr(perop_kernels, name + ("_plain" if plain else ""))


class _ConvdiffFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, visc, dxs, fwd):
        ctx.save_for_backward(u)
        ctx.visc, ctx.dxs = visc, dxs
        return fwd(u.contiguous(), visc, dxs)

    @staticmethod
    def backward(ctx, ct):
        (u,) = ctx.saved_tensors
        with torch.enable_grad():
            v = u.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(convdiff_roll(v, ctx.visc, ctx.dxs), v, ct)
        return g, None, None, None


class _StageDivFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, base, k, coeff, dxs, fwd):
        ctx.save_for_backward(k, coeff if torch.is_tensor(coeff) else None)
        ctx.coeff, ctx.dxs = coeff, dxs
        return fwd(base.contiguous(), k.contiguous(), coeff, dxs)

    @staticmethod
    def backward(ctx, ct_ut, ct_div):
        k, coeff_t = ctx.saved_tensors
        coeff = coeff_t if coeff_t is not None else ctx.coeff
        dxs = ctx.dxs
        vol = float(np.prod(dxs))
        g = ct_ut + torch.stack(
            [vol * (ct_div - roll_p(ct_div, a)) / dxs[a] for a in range(3)]
        )
        ct_coeff = None
        if coeff_t is not None and ctx.needs_input_grad[2]:
            ct_coeff = torch.sum(k * g).to(coeff_t.dtype).reshape(coeff_t.shape)
        return g, coeff * g, ct_coeff, None, None


class _PressureCorrectFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ut, q, dxs, fwd):
        ctx.dxs = dxs
        return fwd(ut.contiguous(), q.contiguous(), dxs)

    @staticmethod
    def backward(ctx, ct):
        dxs = ctx.dxs
        ct_q = sum((ct[a] - roll_m(ct[a], a)) / dxs[a] for a in range(3))
        return ct, ct_q, None, None


class _SmagForceFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, theta, dxs, bodyforce, fwd):
        th_t = theta if torch.is_tensor(theta) else None
        ctx.save_for_backward(u, th_t)
        ctx.theta, ctx.dxs = theta, dxs
        return fwd(u.contiguous(), theta, dxs, bodyforce=bodyforce)

    @staticmethod
    def backward(ctx, ct):
        from .eddyviscosity import smagorinsky_natural_interior

        u, th_t = ctx.saved_tensors
        want_theta = th_t is not None and ctx.needs_input_grad[1]
        with torch.enable_grad():
            v = u.detach().requires_grad_(True)
            th = th_t.detach().requires_grad_(True) if want_theta else ctx.theta
            inputs = [v, th] if want_theta else [v]
            grads = torch.autograd.grad(
                smagorinsky_natural_interior(v, th, ctx.dxs), inputs, ct
            )
        return grads[0], (grads[1] if want_theta else None), None, None, None


def make_convdiff_vjp(visc, dxs, *, plain=False):
    """`convdiff_interior_3d` with a custom VJP: kernel forward,
    roll-twin adjoint backward (linearised at the saved input)."""
    visc = float(visc)
    dxs = tuple(map(float, dxs))
    fwd = _perop("convdiff_interior_3d", plain)

    def f(u):
        return _ConvdiffFn.apply(u, visc, dxs, fwd)

    return f


def make_stage_div_vjp(dxs, *, plain=False):
    """`stage_div_3d` with a custom VJP.  The map is linear:
    ``ut = base + coeff*k``, ``div = vol * Σ_a (ut_a - ut_a[I-e_a])/dx_a``;
    its adjoint sends the divergence cotangent back through the
    transposed stencil ``vol * (w - w[I+e_a])/dx_a`` (Dᵀ = -G), scales
    the k cotangent by ``coeff`` and, for a tensor ``coeff`` that
    requires grad, returns ``Σ k·g`` as its cotangent."""
    dxs = tuple(map(float, dxs))
    fwd = _perop("stage_div_3d", plain)

    def f(base, k, coeff):
        return _StageDivFn.apply(base, k, coeff, dxs, fwd)

    return f


def make_pressure_correct_vjp(dxs, *, plain=False):
    """`pressure_correct_3d` with a custom VJP.  ``u = ut - G q`` is
    linear; the adjoint of the gradient stencil is minus the divergence
    stencil, so ``ct_q = Σ_a (ct_u_a - ct_u_a[I-e_a])/dx_a``."""
    dxs = tuple(map(float, dxs))
    fwd = _perop("pressure_correct_3d", plain)

    def f(ut, q):
        return _PressureCorrectFn.apply(ut, q, dxs, fwd)

    return f


def make_smag_force_vjp(dxs, *, bodyforce=None, plain=False):
    """`smagorinsky_force_3d` (with an optional steady body force folded
    in) with a custom VJP: kernel forward, backward the autograd of the
    roll twin `smagorinsky_natural_interior`, differentiable in u and in a
    tensor θ (the constant that a-posteriori training fits)."""
    from . import smag_kernels

    dxs = tuple(map(float, dxs))
    fwd = smag_kernels.smagorinsky_force_3d_plain if plain else smag_kernels.smagorinsky_force_3d

    def f(u, theta):
        return _SmagForceFn.apply(u, theta, dxs, bodyforce, fwd)

    return f
