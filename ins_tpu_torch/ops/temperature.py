"""The Boussinesq temperature terms on the periodic-uniform interior
layout, as roll graphs.

Port of the temperature half of the JAX fast path's roll twin
(`ins_tpu/ops/fastpath.py`, `momentum` and `temp_rhs`):

    buoyancy   F_g += alpha2 · ½(T + T[I + e_g])         (component g = gdir)
    temp_rhs   Σ_b [−(u_b·T̄_b(I) − u_b·T̄_b(I − e_b))
                    + alpha4·(∂_b T(I) − ∂_b T(I − e_b))] / Δx_b
               + dis · Σ_b ½(u_b·ν∆u_b (I − e_b) + u_b·ν∆u_b (I))

with T̄_b(I) = ½(T(I) + T(I + e_b)) and ∂_b T(I) = (T(I + e_b) − T(I))/Δx_b,
the optional dissipation term scaled by ``dis`` (None: off).  They serve
the roll twin, the per-op chain and the plain versions of the stage
kernels' temperature stream (`ops/stage_kernels.py`), in any dimension.
"""

from __future__ import annotations

import torch

from .diffkernels import roll_m, roll_p

__all__ = ["add_buoyancy", "temp_rhs_roll"]


def add_buoyancy(F, temp, gdir, alpha2):
    """``F`` with ``alpha2·½(T + T[I + e_gdir])`` added to component gdir."""
    tavg = 0.5 * (temp + roll_p(temp, gdir))
    return torch.stack([F[a] + alpha2 * tavg if a == gdir else F[a] for a in range(F.shape[0])])


def temp_rhs_roll(u, temp, dxs, alpha4, visc, dis=None):
    """Temperature convection-diffusion, plus the dissipation scaled by
    ``dis`` unless it is None (``visc`` = 1/Re)."""
    D = u.shape[0]
    acc = 0.0
    for b in range(D):
        T_pb, T_mb = roll_p(temp, b), roll_m(temp, b)
        ub = u[b]
        uT2 = ub * 0.5 * (temp + T_pb)
        uT1 = roll_m(ub, b) * 0.5 * (T_mb + temp)
        dT2 = (T_pb - temp) / dxs[b]
        dT1 = (temp - T_mb) / dxs[b]
        acc = acc + (-(uT2 - uT1) + alpha4 * (dT2 - dT1)) / dxs[b]
    if dis is not None:
        dacc = 0.0
        for b in range(D):
            ub = u[b]
            diffb = sum(
                (visc / dxs[c] ** 2) * (roll_p(ub, c) - 2.0 * ub + roll_m(ub, c))
                for c in range(D)
            )
            dacc = dacc + (roll_m(ub, b) * roll_m(diffb, b) + ub * diffb) / 2
        acc = acc + dis * dacc
    return acc
