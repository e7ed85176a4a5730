"""The periodic-uniform convection-diffusion as a roll graph.

Port of `convdiff_roll` from `ins_tpu/ops/diffkernels.py`: the single
definition of the fast path's momentum math.  It is the plain version
inside the stage kernels' plain twins (`ops/stage_kernels.py`) and the
momentum of the roll-twin stepper (`ops/fastpath.py`).  The custom-VJP
wrappers of the JAX module wait for ROADMAP queue 1 item 9.
"""

from __future__ import annotations

import torch

__all__ = ["convdiff_roll", "roll_p", "roll_m"]


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
