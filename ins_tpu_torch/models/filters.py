"""Discrete DNS -> LES filters.

Port of `ins_tpu/models/filters.py`.  `FaceAverage` averages fine
velocities over the coarse volume face; `VolumeAverage` over the
(component-shifted, periodic) coarse volume.  Both gather with the same
0-based indices as the JAX package, index for index (`index_select` on
the field's device), and leave the output's ghost cells zero, as the JAX
package does (`data_generation.filtersaver` fills them).  `reconstruct`
interpolates an LES field linearly back onto the DNS grid.  Periodic
grids; filters are data preparation, not the hot loop, so they are
plain PyTorch.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = ["FaceAverage", "VolumeAverage", "reconstruct"]


def _gather_filter(u_a, idx_per_dim):
    """Average u_a over windows: ``idx_per_dim[d]`` has shape (nles, m_d)
    of 0-based fine indices; returns the (nles, ...) means.  Each
    gathered dim expands into two axes (nles_d, m_d)."""
    out = u_a
    for d, idx in enumerate(idx_per_dim):
        axis = 2 * d
        flat = torch.as_tensor(idx.reshape(-1), device=u_a.device)
        out = out.index_select(axis, flat)
        out = out.reshape(out.shape[:axis] + idx.shape + out.shape[axis + 1:])
    m = math.prod(idx.shape[1] for idx in idx_per_dim)
    return out.sum(dim=tuple(2 * d + 1 for d in range(len(idx_per_dim)))) / m


def _face_indices(g_les, comp, D, alpha):
    """0-based fine indices of the face window per dim (the ghost offset
    is in ``comp·I + i``: fine index 0 is the left ghost)."""
    idx = []
    for b in range(D):
        Ic = np.arange(g_les.Nu[alpha][b])[:, None]
        i = np.array([comp])[None, :] if b == alpha else np.arange(1, comp + 1)[None, :]
        idx.append(comp * Ic + i)
    return idx


def _volume_indices(g_les, comp, D, alpha, n_dns):
    """0-based fine indices (periodic mod) of the shifted volume window:
    in the component's own dim comp + 1 points for even comp, comp for
    odd."""
    idx = []
    for b in range(D):
        Ic = np.arange(g_les.Nu[alpha][b])[:, None]
        if b == alpha:
            lo = comp // 2 if comp % 2 == 0 else comp // 2 + 1
            i = np.arange(lo, comp // 2 + comp + 1)[None, :]
        else:
            i = np.arange(1, comp + 1)[None, :]
        idx.append(np.mod(comp * Ic + i, n_dns[b]))
    return idx


def _dof_slices(g, a):
    return (a,) + tuple(slice(s, s + g.Nu[a][b]) for b, (s, _) in enumerate(g.Iu[a]))


@dataclasses.dataclass(frozen=True)
class FaceAverage:
    """Average fine velocities over the coarse volume face."""

    def __call__(self, u, setup_les, comp):
        g = setup_les.grid
        D = g.dim
        v = u.new_zeros((D, *g.N))
        for a in range(D):
            v[_dof_slices(g, a)] = _gather_filter(u[a], _face_indices(g, comp, D, a))
        return v


@dataclasses.dataclass(frozen=True)
class VolumeAverage:
    """Average fine velocities over the (component-shifted) coarse volume.
    Periodic only."""

    def __call__(self, u, setup_les, comp):
        g = setup_les.grid
        D = g.dim
        if not all(g.periodic):
            raise ValueError("VolumeAverage requires periodic BCs")
        n_dns = tuple(comp * (n - 2) for n in g.N)
        m = (comp + 1 if comp % 2 == 0 else comp) * comp ** (D - 1)
        v = u.new_zeros((D, *g.N))
        for a in range(D):
            # the mod indices address the ghosted field, whose index 0
            # (left ghost) is the periodic copy of interior index n_dns
            idx = _volume_indices(g, comp, D, a, n_dns)
            mwin = math.prod(ix.shape[1] for ix in idx)
            v[_dof_slices(g, a)] = _gather_filter(u[a], idx) * (mwin / m)
        return v


def reconstruct(v, setup_dns, setup_les, comp):
    """Linear interpolation of an LES velocity back onto the DNS grid.
    Periodic only."""
    g_les, g_dns = setup_les.grid, setup_dns.grid
    D = g_les.dim
    if not all(g_les.periodic):
        raise ValueError("reconstruct requires periodic BCs")
    n_les = tuple(n - 2 for n in g_les.N)
    u = v.new_zeros((D, *g_dns.N))
    for a in range(D):
        # DNS face f (1..n_dns): coarse cell J = (f - 1) // comp; in dim a
        # the weights of the right and left coarse faces, elsewhere
        # piecewise constant in the coarse cell
        idx = []
        for b in range(D):
            f = np.arange(1, comp * n_les[b] + 1)
            Jc = (f - 1) // comp
            if b == a:
                i = comp - 1 - ((f - 1) % comp)
                wts = ((comp - i) / comp, i / comp)
                idx.append((1 + Jc, 1 + np.mod(Jc - 1, n_les[b])))
            else:
                idx.append(1 + Jc)

        def gather(which):
            out = v[a]
            for b in reversed(range(D)):
                ib = idx[b][which] if b == a else idx[b]
                out = out.index_select(b, torch.as_tensor(ib, device=v.device))
            return out

        wshape = tuple(-1 if b == a else 1 for b in range(D))
        wr, wl = (torch.as_tensor(w.reshape(wshape), dtype=v.dtype, device=v.device)
                  for w in wts)
        val = gather(0) * wr + gather(1) * wl
        u[(a,) + tuple(slice(1, 1 + s) for s in val.shape)] = val
    return u
