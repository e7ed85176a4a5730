"""Sparse-matrix mirrors of the matrix-free operators.

Port of `ins_tpu/ops/matrices.py`: scipy.sparse matrices built on the
host at setup time, for `psolver_direct` (a host factorization) and
`psolver_cg_matrix` (the Laplacian as a sparse tensor on the setup's
device).  Flattening convention: scalar fields ravel row-major over `N`;
vector fields ravel row-major over ``(D, *N)`` (component first), i.e.
``u.reshape(-1)`` of the port's layout.  The Dirichlet values are not
part of the BC matrices (their homogeneous part only).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..boundary_conditions import (
    DirichletBC,
    PeriodicBC,
    PressureBC,
    SymmetricBC,
    boundary_plane,
)
from ..grid import _numpy_dtype
from ._stencil import shifted, slc

__all__ = [
    "pad_scalarfield_mat",
    "pad_vectorfield_mat",
    "bc_u_mat",
    "bc_p_mat",
    "bc_temp_mat",
    "divergence_mat",
    "pressuregradient_mat",
    "volume_mat",
    "laplacian_mat",
    "diffusion_mat",
]


def _np_dtype(setup):
    return _numpy_dtype(setup.dtype)


def _ilin_p(g):
    return np.arange(int(np.prod(g.N))).reshape(g.N)


def _ilin_u(g):
    n = int(np.prod(g.N)) * g.dim
    return np.arange(n).reshape((g.dim, *g.N))


def _flat(ilin, box, comp=None, d=None, k=0):
    """Linear indices of `box` (shifted by `k` along `d`), of component
    `comp` of a vector field's index array."""
    sl = slc(box) if d is None else shifted(box, d, k)
    if comp is None:
        return ilin[sl].ravel()
    return ilin[(comp,) + sl].ravel()


def _csr(ii, jj, shape, dtype, vals=None):
    ii, jj = np.concatenate(ii), np.concatenate(jj)
    vals = np.ones(len(ii), dtype) if vals is None else np.concatenate(vals).astype(dtype)
    return sp.csr_matrix((vals, (ii, jj)), shape=shape)


def pad_scalarfield_mat(setup):
    """Pad the inner pressure DOFs with ghost volumes; the transpose
    restricts back to the DOFs."""
    g = setup.grid
    n = int(np.prod(g.N))
    npp = int(np.prod(g.Np))
    return _csr([_flat(_ilin_p(g), g.Ip)], [np.arange(npp)], (n, npp), _np_dtype(setup))


def pad_vectorfield_mat(setup):
    """Pad the inner velocity DOFs with ghost volumes."""
    g = setup.grid
    ilin = _ilin_u(g)
    ii = np.concatenate([_flat(ilin, g.Iu[a], comp=a) for a in range(g.dim)])
    n = int(np.prod(g.N)) * g.dim
    return _csr([ii], [np.arange(len(ii))], (n, len(ii)), _np_dtype(setup))


# --------------------------------------------------------------------------
# Boundary-condition matrices (homogeneous part only)
# --------------------------------------------------------------------------


def _identity_except_planes(ilin, N, beta, planes, comp=None):
    """(i, i) identity pairs over all indices but the `planes` of
    dimension `beta`."""
    keep = np.ones(N[beta], bool)
    keep[list(planes)] = False
    idx = np.nonzero(keep)[0]
    sl = tuple(idx if d == beta else slice(None) for d in range(len(N)))
    ii = ilin[sl].ravel() if comp is None else ilin[(comp,) + sl].ravel()
    return ii, ii.copy()


def _periodic_pairs(ilin, g, beta, comp=None):
    """The identity away from both boundary planes of `beta`, and each
    ghost plane from the opposite interior plane."""
    N = g.N
    ii, jj = _identity_except_planes(ilin, N, beta, (0, N[beta] - 1), comp)
    i_, j_ = [ii], [jj]
    Ia = boundary_plane(beta, N, g.Ip, False)
    Ib = boundary_plane(beta, N, g.Ip, True)
    i_ += [_flat(ilin, Ia, comp), _flat(ilin, Ib, comp)]
    j_ += [_flat(ilin, Ib, comp, beta, -1), _flat(ilin, Ia, comp, beta, +1)]
    return i_, j_


def _bc_u_mat_side(bc, setup, beta, isright):
    g = setup.grid
    D, N = g.dim, g.N
    n = int(np.prod(N)) * D
    ilin = _ilin_u(g)
    dtype = _np_dtype(setup)
    if isinstance(bc, PeriodicBC):
        if isright:
            return sp.identity(n, dtype=dtype, format="csr")
        i_, j_ = [], []
        for a in range(D):
            ia, ja = _periodic_pairs(ilin, g, beta, comp=a)
            i_ += ia
            j_ += ja
        return _csr(i_, j_, (n, n), dtype)
    i_, j_ = [], []
    for a in range(D):
        s, e = g.Iu[a][beta]
        ii, jj = _identity_except_planes(ilin, N, beta, (e if isright else s - 1,), comp=a)
        i_.append(ii)
        j_.append(jj)
        if isinstance(bc, PressureBC) or (isinstance(bc, SymmetricBC) and a != beta):
            box = boundary_plane(beta, N, g.Iu[a], isright)
            i_.append(_flat(ilin, box, a))
            j_.append(_flat(ilin, box, a, beta, -1 if isright else 1))
    return _csr(i_, j_, (n, n), dtype)


def _bc_p_mat_side(bc, setup, beta, isright):
    g = setup.grid
    N = g.N
    n = int(np.prod(N))
    ilin = _ilin_p(g)
    dtype = _np_dtype(setup)
    if isinstance(bc, PeriodicBC):
        if isright:
            return sp.identity(n, dtype=dtype, format="csr")
        return _csr(*_periodic_pairs(ilin, g, beta), (n, n), dtype)
    if isinstance(bc, DirichletBC):
        return sp.identity(n, dtype=dtype, format="csr")  # not used for p
    s, e = g.Ip[beta]
    ii, jj = _identity_except_planes(ilin, N, beta, (e if isright else s - 1,))
    i_, j_ = [ii], [jj]
    if isinstance(bc, SymmetricBC):
        box = boundary_plane(beta, N, g.Ip, isright)
        i_.append(_flat(ilin, box))
        j_.append(_flat(ilin, box, None, beta, -1 if isright else 1))
    # PressureBC: the plane stays zero (p = 0)
    return _csr(i_, j_, (n, n), dtype)


def _bc_temp_mat_side(bc, setup, beta, isright):
    g = setup.grid
    if isinstance(bc, PeriodicBC):
        return _bc_p_mat_side(bc, setup, beta, isright)
    if isinstance(bc, DirichletBC):
        s, e = g.Ip[beta]
        ii, jj = _identity_except_planes(_ilin_p(g), g.N, beta, (e if isright else s - 1,))
        n = int(np.prod(g.N))
        return _csr([ii], [jj], (n, n), _np_dtype(setup))
    if isinstance(bc, (SymmetricBC, PressureBC)):
        # a PressureBC fills the temperature as a symmetric side (apply_bc_temp)
        return _bc_p_mat_side(SymmetricBC(), setup, beta, isright)
    raise TypeError(f"Unknown boundary condition {bc!r}")


def _compose(side_fn, setup, bcs):
    B = None
    for beta in range(setup.grid.dim):
        bcl, bcr = bcs[beta]
        Bd = side_fn(bcr, setup, beta, True) @ side_fn(bcl, setup, beta, False)
        B = Bd if B is None else Bd @ B
    return B.tocsr()


def bc_u_mat(setup):
    """The velocity ghost fill as a matrix (dimension by dimension, left
    then right, as `apply_bc_u`)."""
    return _compose(_bc_u_mat_side, setup, setup.boundary_conditions)


def bc_p_mat(setup):
    """The pressure ghost fill as a matrix."""
    return _compose(_bc_p_mat_side, setup, setup.boundary_conditions)


def bc_temp_mat(setup):
    """The temperature ghost fill as a matrix."""
    return _compose(_bc_temp_mat_side, setup, setup.temperature.boundary_conditions)


# --------------------------------------------------------------------------
# Operator matrices
# --------------------------------------------------------------------------


def _seg_flat(arr, box, d, shift=0):
    """``arr[box[d] + shift]`` broadcast over `box` and raveled."""
    s, e = box[d]
    D = len(box)
    shape = tuple(hi - lo for (lo, hi) in box)
    vec = np.asarray(arr)[s + shift : e + shift]
    return np.broadcast_to(vec.reshape(tuple(-1 if i == d else 1 for i in range(D))),
                           shape).ravel()


def divergence_mat(setup):
    """The divergence, velocity points to pressure points."""
    g = setup.grid
    D, N = g.dim, g.N
    n = int(np.prod(N))
    ilp, ilu = _ilin_p(g), _ilin_u(g)
    box = g.Ip
    ip = _flat(ilp, box)
    i_, j_, v_ = [], [], []
    for a in range(D):
        dI = _seg_flat(g.delta[a], box, a)
        i_ += [ip, ip]
        j_ += [_flat(ilu, box, a), _flat(ilu, box, a, a, -1)]
        v_ += [1.0 / dI, -1.0 / dI]
    return _csr(i_, j_, (n, n * D), _np_dtype(setup), v_)


def pressuregradient_mat(setup):
    """The pressure gradient, pressure points to velocity points."""
    g = setup.grid
    D, N = g.dim, g.N
    n = int(np.prod(N))
    ilp, ilu = _ilin_p(g), _ilin_u(g)
    i_, j_, v_ = [], [], []
    for a in range(D):
        box = g.Iu[a]
        dI = _seg_flat(g.delta_u[a], box, a)
        iu = _flat(ilu, box, a)
        i_ += [iu, iu]
        j_ += [_flat(ilp, box, None, a, +1), _flat(ilp, box)]
        v_ += [1.0 / dI, -1.0 / dI]
    return _csr(i_, j_, (n * D, n), _np_dtype(setup), v_)


def volume_mat(setup):
    """The diagonal of the volume sizes."""
    g = setup.grid
    om = np.ones(g.N, _np_dtype(setup))
    for d in range(g.dim):
        om = om * np.asarray(g.delta[d]).reshape(tuple(-1 if i == d else 1 for i in range(g.dim)))
    return sp.diags(om.ravel()).tocsr()


def laplacian_mat(setup):
    """The pressure-Poisson operator on the pressure DOFs: the
    composition P' Ω M B_u G B_p P."""
    P = pad_scalarfield_mat(setup)
    Bp = bc_p_mat(setup)
    Bu = bc_u_mat(setup)
    G = pressuregradient_mat(setup)
    M = divergence_mat(setup)
    Om = volume_mat(setup)
    return (P.T @ (Om @ (M @ (Bu @ (G @ (Bp @ P)))))).tocsr()


def diffusion_mat(setup):
    """The diffusion without the viscosity (`diffusion(...,
    use_viscosity=False)`), with the same guard against infinitely thin
    ghost volumes."""
    g = setup.grid
    D, N = g.dim, g.N
    n = int(np.prod(N)) * D
    ilu = _ilin_u(g)
    dtype = _np_dtype(setup)
    eps2 = 2 * np.finfo(dtype).eps
    i_, j_, v_ = [], [], []
    for a in range(D):
        box = g.Iu[a]
        iu = _flat(ilu, box, a)
        for b in range(D):
            duab = _seg_flat(g.delta_u[b] if a == b else g.delta[b], box, b)
            if b == a:
                da, db = _seg_flat(g.delta[b], box, b), _seg_flat(g.delta[b], box, b, 1)
            else:
                da, db = _seg_flat(g.delta_u[b], box, b, -1), _seg_flat(g.delta_u[b], box, b)
            av = np.where(da > eps2, 1.0 / da / duab, 0.0)
            bv = np.where(db > eps2, 1.0 / db / duab, 0.0)
            i_ += [iu, iu, iu]
            j_ += [_flat(ilu, box, a, b, -1), _flat(ilu, box, a, b, +1), iu]
            v_ += [av, bv, -(av + bv)]
    return _csr(i_, j_, (n, n), dtype, v_)
