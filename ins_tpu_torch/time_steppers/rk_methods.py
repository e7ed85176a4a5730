"""Named Runge-Kutta tableau library.

The tableau data of `ins_tpu/time_steppers/rk_methods.py` (itself the
data of IncompressibleNavierStokes.jl `src/time_steppers/RKMethods.jl`),
translated rather than imported so that the port never pulls in JAX.
Pure numpy; `tests/test_torch_setup.py` holds every tableau equal to
the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np

from .methods import runge_kutta_method

__all__ = [
    "FE11", "SSP22", "SSP42", "SSP33", "SSP43", "SSP104", "rSSPs2",
    "rSSPs3", "Wray3", "RK56", "DOPRI6", "BE11", "SDIRK34", "ISSPm2",
    "ISSPs3", "HEM3", "HEM3BS", "HEM5", "GL1", "GL2", "GL3", "RIA1",
    "RIA2", "RIA3", "RIIA1", "RIIA2", "RIIA3", "LIIIA2", "LIIIA3",
    "CHDIRK3", "CHCONS3", "CHC3", "CHC5", "Mid22", "MTE22", "CN22",
    "Heun33", "RK33C2", "RK33P2", "RK44", "RK44C2", "RK44C23", "RK44P2",
    "DSso2", "DSRK2", "DSRK3", "NSSP21", "NSSP32", "NSSP33", "NSSP53",
]

_s6 = math.sqrt(6.0)
_s3 = math.sqrt(3.0)
_s15 = math.sqrt(15.0)


def _rowsum(A):
    return np.sum(np.asarray(A, dtype=np.float64), axis=1)


# -------------------- Explicit --------------------


def FE11(**kw):
    """Forward Euler."""
    return runge_kutta_method([[0]], [1], [0], 1, **kw)


def SSP22(**kw):
    A = [[0, 0], [1, 0]]
    return runge_kutta_method(A, [1 / 2, 1 / 2], _rowsum(A), 1, **kw)


def SSP42(**kw):
    t = 1 / 3
    A = [[0, 0, 0, 0], [t, 0, 0, 0], [t, t, 0, 0], [t, t, t, 0]]
    return runge_kutta_method(A, [1 / 4] * 4, _rowsum(A), 3, **kw)


def SSP33(**kw):
    A = [[0, 0, 0], [1, 0, 0], [1 / 4, 1 / 4, 0]]
    return runge_kutta_method(A, [1 / 6, 1 / 6, 2 / 3], _rowsum(A), 1, **kw)


def SSP43(**kw):
    A = [
        [0, 0, 0, 0],
        [1 / 2, 0, 0, 0],
        [1 / 2, 1 / 2, 0, 0],
        [1 / 6, 1 / 6, 1 / 6, 0],
    ]
    return runge_kutta_method(
        A, [1 / 6, 1 / 6, 1 / 6, 1 / 2], _rowsum(A), 2, **kw
    )


def SSP104(**kw):
    s = 10
    alpha = np.diag(np.ones(s - 1), -1)
    alpha[5, 4] = 2 / 5
    alpha[5, 0] = 3 / 5
    beta = np.diag(np.ones(s - 1), -1) / 6
    beta[5, 4] = 1 / 15
    A = np.linalg.solve(np.eye(s) - alpha, beta)
    return runge_kutta_method(A, [1 / 10] * s, _rowsum(A), 6, **kw)


def rSSPs2(s=2, **kw):
    """Optimal low-storage s-stage 2nd-order SSP family."""
    if s < 2:
        raise ValueError("requires s >= 2")
    r = s - 1
    alpha = np.vstack([np.zeros((1, s)), np.eye(s)])
    alpha[s, s - 1] = (s - 1) / s
    beta = alpha / r
    alpha[s, 0] = 1 / s
    A = np.linalg.solve(np.eye(s) - alpha[:s, :], beta[:s, :])
    b = beta[s, :] + A.T @ alpha[s, :]
    return runge_kutta_method(A, b, _rowsum(A), r, **kw)


def rSSPs3(s=4, **kw):
    """Optimal low-storage s²-stage 3rd-order SSP family (s = n², n > 1)."""
    n_ = round(math.sqrt(s))
    if n_ * n_ != s or s < 4:
        raise ValueError("requires s = n^2, n > 1")
    n = s * s
    r = n - s
    alpha = np.vstack([np.zeros((1, n)), np.eye(n)])
    alpha[s * (s + 1) // 2, s * (s + 1) // 2 - 1] = (s - 1) / (2 * s - 1)
    beta = alpha / r
    alpha[s * (s + 1) // 2, (s - 1) * (s - 2) // 2] = s / (2 * s - 1)
    A = np.linalg.solve(np.eye(n) - alpha[:n, :], beta[:n, :])
    b = beta[n, :] + A.T @ alpha[n, :]
    return runge_kutta_method(A, b, _rowsum(A), r, **kw)


def Wray3(**kw):
    A = np.zeros((3, 3))
    A[1, 0] = 8 / 15
    A[2, 0] = 8 / 15 - 17 / 60
    A[2, 1] = 5 / 12
    b = [8 / 15 - 17 / 60, 0, 3 / 4]
    c = [0, A[1, 0], A[2, 0] + A[2, 1]]
    return runge_kutta_method(A, b, c, 0, **kw)


def RK56(**kw):
    A = [
        [0, 0, 0, 0, 0, 0],
        [1 / 4, 0, 0, 0, 0, 0],
        [1 / 8, 1 / 8, 0, 0, 0, 0],
        [0, 0, 1 / 2, 0, 0, 0],
        [3 / 16, -3 / 8, 3 / 8, 9 / 16, 0, 0],
        [-3 / 7, 8 / 7, 6 / 7, -12 / 7, 8 / 7, 0],
    ]
    b = [7 / 90, 0, 16 / 45, 2 / 15, 16 / 45, 7 / 90]
    c = [0, 1 / 4, 1 / 4, 1 / 2, 3 / 4, 1]
    return runge_kutta_method(A, b, c, 0, **kw)


def DOPRI6(**kw):
    A = [
        [0, 0, 0, 0, 0, 0],
        [1 / 5, 0, 0, 0, 0, 0],
        [3 / 40, 9 / 40, 0, 0, 0, 0],
        [44 / 45, -56 / 15, 32 / 9, 0, 0, 0],
        [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0],
        [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0],
    ]
    b = [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]
    return runge_kutta_method(A, b, _rowsum(A), 0, **kw)


# -------------------- Implicit --------------------


def BE11(**kw):
    return runge_kutta_method([[1]], [1], [1], 1.0e10, **kw)


def SDIRK34(**kw):
    g = 0.5 * (1 - math.cos(math.pi / 18) / _s3 - math.sin(math.pi / 18))
    q = (0.5 - g) ** 2
    A = [[g, 0, 0], [0.5 - g, g, 0], [2 * g, 1 - 4 * g, g]]
    b = [1 / (24 * q), 1 - 1 / (12 * q), 1 / (24 * q)]
    return runge_kutta_method(A, b, _rowsum(A), 1.7588, **kw)


def ISSPm2(s=1, **kw):
    i = np.arange(1, s + 1)[:, None] * np.ones((1, s))
    j = i.T
    A = (j < i) / s + (i == j) / (2 * s)
    return runge_kutta_method(A, [1 / s] * s, _rowsum(A), 0, **kw)


def ISSPs3(s=2, **kw):
    if s < 2:
        raise ValueError("requires s >= 2")
    r = s - 1 + math.sqrt(s * s - 1)
    i = np.arange(1, s + 1)[:, None] * np.ones((1, s))
    j = i.T
    A = (j < i) / math.sqrt(s * s - 1) + (i == j) * 0.5 * (
        1 - math.sqrt((s - 1) / (s + 1))
    )
    return runge_kutta_method(A, [1 / s] * s, _rowsum(A), r, **kw)


# -------------------- Half-explicit --------------------


def HEM3(**kw):
    A = [[0, 0, 0], [1 / 3, 0, 0], [-1, 2, 0]]
    return runge_kutta_method(A, [0, 3 / 4, 1 / 4], _rowsum(A), 0, **kw)


def HEM3BS(**kw):
    A = [[0, 0, 0], [1 / 2, 0, 0], [-1, 2, 0]]
    return runge_kutta_method(A, [1 / 6, 2 / 3, 1 / 6], _rowsum(A), 0, **kw)


def HEM5(**kw):
    A = [
        [0, 0, 0, 0, 0],
        [3 / 10, 0, 0, 0, 0],
        [(1 + _s6) / 30, (11 - 4 * _s6) / 30, 0, 0, 0],
        [(-79 - 31 * _s6) / 150, (-1 - 4 * _s6) / 30, (24 + 11 * _s6) / 25, 0, 0],
        [(14 + 5 * _s6) / 6, (-8 + 7 * _s6) / 6, (-9 - 7 * _s6) / 4, (9 - _s6) / 4, 0],
    ]
    b = [0, 0, (16 - _s6) / 36, (16 + _s6) / 36, 1 / 9]
    return runge_kutta_method(A, b, _rowsum(A), 0, **kw)


# -------------------- Classical implicit --------------------


def GL1(**kw):
    return runge_kutta_method([[1 / 2]], [1], [1 / 2], 2, **kw)


def GL2(**kw):
    A = [[1 / 4, 1 / 4 - _s3 / 6], [1 / 4 + _s3 / 6, 1 / 4]]
    c = [1 / 2 - _s3 / 6, 1 / 2 + _s3 / 6]
    return runge_kutta_method(A, [1 / 2, 1 / 2], c, 0, **kw)


def GL3(**kw):
    A = [
        [5 / 36, (80 - 24 * _s15) / 360, (50 - 12 * _s15) / 360],
        [(50 + 15 * _s15) / 360, 2 / 9, (50 - 15 * _s15) / 360],
        [(50 + 12 * _s15) / 360, (80 + 24 * _s15) / 360, 5 / 36],
    ]
    b = [5 / 18, 4 / 9, 5 / 18]
    c = [(5 - _s15) / 10, 1 / 2, (5 + _s15) / 10]
    return runge_kutta_method(A, b, c, 0, **kw)


def RIA1(**kw):
    return runge_kutta_method([[1]], [1], [0], 1, **kw)


def RIA2(**kw):
    A = [[1 / 4, -1 / 4], [1 / 4, 5 / 12]]
    return runge_kutta_method(A, [1 / 4, 3 / 4], [0, 2 / 3], 0, **kw)


def RIA3(**kw):
    A = [
        [1 / 9, (-1 - _s6) / 18, (-1 + _s6) / 18],
        [1 / 9, (88 + 7 * _s6) / 360, (88 - 43 * _s6) / 360],
        [1 / 9, (88 + 43 * _s6) / 360, (88 - 7 * _s6) / 360],
    ]
    b = [1 / 9, (16 + _s6) / 36, (16 - _s6) / 36]
    c = [0, (6 - _s6) / 10, (6 + _s6) / 10]
    return runge_kutta_method(A, b, c, 0, **kw)


def RIIA1(**kw):
    return runge_kutta_method([[1]], [1], [1], 1, **kw)


def RIIA2(**kw):
    A = [[5 / 12, -1 / 12], [3 / 4, 1 / 4]]
    return runge_kutta_method(A, [3 / 4, 1 / 4], [1 / 3, 1], 0, **kw)


def RIIA3(**kw):
    A = [
        [(88 - 7 * _s6) / 360, (296 - 169 * _s6) / 1800, (-2 + 3 * _s6) / 225],
        [(296 + 169 * _s6) / 1800, (88 + 7 * _s6) / 360, (-2 - 3 * _s6) / 225],
        [(16 - _s6) / 36, (16 + _s6) / 36, 1 / 9],
    ]
    b = [(16 - _s6) / 36, (16 + _s6) / 36, 1 / 9]
    c = [(4 - _s6) / 10, (4 + _s6) / 10, 1]
    return runge_kutta_method(A, b, c, 0, **kw)


def LIIIA2(**kw):
    A = [[0, 0], [1 / 2, 1 / 2]]
    return runge_kutta_method(A, [1 / 2, 1 / 2], [0, 1], 0, **kw)


def LIIIA3(**kw):
    A = [[0, 0, 0], [5 / 24, 1 / 3, -1 / 24], [1 / 6, 2 / 3, 1 / 6]]
    return runge_kutta_method(A, [1 / 6, 2 / 3, 1 / 6], [0, 1 / 2, 1], 0, **kw)


# -------------------- Chebyshev --------------------


def CHDIRK3(**kw):
    A = [[0, 0, 0], [1 / 4, 1 / 4, 0], [0, 1, 0]]
    return runge_kutta_method(A, [1 / 6, 2 / 3, 1 / 6], [0, 1 / 2, 1], 0, **kw)


def CHCONS3(**kw):
    A = [
        [1 / 12, -1 / 6, 1 / 12],
        [5 / 24, 1 / 3, -1 / 24],
        [1 / 12, 5 / 6, 1 / 12],
    ]
    return runge_kutta_method(A, [1 / 6, 2 / 3, 1 / 6], [0, 1 / 2, 1], 0, **kw)


def CHC3(**kw):
    A = [[0, 0, 0], [5 / 24, 1 / 3, -1 / 24], [1 / 6, 2 / 3, 1 / 6]]
    return runge_kutta_method(A, [1 / 6, 2 / 3, 1 / 6], [0, 1 / 2, 1], 0, **kw)


def CHC5(**kw):
    A = [
        [0, 0, 0, 0, 0],
        [0.059701779686442, 0.095031716019062, -0.012132034355964,
         0.006643368370744, -0.002798220313558],
        [0.016666666666667, 0.310110028629970, 0.200000000000000,
         -0.043443361963304, 0.016666666666667],
        [0.036131553646891, 0.260023298295923, 0.412132034355964,
         0.171634950647605, -0.026368446353109],
        [0.033333333333333, 0.266666666666667, 0.400000000000000,
         0.266666666666667, 0.033333333333333],
    ]
    b = [1 / 30, 4 / 15, 2 / 5, 4 / 15, 1 / 30]
    c = [0, 0.146446609406726, 0.5, 0.853553390593274, 1.0]
    return runge_kutta_method(A, b, c, 0, **kw)


# -------------------- Miscellaneous --------------------


def Mid22(**kw):
    return runge_kutta_method([[0, 0], [1 / 2, 0]], [0, 1], [0, 1 / 2], 1 / 2, **kw)


def MTE22(**kw):
    return runge_kutta_method(
        [[0, 0], [2 / 3, 0]], [1 / 4, 3 / 4], [0, 2 / 3], 1 / 2, **kw
    )


def CN22(**kw):
    return runge_kutta_method(
        [[0, 0], [1 / 2, 1 / 2]], [1 / 2, 1 / 2], [0, 1], 2, **kw
    )


def Heun33(**kw):
    A = [[0, 0, 0], [1 / 3, 0, 0], [0, 2 / 3, 0]]
    return runge_kutta_method(A, [1 / 4, 0, 3 / 4], _rowsum(A), 0, **kw)


def RK33C2(**kw):
    A = [[0, 0, 0], [2 / 3, 0, 0], [1 / 3, 1 / 3, 0]]
    return runge_kutta_method(A, [1 / 4, 0, 3 / 4], [0, 2 / 3, 2 / 3], 0, **kw)


def RK33P2(**kw):
    A = [[0, 0, 0], [1 / 3, 0, 0], [-1, 2, 0]]
    return runge_kutta_method(A, [0, 3 / 4, 1 / 4], [0, 1 / 3, 1], 0, **kw)


def RK44(**kw):
    """Classical fourth order (default method)."""
    A = [[0, 0, 0, 0], [1 / 2, 0, 0, 0], [0, 1 / 2, 0, 0], [0, 0, 1, 0]]
    return runge_kutta_method(
        A, [1 / 6, 1 / 3, 1 / 3, 1 / 6], _rowsum(A), 0, **kw
    )


def RK44C2(**kw):
    A = [[0, 0, 0, 0], [1 / 4, 0, 0, 0], [0, 1 / 2, 0, 0], [1, -2, 2, 0]]
    return runge_kutta_method(
        A, [1 / 6, 0, 2 / 3, 1 / 6], [0, 1 / 4, 1 / 2, 1], 0, **kw
    )


def RK44C23(**kw):
    A = [[0, 0, 0, 0], [1 / 2, 0, 0, 0], [1 / 4, 1 / 4, 0, 0], [0, -1, 2, 0]]
    return runge_kutta_method(
        A, [1 / 6, 0, 2 / 3, 1 / 6], [0, 1 / 2, 1 / 2, 1], 0, **kw
    )


def RK44P2(**kw):
    A = [
        [0, 0, 0, 0],
        [1, 0, 0, 0],
        [3 / 8, 1 / 8, 0, 0],
        [-1 / 8, -3 / 8, 3 / 2, 0],
    ]
    return runge_kutta_method(
        A, [1 / 6, -1 / 18, 2 / 3, 2 / 9], [0, 1, 1 / 2, 1], 0, **kw
    )


# -------------------- DSRK --------------------


def DSso2(**kw):
    A = [[3 / 4, -1 / 4], [1, 0]]
    return runge_kutta_method(A, [1, 0], [1 / 2, 1], 0, **kw)


def DSRK2(**kw):
    A = [[1 / 2, -1 / 2], [1 / 2, 1 / 2]]
    return runge_kutta_method(A, [1 / 2, 1 / 2], [0, 1], 0, **kw)


def DSRK3(**kw):
    A = [[5 / 2, -2, -1 / 2], [-1, 2, -1 / 2], [1 / 6, 2 / 3, 1 / 6]]
    return runge_kutta_method(A, [1 / 6, 2 / 3, 1 / 6], [0, 1 / 2, 1], 0, **kw)


# -------------------- Non-SSP (Wong & Spiteri) --------------------


def NSSP21(**kw):
    A = [[0, 0], [3 / 4, 0]]
    return runge_kutta_method(A, [0, 1], [0, 3 / 4], 0, **kw)


def NSSP32(**kw):
    A = [[0, 0, 0], [1 / 3, 0, 0], [0, 1, 0]]
    return runge_kutta_method(A, [1 / 2, 0, 1 / 2], [0, 1 / 3, 1], 0, **kw)


def NSSP33(**kw):
    A = [[0, 0, 0], [-4 / 9, 0, 0], [7 / 6, -1 / 2, 0]]
    return runge_kutta_method(A, [1 / 4, 0, 3 / 4], [0, -4 / 9, 2 / 3], 0, **kw)


def NSSP53(**kw):
    A = [
        [0, 0, 0, 0, 0],
        [1 / 7, 0, 0, 0, 0],
        [0, 3 / 16, 0, 0, 0],
        [0, 0, 1 / 3, 0, 0],
        [0, 0, 0, 2 / 3, 0],
    ]
    b = [1 / 4, 0, 0, 0, 3 / 4]
    c = [0, 1 / 7, 3 / 16, 1 / 3, 2 / 3]
    return runge_kutta_method(A, b, c, 0, **kw)
