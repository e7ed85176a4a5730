"""Initial fields.

Port of `scalarfield`, `vectorfield`, `velocityfield`,
`temperaturefield`, `create_spectrum` and `random_field` from
`ins_tpu/ops/initializers.py`.  `velocityfield` evaluates a function at
the staggered velocity points and projects it: on a uniform periodic
grid or a channel with the path's own ghost-free projection, on any
other grid through the ghosted path (the ghost fill, `project`, the
ghost fill again, as the JAX package does); `temperaturefield` evaluates
one at the pressure points and fills the ghosts with `apply_bc_temp`.
`random_field` builds synthetic turbulence on a
uniform periodic grid: the Orlandi-style energy spectrum peaked at `kp`,
random phases and unit vectors, a spectral Leray projection, an inverse
FFT and a final discrete projection.  Randomness comes from an explicit
`torch.Generator`; a test passes the JAX package's uniform draws through
`uniforms=` to compare the two field for field.
"""

from __future__ import annotations

import numpy as np
import torch

from ..boundary_conditions import apply_bc_temp, apply_bc_u
from ._stencil import seg, slc
from .channelpath import (
    channel_correct_roll,
    channel_divergence_roll,
    channelpath_applicable,
    make_channel_metrics,
    reghost_channel,
)
from .fastpath import reghost
from .fdm import om_box
from .pressure import default_psolver, project, project_periodic, psolver_spectral, uniform_dxs

__all__ = [
    "scalarfield",
    "vectorfield",
    "velocityfield",
    "temperaturefield",
    "create_spectrum",
    "random_field",
    "spectrum_draw_shapes",
]


def scalarfield(setup):
    """Empty scalar field (ghosts included) on `setup.device`."""
    return torch.zeros(setup.grid.N, dtype=setup.dtype, device=setup.device)


def vectorfield(setup):
    """Empty velocity field, component first ``(D, *N)``, on `setup.device`."""
    g = setup.grid
    return torch.zeros((g.dim, *g.N), dtype=setup.dtype, device=setup.device)


def _box_values(setup, func, coords_1d, box, *args):
    """``func(*args, *x)`` on `box`'s points, as a tensor of the box's shape."""
    D = setup.grid.dim
    coords = [seg(coords_1d[b], box, b, device=setup.device) for b in range(D)]
    return func(*args, *coords) * torch.ones(tuple(e - s for s, e in box), dtype=setup.dtype,
                                             device=setup.device)


def velocityfield(setup, ufunc, t=0.0, *, psolver=None, doproject=True):
    """Velocity field from ``ufunc(alpha, *x)`` (a torch function; ``alpha``
    a Python int, the coordinates broadcastable tensors) at the staggered
    velocity points, projected onto its divergence-free part, in the
    public ghosted layout on `setup.device`.  Uniform periodic grids and
    channels (static z walls; w's top-wall slot stays 0) take their
    path's own projection; any other grid the ghosted one, its ghosts
    filled at time ``t`` before and after."""
    g = setup.grid
    D = g.dim
    periodic = all(g.periodic) and all(g.uniform)
    if doproject and psolver is None:
        psolver = default_psolver(setup)
    if not (periodic or channelpath_applicable(setup)):
        u = vectorfield(setup)
        for a in range(D):
            u[(a,) + slc(g.Iu[a])] = _box_values(setup, ufunc, g.xu[a], g.Iu[a], a)
        u = apply_bc_u(u, t, setup)
        if doproject:
            u = apply_bc_u(project(u, setup, psolver=psolver), t, setup)
        return u
    dtype, device = setup.dtype, setup.device
    u = torch.zeros((D, *(n - 2 for n in g.N)), dtype=dtype, device=device)
    for a in range(D):
        box = g.Iu[a]
        u[(a,) + tuple(slice(s - 1, e - 1) for s, e in box)] = _box_values(
            setup, ufunc, g.xu[a], box, a)
    if doproject:
        if periodic:
            u = project_periodic(u, uniform_dxs(setup), psolver)
        else:
            met = make_channel_metrics(setup)
            q = psolver(om_box(setup) * channel_divergence_roll(u, met))
            u = channel_correct_roll(u, q, met)
    return reghost(u) if periodic else reghost_channel(u, setup)


def temperaturefield(setup, tempfunc, t=0.0):
    """Temperature field from ``tempfunc(*x)`` (a torch function of
    broadcastable coordinate tensors) at the pressure points, in the
    public ghosted layout, its ghosts filled at time ``t``."""
    if setup.temperature is None:
        raise ValueError("temperaturefield requires a setup with a temperature equation")
    g = setup.grid
    temp = scalarfield(setup)
    temp[slc(g.Ip)] = _box_values(setup, tempfunc, g.xp, g.Ip)
    return apply_bc_temp(temp, t, setup)


def spectrum_draw_shapes(setup):
    """Shapes of the uniform draws `create_spectrum` makes, in order:
    one phase array of shape K per dimension, then the unit-vector
    angles (one array of shape 2K in 2-D, two in 3-D)."""
    D = setup.grid.dim
    K = tuple((n - 2) // 2 for n in setup.grid.N)
    KK = tuple(2 * k for k in K)
    return [K] * D + [KK] * (1 if D == 2 else 2)


def create_spectrum(setup, *, kp, generator=None, uniforms=None):
    """Spectral velocity amplitudes with prescribed energy profile, random
    phases, and spectral Leray projection.  Returns complex `uhat` of
    shape `(D, *(N - 2))`."""
    g = setup.grid
    D = g.dim
    dtype, device = setup.dtype, setup.device
    cdtype = torch.complex64 if dtype == torch.float32 else torch.complex128
    tau = 2 * np.pi
    N = g.N
    if not all(n % 2 == 0 for n in N):
        raise ValueError("Spectrum requires even N")
    K = tuple((n - 2) // 2 for n in N)
    shapes = spectrum_draw_shapes(setup)
    if uniforms is None:
        uniforms = [
            torch.rand(s, generator=generator, dtype=dtype, device=device)
            for s in shapes
        ]
    else:
        if [tuple(np.shape(v)) for v in uniforms] != [tuple(s) for s in shapes]:
            raise ValueError(f"uniforms must have shapes {shapes}")
        uniforms = [torch.as_tensor(np.array(v), dtype=dtype, device=device)
                    for v in uniforms]

    def bshape(arr, d):
        return arr.reshape(tuple(-1 if i == d else 1 for i in range(D)))

    k2 = sum(bshape(torch.arange(K[d], dtype=dtype, device=device) ** 2, d)
             for d in range(D))
    k = torch.sqrt(k2)

    A = (8 * tau / 3) / kp**5
    a = torch.sqrt(A * k**4 * torch.exp(-tau * (k / kp) ** 2)).to(dtype)
    a = a * float(np.prod(N))
    a = a.to(cdtype)

    xi = list(uniforms[:D])
    for d in range(D):
        a = torch.cat([a, torch.flip(a, dims=(d,))], dim=d)
        xi = [
            torch.cat([x, torch.flip(-x if b == d else x, dims=(d,))], dim=d)
            for b, x in enumerate(xi)
        ]
    phase = sum(xi)
    a = torch.exp(1j * tau * phase) * a

    KK = tuple(2 * kd for kd in K)
    kk = [bshape(torch.arange(KK[d], dtype=dtype, device=device), d) for d in range(D)]
    knorm2 = sum(kd**2 for kd in kk)
    knorm2[(0,) * D] = 1.0  # origin: zero wavevector, no projection

    if D == 2:
        theta = uniforms[D]
        e = [torch.cos(tau * theta), torch.sin(tau * theta)]
    else:
        theta, phi = uniforms[D], uniforms[D + 1]
        e = [
            torch.sin(np.pi * theta) * torch.cos(tau * phi),
            torch.sin(np.pi * theta) * torch.sin(tau * phi),
            torch.cos(np.pi * theta),
        ]

    ke = sum(e[d] * kk[d] for d in range(D))
    e = [e[d] - kk[d] * ke / knorm2 for d in range(D)]
    enorm = torch.sqrt(sum(ed**2 for ed in e))
    e = [ed / enorm for ed in e]

    return torch.stack([a * ed for ed in e])


def random_field(setup, t=0.0, *, A=1.0, kp=10, psolver=None, generator=None,
                 uniforms=None):
    """Random turbulent velocity field (Orlandi2000 spectrum) on a
    uniform periodic grid, returned in the public ghosted layout
    `(D, *N)`.  ``generator`` is a `torch.Generator` on the setup's
    device (None: the global generator); ``uniforms`` replaces its draws
    (see `spectrum_draw_shapes`).  ``t`` is accepted for parity with the
    JAX signature; a periodic field does not depend on it."""
    g = setup.grid
    D = g.dim
    if not (all(g.periodic) and all(g.uniform)):
        raise ValueError("random_field requires a uniform periodic grid")
    if psolver is None:
        psolver = psolver_spectral(setup)
    uhat = create_spectrum(setup, kp=kp, generator=generator, uniforms=uniforms)
    u = torch.fft.ifftn(uhat, dim=tuple(range(1, D + 1)))
    u = A * u.real.to(setup.dtype)
    u = project_periodic(u, uniform_dxs(setup), psolver)
    return reghost(u)
