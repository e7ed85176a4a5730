"""Processors: in-loop observability.

Port of the protocol, `timelogger`, `fieldsaver`, `observefield`,
`fieldobserver`, `get_streamfunction`, `observespectrum`,
`observe_nusselt` and `observe_wallshear` of `ins_tpu/processors.py`,
plus `total_kinetic_energy` (`ops/operators.py`), on any grid.  A
processor is ``(initialize, update, finalize)`` over snapshots of the
solver state taken at chunk boundaries; ``nupdate`` decimation also
sets the chunk size, so no step forces a device-to-host sync.  The
other observers (VTK output, the profiler hook) wait for ROADMAP queue
1 item 10.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from .grid import _numpy_dtype
from .ops import operators as ops
from .ops._stencil import seg, slc
from .ops.operators import total_kinetic_energy
from .ops.pressure import default_psolver, pressure
from .ops.tensorbasis import tensorbasis
from .utils.spectrum import observe_spectrum, spectral_stuff

__all__ = [
    "Processor",
    "processor",
    "timelogger",
    "fieldsaver",
    "observefield",
    "fieldobserver",
    "get_streamfunction",
    "observespectrum",
    "observe_nusselt",
    "observe_wallshear",
    "total_kinetic_energy",
]


@dataclasses.dataclass
class Processor:
    initialize: Callable[[dict], Any]
    update: Callable[[Any, dict], Any]
    finalize: Callable[[Any, dict], Any]
    nupdate: int = 1


def processor(update, *, initialize=None, finalize=None, nupdate=1):
    """Build a processor from an update function `pstate, state -> pstate`."""
    return Processor(
        initialize=initialize or (lambda state: None),
        update=update,
        finalize=finalize or (lambda pstate, state: pstate),
        nupdate=nupdate,
    )


def timelogger(nupdate=1):
    """Print step number, time, wall time per step and umax."""

    def initialize(state):
        return {"wall": time.perf_counter(), "n": int(state["n"])}

    def update(pstate, state):
        umax = float(state["u"].abs().max())  # waits for the device
        now = time.perf_counter()
        n = int(state["n"])
        itertime = (now - pstate["wall"]) / max(1, n - pstate["n"])
        print(
            f"Iteration {n}\tt = {float(state['t']):.3g}"
            f"\tΔt_wall = {itertime * 1e3:.3g} ms/it\tumax = {umax:.3g}"
        )
        return {"wall": now, "n": n}

    return Processor(initialize, update, lambda p, s: None, nupdate)


def fieldsaver(nupdate=1):
    """Keep host (numpy) copies of the state every `nupdate` steps."""

    def initialize(state):
        return []

    def update(fields, state):
        temp = state.get("temp")
        fields.append(
            dict(
                u=state["u"].detach().cpu().numpy(),
                temp=None if temp is None else temp.detach().cpu().numpy(),
                t=float(state["t"]),
            )
        )
        return fields

    return Processor(initialize, update, lambda fields, s: fields, nupdate)


def _to_host(v):
    """Tensors (also inside lists, tuples and dicts) as numpy arrays."""
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    if isinstance(v, (list, tuple)):
        return type(v)(_to_host(x) for x in v)
    if isinstance(v, dict):
        return {k: _to_host(x) for k, x in v.items()}
    return v


def observefield(func, *, nupdate=1):
    """Record a derived quantity `func(state) -> value` every `nupdate`
    steps, tensors copied to the host as numpy arrays."""

    def initialize(state):
        return []

    def update(vals, state):
        vals.append(_to_host(func(state)))
        return vals

    return Processor(initialize, update, lambda vals, s: vals, nupdate)


def get_streamfunction(u, setup):
    """2-D streamfunction psi with ∇²psi = −omega on a uniform periodic
    grid: the spectral solve of the vorticity (zero-mean), on the
    pressure DOF box of a zero field."""
    g = setup.grid
    if g.dim != 2 or not (all(g.periodic) and all(g.uniform)):
        raise ValueError("the streamfunction needs a 2-D uniform periodic grid")
    ip = slc(g.Ip)
    wi = ops.vorticity(u, setup)[ip]
    dx = [float(g.delta[d][0]) for d in range(2)]
    kx = np.fft.fftfreq(g.Np[0]) * 2 * np.pi / dx[0]
    ky = np.fft.rfftfreq(g.Np[1]) * 2 * np.pi / dx[1]
    k2 = kx[:, None] ** 2 + ky[None, :] ** 2
    k2[0, 0] = 1.0
    inv_k2 = 1.0 / k2
    inv_k2[0, 0] = 0.0  # the zero-mean mode
    psihat = torch.fft.rfftn(wi) * torch.as_tensor(inv_k2, dtype=wi.dtype, device=wi.device)
    out = torch.zeros(g.N, dtype=u.dtype, device=u.device)
    out[ip] = torch.fft.irfftn(psihat, s=wi.shape).to(u.dtype)
    return out


def fieldobserver(setup, fieldname, *, psolver=None, logtol=None):
    """``state -> field`` at the pressure DOFs (`ins_tpu.fieldobserver`).
    Names: a component index 0..D-1, "velocity", "velocitynorm",
    "vorticity", "streamfunction" (2-D periodic), "pressure", "Dfield",
    "Qfield", "eig2field" (3-D), "temperature", and the tensor-basis
    channels "B1".. and invariants "V1"...  The vortex criteria are
    returned as ``log(max(logtol, ·))`` (λ₂ negated), `logtol` the
    dtype's eps by default; the pressure is solved by `psolver`
    (`default_psolver(setup)` where None)."""
    g = setup.grid
    D = g.dim
    ip = slc(g.Ip)
    if logtol is None:
        logtol = float(np.finfo(_numpy_dtype(setup.dtype)).eps)
    if fieldname in ("pressure", "Dfield") and psolver is None:
        psolver = default_psolver(setup)

    def logclip(f):
        return torch.log(torch.clamp(f, min=logtol))

    def compute(state):
        u, temp, t = state["u"], state["temp"], state["t"]
        if isinstance(fieldname, int):
            return ops.interpolate_u_p(u, setup)[fieldname][ip]
        if fieldname == "velocity":
            return ops.interpolate_u_p(u, setup)[(slice(None),) + ip]
        if fieldname == "velocitynorm":
            up = ops.interpolate_u_p(u, setup)
            return torch.sqrt(sum(up[a] ** 2 for a in range(D)))[ip]
        if fieldname == "vorticity":
            wp = ops.interpolate_omega_p(ops.vorticity(u, setup), setup)
            return wp[ip] if D == 2 else wp[(slice(None),) + ip]
        if fieldname == "streamfunction":
            return get_streamfunction(u, setup)[ip]
        if fieldname == "pressure":
            return pressure(u, temp, t, setup, psolver=psolver)[ip]
        if fieldname == "Dfield":
            return logclip(ops.Dfield(pressure(u, temp, t, setup, psolver=psolver), setup)[ip])
        if fieldname == "Qfield":
            return logclip(ops.Qfield(u, setup)[ip])
        if fieldname == "eig2field":
            return logclip(-ops.eig2field(u, setup)[ip])
        if fieldname == "temperature":
            return temp[ip]
        if isinstance(fieldname, str) and fieldname[:1] in ("B", "V") and fieldname[1:].isdigit():
            B, V = tensorbasis(u, setup)
            return (B if fieldname[0] == "B" else V)[int(fieldname[1:]) - 1][ip]
        raise ValueError(f"Unknown fieldname {fieldname!r}")

    return compute


def observespectrum(setup, *, nupdate=1, npoint=100):
    """Processor recording the binned kinetic-energy spectrum: per velocity
    component the FFT of the interior, cropped to the first K wavenumbers
    per dimension, |û|²/(2·prod(Np)²) summed and binned by
    `utils.spectrum.observe_spectrum`.  Returns dict(kappa, ehat, t)."""
    g = setup.grid
    D = g.dim
    st = spectral_stuff(setup, npoint=npoint)
    K = st["K"]
    ip = tuple(slice(s, e) for s, e in g.Ip)
    scale = 2 * float(np.prod(g.Np)) ** 2

    def ehat_of(u):
        e = 0.0
        for a in range(D):
            uhat = u[a][ip]
            for d in range(D):  # per axis, cropped as it goes
                uhat = torch.fft.fft(uhat, dim=d).narrow(d, 0, K[d])
            e = e + uhat.abs() ** 2 / scale
        return observe_spectrum(e.to(u.dtype), st)

    def initialize(state):
        return dict(kappa=st["kappa"].cpu().numpy(), ehat=[], t=[])

    def update(ps, state):
        ps["ehat"].append(ehat_of(state["u"]).cpu().numpy())
        ps["t"].append(float(state["t"]))
        return ps

    return Processor(initialize, update, lambda ps, s: ps, nupdate)


def _interior_volume_weights(setup):
    """Cell volumes over the interior pressure box (volume averages on
    stretched grids)."""
    g = setup.grid
    w = torch.ones(tuple(e - s for s, e in g.Ip), dtype=setup.dtype, device=setup.device)
    for d in range(g.dim):
        w = w * seg(g.delta[d], g.Ip, d, device=setup.device).to(setup.dtype)
    return w


def observe_nusselt(setup, *, nupdate=1):
    """Processor recording the volume-averaged Nusselt number
    ``Nu = 1 + <u_g θ>/α4`` (`ins_tpu.processors.observe_nusselt`): u_g,
    the velocity in the gravity direction averaged to the pressure points
    from I and I − e_g, times the temperature, volume-weighted over the
    interior (`_interior_volume_weights`), on any grid.  Returns
    dict(t, Nu)."""
    te = setup.temperature
    if te is None:
        raise ValueError("observe_nusselt requires a temperature equation")
    g = setup.grid
    gdir = te.gdir
    ip = tuple(slice(s, e) for s, e in g.Ip)
    left = tuple(slice(s - (d == gdir), e - (d == gdir)) for d, (s, e) in enumerate(g.Ip))
    w = _interior_volume_weights(setup)
    wsum = torch.sum(w)

    def nu_of(u, temp):
        up = (u[gdir][left] + u[gdir][ip]) / 2
        return 1.0 + torch.sum(w * up * temp[ip]) / wsum / te.alpha4

    def update(ps, state):
        ps["t"].append(float(state["t"]))
        ps["Nu"].append(float(nu_of(state["u"], state["temp"])))
        return ps

    def initialize(state):
        return update(dict(t=[], Nu=[]), state)

    return Processor(initialize, update, lambda ps, s: ps, nupdate)


def observe_wallshear(setup, *, dim, side, component, nupdate=1):
    """Processor recording the mean wall shear stress ``τ_w = (1/Re)
    ∂u_c/∂x_d`` (the signed coordinate derivative) at a domain boundary:
    `dim` the wall-normal dimension, `side` 0 (low) or 1 (high),
    `component` a tangential velocity component.  It differences the
    first interior plane and the ghost plane that straddle the wall, so
    it reads the ghosts the fills keep (the channel path's state crosses
    to the ghosted layout through `reghost_channel`).  Returns dict(t,
    tau)."""
    g = setup.grid
    D = g.dim
    if component == dim:
        raise ValueError("wall shear needs a tangential component")
    n = g.N[dim]
    i_in, i_gh = (1, 0) if side == 0 else (n - 2, n - 1)
    xp = np.asarray(g.xp[dim])
    dist = float(xp[i_in] - xp[i_gh])

    def plane(uc, idx):
        sl = [slice(1, -1)] * D
        sl[dim] = idx
        return uc[tuple(sl)]

    def shear_of(u):
        uc = u[component]
        return torch.mean((plane(uc, i_in) - plane(uc, i_gh)) / dist) / setup.Re

    def update(ps, state):
        ps["t"].append(float(state["t"]))
        ps["tau"].append(float(shear_of(state["u"])))
        return ps

    def initialize(state):
        return update(dict(t=[], tau=[]), state)

    return Processor(initialize, update, lambda ps, s: ps, nupdate)
