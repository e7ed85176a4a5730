"""The port's wall-bounded channel path against the JAX package (CPU, f64).

Inputs are made by numpy from a seed and go through both packages.  On
CPU tensors the port's two channel kernel wrappers run their plain
versions (the roll functions composed), which are held here against the
JAX package's Pallas kernels in interpret mode, as
`tests/test_channelpath.py` runs them; the chain, `velocityfield`,
`total_kinetic_energy` and `solve_unsteady` are held against the JAX
package's own.  Both sides compute in float64 and differ in summation
order only: 1e-12 relative for single operators and a few steps, 1e-10
where a projection's solve and several steps compound it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ins_tpu as ins
from ins_tpu.ops import channel_kernels as jck
from ins_tpu.ops import channelpath as jcp
from ins_tpu.ops import fdm as jfdm
from ins_tpu.ops.fastpath import make_fast_timestep as jax_make_fast_timestep
from ins_tpu.ops.operators import total_kinetic_energy as jax_total_kinetic_energy
from ins_tpu.time_steppers.step import StepperState as JaxStepperState

import ins_tpu_torch as it
from ins_tpu_torch import convert
from ins_tpu_torch.ops import channel_kernels as ck
from ins_tpu_torch.ops import channelpath as cp
from ins_tpu_torch.ops import fdm, launches
from ins_tpu_torch.ops.fastpath import make_fast_timestep, make_fast_timestep_hat
from ins_tpu_torch.time_steppers.step import StepperState

TOL = 1e-12
TOL_SOLVE = 1e-10
VISC = 1.0 / 700.0


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _t(a):
    return torch.from_numpy(np.array(a))


def _jforce(dim, xx, yy, zz, t):
    return jnp.where(dim == 0, 1.0, 0.0) + 0.3 * jnp.sin(yy) * (dim == 1) + 0.0 * xx


def _tforce(dim, xx, yy, zz, t):
    return (1.0 if dim == 0 else 0.0) + 0.3 * torch.sin(yy) * (dim == 1) + 0.0 * xx


@functools.lru_cache(maxsize=None)
def _setups(n=(12, 10, 8), stretched=True, lid=False, force=False):
    """The same channel in both packages: x/y periodic, z walls (a sliding
    top wall with `lid`), tanh-stretched z, Re = 700, f64."""
    nx, ny, nz = n
    x = (
        np.linspace(0.0, 4 * np.pi, nx + 1),
        np.linspace(0.0, 2 * np.pi, ny + 1),
        ins.tanh_grid(0.0, 2.0, nz, 1.3) if stretched else np.linspace(0.0, 2.0, nz + 1),
    )
    top = (0.3, -0.2, 0.0) if lid else None

    def bcs(pkg):
        return ((pkg.PeriodicBC(), pkg.PeriodicBC()), (pkg.PeriodicBC(), pkg.PeriodicBC()),
                (pkg.DirichletBC(), pkg.DirichletBC(top)))

    jset = ins.Setup(x=x, boundary_conditions=bcs(ins), Re=700.0, dtype=jnp.float64,
                     bodyforce=_jforce if force else None, issteadybodyforce=True)
    tset = it.Setup(x=x, boundary_conditions=bcs(it), Re=700.0, dtype=torch.float64,
                    bodyforce=_tforce if force else None, device="cpu")
    return jset, tset


def _fields(seed, box, *kinds):
    """Random interior fields: "vec" (3, *box) with w's pinned slot 0, or
    "sca" box."""
    rng = np.random.default_rng(seed)
    out = []
    for kind in kinds:
        if kind == "vec":
            u = rng.standard_normal((3, *box))
            u[2, ..., -1] = 0.0
        else:
            u = 0.1 * rng.standard_normal(box)
        out.append(u)
    return out


# --------------------------------------------------------------------------
# metrics, roll functions, the FDM solve
# --------------------------------------------------------------------------


@pytest.mark.parametrize("stretched,lid,force", [(False, False, False), (True, False, True),
                                                 (True, True, False)])
def test_setup_constants_match_jax(stretched, lid, force):
    """The z-metric vectors, the wall values and the steady body force."""
    jset, tset = _setups(stretched=stretched, lid=lid, force=force)
    jm = jcp.make_channel_metrics(jset)
    consts = {k: np.asarray(getattr(jm, k)) for k in convert._CHANNEL_VECS}
    if force:
        consts["bodyforce_field"] = np.asarray(jset.bodyforce_field)
    assert convert.check_setup_constants(tset, consts) <= TOL
    tm = cp.make_channel_metrics(tset)
    assert (tm.dx, tm.dy, tm.gb, tm.gt) == (jm.dx, jm.dy, jm.gb, jm.gt)
    assert tuple(tm.zmet.shape) == (12, 8)
    consts["inv_duz"] = consts["inv_duz"] * 1.01
    with pytest.raises(ValueError, match="differ"):
        convert.check_setup_constants(tset, consts)
    # a misspelled key, or nothing to compare, is an error, not a pass
    for bad in ({"inv_dz_": consts["inv_dz"]}, {}):
        with pytest.raises(ValueError, match="unknown"):
            convert.check_setup_constants(tset, bad)


@pytest.mark.parametrize("fn", ["convdiff", "divergence", "correct", "laplacian"])
@pytest.mark.parametrize("stretched,lid", [(False, False), (True, True)])
def test_roll_functions_match_jax(fn, stretched, lid):
    jset, tset = _setups(stretched=stretched, lid=lid)
    jm, tm = jcp.make_channel_metrics(jset), cp.make_channel_metrics(tset)
    u, q = _fields(1, tset.grid.Np, "vec", "sca")
    if fn == "convdiff":
        ref = jcp.channel_convdiff_roll(jnp.asarray(u), jm, VISC)
        got = cp.channel_convdiff_roll(_t(u), tm, VISC)
    elif fn == "divergence":
        ref = jcp.channel_divergence_roll(jnp.asarray(u), jm)
        got = cp.channel_divergence_roll(_t(u), tm)
    elif fn == "correct":
        ref = jcp.channel_correct_roll(jnp.asarray(u), jnp.asarray(q), jm)
        got = cp.channel_correct_roll(_t(u), _t(q), tm)
    else:
        ref = jcp.channel_laplacian_box(jnp.asarray(q), jset)
        got = cp.channel_laplacian_box(_t(q), tset)
    assert _rel(got.numpy(), ref) < TOL


@pytest.mark.parametrize("stretched", [False, True])
def test_fdm_solve_box_and_roundoff_match_jax(stretched):
    jset, tset = _setups(stretched=stretched)
    (f,) = _fields(2, tset.grid.Np, "sca")
    ref = jfdm.fdm_solve_box(jset)(jnp.asarray(f))
    assert _rel(fdm.fdm_solve_box(tset)(_t(f)).numpy(), ref) < TOL
    assert fdm.fdm_transform_roundoff(tset) == jfdm.fdm_transform_roundoff(jset)
    # the solve inverts the box Laplacian on right-hand sides orthogonal to
    # its nullspace (the constants: walls give the pressure Neumann rows)
    f = f - f.mean()
    q = fdm.fdm_solve_box(tset)(_t(f))
    assert _rel(cp.channel_laplacian_box(q, tset).numpy(), f) < 1e-10


# --------------------------------------------------------------------------
# the two kernels: plain versions vs the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------

# (ustart, acc, qrecon, force, div_of_acc, emit_urec, cb): every mode the
# per-stage step and the hat chain use, and cb = 0
MSD_MODES = {
    "stage0": (True, False, False, True, False, False, 1 / 6),
    "stream+acc": (True, True, False, False, False, False, 1 / 3),
    "last": (True, True, False, True, True, False, 1 / 6),
    "recon stage0 emit_urec": (False, False, True, True, False, True, 1 / 6),
    "recon stream+acc": (True, True, True, True, False, False, 1 / 3),
    "recon last": (True, True, True, False, True, False, 1 / 6),
    "recon single stage": (False, False, True, True, True, False, 1.0),
    "cb=0": (True, False, False, False, False, False, 0.0),
}


@pytest.mark.parametrize("mode", list(MSD_MODES))
def test_channel_msd_3d_plain_matches_pallas(mode):
    has_us, has_acc, recon, has_force, div_of_acc, emit_urec, cb = MSD_MODES[mode]
    jset, tset = _setups(lid=True)
    jm, tm = jcp.make_channel_metrics(jset), cp.make_channel_metrics(tset)
    box = tset.grid.Np
    u, us0, acc0, force, q = _fields(3, box, "vec", "vec", "vec", "vec", "sca")
    args = dict(visc=VISC, ca=0.5, cb=cb, dt=1e-2, div_of_acc=div_of_acc,
                emit_urec=emit_urec)
    pick = [(us0, has_us), (acc0, has_acc)]
    ref = jck.channel_msd_3d(
        jnp.asarray(u), *(jnp.asarray(a) if on else None for a, on in pick), jm,
        force=jnp.asarray(force) if has_force else None,
        qrecon=jnp.asarray(q) if recon else None, interpret=True, **args,
    )
    got = ck.channel_msd_3d(
        _t(u), *(_t(a) if on else None for a, on in pick), tm,
        force=_t(force) if has_force else None, qrecon=_t(q) if recon else None, **args,
    )
    assert len(got) == len(ref) == (4 if emit_urec else 3)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            assert _rel(g.numpy(), r) < TOL


def test_channel_pressure_correct_3d_plain_matches_pallas():
    jset, tset = _setups()
    t, q = _fields(4, tset.grid.Np, "vec", "sca")
    ref = jck.channel_pressure_correct_3d(jnp.asarray(t), jnp.asarray(q),
                                          jcp.make_channel_metrics(jset), interpret=True)
    got = ck.channel_pressure_correct_3d(_t(t), _t(q), cp.make_channel_metrics(tset))
    assert _rel(got.numpy(), ref) < TOL
    assert not got[2, ..., -1].any()  # the pinned wall slot stays 0


def test_wrappers_run_plain_on_cpu():
    _, tset = _setups()
    tm = cp.make_channel_metrics(tset)
    u, q = (_t(a) for a in _fields(5, tset.grid.Np, "vec", "sca"))
    launches.reset_counts()
    kw = dict(visc=VISC, ca=0.5, cb=0.25, dt=1e-2, qrecon=q)
    got = ck.channel_msd_3d(u, u, None, tm, **kw)
    ref = ck.channel_msd_3d_plain(u, u, None, tm, **kw)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert torch.equal(ck.channel_pressure_correct_3d(u, q, tm),
                       ck.channel_pressure_correct_3d_plain(u, q, tm))
    assert not any(launches.LAUNCHES.values()) and not any(launches.PLAIN_ON_CUDA.values())
    with pytest.raises(ValueError, match="qrecon"):
        ck.channel_msd_3d(u, None, None, tm, visc=VISC, ca=0.5, cb=0.25, dt=1e-2)


# --------------------------------------------------------------------------
# initial field, energy, the chain, the solver
# --------------------------------------------------------------------------


def _jufunc(dim, xx, yy, zz):
    return (jnp.where(dim == 0, 6.0 * zz * (2.0 - zz) / 4.0, 0.0)
            + 0.2 * jnp.sin(2 * xx) * jnp.sin(yy) * jnp.sin(np.pi * zz) * (dim + 1))


def _tufunc(dim, xx, yy, zz):
    return ((6.0 * zz * (2.0 - zz) / 4.0 if dim == 0 else 0.0 * zz)
            + 0.2 * torch.sin(2 * xx) * torch.sin(yy) * torch.sin(np.pi * zz) * (dim + 1))


@functools.lru_cache(maxsize=None)
def _u0(stretched=True, lid=False, force=False):
    """`ins_tpu.velocityfield` of the parabola plus a perturbation."""
    jset, _ = _setups(stretched=stretched, lid=lid, force=force)
    psolver = jfdm.psolver_fdm(jset)
    return np.asarray(jax.jit(lambda: ins.velocityfield(jset, _jufunc, psolver=psolver))())


@pytest.mark.parametrize("stretched,lid", [(True, False), (False, True)])
def test_velocityfield_and_energy_match_jax(stretched, lid):
    jset, tset = _setups(stretched=stretched, lid=lid)
    assert getattr(it.default_psolver(tset), "is_fdm", False)
    ref = _u0(stretched, lid)
    got = it.velocityfield(tset, _tufunc)
    assert got.shape == ref.shape and got.device == tset.device
    assert _rel(got.numpy(), ref) < TOL_SOLVE
    div = cp.channel_divergence_roll(cp.strip_channel(got), cp.make_channel_metrics(tset))
    assert float(div.abs().max()) < 1e-10 * float(got.abs().max())
    e_ref = float(jax_total_kinetic_energy(jnp.asarray(ref), jset))
    assert float(it.total_kinetic_energy(_t(ref), tset)) == pytest.approx(e_ref, rel=TOL)


@pytest.mark.parametrize(
    "method,nsteps,stretched,force",
    [("RK44", 3, False, False), ("RK44", 3, True, True), ("FE11", 2, True, True)],
)
def test_channel_hat_matches_jax(method, nsteps, stretched, force):
    """The port's hat chain (plain versions) == `make_channel_timestep_hat`
    with the Pallas kernels in interpret mode; the per-stage form agrees
    with it."""
    jset, tset = _setups(stretched=stretched, force=force)
    mj, mt = getattr(ins.RKMethods, method)(), getattr(it.RKMethods, method)()
    u0 = cp.strip_channel(_t(_u0(stretched, False, force)))
    dt = 1e-2
    j_to, j_step, j_from = jcp.make_channel_timestep_hat(
        jset, mj, nrefine=0, use_pallas=True, pallas_interpret=True)
    j_step = jax.jit(j_step)
    h = j_to(JaxStepperState(u=jnp.asarray(u0.numpy()), temp=None,
                             t=jnp.asarray(0.0), n=jnp.asarray(0)))
    for _ in range(nsteps):
        h = j_step(h, dt, None)
    ref = np.asarray(j_from(h).u)

    to_hat, step_hat, from_hat = cp.make_channel_timestep_hat(tset, mt, nrefine=0)
    ht = to_hat(StepperState(u=u0, temp=None, t=0.0, n=0))
    for _ in range(nsteps):
        ht = step_hat(ht, dt)
    assert ht.n == nsteps and ht.t == pytest.approx(nsteps * dt)
    back = convert.state_from_numpy(jax.device_get(h), dtype=torch.float64, device="cpu")
    assert isinstance(back, cp.ChannelHat) and _rel(back.q.numpy(), ht.q.numpy()) < TOL
    assert _rel(from_hat(ht).u.numpy(), ref) < TOL
    step = cp.make_channel_timestep(tset, mt, nrefine=0)
    s = StepperState(u=u0, temp=None, t=0.0, n=0)
    for _ in range(nsteps):
        s = step(s, dt)
    assert _rel(s.u.numpy(), ref) < TOL


def test_solve_unsteady_matches_jax(capsys):
    """`solve_unsteady` on the channel (default solver: FDM) == the JAX
    package's, u0 fed from JAX, chunked by processors."""
    jset, tset = _setups(force=True)
    u0 = _u0(True, False, True)
    kw = dict(tlims=(0.0, 0.04), dt=1e-2)
    ref, _ = ins.solve_unsteady(setup=jset, ustart=jnp.asarray(u0), **kw)
    launches.reset_counts()
    got, outs = it.solve_unsteady(
        setup=tset, ustart=_t(u0), **kw,
        processors={"fields": it.fieldsaver(nupdate=2), "log": it.timelogger(nupdate=2)},
    )
    assert got.u.shape == u0.shape and got.n == 4 and got.t == pytest.approx(0.04)
    assert _rel(got.u.numpy(), ref.u) < TOL_SOLVE
    assert [f["t"] for f in outs["fields"]] == pytest.approx([0.02, 0.04])
    assert not outs["fields"][-1]["u"][:2, :, :, 0].any()  # u, v ghosts: the no-slip wall
    assert not outs["fields"][-1]["u"][2, :, :, [0, -2, -1]].any()  # w on and beyond the walls
    assert len([ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("Iteration")]) == 2
    assert not any(launches.LAUNCHES.values())  # CPU: plain versions only


# --------------------------------------------------------------------------
# what raises
# --------------------------------------------------------------------------


def _periodic_with_force():
    x = (np.linspace(0, 2 * np.pi, 9),) * 3
    return it.Setup(x=x, bodyforce=_tforce, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("what", ["fast_timestep_hat", "fast_timestep", "solve_unsteady",
                                  "unsteady_force", "symmetric_fdm"])
def test_unported_cases_raise(what):
    method = it.RKMethods.RK44()
    if what == "unsteady_force":
        with pytest.raises(NotImplementedError, match="queue 1 item 6"):
            it.Setup(x=(np.linspace(0, 1, 5),) * 3, bodyforce=_tforce,
                     issteadybodyforce=False, device="cpu")
        return
    if what == "symmetric_fdm":
        # ported: the refinement applies the ghosted Laplacian's interior
        # rows (a symmetric side reads its boundary cell), as JAX's does
        x = (ins.tanh_grid(0, 1, 6, 1.2), np.linspace(0, 1, 5))
        s = it.Setup(x=x, dtype=torch.float64, device="cpu",
                     boundary_conditions=((it.SymmetricBC(), it.SymmetricBC()),
                                          (it.DirichletBC(), it.DirichletBC())))
        js = ins.Setup(x=x, dtype=jnp.float64,
                       boundary_conditions=((ins.SymmetricBC(), ins.SymmetricBC()),
                                            (ins.DirichletBC(), ins.DirichletBC())))
        f = np.zeros(js.grid.N)
        f[1:-1, 1:-1] = np.random.default_rng(6).standard_normal(js.grid.Np)
        ref = ins.psolver_fdm(js, nrefine=1)(jnp.asarray(f))
        got = fdm.psolver_fdm(s, nrefine=1)(_t(f[1:-1, 1:-1]))
        assert _rel(got.numpy(), np.asarray(ref)[1:-1, 1:-1]) < TOL_SOLVE
        return
    # the periodic path steps LMWray3 with a steady force now (its hat
    # chain and its per-step chain, held here against the JAX roll twin);
    # the channel path, as in the JAX package, does not take it, and the
    # general ghosted path steps it (held against the JAX solver's)
    method = it.LMWray3()
    if what == "solve_unsteady":
        jset, tset = _setups(force=True)
        jst, _ = ins.solve_unsteady(setup=jset, ustart=jnp.zeros((3, 14, 12, 10)),
                                    tlims=(0.0, 0.02), dt=1e-2, method=ins.LMWray3())
        st, _ = it.solve_unsteady(setup=tset, ustart=torch.zeros(3, 14, 12, 10, dtype=torch.float64),
                                  tlims=(0.0, 0.02), dt=1e-2, method=method)
        assert st.n == 2 and _rel(st.u.numpy(), np.asarray(jst.u)) < TOL_SOLVE
        return
    s = _periodic_with_force()
    jset = ins.Setup(x=(np.linspace(0, 2 * np.pi, 9),) * 3, bodyforce=_jforce,
                     issteadybodyforce=True, dtype=jnp.float64)
    (u,) = _fields(11, (8, 8, 8), "sca")
    u = np.stack([u, 0.5 * u[::-1], u.transpose(1, 0, 2)])
    jstep = jax.jit(jax_make_fast_timestep(jset, ins.LMWray3(), _force_roll=True))
    ref = JaxStepperState(u=jnp.asarray(u), temp=None, t=jnp.float64(0.0), n=0)
    state = it.create_stepper(method, setup=s, u=_t(u))
    if what == "fast_timestep_hat":
        to_hat, step_hat, from_hat = make_fast_timestep_hat(s, method)
        h = to_hat(state)
        for _ in range(2):
            h = step_hat(h, 1e-2)
        state = from_hat(h)
    else:
        step = make_fast_timestep(s, method)
        for _ in range(2):
            state = step(state, 1e-2)
    for _ in range(2):
        ref = jstep(ref, jnp.asarray(1e-2), None)
    assert state.n == 2 and _rel(state.u.numpy(), ref.u) < TOL_SOLVE
