"""The a-posteriori errors' DOF boxes, held on the CPU.

`create_loss_post`, `create_relerr_post` and the symmetry errors compare
each velocity component on its own DOF box ``Iu[a]``.  The JAX package
slices every component by the first one's box ``Iu[0]``
(`ins_tpu/models/training.py:237, 333, 359`), which on a wall-bounded grid
cuts u_y with u_x's box: on a 16² lid-driven cavity ``Iu[0]`` is ((1, 16),
(1, 17)) and ``Iu[1]`` ((1, 17), (1, 16)), so u_y's slice drops its last x
column of DOFs and takes its wall row instead (ROADMAP queue 3).  Here:

- on that cavity (float64, the flow 10 RK44 steps of 2e-3 after rest,
  targets scaled 1 % a stored step, 2 stored steps of 2 substeps,
  `psolver_direct`, a closure of zero) the port's loss is the
  per-component one, computed here by stepping `timestep` by hand, within
  1e-12, while the JAX package's sits 7.6e-5 away from it;
- on a periodic grid, where every box is equal, the port's errors are the
  JAX package's slice bit for bit, and its loss matches the JAX
  package's within 1e-12.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ins_tpu as ins
from ins_tpu.models import create_loss_post as jax_create_loss_post

import ins_tpu_torch as it
from ins_tpu_torch.models import create_loss_post
from ins_tpu_torch.models import training
from ins_tpu_torch.time_steppers.step import StepperState, timestep

N = 16
DT = 2e-3
TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: many small float64 operations, which
    oversubscribed threads slow by orders of magnitude when the test lane
    runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _zero_closure(u, theta):
    return theta["a"] * u


def _cavity(pk):
    kw = dict(device="cpu") if pk is it else {}
    d = pk.DirichletBC()
    return pk.Setup(x=(np.linspace(0.0, 1.0, N + 1),) * 2,
                    boundary_conditions=((d, d), (d, pk.DirichletBC((1.0, 0.0)))), Re=1e3,
                    dtype=torch.float64 if pk is it else jnp.float64, **kw)


def _periodic(pk):
    kw = dict(device="cpu") if pk is it else {}
    return pk.Setup(x=(np.linspace(0.0, 2 * np.pi, N + 1),) * 2, Re=1e3,
                    dtype=torch.float64 if pk is it else jnp.float64, **kw)


@functools.lru_cache(maxsize=None)
def _trajectory(kind):
    """(us, t): the stored trajectory, 3 states 2e-3 apart, of the flow 10
    RK44 steps after its start (rest on the cavity, a random field on the
    periodic grid), each stored state scaled 1 % down from the last."""
    ts = _cavity(it) if kind == "cavity" else _periodic(it)
    u0 = (it.vectorfield(ts) if kind == "cavity"
          else it.random_field(ts, kp=2, generator=torch.Generator().manual_seed(3)))
    with torch.no_grad():
        st, _ = it.solve_unsteady(setup=ts, ustart=u0, tlims=(0.0, 10 * DT), dt=DT,
                                  psolver=_psolver(it, ts, kind))
    us = np.stack([st.u.numpy() * (1 - 0.01 * i) for i in range(3)])
    return us, np.arange(3) * DT


def _psolver(pk, setup, kind):
    return pk.psolver_direct(setup) if kind == "cavity" else pk.psolver_spectral(setup)


def _losses(kind):
    """(port, JAX package) a-posteriori losses on `_trajectory(kind)`."""
    us, tt = _trajectory(kind)
    ts = _cavity(it) if kind == "cavity" else _periodic(it)
    js = _cavity(ins) if kind == "cavity" else _periodic(ins)
    zero = {"a": 0.0}
    port = create_loss_post(setup=ts, method=it.RKMethods.RK44(),
                            psolver=_psolver(it, ts, kind), closure_model=_zero_closure,
                            nsubstep=2)([{"u": us, "t": tt}], zero).item()
    ref = float(jax_create_loss_post(setup=js, method=ins.RKMethods.RK44(),
                                     psolver=_psolver(ins, js, kind),
                                     closure_model=_zero_closure, nsubstep=2)(
        [{"u": jnp.asarray(us), "t": jnp.asarray(tt)}], zero))
    return port, ref


def _own_boxes_loss(us):
    """The cavity's loss with each component on its own box, stepped by
    hand with `timestep` (2 stored steps of 2 substeps)."""
    ts = _cavity(it)
    g, ps, method = ts.grid, it.psolver_direct(ts), it.RKMethods.RK44()
    boxes = [tuple(slice(lo, hi) for lo, hi in g.Iu[a]) for a in range(2)]
    s = StepperState(u=torch.from_numpy(us[0]), temp=None, t=0.0, n=0)
    total = 0.0
    with torch.no_grad():
        for k in (1, 2):
            for _ in range(2):
                s = timestep(method, s, DT / 2, setup=ts, psolver=ps)
            ref = torch.from_numpy(us[k])
            num = sum(torch.sum((s.u[a][b] - ref[a][b]) ** 2) for a, b in enumerate(boxes))
            total += (num / sum(torch.sum(ref[a][b] ** 2) for a, b in enumerate(boxes))).item()
    return total / 2


def test_cavity_loss_takes_each_components_box():
    ts = _cavity(it)
    assert ts.grid.Iu[0] != ts.grid.Iu[1]
    port, ref = _losses("cavity")
    own = _own_boxes_loss(_trajectory("cavity")[0])
    assert abs(port - own) <= TOL * own, (port, own)
    # the JAX package's Iu[0] slice is another number (7.6e-5 apart)
    assert abs(ref - own) > 1e-5 * own, (ref, own)


def test_periodic_boxes_are_the_jax_slice():
    """Every box equal: one slice of all components, the JAX package's
    ``Iu[0]`` slice, and the error formula bit for bit its expression."""
    ts = _periodic(it)
    boxes = training._dof_boxes(ts)
    sl = (slice(None),) + tuple(slice(s, e) for (s, e) in ts.grid.Iu[0])
    assert boxes == [(slice(None), sl[1:])]
    rng = np.random.default_rng(0)
    got, ref = (torch.from_numpy(rng.standard_normal((2, N + 2, N + 2))) for _ in range(2))
    old = torch.sum((got[sl] - ref[sl]) ** 2) / torch.sum(ref[sl] ** 2)
    assert torch.equal(training._boxed_err(got, boxes, ref, boxes), old)
    # the interior layout's boxes: the same, one cell down
    inner = training._dof_boxes(ts, -1)
    assert inner == [(slice(None), tuple(slice(s - 1, e - 1) for (s, e) in ts.grid.Iu[0]))]


def test_periodic_loss_matches_jax():
    port, ref = _losses("periodic")
    assert abs(port - ref) <= TOL * abs(ref), (port, ref)
