"""One rank of the port's x-slab halo chain on the CPU, for
`tests/test_torch_halo.py` and `tests/test_torch_halo_les.py`.

`run(rank, world, store, data, cases, solve)` joins a gloo group of
``world`` ranks on the file store ``store``, reads the ghosted 16³
velocity ``data/u0.npy`` and writes this rank's results next to it.  For
each tag of ``cases`` (a setup of `CASES`: the natural-form Smagorinsky
closure at θ = 0.17 and a steady body force, each on or off) it writes
the global velocity after 3 steps of the per-step merged chain and of
the hat carry, for RK44 and LMWray3 (``{tag}_{method}_{form}_r{rank}``).
Then it runs `solve_unsteady(halo=True, theta=)` of the setup ``solve``
(4 RK44 steps in chunks of 2, with kinetic-energy and spectrum
processors) and writes its field and records (``solve*_r{rank}``).
`run_adaptive(rank, world, store, data)` runs the "dns" setup's
`solve_unsteady(halo=True, dt=None, **ADAPTIVE)` and writes its field,
step count and t (``adaptive*_r{rank}``).  It imports torch and the port
only, never jax: a spawned process starts from this module.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

N = 16
DT = 1e-2
NSTEPS = 3
THETA = 0.17
# tag: (the Smagorinsky closure, a steady body force)
CASES = {"dns": (False, False), "les": (True, False), "les_bf": (True, True),
         "bf": (False, True)}
# the adaptive run: the CFL limit every second step, processors at every
# third (chunks of 3)
ADAPTIVE = dict(tlims=(0.0, 0.25), cfl=0.6, n_adapt_dt=2)


def bodyforce(dim, *xt):
    """A steady force (the t argument unused), as `tests/test_torch_les.py`'s."""
    return (dim == 0) * 0.5 * torch.sin(xt[1]) + (dim == 1) * 0.25 * torch.cos(xt[0])


def setup_f64(tag="dns"):
    import ins_tpu_torch as it

    closure, force = CASES[tag]
    x = (np.linspace(0, 2 * np.pi, N + 1),) * 3
    base = it.Setup(device="cpu", x=x, Re=1e3, dtype=torch.float64)
    if not (closure or force):
        return base
    return it.Setup(device="cpu", x=x, Re=1e3, dtype=torch.float64,
                    closure_model=it.smagorinsky_closure_natural(base) if closure else None,
                    bodyforce=bodyforce if force else None)


def theta(tag):
    return THETA if CASES[tag][0] else None


def run(rank, world, store, data, cases, solve):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        _run(rank, data, cases, solve)
    finally:
        dist.destroy_process_group()


def run_adaptive(rank, world, store, data):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        import ins_tpu_torch as it
        from ins_tpu_torch.parallel import make_mesh

        setup = setup_f64("dns")
        u0 = torch.from_numpy(np.load(os.path.join(data, "u0.npy")))
        state, _ = it.solve_unsteady(
            setup=setup, ustart=u0, dt=None, mesh=make_mesh(device="cpu"), halo=True,
            processors={"e": it.observefield(
                lambda st: it.total_kinetic_energy(st["u"], setup), nupdate=3)},
            **ADAPTIVE,
        )
        np.save(os.path.join(data, f"adaptive_r{rank}.npy"), state.u.numpy())
        np.save(os.path.join(data, f"adaptive_nt_r{rank}.npy"),
                np.array([state.n, state.t], np.float64))
    finally:
        dist.destroy_process_group()


def _run(rank, data, cases, solve):
    import ins_tpu_torch as it
    from ins_tpu_torch.ops.fastpath import strip_ghosts
    from ins_tpu_torch.parallel import make_halo_fast_step, make_mesh, shard_interior
    from ins_tpu_torch.parallel.halo import gather_interior

    mesh = make_mesh(device="cpu")
    u0 = torch.from_numpy(np.load(os.path.join(data, "u0.npy")))
    for tag in cases:
        setup, th = setup_f64(tag), theta(tag)
        for name, method in (("rk44", it.RKMethods.RK44()), ("lmwray3", it.LMWray3())):
            step = make_halo_fast_step(setup, method, mesh)
            assert step.fused and step.merged
            s0 = it.create_stepper(method, setup=setup,
                                   u=shard_interior(mesh, strip_ghosts(u0)))
            s = s0
            for _ in range(NSTEPS):
                s = step(s, DT, th)
            out = {"step": gather_interior(mesh, s.u)}
            to_hat, step_hat, from_hat = step.hat
            h = to_hat(s0)
            for _ in range(NSTEPS):
                h = step_hat(h, DT, th)
            s = from_hat(h)
            assert s.n == NSTEPS
            out["hat"] = gather_interior(mesh, s.u)
            for form, u in out.items():
                np.save(os.path.join(data, f"{tag}_{name}_{form}_r{rank}.npy"), u.numpy())
    setup = setup_f64(solve)
    state, outs = it.solve_unsteady(
        setup=setup, ustart=u0, tlims=(0.0, 4 * DT), dt=DT, mesh=mesh, halo=True,
        theta=theta(solve),
        processors={"e": it.observefield(
            lambda st: it.total_kinetic_energy(st["u"], setup), nupdate=2),
            "spec": it.observespectrum(setup, nupdate=2)},
    )
    np.save(os.path.join(data, f"solve_r{rank}.npy"), state.u.numpy())
    np.save(os.path.join(data, f"solve_e_r{rank}.npy"),
            np.array([float(e) for e in outs["e"]]))
    np.save(os.path.join(data, f"solve_spec_r{rank}.npy"), np.stack(outs["spec"]["ehat"]))
