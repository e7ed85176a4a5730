"""One rank of the port's x-slab halo chain on the CPU, for
`tests/test_torch_halo.py`.

`run(rank, world, store, data)` joins a gloo group of ``world`` ranks on
the file store ``store``, reads the ghosted 16³ velocity ``data/u0.npy``
and writes this rank's results next to it: the global velocity after 3
steps of the per-step merged chain and of the hat carry, for RK44 and
LMWray3, and `solve_unsteady(halo=True)` (4 RK44 steps in chunks of 2,
with a kinetic-energy processor).  It imports torch and the port only,
never jax: a spawned process starts from this module.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

N = 16
DT = 1e-2
NSTEPS = 3


def setup_f64():
    import ins_tpu_torch as it

    x = (np.linspace(0, 2 * np.pi, N + 1),) * 3
    return it.Setup(device="cpu", x=x, Re=1e3, dtype=torch.float64)


def run(rank, world, store, data):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        _run(rank, data)
    finally:
        dist.destroy_process_group()


def _run(rank, data):
    import ins_tpu_torch as it
    from ins_tpu_torch.ops.fastpath import strip_ghosts
    from ins_tpu_torch.parallel import make_halo_fast_step, make_mesh, shard_interior
    from ins_tpu_torch.parallel.halo import gather_interior

    setup = setup_f64()
    mesh = make_mesh(device="cpu")
    u0 = torch.from_numpy(np.load(os.path.join(data, "u0.npy")))
    for tag, method in (("rk44", it.RKMethods.RK44()), ("lmwray3", it.LMWray3())):
        step = make_halo_fast_step(setup, method, mesh)
        assert step.fused and step.merged
        s0 = it.create_stepper(method, setup=setup, u=shard_interior(mesh, strip_ghosts(u0)))
        s = s0
        for _ in range(NSTEPS):
            s = step(s, DT)
        out = {"step": gather_interior(mesh, s.u)}
        to_hat, step_hat, from_hat = step.hat
        h = to_hat(s0)
        for _ in range(NSTEPS):
            h = step_hat(h, DT)
        s = from_hat(h)
        assert s.n == NSTEPS
        out["hat"] = gather_interior(mesh, s.u)
        for form, u in out.items():
            np.save(os.path.join(data, f"{tag}_{form}_r{rank}.npy"), u.numpy())
    state, outs = it.solve_unsteady(
        setup=setup, ustart=u0, tlims=(0.0, 4 * DT), dt=DT, mesh=mesh, halo=True,
        processors={"e": it.observefield(
            lambda st: it.total_kinetic_energy(st["u"], setup), nupdate=2)},
    )
    np.save(os.path.join(data, f"solve_r{rank}.npy"), state.u.numpy())
    np.save(os.path.join(data, f"solve_e_r{rank}.npy"),
            np.array([float(e) for e in outs["e"]]))
