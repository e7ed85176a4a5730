"""One-off CPU checks of float32 and solver floors, JAX package against
the port (not lane tests: pytest collects only ``test_*.py``).

``--case rb3d``: the float32 projection floor of Rayleigh-Bénard 3-D.
Both packages build `examples/rayleigh_benard_3d.py`'s setup at n (2n ×
n × n cells; Pr 0.71, Ra 1e7, symmetric temperature sides in y, a
tanh(1.2) grid in z) in float32, start from rest with the example's
temperature, and take the same RK44 steps (dt 1e-3) with their
`default_psolver` (the FDM solve, one refinement sweep in float32).
From each final state it forms the predictor u* = u + dt·F(u) (ghost
filled) and projects it with the package's own solve; the residual is
||Ω div P(u*)|| / ||Ω div u*|| over the pressure DOFs, the witness
`chip_smoke.py`'s phase 13 prints on the card.  The port's float64
solve rounded to float32 gives float32's floor on the same predictor.

``--case ldc2d``: the fast-diagonalization solve on
`examples/lid_driven_cavity_2d.py`'s cosine grid at n² in float64: the
relative residual ||L p − f|| / ||f|| (L the port's `laplacian_box`) of
a zero-sum random right-hand side solved by JAX's `psolver_fdm`, the
port's, and the port's `psolver_direct`; then both packages'
`psolver_direct` on float32 setups (float32 matrix entries, a float64
factorization) against the float64 setup's solution; the FDM's null
modes (the port's per-axis test, the JAX package's sum test) against
the 1-D spectrum at 128², 256² and n², both packages' float32 FDM
solves, and `psolver_cg` with the FDM preconditioner in both packages.

    JAX_PLATFORMS=cpu python tests/torch_floor_checks.py --case rb3d [--n 60] [--steps 20]
    JAX_PLATFORMS=cpu python tests/torch_floor_checks.py --case ldc2d [--n 512]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_ENABLE_X64", "1")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import ins_tpu as ins  # noqa: E402
import ins_tpu_torch as it  # noqa: E402


def setup(pk, n, dtype):
    kw = dict(device="cpu") if pk is it else {}
    temperature = pk.temperature_equation(
        Pr=0.71, Ra=1e7, Ge=1.0, dodissipation=True, gdir=2, dtype=dtype,
        boundary_conditions=((pk.PeriodicBC(), pk.PeriodicBC()),
                             (pk.SymmetricBC(), pk.SymmetricBC()),
                             (pk.DirichletBC(1.0), pk.DirichletBC(0.0))))
    x = (ins.stretched_grid(0.0, 2.0, 2 * n), ins.stretched_grid(0.0, 1.0, n),
         ins.tanh_grid(0.0, 1.0, n, 1.2))
    d = pk.DirichletBC()
    return pk.Setup(x=x, boundary_conditions=((pk.PeriodicBC(), pk.PeriodicBC()), (d, d), (d, d)),
                    temperature=temperature, dtype=dtype, **kw)


def residual(div_star, div_after):
    return float(np.linalg.norm(div_after) / np.linalg.norm(div_star))


def run_jax(n, steps, dt):
    s = setup(ins, n, jnp.float32)
    ip = tuple(slice(a, b) for a, b in s.grid.Ip)
    psolver = ins.default_psolver(s)
    u0 = jax.jit(lambda: ins.velocityfield(s, lambda dim, x, y, z: 0.0 * x, psolver=psolver))()
    T0 = jax.jit(lambda: ins.temperaturefield(
        s, lambda x, y, z: 1 - z + 0.001 * jnp.sin(10 * jnp.pi * x)))()
    st, _ = ins.solve_unsteady(setup=s, ustart=u0, tempstart=T0, tlims=(0.0, steps * dt), dt=dt,
                               psolver=psolver)

    @jax.jit
    def witness(u, T, t):
        ustar = ins.apply_bc_u(u + dt * ins.momentum(u, T, t, s), t, s)
        v = ins.apply_bc_u(ins.project(ustar, s, psolver=psolver), t, s)
        return (ins.scalewithvolume(ins.divergence(ustar, s), s)[ip],
                ins.scalewithvolume(ins.divergence(v, s), s)[ip])

    a, b = witness(st.u, st.temp, st.t)
    return residual(np.asarray(a, np.float64), np.asarray(b, np.float64)), np.asarray(st.u)


def run_port(n, steps, dt):
    from ins_tpu_torch.ops._stencil import slc

    s = setup(it, n, torch.float32)
    ip = slc(s.grid.Ip)
    psolver = it.default_psolver(s)
    u0 = it.velocityfield(s, lambda dim, x, y, z: 0.0 * x, psolver=psolver)
    T0 = it.temperaturefield(s, lambda x, y, z: 1 - z + 0.001 * torch.sin(10 * np.pi * x))
    st, _ = it.solve_unsteady(setup=s, ustart=u0, tempstart=T0, tlims=(0.0, steps * dt), dt=dt,
                              psolver=psolver)
    u, T, t = st.u, st.temp, st.t
    ustar = it.apply_bc_u(u + dt * it.momentum(u, T, t, s), t, s)
    div_star = it.scalewithvolume(it.divergence(ustar, s), s)[ip].double().numpy()
    solve64 = it.psolver_fdm(setup(it, n, torch.float64))
    out = {}
    rounded = lambda f: solve64(f.double()).float()  # noqa: E731
    for name, solve in (("own", psolver), ("float64 rounded", rounded)):
        v = it.apply_bc_u(it.project(ustar, s, psolver=solve), t, s)
        div = it.scalewithvolume(it.divergence(v, s), s)[ip].double().numpy()
        out[name] = residual(div_star, div)
    return out, u.numpy()


def ldc2d(n):
    import scipy.linalg

    from ins_tpu_torch.ops.fdm import (
        _box_delta,
        _one_dim_operator,
        fdm_null_modes,
        laplacian_box,
    )

    def setup_of(pk, dtype, x=(ins.cosine_grid(0.0, 1.0, n),) * 2, **kw):
        d = pk.DirichletBC()
        return pk.Setup(x=x, boundary_conditions=((d, d), (d, pk.DirichletBC((1.0, 0.0)))),
                        Re=1e3, dtype=dtype, **kw)

    js, ts = setup_of(ins, jnp.float64), setup_of(it, torch.float64, device="cpu")
    f = np.random.default_rng(0).standard_normal(ts.grid.Np)
    f -= f.mean()
    ip = tuple(slice(a, b) for a, b in js.grid.Ip)
    fj = np.zeros(js.grid.N)
    fj[ip] = f
    p = {"JAX psolver_fdm": torch.from_numpy(
        np.array(jax.jit(ins.psolver_fdm(js))(jnp.asarray(fj)))[ip])}
    ft = torch.from_numpy(f)
    p["port psolver_fdm"] = it.psolver_fdm(ts)(ft)
    p["port psolver_direct"] = it.psolver_direct(ts)(ft)
    lap = laplacian_box(ts)
    print(f"2-D lid-driven cavity, cosine grid {n}², float64: relative residual "
          f"||L p - f|| / ||f|| of a zero-sum random f: "
          + ", ".join(f"{k} {((lap(v) - ft).norm() / ft.norm()).item():.4e}" for k, v in p.items()))
    # float32 setups: both packages assemble the Laplacian with float32
    # entries and factor it in float64; the distance of that solve from the
    # float64 setup's, means removed
    js32, ts32 = setup_of(ins, jnp.float32), setup_of(it, torch.float32, device="cpu")
    ref = p["port psolver_direct"]
    q = ref - ref.mean()
    p32 = {"JAX psolver_direct": torch.from_numpy(np.array(
        ins.psolver_direct(js32)(jnp.asarray(fj, jnp.float32)))[ip]),
        "port psolver_direct": it.psolver_direct(ts32)(ft.float())}

    def dist(v):
        d = v.double() - ref
        return ((d - d.mean()).norm() / q.norm()).item()

    print(f"float32 setups, the same f: ||p32 - p64|| / ||p64||: "
          + ", ".join(f"{k} {dist(v):.4e}" for k, v in p32.items()))
    # the FDM's null modes (the port's per-axis test, the JAX package's
    # test |λ_i + λ_j| below 1e-8 of the largest) against the 1-D
    # spectrum; both packages' float32 FDM solves of f; CG with the FDM
    # as its preconditioner, in both packages
    for m in sorted({128, 256, n}):
        sm = setup_of(it, torch.float64, x=(ins.cosine_grid(0.0, 1.0, m),) * 2, device="cpu")
        lam, _ = scipy.linalg.eigh(_one_dim_operator(sm, 0), np.diag(_box_delta(sm.grid, 0)))
        low = np.sort(np.abs(lam))
        per_axis, by_sum = fdm_null_modes(sm)
        print(f"{m}²: the 1-D spectrum's lowest |λ| {low[0]:.3e} (the null mode), "
              f"{low[1]:.4e}; modes cut by the port's per-axis test {per_axis}, by the JAX "
              f"package's sum test {by_sum}")
    f32 = {"JAX psolver_fdm": torch.from_numpy(np.array(
        jax.jit(ins.psolver_fdm(js32))(jnp.asarray(fj, jnp.float32)))[ip]),
        "port psolver_fdm": it.psolver_fdm(ts32)(ft.float())}
    print(f"float32 setups, the same f: relative residual ||L p - f|| / ||f|| (L float64): "
          + ", ".join(f"{k} {((lap(v.double()) - ft).norm() / ft.norm()).item():.4e}"
                      for k, v in f32.items()))
    cg = it.psolver_cg(ts, reltol=1e-10, precond="fdm", maxiter=100)
    pc = cg(ft)
    jcg = np.array(jax.jit(ins.psolver_cg(js, reltol=1e-10, precond="fdm", maxiter=100))(
        jnp.asarray(fj)))[ip]
    print(f"psolver_cg(precond='fdm') at {n}², float64, at most 100 iterations: the port "
          f"{int(cg.iterations)} iterations, finite {bool(torch.isfinite(pc).all())}, residual "
          f"{(lap(pc) - ft).norm().item():.4e}; JAX finite {bool(np.isfinite(jcg).all())}, "
          f"residual {(lap(torch.from_numpy(jcg)) - ft).norm().item():.4e}; |f| "
          f"{ft.norm().item():.4e}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", choices=("rb3d", "ldc2d"), default="rb3d")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    if args.case == "ldc2d":
        ldc2d(args.n or 512)
        return
    args.n = args.n or 60
    dt = 1e-3
    t0 = time.perf_counter()
    jres, ju = run_jax(args.n, args.steps, dt)
    t1 = time.perf_counter()
    with torch.no_grad():
        tres, tu = run_port(args.n, args.steps, dt)
    t2 = time.perf_counter()
    drift = float(np.max(np.abs(tu - ju)) / np.max(np.abs(ju)))
    print(f"RB-3D n = {args.n} ({2 * args.n} x {args.n} x {args.n}), float32, {args.steps} RK44 "
          f"steps on the CPU: witness residual ||Ω div P(u*)|| / ||Ω div u*||: JAX package "
          f"{jres:.4e}; port {tres['own']:.4e}; the port's float64 solve rounded to float32 "
          f"{tres['float64 rounded']:.4e}; final states max rel diff {drift:.3e} "
          f"(JAX {t1 - t0:.1f} s, port {t2 - t1:.1f} s)")


if __name__ == "__main__":
    main()
