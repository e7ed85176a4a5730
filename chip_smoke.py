#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`ins_tpu_torch`) once on one NVIDIA GPU.

Run from the repository root on a machine with a Hopper card (H100):

    python3 chip_smoke.py             # the full check (one card)
    python3 chip_smoke.py --profile   # also print a kernel-time breakdown

Phases, each raising on failure (exit code != 0, no result line):

0. Print the card's name and power limit (nvidia-smi), switch TF32 off
   for matmuls and cuDNN, build the CUDA kernels from
   `ins_tpu_torch/csrc` and print the build time.  Without a CUDA device
   the script fails; it never continues on the CPU.
1. Hold every kernel of the main path against its plain PyTorch version
   at 64³ and 256³ on inputs made by numpy from a seed: the RECON stage
   with emit_u and usnew, a stream-base stage, the unmerged stage (with
   and without k streams), pass B, the correction and the plane
   transforms.  Bound: max relative error <= 1e-4 (FP32 on both sides,
   sums taken in another order).  At 256³ each is timed against its
   plain version (CUDA events).
2. The main path: `solve_unsteady` on 256³ decaying turbulence (RK44,
   f32, Re = 4000, `random_field(kp=10)`, dt = 1e-3·128/256) for 20
   steps in chunks of 10, with a timelogger.  Checks: finite; every
   kernel launched and no plain version run on the card; volume-scaled
   max|div u| <= 1e-4·max|u|/dx; kinetic energy not increasing; the
   same run through the plain chain on the card agrees to <= 1e-4
   relative.  Then ms/step for both chains after a warm-up.
3. Print the kernel table (JSON) and, last, the result line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REL_TOL = 1e-4
SEED = 20261016
DEVICE = "cuda"


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def rel_err(got, ref):
    ref_max = ref.abs().max().item()
    return (got - ref).abs().max().item() / max(ref_max, 1e-30)


def abs_err(got, ref):
    return (got - ref).abs().max().item()


def cuda_ms(fn, reps=10, warmup=2):
    """Mean milliseconds of fn() over `reps` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# --------------------------------------------------------------------------


def kernel_cases(n):
    """{kernel name: [(label, kernel_fn, plain_fn), ...]} at size n; each
    fn returns a tuple of output tensors.  The first case of each kernel
    has the shapes and options the main path gives it."""
    import torch

    from ins_tpu_torch.ops import stage_kernels as sk
    from ins_tpu_torch.ops.poisson_kernels import make_fused_projection, passB, passB_plain
    from ins_tpu_torch.ops.transforms import (
        x_transform, x_transform_plain, yz_transform, yz_transform_plain,
    )

    rng = np.random.default_rng(SEED + n)
    dev = torch.device(DEVICE)

    def field(*shape, scale=1.0):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(dev)

    dxs = (2 * np.pi / n,) * 3
    visc = 1.0 / 4000.0
    dt = 1e-3 * 128 / n
    proj = make_fused_projection((n,) * 3, dxs, torch.float32, device=dev)
    ut_prev, ustart, accb, k1 = (field(3, n, n, n) for _ in range(4))
    qhat = field(n, n, n, scale=1e-3)
    divhat = field(n, n, n)
    Vinv, VinvT = proj["Vinv"], proj["VinvT"]

    def pcmsd(impl, streams, coeffs, **kw):
        return lambda: impl(ut_prev, qhat, streams, coeffs, visc, dxs, proj, **kw)

    def msd(impl, streams, coeffs, **kw):
        return lambda: impl(ut_prev, streams, coeffs, visc, dxs, Vinv, VinvT, **kw)

    recon = dict(emit_k=False, usnew_coeff=dt / 6, emit_u=True)
    based = dict(emit_k=False, usnew_coeff=dt / 3, usnew_base=accb)
    return {
        "pcmsd_hat_3d": [
            ("stream base + usnew_base",
             pcmsd(sk.pcmsd_hat_3d, (ustart,), (dt / 2,), **based),
             pcmsd(sk.pcmsd_hat_3d_plain, (ustart,), (dt / 2,), **based)),
            ("RECON + emit_u + usnew",
             pcmsd(sk.pcmsd_hat_3d, (sk.RECON,), (dt / 2,), **recon),
             pcmsd(sk.pcmsd_hat_3d_plain, (sk.RECON,), (dt / 2,), **recon)),
        ],
        "momentum_stage_divhat_3d": [
            ("stage 0 (u base) + usnew",
             msd(sk.momentum_stage_divhat_3d, (ut_prev,), (dt / 2,),
                 emit_k=False, usnew_coeff=dt / 6),
             msd(sk.momentum_stage_divhat_3d_plain, (ut_prev,), (dt / 2,),
                 emit_k=False, usnew_coeff=dt / 6)),
            ("k stream + emit_k",
             msd(sk.momentum_stage_divhat_3d, (ustart, k1), (0.3 * dt, dt / 2)),
             msd(sk.momentum_stage_divhat_3d_plain, (ustart, k1), (0.3 * dt, dt / 2))),
        ],
        "passB": [
            ("divhat -> qhat",
             lambda: (passB(divhat, proj),), lambda: (passB_plain(divhat, proj),)),
        ],
        "pressure_correct_qhat_3d": [
            ("ut, qhat -> u",
             lambda: (sk.pressure_correct_qhat_3d(ut_prev, qhat, dxs, proj["V"], proj["VT"]),),
             lambda: (sk.pressure_correct_qhat_3d_plain(ut_prev, qhat, dxs, proj["V"], proj["VT"]),)),
        ],
        "plane_transform": [
            ("Vinv_y . f . Vinv_z^T",
             lambda: (yz_transform(divhat, Vinv, VinvT),),
             lambda: (yz_transform_plain(divhat, Vinv, VinvT),)),
            ("V_x . f",
             lambda: (x_transform(proj["V"], divhat),),
             lambda: (x_transform_plain(proj["V"], divhat),)),
        ],
    }


def phase_kernels(sizes):
    import torch

    results = {}
    for n in sizes:
        for name, cases in kernel_cases(n).items():
            r = results.setdefault(name, {"max_abs_err": 0.0})
            for label, kfn, pfn in cases:
                got, ref = kfn(), pfn()
                torch.cuda.synchronize()
                if len(got) != len(ref):
                    fail(f"{name} [{label}]: {len(got)} outputs, plain gives {len(ref)}")
                errs = [rel_err(g, p) for g, p in zip(got, ref)]
                r["max_abs_err"] = max(
                    r["max_abs_err"], *(abs_err(g, p) for g, p in zip(got, ref))
                )
                print(f"[kernels] n={n} {name} [{label}]: max rel err per output "
                      + ", ".join(f"{e:.3e}" for e in errs))
                if not all(math.isfinite(e) and e <= REL_TOL for e in errs):
                    fail(f"{name} [{label}] at n={n}: rel err {max(errs):.3e} > {REL_TOL}")
            if n == max(sizes):
                _, kfn, pfn = cases[0]
                p1 = cuda_ms(pfn)
                k1 = cuda_ms(kfn)
                k2 = cuda_ms(kfn)
                p2 = cuda_ms(pfn)
                r["ms"] = (k1 + k2) / 2
                r["plain_ms"] = (p1 + p2) / 2
                print(f"[kernels] n={n} {name} [{cases[0][0]}]: kernel {r['ms']:.4f} ms "
                      f"({k1:.4f}, {k2:.4f}), plain {r['plain_ms']:.4f} ms ({p1:.4f}, {p2:.4f})")
        torch.cuda.empty_cache()
    return results


# --------------------------------------------------------------------------
# phase 2: the main path
# --------------------------------------------------------------------------


def headline_setup(n):
    import torch

    import ins_tpu_torch as it

    x = tuple(np.linspace(0.0, 2 * np.pi, n + 1) for _ in range(3))
    bc = ((it.PeriodicBC(), it.PeriodicBC()),) * 3
    return it.Setup(x=x, boundary_conditions=bc, Re=4000.0, dtype=torch.float32,
                    device=DEVICE)


def phase_main_path(n, nsteps, chunk):
    import torch

    import ins_tpu_torch as it
    from ins_tpu_torch.ops import launches
    from ins_tpu_torch.ops.fastpath import make_fast_timestep_hat, strip_ghosts, strip_state

    setup = headline_setup(n)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    u0 = it.random_field(setup, kp=10, generator=gen)
    dt = 1e-3 * 128 / n
    method = it.RKMethods.RK44()
    torch.cuda.synchronize()

    launches.reset_counts()
    t0 = time.perf_counter()
    state, _ = it.solve_unsteady(
        setup=setup, ustart=u0, tlims=(0.0, nsteps * dt), dt=dt, method=method,
        psolver=it.psolver_spectral(setup),
        processors={"log": it.timelogger(nupdate=chunk)},
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launches.LAUNCHES)
    plain = dict(launches.PLAIN_ON_CUDA)
    print(f"[main] solve_unsteady {n}^3 RK44 f32: {nsteps} steps in chunks of {chunk}, "
          f"{wall:.3f} s wall (first call included); launches {counts}; "
          f"plain calls on CUDA {plain}")
    if state.n != nsteps:
        fail(f"ran {state.n} steps, expected {nsteps}")
    u = strip_ghosts(state.u)
    if not bool(torch.isfinite(u).all()):
        fail("non-finite velocity after the run")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    if any(plain.values()):
        fail(f"plain versions ran on CUDA tensors in the kernel run: {plain}")

    dx = float(setup.grid.delta[0][0])
    vol = dx**3
    div = sum((u[a] - torch.roll(u[a], 1, dims=a)) / dx for a in range(3)) * vol
    umax = u.abs().max().item()
    divmax = div.abs().max().item()
    print(f"[main] max|div u| (volume-scaled) = {divmax:.3e}, bound 1e-4*max|u|/dx = "
          f"{1e-4 * umax / dx:.3e}; unscaled max|div u|*dx/max|u| = "
          f"{divmax / vol * dx / umax:.3e}")
    if not divmax <= 1e-4 * umax / dx:
        fail("the result is not divergence-free")
    if not divmax / vol * dx / umax <= 1e-3:
        fail("the unscaled divergence residual exceeds 1e-3")

    e0 = it.total_kinetic_energy(u0, setup).item()
    e1 = it.total_kinetic_energy(state.u, setup).item()
    print(f"[main] kinetic energy {e0:.9e} -> {e1:.9e}")
    if not e1 <= e0:
        fail("kinetic energy increased")

    # the same run through the plain chain on the card
    to_hat, step_hat, from_hat = make_fast_timestep_hat(setup, method, plain=True)
    s = strip_state(it.create_stepper(method, setup=setup, u=u0))
    left = nsteps
    while left:
        c = min(chunk, left)
        h = to_hat(s)
        for _ in range(c):
            h = step_hat(h, dt)
        s = from_hat(h)
        left -= c
    agree = rel_err(u, s.u)
    print(f"[main] kernel chain vs plain chain after {nsteps} steps: max rel diff {agree:.3e}")
    if not agree <= REL_TOL:
        fail(f"kernel and plain chains disagree by {agree:.3e} > {REL_TOL}")

    # ms/step of the hat chain, kernels and plain, after a warm-up
    hk = make_fast_timestep_hat(setup, method)
    hp = make_fast_timestep_hat(setup, method, plain=True)
    s0 = strip_state(it.create_stepper(method, setup=setup, u=u0))

    def ms_per_step(fns, steps=10):
        to_h, step_h, from_h = fns
        h = step_h(step_h(to_h(s0), dt), dt)  # warm-up, and a rebuilding carry
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            h = step_h(h, dt)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / steps

    times = {"plain": [], "kernels": []}
    for which in ("plain", "kernels", "kernels", "plain"):
        times[which].append(ms_per_step(hk if which == "kernels" else hp))
    ms_k = sum(times["kernels"]) / 2
    ms_p = sum(times["plain"]) / 2
    print(f"[main] hat chain {n}^3 RK44 f32: kernels {ms_k:.3f} ms/step "
          f"({times['kernels'][0]:.3f}, {times['kernels'][1]:.3f}; "
          f"{n**3 / (ms_k * 1e-3):.4e} cell-updates/s), plain {ms_p:.3f} ms/step "
          f"({times['plain'][0]:.3f}, {times['plain'][1]:.3f}; "
          f"{n**3 / (ms_p * 1e-3):.4e} cell-updates/s); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts, setup, u0, dt


def phase_profile(setup, u0, dt):
    """Kernel-time breakdown of 3 hat steps (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import ins_tpu_torch as it
    from ins_tpu_torch.ops.fastpath import make_fast_timestep_hat, strip_state

    method = it.RKMethods.RK44()
    to_h, step_h, _ = make_fast_timestep_hat(setup, method)
    h = step_h(to_h(strip_state(it.create_stepper(method, setup=setup, u=u0))), dt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            h = step_h(h, dt)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="print a torch.profiler kernel breakdown of 3 hat steps")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this check runs on the GPU only")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import ins_tpu_torch  # noqa: F401  (fails outside the repository)
    from ins_tpu_torch import _build

    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.load()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'} s); "
          f"ptxas report in {_build.BUILD_DIR / 'build.log'}")

    results = phase_kernels((64, 256))
    counts, setup, u0, dt = phase_main_path(256, nsteps=20, chunk=10)
    if args.profile:
        phase_profile(setup, u0, dt)

    table = {"kernels": []}
    meta = {
        "plane_transform": ("ins_tpu_torch/csrc/transforms.cu", "ins_tpu/ops/pallas_kernels.py:87"),
        "pcmsd_hat_3d": ("ins_tpu_torch/csrc/stage.cu", "ins_tpu/ops/pallas_kernels.py:2694"),
        "momentum_stage_divhat_3d": ("ins_tpu_torch/csrc/stage.cu", "ins_tpu/ops/pallas_kernels.py:1264"),
        "passB": ("ins_tpu_torch/csrc/poisson.cu", "ins_tpu/ops/poisson_pallas.py:411"),
        "pressure_correct_qhat_3d": ("ins_tpu_torch/csrc/correct.cu", "ins_tpu/ops/pallas_kernels.py:3422"),
    }
    for name, (source, replaces) in meta.items():
        r = results[name]
        table["kernels"].append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
        })
    print(card)
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
