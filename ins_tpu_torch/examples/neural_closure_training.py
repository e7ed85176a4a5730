"""Neural-closure training workflow: generate filtered-DNS data, train a
CNN closure a-priori and a-posteriori, evaluate.

Port of `examples/neural_closure_training.py` (the reference
NeuralClosure example run): a 2-D DNS at Re 2e3 filtered onto an LES
grid a quarter its size, a CNN closure trained a-priori on the
commutator errors, then fine-tuned a-posteriori through the solver.
Run with ``python -m ins_tpu_torch.examples.neural_closure_training
[--quick] [--device cpu]``.
"""

import time

import numpy as np
import torch

import ins_tpu_torch as it
from ins_tpu_torch import models as nc
from ins_tpu_torch.setup import resolve_device
from ins_tpu_torch.time_steppers.rk_methods import RK44


def les_setup(nles, device):
    """The LES setup of the example: the unit square, periodic, Re 2e3,
    float32."""
    return it.Setup(x=(np.linspace(0.0, 1.0, nles + 1),) * 2,
                    boundary_conditions=((it.PeriodicBC(), it.PeriodicBC()),) * 2,
                    Re=2e3, dtype=torch.float32, device=device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(quick=False, device=None):
    """Returns the a-priori relative errors before and after training
    (``relerr_init``, ``relerr_prior``), the last a-posteriori loss
    (``loss_post``), the wall seconds of each stage (``seconds``), the
    data (``data``, the saver's snapshots; ``io``, the training arrays)
    and the trained model (``closure``, ``theta``)."""
    device = resolve_device(device or "cuda")
    ndns = 64 if quick else 256
    nles = ndns // 4
    seconds = {}
    t0 = time.perf_counter()
    data = nc.create_les_data(
        D=2, Re=2e3, lims=(0.0, 1.0), nles=[nles], ndns=ndns, filters=(nc.FaceAverage(),),
        tburn=0.01 if quick else 0.1, tsim=0.05 if quick else 0.5, savefreq=4, dt=1e-3,
        rng=torch.Generator(device=device).manual_seed(42), dtype=torch.float32,
        device=device, processors={},
    )
    seconds["data"] = time.perf_counter() - t0
    les = les_setup(nles, device)
    io = nc.create_io_arrays(data, les)
    closure, theta = nc.cnn(
        setup=les, radii=[2, 2, 2], channels=[16, 16, 2],
        activations=[torch.tanh, torch.tanh, lambda x: x], use_bias=[True, True, False],
        generator=torch.Generator().manual_seed(0),
    )
    x, y = (torch.as_tensor(io[k], device=device) for k in ("u", "c"))
    dl = nc.create_dataloader_prior((io["u"], io["c"]), batchsize=8, device=device)
    relerr = nc.create_relerr_prior(closure, x, y)
    e0 = float(relerr(theta))
    t0 = time.perf_counter()
    ts = nc.create_trainstate(theta, lr=1e-3, rng=np.random.default_rng(1))
    out = nc.train(dataloader=dl, loss=nc.create_loss_prior(closure), trainstate=ts,
                   niter=20 if quick else 500)
    e1 = float(relerr(out["trainstate"]["theta"]))
    seconds["prior"] = time.perf_counter() - t0

    # a-posteriori fine-tune through the differentiable solver
    t0 = time.perf_counter()
    lp = nc.create_loss_post(setup=les, method=RK44(), psolver=it.psolver_spectral(les),
                             closure_model=nc.wrappedclosure(closure, les))
    traj = [dict(u=d["u"], t=d["t"]) for d in data]
    dlp = nc.create_dataloader_post(traj, ntrajectory=1, nunroll=3)
    ts2 = nc.create_trainstate(out["trainstate"]["theta"], lr=1e-5,
                               rng=np.random.default_rng(2))
    out2 = nc.train(dataloader=dlp, loss=lp, trainstate=ts2, niter=3 if quick else 100)
    loss_post = float(out2["trainstate"]["loss"])
    _sync(device)
    seconds["post"] = time.perf_counter() - t0
    return dict(relerr_init=e0, relerr_prior=e1, loss_post=loss_post, seconds=seconds,
                data=data, io=io, closure=closure, theta=out2["trainstate"]["theta"])


if __name__ == "__main__":
    from ins_tpu_torch.examples._common import example_main

    example_main(run)
