#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`ins_tpu_torch`) once on one NVIDIA GPU.

Run from the repository root on a machine with a Hopper card (H100):

    python3 chip_smoke.py             # the full check (one card)
    python3 chip_smoke.py --profile   # also print kernel-time breakdowns
    python3 chip_smoke.py --ghosted   # only phase 13, the general ghosted
                                      # path (no kernel build); with
                                      # --profile its device-time splits
    python3 chip_smoke.py --general2  # only phase 14, the rest of the
                                      # general path (IMEX and implicit
                                      # RK steppers, the matrix solvers,
                                      # the observers)
    python3 chip_smoke.py --adaptive  # only phase 15, adaptive (CFL)
                                      # stepping and unsteady forces
    python3 chip_smoke.py --closure   # only phase 16, the NeuralClosure
                                      # pipeline (filtered DNS, a-priori
                                      # and a-posteriori training, the
                                      # 2-D example, FNO and G-CNN)
    python3 chip_smoke.py --precision # only the default precision's
                                      # checks (phase 1's bf16x3 forms,
                                      # both classes, the gates in each
                                      # precision) and phase 17, the 512³
                                      # RK44 and LMWray3 cells in both
                                      # precisions
    python3 chip_smoke.py --stack-turns DIR   # only phase 11's stack
                                      # timings: the package of the tree
                                      # DIR and this one's, in turns
    python3 chip_smoke.py --chain-turns DIR   # only the 256³ RK44 hat,
                                      # LES and Boussinesq chains'
                                      # ms/step, the package of the tree
                                      # DIR and this one's, in turns
    python3 chip_smoke.py --train-turns DIR   # only phase 3's 128³
                                      # gradient step with float32 convs
                                      # (s/step, conv share), the package
                                      # of the tree DIR and this one's,
                                      # in turns
    python3 chip_smoke.py --conv-turns DIR    # only the fused conv
                                      # layer's float32 kernels at 128³
                                      # (three layers: forward, dh, dw),
                                      # the package of the tree DIR and
                                      # this one's, in turns
    python3 chip_smoke.py --fold-turns DIR    # only the folded pass B's
                                      # cases (`FOLD_CASES`, the level
                                      # route's `FOLD_BIG_CASES`: ms and
                                      # error against float64; this
                                      # tree's gate cases, both routes),
                                      # the package of the tree DIR and
                                      # this one's, in turns
    python3 chip_smoke.py --channel-turns DIR # only the channel: its stage
                                      # kernel in every mode on the
                                      # ragged boxes and 256×128×128
                                      # against the plain version, the
                                      # hat modes' ms, the chain's
                                      # ms/step and device split, the
                                      # package of the tree DIR and this
                                      # one's, in turns
    python3 chip_smoke.py --perop-turns DIR   # only the conv-diff kernel
                                      # (128³ and its ragged box, error
                                      # against float64, ms), the float32
                                      # tap weight gradient at the
                                      # stack's three shapes (error, ms)
                                      # and phase 3's bf16 gradient step
                                      # (s/step, per-op launches), the
                                      # package of the tree DIR and this
                                      # one's, in turns; with --variant
                                      # 'LABEL|FILE|REGEX|REPL'
                                      # (repeatable) this tree with an
                                      # edit, in turns (the CD_XB sweep
                                      # of perop_geometry.cuh); then
                                      # ptxas registers and spills and
                                      # the HMMA count of the new kernels
    python3 chip_smoke.py --pack-turns DIR    # only the float32 pack
                                      # forward at 128³ (the closure's
                                      # three layers) and the dense pass
                                      # B's cases (256³ with the dense
                                      # route forced, 250³, the (250,
                                      # 125, 250) shard), ms and error
                                      # against float64, the package of
                                      # the tree DIR and this one's, in
                                      # turns; --variant as above; then
                                      # ptxas and the HMMA count of
                                      # tapconv_tf32.cu and fold.cu

Phases, each raising on failure (exit code != 0, no result line):

The paths run at `projection_precision="manualhigh"`, the default as in
the JAX package: the plane GEMM and the fused pass B in their bf16x3
forms, counted under their own launch keys (`form_keys`: ``+bf16x3``);
`run_counts` reads every path run's launches and fails where a run
launched the other precision's form.

0. Print the card's name and power limit (nvidia-smi), switch TF32 off
   for matmuls and cuDNN, build the CUDA kernels from
   `ins_tpu_torch/csrc` and print the build time.  Without a CUDA device
   the script fails; it never continues on the CPU.
1. Hold every kernel of the main path against its plain PyTorch version
   at 64³ and 256³ on inputs made by numpy from a seed: the RECON stage
   with emit_u and usnew, a stream-base stage, the unmerged stage (with
   and without k streams), each also with the Smagorinsky force and a
   body force, pass B dense (`dense_case`: at 64³ and at 256³ with the
   dense route forced, and with the 256³ case its own shapes, the 250³
   cube and the 2-way shard (250, 125, 250) at yoff 125, whose columns
   are no multiple of 4; each also against the plain version in float64
   within `DENSE_F64_TOL`, the float32 class; both routes, the fused
   kernel and the GEMM route, timed in turns at the gate's cases,
   `dense_gate_times`) and folded (the fused kernel, `fold_case`:
   one level and two, and with the 256³ cases 128³, the ragged n = 100
   and 512³ at two levels and one, each also against the plain version
   in float64, within twice the distance of the eight-launch route it
   replaced; above `FOLD_FUSED_MAX_N` the level route, the 1152³ cube
   at two levels, against the float32 plain version taken by y-chunks
   and, on a slab of y-columns, the float64 one; both routes timed in
   turns at the gate's cases, `fold_gate_times`), the correction and
   the plane transforms; the stage kernels' temperature
   stream (`momentum_stage_divhat_3d` with T elided, usnew, gdir 0 and
   the dissipation; `pcmsd_hat_3d` as on the Boussinesq path's stages 1-2,
   with a RECON base, emit_u, usnew and T elided, and with a stream base,
   tstart and tacc, gdir 1, no dissipation; each wrapper also with the
   force stream beside it), where the update kt itself, recovered from
   temp_next and tempnew, is held to the same bound.  Bound: max relative
   error <= 1e-4 (FP32 on both sides, sums taken in another order).  The
   plane transform (3xTF32 on the tensor cores) is held at the shapes the
   paths give it: z+y and x on the cube, on a 4-way shard's block (r =
   n/4) and its pass B's (n, n/4, n) y-slice, at the first fold level and
   at a ragged n - 6, each within 1e-6 relative of the float64 product
   (the float32 class) and 1e-4 of its plain version, and timed beside one
   FP32 einsum/matmul and the same call with TF32 allowed.  At 256³ each
   is timed against its plain version (CUDA events); with --profile each
   stage and correction wrapper's device time is split into its
   plane-transform GEMMs and the rest (against the rest's bytes bound).
   The per-op and conv kernels of the training path and the closure
   run's 3-pass Poisson solve `make_poisson_pallas` are held against
   their plain versions at 64³ and 128³ the same way, and timed at
   128³, the solve also against `make_poisson_mm`'s contractions; the
   conv-diff also on the ragged box (n/2 − 3, n − 27, n − 21) (nz % 4 !=
   0: its 4-byte staging), each conv-diff case against the plain version
   in float64 (1e-4) and within 1e-4 of the float32 one.  The
   fused conv layer runs on the tensor cores in both routes: bf16 operands
   (`fusedconv_3d`, `fusedconv_wgrad_3d`) in bf16, float32 ones (`+f32`)
   in 3xTF32: the closure's three layers and the three input-gradient
   forms (flipped, transposed taps) at k = 5 on the cube, and at k = 3, 5
   and 7 on the ragged box (n/2, n - 24, n + 8), with two wider layers
   there (40 -> 40 at k = 3: two input chunks and two output blocks; 16
   -> 13 at k = 5), each with a bf16 and a float32 output, against the
   plain version in float64 (bf16 operands: the kernels differ from the
   plain version on the same rounded operands only in summation order:
   1e-4 relative, one bf16 ulp for a bf16 output; float32 operands: a
   float32 output within 1e-5 of the float64 version and 1e-4 of the
   float32 one, which is cuDNN with TF32 off, a bf16 output one bf16 ulp
   and, near zero, 1e-5 of its largest value);
   the weight gradients against the plain version in float64 (float32
   operands: 1e-5, and 1e-4 of the float32 plain version), and two calls
   of either route bit-identical.  Every cube case is timed beside its
   bound (float32 operands: three TF32 products a multiply-add at the
   TF32 peak) and cuDNN (float32 operands: with TF32 off and on).  The
   solve gate: `make_poisson_pallas` against `make_poisson_mm` at 64³,
   128³ and 256³ (held against each other; wall ms per solve in turns and
   device ms per solve from torch.profiler), printed beside the solve the
   per-op chain's gate (`fastpath.poisson_pallas_min_n`) picks there.
   The cases above that name no precision hold the 3xTF32 forms
   ("highest"); the default precision's (`phase_precision_kernels`):
   the bf16x3 plane transform (`plane_transform+bf16x3`, the shapes of
   `transform_cases` with the inverse z/y transform, at 64³, 256³ and
   512³ and each ragged n − 6; timed at 256³) and the bf16x3 fused pass
   B (folded at 256³ one level and 512³ two, dense at 250³, the 4-way
   shard (256, 64, 256) at yoff 64 and 192), each within
   `BF16X3_PLAIN_TOL` (1e-5) of its plain version and `BF16X3_CLASS_TOL`
   of float64, timed beside its bound (three bf16 products a
   multiply-add at the bf16 peak); `precision_classes` prints each
   form's float64 error beside the other's (transforms at 256³ and 512³,
   those pass B cases, the 3-pass solve at 128³) and fails unless the
   3xTF32 form keeps the float32 class and the bf16x3 form sits
   `CLASS_APART` (4×) above it; then the three gates (`fold_gate_times`,
   `dense_gate_times`, `solve_gate_times`) in each precision.
2. The main path: `solve_unsteady` on 256³ decaying turbulence (RK44,
   f32, Re = 4000, `random_field(kp=10)`, dt = 1e-3·128/256) for 20
   steps in chunks of 10, with a timelogger.  Checks: finite; every
   kernel launched and no plain version run on the card; volume-scaled
   max|div u| <= 1e-4·max|u|/dx; kinetic energy not increasing; the
   same run through the plain chain on the card agrees to <= 1e-4
   relative.  Then ms/step for both chains after a warm-up.
3. The training path: the gradient of the a-posteriori loss
   (`bench.py`'s grad-step case: 128³ unit cube, Re = 2000, RK44,
   `random_field(kp=5)`, a CNN closure with radii (2, 2, 2), channels
   (24, 24, 3), tanh/tanh/identity, 5 unrolled steps with remat) with
   respect to the CNN parameters.  With float32 convs the kernel run's
   loss and gradient agree with the plain run on the card (loss
   relative <= 1e-5, each leaf's gradient relative L2 <= 1e-3) and its
   convolutions take the 3xTF32 kernels alone (`fusedconv_3d+f32`,
   `fusedconv_wgrad_3d+f32`); then its seconds per gradient step
   (kernels and plain in turns) and peak memory.  With the default bf16
   convs the run is finite, launches every training kernel (the bf16
   tensor-core convs, none of the `+f32` ones; the per-op kernels
   `convdiff_interior_3d`, `stage_div_3d`, `pressure_correct_3d` 40, 40
   and 35 times) and no plain version on the card, and its gradient agrees with the plain bf16 run to relative
   L2 <= 1e-2.  Then seconds per gradient step (kernels and plain in
   turns) and peak memory; with --profile the kernel-time breakdown of
   one step with each route's convs.  Then three
   Adam `train` iterations (finite losses) and a 10-step
   `solve_unsteady` with the closure attached (finite, divergence-free
   under phase 2's bounds, the 3-pass Poisson solve launched 4 times a
   step where the gate picks it, else never: at 128³ the chain solves
   with `make_poisson_mm`).
4. The wall-bounded channel: both channel kernels against their plain
   versions at ragged (40, 26, 20), (32, 20, 36) and (48, 24, 40) boxes
   (no multiple of the stage kernel's 16 x 32 tile) and at 256×128×128, in every
   `channel_msd_3d` mode the per-stage step and the hat chain use (with
   and without the force) and the correction, each timed against its
   plain version beside its byte bound.  Then `bench.py`'s `make_channel`
   case through the port's entry points: 256×128×128, x in [0, 4π],
   y in [0, 2π], z = `tanh_grid(0, 2, 128, 1.2)`, no-slip z walls,
   Re = 1e3, steady body force (1, 0, 0), f32, RK44, dt = 1e-3,
   `default_psolver` (the FDM solve), u0 = `velocityfield` of the
   parabola plus a 0.02 sin-sin-sin perturbation; `solve_unsteady` for 20
   steps in chunks of 10 with a timelogger.  Checks: finite; both kernels
   launched (`channel_msd_3d` 4 per step, the correction at each chunk
   end) and no plain version on the card; w exactly 0 on both walls;
   max|div u| <= 1e-4·max|u|/min Δz; the plain chain on the card agrees
   to <= 1e-4 relative.  Then ms/step of both chains in turns, the FDM
   solve's time alone and peak memory.
5. The Smagorinsky LES (`bench.py`'s `run_case(256, les=True)`): the
   force kernel against its plain version at a ragged (40, 26, 20) box
   and at 256³, on u and on the rebuilt u = ut − ∇q, with and without a
   body force (the stage kernels with ``smag=``/``bodyforce=`` and the
   folded pass B, one and two levels, are phase 1 cases), each timed
   against its plain version beside its byte bound.  Then
   `Setup(closure_model=smagorinsky_closure_natural(base))` at 256³,
   RK44, f32, Re = 4000, phase 2's `random_field(kp=10)`, dt =
   1e-3·128/256, θ = 0.17, `solve_unsteady` for 20 steps in chunks of 10
   with a timelogger, `observespectrum` and `observefield`.  Checks:
   finite; divergence as in phase 2; kinetic energy not increasing and at
   step 20 below phase 2's run without the closure; the force kernel,
   the stage kernel and the folded pass B launched exactly 4 times per
   step and no plain version on the card; the plain chain on the card
   agrees to <= 1e-4 relative; every spectrum finite with len(kappa)
   bins.  Then ms/step of both chains in turns and peak memory.
6. Boussinesq convection (`bench.py`'s `run_temp_case`): the unit cube at
   256³, periodic, `temperature_equation(Pr=0.71, Ra=1e7, Ge=1.0,
   dodissipation=True, gdir=2)` (Re = 1/alpha1), f32, RK44, dt =
   2e-4·128/256, u0 = `random_field(kp=10)` from phase 2's seed, T0 =
   `temperaturefield(0.5 + 0.1 sin 2πx)`; `solve_unsteady(tempstart=)` for
   20 steps in chunks of 10 with a timelogger and `observe_nusselt`.
   Checks: u and T finite; the stage kernels (with their temperature
   stream) and the folded pass B launched 4 times a step and no plain
   version on the card; divergence as in phase 2; the plain chain on the
   card agrees to <= 1e-4 relative in u and T, and every Nusselt number
   to 1e-4·max(1, |Nu|).  Then ms/step of both chains in turns and peak
   memory.
7. LMWray3 (`bench.py`'s `256_lmwray3`): phase 2's setup and u0 with
   `method=LMWray3()`, 20 steps in chunks of 10.  Checks: finite;
   divergence as in phase 2; kinetic energy not increasing; 3 stage
   launches and 3 pass B a step; the plain chain agrees to <= 1e-4.  Then
   ms/step of both chains in turns.
8. The x-slab halo chain: the four halo kernels (the stage kernels'
   `HALO` flag as `momentum_stage_divhat_halo_3d` and
   `pcmsd_hat_halo_3d`, `pressure_correct_qhat_halo_3d`, the sharded
   pass B) at the shard shapes of a 4-way x-slab of 64³ and 256³ (lx =
   n/4, ghost planes cut from the neighbours' planes of the global field)
   against their plain versions (the sharded pass B also at the ragged
   (100, 25, 100) at yoff 50 and at a 4-way shard of 1024³, (1024, 256,
   1024) at yoff 512 (two levels) and 256 (one), and against float64 as
   in phase 1; the level route on a 4-way shard of 2048³, (2048, 512,
   2048) at yoff 0 and 1536, as phase 1's 1152³), timed at 256³ (the
   sharded pass B in every case); then on
   every one of the
   four slabs against the matching x-rows of the single-device kernels on
   the whole cube, and the sharded pass B on y-columns [ly·r, ly·r + ly)
   of the full-x divhat at yoff = ly·r against the same columns of the
   single-device pass B (all <= 1e-4 relative).  Then
   `solve_unsteady(mesh=make_mesh(), halo=True)` on a one-rank NCCL group
   at phase 2's setup and u0, 20 steps in chunks of 10: finite,
   divergence-free, launches (the stage kernel once a chunk, the merged
   stage 4 a step less one a chunk, pass B 4 a step, the correction once
   a chunk; no single-device kernel, no plain version), within 1e-4 of
   the single-device hat chain; ms/step of both in turns beside the card's
   name and power limit (`--profile`: the halo step's device-time split
   and each halo kernel's split by kernel).  Phase 8's kernel cases also
   hold the LES kernels of phase 9 at the same shard shapes against their
   plain versions, timed at 256³: `smagorinsky_force_halo_3d` (the
   `HALO` flag of `csrc/smag.cu`) on u and on the rebuilt u, with and
   without a body force, in the chain's form (3 + 2 ghosts, the force on
   planes −1 .. lx − 1) and the JAX contract's (2 + 2 ghosts), and the
   two halo stage kernels with the force stream (`HALO` with `FORCE`),
   with ``smag=`` and with a body force alone (2 + 1 ghosts); and each
   on all four slabs against the single-device `smagorinsky_force_3d`
   and stage kernels' x-rows (<= 1e-4).
9. The Smagorinsky LES on the halo chain: phase 5's setup and phase 2's
   u0, `solve_unsteady(mesh=make_mesh(), halo=True, theta=0.17)` on a
   one-rank NCCL group, 20 steps in chunks of 10, with `observespectrum`
   and `observefield`.  Checks: finite, divergence as in phase 2, kinetic
   energy not increasing and at step 20 below phase 8's halo run; the
   halo force kernel 4 launches a step, the halo stage kernels with their
   force stream as phase 8's (and none without it), pass B 4 a step, the
   correction once a chunk, no single-device kernel and no plain version;
   within 1e-4 of phase 5's single-device LES chain; ms/step of both in
   turns beside the card's name and power limit (`--profile`: the halo
   LES step's device-time split).  Then 64³ halo runs with a steady body
   force, with the LES and alone (no force kernel), each against its
   single-device chain (<= 1e-4) with its launches counted.
10. The fused unmerged chain and bf16 stream storage.  The stage and
   correction kernels with bf16 storage (`momentum_stage_divhat_3d+bf16`:
   k streams with emit_k, stage 0 with usnew, a stream base with
   usnew_base and a body force, two k streams; `pcmsd_hat_3d+bf16`: a
   stream base with usnew_base, RECON with emit_u and usnew, and with a
   body force; `pressure_correct_qhat_3d+bf16`: bf16 -> bf16 and bf16 ->
   float32) and the stage with more than four k streams
   (`momentum_stage_divhat_3d+streams`: 9 and 5 k streams, with usnew and
   a body force, and 9 in bf16) against their plain versions at 64³ and
   256³ (float32 outputs within 1e-4 relative, bf16 ones within one bf16
   ulp elementwise, |Δ| <= 2^-7·|ref| + 1e-6·max|ref|), each timed at
   256³ beside its bound.  Then, at phase 2's setup and u0 through
   `solve_unsteady`: (A) SSP33 on the fused unmerged chain, 20 steps in
   chunks of 10 (finite, divergence as in phase 2, energy not
   increasing, 3 stage, pass B and correction launches a step, <= 1e-4 of
   the plain chain; ms/step beside the roll twin's); (B)
   ``stream_dtype=torch.bfloat16`` on RK44 (the hat chain) and on SSP33
   (the unmerged chain), 20 steps each (finite float32 results, the bf16
   kernels launched as the chain runs them and no float32 stage, the
   divergence to two bf16 roundings; each kernel step within 1e-2 of
   max|u| of the plain step on the same carry, and over the 20 steps the
   kinetic energy within 1e-4 of the bf16 plain chain's and the relative
   L2 distance to it no larger than that chain's from the float32 chain;
   the deviation from the float32 chain, ms/step beside it and both
   chains' energy balance |dE/dt + 2νZ|/(2νZ) over 10 steps, printed); (C) SSP104, 4 steps in chunks of 2 (5 stages a step on the
   many-stream kernel; <= 1e-4 of the plain chain).
11. The tap-matmul / pack-tile conv layer and the unfused stage.  (a)
   `tapconv_3d` and `packconv_3d` on the 24 -> 24 closure layer's z-folded
   g (132, 132, 128, 120) bf16 with tanh and a bias, `packconv_3d` on the
   24 -> 3 identity layer (all 25 taps packed), `tapconv_3d` at the input
   gradient's shape (the cotangent padded to (136, 136, 128, 24), taps
   (5, 5, 24, 120)) and `tapconv_wgrad_3d` on the stack's three shapes
   (g and dpre (128³, 24): 120 x 24; the 3 -> 24 layer's 16 x 24; 120 x 3),
   at 36³ and 128³ (float32 outputs within 1e-4 relative of the plain
   version; the weight gradients of the plain one in float64), each timed
   beside its bound and cuDNN's conv3d / conv3d_weight with a (5, 5, 1)
   kernel; bf16 operands run the bf16 tensor-core kernels, float32
   operands the `+f32` ones (the tap forward, the pack forward of the
   stack's three layers and the weight gradients of the stack's three
   shapes, the pack forward and the weight gradients on operands with
   full float32 mantissas, in 3xTF32 on the tensor cores, bound by three
   TF32 products a multiply-add, the pack forward and the weight
   gradients within 1e-5 of float64 and 1e-4 of the float32 plain
   version); two calls of either weight gradient bit-identical; at 36³
   also, on the ragged box (8, 37, 67) at ky = kx = 3, 5, 7, the bf16
   forwards and the 3xTF32 tap and pack forwards for the stack's three
   forwards (the first with kc =
   15), a 120 -> 13 layer and the input-gradient shapes (24 -> 120, 24 ->
   16, 3 -> 120), bf16 and float32 outputs, and the bf16 and 3xTF32
   weight gradients of the stack's three layers, against the plain version
   in float64 (one bf16 ulp; 1e-4; 3xTF32 1e-5); `momentum_stage_div_3d` (stage.cu's float32 stage)
   at 64³ and 256³.  (b) The closure stack (3 -> 24 -> 24 -> 3, radius 2,
   tanh/tanh/identity, phase 3's CNN weights) through
   `models.cnn._pallas_conv_layer` at 128³: forward and the gradient of
   sum(out²) with respect to the weights, the biases and the input, with
   the default forward (pack) and with pack=False, bf16 and float32
   convs, against the plain stack and the fused layers of phase 3 (bf16:
   output 1e-2 max relative, gradients 1e-2 relative L2; float32: 1e-4 and
   1e-3); launches: 3 `packconv_3d` (pack) or 3 `tapconv_3d` (tap) a
   forward, 3 `tapconv_3d` and 3 `tapconv_wgrad_3d` a backward (float32
   convs: the `+f32` keys, and none of the other route's); ms per
   forward and per forward + backward of the tap, pack and fused stacks
   (bf16) and the tap and pack stacks (float32 convs) in turns, with peak
   memory.  (c) The unfused projection step at 256³
   (`momentum_stage_div_3d` -> the per-op chain's 3-pass solve ->
   `pressure_correct_3d`, one launch each) against the fused hat step
   (`momentum_stage_divhat_3d` -> pass B -> `pressure_correct_qhat_3d`) on
   the same u, base and coeff: k and ut within 1e-4 relative, u_new within
   1e-4 of max|u_new|; ms of both in turns.
12. The dense pass B on a path: phase 2's run at 250³ (n % 4 != 0, where
   the projection's pass B is dense, as the JAX package's; dt =
   1e-3·128/250), 20 steps in chunks of 10.  Checks: finite; divergence
   and energy as in phase 2; the fused dense pass B launched 4 times a
   step and no fold, no GEMM route and no plain version; the plain chain
   on the card agrees to <= 1e-4 relative.  Then ms/step of both chains
   in turns.
13. The general ghosted path (`solve_unsteady`'s general branch, plain
   PyTorch: no kernel launch, which the phase checks), float32 on the
   card: `bench.py`'s `make_cavity_cg` (128³ unit cube, no-slip walls, the
   lid (1, 0, 0) at z = 1, Re 1e3, RK44, dt 1e-3,
   `psolver_cg(maxiter=8, reltol=1e-4, precond="fdm")`), 10 steps; the
   same cavity with `psolver_fdm`, 10 steps; `examples/rayleigh_benard_3d.py`
   at n = 60 (120 × 60 × 60, temperature, symmetric y walls for T), 20
   steps in chunks of 10.  Each run: the state on the card and finite;
   every Dirichlet ghost at its wall value (each wall's planes within the
   other dimensions' ghost layers against the constant, the edges and
   corners against the state's own ghost fill, exactly); the last
   projection's residual ||Ω div u|| / ||its right-hand side|| below the
   CG reltol 1e-4 (CG cavity), `FDM_DIV_TOL` 1e-5 (FDM cavity) or
   `RB_DIV_TOL` 3e-5 (Rayleigh-Bénard); the CG cavity within
   `CAVITY_F64_TOL` (1e-4) relative of the same setup stepped on the card
   in float64.  Rayleigh-Bénard's float32 witness: one projection of a
   predictor u + dt·F(u) of its last state, solved by `psolver_fdm` with
   one refinement sweep (the run's), with two, and by the float64 solve
   rounded to float32; the run's solver must come within
   `RB_FLOOR_FACTOR` (1.5) of the rounded float64 solution's residual
   (float32's floor), so a refinement that has not converged fails.
   Then ms/step and cell-updates/s of each (`timestep` after a warm-up),
   the projection's solve timed alone (for CG its iterations), one FDM
   solve; with --profile each case's device-time split (GEMMs,
   reductions, copies and fills, other elementwise) and idle share.
   `--ghosted` runs this phase alone.
14. The rest of the general path (`phase_general2`; plain PyTorch but for
   the channel's kernels), float32 on the card: the 128³ cavity of phase
   13 with `psolver_fdm` stepped 10 steps by AB-CN (`cavity_abcn128`) and
   by one-leg (`cavity_oneleg128`), each also in float64: the float32 run
   within `CAVITY_F64_TOL` of the float64 one, the divergence max|div
   u|·h / max|u| (h each cell's smallest spacing) below `F32_DIV_TOL`
   (1e-5) and `F64_DIV_TOL` (1e-12),
   the diffusion CG's iterations a step; `cavity_irk128`: GL1
   by full Newton and SDIRK34 by the approximate Newton, 2 steps each in
   both dtypes (`IRK_N`), the Newton iterations and the final |G|/|G0| a
   step, the same bounds; `cavity_cgmatrix128`: RK44 with
   `psolver_cg_matrix` (Jacobi, reltol `CGMATRIX_RELTOL` 1e-4; the last
   projection's relative residual within `CGMATRIX_DIV_FACTOR` of it),
   within that reltol of the `psolver_fdm` run, iterations and ms a
   solve;
   `ldc2d_direct512`: `examples/lid_driven_cavity_2d.py` at 512², RK44
   for 10 steps at the diffusive limit of its smallest cell with
   `psolver_direct` (the host LU's factor time apart) and with
   `psolver_fdm`, both runs' divergence below `F32_DIV_TOL`; on the last
   right-hand side an independent float64 solution (Jacobi `psolver_cg`
   on the matrix-free Laplacian, residual below `DIRECT_REF_RES` 1e-10)
   and the float32 direct solve within `DIRECT_TOL` (2e-3: the float32
   entries of the assembled matrix the LU factors) of it, printed beside
   the FDM solve's distance and the two runs' difference (the fast
   diagonalization loses accuracy on this grid, as the JAX package's
   does);
   every 3-D `fieldobserver` name on the AB-CN state against its float64
   evaluation (`OBSERVER_TOL`; the D-field where float32 resolves ∇²p,
   λ₂ before its log); `observe_wallshear` on both walls of the
   256×128×128 channel path over 20 steps against its float64 evaluation
   (`WALLSHEAR_TOL`); the streamfunction of a 512² periodic field
   against float64 (`STREAM_TOL`).  Each case: ms/step (the unprofiled
   wall of `profile_ghosted`) and its idle share.  `--general2` runs this
   phase alone, after the kernel build.
15. Adaptive (CFL) time stepping and unsteady body forces
   (`phase_adaptive`), float32 on the card.  `adaptive_hat256`: phase 2's
   256³ RK44 hat chain from its random field, `solve_unsteady(dt=None,
   cfl=0.9)` to 20 seed dt's, with the CFL limit recomputed every step
   and every 10th (`n_adapt_dt` 1 and 10); `adaptive_channel`: phase 4's
   256×128×128 channel, the same; `adaptive_cavity128`: phase 13's cavity
   from rest with a time-periodic body force on the general path, the
   same.  Each run: exactly the launches the chain makes (the hat chain:
   `momentum_stage_divhat_3d` once, `pcmsd_hat_3d` 4n − 1, `passB_fold`
   4n, `pressure_correct_qhat_3d` once a recompute on a carry plus the
   chunk end; the channel: `channel_msd_3d` 4n and its correction once a
   recompute plus the end; the cavity none), no plain version on CUDA,
   finite, every recomputed dt within `ADAPTIVE_DT_TOL` (1e-6) of 0.9 ×
   the float64 CFL limit of the same corrected u on the same grid
   (`cfl_twin`; the distance from the float64 grid's limit is printed
   beside it: the float32 grid's spacings carry their coordinates'
   rounding), and the run bit for
   bit the chain stepped by hand with that dt sequence.  Then each
   chain's ms/step at a fixed dt and with the recompute every step and
   every 10th, in turns, and their idle shares under the profiler.
   `unsteady_periodic256`: the 256³ roll route (the fused chains decline
   the force) with a time-periodic force, 5 RK44 steps through
   `solve_unsteady`: its 3-pass Poisson solve (`make_poisson_pallas`,
   its folded pass B) launched 4 times a step, no plain version, within
   `REL_TOL` of the float64 run of the plain versions, and moved by the
   force (against the run without it); ms/step.  Last, the fast
   diagonalization's null-mode counts (the port's per-axis test and the
   JAX package's sum test) on the script's FDM grids.  `--adaptive` runs
   this phase alone, after the kernel build.
16. The NeuralClosure pipeline (`phase_closure`), float32 on the card,
   through the port's entry points.  (a) `create_les_data` at 256³ (Re
   2e3 on the unit cube, phase 2's initial field and dt 5e-4, 20 burn-in
   steps, then 40 with a `filtersaver` every 5) onto 64³ and 128³ with
   `FaceAverage` and `VolumeAverage`: the DNS on the hat chain's kernels
   alone (launches counted, no plain version), every pair's ``c`` finite
   and nonzero, and the first two snapshots of every pair (u and c)
   within `REL_TOL` (relative L2) of the same pipeline with the plain
   chain's DNS; the DNS ms/step between snapshots and one snapshot's
   cost.  (b) The CNN of `BASELINE.json` configs[4] (radii (2,2,2),
   channels (24,24,3)) trained a-priori by `trainepoch` (batch 3) on the
   128³ `FaceAverage` pairs from `create_io_arrays`, with bf16 and with
   float32 convs: on one batch loss and gradients within phase 3's
   tolerances of the plain layers, `fusedconv_3d` / `fusedconv_wgrad_3d`
   (`+f32`) launched, `create_relerr_prior` falling over the epochs;
   s/epoch.  (c) `create_loss_post` on the 128³ trajectory
   (`create_dataloader_post`, nunroll 3, 5 substeps of 5e-4, remat)
   through the per-op chain: the first batch's loss and gradient within
   phase 3's bf16 tolerance of the plain run, then two gradient steps;
   s/step.  (d) `ins_tpu_torch/examples/neural_closure_training.py` at
   its full sizes (256² DNS, 64² LES, 500 a-priori and 100 a-posteriori
   iterations), then an FNO (kmax (16,16,16,8), channels (32,)*4, gelu)
   and a G-CNN (radii (2,2,2), channels (4,4,1)) trained a-priori on its
   data (relative error falling); the G-CNN's prior and post symmetry
   errors within `SYMMETRY_TOL` (1e-5), the CNN's above it; seconds per
   stage.  `--closure` runs this phase alone, after the kernel build.
17. The 512³ cells (`phase_precision`; `bench.py`'s `512` and
   `512_lmwray3`, `run_case(512, 2, 5)`): the periodic box, Re 4000,
   float32, `psolver_spectral`, dt = 1e-3·128/512, `random_field(kp=10)`
   from phase 2's seed; RK44 and LMWray3 through `solve_unsteady` on the
   hat chain for the bench's 7 steps in each precision: peak memory,
   launches (the fused pass B 4 or 3 a step, only the precision's form),
   finite, divergence as in phase 2, energy not increasing; the two hat
   chains' ms/step and cell-updates/s in turns (manualhigh, highest,
   highest, manualhigh; 2 warm-up steps and 5 timed ones); then the
   plain chain against the kernels for 2 steps in each precision
   (`REL_TOL`).  Then `highest_paths`: phase 12's 250³ chain and phase
   8's one-rank x-slab chain at 256³ in "highest" for 4 steps (the dense
   and the sharded pass B's 3xTF32 forms on their paths).
18. Print the kernel table (JSON: per kernel its launches on the main
   path, error, ms, plain ms, the bound — the larger of the bytes it
   moves at 3.35 TB/s and the operations it does at the dense peak of
   their type — and the time of one PyTorch library call computing the
   same function where there is one; the plane GEMM and the fused pass B
   once in each form: the bf16x3 forms with the default paths' launches,
   the 3xTF32 forms with those of phase 17's "highest" runs) and, last,
   the result line
   ``{"ok": true, "device": {...}}``.  The folded pass B's level route
   (`passB_fold+levels`, `passB_sharded+levels`, timed at 1152³ and
   (2048, 512, 2048)) stays in the table with 0 launches; no main path
   runs it (every folded cube here has n <= `FOLD_FUSED_MAX_N`, where the
   fused kernel runs: phases 2 and 8 fail on a level-route launch).  The
   dense pass B's launches are phase 12's; the hat, channel, training and
   3-pass solve kernels' include phases 15 and 16's.  Each phase prints
   its seconds.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from typing import Any, NamedTuple

import numpy as np

REL_TOL = 1e-4
# a cube extent that is no multiple of the stencil kernels' tiles (stage.cu:
# 32 x 16 cells of (z, y) and 16 x-planes a block; smag.cu: 32 x 8 and 16)
# and no multiple of 4: the stage kernels' ragged tiles at every edge
RAGGED_N = 50
# the halo kernels' ragged cube: 4 shards of 13 planes
HALO_RAGGED_N = 52
# the plane transform (3xTF32) against the float64 product: the float32
# class, max|Δ| <= 1e-6·max|ref| (one TF32 pass is ~3e-4 off)
TF32_CLASS_TOL = 1e-6
# projection_precision "manualhigh" (the default, as in the JAX package):
# the bf16x3 forms of the plane GEMM and the fused pass B (three bf16
# products hi·hi + hi·lo + lo·hi of a bf16 hi/lo split, float32 sums).
# Against float64 the 3-pass bf16 class (lo·lo dropped and lo rounded to 8
# bits: ~2^-16 a product; 5e-6 to 2.5e-5 on the CPU at K <= 512, and the
# JAX package documents a projection residual of ~4e-5); against its plain
# version (the same three products, float32 sums in another order) 1e-5;
# its float64 error at least CLASS_APART times the 3xTF32 form's on the
# same inputs, so the two classes show apart
BF16X3_CLASS_TOL = 1e-4
BF16X3_PLAIN_TOL = 1e-5
CLASS_APART = 4.0
# the fused conv layer's 3xTF32 kernels against the float64 plain version
# (sums of up to 3000 split products a cell; ~2e-6 at 128³ on an H100)
CONV_TF32_TOL = 1e-5
# the folded pass B's cases (`fold_case`): (n, fold levels, ly, yoff); ly
# = n is the cube (`passB_fold`), else an x-slab shard's y-slice
# (`passB_sharded`).  Phase 1 holds the cubes at 64³ and 256³ (one level,
# then two) and, with the 256³ ones, 128³, the ragged n = 100 (halves of
# 50) and 512³ at two levels and one (stages of 16 of K); phase 8 the
# shards of the halo path's 4-way cut (at 52³, 64³ and 256³) and, with
# the 256³ one, the ragged shard and a 4-way shard of 1024³ at two levels
# (1024's default) and one (32-column panels, stages of 8 of K).
# `--fold-turns` runs them all.
FOLD_EXTRA_CUBES = ((128, 1, 128, 0), (100, 1, 100, 0), (512, 2, 512, 0), (512, 1, 512, 0))
FOLD_EXTRA_SHARDS = ((100, 1, 25, 50), (1024, 2, 256, 512), (1024, 1, 256, 256))
FOLD_CASES = ((256, 1, 256, 0), (256, 2, 256, 0), *FOLD_EXTRA_CUBES, (64, 1, 64, 0),
              (64, 2, 64, 0), (256, 1, 64, 64), (64, 1, 16, 16), (52, 1, 13, 13),
              *FOLD_EXTRA_SHARDS)
# each folded pass B case's max|Δ|/max|ref| against its plain version in
# float64 by the route before the fused kernel (eight launches around the
# plane GEMM; `--fold-turns` on the same inputs, NVIDIA H100 80GB HBM3, 700
# W), keyed (n, levels, ly): the fused kernel is held within twice it
FOLD_PARENT_F64 = {
    (256, 1, 256): 5.858e-07, (256, 2, 256): 6.212e-07, (128, 1, 128): 9.626e-07,
    (100, 1, 100): 7.946e-07, (64, 1, 64): 6.586e-07, (64, 2, 64): 7.660e-07,
    (256, 1, 64): 5.002e-07, (64, 1, 16): 5.178e-07, (52, 1, 13): 7.944e-07,
    (100, 1, 25): 4.893e-07, (512, 2, 512): 8.258e-07, (512, 1, 512): 8.481e-07,
    (1024, 2, 256): 5.343e-07, (1024, 1, 256): 5.859e-07,
}
# The level route's cases (above `poisson_kernels.FOLD_FUSED_MAX_N`, where
# no panel of all n x-rows fits the fused kernel's block): the 1152³ cube
# at two levels (leaf 288) and a 4-way shard of 2048³ (8.6 GB a field) at
# yoff 0 and 1536.  Held against the float32 plain version, taken
# FOLD_CHUNK_FLOATS of the block at a time along y (the columns are
# independent), and on a slab of FOLD_F64_ROWS y-columns against the
# float64 one, within FOLD_BIG_F64_TOL (the float32 class: the 1024 cases
# are ~5e-7 off).
FOLD_BIG_CUBES = ((1152, 2, 1152, 0),)
FOLD_BIG_SHARDS = ((2048, 2, 512, 0), (2048, 2, 512, 1536))
FOLD_BIG_CASES = FOLD_BIG_CUBES + FOLD_BIG_SHARDS
FOLD_CHUNK_FLOATS = 1 << 27
FOLD_F64_ROWS = 8
FOLD_BIG_F64_TOL = 1e-5
# the gate's cases (`fold_gate_times`): both routes in turns at 512³,
# 768³ (two levels each) and the (1024, 256, 1024) shard
FOLD_GATE_CASES = ((512, 2, 512, 0), (768, 2, 768, 0), (1024, 2, 256, 512))
# the dense pass B's cases (`dense_case`): (n, ly, yoff); ly = n the cube
# (`passB`), else an x-slab shard's y-slice (`passB_sharded`).  With the
# 256³ cube (the dense route forced on a cube that folds) phase 1 holds
# the route's own shapes: the 250³ cube (n % 4 == 2) and its 2-way shard
# at yoff 125 (31250 columns: 4-byte staging).  Each within
# DENSE_F64_TOL of the plain version in float64 (the float32 class: the
# three-launch route is ~1e-6 off at 256³, the float32 plain version
# ~1.4e-6).
DENSE_EXTRA = ((250, 250, 0), (250, 125, 125))
DENSE_F64_TOL = 2e-6
# the dense gate's cases (`dense_gate_times`): both routes in turns on
# either side of `poisson_kernels.DENSE_FUSED_MAX_N`, up to the fused
# kernel's reach (n = 512)
DENSE_GATE_CASES = ((250, 250, 0), (250, 125, 125), (258, 258, 0), (258, 129, 129),
                    (322, 322, 0), (382, 382, 0), (510, 510, 0))
# the dense pass B's chain (phase 12): the cube of phase 2's setup at this
# n % 4 != 0
DENSE_CHAIN_N = 250
SEED = 20261016
DEVICE = "cuda"
# the card's published peaks (H100 SXM data sheet, dense): device-memory
# bytes/s and operations/s by operand type
PEAK_BYTES = 3.35e12
PEAK_OPS = {"fp32": 67e12, "bf16": 989e12, "tf32": 495e12}
# the plane-transform GEMMs' FLOP in a kernel's "fp32" operation count:
# they run three TF32 products a multiply-add at the TF32 peak, so F FLOP
# take 3 F / 495e12 s at the bound, the time of 3·67/495 F FP32 operations
GEMM_AS_FP32 = 3 * PEAK_OPS["fp32"] / PEAK_OPS["tf32"]
# the same for the bf16x3 form ("manualhigh", the paths' default): three
# bf16 products a multiply-add at the bf16 peak
GEMM_BF16X3_AS_FP32 = 3 * PEAK_OPS["fp32"] / PEAK_OPS["bf16"]
GEMM_FP32 = {"highest": GEMM_AS_FP32, "manualhigh": GEMM_BF16X3_AS_FP32}
# operations per cell of the stencil kernels, counted from their arithmetic
# (each add, multiply and divide one): the conv-diff of three components
# (each face flux once: per component and direction the diffusion's 4, the
# flux's 5 (3 along its own axis) and its difference's 4),
# the stage kernels' conv-diff at I and I - e_a plus the tableau and the
# divergence, the channel stage's stretched conv-diff plus rebuild,
# tableau and divergence, and the elementwise passes
OPS_PER_CELL = {
    "convdiff": 111, "stage": 373, "stage_norebuild": 364, "stage_div": 22,
    "correct": 9, "eigen_scale": 15, "channel_msd": 215,
    # the Smagorinsky force as the JAX package's `_smag_body` forms it, each
    # quantity once per cell: 6 strains (24), the eddy viscosity from their
    # squares, the four-edge sums and the sqrt (23), the stress with ν
    # averaged to the edges (21) and its divergence (24)
    "smag": 92, "fold_split": 2,
    # the temperature stream as `_stage_tail` forms it, each face quantity
    # once per cell: the buoyancy (4), per direction the face average,
    # flux, gradient and their differences (12, x3), the dissipation's
    # Laplacian, viscous product and face average per component (19, x3,
    # + 2) and the two tableau updates (4)
    "stage_temp": 103,
    # each k stream of a stage beyond the first: a multiply-add per
    # component at I and at I - e_a
    "tableau_stream": 12,
}
# the Boussinesq cell's coefficients (Pr 0.71, Ra 1e7, Ge 1, nondim 1):
# alpha2 = 1, alpha4 = 1/sqrt(Pr Ra), dissipation Re alpha1/gamma = 1
TEMP_ALPHA4 = 1.0 / math.sqrt(0.71e7)
# phase 3 bounds (float32 convs: summation order only; bf16 convs: one
# bf16 ulp where a stored activation rounds the other way)
LOSS_TOL_F32 = 1e-5
GRAD_TOL_F32 = 1e-3
GRAD_TOL_BF16 = 1e-2
# bf16 stream storage (phase 10): a bf16 kernel output is held to one bf16
# ulp of its plain version elementwise (8 significant bits), |Δ| <=
# 2^-7·|ref| + 1e-6·max|ref|; each step of a bf16 kernel chain to 1e-2 of
# max|u| of the plain step on the same carry (a rounding that falls the
# other way is one ulp, 2^-7·max|u| at most).  Over a run, two bf16 chains
# whose float32 sums differ drift apart by cascades of such roundings (a
# neighbour that differs by a float32 ulp rounds the other way in turn):
# after 20 steps at 256³ their kinetic energies are held to 1e-4 and their
# relative L2 distance to the plain bf16 chain's own distance from the
# float32 chain.  The divergence, unscaled, to two roundings (2^-8
# relative each: the stored ut, then the stored u) of each component at I
# and I - e_a: max|div u|·dx/max|u| <= 3·2·2·2^-8
BF16_ULP = 2.0**-7
BF16_CHAIN_TOL = 1e-2
BF16_ENERGY_TOL = 1e-4
BF16_DIV_TOL = 12 * 2.0**-8


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def form_keys(precision="manualhigh"):
    """The launch keys that the plane GEMM and the fused pass B count
    under in ``precision`` (`transforms.plane_key`,
    `poisson_kernels.fused_key`), by kernel."""
    from ins_tpu_torch.ops import poisson_kernels as pk
    from ins_tpu_torch.ops import transforms

    return {"plane_transform": transforms.plane_key(precision),
            **{k: pk.fused_key(k, precision) for k in ("passB", "passB_fold", "passB_sharded")}}


def hat_kernels(precision="manualhigh"):
    """The hat chain's kernels' launch keys in ``precision``."""
    keys = form_keys(precision)
    return (keys["plane_transform"], "pcmsd_hat_3d", "momentum_stage_divhat_3d",
            keys["passB_fold"], "pressure_correct_qhat_3d")


def run_counts(precision="manualhigh"):
    """The launch counts of the run just driven (read right after it,
    the counts set to 0 just before it).  Fails where the plane GEMM or the
    fused pass B launched in the form of the precision other than
    ``precision`` (no path falls back to the other form)."""
    from ins_tpu_torch.ops import launches

    counts = dict(launches.LAUNCHES)
    other = "highest" if precision == "manualhigh" else "manualhigh"
    wrong = {k: counts[k] for k in form_keys(other).values() if counts[k]}
    if wrong:
        fail(f"a {precision!r} run launched the other form's kernels: {wrong}")
    return counts


def add_counts(total, counts):
    """Adds ``counts`` into ``total`` key by key; returns ``total``."""
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def rel_err(got, ref):
    ref_max = ref.abs().max().item()
    return (got - ref).abs().max().item() / max(ref_max, 1e-30)


def abs_err(got, ref):
    return (got - ref).abs().max().item()


def ulp_ratio(got, ref, floor=1e-6):
    """max |got - ref| / (2^-7·|ref| + floor·max|ref|) elementwise: <= 1
    where a bf16 output is within one bf16 ulp of its reference (and,
    near zero, within `floor` of its largest value)."""
    ref = ref.float()
    bound = BF16_ULP * ref.abs() + floor * ref.abs().max()
    return ((got.float() - ref).abs() / bound.clamp_min(1e-30)).max().item()


def rel_l2(got, ref):
    return ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()


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


class Case(NamedTuple):
    """One check of a kernel against its plain version.  ``ref``, where
    given, is what the error is measured against (``pfn`` is timed);
    ``inputs`` are the tensors the function reads and ``ops`` the
    operations it does (of type ``peak``), for its bound; ``library`` is
    one PyTorch call computing the same function, timed as a yardstick;
    ``derived``, where given, maps either side's outputs to further
    tensors held to the same bound (an update a small step size hides);
    ``time=False`` leaves the case out of the timings.  ``tol`` bounds a
    float output's relative error against ``ref`` (or the plain version);
    ``plain_tol``, where given with ``ref``, also bounds the kernel against
    the plain version; ``ulp_floor`` is the absolute part of a bf16
    output's one-ulp bound, relative to its largest value (`ulp_ratio`);
    ``library_tf32`` is ``library`` with TF32 allowed (PyTorch's "high"
    matmul precision, cuDNN's TF32 convolutions), timed beside it."""

    label: str
    kfn: Any
    pfn: Any
    ref: Any = None
    inputs: tuple = ()
    ops: float = 0.0
    peak: str = "fp32"
    library: Any = None
    derived: Any = None
    time: bool = True
    tol: float = REL_TOL
    plain_tol: Any = None
    ulp_floor: float = 1e-6
    library_tf32: Any = None


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(case, out_bytes):
    """(ms, "bytes" or "operations"): the least time the card could take,
    each input read once and each output written once."""
    t_bytes = (nbytes(case.inputs) + out_bytes) / PEAK_BYTES * 1e3
    t_ops = case.ops / PEAK_OPS[case.peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fold_ops(n, L, precision="highest"):
    """Operations of the folded pass B at n³ with L levels: (n / 2^l)^2 n^2
    for level l's two half GEMMs, the leaf's two GEMMs 4 (n / 2^L)^2 n^2
    (2 n^4 in all at one level, half the dense 4 n^4; as `GEMM_FP32`
    counts them for the precision's form), the scale, split and combine
    elementwise."""
    cells = n**3
    return ((sum(n**4 / 4**lv for lv in range(L)) + 4 * (n / 2**L) ** 2 * n**2)
            * GEMM_FP32[precision]
            + OPS_PER_CELL["eigen_scale"] * cells + L * 2 * OPS_PER_CELL["fold_split"] * cells)


def fold_p64(n, levels):
    """The float64 projection of the folded pass B at n³ (float64 fold
    matrices, `levels` levels), the plain version's in float64."""
    import torch

    from ins_tpu_torch.ops.poisson_kernels import poisson_fold_consts

    dxs = (2 * np.pi / n,) * 3
    mats64, _, eps = poisson_fold_consts((n,) * 3, dxs, torch.float64, levels=levels,
                                         device=torch.device(DEVICE))
    return {"dxs": tuple(float(d) for d in dxs), "vol": float(np.prod(dxs)), "eps": eps,
            "fold_mats": mats64, "fold_levels": levels}


def fold_setup(n, levels, ly, yoff, precision="highest"):
    """The folded pass B's input (made from a seed), projection (float32,
    `levels` levels, ``precision``'s form) and the float64 projection of
    `fold_case(n, levels, ly, yoff, precision)`: (h, proj, p64, label)."""
    import torch

    from ins_tpu_torch.ops.poisson_kernels import (
        make_fused_projection, make_passB_sharded, poisson_fold_consts,
    )

    dev = torch.device(DEVICE)
    dxs = (2 * np.pi / n,) * 3
    kw = dict(precision=precision, device=dev)
    proj = (make_fused_projection((n,) * 3, dxs, torch.float32, **kw) if ly == n
            else make_passB_sharded((n,) * 3, dxs, torch.float32, ly, **kw))
    if levels != proj["fold_levels"]:
        mats, _, _ = poisson_fold_consts((n,) * 3, dxs, torch.float32, levels=levels, device=dev)
        proj = dict(proj, fold_mats=mats, fold_levels=levels)
    seed = SEED + 31 * n + 7 * ly + levels
    if n * ly * n <= 1 << 28:  # up to the (1024, 256, 1024) shard: numpy, as before
        rng = np.random.default_rng(seed)
        h = torch.from_numpy(rng.standard_normal((n, ly, n), dtype=np.float32)).to(dev)
    else:  # larger fields (up to 2^31 floats) are drawn on the card
        gen = torch.Generator(device=dev).manual_seed(seed)
        h = torch.randn((n, ly, n), generator=gen, dtype=torch.float32, device=dev)
    lv = f"{levels} level{'s' if levels > 1 else ''}"
    label = f"{n}³, {lv}" if ly == n else f"({n}, {ly}, {n}) at yoff {yoff}, {lv}"
    if precision == "manualhigh":
        label += ", bf16x3"
    return h, proj, fold_p64(n, levels), label


def fold_chunked_plain(h, proj, yoff):
    """The float32 plain pass B of an (n, ly, n) block whose first y-mode
    is yoff, `FOLD_CHUNK_FLOATS` of it at a time along y (each column's
    solve is its own)."""
    import torch

    from ins_tpu_torch.ops.poisson_kernels import passB_sharded_plain

    n, ly = h.shape[0], h.shape[1]
    step = max(1, FOLD_CHUNK_FLOATS // (n * n))
    out = torch.empty_like(h)
    for a in range(0, ly, step):
        out[:, a:a + step] = passB_sharded_plain(h[:, a:a + step], proj, yoff + a)
    return out


def fold_kernel(h, proj, yoff):
    """The wrapper the main paths call: `passB_fold` on a cube,
    `passB_sharded` on a y-slice."""
    from ins_tpu_torch.ops.poisson_kernels import passB_fold, passB_sharded

    return passB_fold(h, proj) if h.shape[1] == h.shape[0] else passB_sharded(h, proj, yoff)


def fold_case(n, levels, ly, yoff, precision="highest"):
    """A `Case` of the folded pass B (`FOLD_CASES`' terms) on an input made
    from a seed: the kernel and its float32 plain version, held against
    the plain version in float64 (float64 fold matrices) within twice
    `FOLD_PARENT_F64`, and within `REL_TOL` of the float32 plain
    version.  A case `FOLD_PARENT_F64` lacks (the level route's, above
    the fused kernel's range) is held within `REL_TOL` of the float32
    plain version taken by y-chunks (`fold_chunked_plain`), and its
    float64 error on a slab of columns is `fold_f64_sample`'s.  With
    ``precision="manualhigh"`` the bf16x3 form: within `BF16X3_CLASS_TOL`
    of float64 and `BF16X3_PLAIN_TOL` of its plain version."""
    from ins_tpu_torch.ops.poisson_kernels import passB_fold_plain, passB_sharded_plain

    h, proj, p64, label = fold_setup(n, levels, ly, yoff, precision)
    kfn = lambda: (fold_kernel(h, proj, yoff),)  # noqa: E731
    common = dict(inputs=(h, *proj["fold_mats"]), ops=fold_ops(n, levels, precision) * ly / n)
    bf = precision == "manualhigh"
    if not bf and (n, levels, ly) not in FOLD_PARENT_F64:
        return Case(label, kfn, lambda: (fold_chunked_plain(h, proj, yoff),), **common)
    if ly == n:
        pfn = lambda: (passB_fold_plain(h, proj),)  # noqa: E731
        ref = lambda: (passB_fold_plain(h.double(), p64),)  # noqa: E731
    else:
        pfn = lambda: (passB_sharded_plain(h, proj, yoff),)  # noqa: E731
        ref = lambda: (passB_sharded_plain(h.double(), p64, yoff),)  # noqa: E731
    if bf:
        return Case(label, kfn, pfn, ref=ref, tol=BF16X3_CLASS_TOL, plain_tol=BF16X3_PLAIN_TOL,
                    **common)
    return Case(label, kfn, pfn, ref=ref, tol=2 * FOLD_PARENT_F64[n, levels, ly],
                plain_tol=REL_TOL, **common)


def fold_f64_sample(h, p64, yoff, got):
    """max|Δ|/max|ref| of the kernel's output ``got`` on input ``h`` on
    the `FOLD_F64_ROWS` y-columns from ly/2 on, against the plain version
    in float64 (``p64``: float64 fold matrices) there."""
    from ins_tpu_torch.ops.poisson_kernels import passB_sharded_plain

    ly = h.shape[1]
    a = ly // 2
    b = min(ly, a + FOLD_F64_ROWS)
    ref = passB_sharded_plain(h[:, a:b].double(), p64, yoff + a)
    return rel_err(got[:, a:b].double(), ref)


def fold_big_cases(_n):
    """{kernel name: [Case]} of the level route's cube (phase 1)."""
    return {"passB_fold+levels": [fold_case(*c) for c in FOLD_BIG_CUBES]}


def fold_big_shard_cases(_n):
    """{kernel name: [Case, ...]} of the level route's shards (phase 8)."""
    return {"passB_sharded+levels": [fold_case(*c) for c in FOLD_BIG_SHARDS]}


def check_fold_f64(cases):
    """Each case's float64 error on its slab (`fold_f64_sample`), held
    within `FOLD_BIG_F64_TOL`."""
    import torch

    for c in cases:
        n, levels, ly, yoff = c
        h, proj, p64, label = fold_setup(*c)
        err = fold_f64_sample(h, p64, yoff, fold_kernel(h, proj, yoff))
        print(f"[kernels] level route {label}: max rel err on y-columns [{ly // 2}, "
              f"{min(ly, ly // 2 + FOLD_F64_ROWS)}) against the plain version in float64 "
              f"{err:.3e} (bound {FOLD_BIG_F64_TOL})")
        if not err <= FOLD_BIG_F64_TOL:
            fail(f"the level route at {label}: {err:.3e} from float64, above "
                 f"{FOLD_BIG_F64_TOL}")
        del h, proj, p64
        torch.cuda.empty_cache()


def fold_gate_times(cases=FOLD_GATE_CASES, precision="highest"):
    """Both routes of the folded pass B in ``precision``'s form in turns
    (CUDA events, 10 calls a turn: fused, levels, levels, fused) at each
    case, the float32 relative difference between them, and the route
    `fold_route` picks: the gate (`FOLD_FUSED_MAX_N`) must pick the faster
    route, or one within 5 % of it.  {label: {"fused": ms, "levels":
    ms}}."""
    import torch

    from ins_tpu_torch.ops import poisson_kernels as pk

    out = {}
    for c in cases:
        n, levels, ly, yoff = c
        h, proj, _, label = fold_setup(*c, precision)
        fns = {"fused": lambda: pk._fold(h, proj, yoff, ly),
               "levels": lambda: pk._fold_levels(h, proj, 0, 1, yoff)}
        diff = rel_err(fns["levels"](), fns["fused"]())
        t = {"fused": [], "levels": []}
        for which in ("fused", "levels", "levels", "fused"):
            t[which].append(cuda_ms(fns[which]))
        ms = {k: sum(v) / 2 for k, v in t.items()}
        pick = pk.fold_route(n)
        out[label] = ms
        print(f"[fold gate] {card_line()}: {label}: fused {ms['fused']:.4f} ms "
              f"({t['fused'][0]:.4f}, {t['fused'][1]:.4f}), level route {ms['levels']:.4f} ms "
              f"({t['levels'][0]:.4f}, {t['levels'][1]:.4f}); routes differ by {diff:.3e}; "
              f"the gate (n <= {pk.FOLD_FUSED_MAX_N} fused) picks {pick}")
        if not diff <= REL_TOL:
            fail(f"the folded pass B's routes differ by {diff:.3e} at {label}")
        if ms[pick] > 1.05 * min(ms.values()):
            fail(f"the gate picks the {pick} route at {label}, slower than the other: {ms}")
        del h, proj, fns
        torch.cuda.empty_cache()
    return out


def dense_setup(n, ly, yoff, precision="highest"):
    """The dense pass B's input (made from a seed), projection (float32,
    ``precision``'s form; a shard's where ly < n), the float64 projection
    and the label of `dense_case(n, ly, yoff, precision)`: (h, proj, p64,
    label)."""
    import torch

    from ins_tpu_torch.ops.poisson_kernels import make_fused_projection, make_passB_sharded

    dev = torch.device(DEVICE)
    dxs = (2 * np.pi / n,) * 3
    kw = dict(precision=precision, device=dev)
    proj = (make_fused_projection((n,) * 3, dxs, torch.float32, **kw) if ly == n
            else make_passB_sharded((n,) * 3, dxs, torch.float32, ly, **kw))
    p64 = make_fused_projection((n,) * 3, dxs, torch.float64, device=dev)
    rng = np.random.default_rng(SEED + 37 * n + ly)
    h = torch.from_numpy(rng.standard_normal((n, ly, n), dtype=np.float32)).to(dev)
    label = f"{n}³" if ly == n else f"({n}, {ly}, {n}) at yoff {yoff}"
    if ly == n and n % 4 == 0:
        label += ", the dense route forced"
    if precision == "manualhigh":
        label += ", bf16x3"
    return h, proj, p64, label


def dense_case(n, ly, yoff, precision="highest"):
    """A `Case` of the dense pass B (`passB` on a cube, `passB_sharded` on a
    y-slice) on an input made from a seed: held against the plain version
    in float64 within `DENSE_F64_TOL` and within `REL_TOL` of the float32
    plain version; its bound counts the two x products (as `GEMM_FP32`
    counts the precision's form) and the eigen-scale.  With
    ``precision="manualhigh"`` the bf16x3 form: within `BF16X3_CLASS_TOL`
    of float64 and `BF16X3_PLAIN_TOL` of its plain version."""
    from ins_tpu_torch.ops.poisson_kernels import (
        passB, passB_plain, passB_sharded, passB_sharded_plain,
    )

    h, proj, p64, label = dense_setup(n, ly, yoff, precision)
    if ly == n:
        kfn = lambda: (passB(h, proj),)  # noqa: E731
        pfn = lambda: (passB_plain(h, proj),)  # noqa: E731
        ref = lambda: (passB_plain(h.double(), p64),)  # noqa: E731
    else:
        kfn = lambda: (passB_sharded(h, proj, yoff),)  # noqa: E731
        pfn = lambda: (passB_sharded_plain(h, proj, yoff),)  # noqa: E731
        ref = lambda: (passB_sharded_plain(h.double(), p64, yoff),)  # noqa: E731
    ops = (OPS_PER_CELL["eigen_scale"] * n**3 + 4.0 * n**4 * GEMM_FP32[precision]) * ly / n
    bf = precision == "manualhigh"
    return Case(label, kfn, pfn, ref=ref, tol=BF16X3_CLASS_TOL if bf else DENSE_F64_TOL,
                plain_tol=BF16X3_PLAIN_TOL if bf else REL_TOL,
                inputs=(h, proj["Vinv"], proj["V"]), ops=ops)


def dense_gate_times(cases=DENSE_GATE_CASES, precision="highest"):
    """Both routes of the dense pass B in ``precision``'s form in turns
    (CUDA events, 10 calls a turn: fused, GEMM, GEMM, fused) at each case,
    the float32 relative difference between them, and the route
    `dense_route` picks: the gate (`DENSE_FUSED_MAX_N`) must pick the
    faster route, or one within 5 % of it.  {label: {"fused": ms, "gemm":
    ms}}."""
    import torch

    from ins_tpu_torch.ops import poisson_kernels as pk

    out = {}
    for c in cases:
        n, ly, yoff = c
        h, proj, _, label = dense_setup(*c, precision)
        fns = {"fused": lambda: pk._dense_fused(h, proj, yoff, ly),
               "gemm": lambda: pk._dense_gemm(h, proj, yoff)}
        diff = rel_err(fns["gemm"](), fns["fused"]())
        t = {"fused": [], "gemm": []}
        for which in ("fused", "gemm", "gemm", "fused"):
            t[which].append(cuda_ms(fns[which]))
        ms = {k: sum(v) / 2 for k, v in t.items()}
        pick = pk.dense_route(n, precision)
        gate = pk.DENSE_FUSED_MAX_N_BF16X3 if precision == "manualhigh" else pk.DENSE_FUSED_MAX_N
        out[label] = ms
        print(f"[dense gate] {card_line()}: {label}: fused {ms['fused']:.4f} ms "
              f"({t['fused'][0]:.4f}, {t['fused'][1]:.4f}), GEMM route {ms['gemm']:.4f} ms "
              f"({t['gemm'][0]:.4f}, {t['gemm'][1]:.4f}); routes differ by {diff:.3e}; "
              f"the gate (n <= {gate} fused) picks {pick}")
        if not diff <= REL_TOL:
            fail(f"the dense pass B's routes differ by {diff:.3e} at {label}")
        if ms[pick] > 1.05 * min(ms.values()):
            fail(f"the dense gate picks the {pick} route at {label}, slower than the other: {ms}")
        del h, proj, fns
        torch.cuda.empty_cache()
    return out


def card_line(query="name,power.limit"):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# --------------------------------------------------------------------------


def kernel_cases(n):
    """{kernel name: [(label, kernel_fn, plain_fn), ...]} at size n; each
    fn returns a tuple of output tensors.  The first case of each kernel
    has the shapes and options the main path gives it.  At an n that is
    no multiple of 4 (RAGGED_N) only the stage kernels' cases."""
    import torch

    from ins_tpu_torch.ops import stage_kernels as sk
    from ins_tpu_torch.ops.poisson_kernels import make_fused_projection

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
    # one plane-transform GEMM pass: 2 n^4 FLOP (the stages' default
    # bf16x3 form, as `GEMM_BF16X3_AS_FP32` counts them)
    cells, gemm = n**3, 2.0 * n**4 * GEMM_BF16X3_AS_FP32
    mats = (Vinv, VinvT, proj["V"], proj["VT"])
    # the LES stage: the force of a theta on the card, and a body force
    theta = torch.full((1,), LES_THETA, device=dev)
    smag = (theta, 3 * dxs[0] ** 2)
    bf = field(3, n, n, n)
    les = dict(based, smag=smag)
    # the temperature stream: T, its tableau base and accumulator
    T, Ts, Ta = field(n, n, n), field(n, n, n), field(n, n, n)

    def temp(gdir, tstart=None, tacc=None, dis=1.0):
        return (T, tstart, tacc, gdir, 1.0, TEMP_ALPHA4, dis)

    temp_ops = OPS_PER_CELL["stage_temp"] * cells

    def kt(cnew, cu, tb, tab):
        """The temperature update itself, kt, from temp_next and tempnew
        (the last two outputs): c·kt is ~1e-2 of T, so the outputs alone
        would hide an error of a few percent in kt."""
        return lambda o: ((o[-2] - tb) / cnew, (o[-1] - tab) / cu)
    cases = {
        # the Boussinesq stages (the main path's stages 1-2 first)
        "pcmsd_hat_3d+temp": [
            Case("stream base + usnew_base + tstart + tacc, gdir 2, dissipation",
                 pcmsd(sk.pcmsd_hat_3d, (ustart,), (dt / 2,), temperature=temp(2, Ts, Ta),
                       **based),
                 pcmsd(sk.pcmsd_hat_3d_plain, (ustart,), (dt / 2,),
                       temperature=temp(2, Ts, Ta), **based),
                 inputs=(ut_prev, qhat, ustart, accb, T, Ts, Ta, *mats),
                 ops=(OPS_PER_CELL["stage"] * cells + temp_ops + 4 * gemm),
                 derived=kt(dt / 2, dt / 3, Ts, Ta)),
            Case("RECON + emit_u + usnew, T elided, gdir 2, dissipation",
                 pcmsd(sk.pcmsd_hat_3d, (sk.RECON,), (dt / 2,), temperature=temp(2), **recon),
                 pcmsd(sk.pcmsd_hat_3d_plain, (sk.RECON,), (dt / 2,), temperature=temp(2),
                       **recon),
                 inputs=(ut_prev, qhat, T, *mats),
                 ops=(OPS_PER_CELL["stage"] * cells + temp_ops + 4 * gemm),
                 derived=kt(dt / 2, dt / 6, T, T)),
            Case("stream base + usnew_base + tstart + tacc, gdir 1, no dissipation",
                 pcmsd(sk.pcmsd_hat_3d, (ustart,), (dt / 2,),
                       temperature=temp(1, Ts, Ta, None), **based),
                 pcmsd(sk.pcmsd_hat_3d_plain, (ustart,), (dt / 2,),
                       temperature=temp(1, Ts, Ta, None), **based),
                 inputs=(ut_prev, qhat, ustart, accb, T, Ts, Ta, *mats),
                 ops=(OPS_PER_CELL["stage"] * cells + temp_ops + 4 * gemm),
                 derived=kt(dt / 2, dt / 3, Ts, Ta)),
            # the force and temperature streams together (no main path here)
            Case("stream base + usnew_base + tstart + tacc + bodyforce, gdir 1, dissipation",
                 pcmsd(sk.pcmsd_hat_3d, (ustart,), (dt / 2,), temperature=temp(1, Ts, Ta),
                       bodyforce=bf, **based),
                 pcmsd(sk.pcmsd_hat_3d_plain, (ustart,), (dt / 2,),
                       temperature=temp(1, Ts, Ta), bodyforce=bf, **based),
                 inputs=(ut_prev, qhat, ustart, accb, bf, T, Ts, Ta, *mats),
                 ops=(OPS_PER_CELL["stage"] * cells + temp_ops + 4 * gemm),
                 derived=kt(dt / 2, dt / 3, Ts, Ta)),
        ],
        "momentum_stage_divhat_3d+temp": [
            Case("stage 0: T elided + usnew, gdir 0, dissipation",
                 msd(sk.momentum_stage_divhat_3d, (ut_prev,), (dt / 2,), emit_k=False,
                     usnew_coeff=dt / 6, temperature=temp(0)),
                 msd(sk.momentum_stage_divhat_3d_plain, (ut_prev,), (dt / 2,), emit_k=False,
                     usnew_coeff=dt / 6, temperature=temp(0)),
                 inputs=(ut_prev, T, Vinv, VinvT),
                 ops=OPS_PER_CELL["stage_norebuild"] * cells + temp_ops + 2 * gemm,
                 derived=kt(dt / 2, dt / 6, T, T)),
            # the no-REBUILD FORCE + TEMP variant (no main path here)
            Case("stage 0: T elided + usnew + smag + bodyforce, gdir 2, dissipation",
                 msd(sk.momentum_stage_divhat_3d, (ut_prev,), (dt / 2,), emit_k=False,
                     usnew_coeff=dt / 6, temperature=temp(2), smag=smag, bodyforce=bf),
                 msd(sk.momentum_stage_divhat_3d_plain, (ut_prev,), (dt / 2,), emit_k=False,
                     usnew_coeff=dt / 6, temperature=temp(2), smag=smag, bodyforce=bf),
                 derived=kt(dt / 2, dt / 6, T, T)),
        ],
        "pcmsd_hat_3d": [
            Case("stream base + usnew_base",
                 pcmsd(sk.pcmsd_hat_3d, (ustart,), (dt / 2,), **based),
                 pcmsd(sk.pcmsd_hat_3d_plain, (ustart,), (dt / 2,), **based),
                 inputs=(ut_prev, qhat, ustart, accb, *mats),
                 ops=OPS_PER_CELL["stage"] * cells + 4 * gemm),
            Case("RECON + emit_u + usnew",
                 pcmsd(sk.pcmsd_hat_3d, (sk.RECON,), (dt / 2,), **recon),
                 pcmsd(sk.pcmsd_hat_3d_plain, (sk.RECON,), (dt / 2,), **recon)),
        ],
        # the LES stages (the main path's stages 1-2 first): the force
        # kernel on the rebuilt u, then the stage with its force stream.
        # The bound is the JAX package's fused kernel's, which forms the
        # force inside the stage (the same bytes as without it).
        "pcmsd_hat_3d+smag": [
            Case("stream base + usnew_base + smag",
                 pcmsd(sk.pcmsd_hat_3d, (ustart,), (dt / 2,), **les),
                 pcmsd(sk.pcmsd_hat_3d_plain, (ustart,), (dt / 2,), **les),
                 inputs=(ut_prev, qhat, ustart, accb, *mats),
                 ops=(OPS_PER_CELL["stage"] + OPS_PER_CELL["smag"]) * cells + 4 * gemm),
            Case("RECON + emit_u + usnew + smag + bodyforce",
                 pcmsd(sk.pcmsd_hat_3d, (sk.RECON,), (dt / 2,), smag=smag, bodyforce=bf,
                       **recon),
                 pcmsd(sk.pcmsd_hat_3d_plain, (sk.RECON,), (dt / 2,), smag=smag,
                       bodyforce=bf, **recon)),
            Case("stream base + usnew_base + bodyforce",
                 pcmsd(sk.pcmsd_hat_3d, (ustart,), (dt / 2,), bodyforce=bf, **based),
                 pcmsd(sk.pcmsd_hat_3d_plain, (ustart,), (dt / 2,), bodyforce=bf, **based)),
            # k = f carries the force at full weight (elsewhere it enters
            # through coefficients of dt/6 to dt/2 only)
            Case("stream base + emit_k + bodyforce",
                 pcmsd(sk.pcmsd_hat_3d, (ustart,), (dt / 2,), bodyforce=bf),
                 pcmsd(sk.pcmsd_hat_3d_plain, (ustart,), (dt / 2,), bodyforce=bf)),
        ],
        "momentum_stage_divhat_3d": [
            Case("stage 0 (u base) + usnew",
                 msd(sk.momentum_stage_divhat_3d, (ut_prev,), (dt / 2,),
                     emit_k=False, usnew_coeff=dt / 6),
                 msd(sk.momentum_stage_divhat_3d_plain, (ut_prev,), (dt / 2,),
                     emit_k=False, usnew_coeff=dt / 6),
                 inputs=(ut_prev, Vinv, VinvT),
                 ops=OPS_PER_CELL["stage_norebuild"] * cells + 2 * gemm),
            Case("k stream + emit_k",
                 msd(sk.momentum_stage_divhat_3d, (ustart, k1), (0.3 * dt, dt / 2)),
                 msd(sk.momentum_stage_divhat_3d_plain, (ustart, k1), (0.3 * dt, dt / 2))),
            Case("stage 0 + usnew + smag + bodyforce",
                 msd(sk.momentum_stage_divhat_3d, (ut_prev,), (dt / 2,), emit_k=False,
                     usnew_coeff=dt / 6, smag=smag, bodyforce=bf),
                 msd(sk.momentum_stage_divhat_3d_plain, (ut_prev,), (dt / 2,), emit_k=False,
                     usnew_coeff=dt / 6, smag=smag, bodyforce=bf)),
            Case("k stream + emit_k + smag",
                 msd(sk.momentum_stage_divhat_3d, (ustart, k1), (0.3 * dt, dt / 2), smag=smag),
                 msd(sk.momentum_stage_divhat_3d_plain, (ustart, k1), (0.3 * dt, dt / 2),
                     smag=smag)),
            Case("k stream + emit_k + bodyforce",
                 msd(sk.momentum_stage_divhat_3d, (ustart, k1), (0.3 * dt, dt / 2),
                     bodyforce=bf),
                 msd(sk.momentum_stage_divhat_3d_plain, (ustart, k1), (0.3 * dt, dt / 2),
                     bodyforce=bf)),
        ],
    }
    if n % 4:  # a ragged cube (RAGGED_N): the stage cases only
        return cases
    return {
        **cases,
        # the cube with the dense route forced first; with 256³ the dense
        # route's own shapes
        "passB": [dense_case(n, n, 0)]
        + ([dense_case(*c) for c in DENSE_EXTRA] if n == 256 else []),
        # one level first (the main path's), two; with 256³ the other cubes
        "passB_fold": [fold_case(n, 1, n, 0), fold_case(n, 2, n, 0)]
        + ([fold_case(*c) for c in FOLD_EXTRA_CUBES] if n == 256 else []),
        "pressure_correct_qhat_3d": [
            Case("ut, qhat -> u",
                 lambda: (sk.pressure_correct_qhat_3d(ut_prev, qhat, dxs, proj["V"], proj["VT"]),),
                 lambda: (sk.pressure_correct_qhat_3d_plain(ut_prev, qhat, dxs, proj["V"],
                                                            proj["VT"]),),
                 inputs=(ut_prev, qhat, proj["V"], proj["VT"]),
                 ops=OPS_PER_CELL["correct"] * cells + 2 * gemm),
        ],
        "plane_transform": transform_cases(n, divhat, proj),
    }


def with_tf32(fn):
    """fn with TF32 allowed in matmuls (PyTorch's "high" float32
    precision) and in cuDNN's convolutions."""
    import torch

    def run():
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            return fn()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    return run


def transform_cases(n, f, proj, precision="highest"):
    """The plane transform at the shapes the paths give it: the z+y and x
    products on the cube (f, the projection proj), the inverse z/y
    transform (y first in bf16x3), on a 4-way x-slab shard's block (r =
    n/4) and its pass B's (n, n/4, n) y-slice, at the first fold level
    (R_o, n/2 x n/2, on an (n/2, n, n) block) and at a ragged n - 6 (n % 4
    = 2: 4-byte staging).  "highest" (3xTF32 on the tensor cores): each is
    held against the float64 product (the float32 class, 1e-6) and its
    plain version (1e-4); "manualhigh" (bf16x3): `BF16X3_CLASS_TOL` and
    `BF16X3_PLAIN_TOL`.  Each beside one FP32 einsum/matmul and the same
    call with TF32 allowed."""
    import torch

    from ins_tpu_torch.ops.poisson_kernels import make_fused_projection
    from ins_tpu_torch.ops.transforms import (
        x_transform, x_transform_plain, yz_transform, yz_transform_plain,
    )

    rng = np.random.default_rng(SEED + 7 * n)

    def field(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(f.device)

    p = precision
    bf = p == "manualhigh"
    tol = dict(tol=BF16X3_CLASS_TOL if bf else TF32_CLASS_TOL,
               plain_tol=BF16X3_PLAIN_TOL if bf else REL_TOL, peak="bf16" if bf else "tf32")

    def yz(label, g, my, mzT, inverse=False):
        r, m = g.shape[0], g.shape[-1]
        lib = lambda: torch.einsum("yj,xjk,kl->xyl", my, g, mzT)  # noqa: E731
        return Case(label, lambda: (yz_transform(g, my, mzT, p, inverse),),
                    lambda: (yz_transform_plain(g, my, mzT, p, inverse),),
                    ref=lambda: (yz_transform_plain(g.double(), my.double(), mzT.double()),),
                    inputs=(g, my, mzT), ops=3 * 4.0 * r * m**3, library=lib,
                    library_tf32=with_tf32(lib), **tol)

    def x(label, mx, h):
        r, a, b = h.shape
        lib = lambda: torch.matmul(mx, h.view(r, a * b))  # noqa: E731
        return Case(label, lambda: (x_transform(mx, h, p),),
                    lambda: (x_transform_plain(mx, h, p),),
                    ref=lambda: (x_transform_plain(mx.double(), h.double()),),
                    inputs=(mx, h), ops=3 * 2.0 * mx.shape[0] * r * a * b, library=lib,
                    library_tf32=with_tf32(lib), **tol)

    m = n - 6
    ragged = make_fused_projection((m,) * 3, (2 * np.pi / m,) * 3, torch.float32, precision=p,
                                   device=f.device)
    fr = field(m, m, m)
    return [
        yz("Vinv_y . f . Vinv_z^T", f, proj["Vinv"], proj["VinvT"]),
        x("V_x . f", proj["V"], f),
        yz("V_y . qhat . V_z^T (inverse)", f, proj["V"], proj["VT"], inverse=True),
        yz(f"shard block (r = {n // 4})", f[:n // 4], proj["V"], proj["VT"]),
        x(f"shard y-slice ({n}, {n // 4}, {n})", proj["Vinv"], field(n, n // 4, n)),
        x(f"fold level 0: R_o ({n // 2} x {n // 2}) on ({n // 2}, {n}, {n})",
          proj["fold_mats"][0], field(n // 2, n, n)),
        yz(f"ragged n = {m}", fr, ragged["Vinv"], ragged["VinvT"]),
        x(f"ragged n = {m}: V_x . f", ragged["Vinv"], fr),
    ]


def training_kernel_cases(n):
    """{kernel name: [(label, kernel_fn, plain_fn[, reference_fn]), ...]}
    for the per-op and conv kernels of the training path and the closure
    run's 3-pass solve at size n (unit cube; first case: the main path's
    shapes and types; the conv cases take a float32 output, see the
    module docstring).  A reference_fn, where given, is what the error
    is measured against; plain_fn is timed."""
    import torch
    import torch.nn.functional as F

    from ins_tpu_torch.ops import conv_kernels as ck
    from ins_tpu_torch.ops import perop_kernels as pk
    from ins_tpu_torch.ops.dft import make_poisson_mm
    from ins_tpu_torch.ops.poisson_kernels import make_fused_projection, make_poisson_pallas

    rng = np.random.default_rng(SEED + 7 * n)
    dev = torch.device(DEVICE)

    def field(*shape, scale=1.0):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(dev)

    dxs = (1.0 / n,) * 3
    visc = 1.0 / 2000.0
    dt = 5e-4
    u, k1 = field(3, n, n, n), field(3, n, n, n)
    q = field(n, n, n, scale=1e-3)
    # a non-cube box with ragged tiles in y and z
    box = (n // 2, n - 24, n + 8)
    ub, kb, qb = field(3, *box), field(3, *box), field(*box, scale=1e-3)
    dxb = (1.0 / box[0], 1.0 / box[1], 1.0 / box[2])
    cells = n**3
    # the conv-diff also on `convdiff_box(n)` (nz % 4 != 0: its 4-byte
    # staging, ragged y), each case against the plain version in float64
    cbox = convdiff_box(n)
    uc = field(3, *cbox)
    dxc = tuple(1.0 / v for v in cbox)

    def convdiff(uu, dd, label):
        return Case(label, lambda: (pk.convdiff_interior_3d(uu, visc, dd),),
                    lambda: (pk.convdiff_interior_3d_plain(uu, visc, dd),),
                    ref=lambda: (pk.convdiff_interior_3d_plain(uu.double(), visc, dd),),
                    plain_tol=REL_TOL, inputs=(uu,),
                    ops=OPS_PER_CELL["convdiff"] * uu[0].numel())

    cases = {
        "convdiff_interior_3d": [
            convdiff(u, dxs, "u"),
            convdiff(ub, dxb, f"box {box}"),
            convdiff(uc, dxc, f"box {cbox} (nz % 4 != 0)"),
        ],
        "stage_div_3d": [
            Case("base + dt/2 k", lambda: pk.stage_div_3d(u, k1, dt / 2, dxs),
                 lambda: pk.stage_div_3d_plain(u, k1, dt / 2, dxs),
                 inputs=(u, k1), ops=OPS_PER_CELL["stage_div"] * cells),
            Case(f"box {box}", lambda: pk.stage_div_3d(ub, kb, dt, dxb),
                 lambda: pk.stage_div_3d_plain(ub, kb, dt, dxb)),
        ],
        "pressure_correct_3d": [
            Case("ut, q", lambda: (pk.pressure_correct_3d(u, q, dxs),),
                 lambda: (pk.pressure_correct_3d_plain(u, q, dxs),),
                 inputs=(u, q), ops=OPS_PER_CELL["correct"] * cells),
            Case(f"box {box}", lambda: (pk.pressure_correct_3d(ub, qb, dxb),),
                 lambda: (pk.pressure_correct_3d_plain(ub, qb, dxb),)),
        ],
        "fusedconv_3d": [],
        "fusedconv_wgrad_3d": [],
        "fusedconv_3d+f32": [],
        "fusedconv_wgrad_3d+f32": [],
    }
    # the closure run's 3-pass solve: passes A and C (two plane GEMMs of
    # 2 n^4 each) and the folded pass B
    proj = make_fused_projection((n,) * 3, dxs, torch.float32, device=dev)
    solve = {k: make_poisson_pallas((n,) * 3, dxs, torch.float32, device=dev, plain=k)
             for k in (False, True)}
    solve_mm = make_poisson_mm((n,) * 3, dxs, torch.float32, dev)
    f = field(n, n, n)
    cases["make_poisson_pallas"] = [
        Case(f"f -> p, pass B folded {proj['fold_levels']} level, bf16x3 (the default)",
             lambda: (solve[False](f),), lambda: (solve[True](f),),
             inputs=(f, proj["Vinv"], proj["VinvT"], proj["V"], proj["VT"],
                     *proj["fold_mats"]),
             ops=4 * 2.0 * n**4 * GEMM_BF16X3_AS_FP32
             + fold_ops(n, proj["fold_levels"], "manualhigh"),
             library=lambda: solve_mm(f)),
    ]
    # the closure's layers: (cin, cout, act, bias); k = 5.  bf16 operands
    # run the bf16 tensor-core kernels, float32 ones the 3xTF32 kernels
    # ("+f32"), bound by three TF32 products a multiply-add; those are held
    # against the plain version in float64 (the float32 class) and within
    # 1e-4 of the float32 one (cuDNN, TF32 off), and cuDNN is timed with
    # TF32 off and on
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        tag, sfx = ("f32", "+f32") if f32 else ("bf16", "")
        peak, tf32_ops = ("tf32", 3) if f32 else ("bf16", 1)
        for cin, cout, act, has_bias in CONV_LAYERS:
            h = field(n, n, n, cin).to(dtype)
            w = field(5, 5, 5, cin, cout, scale=(125 * cin) ** -0.5)
            b = field(cout, scale=0.1) if has_bias else None
            d = field(n, n, n, cout).to(dtype)
            wf = ck.flip_taps(w)
            ops = tf32_ops * 2 * 125 * cin * cout * cells

            # the library yardsticks: cuDNN on the circularly padded input in
            # the operands' dtype (the pads made once, outside the timing)
            hp, dp = (F.pad(t.permute(3, 0, 1, 2).unsqueeze(0), (2,) * 6, mode="circular")
                      for t in (h, d))
            wt, wft = (t.permute(4, 3, 0, 1, 2).to(dtype).contiguous() for t in (w, wf))
            bt = None if b is None else b.to(dtype)
            dt_ = d.permute(3, 0, 1, 2).unsqueeze(0)

            def lib(fn):
                return dict(library=fn, library_tf32=with_tf32(fn) if f32 else None)

            def exact(fn):  # the float64 reference of a float32 case
                return dict(ref=fn, tol=CONV_TF32_TOL, plain_tol=REL_TOL) if f32 else {}

            cases["fusedconv_3d" + sfx] += [
                Case(f"{cin}->{cout} {act}{'+bias' if has_bias else ''} {tag}",
                     conv_fwd(ck.fusedconv_3d, h, w, b, act),
                     conv_fwd(ck.fusedconv_3d_plain, h, w, b, act),
                     inputs=(h, w, b), ops=ops, peak=peak,
                     **lib(lambda hp=hp, wt=wt, bt=bt: F.conv3d(hp, wt, bt)),
                     **exact(conv_fwd(ck.fusedconv_3d_plain, h, w, b, act, exact=True))),
                # the input gradient the backward pass takes
                Case(f"dh {cout}->{cin} flipped taps {tag}",
                     conv_fwd(ck.fusedconv_3d, d, wf),
                     conv_fwd(ck.fusedconv_3d_plain, d, wf),
                     inputs=(d, wf), ops=ops, peak=peak,
                     **lib(lambda dp=dp, wft=wft: F.conv3d(dp, wft)),
                     **exact(conv_fwd(ck.fusedconv_3d_plain, d, wf, exact=True))),
            ]
            # cuDNN's float32 weight gradient (the plain version's) is itself
            # ~7e-5 off the float64 sum at 128³, so the kernel is held
            # against the plain version evaluated in float64
            cases["fusedconv_wgrad_3d" + sfx] += [
                Case(f"dw {cin}x{cout} {tag}", conv_wgrad(ck.fusedconv_wgrad_3d, h, d, 5),
                     conv_wgrad(ck.fusedconv_wgrad_3d_plain, h, d, 5),
                     ref=conv_wgrad(ck.fusedconv_wgrad_3d_plain, h, d, 5, exact=True),
                     inputs=(h, d), ops=ops, peak=peak,
                     **lib(lambda hp=hp, dt_=dt_, cin=cin, cout=cout:
                           torch.nn.grad.conv3d_weight(hp, (cout, cin, 5, 5, 5), dt_)),
                     **(dict(tol=CONV_TF32_TOL, plain_tol=REL_TOL) if f32 else {})),
            ]
    # both routes at every k on the ragged box, the three layers and their
    # input-gradient forms (and wider layers: two input chunks and two
    # output blocks; 16-channel chunks and two n8 tiles), with a bf16 and a
    # float32 output, held against the plain version in float64 (rounded
    # to the output's dtype): cuDNN's float32 sum is itself off by more than
    # a bf16 ulp of the small outputs at k = 5 and 7.  Float32 operands: a
    # float32 output within 1e-5 of it and 1e-4 of the float32 plain
    # version; a bf16 output within one bf16 ulp plus 1e-5 of max|ref| (the
    # float32 class: near zero a sum of 8232 products at k = 7 rounds either
    # way, as the float32 plain version's does)
    ragged = [(k, layer) for k in (3, 5, 7) for layer in CONV_LAYERS] + [
        (3, (40, 40, "tanh", True)), (5, (16, 13, "id", False))]
    for dtype in (torch.bfloat16, torch.float32):
        sfx = "+f32" if dtype == torch.float32 else ""
        for k, (cin, cout, act, has_bias) in ragged:
            h, w, b, d = conv_operands(field, box, cin, cout, k, has_bias, dtype)
            wf = ck.flip_taps(w)
            for odt in (torch.bfloat16, torch.float32):
                otag = "bf16" if odt == torch.bfloat16 else "f32"
                tols = {} if not sfx else (dict(tol=CONV_TF32_TOL, plain_tol=REL_TOL)
                                           if odt == torch.float32
                                           else dict(ulp_floor=CONV_TF32_TOL))
                cases["fusedconv_3d" + sfx] += [
                    Case(f"{cin}->{cout} k={k} box {box} out {otag}",
                         conv_fwd(ck.fusedconv_3d, h, w, b, act, odt),
                         conv_fwd(ck.fusedconv_3d_plain, h, w, b, act, odt),
                         ref=conv_fwd(ck.fusedconv_3d_plain, h, w, b, act, odt, exact=True),
                         time=False, **tols),
                    Case(f"dh {cout}->{cin} k={k} box {box} out {otag}",
                         conv_fwd(ck.fusedconv_3d, d, wf, out_dtype=odt),
                         conv_fwd(ck.fusedconv_3d_plain, d, wf, out_dtype=odt),
                         ref=conv_fwd(ck.fusedconv_3d_plain, d, wf, out_dtype=odt, exact=True),
                         time=False, **tols),
                ]
            cases["fusedconv_wgrad_3d" + sfx] += [
                Case(f"dw {cin}x{cout} k={k} box {box}",
                     conv_wgrad(ck.fusedconv_wgrad_3d, h, d, k),
                     conv_wgrad(ck.fusedconv_wgrad_3d_plain, h, d, k),
                     ref=conv_wgrad(ck.fusedconv_wgrad_3d_plain, h, d, k, exact=True),
                     time=False,
                     **(dict(tol=CONV_TF32_TOL, plain_tol=REL_TOL) if sfx else {})),
            ]
    return cases


def convdiff_box(n):
    """The conv-diff's ragged box at n: nz % 4 == 3 (the kernel's 4-byte
    staging) and ny a multiple of its 16-row tile plus 5."""
    return (n // 2 - 3, n - 27, n - 21)


# the closure's conv layers: (cin, cout, act, bias)
CONV_LAYERS = ((24, 24, "tanh", True), (3, 24, "tanh", True), (24, 3, "id", False))


def conv_operands(field, box, cin, cout, k, has_bias, dtype=None):
    """(h, w, b, d) of a (cin -> cout, k) layer on `box`: h and d in
    `dtype` (bf16 by default), w and b float32, w scaled by
    1/sqrt(fan-in)."""
    import torch

    dtype = dtype or torch.bfloat16
    h = field(*box, cin).to(dtype)
    w = field(k, k, k, cin, cout, scale=(k**3 * cin) ** -0.5)
    b = field(cout, scale=0.1) if has_bias else None
    return h, w, b, field(*box, cout).to(dtype)


def conv_fwd(impl, h, w, b=None, act=None, out_dtype=None, exact=False):
    """A case function: the fused conv layer ``impl`` (kernel or plain
    version) with a float32 output unless `out_dtype` says otherwise;
    `exact`: the plain version on the same rounded values in float64."""
    import torch

    odt = out_dtype or torch.float32
    if exact:
        return lambda: (impl(h.double(), w.to(h.dtype).double(), b, act, out_dtype=odt),)
    return lambda: (impl(h, w, b, act, out_dtype=odt),)


def conv_wgrad(impl, h, d, k, exact=False):
    """A case function: the weight gradient ``impl``; `exact`: the plain
    version on the same values in float64."""
    if exact:
        return lambda: (impl(h.double(), d.double(), k),)
    return lambda: (impl(h, d, k),)


def check_wgrad_repeatable(n):
    """Two calls of the weight-gradient kernel give the same bits, for bf16
    and float32 operands, on the cube at k = 5 and on the ragged box at k =
    3, 5 and 7."""
    import torch

    from ins_tpu_torch.ops import conv_kernels as ck

    rng = np.random.default_rng(SEED + 11 * n)

    def field(*shape, scale=1.0):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(DEVICE)

    box = (n // 2, n - 24, n + 8)
    for dtype in (torch.bfloat16, torch.float32):
        for shape, ks in (((n, n, n), (5,)), (box, (3, 5, 7))):
            for k in ks:
                for cin, cout, _, _ in CONV_LAYERS:
                    h, _, _, d = conv_operands(field, shape, cin, cout, k, False, dtype)
                    first = ck.fusedconv_wgrad_3d(h, d, k)
                    second = ck.fusedconv_wgrad_3d(h, d, k)
                    if not torch.equal(first, second):
                        diff = (first - second).abs().max().item()
                        fail(f"fusedconv_wgrad_3d {cin}x{cout} k={k} {dtype} on {shape}: two "
                             f"calls differ by {diff:.3e}")
    print(f"[kernels] n={n} fusedconv_wgrad_3d: two calls bit-identical on {(n,) * 3} (k=5) "
          f"and on {box} (k=3, 5, 7), each layer, bf16 and float32 operands")


def conv_gflop(label, n):
    """GFLOP of a conv case (2 per multiply-add, k = 5) from its label."""
    dims = label.split()[1 if label.startswith("d") else 0]
    sep = "x" if label.startswith("dw") else "->"
    cin, cout = (int(v) for v in dims.split(sep))
    return 2 * 125 * cin * cout * n**3 / 1e9


def phase_kernels(cases_fn, sizes, time_all=(), time_at=None):
    """Hold every case of `cases_fn(n)` against its plain version at each
    size; time the first case of each kernel (every case of the kernels
    in `time_all`) at the largest size (or ``time_at``), kernel and plain
    in turns, beside its bound and its library yardstick where it has
    them."""
    import torch

    results = {}
    for n in sizes:
        for name, cases in cases_fn(n).items():
            r = results.setdefault(name, {"max_abs_err": 0.0})
            out_bytes = {}
            for c in cases:
                got, ref = c.kfn(), (c.ref or c.pfn)()
                torch.cuda.synchronize()
                if len(got) != len(ref):
                    fail(f"{name} [{c.label}]: {len(got)} outputs, plain gives {len(ref)}")
                out_bytes[c.label] = nbytes(got)
                if not c.ref and any(g.dtype != p.dtype for g, p in zip(got, ref)):
                    fail(f"{name} [{c.label}]: output dtypes {[g.dtype for g in got]}, plain "
                         f"gives {[p.dtype for p in ref]}")
                # a bf16 output: within one bf16 ulp elementwise (ratio to it <= 1)
                bf = [g.dtype == torch.bfloat16 for g in got]
                errs = [ulp_ratio(g, p, c.ulp_floor) if b else rel_err(g.to(p.dtype), p)
                        for g, p, b in zip(got, ref, bf)]
                if c.derived:
                    errs += [rel_err(g, p) for g, p in zip(c.derived(got), c.derived(ref))]
                    bf += [False] * (len(errs) - len(bf))
                bounds = [1.0 if b else c.tol for b in bf]
                r["max_abs_err"] = max(
                    r["max_abs_err"], *(abs_err(g.to(p.dtype), p) for g, p in zip(got, ref))
                )
                extra = ""
                if c.ref:
                    plain = c.pfn()

                    def off(a, p):  # bf16 ulps for a bf16 output, else relative
                        if p.dtype == torch.bfloat16:
                            return f"{ulp_ratio(a, p, c.ulp_floor):.3f} bf16 ulp"
                        return f"{rel_err(a.to(p.dtype), p):.3e}"

                    extra = ("; the float32 plain version is off that reference by "
                             + ", ".join(off(q, p) for q, p in zip(plain, ref))
                             + ", the kernel off it by "
                             + ", ".join(off(g, q) for g, q in zip(got, plain)))
                    if c.plain_tol is not None:
                        perr = [rel_err(g, q) for g, q in zip(got, plain)]
                        if not all(math.isfinite(e) and e <= c.plain_tol for e in perr):
                            fail(f"{name} [{c.label}] at n={n}: {perr} from the plain version, "
                                 f"above {c.plain_tol}")
                print(f"[kernels] n={n} {name} [{c.label}]: max rel err per output "
                      + ", ".join(f"{e:.3f} bf16 ulp" if b else f"{e:.3e}"
                                  for e, b in zip(errs, bf))
                      + (" (against the plain version in float64)" if c.ref else "")
                      + (" (the last: the update from each)" if c.derived else "") + extra)
                if not all(math.isfinite(e) and e <= b for e, b in zip(errs, bounds)):
                    fail(f"{name} [{c.label}] at n={n}: errors {errs} above {bounds}")
                del got, ref
            if n != (time_at or max(sizes)):
                continue
            for i, c in enumerate(cases):
                if i and name not in time_all:
                    break
                if not c.time:
                    continue
                p1 = cuda_ms(c.pfn)
                k1 = cuda_ms(c.kfn)
                k2 = cuda_ms(c.kfn)
                p2 = cuda_ms(c.pfn)
                ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
                extra = ""
                if c.inputs:
                    bms, by = bound(c, out_bytes[c.label])
                    lib = None
                    if c.library is not None:
                        lib = (cuda_ms(c.library) + cuda_ms(c.library)) / 2
                    extra = (f"; bound {bms:.4f} ms ({by}, "
                             f"{(nbytes(c.inputs) + out_bytes[c.label]) / 1e6:.1f} MB, "
                             f"{c.ops / 1e9:.2f} GOP {c.peak}), library "
                             + ("none" if lib is None else f"{lib:.4f} ms"))
                    if c.library_tf32 is not None:
                        lib_tf32 = (cuda_ms(c.library_tf32) + cuda_ms(c.library_tf32)) / 2
                        extra += f", with TF32 allowed {lib_tf32:.4f} ms"
                        if i == 0:
                            r["library_tf32_ms"] = lib_tf32
                    if i == 0:
                        r.update(bound_ms=bms, bound_by=by, library_ms=lib)
                how = ""
                if name in DEVICE_TIMED:
                    # back-to-back launches of a kernel this short run at the
                    # host's launch rate: its own time is the profiler's
                    dms = device_ms(c.kfn)
                    if dms:
                        ms, how = dms, "device (profiler); events "
                if i == 0:
                    r["ms"], r["plain_ms"] = ms, plain_ms
                if name.startswith("plane_transform"):
                    gf = c.ops / 3e9  # the GEMMs' FLOP (three TF32 or bf16 products each)
                    extra += f"; {gf:.2f} GFLOP: {gf / ms:.2f} TFLOP/s"
                if name.startswith("fusedconv") or ("conv" in name and c.ops):
                    # GFLOP of the convolution (3xTF32 does three TF32 products a
                    # multiply-add: its ops count them)
                    gf = (conv_gflop(c.label, n) if name.startswith("fusedconv")
                          else c.ops / (3e9 if c.peak == "tf32" else 1e9))
                    extra += (f"; {gf:.1f} GFLOP: {gf / ms:.2f} TFLOP/s kernel, "
                              f"{gf / plain_ms:.2f} plain")
                print(f"[kernels] n={n} {name} [{c.label}]: kernel {ms:.4f} ms "
                      f"({how}{k1:.4f}, {k2:.4f}), plain {plain_ms:.4f} ms ({p1:.4f}, {p2:.4f})"
                      + extra)
        torch.cuda.empty_cache()
    return results


# --------------------------------------------------------------------------
# phase 2: the main path
# --------------------------------------------------------------------------


def headline_setup(n, bodyforce=None, dtype=None, steady=True):
    import torch

    import ins_tpu_torch as it

    x = tuple(np.linspace(0.0, 2 * np.pi, n + 1) for _ in range(3))
    bc = ((it.PeriodicBC(), it.PeriodicBC()),) * 3
    return it.Setup(x=x, boundary_conditions=bc, Re=4000.0, dtype=dtype or torch.float32,
                    device=DEVICE, bodyforce=bodyforce, issteadybodyforce=steady)


def check_divergence(u, dx, tag, unscaled_tol=1e-3):
    """Volume-scaled max|div u| <= 1e-4·max|u|/dx and the unscaled
    residual max|div u|·dx/max|u| <= 1e-3 (uniform periodic cube;
    ``unscaled_tol`` for a u stored in bf16)."""
    import torch

    vol = dx**3
    div = sum((u[a] - torch.roll(u[a], 1, dims=a)) / dx for a in range(3)) * vol
    umax = u.abs().max().item()
    divmax = div.abs().max().item()
    print(f"[{tag}] max|div u| (volume-scaled) = {divmax:.3e}, bound 1e-4*max|u|/dx = "
          f"{1e-4 * umax / dx:.3e}; unscaled max|div u|*dx/max|u| = "
          f"{divmax / vol * dx / umax:.3e} (bound {unscaled_tol:.3e})")
    if not divmax <= 1e-4 * umax / dx:
        fail(f"{tag}: the result is not divergence-free")
    if not divmax / vol * dx / umax <= unscaled_tol:
        fail(f"{tag}: the unscaled divergence residual exceeds {unscaled_tol:.3e}")


def run_plain_chain(setup, method, state, dt, nsteps, chunk, at_chunk_end=None, theta=None,
                    fns=None, precision="manualhigh"):
    """The hat chain of the plain versions on the card in ``precision`` (or
    the chain ``fns``, a (to, step, from) triple), chunk by chunk as
    `solve_unsteady` runs it; ``at_chunk_end(state)`` sees each chunk's
    interior state."""
    from ins_tpu_torch.ops.fastpath import make_fast_timestep_hat

    to_hat, step_hat, from_hat = fns or make_fast_timestep_hat(
        setup, method, plain=True, projection_precision=precision)
    left = nsteps
    while left:
        c = min(chunk, left)
        h = to_hat(state)
        for _ in range(c):
            h = step_hat(h, dt, theta)
        state = from_hat(h)
        left -= c
        if at_chunk_end is not None:
            at_chunk_end(state)
    return state


def hat_ms_per_step(setup, method, s0, dt, steps=10, theta=None, precision="manualhigh"):
    """ms/step of the kernel and the plain hat chains in ``precision``, in
    turns (plain, kernels, kernels, plain), each after a warm-up of two
    steps (the second one on a rebuilding carry)."""
    from ins_tpu_torch.ops.fastpath import make_fast_timestep_hat

    return chains_ms_per_step({k: make_fast_timestep_hat(setup, method, plain=k == "plain",
                                                         projection_precision=precision)
                               for k in ("plain", "kernels")}, s0, dt, steps, theta)


def chains_ms_per_step(chains, s0, dt, steps=10, theta=None):
    """ms/step of two (to, step, from) chains in turns (a, b, b, a), each
    after a warm-up of two steps (the second one on a rebuilding carry)."""
    import torch

    a, b = chains
    times = {a: [], b: []}
    for which in (a, b, b, a):
        to, step, _ = chains[which]
        h = step(step(to(s0), dt, theta), dt, theta)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            h = step(h, dt, theta)
        torch.cuda.synchronize()
        times[which].append((time.perf_counter() - t) * 1e3 / steps)
        del h
    return times


def print_ms_per_step(tag, label, n, times):
    import torch

    ms_k, ms_p = sum(times["kernels"]) / 2, sum(times["plain"]) / 2
    print(f"[{tag}] hat chain {label}: kernels {ms_k:.3f} ms/step "
          f"({times['kernels'][0]:.3f}, {times['kernels'][1]:.3f}; "
          f"{n**3 / (ms_k * 1e-3):.4e} cell-updates/s), plain {ms_p:.3f} ms/step "
          f"({times['plain'][0]:.3f}, {times['plain'][1]:.3f}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card after the timing "
          f"(SM clock, power draw, temperature): "
          f"{card_line('clocks.sm,power.draw,temperature.gpu')}")


def phase_main_path(n, nsteps, chunk):
    import torch

    import ins_tpu_torch as it
    from ins_tpu_torch.ops import launches
    from ins_tpu_torch.ops.fastpath import strip_ghosts, strip_state

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
    counts = run_counts()
    plain = dict(launches.PLAIN_ON_CUDA)
    print(f"[main] solve_unsteady {n}^3 RK44 f32: {nsteps} steps in chunks of {chunk}, "
          f"{wall:.3f} s wall (first call included); launches {counts}; "
          f"plain calls on CUDA {plain}")
    if state.n != nsteps:
        fail(f"ran {state.n} steps, expected {nsteps}")
    u = strip_ghosts(state.u)
    if not bool(torch.isfinite(u).all()):
        fail("non-finite velocity after the run")
    missing = [k for k in hat_kernels() if counts[k] <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    if counts["passB_fold+levels"]:
        fail(f"pass B took the level route at {n}³ (the fused kernel's range)")
    if any(plain.values()):
        fail(f"plain versions ran on CUDA tensors in the kernel run: {plain}")

    check_divergence(u, float(setup.grid.delta[0][0]), "main")

    e0 = it.total_kinetic_energy(u0, setup).item()
    e1 = it.total_kinetic_energy(state.u, setup).item()
    print(f"[main] kinetic energy {e0:.9e} -> {e1:.9e}")
    if not e1 <= e0:
        fail("kinetic energy increased")

    # the same run through the plain chain on the card
    s0 = strip_state(it.create_stepper(method, setup=setup, u=u0))
    s = run_plain_chain(setup, method, s0, dt, nsteps, chunk)
    agree = rel_err(u, s.u)
    print(f"[main] kernel chain vs plain chain after {nsteps} steps: max rel diff {agree:.3e}")
    if not agree <= REL_TOL:
        fail(f"kernel and plain chains disagree by {agree:.3e} > {REL_TOL}")
    del s

    print_ms_per_step("main", f"{n}^3 RK44 f32", n, hat_ms_per_step(setup, method, s0, dt))
    return counts, setup, u0, dt, e1


def phase_dense_chain(n=DENSE_CHAIN_N, nsteps=20, chunk=10, precision="manualhigh"):
    """12: phase 2's run at n³ (n % 4 != 0: the dense pass B), through
    `solve_unsteady` in ``precision``; its launches (the fused dense pass
    B 4 a step, no fold, no GEMM route), divergence, energy, the plain
    chain's agreement and ms/step of both chains in turns.  Returns the
    launch counts."""
    import torch

    import ins_tpu_torch as it
    from ins_tpu_torch.ops import launches
    from ins_tpu_torch.ops.fastpath import strip_ghosts, strip_state

    setup = headline_setup(n)
    u0 = it.random_field(setup, kp=10, generator=torch.Generator(device=DEVICE).manual_seed(1))
    dt = 1e-3 * 128 / n
    method = it.RKMethods.RK44()
    torch.cuda.synchronize()
    launches.reset_counts()
    state, _ = it.solve_unsteady(
        setup=setup, ustart=u0, tlims=(0.0, nsteps * dt), dt=dt, method=method,
        psolver=it.psolver_spectral(setup), projection_precision=precision,
        processors={"log": it.timelogger(nupdate=chunk)},
    )
    torch.cuda.synchronize()
    counts = run_counts(precision)
    plain = dict(launches.PLAIN_ON_CUDA)
    print(f"[dense] solve_unsteady {n}^3 RK44 f32, {precision}: {nsteps} steps in chunks of "
          f"{chunk}; launches { {k: v for k, v in counts.items() if v} }; plain calls on CUDA "
          f"{ {k: v for k, v in plain.items() if v} }")
    if state.n != nsteps:
        fail(f"the {n}³ run ran {state.n} steps, expected {nsteps}")
    u = strip_ghosts(state.u)
    if not bool(torch.isfinite(u).all()):
        fail(f"non-finite velocity after the {n}³ run")
    keys = form_keys(precision)
    fold = {k: v for k, v in counts.items() if k.startswith("passB_") or k.endswith("+gemm")}
    want = {k: 0 for k in fold}
    if counts[keys["passB"]] != 4 * nsteps or fold != want:
        fail(f"the {n}³ run launched pass B {counts[keys['passB']]} times (expected "
             f"{4 * nsteps}), other pass B routes {fold}")
    missing = [k for k in hat_kernels(precision) if k != keys["passB_fold"] and counts[k] <= 0]
    if missing or any(plain.values()):
        fail(f"the {n}³ run: kernels never launched {missing}, plain versions on CUDA {plain}")
    check_divergence(u, float(setup.grid.delta[0][0]), "dense")
    e0 = it.total_kinetic_energy(u0, setup).item()
    e1 = it.total_kinetic_energy(state.u, setup).item()
    print(f"[dense] kinetic energy {e0:.9e} -> {e1:.9e}")
    if not e1 <= e0:
        fail(f"the {n}³ run's kinetic energy increased")
    s0 = strip_state(it.create_stepper(method, setup=setup, u=u0))
    s = run_plain_chain(setup, method, s0, dt, nsteps, chunk, precision=precision)
    agree = rel_err(u, s.u)
    print(f"[dense] kernel chain vs plain chain after {nsteps} steps: max rel diff {agree:.3e}")
    if not agree <= REL_TOL:
        fail(f"the {n}³ kernel and plain chains disagree by {agree:.3e} > {REL_TOL}")
    del s
    print_ms_per_step("dense", f"{n}^3 RK44 f32 (dense pass B), {precision}", n,
                      hat_ms_per_step(setup, method, s0, dt, precision=precision))
    return counts


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


# --------------------------------------------------------------------------
# phase 3: the training path
# --------------------------------------------------------------------------


def training_setup(n, closure_model=None):
    import torch

    import ins_tpu_torch as it

    x = tuple(np.linspace(0.0, 1.0, n + 1) for _ in range(3))
    return it.Setup(x=x, Re=2000.0, dtype=torch.float32, device=DEVICE,
                    closure_model=closure_model)


def build_training(setup, *, compute_dtype=None, plain=False):
    """(closure model, theta, loss) of `bench.py`'s grad-step case, the
    CNN's weights drawn from a fixed seed."""
    import ins_tpu_torch as it
    from ins_tpu_torch import models as nc

    closure, theta = closure_cnn(setup, compute_dtype, plain)
    m = nc.wrappedclosure(closure, setup)
    loss = nc.create_loss_post(
        setup=setup, method=it.RKMethods.RK44(), psolver=it.psolver_spectral(setup),
        closure_model=m, nsubstep=1, remat=True, plain=plain,
    )
    return m, theta, loss


def value_and_grad(loss, data, theta):
    import torch

    value = loss(data, theta)
    grads = torch.autograd.grad(value, list(theta.values()))
    torch.cuda.synchronize()
    return value.detach(), dict(zip(theta, grads))


def training_data(setup, nunroll):
    """Phase 3's trajectory: `random_field(kp=5)` from a fixed seed, scaled
    down 1 % a step over nunroll + 1 snapshots."""
    import torch

    import ins_tpu_torch as it

    u0 = it.random_field(setup, kp=5, generator=torch.Generator(device=DEVICE).manual_seed(3))
    return u0, [{"u": torch.stack([u0 * (1.0 - 0.01 * i) for i in range(nunroll + 1)]),
                 "t": torch.arange(nunroll + 1, dtype=torch.float64) * 5e-4}]


def step_turns(tag, runs, data):
    """Seconds per gradient step and peak memory of the `runs` {name:
    (loss, theta)} in turns (a, b, b, a); prints them, returns {name: s}."""
    import torch

    names = list(runs)
    times, peak = {k: [] for k in names}, {}
    for which in names + names[::-1]:
        lo, th = runs[which]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        value_and_grad(lo, data, th)
        times[which].append(time.perf_counter() - t0)
        peak[which] = torch.cuda.max_memory_allocated() / 2**30
    mean = {k: sum(v) / 2 for k, v in times.items()}
    print(f"[train] {card_line()}: s/gradient step, {tag}: " + ", ".join(
        f"{k} {mean[k]:.4f} ({times[k][0]:.4f}, {times[k][1]:.4f})" for k in names)
        + "; peak memory " + ", ".join(f"{k} {peak[k]:.2f} GiB" for k in names))
    return mean


# the fused conv layer's kernels (forward and dh, weight gradient and its
# fixed-order sum of partials) by name, both routes and the FP32 FMA
# kernels of trees before the 3xTF32 route
CONV_KERNEL_NAMES = ("conv_fwd", "wgrad_kernel", "wgrad_mma", "wgrad_tf32", "reduce_partials")


def profile_step(loss, data, theta):
    """(unprofiled wall s, kernel s, fused-conv kernel s, key_averages) of
    one gradient step, after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    value_and_grad(loss, data, theta)
    t0 = time.perf_counter()
    value_and_grad(loss, data, theta)
    wall = time.perf_counter() - t0  # without the profiler's host overhead
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        value_and_grad(loss, data, theta)
    events = prof.key_averages()
    cuda = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = sum(e.self_device_time_total for e in cuda) / 1e6
    conv = sum(e.self_device_time_total for e in cuda
               if any(s in e.key for s in CONV_KERNEL_NAMES)) / 1e6
    return wall, dev, conv, events


def phase_training(n, nunroll):
    import torch

    import ins_tpu_torch as it
    from ins_tpu_torch import models as nc
    from ins_tpu_torch.ops import launches
    from ins_tpu_torch.ops.fastpath import poisson_pallas_min_n, strip_ghosts

    setup = training_setup(n)
    u0, data = training_data(setup, nunroll)
    print(f"[train] {n}^3 RK44 Re=2000, CNN (2,2,2)/(24,24,3), {nunroll} unrolled "
          f"steps with remat")

    # 1. float32 convs (the 3xTF32 kernels, "+f32"): kernel run against the
    # plain run on the card
    runs, f32_runs = {}, {}
    for plain in (False, True):
        _, theta, loss = build_training(setup, compute_dtype=torch.float32, plain=plain)
        f32_runs["plain" if plain else "kernels"] = (loss, theta)
        launches.reset_counts()
        t0 = time.perf_counter()
        runs[plain] = value_and_grad(loss, data, theta)
        if not plain:
            f32_counts = {k: launches.LAUNCHES[k] for k in CONV_KEYS}
        print(f"[train] f32 convs, {'plain' if plain else 'kernels'}: loss "
              f"{runs[plain][0].item():.9e} ({time.perf_counter() - t0:.3f} s)")
    print(f"[train] f32 convs, kernels: conv launches {f32_counts}")
    if any(f32_counts[k] <= 0 for k in F32_CONV_KERNELS) or any(
            f32_counts[k] for k in CONV_KEYS if k not in F32_CONV_KERNELS):
        fail(f"the float32 run did not take the 3xTF32 conv kernels alone: {f32_counts}")
    (lk, gk), (lp, gp) = runs[False], runs[True]
    lrel = abs(lk.item() - lp.item()) / abs(lp.item())
    grel = {k: rel_l2(gk[k], gp[k]) for k in gk}
    print(f"[train] f32 kernels vs plain: loss rel {lrel:.3e} (bound {LOSS_TOL_F32}); "
          "grad rel L2 " + ", ".join(f"{k} {v:.3e}" for k, v in grel.items())
          + f" (bound {GRAD_TOL_F32})")
    if not (math.isfinite(lk.item()) and lrel <= LOSS_TOL_F32):
        fail(f"f32 loss: kernels vs plain {lrel:.3e} > {LOSS_TOL_F32}")
    if not all(math.isfinite(v) and v <= GRAD_TOL_F32 for v in grel.values()):
        fail(f"f32 gradient: kernels vs plain {grel} > {GRAD_TOL_F32}")
    step_turns("f32 convs", f32_runs, data)
    del runs, f32_runs

    # 2. the default bf16 convs: the slice's main path
    _, theta, loss = build_training(setup)
    launches.reset_counts()
    lb, gb = value_and_grad(loss, data, theta)
    counts = run_counts()
    plain_calls = dict(launches.PLAIN_ON_CUDA)
    print(f"[train] bf16 convs, kernels: loss {lb.item():.9e}; launches {counts}; "
          f"plain calls on CUDA {plain_calls}")
    finite = math.isfinite(lb.item()) and all(bool(torch.isfinite(g).all()) for g in gb.values())
    if not finite:
        fail("non-finite bf16 loss or gradient")
    missing = [k for k in TRAINING_KERNELS if counts[k] <= 0]
    if missing:
        fail(f"training kernels never launched: {missing}")
    perop = {k: counts[k] for k in PEROP_STEP_LAUNCHES}
    if perop != PEROP_STEP_LAUNCHES:
        fail(f"the per-op kernels' launches in a gradient step: {perop}, expected "
             f"{PEROP_STEP_LAUNCHES}")
    if any(counts[k] for k in F32_CONV_KERNELS):
        fail(f"the bf16 run launched the float32 conv kernels: "
             f"{ {k: counts[k] for k in F32_CONV_KERNELS} }")
    if any(plain_calls.values()):
        fail(f"plain versions ran on CUDA tensors in the kernel run: {plain_calls}")
    _, theta_p, loss_p = build_training(setup, plain=True)
    lbp, gbp = value_and_grad(loss_p, data, theta_p)
    grel = {k: rel_l2(gb[k], gbp[k]) for k in gb}
    print(f"[train] bf16 kernels vs plain: loss {lb.item():.9e} vs {lbp.item():.9e} "
          f"(rel {abs(lb.item() - lbp.item()) / abs(lbp.item()):.3e}); grad rel L2 "
          + ", ".join(f"{k} {v:.3e}" for k, v in grel.items()) + f" (bound {GRAD_TOL_BF16})")
    if not all(math.isfinite(v) and v <= GRAD_TOL_BF16 for v in grel.values()):
        fail(f"bf16 gradient: kernels vs plain {grel} > {GRAD_TOL_BF16}")

    # 3. seconds per gradient step, in turns, and peak memory
    step_turns("bf16 convs", {"plain": (loss_p, theta_p), "kernels": (loss, theta)}, data)

    # 4. three Adam iterations
    dataloader = nc.create_dataloader_post(data, ntrajectory=1, nunroll=nunroll)
    state = nc.create_trainstate(theta, lr=1e-3, rng=np.random.default_rng(SEED))
    losses = []
    for _ in range(3):
        state = nc.train(dataloader=dataloader, loss=loss, trainstate=state, niter=1)["trainstate"]
        losses.append(state["loss"].item())
    print(f"[train] 3 Adam iterations (lr 1e-3): losses "
          + ", ".join(f"{v:.9e}" for v in losses))
    if not all(math.isfinite(v) for v in losses):
        fail("non-finite loss in train")

    # 5. solve_unsteady with the trained closure attached
    m, _, _ = build_training(setup)
    csetup = training_setup(n, closure_model=m)
    nsteps, dt = 10, 5e-4
    launches.reset_counts()
    t0 = time.perf_counter()
    out, _ = it.solve_unsteady(setup=csetup, ustart=u0, tlims=(0.0, nsteps * dt), dt=dt,
                               method=it.RKMethods.RK44(), psolver=it.psolver_spectral(csetup),
                               theta=state["theta"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fcounts = {k: v for k, v in run_counts().items() if v}
    print(f"[train] solve_unsteady with the closure, {nsteps} steps: {wall:.3f} s wall; "
          f"launches {fcounts}; plain calls on CUDA "
          f"{ {k: v for k, v in launches.PLAIN_ON_CUDA.items() if v} }")
    u = strip_ghosts(out.u)
    if out.n != nsteps or not bool(torch.isfinite(u).all()):
        fail("the closure run did not finish with finite fields")
    if any(launches.PLAIN_ON_CUDA.values()):
        fail("plain versions ran on CUDA tensors in the closure run")
    gate = poisson_pallas_min_n("manualhigh")
    expect = 4 * nsteps if n >= gate else 0
    if launches.LAUNCHES["poisson_pallas"] != expect:
        fail(f"the closure run solved Poisson {launches.LAUNCHES['poisson_pallas']} times "
             f"with the 3-pass kernels, expected {expect} (the gate: n >= {gate})")
    check_divergence(u, float(csetup.grid.delta[0][0]), "closure run")
    counts["poisson_pallas"] = launches.LAUNCHES["poisson_pallas"]
    counts.update({k: f32_counts[k] for k in F32_CONV_KERNELS})
    return counts


def phase_profile_training(n, nunroll):
    """Kernel-time breakdown of one gradient step with bf16 convs and one
    with float32 convs (torch.profiler)."""
    import torch

    setup = training_setup(n)
    _, data = training_data(setup, nunroll)
    for tag, cdt in (("bf16", None), ("f32", torch.float32)):
        _, theta, loss = build_training(setup, compute_dtype=cdt)
        wall, dev, conv, events = profile_step(loss, data, theta)
        print(f"[profile] one {tag} gradient step: {wall:.3f} s wall (unprofiled), "
              f"{dev:.3f} s of kernel time (profiled); idle share "
              f"{max(0.0, 1 - dev / wall):.3f}; fused conv kernels {conv:.3f} s "
              f"({conv / dev:.3f} of the kernel time)")
        print(events.table(sort_by="self_cuda_time_total", row_limit=20))
        del theta, loss, events
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase 4: the wall-bounded channel
# --------------------------------------------------------------------------

CHANNEL_BOX = (256, 128, 128)
# boxes whose ny and nz are no multiple of the stage kernel's 16 x 32 (y,
# z) tile (nz % 4 == 0: its 16-byte staging; nz = 20 with ny = 26 too)
CHANNEL_RAGGED_BOXES = ((40, 26, 20), (32, 20, 36), (48, 24, 40))


def channel_setup(box, dtype=None):
    """`bench.py`'s `make_channel` configuration on `box`, through the
    port's `Setup`: x/y periodic, no-slip z walls on a tanh(1.2) grid,
    Re = 1e3, steady body force (1, 0, 0), f32 (or `dtype`)."""
    import torch

    import ins_tpu_torch as it

    nx, ny, nz = box
    x = (np.linspace(0.0, 4 * np.pi, nx + 1), np.linspace(0.0, 2 * np.pi, ny + 1),
         it.tanh_grid(0.0, 2.0, nz, 1.2))
    wall = it.DirichletBC()
    bc = ((it.PeriodicBC(), it.PeriodicBC()), (it.PeriodicBC(), it.PeriodicBC()), (wall, wall))
    return it.Setup(
        x=x, boundary_conditions=bc, Re=1e3, dtype=dtype or torch.float32, device=DEVICE,
        bodyforce=lambda dim, xx, yy, zz, t: (1.0 if dim == 0 else 0.0) + 0.0 * xx,
    )


def channel_kernel_cases(box):
    """{kernel name: [Case, ...]} of the two channel kernels on `box`: every
    `channel_msd_3d` mode of the hat chain and of the per-stage step (the
    first, which feeds the kernels line, is the hat chain's stages 1-2:
    half of the main path's launches, and its heaviest in bytes), and the
    correction; every case carries its bound."""
    import torch

    from ins_tpu_torch.ops import channel_kernels as ck
    from ins_tpu_torch.ops.channelpath import make_channel_metrics

    met = make_channel_metrics(channel_setup(box))
    rng = np.random.default_rng(SEED + sum(box))
    dev = torch.device(DEVICE)

    def field(*shape, scale=1.0):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        if len(shape) == 4:
            a[2, ..., -1] = 0.0  # w's pinned wall slot
        return torch.from_numpy(a).to(dev)

    vec = (3, *box)
    t, ustart, acc, force = (field(*vec) for _ in range(4))
    q = field(*box, scale=1e-2)
    cells = int(np.prod(box))

    def msd(impl, us_, acc_, kw):
        def run():
            res = impl(t, us_, acc_, met, visc=1e-3, dt=1e-3, **kw)
            return tuple(r for r in res if r is not None)

        return run

    def case(label, us_, acc_, **kw):
        if kw.get("div_of_acc") and acc_ is not None:
            reads_base = None  # the base is not read on the final stage
        else:
            reads_base = us_
        reads = (t, kw.get("qrecon"), reads_base, acc_, kw.get("force"), met.zmet)
        return Case(label, msd(ck.channel_msd_3d, us_, acc_, kw),
                    msd(ck.channel_msd_3d_plain, us_, acc_, kw),
                    inputs=reads, ops=OPS_PER_CELL["channel_msd"] * cells)

    last = dict(ca=0.0, cb=1 / 6, div_of_acc=True)
    return {
        "channel_msd_3d": [
            case("hat stages 1-2: recon, ustart, acc, force", ustart, acc, qrecon=q,
                 force=force, ca=0.5, cb=1 / 3),
            case("hat stage 0: recon, emit_urec, force", None, None, qrecon=q,
                 emit_urec=True, force=force, ca=0.5, cb=1 / 6),
            case("hat stage 3: recon, acc, div_of_acc, force", ustart, acc, qrecon=q,
                 force=force, **last),
            case("hat single stage: recon, div_of_acc", None, None, qrecon=q, ca=0.0,
                 cb=1.0, div_of_acc=True),
            case("per-stage 0: ustart, force", ustart, None, force=force, ca=0.5, cb=1 / 6),
            case("per-stage 1-2: ustart, acc", ustart, acc, ca=0.5, cb=1 / 3),
            case("per-stage 3: acc, div_of_acc", ustart, acc, **last),
            case("cb = 0, force", ustart, None, force=force, ca=0.5, cb=0.0),
        ],
        "channel_pressure_correct_3d": [
            Case("target, q -> u", lambda: (ck.channel_pressure_correct_3d(t, q, met),),
                 lambda: (ck.channel_pressure_correct_3d_plain(t, q, met),),
                 inputs=(t, q, met.zmet[3]), ops=OPS_PER_CELL["correct"] * cells),
        ],
    }


def channel_u0(setup, psolver):
    """u0 of `make_channel`: the parabola plus the 0.02 sin-sin-sin
    perturbation, projected (`velocityfield`)."""
    import torch

    import ins_tpu_torch as it

    def ufunc(dim, xx, yy, zz):
        base = 6.0 * zz * (2.0 - zz) / 4.0 if dim == 0 else 0.0 * zz
        return base + 0.02 * torch.sin(2 * xx) * torch.sin(2 * yy) * torch.sin(np.pi * zz)

    return it.velocityfield(setup, ufunc, psolver=psolver)


def phase_channel(nsteps, chunk):
    import torch

    import ins_tpu_torch as it
    from ins_tpu_torch.ops import launches
    from ins_tpu_torch.ops.channelpath import (
        channel_divergence_roll,
        make_channel_metrics,
        make_channel_timestep_hat,
        strip_channel,
    )
    from ins_tpu_torch.ops.fdm import fdm_solve_box, fdm_transform_roundoff, om_box

    setup = channel_setup(CHANNEL_BOX)
    psolver = it.default_psolver(setup)
    if not getattr(psolver, "is_fdm", False):
        fail("default_psolver did not give the FDM solve on the channel")
    u0 = channel_u0(setup, psolver)
    roundoff = fdm_transform_roundoff(setup)
    print(f"[channel] {CHANNEL_BOX} RK44 f32, Re=1e3, force (1, 0, 0), tanh(1.2) walls; "
          f"FDM transform roundoff {roundoff:.3e} -> nrefine {1 if roundoff > 1e-4 else 0}")
    dt = 1e-3
    method = it.RKMethods.RK44()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    launches.reset_counts()
    t0 = time.perf_counter()
    state, _ = it.solve_unsteady(
        setup=setup, ustart=u0, tlims=(0.0, nsteps * dt), dt=dt, method=method,
        psolver=psolver, processors={"log": it.timelogger(nupdate=chunk)},
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = run_counts()
    plain = dict(launches.PLAIN_ON_CUDA)
    print(f"[channel] solve_unsteady: {nsteps} steps in chunks of {chunk}, {wall:.3f} s "
          f"wall (first call included); launches "
          f"{ {k: v for k, v in counts.items() if v} }; plain calls on CUDA "
          f"{ {k: v for k, v in plain.items() if v} }")
    if state.n != nsteps:
        fail(f"the channel ran {state.n} steps, expected {nsteps}")
    expect = {"channel_msd_3d": 4 * nsteps, "channel_pressure_correct_3d": nsteps // chunk}
    if {k: v for k, v in counts.items() if v} != expect:
        fail(f"channel launches {counts}, expected {expect}")
    if any(plain.values()):
        fail(f"plain versions ran on CUDA tensors in the channel run: {plain}")
    u = state.u
    if not bool(torch.isfinite(u).all()):
        fail("non-finite velocity after the channel run")
    w_walls = u[2][..., [0, -2, -1]]
    print(f"[channel] w on the walls (bottom face, top face, top ghost): max "
          f"{w_walls.abs().max().item():.3e}")
    if bool(w_walls.any()):
        fail("w is not exactly 0 on the walls")

    met = make_channel_metrics(setup)
    ui = strip_channel(u)
    div = channel_divergence_roll(ui, met)
    dz_min = float(np.min(np.diff(np.asarray(setup.grid.x[2][1:-1], np.float64))))
    umax, divmax = ui.abs().max().item(), div.abs().max().item()
    print(f"[channel] max|div u| = {divmax:.3e}, bound 1e-4*max|u|/min dz = "
          f"{1e-4 * umax / dz_min:.3e} (max|u| {umax:.4f}, min dz {dz_min:.4e}); "
          f"kinetic energy {it.total_kinetic_energy(u0, setup).item():.9e} -> "
          f"{it.total_kinetic_energy(u, setup).item():.9e}")
    if not divmax <= 1e-4 * umax / dz_min:
        fail("the channel result is not divergence-free")

    # the same run through the plain chain on the card
    hp = make_channel_timestep_hat(setup, method, plain=True)
    s0 = it.create_stepper(method, setup=setup, u=strip_channel(u0))
    s, left = s0, nsteps
    while left:
        c = min(chunk, left)
        h = hp[0](s)
        for _ in range(c):
            h = hp[1](h, dt)
        s = hp[2](h)
        left -= c
    agree = rel_err(ui, s.u)
    print(f"[channel] kernel chain vs plain chain after {nsteps} steps: max rel diff "
          f"{agree:.3e}")
    if not agree <= REL_TOL:
        fail(f"channel kernel and plain chains disagree by {agree:.3e} > {REL_TOL}")

    # ms/step of the hat chain, kernels and plain, after a warm-up
    hk = make_channel_timestep_hat(setup, method)

    def ms_per_step(fns, steps=20):
        to_h, step_h, _ = fns
        h = step_h(step_h(to_h(s0), dt), dt)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            h = step_h(h, dt)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / steps

    times = {"plain": [], "kernels": []}
    for which in ("plain", "kernels", "kernels", "plain"):
        times[which].append(ms_per_step(hk if which == "kernels" else hp))
    ms_k, ms_p = sum(times["kernels"]) / 2, sum(times["plain"]) / 2
    cells = int(np.prod(CHANNEL_BOX))
    # the projection's FDM solve alone: 6 contractions of 2 n_d N operations
    solve = fdm_solve_box(setup)
    f = om_box(setup) * div
    solve_ms = (cuda_ms(lambda: solve(f)) + cuda_ms(lambda: solve(f))) / 2
    gop = 2 * 2 * cells * sum(CHANNEL_BOX) / 1e9
    print(f"[channel] hat chain {CHANNEL_BOX} RK44 f32: kernels {ms_k:.3f} ms/step "
          f"({times['kernels'][0]:.3f}, {times['kernels'][1]:.3f}; "
          f"{cells / (ms_k * 1e-3):.4e} cell-updates/s), plain {ms_p:.3f} ms/step "
          f"({times['plain'][0]:.3f}, {times['plain'][1]:.3f}); FDM solve {solve_ms:.4f} ms "
          f"per projection ({gop:.2f} GOP: {gop / solve_ms:.2f} TFLOP/s FP32, 4 per step); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card after "
          f"the timing (SM clock, power draw, temperature): "
          f"{card_line('clocks.sm,power.draw,temperature.gpu')}")
    return counts, setup, u0, dt


def phase_profile_channel(setup, u0, dt, table=True):
    """Kernel / FDM-GEMM / glue split of 3 channel hat steps (torch.profiler):
    prints it (and, with ``table``, the kernels by time) and returns
    {"wall": ms, split..., "idle": share}, or None where the trace holds no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import ins_tpu_torch as it
    from ins_tpu_torch.ops.channelpath import make_channel_timestep_hat, strip_channel

    method = it.RKMethods.RK44()
    to_h, step_h, _ = make_channel_timestep_hat(setup, method)
    h = step_h(to_h(it.create_stepper(method, setup=setup, u=strip_channel(u0))), dt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        h = step_h(h, dt)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 3  # unprofiled
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            h = step_h(h, dt)
        torch.cuda.synchronize()
    events = prof.key_averages()
    split = {"kernels": 0.0, "FDM GEMM": 0.0, "glue": 0.0}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = ("kernels" if "channel_" in e.key else
               "FDM GEMM" if "gemm" in e.key.lower() else "glue")
        split[key] += e.self_device_time_total / 1e3 / 3
    dev = sum(split.values())
    if dev <= 0.0:
        print("[profile] the trace holds no device time; no split")
        return None
    idle = max(0.0, 1 - dev / wall)
    print(f"[profile] channel step: {wall:.3f} ms wall (unprofiled), {dev:.3f} ms of "
          f"device time: " + ", ".join(f"{k} {v:.3f} ms ({v / dev:.1%})" for k, v in split.items())
          + f"; idle share {idle:.3f}")
    if table:
        print(events.table(sort_by="self_cuda_time_total", row_limit=15))
    return {"wall": wall, **split, "idle": idle}


# --------------------------------------------------------------------------
# phase 5: the Smagorinsky LES
# --------------------------------------------------------------------------

LES_THETA = 0.17
LES_BOX = (256, 256, 256)


def les_kernel_cases(box):
    """{"smagorinsky_force_3d": [Case, ...]} on `box`: the force on the
    rebuilt u (the hat chain's stages, the main path's shape, first), on
    u (the chunk's first stage), and both with a body force."""
    import torch

    from ins_tpu_torch.ops import smag_kernels as smk

    rng = np.random.default_rng(SEED + 3 * sum(box))
    dev = torch.device(DEVICE)

    def field(*shape, scale=1.0):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(dev)

    u, bf = field(3, *box), field(3, *box)
    q = field(*box, scale=1e-2)
    theta = torch.full((1,), LES_THETA, device=dev)
    dxs = tuple(2 * np.pi / n for n in box)

    def case(label, **kw):
        # the force, plus the rebuild u - grad q and the body force's add
        ops = (OPS_PER_CELL["smag"] + OPS_PER_CELL["correct"] * ("rebuild_q" in kw)
               + 3 * ("bodyforce" in kw)) * int(np.prod(box))
        return Case(label, lambda: (smk.smagorinsky_force_3d(u, theta, dxs, **kw),),
                    lambda: (smk.smagorinsky_force_3d_plain(u, theta, dxs, **kw),),
                    inputs=(u, kw.get("rebuild_q"), kw.get("bodyforce"), theta), ops=ops)

    return {"smagorinsky_force_3d": [
        case("rebuild (ut_prev, q)", rebuild_q=q),
        case("u"),
        case("rebuild + bodyforce", rebuild_q=q, bodyforce=bf),
        case("u + bodyforce", bodyforce=bf),
    ]}


def les_setup(n, bodyforce=None):
    """`bench.py`'s LES case: phase 2's setup with the natural-form
    Smagorinsky closure (and a steady body force)."""
    import torch

    import ins_tpu_torch as it

    base = headline_setup(n)
    x = tuple(np.linspace(0.0, 2 * np.pi, n + 1) for _ in range(3))
    return it.Setup(x=x, boundary_conditions=base.boundary_conditions, Re=4000.0,
                    dtype=torch.float32, device=DEVICE, bodyforce=bodyforce,
                    closure_model=it.smagorinsky_closure_natural(base))


def phase_les(n, nsteps, chunk, u0_ref, e_no_closure):
    import torch

    import ins_tpu_torch as it
    from ins_tpu_torch.ops import launches
    from ins_tpu_torch.ops.fastpath import strip_ghosts, strip_state

    setup = les_setup(n)
    u0 = it.random_field(setup, kp=10, generator=torch.Generator(device=DEVICE).manual_seed(1))
    if not torch.equal(u0, u0_ref):
        fail("random_field on the LES setup did not give phase 2's u0")
    dt = 1e-3 * 128 / n
    method = it.RKMethods.RK44()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    launches.reset_counts()
    t0 = time.perf_counter()
    state, outs = it.solve_unsteady(
        setup=setup, ustart=u0, tlims=(0.0, nsteps * dt), dt=dt, method=method,
        psolver=it.psolver_spectral(setup), theta=LES_THETA,
        processors={"log": it.timelogger(nupdate=chunk),
                    "spec": it.observespectrum(setup, nupdate=chunk),
                    "energy": it.observefield(
                        lambda s: it.total_kinetic_energy(s["u"], setup), nupdate=chunk)},
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = run_counts()
    plain = dict(launches.PLAIN_ON_CUDA)
    print(f"[les] solve_unsteady {n}^3 RK44 f32 Re=4000, Smagorinsky theta={LES_THETA}: "
          f"{nsteps} steps in chunks of {chunk}, {wall:.3f} s wall (first call included); "
          f"launches { {k: v for k, v in counts.items() if v} }; plain calls on CUDA "
          f"{ {k: v for k, v in plain.items() if v} }")
    if state.n != nsteps:
        fail(f"the LES ran {state.n} steps, expected {nsteps}")
    keys = form_keys()
    per_step = {"smagorinsky_force_3d": counts["smagorinsky_force_3d"],
                "stage kernel": counts["pcmsd_hat_3d"] + counts["momentum_stage_divhat_3d"],
                keys["passB_fold"]: counts[keys["passB_fold"]]}
    if any(v != 4 * nsteps for v in per_step.values()):
        fail(f"LES launches {per_step}, expected {4 * nsteps} each (4 per step)")
    if counts["pressure_correct_qhat_3d"] != nsteps // chunk or counts[keys["passB"]]:
        fail(f"LES launches {counts}: one correction per chunk, no dense pass B expected")
    if any(plain.values()):
        fail(f"plain versions ran on CUDA tensors in the LES run: {plain}")
    u = strip_ghosts(state.u)
    if not bool(torch.isfinite(u).all()):
        fail("non-finite velocity after the LES run")
    check_divergence(u, float(setup.grid.delta[0][0]), "les")
    e0 = it.total_kinetic_energy(u0, setup).item()
    e1 = it.total_kinetic_energy(state.u, setup).item()
    hist = [float(v) for v in outs["energy"]]
    print(f"[les] kinetic energy {e0:.9e} -> {e1:.9e} (at the chunk ends "
          + ", ".join(f"{v:.9e}" for v in hist) + f"); without the closure {e_no_closure:.9e}")
    if not (e1 <= e0 and all(b <= a for a, b in zip([e0] + hist, hist))):
        fail("LES kinetic energy increased")
    if not e1 < e_no_closure:
        fail("the eddy viscosity did not dissipate: LES energy not below the run without it")
    spec = outs["spec"]
    nk = len(spec["kappa"])
    if len(spec["ehat"]) != nsteps // chunk or not all(
            e.shape == (nk,) and np.isfinite(e).all() for e in spec["ehat"]):
        fail(f"spectrum records {[e.shape for e in spec['ehat']]}, expected "
             f"{nsteps // chunk} finite ({nk},) arrays")
    print(f"[les] spectrum: {nk} bins (kappa {int(spec['kappa'][0])}..{int(spec['kappa'][-1])}), "
          f"E(kappa) at t = {spec['t'][-1]:.4f}: first bins "
          + ", ".join(f"{v:.4e}" for v in spec["ehat"][-1][:4]))

    # the same run through the plain chain on the card
    s0 = strip_state(it.create_stepper(method, setup=setup, u=u0))
    s = run_plain_chain(setup, method, s0, dt, nsteps, chunk, theta=LES_THETA)
    agree = rel_err(u, s.u)
    print(f"[les] kernel chain vs plain chain after {nsteps} steps: max rel diff {agree:.3e}")
    if not agree <= REL_TOL:
        fail(f"LES kernel and plain chains disagree by {agree:.3e} > {REL_TOL}")
    del s

    theta = torch.full((), LES_THETA, device=DEVICE)
    print_ms_per_step("les", f"{n}^3 RK44 f32 + Smagorinsky", n,
                      hat_ms_per_step(setup, method, s0, dt, theta=theta))
    return counts, setup, u0, dt


def phase_profile_split(tag, setup, method, u0, dt, theta=None, temp0=None, chain=None):
    """Device-time split of 3 hat steps (torch.profiler) and the idle
    share against the unprofiled wall; ``chain=(to_hat, step_hat, state)``
    profiles that chain (the halo chain's) instead of the single-device
    one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import ins_tpu_torch as it
    from ins_tpu_torch.ops.fastpath import make_fast_timestep_hat, strip_state

    if chain is None:
        to_h, step_h, _ = make_fast_timestep_hat(setup, method)
        s0 = strip_state(it.create_stepper(method, setup=setup, u=u0, temp=temp0))
    else:
        to_h, step_h, s0 = chain
    h = step_h(to_h(s0), dt, theta)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        h = step_h(h, dt, theta)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            h = step_h(h, dt, theta)
        torch.cuda.synchronize()
    events = prof.key_averages()
    split = {"smag": 0.0, "stage": 0.0, "GEMM": 0.0, "pass B": 0.0, "correct": 0.0,
             "collectives": 0.0, "glue": 0.0}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = ("collectives" if "nccl" in e.key.lower() else
               "smag" if "smag_kernel" in e.key else
               "stage" if "stage_kernel" in e.key else
               "pass B" if ("eigen_scale" in e.key or "passb_fold" in e.key) else
               "GEMM" if "gemm" in e.key.lower() else
               "correct" if "correct" in e.key else "glue")
        split[key] += e.self_device_time_total / 1e3 / 3
    dev = sum(split.values())
    if dev <= 0.0:
        print("[profile] the trace holds no device time; no split")
        return
    print(f"[profile] {tag}: {wall:.3f} ms wall (unprofiled), {dev:.3f} ms of device "
          f"time: " + ", ".join(f"{k} {v:.3f} ms ({v / dev:.1%})" for k, v in split.items())
          + f"; idle share {max(0.0, 1 - dev / wall):.3f}")
    print(events.table(sort_by="self_cuda_time_total", row_limit=15))


# --------------------------------------------------------------------------
# phase 6: Boussinesq convection
# --------------------------------------------------------------------------


def boussinesq_setup(n):
    """`bench.py`'s `run_temp_case`: the periodic unit cube with
    `temperature_equation(Pr=0.71, Ra=1e7, Ge=1.0, dodissipation=True,
    gdir=2)`, Re = 1/alpha1, f32."""
    import torch

    import ins_tpu_torch as it

    x = tuple(np.linspace(0.0, 1.0, n + 1) for _ in range(3))
    bc = ((it.PeriodicBC(), it.PeriodicBC()),) * 3
    te = it.temperature_equation(Pr=0.71, Ra=1e7, Ge=1.0, dodissipation=True,
                                 boundary_conditions=bc, gdir=2, dtype=torch.float32)
    return it.Setup(x=x, boundary_conditions=bc, temperature=te, dtype=torch.float32,
                    device=DEVICE)


def phase_boussinesq(n, nsteps, chunk):
    import torch

    import ins_tpu_torch as it
    from ins_tpu_torch.ops import launches
    from ins_tpu_torch.ops.fastpath import (
        reghost, reghost_scalar, strip_ghosts, strip_scalar, strip_state,
    )

    setup = boussinesq_setup(n)
    u0 = it.random_field(setup, kp=10, generator=torch.Generator(device=DEVICE).manual_seed(1))
    T0 = it.temperaturefield(setup, lambda xx, yy, zz: 0.5 + 0.1 * torch.sin(2 * np.pi * xx))
    dt = 2e-4 * 128 / n
    method = it.RKMethods.RK44()
    te = setup.temperature
    print(f"[boussinesq] {n}^3 RK44 f32, Pr=0.71 Ra=1e7 Ge=1 gdir=2 with dissipation: "
          f"Re = 1/alpha1 = {setup.Re:.6f}, alpha4 = {te.alpha4:.6e}, dt = {dt:g}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    launches.reset_counts()
    t0 = time.perf_counter()
    state, outs = it.solve_unsteady(
        setup=setup, ustart=u0, tempstart=T0, tlims=(0.0, nsteps * dt), dt=dt, method=method,
        psolver=it.psolver_spectral(setup),
        processors={"log": it.timelogger(nupdate=chunk),
                    "nu": it.observe_nusselt(setup, nupdate=chunk)},
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = run_counts()
    plain = dict(launches.PLAIN_ON_CUDA)
    print(f"[boussinesq] solve_unsteady: {nsteps} steps in chunks of {chunk}, {wall:.3f} s "
          f"wall (first call included); launches { {k: v for k, v in counts.items() if v} }; "
          f"plain calls on CUDA { {k: v for k, v in plain.items() if v} }")
    if state.n != nsteps:
        fail(f"the Boussinesq run ran {state.n} steps, expected {nsteps}")
    keys = form_keys()
    per_step = {"stage kernel": counts["pcmsd_hat_3d"] + counts["momentum_stage_divhat_3d"],
                keys["passB_fold"]: counts[keys["passB_fold"]]}
    if any(v != 4 * nsteps for v in per_step.values()):
        fail(f"Boussinesq launches {per_step}, expected {4 * nsteps} each (4 per step)")
    if counts["pressure_correct_qhat_3d"] != nsteps // chunk or counts[keys["passB"]]:
        fail(f"Boussinesq launches {counts}: one correction per chunk, no dense pass B")
    if any(plain.values()):
        fail(f"plain versions ran on CUDA tensors in the Boussinesq run: {plain}")
    u, T = strip_ghosts(state.u), strip_scalar(state.temp)
    if not (bool(torch.isfinite(u).all()) and bool(torch.isfinite(T).all())):
        fail("non-finite velocity or temperature after the Boussinesq run")
    check_divergence(u, float(setup.grid.delta[0][0]), "boussinesq")
    nu = outs["nu"]["Nu"]
    print(f"[boussinesq] T in [{T.min().item():.6f}, {T.max().item():.6f}], mean "
          f"{T.mean().item():.9f} (T0 mean {strip_scalar(T0).mean().item():.9f}); Nu at t = "
          + ", ".join(f"{t:.4f}: {v:.9f}" for t, v in zip(outs["nu"]["t"], nu)))
    if len(nu) != nsteps // chunk + 1 or not all(math.isfinite(v) for v in nu):
        fail(f"Nusselt record {nu}: expected {nsteps // chunk + 1} finite values")

    # the same run through the plain chain on the card, with its Nusselt
    # numbers from the same processor
    nu_plain = it.observe_nusselt(setup)
    s0 = strip_state(it.create_stepper(method, setup=setup, u=u0, temp=T0))
    ps = nu_plain.initialize(dict(u=u0, temp=T0, t=0.0, n=0))

    def observe(st):
        nonlocal ps
        ps = nu_plain.update(ps, dict(u=reghost(st.u), temp=reghost_scalar(st.temp), t=st.t,
                                      n=st.n))

    s = run_plain_chain(setup, method, s0, dt, nsteps, chunk, observe)
    agree_u, agree_t = rel_err(u, s.u), rel_err(T, s.temp)
    nu_diff = [abs(a - b) / max(1.0, abs(b)) for a, b in zip(nu, ps["Nu"])]
    print(f"[boussinesq] kernel chain vs plain chain after {nsteps} steps: max rel diff u "
          f"{agree_u:.3e}, T {agree_t:.3e}; Nu diff / max(1, |Nu|) "
          + ", ".join(f"{v:.3e}" for v in nu_diff))
    if not (agree_u <= REL_TOL and agree_t <= REL_TOL):
        fail(f"Boussinesq kernel and plain chains disagree by {agree_u:.3e} (u), "
             f"{agree_t:.3e} (T) > {REL_TOL}")
    if len(nu_diff) != len(nu) or not all(v <= REL_TOL for v in nu_diff):
        fail(f"Nusselt numbers of the kernel and plain chains differ: {nu} vs {ps['Nu']}")
    del s, state

    print_ms_per_step("boussinesq", f"{n}^3 RK44 f32 + temperature", n,
                      hat_ms_per_step(setup, method, s0, dt))
    return counts, setup, u0, T0, dt


# --------------------------------------------------------------------------
# phase 7: LMWray3
# --------------------------------------------------------------------------


def phase_lmwray3(n, nsteps, chunk, u0):
    import torch

    import ins_tpu_torch as it
    from ins_tpu_torch.ops import launches
    from ins_tpu_torch.ops.fastpath import strip_ghosts, strip_state

    setup = headline_setup(n)
    dt = 1e-3 * 128 / n
    method = it.LMWray3()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    launches.reset_counts()
    t0 = time.perf_counter()
    state, outs = it.solve_unsteady(
        setup=setup, ustart=u0, tlims=(0.0, nsteps * dt), dt=dt, method=method,
        psolver=it.psolver_spectral(setup),
        processors={"log": it.timelogger(nupdate=chunk),
                    "energy": it.observefield(
                        lambda s: it.total_kinetic_energy(s["u"], setup), nupdate=chunk)},
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = run_counts()
    plain = dict(launches.PLAIN_ON_CUDA)
    print(f"[lmwray3] solve_unsteady {n}^3 LMWray3 f32 Re=4000: {nsteps} steps in chunks of "
          f"{chunk}, {wall:.3f} s wall (first call included); launches "
          f"{ {k: v for k, v in counts.items() if v} }; plain calls on CUDA "
          f"{ {k: v for k, v in plain.items() if v} }")
    if state.n != nsteps:
        fail(f"the LMWray3 run ran {state.n} steps, expected {nsteps}")
    keys = form_keys()
    per_step = {"stage kernel": counts["pcmsd_hat_3d"] + counts["momentum_stage_divhat_3d"],
                keys["passB_fold"]: counts[keys["passB_fold"]]}
    if any(v != 3 * nsteps for v in per_step.values()):
        fail(f"LMWray3 launches {per_step}, expected {3 * nsteps} each (3 per step)")
    if counts["pressure_correct_qhat_3d"] != nsteps // chunk or counts[keys["passB"]]:
        fail(f"LMWray3 launches {counts}: one correction per chunk, no dense pass B")
    if any(plain.values()):
        fail(f"plain versions ran on CUDA tensors in the LMWray3 run: {plain}")
    u = strip_ghosts(state.u)
    if not bool(torch.isfinite(u).all()):
        fail("non-finite velocity after the LMWray3 run")
    check_divergence(u, float(setup.grid.delta[0][0]), "lmwray3")
    e0 = it.total_kinetic_energy(u0, setup).item()
    hist = [float(v) for v in outs["energy"]]
    print(f"[lmwray3] kinetic energy {e0:.9e} -> " + ", ".join(f"{v:.9e}" for v in hist)
          + " (chunk ends)")
    if not all(b <= a for a, b in zip([e0] + hist, hist)):
        fail("LMWray3 kinetic energy increased")

    s0 = strip_state(it.create_stepper(method, setup=setup, u=u0))
    s = run_plain_chain(setup, method, s0, dt, nsteps, chunk)
    agree = rel_err(u, s.u)
    print(f"[lmwray3] kernel chain vs plain chain after {nsteps} steps: max rel diff "
          f"{agree:.3e}")
    if not agree <= REL_TOL:
        fail(f"LMWray3 kernel and plain chains disagree by {agree:.3e} > {REL_TOL}")
    del s, state

    print_ms_per_step("lmwray3", f"{n}^3 LMWray3 f32", n, hat_ms_per_step(setup, method, s0, dt))
    return counts, setup, dt


# --------------------------------------------------------------------------
# phase 8: the x-slab halo chain
# --------------------------------------------------------------------------

HALO_SHARDS = 4  # the kernels run at a 4-way x-slab's shard shapes


def device_ms(fn, reps=10):
    """Device milliseconds per fn() call: the CUDA time of every kernel
    and copy it launches (torch.profiler), over `reps` calls after a
    warm-up; None where the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / 1e3 / reps if total > 0 else None


def solve_gate_times(sizes=(64, 128, 256), precision="manualhigh"):
    """The 3-pass solve `make_poisson_pallas` in ``precision`` against
    `make_poisson_mm`'s
    contractions at each n, held against each other: wall ms per solve
    (CUDA events around 20 solves, turns pallas, mm, mm, pallas) and
    device ms per solve (torch.profiler).  On the per-op chain the solve
    sits behind the closure's convolutions in the device queue, so its
    device time is what the gate (`fastpath.poisson_pallas_min_n`)
    follows; prints which solve the gate picks in ``precision``."""
    import torch

    from ins_tpu_torch.ops.dft import make_poisson_mm
    from ins_tpu_torch.ops.fastpath import poisson_pallas_min_n
    from ins_tpu_torch.ops.poisson_kernels import make_poisson_pallas

    out = {}
    for n in sizes:
        dxs = (1.0 / n,) * 3
        f = torch.from_numpy(np.random.default_rng(SEED + n).standard_normal(
            (n, n, n), dtype=np.float32)).to(DEVICE)
        pallas = make_poisson_pallas((n,) * 3, dxs, torch.float32, precision=precision,
                                     device=DEVICE)
        mm = make_poisson_mm((n,) * 3, dxs, torch.float32, DEVICE)
        err = rel_err(pallas(f), mm(f))
        if not err <= REL_TOL:
            fail(f"make_poisson_pallas vs make_poisson_mm at n={n}: {err:.3e} > {REL_TOL}")
        fns = {"pallas": lambda: pallas(f), "mm": lambda: mm(f)}
        wall = {"pallas": [], "mm": []}
        for which in ("pallas", "mm", "mm", "pallas"):
            wall[which].append(cuda_ms(fns[which], reps=20))
        dev = {k: device_ms(fn) for k, fn in fns.items()}
        out[n] = {"wall": {k: sum(v) / 2 for k, v in wall.items()}, "device": dev}
        gate = poisson_pallas_min_n(precision)
        pick = "make_poisson_pallas" if n >= gate else "make_poisson_mm"
        print(f"[solve gate] {card_line()}: n={n}, {precision}: wall per solve make_poisson_pallas "
              f"{out[n]['wall']['pallas']:.4f} ms ({wall['pallas'][0]:.4f}, "
              f"{wall['pallas'][1]:.4f}), make_poisson_mm {out[n]['wall']['mm']:.4f} ms "
              f"({wall['mm'][0]:.4f}, {wall['mm'][1]:.4f}); device per solve "
              + ", ".join(f"{k} {v:.4f} ms" if v is not None else f"{k} not measured"
                          for k, v in dev.items())
              + f"; rel diff {err:.3e}; the gate (n >= {gate}) picks {pick}")
        del f
    torch.cuda.empty_cache()
    return out


def halo_kernel_inputs(n, P, rank):
    """Global fields from a seed and the x-slab ``rank`` of ``P`` cut from
    them, ghost planes from the neighbours: {name: tensor}."""
    import torch

    rng = np.random.default_rng(SEED + 17 * n)
    dev = torch.device(DEVICE)

    def field(*shape, scale=1.0):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(dev)

    g = {"u": field(3, n, n, n), "ustart": field(3, n, n, n), "accb": field(3, n, n, n),
         "qhat": field(n, n, n, scale=1e-3), "divhat": field(n, n, n),
         "bf": field(3, n, n, n), "q": field(n, n, n, scale=1e-2)}
    lx = n // P
    x0 = rank * lx

    def planes(v, lo, k):
        idx = torch.arange(lo, lo + k, device=dev) % n
        return v.index_select(v.dim() - 3, idx).contiguous()

    loc = {}
    for k, v in g.items():
        if k == "divhat":
            continue
        loc[k] = planes(v, x0, lx)
        for j in (1, 2, 3):  # ghost planes: the halo path's widths
            loc[f"{k}_lo{j}"] = planes(v, x0 - j, j)
            loc[f"{k}_hi{j}"] = planes(v, x0 + lx, j)
    ly = n // P
    loc["h"] = g["divhat"][:, rank * ly:(rank + 1) * ly].contiguous()
    return g, loc


def halo_kernel_cases(n, rank=1):
    """{kernel name: [Case, ...]} of the halo kernels on x-slab ``rank``
    of a HALO_SHARDS-way cut of an n³ cube (first case: the shapes and
    options the halo path gives it)."""
    import torch

    from ins_tpu_torch.ops import smag_kernels as smk
    from ins_tpu_torch.ops import stage_kernels as sk
    from ins_tpu_torch.ops.poisson_kernels import make_passB_sharded

    P = HALO_SHARDS
    lx = ly = n // P
    dxs = (2 * np.pi / n,) * 3
    visc = 1.0 / 4000.0
    dt = 1e-3 * 128 / n
    proj = make_passB_sharded((n,) * 3, dxs, torch.float32, ly, device=DEVICE)
    _, L = halo_kernel_inputs(n, P, rank)
    theta = torch.full((1,), LES_THETA, device=DEVICE)
    d2 = float(sum(d * d for d in dxs))
    smag = (theta, d2)
    cells = lx * n * n
    mats = (proj["Vinv"], proj["VinvT"], proj["V"], proj["VT"])

    def gemm(k):  # one plane-transform product over k planes (the default bf16x3 form)
        return 2.0 * k * n**3 * GEMM_BF16X3_AS_FP32

    def msd(impl, **kw):
        return lambda: impl(L["u"], L["u_lo2"], L["u_hi1"], (L["u"],), (L["u_lo1"],),
                            (dt / 2,), visc, dxs, proj["Vinv"], proj["VinvT"],
                            emit_k=False, **kw)

    def pcmsd(impl, base, base_lo, **kw):
        return lambda: impl(L["u"], L["u_lo2"], L["u_hi1"], L["qhat"], L["qhat_lo2"],
                            L["qhat_hi2"], (base,), (base_lo,), (dt / 2,), visc, dxs, proj,
                            emit_k=False, **kw)

    def corr(impl):
        return lambda: (impl(L["u"], L["qhat"], L["qhat_hi1"], dxs, proj["V"], proj["VT"]),)

    based = dict(usnew_coeff=dt / 3, usnew_base=L["accb"])
    recon = dict(usnew_coeff=dt / 6, emit_u=True)
    bfk = dict(bodyforce=L["bf"], bodyforce_lo=L["bf_lo1"])
    cells1 = (lx + 1) * n * n  # the force's planes -1 .. lx - 1

    def force(impl, x_first, rebuild=False, bf=False):
        # the chain's form (x_first = -1: 3 + 2 ghosts, the force at plane
        # -1 too) or the JAX contract (2 + 2 ghosts, lx planes)
        glo = 2 - x_first
        q3 = (L["q"], L[f"q_lo{glo}"], L["q_hi3"]) if rebuild else None
        kw = dict(bodyforce=L["bf"], bodyforce_lo=L["bf_lo1"]) if bf else {}
        return lambda: tuple(t for t in impl(L["u"], L[f"u_lo{glo}"], L["u_hi2"], theta, dxs,
                                              d2, rebuild_q=q3, x_first=x_first, **kw)
                             if t is not None)

    def msd_smag(impl, **kw):
        glo, ghi = (3, 2) if "smag" in kw else (2, 1)
        return lambda: impl(L["u"], L[f"u_lo{glo}"], L[f"u_hi{ghi}"], (L["u"],), (L["u_lo1"],),
                            (dt / 2,), visc, dxs, proj["Vinv"], proj["VinvT"],
                            emit_k=False, usnew_coeff=dt / 6, **kw)

    def pcmsd_smag(impl, base, base_lo, **kw):
        glo, ghi = (3, 2) if "smag" in kw else (2, 1)
        return lambda: impl(L["u"], L[f"u_lo{glo}"], L[f"u_hi{ghi}"], L["qhat"],
                            L[f"qhat_lo{glo}"], L[f"qhat_hi{ghi + 1}"], (base,), (base_lo,),
                            (dt / 2,), visc, dxs, proj, emit_k=False, **kw)

    return {
        "smagorinsky_force_halo_3d": [
            Case("chain form: rebuild (ut, q), 3 + 2 ghosts, planes -1 .. lx-1",
                 force(smk._force_halo, -1, rebuild=True),
                 force(smk._force_halo_plain, -1, rebuild=True),
                 inputs=(L["u"], L["u_lo3"], L["u_hi2"], L["q"], L["q_lo3"], L["q_hi3"],
                         theta),
                 ops=(OPS_PER_CELL["smag"] + OPS_PER_CELL["correct"]) * cells1),
            Case("u (the JAX contract)", force(smk._force_halo, 0),
                 force(smk._force_halo_plain, 0)),
            Case("u + bodyforce", force(smk._force_halo, 0, bf=True),
                 force(smk._force_halo_plain, 0, bf=True)),
            Case("rebuild + bodyforce, planes -1 .. lx-1",
                 force(smk._force_halo, -1, rebuild=True, bf=True),
                 force(smk._force_halo_plain, -1, rebuild=True, bf=True)),
            Case("rebuild (the JAX contract's ghosts)", force(smk._force_halo, 0, rebuild=True),
                 force(smk._force_halo_plain, 0, rebuild=True)),
        ],
        "momentum_stage_divhat_halo_3d+smag": [
            Case("stage 0: u base + usnew + smag",
                 msd_smag(sk.momentum_stage_divhat_halo_3d, smag=smag),
                 msd_smag(sk.momentum_stage_divhat_halo_3d_plain, smag=smag),
                 inputs=(L["u"], L["u_lo3"], L["u_hi2"], proj["Vinv"], proj["VinvT"],
                         theta),
                 ops=(OPS_PER_CELL["stage_norebuild"] * cells + OPS_PER_CELL["smag"] * cells1
                      + 2 * gemm(lx))),
            Case("+ smag + bodyforce", msd_smag(sk.momentum_stage_divhat_halo_3d, smag=smag,
                                                **bfk),
                 msd_smag(sk.momentum_stage_divhat_halo_3d_plain, smag=smag, **bfk)),
            Case("u base + usnew + bodyforce (the force stream alone)",
                 msd_smag(sk.momentum_stage_divhat_halo_3d, **bfk),
                 msd_smag(sk.momentum_stage_divhat_halo_3d_plain, **bfk)),
        ],
        "pcmsd_hat_halo_3d+smag": [
            Case("stream base + usnew_base + smag",
                 pcmsd_smag(sk.pcmsd_hat_halo_3d, L["ustart"], L["ustart_lo1"], smag=smag,
                            **based),
                 pcmsd_smag(sk.pcmsd_hat_halo_3d_plain, L["ustart"], L["ustart_lo1"],
                            smag=smag, **based),
                 inputs=(L["u"], L["u_lo3"], L["u_hi2"], L["qhat"], L["qhat_lo3"],
                         L["qhat_hi3"], L["ustart"], L["ustart_lo1"], L["accb"], *mats,
                         theta),
                 # "stage" already holds the rebuild of u (the cube's
                 # `smag=` row counts it once too)
                 ops=(OPS_PER_CELL["stage"] * cells + OPS_PER_CELL["smag"] * cells1
                      + 4 * gemm(lx) + 2 * gemm(6))),
            Case("RECON + emit_u + usnew + smag",
                 pcmsd_smag(sk.pcmsd_hat_halo_3d, sk.RECON, sk.RECON, smag=smag, **recon),
                 pcmsd_smag(sk.pcmsd_hat_halo_3d_plain, sk.RECON, sk.RECON, smag=smag,
                            **recon)),
            Case("stream base + smag + bodyforce",
                 pcmsd_smag(sk.pcmsd_hat_halo_3d, L["ustart"], L["ustart_lo1"], smag=smag,
                            **based, **bfk),
                 pcmsd_smag(sk.pcmsd_hat_halo_3d_plain, L["ustart"], L["ustart_lo1"],
                            smag=smag, **based, **bfk)),
            Case("stream base + bodyforce (the force stream alone)",
                 pcmsd_smag(sk.pcmsd_hat_halo_3d, L["ustart"], L["ustart_lo1"], **based,
                            **bfk),
                 pcmsd_smag(sk.pcmsd_hat_halo_3d_plain, L["ustart"], L["ustart_lo1"],
                            **based, **bfk)),
        ],
        "momentum_stage_divhat_halo_3d": [
            Case("stage 0: u base + usnew",
                 msd(sk.momentum_stage_divhat_halo_3d, usnew_coeff=dt / 6),
                 msd(sk.momentum_stage_divhat_halo_3d_plain, usnew_coeff=dt / 6),
                 inputs=(L["u"], L["u_lo2"], L["u_hi1"], proj["Vinv"], proj["VinvT"]),
                 ops=OPS_PER_CELL["stage_norebuild"] * cells + 2 * gemm(lx)),
        ],
        "pcmsd_hat_halo_3d": [
            Case("stream base + usnew_base",
                 pcmsd(sk.pcmsd_hat_halo_3d, L["ustart"], L["ustart_lo1"], **based),
                 pcmsd(sk.pcmsd_hat_halo_3d_plain, L["ustart"], L["ustart_lo1"], **based),
                 inputs=(L["u"], L["u_lo2"], L["u_hi1"], L["qhat"], L["qhat_lo2"],
                         L["qhat_hi2"], L["ustart"], L["ustart_lo1"], L["accb"], *mats),
                 ops=OPS_PER_CELL["stage"] * cells + 4 * gemm(lx) + 2 * gemm(4)),
            Case("RECON + emit_u + usnew",
                 pcmsd(sk.pcmsd_hat_halo_3d, sk.RECON, sk.RECON, **recon),
                 pcmsd(sk.pcmsd_hat_halo_3d_plain, sk.RECON, sk.RECON, **recon)),
        ],
        "pressure_correct_qhat_halo_3d": [
            Case("ut, qhat, qhat_hi -> u", corr(sk.pressure_correct_qhat_halo_3d),
                 corr(sk.pressure_correct_qhat_halo_3d_plain),
                 inputs=(L["u"], L["qhat"], L["qhat_hi1"], proj["V"], proj["VT"]),
                 ops=OPS_PER_CELL["correct"] * cells + 2 * gemm(lx) + 2 * gemm(1)),
        ],
        # the halo path's y-slice, then at the largest size the ragged shard
        "passB_sharded": [fold_case(n, proj["fold_levels"], ly, rank * ly)]
        + ([fold_case(*c) for c in FOLD_EXTRA_SHARDS] if n == 256 else []),
    }


def profile_split(fn, reps=10):
    """{kernel name: device ms a call} of `reps` calls of fn under one
    torch.profiler context, after a call outside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total:
            key = e.key[:48]
            split[key] = split.get(key, 0.0) + e.self_device_time_total / 1e3 / reps
    return split


def profile_cases(cases, names=None):
    """Device-time split by kernel of 10 calls of each kernel's first case
    (torch.profiler; ``names``: only those kernels), and for a wrapper
    that runs plane-transform GEMMs the split into the GEMMs and the rest
    (its stage or correction kernel and glue), the rest beside the bytes
    bound of the wrapper's inputs and outputs (the stage kernel reads q and
    writes div where the wrapper reads qhat and writes divhat: the same
    bytes).  Each split is the fuller of two profiled windows in a row: a
    window after a run of other work can hold part or none of its
    kernels' activity (phase 8's force and pass B read 0 in a first window
    and their time in a second; PERF.md §7)."""
    import torch

    for name, cs in cases.items():
        if names is not None and name not in names:
            continue
        fn = cs[0].kfn
        out_bytes = nbytes(fn())
        torch.cuda.synchronize()
        splits = [profile_split(fn) for _ in range(2)]
        totals = [sum(sp.values()) for sp in splits]
        split = splits[int(totals[1] >= totals[0])]
        print(f"[profile] {name} [{cs[0].label}]: {max(totals):.4f} ms of device time a call "
              f"(windows {totals[0]:.4f}, {totals[1]:.4f}): "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items(), key=lambda kv: -kv[1])))
        gemm = sum(v for k, v in split.items() if "gemm" in k.lower())
        if gemm and name != "plane_transform":
            rest = sum(split.values()) - gemm
            t_bytes = (nbytes(cs[0].inputs) + out_bytes) / PEAK_BYTES * 1e3
            print(f"[profile] {name} split: plane-transform GEMMs {gemm:.4f} ms, the rest "
                  f"{rest:.4f} ms against its bytes bound {t_bytes:.4f} ms ({rest / t_bytes:.1f}x)")


def halo_vs_single_device(n):
    """Every x-slab of a HALO_SHARDS-way cut: each halo kernel against the
    matching x-rows of the single-device kernel on the whole cube, and the
    sharded pass B on y-columns [ly·r, ly·r + ly) of the full-x divhat at
    yoff = ly·r against the same columns of the single-device pass B."""
    import torch

    from ins_tpu_torch.ops import smag_kernels as smk
    from ins_tpu_torch.ops import stage_kernels as sk
    from ins_tpu_torch.ops.poisson_kernels import make_fused_projection, make_passB_sharded

    P = HALO_SHARDS
    lx = ly = n // P
    dxs = (2 * np.pi / n,) * 3
    visc = 1.0 / 4000.0
    dt = 1e-3 * 128 / n
    cube = make_fused_projection((n,) * 3, dxs, torch.float32, device=DEVICE)
    proj = make_passB_sharded((n,) * 3, dxs, torch.float32, ly, device=DEVICE)
    theta = torch.full((1,), LES_THETA, device=DEVICE)
    d2 = float(sum(d * d for d in dxs))
    smag = (theta, d2)
    worst = 0.0
    for r in range(P):
        G, L = halo_kernel_inputs(n, P, r)
        xs = slice(r * lx, (r + 1) * lx)
        ys = slice(r * ly, (r + 1) * ly)
        # the force on planes -1 .. lx - 1 (rows r·lx - 1 .. r·lx + lx - 1)
        f, f_lo = smk._force_halo(L["u"], L["u_lo3"], L["u_hi2"], theta, dxs, d2,
                                  bodyforce=L["bf"], bodyforce_lo=L["bf_lo1"],
                                  rebuild_q=(L["q"], L["q_lo3"], L["q_hi3"]), x_first=-1)
        f_ref = smk.smagorinsky_force_3d(G["u"], theta, dxs, bodyforce=G["bf"],
                                         rebuild_q=G["q"])
        rows_m1 = torch.arange(r * lx - 1, (r + 1) * lx, device=DEVICE) % n
        pairs = {
            "smagorinsky_force_halo_3d": (
                (smk.smagorinsky_force_halo_3d(L["u"], L["u_lo2"], L["u_hi2"], theta, dxs),),
                (smk.smagorinsky_force_3d(G["u"], theta, dxs),)),
            "momentum_stage_divhat_halo_3d+smag": (
                sk.momentum_stage_divhat_halo_3d(
                    L["u"], L["u_lo3"], L["u_hi2"], (L["u"],), (L["u_lo1"],), (dt / 2,),
                    visc, dxs, proj["Vinv"], proj["VinvT"], emit_k=False,
                    usnew_coeff=dt / 6, smag=smag, bodyforce=L["bf"],
                    bodyforce_lo=L["bf_lo1"]),
                sk.momentum_stage_divhat_3d(
                    G["u"], (G["u"],), (dt / 2,), visc, dxs, cube["Vinv"], cube["VinvT"],
                    emit_k=False, usnew_coeff=dt / 6, smag=smag, bodyforce=G["bf"])),
            "pcmsd_hat_halo_3d+smag": (
                sk.pcmsd_hat_halo_3d(
                    L["u"], L["u_lo3"], L["u_hi2"], L["qhat"], L["qhat_lo3"], L["qhat_hi3"],
                    (L["ustart"],), (L["ustart_lo1"],), (dt / 2,), visc, dxs, proj,
                    emit_k=False, usnew_coeff=dt / 3, usnew_base=L["accb"], smag=smag,
                    bodyforce=L["bf"], bodyforce_lo=L["bf_lo1"]),
                sk.pcmsd_hat_3d(
                    G["u"], G["qhat"], (G["ustart"],), (dt / 2,), visc, dxs, cube,
                    emit_k=False, usnew_coeff=dt / 3, usnew_base=G["accb"], smag=smag,
                    bodyforce=G["bf"])),
            "momentum_stage_divhat_halo_3d+bodyforce": (
                sk.momentum_stage_divhat_halo_3d(
                    L["u"], L["u_lo2"], L["u_hi1"], (L["u"],), (L["u_lo1"],), (dt / 2,),
                    visc, dxs, proj["Vinv"], proj["VinvT"], emit_k=False,
                    usnew_coeff=dt / 6, bodyforce=L["bf"], bodyforce_lo=L["bf_lo1"]),
                sk.momentum_stage_divhat_3d(
                    G["u"], (G["u"],), (dt / 2,), visc, dxs, cube["Vinv"], cube["VinvT"],
                    emit_k=False, usnew_coeff=dt / 6, bodyforce=G["bf"])),
            "pcmsd_hat_halo_3d+bodyforce": (
                sk.pcmsd_hat_halo_3d(
                    L["u"], L["u_lo2"], L["u_hi1"], L["qhat"], L["qhat_lo2"], L["qhat_hi2"],
                    (L["ustart"],), (L["ustart_lo1"],), (dt / 2,), visc, dxs, proj,
                    emit_k=False, usnew_coeff=dt / 3, usnew_base=L["accb"],
                    bodyforce=L["bf"], bodyforce_lo=L["bf_lo1"]),
                sk.pcmsd_hat_3d(
                    G["u"], G["qhat"], (G["ustart"],), (dt / 2,), visc, dxs, cube,
                    emit_k=False, usnew_coeff=dt / 3, usnew_base=G["accb"],
                    bodyforce=G["bf"])),
            "pcmsd_hat_halo_3d+smag (RECON)": (
                sk.pcmsd_hat_halo_3d(
                    L["u"], L["u_lo3"], L["u_hi2"], L["qhat"], L["qhat_lo3"], L["qhat_hi3"],
                    (sk.RECON,), (sk.RECON,), (dt / 2,), visc, dxs, proj, emit_k=False,
                    usnew_coeff=dt / 6, emit_u=True, smag=smag),
                sk.pcmsd_hat_3d(
                    G["u"], G["qhat"], (sk.RECON,), (dt / 2,), visc, dxs, cube,
                    emit_k=False, usnew_coeff=dt / 6, emit_u=True, smag=smag)),
            "momentum_stage_divhat_halo_3d": (
                sk.momentum_stage_divhat_halo_3d(
                    L["u"], L["u_lo2"], L["u_hi1"], (L["u"],), (L["u_lo1"],), (dt / 2,),
                    visc, dxs, proj["Vinv"], proj["VinvT"], emit_k=False,
                    usnew_coeff=dt / 6),
                sk.momentum_stage_divhat_3d(
                    G["u"], (G["u"],), (dt / 2,), visc, dxs, cube["Vinv"], cube["VinvT"],
                    emit_k=False, usnew_coeff=dt / 6)),
            "pcmsd_hat_halo_3d": (
                sk.pcmsd_hat_halo_3d(
                    L["u"], L["u_lo2"], L["u_hi1"], L["qhat"], L["qhat_lo2"], L["qhat_hi2"],
                    (L["ustart"],), (L["ustart_lo1"],), (dt / 2,), visc, dxs, proj,
                    emit_k=False, usnew_coeff=dt / 3, usnew_base=L["accb"]),
                sk.pcmsd_hat_3d(
                    G["u"], G["qhat"], (G["ustart"],), (dt / 2,), visc, dxs, cube,
                    emit_k=False, usnew_coeff=dt / 3, usnew_base=G["accb"])),
            "pcmsd_hat_halo_3d (RECON)": (
                sk.pcmsd_hat_halo_3d(
                    L["u"], L["u_lo2"], L["u_hi1"], L["qhat"], L["qhat_lo2"], L["qhat_hi2"],
                    (sk.RECON,), (sk.RECON,), (dt / 2,), visc, dxs, proj, emit_k=False,
                    usnew_coeff=dt / 6, emit_u=True),
                sk.pcmsd_hat_3d(
                    G["u"], G["qhat"], (sk.RECON,), (dt / 2,), visc, dxs, cube,
                    emit_k=False, usnew_coeff=dt / 6, emit_u=True)),
            "pressure_correct_qhat_halo_3d": (
                (sk.pressure_correct_qhat_halo_3d(L["u"], L["qhat"], L["qhat_hi1"], dxs,
                                                  proj["V"], proj["VT"]),),
                (sk.pressure_correct_qhat_3d(G["u"], G["qhat"], dxs, cube["V"],
                                             cube["VT"]),)),
        }
        errs = {}
        for name, (got, ref) in pairs.items():
            # vectors (3, n, n, n) keep x-rows xs; scalars (n, n, n) too
            errs[name] = max(rel_err(g, (p[:, xs] if p.dim() == 4 else p[xs]))
                             for g, p in zip(got, ref))
        # the chain's force: rows r·lx - 1 .. r·lx + lx - 1, plane -1 included
        errs["smagorinsky_force_halo_3d (rebuild, bodyforce, plane -1)"] = rel_err(
            torch.cat([f_lo, f], dim=1), f_ref.index_select(1, rows_m1))
        got = proj["passB"](L["h"], r * ly)
        ref = cube["passB"](G["divhat"])[:, ys]
        errs["passB_sharded"] = rel_err(got, ref)
        torch.cuda.synchronize()
        print(f"[halo kernels] n={n}, x-slab {r} of {P} (lx = {lx}; pass B y-columns "
              f"[{r * ly}, {(r + 1) * ly}), yoff {r * ly}): max rel err against the "
              "single-device kernels' rows " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        worst = max(worst, *errs.values())
        if not all(math.isfinite(v) and v <= REL_TOL for v in errs.values()):
            fail(f"halo kernels on x-slab {r} disagree with the single-device kernels: {errs}")
        del G, L, pairs, f, f_lo, f_ref
    torch.cuda.empty_cache()
    return worst


def halo_ms_per_step(chains, dt, theta, steps=10):
    """ms/step of each ``{name: ((to_hat, step_hat, from_hat), state)}``
    chain, in turns (first, second, second, first), each after two
    warm-up steps."""
    import torch

    a, b = chains
    times = {a: [], b: []}
    for which in (a, b, b, a):
        (to_h, step_h, _), st = chains[which]
        h = step_h(step_h(to_h(st), dt, theta), dt, theta)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            h = step_h(h, dt, theta)
        torch.cuda.synchronize()
        times[which].append((time.perf_counter() - t) * 1e3 / steps)
        del h
    return times


def phase_halo(n, nsteps, chunk, u0, profile=False):
    """`solve_unsteady(mesh=make_mesh(), halo=True)` on a one-rank NCCL
    group: checks, agreement with the single-device hat chain, launches,
    ms/step of both in turns."""
    import torch
    import torch.distributed as dist

    import ins_tpu_torch as it
    from ins_tpu_torch.ops import launches
    from ins_tpu_torch.ops.fastpath import make_fast_timestep_hat, strip_ghosts, strip_state
    from ins_tpu_torch.parallel import make_halo_fast_step, make_mesh, shard_interior

    setup = headline_setup(n)
    dt = 1e-3 * 128 / n
    method = it.RKMethods.RK44()
    mesh = make_mesh()
    print(f"[halo] mesh: {mesh.size} rank(s) along x, backend "
          f"{dist.get_backend(mesh.group)}, device {mesh.device}")
    torch.cuda.synchronize()
    launches.reset_counts()
    t0 = time.perf_counter()
    state, outs = it.solve_unsteady(
        setup=setup, ustart=u0, tlims=(0.0, nsteps * dt), dt=dt, method=method, mesh=mesh,
        halo=True, processors={"log": it.timelogger(nupdate=chunk)},
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = run_counts()
    plain = dict(launches.PLAIN_ON_CUDA)
    print(f"[halo] solve_unsteady(mesh=make_mesh(), halo=True) {n}^3 RK44 f32: {nsteps} "
          f"steps in chunks of {chunk}, {wall:.3f} s wall (first call included); launches "
          f"{ {k: v for k, v in counts.items() if v} }; plain calls on CUDA "
          f"{ {k: v for k, v in plain.items() if v} }")
    if state.n != nsteps:
        fail(f"the halo run ran {state.n} steps, expected {nsteps}")
    u = strip_ghosts(state.u)
    if not bool(torch.isfinite(u).all()):
        fail("non-finite velocity after the halo run")
    nchunk = nsteps // chunk
    keys = form_keys()
    expect = {"momentum_stage_divhat_halo_3d": nchunk, "pcmsd_hat_halo_3d": 4 * nsteps - nchunk,
              keys["passB_sharded"]: 4 * nsteps, "passB_sharded+levels": 0,
              "pressure_correct_qhat_halo_3d": nchunk}
    got = {k: counts[k] for k in expect}
    if got != expect:
        fail(f"halo launches {got}, expected {expect}")
    single = [k for k in ("pcmsd_hat_3d", "momentum_stage_divhat_3d", keys["passB_fold"],
                          "pressure_correct_qhat_3d") if counts[k]]
    if single or any(plain.values()):
        fail(f"the halo run launched single-device kernels {single} or plain versions {plain}")
    check_divergence(u, float(setup.grid.delta[0][0]), "halo")

    # the single-device hat chain (kernels) from the same u0
    launches.reset_counts()
    ref, _ = it.solve_unsteady(setup=setup, ustart=u0, tlims=(0.0, nsteps * dt), dt=dt,
                               method=method, psolver=it.psolver_spectral(setup),
                               processors={"log": it.timelogger(nupdate=chunk)})
    agree = rel_err(u, strip_ghosts(ref.u))
    print(f"[halo] halo chain vs single-device hat chain after {nsteps} steps: max rel diff "
          f"{agree:.3e}")
    if not agree <= REL_TOL:
        fail(f"the halo chain and the single-device hat chain disagree by {agree:.3e}")
    e_end = it.total_kinetic_energy(state.u, setup).item()
    del ref, state

    s0 = strip_state(it.create_stepper(method, setup=setup, u=u0))
    halo_hat = make_halo_fast_step(setup, method, mesh).hat
    chains = {"halo": (halo_hat, s0._replace(u=shard_interior(mesh, s0.u))),
              "single": (make_fast_timestep_hat(setup, method), s0)}
    times = halo_ms_per_step(chains, dt, None)
    mh, ms = sum(times["halo"]) / 2, sum(times["single"]) / 2
    print(f"[halo] {n}^3 RK44 f32 on {mesh.size} rank: halo chain {mh:.3f} ms/step "
          f"({times['halo'][0]:.3f}, {times['halo'][1]:.3f}), single-device hat chain "
          f"{ms:.3f} ms/step ({times['single'][0]:.3f}, {times['single'][1]:.3f}); card "
          f"{card_line()}; after the timing (SM clock, power draw, temperature): "
          f"{card_line('clocks.sm,power.draw,temperature.gpu')}")
    if profile:
        to_h, step_h, _ = halo_hat
        phase_profile_split("halo step", setup, method, u0, dt,
                            chain=(to_h, step_h, chains["halo"][1]))
    dist.destroy_process_group()
    return counts, e_end


# --------------------------------------------------------------------------
# phase 9: the Smagorinsky LES on the x-slab halo chain
# --------------------------------------------------------------------------


def halo_bodyforce(dim, *xt):
    """A steady force: (0.5 sin y, 0.25 cos x, 0)."""
    import torch

    return (dim == 0) * 0.5 * torch.sin(xt[1]) + (dim == 1) * 0.25 * torch.cos(xt[0])


def phase_halo_les(n, nsteps, chunk, u0, e_halo, profile=False):
    """`solve_unsteady(mesh=make_mesh(), halo=True, theta=)` of phase 5's
    LES on a one-rank NCCL group: checks, launches, agreement with the
    single-device LES chain, ms/step of both in turns; then 64³ halo runs
    with a steady body force, with the LES and alone, each against its
    single-device chain."""
    import torch
    import torch.distributed as dist

    import ins_tpu_torch as it
    from ins_tpu_torch.ops import launches
    from ins_tpu_torch.ops.fastpath import make_fast_timestep_hat, strip_ghosts, strip_state
    from ins_tpu_torch.parallel import make_halo_fast_step, make_mesh, shard_interior

    setup = les_setup(n)
    dt = 1e-3 * 128 / n
    method = it.RKMethods.RK44()
    mesh = make_mesh()
    print(f"[halo les] mesh: {mesh.size} rank(s) along x, backend "
          f"{dist.get_backend(mesh.group)}, device {mesh.device}")
    torch.cuda.synchronize()
    launches.reset_counts()
    t0 = time.perf_counter()
    state, outs = it.solve_unsteady(
        setup=setup, ustart=u0, tlims=(0.0, nsteps * dt), dt=dt, method=method, mesh=mesh,
        halo=True, theta=LES_THETA,
        processors={"log": it.timelogger(nupdate=chunk),
                    "spec": it.observespectrum(setup, nupdate=chunk),
                    "energy": it.observefield(
                        lambda s: it.total_kinetic_energy(s["u"], setup), nupdate=chunk)},
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = run_counts()
    plain = dict(launches.PLAIN_ON_CUDA)
    print(f"[halo les] solve_unsteady(mesh=make_mesh(), halo=True, theta={LES_THETA}) {n}^3 "
          f"RK44 f32 Re=4000: {nsteps} steps in chunks of {chunk}, {wall:.3f} s wall (first "
          f"call included); launches { {k: v for k, v in counts.items() if v} }; plain calls "
          f"on CUDA { {k: v for k, v in plain.items() if v} }")
    if state.n != nsteps:
        fail(f"the halo LES ran {state.n} steps, expected {nsteps}")
    u = strip_ghosts(state.u)
    if not bool(torch.isfinite(u).all()):
        fail("non-finite velocity after the halo LES run")
    nchunk = nsteps // chunk
    keys = form_keys()
    expect = {"smagorinsky_force_halo_3d": 4 * nsteps,
              "momentum_stage_divhat_halo_3d+force": nchunk,
              "pcmsd_hat_halo_3d+force": 4 * nsteps - nchunk,
              keys["passB_sharded"]: 4 * nsteps, "pressure_correct_qhat_halo_3d": nchunk,
              "momentum_stage_divhat_halo_3d": 0, "pcmsd_hat_halo_3d": 0}
    got = {k: counts[k] for k in expect}
    if got != expect:
        fail(f"halo LES launches {got}, expected {expect}")
    single = [k for k in ("pcmsd_hat_3d", "momentum_stage_divhat_3d", keys["passB_fold"],
                          "pressure_correct_qhat_3d", "smagorinsky_force_3d") if counts[k]]
    if single or any(plain.values()):
        fail(f"the halo LES launched single-device kernels {single} or plain versions {plain}")
    check_divergence(u, float(setup.grid.delta[0][0]), "halo les")
    e0 = it.total_kinetic_energy(u0, setup).item()
    e1 = it.total_kinetic_energy(state.u, setup).item()
    hist = [float(v) for v in outs["energy"]]
    print(f"[halo les] kinetic energy {e0:.9e} -> {e1:.9e} (at the chunk ends "
          + ", ".join(f"{v:.9e}" for v in hist) + f"); phase 8's halo run without the "
          f"closure {e_halo:.9e}")
    if not (e1 <= e0 and all(b <= a for a, b in zip([e0] + hist, hist))):
        fail("halo LES kinetic energy increased")
    if not e1 < e_halo:
        fail("the halo LES did not dissipate: its energy is not below phase 8's halo run")
    spec = outs["spec"]
    nk = len(spec["kappa"])
    if len(spec["ehat"]) != nchunk or not all(
            e.shape == (nk,) and np.isfinite(e).all() for e in spec["ehat"]):
        fail(f"halo LES spectrum records {[e.shape for e in spec['ehat']]}, expected "
             f"{nchunk} finite ({nk},) arrays")

    # phase 5's single-device LES chain (kernels) from the same u0
    ref, _ = it.solve_unsteady(setup=setup, ustart=u0, tlims=(0.0, nsteps * dt), dt=dt,
                               method=method, psolver=it.psolver_spectral(setup),
                               theta=LES_THETA)
    agree = rel_err(u, strip_ghosts(ref.u))
    print(f"[halo les] halo LES chain vs single-device LES chain after {nsteps} steps: max "
          f"rel diff {agree:.3e}")
    if not agree <= REL_TOL:
        fail(f"the halo LES and the single-device LES chains disagree by {agree:.3e}")
    del ref, state

    theta = torch.full((), LES_THETA, device=DEVICE)
    s0 = strip_state(it.create_stepper(method, setup=setup, u=u0))
    halo_hat = make_halo_fast_step(setup, method, mesh).hat
    chains = {"halo": (halo_hat, s0._replace(u=shard_interior(mesh, s0.u))),
              "single": (make_fast_timestep_hat(setup, method), s0)}
    times = halo_ms_per_step(chains, dt, theta)
    mh, ms = sum(times["halo"]) / 2, sum(times["single"]) / 2
    print(f"[halo les] {n}^3 RK44 f32 + Smagorinsky on {mesh.size} rank: halo chain "
          f"{mh:.3f} ms/step ({times['halo'][0]:.3f}, {times['halo'][1]:.3f}), "
          f"single-device LES chain {ms:.3f} ms/step ({times['single'][0]:.3f}, "
          f"{times['single'][1]:.3f}); card {card_line()}; after the timing (SM clock, "
          f"power draw, temperature): {card_line('clocks.sm,power.draw,temperature.gpu')}")
    if profile:
        to_h, step_h, _ = halo_hat
        phase_profile_split("halo LES step", setup, method, u0, dt, theta=theta,
                            chain=(to_h, step_h, chains["halo"][1]))
    del chains, s0

    # 64^3: a steady body force with the LES and alone (the FORCE stages
    # without the force kernel, 2 + 1 ghosts), halo against single-device
    m = 64
    bdt = 1e-3 * 128 / m
    nch = nsteps // chunk
    for tag, bsetup, th, nforce in (
            ("LES + steady body force", les_setup(m, bodyforce=halo_bodyforce), LES_THETA,
             4 * nsteps),
            ("steady body force alone", headline_setup(m, bodyforce=halo_bodyforce), None, 0)):
        bu0 = it.random_field(bsetup, kp=4,
                              generator=torch.Generator(device=DEVICE).manual_seed(2))
        kw = dict(setup=bsetup, ustart=bu0, tlims=(0.0, nsteps * bdt), dt=bdt,
                  method=method, theta=th, processors={"log": it.timelogger(nupdate=chunk)})
        launches.reset_counts()
        hs, _ = it.solve_unsteady(mesh=mesh, halo=True, **kw)
        bcounts = run_counts()
        bplain = dict(launches.PLAIN_ON_CUDA)
        ss, _ = it.solve_unsteady(psolver=it.psolver_spectral(bsetup), **kw)
        bu = strip_ghosts(hs.u)
        if not bool(torch.isfinite(bu).all()):
            fail(f"non-finite velocity after the {m}^3 halo run, {tag}")
        check_divergence(bu, float(bsetup.grid.delta[0][0]), f"halo {tag}")
        bagree = rel_err(bu, strip_ghosts(ss.u))
        print(f"[halo les] {m}^3 {tag}, {nsteps} steps: halo vs single-device chain max rel "
              f"diff {bagree:.3e}; halo launches { {k: v for k, v in bcounts.items() if v} }")
        bexpect = {"smagorinsky_force_halo_3d": nforce,
                   "momentum_stage_divhat_halo_3d+force": nch,
                   "pcmsd_hat_halo_3d+force": 4 * nsteps - nch,
                   "momentum_stage_divhat_halo_3d": 0, "pcmsd_hat_halo_3d": 0}
        bgot = {k: bcounts[k] for k in bexpect}
        if bgot != bexpect or any(bplain.values()):
            fail(f"the {m}^3 halo run ({tag}) launched {bgot}, expected {bexpect}; plain "
                 f"versions {bplain}")
        if not bagree <= REL_TOL:
            fail(f"the {m}^3 halo run ({tag}) disagrees with its single-device chain by "
                 f"{bagree:.3e}")
        del hs, ss, bu, bu0
    dist.destroy_process_group()
    counts["momentum_stage_divhat_halo_3d+smag"] = counts["momentum_stage_divhat_halo_3d+force"]
    counts["pcmsd_hat_halo_3d+smag"] = counts["pcmsd_hat_halo_3d+force"]
    return counts


# --------------------------------------------------------------------------
# phase 10: the fused unmerged chain and bf16 stream storage
# --------------------------------------------------------------------------


def unmerged_kernel_cases(n):
    """The stage and correction kernels with bf16 stream storage and the
    stage with more than four k streams at size n, against their plain
    versions; the first case of each has the shapes and options phase
    10's runs give it."""
    import torch

    from ins_tpu_torch.ops import stage_kernels as sk
    from ins_tpu_torch.ops.poisson_kernels import make_fused_projection

    rng = np.random.default_rng(SEED + 10 + n)
    dev = torch.device(DEVICE)
    bf16 = torch.bfloat16

    def field(*shape, scale=1.0, dtype=torch.float32):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(dev).to(dtype)

    dxs = (2 * np.pi / n,) * 3
    visc = 1.0 / 4000.0
    dt = 1e-3 * 128 / n
    proj = make_fused_projection((n,) * 3, dxs, torch.float32, device=dev)
    Vinv, VinvT, V, VT = proj["Vinv"], proj["VinvT"], proj["V"], proj["VT"]
    mats = (Vinv, VinvT, V, VT)
    cells, gemm = n**3, 2.0 * n**4 * GEMM_BF16X3_AS_FP32
    qhat = field(n, n, n, scale=1e-3)
    bf = field(3, n, n, n)  # a float32 body force: the wrappers round it
    # bf16 storage: u (ut_prev), the base, the accumulator, k streams
    u, ustart, accb = (field(3, n, n, n, dtype=bf16) for _ in range(3))
    kb = [field(3, n, n, n, dtype=bf16) for _ in range(2)]
    # float32 storage with 9 k streams (SSP104's last stage)
    u32, ustart32 = field(3, n, n, n), field(3, n, n, n)
    k32 = [field(3, n, n, n) for _ in range(9)]
    c9 = tuple(dt * (0.05 + 0.01 * j) for j in range(9)) + (dt / 10,)

    def msd(impl, uu, streams, coeffs, **kw):
        return lambda: impl(uu, streams, coeffs, visc, dxs, Vinv, VinvT,
                            compute_dtype=torch.float32, **kw)

    def pcmsd(impl, streams, coeffs, **kw):
        return lambda: impl(u, qhat, streams, coeffs, visc, dxs, proj, **kw)

    def correct(impl, out_dtype):
        return lambda: (impl(u, qhat, dxs, V, VT, out_dtype=out_dtype),)

    def stage_ops(m, rebuild=False):
        key = "stage" if rebuild else "stage_norebuild"
        return ((OPS_PER_CELL[key] + m * OPS_PER_CELL["tableau_stream"]) * cells
                + (4 if rebuild else 2) * gemm)

    based = dict(emit_k=False, usnew_coeff=dt / 3, usnew_base=accb)
    M, MP = sk.momentum_stage_divhat_3d, sk.momentum_stage_divhat_3d_plain
    P, PP = sk.pcmsd_hat_3d, sk.pcmsd_hat_3d_plain
    return {
        "momentum_stage_divhat_3d+bf16": [
            Case("k streams (ustart, k1) + emit_k (SSP33 stage 1)",
                 msd(M, u, (ustart, kb[0]), (dt / 4, dt / 4)),
                 msd(MP, u, (ustart, kb[0]), (dt / 4, dt / 4)),
                 inputs=(u, ustart, kb[0], Vinv, VinvT), ops=stage_ops(1)),
            Case("stage 0 (u base) + usnew (RK44 stage 0)",
                 msd(M, u, (u,), (dt / 2,), emit_k=False, usnew_coeff=dt / 6),
                 msd(MP, u, (u,), (dt / 2,), emit_k=False, usnew_coeff=dt / 6),
                 inputs=(u, Vinv, VinvT), ops=stage_ops(0)),
            Case("stream base + usnew_base + bodyforce",
                 msd(M, u, (ustart,), (dt / 2,), bodyforce=bf, **based),
                 msd(MP, u, (ustart,), (dt / 2,), bodyforce=bf, **based),
                 inputs=(u, ustart, accb, bf.to(bf16), Vinv, VinvT), ops=stage_ops(0)),
            Case("2 k streams, the last stage (SSP33 stage 2)",
                 msd(M, u, (ustart, *kb), (dt / 6, dt / 6, 2 * dt / 3), emit_k=False),
                 msd(MP, u, (ustart, *kb), (dt / 6, dt / 6, 2 * dt / 3), emit_k=False),
                 inputs=(u, ustart, *kb, Vinv, VinvT), ops=stage_ops(2)),
        ],
        "pcmsd_hat_3d+bf16": [
            Case("stream base + usnew_base (RK44 stages 1-2)",
                 pcmsd(P, (ustart,), (dt / 2,), **based),
                 pcmsd(PP, (ustart,), (dt / 2,), **based),
                 inputs=(u, qhat, ustart, accb, *mats), ops=stage_ops(0, rebuild=True)),
            Case("RECON + emit_u + usnew (RK44 stage 0)",
                 pcmsd(P, (sk.RECON,), (dt / 2,), emit_k=False, usnew_coeff=dt / 6,
                       emit_u=True),
                 pcmsd(PP, (sk.RECON,), (dt / 2,), emit_k=False, usnew_coeff=dt / 6,
                       emit_u=True),
                 inputs=(u, qhat, *mats), ops=stage_ops(0, rebuild=True)),
            Case("stream base + usnew_base + bodyforce",
                 pcmsd(P, (ustart,), (dt / 2,), bodyforce=bf, **based),
                 pcmsd(PP, (ustart,), (dt / 2,), bodyforce=bf, **based),
                 inputs=(u, qhat, ustart, accb, bf.to(bf16), *mats),
                 ops=stage_ops(0, rebuild=True)),
        ],
        "pressure_correct_qhat_3d+bf16": [
            Case("ut bf16 -> u bf16 (the unmerged chain's stages)",
                 correct(sk.pressure_correct_qhat_3d, bf16),
                 correct(sk.pressure_correct_qhat_3d_plain, bf16),
                 inputs=(u, qhat, V, VT), ops=OPS_PER_CELL["correct"] * cells + 2 * gemm),
            Case("ut bf16 -> u float32 (the hat chain's chunk ends)",
                 correct(sk.pressure_correct_qhat_3d, None),
                 correct(sk.pressure_correct_qhat_3d_plain, None),
                 inputs=(u, qhat, V, VT), ops=OPS_PER_CELL["correct"] * cells + 2 * gemm),
        ],
        "momentum_stage_divhat_3d+streams": [
            Case("9 k streams (SSP104's last stage)",
                 msd(M, u32, (ustart32, *k32), c9, emit_k=False),
                 msd(MP, u32, (ustart32, *k32), c9, emit_k=False),
                 inputs=(u32, ustart32, *k32, Vinv, VinvT), ops=stage_ops(9)),
            Case("5 k streams + emit_k (SSP104 stage 5)",
                 msd(M, u32, (ustart32, *k32[:5]), c9[:5] + (dt / 10,)),
                 msd(MP, u32, (ustart32, *k32[:5]), c9[:5] + (dt / 10,)),
                 inputs=(u32, ustart32, *k32[:5], Vinv, VinvT), ops=stage_ops(5)),
            Case("9 k streams + emit_k + usnew + bodyforce",
                 msd(M, u32, (ustart32, *k32), c9, usnew_coeff=dt / 3, bodyforce=bf),
                 msd(MP, u32, (ustart32, *k32), c9, usnew_coeff=dt / 3, bodyforce=bf),
                 inputs=(u32, ustart32, *k32, bf, Vinv, VinvT), ops=stage_ops(9)),
            Case("9 k streams, bf16 storage",
                 msd(M, u, (ustart, *kb, *kb, *kb, *kb, kb[0]), c9, emit_k=False),
                 msd(MP, u, (ustart, *kb, *kb, *kb, *kb, kb[0]), c9, emit_k=False)),
        ],
    }


def _same(s):
    return s


def print_chains_ms(tag, label, times):
    (a, ta), (b, tb) = times.items()
    ma, mb = sum(ta) / 2, sum(tb) / 2
    print(f"[{tag}] {label}: {a} {ma:.3f} ms/step ({ta[0]:.3f}, {ta[1]:.3f}), {b} "
          f"{mb:.3f} ms/step ({tb[0]:.3f}, {tb[1]:.3f}), {a}/{b} {ma / mb:.3f}; card "
          f"{card_line()}, after the timing {card_line('clocks.sm,power.draw,temperature.gpu')}")


def energy_balance(setup, fns, s0, dt, nsteps=10):
    """max over steps of |dE/dt + 2νZ| / (2νZ) along a chain whose u is
    read every step (`benchmarks/bf16_stream_probe.py`'s measure): E =
    ½Σu²·vol, Z = ½Σ_ab (D⁺_b u_a)²·vol, dE/dt by centred differences."""
    import torch

    dx = float(setup.grid.delta[0][0])
    vol, nu = dx**3, 1.0 / float(setup.Re)
    to, step, frm = fns
    h = to(s0)
    E, Z = [], []
    for k in range(nsteps + 1):
        u = frm(h).u.double()
        E.append(0.5 * u.pow(2).sum().item() * vol)
        Z.append(0.5 * vol * sum(((torch.roll(u[a], -1, dims=b) - u[a]) / dx).pow(2).sum().item()
                                 for a in range(3) for b in range(3)))
        del u
        if k < nsteps:
            h = step(h, dt)
    return max(abs((E[k + 1] - E[k - 1]) / (2 * dt) + 2 * nu * Z[k]) / (2 * nu * Z[k])
               for k in range(1, nsteps))


def phase_unmerged(n, nsteps, chunk, u0, profile=False):
    """Paths A (SSP33 on the fused unmerged chain), B (bf16 stream storage
    on the RK44 hat chain and the SSP33 unmerged chain) and C (SSP104, the
    many-stream stage) at n³ through `solve_unsteady`; returns the launch
    counts of the new kernels."""
    import torch

    import ins_tpu_torch as it
    from ins_tpu_torch.ops import launches
    from ins_tpu_torch.ops.fastpath import (
        make_fast_timestep, make_fast_timestep_hat, reghost, strip_ghosts, strip_state,
    )

    setup = headline_setup(n)
    dx = float(setup.grid.delta[0][0])
    dt = 1e-3 * 128 / n
    bf16 = torch.bfloat16
    rk44, ssp33, ssp104 = it.RKMethods.RK44(), it.RKMethods.SSP33(), it.RKMethods.SSP104()
    keys = form_keys()

    def solve(tag, method, steps, ck, want=None, **kw):
        """`solve_unsteady` from u0 with a timelogger and the energy at chunk
        ends; holds the launches (other than the plane transforms) to
        ``want``.  Returns (u, launches, energies)."""
        torch.cuda.synchronize()
        launches.reset_counts()
        t0 = time.perf_counter()
        state, outs = it.solve_unsteady(
            setup=setup, ustart=u0, tlims=(0.0, steps * dt), dt=dt, method=method,
            psolver=it.psolver_spectral(setup),
            processors={"log": it.timelogger(nupdate=ck),
                        "energy": it.observefield(
                            lambda s: it.total_kinetic_energy(s["u"], setup), nupdate=ck)},
            **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in run_counts().items() if v}
        plain = {k: v for k, v in launches.PLAIN_ON_CUDA.items() if v}
        print(f"[{tag}] solve_unsteady {n}^3: {steps} steps in chunks of {ck}, {wall:.3f} s "
              f"wall (first call included); launches {counts}; plain calls on CUDA {plain}")
        if state.n != steps:
            fail(f"{tag}: ran {state.n} steps, expected {steps}")
        if plain:
            fail(f"{tag}: plain versions ran on CUDA tensors: {plain}")
        got = {k: v for k, v in counts.items() if k != keys["plane_transform"]}
        if want is not None and (got != want or not counts.get(keys["plane_transform"])):
            fail(f"{tag}: launches {counts}, expected {want} and the plane transforms")
        u = strip_ghosts(state.u)
        if u.dtype != torch.float32 or not bool(torch.isfinite(u).all()):
            fail(f"{tag}: the result is not a finite float32 field ({u.dtype})")
        return u, counts, [float(v) for v in outs["energy"]]

    def energies(tag, hist):
        e0 = it.total_kinetic_energy(u0, setup).item()
        print(f"[{tag}] kinetic energy {e0:.9e} -> " + ", ".join(f"{v:.9e}" for v in hist)
              + " (chunk ends)")
        return all(b <= a for a, b in zip([e0] + hist, hist))

    def agree(tag, u, fns, steps, ck, tol):
        s = run_plain_chain(setup, None, s0, dt, steps, ck, fns=fns)
        err = rel_err(u, s.u.float())
        print(f"[{tag}] kernel chain vs plain chain after {steps} steps: max|Δu|/max|u| "
              f"{err:.3e} (bound {tol:.0e})")
        if not err <= tol:
            fail(f"{tag}: kernel and plain chains disagree by {err:.3e} > {tol:.0e}")

    def energy(u):
        return it.total_kinetic_energy(reghost(u), setup).item()

    def agree_bf16(tag, u, method, u32):
        """Each step of the bf16 kernel chain against the plain step on the
        same carry, then the two chains over the run (module constants)."""
        fk = make_fast_timestep_hat(setup, method, stream_dtype=bf16)
        fp = make_fast_timestep_hat(setup, method, stream_dtype=bf16, plain=True)
        worst, s = 0.0, s0
        for k in range(nsteps):
            if k % chunk == 0:
                h = fk[0](s)
            hk = fk[1](h, dt)
            worst = max(worst, rel_err(fk[2](hk).u, fp[2](fp[1](h, dt)).u))
            h = hk
            if (k + 1) % chunk == 0:
                s = fk[2](h)
        up = run_plain_chain(setup, None, s0, dt, nsteps, chunk, fns=fp).u
        dmax, dl2, l2_32 = rel_err(u, up), rel_l2(u, up), rel_l2(up, u32)
        de = abs(energy(u) - energy(up)) / energy(up)
        print(f"[{tag}] each step vs the plain step on the same carry: max|Δu|/max|u| <= "
              f"{worst:.3e} (bound {BF16_CHAIN_TOL:.0e}); after {nsteps} steps vs the plain "
              f"chain: max|Δu|/max|u| {dmax:.3e}, relative L2 {dl2:.3e} (bound: the plain "
              f"chain's from the float32 chain, {l2_32:.3e}), kinetic energy {de:.3e} "
              f"(bound {BF16_ENERGY_TOL:.0e})")
        if not worst <= BF16_CHAIN_TOL:
            fail(f"{tag}: a kernel step and the plain step disagree by {worst:.3e}")
        if not (dl2 <= l2_32 and de <= BF16_ENERGY_TOL):
            fail(f"{tag}: the kernel and plain bf16 chains drift apart (L2 {dl2:.3e}, "
                 f"energy {de:.3e})")

    s0 = strip_state(it.create_stepper(ssp33, setup=setup, u=u0))
    per = nsteps // chunk
    # path A: SSP33 on the fused unmerged chain
    u_a, _, hist = solve("unmerged", ssp33, nsteps, chunk, want={
        "momentum_stage_divhat_3d": 3 * nsteps, keys["passB_fold"]: 3 * nsteps,
        "pressure_correct_qhat_3d": 3 * nsteps})
    check_divergence(u_a, dx, "unmerged")
    if not energies("unmerged", hist):
        fail("SSP33 kinetic energy increased")
    agree("unmerged", u_a, (_same, make_fast_timestep(setup, ssp33, plain=True), _same),
          nsteps, chunk, REL_TOL)
    print_chains_ms("unmerged", f"{n}^3 SSP33 f32", chains_ms_per_step({
        "kernels": (_same, make_fast_timestep(setup, ssp33), _same),
        "roll twin": (_same, make_fast_timestep(setup, ssp33, _force_roll=True), _same)},
        s0, dt))
    if profile:
        phase_profile_split("SSP33 unmerged step", setup, ssp33, u0, dt,
                            chain=(_same, make_fast_timestep(setup, ssp33), s0))

    # path B: bf16 stream storage on the RK44 hat chain and the SSP33 unmerged chain
    u_rk, _, _ = solve("bf16", rk44, nsteps, chunk)  # the float32 hat chain
    bf_counts = {}
    for name, method, u32, want in (
        ("RK44 hat chain", rk44, u_rk, {
            "momentum_stage_divhat_3d+bf16": per, "pcmsd_hat_3d+bf16": 4 * nsteps - per,
            keys["passB_fold"]: 4 * nsteps, "pressure_correct_qhat_3d+bf16": per}),
        ("SSP33 unmerged chain", ssp33, u_a, {
            "momentum_stage_divhat_3d+bf16": 3 * nsteps, keys["passB_fold"]: 3 * nsteps,
            "pressure_correct_qhat_3d+bf16": 3 * nsteps}),
    ):
        tag = f"bf16 {name}"
        u, counts, hist = solve(tag, method, nsteps, chunk, want=want, stream_dtype=bf16)
        for k, v in counts.items():
            bf_counts[k] = bf_counts.get(k, 0) + v
        check_divergence(u, dx, tag, unscaled_tol=BF16_DIV_TOL)
        energies(tag, hist)
        print(f"[{tag}] bf16 vs float32 chain after {nsteps} steps: max|Δu|/max|u| "
              f"{rel_err(u, u32):.3e}, relative L2 {rel_l2(u, u32):.3e}, kinetic energy "
              f"{energy(u):.9e} vs {energy(u32):.9e}")
        agree_bf16(tag, u, method, u32)
        f32 = (make_fast_timestep_hat(setup, method) if method is rk44
               else (_same, make_fast_timestep(setup, method), _same))
        bfc = make_fast_timestep_hat(setup, method, stream_dtype=bf16)
        print_chains_ms(tag, f"{n}^3 {name}", chains_ms_per_step(
            {"bf16": bfc, "float32": f32}, s0, dt))
        e32, ebf = energy_balance(setup, f32, s0, dt), energy_balance(setup, bfc, s0, dt)
        print(f"[{tag}] energy balance max|dE/dt + 2 nu Z|/(2 nu Z) over 10 steps: float32 "
              f"{e32:.3e}, bf16 {ebf:.3e}")
        if profile:
            phase_profile_split(f"{name} step, bf16 streams", setup, method, u0, dt,
                                chain=(bfc[0], bfc[1], s0))

    # path C: SSP104, 5 of its 10 stages with more than 4 k streams
    u_c, c_counts, _ = solve("streams", ssp104, 4, 2, want={
        "momentum_stage_divhat_3d": 20, "momentum_stage_divhat_3d+streams": 20,
        keys["passB_fold"]: 40, "pressure_correct_qhat_3d": 40})
    check_divergence(u_c, dx, "streams")
    agree("streams", u_c, (_same, make_fast_timestep(setup, ssp104, plain=True), _same), 4, 2,
          REL_TOL)
    return {**{k: bf_counts.get(k, 0) for k in UNMERGED_KERNELS[:3]},
            "momentum_stage_divhat_3d+streams": c_counts.get("momentum_stage_divhat_3d+streams",
                                                             0)}


# --------------------------------------------------------------------------
# phase 11: the tap-matmul / pack-tile conv layer and the unfused stage
# --------------------------------------------------------------------------

# `benchmarks/conv_probe.py`'s closure stack (phase 3's CNN): per layer
# (cin, cout, activation, bias), radius 2
TAP_LAYERS = ((3, 24, "tanh", True), (24, 24, "tanh", True), (24, 3, "id", False))
TAP_OUT_TOL_F32 = 1e-4
# the ragged box of the tensor-core cases (nx, ny, nz): odd ny and nz, a
# partial tile in y and z
TAP_RAGGED_BOX = (8, 37, 67)
# (kc, cout, act, label) of the ragged cases: the stack's three forwards
# (the first layer's kc = 15, which the wrapper pads to 16), a 13-channel
# output (two n8 tiles), and the input-gradient shapes (kc = the
# cotangent's channels, cout = the layer's kc: 120 in three blocks of five
# n8 tiles, 16, and a 3-channel cotangent padded to 8)
TAP_RAGGED = ((15, 24, "tanh", "3->24"), (120, 24, "tanh", "24->24"), (120, 3, "id", "24->3"),
              (120, 13, "tanh", "120->13"), (24, 120, "id", "dG 24->120"),
              (24, 16, "id", "dG 24->16"), (3, 120, "id", "dG 3->120"))


def tap_kernel_cases(n):
    """{kernel name: [Case, ...]} for the tap-matmul / pack-tile kernels at
    n (128: the closure stack's full width): the 24 -> 24 layer's z-folded
    g (n + 4, n + 4, n, 120) in bf16 through both forwards (the tensor-core
    kernels), the 24 -> 3 identity layer (all 25 taps pack), the input
    gradient's shape (the cotangent padded to (n + 8, n + 8, n, 24), taps
    (5, 5, 24, 120)) and the weight gradient on (g, dpre (n, n, n, 24));
    float32 outputs, the weight gradient held against the plain version in
    float64; the same forwards on float32 operands (``+f32``, 3xTF32: the
    tap forward; the pack forward of the stack's three layers, the pack
    kernel at 24 -> 3 and the tap kernel at 24 -> 24 and 3 -> 24, on
    operands with full float32 mantissas, held against the plain version
    in float64) and the float32 weight gradients (3xTF32) of the stack's
    three shapes on operands with full float32 mantissas.  Then the
    tensor-core kernels on `TAP_RAGGED_BOX` for each of `TAP_RAGGED` at
    ky = kx = 3, 5 and 7, bf16 and float32 outputs, against the plain
    version in float64.  The library yardsticks are cuDNN's
    conv3d with a (5, 5, 1) kernel and its conv3d_weight on the same
    operands."""
    import torch
    import torch.nn.functional as F

    from ins_tpu_torch.ops import conv_kernels as ck

    rng = np.random.default_rng(SEED + 11 * n)
    dev = torch.device(DEVICE)
    bf = torch.bfloat16

    def field(*shape, scale=1.0, dtype=torch.float32):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(dev).to(dtype)

    kc = 5 * 24
    g = field(n + 4, n + 4, n, kc, dtype=bf)
    g16 = field(n + 4, n + 4, n, 16, dtype=bf)  # the 3 -> 24 layer's g (15 channels, padded)
    w24, w3 = field(5, 5, kc, 24, scale=(125 * 24) ** -0.5), field(5, 5, kc, 3, scale=0.02)
    b24 = field(24, scale=0.1)
    ctp = field(n + 8, n + 8, n, 24, dtype=bf)
    wback = field(5, 5, 24, kc, scale=(25 * 24) ** -0.5)
    dpre, dpre3 = field(n, n, n, 24, dtype=bf), field(n, n, n, 3, dtype=bf)
    f32 = f32_ = torch.float32

    def fwd(impl, g, w, b, act):
        return lambda: (impl(g, w, b, act, out_dtype=f32),)

    def conv_ops(nx, ny, nz, kc, cout):
        return 2.0 * nx * ny * nz * 25 * kc * cout

    def wgrad(gg, dd, label):  # the weight gradient against float64
        def lib():
            return torch.nn.grad.conv3d_weight(planes(gg), (dd.shape[-1], gg.shape[-1], 5, 5, 1),
                                               planes(dd))

        ops = conv_ops(n, n, n, gg.shape[-1], dd.shape[-1])
        # float32 operands: 3xTF32, three TF32 products a multiply-add, bound
        # at the TF32 peak; within 1e-5 of float64 and 1e-4 of the plain version
        f32 = dict(peak="tf32", tol=CONV_TF32_TOL, plain_tol=REL_TOL,
                   library_tf32=with_tf32(lib)) if gg.dtype == f32_ else dict(peak="bf16")
        return Case(label, lambda: (ck.tapconv_wgrad_3d(gg, dd, 5, 5),),
                    lambda: (ck.tapconv_wgrad_3d_plain(gg, dd, 5, 5),),
                    ref=lambda: (ck.tapconv_wgrad_3d_plain(gg.double(), dd.double(), 5, 5),),
                    inputs=(gg, dd), ops=ops * (3 if gg.dtype == f32_ else 1), library=lib, **f32)

    def planes(t):  # (nx, ny, nz, c) -> (1, c, nx, ny, nz)
        return t.permute(3, 0, 1, 2).unsqueeze(0)

    def pack32(label, gg, w, b, act):
        """`packconv_3d` on float32 operands: 3xTF32, bound at the TF32
        peak; within 1e-5 of float64 and 1e-4 of the float32 plain
        version; cuDNN's conv3d with TF32 off and allowed beside it."""
        def lib():
            return F.conv3d(planes(gg), w.permute(3, 2, 0, 1).unsqueeze(-1).contiguous(), b)

        b64 = None if b is None else b.double()
        return Case(label, fwd(ck.packconv_3d, gg, w, b, act),
                    fwd(ck.packconv_3d_plain, gg, w, b, act),
                    ref=lambda: (ck.packconv_3d_plain(gg.double(), w.double(), b64, act,
                                                      out_dtype=torch.float64),),
                    inputs=(gg, w) + (() if b is None else (b,)),
                    ops=3 * conv_ops(n, n, n, gg.shape[-1], w.shape[-1]), peak="tf32",
                    tol=CONV_TF32_TOL, plain_tol=REL_TOL, library=lib,
                    library_tf32=with_tf32(lib))

    def taps(w):  # (5, 5, kc, cout) -> (cout, kc, 5, 5, 1) in bf16
        return w.permute(3, 2, 0, 1).unsqueeze(-1).to(bf).contiguous()

    gp, ctpp = planes(g), planes(ctp)
    t24, t3, tb = taps(w24), taps(w3), taps(wback)
    b24b = b24.to(bf)
    ops24 = conv_ops(n, n, n, kc, 24)
    g32, ctp32 = g.float(), ctp.float()
    gp32, ctpp32 = planes(g32), planes(ctp32)
    cases = {
        "tapconv_3d": [
            Case("24->24 tanh+bias bf16", fwd(ck.tapconv_3d, g, w24, b24, "tanh"),
                 fwd(ck.tapconv_3d_plain, g, w24, b24, "tanh"), inputs=(g, w24, b24),
                 ops=ops24, peak="bf16", library=lambda: F.conv3d(gp, t24, b24b)),
            Case("dG 24->120 flipped taps bf16", fwd(ck.tapconv_3d, ctp, wback, None, None),
                 fwd(ck.tapconv_3d_plain, ctp, wback, None, None), inputs=(ctp, wback),
                 ops=conv_ops(n + 4, n + 4, n, 24, kc), peak="bf16",
                 library=lambda: F.conv3d(ctpp, tb)),
        ],
        "packconv_3d": [
            Case("24->24 tanh+bias bf16", fwd(ck.packconv_3d, g, w24, b24, "tanh"),
                 fwd(ck.packconv_3d_plain, g, w24, b24, "tanh"), inputs=(g, w24, b24),
                 ops=ops24, peak="bf16", library=lambda: F.conv3d(gp, t24, b24b)),
            Case("24->3 id, all 25 taps packed bf16", fwd(ck.packconv_3d, g, w3, None, None),
                 fwd(ck.packconv_3d_plain, g, w3, None, None), inputs=(g, w3),
                 ops=conv_ops(n, n, n, kc, 3), peak="bf16", library=lambda: F.conv3d(gp, t3)),
        ],
        # the stack's three weight gradients (tensor cores, bf16)
        "tapconv_wgrad_3d": [wgrad(g, dpre, "dw 120x24 bf16"), wgrad(g16, dpre, "dw 16x24 bf16"),
                             wgrad(g, dpre3, "dw 120x3 bf16")],
        # the float32 stack's three weight gradients (3xTF32) on operands
        # with full float32 mantissas
        "tapconv_wgrad_3d+f32": [wgrad(field(n + 4, n + 4, n, kc), field(n, n, n, 24),
                                       "dw 120x24 f32"),
                                 wgrad(field(n + 4, n + 4, n, 15), field(n, n, n, 24),
                                       "dw 15x24 f32"),
                                 wgrad(field(n + 4, n + 4, n, kc), field(n, n, n, 3),
                                       "dw 120x3 f32")],
        # 3xTF32: three TF32 products a multiply-add, bound at the TF32 peak
        "tapconv_3d+f32": [
            Case("24->24 tanh+bias f32", fwd(ck.tapconv_3d, g32, w24, b24, "tanh"),
                 fwd(ck.tapconv_3d_plain, g32, w24, b24, "tanh"), inputs=(g32, w24, b24),
                 ops=3 * ops24, peak="tf32",
                 library=lambda: F.conv3d(gp32, taps(w24).float(), b24)),
            Case("dG 24->120 flipped taps f32", fwd(ck.tapconv_3d, ctp32, wback, None, None),
                 fwd(ck.tapconv_3d_plain, ctp32, wback, None, None), inputs=(ctp32, wback),
                 ops=3 * conv_ops(n + 4, n + 4, n, 24, kc), peak="tf32",
                 library=lambda: F.conv3d(ctpp32, tb.float())),
        ],
        # the stack's three layers on operands with full float32 mantissas:
        # the tap kernel (24 -> 24, 3 -> 24) and the pack kernel (24 -> 3)
        "packconv_3d+f32": [
            pack32("24->24 tanh+bias f32 (tap kernel)", field(n + 4, n + 4, n, kc), w24, b24,
                   "tanh"),
            pack32("24->3 id, all 25 taps packed f32 (pack kernel)", field(n + 4, n + 4, n, kc),
                   w3, None, None),
            pack32("3->24 tanh+bias f32 (tap kernel)", field(n + 4, n + 4, n, 15),
                   field(5, 5, 15, 24, scale=(25 * 15) ** -0.5), b24, "tanh"),
        ],
    }
    del g32, ctp32
    # the tensor-core kernels on the ragged box (once: at the small size),
    # held against the plain version in float64 (rounded to the output's
    # dtype): cuDNN's float32 sum is itself off by more than a bf16 ulp of
    # small outputs.  The forwards in bf16 and (the tap form) in 3xTF32,
    # the weight gradients of the stack's three layers in bf16.
    nx, ny, nz = TAP_RAGGED_BOX
    for k in (3, 5, 7) if n < 64 else ():
        for kcr, cout, act, label in TAP_RAGGED:
            gr = field(nx + k - 1, ny + k - 1, nz, kcr, dtype=bf)
            wr = field(k, k, kcr, cout, scale=(k * k * kcr) ** -0.5)
            br = field(cout, scale=0.1) if act == "tanh" else None
            g32r = field(nx + k - 1, ny + k - 1, nz, kcr)  # full float32 mantissas
            for odt in (bf, f32):
                otag = "bf16" if odt == bf else "f32"
                for name, impl, plain, gg, ww in (
                        ("tapconv_3d", ck.tapconv_3d, ck.tapconv_3d_plain, gr, wr),
                        ("packconv_3d", ck.packconv_3d, ck.packconv_3d_plain, gr, wr),
                        ("tapconv_3d+f32", ck.tapconv_3d, ck.tapconv_3d_plain, g32r, wr),
                        ("packconv_3d+f32", ck.packconv_3d, ck.packconv_3d_plain, g32r, wr)):
                    if name.startswith("packconv_3d") and label.startswith("dG"):
                        continue  # the input gradient runs the tap form only
                    takes = (ck.pack_mma_takes(k, k, -(-kcr // 8) * 8, cout)
                             if name == "packconv_3d"
                             else ck.pack_tf32_takes(k, k, -(-kcr // 4) * 4, cout))
                    route = ((" (pack kernel)" if takes else " (tap kernel)")
                             if name.startswith("packconv_3d") else "")
                    cases[name].append(Case(
                        f"{label} k={k} box {TAP_RAGGED_BOX} out {otag}{route}",
                        lambda impl=impl, gg=gg, ww=ww, br=br, act=act, odt=odt:
                            (impl(gg, ww, br, act, out_dtype=odt),),
                        lambda plain=plain, gg=gg, ww=ww, br=br, act=act, odt=odt:
                            (plain(gg, ww, br, act, out_dtype=odt),),
                        ref=lambda plain=plain, gg=gg, ww=ww, br=br, act=act, odt=odt:
                            (plain(gg.double(), ww.to(gg.dtype).double(), br, act,
                                   out_dtype=odt),),
                        time=False))
            if label.startswith("dG") or label == "120->13":
                continue
            dr, dr32 = field(nx, ny, nz, cout, dtype=bf), field(nx, ny, nz, cout)
            for name, gg, dd, tols in (("tapconv_wgrad_3d", gr, dr, {}),
                                       ("tapconv_wgrad_3d+f32", g32r, dr32,
                                        dict(tol=CONV_TF32_TOL, plain_tol=REL_TOL))):
                cases[name].append(Case(
                    f"dw {label} k={k} box {TAP_RAGGED_BOX}",
                    lambda gg=gg, dd=dd, k=k: (ck.tapconv_wgrad_3d(gg, dd, k, k),),
                    lambda gg=gg, dd=dd, k=k: (ck.tapconv_wgrad_3d_plain(gg, dd, k, k),),
                    ref=lambda gg=gg, dd=dd, k=k: (
                        ck.tapconv_wgrad_3d_plain(gg.double(), dd.double(), k, k),),
                    time=False, **tols))
    return cases


def stage_div_kernel_cases(n):
    """`momentum_stage_div_3d` (stage.cu's float32 stage with a stream
    base and k emitted) against its plain version at n (256: the main
    path's cube); no library call computes it."""
    import torch

    from ins_tpu_torch.ops import perop_kernels as pk

    rng = np.random.default_rng(SEED + 13 * n)
    u, base = (torch.from_numpy(rng.standard_normal((3, n, n, n), dtype=np.float32)).to(DEVICE)
               for _ in range(2))
    dxs = (2 * np.pi / n,) * 3
    visc, coeff = 1.0 / 4000.0, 0.13
    return {
        "momentum_stage_div_3d": [
            Case("base + 0.13 k", lambda: pk.momentum_stage_div_3d(u, base, coeff, visc, dxs),
                 lambda: pk.momentum_stage_div_3d_plain(u, base, coeff, visc, dxs),
                 inputs=(u, base), ops=OPS_PER_CELL["stage_norebuild"] * n**3),
        ],
    }


def check_tap_wgrad_repeatable(n):
    """Two calls of the tap layer's weight gradient give the same bits, for
    bf16 and float32 operands, at the stack's three shapes at n³ (k = 5)."""
    import torch

    from ins_tpu_torch.ops import conv_kernels as ck

    rng = np.random.default_rng(SEED + 17 * n)
    for dtype in (torch.bfloat16, torch.float32):
        for kc, cout in ((120, 24), (15, 24), (120, 3)):
            g, d = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(DEVICE)
                    .to(dtype) for s in ((n + 4, n + 4, n, kc), (n, n, n, cout)))
            first = ck.tapconv_wgrad_3d(g, d, 5, 5)
            second = ck.tapconv_wgrad_3d(g, d, 5, 5)
            if not torch.equal(first, second):
                fail(f"tapconv_wgrad_3d {kc}x{cout} {dtype} at n={n}: two calls differ by "
                     f"{(first - second).abs().max().item():.3e}")
    print(f"[kernels] n={n} tapconv_wgrad_3d: two calls bit-identical at 120x24, 15x24 and "
          "120x3, bf16 and float32 operands")


def tap_stack(theta, h0, cdt, *, form, pack=None):
    """The closure stack on one sample h0 (n, n, n, 3): ``form`` "tap"
    (`_pallas_conv_layer`, the tap layer with `pack`), "plain" (the same
    through the plain versions) or "fused" (`make_fused_layer`, the
    production layers; stored in ``cdt`` between layers as `CNN` does)."""
    from ins_tpu_torch.models.cnn import _pallas_conv_layer
    from ins_tpu_torch.ops.conv_kernels import make_fused_layer

    h = h0.to(cdt) if form == "fused" else h0
    for i, (cin, cout, act, _) in enumerate(TAP_LAYERS):
        w, b = theta[f"conv{i}_kernel"], theta.get(f"conv{i}_bias")
        if form == "fused":
            h = make_fused_layer(act, b is not None, cin=cin, cout=cout, k=5)(h, w, b)
        else:
            h = _pallas_conv_layer(h, w, b, 2, True, act, cdt, plain=form == "plain", pack=pack)
    return h.float()


def tap_value_and_grad(theta, h0, cdt, **kw):
    """(out, {name: gradient}) of sum(out²) with respect to the weights,
    the biases and the input."""
    import torch

    leaves = {"input": h0, **theta}
    out = tap_stack(theta, h0, cdt, **kw)
    grads = torch.autograd.grad((out * out).sum(), list(leaves.values()))
    torch.cuda.synchronize()
    return out.detach(), dict(zip(leaves, grads))


def tap_stack_inputs(n):
    """(theta, h0): phase 3's CNN weights (seed 0) for the stack and one
    sample h0 (n, n, n, 3), all with gradients."""
    import torch

    from ins_tpu_torch import models as nc

    setup = training_setup(n)
    _, theta0 = nc.cnn(
        setup=setup, radii=[2, 2, 2], channels=[c[1] for c in TAP_LAYERS],
        activations=[torch.tanh, torch.tanh, lambda v: v], use_bias=[c[3] for c in TAP_LAYERS],
        generator=torch.Generator().manual_seed(0),
    )
    rng = np.random.default_rng(SEED + 17)
    h0 = torch.from_numpy(rng.standard_normal((n, n, n, 3), dtype=np.float32)).to(DEVICE)
    h0.requires_grad_(True)
    return {k: v.detach().requires_grad_(True) for k, v in theta0.items()}, h0


# the stack's forms: (compute dtype, tap_stack keywords); "f32": float32 convs
TAP_STACK_FORMS = {"tap": ("bf16", dict(form="tap", pack=False)),
                   "pack": ("bf16", dict(form="tap")), "fused": ("bf16", dict(form="fused")),
                   "tap f32": ("f32", dict(form="tap", pack=False)),
                   "pack f32": ("f32", dict(form="tap"))}


def tap_stack_times(theta, h0, order):
    """{form: {"fwd": [ms, ...], "fwd+bwd": [ms, ...], "peak": GiB}} of the
    stack's forms (`TAP_STACK_FORMS`) timed in the given order (3 runs
    after a warm-up each); the peak device memory of forward + backward."""
    import torch

    times = {k: {"fwd": [], "fwd+bwd": []} for k in dict.fromkeys(order)}
    for name in order:
        dt, kw = TAP_STACK_FORMS[name]
        cdt = torch.bfloat16 if dt == "bf16" else torch.float32
        with torch.no_grad():
            times[name]["fwd"].append(
                cuda_ms(lambda: tap_stack(theta, h0, cdt, **kw), reps=3, warmup=1))
        torch.cuda.reset_peak_memory_stats()
        times[name]["fwd+bwd"].append(
            cuda_ms(lambda: tap_value_and_grad(theta, h0, cdt, **kw), reps=3, warmup=1))
        times[name]["peak"] = torch.cuda.max_memory_allocated() / 2**30
    return times


def print_stack_times(tag, times):
    print(f"[tapconv] {tag}{card_line()}: stack ms per forward / forward + backward: "
          + "; ".join(f"{k} {sum(v['fwd']) / len(v['fwd']):.3f} ("
                      + ", ".join(f"{t:.3f}" for t in v["fwd"]) + ") / "
                      f"{sum(v['fwd+bwd']) / len(v['fwd+bwd']):.3f} ("
                      + ", ".join(f"{t:.3f}" for t in v["fwd+bwd"])
                      + f"), peak {v['peak']:.2f} GiB" for k, v in times.items()))


def phase_tapconv(n):
    """11b: the closure stack through `_pallas_conv_layer` at n³ against
    the plain stack and the fused layers, its launches, and the ms of the
    tap, pack and fused stacks."""
    import torch

    from ins_tpu_torch.ops import launches

    theta, h0 = tap_stack_inputs(n)
    print(f"[tapconv] {n}^3 closure stack (3->24->24->3, radius 2, tanh/tanh/id) through "
          "_pallas_conv_layer")
    counts = {}
    for cdt, out_tol, grad_tol in ((torch.bfloat16, GRAD_TOL_BF16, GRAD_TOL_BF16),
                                   (torch.float32, TAP_OUT_TOL_F32, GRAD_TOL_F32)):
        tag = "bf16" if cdt == torch.bfloat16 else "f32"
        refs = {form: tap_value_and_grad(theta, h0, cdt, form=form)
                for form in ("plain", "fused")}
        for pack in (None, False):
            sel = "pack" if pack is None else "tap"
            launches.reset_counts()
            out = tap_stack(theta, h0, cdt, form="tap", pack=pack)
            torch.cuda.synchronize()
            fwd = run_counts()
            launches.reset_counts()
            grads = dict(zip(["input", *theta],
                             torch.autograd.grad((out * out).sum(), [h0, *theta.values()])))
            torch.cuda.synchronize()
            bwd = run_counts()
            # bf16 convs run the bf16 tensor-core kernels, float32 ones the
            # "+f32" kernels (the tap and pack forwards and the weight
            # gradient in 3xTF32), never the other route's
            sfx = "" if cdt == torch.bfloat16 else "+f32"
            other = "+f32" if cdt == torch.bfloat16 else ""
            want_fwd = {"packconv_3d" + sfx: 3 if pack is None else 0,
                        "tapconv_3d" + sfx: 0 if pack is None else 3,
                        "tapconv_wgrad_3d" + sfx: 0}
            want_bwd = {"packconv_3d" + sfx: 0, "tapconv_3d" + sfx: 3,
                        "tapconv_wgrad_3d" + sfx: 3}
            for want in (want_fwd, want_bwd):
                want.update({k + other: 0 for k in ("packconv_3d", "tapconv_3d",
                                                    "tapconv_wgrad_3d")})
            got_fwd = {k: fwd[k] for k in want_fwd}
            got_bwd = {k: bwd[k] for k in want_bwd}
            print(f"[tapconv] {tag} {sel}: launches forward {got_fwd}, backward {got_bwd}")
            if got_fwd != want_fwd or got_bwd != want_bwd:
                fail(f"tap stack {tag} {sel}: launches forward {got_fwd}, backward {got_bwd}; "
                     f"expected {want_fwd}, {want_bwd}")
            if any(launches.PLAIN_ON_CUDA.values()):
                fail(f"tap stack {tag} {sel}: plain versions ran on CUDA tensors")
            if pack is None:
                counts.update({"packconv_3d" + sfx: got_fwd["packconv_3d" + sfx],
                               "tapconv_3d" + sfx: got_bwd["tapconv_3d" + sfx],
                               "tapconv_wgrad_3d" + sfx: got_bwd["tapconv_wgrad_3d" + sfx]})
            out = out.detach()
            if not (bool(torch.isfinite(out).all()) and out.shape == (n, n, n, 3)):
                fail(f"tap stack {tag} {sel}: output not finite or of shape {tuple(out.shape)}")
            for form, (rout, rgrads) in refs.items():
                oerr = rel_err(out, rout)
                gerr = {k: rel_l2(grads[k], rgrads[k]) for k in grads}
                print(f"[tapconv] {tag} {sel} vs {form}: output max rel {oerr:.3e} (bound "
                      f"{out_tol}); grad rel L2 "
                      + ", ".join(f"{k} {v:.3e}" for k, v in gerr.items()) + f" (bound {grad_tol})")
                if not (oerr <= out_tol and all(math.isfinite(v) and v <= grad_tol
                                                for v in gerr.values())):
                    fail(f"tap stack {tag} {sel} vs {form}: output {oerr:.3e}, gradients {gerr}")
        del refs, out, grads
        torch.cuda.empty_cache()

    # ms per forward and per forward + backward (bf16 and float32 convs), in
    # turns, and peak memory
    print_stack_times("", tap_stack_times(theta, h0, ("tap", "pack", "fused", "pack f32", "tap f32",
                                                      "tap f32", "pack f32", "fused", "pack",
                                                      "tap")))
    return counts


def stack_turns(parent):
    """The stack's ms and peak memory (`tap_stack_times`, pack and tap
    forms, bf16 and float32 convs, at 128³) of the package in the tree `parent` and of this tree's,
    each in its own process, in turns: parent, this, this, parent."""
    run_turns("--stack-time", parent)


def chain_time(n=256, steps=10):
    """One turn of `chain_turns`: ms/step of three n³ RK44 hat chains in
    this process, each two runs of `steps` steps after a warm-up of two:
    the main path (phase 2's setup and u0), the LES (phase 5's: the
    Smagorinsky closure at theta = LES_THETA) and the Boussinesq chain
    (phase 6's setup, u0 and T0).  {chain: [ms, ms]}."""
    import torch

    import ins_tpu_torch as it
    from ins_tpu_torch.ops.fastpath import make_fast_timestep_hat, strip_state

    method = it.RKMethods.RK44()

    def u0(setup):
        return it.random_field(setup, kp=10,
                               generator=torch.Generator(device=DEVICE).manual_seed(1))

    def hat():
        setup = headline_setup(n)
        return setup, dict(u=u0(setup)), 1e-3 * 128 / n, None

    def les():
        setup = les_setup(n)
        return setup, dict(u=u0(setup)), 1e-3 * 128 / n, torch.full((), LES_THETA,
                                                                       device=DEVICE)

    def boussinesq():
        setup = boussinesq_setup(n)
        temp = it.temperaturefield(setup, lambda xx, yy, zz: 0.5 + 0.1 * torch.sin(2 * np.pi * xx))
        return setup, dict(u=u0(setup), temp=temp), 2e-4 * 128 / n, None

    out = {}
    for name, make in (("hat", hat), ("les", les), ("boussinesq", boussinesq)):
        setup, state, dt, theta = make()
        to_h, step_h, _ = make_fast_timestep_hat(setup, method)
        h = to_h(strip_state(it.create_stepper(method, setup=setup, **state)))
        h = step_h(step_h(h, dt, theta), dt, theta)
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(steps):
                h = step_h(h, dt, theta)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3 / steps)
        out[name] = times
        del setup, state, h
        torch.cuda.empty_cache()
    return out


def conv_time(n=128):
    """One turn of `conv_turns`: ms of the fused layer's float32 kernels in
    this process at n³, k = 5 (CUDA events, mean of two runs of 10): each
    closure layer's forward, its input gradient (flipped taps) and its
    weight gradient.  {label: ms}."""
    import torch

    from ins_tpu_torch.ops import conv_kernels as ck

    rng = np.random.default_rng(SEED + 13)

    def field(*shape, scale=1.0):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(DEVICE)

    out = {}
    for cin, cout, act, has_bias in CONV_LAYERS:
        h, d = field(n, n, n, cin), field(n, n, n, cout)
        w = field(5, 5, 5, cin, cout, scale=(125 * cin) ** -0.5)
        b = field(cout, scale=0.1) if has_bias else None
        wf = ck.flip_taps(w)
        for label, fn in ((f"{cin}->{cout}", lambda: ck.fusedconv_3d(h, w, b, act)),
                          (f"dh {cout}->{cin}", lambda: ck.fusedconv_3d(d, wf)),
                          (f"dw {cin}x{cout}", lambda: ck.fusedconv_wgrad_3d(h, d, 5))):
            out[label] = (cuda_ms(fn) + cuda_ms(fn)) / 2
        del h, d
        torch.cuda.empty_cache()
    return out


def conv_turns(parent):
    """ms of the fused layer's float32 kernels (`conv_time`) of the package
    in the tree `parent` and of this tree's, each in its own process, in
    turns: parent, this, this, parent."""
    run_turns("--conv-time", parent)


def fold_time(max_n=None):
    """One turn of `fold_turns`: each of `FOLD_CASES` and `FOLD_BIG_CASES`
    in this process (with ``max_n``, only the cases of `FOLD_CASES` with n
    <= max_n), its ms (CUDA events, mean of two runs of 10) and its max
    relative error against the plain version in float64 (on a slab of
    columns for the big cases, `fold_f64_sample`), or "refused" where a
    tree without the level route raises (n > 1024); and, where the tree
    has the gate, both routes at its cases (`fold_gate_times`).  {label:
    [ms, err] or "refused: ...", "gate": {...}}."""
    import torch

    from ins_tpu_torch.ops import poisson_kernels as pk

    routed = hasattr(pk, "fold_route")
    cases = FOLD_CASES + FOLD_BIG_CASES if max_n is None else [
        c for c in FOLD_CASES if c[0] <= max_n]
    out = {}
    for c in cases:
        case = fold_case(*c)
        try:
            got = case.kfn()[0]
        except (RuntimeError, ValueError) as e:
            if routed:
                raise
            out[case.label] = f"refused: {str(e)[:80]}"
            del case
            continue
        ms = (cuda_ms(case.kfn) + cuda_ms(case.kfn)) / 2
        if c in FOLD_BIG_CASES:
            err = fold_f64_sample(case.inputs[0], fold_p64(c[0], c[1]), c[3], got)
        else:
            err = rel_err(got.double(), case.ref()[0])
        out[case.label] = [ms, err]
        del case, got
        torch.cuda.empty_cache()
    if routed and max_n is None:
        out["gate"] = fold_gate_times()
    return out


def fold_turns(parent, rounds=1, max_n=None):
    """ms and float64 error of the folded pass B's cases (`fold_time`) of
    the package in the tree `parent` and of this tree's, each in its own
    process, in turns: parent, this, this, parent, `rounds` times."""
    extra = () if max_n is None else ("--fold-max-n", str(max_n))
    run_turns("--fold-time", parent, rounds, extra)


def channel_time(steps=20):
    """One turn of `channel_turns` in this process: the stage kernel in
    every `channel_msd_3d` mode (`channel_kernel_cases`) on the ragged
    boxes and 256×128×128 against its plain version (max relative error
    over the modes and outputs, held within `REL_TOL`); the ms of the hat
    chain's four modes at 256×128×128 (CUDA events, mean of two runs of
    10); the hat chain's ms/step (four runs of `steps` after a warm-up of
    two: the host's clock on a shared machine spreads) and its device
    split (3 profiled steps).  {...}."""
    import torch

    import ins_tpu_torch as it
    from ins_tpu_torch.ops.channelpath import make_channel_timestep_hat, strip_channel

    out = {"max_rel_err": 0.0}
    for box in CHANNEL_RAGGED_BOXES + (CHANNEL_BOX,):
        cases = channel_kernel_cases(box)["channel_msd_3d"]
        for c in cases:
            got, ref = c.kfn(), c.pfn()
            err = max(rel_err(g, r) for g, r in zip(got, ref))
            if not err <= REL_TOL:
                fail(f"channel_msd_3d [{c.label}] at {box}: {err:.3e} from the plain version")
            out["max_rel_err"] = max(out["max_rel_err"], err)
        if box == CHANNEL_BOX:
            out["ms"] = {c.label: (cuda_ms(c.kfn) + cuda_ms(c.kfn)) / 2 for c in cases[:4]}
        del cases
        torch.cuda.empty_cache()
    setup = channel_setup(CHANNEL_BOX)
    u0 = channel_u0(setup, it.default_psolver(setup))
    dt, method = 1e-3, it.RKMethods.RK44()
    to_h, step_h, _ = make_channel_timestep_hat(setup, method)
    h = step_h(step_h(to_h(it.create_stepper(method, setup=setup, u=strip_channel(u0))), dt), dt)
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            h = step_h(h, dt)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / steps)
    out["ms_per_step"] = times
    out["profile"] = phase_profile_channel(setup, u0, dt, table=False)
    return out


def channel_turns(parent):
    """The channel stage kernel's errors and ms and the channel chain's
    ms/step (`channel_time`) of the package in the tree `parent` and of
    this tree's, each in its own process, in turns: parent, this, this,
    parent."""
    run_turns("--channel-time", parent)


# the kernels `--perop-turns` reports ptxas registers and spills of
PEROP_PTXAS = ("convdiff_kernel", "tap_wgrad_tf32_kernel")


def ptxas_report(names=PEROP_PTXAS):
    """Print ptxas's registers, spills and shared memory of each kernel
    whose mangled name holds one of `names`, from this tree's build.log."""
    from ins_tpu_torch import _build

    lines = (_build.BUILD_DIR / "build.log").read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line or not any(k in line for k in names):
            continue
        fn = line.split("'")[1]
        props = [ln.strip() for ln in lines[i + 1:i + 5]
                 if "spill" in ln or "registers" in ln]
        print(f"[ptxas] {fn}: " + "; ".join(props))


def perop_time(with_step=True, steps=2, n=128):
    """One turn of `perop_turns` in this process: the float32 tap weight
    gradient at the stack's three shapes at n³ (error against float64,
    held within `CONV_TF32_TOL`), then the conv-diff kernel at n³ and on
    `convdiff_box(n)` (max relative error against the plain version in
    float64, held within `REL_TOL`), each as [ms (CUDA events, mean of two
    runs of 10), device ms (`device_ms` over 50 calls: the kernels' own
    time, which a back-to-back run of short kernels hides behind the
    host's launch work), error]; with ``with_step`` phase 3's n³
    gradient step with bf16 convs: its per-op launches and seconds per
    step (`steps` runs after a warm-up).  {...}."""
    import torch

    from ins_tpu_torch.ops import conv_kernels as ck
    from ins_tpu_torch.ops import launches
    from ins_tpu_torch.ops import perop_kernels as pk

    rng = np.random.default_rng(SEED + 19)

    def field(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(DEVICE)

    def timed(fn, err):
        return [(cuda_ms(fn) + cuda_ms(fn)) / 2, device_ms(fn, reps=50), err]

    # the weight gradients first: seconds of tensor-core work bring the
    # card to its clocks before the conv-diff's microseconds are timed
    out = {}
    for kc, cout in ((120, 24), (15, 24), (120, 3)):
        g, d = field(n + 4, n + 4, n, kc), field(n, n, n, cout)
        got = ck.tapconv_wgrad_3d(g, d, 5, 5)
        err = rel_err(got.double(), ck.tapconv_wgrad_3d_plain(g.double(), d.double(), 5, 5))
        if not err <= CONV_TF32_TOL:
            fail(f"tapconv_wgrad_3d {kc}x{cout} float32: {err:.3e} from the float64 plain "
                 "version")
        out[f"wgrad f32 {kc}x{cout}"] = timed(lambda g=g, d=d: ck.tapconv_wgrad_3d(g, d, 5, 5),
                                              err)
        del g, d, got
        torch.cuda.empty_cache()
    visc = 1.0 / 2000.0
    for box in ((n,) * 3, convdiff_box(n)):
        u = field(3, *box)
        dx = tuple(1.0 / v for v in box)
        err = rel_err(pk.convdiff_interior_3d(u, visc, dx).double(),
                      pk.convdiff_interior_3d_plain(u.double(), visc, dx))
        if not err <= REL_TOL:
            fail(f"convdiff_interior_3d at {box}: {err:.3e} from the float64 plain version")
        out[f"convdiff {box}"] = timed(lambda u=u, dx=dx: pk.convdiff_interior_3d(u, visc, dx),
                                       err)
        del u
    if not with_step:
        return out
    setup = training_setup(n)
    _, data = training_data(setup, 5)
    _, theta, loss = build_training(setup)
    launches.reset_counts()
    value_and_grad(loss, data, theta)
    out["step launches"] = {k: launches.LAUNCHES[k] for k in PEROP_STEP_LAUNCHES}
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        value_and_grad(loss, data, theta)
        times.append(time.perf_counter() - t0)
    out["bf16 step s"] = times
    return out


def variant_tree(here, label, edits):
    """A copy of this tree's package in `build/variant_<label>` with each
    edit (file under the repository, regex, replacement) applied once;
    returns its root."""
    import re
    import shutil

    root = os.path.join(here, "build", f"variant_{label}")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(here, "ins_tpu_torch"), os.path.join(root, "ins_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for path, pattern, repl in edits:
        target = os.path.join(root, path)
        with open(target) as f:
            text, count = re.subn(pattern, repl, f.read())
        if count != 1:
            fail(f"variant {label}: {pattern!r} matched {count} times in {path}")
        with open(target, "w") as f:
            f.write(text)
    return root


def variant_turns(flag, variants, extra=()):
    """Each of ``variants``, "label|file|regex|replacement[|file|regex|
    replacement...]", this tree with those edits copied into
    `build/variant_<label>` (`variant_tree`), run with `flag ROOT` (and
    ``extra``) in turns: the list, then the list reversed."""
    here = os.path.dirname(os.path.abspath(__file__))
    specs = []
    for v in variants:
        label, *rest = v.split("|")
        if not rest or len(rest) % 3:
            fail(f"--variant {v!r}: expected label|file|regex|replacement[|...]")
        specs.append((label, [tuple(rest[i:i + 3]) for i in range(0, len(rest), 3)]))
    roots = [variant_tree(here, label, edits) for label, edits in specs]
    for root in roots + roots[::-1]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), flag, root, *extra],
                             capture_output=True, text=True, timeout=900)
        lines = out.stdout.strip().splitlines()
        print(f"[turns] {root}: " + (lines[-1] if lines else "no output"))
        if out.returncode:
            fail(f"{flag} {root}: exit {out.returncode}: {out.stderr[-2000:]}")


def hmma_count(old_csrc, *sources):
    """`sass_diff.py --opcode HMMA` of ``sources`` between the csrc
    directory ``old_csrc`` and this tree's: each kernel's tensor-core
    instructions; fails where a kernel of the old tree changed or went."""
    here = os.path.dirname(os.path.abspath(__file__))
    sass = subprocess.run([sys.executable, os.path.join(here, "sass_diff.py"), "--opcode", "HMMA",
                           old_csrc, os.path.join(here, "ins_tpu_torch", "csrc"), *sources],
                          capture_output=True, text=True, timeout=600)
    print(sass.stdout.strip())
    if sass.returncode:
        fail(f"sass_diff.py: exit {sass.returncode}: {sass.stderr[-2000:]}")


def perop_turns(parent, variants=()):
    """`perop_time` of the package in the tree `parent` and of this tree's,
    each in its own process, in turns: parent, this, this, parent.  Then
    ``variants`` (`variant_turns`), timed without the gradient step.  Then
    ptxas's report of the new kernels and their HMMA count (`sass_diff.py
    --opcode HMMA`)."""
    run_turns("--perop-time", parent)
    variant_turns("--perop-time", variants, ("--perop-no-step",))
    from ins_tpu_torch import _build

    _build.load()
    ptxas_report()
    here = os.path.dirname(os.path.abspath(__file__))
    empty = os.path.join(here, "build", "empty_csrc")
    os.makedirs(empty, exist_ok=True)
    hmma_count(empty, "tapwgrad_tf32.cu")


# the float32 pack forward's cases at 128³ (`pack_time`): (label, kc, cout,
# activation, bias)
PACK_LAYERS = (("24->24", 120, 24, "tanh", True), ("24->3", 120, 3, None, False),
               ("3->24", 15, 24, "tanh", True))
# the kernels whose registers and spills `--pack-turns` reports, and the
# FMA kernels the build must no longer hold
PACK_PTXAS = ("pack_tf32_kernel", "passb_fold_kernelILi0E")
FMA_CONV_KERNELS = ("pack_products_kernel", "pack_combine_kernel")


def pack_time(n=128):
    """One turn of `pack_turns` in this process: `packconv_3d` on float32
    operands with full mantissas at n³ for each of `PACK_LAYERS`, and the
    dense pass B (`passB`, `passB_sharded`) at 256³ with the dense route
    forced and at `DENSE_EXTRA`: each [ms (CUDA events, mean of two runs
    of 10), max relative error against the plain version in float64].
    {label: [ms, err]}."""
    import torch

    from ins_tpu_torch.ops import conv_kernels as ck

    rng = np.random.default_rng(SEED + 23)

    def field(*shape, scale=1.0):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(DEVICE)

    out = {}
    for label, kc, cout, act, has_bias in PACK_LAYERS:
        g = field(n + 4, n + 4, n, kc)
        w = field(5, 5, kc, cout, scale=(25 * kc) ** -0.5)
        b = field(cout, scale=0.1) if has_bias else None
        got = ck.packconv_3d(g, w, b, act)
        ref = ck.packconv_3d_plain(g.double(), w.double(), None if b is None else b.double(),
                                   act, out_dtype=torch.float64)
        err = rel_err(got.double(), ref)
        if not err <= CONV_TF32_TOL:
            fail(f"packconv_3d {label} float32: {err:.3e} from the float64 plain version")
        fn = lambda g=g, w=w, b=b, act=act: ck.packconv_3d(g, w, b, act)  # noqa: E731
        out[f"pack f32 {label}"] = [(cuda_ms(fn) + cuda_ms(fn)) / 2, err]
        del g, got, ref
        torch.cuda.empty_cache()
    for c in ((256, 256, 0),) + DENSE_EXTRA:
        case = dense_case(*c)
        err = rel_err(case.kfn()[0].double(), case.ref()[0])
        if not err <= DENSE_F64_TOL:
            fail(f"the dense pass B at {case.label}: {err:.3e} from the float64 plain version")
        out[f"dense {case.label}"] = [(cuda_ms(case.kfn) + cuda_ms(case.kfn)) / 2, err]
        del case
        torch.cuda.empty_cache()
    return out


def pack_turns(parent, variants=()):
    """`pack_time` of the package in the tree `parent` and of this tree's,
    each in its own process, in turns: parent, this, this, parent; then
    ``variants`` (`variant_turns`); then ptxas's report of the new kernels,
    a check that the build holds no FMA convolution kernel, and the HMMA
    count of `tapconv_tf32.cu` and `fold.cu` against the parent's."""
    run_turns("--pack-time", parent)
    variant_turns("--pack-time", variants)
    from ins_tpu_torch import _build

    _build.load()
    ptxas_report(PACK_PTXAS)
    log = (_build.BUILD_DIR / "build.log").read_text()
    fma = [k for k in FMA_CONV_KERNELS if k in log]
    print(f"[pack] FMA convolution kernels in the build: {fma or 'none'}")
    if fma:
        fail(f"the build still holds the FMA convolution kernels {fma}")
    hmma_count(os.path.join(os.path.abspath(parent), "ins_tpu_torch", "csrc"),
               "tapconv_tf32.cu", "fold.cu")


def run_turns(flag, parent, rounds=1, extra=()):
    """Run this script with `flag ROOT` (and the arguments ``extra``) for
    ROOT = parent, this tree, this tree, parent, `rounds` times (each in
    its own process); print each one's last line."""
    here = os.path.dirname(os.path.abspath(__file__))
    print(card_line())
    for root in (parent, here, here, parent) * rounds:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), flag, root, *extra],
                             capture_output=True, text=True, timeout=900)
        lines = out.stdout.strip().splitlines()
        print(f"[turns] {os.path.abspath(root)}: " + (lines[-1] if lines else "no output"))
        if out.returncode:
            fail(f"{flag} {root}: exit {out.returncode}: {out.stderr[-2000:]}")


def train_time(n=128, nunroll=5):
    """One turn of `train_turns`: phase 3's gradient step with float32
    convs in this process, two timed steps after a warm-up, then one
    profiled: {"s_per_step": [s, s], "device_s", "conv_s"}."""
    import torch

    setup = training_setup(n)
    _, data = training_data(setup, nunroll)
    _, theta, loss = build_training(setup, compute_dtype=torch.float32)
    value_and_grad(loss, data, theta)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        value_and_grad(loss, data, theta)
        times.append(time.perf_counter() - t0)
    _, dev, conv, _ = profile_step(loss, data, theta)
    return {"s_per_step": times, "device_s": dev, "conv_s": conv}


def train_turns(parent):
    """s/step and conv share of phase 3's 128³ gradient step with float32
    convs (`train_time`) of the package in the tree `parent` and of this
    tree's, each in its own process, in turns: parent, this, this, parent."""
    run_turns("--train-time", parent)


def chain_turns(parent):
    """ms/step of the 256³ RK44 hat, LES and Boussinesq chains
    (`chain_time`) of the package in the tree `parent` and of this tree's,
    each in its own process, in turns: parent, this, this, parent."""
    run_turns("--chain-time", parent)


def phase_unfused_step(n):
    """11c: the unfused projection step (`momentum_stage_div_3d` -> the
    per-op chain's solve -> `pressure_correct_3d`) against the fused hat
    step (`momentum_stage_divhat_3d` -> pass B -> `pressure_correct_qhat_3d`)
    on the same u, base and coeff at n³ (the port of the JAX package's
    `test_fused_projection_chain_matches_unfused`)."""
    import torch

    from ins_tpu_torch.ops import launches
    from ins_tpu_torch.ops import perop_kernels as pk
    from ins_tpu_torch.ops import stage_kernels as sk
    from ins_tpu_torch.ops.dft import make_poisson_mm
    from ins_tpu_torch.ops.fastpath import poisson_pallas_min_n
    from ins_tpu_torch.ops.poisson_kernels import make_fused_projection, make_poisson_pallas

    rng = np.random.default_rng(SEED + 19)
    u, base = (torch.from_numpy(rng.standard_normal((3, n, n, n), dtype=np.float32)).to(DEVICE)
               for _ in range(2))
    dxs = (2 * np.pi / n,) * 3
    visc, coeff = 1.0 / 4000.0, 0.13
    f32 = torch.float32
    proj = make_fused_projection((n,) * 3, dxs, f32, device=DEVICE)
    pallas = n >= poisson_pallas_min_n("manualhigh")
    solve = (make_poisson_pallas((n,) * 3, dxs, f32, device=DEVICE) if pallas
             else make_poisson_mm((n,) * 3, dxs, f32, DEVICE))

    def unfused():
        k, ut, div = pk.momentum_stage_div_3d(u, base, coeff, visc, dxs)
        return k, ut, pk.pressure_correct_3d(ut, solve(div), dxs)

    def fused():
        k, ut, divhat = sk.momentum_stage_divhat_3d(u, (base,), (coeff,), visc, dxs,
                                                    proj["Vinv"], proj["VinvT"])
        qhat = proj["passB"](divhat)
        return k, ut, sk.pressure_correct_qhat_3d(ut, qhat, dxs, proj["V"], proj["VT"])

    launches.reset_counts()
    got = unfused()
    torch.cuda.synchronize()
    print(f"[unfused] {n}^3: launches {({k: v for k, v in run_counts().items() if v})}")
    want = {"momentum_stage_div_3d": 1, "pressure_correct_3d": 1,
            "poisson_pallas": int(pallas)}
    counts = {k: launches.LAUNCHES[k] for k in want}
    if counts != want or any(launches.PLAIN_ON_CUDA.values()):
        fail(f"unfused step launches {counts} (plain on CUDA "
             f"{ {k: v for k, v in launches.PLAIN_ON_CUDA.items() if v} }), expected {want}")
    ref = fused()
    errs = [rel_err(a, b) for a, b in zip(got, ref)]
    print(f"[unfused] {n}^3 unfused vs fused step: k {errs[0]:.3e}, ut {errs[1]:.3e} (max rel), "
          f"u_new {errs[2]:.3e} of max|u_new| (bounds {REL_TOL})")
    if not all(math.isfinite(e) and e <= REL_TOL for e in errs):
        fail(f"unfused vs fused step at {n}^3: {errs} above {REL_TOL}")
    tu1, tf1 = cuda_ms(unfused), cuda_ms(fused)
    tf2, tu2 = cuda_ms(fused), cuda_ms(unfused)
    print(f"[unfused] {card_line()}: {n}^3 unfused step {(tu1 + tu2) / 2:.4f} ms ({tu1:.4f}, "
          f"{tu2:.4f}), fused hat step {(tf1 + tf2) / 2:.4f} ms ({tf1:.4f}, {tf2:.4f})")
    return counts["momentum_stage_div_3d"]


CAVITY_N = 128
CAVITY_STEPS = 10
RB_N = 60
CAVITY_F64_TOL = 1e-4
# the last projection's residual relative to its right-hand side with the
# FDM solve in float32: the cavity's bound, and Rayleigh-Benard's, whose
# hydrostatic pressure cancels a buoyancy update far larger than the flow
# (its float32 floor, which the witness of `rb_floor_witness` reads)
FDM_DIV_TOL = 1e-5
RB_DIV_TOL = 3e-5
# the run's FDM solve within this factor of float32's floor
RB_FLOOR_FACTOR = 1.5


def cavity_setup(n, dtype):
    """`bench.py`'s `make_cavity_cg` setup: the uniform unit cube at n³,
    no-slip walls and the lid (1, 0, 0) at z = 1, Re 1e3."""
    import ins_tpu_torch as it

    x = tuple(np.linspace(0.0, 1.0, n + 1) for _ in range(3))
    d = it.DirichletBC()
    bc = ((d, d), (d, d), (d, it.DirichletBC((1.0, 0.0, 0.0))))
    return it.Setup(x=x, boundary_conditions=bc, Re=1e3, dtype=dtype, device=DEVICE)


def rb3d_setup(n, dtype=None):
    """`examples/rayleigh_benard_3d.py` at its full size: 2n × n × n,
    x periodic, y and z no-slip walls, T = 1 at z = 0 and 0 at z = 1,
    symmetric in y, Pr 0.71, Ra 1e7, tanh(1.2) in z; float32 unless
    `dtype` says otherwise."""
    import torch

    import ins_tpu_torch as it

    temperature = it.temperature_equation(
        Pr=0.71, Ra=1e7, Ge=1.0, dodissipation=True,
        boundary_conditions=((it.PeriodicBC(), it.PeriodicBC()),
                             (it.SymmetricBC(), it.SymmetricBC()),
                             (it.DirichletBC(1.0), it.DirichletBC(0.0))),
        gdir=2, dtype=dtype or torch.float32)
    x = (it.stretched_grid(0.0, 2.0, 2 * n), it.stretched_grid(0.0, 1.0, n),
         it.tanh_grid(0.0, 1.0, n, 1.2))
    d = it.DirichletBC()
    return it.Setup(x=x, boundary_conditions=((it.PeriodicBC(), it.PeriodicBC()), (d, d), (d, d)),
                    temperature=temperature, dtype=dtype or torch.float32, device=DEVICE)


def dirichlet_ghost_error(setup, t, u, temp=None):
    """Largest distance of a Dirichlet ghost from its (constant) wall
    value: on every Dirichlet side the plane of each velocity component
    (and of the temperature) within the other dimensions' ghost layers,
    where no later side's fill writes; and, for the edges and corners,
    the whole state against its own ghost fill (`apply_bc_u`,
    `apply_bc_temp`), which leaves a filled state as it is."""
    import ins_tpu_torch as it
    from ins_tpu_torch.boundary_conditions import DirichletBC, boundary_plane

    g = setup.grid
    inner = tuple(slice(1, n - 1) for n in g.N)

    def plane(f, beta, i):
        return f[tuple(slice(i, i + 1) if b == beta else inner[b] for b in range(g.dim))]

    err = (it.apply_bc_u(u, t, setup) - u).abs().max().item()
    if temp is not None:
        err = max(err, (it.apply_bc_temp(temp, t, setup) - temp).abs().max().item())
    for beta in range(g.dim):
        for isright, bc in zip((False, True), setup.boundary_conditions[beta]):
            if not isinstance(bc, DirichletBC):
                continue
            for a in range(g.dim):
                i = boundary_plane(beta, g.N, g.Iu[a], isright)[beta][0]
                want = 0.0 if bc.u is None else float(bc.u[a])
                err = max(err, (plane(u[a], beta, i) - want).abs().max().item())
        if temp is None:
            continue
        for isright, bc in zip((False, True), setup.temperature.boundary_conditions[beta]):
            if isinstance(bc, DirichletBC):
                i = boundary_plane(beta, g.N, g.Ip, isright)[beta][0]
                want = 0.0 if bc.u is None else float(bc.u)
                err = max(err, (plane(temp, beta, i) - want).abs().max().item())
    return err


def recording(psolver):
    """`psolver` that keeps the right-hand side of its last call
    (`last`)."""
    def rec(f):
        rec.last = f
        return psolver(f)

    for k in ("is_cg", "is_fdm", "is_direct"):
        if hasattr(psolver, k):
            setattr(rec, k, getattr(psolver, k))
    rec.last = None
    return rec


def divergence_residual(setup, u, f_last):
    """||Ω div u||₂ / ||f||₂ over the pressure DOFs, f the last
    projection's right-hand side (Ω div of the unprojected field): the
    relative residual the last solve left, the measure CG stops on."""
    import ins_tpu_torch as it
    from ins_tpu_torch.ops._stencil import slc

    r = it.scalewithvolume(it.divergence(u, setup), setup)[slc(setup.grid.Ip)]
    return (r.norm() / f_last.norm()).item()


def ghosted_run(tag, setup, psolver, u0, nsteps, chunk, dt, temp0=None, method=None,
                divergence_of=None):
    """`solve_unsteady` of `method` (RK44 where None) through the general
    branch (no kernel launch), then the checks every phase-13 and
    phase-14 run is held to: the state on the card and finite, the
    Dirichlet ghosts at their wall values.  Returns the state and its
    divergence: ``divergence_of(u)`` (`scaled_divergence`) where given,
    else `divergence_residual` of the last solve's right-hand side."""
    import torch

    import ins_tpu_torch as it
    from ins_tpu_torch.ops import launches
    from ins_tpu_torch.ops.channelpath import channelpath_applicable
    from ins_tpu_torch.ops.fastpath import fastpath_applicable

    method = method or it.RKMethods.RK44()
    if fastpath_applicable(setup, method, psolver) or (
            getattr(psolver, "is_fdm", False) and channelpath_applicable(setup, method)):
        fail(f"[{tag}] the setup would not take the general branch")
    launches.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = it.solve_unsteady(setup=setup, ustart=u0, tempstart=temp0, tlims=(0.0, nsteps * dt),
                                 dt=dt, method=method, psolver=psolver,
                                 processors={"log": it.timelogger(nupdate=chunk)})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in run_counts().items() if v}
    plain = {k: v for k, v in launches.PLAIN_ON_CUDA.items() if v}
    if counts or plain:
        fail(f"[{tag}] the general path launched {counts} / ran plain versions {plain}")
    if state.n != nsteps:
        fail(f"[{tag}] ran {state.n} steps, expected {nsteps}")
    fields = [state.u] + ([state.temp] if temp0 is not None else [])
    for f in fields:
        if f.device.type != "cuda":
            fail(f"[{tag}] the state is on {f.device}")
        if not bool(torch.isfinite(f).all()):
            fail(f"[{tag}] non-finite state after {nsteps} steps")
    ghost = dirichlet_ghost_error(setup, state.t, state.u,
                                  state.temp if temp0 is not None else None)
    if ghost != 0.0:
        fail(f"[{tag}] a Dirichlet ghost is {ghost:.3e} from its wall value")
    if divergence_of is not None:
        div, measure = divergence_of(state.u), "max|div u| h / max|u|"
    else:
        div = divergence_residual(setup, state.u, psolver.last)
        measure = "||Ω div u|| / ||last right-hand side||"
    print(f"[{tag}] solve_unsteady: {nsteps} steps in chunks of {chunk}, {wall:.3f} s wall "
          f"(first call included); max|u| {state.u.abs().max().item():.6f}; divergence "
          f"{measure} {div:.3e}; Dirichlet ghosts exact; "
          f"kinetic energy {it.total_kinetic_energy(state.u, setup).item():.9e}")
    return state, div


def ghosted_ms_per_step(setup, psolver, state, dt, steps=5, method=None):
    """ms/step of `timestep` of `method` (RK44 where None) on the card
    after one warm-up step, and the projection's share: one psolver call
    on a stage's right-hand side (four an RK44 step) timed alone, and for
    CG its iterations and the FDM solve it applies once an iteration."""
    import torch

    import ins_tpu_torch as it
    from ins_tpu_torch.ops._stencil import slc

    method = method or it.RKMethods.RK44()

    def step(s):
        return it.timestep(method, s, dt, setup=setup, psolver=psolver)

    s = step(state)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        s = step(s)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / steps
    g = setup.grid
    f = it.scalewithvolume(it.divergence(it.apply_bc_u(
        s.u + dt * it.momentum(s.u, s.temp, s.t, setup), s.t, setup), setup), setup)[slc(g.Ip)]
    solve_ms = cuda_ms(lambda: psolver(f), reps=5, warmup=1)
    return ms, solve_ms, f


def profile_ghosted(tag, setup, psolver, state, dt, steps=2, method=None):
    """Device-time split of `steps` general-path steps of `method` (RK44
    where None; torch.profiler): GEMMs (the FDM contractions), reductions
    (CG's inner products and norms), copies and fills (ghost fills,
    clones, box writes) and the other elementwise kernels (the stencil
    arithmetic), with the idle share against the unprofiled wall.
    Returns (the unprofiled ms/step, the idle share or None where the
    trace holds no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import ins_tpu_torch as it

    method = method or it.RKMethods.RK44()

    def run(s):
        for _ in range(steps):
            s = it.timestep(method, s, dt, setup=setup, psolver=psolver)
        return s

    s = run(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = run(s)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    # device activity only: the split reads no host events, and recording
    # every host op of an implicit RK step (~50,000 kernels) costs far
    # more than the step
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s = run(s)
        torch.cuda.synchronize()
    events = prof.key_averages()
    split = {"GEMM": 0.0, "reductions": 0.0, "copies and fills": 0.0, "elementwise": 0.0}
    launches = 0
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        k = e.key.lower()
        key = ("GEMM" if ("gemm" in k or "xmma" in k or "cutlass" in k) else
               "reductions" if "reduce" in k else
               "copies and fills" if ("copy" in k or "fill" in k or "cat" in k
                                      or "memset" in k or "memcpy" in k) else "elementwise")
        split[key] += e.self_device_time_total / 1e3 / steps
        launches += e.count
    dev = sum(split.values())
    if dev <= 0.0:
        print(f"[profile] {tag}: the trace holds no device time; no split")
        return wall, None
    idle = max(0.0, 1 - dev / wall)
    print(f"[profile] {tag}: {wall:.3f} ms/step wall (unprofiled), {dev:.3f} ms of device "
          f"time a step in {launches / steps:.0f} kernels: "
          + ", ".join(f"{k} {v:.3f} ms ({v / dev:.1%})" for k, v in split.items())
          + f"; idle share {idle:.3f}; {card_line()}")
    print(events.table(sort_by="self_cuda_time_total", row_limit=12, max_name_column_width=60))
    return wall, idle


def rb_floor_witness(setup, state, dt):
    """Rayleigh-Bénard's float32 witness: the divergence residual (as
    `divergence_residual`, after the stepper's ghost fill) of one float32
    projection of the predictor u + dt·F(u) of `state`, solved by
    `psolver_fdm` with one refinement sweep (the run's solver), with two,
    and by the float64 FDM solve rounded to float32.  Fails unless the
    run's solver comes within `RB_FLOOR_FACTOR` of the last: the floor
    float32 puts on the projection where the hydrostatic pressure
    cancels the buoyancy update."""
    import torch

    import ins_tpu_torch as it
    from ins_tpu_torch.ops._stencil import slc

    u, t = state.u, state.t
    ustar = it.apply_bc_u(u + dt * it.momentum(u, state.temp, t, setup), t, setup)
    f = it.scalewithvolume(it.divergence(ustar, setup), setup)[slc(setup.grid.Ip)]
    solve64 = it.psolver_fdm(rb3d_setup(RB_N, torch.float64))
    solvers = {
        "nrefine 1": it.psolver_fdm(setup, nrefine=1),
        "nrefine 2": it.psolver_fdm(setup, nrefine=2),
        "float64 rounded": lambda rhs: solve64(rhs.double()).float(),
    }
    res = {}
    for k, solve in solvers.items():
        v = it.apply_bc_u(it.project(ustar, setup, psolver=solve), t, setup)
        res[k] = divergence_residual(setup, v, f)
    print(f"[rb3d_{RB_N}] float32 witness, one projection of u + dt F(u): residual "
          + ", ".join(f"{k} {v:.3e}" for k, v in res.items())
          + f" (the run's solver within {RB_FLOOR_FACTOR}x of the float64 solution rounded)")
    if not res["nrefine 1"] <= RB_FLOOR_FACTOR * res["float64 rounded"]:
        fail(f"[rb3d_{RB_N}] the FDM solve's residual {res['nrefine 1']:.3e} is above "
             f"{RB_FLOOR_FACTOR}x float32's floor {res['float64 rounded']:.3e}")


def phase_ghosted(profile=False):
    """Phase 13: the general ghosted path on the card (see the docstring);
    ``profile`` adds each case's device-time split."""
    import torch

    import ins_tpu_torch as it
    from ins_tpu_torch.ops.fdm import fdm_solve_box

    dt = 1e-3
    cells = CAVITY_N**3
    out = {}
    # the 128³ lid-driven cavity with FDM-preconditioned CG (bench.py:252-266)
    runs = {}
    for dtype in (torch.float32, torch.float64):
        setup = cavity_setup(CAVITY_N, dtype)
        cg = it.psolver_cg(setup, maxiter=8, reltol=1e-4, precond="fdm")
        psolver = recording(cg)
        u0 = it.velocityfield(setup, lambda dim, xx, yy, zz: 0.0 * xx, psolver=psolver)
        tag = f"cavity_cg{CAVITY_N} {str(dtype)[6:]}"
        state, div = ghosted_run(tag, setup, psolver, u0, CAVITY_STEPS, CAVITY_STEPS // 2, dt)
        if not div <= 1e-4:
            fail(f"[{tag}] relative divergence {div:.3e} above the CG reltol 1e-4")
        runs[dtype] = (setup, cg, state)
    (setup, psolver, s32), (_, _, s64) = runs[torch.float32], runs[torch.float64]
    agree = rel_err(s32.u.double(), s64.u)
    print(f"[cavity_cg{CAVITY_N}] float32 vs float64 on the card after {CAVITY_STEPS} steps: "
          f"max rel diff {agree:.3e} (bound {CAVITY_F64_TOL})")
    if not agree <= CAVITY_F64_TOL:
        fail(f"the float32 CG cavity is {agree:.3e} from its float64 run")
    del runs
    ms, solve_ms, f = ghosted_ms_per_step(setup, psolver, s32, dt)
    iters = int(psolver.iterations)
    if profile:
        profile_ghosted(f"cavity_cg{CAVITY_N}", setup, psolver, s32, dt)
    fdm = fdm_solve_box(setup)
    fdm_ms = cuda_ms(lambda: fdm(f), reps=5, warmup=1)
    out["cavity_cg"] = ms
    print(f"[cavity_cg{CAVITY_N}] RK44 f32: {ms:.3f} ms/step, {cells / (ms * 1e-3):.4e} "
          f"cell-updates/s; a projection's CG solve {solve_ms:.4f} ms ({iters} iterations), "
          f"4 a step: {4 * solve_ms / ms:.1%} of the step; one FDM solve {fdm_ms:.4f} ms; "
          f"the rest (stencils, ghost fills, glue) {ms - 4 * solve_ms:.3f} ms; {card_line()}")
    del setup, psolver, s32, s64
    torch.cuda.empty_cache()

    # the same cavity with the FDM direct solve (VERDICT item 7's cavity_fdm128)
    setup = cavity_setup(CAVITY_N, torch.float32)
    psolver = recording(it.psolver_fdm(setup))
    u0 = it.velocityfield(setup, lambda dim, xx, yy, zz: 0.0 * xx, psolver=psolver)
    tag = f"cavity_fdm{CAVITY_N}"
    state, div = ghosted_run(tag, setup, psolver, u0, CAVITY_STEPS, CAVITY_STEPS // 2, dt)
    if not div <= FDM_DIV_TOL:
        fail(f"[{tag}] relative divergence {div:.3e} above {FDM_DIV_TOL}")
    ms, solve_ms, _ = ghosted_ms_per_step(setup, psolver, state, dt)
    if profile:
        profile_ghosted(tag, setup, psolver, state, dt)
    out["cavity_fdm"] = ms
    print(f"[{tag}] RK44 f32: {ms:.3f} ms/step, {cells / (ms * 1e-3):.4e} cell-updates/s; "
          f"a projection's FDM solve (one refinement sweep) {solve_ms:.4f} ms, 4 a step: "
          f"{4 * solve_ms / ms:.1%} of the step; the rest {ms - 4 * solve_ms:.3f} ms; "
          f"{card_line()}")
    del setup, psolver, state
    torch.cuda.empty_cache()

    # Rayleigh-Bénard 3-D at its full size: temperature, symmetric walls
    setup = rb3d_setup(RB_N)
    psolver = recording(it.default_psolver(setup))
    if not psolver.is_fdm:
        fail("default_psolver did not give the FDM solve on the Rayleigh-Benard box")
    u0 = it.velocityfield(setup, lambda dim, xx, yy, zz: 0.0 * xx, psolver=psolver)
    temp0 = it.temperaturefield(
        setup, lambda xx, yy, zz: 1 - zz + 0.001 * torch.sin(10 * np.pi * xx))
    tag = f"rb3d_{RB_N}"
    state, div = ghosted_run(tag, setup, psolver, u0, 20, 10, dt, temp0=temp0)
    if not div <= RB_DIV_TOL:
        fail(f"[{tag}] relative divergence {div:.3e} above {RB_DIV_TOL}")
    rb_floor_witness(setup, state, dt)
    nu = it.observe_nusselt(setup).initialize(dict(u=state.u, temp=state.temp, t=state.t))["Nu"][0]
    ms, solve_ms, _ = ghosted_ms_per_step(setup, psolver, state, dt)
    if profile:
        profile_ghosted(tag, setup, psolver, state, dt)
    rb_cells = int(np.prod(setup.grid.Np))
    out["rb3d"] = ms
    print(f"[{tag}] {setup.grid.Np} RK44 f32 with temperature: Nu {nu:.6f}; {ms:.3f} ms/step, "
          f"{rb_cells / (ms * 1e-3):.4e} cell-updates/s; a projection's FDM solve "
          f"{solve_ms:.4f} ms, 4 a step: {4 * solve_ms / ms:.1%}; {card_line()}")
    del setup, psolver, state
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 14: the rest of the general path (IMEX and implicit RK steppers,
# the matrix solvers, the observers)
# --------------------------------------------------------------------------

# the implicit RK cube and its steps (64 if a 128³ case ran over ~60 s)
IRK_N = CAVITY_N
IRK_STEPS = 2
# a phase-14 cavity's divergence, max|div u|·h / max|u| with h each
# cell's smallest spacing (`scaled_divergence`): float32 below
# `F32_DIV_TOL` (the FDM solve's, as `FDM_DIV_TOL`), float64 below
# `F64_DIV_TOL`.  A relative residual against the last solve's right-hand side, phase 13's measure,
# is ill-posed here: AB-CN and one-leg subtract the last pressure's
# gradient before the correction and implicit RK projects every stage,
# so what a step's last solve corrects is already nearly divergence-free
F32_DIV_TOL = 1e-5
F64_DIV_TOL = 1e-12
CGMATRIX_RELTOL = 1e-4
# the Jacobi CG stops on its recursively updated residual; in float32 the
# true residual, which the divergence reads, drifts from it (1.18x at
# 128³ in this PR's first run): the divergence is held to 2x the reltol
CGMATRIX_DIV_FACTOR = 2.0
LDC2D_N = 512
# the 2-D cavity's direct solve is held to an independent float64
# solution of its last right-hand side: Jacobi `psolver_cg` on the
# float64 setup, whose Laplacian is the matrix-free
# `ops/fdm.laplacian_box` (not the assembled matrix the LU factors), to
# `DIRECT_REF_RELTOL`, its own float64 residual below `DIRECT_REF_RES`.
# The float32 setup assembles `laplacian_mat` with float32 entries,
# which the host LU factors in float64, as the JAX package's
# `psolver_direct` does; on this grid (smallest cell ~1e-5, largest
# ~3e-3) that rounding moves a random right-hand side's solution by
# 5.25e-4 in both packages (`tests/torch_floor_checks.py --case
# ldc2d`), so `DIRECT_TOL` is 2e-3;
# the fast diagonalization is 0.79 off there, a wrong solve O(1)
DIRECT_REF_RELTOL = 1e-12
DIRECT_REF_RES = 1e-10
DIRECT_TOL = 2e-3
# a float32 observer against its float64 evaluation of the same field,
# relative to the field's scale: its largest value, and for a tensor-basis
# channel of degree k in the velocity gradient max|∇u|^k (a difference of
# products, such as B11 = R S² R² − R² S² R, cancels far below the size
# of its terms, whose rounding it keeps).  The logged vortex criteria are
# read where float32 resolves them (the PR's first card run read the
# D-field 17 % and λ₂ 2.4e-3 off over the whole cavity): λ₂ before the
# log against max|∇u|², its scale (the closed form's arccos keeps
# sqrt(eps) near a double eigenvalue); the D-field |∇p| / (2 ∇²p) on the
# points where float64's ∇²p is 100x the float32 run's largest error in
# it, so that its log moves by < 1 %
OBSERVER_TOL = 1e-3
DFIELD_RESOLVED = 100.0
# each tensor-basis channel's degree in the velocity gradient
TB_DEGREE = {"B1": 0, "B2": 1, "B3": 2, "B4": 2, "B5": 2, "B6": 3, "B7": 3, "B8": 4, "B9": 4,
             "B10": 4, "B11": 5, "V1": 2, "V2": 2, "V3": 3, "V4": 3, "V5": 4}
WALLSHEAR_TOL = 1e-5
STREAM_N = 512
STREAM_TOL = 1e-5


class LoopLog:
    """Wraps `module.device_while` (the CG and Newton loops of
    `time_steppers.imex` / `implicit_rk`) to keep, for each loop, its
    iterations and the residual norm (the carry's last entry) at its
    start and end; `take()` returns them as numbers and clears the
    list, `close()` restores the module."""

    def __init__(self, module):
        self.module, self.orig, self.calls = module, module.device_while, []

        def wrapped(cond, body, carry, maxiter, **kw):
            out, iters = self.orig(cond, body, carry, maxiter, **kw)
            self.calls.append((iters, carry[-1], out[-1]))
            return out, iters

        module.device_while = wrapped

    def take(self):
        calls = [(int(i), float(r0), float(r1)) for i, r0, r1 in self.calls]
        self.calls = []
        return calls

    def close(self):
        self.module.device_while = self.orig


def scaled_divergence(setup, u):
    """max|div u|·h / max|u| over the pressure DOFs, h each cell's own
    smallest spacing: the divergence in units of the velocity's own
    gradient scale at that cell."""
    import torch

    import ins_tpu_torch as it
    from ins_tpu_torch.ops._stencil import slc

    g = setup.grid
    h = None
    for d, (s, e) in enumerate(g.Ip):
        shape = [1] * g.dim
        shape[d] = e - s
        hd = torch.as_tensor(np.asarray(g.delta[d][s:e]), dtype=u.dtype,
                             device=u.device).reshape(shape)
        h = hd if h is None else torch.minimum(h, hd)
    div = it.divergence(u, setup)[slc(g.Ip)]
    return ((div.abs() * h).max() / u.abs().max()).item()


def ldc2d_setup(n, dtype):
    """`examples/lid_driven_cavity_2d.py` at n²: cosine grids on the unit
    square, no-slip walls, the lid (1, 0) at y = 1, Re 1e3."""
    import ins_tpu_torch as it

    x = (it.cosine_grid(0.0, 1.0, n), it.cosine_grid(0.0, 1.0, n))
    d = it.DirichletBC()
    return it.Setup(x=x, boundary_conditions=((d, d), (d, it.DirichletBC((1.0, 0.0)))), Re=1e3,
                    dtype=dtype, device=DEVICE)


def general2_pair(tag, method, n, nsteps, dt, log=None):
    """The 3-D cavity at n³ stepped by `method` with `psolver_fdm` in
    float32 and float64 (`ghosted_run`'s checks), the float32 run held to
    the float64 one within `CAVITY_F64_TOL`, the `scaled_divergence`
    below `F32_DIV_TOL` and `F64_DIV_TOL`; with `log`, each run's loops.
    Returns {dtype: (setup, psolver, state, loops)}."""
    import torch

    import ins_tpu_torch as it

    runs = {}
    for dtype, bound in ((torch.float32, F32_DIV_TOL), (torch.float64, F64_DIV_TOL)):
        setup = cavity_setup(n, dtype)
        psolver = recording(it.psolver_fdm(setup))
        u0 = it.velocityfield(setup, lambda dim, xx, yy, zz: 0.0 * xx, psolver=psolver)
        name = f"{tag} {str(dtype)[6:]}"
        if log is not None:
            log.take()
        state, div = ghosted_run(name, setup, psolver, u0, nsteps, nsteps // 2 or 1, dt,
                                 method=method,
                                 divergence_of=lambda u, setup=setup: scaled_divergence(setup, u))
        if not div <= bound:
            fail(f"[{name}] divergence max|div u| h / max|u| {div:.3e} above {bound}")
        runs[dtype] = (setup, psolver, state, log.take() if log is not None else [])
    agree = rel_err(runs[torch.float32][2].u.double(), runs[torch.float64][2].u)
    print(f"[{tag}] float32 vs float64 on the card after {nsteps} steps: max rel diff "
          f"{agree:.3e} (bound {CAVITY_F64_TOL})")
    if not agree <= CAVITY_F64_TOL:
        fail(f"[{tag}] the float32 run is {agree:.3e} from its float64 run")
    return runs


def phase_general2():
    """Phase 14: the rest of the general path on the card (see the
    docstring).  Returns {case: ms/step}."""
    import torch

    import ins_tpu_torch as it
    from ins_tpu_torch.ops import launches
    from ins_tpu_torch.ops._stencil import slc
    from ins_tpu_torch.ops.channelpath import channelpath_applicable
    from ins_tpu_torch.ops.fdm import laplacian_box
    from ins_tpu_torch.time_steppers import imex, implicit_rk

    f32, f64 = torch.float32, torch.float64
    dt = 1e-3
    cells = CAVITY_N**3
    out = {}

    # AB-CN and one-leg on the 128³ cavity
    ts = it.time_steppers
    for name, method in (("abcn", ts.AdamsBashforthCrankNicolsonMethod()),
                         ("oneleg", ts.OneLegMethod())):
        tag = f"cavity_{name}{CAVITY_N}"
        log = LoopLog(imex)
        try:
            runs = general2_pair(tag, method, CAVITY_N, CAVITY_STEPS, dt, log=log)
        finally:
            log.close()
        setup, psolver, state, loops = runs[f32]
        cg = ", ".join(f"{i}" for i, _, _ in loops) or "none (explicit)"
        wall, idle = profile_ghosted(tag, setup, psolver, state, dt, steps=2, method=method)
        out[tag] = wall
        print(f"[{tag}] f32: {wall:.3f} ms/step, {cells / (wall * 1e-3):.4e} cell-updates/s, "
              f"idle share {idle}; diffusion-CG iterations a step (steps 2-{CAVITY_STEPS}; step 1 "
              f"the RK44 startup): {cg}; {card_line()}")
        if name == "abcn":
            observer_state = (setup, state)
        del runs, psolver
        torch.cuda.empty_cache()

    # implicit RK on the cavity: GL1 by full Newton, SDIRK34 by the approximate
    for mname, nt in (("GL1", "full"), ("SDIRK34", "approximate")):
        method = getattr(it.RKMethods, mname)(newton_type=nt)
        tag = f"cavity_irk{IRK_N} {mname}-{nt}"
        log = LoopLog(implicit_rk)
        t0 = time.perf_counter()
        try:
            runs = general2_pair(tag, method, IRK_N, IRK_STEPS, dt, log=log)
        finally:
            log.close()
        for dtype, (_, _, _, loops) in runs.items():
            print(f"[{tag}] {str(dtype)[6:]} Newton iterations a step "
                  + ", ".join(f"{i} (|G|/|G0| {r1 / max(r0, 1e-300):.3e})" for i, r0, r1 in loops))
        setup, psolver, state, _ = runs[f32]
        wall, idle = profile_ghosted(tag, setup, psolver, state, dt, steps=1, method=method)
        out[tag] = wall
        print(f"[{tag}] f32: {wall:.3f} ms/step, {IRK_N**3 / (wall * 1e-3):.4e} cell-updates/s, "
              f"idle share {idle}; both dtypes' runs and the profile "
              f"{time.perf_counter() - t0:.1f} s; {card_line()}")
        del runs, psolver, state
        torch.cuda.empty_cache()

    # RK44 with the assembled Laplacian's Jacobi CG, against psolver_fdm
    tag = f"cavity_cgmatrix{CAVITY_N}"
    setup = cavity_setup(CAVITY_N, f32)
    t0 = time.perf_counter()
    cgm = it.psolver_cg_matrix(setup, reltol=CGMATRIX_RELTOL)
    build_s = time.perf_counter() - t0
    iters = []

    def counted(f):
        p = cgm(f)
        iters.append(cgm.iterations)
        return p

    counted.is_cg = True
    psolver = recording(counted)
    u0 = it.velocityfield(setup, lambda dim, xx, yy, zz: 0.0 * xx, psolver=psolver)
    iters.clear()
    state, div = ghosted_run(tag, setup, psolver, u0, CAVITY_STEPS, CAVITY_STEPS // 2, dt)
    if not div <= CGMATRIX_DIV_FACTOR * CGMATRIX_RELTOL:
        fail(f"[{tag}] relative divergence {div:.3e} above {CGMATRIX_DIV_FACTOR}x the CG "
             f"reltol {CGMATRIX_RELTOL}")
    counts = [int(i) for i in iters]
    fdm = recording(it.psolver_fdm(setup))
    ref, _ = ghosted_run(f"{tag} (psolver_fdm)", setup, fdm,
                         it.velocityfield(setup, lambda dim, xx, yy, zz: 0.0 * xx, psolver=fdm),
                         CAVITY_STEPS, CAVITY_STEPS // 2, dt)
    agree = rel_err(state.u, ref.u)
    print(f"[{tag}] vs psolver_fdm after {CAVITY_STEPS} steps: max rel diff {agree:.3e} "
          f"(bound: the CG's reltol {CGMATRIX_RELTOL})")
    if not agree <= CGMATRIX_RELTOL:
        fail(f"[{tag}] {agree:.3e} from the psolver_fdm run")
    f = it.scalewithvolume(it.divergence(it.apply_bc_u(
        state.u + dt * it.momentum(state.u, None, state.t, setup), state.t, setup), setup),
        setup)[slc(setup.grid.Ip)]
    solve_ms = cuda_ms(lambda: cgm(f), reps=3, warmup=1)
    wall, idle = profile_ghosted(tag, setup, psolver, state, dt, steps=1)
    out[tag] = wall
    print(f"[{tag}] RK44 f32: {wall:.3f} ms/step, idle share {idle}; Jacobi CG iterations a "
          f"solve min {min(counts)} mean {sum(counts) / len(counts):.1f} max {max(counts)} over "
          f"{len(counts)} solves; one solve {solve_ms:.3f} ms ({int(cgm.iterations)} iterations); "
          f"CSR built in {build_s:.3f} s; {card_line()}")
    del setup, cgm, psolver, state, ref, fdm, f
    torch.cuda.empty_cache()

    # the 2-D lid-driven cavity at 512² with psolver_direct, beside psolver_fdm
    tag = f"ldc2d_direct{LDC2D_N}"
    setup = ldc2d_setup(LDC2D_N, f32)
    # RK44 within its diffusive limit on the cosine grid's smallest cell
    dt2 = 0.25 * setup.Re * float(np.min(setup.grid.delta[0][1:-1])) ** 2
    t0 = time.perf_counter()
    direct = it.psolver_direct(setup)
    factor_s = time.perf_counter() - t0
    states = {}
    for label, solver in (("direct", direct), ("fdm", it.psolver_fdm(setup))):
        rec = recording(solver)
        u0 = it.velocityfield(setup, lambda dim, xx, yy: 0.0 * xx, psolver=rec)
        states[label], div = ghosted_run(
            f"{tag} ({label})", setup, rec, u0, CAVITY_STEPS, CAVITY_STEPS // 2, dt2,
            divergence_of=lambda u: scaled_divergence(setup, u))
        if not div <= F32_DIV_TOL:
            fail(f"[{tag} ({label})] divergence max|div u| h / max|u| {div:.3e} above "
                 f"{F32_DIV_TOL}")
        if label == "direct":
            rec_direct = rec
    g = setup.grid
    agree = max(rel_err(states["direct"].u[(a,) + slc(g.Iu[a])],
                        states["fdm"].u[(a,) + slc(g.Iu[a])]) for a in range(2))
    # each float32 solve of the direct run's last right-hand side against
    # the independent float64 solution (means removed: the gauge),
    # ||p − p_ref|| / ||p_ref||
    setup64 = ldc2d_setup(LDC2D_N, f64)
    f = rec_direct.last
    f0 = f.double() - f.double().mean()
    refcg = it.psolver_cg(setup64, reltol=DIRECT_REF_RELTOL, precond="jacobi")
    t0 = time.perf_counter()
    p_ref = refcg(f.double())
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    ref_res = ((laplacian_box(setup64)(p_ref) - f0).norm() / f0.norm()).item()
    q_ref = p_ref - p_ref.mean()

    def solve_err(p):
        d = p.double() - p_ref
        return ((d - d.mean()).norm() / q_ref.norm()).item()

    errs = {"direct": solve_err(direct(f)), "fdm": solve_err(it.psolver_fdm(setup)(f))}
    print(f"[{tag}] after {CAVITY_STEPS} steps (dt {dt2:.4e}): psolver_direct vs psolver_fdm on "
          f"the velocity DOFs max rel diff {agree:.3e}; the last right-hand side's float64 "
          f"reference (Jacobi CG on laplacian_box, {int(refcg.iterations)} iterations, "
          f"{ref_s:.2f} s) has residual {ref_res:.3e} (bound {DIRECT_REF_RES}); each float32 "
          f"solve against it: direct {errs['direct']:.3e} (bound {DIRECT_TOL}), fdm "
          f"{errs['fdm']:.3e} (the fast diagonalization on this {LDC2D_N}² cosine grid, as the "
          f"JAX package's: tests/torch_floor_checks.py)")
    if not ref_res <= DIRECT_REF_RES:
        fail(f"[{tag}] the float64 reference's residual {ref_res:.3e} above {DIRECT_REF_RES}")
    if not errs["direct"] <= DIRECT_TOL:
        fail(f"[{tag}] the direct solve is {errs['direct']:.3e} from the float64 reference")
    fvec = torch.randn(g.Np, device=DEVICE)
    solve_ms = cuda_ms(lambda: direct(fvec), reps=3, warmup=1)
    wall, idle = profile_ghosted(tag, setup, rec_direct, states["direct"], dt2, steps=2)
    out[tag] = wall
    print(f"[{tag}] RK44 f32: {wall:.3f} ms/step, {LDC2D_N**2 / (wall * 1e-3):.4e} "
          f"cell-updates/s, idle share {idle}; the host LU's factor {factor_s:.2f} s (once), a "
          f"solve {solve_ms:.3f} ms with its two copies; {card_line()}")
    del setup, setup64, direct, states, rec_direct, fvec, refcg, p_ref, q_ref, f, f0
    torch.cuda.empty_cache()

    # fieldobserver: every 3-D name on the AB-CN cavity's float32 state,
    # held to its float64 evaluation of the same field
    setup, state = observer_state
    setup64 = cavity_setup(CAVITY_N, f64)
    p32, p64 = it.psolver_fdm(setup), it.psolver_fdm(setup64)
    s32 = dict(u=state.u, temp=None, t=state.t, n=state.n)
    s64 = dict(u=state.u.double(), temp=None, t=state.t, n=state.n)
    logtol = float(np.finfo(np.float32).eps)
    names = [0, 1, 2, "velocity", "velocitynorm", "vorticity", "pressure", "Dfield", "Qfield",
             "eig2field"] + [f"B{i}" for i in range(1, 12)] + [f"V{i}" for i in range(1, 6)]
    gmax = max(v.abs().max().item() for row in it.ops.operators._gradient_tensor(
        s64["u"], setup64, setup64.grid.Ip) for v in row)
    ip = slc(setup.grid.Ip)
    # the D-field's resolved points: where float64's ∇²p is 100x the
    # float32 run's error in it (the D-field's own ∇²p, from each
    # dtype's pressure)
    def lap_p(st, s, ps):
        G = it.pressuregradient(it.pressure(st["u"], None, st["t"], s, psolver=ps), s)
        return sum((G[a][ip] - G[a][slc(s.grid.Ip, **{f"d{a}": -1})])
                   / it.ops._stencil.dseg(s.dgrid.delta[a], s.grid.Ip, a) for a in range(3))

    lap64 = lap_p(s64, setup64, p64)
    lap_err = (lap_p(s32, setup, p32).double() - lap64).abs().max().item()
    resolved = lap64.abs() >= DFIELD_RESOLVED * lap_err
    errs, shares = {}, {}
    for name in names:
        a = it.fieldobserver(setup, name, psolver=p32, logtol=logtol)
        b = it.fieldobserver(setup64, name, psolver=p64, logtol=logtol)
        got, ref = a(s32), b(s64)
        if got.device.type != "cuda" or not bool(torch.isfinite(got).all()):
            fail(f"[fieldobserver] {name}: not a finite field on the card")
        diff = (got.double() - ref).abs()
        scale = gmax ** TB_DEGREE[name] if name in TB_DEGREE else ref.abs().max().item()
        if name == "Dfield":
            shares[name] = resolved.double().mean().item()
            diff = diff[resolved]
        elif name == "eig2field":  # λ₂ itself against max|∇u|²
            lam32 = it.eig2field(s32["u"], setup)[ip]
            lam64 = it.eig2field(s64["u"], setup64)[ip]
            shares["eig2field (logged)"] = diff.max().item() / scale
            diff, scale = (lam32.double() - lam64).abs(), gmax**2
        errs[name] = diff.max().item() / max(scale, 1e-30) if diff.numel() else 0.0
    ms = cuda_ms(lambda: it.fieldobserver(setup, "eig2field")(s32), reps=3, warmup=1)
    print(f"[fieldobserver] {CAVITY_N}³ AB-CN cavity state (max|∇u| {gmax:.4e}), float32 vs "
          f"its float64 evaluation, max diff over the field's scale (bound {OBSERVER_TOL}; "
          f"Dfield on the {shares['Dfield']:.1%} of points where float32 resolves ∇²p, "
          f"eig2field as λ₂ over max|∇u|², its logged output "
          f"{shares['eig2field (logged)']:.2e}; "
          f"no temperature equation, so no 'temperature'): "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; eig2field {ms:.3f} ms; {card_line()}")
    bad = {k: v for k, v in errs.items() if not v <= OBSERVER_TOL}
    if bad:
        fail(f"[fieldobserver] above the bound: {bad}")
    del observer_state, setup, setup64, state, s32, s64, p32, p64
    torch.cuda.empty_cache()

    # observe_wallshear on both walls of the 256×128×128 channel path
    setup = channel_setup(CHANNEL_BOX)
    psolver = it.psolver_fdm(setup)
    if not channelpath_applicable(setup, it.RKMethods.RK44()):
        fail("the channel setup would not take the channel path")
    u0 = channel_u0(setup, psolver)
    procs = {f"tau{k}": it.observe_wallshear(setup, dim=2, side=k, component=0, nupdate=10)
             for k in (0, 1)}
    # the float64 evaluation of the same field on the same (float32) grid:
    # the wall-normal distance from the run's own coordinates
    xp = np.asarray(setup.grid.xp[2], np.float64)
    nz = setup.grid.N[2]

    def tau64(u, side):
        i_in, i_gh = (1, 0) if side == 0 else (nz - 2, nz - 1)
        du = u[0, 1:-1, 1:-1, i_in].double() - u[0, 1:-1, 1:-1, i_gh].double()
        return (du / (xp[i_in] - xp[i_gh])).mean().item() / setup.Re

    procs["tau64"] = it.observefield(lambda s: [tau64(s["u"], k) for k in (0, 1)], nupdate=10)
    launches.reset_counts()
    state, outs = it.solve_unsteady(setup=setup, ustart=u0, tlims=(0.0, 20 * dt), dt=dt,
                                    psolver=psolver, processors=procs)
    if not launches.LAUNCHES.get("channel_msd_3d"):
        fail("[channel wallshear] the run did not take the channel path")
    errs = []
    for k in (0, 1):
        taus = outs[f"tau{k}"]["tau"]
        if len(taus) != len(outs["tau64"]) + 1:  # observefield keeps no initial reading
            fail("[channel wallshear] the readings do not pair up")
        for tau, ref in zip(taus[1:], outs["tau64"]):
            errs.append(abs(tau - ref[k]) / abs(ref[k]))
    taus = [outs[f"tau{k}"]["tau"][-1] for k in (0, 1)]
    ms = cuda_ms(lambda: procs["tau0"].update(dict(t=[], tau=[]), dict(u=state.u, t=state.t)),
                 reps=3, warmup=1)
    print(f"[channel wallshear] {CHANNEL_BOX} after 20 channel-path steps: tau_w {taus[0]:.6e} "
          f"(z = 0), {taus[1]:.6e} (z = 2); float32 vs its float64 evaluation max rel diff "
          f"{max(errs):.3e} over {len(errs)} readings (bound {WALLSHEAR_TOL}); {ms:.3f} ms a "
          f"reading; {card_line()}")
    if not max(errs) <= WALLSHEAR_TOL:
        fail(f"[channel wallshear] {max(errs):.3e} from the float64 evaluation")
    del setup, psolver, state, u0
    torch.cuda.empty_cache()

    # the streamfunction of a 512² periodic field
    x = (np.linspace(0.0, 2 * np.pi, STREAM_N + 1),) * 2
    s32, s64 = (it.Setup(x=x, Re=1e3, dtype=d, device=DEVICE) for d in (f32, f64))
    u = it.random_field(s32, kp=10, generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    got = it.get_streamfunction(u, s32)
    ref = it.get_streamfunction(u.double(), s64)
    err = rel_err(got.double(), ref)
    ms = cuda_ms(lambda: it.get_streamfunction(u, s32), reps=5)
    print(f"[streamfunction] {STREAM_N}² periodic field: float32 vs float64 max rel diff "
          f"{err:.3e} (bound {STREAM_TOL}); {ms:.3f} ms; {card_line()}")
    if not (bool(torch.isfinite(got).all()) and err <= STREAM_TOL):
        fail(f"[streamfunction] {err:.3e} from float64")
    return out


# --------------------------------------------------------------------------
# phase 1, the default precision: the bf16x3 forms ("manualhigh")
# --------------------------------------------------------------------------

# the bf16x3 plane transform's sizes (each with its ragged n - 6; timed at
# 256³, the main path's) and the fused pass B's cases: the folded cube at
# 256³ (one level, the main path's) and 512³ (two levels), the dense 250³
# cube, the 4-way shard of 256³ at two y offsets; the 3-pass solve's n
BF16X3_TRANSFORM_SIZES = (64, 512, 256)
BF16X3_FOLD_CASES = ((256, 1, 256, 0), (512, 2, 512, 0))
BF16X3_DENSE_CASES = ((250, 250, 0),)
BF16X3_SHARD_CASES = ((256, 1, 64, 64), (256, 1, 64, 192))
BF16X3_SOLVE_N = 128


def bf16x3_transform_cases(n):
    """{"plane_transform+bf16x3": `transform_cases` in the bf16x3 form at
    n}, on an input made from a seed."""
    import torch

    from ins_tpu_torch.ops.poisson_kernels import make_fused_projection

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 11 * n)
    f = torch.from_numpy(rng.standard_normal((n, n, n), dtype=np.float32)).to(dev)
    proj = make_fused_projection((n,) * 3, (2 * np.pi / n,) * 3, torch.float32, device=dev)
    return {"plane_transform+bf16x3": transform_cases(n, f, proj, "manualhigh")}


def bf16x3_passb_cases(_n):
    """{kernel name: [Case, ...]} of the fused pass B in bf16x3 (the main
    paths' shapes first), each within `BF16X3_CLASS_TOL` of float64 and
    `BF16X3_PLAIN_TOL` of its plain version."""
    return {
        "passB_fold+bf16x3": [fold_case(*c, "manualhigh") for c in BF16X3_FOLD_CASES],
        "passB+bf16x3": [dense_case(*c, "manualhigh") for c in BF16X3_DENSE_CASES],
        "passB_sharded+bf16x3": [fold_case(*c, "manualhigh") for c in BF16X3_SHARD_CASES],
    }


def precision_classes():
    """Each form's distance from float64 on the same inputs, printed side
    by side: the z+y and x transforms at 256³ and 512³, the fused pass B's
    bf16x3 cases and the 3-pass solve at `BF16X3_SOLVE_N`³ (also held,
    kernels against plain, within `BF16X3_PLAIN_TOL`).  Fails where the
    3xTF32 form leaves the float32 class (`TF32_CLASS_TOL` for a
    transform, `DENSE_F64_TOL` for pass B and the solve), the bf16x3 form
    leaves `BF16X3_CLASS_TOL`, or the two are less than `CLASS_APART`
    apart.  {label: (bf16x3 error, 3xTF32 error)}."""
    import torch

    from ins_tpu_torch.ops import poisson_kernels as pk
    from ins_tpu_torch.ops.transforms import (
        PRECISIONS, x_transform, x_transform_plain, yz_transform, yz_transform_plain,
    )

    dev = torch.device(DEVICE)
    out = {}

    def check(label, run, ref, tf32_tol):
        err = {p: rel_err(run(p).double(), ref) for p in PRECISIONS}
        bf, tf = err["manualhigh"], err["highest"]
        print(f"[precision] {card_line()}: {label}: max rel err against float64, bf16x3 "
              f"(manualhigh) {bf:.3e}, 3xTF32 (highest) {tf:.3e}: {bf / max(tf, 1e-30):.1f}x")
        if not (tf <= tf32_tol and bf <= BF16X3_CLASS_TOL and bf >= CLASS_APART * tf):
            fail(f"[precision] {label}: bf16x3 {bf:.3e} (bound {BF16X3_CLASS_TOL}), 3xTF32 "
                 f"{tf:.3e} (bound {tf32_tol}), not {CLASS_APART}x apart")
        out[label] = (bf, tf)

    for n in (256, 512):
        dxs = (2 * np.pi / n,) * 3
        rng = np.random.default_rng(SEED + 13 * n)
        f = torch.from_numpy(rng.standard_normal((n, n, n), dtype=np.float32)).to(dev)
        proj = pk.make_fused_projection((n,) * 3, dxs, torch.float32, device=dev)
        p64 = pk.make_fused_projection((n,) * 3, dxs, torch.float64, device=dev)
        ref = yz_transform_plain(f.double(), p64["Vinv"], p64["VinvT"])
        check(f"Vinv_y . f . Vinv_z^T at {n}³",
              lambda p: yz_transform(f, proj["Vinv"], proj["VinvT"], p), ref, TF32_CLASS_TOL)
        ref = x_transform_plain(p64["V"], f.double())
        check(f"V_x . f at {n}³", lambda p: x_transform(proj["V"], f, p), ref, TF32_CLASS_TOL)
        del f, proj, p64, ref
        torch.cuda.empty_cache()
    for c in BF16X3_FOLD_CASES + BF16X3_SHARD_CASES:
        n, levels, ly, yoff = c
        runs = {p: fold_setup(*c, p) for p in PRECISIONS}
        h, _, p64, label = runs["highest"]
        check(f"pass B {label}", lambda p: fold_kernel(runs[p][0], runs[p][1], yoff),
              pk.passB_sharded_plain(h.double(), p64, yoff), DENSE_F64_TOL)
        del runs, h, p64
    for c in BF16X3_DENSE_CASES:
        runs = {p: dense_setup(*c, p) for p in PRECISIONS}
        h, _, p64, label = runs["highest"]
        check(f"pass B {label}", lambda p: pk.passB(runs[p][0], runs[p][1]),
              pk.passB_plain(h.double(), p64), DENSE_F64_TOL)
        del runs, h, p64
    n = BF16X3_SOLVE_N
    dxs = (1.0 / n,) * 3
    f = torch.from_numpy(np.random.default_rng(SEED + n).standard_normal(
        (n, n, n), dtype=np.float32)).to(dev)
    solve = {(p, plain): pk.make_poisson_pallas((n,) * 3, dxs, torch.float32, precision=p,
                                                 device=dev, plain=plain)
             for p in PRECISIONS for plain in (False, True)}
    ref = pk.make_poisson_pallas((n,) * 3, dxs, torch.float64, device=dev, plain=True)(
        f.double())
    check(f"the 3-pass solve at {n}³", lambda p: solve[p, False](f), ref, DENSE_F64_TOL)
    err = rel_err(solve["manualhigh", False](f), solve["manualhigh", True](f))
    print(f"[precision] the 3-pass solve at {n}³ in bf16x3: kernels against the plain "
          f"version {err:.3e} (bound {BF16X3_PLAIN_TOL})")
    if not err <= BF16X3_PLAIN_TOL:
        fail(f"the bf16x3 3-pass solve at {n}³ is {err:.3e} from its plain version")
    torch.cuda.empty_cache()
    return out


def phase_precision_kernels():
    """Phase 1's checks of the default precision's kernels: the bf16x3
    forms against their plain versions and float64 (`bf16x3_*_cases`,
    timed beside their bounds), both classes side by side
    (`precision_classes`), and the three gates measured in each precision
    in turns.  Returns the kernel results."""
    results = phase_kernels(bf16x3_transform_cases, BF16X3_TRANSFORM_SIZES, time_at=256,
                            time_all=("plane_transform+bf16x3",))
    results.update(phase_kernels(bf16x3_passb_cases, (256,),
                                 time_all=("passB_fold+bf16x3", "passB_sharded+bf16x3")))
    precision_classes()
    for p in ("manualhigh", "highest"):
        fold_gate_times(precision=p)
        dense_gate_times(precision=p)
        solve_gate_times(precision=p)
    return results


# --------------------------------------------------------------------------
# phase 17: the 512³ RK44 and LMWray3 cells in both precisions
# --------------------------------------------------------------------------

# `bench.py`'s `run_case(512, 2, 5)` (`512`, `512_lmwray3`): the periodic
# box [0, 2π]³, Re 4000, float32, `psolver_spectral`, dt = 1e-3·128/512,
# 2 warm-up steps and 5 timed ones; the plain chain against the kernels for
# PRECISION_PLAIN_STEPS steps in each precision, within REL_TOL (the
# 3-pass bf16 class moves a transform by ~1e-5 of float64; the kernels and
# the plain version share its products)
PRECISION_N = 512
PRECISION_WARMUP = 2
PRECISION_STEPS = 5
PRECISION_PLAIN_STEPS = 2
# the x-slab chain's and the dense chain's 3xTF32 runs ("highest"): steps
HIGHEST_PATH_STEPS = 4


def precision_turn(setup, name, method, u0, dt, precision, e0):
    """`solve_unsteady` for the bench's warm-up and timed steps in
    ``precision``, the launch counts set to 0 before and read after;
    checks finite, divergence (phase 2's bounds), energy not increasing
    and the launches.  Returns (the final velocity, peak GiB, counts)."""
    import torch

    import ins_tpu_torch as it
    from ins_tpu_torch.ops import launches
    from ins_tpu_torch.ops.fastpath import strip_ghosts

    steps = PRECISION_WARMUP + PRECISION_STEPS
    torch.cuda.reset_peak_memory_stats()
    launches.reset_counts()
    state, _ = it.solve_unsteady(setup=setup, ustart=u0, tlims=(0.0, steps * dt), dt=dt,
                                 method=method, psolver=it.psolver_spectral(setup),
                                 projection_precision=precision)
    torch.cuda.synchronize()
    counts = {k: v for k, v in run_counts(precision).items() if v}
    plain = {k: v for k, v in launches.PLAIN_ON_CUDA.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = setup.grid.Np[0]
    keys = form_keys(precision)
    per = 3 if name == "LMWray3" else 4
    print(f"[{n}^3 {name}] {precision}: solve_unsteady, {steps} steps: peak memory "
          f"{peak:.2f} GiB; launches {counts}")
    if (plain or counts.get(keys["passB_fold"]) != per * steps
            or counts.get("passB_fold+levels")):
        fail(f"[{n}^3 {name}] {precision}: launches {counts}, plain {plain}; expected "
             f"{keys['passB_fold']} {per * steps} (the fused kernel at n = {n})")
    missing = [k for k in (keys["plane_transform"], "pcmsd_hat_3d") if not counts.get(k)]
    if missing:
        fail(f"[{n}^3 {name}] {precision}: never launched {missing}")
    u = strip_ghosts(state.u)
    if not bool(torch.isfinite(u).all()):
        fail(f"[{n}^3 {name}] {precision}: non-finite velocity")
    check_divergence(u, float(setup.grid.delta[0][0]), f"{n}^3 {name} {precision}")
    e1 = it.total_kinetic_energy(state.u, setup).item()
    print(f"[{n}^3 {name}] {precision}: kinetic energy {e0:.9e} -> {e1:.9e}")
    if not e1 <= e0:
        fail(f"[{n}^3 {name}] {precision}: kinetic energy increased")
    return u, peak, counts


def phase_precision(n=PRECISION_N):
    """17: `bench.py`'s 512³ RK44 and LMWray3 cells on the hat chain in
    each precision: `solve_unsteady` for the bench's steps
    (`precision_turn`: launches, divergence, energy, peak memory), the
    hat chains' ms/step in turns (manualhigh, highest, highest,
    manualhigh; `chains_ms_per_step`, the bench's 2 warm-up steps and 5
    timed ones), then the plain chain against the kernels for
    `PRECISION_PLAIN_STEPS` steps in each; then `highest_paths`.
    Returns ({cell: {precision: [ms, ms]}}, the "highest" runs' launch
    counts summed)."""
    import torch

    import ins_tpu_torch as it
    from ins_tpu_torch.ops.fastpath import make_fast_timestep_hat, strip_state
    from ins_tpu_torch.ops.transforms import PRECISIONS

    field_gb = 3 * n**3 * 4 / 1e9
    print(f"[{n}^3] memory reckoned: one velocity field 3·{n}³·4 B = {field_gb:.2f} GB; the "
          f"hat chain holds about eight fields ({8 * field_gb:.1f} GB), the plain chain's "
          f"temporaries a few more; the card has "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB")
    setup = headline_setup(n)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    u0 = it.random_field(setup, kp=10, generator=gen)
    dt = 1e-3 * 128 / n
    e0 = it.total_kinetic_energy(u0, setup).item()
    times, highest = {}, {}
    for name, method in (("RK44", it.RKMethods.RK44()), ("LMWray3", it.LMWray3())):
        last, peak = {}, {}
        for p in PRECISIONS:
            last[p], peak[p], counts = precision_turn(setup, name, method, u0, dt, p, e0)
            if p == "highest":
                add_counts(highest, counts)
        gap = rel_err(last["manualhigh"], last["highest"])
        del last
        torch.cuda.empty_cache()
        s0 = strip_state(it.create_stepper(method, setup=setup, u=u0))
        chains = {p: make_fast_timestep_hat(setup, method, projection_precision=p)
                  for p in ("manualhigh", "highest")}
        ms = chains_ms_per_step(chains, s0, dt, steps=PRECISION_STEPS)
        for p in ("manualhigh", "highest"):
            m = sum(ms[p]) / 2
            print(f"[{n}^3 {name}] {p}: hat chain {m:.3f} ms/step ({ms[p][0]:.3f}, "
                  f"{ms[p][1]:.3f}; {PRECISION_WARMUP} warm-up steps, {PRECISION_STEPS} timed, "
                  f"in turns with the other precision), {n**3 / (m * 1e-3):.4e} "
                  f"cell-updates/s; solve_unsteady's peak memory {peak[p]:.2f} GiB; "
                  f"{card_line()}")
        print(f"[{n}^3 {name}] after {PRECISION_WARMUP + PRECISION_STEPS} steps the two "
              f"precisions differ by {gap:.3e} (max rel)")
        for p in ("manualhigh", "highest"):
            k = run_plain_chain(setup, method, s0, dt, PRECISION_PLAIN_STEPS,
                                PRECISION_PLAIN_STEPS, fns=chains[p])
            q = run_plain_chain(setup, method, s0, dt, PRECISION_PLAIN_STEPS,
                                PRECISION_PLAIN_STEPS, precision=p)
            agree = rel_err(k.u, q.u)
            print(f"[{n}^3 {name}] {p}: kernel chain vs plain chain after "
                  f"{PRECISION_PLAIN_STEPS} steps: max rel diff {agree:.3e} (bound {REL_TOL})")
            if not agree <= REL_TOL:
                fail(f"[{n}^3 {name}] {p}: kernel and plain chains disagree by {agree:.3e}")
            del k, q
            torch.cuda.empty_cache()
        times[f"{n}^3 {name}"] = ms
        del chains, s0
    del u0, setup
    torch.cuda.empty_cache()
    add_counts(highest, highest_paths())
    return times, highest


def highest_paths(steps=HIGHEST_PATH_STEPS):
    """The 3xTF32 forms of the dense and the sharded pass B on their paths:
    phase 12's 250³ chain and phase 8's one-rank x-slab chain at 256³, each
    in "highest" for ``steps`` steps through `solve_unsteady` (launches,
    finite, divergence; the dense chain against its plain chain, the
    x-slab chain within `REL_TOL` of the single-device chain in the same
    precision).  Returns the two runs' launch counts summed."""
    import torch
    import torch.distributed as dist

    import ins_tpu_torch as it
    from ins_tpu_torch.ops import launches
    from ins_tpu_torch.ops.fastpath import strip_ghosts
    from ins_tpu_torch.parallel import make_mesh

    total = {k: v for k, v in phase_dense_chain(nsteps=steps, chunk=steps // 2,
                                                 precision="highest").items() if v}
    n = 256
    setup = headline_setup(n)
    u0 = it.random_field(setup, kp=10, generator=torch.Generator(device=DEVICE).manual_seed(1))
    dt = 1e-3 * 128 / n
    kw = dict(setup=setup, ustart=u0, tlims=(0.0, steps * dt), dt=dt,
              method=it.RKMethods.RK44(), projection_precision="highest")
    launches.reset_counts()
    hs, _ = it.solve_unsteady(mesh=make_mesh(), halo=True, **kw)
    torch.cuda.synchronize()
    dist.destroy_process_group()
    counts = {k: v for k, v in run_counts("highest").items() if v}
    plain = {k: v for k, v in launches.PLAIN_ON_CUDA.items() if v}
    ss, _ = it.solve_unsteady(psolver=it.psolver_spectral(setup), **kw)
    u = strip_ghosts(hs.u)
    agree = rel_err(u, strip_ghosts(ss.u))
    print(f"[halo] {n}^3 RK44, highest, {steps} steps: launches {counts}; vs the single-device "
          f"chain {agree:.3e}")
    key = form_keys("highest")["passB_sharded"]
    if plain or counts.get(key) != 4 * steps or not bool(torch.isfinite(u).all()):
        fail(f"the highest x-slab run: launches {counts}, plain {plain}, expected {key} "
             f"{4 * steps}, finite")
    check_divergence(u, float(setup.grid.delta[0][0]), "halo highest")
    if not agree <= REL_TOL:
        fail(f"the highest x-slab run is {agree:.3e} from the single-device chain")
    del hs, ss, u, u0
    torch.cuda.empty_cache()
    return add_counts(total, counts)


LES_KERNELS = ("smagorinsky_force_3d", "pcmsd_hat_3d+smag")
# the cube wrappers that run plane-transform GEMMs around a stage or
# correction kernel (split by `profile_cases` under --profile), and the
# folded pass B (one kernel: its device time alone)
STAGE_WRAPPERS = ("pcmsd_hat_3d", "pcmsd_hat_3d+smag", "pcmsd_hat_3d+temp",
                  "momentum_stage_divhat_3d", "momentum_stage_divhat_3d+temp",
                  "pressure_correct_qhat_3d", "passB_fold")
TRAINING_KERNELS = (
    "convdiff_interior_3d", "stage_div_3d", "pressure_correct_3d",
    "fusedconv_3d", "fusedconv_wgrad_3d",
)
# kernels whose table time is their device time (`device_ms`): tens of
# microseconds, below the host's time to launch them back to back
DEVICE_TIMED = ("convdiff_interior_3d", "stage_div_3d", "pressure_correct_3d")
# the per-op kernels' launches in phase 3's bf16 gradient step (5 unrolled
# RK44 steps with remat)
PEROP_STEP_LAUNCHES = {"convdiff_interior_3d": 40, "stage_div_3d": 40, "pressure_correct_3d": 35}
# the fused conv layer's float32 route (phase 3's float32 run)
F32_CONV_KERNELS = ("fusedconv_3d+f32", "fusedconv_wgrad_3d+f32")
CONV_KEYS = ("fusedconv_3d", "fusedconv_wgrad_3d") + F32_CONV_KERNELS
CHANNEL_KERNELS = ("channel_msd_3d", "channel_pressure_correct_3d")
TEMP_KERNELS = ("pcmsd_hat_3d+temp", "momentum_stage_divhat_3d+temp")
HALO_KERNELS = ("momentum_stage_divhat_halo_3d", "pcmsd_hat_halo_3d",
                "pressure_correct_qhat_halo_3d")
HALO_LES_KERNELS = ("smagorinsky_force_halo_3d", "momentum_stage_divhat_halo_3d+smag",
                    "pcmsd_hat_halo_3d+smag")
UNMERGED_KERNELS = ("momentum_stage_divhat_3d+bf16", "pcmsd_hat_3d+bf16",
                    "pressure_correct_qhat_3d+bf16", "momentum_stage_divhat_3d+streams")
TAP_KERNELS = ("tapconv_3d", "packconv_3d", "tapconv_wgrad_3d", "momentum_stage_div_3d",
               "tapconv_3d+f32", "packconv_3d+f32", "tapconv_wgrad_3d+f32")


KERNEL_META = {  # name: (source, the TPU kernel it replaces)
    "plane_transform": ("ins_tpu_torch/csrc/transforms.cu", "ins_tpu/ops/pallas_kernels.py:87"),
    "pcmsd_hat_3d": ("ins_tpu_torch/csrc/stage.cu", "ins_tpu/ops/pallas_kernels.py:2694"),
    "momentum_stage_divhat_3d": ("ins_tpu_torch/csrc/stage.cu", "ins_tpu/ops/pallas_kernels.py:1264"),
    "passB": ("ins_tpu_torch/csrc/fold.cu", "ins_tpu/ops/poisson_pallas.py:451"),
    "passB_fold": ("ins_tpu_torch/csrc/fold.cu", "ins_tpu/ops/poisson_pallas.py:432"),
    # the folded pass B's level route above the fused kernel's range (its
    # x products are plane GEMMs, transforms.cu)
    "passB_fold+levels": ("ins_tpu_torch/csrc/poisson.cu", "ins_tpu/ops/poisson_pallas.py:432"),
    "smagorinsky_force_3d": ("ins_tpu_torch/csrc/smag.cu", "ins_tpu/ops/pallas_kernels.py:2292"),
    "pcmsd_hat_3d+smag": ("ins_tpu_torch/csrc/stage.cu", "ins_tpu/ops/pallas_kernels.py:2639"),
    "pcmsd_hat_3d+temp": ("ins_tpu_torch/csrc/stage.cu", "ins_tpu/ops/pallas_kernels.py:2645"),
    "momentum_stage_divhat_3d+temp": ("ins_tpu_torch/csrc/stage.cu",
                                      "ins_tpu/ops/pallas_kernels.py:1264"),
    "make_poisson_pallas": ("ins_tpu_torch/csrc/transforms.cu",
                            "ins_tpu/ops/poisson_pallas.py:308"),
    "pressure_correct_qhat_3d": ("ins_tpu_torch/csrc/correct.cu", "ins_tpu/ops/pallas_kernels.py:3422"),
    "convdiff_interior_3d": ("ins_tpu_torch/csrc/perop.cu", "ins_tpu/ops/pallas_kernels.py:312"),
    "stage_div_3d": ("ins_tpu_torch/csrc/perop.cu", "ins_tpu/ops/pallas_kernels.py:458"),
    "pressure_correct_3d": ("ins_tpu_torch/csrc/perop.cu", "ins_tpu/ops/pallas_kernels.py:3546"),
    "fusedconv_3d": ("ins_tpu_torch/csrc/conv.cu", "ins_tpu/ops/convkernels.py:780"),
    "fusedconv_wgrad_3d": ("ins_tpu_torch/csrc/conv.cu", "ins_tpu/ops/convkernels.py:918"),
    "fusedconv_3d+f32": ("ins_tpu_torch/csrc/conv.cu", "ins_tpu/ops/convkernels.py:780"),
    "fusedconv_wgrad_3d+f32": ("ins_tpu_torch/csrc/conv.cu", "ins_tpu/ops/convkernels.py:918"),
    "channel_msd_3d": ("ins_tpu_torch/csrc/channel.cu", "ins_tpu/ops/channel_kernels.py:333"),
    "channel_pressure_correct_3d": ("ins_tpu_torch/csrc/channel.cu",
                                    "ins_tpu/ops/channel_kernels.py:503"),
    "momentum_stage_divhat_halo_3d": ("ins_tpu_torch/csrc/stage.cu",
                                      "ins_tpu/ops/pallas_kernels.py:1730"),
    "pcmsd_hat_halo_3d": ("ins_tpu_torch/csrc/stage.cu", "ins_tpu/ops/pallas_kernels.py:3183"),
    "pressure_correct_qhat_halo_3d": ("ins_tpu_torch/csrc/correct.cu",
                                      "ins_tpu/ops/pallas_kernels.py:1937"),
    "passB_sharded": ("ins_tpu_torch/csrc/fold.cu", "ins_tpu/ops/poisson_pallas.py:480"),
    # the default precision ("manualhigh"): the bf16x3 forms of the plane
    # GEMM (`_mm_h` / `_mm_h_left` with manualhigh) and the fused pass B
    # (`_passB_body` / `_passB_fold_body` with prec None, `_dot_h` :68)
    "plane_transform+bf16x3": ("ins_tpu_torch/csrc/transforms.cu",
                               "ins_tpu/ops/pallas_kernels.py:87"),
    "passB_fold+bf16x3": ("ins_tpu_torch/csrc/fold.cu", "ins_tpu/ops/poisson_pallas.py:432"),
    "passB+bf16x3": ("ins_tpu_torch/csrc/fold.cu", "ins_tpu/ops/poisson_pallas.py:451"),
    "passB_sharded+bf16x3": ("ins_tpu_torch/csrc/fold.cu", "ins_tpu/ops/poisson_pallas.py:480"),
    "passB_sharded+levels": ("ins_tpu_torch/csrc/poisson.cu",
                             "ins_tpu/ops/poisson_pallas.py:480"),
    "smagorinsky_force_halo_3d": ("ins_tpu_torch/csrc/smag.cu",
                                  "ins_tpu/ops/pallas_kernels.py:2243"),
    "momentum_stage_divhat_halo_3d+smag": ("ins_tpu_torch/csrc/stage.cu",
                                           "ins_tpu/ops/pallas_kernels.py:1759"),
    "pcmsd_hat_halo_3d+smag": ("ins_tpu_torch/csrc/stage.cu",
                               "ins_tpu/ops/pallas_kernels.py:3207"),
    "momentum_stage_divhat_3d+bf16": ("ins_tpu_torch/csrc/stage.cu",
                                      "ins_tpu/ops/pallas_kernels.py:1264"),
    "pcmsd_hat_3d+bf16": ("ins_tpu_torch/csrc/stage.cu", "ins_tpu/ops/pallas_kernels.py:2694"),
    "pressure_correct_qhat_3d+bf16": ("ins_tpu_torch/csrc/correct.cu",
                                      "ins_tpu/ops/pallas_kernels.py:3422"),
    "momentum_stage_divhat_3d+streams": ("ins_tpu_torch/csrc/stage.cu",
                                         "ins_tpu/ops/pallas_kernels.py:1126"),
    "tapconv_3d": ("ins_tpu_torch/csrc/tapconv_mma.cu", "ins_tpu/ops/convkernels.py:130"),
    "packconv_3d": ("ins_tpu_torch/csrc/tapconv_mma.cu", "ins_tpu/ops/convkernels.py:471"),
    "tapconv_wgrad_3d": ("ins_tpu_torch/csrc/tapwgrad_mma.cu", "ins_tpu/ops/convkernels.py:249"),
    "momentum_stage_div_3d": ("ins_tpu_torch/csrc/stage.cu", "ins_tpu/ops/pallas_kernels.py:631"),
    "tapconv_3d+f32": ("ins_tpu_torch/csrc/tapconv_tf32.cu", "ins_tpu/ops/convkernels.py:130"),
    "packconv_3d+f32": ("ins_tpu_torch/csrc/tapconv_tf32.cu", "ins_tpu/ops/convkernels.py:471"),
    "tapconv_wgrad_3d+f32": ("ins_tpu_torch/csrc/tapwgrad_tf32.cu",
                             "ins_tpu/ops/convkernels.py:249"),
}


# --------------------------------------------------------------------------
# phase 15: adaptive (CFL) time stepping and unsteady body forces
# --------------------------------------------------------------------------

ADAPTIVE_CFL = 0.9
ADAPTIVE_STEPS = 20  # about this many steps a run: tend is this many seed dt's
ADAPTIVE_N_ADAPT = (1, 10)
# each step's dt against ADAPTIVE_CFL times the float64 CFL limit of the
# corrected u on the same grid (`cfl_twin`: the float32 limit rounds its
# division once, the product once)
ADAPTIVE_DT_TOL = 1e-6
ADAPTIVE_CAVITY_N = 128
UNSTEADY_N = 256
UNSTEADY_STEPS = 5


def unsteady_force(dim, x, y, z, t):
    """A time-periodic force on the 2π-periodic cube: (0.5 sin(y) cos(200 t),
    0.25 cos(x) sin(200 t), 0); one period is ~63 steps of 5e-4."""
    import torch

    if dim == 0:
        return 0.5 * torch.sin(y) * torch.cos(200 * t)
    if dim == 1:
        return 0.25 * torch.cos(x) * torch.sin(200 * t)
    return 0.0 * z


def cavity_force(dim, x, y, z, t):
    """A time-periodic force in the unit cavity: (0.5 sin(πz) cos(20 t),
    0.25 sin(πx) sin(20 t), 0)."""
    import torch

    if dim == 0:
        return 0.5 * torch.sin(np.pi * z) * torch.cos(20 * t)
    if dim == 1:
        return 0.25 * torch.sin(np.pi * x) * torch.sin(20 * t)
    return 0.0 * z


def adaptive_cavity_setup(n, dtype):
    """Phase 13's cavity (`cavity_setup`) with the unsteady `cavity_force`."""
    import ins_tpu_torch as it

    base = cavity_setup(n, dtype)
    x = tuple(np.linspace(0.0, 1.0, n + 1) for _ in range(3))
    return it.Setup(x=x, boundary_conditions=base.boundary_conditions, Re=base.Re, dtype=dtype,
                    device=DEVICE, bodyforce=cavity_force, issteadybodyforce=False)


def cfl_twin(setup):
    """The float32 ``setup`` as float64 with its grid's pressure-point
    distances widened, not recomputed: `get_cfl_timestep` of it is the
    float32 setup's limit in float64 arithmetic.  (A float64 grid's own
    distances differ from the float32 grid's by its coordinates'
    rounding: up to ~8e-6 of a spacing on the 2π cube at 256, more on
    longer boxes.)"""
    import dataclasses

    import torch

    g = setup.grid
    grid = dataclasses.replace(g, delta_u=tuple(np.asarray(d, np.float64) for d in g.delta_u))
    return dataclasses.replace(setup, grid=grid, dtype=torch.float64)


def adaptive_by_hand(setup, setup64, fns, state, tend, n_adapt, max_steps=None):
    """The chain ``fns`` (to, step, from) stepped as `solve_unsteady(dt=None,
    cfl=ADAPTIVE_CFL)` steps it in one chunk, written out: every
    ``n_adapt`` steps dt = cfl × `get_cfl_timestep` of the corrected u,
    cut to what is left to ``tend``, t and dt in the setup's dtype.
    Returns the final state, the dt list and the largest relative
    distances of a recomputed dt from cfl × the CFL limit of the same u in
    float64, on the same grid (`cfl_twin`) and on the float64 grid
    ``setup64``.  ``max_steps`` stops it early (a pilot run)."""
    import torch

    import ins_tpu_torch as it

    fdt = np.float32 if setup.dtype == torch.float32 else np.float64
    to, step, frm = fns
    cfl, tend_ = fdt(ADAPTIVE_CFL), fdt(tend)
    margin = fdt(1e-14) * max(fdt(1.0), abs(tend_))
    dtc = cfl * fdt(it.get_cfl_timestep(state.u, setup).item())
    c = to(state._replace(t=fdt(state.t)))
    twin = cfl_twin(setup)
    dts, worst = [], [0.0, 0.0]
    while c.t < tend_ - margin and (max_steps is None or len(dts) < max_steps):
        if c.n % n_adapt == 0:
            u = frm(c).u
            dtc = cfl * fdt(it.get_cfl_timestep(u, setup).item())
            for i, s64 in enumerate((twin, setup64)):
                ref = ADAPTIVE_CFL * it.get_cfl_timestep(u.double(), s64).item()
                worst[i] = max(worst[i], abs(float(dtc) - ref) / ref)
        dt = fdt(min(dtc, tend_ - c.t))
        dts.append(dt)
        c = step(c, dt)
    return frm(c), dts, worst


def timed_idle(fn):
    """(wall ms, device ms, idle share) of one fn() call after a warm-up
    call, under torch.profiler (device ms None where the trace holds no
    device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    dev = sum(e.self_device_time_total for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return wall, (dev if dev > 0 else None), (1.0 - dev / wall if dev > 0 else None)


def adaptive_costs(tag, setup, fns, state, steps=10):
    """ms/step of the chain at a fixed dt (the seed's) and with the CFL
    limit recomputed every n_adapt steps (each recompute: `from` of the
    carry, `get_cfl_timestep`, its host read), in turns (fixed, every
    step, every 10th, every 10th, every step, fixed), each after two
    warm-up steps; then each mode's idle share under the profiler."""
    import torch

    import ins_tpu_torch as it

    fdt = np.float32 if setup.dtype == torch.float32 else np.float64
    to, step, frm = fns
    dt0 = fdt(ADAPTIVE_CFL) * fdt(it.get_cfl_timestep(state.u, setup).item())

    def run(n_adapt):
        c = step(step(to(state), dt0), dt0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        dt = dt0
        for i in range(steps):
            if n_adapt and i % n_adapt == 0:
                dt = fdt(ADAPTIVE_CFL) * fdt(it.get_cfl_timestep(frm(c).u, setup).item())
            c = step(c, dt)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / steps

    modes = {"fixed": 0, "every step": 1, "every 10th": 10}
    times = {k: [] for k in modes}
    for k in ("fixed", "every step", "every 10th", "every 10th", "every step", "fixed"):
        times[k].append(run(modes[k]))
    idle = {k: timed_idle(lambda v=v: run(v)) for k, v in modes.items()}
    print(f"[{tag}] ms/step in turns: " + "; ".join(
        f"{k} {sum(v) / len(v):.4f} ({', '.join(f'{x:.4f}' for x in v)})" for k, v in times.items())
        + f"; the recompute every step costs "
        f"{(sum(times['every step']) - sum(times['fixed'])) / sum(times['fixed']) * 100:.2f} %")
    print(f"[{tag}] under the profiler, {steps} steps (wall ms, device ms, idle share): "
          + "; ".join(f"{k} {w:.3f}, {d if d is None else f'{d:.3f}'}, "
                      f"{i if i is None else f'{i:.4f}'}" for k, (w, d, i) in idle.items())
          + f"; card {card_line('clocks.sm,power.draw,temperature.gpu')}")
    return times, idle


def adaptive_case(tag, setup, setup64, fns, state0, ustart, method, psolver, strip, expect):
    """`solve_unsteady(dt=None, cfl=ADAPTIVE_CFL, n_adapt_dt=k)` for each k
    of `ADAPTIVE_N_ADAPT` from ``ustart`` (``state0`` in the chain's
    layout) to the t that a pilot of the chain stepped by hand reaches in
    `ADAPTIVE_STEPS` steps: its launches are ``expect(n, k)`` exactly (no
    other kernel but the plane transforms, no plain version on CUDA), the
    state finite, every recomputed dt within `ADAPTIVE_DT_TOL` of cfl ×
    the float64 CFL limit of its u, the run bit for bit the chain ``fns``
    stepped by hand (`adaptive_by_hand`).  Returns the launches summed
    over the runs, and the last run's state."""
    import torch

    import ins_tpu_torch as it
    from ins_tpu_torch.ops import launches

    pilot, _, _ = adaptive_by_hand(setup, setup64, fns, state0, 1e30, 1, ADAPTIVE_STEPS)
    tend = float(pilot.t)
    del pilot
    total = {}
    for k in ADAPTIVE_N_ADAPT:
        launches.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = it.solve_unsteady(setup=setup, ustart=ustart, tlims=(0.0, tend), dt=None,
                                     cfl=ADAPTIVE_CFL, n_adapt_dt=k, method=method,
                                     psolver=psolver)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n: v for n, v in run_counts().items() if v}
        plain = {n: v for n, v in launches.PLAIN_ON_CUDA.items() if v}
        u = strip(state.u)
        if plain:
            fail(f"[{tag}] plain versions ran on CUDA tensors: {plain}")
        if not bool(torch.isfinite(u).all()):
            fail(f"[{tag}] non-finite velocity after the adaptive run")
        hand, dts, worst = adaptive_by_hand(setup, setup64, fns, state0, tend, k)
        want = expect(state.n, k)
        got = {n: v for n, v in counts.items() if n != form_keys()["plane_transform"]}
        print(f"[{tag}] solve_unsteady(dt=None, cfl={ADAPTIVE_CFL}, n_adapt_dt={k}) to t = "
              f"{tend:.6e}: {state.n} steps, {wall:.3f} s wall (first call included), t = "
              f"{float(state.t):.9e}; dt from {float(min(dts)):.6e} to {float(max(dts)):.6e}; "
              f"launches {counts}; each recomputed dt within {worst[0]:.3e} of cfl x the "
              f"float64 CFL limit on the same grid ({worst[1]:.3e} on the float64 grid); the "
              f"chain stepped by hand: {len(dts)} steps, "
              f"{'bit-identical' if torch.equal(u, hand.u) else 'DIFFERENT'}")
        if state.n != len(dts) or not torch.equal(u, hand.u) or float(state.t) != float(hand.t):
            fail(f"[{tag}] the adaptive run differs from its chain stepped by hand")
        if not worst[0] <= ADAPTIVE_DT_TOL:
            fail(f"[{tag}] a dt is {worst[0]:.3e} from cfl x the float64 CFL limit")
        if got != want:
            fail(f"[{tag}] launches {got}, expected {want}")
        for n, v in counts.items():
            total[n] = total.get(n, 0) + v
    return total, state


def phase_adaptive(n=256, channel_box=None, cavity_n=ADAPTIVE_CAVITY_N, unsteady_n=UNSTEADY_N):
    """15: adaptive (CFL) stepping on the hat chain, the channel and the
    general path, and an unsteady force on the roll route; returns the
    kernels' launches of its runs."""
    import torch

    import ins_tpu_torch as it
    from ins_tpu_torch.ops import launches
    from ins_tpu_torch.ops.channelpath import make_channel_timestep_hat, strip_channel
    from ins_tpu_torch.ops.fastpath import (
        hat_chain_applicable,
        make_fast_timestep,
        make_fast_timestep_hat,
        strip_ghosts,
        strip_state,
    )
    from ins_tpu_torch.ops.fdm import fdm_null_modes

    f64 = torch.float64
    method = it.RKMethods.RK44()
    keys = form_keys()
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    # adaptive_hat256: the main path's chain from its random field
    setup, setup64 = headline_setup(n), headline_setup(n, dtype=f64)
    u0 = it.random_field(setup, kp=10, generator=torch.Generator(device=DEVICE).manual_seed(1))
    s0 = strip_state(it.create_stepper(method, setup=setup, u=u0))
    fns = make_fast_timestep_hat(setup, method)
    counts, _ = adaptive_case(
        f"adaptive_hat{n}", setup, setup64, fns, s0, u0, method, it.psolver_spectral(setup),
        strip_ghosts,
        lambda m, k: {"momentum_stage_divhat_3d": 1, "pcmsd_hat_3d": 4 * m - 1,
                      keys["passB_fold"]: 4 * m, "pressure_correct_qhat_3d": -(-m // k)})
    add(counts)
    adaptive_costs(f"adaptive_hat{n}", setup, fns, s0)
    del setup, setup64, u0, s0, fns
    torch.cuda.empty_cache()

    # adaptive_channel: phase 4's channel
    box = channel_box or CHANNEL_BOX
    setup, setup64 = channel_setup(box), channel_setup(box, dtype=f64)
    psolver = it.default_psolver(setup)
    u0 = channel_u0(setup, psolver)
    s0 = it.create_stepper(method, setup=setup, u=strip_channel(u0))
    fns = make_channel_timestep_hat(setup, method)
    counts, _ = adaptive_case(
        "adaptive_channel", setup, setup64, fns, s0, u0, method, psolver, strip_channel,
        lambda m, k: {"channel_msd_3d": 4 * m, "channel_pressure_correct_3d": -(-m // k) + 1})
    add(counts)
    adaptive_costs("adaptive_channel", setup, fns, s0)
    del setup, setup64, u0, s0, fns, psolver
    torch.cuda.empty_cache()

    # adaptive_cavity128: the general path with a time-periodic force, from
    # the flow 10 adaptive steps after rest (the lid's start, where dt
    # falls ten-fold, is no state to hold a dt over 10 steps from)
    setup = adaptive_cavity_setup(cavity_n, torch.float32)
    setup64 = adaptive_cavity_setup(cavity_n, f64)
    psolver = it.default_psolver(setup)

    def general_step(s, dt):
        return it.timestep(method, s, dt, setup=setup, psolver=psolver)

    fns = (_same, general_step, _same)
    rest = torch.zeros((3, *setup.grid.N), dtype=torch.float32, device=DEVICE)
    warm, _, _ = adaptive_by_hand(setup, setup64, fns,
                                  it.create_stepper(method, setup=setup, u=rest), 1e30, 1, 10)
    u0 = warm.u
    s0 = it.create_stepper(method, setup=setup, psolver=psolver, u=u0)
    del rest, warm
    _, state = adaptive_case(f"adaptive_cavity{cavity_n}", setup, setup64, fns, s0, u0, method,
                             psolver, _same, lambda m, k: {})
    ghost = dirichlet_ghost_error(setup, state.t, state.u)
    print(f"[adaptive_cavity{cavity_n}] Dirichlet ghosts {ghost:.3e} from their wall values; "
          f"max|u| {state.u.abs().max().item():.6f}")
    if ghost != 0.0:
        fail(f"[adaptive_cavity{cavity_n}] a Dirichlet ghost is {ghost:.3e} from its wall value")
    adaptive_costs(f"adaptive_cavity{cavity_n}", setup, fns, s0, steps=5)
    del setup, setup64, u0, s0, fns, psolver, state
    torch.cuda.empty_cache()

    # unsteady_periodic256: the roll route with a time-periodic force; its
    # 3-pass Poisson solve on the card against a float64 run of the plain
    # versions
    setup = headline_setup(unsteady_n, bodyforce=unsteady_force, steady=False)
    if hat_chain_applicable(setup, method) or make_fast_timestep_hat(setup, method) is not None:
        fail("the fused chains took an unsteady body force")
    u0 = it.random_field(setup, kp=10, generator=torch.Generator(device=DEVICE).manual_seed(2))
    dt = 1e-3 * 128 / unsteady_n
    tlims = (0.01, 0.01 + UNSTEADY_STEPS * dt)
    launches.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = it.solve_unsteady(setup=setup, ustart=u0, tlims=tlims, dt=dt, method=method,
                                 psolver=it.psolver_spectral(setup))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in run_counts().items() if v}
    plain = {k: v for k, v in launches.PLAIN_ON_CUDA.items() if v}
    want = {"poisson_pallas": 4 * UNSTEADY_STEPS, keys["passB_fold"]: 4 * UNSTEADY_STEPS}
    if plain or {k: v for k, v in counts.items() if k != keys["plane_transform"]} != want:
        fail(f"[unsteady_periodic{unsteady_n}] launches {counts} (plain {plain}), "
             f"expected {want} and the plane transforms")
    add(counts)
    u = strip_ghosts(state.u)
    if not bool(torch.isfinite(u).all()):
        fail(f"[unsteady_periodic{unsteady_n}] non-finite velocity")
    setup64 = headline_setup(unsteady_n, bodyforce=unsteady_force, dtype=f64, steady=False)
    step64 = make_fast_timestep(setup64, method, plain=True)
    s = strip_state(it.create_stepper(method, setup=setup64, u=u0.double(), t=tlims[0]))
    for _ in range(UNSTEADY_STEPS):
        s = step64(s, dt)
    err = rel_err(u, s.u)
    kept = headline_setup(unsteady_n)
    s_steady = strip_state(it.create_stepper(method, setup=kept, u=u0, t=tlims[0]))
    step_nf = make_fast_timestep(kept, method, _force_roll=True)
    for _ in range(UNSTEADY_STEPS):
        s_steady = step_nf(s_steady, dt)
    moved = rel_err(u, s_steady.u)
    step32 = make_fast_timestep(setup, method)
    s32 = strip_state(it.create_stepper(method, setup=setup, u=u0, t=tlims[0]))
    ms = cuda_ms(lambda: step32(s32, dt), reps=5, warmup=1)
    print(f"[unsteady_periodic{unsteady_n}] solve_unsteady, RK44 f32 roll route with the "
          f"time-periodic force, {UNSTEADY_STEPS} steps of {dt:.3e} from t = {tlims[0]}: "
          f"{wall:.3f} s wall (first call included); launches {counts}; against the float64 "
          f"run of the plain versions: max rel diff {err:.3e} (bound {REL_TOL:.0e}); against "
          f"the same run without the force: {moved:.3e}; {ms:.3f} ms/step")
    if not err <= REL_TOL:
        fail(f"[unsteady_periodic{unsteady_n}] {err:.3e} from the float64 run")
    if not moved > 10 * err:
        fail(f"[unsteady_periodic{unsteady_n}] the force did not move the run")
    del setup, setup64, kept, u0, u, state, s, s_steady, s32
    torch.cuda.empty_cache()

    # the fast diagonalization's null modes on the FDM grids this script
    # builds: the port's per-axis test and the JAX package's sum test
    for tag, st in (("channel", channel_setup(box)), (f"cavity{cavity_n}",
                                                      cavity_setup(cavity_n, torch.float32)),
                    (f"rb3d{RB_N}", rb3d_setup(RB_N)), ("ldc2d512", ldc2d_setup(512, f64))):
        per_axis, by_sum = fdm_null_modes(st)
        print(f"[adaptive] fdm null modes on {tag} {tuple(st.grid.Np)}: {per_axis} by the "
              f"per-axis test, {by_sum} by the JAX package's sum test")
    return totals

# --------------------------------------------------------------------------
# phase 16: the NeuralClosure pipeline
# --------------------------------------------------------------------------

CLOSURE_NDNS = 256
CLOSURE_NLES = (64, 128)
CLOSURE_DT = 5e-4  # phase 2's dt at 256³
CLOSURE_BURN = 20  # burn-in steps (cut this first if the script nears its limit)
CLOSURE_STEPS = 40
CLOSURE_SAVEFREQ = 5
CLOSURE_EPOCHS = 4  # a-priori epochs per conv dtype
CLOSURE_BATCH = 3
# the 2-D reference workflow's FNO and G-CNN, trained a-priori on its data
CLOSURE_FNO = dict(kmax=(16, 16, 16, 8), c=(32, 32, 32, 32))
CLOSURE_GCNN = dict(radii=(2, 2, 2), channels=(4, 4, 1))
CLOSURE_ITERS_2D = 200
CLOSURE_QUICK_2D = False  # the example at its full sizes
SYMMETRY_TOL = 1e-5
# the hat chain's c may differ from the plain chain's by at most this
# many times the plain chain's own spread under an ulp change of its
# initial field (the unit-cube flow amplifies rounding: see phase 16)
CLOSURE_FLOW_FACTOR = 10.0


def closure_pairs(data):
    """(label, pair) of `create_les_data`'s output (LES grids outer,
    filters inner)."""
    labels = [f"{n}^3 {f}" for n in CLOSURE_NLES for f in ("FaceAverage", "VolumeAverage")]
    return list(zip(labels, data))


def closure_les_setup(n, closure_model=None):
    import torch

    import ins_tpu_torch as it

    return it.Setup(x=(np.linspace(0.0, 1.0, n + 1),) * 3, Re=2e3, dtype=torch.float32,
                    device=DEVICE, closure_model=closure_model)


def closure_ic(dns, psolver, rng):
    """Phase 2's initial field: `random_field(kp=10)` from the card's
    generator seeded 1."""
    import torch

    import ins_tpu_torch as it

    return it.random_field(dns, kp=10, psolver=psolver,
                           generator=torch.Generator(device=DEVICE).manual_seed(1))


def closure_dns_data(add):
    """16a: `create_les_data` at 256³ (64³ and 128³ LES, both filters) on
    the hat chain; its first two snapshots of every pair against the
    same pipeline with the plain chain's DNS."""
    import torch

    import ins_tpu_torch as it
    from ins_tpu_torch import models as nc
    from ins_tpu_torch.ops import launches
    from ins_tpu_torch.ops.fastpath import hat_chain_applicable, reghost, strip_state

    method = it.RKMethods.RK44()
    filters = (nc.FaceAverage(), nc.VolumeAverage())
    ticks, saver_start = [], []

    def start(state):
        # the last run's first state: the saver's start
        saver_start[:] = [state["u"].clone()]
        tick(state)

    def tick(state):
        torch.cuda.synchronize()
        ticks.append((int(state["n"]), time.perf_counter()))

    clock = it.processor(lambda p, s: tick(s), initialize=start, nupdate=CLOSURE_SAVEFREQ)
    launches.reset_counts()
    t0 = time.perf_counter()
    data = nc.create_les_data(
        D=3, Re=2e3, lims=(0.0, 1.0), nles=list(CLOSURE_NLES), ndns=CLOSURE_NDNS,
        filters=filters, tburn=CLOSURE_BURN * CLOSURE_DT, tsim=CLOSURE_STEPS * CLOSURE_DT,
        savefreq=CLOSURE_SAVEFREQ, dt=CLOSURE_DT, icfunc=closure_ic, dtype=torch.float32,
        device=DEVICE, processors={"clock": clock},
    )
    wall = time.perf_counter() - t0
    counts = add()
    plain = {k: v for k, v in launches.PLAIN_ON_CUDA.items() if v}
    # burn-in ticks: n = 0, 5, ..., 20; the saver run's: 0, 5, ..., 40
    nb = CLOSURE_BURN // CLOSURE_SAVEFREQ + 1
    burn = sorted(b - a for (_, a), (_, b) in zip(ticks[:nb - 1], ticks[1:nb]))
    saver = sorted(b - a for (_, a), (_, b) in zip(ticks[nb:-1], ticks[nb + 1:]))
    ms_step = burn[len(burn) // 2] * 1e3 / CLOSURE_SAVEFREQ
    nsnap = CLOSURE_STEPS // CLOSURE_SAVEFREQ + 1
    print(f"[closure] create_les_data {CLOSURE_NDNS}^3 -> {list(CLOSURE_NLES)}^3, both filters, "
          f"RK44 f32 dt {CLOSURE_DT}, {CLOSURE_BURN} burn-in + {CLOSURE_STEPS} steps, a "
          f"snapshot every {CLOSURE_SAVEFREQ}: {wall:.3f} s wall; DNS {ms_step:.3f} ms/step "
          f"between snapshots (median of {len(burn)} burn-in chunks of {CLOSURE_SAVEFREQ}); a "
          f"saver chunk ({CLOSURE_SAVEFREQ} steps and a snapshot) "
          f"{saver[len(saver) // 2] * 1e3:.1f} ms (median of {len(saver)}); {card_line()}; "
          f"launches {counts}; plain calls on CUDA {plain}")
    dns = closure_les_setup(CLOSURE_NDNS)
    if not hat_chain_applicable(dns, method):
        fail("[closure] the 256³ DNS is not on the hat chain")
    missing = [k for k in hat_kernels() if counts.get(k, 0) <= 0]
    if missing or plain:
        fail(f"[closure] the DNS did not run on the hat kernels alone: missing {missing}, "
             f"plain {plain}")
    if len(data) != 4 or any(d["u"].shape[0] != nsnap for d in data):
        fail(f"[closure] expected 4 pairs of {nsnap} snapshots")
    for label, d in closure_pairs(data):
        if not (np.all(np.isfinite(d["u"])) and np.all(np.isfinite(d["c"]))
                and np.max(np.abs(d["c"])) > 0):
            fail(f"[closure] {label}: c is not finite and nonzero")

    # the same pipeline on the plain chain: (A) from the same field, the
    # burn-in and the saver's first two snapshots; (B) the same from the
    # field scaled by 1 + 2^-23 (a change of at most an ulp a value: what
    # the flow makes of rounding alone); (C) from the hat run's own state
    # at the saver's start, its second snapshot (5 steps apart)
    psolver = it.psolver_spectral(dns)
    les = [closure_les_setup(n) for n in CLOSURE_NLES]

    def plain_pipeline(u_start, burn):
        fs = nc.filtersaver(dns, les, filters, [CLOSURE_NDNS // n for n in CLOSURE_NLES],
                            psolver, [it.psolver_spectral(s) for s in les],
                            nupdate=CLOSURE_SAVEFREQ)
        s = strip_state(it.create_stepper(method, setup=dns, u=u_start))
        s = run_plain_chain(dns, method, s, CLOSURE_DT, burn, CLOSURE_SAVEFREQ)._replace(t=0.0, n=0)
        pst = fs.initialize(dict(u=reghost(s.u), t=s.t, n=s.n))
        s = run_plain_chain(dns, method, s, CLOSURE_DT, CLOSURE_SAVEFREQ, CLOSURE_SAVEFREQ)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pst = fs.update(pst, dict(u=reghost(s.u), t=s.t, n=CLOSURE_SAVEFREQ))
        return fs.finalize(pst, None), (time.perf_counter() - t0) * 1e3

    u0 = closure_ic(dns, psolver, None)
    umax = u0.abs().max().item()
    print(f"[closure] initial max|u| {umax:.4f}: CFL max|u|·dt/dx {umax * CLOSURE_DT * CLOSURE_NDNS:.3f}")
    ref, snap_ms = plain_pipeline(u0, CLOSURE_BURN)
    print(f"[closure] one snapshot (the DNS force, 4 pairs filtered, their commutator errors, "
          f"to the host as numpy): {snap_ms:.1f} ms")
    ulp, _ = plain_pipeline(u0 * (1 + 2.0**-23), CLOSURE_BURN)
    same, _ = plain_pipeline(saver_start[0], 0)

    def gap(a, b, k, i):
        return rel_l2(torch.from_numpy(a[k][i]), torch.from_numpy(b[k][i]))

    worst_u = worst_c5 = 0.0
    ratio = []
    for (label, d), r, p, q in zip(closure_pairs(data), ref, ulp, same):
        for k in "uc":
            ours = [gap(d, r, k, i) for i in (0, 1)]
            flow = [gap(p, r, k, i) for i in (0, 1)]
            five = gap(d, q, k, 1)
            print(f"[closure] {label} {k}: hat vs plain chain, snapshots 0 and 1 (after "
                  f"{CLOSURE_BURN} and {CLOSURE_BURN + CLOSURE_SAVEFREQ} steps): rel L2 "
                  f"{ours[0]:.3e}, {ours[1]:.3e}; the plain chain against itself from the "
                  f"ulp-scaled field {flow[0]:.3e}, {flow[1]:.3e}; from the same state, "
                  f"{CLOSURE_SAVEFREQ} steps: {five:.3e}")
            if k == "u":
                worst_u = max(worst_u, *ours)
            else:
                worst_c5 = max(worst_c5, five)
                ratio.append(max(ours) / max(max(flow), 1e-30))
    print(f"[closure] bounds: u {worst_u:.3e} <= {REL_TOL}; c from the same state "
          f"{worst_c5:.3e} <= {REL_TOL}; c against the flow's own ulp spread: at most "
          f"{max(ratio):.2f}x (bound {CLOSURE_FLOW_FACTOR})")
    if not worst_u <= REL_TOL:
        fail(f"[closure] the filtered DNS velocities differ from the plain chain's by {worst_u:.3e}")
    if not worst_c5 <= REL_TOL:
        fail(f"[closure] c differs from the plain chain's from the same state by {worst_c5:.3e}")
    if not max(ratio) <= CLOSURE_FLOW_FACTOR:
        fail(f"[closure] c differs from the plain chain's by {max(ratio):.2f}x the flow's own "
             f"spread under an ulp")
    del ref, ulp, same, saver_start
    torch.cuda.empty_cache()
    return data


def closure_cnn(setup, compute_dtype=None, plain=False):
    """`BASELINE.json` configs[4]'s CNN (`bench.py`'s grad-step case), its
    weights drawn from a fixed seed: ``(closure, theta)``."""
    import torch

    from ins_tpu_torch import models as nc

    return nc.cnn(setup=setup, radii=[2, 2, 2], channels=[24, 24, 3],
                  activations=[torch.tanh, torch.tanh, lambda v: v], use_bias=[True, True, False],
                  generator=torch.Generator().manual_seed(0), compute_dtype=compute_dtype,
                  plain=plain)


def closure_prior(data, add):
    """16b: the 3-D CNN trained a-priori on the 128³ FaceAverage pairs by
    `trainepoch`, with bf16 and float32 convs; one batch against the
    plain layers.  Returns the bf16-trained theta."""
    import torch

    from ins_tpu_torch import models as nc
    from ins_tpu_torch.ops import launches

    les = closure_les_setup(CLOSURE_NLES[-1])
    io = nc.create_io_arrays([data[2]], les)
    x, y = (torch.as_tensor(io[k], device=DEVICE) for k in ("u", "c"))
    batch = (x[:CLOSURE_BATCH], y[:CLOSURE_BATCH])
    print(f"[closure] a-priori: CNN (2,2,2)/(24,24,3) on the 128^3 FaceAverage pairs "
          f"{tuple(x.shape)}, trainepoch batch {CLOSURE_BATCH}, Adam lr 1e-3")
    trained = None
    for tag, cdt, loss_tol, grad_tol in (("bf16", None, GRAD_TOL_BF16, GRAD_TOL_BF16),
                                         ("f32", torch.float32, LOSS_TOL_F32, GRAD_TOL_F32)):
        closure, theta = closure_cnn(les, cdt)
        plain, theta_p = closure_cnn(les, cdt, plain=True)
        lk = nc.create_loss_prior(closure)(batch, theta)
        gk = torch.autograd.grad(lk, list(theta.values()))
        lp = nc.create_loss_prior(plain)(batch, theta_p)
        gp = torch.autograd.grad(lp, list(theta_p.values()))
        lrel = abs(lk.item() - lp.item()) / abs(lp.item())
        grel = {k: rel_l2(a, b) for k, a, b in zip(theta, gk, gp)}
        print(f"[closure] a-priori {tag} convs, one batch, kernels vs plain: loss "
              f"{lk.item():.9e} vs {lp.item():.9e} (rel {lrel:.3e}, bound {loss_tol}); grad rel L2 "
              + ", ".join(f"{k} {v:.3e}" for k, v in grel.items()) + f" (bound {grad_tol})")
        if not (math.isfinite(lk.item()) and lrel <= loss_tol):
            fail(f"[closure] a-priori {tag} loss: kernels vs plain {lrel:.3e}")
        if not all(math.isfinite(v) and v <= grad_tol for v in grel.values()):
            fail(f"[closure] a-priori {tag} gradient: kernels vs plain {grel}")
        del plain, theta_p, gp, gk
        relerr = nc.create_relerr_prior(closure, x, y)
        errs = [relerr(theta).item()]
        state = nc.create_trainstate(theta, lr=1e-3, rng=np.random.default_rng(SEED))
        secs = []
        launches.reset_counts()
        for _ in range(CLOSURE_EPOCHS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = nc.trainepoch(data=(io["u"], io["c"]), batchsize=CLOSURE_BATCH,
                                  loss=nc.create_loss_prior(closure), trainstate=state)["trainstate"]
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            errs.append(relerr(theta).item())
        counts = add()
        plain_calls = {k: v for k, v in launches.PLAIN_ON_CUDA.items() if v}
        print(f"[closure] a-priori {tag} convs: {CLOSURE_EPOCHS} epochs of "
              f"{x.shape[0] // CLOSURE_BATCH} batches, s/epoch "
              + ", ".join(f"{v:.3f}" for v in secs) + "; relerr_prior "
              + " -> ".join(f"{e:.5f}" for e in errs) + f"; launches {counts}; {card_line()}")
        keys = ("fusedconv_3d", "fusedconv_wgrad_3d")
        keys = tuple(k + "+f32" for k in keys) if cdt is not None else keys
        if any(counts.get(k, 0) <= 0 for k in keys) or plain_calls:
            fail(f"[closure] a-priori {tag}: the conv kernels did not run alone ({counts}, "
                 f"plain {plain_calls})")
        if not (all(math.isfinite(e) for e in errs) and errs[-1] < errs[0]):
            fail(f"[closure] a-priori {tag}: relerr_prior did not fall: {errs}")
        if trained is None:
            trained = theta
    del x, y
    torch.cuda.empty_cache()
    return trained


def closure_post(data, theta, add):
    """16c: an a-posteriori fine-tune of the a-priori CNN on the 128³
    FaceAverage trajectory (nunroll 3, 5 substeps, remat) through the
    per-op chain; the first batch's loss and gradient against the plain
    run."""
    import torch

    import ins_tpu_torch as it
    from ins_tpu_torch import models as nc
    from ins_tpu_torch.ops import launches

    les = closure_les_setup(CLOSURE_NLES[-1])
    traj = [dict(u=data[2]["u"], t=data[2]["t"])]
    dl = nc.create_dataloader_post(traj, ntrajectory=1, nunroll=3)
    batch, _ = dl(np.random.default_rng(SEED))
    runs = {}
    for plain in (False, True):
        closure, th = closure_cnn(les, plain=plain)
        with torch.no_grad():
            for k in th:
                th[k].copy_(theta[k])
        loss = nc.create_loss_post(setup=les, method=it.RKMethods.RK44(),
                                   psolver=it.psolver_spectral(les),
                                   closure_model=nc.wrappedclosure(closure, les), nsubstep=5,
                                   remat=True, plain=plain)
        launches.reset_counts()
        t0 = time.perf_counter()
        runs[plain] = (loss, th) + value_and_grad(loss, batch, th)
        wall = time.perf_counter() - t0
        if not plain:
            counts = add()
            plain_calls = {k: v for k, v in launches.PLAIN_ON_CUDA.items() if v}
        print(f"[closure] a-posteriori, {'plain' if plain else 'kernels'}: loss "
              f"{runs[plain][2].item():.9e} ({wall:.3f} s)")
    (loss, th, lk, gk), (_, _, lp, gp) = runs[False], runs[True]
    lrel = abs(lk.item() - lp.item()) / abs(lp.item())
    grel = {k: rel_l2(gk[k], gp[k]) for k in gk}
    print(f"[closure] a-posteriori (bf16 convs) kernels vs plain: loss rel {lrel:.3e}; grad rel "
          "L2 " + ", ".join(f"{k} {v:.3e}" for k, v in grel.items())
          + f" (bound {GRAD_TOL_BF16}); launches {counts}")
    if not (math.isfinite(lk.item()) and lrel <= GRAD_TOL_BF16):
        fail(f"[closure] a-posteriori loss: kernels vs plain {lrel:.3e}")
    if not all(math.isfinite(v) and v <= GRAD_TOL_BF16 for v in grel.values()):
        fail(f"[closure] a-posteriori gradient: kernels vs plain {grel}")
    if any(counts.get(k, 0) <= 0 for k in TRAINING_KERNELS) or plain_calls:
        fail(f"[closure] a-posteriori: the per-op and conv kernels did not run alone ({counts}, "
             f"plain {plain_calls})")
    del runs
    state = nc.create_trainstate(th, lr=1e-5, rng=np.random.default_rng(SEED + 1))
    secs = []
    launches.reset_counts()
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = nc.train(dataloader=dl, loss=loss, trainstate=state, niter=1)["trainstate"]
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    counts = add()
    print(f"[closure] a-posteriori: 2 gradient steps (15 RK44 steps each, remat): s/step "
          + ", ".join(f"{v:.3f}" for v in secs) + f"; loss {state['loss'].item():.9e}; "
          f"launches {counts}; {card_line()}")
    if not math.isfinite(state["loss"].item()):
        fail("[closure] a-posteriori: non-finite loss")
    torch.cuda.empty_cache()


def closure_2d():
    """16d: the ported 2-D example at its full sizes, then an FNO and a
    G-CNN trained a-priori on its data; the symmetry errors."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    import ins_tpu_torch as it
    from ins_tpu_torch import models as nc
    from ins_tpu_torch.examples import neural_closure_training as ex

    t0 = time.perf_counter()
    out = ex.run(quick=CLOSURE_QUICK_2D, device=DEVICE)
    secs = {k: round(v, 3) for k, v in out["seconds"].items()}
    print(f"[closure] 2-D example (256^2 DNS -> 64^2, 500 a-priori and 100 a-posteriori "
          f"iterations): {time.perf_counter() - t0:.3f} s; seconds per stage {secs}; "
          f"relerr {out['relerr_init']:.5f} -> {out['relerr_prior']:.5f}; loss_post "
          f"{out['loss_post']:.6e}; {card_line()}")
    if not (all(math.isfinite(out[k]) for k in ("relerr_init", "relerr_prior", "loss_post"))
            and out["relerr_prior"] < out["relerr_init"]):
        fail("[closure] the 2-D example did not train")
    io = out["io"]
    les = ex.les_setup(io["u"].shape[1], DEVICE)
    x, y = (torch.as_tensor(io[k], device=DEVICE) for k in ("u", "c"))
    dl = nc.create_dataloader_prior((io["u"], io["c"]), batchsize=8, device=DEVICE)

    def gelu(v):
        return F.gelu(v, approximate="tanh")

    models = {
        "fno": nc.fno(setup=les, sigma=(gelu,) * 4, psi=gelu,
                      generator=torch.Generator().manual_seed(0), **CLOSURE_FNO),
        "gcnn": nc.gcnn(setup=les, activations=(torch.tanh, torch.tanh, lambda v: v),
                        use_bias=(True, True, False), generator=torch.Generator().manual_seed(0),
                        **CLOSURE_GCNN),
        "cnn": (out["closure"], out["theta"]),
    }
    u = out["data"][0]["u"]
    sym = {}
    for name, (closure, theta) in models.items():
        if name != "cnn":
            relerr = nc.create_relerr_prior(closure, x, y)
            e0 = relerr(theta).item()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = nc.train(dataloader=dl, loss=nc.create_loss_prior(closure),
                          trainstate=nc.create_trainstate(theta, lr=1e-3,
                                                          rng=np.random.default_rng(SEED)),
                          niter=CLOSURE_ITERS_2D)
            e1 = relerr(theta).item()
            print(f"[closure] 2-D {name} a-priori: {CLOSURE_ITERS_2D} iterations in "
                  f"{time.perf_counter() - t0:.3f} s; relerr {e0:.5f} -> {e1:.5f}")
            if not (math.isfinite(e1) and e1 < e0 and math.isfinite(st["trainstate"]["loss"].item())):
                fail(f"[closure] 2-D {name}: relerr_prior did not fall")
        setup_c = dataclasses.replace(les, closure_model=nc.wrappedclosure(closure, les))
        prior = nc.create_relerr_symmetry_prior(u=u[:4], setup=setup_c)(theta).item()
        post = nc.create_relerr_symmetry_post(u=u[0], setup=setup_c,
                                              psolver=it.psolver_spectral(les), dt=1e-3,
                                              nstep=4)(theta).item()
        sym[name] = (prior, post)
        print(f"[closure] 2-D {name}: symmetry error prior {prior:.3e}, post {post:.3e}")
    if not all(v <= SYMMETRY_TOL for v in sym["gcnn"]):
        fail(f"[closure] the G-CNN's symmetry errors {sym['gcnn']} exceed {SYMMETRY_TOL}")
    if not all(v > SYMMETRY_TOL for v in sym["cnn"]):
        fail(f"[closure] the CNN's symmetry errors {sym['cnn']} are not above {SYMMETRY_TOL}")


def phase_closure():
    """16: the NeuralClosure pipeline through the port's entry points;
    returns the kernels' launches of its kernel runs."""
    from ins_tpu_torch.ops import launches

    totals = {}

    def add():
        """Add the launches since the last reset to the totals; return
        the nonzero ones."""
        counts = {k: v for k, v in run_counts().items() if v}
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        return counts

    clock = time.perf_counter()
    data = closure_dns_data(add)
    print(f"[time] 16a (filtered DNS): {time.perf_counter() - clock:.1f} s")
    clock = time.perf_counter()
    theta = closure_prior(data, add)
    print(f"[time] 16b (a-priori 3-D): {time.perf_counter() - clock:.1f} s")
    clock = time.perf_counter()
    closure_post(data, theta, add)
    print(f"[time] 16c (a-posteriori 3-D): {time.perf_counter() - clock:.1f} s")
    del data, theta
    clock = time.perf_counter()
    closure_2d()
    print(f"[time] 16d (the 2-D workflow): {time.perf_counter() - clock:.1f} s")
    return totals


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stack-turns", metavar="PARENT",
                    help="only time the 128³ tap stack (pack and tap forms, bf16 and "
                         "float32 convs) of the "
                         "package in the tree PARENT and of this tree's, in turns")
    ap.add_argument("--stack-time", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--chain-turns", metavar="PARENT",
                    help="only time the 256³ RK44 hat, LES and Boussinesq chains "
                         "(ms/step) of the package in the tree PARENT and of this tree's, "
                         "in turns")
    ap.add_argument("--chain-time", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--train-turns", metavar="PARENT",
                    help="only time phase 3's 128³ gradient step with float32 convs "
                         "(s/step, conv share) of the package in the tree PARENT and of "
                         "this tree's, in turns")
    ap.add_argument("--train-time", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--conv-turns", metavar="PARENT",
                    help="only time the fused conv layer's float32 kernels (each closure "
                         "layer's forward, input gradient and weight gradient at 128³) of "
                         "the package in the tree PARENT and of this tree's, in turns")
    ap.add_argument("--conv-time", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--fold-turns", metavar="PARENT",
                    help="only time the folded pass B's cases (and their error against "
                         "float64) of the package in the tree PARENT and of this tree's, "
                         "in turns")
    ap.add_argument("--fold-time", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--fold-max-n", type=int, metavar="N",
                    help="with --fold-turns: only the cases of size n <= N (no level "
                         "route, no gate)")
    ap.add_argument("--rounds", type=int, default=1, metavar="R",
                    help="with --fold-turns: R rounds of the four turns")
    ap.add_argument("--channel-turns", metavar="PARENT",
                    help="only the channel: the stage kernel in every mode against its "
                         "plain version, its ms and the 256×128×128 chain's ms/step and "
                         "device split, of the package in the tree PARENT and of this "
                         "tree's, in turns")
    ap.add_argument("--channel-time", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--perop-turns", metavar="PARENT",
                    help="only the conv-diff kernel, the float32 tap weight gradient and "
                         "phase 3's bf16 gradient step (errors, ms, s/step) of the package "
                         "in the tree PARENT and of this tree's, in turns; then ptxas's "
                         "report and the HMMA count of the new kernels")
    ap.add_argument("--pack-turns", metavar="PARENT",
                    help="only the float32 pack forward at 128³ (the closure's three layers) "
                         "and the dense pass B's cases (errors against float64, ms) of the "
                         "package in the tree PARENT and of this tree's, in turns; then "
                         "ptxas's report and the HMMA count of tapconv_tf32.cu and fold.cu")
    ap.add_argument("--pack-time", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--variant", action="append", default=[],
                    metavar="LABEL|FILE|REGEX|REPL",
                    help="with --perop-turns or --pack-turns: also this tree with REGEX "
                         "replaced by REPL in FILE (more FILE|REGEX|REPL triples may follow), "
                         "in turns")
    ap.add_argument("--perop-time", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--perop-no-step", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--ghosted", action="store_true",
                    help="only phase 13 (the general ghosted path: the 128³ cavity with "
                         "FDM-CG and with psolver_fdm, Rayleigh-Benard 3-D), no kernel build; "
                         "with --profile each case's device-time split")
    ap.add_argument("--general2", action="store_true",
                    help="only phase 14 (the rest of the general path: AB-CN, one-leg and "
                         "implicit RK on the 128³ cavity, psolver_cg_matrix, psolver_direct on "
                         "the 512² 2-D cavity, the observers); builds the kernels for the "
                         "channel's wall shear")
    ap.add_argument("--adaptive", action="store_true",
                    help="only phase 15 (adaptive CFL stepping on the 256³ hat chain, the "
                         "channel and the 128³ cavity's general path, an unsteady force on "
                         "the 256³ roll route), after the kernel build")
    ap.add_argument("--closure", action="store_true",
                    help="only phase 16 (the NeuralClosure pipeline: filtered DNS at 256³, "
                         "a-priori and a-posteriori training of the 3-D CNN, the 2-D "
                         "example with an FNO and a G-CNN), after the kernel build")
    ap.add_argument("--precision", action="store_true",
                    help="only the default precision's checks: the bf16x3 forms of the plane "
                         "GEMM and the fused pass B against their plain versions and float64, "
                         "both classes side by side, the gates in each precision, and phase "
                         "17 (the 512³ RK44 and LMWray3 cells in both precisions), after the "
                         "kernel build")
    ap.add_argument("--profile", action="store_true",
                    help="print torch.profiler kernel breakdowns of 3 hat steps, "
                         "of one gradient step with bf16 and with float32 convs, "
                         "of 3 channel steps, of 3 LES, "
                         "Boussinesq, LMWray3, halo and halo LES steps, of the "
                         "halo kernels at the 4-shard shapes, and of 3 SSP33 "
                         "unmerged steps and 3 bf16-stream steps; and split each "
                         "stage wrapper into its plane-transform GEMMs and the rest")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this check runs on the GPU only")
    if args.stack_turns:
        stack_turns(args.stack_turns)
        return
    if args.chain_turns:
        chain_turns(args.chain_turns)
        return
    if args.train_turns:
        train_turns(args.train_turns)
        return
    if args.conv_turns:
        conv_turns(args.conv_turns)
        return
    if args.fold_turns:
        fold_turns(args.fold_turns, args.rounds, args.fold_max_n)
        return
    if args.channel_turns:
        channel_turns(args.channel_turns)
        return
    if args.perop_turns:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        perop_turns(args.perop_turns, args.variant)
        return
    if args.pack_turns:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        pack_turns(args.pack_turns, args.variant)
        return
    root = (args.stack_time or args.chain_time or args.train_time or args.conv_time
            or args.fold_time or args.channel_time or args.perop_time or args.pack_time)
    sys.path.insert(0, os.path.abspath(root) if root
                    else os.path.dirname(os.path.abspath(__file__)))
    import ins_tpu_torch  # noqa: F401  (fails outside the repository)
    from ins_tpu_torch import _build

    if args.chain_time:  # one turn of --chain-turns
        torch.backends.cuda.matmul.allow_tf32 = False
        times = chain_time()
        print(json.dumps({"ms_per_step": times, "root": os.path.abspath(args.chain_time)}))
        return
    if (args.train_time or args.conv_time or args.fold_time or args.channel_time
            or args.perop_time or args.pack_time):
        # one turn of --*-turns
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        times = (train_time() if args.train_time else conv_time() if args.conv_time
                 else fold_time(args.fold_max_n) if args.fold_time
                 else perop_time(not args.perop_no_step) if args.perop_time
                 else pack_time() if args.pack_time
                 else channel_time())
        print(json.dumps({**times, "root": os.path.abspath(root)}))
        return
    if args.stack_time:  # one turn of --stack-turns
        torch.backends.cudnn.allow_tf32 = False
        times = tap_stack_times(*tap_stack_inputs(128), ("pack", "tap", "pack f32", "tap f32",
                                                          "tap f32", "pack f32", "tap", "pack"))
        print_stack_times(f"{os.path.abspath(args.stack_time)} ", times)
        print(json.dumps({k: [sum(v["fwd"]) / len(v["fwd"]), sum(v["fwd+bwd"]) / len(v["fwd+bwd"]),
                              v["peak"]] for k, v in times.items()}))
        return

    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.ghosted:
        phase_ghosted(args.profile)
        return
    t0 = time.perf_counter()
    _build.load()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'} s); "
          f"ptxas report in {_build.BUILD_DIR / 'build.log'}")
    if args.general2:
        t0 = time.perf_counter()
        phase_general2()
        print(f"[time] phase 14 (the rest of the general path): {time.perf_counter() - t0:.1f} s")
        return
    if args.adaptive:
        t0 = time.perf_counter()
        launched = phase_adaptive()
        print(f"[adaptive] launches of the phase's runs: {launched}")
        print(f"[time] phase 15 (adaptive dt, unsteady forces): {time.perf_counter() - t0:.1f} s")
        return
    if args.precision:
        t0 = time.perf_counter()
        phase_precision_kernels()
        print(f"[time] phase 1, the default precision's kernels and gates: "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        _, highest = phase_precision()
        print(f"[precision] launches of the \"highest\" runs: {highest}")
        print(f"[time] phase 17 (the 512³ cells in both precisions): "
              f"{time.perf_counter() - t0:.1f} s")
        return
    if args.closure:
        t0 = time.perf_counter()
        launched = phase_closure()
        print(f"[closure] launches of the phase's runs: {launched}")
        print(f"[time] phase 16 (the NeuralClosure pipeline): {time.perf_counter() - t0:.1f} s")
        return
    ptxas_report()

    clock = {"t": time.perf_counter()}

    def phase_done(name):
        now = time.perf_counter()
        print(f"[time] {name}: {now - clock['t']:.1f} s")
        clock["t"] = now

    results = phase_kernels(kernel_cases, (RAGGED_N, 64, 256),
                            time_all=("passB", "passB_fold", "pcmsd_hat_3d+smag",
                                      "pcmsd_hat_3d+temp", "plane_transform"))
    results.update(phase_kernels(fold_big_cases, (FOLD_BIG_CUBES[0][0],),
                                 time_all=("passB_fold+levels",)))
    check_fold_f64(FOLD_BIG_CUBES)
    results.update(phase_precision_kernels())
    if args.profile:
        profile_cases(kernel_cases(256), names=STAGE_WRAPPERS)
    phase_done("phase 1 (hat kernels)")
    hat_counts, setup, u0, dt, e_hat = phase_main_path(256, nsteps=20, chunk=10)
    if args.profile:
        phase_profile(setup, u0, dt)
    u0_hat = u0
    del setup
    torch.cuda.empty_cache()
    phase_done("phase 2 (main path)")
    results.update(phase_kernels(training_kernel_cases, (64, 128),
                                 time_all=CONV_KEYS + ("convdiff_interior_3d",)))
    for n in (64, 128):
        check_wgrad_repeatable(n)
    train_counts = phase_training(128, nunroll=5)
    if args.profile:
        phase_profile_training(128, nunroll=5)
    torch.cuda.empty_cache()
    phase_done("phase 3 (training)")
    results.update(phase_kernels(channel_kernel_cases, CHANNEL_RAGGED_BOXES + (CHANNEL_BOX,),
                                 time_all=CHANNEL_KERNELS))
    channel_counts, setup, u0, dt = phase_channel(nsteps=20, chunk=10)
    if args.profile:
        phase_profile_channel(setup, u0, dt)
    del setup, u0
    torch.cuda.empty_cache()
    phase_done("phase 4 (channel)")
    results.update(phase_kernels(les_kernel_cases, ((40, 26, 20), LES_BOX),
                                 time_all=("smagorinsky_force_3d",)))
    les_counts, setup, u0, dt = phase_les(LES_BOX[0], 20, 10, u0_hat, e_hat)
    if args.profile:
        phase_profile_split("LES step", setup, ins_tpu_torch.RKMethods.RK44(), u0, dt,
                            theta=torch.full((), LES_THETA, device=DEVICE))
    les_counts["pcmsd_hat_3d+smag"] = les_counts["pcmsd_hat_3d"]
    del setup, u0
    torch.cuda.empty_cache()
    phase_done("phase 5 (LES)")
    bous_counts, setup, u0, T0, dt = phase_boussinesq(256, 20, 10)
    if args.profile:
        phase_profile_split("Boussinesq step", setup, ins_tpu_torch.RKMethods.RK44(), u0, dt,
                            temp0=T0)
    bous_counts["pcmsd_hat_3d+temp"] = bous_counts["pcmsd_hat_3d"]
    bous_counts["momentum_stage_divhat_3d+temp"] = bous_counts["momentum_stage_divhat_3d"]
    del setup, u0, T0
    torch.cuda.empty_cache()
    phase_done("phase 6 (Boussinesq)")
    _, setup, dt = phase_lmwray3(256, 20, 10, u0_hat)
    if args.profile:
        phase_profile_split("LMWray3 step", setup, ins_tpu_torch.LMWray3(), u0_hat, dt)
    del setup
    phase_done("phase 7 (LMWray3)")
    results.update(phase_kernels(halo_kernel_cases, (HALO_RAGGED_N, 64, 256),
                                 time_all=("pcmsd_hat_halo_3d", "passB_sharded")
                                 + HALO_LES_KERNELS))
    results.update(phase_kernels(fold_big_shard_cases, (FOLD_BIG_SHARDS[0][0],),
                                 time_all=("passB_sharded+levels",)))
    check_fold_f64(FOLD_BIG_SHARDS)
    if args.profile:
        profile_cases(halo_kernel_cases(256))
    for n in (64, 256):
        halo_vs_single_device(n)
    halo_counts, e_halo = phase_halo(256, 20, 10, u0_hat, profile=args.profile)
    phase_done("phase 8 (halo)")
    halo_les_counts = phase_halo_les(256, 20, 10, u0_hat, e_halo, profile=args.profile)
    phase_done("phase 9 (halo LES)")
    torch.cuda.empty_cache()
    results.update(phase_kernels(unmerged_kernel_cases, (RAGGED_N, 64, 256), time_all=UNMERGED_KERNELS))
    if args.profile:
        profile_cases(unmerged_kernel_cases(256), names=UNMERGED_KERNELS)
    torch.cuda.empty_cache()
    unmerged_counts = phase_unmerged(256, 20, 10, u0_hat, profile=args.profile)
    phase_done("phase 10 (unmerged chain and bf16 streams)")
    results.update(phase_kernels(tap_kernel_cases, (36, 128),
                                 time_all=("tapconv_3d", "packconv_3d", "tapconv_3d+f32",
                                           "packconv_3d+f32", "tapconv_wgrad_3d",
                                           "tapconv_wgrad_3d+f32")))
    for n in (36, 128):
        check_tap_wgrad_repeatable(n)
    results.update(phase_kernels(stage_div_kernel_cases, (RAGGED_N, 64, 256)))
    torch.cuda.empty_cache()
    tap_counts = phase_tapconv(128)
    tap_counts["momentum_stage_div_3d"] = phase_unfused_step(256)
    phase_done("phase 11 (tap conv layer and unfused stage)")
    dense_counts = phase_dense_chain()
    torch.cuda.empty_cache()
    phase_done("phase 12 (the dense pass B's chain)")
    phase_ghosted(args.profile)
    phase_done("phase 13 (the general ghosted path)")
    phase_general2()
    phase_done("phase 14 (the rest of the general path)")
    adaptive_counts = phase_adaptive()
    phase_done("phase 15 (adaptive dt, unsteady forces)")
    closure_counts = phase_closure()
    phase_done("phase 16 (the NeuralClosure pipeline)")
    _, highest_counts = phase_precision()
    phase_done("phase 17 (the 512³ cells in both precisions)")

    def with_later(k, v):
        """v plus the launches of phases 15 and 16."""
        return v + adaptive_counts.get(k, 0) + closure_counts.get(k, 0)

    bf, tf = form_keys("manualhigh"), form_keys("highest")
    counts = {**{k: with_later(k, hat_counts[k]) for k in hat_kernels() + ("passB_fold+levels",)},
              bf["passB"]: dense_counts[bf["passB"]],
              **{k: with_later(k, train_counts[k]) for k in TRAINING_KERNELS + F32_CONV_KERNELS},
              "make_poisson_pallas": with_later("poisson_pallas", train_counts["poisson_pallas"]),
              **{k: with_later(k, channel_counts[k]) for k in CHANNEL_KERNELS},
              **{k: les_counts[k] for k in LES_KERNELS},
              **{k: bous_counts[k] for k in TEMP_KERNELS},
              **{k: halo_counts[k] for k in HALO_KERNELS + (bf["passB_sharded"],
                                                            "passB_sharded+levels")},
              **{k: halo_les_counts[k] for k in HALO_LES_KERNELS},
              **{k: unmerged_counts[k] for k in UNMERGED_KERNELS},
              **{k: tap_counts[k] for k in TAP_KERNELS},
              # the 3xTF32 forms of the plane GEMM and the fused pass B: the
              # "highest" runs of phase 17
              **{k: highest_counts.get(k, 0) for k in tf.values()}}

    table = {"kernels": []}
    for name, (source, replaces) in KERNEL_META.items():
        r = results[name]
        table["kernels"].append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(card)
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
