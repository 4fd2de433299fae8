#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``xnode_wan_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (the kernels are built for Hopper, ``sm_90a``) and
``nvcc``; imports nothing of JAX or of the JAX package. Phases, each of
which raises on failure:

1. build every CUDA kernel from ``xnode_wan_tpu_torch/csrc`` (one ``nvcc``
   per library, all in parallel; #1/#2's ``xnode_fwd.cu`` once per (H, Hh)
   pair of the shipped configs, and for 2s's (64/64) and 2u's (48/48)
   nets in a thread beside phases 2a-2r, the register #6's
   ``disc_fwd.cu`` once per shipped adversary width H,
   ``xnode_grad.cu``, ``xnode_path_tile.cu`` (#1/#2's path-tile kernel)
   and ``disc_train.cu`` (#7 and the tile #6, every width at run time)
   once) and print the build time and ptxas usage; #1/#2 (both kernels),
   #6 and #7 must show no stack and no spills at the shipped widths; hold
   ``steppers.staged_floats`` against the staged copy #1/#2 ask for,
   ``disc_train.staged_floats`` against the register #6's (the
   d=5 and the d=20 adversary, each tied and untied) and
   ``disc_train.tile_smem_bytes`` against the bytes #7's shared and global
   variants ask for at every tile and the tile #6 at each of its tiles
   (at its weight slice), and
   ``disc_train.cluster_smem_bytes`` against #7's cluster variant's at
   clusters of 2, 4 and 8 blocks and every tile (the tied nets) (those
   adversaries, 2v's, 2w's and phase 3's; the route, shared bytes and
   registers printed), and the
   wrapper's shared-memory rule for #3-#5 against the bytes their
   launchers ask for, and ``xnode_train.path_tile_smem_bytes`` and
   ``path_tile_staged_floats`` against the path-tile launchers' at every
   method, tile and slice (at those nets, 2x's, 96/64, 72/80 and
   256/256);
2. the main paths at the d=5 width of ``configs/cube_pde.yaml``, then
   on the moving domains and at d = 20, each with every kernel launch
   counter zeroed just before and read just after (every solver writes
   into a temporary directory). Phases h, i and m's solver runs share a
   process of their own, and r's ranks and ``nccl`` world theirs: all
   start before h and run beside j-q (the host paces every training loop
   here while the card idles; each process counts its own launches), and
   their output is printed after r:

   a. serving and scoring the reference trainer's checkpoint: 65,536
      points through ``evaluate_points`` and 4,000 fresh interior paths
      through ``u_forward_fused``; each kernel must have launched, and the
      rel-L2 error must stay under 0.0125 for the served points, the
      kernel path forward and the plain scan;
   b. training: ``NODEWANSolver.train_until(0.01, iterations)`` from
      ``seed`` 0 on ``Ex4_1_funcs``, full width and depth; it must reach
      rel-L2 < 1%, with kernels #2 and #3 launched once per outer
      iteration, #4 and #5 ``n1`` times, #6 and #7 never;
   c. the command line (``xnode_wan_tpu_torch.main``) on the same config
      with ``fused_v: true``, which trains in chunks of ``train_chunk``
      ending at each report step: it must print ``Stopping Criterion
      Reached`` within the config's iterations, launch #6 twice, #7
      once, #4 and #5 ``n1`` times and #2 and #3 once per iteration run
      (the chunks run whole, then the replay to the stop:
      ``chunked_run``), #1 once a report step (the plot), and write one
      metrics record per iteration kept, the three JSON lists, the
      checkpoint of the stop iteration and the best weights (the same
      counts hold for the command lines of e, j and l);
      ``--resume --iterations 3`` must
      continue the step count and the loss; the resumed primal is served
      through ``evaluate_points`` (kernel #1) under the rel-L2 limit of
      2a, and the best weights load with ``load_reference_state_dict``;
      #6 launches only its register kernel and #7 only its shared
      accumulator;
   d. the shrinking cone, ``configs/cone_pde.yaml`` (d = 3, the same
      widths, ``NSphere_TCone``, the per-exit-group objective):
      ``train_until(0.01, 300)`` from ``seed`` 0 on ``Ex4_1_funcs`` must
      reach rel-L2 < 1%, with #2 and #3 launched once per iteration, #4
      and #5 ``n1`` times, #6 and #7 never; the trained primal is served
      through ``predict`` (``evaluate_points`` with the cone as domain,
      kernel #1) at 65,536 points inside the cone's space-time set under
      rel-L2 0.02;
   e. the hourglass through the command line,
      ``configs/hourglass_pde.yaml`` (``NSphere_THourglass``, 8,000
      interior rows with the g-seeded re-entry rows) with ``fused_v:
      true``, 20 iterations: one metrics record per iteration, finite
      losses, a last rel-L2 under the first, #2 and #3 once per iteration,
      #4 and #5 ``n1`` times, #6 twice and #7 once; ``--resume
      --iterations 3`` must continue the step count and the loss; the
      resumed primal is served through ``predict`` at 65,536 points of the
      hourglass (about a third of them re-entry points, seeded from ``g``
      at ``t_entry > T0``) and held against the plain scan within ``rtol,
      atol`` below;
   f. the hourglass converging: ``configs/hourglass_pde.yaml`` as shipped
      (the plain adversary), ``train_until(0.01, iterations, window=100,
      stall_action="drop_lr")`` from ``seed`` 0 on ``Ex4_1_funcs`` must
      reach rel-L2 < 1%, with #2 and #3 launched once per iteration, #4
      and #5 ``n1`` times, #6 and #7 never, and write the best weights
      and the checkpoint; its iterations, learning-rate drops and rel-L2
      every 10 iterations are printed beside JAX's run; the converged
      primal is served through ``predict`` at 65,536 points uniform in
      the hourglass's space-time set under rel-L2 0.02 and held against
      the plain scan;
   g. paper example 4.3 at d = 20: ``configs/highdim_d20.yaml`` as
      shipped with ``Ex4_3_consistent`` from ``seed`` 0 (auto ``u_scale``,
      printed), ``train_until(0.01, 70, window=200,
      stall_action="drop_lr")``: every rel-L2 finite, the least under
      0.25, the launches exact as in f, the rel-L2 every 10 iterations
      beside JAX's first 15;
   h. randomized QMC: one interior and one boundary batch of each of the
      three domains with ``qmc: halton`` on the card (every valid sample
      in its set, each coordinate's mean within 4 sigma / sqrt(N) of the
      centre), then ``configs/cube_pde.yaml`` with ``qmc: halton`` from
      ``seed`` 0, ``train_until(0.01, 1000)``: rel-L2 < 1%, the launches
      of b an iteration, the iterations beside JAX's (131; i.i.d. 108);
   i. ``ensemble: 4`` on ``configs/cube_pde.yaml`` at ``dim: 20``, seed 0,
      ``train_until(0.01, 200, window=100)``: the best member under 1%,
      every kernel launched 4x a single member's count an iteration,
      ``best_member`` and ``rel_err_worst`` printed; the best member
      served through ``predict`` at 65,536 points under 2a's limit;
   j. the WAN primal (``primal: wan``, the plain adversary), seed 0,
      ``train_until(0.05, 500)`` (cut from JAX's 7,015 to 1%): every value
      finite, the rel-L2 under 0.05 within 500 iterations, no kernel
      launched; then the command line
      with ``primal: wan`` and ``fused_v: true``, 20 iterations and
      ``--resume --iterations 3``: a record an iteration, the step and
      loss continuing, #6 twice and #7 once an iteration, #1-#5 never;
   k. the f64 reference-parity lane (``x64``, ``s1_raw_v``,
      ``independent_uv``, ``init_all_rows``; ``benchmarks/run_parity.py``)
      on the cube, seed 0, ``train_until(0.05, 60)``: the rel-L2 under
      0.05 within 60 iterations, with no kernel launched;
   l. the adaptive integrator at full width: ``configs/cube_pde.yaml`` with
      ``solver: dopri5`` and ``ode_max_steps: 16`` (JAX's ``d5_dopri5``
      scenario), seed 0, ``train_until(0.15, 20)``: every value finite,
      the rel-L2 under 0.15 within 20 iterations, no kernel launched (the
      adaptive solvers close the fused gate); then the command line with
      ``fused_v: true`` for 3 iterations and ``--resume --iterations 1``:
      #6 twice and #7 once an iteration and nothing else, the step and
      loss continuing; the resumed primal served through ``predict`` at
      65,536 points by the dopri5 masked scan, finite;
   m. the other solvers: first ``integrate_adaptive`` for each adaptive
      method with l's trained field on a fresh 4,000-path batch, f32
      against f64 on the card within 1e-3 of the tensor's largest value,
      and with ``remat`` bitwise equal to without; then the size of the
      JAX package's on-chip test (d=2, N_r = N_b = 256, N_t = 10, H = 16,
      Hh = 10, 3 layers, alpha 1e5): ``adams`` for 14 iterations to a
      final rel-L2 under 0.3, and ``bosh3``, ``adaptive_heun``,
      ``fehlberg2``, ``dopri8``, ``explicit_adams`` and ``fixed_adams``
      for 2 iterations each: finite, no kernel launched;
   n. the continuous adjoint (``apply_xnode_adjoint``) on a 4,000-path d=5
      midpoint batch: its forward bitwise equal to ``apply_xnode``'s
      without remat, its parameter gradient within 2e-2 (relative, in
      norm) of autograd through the scan; and the peak device memory and
      time of one backward without remat, with remat and with the adjoint
      at L = 20 and 200;
   o. chunked training: the cube from ``seed`` 0 by
      ``train_chunked(300, chunk=20)`` to the 1% stop: its stop iteration
      and final rel-L2 bitwise b's, its checkpoint's networks bitwise b's
      stop state, the replay bitwise the chunk's own metrics, the
      launches exact; the host syncs of one chunk of 20 (only the
      metrics' copy and the improved best weights' may wait), and the
      chunked iteration's time against one at a time;
   p. ``profile_dir`` through the command line, 10 iterations: the
      Chrome trace exists and names the launchers of #2-#5; the card's
      busy share over the traced window;
   q. the contour plot's slice of o's primal at resolution 200 through
      kernel #1 (once), ``guess_cn.npy`` and ``error_cn.npy`` written,
      the slice's rel-L2 under 0.05, a missing matplotlib printed;
   r. two ranks on the card over ``gloo``, the cube at full width (2,000
      interior and boundary rows a rank): one outer step against one
      process (1e-4 of each parameter tensor's largest value, 1e-5 on
      the metrics), ``train_until`` to 1% beside b's iterations with
      the exact launches a rank, a ``fused_v`` step through #6/#7,
      65,536 points served on the mesh bitwise equal to one process, an
      ``ensemble: 2`` step (a member a rank, through #2-#5) and a
      ``fused_v`` ``tangent_shards: 2`` step at d = 20 (u side plain, #2
      and #6/#7 kept), each with exact launches against its fused
      single-process twin; then ``nccl`` on a world of every card, one
      step equal to one process;
   s. the wide cube: ``configs/cube_pde.yaml`` with ``u_hidden_dim`` =
      ``u_hidden_hidden_dim`` = 64 (the widest primal the JAX package's
      Pallas #5 takes at d = 5), seed 0, ``train_until(0.01, 300)``:
      launches of b an iteration, #5 all in its cluster variant (two
      blocks a cluster, each with half the units and half the
      accumulator), the least rel-L2 under 0.05 and the iteration of the 1%
      stop printed if it fired; the result served through #1 at 65,536
      points, finite and within 2x the least training rel-L2;
   t. the cube at d = 100 with ``fourier_features: 1`` (F = 300), seed
      0, ``N_r = N_b = 4,000``, 20 iterations of ``train_until``: #2 once
      an iteration in its register kernel, #3 once and #4 and #5 twice
      an iteration at the full d (one tangent chunk: the features stay
      out of the tiles), every rel-L2 and weight finite
      (``loss_u`` overflows f32 at this volume, as in the JAX package),
      the least rel-L2 under the first; 65,536 points served through #1's
      register kernel, finite (the interior term's gradient is zero
      here, as ``log`` of an inf; 2u trains through it);
   u. the cube at d = 30 with ``u_hidden_dim = u_hidden_hidden_dim = 48``
      and ``fourier_features: 1`` (F = 90), seed 0, 20 iterations of
      ``train_until``: #2 in its register kernel (the 48/48 library),
      #3-#5 at the full d with #5's cluster variant, exact
      launches by variant, every ``loss_u`` finite (#3-#5's interior term
      drives the training), the least rel-L2 under the first;
   x. the cube at ``u_hidden_dim = u_hidden_hidden_dim = 128``, seed 0,
      10 iterations of ``train_until``: #2 once an iteration in the
      path-tile kernel (``csrc/xnode_path_tile.cu``), #3-#5 on their
      route (#5 on clusters), exact launches by variant, every loss and
      rel-L2 finite, the least rel-L2 under the first; 65,536 points
      served through ``evaluate_points`` (#1's path-tile kernel, once)
      against ``evaluate_plain`` on the card within ``rtol, atol`` below;
   v. the cube with a 256-wide adversary (``v_hidden_dim: 256``, tied,
      ``fused_v: true``), seed 0: one outer step through #6/#7 against the
      same step with the plain adversary from the same weights and batch
      (1e-4 of each parameter tensor's largest value, 1e-5 on the
      metrics), then 20 iterations of ``train_until``: #6 twice an
      iteration in its tile variant, #7 once in its cluster variant
      (neither the register #6's staged weights nor #7's shared
      accumulator fit; clusters of 8 blocks, 16 points a tile, the hidden
      weights resident), #2-#5 as in b, every ``loss_u``, L2, rel-L2 and
      weight finite, the least rel-L2 under the first;
   w. the same at ``dim: 20`` with ``v_fourier_features: 3`` (F = 141):
      the register #6 and the shared #7;

3. each kernel against its plain PyTorch version on the same card
   inputs: #1 and #2 within ``rtol=2e-4, atol=2e-5`` on all four RK
   methods, a random 70% mask and rk4 with n_sub 2 (#2), Fourier
   features (#1), ragged counts (#1 at M = 65,537, #2 at N = 4,001 and
   37) and the ``highdim_d20`` widths with its Fourier bank (random
   weights, a library of their own); #3 / #4 (u, du, hs,
   hts) and #5 (the packed weight gradient, against the plain
   hand-derived adjoint) on all four RK methods, a random 70% mask, rk4
   with n_sub 2, Fourier features, ragged path counts (4,001 and 37) and
   the ``highdim_d20`` geometry (H = 24, Hh = 32, d = 20, its Fourier
   bank; paths within ``KINK_MARGIN`` of a relu kink left out, then all
   paths at ``KINK_RTOL``), two launches of #4 and of #5 compared
   bitwise there and at the cube's trained net at N_r, N_r + 1 and 37
   paths, and the autograd function's weight gradients against
   ``torch.autograd.grad``
   through the plain forward;
   #6 (v within ``rtol=2e-4, atol=2e-5``, the input gradient) and #7
   (each weight-gradient tensor) at 80,000 points for the trained tied
   adversary, an untied one and the d=20 geometry with its Fourier bank,
   tied and untied (the untied one runs #7's 8-point tiles),
   #6 and #7 also at ragged counts (M = 80,001 and 37, the trained and
   the untied adversary), two launches of #7 compared bitwise, and the
   fused adversary side's weight gradients against autograd through the
   plain ``create_graph`` path;
   on the moving domains' inputs: #2 and #3-#5 on a cone interior batch
   (4,000 rows that die partway), an hourglass interior batch (8,000 rows:
   g-seeded re-entry rows that start after ``T0``, rows dead in the whole
   sample) and an hourglass boundary batch (zero-length anchored paths,
   every ``dt`` 0), with the kink rule of the d=20 check, #5 twice on the
   hourglass batch compared bitwise; #1 at the hourglass's served points
   with their entry times and seeds; the fused adversary side with the
   hourglass's time-dependent cutoff against autograd through the plain
   path; and the per-exit-group objective with its input gradients
   computed twice on the same card inputs, compared bitwise; the
   kernel variants: #1 and #2's path-tile kernel at 2x's trained net
   and at d = 5 with H = 96, Hh = 64 (their route) and, through its
   launch helper, at 2t's net (#2 at N_r, N_r + 1 and 37 paths, #1 at
   65,536 points) and at the cube's net, and their register kernel at
   2t's, 2u's and the cube's nets, each twice, bitwise,
   #5's cluster variant at 2s's trained net and, at random weights (live
   relus), at its shape and at 2u's (d = 30, F = 90), each
   at N_r, N_r + 1 and 37 paths, twice, bitwise, by the kink rule of the
   d=20 check (the paths at least ``KINK_MARGIN`` from a kink against the
   plain version, all of them at ``KINK_RTOL``); at the random ones #5's
   global variant against the plain version by the same all-path rule
   and the cluster variant against it on all paths (their FP32 forwards
   sum in the same order); #5's global variant at 2s's trained net by
   the kink rule; #5's global
   accumulator bitwise equal to the shared
   one at the cube's trained net with the launcher called with each at
   the same tile and grid, and #3-#5 in
   tangent chunks of 10 at the ``highdim_d20`` geometry against the
   full-d kernels (u and du bitwise, the weight gradient within the
   scaled limit), and #3-#5 against their plain versions, with the kink
   rule of the d=20 check, at the full d of 2t's net (d = 100, F = 300),
   of 2u's trained net (d = 30, #5's cluster variant), of 2i's net (the
   cube's widths at d = 20, random weights) and of the cube's widths at
   d = 50 (random weights), #4 and #5 twice each, bitwise; #6's and #7's
   variants, by the kink rule of the d=20 check
   (points within ``KINK_MARGIN`` of a relu kink of the adversary left
   out, then all at ``KINK_RTOL``) at 80,000 points and at 80,001 and 37:
   2v's and 2w's trained adversaries, JAX's widest at the shipped depth
   (558 wide, tied), an untied 128-wide one and a 50-wide one 40 deep,
   untied and tied, and 2v's 256-wide tied shape (#7's cluster variant)
   (random weights), #6 and #7 twice each, bitwise (the tile #6 at 2v's
   trained net and at the 256-wide, 558-wide, 128 untied and 40-deep
   untied random ones); the tile #6 through its launcher at the cube's
   shape (random weights, 128 points a tile) at the same three sizes by
   the same rule, twice, bitwise; #7's global accumulator bitwise equal to
   the shared one at the cube's shape at the same tile and grid;
4. CUDA-event times (the kernel's median of 20 after warm-up, the plain
   version's of 5) of each kernel and its plain version at the main
   path's shapes, beside the bound the card's published peaks put on the
   same work (FP32 outside the tensor cores; where #5's cluster variant
   runs its VJP on the tensor cores in 3xTF32, those operations at the
   TF32 rate over three); and each kernel variant
   at its phase's shapes (the path-tile #1/#2 at 2x's, phase 3's 96/64
   and, launched directly, 2t's shapes, the register #1/#2 at 2t's and
   2u's, and both variants of #2 at the cube's net, #5's cluster variant at 2s's and its global
   accumulator there through its launcher, #3-#5 at 2t's, #5's cluster
   variant and its global accumulator at 2u's, #3-#5 at the d=20 nets of
   2g (``highdim_d20``) and 2i (random weights); #6 and #7 at
   2v's and 2w's trained adversaries and at the 558-wide one, #7's global
   accumulator at 2v's through its launcher beside its cluster variant
   (whose bound takes the FP32 forward recompute at the FP32 rate and the
   rest, in 3xTF32, at the TF32 rate over three; the tile #6's likewise
   its FP32 forward and its 3xTF32 sweep and gin), the tile #6 and #7's
   global accumulator at the cube's shape), with its bound and its
   launches there;
5. CUDA-event times (median of 10; an outer step's, of ``STEP_REPS``)
   of the two serving entry points and
   the share of each that its kernel takes, of one training outer step
   with the share of each kernel, of the plain boundary scan's forward
   and backward, and of the adversary side, and of one ``fused_v`` outer
   step (timed in turns with the plain one) with the share of #6 and #7,
   and of the adversary step alone, plain and fused in turns; one cone
   outer step with the share of the plain boundary scan, the
   per-exit-group objective, each of #2-#5, the kernels' tangent inputs
   and the adversary side, and its launches an iteration beside the
   cube's; one d = 20 outer step (2g's solver) with the
   same parts (medians of 5); one ensemble iteration of 2i (4 members at
   d = 20) beside one member's step, one WAN outer step (plain and
   ``fused_v``), one f64 parity-lane step, and a Halton draw beside an
   i.i.d. one at the cube's N_r; one dopri5 outer step of l (one run,
   three before phases 2o-2r) with its u side and boundary scan timed
   alone, one ``adams`` step
   of m (the median of its last three iterations, by the host clock of
   its log), and the cube's midpoint step with ``remat_scan`` on and off
   in turns (on, off, off, on). Parts timed alone can overlap in a step, so
   their sum may pass the step's time.

Each phase prints its seconds. The line before the last is a JSON object
with one entry per kernel (its launches on the main path, and by phase;
for #1, #2, #5, #6 and #7 also by variant, and the times of the
variants); the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import inspect
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "benchmarks", "ref_run_nr4000",
                    "best_model_weights_NODE.pth")
CONFIG = os.path.join(ROOT, "configs", "cube_pde.yaml")
CONE_CONFIG = os.path.join(ROOT, "configs", "cone_pde.yaml")
HOURGLASS_CONFIG = os.path.join(ROOT, "configs", "hourglass_pde.yaml")
# JAX reaches 0.95% on the cone in 52 outer iterations
# (benchmarks/scenarios/cone.json, seed 0)
CONE_MAX_ITERS = 300
# the served points fill the cone's space-time set uniformly, unlike the
# metric's paths (uniform in the ball at T0, cut where they exit)
CONE_SERVE_LIMIT = 0.02
# 2e holds the command-line run on the hourglass to its course over 20
# iterations; 2f trains it to the 1% stop with the drop_lr recipe, as JAX
# did: 0.99% in 496 iterations, one drop at 318, windows of 100
# (benchmarks/scenarios/hourglass.json)
HOURGLASS_ITERS = 20
HOURGLASS_WINDOW = 100
HOURGLASS_RUN = os.path.join(ROOT, "benchmarks", "scenarios",
                             "hourglass.json")
# 2g: paper example 4.3 at d = 20 (Ex4_3_consistent) with JAX's recipe,
# cut to 70 iterations (JAX's 1,990 to 0.98%, one drop at 662, would
# take about ten minutes at the d = 20 step; 150 before phases 2s-2u);
# JAX's rel-L2 reached 0.2344 by iteration 20
# (benchmarks/scenarios/d20_sines_twophase.json)
D20_CONFIG = os.path.join(ROOT, "configs", "highdim_d20.yaml")
D20_RUN = os.path.join(ROOT, "benchmarks", "scenarios",
                       "d20_sines_twophase.json")
D20_ITERS = 70
D20_WINDOW = 200
D20_BEST_LIMIT = 0.25
# 2h: the cube with qmc: halton; JAX reached 1% in 131 iterations from
# seed 0 (i.i.d. clouds: 108; benchmarks/ab_qmc.json)
QMC_RUN = os.path.join(ROOT, "benchmarks", "ab_qmc.json")
QMC_MAX_ITERS = 1000
# 2i: the cube at dim 20 with ensemble 4; JAX reached 0.99% in 85
# iterations (benchmarks/scenarios/d20_cube_ensemble.json)
ENSEMBLE_RUN = os.path.join(ROOT, "benchmarks", "scenarios",
                            "d20_cube_ensemble.json")
ENSEMBLE_MAX_ITERS = 200
ENSEMBLE_WINDOW = 100
# 2j: the WAN primal, cut to 500 iterations (JAX: 1% in 7,015, least
# rel-L2 0.0230 over its first 500; benchmarks/scenarios/wan_d5.json),
# run until its rel-L2 is under WAN_BEST_LIMIT (the port's is from
# iteration 280), then 20 iterations of the command line with fused_v
# and a resume
WAN_RUN = os.path.join(ROOT, "benchmarks", "scenarios", "wan_d5.json")
WAN_ITERS = 500
WAN_BEST_LIMIT = 0.05
WAN_CLI_ITERS = 20
# 2k: the f64 reference-parity lane (benchmarks/run_parity.py:48); JAX
# reached 0.998% in 80 iterations on a CPU
# (benchmarks/convergence_d5_parity.json), the port 1% in 113 on the H100;
# cut to 60 iterations to make room for 2l-2n, run until its rel-L2 is
# under PARITY_BEST_LIMIT (JAX's: 0.0149 by iteration 40, the port's
# 0.0299)
PARITY_RUN = os.path.join(ROOT, "benchmarks", "convergence_d5_parity.json")
PARITY_FLAGS = dict(x64=True, s1_raw_v=True, independent_uv=True,
                    init_all_rows=True)
PARITY_ITERS = 60
PARITY_BEST_LIMIT = 0.05
# 2l: the cube with solver: dopri5 (JAX's benchmarks/scenarios/d5_dopri5.json:
# 1% in 118 iterations; 0.461, 0.148, 0.084 at iterations 0, 10, 20), cut
# to 20 iterations (30 before phases 2o-2r), run until its rel-L2 is under
# DOPRI5_BEST_LIMIT;
# then the command line with fused_v for 3 iterations and a resume of 1
# (5 and 2 before phases 2o-2r)
DOPRI5_RUN = os.path.join(ROOT, "benchmarks", "scenarios", "d5_dopri5.json")
DOPRI5_ITERS = 20
DOPRI5_BEST_LIMIT = 0.15
DOPRI5_CLI_ITERS = 3
DOPRI5_RESUME_ITERS = 1
# 2m: the other solvers at the size of the JAX package's on-chip test
# (tests/test_tpu_hardware.py:218-228): adams cut from its 30 iterations
# to 14 (before phases 2o-2r: 30, before 2s-2u: 20), to a final rel-L2
# under 0.3 (its assertion), every other solver 2 iterations (5 before
# 2o-2r, 3 before #5's cluster variant's phase-3 checks);
# before them each adaptive method's f32 integration held against f64
SOLVER_CFG = dict(dim=2, shape_param=(-1.0, 1.0), N_t=10, N_r=256, N_b=256,
                  u_hidden_dim=16, u_hidden_hidden_dim=10, u_layers=3,
                  v_layers=4, v_hidden_dim=20, min_steps=5, alpha=1e5,
                  u_rate=0.015, v_rate=0.04, n1=2, n2=1, seed=0)
ADAMS_ITERS = 14
ADAMS_LIMIT = 0.3
OTHER_SOLVERS = ("bosh3", "adaptive_heun", "fehlberg2", "dopri8",
                 "explicit_adams", "fixed_adams")
OTHER_ITERS = 2
F64_SCALED_TOL = 1e-3
# 2n: the continuous adjoint's gradient against autograd through the scan
# (the bound of tests/test_adjoint.py:77-90), and the peak memory of one
# backward at two path lengths (benchmarks/ab_adjoint.py's A/B)
ADJOINT_GRAD_RTOL = 2e-2
ADJOINT_LENGTHS = (20, 200)
# 2o: the cube by train_chunked to the 1% stop, against 2b's train_until
CHUNK = 20
CHUNKED_MAX_ITERS = 300
# 2p: the command line with profile_dir, one iteration a chunk
PROFILE_ITERS = 10
# 2q: the slice through x_2..x_d = 0.5 of 2o's primal, as plotted
PLOT_REL_LIMIT = 0.05
# 2r: two ranks on the card against one process, at the f32 tolerances of
# tests/test_torch_training.py::test_one_outer_step_matches_jax[f32_*]
MG_MAX_ITERS = 300
PARAM_RTOL, METRIC_RTOL = 1e-4, 1e-5
# 2v/2w's step against the plain one: Adam's first step moves a parameter
# by lr g / (|g| + eps), so where |g| is a small share of its tensor's
# largest, f32 rounding of g (about 1e-7 of the largest) is a large share
# of g and moves the step by up to lr; the parameters compared are those
# whose |g| is at least this share of the largest, in both runs
ADAM_GRAD_SHARE = 1e-4
# 2s: the cube at u_hidden_dim = u_hidden_hidden_dim = 64, to the 1% stop
# within 300 iterations, held to its least rel-L2; served within 2x that
WIDE = dict(u_hidden_dim=64, u_hidden_hidden_dim=64)
WIDE_MAX_ITERS = 300
WIDE_BEST_LIMIT = 0.05
WIDE_SERVE_FACTOR = 2.0
# 2t: the cube at d = 100 with its Fourier bank (F = 300), as JAX's
# benchmarks/scenarios/d50_cube.json runs d = 50, 20 iterations
D100 = dict(dim=100, fourier_features=1)
D100_ITERS = 20
# 2u: the cube at d = 30 with H = Hh = 48 and its Fourier bank (F = 90):
# 2t's route (the register #2, #3-#5 at the full d) with #5's cluster
# variant, at a volume (2^30)
# where loss_u stays finite, so that #3-#5's interior term drives the
# training; 20 iterations
D30 = dict(dim=30, u_hidden_dim=48, u_hidden_hidden_dim=48,
           fourier_features=1)
D30_ITERS = 20
# phase 3: the path-tile #1/#2 at the cube with a 96/64 primal, random
# weights (its staged copy, 243,344 bytes, is past one block)
NET96 = dict(u_hidden_dim=96, u_hidden_hidden_dim=64)
# 2x: the cube at u_hidden_dim = u_hidden_hidden_dim = 128, the next step
# of 2s's width sweep: #1/#2 past the register kernel's widths (the
# path-tile kernel), #3/#4 on 4-path tiles, #5 on clusters; 10 iterations
WIDE128 = dict(u_hidden_dim=128, u_hidden_hidden_dim=128)
WIDE128_ITERS = 10
# 2v: the cube with a 256-wide adversary through fused_v (the tile #6,
# #7's cluster variant); 2w: the cube at d = 20 with the adversary's
# Fourier bank at three frequencies (F = 1 + 20 * 7 = 141, past the 128
# features the port took before: the register #6, the shared #7); 20
# iterations of train_until each
WIDE_V = dict(v_hidden_dim=256, fused_v=True)
FOURIER_V = dict(dim=20, v_fourier_features=3, fused_v=True)
ADV_ITERS = 20
# phase 3: adversaries with random weights, so that their relus are live
# (the trained ones' die): the cube's shape, the d=20 cube's with three
# Fourier frequencies (F = 141, past the old 128), JAX's widest at the
# shipped depth (12,284 of its 12,288 rows), an untied 128-wide one, a
# deep one, untied and tied, and 2v's (#7's cluster variant): (label, d,
# H, L, tied, v_fourier_features)
ADV_NETS = (("cube's shape", 5, 50, 9, True, 0),
            ("2v's shape", 5, 256, 9, True, 0),
            ("d=20, 3 frequencies", 20, 50, 9, True, 3),
            ("widest tied", 5, 558, 9, True, 0),
            ("untied", 5, 128, 9, False, 0),
            ("deep untied", 5, 50, 40, False, 0),
            ("deep tied", 5, 50, 40, True, 0))
# phase 3: #3-#5 at the highdim_d20 geometry in chunks of this many
# tangent directions, against the full d
D20_CHUNK = 10
RTOL, ATOL = 2e-4, 2e-5       # kernel against plain; tests/test_pallas.py:33
# Tangents, stored tangent states and weight gradients are sums of many
# terms of both signs (the gradient: over 20,000 path-directions and 20
# intervals), taken in another order by the kernels; their error is held
# against the largest magnitude of each tensor instead of elementwise.
SCALED_RTOL = 2e-4
REL_L2_LIMIT = 0.0125         # JAX on the CPU gives 0.0102-0.0104 here
TRAIN_TOL = 0.01              # the paper's stop (configs/Ex4_1_funcs.py)
SERVE_POINTS = 65536
# The highdim_d20 check of #3-#5 leaves out the paths that come within
# KINK_MARGIN of a relu kink (the smallest |a| / (|W| |z| + |b|) of a
# primal pre-activation along the path, in f64): there the tangents jump,
# and two f32 orders of summation may take either branch. At 4,000 paths
# one path has a margin of 3.5e-8; the kernels' du and hts leave the
# plain f32 version there by 3.1e-4 and 1.6e-3 of the largest value (16
# and 600 elements), while the median path's margin is 3.3e-5
# (python -m xnode_wan_tpu_torch.tile_sweep --configs highdim_d20 --f64).
# All the paths, those near a kink too, are then held at KINK_RTOL of the
# largest value, above the 1.6e-3 seen, with the count of elements beyond
# SCALED_RTOL printed.
D20_PATHS = 4000
KINK_MARGIN = 1e-5
KINK_RTOL = 2e-3
SEED = 0
# NVIDIA H100 SXM data sheet: FP32 without tensor cores, HBM3 rate.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12      # on the tensor cores, dense
PEAK_BYTES_PER_S = 3.35e12
# CUDA-event runs of an outer step in phase 5 (10 before #5's cluster
# variant's phase-3 checks), after one warm-up run
STEP_REPS = 5
# phase 4 times an adversary kernel over 5 runs (20 after 3 warm-ups
# before #7's cluster variant's phase-3 checks) where its first launch
# takes longer: the 558-wide net's global #7, about 1.3 s a launch
SLOW_LAUNCH_MS = 500.0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, n_bytes: float, flops_3xtf32: float = 0.0):
    """The least time (ms) for ``flops`` FP32 operations and ``n_bytes``
    moved, and which of the two bounds it. ``flops_3xtf32`` are operations
    that the kernel runs on the tensor cores in 3xTF32: three TF32
    products each, at the TF32 rate; the FP32 units and the tensor cores
    work side by side, so the operations take the longer of the two."""
    t_ops = max(flops / PEAK_FP32_FLOPS,
                3.0 * flops_3xtf32 / PEAK_TF32_FLOPS)
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite output")
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                               msg=lambda m: f"{name}: {m}")
    print(f"  {name}: max |kernel - plain| = {err:.3e}")
    return err


def compare_scaled(name: str, got, want, sizes=None,
                   limit: float = SCALED_RTOL) -> float:
    """``max |got - want| <= limit * max |want|`` for each segment
    (``sizes`` splits a packed vector into its weight tensors). Under a
    looser limit, also prints how many elements are off by more than
    ``SCALED_RTOL`` of their segment's largest value."""
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite output")
    pairs = (zip(torch.split(got, sizes), torch.split(want, sizes))
             if sizes else [(got, want)])
    worst, err, n_off = 0.0, 0.0, 0
    for g, w in pairs:
        e = float((g - w).abs().max())
        scale = float(w.abs().max())
        rel = e / scale if scale > 0 else e
        err, worst = max(err, e), max(worst, rel)
        n_off += int(((g - w).abs() > SCALED_RTOL * scale).sum())
        if not rel <= limit:
            raise AssertionError(f"{name}: max |kernel - plain| {e:.3e} is "
                                 f"{rel:.3e} of max |plain| {scale:.3e} "
                                 f"(limit {limit})")
    off = (f"; {n_off} of {got.numel()} elements beyond {SCALED_RTOL}"
           if limit != SCALED_RTOL else "")
    print(f"  {name}: max |kernel - plain| = {err:.3e}, at most "
          f"{worst:.3e} of the tensor's largest value{off}")
    return err


def path_work(net, steppers, N, L, d, n_sub, method):
    """FLOPs and bytes of kernels #2-#5 at these shapes: each input read
    once, each output written once; the multiply-adds of the joint
    primal + d-tangent network (the tangent of field layer 0 skips the
    time column, which has no tangent)."""
    evals = steppers.EVALS_PER_STEP[method]
    once, per_eval = steppers.field_macs(net)
    lift_read = steppers.lift_readout_macs(net)
    tan_eval = per_eval - net.Hh
    steps = L * n_sub * evals
    primal = N * 2.0 * (lift_read + once + steps * per_eval)
    joint = N * 2.0 * ((1 + d) * (lift_read + once)
                       + steps * (per_eval + d * tan_eval))
    n_w = 4.0 * sum(a.numel() for a in net.flat)
    F = net.F
    inputs = 4.0 * N * (2 * L + F + d * F + 1 + d) + n_w
    outputs = 4.0 * N * L * (1 + d)
    states = 4.0 * L * N * net.H * (1 + d)
    return {
        "xnode_train": (primal, 4.0 * N * (2 * L + F + 1) + n_w
                        + 4.0 * N * L),
        "xnode_udu_fwd": (joint, inputs + outputs),
        "xnode_udu_fwd_store": (joint, inputs + outputs + states),
        # recompute of each interval plus its reverse walk: the reverse of
        # a linear layer is two products (input cotangent, weight
        # gradient), so about 3x the forward's operations
        "xnode_udu_bwd": (3.0 * joint, inputs + states + outputs + n_w),
        # #5's cluster variant: the recompute in FP32, the two products of
        # the reverse walk on the tensor cores in 3xTF32
        "xnode_udu_bwd cluster": (joint, inputs + states + outputs + n_w,
                                  2.0 * joint),
    }


def disc_work(geom, M):
    """FLOPs and bytes of kernels #6 and #7 on M points: the forward and
    the sweep (#6), plus both reverses with their weight gradients (#7:
    the sweep's reverse is one product and one outer product per layer,
    as is the forward's); features, cotangents and weights read once,
    outputs written once."""
    F, H, L = geom.F, geom.H, geom.L
    fwd = F * H + L * H * H + H
    sweep = L * H * H + F * H
    bwd = fwd + sweep + 3 * F * H + 4 * L * H * H + 2 * H
    n_w = 4.0 * geom.n_params
    io = 4.0 * M * (2 * F + 1) + 2 * n_w
    fwd_io = 4.0 * M * (2 * F + 1) + n_w
    return {"disc_fwd": (2.0 * M * (fwd + sweep), fwd_io),
            # the tile #6: its forward in FP32, its sweep and gin in 3xTF32
            "disc_fwd tile": (2.0 * M * fwd, fwd_io, 2.0 * M * sweep),
            "disc_bwd": (2.0 * M * bwd, io),
            # #7's cluster variant: the forward recompute in FP32, the
            # sweep, both reverses and the weight sums in 3xTF32
            "disc_bwd cluster": (2.0 * M * fwd, io, 2.0 * M * (bwd - fwd))}


def inside_points(domain, m: int, generator, radius: float) -> torch.Tensor:
    """``m`` points drawn uniformly from a domain's space-time set, by
    rejection from the box ``[T0, T] x [-radius, radius]^d``."""
    parts, n = [], 0
    while n < m:
        p = torch.rand((4 * m, domain.dim + 1), generator=generator,
                       device=generator.device)
        p[:, 0] = domain.T0 + p[:, 0] * (domain.T - domain.T0)
        p[:, 1:] = radius * (2.0 * p[:, 1:] - 1.0)
        p = p[domain.func_w(p) > 0]
        parts.append(p)
        n += p.shape[0]
    return torch.cat(parts)[:m].contiguous()


def zero_launches(kernels) -> None:
    for k in kernels.values():
        k.launches = 0


class Launches(dict):
    """Launches by kernel name, which the phases compare with the counts
    they expect, and ``variants``: for each kernel built in more than one
    variant (#1, #2, #5), its launches by variant."""

    def __init__(self, counts, variants):
        super().__init__(counts)
        self.variants = variants


def read_launches(kernels) -> Launches:
    return Launches({n: k.launches for n, k in kernels.items()},
                    {n: k.by_variant() for n, k in kernels.items()
                     if hasattr(k, "by_variant")})


def check_served(label: str, launches, n: int = 1) -> None:
    """Serving a shipped net launched #1 ``n`` times, all in its register
    kernel (``launches`` read just after, :func:`read_launches`)."""
    if launches.variants["xnode_eval"] != {"registers": n, "tile": 0}:
        raise AssertionError(f"serving {label} launched #1 by variant "
                             f"{launches.variants['xnode_eval']}, expected "
                             f"{n} of its register kernel")


def train_launches_want(n: int, c) -> dict:
    """The launches of ``n`` outer iterations with the plain adversary:
    #2 and #3 once an iteration, #4 and #5 ``n1`` times."""
    return {"xnode_eval": 0, "xnode_train": n, "xnode_udu_fwd": n,
            "xnode_udu_fwd_store": c.n1 * n, "xnode_udu_bwd": c.n1 * n,
            "disc_fwd": 0, "disc_bwd": 0}


def chunked_run(kept: int, iterations: int, chunk: int, report_it=None,
                stopped: bool = False) -> int:
    """The outer iterations a chunked ``train`` (or ``train_chunked``)
    runs to keep ``kept``: chunks of ``chunk``, each ending at the next
    report step when ``report_it`` is given, the stop's chunk run whole
    and then replayed to the stop unless the stop is its last iteration
    (``NODEWANSolver._chunk``)."""
    done = run = 0
    while done < kept:
        n = min(chunk, iterations - done)
        if report_it:
            n = min(n, -(-done // report_it) * report_it - done + 1)
        run += n
        if stopped and done + n > kept:
            run += kept - done
        done += n
    return run


def cli_launches_want(kept: int, c, report_it: int, iterations: int,
                      stopped: bool, plots_launch: bool = True) -> dict:
    """The launches of a ``fused_v`` command-line run that kept ``kept``
    iterations: those of :func:`chunked_run`'s iterations (#2, #3 once,
    #4, #5 ``n1`` times, #6 ``1 + n2``, #7 ``n2`` times an iteration),
    and #1 once for each report step's plot when the primal serves
    through it."""
    n = chunked_run(kept, iterations, c.train_chunk, report_it, stopped)
    plots = len(range(0, kept, report_it)) if plots_launch else 0
    return {"xnode_eval": plots, "xnode_train": n, "xnode_udu_fwd": n,
            "xnode_udu_fwd_store": c.n1 * n, "xnode_udu_bwd": c.n1 * n,
            "disc_fwd": (1 + c.n2) * n, "disc_bwd": c.n2 * n}


def every_10(label: str, rel, reference) -> None:
    """Print rel-L2 at iterations 0, 10, 20, ... beside the JAX run's
    samples at the same iterations."""
    cells = [f"{i}: {rel[i]:.4f}" + (f" ({reference[i // 10]:.4f})"
                                      if i // 10 < len(reference) else "")
             for i in range(0, len(rel), 10)]
    print(f"{label}: rel-L2 every 10 iterations, JAX's in brackets:")
    for k in range(0, len(cells), 6):
        print("  " + "; ".join(cells[k:k + 6]))


def check_until(label: str, hist, launches, c) -> int:
    """The checks every ``train_until`` phase shares: one metric per
    iteration, every one finite, and the exact launches."""
    n = hist["iterations_run"]
    if not (len(hist["rel_err"]) == len(hist["loss_u"]) == n > 0):
        raise AssertionError(f"{label}: {len(hist['rel_err'])} metrics for "
                             f"{n} iterations")
    if not all(math.isfinite(v) for k in ("rel_err", "loss_u")
               for v in hist[k]):
        raise AssertionError(f"{label}: a non-finite rel-L2 or loss_u")
    if launches != train_launches_want(n, c):
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{train_launches_want(n, c)}")
    return n


def hourglass_drop_lr(kernels, work: str, gen, card: str) -> dict:
    """Phase 2f: ``configs/hourglass_pde.yaml`` as shipped, seed 0, trained
    by ``train_until`` with ``stall_action="drop_lr"`` to rel-L2 < 1% within
    the config's iterations, exact launches; then the converged primal
    served through ``predict`` (kernel #1) at ``SERVE_POINTS`` points
    uniform in the hourglass's space-time set, under ``CONE_SERVE_LIMIT``
    and against the plain scan."""
    from xnode_wan_tpu_torch import (NODEWANSolver, evaluate_points,
                                     load_params, load_problem, rel_err)

    cfg = load_params(HOURGLASS_CONFIG).replace(seed=SEED)
    problem = load_problem("Ex4_1_funcs", dim=cfg.dim)
    solver = NODEWANSolver(cfg, problem, work_dir=work)
    hg = solver.domain
    zero_launches(kernels)
    hist = solver.train_until(TRAIN_TOL, cfg.iterations,
                              window=HOURGLASS_WINDOW, stall_action="drop_lr")
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    with open(HOURGLASS_RUN) as fh:
        ref = json.load(fh)
    n = hist["iterations_run"]
    print(f"hourglass, train_until(drop_lr, window {HOURGLASS_WINDOW}) "
          f"({hg.interior_rows(cfg.N_r)} interior rows): {n} outer "
          f"iterations to rel-L2 {hist['rel_err_final']:.6f}, drops at "
          f"{hist['lr_drops_at']}, in {hist['wall_train_s']:.3f} s "
          f"(train_until wall clock, {card}); JAX: "
          f"{ref['iterations_run']} iterations, drops at "
          f"{ref['lr_drops_at']}; launches {launches}")
    if not hist["lr_drops_at"]:
        print("  no learning-rate drop fired before the stop")
    every_10("hourglass", hist["rel_err"], ref["rel_err_every_10"])
    check_until("hourglass (2f)", hist, launches, cfg)
    if not hist["rel_err_final"] < TRAIN_TOL:
        raise AssertionError(f"the hourglass stopped at rel-L2 "
                             f"{hist['rel_err_final']} >= {TRAIN_TOL} after "
                             f"{n} iterations")
    for name in ("best_model_weights_NODE.pth", "checkpoint_NODE.pt"):
        if not os.path.exists(os.path.join(work, name)):
            raise AssertionError(f"train_until wrote no {name}")

    pts = inside_points(hg, SERVE_POINTS, gen, hg.r * (hg.T - hg.T0))
    zero_launches(kernels)
    u = solver.predict(pts)
    torch.cuda.synchronize()
    serve = read_launches(kernels)
    check_served("the hourglass (2f)", serve)
    with torch.no_grad():
        u_scan = evaluate_points(solver.state.u_params, pts, problem,
                                 solver.cfg.replace(use_pallas=False),
                                 domain=hg)
    served = float(rel_err(u, problem.u_sol(pts),
                           torch.ones_like(u, dtype=torch.bool), hg.V(),
                           cfg.p))
    print(f"served the converged hourglass primal through predict at "
          f"{SERVE_POINTS} points: rel-L2 {served:.6f} (#1 by variant "
          f"{serve.variants['xnode_eval']})")
    if u.shape != (SERVE_POINTS,) or not served < CONE_SERVE_LIMIT:
        raise AssertionError(f"the hourglass serves at rel-L2 {served} >= "
                             f"{CONE_SERVE_LIMIT}")
    err = compare(f"served converged hourglass, kernel #1 vs the plain "
                  f"scan, M={SERVE_POINTS}", u, u_scan)
    return {"hist": hist, "launches": launches, "served": served,
            "err": err, "reference": ref, "serve_launches": serve}


def d20_drop_lr(kernels, work: str, card: str) -> dict:
    """Phase 2g: ``configs/highdim_d20.yaml`` as shipped with
    ``Ex4_3_consistent``, seed 0, ``train_until(0.01, D20_ITERS,
    window=200, stall_action="drop_lr")``: every rel-L2 finite, the least
    under ``D20_BEST_LIMIT``, exact launches. Returns the solver too, whose
    outer step phase 5 times."""
    from xnode_wan_tpu_torch import NODEWANSolver, load_params, load_problem

    cfg = load_params(D20_CONFIG).replace(seed=SEED)
    solver = NODEWANSolver(cfg, load_problem("Ex4_3_consistent", cfg.dim),
                           work_dir=work)
    zero_launches(kernels)
    hist = solver.train_until(TRAIN_TOL, D20_ITERS, window=D20_WINDOW,
                              stall_action="drop_lr")
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    with open(D20_RUN) as fh:
        ref = json.load(fh)
    n = hist["iterations_run"]
    best = float(min(hist["rel_err"]))
    print(f"paper example 4.3, d={cfg.dim}, Ex4_3_consistent, auto u_scale "
          f"{solver.cfg.u_scale:.6g}: {n} outer iterations, least rel-L2 "
          f"{best:.6f}, last {hist['rel_err_final']:.6f}, drops at "
          f"{hist['lr_drops_at']}, in {hist['wall_train_s']:.3f} s "
          f"(train_until wall clock, {card}); launches {launches}")
    every_10("d=20", hist["rel_err"], ref["rel_err_every_10"][:15])
    check_until("d=20 (2g)", hist, launches, cfg)
    if not best < D20_BEST_LIMIT:
        raise AssertionError(f"the d=20 run's least rel-L2 {best} >= "
                             f"{D20_BEST_LIMIT} in {n} iterations")
    return {"hist": hist, "launches": launches, "best": best,
            "solver": solver, "u_scale": solver.cfg.u_scale}


def check_qmc_clouds(dev) -> dict:
    """Phase 2h's draws: one interior and one boundary batch of each
    domain with ``qmc: halton`` on the card, at the shipped configs'
    N_r / N_b. Every valid sample lies in its set (the boundary paths end
    on the boundary), and each spatial coordinate's mean lies within
    4 sigma / sqrt(N) of the i.i.d. expectation, the centre of the
    domain's symmetric box or ball (sigma: the coordinate's spread)."""
    from xnode_wan_tpu_torch import load_params, make_domain

    out = {}
    g = torch.Generator(device=dev).manual_seed(SEED)
    for path in (CONFIG, CONE_CONFIG, HOURGLASS_CONFIG):
        c = load_params(path)
        dom = make_domain(c.domain, c.shape_param, c.dim, c.T0, c.T, c.N_t,
                          qmc="halton")
        centre = (0.5 * (dom.bot + dom.top) if hasattr(dom, "bot") else 0.0)
        for kind, b in (("interior", dom.interior(g, c.N_r)),
                        ("boundary", dom.boundary(g, c.N_b))):
            name = f"{c.domain} {kind}"
            w = dom.func_w(b.x)
            if kind == "interior":
                gap = float(torch.clamp(-w[b.mask], min=0).max())
            else:   # the cube's whole paths, the spheres' exit samples
                w_end = w if c.domain == "Hypercube" else w[:, -1]
                gap = float(w_end.abs().max())
            if not gap <= 1e-5:
                raise AssertionError(f"{name}: a sample {gap:.3e} outside "
                                     "its set")
            xs = b.x[:, 0, 1:].double() if kind == "interior" else \
                b.x[:, -1, 1:].double()
            n = xs.shape[0]
            z = ((xs.mean(0) - centre) / (xs.std(0) / math.sqrt(n))).abs()
            print(f"  qmc {name}: {tuple(b.x.shape)}, every sample in its "
                  f"set (worst {gap:.2e}); coordinate means at most "
                  f"{float(z.max()):.3f} sigma/sqrt(N) from the centre")
            if not bool((z < 4.0).all()):
                raise AssertionError(f"{name}: a coordinate mean is "
                                     f"{float(z.max()):.2f} sigma/sqrt(N) off")
            out[name] = float(z.max())
    return out


def qmc_cube(kernels, work: str, dev, card: str) -> dict:
    """Phase 2h: the clouds of :func:`check_qmc_clouds`, then
    ``configs/cube_pde.yaml`` with ``qmc: halton``, seed 0,
    ``train_until(0.01, QMC_MAX_ITERS)``: rel-L2 < 1%, the launches of 2b
    an iteration, the iterations beside JAX's (Halton and i.i.d.)."""
    from xnode_wan_tpu_torch import NODEWANSolver, load_params, load_problem

    clouds = check_qmc_clouds(dev)
    cfg = load_params(CONFIG).replace(qmc="halton", seed=SEED)
    solver = NODEWANSolver(cfg, load_problem("Ex4_1_funcs", dim=cfg.dim),
                           work_dir=work)
    zero_launches(kernels)
    hist = solver.train_until(TRAIN_TOL, QMC_MAX_ITERS)
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    with open(QMC_RUN) as fh:
        runs = json.load(fh)["runs"]
    jax_iters = {kind: next(r["iterations_run"] for r in runs[kind]
                            if r["seed"] == SEED)
                 for kind in ("halton", "none")}
    n = check_until("qmc cube (2h)", hist, launches, cfg)
    print(f"qmc: halton cube: {n} outer iterations to rel-L2 "
          f"{hist['rel_err_final']:.6f} in {hist['wall_train_s']:.3f} s "
          f"(train_until wall clock, {card}); JAX from seed {SEED}: "
          f"{jax_iters['halton']} (halton), {jax_iters['none']} (i.i.d.); "
          f"launches {launches}")
    if not hist["rel_err_final"] < TRAIN_TOL:
        raise AssertionError(f"the halton cube stopped at rel-L2 "
                             f"{hist['rel_err_final']} after {n} iterations")
    return {"hist": hist, "launches": launches, "jax": jax_iters,
            "clouds": clouds, "solver": solver}


def ensemble_d20(kernels, work: str, dev, card: str) -> dict:
    """Phase 2i: ``configs/cube_pde.yaml`` at ``dim: 20`` with ``ensemble:
    4``, seed 0, ``train_until(0.01, ENSEMBLE_MAX_ITERS, window=100)``:
    rel-L2 < 1% (the best member's), each kernel launched 4x a single
    member's count an iteration, ``best_member`` and ``rel_err_worst``
    printed; then the best member served through ``predict`` at
    ``SERVE_POINTS`` points under ``REL_L2_LIMIT`` (one launch of #1)."""
    from xnode_wan_tpu_torch import (NODEWANSolver, load_params, load_problem,
                                     rel_err)

    cfg = load_params(CONFIG).replace(dim=20, ensemble=4, seed=SEED)
    problem = load_problem("Ex4_1_funcs", dim=cfg.dim)
    solver = NODEWANSolver(cfg, problem, work_dir=work)
    zero_launches(kernels)
    hist = solver.train_until(TRAIN_TOL, ENSEMBLE_MAX_ITERS,
                              window=ENSEMBLE_WINDOW)
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    n = hist["iterations_run"]
    with open(ENSEMBLE_RUN) as fh:
        ref = json.load(fh)
    print(f"ensemble {cfg.ensemble}, d={cfg.dim}: {n} outer iterations to "
          f"rel-L2 {hist['rel_err_final']:.6f} (best member "
          f"{int(hist['best_member'][-1])}, worst member "
          f"{hist['rel_err_worst'][-1]:.6f}) in {hist['wall_train_s']:.3f} s "
          f"(train_until wall clock, {card}); JAX: {ref['iterations_run']} "
          f"iterations to {ref['rel_err_final']:.6f}; launches {launches}")
    every_10("ensemble", hist["rel_err"], ref["rel_err_every_10"])
    members = [int(b) for b in hist["best_member"][::10]]
    print(f"  best member every 10 iterations: {members}; worst member's "
          f"rel-L2: {[round(float(v), 4) for v in hist['rel_err_worst'][::10]]}")
    one = train_launches_want(n, cfg)
    want = {k: cfg.ensemble * v for k, v in one.items()}
    if launches != want:
        raise AssertionError(f"ensemble launches {launches}, expected {want}")
    if not (len(hist["rel_err"]) == len(hist["best_member"]) == n
            and all(math.isfinite(v) for v in hist["rel_err_worst"])):
        raise AssertionError("ensemble: the history is not one entry an "
                             "iteration, or not finite")
    if not hist["rel_err_final"] < TRAIN_TOL:
        raise AssertionError(f"the ensemble stopped at rel-L2 "
                             f"{hist['rel_err_final']} after {n} iterations")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    pts = torch.rand((SERVE_POINTS, cfg.dim + 1), generator=g, device=dev)
    pts[:, 1:] = 2.0 * pts[:, 1:] - 1.0
    zero_launches(kernels)
    u = solver.predict(pts)
    torch.cuda.synchronize()
    serve = read_launches(kernels)
    served = float(rel_err(u, problem.u_sol(pts),
                           torch.ones_like(u, dtype=torch.bool),
                           solver.domain.V(), cfg.p))
    print(f"served the best member ({solver._best_member}) through predict "
          f"at {SERVE_POINTS} points: rel-L2 {served:.6f} "
          f"(#1 by variant {serve.variants['xnode_eval']})")
    check_served("the ensemble (2i)", serve)
    if u.shape != (SERVE_POINTS,) or not served < REL_L2_LIMIT:
        raise AssertionError(f"the best member serves at rel-L2 {served} >= "
                             f"{REL_L2_LIMIT}")
    return {"hist": hist, "launches": launches, "served": served,
            "solver": solver, "reference": ref, "serve_launches": serve}


def wan_runs(kernels, work_root: str, cli_main, card: str) -> dict:
    """Phase 2j: ``configs/cube_pde.yaml`` with ``primal: wan`` (plain
    adversary), seed 0, ``train_until(WAN_BEST_LIMIT, WAN_ITERS)``: every
    value finite, the rel-L2 under ``WAN_BEST_LIMIT`` within ``WAN_ITERS``
    iterations, no kernel launched;
    then the command line with ``primal: wan`` and ``fused_v: true`` for
    ``WAN_CLI_ITERS`` iterations and ``--resume --iterations 3``: a record
    an iteration, the step and loss continuing, #6 twice and #7 once an
    iteration, #1-#5 never."""
    from xnode_wan_tpu_torch import NODEWANSolver, load_params, load_problem

    cfg = load_params(CONFIG).replace(primal="wan", seed=SEED)
    solver = NODEWANSolver(cfg, load_problem("Ex4_1_funcs", dim=cfg.dim),
                           work_dir=os.path.join(work_root, "2j"))
    zero_launches(kernels)
    hist = solver.train_until(WAN_BEST_LIMIT, WAN_ITERS)
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    with open(WAN_RUN) as fh:
        ref = json.load(fh)
    n = hist["iterations_run"]
    best = float(min(hist["rel_err"]))
    print(f"WAN primal: {n} outer iterations, least rel-L2 {best:.6f}, last "
          f"{hist['rel_err_final']:.6f}, in {hist['wall_train_s']:.3f} s "
          f"(train_until wall clock, {card}); JAX: least "
          f"{min(ref['rel_err_every_10'][:-(-n // 10)]):.6f} over its "
          f"first {n} (every 10th), 1% in {ref['iterations_run']}; "
          f"launches {launches}")
    every_10("WAN", hist["rel_err"], ref["rel_err_every_10"])
    if not (len(hist["rel_err"]) == n and all(
            math.isfinite(v) for k in ("rel_err", "loss_u", "L2")
            for v in hist[k])):
        raise AssertionError("the WAN run logged a non-finite value")
    if any(launches.values()):
        raise AssertionError(f"the WAN run launched kernels: {launches}")
    if not best < WAN_BEST_LIMIT:
        raise AssertionError(f"the WAN run's least rel-L2 {best} >= "
                             f"{WAN_BEST_LIMIT}")

    def want(k, iterations, stopped):
        # the WAN's u side and its plots launch none of #1-#5
        n = chunked_run(k, iterations, cfg.train_chunk, 5, stopped)
        return {"xnode_eval": 0, "xnode_train": 0, "xnode_udu_fwd": 0,
                "xnode_udu_fwd_store": 0, "xnode_udu_bwd": 0,
                "disc_fwd": (1 + cfg.n2) * n, "disc_bwd": cfg.n2 * n}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_wan_") as work:
        yaml_path = os.path.join(work, "cube_pde_wan_fused_v.yaml")
        with open(CONFIG) as fh:
            text = fh.read()
        with open(yaml_path, "w") as fh:
            fh.write(text.rstrip("\n") + "\nprimal: wan\nfused_v: true\n")
        argv = ["--params", yaml_path, "--funcs", "Ex4_1_funcs", "-w", work,
                "--report_it", "5"]
        zero_launches(kernels)
        out, wsolver = run_cli(cli_main, argv + ["--iterations",
                                                 str(WAN_CLI_ITERS)])
        torch.cuda.synchronize()
        cli_launches = read_launches(kernels)
        metrics_file = os.path.join(work, f"metrics_NODE_{cfg.dim}.jsonl")
        rec = read_jsonl(metrics_file)
        zero_launches(kernels)
        out_res, resumed = run_cli(cli_main, argv + ["--resume",
                                                     "--iterations", "3"])
        torch.cuda.synchronize()
        res_launches = read_launches(kernels)
        rec2 = read_jsonl(metrics_file)
    fresh, last, first = (rec[0]["loss_u"], rec[-1]["loss_u"],
                          rec2[0]["loss_u"])
    print(f"WAN command line, fused_v: {wsolver.state.step} iterations, "
          f"rel-L2 {rec[0]['rel_err']:.6f} -> {rec[-1]['rel_err']:.6f}; "
          f"launches {cli_launches}; resumed: step {wsolver.state.step} -> "
          f"{resumed.state.step}, loss_u first fresh {fresh:.6g}, last "
          f"{last:.6g}, first resumed {first:.6g}; launches {res_launches}")
    if wsolver.state.step != WAN_CLI_ITERS or \
            [r["step"] for r in rec] != list(range(WAN_CLI_ITERS)):
        raise AssertionError(f"{len(rec)} WAN records for {WAN_CLI_ITERS} "
                             "iterations")
    if not all(math.isfinite(r[k]) for r in rec + rec2
               for k in ("loss_u", "loss_v", "rel_err")):
        raise AssertionError("the WAN command line logged a non-finite loss")
    if len(rec2) != 3 or resumed.state.step != WAN_CLI_ITERS + 3:
        raise AssertionError("the resumed WAN run did not continue the step "
                             "count")
    if not abs(first - last) < abs(first - fresh):
        raise AssertionError("the resumed WAN loss_u is nearer the fresh "
                             "start's than the last one's")
    want_cli = want(WAN_CLI_ITERS, WAN_CLI_ITERS,
                    "Stopping Criterion Reached" in out)
    want_res = want(3, 3, "Stopping Criterion Reached" in out_res)
    if cli_launches != want_cli or res_launches != want_res:
        raise AssertionError(f"WAN command-line launches {cli_launches}, "
                             f"{res_launches}; expected {want_cli}, "
                             f"{want_res}")
    return {"hist": hist, "launches": launches, "best": best,
            "cli_launches": cli_launches, "res_launches": res_launches,
            "solver": solver, "cli_solver": resumed}


def parity_lane(kernels, work: str, card: str) -> dict:
    """Phase 2k: the f64 reference-parity lane, ``configs/cube_pde.yaml``
    with the four flags of ``benchmarks/run_parity.py`` (``x64``,
    ``s1_raw_v``, ``independent_uv``, ``init_all_rows``), seed 0,
    ``train_until(PARITY_BEST_LIMIT, PARITY_ITERS)``: the rel-L2 under
    ``PARITY_BEST_LIMIT`` within ``PARITY_ITERS`` iterations, and no
    kernel launched (x64 closes both gates)."""
    from xnode_wan_tpu_torch import NODEWANSolver, load_params, load_problem

    cfg = load_params(CONFIG).replace(seed=SEED, **PARITY_FLAGS)
    solver = NODEWANSolver(cfg, load_problem("Ex4_1_funcs", dim=cfg.dim),
                           work_dir=work)
    zero_launches(kernels)
    hist = solver.train_until(PARITY_BEST_LIMIT, PARITY_ITERS)
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    with open(PARITY_RUN) as fh:
        ref = json.load(fh)
    n = hist["iterations_run"]
    best = float(min(hist["rel_err"]))
    print(f"f64 parity lane {sorted(PARITY_FLAGS)}: {n} outer iterations, "
          f"least rel-L2 {best:.6f}, last {hist['rel_err_final']:.6f}, in "
          f"{hist['wall_train_s']:.3f} s (train_until wall clock, {card}); "
          f"JAX on a CPU: {ref['iterations']} to {ref['rel_err_final']:.6f}"
          f"; launches {launches}")
    every_10("parity", hist["rel_err"], ref["trajectory"]["rel_err"][::10])
    if any(launches.values()):
        raise AssertionError(f"the f64 lane launched kernels: {launches}")
    if not (len(hist["rel_err"]) == n > 0 and all(
            math.isfinite(v) for v in hist["loss_u"])):
        raise AssertionError("the f64 lane logged a non-finite loss_u")
    if not best < PARITY_BEST_LIMIT:
        raise AssertionError(f"the f64 lane's least rel-L2 {best} >= "
                             f"{PARITY_BEST_LIMIT} in {n} iterations")
    return {"hist": hist, "launches": launches, "solver": solver,
            "reference": ref}


def dopri5_cube(kernels, work_root: str, cli_main, pts, card: str) -> dict:
    """Phase 2l: ``configs/cube_pde.yaml`` with ``solver: dopri5`` and
    ``ode_max_steps: 16`` (JAX's ``d5_dopri5`` scenario), seed 0,
    ``train_until(DOPRI5_BEST_LIMIT, DOPRI5_ITERS)``: every value finite,
    the rel-L2 under ``DOPRI5_BEST_LIMIT`` within ``DOPRI5_ITERS``
    iterations, no kernel launched (the adaptive
    solvers close the fused gate); then the command line with ``fused_v:
    true`` for ``DOPRI5_CLI_ITERS`` iterations and ``--resume --iterations
    DOPRI5_RESUME_ITERS``: #6 twice and #7 once an iteration and nothing
    else, the step and
    loss continuing; the resumed primal served by ``predict`` at the
    65,536 points ``pts`` through the dopri5 masked scan: finite, no
    launch."""
    from xnode_wan_tpu_torch import NODEWANSolver, load_params, load_problem

    cfg = load_params(CONFIG).replace(solver="dopri5", ode_max_steps=16,
                                      seed=SEED)
    solver = NODEWANSolver(cfg, load_problem("Ex4_1_funcs", dim=cfg.dim),
                           work_dir=os.path.join(work_root, "2l"))
    zero_launches(kernels)
    hist = solver.train_until(DOPRI5_BEST_LIMIT, DOPRI5_ITERS)
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    with open(DOPRI5_RUN) as fh:
        ref = json.load(fh)
    n = hist["iterations_run"]
    best = float(min(hist["rel_err"]))
    print(f"dopri5 cube (ode_max_steps {cfg.ode_max_steps}): {n} outer "
          f"iterations, least rel-L2 {best:.6f}, last "
          f"{hist['rel_err_final']:.6f}, in {hist['wall_train_s']:.3f} s "
          f"(train_until wall clock, {card}); JAX: 1% in "
          f"{ref['iterations_run']}; launches {launches}")
    every_10("dopri5", hist["rel_err"], ref["rel_err_every_10"])
    if not (len(hist["rel_err"]) == n > 0 and all(
            math.isfinite(v) for k in ("rel_err", "loss_u", "L2")
            for v in hist[k])):
        raise AssertionError("the dopri5 run logged a non-finite value")
    if any(launches.values()):
        raise AssertionError(f"the dopri5 run launched kernels: {launches}")
    if not best < DOPRI5_BEST_LIMIT:
        raise AssertionError(f"the dopri5 run's least rel-L2 {best} >= "
                             f"{DOPRI5_BEST_LIMIT}")

    def want(k):
        return dict({n: 0 for n in kernels}, disc_fwd=(1 + cfg.n2) * k,
                    disc_bwd=cfg.n2 * k)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dopri5_") as work:
        yaml_path = os.path.join(work, "cube_pde_dopri5_fused_v.yaml")
        with open(CONFIG) as fh:
            text = fh.read()
        with open(yaml_path, "w") as fh:
            fh.write(text.replace("solver: midpoint", "solver: dopri5")
                     .rstrip("\n") + "\node_max_steps: 16\nfused_v: true\n")
        argv = ["--params", yaml_path, "--funcs", "Ex4_1_funcs", "-w", work,
                "--report_it", "1"]
        zero_launches(kernels)
        t = time.perf_counter()
        _, dsolver = run_cli(cli_main, argv + ["--iterations",
                                               str(DOPRI5_CLI_ITERS)])
        torch.cuda.synchronize()
        t_cli = time.perf_counter() - t
        cli_launches = read_launches(kernels)
        metrics_file = os.path.join(work, f"metrics_NODE_{cfg.dim}.jsonl")
        rec = read_jsonl(metrics_file)
        zero_launches(kernels)
        _, resumed = run_cli(cli_main, argv + [
            "--resume", "--iterations", str(DOPRI5_RESUME_ITERS)])
        torch.cuda.synchronize()
        res_launches = read_launches(kernels)
        rec2 = read_jsonl(metrics_file)
    if dsolver.cfg.solver != "dopri5" or not dsolver.cfg.fused_v:
        raise AssertionError(f"the command line ran {dsolver.cfg.solver}, "
                             f"fused_v {dsolver.cfg.fused_v}")
    fresh, last, first = (rec[0]["loss_u"], rec[-1]["loss_u"],
                          rec2[0]["loss_u"])
    print(f"dopri5 command line, fused_v: {dsolver.state.step} iterations "
          f"in {t_cli:.3f} s, rel-L2 {rec[0]['rel_err']:.6f} -> "
          f"{rec[-1]['rel_err']:.6f}; launches {cli_launches}; resumed: step "
          f"{dsolver.state.step} -> {resumed.state.step}, loss_u first fresh "
          f"{fresh:.6g}, last {last:.6g}, first resumed {first:.6g}; "
          f"launches {res_launches}")
    if dsolver.state.step != DOPRI5_CLI_ITERS or \
            [r["step"] for r in rec] != list(range(DOPRI5_CLI_ITERS)):
        raise AssertionError(f"{len(rec)} dopri5 records for "
                             f"{DOPRI5_CLI_ITERS} iterations")
    if not all(math.isfinite(r[k]) for r in rec + rec2
               for k in ("loss_u", "loss_v", "rel_err")):
        raise AssertionError("the dopri5 command line logged a non-finite "
                             "loss")
    if len(rec2) != DOPRI5_RESUME_ITERS or \
            resumed.state.step != DOPRI5_CLI_ITERS + DOPRI5_RESUME_ITERS:
        raise AssertionError("the resumed dopri5 run did not continue the "
                             "step count")
    if not abs(first - last) < abs(first - fresh):
        raise AssertionError("the resumed dopri5 loss_u is nearer the fresh "
                             "start's than the last one's")
    if cli_launches != want(DOPRI5_CLI_ITERS) or \
            res_launches != want(DOPRI5_RESUME_ITERS):
        raise AssertionError(f"dopri5 command-line launches {cli_launches}, "
                             f"{res_launches}; expected "
                             f"{want(DOPRI5_CLI_ITERS)}, "
                             f"{want(DOPRI5_RESUME_ITERS)}")
    zero_launches(kernels)
    t = time.perf_counter()
    u_served = resumed.predict(pts)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t
    serve_launches = read_launches(kernels)
    print(f"served the resumed dopri5 primal through predict at "
          f"{pts.shape[0]} points (the dopri5 masked scan) in "
          f"{1e3 * t_serve:.3f} ms; launches {serve_launches}")
    if u_served.shape != (pts.shape[0],) or not bool(
            torch.isfinite(u_served).all()):
        raise AssertionError("the dopri5 primal serves non-finite values")
    if any(serve_launches.values()):
        raise AssertionError(f"dopri5 serving launched {serve_launches}")
    return {"hist": hist, "best": best, "reference": ref,
            "cli_launches": cli_launches, "res_launches": res_launches,
            "solver": solver, "wall_cli_s": t_cli, "serve_ms": 1e3 * t_serve}


def adaptive_checks(dop) -> dict:
    """Phase 2m's first part: on the card, ``integrate_adaptive`` for each
    adaptive method with 2l's trained field on a fresh interior batch of
    the cube (the 2l shapes): f32 against the same call in f64 within
    ``F64_SCALED_TOL`` of the tensor's largest value, and with ``remat``
    (gradients on, so each interval runs under its checkpoint) bitwise
    equal to without. Returns the gaps by method."""
    import copy

    from xnode_wan_tpu_torch import integrate_adaptive
    from xnode_wan_tpu_torch.models.xnode import (field_apply, field_weights,
                                                  lift_apply, path_seed_fn,
                                                  spatial_features)
    from xnode_wan_tpu_torch.ops.integrate import ADAPTIVE_METHODS

    dsolver = dop["solver"]
    cfg, problem = dsolver.cfg, dsolver.problem
    params = dsolver.state.u_params
    p64 = copy.deepcopy(params).double()
    gen = torch.Generator(device=dsolver.device).manual_seed(31)
    batch = dsolver.domain.interior(gen, cfg.N_r)
    xs = batch.space[:, 0, :]
    with torch.no_grad():
        h0 = lift_apply(params, path_seed_fn(batch, problem, cfg)(xs)[:, None])
        xf = spatial_features(xs, cfg.fourier_features)
    args32 = (h0, batch.times, batch.t_start, batch.mask)
    args64 = tuple(a.double() if a.is_floating_point() else a
                   for a in args32)

    def run(p, feats, args, method, remat):
        return integrate_adaptive(
            lambda t, h: field_apply(p, feats, t, h), *args,
            rtol=cfg.ode_rtol, atol=cfg.ode_atol,
            max_steps=cfg.ode_max_steps, remat=remat, method=method,
            closed=(feats, *field_weights(p)))

    f64_gap = {}
    for method in ADAPTIVE_METHODS:
        t = time.perf_counter()
        with torch.no_grad():
            got = run(params, xf, args32, method, False)
            want = run(p64, xf.double(), args64, method, False)
        torch.cuda.synchronize()
        t_f32 = time.perf_counter() - t
        got_remat = run(params, xf, args32, method, True).detach()
        gap = float((got.double() - want).abs().max()
                    / want.abs().max())
        f64_gap[method] = gap
        print(f"  integrate_adaptive {method}, {tuple(got.shape)}: f32 vs "
              f"f64 {gap:.3e} of the largest value; remat bitwise "
              f"{torch.equal(got, got_remat)}; f32 + f64 "
              f"{1e3 * t_f32:.1f} ms")
        if not (bool(torch.isfinite(got).all()) and gap <= F64_SCALED_TOL):
            raise AssertionError(f"integrate_adaptive {method}: f32 leaves "
                                 f"f64 by {gap:.3e} of the largest value")
        if not torch.equal(got, got_remat):
            raise AssertionError(f"integrate_adaptive {method}: remat "
                                 "changed the forward")
    return f64_gap


def solver_runs(kernels, work_root: str, card: str) -> dict:
    """Phase 2m's second part, at the JAX on-chip test's size
    (``SOLVER_CFG``): ``adams`` for ``ADAMS_ITERS`` iterations with its
    final rel-L2 under ``ADAMS_LIMIT``, and every other solver
    ``OTHER_ITERS`` iterations: finite, no kernel launched. Returns each
    run's figures and the adams step (the median of its last three
    iterations, by the host clock its log keeps)."""
    from xnode_wan_tpu_torch import NODEWANSolver, SolverConfig, load_problem

    base = SolverConfig(**SOLVER_CFG)
    sproblem = load_problem("Ex4_1_funcs", dim=base.dim)
    runs = {}
    for name, iters in (("adams", ADAMS_ITERS),
                        *((m, OTHER_ITERS) for m in OTHER_SOLVERS)):
        s = NODEWANSolver(base.replace(solver=name, iterations=iters),
                          sproblem, work_dir=os.path.join(work_root,
                                                          f"2m_{name}"))
        zero_launches(kernels)
        t = time.perf_counter()
        # one iteration a chunk: the log then stamps every iteration's end
        # (phase 5 times the adams step from those stamps)
        m = s.train(report=False, chunk=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = read_launches(kernels)
        runs[name] = {"iterations": s.state.step, "rel_err": m["rel_err"],
                      "loss_u": m["loss_u"], "wall_s": wall}
        if name == "adams":
            stamps = s.logger.times[-4:]
            adams_step_ms = 1e3 * statistics.median(
                b - a for a, b in zip(stamps, stamps[1:]))
        print(f"  {name} at d={base.dim}, N_r={base.N_r}: {s.state.step} "
              f"iterations in {wall:.3f} s ({card}), final rel-L2 "
              f"{m['rel_err']:.6f}, loss_u {m['loss_u']:.6g}; launches "
              f"{launches}")
        if not (math.isfinite(m["loss_u"]) and math.isfinite(m["rel_err"])):
            raise AssertionError(f"{name}: a non-finite loss or rel-L2")
        if any(launches.values()):
            raise AssertionError(f"{name} launched kernels: {launches}")
    if not runs["adams"]["rel_err"] < ADAMS_LIMIT:
        raise AssertionError(f"adams: final rel-L2 {runs['adams']['rel_err']}"
                             f" >= {ADAMS_LIMIT}")
    return {"runs": runs, "adams_step_ms": adams_step_ms}


def adjoint_and_remat(dev, card: str) -> dict:
    """Phase 2n: ``apply_xnode_adjoint`` on a 4,000-path d=5 midpoint batch
    of the cube: its forward bitwise equal to ``apply_xnode`` without
    remat, its parameter gradient within ``ADJOINT_GRAD_RTOL`` (relative,
    in norm) of autograd through the scan; then the peak device memory
    and the time of one backward without remat, with remat and with the
    adjoint at each of ``ADJOINT_LENGTHS`` (the d=5 field, N = 4,000,
    midpoint, uniform times)."""
    from xnode_wan_tpu_torch import (Hypercube, apply_xnode,
                                     apply_xnode_adjoint, init_xnode,
                                     load_params, load_problem)
    from xnode_wan_tpu_torch.models.xnode import (field_apply,
                                                  field_apply_weights,
                                                  field_weights)
    from xnode_wan_tpu_torch.ops.adjoint import make_adjoint_integrator
    from xnode_wan_tpu_torch.ops.integrate import integrate

    cfg = load_params(CONFIG)
    problem = load_problem("Ex4_1_funcs", dim=cfg.dim)
    params = init_xnode(cfg, device=dev)
    leaves = list(params.parameters())
    gen = torch.Generator(device=dev).manual_seed(41)
    batch = Hypercube(cfg.shape_param, cfg.dim, cfg.T0, cfg.T,
                      cfg.N_t).interior(gen, cfg.N_r)
    w = torch.randn(batch.mask.shape, generator=gen, device=dev)
    u_ref = apply_xnode(params, batch, problem, cfg.replace(remat_scan=False))
    u_adj = apply_xnode_adjoint(params, batch, problem, cfg)
    bitwise = torch.equal(u_adj, u_ref)
    g_ref = torch.autograd.grad((u_ref * w).sum(), leaves)
    g_adj = torch.autograd.grad((u_adj * w).sum(), leaves)
    num = math.sqrt(sum(float(((a - b) ** 2).sum())
                        for a, b in zip(g_adj, g_ref)))
    den = math.sqrt(sum(float((b ** 2).sum()) for b in g_ref))
    grad_rel = num / den
    print(f"continuous adjoint, {cfg.solver}, N={cfg.N_r}, L={cfg.N_t}, "
          f"n_sub={cfg.n_sub}: forward bitwise {bitwise}; parameter "
          f"gradient {grad_rel:.3e} from autograd through the scan (relative"
          f", in norm)")
    if not bitwise:
        raise AssertionError("the adjoint's forward is not the scan's")
    if not grad_rel < ADJOINT_GRAD_RTOL:
        raise AssertionError(f"adjoint gradient off by {grad_rel:.3e} >= "
                             f"{ADJOINT_GRAD_RTOL}")

    n, d = cfg.N_r, cfg.dim
    xs = 2.0 * torch.rand((n, d), generator=gen, device=dev) - 1.0
    h0 = 0.1 * torch.randn((n, cfg.u_hidden_dim), generator=gen, device=dev)
    weights = field_weights(params)
    adjoint = make_adjoint_integrator(field_apply_weights, 1, "midpoint")
    memory = {}
    for L in ADJOINT_LENGTHS:
        times = torch.linspace(0.0, 1.0, L, device=dev).expand(n, L)
        t_start = torch.zeros((n,), device=dev)
        mask = torch.ones((n, L), dtype=torch.bool, device=dev)
        wl = torch.randn((n, L, cfg.u_hidden_dim), generator=gen, device=dev)

        def backward(mode):
            if mode == "adjoint":
                hs = adjoint(weights, xs, h0, times, t_start, mask)
            else:
                hs = integrate(lambda t, h: field_apply(params, xs, t, h),
                               h0, times, t_start, mask, n_sub=1,
                               method="midpoint", remat=mode == "remat",
                               closed=weights)
            return torch.autograd.grad((hs * wl).sum(), weights)

        row = {}
        for mode in ("no remat", "remat", "adjoint"):
            backward(mode)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            backward(mode)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            ms = time_ms(lambda: backward(mode), reps=3, warmup=0)
            row[mode] = {"peak_mib": peak / 2 ** 20, "ms": ms}
        memory[L] = row
        print(f"  one backward at L={L}, N={n} ({card}): " + "; ".join(
            f"{k} peak {v['peak_mib']:.1f} MiB, {v['ms']:.1f} ms"
            for k, v in row.items()))
    return {"forward_bitwise": bitwise, "grad_rel": grad_rel,
            "memory": memory}


def integrator_steps(solver, dop, others, work_root: str, card: str):
    """Phase 5's integrator figures: one dopri5 outer step (2l's solver,
    one run) with its u side and boundary scan timed alone (one run
    each), times their calls a step; one adams step at d=2 (the median of
    2m's last three iterations, by the host clock its log keeps, taken by
    :func:`solver_runs`); the cube's midpoint step with ``remat_scan`` on (2b's ``solver``) and
    off (a solver with the same weights), in turns on, off, off, on,
    medians of ``STEP_REPS``."""
    from xnode_wan_tpu_torch import NODEWANSolver, apply_xnode
    from xnode_wan_tpu_torch.ops import weak_form

    cfg, problem = solver.cfg, solver.problem
    dsolver = dop["solver"]
    dcfg, dstate = dsolver.cfg, dsolver.state
    # 2l's and 2m's solvers are warm: no warm-up runs
    dop_step_ms = time_ms(lambda: dsolver._outer_step(), reps=1, warmup=0)
    db, dbb, _ = dsolver._sample(dstate.generator)
    dleaves = list(dstate.u_params.parameters())

    def dop_uside():
        u, du = dsolver._losses.u_side(dstate.u_params, db)
        torch.autograd.grad((u * u).sum() + (du * du).sum(), dleaves)

    def dop_bdry():
        return weak_form.bdry_loss(apply_xnode, dstate.u_params, dbb,
                                   dsolver.problem, dcfg)

    dop_parts = {"u side with its backward": dcfg.n1 * time_ms(
        dop_uside, reps=1, warmup=0)}
    with torch.no_grad():
        dop_parts["u side without gradient"] = time_ms(
            lambda: dsolver._losses.u_side(dstate.u_params, db), reps=1,
            warmup=0)
    dop_parts["boundary scan forward and backward"] = dcfg.n1 * time_ms(
        lambda: torch.autograd.grad(dop_bdry(), dleaves), reps=1, warmup=0)
    adams_step_ms = others["adams_step_ms"]
    rsolver = NODEWANSolver(cfg.replace(remat_scan=False), problem,
                            work_dir=os.path.join(work_root, "5_remat"))
    rsolver.state.u_params.load_state_dict(solver.state.u_params.state_dict())
    rsolver.state.v_params.load_state_dict(solver.state.v_params.state_dict())
    remat_runs = [time_ms(lambda: solver._outer_step(), STEP_REPS, 1),
                  time_ms(lambda: rsolver._outer_step(), STEP_REPS, 1),
                  time_ms(lambda: rsolver._outer_step(), STEP_REPS),
                  time_ms(lambda: solver._outer_step(), STEP_REPS)]
    remat_on_ms = statistics.mean(remat_runs[::3])
    remat_off_ms = statistics.mean(remat_runs[1:3])
    print(f"dopri5 outer step ({card}), one run: {dop_step_ms:.4f} ms; "
          "parts timed alone times their calls a step:")
    for name, ms in dop_parts.items():
        print(f"  {name}: {ms:.4f} ms, {ms / dop_step_ms:.1%}")
    print(f"adams outer step at d=2, N_r={SOLVER_CFG['N_r']} ({card}), "
          f"median of 2m's last 3 iterations (beside phases 2j-2q, "
          f"another process): {adams_step_ms:.4f} ms")
    print(f"cube midpoint outer step ({card}), remat_scan on, off, off, on, "
          f"medians of {STEP_REPS} {remat_runs}: on {remat_on_ms:.4f} ms, off "
          f"{remat_off_ms:.4f} ms")
    return {"dopri5_step_ms": dop_step_ms, "dopri5_parts_ms": dop_parts,
            "adams_step_ms": adams_step_ms,
            "cube_step_ms": {"remat_scan": remat_on_ms,
                             "no_remat": remat_off_ms, "runs": remat_runs}}


def step_parts(solver, reps: int, scan_reps: int):
    """The parts of one outer step of ``solver``, each timed alone (CUDA
    events, a median) on a fresh draw of its batches and multiplied by its
    calls a step: kernels #2-#5, the kernels' tangent inputs, the plain
    boundary scan's forward and backward and the adversary side. Returns
    the parts in ms and the interior and boundary batches."""
    from xnode_wan_tpu_torch import apply_xnode
    from xnode_wan_tpu_torch.ops import weak_form
    from xnode_wan_tpu_torch.ops.kernels import xnode_train

    cfg, problem, state = solver.cfg, solver.problem, solver.state
    batch, bbatch, _ = solver._sample(state.generator)
    net = xnode_train.flat_net(state.u_params)
    packed = net.packed()
    args = [a.contiguous() for a in (
        *xnode_train._prep_intervals(batch.times, batch.mask, batch.t_start,
                                     cfg.n_sub),
        *xnode_train.path_tangent_inputs(batch, problem, cfg))]
    n_sub, method = cfg.n_sub, cfg.solver
    gen = torch.Generator(device=packed.device).manual_seed(9)
    at_exit = bool(getattr(solver.domain, "boundary_at_exit", False))

    def bdry():
        return weak_form.bdry_loss(apply_xnode, state.u_params, bbatch,
                                   problem, cfg, at_exit=at_exit)

    with torch.no_grad():
        states = xnode_train.u_du_fwd_cuda(net, packed, *args, n_sub, method,
                                           store=True)[2:]
        ub = torch.randn(args[0].shape, generator=gen, device=packed.device)
        dub = torch.randn((*args[0].shape, cfg.dim), generator=gen,
                          device=packed.device)
        parts = {
            "xnode_train (#2)": time_ms(lambda: xnode_train.path_forward_cuda(
                net, args[0], args[1], args[2], args[4], n_sub, method,
                packed=packed), reps=reps),
            "xnode_udu_fwd (#3)": time_ms(lambda: xnode_train.u_du_fwd_cuda(
                net, packed, *args, n_sub, method), reps=reps),
            "xnode_udu_fwd_store (#4)": cfg.n1 * time_ms(
                lambda: xnode_train.u_du_fwd_cuda(net, packed, *args, n_sub,
                                                  method, True), reps=reps),
            "xnode_udu_bwd (#5)": cfg.n1 * time_ms(
                lambda: xnode_train.u_du_bwd_cuda(net, packed, *args, *states,
                                                  ub, dub, n_sub, method),
                reps=reps),
            # the u side is taken in each of the n1 primal steps and once
            # for the adversary's
            "tangent inputs of #3-#5": (cfg.n1 + 1) * time_ms(
                lambda: xnode_train.path_tangent_inputs(batch, problem, cfg),
                reps=scan_reps)}
    # the adversary side, once without a graph and n2 times with one
    parts["adversary side (v, phi, grad phi)"] = (1 + cfg.n2) * time_ms(
        lambda: solver._losses.v_side(state.v_params, batch), reps=scan_reps)
    fwd_ms = time_ms(bdry, reps=scan_reps)
    parts["boundary scan forward"] = cfg.n1 * fwd_ms
    parts["boundary scan backward"] = cfg.n1 * (time_ms(
        lambda: torch.autograd.grad(bdry(), list(state.u_params.parameters())),
        reps=scan_reps) - fwd_ms)
    return parts, batch, bbatch


def sync_sites(fn) -> list:
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: the
    ``file:line`` of every call that made the host wait on the card."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
            if "synchronizing CUDA operation" in str(w.message)]


def source_lines(fn) -> set:
    """The ``file:line`` of every line of ``fn``'s source."""
    lines, first = inspect.getsourcelines(fn)
    path = os.path.relpath(inspect.getsourcefile(fn), ROOT)
    return {f"{path}:{first + i}" for i in range(len(lines))}


def chunked_cube(kernels, work_root: str, ref, ref_hist, card: str) -> dict:
    """Phase 2o: ``configs/cube_pde.yaml`` from ``seed`` 0,
    ``train_chunked(CHUNKED_MAX_ITERS, chunk=CHUNK)`` to the 1% stop: the
    stop iteration and the final rel-L2 bitwise 2b's, the checkpoint's
    networks bitwise 2b's stop state, the replay bitwise the chunk's own
    metrics, the launches exact (the chunks run whole, then the replay);
    then the host syncs of one chunk (``sync_sites``: only the metrics'
    copy, and the best weights' copy when they improved, may wait), and
    the chunked loop's time an iteration against one at a time (in turns:
    1, CHUNK, CHUNK, 1)."""
    from xnode_wan_tpu_torch import NODEWANSolver, load_params, load_problem
    from xnode_wan_tpu_torch.training import NODEWANSolver as Solver
    from xnode_wan_tpu_torch.utils import checkpoint as ckpt

    cfg = load_params(CONFIG).replace(seed=SEED)
    problem = load_problem("Ex4_1_funcs", dim=cfg.dim)
    work = os.path.join(work_root, "2o")
    solver = NODEWANSolver(cfg, problem, work_dir=work)
    zero_launches(kernels)
    t = time.perf_counter()
    m = solver.train_chunked(CHUNKED_MAX_ITERS, chunk=CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_launches(kernels)
    n = m["iterations_run"]
    run = chunked_run(n, CHUNKED_MAX_ITERS, CHUNK, None, True)
    want = train_launches_want(run, cfg)
    sd = torch.load(os.path.join(work, "checkpoint_NODE.pt"),
                    map_location="cpu", weights_only=True)["members"][0]
    differ = [f"{net}.{k}" for net, module in (
        ("u_params", ref.state.u_params), ("v_params", ref.state.v_params))
        for k, v in module.state_dict().items()
        if not torch.equal(sd[net][k], v.cpu())]
    print(f"chunked training (train_chunked, chunk {CHUNK}): {n} outer "
          f"iterations to rel-L2 {m['rel_err']!r} in {wall:.3f} s (wall "
          f"clock, {card}); 2b's train_until: {ref_hist['iterations_run']} "
          f"to {ref_hist['rel_err_final']!r}; {run} iterations run; the "
          f"replay bitwise the chunk's own metrics: {solver.replay_bitwise}; "
          f"checkpoint tensors that differ from 2b's stop state: {differ}; "
          f"launches {launches}")
    if n != ref_hist["iterations_run"] or m["rel_err"] != \
            ref_hist["rel_err_final"]:
        raise AssertionError("the chunked run's stop iteration or rel-L2 is "
                             "not 2b's")
    if differ or sd["step"] != n or solver.replay_bitwise is False:
        raise AssertionError("the chunked run's checkpoint is not 2b's stop "
                             "state, or its replay left the chunk's metrics")
    if launches != want:
        raise AssertionError(f"chunked launches {launches}, expected {want}")

    fresh = NODEWANSolver(cfg, problem, work_dir=work + "_syncs")
    fresh.train_chunked(2, chunk=2, log=False)   # the first chunk warms up
    sites = sync_sites(lambda: fresh._chunk(CHUNK, fresh._can_stop()))
    allowed = (source_lines(Solver._host_values)
               | source_lines(ckpt.cpu_parameters))
    print(f"host syncs in one chunk of {CHUNK} iterations on the cube: "
          f"{len(sites)} ({', '.join(sites) or 'none'})")
    if not 1 <= len(sites) <= 2 or not set(sites) <= allowed:
        raise AssertionError(f"a chunk waits on the card at {sites}; only "
                             "its metrics' copy and the best weights' may")

    step_ms = {}
    for label, chunk in (("1", 1), (str(CHUNK), CHUNK), (f"{CHUNK} again",
                                                        CHUNK),
                         ("1 again", 1)):
        timed = NODEWANSolver(cfg, problem, work_dir=work + "_timed")
        timed.train_chunked(1, chunk=1, log=False)
        torch.cuda.synchronize()
        t = time.perf_counter()
        timed.train_chunked(CHUNK, chunk=chunk, log=False)
        torch.cuda.synchronize()
        step_ms[label] = 1e3 * (time.perf_counter() - t) / CHUNK
    print(f"outer iteration ({card}), host clock over {CHUNK} iterations "
          f"after one: " + ", ".join(f"chunk {k} {v:.4f} ms"
                                     for k, v in step_ms.items()))
    return {"solver": solver, "iterations": n, "rel_err": m["rel_err"],
            "run": run, "wall_s": wall, "launches": launches,
            "syncs": sites, "step_ms": step_ms,
            "replay_bitwise": solver.replay_bitwise}


PROFILE_LAUNCHERS = ("xnode_path_fwd_launch", "xnode_udu_fwd_launch",
                     "xnode_udu_fwd_store_launch", "xnode_udu_bwd_launch")


def profile_cli(kernels, cli_main, card: str) -> dict:
    """Phase 2p: the command line on the cube for ``PROFILE_ITERS``
    iterations with ``profile_dir`` set (one iteration a chunk): the
    Chrome trace of iterations [3, 8) exists and names the launchers of
    #2-#5; the launches exact (and #1 once for each report step's plot);
    the card's busy share over the traced window, from the trace's kernel
    events."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_profile_") as work:
        yaml_path = os.path.join(work, "cube_pde_profile.yaml")
        with open(CONFIG) as fh:
            text = fh.read()
        trace_dir = os.path.join(work, "trace")
        with open(yaml_path, "w") as fh:
            fh.write(text.rstrip("\n") + f"\nprofile_dir: {trace_dir}\n")
        zero_launches(kernels)
        t = time.perf_counter()
        out, solver = run_cli(cli_main, [
            "--params", yaml_path, "--funcs", "Ex4_1_funcs", "-w", work,
            "--report_it", "5", "--iterations", str(PROFILE_ITERS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = read_launches(kernels)
        path = os.path.join(trace_dir, "trace.json")
        with open(path) as fh:
            text = fh.read()
    trace = json.loads(text)["traceEvents"]
    named = {n: text.count(f'"{n}"') for n in PROFILE_LAUNCHERS}
    kernel_ev = [e for e in trace if e.get("cat") == "kernel"]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in kernel_ev)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    timed = [e for e in trace if "dur" in e and e.get("ph") == "X"]
    window = (max(e["ts"] + e["dur"] for e in timed)
              - min(e["ts"] for e in timed)) if timed else 0.0
    by_name = {}
    for e in kernel_ev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e.get("dur", 0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    cfg = solver.cfg
    kept = solver.state.step
    want = train_launches_want(
        chunked_run(kept, PROFILE_ITERS, 1, 5,
                    "Stopping Criterion Reached" in out), cfg)
    want["xnode_eval"] = len(range(0, kept, 5))
    print(f"profile_dir: {PROFILE_ITERS} iterations in {wall:.3f} s ({card}); "
          f"trace {len(text)} bytes, launcher names {named}; {len(kernel_ev)} "
          f"kernel events, the card busy {busy / 1e3:.3f} of "
          f"{window / 1e3:.3f} ms traced ({100 * busy / max(window, 1):.2f}%);"
          f" kernel time by name (ms): "
          + "; ".join(f"{k[:60]} {v / 1e3:.3f}" for k, v in top)
          + f"; launches {launches}")
    if not all(named.values()):
        raise AssertionError(f"the trace does not name every launcher: "
                             f"{named}")
    if launches != want:
        raise AssertionError(f"profiled launches {launches}, expected {want}")
    return {"launches": launches, "busy_ms": busy / 1e3,
            "window_ms": window / 1e3, "kernel_events": len(kernel_ev),
            "named": named, "top_ms": {k: v / 1e3 for k, v in top}}


def plots(kernels, solver, card: str) -> dict:
    """Phase 2q: ``proj`` (through the solver's ``_maybe_plot``) on 2o's
    primal at resolution 200: kernel #1 launched once for the 40,000
    points, ``guess_cn.npy`` and ``error_cn.npy`` written, the guess's
    rel-L2 against the exact slice (free coordinates at 0.5) under
    ``PLOT_REL_LIMIT``; a missing matplotlib is printed, and only that is
    caught."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_plots_") as work:
        solver.work_dir = work
        zero_launches(kernels)
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            solver._maybe_plot(solver.state.step, False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = read_launches(kernels)
        guess = np.load(os.path.join(work, "guess_cn.npy"))
        error = np.load(os.path.join(work, "error_cn.npy"))
        png = [f for f in os.listdir(work) if f.endswith(".png")]
    print(buf.getvalue(), end="")
    sol = guess - error
    rel = float(np.sqrt(np.sum(error ** 2) / np.sum(sol ** 2)))
    print(f"plot of 2o's primal at step {solver.state.step}: {guess.size} "
          f"points in {1e3 * wall:.3f} ms ({card}); rel-L2 against the exact "
          f"slice {rel:.6f}; PNG files {png}; launches {launches}")
    if guess.shape != (200, 200) or not np.isfinite(guess).all():
        raise AssertionError("the plot's guess is not a finite 200 x 200 grid")
    if launches != dict({n: 0 for n in kernels}, xnode_eval=1):
        raise AssertionError(f"the plot launched {launches}")
    if not rel < PLOT_REL_LIMIT:
        raise AssertionError(f"the plotted slice's rel-L2 {rel} >= "
                             f"{PLOT_REL_LIMIT}")
    if not png and "No module named 'matplotlib'" not in buf.getvalue():
        raise AssertionError("no PNG, and no missing matplotlib printed")
    return {"rel_err": rel, "points": int(guess.size), "ms": 1e3 * wall,
            "launches": launches, "png": bool(png)}


def mg_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """One rank of phase 2r (spawned): the cube at full width on a mesh of
    two ranks sharing the card over ``gloo``; saves what the parent holds
    against the single-process runs."""
    sys.path.insert(0, ROOT)
    from xnode_wan_tpu_torch import (NODEWANSolver, evaluate_points,
                                     load_params, load_problem,
                                     load_reference_state_dict)
    from xnode_wan_tpu_torch.parallel.mesh import init_distributed

    t_rank = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_distributed("cuda:0", backend="gloo",
                           init_method=f"tcp://localhost:{port}",
                           world_size=world, rank=rank)
    kernels = kernel_table()
    cfg = load_params(CONFIG).replace(seed=SEED)
    problem = load_problem("Ex4_1_funcs", dim=cfg.dim)
    res = {}

    def step(name, c, prob=problem):
        s = NODEWANSolver(c, prob, work_dir=os.path.join(out_dir, name))
        zero_launches(kernels)
        m = s._to_host(s._outer_step())
        torch.cuda.synchronize()
        launches = read_launches(kernels)
        res[name] = {"metrics": m, "launches": dict(launches),
                     "variants": launches.variants,
                     "params": member_params(s, s._owned),
                     "rows": (s.cfg.N_r // s.mesh.shape.get("data", 1),
                              s.cfg.N_b // s.mesh.shape.get("data", 1)),
                     "mesh": dict(s.mesh.shape)}
        return s

    try:
        step("step", cfg)
        s = NODEWANSolver(cfg, problem, work_dir=os.path.join(out_dir, "2r"))
        zero_launches(kernels)
        hist = s.train_until(TRAIN_TOL, MG_MAX_ITERS)
        torch.cuda.synchronize()
        res["until"] = {k: hist[k] for k in ("iterations_run",
                                             "rel_err_final",
                                             "wall_train_s")}
        res["until"]["rel_err"] = hist["rel_err"].tolist()
        launches = read_launches(kernels)
        res["until"]["launches"] = dict(launches)
        res["until"]["variants"] = launches.variants
        step("fused_v", cfg.replace(fused_v=True))
        model = load_reference_state_dict(CKPT, device=dev,
                                          dtype=torch.float32)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        pts = torch.rand((SERVE_POINTS, cfg.dim + 1), generator=gen,
                         device=dev)
        pts[:, 1:] = 2 * pts[:, 1:] - 1
        zero_launches(kernels)
        with torch.no_grad():
            t = time.perf_counter()
            sharded = evaluate_points(model, pts, problem, cfg, mesh=s.mesh)
            torch.cuda.synchronize()
            t_sharded = time.perf_counter() - t
            whole = evaluate_points(model, pts, problem, cfg)
        torch.cuda.synchronize()
        launches = read_launches(kernels)
        res["serve"] = {"bitwise": bool(torch.equal(sharded, whole)),
                        "launches": dict(launches),
                        "variants": launches.variants,
                        "ms": 1e3 * t_sharded}
        step("ensemble", cfg.replace(ensemble=2))
        dcfg = load_params(D20_CONFIG).replace(seed=SEED, tangent_shards=2,
                                               fused_v=True)
        step("tangent", dcfg, load_problem("Ex4_3_consistent", dcfg.dim))
    finally:
        res["wall_s"] = time.perf_counter() - t_rank
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()


def side_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """Phases 2h, 2i and 2m's solver runs (spawned, one process, started
    before 2h): each trains from its own seed and nothing later reads its
    weights, so they run beside 2j-2q, whose loops, like theirs, the host
    paces while the card idles. Prints into ``side.log`` and saves the
    figures into ``side.pt`` in ``out_dir`` (:func:`join_side`)."""
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = kernel_table()
    dev = torch.device("cuda", 0)
    card = card_line()
    res = {}

    def keep(name, out, *launch_keys):
        res[name] = {k: v for k, v in out.items()
                     if k != "solver" and k not in launch_keys}
        for k in launch_keys:
            res[name][k] = (dict(out[k]), out[k].variants)

    with open(os.path.join(out_dir, "side.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        t = time.perf_counter()
        keep("qmc", qmc_cube(kernels, os.path.join(out_dir, "2h"), dev,
                             card), "launches")
        t = phase_done("2h (beside 2j-2q)", t)
        keep("ens", ensemble_d20(kernels, os.path.join(out_dir, "2i"), dev,
                                 card), "launches", "serve_launches")
        t = phase_done("2i (beside 2j-2q)", t)
        print("  the other solvers (2m):")
        res["solvers"] = solver_runs(kernels, out_dir, card)
        phase_done("2m's solver runs (beside 2j-2q)", t)
    torch.save(res, os.path.join(out_dir, "side.pt"))


def join_side(ctx, out_dir: str) -> dict:
    """Wait for :func:`side_rank`, print its log, and return its figures
    with each phase's launches as :class:`Launches`."""
    try:
        join_spawn(ctx)
    finally:
        path = os.path.join(out_dir, "side.log")
        if os.path.exists(path):
            with open(path) as fh:
                print(fh.read(), end="")
    res = torch.load(os.path.join(out_dir, "side.pt"), weights_only=False)
    for out in (res["qmc"], res["ens"]):
        for k in ("launches", "serve_launches"):
            if k in out:
                out[k] = Launches(*out[k])
    return res


def nccl_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """Phase 2r's ``nccl`` world of every card (one on a one-card
    machine): an all-reduce through ``parallel.mesh``, then one outer
    step of the cube on the world's mesh (none for one rank)."""
    sys.path.insert(0, ROOT)
    from xnode_wan_tpu_torch import NODEWANSolver, load_params, load_problem
    from xnode_wan_tpu_torch.parallel.mesh import (all_reduce_sum,
                                                   init_distributed)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_distributed(f"cuda:{rank}",
                           init_method=f"tcp://localhost:{port}",
                           world_size=world, rank=rank)
    try:
        total = all_reduce_sum(torch.ones(1, device=dev), dist.group.WORLD)
        cfg = load_params(CONFIG).replace(seed=SEED)
        s = NODEWANSolver(cfg, load_problem("Ex4_1_funcs", dim=cfg.dim),
                          device=dev, work_dir=os.path.join(out_dir, "nccl"))
        m = s._to_host(s._outer_step())
        torch.save({"backend": dist.get_backend(), "sum": float(total),
                    "metrics": m, "params": member_params(s, [0]),
                    "mesh": None if s.mesh is None else dict(s.mesh.shape)},
                   os.path.join(out_dir, f"nccl{rank}.pt"))
    finally:
        dist.destroy_process_group()


def member_params(solver, members) -> list:
    """The networks of ``members`` as CPU tensors."""
    return [p.detach().cpu() for k in members
            for net in (solver.members[k].u_params,
                        solver.members[k].v_params)
            for p in net.parameters()]


def kernel_table() -> dict:
    """The seven kernels' launch counters by name; #1, #2, #5, #6 and #7
    count their variants together (``_build.KernelVariants``)."""
    from xnode_wan_tpu_torch.ops.kernels import (disc_train, xnode_eval,
                                                 xnode_train)
    return {"xnode_eval": xnode_eval.LAUNCHES,
            "xnode_train": xnode_train.PATH_LAUNCHES,
            "xnode_udu_fwd": xnode_train.FWD_KERNEL,
            "xnode_udu_fwd_store": xnode_train.FWD_STORE_KERNEL,
            "xnode_udu_bwd": xnode_train.BWD_LAUNCHES,
            "disc_fwd": disc_train.FWD_LAUNCHES,
            "disc_bwd": disc_train.BWD_LAUNCHES}


# the process groups started by start_spawn and not yet joined; the script
# ends them on its way out (stop_background)
BACKGROUND = []


def start_spawn(fn, nprocs: int, out_dir: str):
    """``fn(rank, nprocs, port, out_dir)`` in ``nprocs`` fresh processes,
    started and left running; :func:`join_spawn` waits for them."""
    import socket
    import torch.multiprocessing as mp
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.spawn(fn, args=(nprocs, port, out_dir), nprocs=nprocs,
                   join=False)
    BACKGROUND.append(ctx)
    return ctx


def join_spawn(ctx) -> None:
    """Wait for the processes of :func:`start_spawn`; raises if any
    failed."""
    while not ctx.join():
        pass
    BACKGROUND.remove(ctx)


def stop_background() -> None:
    """End every process of :func:`start_spawn` still running."""
    for ctx in BACKGROUND:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    BACKGROUND.clear()



def close_f32(label: str, got, want, rtol: float) -> float:
    """``max |got - want| <= rtol * max |want|``, tensor by tensor."""
    worst = 0.0
    for g, w in zip(got, want):
        scale = float(w.abs().max()) or 1.0
        worst = max(worst, float((g - w).abs().max()) / scale)
    if not worst <= rtol:
        raise AssertionError(f"{label}: {worst:.3e} of the largest value > "
                             f"{rtol}")
    return worst


def multi_gpu(kernels, out: str, started, b_hist, card: str) -> dict:
    """Phase 2r: two ranks on the one card over ``gloo`` (passed
    explicitly: NCCL refuses two ranks on one device), the cube at full
    width, 2,000 interior and 2,000 boundary rows a rank: one outer step
    against one process at the f32 tolerance of
    ``test_one_outer_step_matches_jax[f32_*]`` (1e-4 of each parameter
    tensor's largest value, 1e-5 on the metrics); ``train_until(0.01,
    MG_MAX_ITERS)`` to 1%, beside 2b's iterations; the exact launches a
    rank; a ``fused_v`` step through #6/#7; 65,536 points served on the
    mesh bitwise equal to one process; an ``ensemble: 2`` step (a member
    a rank, through #2-#5) and a ``fused_v`` ``tangent_shards: 2`` step
    at d = 20 (the u side plain, #2 and #6/#7 kept), each with its exact
    launches a rank, against its fused single-process twin and that
    twin's own exact launches; then ``nccl`` on a world of every card.
    The ranks (:func:`mg_rank`) and the ``nccl`` world (:func:`nccl_rank`)
    were started into ``out`` before phase 2h (``started``: their
    :func:`start_spawn` groups) and ran beside 2h-2q; this waits for them
    and holds what they saved."""
    from xnode_wan_tpu_torch import NODEWANSolver, load_params, load_problem

    ranks_ctx, nccl_ctx = started
    join_spawn(ranks_ctx)
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    t_ranks = ranks[0]["wall_s"]
    cfg = load_params(CONFIG).replace(seed=SEED)
    problem = load_problem("Ex4_1_funcs", dim=cfg.dim)

    def twin(c, prob=problem):
        s = NODEWANSolver(c, prob,
                          work_dir=os.path.join(out, "twin", str(len(errs))))
        zero_launches(kernels)
        m = s._to_host(s._outer_step())
        torch.cuda.synchronize()
        return m, s, read_launches(kernels)

    dcfg = load_params(D20_CONFIG).replace(seed=SEED, fused_v=True)
    want_step = train_launches_want(1, cfg)
    want_fv = cli_launches_want(1, cfg, 10 ** 9, 1, False, False)
    # one member's step a rank; the fused twin steps both
    want_twin = {"ensemble": {n: 2 * v for n, v in want_step.items()},
                 "tangent": cli_launches_want(1, dcfg, 10 ** 9, 1, False,
                                              False)}
    # the tangent split's u side is plain: #2 (the metric) and #6/#7 stay
    want_tan = dict(want_twin["tangent"], xnode_udu_fwd=0,
                    xnode_udu_fwd_store=0, xnode_udu_bwd=0)
    errs = {}
    for name, c, prob in (
            ("step", cfg, problem), ("fused_v", cfg.replace(fused_v=True),
                                     problem),
            ("ensemble", cfg.replace(ensemble=2), problem),
            ("tangent", dcfg, load_problem("Ex4_3_consistent", 20))):
        m, s, twin_launches = twin(c, prob)
        if name in want_twin and twin_launches != want_twin[name]:
            raise AssertionError(f"2r {name} twin: launches {twin_launches}, "
                                 f"expected {want_twin[name]}")
        for r, res in enumerate(ranks):
            got = res[name]
            members = [r] if name == "ensemble" else [0]
            worst = close_f32(f"{name} rank {r}", got["params"],
                              member_params(s, members), PARAM_RTOL)
            for k, v in m.items():
                if not abs(got["metrics"][k] - v) <= METRIC_RTOL * abs(v):
                    raise AssertionError(f"{name} rank {r}: {k} "
                                         f"{got['metrics'][k]} vs {v}")
            errs[f"{name} rank {r}"] = worst
        print(f"  {name}: mesh {ranks[0][name]['mesh']}, interior and "
              f"boundary rows a rank {ranks[0][name]['rows']}, parameters within "
              f"{max(errs[f'{name} rank {r}'] for r in range(2)):.3e} of the "
              f"largest value of one process's; launches a rank "
              f"{ranks[0][name]['launches']}, {ranks[1][name]['launches']}")
    none = {n: 0 for n in kernels}
    for r, res in enumerate(ranks):
        n = res["until"]["iterations_run"]
        want = {"step": want_step, "fused_v": want_fv,
                "ensemble": want_step, "tangent": want_tan}
        for name, w in want.items():
            if res[name]["launches"] != w:
                raise AssertionError(f"2r {name} rank {r}: launches "
                                     f"{res[name]['launches']}, expected {w}")
        if res["until"]["launches"] != train_launches_want(n, cfg):
            raise AssertionError(f"2r train_until rank {r}: launches "
                                 f"{res['until']['launches']}")
        if not res["serve"]["bitwise"] or res["serve"]["launches"] != dict(
                none, xnode_eval=2):
            raise AssertionError(f"2r serving rank {r}: {res['serve']}")
    until = ranks[0]["until"]
    if ranks[1]["until"]["rel_err"] != until["rel_err"]:
        raise AssertionError("the two ranks logged other rel-L2s")
    print(f"two ranks on one card (gloo): train_until to rel-L2 "
          f"{until['rel_err_final']:.6f} in {until['iterations_run']} "
          f"iterations (2b: {b_hist['iterations_run']}), "
          f"{until['wall_train_s']:.3f} s (train_until wall clock, {card}); "
          f"launches a rank {ranks[0]['until']['launches']}; served "
          f"{SERVE_POINTS} points on the mesh in "
          f"{ranks[0]['serve']['ms']:.3f} ms (first call), bitwise equal to "
          f"one process: {ranks[0]['serve']['bitwise']}; rank 0 took "
          f"{t_ranks:.3f} s beside phases 2h-2q")
    if not until["rel_err_final"] < TRAIN_TOL:
        raise AssertionError(f"the two-rank cube stopped at rel-L2 "
                             f"{until['rel_err_final']}")

    n_cards = torch.cuda.device_count()
    join_spawn(nccl_ctx)
    nccl = torch.load(os.path.join(out, "nccl0.pt"), weights_only=False)
    m, s, _ = twin(cfg)
    bitwise = all(torch.equal(a, b) for a, b in
                  zip(nccl["params"], member_params(s, [0])))
    worst = close_f32("nccl step", nccl["params"], member_params(s, [0]),
                      PARAM_RTOL)
    print(f"nccl world of {n_cards} card(s): backend {nccl['backend']}, "
          f"all-reduce of ones {nccl['sum']}, mesh {nccl['mesh']}; one step "
          f"against one process: bitwise {bitwise}, within {worst:.3e}")
    if nccl["backend"] != "nccl" or nccl["sum"] != n_cards:
        raise AssertionError(f"the nccl world: {nccl}")
    return {"ranks": ranks, "errs": errs, "nccl_bitwise": bitwise,
            "wall_s": t_ranks}


def chunk_launches_want(n: int, c, chunks: int) -> dict:
    """:func:`train_launches_want` with #3-#5 in ``chunks`` tangent
    chunks: #2 once an iteration, #3 once and #4 and #5 ``n1`` times a
    chunk."""
    want = train_launches_want(n, c)
    for name in ("xnode_udu_fwd", "xnode_udu_fwd_store", "xnode_udu_bwd"):
        want[name] *= chunks
    return want


def check_variants(label: str, launches, want: dict) -> None:
    """Each variant's launches (``{kernel: {variant: count}}``)."""
    for name, counts in want.items():
        if launches.variants[name] != counts:
            raise AssertionError(f"{label}: {name} launched by variant "
                                 f"{launches.variants[name]}, expected "
                                 f"{counts}")


def wide_cube(kernels, work: str, pts, card: str) -> dict:
    """Phase 2s: ``configs/cube_pde.yaml`` with :data:`WIDE` (the widest
    primal the JAX package's Pallas #5 takes at d = 5), seed 0,
    ``train_until(0.01, WIDE_MAX_ITERS)``: the launches of 2b an
    iteration, #5 all in its cluster variant (its 46,337 floats of
    accumulator do not fit beside the block), the least rel-L2
    under ``WIDE_BEST_LIMIT``; then the kept weights served through #1
    at 2a's points: finite and within ``WIDE_SERVE_FACTOR`` times the
    least training rel-L2."""
    from xnode_wan_tpu_torch import (Hypercube, NODEWANSolver,
                                     evaluate_points, load_params,
                                     load_problem, rel_err)
    from xnode_wan_tpu_torch.ops.kernels import xnode_train

    cfg = load_params(CONFIG).replace(seed=SEED, **WIDE)
    problem = load_problem("Ex4_1_funcs", dim=cfg.dim)
    solver = NODEWANSolver(cfg, problem, work_dir=work)
    net = xnode_train.flat_net(solver.state.u_params)
    route = xnode_train.kernel_route(net.dims(), cfg.dim, cfg.solver)
    print(f"wide cube {WIDE}: {net.packed().numel()} weights, kernels "
          f"{route}")
    if route.bwd.variant != "cluster" or route.d_chunk != cfg.dim:
        raise AssertionError(f"the wide cube routes {route}")
    zero_launches(kernels)
    hist = solver.train_until(TRAIN_TOL, WIDE_MAX_ITERS)
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    n = check_until("wide cube (2s)", hist, launches, cfg)
    check_variants("wide cube (2s)", launches, {
        "xnode_train": {"registers": n, "tile": 0},
        "xnode_udu_bwd": {"shared": 0, "cluster": cfg.n1 * n,
                          "global": 0}})
    rel = [float(r) for r in hist["rel_err"]]
    best = min(rel)
    hit = next((i for i, r in enumerate(rel) if r < TRAIN_TOL), None)
    print(f"wide cube: {n} outer iterations, least rel-L2 {best:.6f}, last "
          f"{rel[-1]:.6f}, "
          + (f"1% reached at iteration {hit}" if hit is not None
             else "1% not reached")
          + f", in {hist['wall_train_s']:.3f} s (train_until wall clock, "
          f"{card}); launches {launches}, by variant {launches.variants}")
    if not best < WIDE_BEST_LIMIT:
        raise AssertionError(f"the wide cube's least rel-L2 {best} >= "
                             f"{WIDE_BEST_LIMIT} in {n} iterations")
    cube = Hypercube(cfg.shape_param, cfg.dim, cfg.T0, cfg.T, cfg.N_t)
    zero_launches(kernels)
    with torch.no_grad():
        u = evaluate_points(solver.best_u_params, pts, problem, cfg)
    torch.cuda.synchronize()
    serve = read_launches(kernels)
    served = float(rel_err(u, problem.u_sol(pts),
                           torch.ones_like(u, dtype=torch.bool), cube.V(),
                           cfg.p))
    print(f"wide cube served at {pts.shape[0]} points through #1: rel-L2 "
          f"{served:.6f} (limit {WIDE_SERVE_FACTOR} x {best:.6f}); "
          f"{serve.variants['xnode_eval']}")
    check_served("the wide cube (2s)", serve)
    if not (bool(torch.isfinite(u).all())
            and served < WIDE_SERVE_FACTOR * best):
        raise AssertionError(f"the wide cube serves at rel-L2 {served}")
    return {"hist": hist, "launches": launches, "serve_launches": serve,
            "best": best, "hit": hit, "served": served, "solver": solver,
            "route": route}


def d100_fourier(kernels, work: str, card: str) -> dict:
    """Phase 2t: ``configs/cube_pde.yaml`` at :data:`D100` (d = 100, F =
    300), seed 0, ``N_r = N_b = 4,000``, ``D100_ITERS`` iterations of
    ``train_until``: #1/#2 in their register kernel (its feature columns
    are applied once a path, so F = 300 fits it), #3-#5 at the full d (one
    chunk; the features stay out of their tiles); every rel-L2
    and weight finite (``loss_u`` is not, as in the JAX package: the
    square of the interior term's integral, which carries the cube's
    volume 2^100, overflows f32), the least rel-L2 under the first, exact
    launches by variant;
    then 65,536 points served through #1's register kernel, finite."""
    from xnode_wan_tpu_torch import (Hypercube, NODEWANSolver,
                                     evaluate_points, load_params,
                                     load_problem, rel_err)
    from xnode_wan_tpu_torch.ops.kernels import xnode_train

    cfg = load_params(CONFIG).replace(seed=SEED, **D100)
    problem = load_problem("Ex4_1_funcs", dim=cfg.dim)
    solver = NODEWANSolver(cfg, problem, work_dir=work)
    net = xnode_train.flat_net(solver.state.u_params)
    route = xnode_train.kernel_route(net.dims(), cfg.dim, cfg.solver)
    chunks = cfg.dim // route.d_chunk
    print(f"d={cfg.dim} cube with fourier_features 1 (F={net.F}): kernels "
          f"{route}, {chunks} chunks")
    if route.path != "registers" or chunks != 1:
        raise AssertionError(f"the d=100 cube routes {route}")
    cube = Hypercube(cfg.shape_param, cfg.dim, cfg.T0, cfg.T, cfg.N_t)
    zero_launches(kernels)
    hist = solver.train_until(TRAIN_TOL, D100_ITERS)
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    n = hist["iterations_run"]
    rel = [float(r) for r in hist["rel_err"]]
    want = chunk_launches_want(n, cfg, chunks)
    bwd = route.bwd.variant
    print(f"d={cfg.dim} cube: {n} outer iterations, rel-L2 {rel[0]:.6f} -> "
          f"least {min(rel):.6f}, last {rel[-1]:.6f}, in "
          f"{hist['wall_train_s']:.3f} s (train_until wall clock, {card}); "
          f"launches {launches}, by variant {launches.variants}")
    # loss_u is inf here as in the JAX package: the interior term's
    # log(I^2) takes I with the cube's volume 2^100 (1.3e30), whose square
    # overflows f32; the rel-L2 and the weights stay finite
    weights_ok = all(bool(torch.isfinite(p).all())
                     for net_ in (solver.state.u_params,
                                  solver.state.v_params)
                     for p in net_.parameters())
    print(f"  loss_u finite at {sum(map(math.isfinite, hist['loss_u']))} "
          f"of {n} iterations (domain volume {cube.V():.4g}); weights "
          f"finite: {weights_ok}")
    if not (len(rel) == n == D100_ITERS and weights_ok
            and all(map(math.isfinite, rel))):
        raise AssertionError(f"the d=100 cube: {n} iterations, or a "
                             "non-finite rel-L2 or weight")
    if launches != want:
        raise AssertionError(f"the d=100 cube: launches {launches}, "
                             f"expected {want}")
    check_variants("the d=100 cube (2t)", launches, {
        "xnode_train": {"registers": n, "tile": 0},
        "xnode_udu_bwd": {"shared": 0, "cluster": 0, "global": 0,
                          bwd: want["xnode_udu_bwd"]}})
    if not min(rel) < rel[0]:
        raise AssertionError(f"the d=100 cube's least rel-L2 {min(rel)} is "
                             f"not under its first {rel[0]}")
    g = torch.Generator(device=solver.device).manual_seed(SEED)
    pts = torch.rand((SERVE_POINTS, cfg.dim + 1), generator=g,
                     device=solver.device)
    pts[:, 1:] = cube.bot + pts[:, 1:] * (cube.top - cube.bot)
    pts[:, 0] = cfg.T0 + pts[:, 0] * (cfg.T - cfg.T0)
    zero_launches(kernels)
    with torch.no_grad():
        t = time.perf_counter()
        u = evaluate_points(solver.state.u_params, pts, problem, cfg)
        torch.cuda.synchronize()
        t_serve = time.perf_counter() - t
    serve = read_launches(kernels)
    served = float(rel_err(u, problem.u_sol(pts),
                           torch.ones_like(u, dtype=torch.bool), cube.V(),
                           cfg.p))
    print(f"d={cfg.dim} cube served at {SERVE_POINTS} points through #1's "
          f"register kernel in {1e3 * t_serve:.3f} ms (first call): "
          f"rel-L2 {served:.6f}; {serve.variants['xnode_eval']}")
    check_served("the d=100 cube (2t)", serve)
    if u.shape != (SERVE_POINTS,) or not bool(torch.isfinite(u).all()):
        raise AssertionError("the d=100 cube serves non-finite values")
    return {"hist": hist, "launches": launches, "serve_launches": serve,
            "served": served, "solver": solver, "route": route,
            "chunks": chunks, "pts": pts}


def path_tile_direct(tnet, targs, c):
    """#2's path-tile kernel at any net, at its rule's tile, through its
    launch helper (the wrapper takes it only past the register kernel's
    caps)."""
    from xnode_wan_tpu_torch.ops.kernels import xnode_train
    return xnode_train._path_tile_forward(
        tnet, tnet.packed(), *targs, c.n_sub, c.solver,
        xnode_train.path_tile(tnet.dims(), c.solver))


def serve_tile_direct(tnet, targs, k_steps, c):
    """#1's path-tile kernel at any net, through its launch helper."""
    from xnode_wan_tpu_torch.ops.kernels import xnode_eval, xnode_train
    return xnode_eval._serve_tile(
        tnet, tnet.packed(), *targs, k_steps, c.solver,
        xnode_train.path_tile(tnet.dims(), c.solver))


def variants_run(before: dict, counter) -> list:
    """The variants of ``counter`` (a ``KernelVariants``) launched once
    each since ``before`` (its :meth:`by_variant`), or more than once
    (listed as often)."""
    after = counter.by_variant()
    return [v for v in after for _ in range(after[v] - before[v])]


def d30_cube(kernels, work: str, card: str) -> dict:
    """Phase 2u: ``configs/cube_pde.yaml`` at :data:`D30` (d = 30, H = Hh
    = 48, F = 90), seed 0, ``D30_ITERS`` iterations of ``train_until``:
    #2 in its register kernel (the 48/48 library), #3-#5 at the full d
    with #5's cluster variant, exact launches by variant; every ``loss_u`` finite (the
    interior term, which only #3-#5 compute, gives a gradient at every
    iteration, unlike at 2t's volume), every rel-L2 finite and the least
    under the first."""
    from xnode_wan_tpu_torch import NODEWANSolver, load_params, load_problem
    from xnode_wan_tpu_torch.ops.kernels import xnode_train

    cfg = load_params(CONFIG).replace(seed=SEED, **D30)
    solver = NODEWANSolver(cfg, load_problem("Ex4_1_funcs", dim=cfg.dim),
                           work_dir=work)
    net = xnode_train.flat_net(solver.state.u_params)
    route = xnode_train.kernel_route(net.dims(), cfg.dim, cfg.solver)
    chunks = cfg.dim // route.d_chunk
    print(f"d={cfg.dim} cube at H=Hh=48 with fourier_features 1 (F={net.F}):"
          f" kernels {route}, {chunks} chunks")
    if (route.path != "registers" or chunks != 1
            or route.bwd.variant != "cluster"):
        raise AssertionError(f"the d=30 cube routes {route}")
    zero_launches(kernels)
    hist = solver.train_until(TRAIN_TOL, D30_ITERS)
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    n = hist["iterations_run"]
    rel = [float(r) for r in hist["rel_err"]]
    loss_u = [float(v) for v in hist["loss_u"]]
    want = chunk_launches_want(n, cfg, chunks)
    print(f"d={cfg.dim} cube: {n} outer iterations, rel-L2 {rel[0]:.6f} -> "
          f"least {min(rel):.6f}, last {rel[-1]:.6f}, loss_u {loss_u[0]:.6g}"
          f" -> {loss_u[-1]:.6g}, in {hist['wall_train_s']:.3f} s "
          f"(train_until wall clock, {card}); launches {launches}, by "
          f"variant {launches.variants}")
    if not (len(rel) == n == D30_ITERS and all(map(math.isfinite, rel))
            and all(map(math.isfinite, loss_u))):
        raise AssertionError(f"the d=30 cube: {n} iterations, or a "
                             "non-finite rel-L2 or loss_u")
    if launches != want:
        raise AssertionError(f"the d=30 cube: launches {launches}, "
                             f"expected {want}")
    check_variants("the d=30 cube (2u)", launches, {
        "xnode_train": {"registers": n, "tile": 0},
        "xnode_udu_bwd": {"shared": 0, "cluster": want["xnode_udu_bwd"],
                          "global": 0}})
    if not min(rel) < rel[0]:
        raise AssertionError(f"the d=30 cube's least rel-L2 {min(rel)} is "
                             f"not under its first {rel[0]}")
    return {"hist": hist, "launches": launches, "solver": solver,
            "route": route, "chunks": chunks}


def wide128_cube(kernels, work: str, card: str) -> dict:
    """Phase 2x: ``configs/cube_pde.yaml`` at :data:`WIDE128` (H = Hh =
    128, d = 5), seed 0, ``WIDE128_ITERS`` iterations of ``train_until``:
    #2 once an iteration in the path-tile kernel, #3-#5 on the route's
    tiles (#5 on clusters), exact launches by variant; every loss and
    rel-L2 finite, the least rel-L2 under the first. Then 65,536 points
    served through ``evaluate_points`` (#1's path-tile kernel, once) and
    held against ``evaluate_plain`` on the same card inputs at ``RTOL,
    ATOL``."""
    from xnode_wan_tpu_torch import (Hypercube, NODEWANSolver,
                                     evaluate_points, load_params,
                                     load_problem)
    from xnode_wan_tpu_torch.ops.kernels import xnode_eval, xnode_train

    cfg = load_params(CONFIG).replace(seed=SEED, **WIDE128)
    problem = load_problem("Ex4_1_funcs", dim=cfg.dim)
    solver = NODEWANSolver(cfg, problem, work_dir=work)
    net = xnode_train.flat_net(solver.state.u_params)
    route = xnode_train.kernel_route(net.dims(), cfg.dim, cfg.solver)
    chunks = cfg.dim // route.d_chunk
    print(f"the 128/128 cube: {net.packed().numel()} weights, kernels "
          f"{route}, {chunks} chunks")
    if route.path != "tile" or chunks != 1:
        raise AssertionError(f"the 128/128 cube routes {route}")
    zero_launches(kernels)
    hist = solver.train_until(TRAIN_TOL, WIDE128_ITERS)
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    n = hist["iterations_run"]
    rel = [float(r) for r in hist["rel_err"]]
    losses = {k: [float(v) for v in hist[k]] for k in ("loss_u", "L2")}
    want = chunk_launches_want(n, cfg, chunks)
    bwd = route.bwd.variant
    print(f"the 128/128 cube: {n} outer iterations, rel-L2 {rel[0]:.6f} -> "
          f"least {min(rel):.6f}, last {rel[-1]:.6f}, loss_u "
          f"{losses['loss_u'][0]:.6g} -> {losses['loss_u'][-1]:.6g}, in "
          f"{hist['wall_train_s']:.3f} s (train_until wall clock, {card}); "
          f"launches {launches}, by variant {launches.variants}")
    if not (len(rel) == n == WIDE128_ITERS and all(map(math.isfinite, rel))
            and all(math.isfinite(v) for vs in losses.values()
                    for v in vs)):
        raise AssertionError(f"the 128/128 cube: {n} iterations, or a "
                             "non-finite rel-L2 or loss")
    if launches != want:
        raise AssertionError(f"the 128/128 cube: launches {launches}, "
                             f"expected {want}")
    check_variants("the 128/128 cube (2x)", launches, {
        "xnode_train": {"registers": 0, "tile": n},
        "xnode_udu_bwd": {"shared": 0, "cluster": 0, "global": 0,
                          bwd: want["xnode_udu_bwd"]}})
    if not min(rel) < rel[0]:
        raise AssertionError(f"the 128/128 cube's least rel-L2 {min(rel)} is "
                             f"not under its first {rel[0]}")
    cube = Hypercube(cfg.shape_param, cfg.dim, cfg.T0, cfg.T, cfg.N_t)
    g = torch.Generator(device=solver.device).manual_seed(SEED)
    pts = torch.rand((SERVE_POINTS, cfg.dim + 1), generator=g,
                     device=solver.device)
    pts[:, 1:] = cube.bot + pts[:, 1:] * (cube.top - cube.bot)
    pts[:, 0] = cfg.T0 + pts[:, 0] * (cfg.T - cfg.T0)
    k_steps = max(cfg.min_steps, cfg.N_t) * cfg.n_sub
    x_pts = pts[:, 1:].contiguous()
    t_s = torch.full_like(pts[:, 0], cfg.T0)
    serve_args = (x_pts, pts[:, 0].contiguous(), t_s,
                  (problem.h(torch.cat([t_s[:, None], x_pts], dim=-1))
                   / cfg.u_scale_eff).contiguous())
    zero_launches(kernels)
    with torch.no_grad():
        t = time.perf_counter()
        u = evaluate_points(solver.state.u_params, pts, problem, cfg)
        torch.cuda.synchronize()
        t_serve = time.perf_counter() - t
    serve = read_launches(kernels)
    with torch.no_grad():
        plain = xnode_eval.evaluate_plain(net, *serve_args, k_steps,
                                          cfg.solver) * cfg.u_scale_eff
    print(f"the 128/128 cube served at {SERVE_POINTS} points through #1's "
          f"path-tile kernel in {1e3 * t_serve:.3f} ms (first call); "
          f"{serve.variants['xnode_eval']}")
    if serve.variants["xnode_eval"] != {"registers": 0, "tile": 1}:
        raise AssertionError("serving the 128/128 cube did not launch #1's "
                             "path-tile kernel once")
    err = compare(f"the 128/128 cube served through #1's path-tile kernel, "
                  f"M={SERVE_POINTS}", u, plain)
    return {"hist": hist, "launches": launches, "serve_launches": serve,
            "solver": solver, "route": route, "chunks": chunks,
            "serve_err": err, "serve_args": serve_args, "k_steps": k_steps}


def adv_launches_want(n: int, c, chunks: int, route) -> tuple:
    """The launches of ``n`` ``fused_v`` outer iterations with #3-#5 in
    ``chunks`` tangent chunks (:func:`chunk_launches_want`), #6 ``1 + n2``
    and #7 ``n2`` times an iteration, and #6's and #7's launches by
    variant for the adversary's ``disc_route``."""
    want = chunk_launches_want(n, c, chunks)
    want.update(disc_fwd=(1 + c.n2) * n, disc_bwd=c.n2 * n)
    fwd = {"registers": 0, "tile": 0, route.fwd: want["disc_fwd"]}
    bwd = {"shared": 0, "cluster": 0, "global": 0,
           route.bwd: want["disc_bwd"]}
    return want, {"disc_fwd": fwd, "disc_bwd": bwd}


def step_against_plain(label: str, fused, plain) -> tuple:
    """After one outer step of each solver from the same weights and
    batch: each gradient (Adam's first moment) within ``PARAM_RTOL`` of
    its tensor's largest value, and each parameter too, except those whose
    gradient is under ``ADAM_GRAD_SHARE`` of its tensor's largest in
    either run (:data:`ADAM_GRAD_SHARE`). Returns the worst share and the
    count of parameters beyond ``PARAM_RTOL`` that this leaves out."""
    worst, n_eps = 0.0, 0
    for net in ("u", "v"):
        pairs = zip(getattr(fused.state, f"{net}_params").parameters(),
                    getattr(plain.state, f"{net}_params").parameters())
        for a, b in pairs:
            ga = getattr(fused.state, f"opt_{net}").state[a]["exp_avg"]
            gb_ = getattr(plain.state, f"opt_{net}").state[b]["exp_avg"]
            worst = max(worst, close_f32(f"{label}: the fused_v step's "
                                         "gradient", [ga], [gb_],
                                         PARAM_RTOL))
            floor = ADAM_GRAD_SHARE * float(gb_.abs().max())
            keep = (ga.abs() >= floor) & (gb_.abs() >= floor)
            scale = float(b.detach().abs().max()) or 1.0
            off = (a - b).detach().abs() > PARAM_RTOL * scale
            n_eps += int((off & ~keep).sum())
            err = float(((a - b).detach().abs() * keep).max()) / scale
            if not err <= PARAM_RTOL:
                raise AssertionError(f"{label}: the fused_v step's parameter "
                                     f"{tuple(a.shape)} {err:.3e} of its "
                                     f"largest value > {PARAM_RTOL}")
            worst = max(worst, err)
    return worst, n_eps


def fused_adversary(kernels, work: str, label: str, over: dict,
                    variants: tuple, card: str) -> dict:
    """Phases 2v and 2w: ``configs/cube_pde.yaml`` with ``over`` (which
    sets ``fused_v``), seed 0. First one outer step through #6/#7 against
    the same step with the plain adversary, from the same weights and
    batch: every parameter within ``PARAM_RTOL`` of its tensor's largest
    value, every metric within ``METRIC_RTOL``, #6 and #7 launched in the
    ``variants`` (#6's, #7's) that ``disc_route`` picks and nothing else.
    Then ``ADV_ITERS`` iterations of ``train_until``: every ``loss_u``,
    L2 and rel-L2 finite, every weight finite, the least rel-L2 under the
    first, the launches exact by variant."""
    from xnode_wan_tpu_torch import NODEWANSolver, load_params, load_problem
    from xnode_wan_tpu_torch.ops.kernels import disc_train, xnode_train

    cfg = load_params(CONFIG).replace(seed=SEED, **over)
    problem = load_problem("Ex4_1_funcs", dim=cfg.dim)
    solvers = {fv: NODEWANSolver(cfg.replace(fused_v=fv), problem,
                                 work_dir=os.path.join(work, str(fv)))
               for fv in (True, False)}
    geom = disc_train.geom_of(solvers[True].state.v_params, cfg.v_layers,
                              cfg.tied_v)
    route = disc_train.disc_route(geom)
    u_route = xnode_train.kernel_route(xnode_train.flat_net(
        solvers[True].state.u_params).dims(), cfg.dim, cfg.solver)
    chunks = cfg.dim // u_route.d_chunk
    print(f"{label}: adversary {geom} ({geom.n_params} weights), kernels "
          f"{route}; primal kernels {u_route}")
    if (route.fwd, route.bwd) != variants:
        raise AssertionError(f"{label}: the adversary routes {route}, "
                             f"expected {variants}")
    if not all(torch.equal(a, b) for a, b in zip(
            member_params(solvers[True], [0]),
            member_params(solvers[False], [0]))):
        raise AssertionError(f"{label}: the fused and plain solvers start "
                             "from different weights")
    metrics, step_launches = {}, {}
    for fv, s in solvers.items():
        zero_launches(kernels)
        metrics[fv] = s._to_host(s._outer_step())
        torch.cuda.synchronize()
        step_launches[fv] = read_launches(kernels)
    worst, n_eps = step_against_plain(label, solvers[True], solvers[False])
    for k, v in metrics[False].items():
        if not abs(metrics[True][k] - v) <= METRIC_RTOL * abs(v):
            raise AssertionError(f"{label}: the fused_v step's {k} "
                                 f"{metrics[True][k]} against the plain "
                                 f"{v}")
    want, want_var = adv_launches_want(1, cfg, chunks, route)
    plain_want = dict(want, disc_fwd=0, disc_bwd=0)
    if step_launches[True] != want or step_launches[False] != plain_want:
        raise AssertionError(f"{label}: step launches fused "
                             f"{step_launches[True]}, plain "
                             f"{step_launches[False]}, expected {want}, "
                             f"{plain_want}")
    check_variants(f"{label}: the fused_v step", step_launches[True],
                   want_var)
    print(f"{label}: one fused_v outer step against the plain one from the "
          f"same weights and batch: gradients and parameters within "
          f"{worst:.3e} of each tensor's largest value ({n_eps} parameters "
          f"beyond {PARAM_RTOL}, each at a gradient under "
          f"{ADAM_GRAD_SHARE:g} of its tensor's largest, left out), "
          f"metrics within {METRIC_RTOL}; #6 and #7 by variant "
          f"{step_launches[True].variants['disc_fwd']}, "
          f"{step_launches[True].variants['disc_bwd']}")
    del solvers
    solver = NODEWANSolver(cfg, problem,
                           work_dir=os.path.join(work, "until"))
    zero_launches(kernels)
    hist = solver.train_until(TRAIN_TOL, ADV_ITERS)
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    n = hist["iterations_run"]
    rel = [float(r) for r in hist["rel_err"]]
    print(f"{label}: {n} outer iterations, rel-L2 {rel[0]:.6f} -> least "
          f"{min(rel):.6f}, last {rel[-1]:.6f}, loss_u "
          f"{hist['loss_u'][0]:.6g} -> {hist['loss_u'][-1]:.6g}, in "
          f"{hist['wall_train_s']:.3f} s (train_until wall clock, {card}); "
          f"launches {launches}, by variant {launches.variants}")
    finite = all(math.isfinite(float(v)) for k in ("loss_u", "L2", "rel_err")
                 for v in hist[k])
    weights = all(bool(torch.isfinite(p).all()) for p in
                  member_params(solver, [0]))
    if not (len(rel) == n == ADV_ITERS and finite and weights):
        raise AssertionError(f"{label}: {n} iterations, or a non-finite "
                             "loss_u, L2, rel-L2 or weight")
    want, want_var = adv_launches_want(n, cfg, chunks, route)
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    check_variants(label, launches, want_var)
    if not min(rel) < rel[0]:
        raise AssertionError(f"{label}: the least rel-L2 {min(rel)} is not "
                             f"under the first {rel[0]}")
    return {"hist": hist, "launches": launches, "solver": solver,
            "route": route, "geom": geom, "step_rel": worst, "cfg": cfg,
            "step_launches": step_launches[True]}


def bwd_key(tile) -> str:
    """:func:`path_work`'s key for #5 in ``tile``'s variant."""
    return ("xnode_udu_bwd cluster" if tile.variant == "cluster"
            else "xnode_udu_bwd")


def global_tile(dims, d: int, method: str):
    """#5's global-accumulator variant's block at a net: the tile its
    route would take were the shared and cluster variants not there."""
    from xnode_wan_tpu_torch.ops.kernels import steppers, xnode_train
    for tile in xnode_train.BWD_TILES:
        if (xnode_train.tile_smem_bytes(dims, d, method, tile, True,
                                        "global")
                <= steppers.MAX_SMEM_BYTES):
            return xnode_train.GradTile(tile, xnode_train.block_threads(
                tile, d, dims[1], True), "global")
    raise AssertionError(f"#5's global variant does not fit {dims}, d={d}")


def bwd_direct(tile, net, packed, args, states, ub, dub, n_sub, method):
    """#5 through the launcher of ``tile``'s variant at that tile and its
    persistent grid (the wrapper launches the route's variant only)."""
    from xnode_wan_tpu_torch.ops.kernels import steppers, xnode_train
    dev = args[0].device
    N, L = args[0].shape
    d = args[-1].shape[1]
    grid = xnode_train.bwd_grid(net.dims(), N, d, method, tile, dev)
    part = torch.empty((grid, packed.numel()), device=dev)
    grad = torch.empty((packed.numel(),), device=dev)
    kernel = xnode_train.BWD_LAUNCHES.variants[tile.variant]
    extra = (tile.cluster,) if tile.variant == "cluster" else ()
    kernel(dev, packed.data_ptr(), packed.numel(),
           *(a.data_ptr() for a in (*args, *states, ub, dub, part, grad)),
           N, L, d, *net.dims(), n_sub, steppers.METHOD_IDS[method],
           tile.paths, tile.threads, grid, *extra)
    return grad


def variant_checks(*, L, N, batch, batch20, cfg, cfg20, check_udu,
                    check_udu_near_kinks,
                    cube, d, dev, errs, eval_args, hd, hu, hx, in20, k_steps,
                    net,
                    net_tr, path_seed, problem, pts, tan_inputs, wide,
                    xs) -> dict:
    """Phase 3's checks of the kernel variants: #1/#2's path-tile
    kernel at 2x's trained net and at d = 5 with H = 96, Hh = 64 (their
    route), and through its launch helper at 2t's net and at the cube's,
    #2 at N_r, N_r + 1 and 37 paths (the cube's at N_r), #1 at 65,536
    points; #1/#2's register kernel at 2t's, 2u's and the cube's nets;
    each twice, bitwise; #5's cluster
    variant at 2s's trained net, and at random weights at its shape and
    at 2u's chunk (the global variant too), each at three path counts,
    twice, bitwise, by the kink rule; #5's global variant at 2s's trained
    net by the kink rule; #5's global
    accumulator bitwise equal to the shared one at the same tile and
    grid; #3-#5 at the full d of 2t's, 2u's and 2i's nets and of the
    cube's widths at d = 50 against their plain versions, #4 and #5 twice,
    bitwise; #3-#5 in tangent chunks against
    the full d. Takes the names of ``main`` these read; returns what
    phase 4 times."""
    from xnode_wan_tpu_torch import Hypercube, init_xnode, load_problem
    from xnode_wan_tpu_torch.models.xnode import spatial_features
    from xnode_wan_tpu_torch.ops.kernels import (steppers, xnode_eval,
                                                 xnode_train)
    from xnode_wan_tpu_torch.ops.kernels.steppers import FlatNet
    # the kernel variants: #1/#2's path-tile variant, #5's cluster and
    # global variants, #3-#5 in tangent chunks
    print("kernel variants vs plain, f32:")
    from xnode_wan_tpu_torch.models.xnode import path_seed_fn
    var_errs = {}

    def note(key, err):
        var_errs[key] = max(var_errs.get(key, 0.0), err)
        return err

    def path_inputs(b, prob, c):
        """#2's ``(t0, dt, feats, seed)`` on a batch."""
        xs_b = b.space[:, 0, :].contiguous()
        t0_b, dt_b = xnode_train._prep_intervals(b.times, b.mask, b.t_start,
                                                 c.n_sub)
        return (t0_b.contiguous(), dt_b.contiguous(),
                spatial_features(xs_b, c.fourier_features).contiguous(),
                path_seed_fn(b, prob, c)(xs_b).contiguous())

    def serve_inputs(p_pts, prob, c):
        """#1's ``(feats, t, t_start, seed)`` at points, from T0."""
        x_p = p_pts[:, 1:].contiguous()
        t_s = torch.full_like(p_pts[:, 0], c.T0)
        return (spatial_features(x_p, c.fourier_features).contiguous(),
                p_pts[:, 0].contiguous(), t_s,
                (prob.h(torch.cat([t_s[:, None], x_p], -1))
                 / c.u_scale_eff).contiguous())

    t0_main, dt_main = [a.contiguous() for a in xnode_train._prep_intervals(
        batch.times, batch.mask, batch.t_start, cfg.n_sub)]
    main_path = (t0_main, dt_main, xs, path_seed)
    hsolver, wsolver = hd["solver"], wide["solver"]
    t_cfg, wcfg = hsolver.cfg, wsolver.cfg
    t_net = xnode_train.flat_net(hsolver.state.u_params)
    wnet = xnode_train.flat_net(wsolver.state.u_params)
    hcube = Hypercube(t_cfg.shape_param, t_cfg.dim, t_cfg.T0, t_cfg.T,
                      t_cfg.N_t)
    gv = torch.Generator(device=dev).manual_seed(15)
    cfg96 = cfg.replace(**NET96)
    net96 = xnode_train.flat_net(init_xnode(cfg96, gv))
    xsolver, rsolver = hx["solver"], hu["solver"]
    x_cfg, r_cfg = xsolver.cfg, rsolver.cfg
    x_net = xnode_train.flat_net(xsolver.state.u_params)
    r_net = xnode_train.flat_net(rsolver.state.u_params)
    r_dom = Hypercube(r_cfg.shape_param, r_cfg.dim, r_cfg.T0, r_cfg.T,
                      r_cfg.N_t)
    hk = max(t_cfg.min_steps, t_cfg.N_t) * t_cfg.n_sub
    rk = max(r_cfg.min_steps, r_cfg.N_t) * r_cfg.n_sub
    with torch.no_grad():
        hb = hcube.interior(gv, t_cfg.N_r)
        h_path = path_inputs(hb, hsolver.problem, t_cfg)
        h_serve = serve_inputs(hd["pts"], hsolver.problem, t_cfg)
        b96 = cube.interior(gv, cfg.N_r)
        # the other paths and points of these checks come from a generator
        # of their own, so that every later check draws from gv what it
        # drew before they were added
        gt = torch.Generator(device=dev).manual_seed(16)

        def three_counts(dom, prob, c, first=None):
            """#2's inputs on N_r (``first`` if given), N_r + 1 and 37
            fresh interior paths."""
            return [first or path_inputs(dom.interior(gt, c.N_r), prob, c)] + [
                path_inputs(dom.interior(gt, n), prob, c)
                for n in (c.N_r + 1, 37)]

        x_paths = three_counts(cube, xsolver.problem, x_cfg)
        p96 = three_counts(cube, problem, cfg96,
                           path_inputs(b96, problem, cfg96))
        t_paths = three_counts(hcube, hsolver.problem, t_cfg, h_path)
        r_path = path_inputs(r_dom.interior(gt, r_cfg.N_r), rsolver.problem,
                             r_cfg)
        r_pts = torch.rand((SERVE_POINTS, r_cfg.dim + 1), generator=gt,
                           device=dev)
        r_pts[:, 1:] = r_dom.bot + r_pts[:, 1:] * (r_dom.top - r_dom.bot)
        r_pts[:, 0] = r_cfg.T0 + r_pts[:, 0] * (r_cfg.T - r_cfg.T0)
        r_serve = serve_inputs(r_pts, rsolver.problem, r_cfg)
        s96 = serve_inputs(pts, problem, cfg96)
        # the wrappers route 2x's net and 96/64 to the path-tile kernel and
        # 2t's, 2u's and the cube's nets to the register kernel; the
        # path-tile kernel at 2t's and the cube's nets is launched through
        # its helper; each launched twice, bitwise
        tiles = []
        for name, tnet, runs, c in (("2x's net (128/128)", x_net, x_paths,
                                     x_cfg),
                                    ("d=5 H=96 Hh=64 (random weights)", net96,
                                     p96, cfg96)):
            tiles += [(f"{name} N={a[0].shape[0]}", tnet, a, c, "tile", False)
                      for a in runs]
        tiles += [(f"2t's net (F={t_net.F}) N={a[0].shape[0]}, launched "
                   "directly", t_net, a, t_cfg, "tile", True)
                  for a in t_paths]
        tiles += [
            (f"the cube's net N={cfg.N_r}, launched directly", net,
             main_path, cfg, "tile", True),
            (f"2t's net (F={t_net.F}) N={t_cfg.N_r} L={t_cfg.N_t}", t_net,
             h_path, t_cfg, "registers", False),
            (f"2u's net (48/48, F={r_net.F}) N={r_cfg.N_r}", r_net, r_path,
             r_cfg, "registers", False),
            (f"the cube's net N={cfg.N_r}", net, main_path, cfg,
             "registers", False)]
        for label, tnet, targs, c, want_v, direct in tiles:
            before = xnode_train.PATH_LAUNCHES.by_variant()
            got, again = [
                path_tile_direct(tnet, targs, c) if direct else
                xnode_train.path_forward_cuda(tnet, *targs, c.n_sub, c.solver)
                for _ in range(2)]
            ran = variants_run(before, xnode_train.PATH_LAUNCHES)
            if ran != [want_v, want_v]:
                raise AssertionError(f"xnode_train {label}: ran {ran}, "
                                     f"expected two {want_v} launches")
            if not torch.equal(got, again):
                raise AssertionError(f"xnode_train {want_v} {label}: two "
                                     "launches differ")
            errs["xnode_train"] = max(errs["xnode_train"], note(
                f"xnode_train {want_v}", compare(
                    f"xnode_train {want_v} variant, {label}, twice bitwise",
                    got, xnode_train.path_forward_plain(tnet, *targs, c.n_sub,
                                                        c.solver))))
        serves = [
            (f"2x's net (128/128) M={SERVE_POINTS}", x_net, hx["serve_args"],
             x_cfg, hx["k_steps"], "tile", False),
            (f"d=5 H=96 Hh=64 M={SERVE_POINTS}", net96, s96, cfg96, k_steps,
             "tile", False),
            (f"2t's net M={SERVE_POINTS} k_steps={hk}, launched directly",
             t_net, h_serve, t_cfg, hk, "tile", True),
            (f"the cube's net M={SERVE_POINTS}, launched directly", net,
             eval_args, cfg, k_steps, "tile", True),
            (f"2t's net M={SERVE_POINTS} k_steps={hk}", t_net, h_serve,
             t_cfg, hk, "registers", False),
            (f"2u's net M={SERVE_POINTS} k_steps={rk}", r_net, r_serve,
             r_cfg, rk, "registers", False)]
        for label, tnet, targs, c, k, want_v, direct in serves:
            before = xnode_eval.LAUNCHES.by_variant()
            got, again = [
                serve_tile_direct(tnet, targs, k, c) if direct else
                xnode_eval.evaluate_cuda(tnet, *targs, k, c.solver)
                for _ in range(2)]
            ran = variants_run(before, xnode_eval.LAUNCHES)
            if ran != [want_v, want_v]:
                raise AssertionError(f"xnode_eval {label}: ran {ran}, "
                                     f"expected two {want_v} launches")
            if not torch.equal(got, again):
                raise AssertionError(f"xnode_eval {want_v} {label}: two "
                                     "launches differ")
            errs["xnode_eval"] = max(errs["xnode_eval"], note(
                f"xnode_eval {want_v}", compare(
                    f"xnode_eval {want_v} variant, {label}, twice bitwise",
                    got, xnode_eval.evaluate_plain(tnet, *targs, k,
                                                   c.solver))))

        # #5's cluster variant (and #3/#4) at 2s's trained net, and at
        # random weights (live relus) at its shape and at 2u's chunk (15 of
        # d = 30, F = 90), each at N_r, N_r + 1 and 37 paths, #5 twice,
        # bitwise
        usolver = hu["solver"]
        u_cfg, dc_u = usolver.cfg, hu["route"].d_chunk
        u_dom = Hypercube(u_cfg.shape_param, u_cfg.dim, u_cfg.T0, u_cfg.T,
                          u_cfg.N_t)

        def udu_args(dom, prob, c, n_p, dc):
            """#3-#5's inputs on ``n_p`` interior paths, the tangents cut
            to their first ``dc`` directions."""
            b = dom.interior(gv, n_p)
            t0_b, dt_b = [a.contiguous() for a in xnode_train._prep_intervals(
                b.times, b.mask, b.t_start, c.n_sub)]
            tan = [a.contiguous() for a in xnode_train.path_tangent_inputs(
                b, prob, c)]
            return (t0_b, dt_b, tan[0], tan[1][:, :dc].contiguous(), tan[2],
                    tan[3][:, :dc].contiguous())

        def cluster_random(label, cnet, cargs, c):
            """#5's cluster variant at random weights, by the kink rule:
            the paths at least ``KINK_MARGIN`` from a relu kink against
            the plain version (``check_udu``, #3/#4 too), all paths
            against it at ``KINK_RTOL``, and the global variant, launched
            directly, against it on all paths at ``KINK_RTOL`` too; the
            cluster variant against the global one on all paths at
            ``SCALED_RTOL`` (their forwards sum in the same order); twice,
            bitwise. At random weights about 40% of the paths pass within
            1e-5 of a kink, and at some of them the plain version's f32
            order takes the other branch than the kernels' FP32 forward."""
            c64 = FlatNet([a.double() for a in cnet.flat], cnet.n_lift,
                          cnet.n_field)
            t0_, dt_, feats_, _, seed_, dd = cargs
            keep = xnode_train.relu_margins(
                c64, t0_.double(), dt_.double(), feats_.double(),
                seed_.double(), c.n_sub, c.solver) >= KINK_MARGIN
            n_p = keep.numel()
            print(f"  {label}: {int((~keep).sum())} of {n_p} paths come "
                  f"within {KINK_MARGIN} of a relu kink")
            check_udu(f"{label} N={int(keep.sum())}", cnet,
                      [a[keep].contiguous() for a in cargs], c.n_sub,
                      c.solver)
            want = xnode_train.u_du_fwd_plain(cnet, *cargs, c.n_sub,
                                              c.solver, store=True)
            cgr = torch.Generator(device=dev).manual_seed(7)
            ubr = torch.randn(t0_.shape, generator=cgr, device=dev)
            dubr = torch.randn((*t0_.shape, dd.shape[1]), generator=cgr,
                               device=dev)
            packed_c = cnet.packed()
            runs = [xnode_train.u_du_bwd_cuda(
                cnet, packed_c, *cargs, *want[2:], ubr, dubr, c.n_sub,
                c.solver) for _ in range(2)]
            if not torch.equal(runs[0], runs[1]):
                raise AssertionError(f"xnode_udu_bwd {label}: two launches "
                                     "differ")
            g_glob = bwd_direct(global_tile(cnet.dims(), dd.shape[1],
                                            c.solver), cnet, packed_c,
                                cargs, want[2:], ubr, dubr, c.n_sub,
                                c.solver)
            g_plain = xnode_train.u_du_bwd_plain(
                cnet, *cargs, *want[2:], ubr, dubr, c.n_sub, c.solver)
            sizes = [a.numel() for a in cnet.flat]
            errs["xnode_udu_bwd"] = max(errs["xnode_udu_bwd"], note(
                "xnode_udu_bwd cluster vs global", compare_scaled(
                    f"xnode_udu_bwd cluster vs global {label}, all {n_p} "
                    "paths", runs[0], g_glob, sizes)))
            for name, g in (("cluster", runs[0]), ("global", g_glob)):
                compare_scaled(f"xnode_udu_bwd {name} vs plain {label}, all "
                               f"{n_p} paths", g, g_plain, sizes,
                               limit=KINK_RTOL)
            print(f"  xnode_udu_bwd {label}, all {n_p} paths: two launches "
                  "bitwise equal")

        cluster_nets = [
            (f"2s's trained net H=Hh=64 {wcfg.solver}", wnet, wcfg, cube,
             problem, wcfg.dim, False),
            (f"H=Hh=64 d=5 {wcfg.solver} (random weights)",
             xnode_train.flat_net(init_xnode(wcfg, gv)), wcfg, cube, problem,
             wcfg.dim, True),
            (f"H=Hh=48 F=90, {dc_u} of d={u_cfg.dim} a launch (random "
             "weights)", xnode_train.flat_net(init_xnode(u_cfg, gv)), u_cfg,
             u_dom, usolver.problem, dc_u, True)]
        for label, cnet, c, dom, prob, dc, random in cluster_nets:
            if xnode_train.kernel_route(cnet.dims(), c.dim,
                                        c.solver).bwd.variant != "cluster":
                raise AssertionError(f"#5 at {label} does not route to its "
                                     "cluster variant")
            for n_p in (c.N_r, c.N_r + 1, 37):
                cargs = udu_args(dom, prob, c, n_p, dc)
                if n_p == c.N_r and cnet is wnet:
                    w_args = cargs
                before = xnode_train.BWD_LAUNCHES.by_variant()
                if random:
                    cluster_random(f"{label} N={n_p}", cnet, cargs, c)
                else:
                    check_udu_near_kinks(label, cnet, cargs, c.n_sub,
                                         c.solver, bitwise=True)
                ran = set(variants_run(before, xnode_train.BWD_LAUNCHES))
                if ran != ({"cluster", "global"} if random else {"cluster"}):
                    raise AssertionError(f"#5 at {label}, N={n_p} ran {ran}"
                                         ", expected its cluster variant")
        # #3-#5 at the shapes 2t launches them (F = 300, the full d = 100)
        # and at 2u's trained net (F = 90, d = 30; #5's cluster variant),
        # #4 and #5 twice each, bitwise
        dc_t = hd["route"].d_chunk
        h_tan = [a.contiguous() for a in xnode_train.path_tangent_inputs(
            hb, hsolver.problem, t_cfg)]
        h_chunk = (h_path[0], h_path[1], h_tan[0],
                   h_tan[1][:, :dc_t].contiguous(), h_tan[2],
                   h_tan[3][:, :dc_t].contiguous())
        ub_ = u_dom.interior(gv, u_cfg.N_r)
        u_t0, u_dt = [a.contiguous() for a in xnode_train._prep_intervals(
            ub_.times, ub_.mask, ub_.t_start, u_cfg.n_sub)]
        u_tan = [a.contiguous() for a in xnode_train.path_tangent_inputs(
            ub_, usolver.problem, u_cfg)]
        u_chunk_args = (u_t0, u_dt, u_tan[0], u_tan[1][:, :dc_u].contiguous(),
                        u_tan[2], u_tan[3][:, :dc_u].contiguous())
        chunk_runs = [
            (f"2t's net (F={t_net.F}), {dc_t} of d={t_cfg.dim} a launch",
             t_net, h_chunk, t_cfg, True),
            (f"2u's trained net (H=Hh=48, F=90), {dc_u} of d={u_cfg.dim} a "
             "launch", xnode_train.flat_net(usolver.state.u_params),
             u_chunk_args, u_cfg, True)]
        for label, cnet, cargs, c, bitwise in chunk_runs:
            before = xnode_train.BWD_LAUNCHES.by_variant()
            check_udu_near_kinks(label, cnet, cargs, c.n_sub, c.solver,
                                 bitwise=bitwise)
            ran = set(variants_run(before, xnode_train.BWD_LAUNCHES))
            want_v = xnode_train.kernel_route(cnet.dims(), c.dim,
                                              c.solver).bwd.variant
            if ran != {want_v}:
                raise AssertionError(f"#5 at {label} ran {ran}, expected "
                                     f"its {want_v} variant")
        # #3-#5 at the full d of 2i's net (the cube's widths at d = 20) and
        # at d = 50, random weights (live relus), by the kink rule, #4 and
        # #5 twice each, bitwise
        wide_d = {}
        for dim_r in (20, 50):
            c_r = cfg.replace(dim=dim_r)
            net_r = xnode_train.flat_net(init_xnode(c_r, gv))
            args_r = udu_args(
                Hypercube(c_r.shape_param, dim_r, c_r.T0, c_r.T, c_r.N_t),
                load_problem("Ex4_1_funcs", dim=dim_r), c_r, c_r.N_r, dim_r)
            if xnode_train.kernel_route(net_r.dims(), dim_r,
                                        c_r.solver).d_chunk != dim_r:
                raise AssertionError(f"#3-#5 at the cube's widths, d={dim_r},"
                                     " do not take the full d")
            check_udu_near_kinks(f"the cube's widths at d={dim_r} (random "
                                 "weights)", net_r, args_r, c_r.n_sub,
                                 c_r.solver, bitwise=True)
            wide_d[dim_r] = (net_r, args_r, c_r)

        # #5's global variant at 2s's trained net, launched directly, by
        # the kink rule: the paths at least KINK_MARGIN from a kink against
        # the plain version at SCALED_RTOL, all of them at KINK_RTOL; then
        # how far each variant and the plain f32 version are from the plain
        # version in f64 there (printed)
        w_st = xnode_train.u_du_fwd_cuda(wnet, wnet.packed(), *w_args,
                                         wcfg.n_sub, wcfg.solver, True)[2:]
        cw = torch.Generator(device=dev).manual_seed(7)
        w_ub = torch.randn(w_args[0].shape, generator=cw, device=dev)
        w_dub = torch.randn((*w_args[0].shape, wcfg.dim), generator=cw,
                            device=dev)
        wnet64 = FlatNet([a.double() for a in wnet.flat], wnet.n_lift,
                         wnet.n_field)
        w64 = [a.double() for a in w_args]
        sizes = [a.numel() for a in wnet.flat]
        w_glob = global_tile(wnet.dims(), wcfg.dim, wcfg.solver)
        keep_w = xnode_train.relu_margins(
            wnet64, w64[0], w64[1], w64[2], w64[4], wcfg.n_sub,
            wcfg.solver) >= KINK_MARGIN
        kept = [a[keep_w].contiguous() for a in w_args]
        kept_st = xnode_train.u_du_fwd_plain(wnet, *kept, wcfg.n_sub,
                                             wcfg.solver, store=True)[2:]
        kept_ub = (w_ub[keep_w].contiguous(), w_dub[keep_w].contiguous())
        errs["xnode_udu_bwd"] = max(errs["xnode_udu_bwd"], note(
            "xnode_udu_bwd global", compare_scaled(
                f"xnode_udu_bwd global at 2s's trained net, launched "
                f"directly, N={int(keep_w.sum())}", bwd_direct(
                    w_glob, wnet, wnet.packed(), kept, kept_st, *kept_ub,
                    wcfg.n_sub, wcfg.solver), xnode_train.u_du_bwd_plain(
                    wnet, *kept, *kept_st, *kept_ub, wcfg.n_sub,
                    wcfg.solver), sizes)))
        g_plain = xnode_train.u_du_bwd_plain(wnet, *w_args, *w_st, w_ub,
                                             w_dub, wcfg.n_sub, wcfg.solver)
        g_glob = bwd_direct(w_glob, wnet, wnet.packed(), w_args, w_st, w_ub,
                            w_dub, wcfg.n_sub, wcfg.solver)
        compare_scaled(f"xnode_udu_bwd global at 2s's trained net, all "
                       f"{keep_w.numel()} paths", g_glob, g_plain, sizes,
                       limit=KINK_RTOL)
        g64 = xnode_train.u_du_bwd_plain(
            wnet64, *w64, *xnode_train.u_du_fwd_plain(
                wnet64, *w64, wcfg.n_sub, wcfg.solver, store=True)[2:],
            w_ub.double(), w_dub.double(), wcfg.n_sub, wcfg.solver)
        for label, g in (("kernel", xnode_train.u_du_bwd_cuda(
                wnet, wnet.packed(), *w_args, *w_st, w_ub, w_dub,
                wcfg.n_sub, wcfg.solver)), ("global variant", g_glob),
                ("plain f32", g_plain)):
            worst = max(float((a.double() - b).abs().max() / b.abs().max())
                        for a, b in zip(torch.split(g, sizes),
                                        torch.split(g64, sizes)))
            print(f"  xnode_udu_bwd at 2s's net: {label} vs the plain "
                  f"version in f64, at most {worst:.3e} of each tensor's "
                  "largest value")

        # the same tile and grid with each accumulator: bitwise equal
        gargs_v = (t0_main, dt_main, *tan_inputs)
        stv = xnode_train.u_du_fwd_cuda(net_tr, net_tr.packed(), *gargs_v,
                                         cfg.n_sub, cfg.solver,
                                         store=True)[2:]
        cgv = torch.Generator(device=dev).manual_seed(16)
        ubv = torch.randn((N, L), generator=cgv, device=dev)
        dubv = torch.randn((N, L, d), generator=cgv, device=dev)
        tile_sh = xnode_train.grad_tile(net_tr.dims(), d, cfg.solver, True)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        grid = steppers.bwd_blocks(N, tile_sh.paths,
                                   xnode_train.tile_smem_bytes(
                                       net_tr.dims(), d, cfg.solver,
                                       tile_sh.paths, True),
                                   tile_sh.threads, sms)
        tr_packed = net_tr.packed()

        def launch(kernel):
            """#5 through its launcher at this tile and grid."""
            part = torch.empty((grid, tr_packed.numel()), device=dev)
            grad = torch.empty((tr_packed.numel(),), device=dev)
            kernel(dev, tr_packed.data_ptr(), tr_packed.numel(),
                   *(a.data_ptr() for a in (*gargs_v, *stv, ubv, dubv,
                                            part, grad)),
                   N, L, d, *net_tr.dims(), cfg.n_sub,
                   steppers.METHOD_IDS[cfg.solver], tile_sh.paths,
                   tile_sh.threads, grid)
            return grad

        by_acc = [launch(k) for k in (xnode_train.BWD_KERNEL,
                                      xnode_train.BWD_GLOBAL_KERNEL,
                                      xnode_train.BWD_GLOBAL_KERNEL)]
        if not (torch.equal(by_acc[0], by_acc[1])
                and torch.equal(by_acc[1], by_acc[2])):
            raise AssertionError("#5's global accumulator differs from the "
                                 "shared one, or from itself")
        print(f"  xnode_udu_bwd at the cube's trained net, {tile_sh.paths} "
              f"paths a tile, {tile_sh.threads} threads, {grid} blocks: "
              "the global accumulator bitwise equal to the shared one, and "
              "to itself over two launches")

    # #3-#5 in tangent chunks at the highdim_d20 geometry: u and du
    # against the full-d kernels, and the weight gradients of a
    # contraction through the autograd function
    m20 = init_xnode(cfg20, gv)
    c_u = torch.randn(batch20.times.shape, generator=gv, device=dev)
    c_d = torch.randn((*batch20.times.shape, cfg20.dim), generator=gv,
                      device=dev)
    runs20 = {}
    for dc in (D20_CHUNK, None):
        before = (xnode_train.FWD_STORE_KERNEL.launches,
                  xnode_train.BWD_LAUNCHES.launches)
        u20, du20 = xnode_train.u_du_fused(
            m20, *in20, batch20.times, batch20.mask, batch20.t_start,
            n_sub=cfg20.n_sub, method=cfg20.solver,
            scale=float(cfg20.u_scale_eff), d_chunk=dc)
        g20s = torch.autograd.grad((u20 * c_u).sum() + (du20 * c_d).sum()
                                   + (torch.tanh(u20) * du20[..., 0]).sum(),
                                   list(m20.parameters()))
        n_chunks = cfg20.dim // (dc or cfg20.dim)
        if (xnode_train.FWD_STORE_KERNEL.launches - before[0],
                xnode_train.BWD_LAUNCHES.launches - before[1]) != (
                    n_chunks, n_chunks):
            raise AssertionError(f"d_chunk={dc}: not {n_chunks} launches of "
                                 "#4 and #5")
        runs20[dc] = (u20.detach(), du20.detach(),
                      torch.cat([g.reshape(-1) for g in g20s]))
    (uc, duc, gc), (uf, duf, gf) = runs20[D20_CHUNK], runs20[None]
    if not torch.equal(uc, uf):
        raise AssertionError("u in tangent chunks differs from the full d")
    note("chunked du", compare_scaled(
        f"du, {cfg20.dim // D20_CHUNK} chunks of {D20_CHUNK} vs the full "
        f"d={cfg20.dim} (bitwise: {torch.equal(duc, duf)})", duc, duf))
    note("chunked grad", compare_scaled(
        f"weight gradient, {cfg20.dim // D20_CHUNK} chunks of {D20_CHUNK} vs "
        f"the full d={cfg20.dim}", gc, gf,
        [p.numel() for p in m20.parameters()]))
    print(f"  u in chunks of {D20_CHUNK} bitwise equal to the full d")
    t0_20, dt_20 = [a.contiguous() for a in xnode_train._prep_intervals(
        batch20.times, batch20.mask, batch20.t_start, cfg20.n_sub)]
    d20_case = (xnode_train.flat_net(m20), (t0_20, dt_20, *in20), cfg20)
    return dict(h_path=h_path, h_serve=h_serve, hk=hk, t_cfg=t_cfg,
                t_net=t_net, h_chunk=h_chunk, u_cfg=u_cfg,
                x_net=x_net, x_path=x_paths[0], net96=net96, cfg96=cfg96,
                p96=p96[0], s96=s96, r_net=r_net, r_path=r_path,
                r_serve=r_serve, rk=rk,
                u_net=chunk_runs[1][1], u_chunk_args=u_chunk_args,
                wcfg=wcfg, wnet=wnet, w_args=w_args, main_path=main_path,
                var_errs=var_errs, d20_case=d20_case, d20_net=wide_d[20])


def variant_times(*, card, cfg, cg, dev, hd, hu, hx, method, net,
                   phase_launches, work, h_path, h_serve, hk, t_cfg, t_net,
                   h_chunk, u_cfg, u_net, u_chunk_args, wcfg, wnet, w_args,
                   main_path, d20_case, d20_net, x_net, x_path, net96, cfg96,
                   p96, s96, r_net, r_path, r_serve, rk) -> list:
    """Phase 4's times of the kernel variants at their phases'
    shapes, each with its bound and its launches there. Takes the names
    of ``main`` and of :func:`variant_checks` these read."""
    from xnode_wan_tpu_torch.ops.kernels import (steppers, xnode_eval,
                                                 xnode_train)
    with torch.no_grad():
        # the kernel variants at their phases' shapes: the path-tile #1/#2
        # at 2x's, 96/64's and 2t's shapes, the register #1/#2 at 2t's and
        # 2u's, #2's two variants at the cube's net, #5's cluster variant
        # and its global one, #3-#5 at 2t's and 2u's nets
        def serve_work(tnet, m, k, method_):
            once_, per_ = steppers.field_macs(tnet)
            evals_ = steppers.EVALS_PER_STEP[method_]
            flops = m * 2.0 * (steppers.lift_readout_macs(tnet) + once_
                               + k * evals_ * per_)
            return flops, 4.0 * (m * (tnet.F + 3) + tnet.packed().numel()
                                 + m)

        hm, hN, hL = t_cfg.solver, t_cfg.N_r, t_cfg.N_t
        dc_t = hd["route"].d_chunk
        h_packed = t_net.packed()
        h_states = xnode_train.u_du_fwd_cuda(t_net, h_packed, *h_chunk,
                                             t_cfg.n_sub, hm, True)[2:]
        h_ub = torch.randn((hN, hL), generator=cg, device=dev)
        h_dub = torch.randn((hN, hL, dc_t), generator=cg, device=dev)
        w_packed = wnet.packed()
        w_states = xnode_train.u_du_fwd_cuda(wnet, w_packed, *w_args,
                                             wcfg.n_sub, wcfg.solver,
                                             True)[2:]
        w_ub = torch.randn((wcfg.N_r, wcfg.N_t), generator=cg, device=dev)
        w_dub = torch.randn((wcfg.N_r, wcfg.N_t, wcfg.dim), generator=cg,
                            device=dev)
        h_work = path_work(t_net, steppers, hN, hL, dc_t, t_cfg.n_sub, hm)
        dc_u, um = hu["route"].d_chunk, u_cfg.solver
        u_packed = u_net.packed()
        u_states = xnode_train.u_du_fwd_cuda(u_net, u_packed, *u_chunk_args,
                                             u_cfg.n_sub, um, True)[2:]
        u_ub = torch.randn((u_cfg.N_r, u_cfg.N_t), generator=cg, device=dev)
        u_dub = torch.randn((u_cfg.N_r, u_cfg.N_t, dc_u), generator=cg,
                            device=dev)
        u_work = path_work(u_net, steppers, u_cfg.N_r, u_cfg.N_t, dc_u,
                           u_cfg.n_sub, um)
        w_work = path_work(wnet, steppers, wcfg.N_r, wcfg.N_t, wcfg.dim,
                           wcfg.n_sub, wcfg.solver)
        bwd_t = hd["route"].bwd.variant
        w_bwd = xnode_train.kernel_route(wnet.dims(), wcfg.dim,
                                          wcfg.solver).bwd
        u_bwd = hu["route"].bwd
        # the global variant where the route takes the cluster one, through
        # its launcher at its own tile and grid
        w_glob = global_tile(wnet.dims(), wcfg.dim, wcfg.solver)
        u_glob = global_tile(u_net.dims(), dc_u, um)
        lv = {p: phase_launches[p].variants
              for p in ("2b", "2s", "2t", "2t serve", "2u", "2x",
                        "2x serve")}
        chunk_label = f"{dc_t} of d={t_cfg.dim} a launch"
        x_cfg, r_cfg = hx["solver"].cfg, hu["solver"].cfg
        xm, xk = x_cfg.solver, hx["k_steps"]
        x_tile = xnode_train.kernel_route(x_net.dims(), 0, xm).path_tile
        t_tile = xnode_train.path_tile(t_net.dims(), hm)
        tile96 = xnode_train.kernel_route(net96.dims(), 0,
                                          cfg96.solver).path_tile
        x_serve = hx["serve_args"]
        variant_cases = [
            ("xnode_train", f"tile {tuple(x_tile)}", "2x",
             lambda: xnode_train.path_forward_cuda(x_net, *x_path,
                                                   x_cfg.n_sub, xm),
             lambda: xnode_train.path_forward_plain(x_net, *x_path,
                                                    x_cfg.n_sub, xm),
             path_work(x_net, steppers, x_cfg.N_r, x_cfg.N_t, 0, x_cfg.n_sub,
                       xm)["xnode_train"],
             lv["2x"]["xnode_train"]["tile"], 5),
            ("xnode_eval", f"tile {tuple(x_tile)}", "2x serve",
             lambda: xnode_eval.evaluate_cuda(x_net, *x_serve, xk, xm),
             lambda: xnode_eval.evaluate_plain(x_net, *x_serve, xk, xm),
             serve_work(x_net, SERVE_POINTS, xk, xm),
             lv["2x serve"]["xnode_eval"]["tile"], 3),
            ("xnode_train", f"tile {tuple(tile96)}", "phase 3's 96/64",
             lambda: xnode_train.path_forward_cuda(net96, *p96, cfg96.n_sub,
                                                   cfg96.solver),
             lambda: xnode_train.path_forward_plain(net96, *p96, cfg96.n_sub,
                                                    cfg96.solver),
             path_work(net96, steppers, cfg96.N_r, cfg96.N_t, 0, cfg96.n_sub,
                       cfg96.solver)["xnode_train"], 0, 5),
            ("xnode_eval", f"tile {tuple(tile96)}", "phase 3's 96/64 serve",
             lambda: xnode_eval.evaluate_cuda(net96, *s96, xk, cfg96.solver),
             lambda: xnode_eval.evaluate_plain(net96, *s96, xk,
                                               cfg96.solver),
             serve_work(net96, SERVE_POINTS, xk, cfg96.solver), 0, 3),
            ("xnode_train", f"tile {tuple(t_tile)}, launched directly",
             "2t's shapes",
             lambda: path_tile_direct(t_net, h_path, t_cfg),
             lambda: xnode_train.path_forward_plain(t_net, *h_path,
                                                    t_cfg.n_sub, hm),
             h_work["xnode_train"], 0, 5),
            ("xnode_eval", f"tile {tuple(t_tile)}, launched directly",
             "2t serve's shapes",
             lambda: serve_tile_direct(t_net, h_serve, hk, t_cfg),
             lambda: xnode_eval.evaluate_plain(t_net, *h_serve, hk, hm),
             serve_work(t_net, SERVE_POINTS, hk, hm), 0, 5),
            ("xnode_train", "registers", "2t",
             lambda: xnode_train.path_forward_cuda(t_net, *h_path,
                                                   t_cfg.n_sub, hm),
             lambda: xnode_train.path_forward_plain(t_net, *h_path,
                                                    t_cfg.n_sub, hm),
             h_work["xnode_train"], lv["2t"]["xnode_train"]["registers"], 20),
            ("xnode_train", "registers", "2u",
             lambda: xnode_train.path_forward_cuda(r_net, *r_path,
                                                   r_cfg.n_sub, r_cfg.solver),
             lambda: xnode_train.path_forward_plain(r_net, *r_path,
                                                    r_cfg.n_sub,
                                                    r_cfg.solver),
             path_work(r_net, steppers, r_cfg.N_r, r_cfg.N_t, 0, r_cfg.n_sub,
                       r_cfg.solver)["xnode_train"],
             lv["2u"]["xnode_train"]["registers"], 20),
            ("xnode_eval", "registers", "phase 3's 2u serve",
             lambda: xnode_eval.evaluate_cuda(r_net, *r_serve, rk,
                                              r_cfg.solver),
             lambda: xnode_eval.evaluate_plain(r_net, *r_serve, rk,
                                               r_cfg.solver),
             serve_work(r_net, SERVE_POINTS, rk, r_cfg.solver), 0, 5),
            ("xnode_train", "tile", "2b's shapes",
             lambda: path_tile_direct(net, main_path, cfg),
             lambda: xnode_train.path_forward_plain(net, *main_path,
                                                    cfg.n_sub, method),
             work["xnode_train"], lv["2b"]["xnode_train"]["tile"], 20),
            ("xnode_train", "registers", "2b's shapes",
             lambda: xnode_train.path_forward_cuda(net, *main_path,
                                                   cfg.n_sub, method),
             lambda: xnode_train.path_forward_plain(net, *main_path,
                                                    cfg.n_sub, method),
             work["xnode_train"], lv["2b"]["xnode_train"]["registers"], 20),
            ("xnode_eval", "registers", "2t serve",
             lambda: xnode_eval.evaluate_cuda(t_net, *h_serve, hk, hm),
             lambda: xnode_eval.evaluate_plain(t_net, *h_serve, hk, hm),
             serve_work(t_net, SERVE_POINTS, hk, hm),
             lv["2t serve"]["xnode_eval"]["registers"], 5),
            ("xnode_udu_bwd", f"{w_bwd.variant}, {w_bwd.cluster} blocks a "
             f"cluster, {w_bwd.paths} paths a tile", "2s",
             lambda: xnode_train.u_du_bwd_cuda(
                 wnet, w_packed, *w_args, *w_states, w_ub, w_dub, wcfg.n_sub,
                 wcfg.solver),
             lambda: xnode_train.u_du_bwd_plain(
                 wnet, *w_args, *w_states, w_ub, w_dub, wcfg.n_sub,
                 wcfg.solver),
             w_work[bwd_key(w_bwd)],
             lv["2s"]["xnode_udu_bwd"][w_bwd.variant], 3),
            ("xnode_udu_bwd", f"global, {w_glob.paths} paths a tile, "
             "launched directly", "2s's shapes",
             lambda: bwd_direct(w_glob, wnet, w_packed, w_args, w_states,
                                w_ub, w_dub, wcfg.n_sub, wcfg.solver),
             lambda: xnode_train.u_du_bwd_plain(
                 wnet, *w_args, *w_states, w_ub, w_dub, wcfg.n_sub,
                 wcfg.solver),
             w_work["xnode_udu_bwd"], lv["2s"]["xnode_udu_bwd"]["global"],
             1),
            ("xnode_udu_fwd", chunk_label, "2t",
             lambda: xnode_train.u_du_fwd_cuda(t_net, h_packed, *h_chunk,
                                               t_cfg.n_sub, hm),
             lambda: xnode_train.u_du_fwd_plain(t_net, *h_chunk,
                                                t_cfg.n_sub, hm),
             h_work["xnode_udu_fwd"], hd["launches"]["xnode_udu_fwd"], 3),
            ("xnode_udu_fwd_store", chunk_label, "2t",
             lambda: xnode_train.u_du_fwd_cuda(t_net, h_packed, *h_chunk,
                                               t_cfg.n_sub, hm, True),
             lambda: xnode_train.u_du_fwd_plain(t_net, *h_chunk,
                                                t_cfg.n_sub, hm, True),
             h_work["xnode_udu_fwd_store"],
             hd["launches"]["xnode_udu_fwd_store"], 3),
            ("xnode_udu_bwd", f"{bwd_t}, {chunk_label}", "2t",
             lambda: xnode_train.u_du_bwd_cuda(
                 t_net, h_packed, *h_chunk, *h_states, h_ub, h_dub,
                 t_cfg.n_sub, hm),
             lambda: xnode_train.u_du_bwd_plain(
                 t_net, *h_chunk, *h_states, h_ub, h_dub, t_cfg.n_sub,
                 hm),
             h_work["xnode_udu_bwd"], hd["launches"]["xnode_udu_bwd"], 3),
            ("xnode_udu_bwd", f"{u_bwd.variant}, {u_bwd.cluster} blocks a "
             f"cluster, {u_bwd.paths} paths a tile, {dc_u} of "
             f"d={u_cfg.dim} a launch", "2u",
             lambda: xnode_train.u_du_bwd_cuda(
                 u_net, u_packed, *u_chunk_args, *u_states, u_ub, u_dub,
                 u_cfg.n_sub, um),
             lambda: xnode_train.u_du_bwd_plain(
                 u_net, *u_chunk_args, *u_states, u_ub, u_dub, u_cfg.n_sub,
                 um),
             u_work[bwd_key(u_bwd)],
             hu["launches"].variants["xnode_udu_bwd"][u_bwd.variant], 3),
            ("xnode_udu_bwd", f"global, {u_glob.paths} paths a tile, {dc_u} "
             f"of d={u_cfg.dim} a launch, launched directly", "2u's shapes",
             lambda: bwd_direct(u_glob, u_net, u_packed, u_chunk_args,
                                u_states, u_ub, u_dub, u_cfg.n_sub, um),
             lambda: xnode_train.u_du_bwd_plain(
                 u_net, *u_chunk_args, *u_states, u_ub, u_dub, u_cfg.n_sub,
                 um),
             u_work["xnode_udu_bwd"],
             hu["launches"].variants["xnode_udu_bwd"]["global"], 1)]
        # #3, #4 and #5 at the d=20 nets of 2g (highdim_d20) and 2i (the
        # cube's widths at d = 20), random weights, their launches there
        for label, phase, (xnet, xargs, xc) in (
                ("highdim_d20", "2g", d20_case), ("2i's net", "2i", d20_net)):
            xp = xnet.packed()
            xN, xL = xargs[0].shape
            xd = xargs[-1].shape[1]
            xs = xnode_train.u_du_fwd_cuda(xnet, xp, *xargs, xc.n_sub,
                                           xc.solver, True)[2:]
            x_ub = torch.randn((xN, xL), generator=cg, device=dev)
            x_dub = torch.randn((xN, xL, xd), generator=cg, device=dev)
            x_work = path_work(xnet, steppers, xN, xL, xd, xc.n_sub,
                               xc.solver)
            x_bwd = xnode_train.kernel_route(xnet.dims(), xd, xc.solver).bwd
            x_launch = phase_launches[phase]
            shape = f"{label}, d={xd}, {xnet.dims()}"

            def fwd(store, a=(xnet, xp, xargs, xc)):
                return lambda: xnode_train.u_du_fwd_cuda(
                    a[0], a[1], *a[2], a[3].n_sub, a[3].solver, store)

            def fwd_plain(store, a=(xnet, xargs, xc)):
                return lambda: xnode_train.u_du_fwd_plain(
                    a[0], *a[1], a[2].n_sub, a[2].solver, store)

            b_args = (xnet, xp, xargs, xs, x_ub, x_dub, xc)
            variant_cases += [
                ("xnode_udu_fwd", shape, f"{phase}'s shapes", fwd(False),
                 fwd_plain(False), x_work["xnode_udu_fwd"],
                 x_launch["xnode_udu_fwd"], 3),
                ("xnode_udu_fwd_store", shape, f"{phase}'s shapes", fwd(True),
                 fwd_plain(True), x_work["xnode_udu_fwd_store"],
                 x_launch["xnode_udu_fwd_store"], 3),
                ("xnode_udu_bwd", f"{x_bwd.variant}, {x_bwd.paths} paths a "
                 f"tile, {shape}", f"{phase}'s shapes",
                 lambda a=b_args: xnode_train.u_du_bwd_cuda(
                     a[0], a[1], *a[2], *a[3], a[4], a[5], a[6].n_sub,
                     a[6].solver),
                 lambda a=b_args: xnode_train.u_du_bwd_plain(
                     a[0], *a[2], *a[3], a[4], a[5], a[6].n_sub,
                     a[6].solver),
                 x_work[bwd_key(x_bwd)], x_launch["xnode_udu_bwd"], 3)]
        var_rows = []
        print(f"kernel variants ({card}), kernel the median of 20 "
              "CUDA-event runs, plain of the reps given:")
        for name, variant, phase, kern, plain, wk, n_launch, p_reps in \
                variant_cases:
            ms = time_ms(kern)
            plain_ms = time_ms(plain, reps=p_reps, warmup=1)
            bound_ms, bound_by = bound(*wk)
            flops = wk[0] + sum(wk[2:])
            tc = (f", {wk[2] / 1e9:.3f} of them on the tensor cores in "
                  "3xTF32" if len(wk) > 2 else "")
            print(f"  {name} {variant} at {phase}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {1e3 * bound_ms:.2f} us "
                  f"({bound_by}; {flops / 1e9:.3f} GFLOP{tc}, "
                  f"{wk[1] / 1e6:.3f} MB), "
                  f"{flops / (ms * 1e-3) / 1e12:.3f} TFLOP/s, "
                  f"{n_launch} launches there")
            var_rows.append({"kernel": name, "variant": variant,
                             "phase": phase, "launches": n_launch, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by})
    return var_rows


def disc_margins(geom, packed, feats) -> torch.Tensor:
    """Each point's smallest ``|a| / (|W| |x| + |b|)`` over the relu
    pre-activations ``a_0 .. a_{L-1}`` of the adversary, in f64: where it
    is tiny, two f32 orders of summation may put the point on either side
    of a kink, and ``gin`` and #7's gradient jump there."""
    pairs = geom.unpack(packed.double())
    x = feats.double()
    margin = torch.full((x.shape[0],), math.inf, dtype=torch.float64,
                        device=x.device)
    for i in range(geom.L):
        w, b = pairs[0] if i == 0 else geom.hidden(pairs, i - 1)
        a = x @ w.T + b
        scale = (x.abs() @ w.abs().T + b.abs()).clamp_min(1e-300)
        margin = torch.minimum(margin, (a.abs() / scale).min(1).values)
        x = torch.relu(a)
    return margin


def disc_bwd_global(geom, dev):
    """#7's global variant at its largest tile through its launcher,
    whatever ``disc_route`` picks: ``(label, launch)``, with
    ``launch(packed, feats, vb, gb)`` the gradient on the route's grid
    rule for that many points."""
    from xnode_wan_tpu_torch.ops.kernels import disc_train

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tile = disc_train._largest_tile(geom, "global")

    def launch(packed, f, vb, gb):
        blocks = disc_train.bwd_grid(geom, "global", tile, f.shape[0], sms)
        return disc_train._bwd(disc_train.BWD_GLOBAL_KERNEL, packed, f, vb,
                               gb, geom, tile, blocks, dev)
    return f"global, {tile}-point tiles", launch


def check_adversary(label: str, geom, packed, feats, gen) -> dict:
    """#6 and #7, in the variants ``disc_route`` picks, against their
    plain versions on ``feats``: ``v`` within ``RTOL``/``ATOL``; ``gin``
    and each weight-gradient tensor of #7 (seeded random cotangents)
    within ``SCALED_RTOL`` of its largest value on the points at least
    ``KINK_MARGIN`` from a relu kink (every point where none comes
    nearer), and where some do, every point at ``KINK_RTOL``; #6 and #7
    twice on every point, bitwise. Returns the largest errors."""
    from xnode_wan_tpu_torch.ops.kernels import disc_train

    M = feats.shape[0]
    vb = torch.randn((M,), generator=gen, device=feats.device)
    gb = torch.randn((M, geom.F), generator=gen, device=feats.device)
    sizes = [w.numel() for pair in geom.unpack(packed) for w in pair]
    route = disc_train.disc_route(geom)
    keep = disc_margins(geom, packed, feats) >= KINK_MARGIN
    errs = {"disc_fwd": 0.0, "disc_bwd": 0.0}
    variant = f"{route.bwd}, {route.bwd_tile}-point tiles"

    def against_plain(lbl, idx, limit):
        f, v_b, g_b = ((feats, vb, gb) if idx is None else
                       (feats[idx].contiguous(), vb[idx].contiguous(),
                        gb[idx].contiguous()))
        v_k, g_k = disc_train.v_dv_fwd_cuda(packed, f, geom)
        v_p, g_p = disc_train.v_dv_fwd_plain(packed, f, geom)
        errs["disc_fwd"] = max(errs["disc_fwd"], compare(
            f"disc_fwd {route.fwd} v {lbl}", v_k, v_p), compare_scaled(
            f"disc_fwd {route.fwd} gin {lbl}", g_k, g_p, limit=limit))
        grad = disc_train.v_dv_bwd_cuda(packed, f, v_b, g_b, geom)
        errs["disc_bwd"] = max(errs["disc_bwd"], compare_scaled(
            f"disc_bwd {variant} {lbl}", grad,
            disc_train.v_dv_bwd_plain(packed, f, v_b, g_b, geom), sizes,
            limit=limit))
        return grad

    label = f"{label} {geom} M={M}"
    if bool(keep.all()):
        grad = against_plain(label, None, SCALED_RTOL)
    else:
        print(f"  {label}: {int((~keep).sum())} of {M} points come within "
              f"{KINK_MARGIN} of a relu kink and are left out")
        against_plain(f"{label}, {int(keep.sum())} points", keep,
                      SCALED_RTOL)
        grad = against_plain(f"{label}, all points", None, KINK_RTOL)
    fwd_twice = [disc_train.v_dv_fwd_cuda(packed, feats, geom)
                 for _ in range(2)]
    if not all(torch.equal(a, b) for a, b in zip(*fwd_twice)):
        raise AssertionError(f"disc_fwd {route.fwd} {label}: two launches "
                             "differ")
    print(f"  disc_fwd {route.fwd} {label}: two launches bitwise equal")
    if not torch.equal(grad, disc_train.v_dv_bwd_cuda(packed, feats, vb, gb,
                                                      geom)):
        raise AssertionError(f"disc_bwd {variant} {label}: two launches "
                             "differ")
    print(f"  disc_bwd {variant} {label}: two launches bitwise equal")
    return errs


def check_fwd_tile(label: str, geom, packed, feats, tile: int, dev) -> float:
    """The tile #6 at ``tile`` points through its launcher against the
    plain version on ``feats``, by :func:`check_adversary`'s rule for #6,
    twice, bitwise. Returns the largest error."""
    from xnode_wan_tpu_torch.ops.kernels import disc_train

    keep = disc_margins(geom, packed, feats) >= KINK_MARGIN
    runs = [disc_train._fwd_tile(packed, feats, geom, tile, dev)
            for _ in range(2)]
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError(f"disc_fwd tile {label}: two launches differ")
    (v_t, g_t), (v_p, g_p) = runs[0], disc_train.v_dv_fwd_plain(
        packed, feats, geom)
    if not float(g_p.abs().max()) > 0.0:
        raise AssertionError(f"{label}: gin is 0, so the checks cannot see "
                             "the features")
    err = compare(f"disc_fwd tile v {label}", v_t, v_p)
    if bool(keep.all()):
        err = max(err, compare_scaled(f"disc_fwd tile gin {label}", g_t,
                                      g_p))
    else:
        print(f"  {label}: {int((~keep).sum())} of {feats.shape[0]} points "
              f"come within {KINK_MARGIN} of a relu kink")
        err = max(err, compare_scaled(
            f"disc_fwd tile gin {label}, {int(keep.sum())} points",
            g_t[keep], g_p[keep]), compare_scaled(
            f"disc_fwd tile gin {label}, all points", g_t, g_p,
            limit=KINK_RTOL))
    print(f"  disc_fwd tile {label}: two launches bitwise equal")
    return err


def adversary_checks(*, cube, dev, hv, hw, vpts) -> dict:
    """Phase 3's checks of #6's and #7's variants: 2v's and 2w's trained
    adversaries and :data:`ADV_NETS` (random weights) at the main path's
    80,000 points and at 80,001 and 37, by :func:`check_adversary`, each
    net's launches counted; at the cube's shape (random weights), the tile
    #6 against the plain version, and #7's global variant bitwise equal to
    the shared one, the launcher called with each at the same tile and
    grid. Returns the errors, the launches by net and what phase 4 times."""
    from xnode_wan_tpu_torch import init_discriminator
    from xnode_wan_tpu_torch.models.discriminator import disc_features
    from xnode_wan_tpu_torch.ops.kernels import disc_train

    print("adversary variants vs plain, f32:")
    kernels = kernel_table()
    gen = torch.Generator(device=dev).manual_seed(21)
    M = vpts.shape[0]
    c20 = hw["cfg"]
    pts20 = torch.rand((M + 1, c20.dim + 1), generator=gen, device=dev)
    pts20[:, 1:] = 2.0 * pts20[:, 1:] - 1.0
    # one more interior point for the ragged count
    pts5 = torch.cat([vpts, cube.interior(gen, 1).x[0, :1]])
    cv = hv["cfg"]
    nets = [("2v trained", hv["solver"].state.v_params, cv.v_layers,
             cv.tied_v, cv.v_fourier_features, cv.dim),
            ("2w trained", hw["solver"].state.v_params, c20.v_layers,
             c20.tied_v, c20.v_fourier_features, c20.dim)]
    for name, d, width, layers, tied, n_freq in ADV_NETS:
        nets.append((f"{name}, random", init_discriminator(
            d, width, layers, tied, n_freq, generator=gen, device=dev),
            layers, tied, n_freq, d))
    errs, timed, launches, every = {}, {}, {}, {}
    with torch.no_grad():
        for name, vp, layers, tied, n_freq, d in nets:
            geom = disc_train.geom_of(vp, layers, tied)
            packed = disc_train.live_packed_disc(vp, layers, tied).detach()
            base = {cv.dim: pts5, c20.dim: pts20}[d]
            feats = disc_features(base, n_freq).contiguous()
            zero_launches(kernels)
            for m in (M, M + 1, 37):
                e = check_adversary(name, geom, packed, feats[:m], gen)
                for k, v in e.items():
                    errs[k] = max(errs.get(k, 0.0), v)
            launches[name] = read_launches(kernels)
            timed[name] = (geom, packed, feats[:M].contiguous())
            every[name] = feats
        # the cube's shape: the tile #6 through its launcher, and #7's two
        # accumulators at the shared one's tile and grid
        geom, packed, feats = timed["cube's shape, random"]
        route = disc_train.disc_route(geom)
        tile = disc_train._largest_tile(geom, "tile")
        zero_launches(kernels)
        for m in (M, M + 1, 37):
            err = check_fwd_tile(
                f"the cube's shape, random, {tile} points a tile, M={m}",
                geom, packed, every["cube's shape, random"][:m].contiguous(),
                tile, dev)
            errs["disc_fwd"] = max(errs.get("disc_fwd", 0.0), err)
        vb = torch.randn((M,), generator=gen, device=dev)
        gb = torch.randn((M, geom.F), generator=gen, device=dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        blocks = disc_train.bwd_grid(geom, "shared", route.bwd_tile, M, sms)
        shared, glob = (disc_train._bwd(k, packed, feats, vb, gb, geom,
                                        route.bwd_tile, blocks, dev)
                        for k in (disc_train.BWD_KERNEL,
                                  disc_train.BWD_GLOBAL_KERNEL))
        if not torch.equal(shared, glob):
            raise AssertionError("disc_bwd at the cube's shape: the global "
                                 "accumulator differs from the shared one "
                                 "at the same tile and grid")
        print(f"  disc_bwd at the cube's shape, random, M={M}: the global "
              f"accumulator bitwise equal to the shared one at "
              f"{route.bwd_tile} points a tile and {blocks} blocks")
        launches["cube's shape, tile #6 and #7 global"] = read_launches(
            kernels)
        timed["cube's shape"] = (geom, packed, feats, tile, blocks)
    return {"errs": errs, "timed": timed, "launches": launches}


def adversary_times(*, card, checked, phase_launches) -> list:
    """Phase 4's times of #6's and #7's variants, each with its bound,
    its plain version and its launches where its net ran: 2v's (the tile
    #6, #7 global) and 2w's (the register #6, #7 shared at F = 141) at the
    main path's 80,000 points with 2v's and 2w's launches; the widest
    net's, the d=20 3-frequency net's and, at the cube's shape, the tile
    #6 and #7 global (the latter at the shared one's tile and grid), with
    phase 3's launches at that net."""
    from xnode_wan_tpu_torch.ops.kernels import disc_train

    p3 = checked["launches"]
    gen = torch.Generator(device=checked["timed"]["cube's shape"][2].device)
    gen.manual_seed(22)
    rows = []
    with torch.no_grad():
        cases = []
        for name, phase, lv in (
                ("2v trained", "2v", phase_launches["2v"].variants),
                ("2w trained", "2w", phase_launches["2w"].variants),
                ("widest tied, random", "phase 3",
                 p3["widest tied, random"].variants),
                ("d=20, 3 frequencies, random", "phase 3",
                 p3["d=20, 3 frequencies, random"].variants)):
            geom, packed, feats = checked["timed"][name]
            route = disc_train.disc_route(geom)
            M = feats.shape[0]
            vb = torch.randn((M,), generator=gen, device=feats.device)
            gb = torch.randn((M, geom.F), generator=gen, device=feats.device)
            work = disc_work(geom, M)
            cases += [
                ("disc_fwd", route.fwd, f"{phase}, {geom}",
                 lambda p=packed, f=feats, g=geom:
                 disc_train.v_dv_fwd_cuda(p, f, g),
                 lambda p=packed, f=feats, g=geom:
                 disc_train.v_dv_fwd_plain(p, f, g),
                 # the tile #6's bound splits its FP32 forward from its
                 # 3xTF32 sweep and gin
                 work["disc_fwd tile" if route.fwd == "tile"
                      else "disc_fwd"], lv["disc_fwd"][route.fwd]),
                ("disc_bwd", route.bwd, f"{phase}, {geom}, {route}",
                 lambda p=packed, f=feats, a=vb, b=gb, g=geom:
                 disc_train.v_dv_bwd_cuda(p, f, a, b, g),
                 lambda p=packed, f=feats, a=vb, b=gb, g=geom:
                 disc_train.v_dv_bwd_plain(p, f, a, b, g),
                 # the cluster variant's bound splits its FP32 forward
                 # from its 3xTF32 rest
                 work["disc_bwd cluster" if route.bwd == "cluster"
                      else "disc_bwd"], lv["disc_bwd"][route.bwd])]
            if name == "2v trained":
                # the global variant, which 2v took before the cluster one,
                # through its launcher beside it
                label, launch = disc_bwd_global(geom, feats.device)
                cases.append((
                    "disc_bwd", "global", f"{phase}, {geom}, {label}, "
                    "through its launcher",
                    lambda p=packed, f=feats, a=vb, b=gb, fn=launch:
                    fn(p, f, a, b),
                    lambda p=packed, f=feats, a=vb, b=gb, g=geom:
                    disc_train.v_dv_bwd_plain(p, f, a, b, g),
                    work["disc_bwd"], 0))
        geom, packed, feats, tile, blocks = checked["timed"]["cube's shape"]
        lv = p3["cube's shape, tile #6 and #7 global"].variants
        dev = feats.device
        M = feats.shape[0]
        vb = torch.randn((M,), generator=gen, device=dev)
        gb = torch.randn((M, geom.F), generator=gen, device=dev)
        work = disc_work(geom, M)
        tile_b = disc_train.disc_route(geom).bwd_tile
        cases += [
            ("disc_fwd", "tile", f"phase 3, the cube's shape {geom}, {tile} "
             "points a tile",
             lambda: disc_train._fwd_tile(packed, feats, geom, tile, dev),
             lambda: disc_train.v_dv_fwd_plain(packed, feats, geom),
             work["disc_fwd tile"], lv["disc_fwd"]["tile"]),
            ("disc_bwd", "global", f"phase 3, the cube's shape {geom}, the "
             f"shared one's {tile_b}-point tiles and {blocks} blocks",
             lambda: disc_train._bwd(disc_train.BWD_GLOBAL_KERNEL, packed,
                                     feats, vb, gb, geom, tile_b, blocks,
                                     dev),
             lambda: disc_train.v_dv_bwd_plain(packed, feats, vb, gb, geom),
             work["disc_bwd"], lv["disc_bwd"]["global"])]
        print(f"adversary variants ({card}), kernel the median of 20 "
              "CUDA-event runs (of 5 where a launch takes over "
              f"{SLOW_LAUNCH_MS:g} ms), plain of 5:")
        for name, variant, phase, kern, plain, wk, n_launch in cases:
            first = time_ms(kern, reps=1, warmup=0)
            ms = (time_ms(kern, reps=5, warmup=0) if first > SLOW_LAUNCH_MS
                  else time_ms(kern))
            plain_ms = time_ms(plain, reps=5, warmup=1)
            bound_ms, bound_by = bound(*wk)
            flops = wk[0] + (wk[2] if len(wk) > 2 else 0.0)
            print(f"  {name} {variant} at {phase}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {1e3 * bound_ms:.2f} us "
                  f"({bound_by}; {flops / 1e9:.3f} GFLOP, {wk[1] / 1e6:.3f} "
                  f"MB), {flops / (ms * 1e-3) / 1e12:.3f} TFLOP/s, "
                  f"{n_launch} launches there")
            rows.append({"kernel": name, "variant": variant, "phase": phase,
                         "launches": n_launch, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by})
    return rows


def phase_done(name: str, t_start: float) -> float:
    now = time.perf_counter()
    print(f"phase {name}: {now - t_start:.3f} s")
    return now


def run_cli(cli_main, argv):
    """``cli_main(argv)`` with its standard output captured and echoed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        solver = cli_main(argv)
    text = buf.getvalue()
    print(text, end="")
    return text, solver


def read_jsonl(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def main(work_root: str) -> int:
    """Every phase; the solvers' files go under ``work_root``."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from xnode_wan_tpu_torch import (Hypercube, NODEWANSolver, apply_xnode,
                                     evaluate_points, init_discriminator,
                                     init_xnode, load_params, load_problem,
                                     load_reference_state_dict, rel_err,
                                     u_forward_fused)
    from xnode_wan_tpu_torch.main import main as cli_main
    from xnode_wan_tpu_torch.models.xnode import spatial_features
    from xnode_wan_tpu_torch.ops import weak_form
    from xnode_wan_tpu_torch.ops.kernels import _build, disc_train, steppers
    from xnode_wan_tpu_torch.ops.kernels import xnode_eval, xnode_train
    from xnode_wan_tpu_torch.ops.kernels.steppers import FlatNet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()

    # 1. build ---------------------------------------------------------
    # #1/#2 (xnode_fwd.cu) get one library per (H, Hh) pair of the
    # shipped configs, the register #6 (disc_fwd.cu) one per adversary
    # width; #3-#5 (xnode_grad.cu) one, #7 and the tile #6 (disc_train.cu)
    # one
    shipped = {}
    for name in ("cube_pde", "ex4_1_d10", "highdim_d20"):
        gcfg = load_params(os.path.join(ROOT, "configs", f"{name}.yaml"))
        shipped[name] = (gcfg, xnode_train.flat_net(
            init_xnode(gcfg, device="cpu")).dims())
    shipped_fwd = {dims[:2] for _, dims in shipped.values()}
    # 2s's net (64, 64) and 2u's (48, 48) are within #1/#2's caps: a
    # library each
    wide_fwds = [(WIDE["u_hidden_dim"], WIDE["u_hidden_hidden_dim"]),
                 (D30["u_hidden_dim"], D30["u_hidden_hidden_dim"])]
    disc_widths = sorted({(g.v_hidden_dim,) for g, _ in shipped.values()})
    # these libraries spill and take ptxas about 100 s: they build, side by
    # side, in a thread of their own while phases 2a-2r run, and 2s waits
    # for them
    wide_build = {}

    def build_wide():
        t_w = time.perf_counter()
        try:
            _build.build([("xnode_fwd", w) for w in wide_fwds])
        except Exception as exc:   # re-raised by 2s
            wide_build["error"] = exc
        wide_build["s"] = time.perf_counter() - t_w

    wide_thread = threading.Thread(target=build_wide, daemon=True)
    wide_thread.start()
    t = time.perf_counter()
    libs = _build.build([("xnode_grad", None), ("xnode_path_tile", None),
                         ("disc_train", None)]
                        + [("xnode_fwd", w) for w in sorted(shipped_fwd)]
                        + [("disc_fwd", w) for w in disc_widths])
    print(f"build: {time.perf_counter() - t:.2f} s -> {_build.build_dir()}")
    for name in libs:
        log = (_build.build_dir() / f"{name}.log").read_text()
        for line in log.splitlines():
            if ("Compiling entry" in line or "registers" in line
                    or "spill" in line):
                print(f"  {name}: {line.strip()}")
        # the width-specialized kernels keep every per-thread array in
        # registers at the shipped widths, and the adversary's tile
        # kernels and #1/#2's path-tile kernel theirs at any width: no
        # stack, no spills
        frames = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill "
                            r"stores, (\d+) bytes spill loads", log)
        if name.startswith(("xnode_fwd", "disc_fwd", "disc_train",
                            "xnode_path_tile")) and (
                not frames or any(v != "0" for f in frames for v in f)):
            raise AssertionError(f"{name}: stack or spills {frames}")
    # the staged copy's size in Python against the library's, at the
    # shipped configs
    for name, (gcfg, dims) in shipped.items():
        H, Hh, _, n_lift, n_field = dims
        lib = ctypes.CDLL(str(libs[_build.lib_name("xnode_fwd", (H, Hh))]))
        got = lib.xnode_fwd_staged_floats(H, Hh, n_lift, n_field)
        if got != steppers.staged_floats(H, Hh, n_lift, n_field):
            raise AssertionError(f"staged_floats {name}: the kernel stages "
                                 f"{got} floats")
        print(f"  xnode_fwd {name} (H={H}, Hh={Hh}): {got} staged floats, "
              f"{4 * got} bytes of shared memory a block")
    for name, tied in (("cube_pde", True), ("cube_pde", False),
                       ("highdim_d20", True), ("highdim_d20", False)):
        gcfg = shipped[name][0]
        geom = disc_train.geom_of(init_discriminator(
            gcfg.dim, gcfg.v_hidden_dim, gcfg.v_layers, tied,
            gcfg.v_fourier_features, device="cpu"), gcfg.v_layers, tied)
        lib = ctypes.CDLL(str(libs[_build.lib_name("disc_fwd", (geom.H,))]))
        got = lib.disc_fwd_staged_floats(geom.F, geom.H, geom.L, int(tied))
        if got != disc_train.staged_floats(geom):
            raise AssertionError(f"disc_train.staged_floats {name} {geom}: "
                                 f"the kernel stages {got} floats")
        print(f"  disc_fwd {name} {geom}: {got} staged floats; "
              f"{disc_train.fwd_smem_bytes(geom)} bytes of shared memory a "
              "block with the sign words and slots")
    # #7's variants and the tile #6: the tile's shared bytes in Python
    # against the launcher's, at the shipped adversaries, 2v's and 2w's
    # and phase 3's, every variant and tile (#7's cluster variant at
    # clusters of 2, 4 and 8 blocks, the tied nets)
    smem_of = ctypes.CDLL(str(libs["disc_train"])).disc_tile_smem_bytes
    smem_of.restype = ctypes.c_longlong
    smem_of.argtypes = [ctypes.c_int] * 6
    cluster_smem_of = ctypes.CDLL(
        str(libs["disc_train"])).disc_cluster_smem_bytes
    cluster_smem_of.restype = ctypes.c_longlong
    cluster_smem_of.argtypes = [ctypes.c_int] * 5
    adv_geoms = {disc_train.DiscGeom(
        g.v_fourier_features * 2 * g.dim + g.dim + 1, g.v_hidden_dim,
        g.v_layers, tied) for g, _ in shipped.values() for tied in (0, 1)}
    for over in (WIDE_V, FOURIER_V):
        g = load_params(CONFIG).replace(**over)
        adv_geoms.add(disc_train.DiscGeom(
            g.v_fourier_features * 2 * g.dim + g.dim + 1, g.v_hidden_dim,
            g.v_layers, int(g.tied_v)))
    adv_geoms |= {disc_train.DiscGeom(d * (2 * nf + 1) + 1, H, L, int(t))
                  for _, d, H, L, t, nf in ADV_NETS}
    for geom in sorted(adv_geoms):
        for variant, vid in disc_train.VARIANT_IDS.items():
            for tile in (disc_train.FWD_TILES if variant == "tile"
                         else disc_train.TILES):
                got = smem_of(vid, geom.F, geom.H, geom.L, geom.tied, tile)
                if got != disc_train.tile_smem_bytes(geom, variant, tile):
                    raise AssertionError(
                        f"disc_train.tile_smem_bytes {geom} {variant} "
                        f"tile={tile}: the launcher asks for {got} bytes")
        for cluster in (2, 4, 8) if geom.tied else ():
            for tile in disc_train.TILES:
                got = cluster_smem_of(geom.F, geom.H, geom.L, cluster, tile)
                if got != disc_train.cluster_smem_bytes(geom, cluster, tile):
                    raise AssertionError(
                        f"disc_train.cluster_smem_bytes {geom} cluster="
                        f"{cluster} tile={tile}: the launcher asks for {got} "
                        "bytes")
        route = disc_train.disc_route(geom)
        smem = (disc_train.cluster_smem_bytes(geom, route.cluster,
                                              route.bwd_tile)
                if route.bwd == "cluster" else
            disc_train.tile_smem_bytes(geom, route.bwd, route.bwd_tile))
        threads = (disc_train.CLUSTER_THREADS if route.bwd == "cluster"
                   else disc_train.BWD_THREADS)
        fwd = ""
        if route.fwd == "tile":
            t6 = route.fwd_tile
            kf = disc_train.fwd_slice(geom, t6)
            fwd = (f"; the tile #6 at {t6} points "
                   f"{disc_train.tile_smem_bytes(geom, 'tile', t6)} bytes, "
                   f"slices of {kf} and "
                   f"{disc_train.sweep_slice(geom, t6, kf)} inputs, passes "
                   f"of {disc_train.fwd_pass(geom, t6)}")
        print(f"  disc_train {geom}: {route}, #7 {smem} bytes of shared "
              f"memory a block, {threads} threads{fwd}")
    log = (_build.build_dir() / "disc_train.log").read_text()
    for c in log.split("Compiling entry function")[1:]:
        regs = re.search(r"Used (\d+) registers", c)
        print(f"  disc_train {c.splitlines()[0].strip()}: "
              f"{regs.group(1) if regs else '?'} registers a thread")
    # the wrapper's shared-memory rule against the bytes the launchers of
    # #3-#5 ask for, at every shipped config, the nets of 2s, 2t, 2u and 2i
    # and the cube's widths at d = 50,
    # method and listed tile: #3/#4 (also at d = 0), #5, #5's
    # global-accumulator variant and its cluster variant at each cluster
    # size
    grad_lib = ctypes.CDLL(str(libs["xnode_grad"]))
    smem_of = grad_lib.xnode_udu_smem_bytes
    smem_of.restype = ctypes.c_longlong
    smem_of.argtypes = [ctypes.c_int] * 9
    cluster_smem_of = grad_lib.xnode_udu_cluster_smem_bytes
    cluster_smem_of.restype = ctypes.c_longlong
    cluster_smem_of.argtypes = [ctypes.c_int] * 9
    geoms = dict(shipped)
    for name, kw in (("2s", WIDE), ("2t", D100), ("2u", D30),
                     ("2i", dict(dim=20)), ("d=50", dict(dim=50))):
        gcfg = load_params(CONFIG).replace(**kw)
        geoms[name] = (gcfg, xnode_train.flat_net(
            init_xnode(gcfg, device="cpu")).dims())
    n_geom = 0
    for shipped_name, (gcfg, dims) in geoms.items():
        for method, mid in steppers.METHOD_IDS.items():
            for tile in (1, 2, 4, 8, 16):
                for variant, d_t in ((0, gcfg.dim), (0, 0), (1, gcfg.dim),
                                     (2, gcfg.dim)):
                    want = smem_of(variant, tile, d_t, *dims, mid)
                    got = xnode_train.tile_smem_bytes(
                        dims, d_t, method, tile, variant > 0,
                        "global" if variant == 2 else "shared")
                    if got != want:
                        raise AssertionError(
                            f"tile_smem_bytes {shipped_name} {method} "
                            f"tile={tile} d={d_t} variant={variant}: {got} "
                            f"bytes, the kernel asks for {want}")
                    n_geom += 1
                for c_size in xnode_train.CLUSTERS:
                    want = cluster_smem_of(c_size, tile, gcfg.dim, *dims,
                                           mid)
                    got = xnode_train.tile_smem_bytes(
                        dims, gcfg.dim, method, tile, True, "cluster",
                        c_size)
                    if got != want:
                        raise AssertionError(
                            f"tile_smem_bytes {shipped_name} {method} "
                            f"tile={tile} cluster={c_size}: {got} bytes, "
                            f"the kernel asks for {want}")
                    n_geom += 1
    print(f"  xnode_grad: tile_smem_bytes equals the launchers' shared "
          f"bytes at {n_geom} geometries")
    # the path-tile #1/#2: its shared bytes and staged copy in Python
    # against the launchers', at those nets, 2x's, phase 3's 96/64 and two
    # more widths past the register kernel, every method, tile and slice
    tile_lib = ctypes.CDLL(str(libs["xnode_path_tile"]))
    tile_smem_of = tile_lib.xnode_path_tile_smem_bytes
    tile_smem_of.restype = ctypes.c_longlong
    tile_smem_of.argtypes = [ctypes.c_int] * 6
    staged_of = tile_lib.xnode_path_tile_staged_floats
    staged_of.argtypes = [ctypes.c_int] * 3
    for name, kw in (("2x", WIDE128), ("96/64", NET96), ("72/80", dict(
            u_hidden_dim=72, u_hidden_hidden_dim=80)), ("256/256", dict(
                u_hidden_dim=256, u_hidden_hidden_dim=256))):
        gcfg = load_params(CONFIG).replace(**kw)
        geoms[name] = (gcfg, xnode_train.flat_net(
            init_xnode(gcfg, device="cpu")).dims())
    n_geom = 0
    for geom_name, (gcfg, dims) in geoms.items():
        H, Hh, _, _, n_field = dims
        if staged_of(H, Hh, n_field) != xnode_train.path_tile_staged_floats(
                dims):
            raise AssertionError(f"path_tile_staged_floats {geom_name}: the "
                                 f"launcher stages {staged_of(H, Hh, n_field)}")
        for method, mid in steppers.METHOD_IDS.items():
            for rows in (16, 32, 64, 128):
                for slice_ in (0,) + xnode_train.PATH_SLICES:
                    want = tile_smem_of(rows, slice_, H, Hh, n_field, mid)
                    got = xnode_train.path_tile_smem_bytes(dims, method, rows,
                                                           slice_)
                    if got != want:
                        raise AssertionError(
                            f"path_tile_smem_bytes {geom_name} {method} "
                            f"rows={rows} slice={slice_}: {got} bytes, the "
                            f"launcher asks for {want}")
                    n_geom += 1
        route = xnode_train.kernel_route(dims, 0, gcfg.solver)
        if route.path == "tile":
            print(f"  xnode_path_tile {geom_name} {dims}: {route.path_tile}, "
                  f"{xnode_train.path_tile_smem_bytes(dims, gcfg.solver, *route.path_tile)}"
                  f" bytes of shared memory a block, "
                  f"{xnode_train.PATH_TILE_THREADS} threads")
    print(f"  xnode_path_tile: path_tile_smem_bytes equals the launchers' "
          f"shared bytes at {n_geom} geometries")
    t_phase = phase_done("1", t_phase)

    cfg = load_params(CONFIG)
    problem = load_problem("Ex4_1_funcs", dim=cfg.dim)
    model = load_reference_state_dict(CKPT, device=dev, dtype=torch.float32)
    cube = Hypercube(cfg.shape_param, cfg.dim, cfg.T0, cfg.T, cfg.N_t)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pts = torch.rand((SERVE_POINTS, cfg.dim + 1), generator=gen, device=dev)
    pts[:, 1:] = cube.bot + pts[:, 1:] * (cube.top - cube.bot)
    pts[:, 0] = cfg.T0 + pts[:, 0] * (cfg.T - cfg.T0)
    batch = cube.interior(gen, cfg.N_r)
    kernels = kernel_table()
    errs = {n: 0.0 for n in kernels}

    # 2a. serving and scoring ---------------------------------------------
    zero_launches(kernels)
    with torch.no_grad():
        t = time.perf_counter()
        u_served = evaluate_points(model, pts, problem, cfg)
        torch.cuda.synchronize()
        t_serve = time.perf_counter() - t
        t = time.perf_counter()
        u_paths = u_forward_fused(model, batch, problem, cfg)
        torch.cuda.synchronize()
        t_metric = time.perf_counter() - t
    launches = read_launches(kernels)
    print(f"serving and scoring launches: {launches}")
    for n in ("xnode_eval", "xnode_train"):
        if launches[n] < 1:
            raise AssertionError(f"kernel {n} was not launched on the main path")
    ones = torch.ones((SERVE_POINTS,), dtype=torch.bool, device=dev)
    with torch.no_grad():
        u_scan = apply_xnode(model, batch, problem, cfg)
    sol_paths = problem.u_sol(batch.x)
    rel = {
        "served_points": float(rel_err(u_served, problem.u_sol(pts), ones,
                                       cube.V(), cfg.p)),
        "paths_kernel": float(rel_err(u_paths, sol_paths, batch.mask,
                                      cube.V(), cfg.p)),
        "paths_plain_scan": float(rel_err(u_scan, sol_paths, batch.mask,
                                          cube.V(), cfg.p)),
    }
    print(f"rel-L2 of the d=5 checkpoint: {rel}")
    print(f"evaluate_points: {SERVE_POINTS} points in {1e3 * t_serve:.3f} ms "
          f"(first call); u_forward_fused: {tuple(u_paths.shape)} in "
          f"{1e3 * t_metric:.3f} ms (first call)")
    if u_served.shape != (SERVE_POINTS,) or u_paths.shape != (cfg.N_r, cfg.N_t):
        raise AssertionError("main path output shapes are wrong")
    for name, value in rel.items():
        if not value < REL_L2_LIMIT:
            raise AssertionError(f"rel-L2 {name} = {value} >= {REL_L2_LIMIT}")
    scan_gap = float((u_paths - u_scan).abs().max())
    print(f"  kernel path forward vs plain scan: max abs diff {scan_gap:.3e}")
    torch.testing.assert_close(u_paths, u_scan, rtol=RTOL, atol=ATOL)
    serve_launches = launches
    t_phase = phase_done("2a", t_phase)

    # 2b. training ------------------------------------------------------
    solver = NODEWANSolver(cfg, problem,
                           work_dir=os.path.join(work_root, "2b"))
    zero_launches(kernels)
    hist = solver.train_until(TRAIN_TOL, cfg.iterations)
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    iters = hist["iterations_run"]
    print(f"training: {iters} outer iterations to rel-L2 "
          f"{hist['rel_err_final']:.6f} in {hist['wall_train_s']:.3f} s "
          f"(train_until wall clock, {card}); launches {launches}")
    want = train_launches_want(iters, cfg)
    if launches != want:
        raise AssertionError(f"training launches {launches}, expected {want}")
    if not hist["rel_err_final"] < TRAIN_TOL:
        raise AssertionError(f"training stopped at rel-L2 "
                             f"{hist['rel_err_final']} >= {TRAIN_TOL} after "
                             f"{iters} iterations")
    if not all(map(lambda v: v == v, hist["loss_u"])):
        raise AssertionError("training produced a non-finite loss_u")
    train_launches = Launches(launches, launches.variants)
    launches["xnode_eval"] = serve_launches["xnode_eval"]
    trained = solver.state.u_params
    t_phase = phase_done("2b", t_phase)

    # 2c. the command line with fused_v ------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as work:
        yaml_path = os.path.join(work, "cube_pde_fused_v.yaml")
        with open(CONFIG) as fh:
            text = fh.read()
        with open(yaml_path, "w") as fh:
            fh.write(text.rstrip("\n") + "\nfused_v: true\n")
        argv = ["--params", yaml_path, "--funcs", "Ex4_1_funcs", "-w", work,
                "--report_it", "25"]
        zero_launches(kernels)
        t = time.perf_counter()
        out, fv_solver = run_cli(cli_main, argv)
        torch.cuda.synchronize()
        t_cli = time.perf_counter() - t
        cli_launches = read_launches(kernels)
        fv_iters = fv_solver.state.step
        records = read_jsonl(os.path.join(work, f"metrics_NODE_{cfg.dim}.jsonl"))
        print(f"command line, fused_v: {fv_iters} outer iterations to rel-L2 "
              f"{records[-1]['rel_err']:.6f} in {t_cli:.3f} s (wall clock, "
              f"{card}); launches {cli_launches}")
        if "Stopping Criterion Reached" not in out:
            raise AssertionError("the fused_v command-line run did not reach "
                                 f"rel-L2 < {TRAIN_TOL} in {fv_iters} "
                                 "iterations")
        want = cli_launches_want(fv_iters, cfg, 25, cfg.iterations, True)
        sd = torch.load(os.path.join(work, "checkpoint_NODE.pt"),
                        map_location="cpu", weights_only=True)
        print(f"  chunks of {cfg.train_chunk} ending at the report steps: "
              f"{chunked_run(fv_iters, cfg.iterations, cfg.train_chunk, 25, True)}"
              f" iterations run for {fv_iters} kept; the replay to the stop "
              f"bitwise equal to the chunk's own: {fv_solver.replay_bitwise}; "
              f"checkpoint at step {sd['members'][0]['step']}")
        if cli_launches != want:
            raise AssertionError(f"command-line launches {cli_launches}, "
                                 f"expected {want}")
        if sd["members"][0]["step"] != fv_iters or \
                fv_solver.replay_bitwise is False:
            raise AssertionError("the checkpoint is not the stop iteration's "
                                 "or the replay left the chunk's metrics")
        if len(records) != fv_iters or [r["step"] for r in records] != \
                list(range(fv_iters)):
            raise AssertionError(f"{len(records)} metrics records for "
                                 f"{fv_iters} iterations")
        for name in (f"losses_NODE_{cfg.dim}.json", f"L2_NODE_{cfg.dim}.json",
                     f"Time_NODE_{cfg.dim}.json", "checkpoint_NODE.pt",
                     "best_model_weights_NODE.pth"):
            if not os.path.exists(os.path.join(work, name)):
                raise AssertionError(f"the command line wrote no {name}")
        with open(os.path.join(work, f"losses_NODE_{cfg.dim}.json")) as fh:
            if len(json.load(fh)) != fv_iters:
                raise AssertionError("losses list length != iterations")

        zero_launches(kernels)
        out_res, resumed = run_cli(cli_main,
                                   argv + ["--resume", "--iterations", "3"])
        torch.cuda.synchronize()
        resumed_launches = read_launches(kernels)
        records2 = read_jsonl(os.path.join(work,
                                           f"metrics_NODE_{cfg.dim}.jsonl"))
        n_res = len(records2)
        fresh, stop_l, first = (records[0]["loss_u"], records[-1]["loss_u"],
                                records2[0]["loss_u"])
        print(f"resumed: step {fv_iters} -> {resumed.state.step} in {n_res} "
              f"iterations; loss_u first fresh {fresh:.6g}, at the stop "
              f"{stop_l:.6g}, first resumed {first:.6g}; launches "
              f"{resumed_launches}")
        if not 1 <= n_res <= 3 or resumed.state.step != fv_iters + n_res:
            raise AssertionError("the resumed run did not continue the step "
                                 f"count ({fv_iters} + {n_res} != "
                                 f"{resumed.state.step})")
        if not abs(first - stop_l) < 0.2 * abs(stop_l):
            raise AssertionError("the resumed loss_u is not near the stop's: "
                                 "the checkpoint was not restored")
        want = cli_launches_want(n_res, cfg, 25, 3,
                                 "Stopping Criterion Reached" in out_res)
        if resumed_launches != want:
            raise AssertionError(f"resumed launches {resumed_launches}, "
                                 f"expected {want}")

        zero_launches(kernels)
        u_resumed = resumed.predict(pts)
        torch.cuda.synchronize()
        rel_resumed = float(rel_err(u_resumed, problem.u_sol(pts), ones,
                                    cube.V(), cfg.p))
        best = load_reference_state_dict(
            os.path.join(work, "best_model_weights_NODE.pth"), device=dev,
            dtype=torch.float32)
        with torch.no_grad():
            u_best = evaluate_points(best, pts, problem, cfg)
        torch.cuda.synchronize()
        c_serve = read_launches(kernels)
        rel_best = float(rel_err(u_best, problem.u_sol(pts), ones, cube.V(),
                                 cfg.p))
        print(f"served the resumed primal on {SERVE_POINTS} points: rel-L2 "
              f"{rel_resumed:.6f} (#1 by variant "
              f"{c_serve.variants['xnode_eval']}); best weights through "
              f"load_reference_state_dict: rel-L2 {rel_best:.6f}")
        check_served("the resumed primal and the best weights (2c)", c_serve,
                     2)
        if not rel_resumed < REL_L2_LIMIT:
            raise AssertionError(f"resumed primal serves at rel-L2 "
                                 f"{rel_resumed} >= {REL_L2_LIMIT}")
        if u_best.shape != (SERVE_POINTS,) or not bool(
                torch.isfinite(u_best).all()):
            raise AssertionError("the best weights serve non-finite values")
    # the shipped adversary keeps the register #6 and the shared #7
    check_variants("command line (2c)", cli_launches, {
        "disc_fwd": {"registers": cli_launches["disc_fwd"], "tile": 0},
        "disc_bwd": {"shared": cli_launches["disc_bwd"], "cluster": 0,
                     "global": 0}})
    for name in ("disc_fwd", "disc_bwd"):
        launches[name] = cli_launches[name]
    phase_launches = {"2a": serve_launches, "2b": train_launches,
                      "2c": cli_launches, "2c resume": resumed_launches,
                      "2c serve": c_serve}
    t_phase = phase_done("2c", t_phase)

    # 2d. training the shrinking cone ---------------------------------------
    ccfg = load_params(CONE_CONFIG)
    cproblem = load_problem("Ex4_1_funcs", dim=ccfg.dim)
    csolver = NODEWANSolver(ccfg, cproblem,
                            work_dir=os.path.join(work_root, "2d"))
    cone = csolver.domain
    zero_launches(kernels)
    chist = csolver.train_until(TRAIN_TOL, CONE_MAX_ITERS)
    torch.cuda.synchronize()
    cone_launches = read_launches(kernels)
    c_iters = chist["iterations_run"]
    print(f"cone training ({type(cone).__name__}, d={ccfg.dim}, "
          f"N_r={ccfg.N_r}): {c_iters} outer iterations to rel-L2 "
          f"{chist['rel_err_final']:.6f} in {chist['wall_train_s']:.3f} s "
          f"(train_until wall clock, {card}); launches {cone_launches}")
    want = train_launches_want(c_iters, ccfg)
    if cone_launches != want:
        raise AssertionError(f"cone launches {cone_launches}, expected {want}")
    if not chist["rel_err_final"] < TRAIN_TOL:
        raise AssertionError(f"the cone stopped at rel-L2 "
                             f"{chist['rel_err_final']} >= {TRAIN_TOL} after "
                             f"{c_iters} iterations")
    if not all(map(lambda v: v == v, chist["loss_u"])):
        raise AssertionError("cone training produced a non-finite loss_u")
    cpts = inside_points(cone, SERVE_POINTS, gen, cone.r)
    zero_launches(kernels)
    u_cone = csolver.predict(cpts)
    torch.cuda.synchronize()
    cone_serve = read_launches(kernels)
    rel_cone = float(rel_err(u_cone, cproblem.u_sol(cpts),
                             torch.ones_like(u_cone, dtype=torch.bool),
                             cone.V(), ccfg.p))
    print(f"served the trained cone primal through predict at "
          f"{SERVE_POINTS} points inside the cone: rel-L2 {rel_cone:.6f} "
          f"(#1 by variant {cone_serve.variants['xnode_eval']})")
    check_served("the cone (2d)", cone_serve)
    if u_cone.shape != (SERVE_POINTS,) or not rel_cone < CONE_SERVE_LIMIT:
        raise AssertionError(f"the cone serves at rel-L2 {rel_cone} >= "
                             f"{CONE_SERVE_LIMIT}")
    phase_launches["2d"] = cone_launches
    phase_launches["2d serve"] = cone_serve
    t_phase = phase_done("2d", t_phase)

    # 2e. the hourglass through the command line, fused_v -------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_hourglass_") as work:
        yaml_path = os.path.join(work, "hourglass_pde_fused_v.yaml")
        with open(HOURGLASS_CONFIG) as fh:
            text = fh.read()
        with open(yaml_path, "w") as fh:
            fh.write(text.rstrip("\n") + "\nfused_v: true\n")
        argv = ["--params", yaml_path, "--funcs", "Ex4_1_funcs", "-w", work,
                "--report_it", "5"]
        zero_launches(kernels)
        t = time.perf_counter()
        out, hsolver = run_cli(cli_main, argv + ["--iterations",
                                                 str(HOURGLASS_ITERS)])
        torch.cuda.synchronize()
        t_hcli = time.perf_counter() - t
        hg_launches = read_launches(kernels)
        hcfg, hg, hproblem = hsolver.cfg, hsolver.domain, hsolver.problem
        h_iters = hsolver.state.step
        metrics_file = os.path.join(work, f"metrics_NODE_{hcfg.dim}.jsonl")
        hrec = read_jsonl(metrics_file)
        print(f"hourglass command line, fused_v ({type(hg).__name__}, "
              f"{hg.interior_rows(hcfg.N_r)} interior rows): {h_iters} outer "
              f"iterations, rel-L2 {hrec[0]['rel_err']:.6f} -> "
              f"{hrec[-1]['rel_err']:.6f} in {t_hcli:.3f} s (wall clock, "
              f"{card}); launches {hg_launches}")
        # all the iterations, unless the problem's 1% stop came first
        stopped = "Stopping Criterion Reached" in out
        if not (h_iters == HOURGLASS_ITERS or stopped and h_iters > 1) or \
                [r["step"] for r in hrec] != list(range(h_iters)):
            raise AssertionError(f"{len(hrec)} metrics records for "
                                 f"{h_iters} of {HOURGLASS_ITERS} iterations")
        if not all(math.isfinite(r[k]) for r in hrec
                   for k in ("loss_u", "loss_v", "rel_err")):
            raise AssertionError("the hourglass run logged a non-finite loss")
        if not hrec[-1]["rel_err"] < hrec[0]["rel_err"]:
            raise AssertionError("the hourglass rel-L2 did not fall below its "
                                 "first iteration's")
        want = cli_launches_want(h_iters, hcfg, 5, HOURGLASS_ITERS, stopped)
        if hg_launches != want:
            raise AssertionError(f"hourglass launches {hg_launches}, expected "
                                 f"{want}")
        zero_launches(kernels)
        _, hresumed = run_cli(cli_main, argv + ["--resume", "--iterations",
                                                "3"])
        torch.cuda.synchronize()
        hg_res_launches = read_launches(kernels)
        hrec2 = read_jsonl(metrics_file)
        fresh, stop_l, first = (hrec[0]["loss_u"], hrec[-1]["loss_u"],
                                hrec2[0]["loss_u"])
        print(f"hourglass resumed: step {h_iters} -> {hresumed.state.step} "
              f"in {len(hrec2)} iterations; loss_u first fresh {fresh:.6g}, "
              f"last {stop_l:.6g}, first resumed {first:.6g}; launches "
              f"{hg_res_launches}")
        if len(hrec2) != 3 or hresumed.state.step != h_iters + 3:
            raise AssertionError("the resumed hourglass run did not continue "
                                 "the step count")
        if not abs(first - stop_l) < abs(first - fresh):
            raise AssertionError("the resumed hourglass loss_u is nearer the "
                                 "fresh start's than the last one's")
        if hg_res_launches != cli_launches_want(3, hcfg, 5, 3, False):
            raise AssertionError(f"resumed hourglass launches "
                                 f"{hg_res_launches}")
    hpts = inside_points(hg, SERVE_POINTS, gen, hg.r * (hg.T - hg.T0))
    h_entry, h_from_h = hg.entry(hpts)
    zero_launches(kernels)
    u_hg = hresumed.predict(hpts)
    torch.cuda.synchronize()
    hg_serve = read_launches(kernels)
    check_served("the resumed hourglass (2e)", hg_serve)
    with torch.no_grad():
        u_hg_scan = evaluate_points(hresumed.state.u_params, hpts, hproblem,
                                    hresumed.cfg.replace(use_pallas=False),
                                    domain=hg)
    n_re = int((~h_from_h).sum())
    rel_hg = float(rel_err(u_hg, hproblem.u_sol(hpts),
                           torch.ones_like(h_from_h), hg.V(), hcfg.p))
    print(f"served the resumed hourglass primal through predict at "
          f"{SERVE_POINTS} points, {n_re} of them re-entry points seeded "
          f"from g at t_entry in [{float(h_entry[~h_from_h].min()):.4f}, "
          f"{float(h_entry.max()):.4f}]; rel-L2 {rel_hg:.6f} after "
          f"{hresumed.state.step} iterations")
    if not 0.2 * SERVE_POINTS < n_re < 0.5 * SERVE_POINTS:
        raise AssertionError(f"{n_re} re-entry points of {SERVE_POINTS}")
    errs["xnode_eval"] = max(errs["xnode_eval"], compare(
        f"served hourglass, kernel #1 vs the plain scan, M={SERVE_POINTS}",
        u_hg, u_hg_scan))
    phase_launches["2e"] = hg_launches
    phase_launches["2e resume"] = hg_res_launches
    phase_launches["2e serve"] = hg_serve
    t_phase = phase_done("2e", t_phase)

    # 2f. the hourglass to 1% with the drop_lr recipe ---------------------
    hg_until = hourglass_drop_lr(kernels, os.path.join(work_root, "2f"), gen,
                                 card)
    errs["xnode_eval"] = max(errs["xnode_eval"], hg_until["err"])
    phase_launches["2f"] = hg_until["launches"]
    phase_launches["2f serve"] = hg_until["serve_launches"]
    t_phase = phase_done("2f", t_phase)

    # 2g. paper example 4.3 at d=20 ---------------------------------------
    d20 = d20_drop_lr(kernels, os.path.join(work_root, "2g"), card)
    phase_launches["2g"] = d20["launches"]
    t_phase = phase_done("2g", t_phase)

    # 2h, 2i and 2m's solver runs in a process of their own, and 2r's ranks
    # and nccl world in theirs, all started now and run beside 2j-2q: every
    # one of these loops is paced by its host thread while the card idles
    # (PERF.md section 5), and each process counts its own launches. Their
    # output is printed where 2r and 2m wait for them
    side_dir, mg_dir = (os.path.join(work_root, d) for d in ("side", "2r"))
    for d in (side_dir, mg_dir):
        os.makedirs(d, exist_ok=True)
    side_ctx = start_spawn(side_rank, 1, side_dir)
    mg_started = (start_spawn(mg_rank, 2, mg_dir),
                  start_spawn(nccl_rank, torch.cuda.device_count(), mg_dir))
    t_phase = phase_done("2h, 2i and 2r's ranks started", t_phase)

    # 2j. the WAN primal, and through the command line with fused_v ---------
    wan = wan_runs(kernels, work_root, cli_main, card)
    phase_launches["2j CLI"] = wan["cli_launches"]
    phase_launches["2j resume"] = wan["res_launches"]
    t_phase = phase_done("2j", t_phase)

    # 2k. the f64 reference-parity lane -----------------------------------
    parity = parity_lane(kernels, os.path.join(work_root, "2k"), card)
    t_phase = phase_done("2k", t_phase)

    # 2l. dopri5 at full width, and through the command line with fused_v ---
    dop = dopri5_cube(kernels, work_root, cli_main, pts, card)
    phase_launches["2l CLI"] = dop["cli_launches"]
    phase_launches["2l resume"] = dop["res_launches"]
    t_phase = phase_done("2l", t_phase)

    # 2m. the other solvers: the adaptive methods here, the solver runs in
    # the process of 2h and 2i -------------------------------------------
    f64_gap = adaptive_checks(dop)
    t_phase = phase_done("2m (adaptive methods)", t_phase)

    # 2n. the continuous adjoint and remat on the card ------------------------
    adj = adjoint_and_remat(dev, card)
    t_phase = phase_done("2n", t_phase)

    # 2o. chunked training with the exact stop --------------------------------
    chunked = chunked_cube(kernels, work_root, solver, hist, card)
    phase_launches["2o"] = chunked["launches"]
    t_phase = phase_done("2o", t_phase)

    # 2p. profile_dir through the command line ---------------------------------
    prof = profile_cli(kernels, cli_main, card)
    phase_launches["2p"] = prof["launches"]
    t_phase = phase_done("2p", t_phase)

    # 2q. the contour plot's slice ---------------------------------------------
    plot = plots(kernels, chunked["solver"], card)
    phase_launches["2q"] = plot["launches"]
    t_phase = phase_done("2q", t_phase)

    # 2r. two ranks on the card, then nccl -------------------------------------
    mg = multi_gpu(kernels, mg_dir, mg_started, hist, card)
    for r, res in enumerate(mg["ranks"]):
        for name in ("step", "until", "fused_v", "serve", "ensemble",
                     "tangent"):
            phase_launches[f"2r rank {r} {name}"] = Launches(
                res[name]["launches"], res[name]["variants"])
    print(json.dumps({"slice14": {
        "chunked": {k: chunked[k] for k in ("iterations", "rel_err", "run",
                                            "wall_s", "syncs", "step_ms",
                                            "replay_bitwise")},
        "profile": {k: prof[k] for k in ("busy_ms", "window_ms",
                                         "kernel_events", "top_ms")},
        "plot": {k: plot[k] for k in ("rel_err", "points", "ms", "png")},
        "two_ranks": {"until": {k: v for k, v in
                                mg["ranks"][0]["until"].items()
                                if k != "launches"},
                      "serve_ms": mg["ranks"][0]["serve"]["ms"],
                      "param_rel": mg["errs"], "wall_s": mg["wall_s"],
                      "nccl_bitwise": mg["nccl_bitwise"]},
        "card": card}}))
    t_phase = phase_done("2r", t_phase)

    # 2h, 2i and 2m's solver runs, from their process ------------------------
    side = join_side(side_ctx, side_dir)
    qmc, ens = side["qmc"], side["ens"]
    others = dict(side["solvers"], f64_gap=f64_gap)
    phase_launches["2h"] = qmc["launches"]
    phase_launches["2i"] = ens["launches"]
    phase_launches["2i serve"] = ens["serve_launches"]
    t_phase = phase_done("2h, 2i and 2m's solver runs (waited for)", t_phase)

    # 2s. the wide cube, #5 on clusters of blocks ---------------------------
    wide_thread.join()
    if "error" in wide_build:
        raise wide_build["error"]
    print(f"{', '.join(_build.lib_name('xnode_fwd', w) for w in wide_fwds)} "
          f"built in {wide_build['s']:.2f} s beside phases 2a-2r")
    for w in wide_fwds:
        wide_name = _build.lib_name("xnode_fwd", w)
        log = (_build.build_dir() / f"{wide_name}.log").read_text()
        print(f"  {wide_name}: " + "; ".join(
            line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line))
    wide = wide_cube(kernels, os.path.join(work_root, "2s"), pts, card)
    phase_launches["2s"] = wide["launches"]
    phase_launches["2s serve"] = wide["serve_launches"]
    t_phase = phase_done("2s", t_phase)

    # 2t. d = 100 with its Fourier bank: the register #1/#2, #3-#5 ---------
    hd = d100_fourier(kernels, os.path.join(work_root, "2t"), card)
    phase_launches["2t"] = hd["launches"]
    phase_launches["2t serve"] = hd["serve_launches"]
    t_phase = phase_done("2t", t_phase)

    # 2u. d = 30 at H = Hh = 48: chunked #3-#5 drive the training ----------
    hu = d30_cube(kernels, os.path.join(work_root, "2u"), card)
    phase_launches["2u"] = hu["launches"]
    t_phase = phase_done("2u", t_phase)

    # 2x. the cube at 128/128: the path-tile #1/#2 ---------------------------
    hwx = wide128_cube(kernels, os.path.join(work_root, "2x"), card)
    phase_launches["2x"] = hwx["launches"]
    phase_launches["2x serve"] = hwx["serve_launches"]
    print(json.dumps({"wide_nets": {
        "wide_cube": {"iterations": wide["hist"]["iterations_run"],
                      "least_rel_err": wide["best"],
                      "rel_err_final": wide["hist"]["rel_err_final"],
                      "one_percent_at": wide["hit"],
                      "served_rel_err": wide["served"],
                      "wall_train_s": wide["hist"]["wall_train_s"],
                      "route": wide["route"]._asdict()},
        "d100_fourier": {"iterations": hd["hist"]["iterations_run"],
                         "rel_err": [float(r)
                                     for r in hd["hist"]["rel_err"]],
                         "served_rel_err": hd["served"],
                         "wall_train_s": hd["hist"]["wall_train_s"],
                         "chunks": hd["chunks"],
                         "route": hd["route"]._asdict()},
        "d30_cube": {"iterations": hu["hist"]["iterations_run"],
                        "rel_err": [float(r) for r in hu["hist"]["rel_err"]],
                        "loss_u": [float(v) for v in hu["hist"]["loss_u"]],
                        "wall_train_s": hu["hist"]["wall_train_s"],
                        "chunks": hu["chunks"],
                        "route": hu["route"]._asdict()},
        "wide128_cube": {"iterations": hwx["hist"]["iterations_run"],
                         "rel_err": [float(r)
                                     for r in hwx["hist"]["rel_err"]],
                         "loss_u": [float(v) for v in hwx["hist"]["loss_u"]],
                         "wall_train_s": hwx["hist"]["wall_train_s"],
                         "serve_err": hwx["serve_err"],
                         "route": hwx["route"]._asdict()},
        "card": card}}))
    t_phase = phase_done("2x", t_phase)

    # 2v. a 256-wide adversary: the tile #6 and #7's cluster variant -----
    hv = fused_adversary(kernels, os.path.join(work_root, "2v"),
                         "the 256-wide adversary (2v)", WIDE_V,
                         ("tile", "cluster"), card)
    phase_launches["2v"] = hv["launches"]
    phase_launches["2v step"] = hv["step_launches"]
    t_phase = phase_done("2v", t_phase)

    # 2w. d = 20 with the adversary's Fourier bank at 3 frequencies -------
    hw = fused_adversary(kernels, os.path.join(work_root, "2w"),
                         "the 141-feature adversary (2w)", FOURIER_V,
                         ("registers", "shared"), card)
    phase_launches["2w"] = hw["launches"]
    phase_launches["2w step"] = hw["step_launches"]
    print(json.dumps({"wide_adversaries": {
        name: {"geom": h["geom"]._asdict(), "route": h["route"]._asdict(),
               "step_param_rel": h["step_rel"],
               "iterations": h["hist"]["iterations_run"],
               "rel_err": [float(r) for r in h["hist"]["rel_err"]],
               "loss_u": [float(v) for v in h["hist"]["loss_u"]],
               "wall_train_s": h["hist"]["wall_train_s"]}
        for name, h in (("2v", hv), ("2w", hw))}, "card": card}))
    t_phase = phase_done("2w", t_phase)

    # 3. each kernel against its plain version on the card -----------------
    net = xnode_train.flat_net(model)
    packed = net.packed()
    k_steps = max(cfg.min_steps, cfg.N_t) * cfg.n_sub
    t_pts, x_pts = pts[:, 0].contiguous(), pts[:, 1:].contiguous()
    ts = torch.full_like(t_pts, cfg.T0)
    seed = (problem.h(torch.cat([ts[:, None], x_pts], dim=-1))
            / cfg.u_scale_eff).contiguous()
    eval_args = (x_pts, t_pts, ts, seed)
    print("kernel vs plain, f32:")
    with torch.no_grad():
        for method in steppers.FUSED_KERNEL_METHODS:
            errs["xnode_eval"] = max(errs["xnode_eval"], compare(
                f"xnode_eval {method} M={SERVE_POINTS} k_steps={k_steps}",
                xnode_eval.evaluate_cuda(net, *eval_args, k_steps, method),
                xnode_eval.evaluate_plain(net, *eval_args, k_steps, method)))
        cfg_ff = cfg.replace(fourier_features=1)
        model_ff = init_xnode(cfg_ff, torch.Generator(device=dev).manual_seed(1))
        net_ff = xnode_train.flat_net(model_ff)
        ff_args = (spatial_features(x_pts, 1).contiguous(), t_pts, ts, seed)
        errs["xnode_eval"] = max(errs["xnode_eval"], compare(
            "xnode_eval midpoint fourier_features=1 (random weights)",
            xnode_eval.evaluate_cuda(net_ff, *ff_args, k_steps, "midpoint"),
            xnode_eval.evaluate_plain(net_ff, *ff_args, k_steps, "midpoint")))

        xs = batch.space[:, 0, :].contiguous()
        path_seed = (problem.h(batch.x[:, 0, :]) / cfg.u_scale_eff).contiguous()
        mask = torch.rand(batch.mask.shape, generator=gen, device=dev) < 0.7
        cases = [(m, batch.mask, cfg.n_sub) for m in steppers.FUSED_KERNEL_METHODS]
        cases += [("midpoint", mask, cfg.n_sub), ("rk4", mask, 2)]
        for method, msk, n_sub in cases:
            t0, dt = xnode_train._prep_intervals(batch.times, msk,
                                                 batch.t_start, n_sub)
            args = (t0.contiguous(), dt.contiguous(), xs, path_seed)
            label = ("interior" if msk is batch.mask else "random mask")
            errs["xnode_train"] = max(errs["xnode_train"], compare(
                f"xnode_train {method} N={cfg.N_r} L={cfg.N_t} "
                f"n_sub={n_sub} {label}",
                xnode_train.path_forward_cuda(net, *args, n_sub, method),
                xnode_train.path_forward_plain(net, *args, n_sub, method)))

        # #1 at a point count one past a whole number of blocks
        rg = torch.Generator(device=dev).manual_seed(13)
        m_rag = SERVE_POINTS + 1
        x_rag = cube.bot + torch.rand((m_rag, cfg.dim), generator=rg,
                                      device=dev) * (cube.top - cube.bot)
        rag_args = (x_rag, cfg.T0 + torch.rand((m_rag,), generator=rg,
                                              device=dev) * (cfg.T - cfg.T0),
                    torch.full((m_rag,), cfg.T0, device=dev),
                    torch.randn((m_rag,), generator=rg, device=dev))
        errs["xnode_eval"] = max(errs["xnode_eval"], compare(
            f"xnode_eval {cfg.solver} M={m_rag}",
            xnode_eval.evaluate_cuda(net, *rag_args, k_steps, cfg.solver),
            xnode_eval.evaluate_plain(net, *rag_args, k_steps, cfg.solver)))

        # kernels #3, #4, #5 with the trained weights, and Fourier features
        # with random ones; seeded random readout cotangents
        tan_inputs = [a.contiguous() for a in xnode_train.path_tangent_inputs(
            batch, problem, cfg)]
        tan_inputs_ff = [a.contiguous() for a in xnode_train.path_tangent_inputs(
            batch, problem, cfg_ff)]
        net_tr = xnode_train.flat_net(trained)
        gcases = [(m, net_tr, tan_inputs, batch.mask, cfg.n_sub)
                  for m in steppers.FUSED_KERNEL_METHODS]
        gcases += [("midpoint", net_tr, tan_inputs, mask, cfg.n_sub),
                   ("rk4", net_tr, tan_inputs, mask, 2),
                   ("midpoint", net_ff, tan_inputs_ff, batch.mask, cfg.n_sub)]
        d, N, L = cfg.dim, cfg.N_r, cfg.N_t

        def check_udu(label, gnet, args, n_sub, method, bitwise=False):
            """#3, #4 and #5 against their plain versions on ``args``."""
            n_p, l_p = args[0].shape
            d_p = args[-1].shape[1]
            gpacked = gnet.packed()
            want = xnode_train.u_du_fwd_plain(gnet, *args, n_sub, method,
                                              store=True)
            got = xnode_train.u_du_fwd_cuda(gnet, gpacked, *args, n_sub,
                                            method)
            errs["xnode_udu_fwd"] = max(
                errs["xnode_udu_fwd"],
                compare(f"xnode_udu_fwd u {label}", got[0], want[0]),
                compare_scaled(f"xnode_udu_fwd du {label}", got[1], want[1]))
            got = xnode_train.u_du_fwd_cuda(gnet, gpacked, *args, n_sub,
                                            method, store=True)
            if bitwise and not all(torch.equal(a, b) for a, b in zip(
                    got, xnode_train.u_du_fwd_cuda(gnet, gpacked, *args,
                                                   n_sub, method,
                                                   store=True))):
                raise AssertionError(f"xnode_udu_fwd_store {label}: two "
                                     "launches differ")
            errs["xnode_udu_fwd_store"] = max(
                errs["xnode_udu_fwd_store"],
                compare(f"xnode_udu_fwd_store u {label}", got[0], want[0]),
                *(compare_scaled(f"xnode_udu_fwd_store {n} {label}", g, w)
                  for n, g, w in zip(("du", "hs", "hts"), got[1:], want[1:])))
            cg = torch.Generator(device=dev).manual_seed(7)
            ub = torch.randn((n_p, l_p), generator=cg, device=dev)
            dub = torch.randn((n_p, l_p, d_p), generator=cg, device=dev)
            sizes = [a.numel() for a in gnet.flat]
            grad = xnode_train.u_du_bwd_cuda(gnet, gpacked, *args, *want[2:],
                                             ub, dub, n_sub, method)
            errs["xnode_udu_bwd"] = max(errs["xnode_udu_bwd"], compare_scaled(
                f"xnode_udu_bwd {label}", grad,
                xnode_train.u_du_bwd_plain(gnet, *args, *want[2:], ub, dub,
                                           n_sub, method), sizes))
            if bitwise:
                again = xnode_train.u_du_bwd_cuda(gnet, gpacked, *args,
                                                  *want[2:], ub, dub, n_sub,
                                                  method)
                if not torch.equal(grad, again):
                    raise AssertionError(f"xnode_udu_bwd {label}: two "
                                         "launches differ")
                print(f"  xnode_udu_fwd_store and xnode_udu_bwd {label}: two "
                      "launches each bitwise equal")

        def check_udu_near_kinks(label, gnet, args, n_sub, method,
                                 bitwise=False):
            """:func:`check_udu` on the paths at least ``KINK_MARGIN`` from
            a relu kink (all of them where none comes nearer); where some
            do, all the paths at ``KINK_RTOL`` of each tensor's largest
            value, and #5 twice on all of them."""
            gnet64 = FlatNet([a.double() for a in gnet.flat], gnet.n_lift,
                             gnet.n_field)
            t0_, dt_, feats_, _, seed_, _ = args
            keep = xnode_train.relu_margins(
                gnet64, t0_.double(), dt_.double(), feats_.double(),
                seed_.double(), n_sub, method) >= KINK_MARGIN
            n_p = keep.numel()
            if bool(keep.all()):
                check_udu(f"{label} N={n_p}", gnet, args, n_sub, method,
                          bitwise)
                return
            print(f"  {label}: {int((~keep).sum())} of {n_p} paths come "
                  f"within {KINK_MARGIN} of a relu kink and are left out")
            check_udu(f"{label} N={int(keep.sum())}", gnet,
                      [a[keep].contiguous() for a in args], n_sub, method)
            want = xnode_train.u_du_fwd_plain(gnet, *args, n_sub, method,
                                              store=True)
            got = xnode_train.u_du_fwd_cuda(gnet, gnet.packed(), *args,
                                            n_sub, method, store=True)
            if bitwise and not all(torch.equal(a, b) for a, b in zip(
                    got, xnode_train.u_du_fwd_cuda(gnet, gnet.packed(), *args,
                                                   n_sub, method,
                                                   store=True))):
                raise AssertionError(f"xnode_udu_fwd_store {label}: two "
                                     "launches differ")
            cg = torch.Generator(device=dev).manual_seed(7)
            ub = torch.randn(args[0].shape, generator=cg, device=dev)
            dub = torch.randn((*args[0].shape, args[-1].shape[1]),
                              generator=cg, device=dev)
            g_k = xnode_train.u_du_bwd_cuda(gnet, gnet.packed(), *args,
                                            *want[2:], ub, dub, n_sub, method)
            g_p = xnode_train.u_du_bwd_plain(gnet, *args, *want[2:], ub, dub,
                                             n_sub, method)
            sizes = [a.numel() for a in gnet.flat]
            for part, g, w, sz in zip(("u", "du", "hs", "hts", "grad"),
                                      (*got, g_k), (*want, g_p),
                                      (None,) * 4 + (sizes,)):
                compare_scaled(f"{label} {part}, all {n_p} paths", g, w, sz,
                               limit=KINK_RTOL)
            if bitwise:
                if not torch.equal(g_k, xnode_train.u_du_bwd_cuda(
                        gnet, gnet.packed(), *args, *want[2:], ub, dub,
                        n_sub, method)):
                    raise AssertionError(f"xnode_udu_bwd {label}: two "
                                         "launches differ")
                print(f"  xnode_udu_fwd_store and xnode_udu_bwd {label}, all "
                      f"{n_p} paths: two launches each bitwise equal")

        for method, gnet, inputs, msk, n_sub in gcases:
            t0, dt = [a.contiguous() for a in xnode_train._prep_intervals(
                batch.times, msk, batch.t_start, n_sub)]
            label = (f"{method} n_sub={n_sub} "
                     f"{'interior' if msk is batch.mask else 'random mask'}"
                     f"{' fourier_features=1' if gnet is net_ff else ''}")
            check_udu(label, gnet, (t0, dt, *inputs), n_sub, method,
                      bitwise=gnet is net_tr and msk is batch.mask
                      and method == cfg.solver)

        # ragged path counts (the last tile part full), trained weights
        rgen = torch.Generator(device=dev).manual_seed(11)
        for n_rag in (4001, 37):
            rbatch = cube.interior(rgen, n_rag)
            t0, dt = [a.contiguous() for a in xnode_train._prep_intervals(
                rbatch.times, rbatch.mask, rbatch.t_start, cfg.n_sub)]
            rin = [a.contiguous() for a in xnode_train.path_tangent_inputs(
                rbatch, problem, cfg)]
            check_udu(f"{cfg.solver} N={n_rag}", net_tr, (t0, dt, *rin),
                      cfg.n_sub, cfg.solver, bitwise=True)
            fwd_args = (t0, dt, rin[0], rin[2], cfg.n_sub, cfg.solver)
            errs["xnode_train"] = max(errs["xnode_train"], compare(
                f"xnode_train {cfg.solver} N={n_rag}",
                xnode_train.path_forward_cuda(net_tr, *fwd_args),
                xnode_train.path_forward_plain(net_tr, *fwd_args)))

        # the highdim_d20 geometry: H = 24, Hh = 32, d = 20 with its Fourier
        # bank (F = 60), random weights, one interior batch
        cfg20 = load_params(os.path.join(ROOT, "configs", "highdim_d20.yaml"))
        g20 = torch.Generator(device=dev).manual_seed(5)
        net20 = xnode_train.flat_net(init_xnode(cfg20, g20))
        cube20 = Hypercube(cfg20.shape_param, cfg20.dim, cfg20.T0, cfg20.T,
                           cfg20.N_t)
        batch20 = cube20.interior(g20, D20_PATHS)
        t0, dt = [a.contiguous() for a in xnode_train._prep_intervals(
            batch20.times, batch20.mask, batch20.t_start, cfg20.n_sub)]
        in20 = [a.contiguous() for a in xnode_train.path_tangent_inputs(
            batch20, load_problem("Ex4_1_funcs", dim=cfg20.dim), cfg20)]
        # #1 and #2 at these widths: a library of their own
        fwd_args = (t0, dt, in20[0], in20[2], cfg20.n_sub, cfg20.solver)
        errs["xnode_train"] = max(errs["xnode_train"], compare(
            f"xnode_train highdim_d20 {cfg20.solver} N={D20_PATHS} "
            f"F={net20.F}", xnode_train.path_forward_cuda(net20, *fwd_args),
            xnode_train.path_forward_plain(net20, *fwd_args)))
        k20 = max(cfg20.min_steps, cfg20.N_t) * cfg20.n_sub
        x20 = 2.0 * torch.rand((m_rag, cfg20.dim), generator=g20,
                               device=dev) - 1.0
        ev20 = (spatial_features(x20, cfg20.fourier_features).contiguous(),
                cfg20.T0 + torch.rand((m_rag,), generator=g20, device=dev)
                * (cfg20.T - cfg20.T0),
                torch.full((m_rag,), cfg20.T0, device=dev),
                torch.randn((m_rag,), generator=g20, device=dev))
        errs["xnode_eval"] = max(errs["xnode_eval"], compare(
            f"xnode_eval highdim_d20 {cfg20.solver} M={m_rag} k_steps={k20} "
            f"F={net20.F}",
            xnode_eval.evaluate_cuda(net20, *ev20, k20, cfg20.solver),
            xnode_eval.evaluate_plain(net20, *ev20, k20, cfg20.solver)))
        check_udu_near_kinks(f"highdim_d20 {cfg20.solver} F={net20.F}",
                             net20, (t0, dt, *in20), cfg20.n_sub,
                             cfg20.solver, bitwise=True)

    # the autograd function's weight gradients against autograd through
    # the plain forward, on the main path's batch with the trained weights
    cu = torch.randn((N, L), generator=gen, device=dev)
    cd = torch.randn((N, L, d), generator=gen, device=dev)

    def contraction(u, du):
        return (u * cu).sum() + (du * cd).sum() + (torch.tanh(u) * du[..., 0]).sum()

    params = list(trained.parameters())
    g_fn = torch.autograd.grad(contraction(*xnode_train.fused_from_batch(
        trained, batch, problem, cfg)), params)
    leaves = [a.clone().requires_grad_(True) for a in net_tr.flat]
    t0, dt = xnode_train._prep_intervals(batch.times, batch.mask,
                                         batch.t_start, cfg.n_sub)
    u_p, du_p = xnode_train.u_du_fwd_plain(
        FlatNet(leaves, net_tr.n_lift, net_tr.n_field), t0, dt, *tan_inputs,
        cfg.n_sub, cfg.solver)
    g_ad = torch.autograd.grad(contraction(u_p, du_p), leaves)
    compare_scaled("UDuFused.backward vs autograd through the plain forward",
                   torch.cat([g.reshape(-1) for g in g_fn]),
                   torch.cat([g.reshape(-1) for g in g_ad]),
                   [g.numel() for g in g_ad])

    # kernels #6 and #7 at the main path's 80,000 points: the trained tied
    # adversary of 2c, an untied one and the d=20 geometry with its
    # Fourier bank, tied and untied (random weights, seeded random
    # cotangents); the untied d=20 net is the one that takes #7's 8-point
    # tiles with their unpadded rows
    vpts = batch.x.reshape(-1, cfg.dim + 1).contiguous()
    M_v = vpts.shape[0]
    vg = torch.Generator(device=dev).manual_seed(3)
    pts20 = torch.rand((M_v, cfg20.dim + 1), generator=vg, device=dev)
    pts20[:, 1:] = 2.0 * pts20[:, 1:] - 1.0
    dcases = [
        ("tied d=5, trained", fv_solver.state.v_params, vpts, cfg.v_layers,
         True, 0),
        ("untied d=5, random", init_discriminator(
            cfg.dim, cfg.v_hidden_dim, cfg.v_layers, False, 0, generator=vg,
            device=dev), vpts, cfg.v_layers, False, 0),
        ("tied d=20 v_fourier_features=1, random", init_discriminator(
            cfg20.dim, cfg20.v_hidden_dim, cfg20.v_layers, True,
            cfg20.v_fourier_features, generator=vg, device=dev), pts20,
         cfg20.v_layers, True, cfg20.v_fourier_features),
        ("untied d=20 v_fourier_features=1, random", init_discriminator(
            cfg20.dim, cfg20.v_hidden_dim, cfg20.v_layers, False,
            cfg20.v_fourier_features, generator=vg, device=dev), pts20,
         cfg20.v_layers, False, cfg20.v_fourier_features)]
    with torch.no_grad():
        for label, vp, dpts, n_layers, tied, n_freq in dcases:
            geom = disc_train.geom_of(vp, n_layers, tied)
            dpacked = disc_train.live_packed_disc(vp, n_layers,
                                                  tied).detach()
            dfeats = disc_train.disc_features(dpts, n_freq).contiguous()
            v_k, g_k = disc_train.v_dv_fwd_cuda(dpacked, dfeats, geom)
            v_p, g_p = disc_train.v_dv_fwd_plain(dpacked, dfeats, geom)
            label = f"{label} M={M_v} {geom}"
            errs["disc_fwd"] = max(errs["disc_fwd"],
                                   compare(f"disc_fwd v {label}", v_k, v_p),
                                   compare_scaled(f"disc_fwd gin {label}",
                                                  g_k, g_p))
            vb = torch.randn((M_v,), generator=vg, device=dev)
            gb = torch.randn((M_v, geom.F), generator=vg, device=dev)
            sizes = [a.numel() for a in disc_train.flat_disc(vp, n_layers,
                                                             tied)]
            g_bwd = disc_train.v_dv_bwd_cuda(dpacked, dfeats, vb, gb, geom)
            errs["disc_bwd"] = max(errs["disc_bwd"], compare_scaled(
                f"disc_bwd {label}", g_bwd,
                disc_train.v_dv_bwd_plain(dpacked, dfeats, vb, gb, geom),
                sizes))
            if not torch.equal(g_bwd, disc_train.v_dv_bwd_cuda(
                    dpacked, dfeats, vb, gb, geom)):
                raise AssertionError(f"disc_bwd {label}: two launches differ")
            print(f"  disc_bwd {label}, "
                  f"{disc_train.disc_route(geom).bwd_tile}-point "
                  "tiles: two launches bitwise equal")
        # #6 and #7 at point counts one past a whole number of blocks (and
        # of #7's tiles) and under one block: the trained adversary, and
        # the untied one (the trained one's relu layers die in training, so
        # its gin is zero)
        for label, vp, _, n_layers, tied, _ in dcases[:2]:
            geom = disc_train.geom_of(vp, n_layers, tied)
            dpacked = disc_train.live_packed_disc(vp, n_layers,
                                                  tied).detach()
            sizes = [a.numel() for a in disc_train.flat_disc(vp, n_layers,
                                                             tied)]
            for m_rag in (M_v + 1, 37):
                rpts = cube.interior(vg, -(-m_rag // cfg.N_t)).x.reshape(
                    -1, cfg.dim + 1)[:m_rag]
                dfeats = disc_train.disc_features(rpts, 0).contiguous()
                v_k, g_k = disc_train.v_dv_fwd_cuda(dpacked, dfeats, geom)
                v_p, g_p = disc_train.v_dv_fwd_plain(dpacked, dfeats, geom)
                rlabel = f"{label} M={m_rag} {geom}"
                errs["disc_fwd"] = max(
                    errs["disc_fwd"],
                    compare(f"disc_fwd v {rlabel}", v_k, v_p),
                    compare_scaled(f"disc_fwd gin {rlabel}", g_k, g_p))
                vb = torch.randn((m_rag,), generator=vg, device=dev)
                gb = torch.randn((m_rag, geom.F), generator=vg, device=dev)
                errs["disc_bwd"] = max(errs["disc_bwd"], compare_scaled(
                    f"disc_bwd {rlabel}",
                    disc_train.v_dv_bwd_cuda(dpacked, dfeats, vb, gb, geom),
                    disc_train.v_dv_bwd_plain(dpacked, dfeats, vb, gb, geom),
                    sizes))

    # the fused adversary side's weight gradients (#6 forward, #7
    # backward) against autograd through the plain create_graph path, in
    # a contraction shaped like loss_v
    def fused_v_vs_plain(label, s, pts_x, func_w):
        n_p, l_p, c_p = pts_x.shape
        cv = torch.randn((n_p, l_p), generator=gen, device=dev)
        cp = torch.randn((n_p, l_p), generator=gen, device=dev)
        cdp = torch.randn((n_p, l_p, c_p), generator=gen, device=dev)

        def v_contraction(v, phi, dphi):
            return ((v * v * cv).sum() + (phi * cp).sum()
                    + (dphi * cdp).sum()
                    + (torch.tanh(phi) * dphi[..., 0]).sum())

        vleaves = list(s.state.v_params.parameters())
        g_fused = torch.autograd.grad(v_contraction(
            *weak_form.v_phi_grads_fused(s.state.v_params, pts_x, func_w,
                                         s.cfg)), vleaves)
        g_plain = torch.autograd.grad(v_contraction(
            *weak_form.v_phi_and_grads(s._v_apply, s.state.v_params, pts_x,
                                       func_w)), vleaves)
        compare_scaled("VDvFused.backward vs autograd through the plain "
                       f"create_graph path{label}",
                       torch.cat([g.reshape(-1) for g in g_fused]),
                       torch.cat([g.reshape(-1) for g in g_plain]),
                       [g.numel() for g in g_plain])

    fused_v_vs_plain("", fv_solver, batch.x, fv_solver.domain.func_w)
    vparams = fv_solver.state.v_params

    # the moving domains' inputs: rows that die partway (cone), g-seeded
    # re-entry rows that start after T0 and rows dead in every sample
    # (hourglass interior), zero-length paths whose every dt is 0
    # (hourglass boundary); the trained cone primal, the resumed hourglass
    # one
    print("kernel vs plain on the moving domains' inputs, f32:")
    mg = torch.Generator(device=dev).manual_seed(17)
    mbatches = [("cone interior", cone.interior(mg, ccfg.N_r), csolver),
                ("hourglass interior", hg.interior(mg, hcfg.N_r), hresumed),
                ("hourglass boundary", hg.boundary(mg, hcfg.N_b), hresumed)]
    with torch.no_grad():
        for label, mb, ms in mbatches:
            mcfg = ms.cfg
            mnet = xnode_train.flat_net(ms.state.u_params)
            t0, dt = [a.contiguous() for a in xnode_train._prep_intervals(
                mb.times, mb.mask, mb.t_start, mcfg.n_sub)]
            m_in = [a.contiguous() for a in xnode_train.path_tangent_inputs(
                mb, ms.problem, mcfg)]
            live, late = mb.mask.any(1), ~mb.seed_from_h
            kinds = {"dead in every sample": int((~live).sum()),
                     "dying partway": int((live & ~mb.mask.all(1)).sum()),
                     "g-seeded from t_start > T0": int(
                         (late & (mb.t_start > ms.cfg.T0)).sum()),
                     "with every dt 0": int((dt == 0).all(1).sum())}
            print(f"  {label}: {mb.x.shape[0]} rows, {kinds}")
            need = {"cone interior": ("dying partway",),
                    "hourglass interior": ("dead in every sample",
                                           "g-seeded from t_start > T0"),
                    "hourglass boundary": ("g-seeded from t_start > T0",
                                           "with every dt 0")}[label]
            if not all(kinds[k] > 0 for k in need):
                raise AssertionError(f"{label}: no rows {need}")
            fwd_args = (t0, dt, m_in[0], m_in[2], mcfg.n_sub, mcfg.solver)
            errs["xnode_train"] = max(errs["xnode_train"], compare(
                f"xnode_train {mcfg.solver} {label} N={mb.x.shape[0]}",
                xnode_train.path_forward_cuda(mnet, *fwd_args),
                xnode_train.path_forward_plain(mnet, *fwd_args)))
            check_udu_near_kinks(f"{mcfg.solver} {label}", mnet,
                                 (t0, dt, *m_in), mcfg.n_sub, mcfg.solver,
                                 bitwise=label == "hourglass interior")

        # #1 at the hourglass's served points, from their entry times
        # with the h- or g-seed there
        hcfg_r = hresumed.cfg
        hnet = xnode_train.flat_net(hresumed.state.u_params)
        hx = hpts[:, 1:].contiguous()
        entry_pts = torch.cat([h_entry[:, None], hx], dim=-1)
        hseed = (torch.where(h_from_h, hproblem.h(entry_pts),
                             hproblem.g(entry_pts))
                 / hcfg_r.u_scale_eff).contiguous()
        h_args = (spatial_features(hx, hcfg_r.fourier_features).contiguous(),
                  hpts[:, 0].contiguous(), h_entry.contiguous(), hseed)
        hk = max(hcfg_r.min_steps, hcfg_r.N_t) * hcfg_r.n_sub
        errs["xnode_eval"] = max(errs["xnode_eval"], compare(
            f"xnode_eval hourglass entry points M={SERVE_POINTS} ({n_re} "
            f"from t_entry > T0) k_steps={hk}",
            xnode_eval.evaluate_cuda(hnet, *h_args, hk, hcfg_r.solver),
            xnode_eval.evaluate_plain(hnet, *h_args, hk, hcfg_r.solver)))

    # #6/#7 with the hourglass's time-dependent cutoff w = R(t) - |x|
    hg_batch = mbatches[1][1]
    fused_v_vs_plain(", hourglass interior", hresumed, hg_batch.x, hg.func_w)

    # the per-exit-group objective (its values and the gradients of its
    # loss in u, grad u, v, phi, grad phi) twice on the same card inputs
    for label, mb, ms in mbatches[:2]:
        with torch.no_grad():
            sides = (*ms._losses.u_side(ms.state.u_params, mb),
                     *ms._losses.v_side(ms.state.v_params, mb))

        def grouped():
            leaves = [a.detach().clone().requires_grad_(True) for a in sides]
            out = weak_form.grouped_interior_objective(
                *leaves, mb, ms.problem, ms.domain, s1_raw_v=ms.cfg.s1_raw_v)
            return ([o.detach() for o in out]
                    + list(torch.autograd.grad(out[0], leaves)))

        first, again = grouped(), grouped()
        if not all(bool(torch.isfinite(a).all()) for a in first):
            raise AssertionError(f"grouped objective {label}: non-finite")
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"grouped objective {label}: two "
                                 "evaluations differ")
        groups = len(set(weak_form._endpoint_indices(mb.mask)[1][
            mb.mask.any(1)].tolist()))
        print(f"  grouped objective {label}: int {float(first[0]):.6g}, "
              f"I {float(first[1]):.6g}, norm {float(first[2]):.6g} over "
              f"{groups} exit groups; values and input gradients of two "
              "evaluations bitwise equal")

    checked = variant_checks(
        L=L, N=N, batch=batch, batch20=batch20, cfg=cfg, cfg20=cfg20,
        cube=cube, check_udu=check_udu,
        check_udu_near_kinks=check_udu_near_kinks, d=d, dev=dev,
        errs=errs, eval_args=eval_args, hd=hd, hu=hu, hx=hwx, in20=in20,
        k_steps=k_steps,
        net=net, net_tr=net_tr, path_seed=path_seed, problem=problem,
        pts=pts, tan_inputs=tan_inputs, wide=wide, xs=xs)
    adv_checked = adversary_checks(cube=cube, dev=dev, hv=hv, hw=hw,
                                   vpts=vpts)
    t_phase = phase_done("3", t_phase)

    # 4. times at the main path's shapes ------------------------------------
    t0, dt = xnode_train._prep_intervals(batch.times, batch.mask,
                                         batch.t_start, cfg.n_sub)
    t0, dt = t0.contiguous(), dt.contiguous()
    path_args = (t0, dt, xs, path_seed)
    method = cfg.solver
    evals = steppers.EVALS_PER_STEP[method]
    once, per_eval = steppers.field_macs(net)
    lift_read = steppers.lift_readout_macs(net)
    n_w = packed.numel()

    def flops_per_path(steps):
        return 2.0 * (lift_read + once + steps * evals * per_eval)

    M = SERVE_POINTS
    work = {"xnode_eval": (M * flops_per_path(k_steps),
                           4.0 * (M * (net.F + 3) + n_w + M))}
    work.update(path_work(net_tr, steppers, N, L, d, cfg.n_sub, method))
    tr_packed = net_tr.packed()
    gargs = (t0, dt, *tan_inputs)
    with torch.no_grad():
        states = xnode_train.u_du_fwd_cuda(net_tr, tr_packed, *gargs,
                                           cfg.n_sub, method, store=True)[2:]
    cg = torch.Generator(device=dev).manual_seed(8)
    ub = torch.randn((N, L), generator=cg, device=dev)
    dub = torch.randn((N, L, d), generator=cg, device=dev)
    # #6 and #7: the trained adversary of 2c on the interior batch's points
    vgeom = disc_train.geom_of(vparams, cfg.v_layers, cfg.tied_v)
    vpacked = disc_train.live_packed_disc(vparams, cfg.v_layers,
                                          cfg.tied_v).detach()
    vb = torch.randn((M_v,), generator=cg, device=dev)
    gb = torch.randn((M_v, vgeom.F), generator=cg, device=dev)
    work.update(disc_work(vgeom, M_v))
    with torch.no_grad():
        timed = {
            "xnode_eval": (
                lambda: xnode_eval.evaluate_cuda(net, *eval_args, k_steps,
                                                 method, packed=packed),
                lambda: xnode_eval.evaluate_plain(net, *eval_args, k_steps,
                                                  method)),
            "xnode_train": (
                lambda: xnode_train.path_forward_cuda(net, *path_args,
                                                      cfg.n_sub, method,
                                                      packed=packed),
                lambda: xnode_train.path_forward_plain(net, *path_args,
                                                       cfg.n_sub, method)),
            "xnode_udu_fwd": (
                lambda: xnode_train.u_du_fwd_cuda(net_tr, tr_packed, *gargs,
                                                  cfg.n_sub, method),
                lambda: xnode_train.u_du_fwd_plain(net_tr, *gargs, cfg.n_sub,
                                                   method)),
            "xnode_udu_fwd_store": (
                lambda: xnode_train.u_du_fwd_cuda(net_tr, tr_packed, *gargs,
                                                  cfg.n_sub, method, True),
                lambda: xnode_train.u_du_fwd_plain(net_tr, *gargs, cfg.n_sub,
                                                   method, True)),
            "xnode_udu_bwd": (
                lambda: xnode_train.u_du_bwd_cuda(net_tr, tr_packed, *gargs,
                                                  *states, ub, dub,
                                                  cfg.n_sub, method),
                lambda: xnode_train.u_du_bwd_plain(net_tr, *gargs, *states,
                                                   ub, dub, cfg.n_sub,
                                                   method)),
            "disc_fwd": (
                lambda: disc_train.v_dv_fwd_cuda(vpacked, vpts, vgeom),
                lambda: disc_train.v_dv_fwd_plain(vpacked, vpts, vgeom)),
            "disc_bwd": (
                lambda: disc_train.v_dv_bwd_cuda(vpacked, vpts, vb, gb,
                                                 vgeom),
                lambda: disc_train.v_dv_bwd_plain(vpacked, vpts, vb, gb,
                                                  vgeom)),
        }
        meta = {
            "xnode_eval": ("xnode_wan_tpu_torch/csrc/xnode_fwd.cu",
                           "xnode_wan_tpu/ops/pallas/xnode_eval.py:60"),
            "xnode_train": ("xnode_wan_tpu_torch/csrc/xnode_fwd.cu",
                            "xnode_wan_tpu/ops/pallas/xnode_train.py:325"),
            "xnode_udu_fwd": ("xnode_wan_tpu_torch/csrc/xnode_grad.cu",
                              "xnode_wan_tpu/ops/pallas/xnode_train.py:241"),
            "xnode_udu_fwd_store": ("xnode_wan_tpu_torch/csrc/xnode_grad.cu",
                                    "xnode_wan_tpu/ops/pallas/xnode_train.py:264"),
            "xnode_udu_bwd": ("xnode_wan_tpu_torch/csrc/xnode_grad.cu",
                              "xnode_wan_tpu/ops/pallas/xnode_train.py:432"),
            "disc_fwd": ("xnode_wan_tpu_torch/csrc/disc_fwd.cu",
                         "xnode_wan_tpu/ops/pallas/disc_train.py:95"),
            "disc_bwd": ("xnode_wan_tpu_torch/csrc/disc_train.cu",
                         "xnode_wan_tpu/ops/pallas/disc_train.py:103"),
        }
        rows = []
        print(f"times ({card}), kernel the median of 20 CUDA-event runs, "
              f"plain of 5, {method}; #6 and #7 on {M_v} points, {vgeom}:")
        for name, (kern, plain) in timed.items():
            ms = time_ms(kern)
            plain_ms = time_ms(plain, reps=5, warmup=1)
            bound_ms, bound_by = bound(*work[name])
            print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {1e3 * bound_ms:.2f} us ({bound_by}; "
                  f"{work[name][0] / 1e9:.3f} GFLOP, "
                  f"{work[name][1] / 1e6:.3f} MB), "
                  f"{work[name][0] / (ms * 1e-3) / 1e12:.3f} TFLOP/s")
            rows.append({
                "name": name, "route": "cuda", "source": meta[name][0],
                "replaces": meta[name][1], "launches": launches[name],
                "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None,
                "phases": {p: c[name] for p, c in phase_launches.items()
                           if c.get(name)},
            })

        var_errs = dict(checked.pop("var_errs"),
                        **{f"{k} variants": v
                           for k, v in adv_checked["errs"].items()})
        var_rows = variant_times(card=card, cfg=cfg, cg=cg, dev=dev, hd=hd,
                                 hu=hu, hx=hwx,
                                 method=method, net=net,
                                 phase_launches=phase_launches, work=work,
                                 **checked)
        var_rows += adversary_times(card=card, checked=adv_checked,
                                    phase_launches=phase_launches)
        for row in rows:
            row["variants"] = {
                p: c.variants[row["name"]] for p, c in phase_launches.items()
                if c.get(row["name"]) and row["name"] in getattr(
                    c, "variants", {})}
            row["variant_times"] = [
                {k: v for k, v in vr.items() if k != "kernel"}
                for vr in var_rows if vr["kernel"] == row["name"]]
        # #1/#2's path-tile kernel (csrc/xnode_path_tile.cu) as kernels of
        # their own: launched on 2x's path, timed at its shapes
        for name, phase in (("xnode_eval", "2x serve"), ("xnode_train", "2x")):
            n_tile = phase_launches[phase].variants[name]["tile"]
            if n_tile < 1:
                raise AssertionError(f"{name}'s path-tile kernel was not "
                                     f"launched in {phase}")
            vr = next(r for r in var_rows
                      if r["kernel"] == name and r["phase"] == phase)
            rows.append({
                "name": f"{name} tile", "route": "cuda",
                "source": "xnode_wan_tpu_torch/csrc/xnode_path_tile.cu",
                "replaces": meta[name][1], "launches": n_tile,
                "max_abs_err": var_errs[f"{name} tile"], "ms": vr["ms"],
                "plain_ms": vr["plain_ms"], "bound_ms": vr["bound_ms"],
                "bound_by": vr["bound_by"], "library_ms": None,
                "phases": {phase: n_tile}, "variant": vr["variant"]})
        print(json.dumps({"kernel_variants": {
            "errs": var_errs, "times": var_rows, "card": card}}))
    kernel_ms = {row["name"]: row["ms"] for row in rows}
    t_phase = phase_done("4", t_phase)

    # 5. the entry points, steady state ------------------------------------
    def score():
        return rel_err(u_forward_fused(model, batch, problem, cfg),
                       problem.u_sol(batch.x), batch.mask, cube.V(), cfg.p)

    with torch.no_grad():
        serve_ms = time_ms(lambda: evaluate_points(model, pts, problem, cfg),
                           reps=10)
        score_ms = time_ms(score, reps=10)
    print(f"entry points ({card}), median of 10 CUDA-event runs: "
          f"evaluate_points {M} points {serve_ms:.4f} ms "
          f"({M / (serve_ms * 1e-3):.4g} points/s, kernel "
          f"{kernel_ms['xnode_eval'] / serve_ms:.1%} of it); "
          f"u_forward_fused + rel_err {N} paths {score_ms:.4f} ms (kernel "
          f"{kernel_ms['xnode_train'] / score_ms:.1%} of it)")

    # one training outer step and what takes its time (the trained states
    # take these extra steps; the launch counts were read above). The
    # plain and the fused_v step (the first command-line run's solver) are
    # timed in turns, plain, fused, fused, plain, since the host-bound
    # parts drift within a call
    step_runs = [time_ms(lambda: solver._outer_step(), STEP_REPS, 1)]
    fv_runs = [time_ms(lambda: fv_solver._outer_step(), STEP_REPS, 1)]
    fv_runs.append(time_ms(lambda: fv_solver._outer_step(), STEP_REPS))
    step_runs.append(time_ms(lambda: solver._outer_step(), STEP_REPS))
    step_ms, fv_step_ms = statistics.mean(step_runs), statistics.mean(fv_runs)
    sbatch, bbatch, _ = solver._sample(solver.state.generator)
    state = solver.state

    def bdry_fwd():
        return weak_form.bdry_loss(apply_xnode, state.u_params, bbatch,
                                   problem, solver.cfg)

    def bdry_fwd_bwd():
        torch.autograd.grad(bdry_fwd(), list(state.u_params.parameters()))

    fwd_ms = time_ms(bdry_fwd, reps=10)
    bdry_bwd_ms = time_ms(bdry_fwd_bwd, reps=10) - fwd_ms
    vside_ms = time_ms(lambda: solver._losses.v_side(state.v_params, sbatch),
                       reps=10)
    per_step = {"xnode_train (#2)": kernel_ms["xnode_train"],
                "xnode_udu_fwd (#3)": kernel_ms["xnode_udu_fwd"],
                "xnode_udu_fwd_store (#4)":
                    cfg.n1 * kernel_ms["xnode_udu_fwd_store"],
                "xnode_udu_bwd (#5)": cfg.n1 * kernel_ms["xnode_udu_bwd"],
                "boundary scan forward": cfg.n1 * fwd_ms,
                "boundary scan backward": cfg.n1 * bdry_bwd_ms,
                "v_side": (1 + cfg.n2) * vside_ms}
    print(f"training outer step ({card}), mean of two medians of "
          f"{STEP_REPS} "
          f"CUDA-event runs {step_runs}: {step_ms:.4f} ms; shares, from each "
          "part timed alone times its calls per step:")
    for name, ms in per_step.items():
        print(f"  {name}: {ms:.4f} ms, {ms / step_ms:.1%}")
    print(f"  rest (sampling, losses, Adam, host): "
          f"{step_ms - sum(per_step.values()):.4f} ms")
    print(json.dumps({"training": {
        "iterations": iters, "rel_err_final": hist["rel_err_final"],
        "wall_train_s": hist["wall_train_s"], "step_ms": step_ms,
        "parts_ms": per_step}}))

    # the fused_v outer step: the adversary side through #6 twice and #7
    # once, beside the plain one
    fv_batch, _, _ = fv_solver._sample(fv_solver.state.generator)
    with torch.no_grad():
        fv_vside_ms = time_ms(lambda: fv_solver._losses.v_side(
            fv_solver.state.v_params, fv_batch), reps=10)
    fv_parts = {"disc_fwd (#6), 2 launches": 2 * kernel_ms["disc_fwd"],
                "disc_bwd (#7), 1 launch": kernel_ms["disc_bwd"]}

    # the adversary step alone (the n2 part of _step_on): loss_v on a
    # fixed u side, forward and weight gradient, in turns
    def adversary_step(s):
        b, _, _ = s._sample(s.state.generator)
        with torch.no_grad():
            uside = s._losses.u_side(s.state.u_params, b)
        leaves = list(s.state.v_params.parameters())

        def run():
            loss, _ = s._losses.loss_v_uside(s.state.v_params, uside, b)
            torch.autograd.grad(loss, leaves)
        return run

    adv_plain, adv_fused = adversary_step(solver), adversary_step(fv_solver)
    adv_runs = [time_ms(adv_plain, reps=10), time_ms(adv_fused, reps=10),
                time_ms(adv_fused, reps=10), time_ms(adv_plain, reps=10)]
    adv_plain_ms = statistics.mean(adv_runs[::3])
    adv_fused_ms = statistics.mean(adv_runs[1:3])
    print(f"fused_v outer step ({card}), mean of two medians of "
          f"{STEP_REPS} "
          f"CUDA-event runs {fv_runs}: {fv_step_ms:.4f} ms (plain step in "
          f"turns with it: {step_ms:.4f} ms)")
    for name, ms in fv_parts.items():
        print(f"  {name}: {ms:.4f} ms, {ms / fv_step_ms:.1%}")
    print(f"  fused v_side without gradient (#6 and the cutoff), timed "
          f"alone: {fv_vside_ms:.4f} ms a call; plain v_side with its "
          f"create_graph graph: {vside_ms:.4f} ms a call, "
          f"{per_step['v_side']:.4f} ms a step, "
          f"{per_step['v_side'] / step_ms:.1%} of the plain step")
    print(f"  adversary step alone (loss_v and its weight gradient on a "
          f"fixed u side), plain, fused, fused, plain {adv_runs}: plain "
          f"{adv_plain_ms:.4f} ms, fused {adv_fused_ms:.4f} ms")
    print(json.dumps({"training_fused_v": {
        "adversary_step_ms": adv_fused_ms,
        "plain_adversary_step_ms": adv_plain_ms,
        "iterations": fv_iters, "wall_cli_s": t_cli, "step_ms": fv_step_ms,
        "step_runs_ms": fv_runs, "plain_step_runs_ms": step_runs,
        "parts_ms": fv_parts, "fused_v_side_ms": fv_vside_ms,
        "plain_v_side_ms": vside_ms}}))

    # one cone outer step: the per-exit-group objective in place of the
    # pooled one, the boundary penalty at each boundary path's exit; each
    # part timed alone on the cone's shapes, times its calls per step
    cone_step_ms = time_ms(lambda: csolver._outer_step(), STEP_REPS, 1)
    cstate = csolver.state
    cone_parts, cb, cbb = step_parts(csolver, reps=20, scan_reps=10)
    with torch.no_grad():
        csides = (*csolver._losses.u_side(cstate.u_params, cb),
                  *csolver._losses.v_side(cstate.v_params, cb))

    def cone_objective(grouped):
        leaves = [a.detach().requires_grad_(True) for a in csides]
        if grouped:
            out = weak_form.grouped_interior_objective(
                *leaves, cb, cproblem, cone, s1_raw_v=ccfg.s1_raw_v)[0]
        else:
            current, norm = weak_form.interior_terms(
                *leaves, cb, cproblem, cone, s1_raw_v=ccfg.s1_raw_v)
            out = torch.log(current ** 2) - torch.log(norm)
        torch.autograd.grad(out, leaves)

    cone_parts["grouped objective with its input gradients"] = (
        (ccfg.n1 + ccfg.n2) * time_ms(lambda: cone_objective(True), reps=10))
    pooled_ms = (ccfg.n1 + ccfg.n2) * time_ms(lambda: cone_objective(False),
                                              reps=10)
    print(f"cone outer step ({card}), median of {STEP_REPS} CUDA-event "
          "runs: "
          f"{cone_step_ms:.4f} ms (cube step: {step_ms:.4f} ms); shares, "
          "from each part timed alone times its calls per step:")
    for name, ms in cone_parts.items():
        print(f"  {name}: {ms:.4f} ms, {ms / cone_step_ms:.1%}")
    print(f"  rest (sampling, losses, Adam, host): "
          f"{cone_step_ms - sum(cone_parts.values()):.4f} ms")
    print(f"  (the pooled objective on the same inputs, timed alone: "
          f"{pooled_ms:.4f} ms a step)")
    f_hist, d_hist = hg_until["hist"], d20["hist"]
    per_iter = {
        "cube (2b)": {n: c / iters for n, c in train_launches.items()},
        "cone (2d)": {n: c / c_iters for n, c in cone_launches.items()},
        "hourglass, fused_v (2e)": {n: c / h_iters
                                    for n, c in hg_launches.items()},
        "hourglass, drop_lr (2f)": {
            n: c / f_hist["iterations_run"]
            for n, c in hg_until["launches"].items()},
        "d=20 (2g)": {n: c / d_hist["iterations_run"]
                      for n, c in d20["launches"].items()},
        "qmc cube (2h)": {n: c / qmc["hist"]["iterations_run"]
                          for n, c in qmc["launches"].items()},
        "ensemble 4, d=20 (2i)": {n: c / ens["hist"]["iterations_run"]
                                  for n, c in ens["launches"].items()},
        "WAN, fused_v CLI (2j)": {n: c / WAN_CLI_ITERS
                                  for n, c in wan["cli_launches"].items()},
        "dopri5, fused_v CLI (2l)": {
            n: c / DOPRI5_CLI_ITERS for n, c in dop["cli_launches"].items()}}
    print(f"launches an outer iteration: {per_iter}")
    print(json.dumps({"training_cone": {
        "iterations": c_iters, "rel_err_final": chist["rel_err_final"],
        "wall_train_s": chist["wall_train_s"], "served_rel_err": rel_cone,
        "step_ms": cone_step_ms, "parts_ms": cone_parts,
        "pooled_objective_ms": pooled_ms,
        "hourglass_rel_err": [hrec[0]["rel_err"], hrec[-1]["rel_err"]],
        "hourglass_wall_cli_s": t_hcli, "launches_per_iteration": per_iter}}))

    # one d=20 outer step (2g's solver, paper example 4.3 at the widths of
    # configs/highdim_d20.yaml)
    dsolver = d20["solver"]
    d20_step_ms = time_ms(lambda: dsolver._outer_step(), STEP_REPS, 1)
    d20_parts = step_parts(dsolver, reps=5, scan_reps=5)[0]
    print(f"d=20 outer step ({card}), median of {STEP_REPS} CUDA-event "
          "runs: "
          f"{d20_step_ms:.4f} ms (cube step: {step_ms:.4f} ms, cone: "
          f"{cone_step_ms:.4f} ms); shares, from each part timed alone "
          "(median of 5) times its calls per step:")
    for name, ms in d20_parts.items():
        print(f"  {name}: {ms:.4f} ms, {ms / d20_step_ms:.1%}")
    print(f"  rest (sampling, losses, Adam, host): "
          f"{d20_step_ms - sum(d20_parts.values()):.4f} ms")
    print(json.dumps({"training_recipes": {
        "hourglass": {
            "iterations": f_hist["iterations_run"],
            "lr_drops_at": f_hist["lr_drops_at"],
            "rel_err_final": f_hist["rel_err_final"],
            "wall_train_s": f_hist["wall_train_s"],
            "served_rel_err": hg_until["served"],
            "rel_err_every_10": f_hist["rel_err"][::10].tolist(),
            "jax_iterations": hg_until["reference"]["iterations_run"],
            "jax_lr_drops_at": hg_until["reference"]["lr_drops_at"]},
        "d20": {
            "iterations": d_hist["iterations_run"],
            "lr_drops_at": d_hist["lr_drops_at"],
            "u_scale": d20["u_scale"], "least_rel_err": d20["best"],
            "rel_err_final": d_hist["rel_err_final"],
            "wall_train_s": d_hist["wall_train_s"],
            "rel_err_every_10": d_hist["rel_err"][::10].tolist(),
            "step_ms": d20_step_ms, "parts_ms": d20_parts},
        "card": card}}))

    # one ensemble iteration (4 members at d = 20, 2i's configuration on
    # fresh weights: 2i trained in another process) beside one member's
    # step, one WAN outer step (plain adversary, and 2j's command-line
    # solver with fused_v), one f64 parity step, and a Halton draw beside
    # an i.i.d. one at the cube's N_r
    ecfg = load_params(CONFIG).replace(dim=20, ensemble=4, seed=SEED)
    esolver = NODEWANSolver(ecfg, load_problem("Ex4_1_funcs", dim=ecfg.dim),
                            work_dir=os.path.join(work_root, "5_ensemble"))
    wsolver = wan["solver"]
    ens_ms = time_ms(lambda: esolver._outer_step(), reps=3, warmup=1)
    member_ms = time_ms(lambda: esolver._outer_step(esolver.members[0]),
                        reps=3, warmup=1)
    wan_ms = time_ms(lambda: wsolver._outer_step(), STEP_REPS, 1)
    wan_fv_ms = time_ms(lambda: wan["cli_solver"]._outer_step(), STEP_REPS,
                        1)
    psolver = parity["solver"]
    parity_ms = time_ms(lambda: psolver._outer_step(), reps=3, warmup=1)
    qg = torch.Generator(device=dev).manual_seed(21)
    # 2h's domain (its solver trained in another process)
    hcube = NODEWANSolver(cfg.replace(qmc="halton", seed=SEED), problem,
                          work_dir=os.path.join(work_root, "5_qmc")).domain
    icube = solver.domain
    draws = {"halton interior": time_ms(lambda: hcube.interior(qg, cfg.N_r)),
             "iid interior": time_ms(lambda: icube.interior(qg, cfg.N_r)),
             "halton boundary": time_ms(lambda: hcube.boundary(qg, cfg.N_b)),
             "iid boundary": time_ms(lambda: icube.boundary(qg, cfg.N_b))}
    print(f"ensemble iteration ({card}), 4 members at d=20, median of 3: "
          f"{ens_ms:.4f} ms; one member's outer step: {member_ms:.4f} ms "
          f"({ens_ms / member_ms:.2f}x)")
    print(f"WAN outer step ({card}), median of {STEP_REPS}: plain adversary "
          f"{wan_ms:.4f} ms, fused_v {wan_fv_ms:.4f} ms (XNODE cube step "
          f"{step_ms:.4f} ms); f64 parity-lane step, median of 3: "
          f"{parity_ms:.4f} ms")
    print(f"cloud draws at N={cfg.N_r}, d={cfg.dim} ({card}), median of 20: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in draws.items()))
    print(json.dumps({"new_paths": {
        "qmc_cube": {"iterations": qmc["hist"]["iterations_run"],
                     "rel_err_final": qmc["hist"]["rel_err_final"],
                     "wall_train_s": qmc["hist"]["wall_train_s"],
                     "jax_iterations": qmc["jax"],
                     "cloud_mean_sigmas": qmc["clouds"]},
        "ensemble": {"iterations": ens["hist"]["iterations_run"],
                     "rel_err_final": ens["hist"]["rel_err_final"],
                     "best_member": int(ens["hist"]["best_member"][-1]),
                     "rel_err_worst": float(ens["hist"]["rel_err_worst"][-1]),
                     "served_rel_err": ens["served"],
                     "wall_train_s": ens["hist"]["wall_train_s"],
                     "iteration_ms": ens_ms, "member_step_ms": member_ms},
        "wan": {"iterations": wan["hist"]["iterations_run"],
                "least_rel_err": wan["best"],
                "rel_err_every_10": wan["hist"]["rel_err"][::10].tolist(),
                "wall_train_s": wan["hist"]["wall_train_s"],
                "step_ms": wan_ms, "fused_v_step_ms": wan_fv_ms},
        "parity": {"iterations": parity["hist"]["iterations_run"],
                   "rel_err_final": parity["hist"]["rel_err_final"],
                   "wall_train_s": parity["hist"]["wall_train_s"],
                   "step_ms": parity_ms},
        "draws_ms": draws, "card": card}}))

    # one dopri5 outer step, one adams step, the cube's step with and
    # without remat_scan
    ints = integrator_steps(solver, dop, others, work_root, card)
    print(json.dumps({"integrators": {
        "dopri5": {"iterations": dop["hist"]["iterations_run"],
                   "least_rel_err": dop["best"],
                   "rel_err_final": dop["hist"]["rel_err_final"],
                   "rel_err_every_10": dop["hist"]["rel_err"][::10].tolist(),
                   "wall_train_s": dop["hist"]["wall_train_s"],
                   "wall_cli_s": dop["wall_cli_s"],
                   "serve_ms": dop["serve_ms"],
                   "step_ms": ints["dopri5_step_ms"],
                   "parts_ms": ints["dopri5_parts_ms"]},
        "solvers": {k: {kk: vv for kk, vv in v.items() if kk != "solver"}
                    for k, v in others["runs"].items()},
        "adams_step_ms": ints["adams_step_ms"],
        "f32_vs_f64": others["f64_gap"],
        "adjoint": {"forward_bitwise": adj["forward_bitwise"],
                    "grad_rel": adj["grad_rel"], "memory": adj["memory"]},
        "cube_step_ms": ints["cube_step_ms"],
        "card": card}}))
    phase_done("5", t_phase)

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        try:
            code = main(root)
        finally:
            stop_background()
    sys.exit(code)
