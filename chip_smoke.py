#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``xnode_wan_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (the kernels are built for Hopper, ``sm_90a``) and
``nvcc``; imports nothing of JAX or of the JAX package. Phases, each of
which raises on failure:

1. build every CUDA kernel from ``xnode_wan_tpu_torch/csrc`` (one ``nvcc``
   per library, all in parallel; #1/#2's ``xnode_fwd.cu`` once per (H, Hh)
   pair of the shipped configs, #6's ``disc_fwd.cu`` and #7's
   ``disc_train.cu`` once per shipped adversary width H) and print the
   build time and ptxas usage; #1/#2, #6 and #7 must show no stack and no
   spills; hold ``steppers.staged_floats`` against the staged copy #1/#2
   ask for, ``disc_train.staged_floats`` against #6's and
   ``disc_train.bwd_smem_bytes`` against #7's shared bytes (the d=5 and
   the d=20 adversary, each tied and untied; #7's registers and shared
   bytes a block printed), and the wrapper's shared-memory rule for #3-#5
   against the bytes their launchers ask for;
2. the main paths at the d=5 width of ``configs/cube_pde.yaml``, each
   with every kernel launch counter zeroed just before and read just
   after:

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
      with ``fused_v: true``: it must print ``Stopping Criterion
      Reached`` within the config's iterations, launch #6 twice, #7
      once, #4 and #5 ``n1`` times and #2 and #3 once per iteration, and
      write one metrics record per iteration, the three JSON lists, the
      checkpoint and the best weights; ``--resume --iterations 3`` must
      continue the step count and the loss; the resumed primal is served
      through ``evaluate_points`` (kernel #1) under the rel-L2 limit of
      2a, and the best weights load with ``load_reference_state_dict``;
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
   paths at ``KINK_RTOL``), two launches of #5 compared bitwise, and the
   autograd function's weight gradients against ``torch.autograd.grad``
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
   computed twice on the same card inputs, compared bitwise;
4. CUDA-event times (median of 20 after warm-up) of each kernel and its
   plain version at the main path's shapes, beside the bound the card's
   published peaks put on the same work;
5. CUDA-event times (median of 10) of the two serving entry points and
   the share of each that its kernel takes, of one training outer step
   with the share of each kernel, of the plain boundary scan's forward
   and backward, and of the adversary side, and of one ``fused_v`` outer
   step (timed in turns with the plain one) with the share of #6 and #7,
   and of the adversary step alone, plain and fused in turns; one cone
   outer step with the share of the plain boundary scan, the
   per-exit-group objective and each of #2-#5, and its launches an
   iteration beside the cube's.

Each phase prints its seconds. The line before the last is a JSON object
with one entry per kernel (its launches on the main path, and by phase);
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch

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
# the hourglass converges only with the drop_lr recipe, not ported yet:
# the run is held to its course, not to the 1% stop
HOURGLASS_ITERS = 20
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
PEAK_BYTES_PER_S = 3.35e12


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


def bound(flops: float, n_bytes: float):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, n_bytes / PEAK_BYTES_PER_S
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
    return {"disc_fwd": (2.0 * M * (fwd + sweep), 4.0 * M * (2 * F + 1) + n_w),
            "disc_bwd": (2.0 * M * bwd, 4.0 * M * (2 * F + 1) + 2 * n_w)}


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


def main() -> int:
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
    # shipped configs, #6 (disc_fwd.cu) and #7 (disc_train.cu) one per
    # adversary width; #3-#5 (xnode_grad.cu) one
    shipped = {}
    for name in ("cube_pde", "ex4_1_d10", "highdim_d20"):
        gcfg = load_params(os.path.join(ROOT, "configs", f"{name}.yaml"))
        shipped[name] = (gcfg, xnode_train.flat_net(
            init_xnode(gcfg, device="cpu")).dims())
    fwd_widths = sorted({dims[:2] for _, dims in shipped.values()})
    disc_widths = sorted({(g.v_hidden_dim,) for g, _ in shipped.values()})
    t = time.perf_counter()
    libs = _build.build([("xnode_grad", None)]
                        + [("xnode_fwd", w) for w in fwd_widths]
                        + [(src, w) for src in ("disc_fwd", "disc_train")
                           for w in disc_widths])
    print(f"build: {time.perf_counter() - t:.2f} s -> {_build.build_dir()}")
    for name in libs:
        log = (_build.build_dir() / f"{name}.log").read_text()
        for line in log.splitlines():
            if ("Compiling entry" in line or "registers" in line
                    or "spill" in line):
                print(f"  {name}: {line.strip()}")
        # the width-specialized kernels keep every per-thread array in
        # registers: no stack, no spills
        frames = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill "
                            r"stores, (\d+) bytes spill loads", log)
        if name.startswith(("xnode_fwd", "disc_fwd", "disc_train")) and (
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
        # #7: the tile's shared bytes in Python against the launcher's
        bwd_name = _build.lib_name("disc_train", (geom.H,))
        smem_of = ctypes.CDLL(str(libs[bwd_name])).disc_bwd_smem_bytes
        smem_of.restype = ctypes.c_longlong
        tile = disc_train.bwd_tile(geom)
        got = smem_of(geom.F, geom.H, geom.L, int(tied), tile)
        if got != disc_train.bwd_smem_bytes(geom, tile):
            raise AssertionError(f"disc_train.bwd_smem_bytes {name} {geom}: "
                                 f"the launcher asks for {got} bytes")
        log = (_build.build_dir() / f"{bwd_name}.log").read_text()
        regs = [re.search(r"Used (\d+) registers", c).group(1)
                for c in log.split("Compiling entry function")[1:]
                if "disc_bwd_kernel" in c.splitlines()[0]]
        print(f"  disc_train {name} {geom}: {tile} points a tile, rows of "
              f"{disc_train.bwd_stride(tile)} floats, {got} bytes of shared "
              f"memory a block, {disc_train.BWD_THREADS} threads, "
              f"{regs[0] if regs else '?'} registers a thread")
    # the wrapper's shared-memory rule against the bytes the launchers of
    # #3-#5 ask for, at every shipped config, method and listed tile
    smem_of = ctypes.CDLL(str(libs["xnode_grad"])).xnode_udu_smem_bytes
    smem_of.restype = ctypes.c_longlong
    smem_of.argtypes = [ctypes.c_int] * 9
    n_geom = 0
    for shipped_name, (gcfg, dims) in shipped.items():
        for method, mid in steppers.METHOD_IDS.items():
            for tile in (1, 2, 4, 8, 16):
                for backward in (False, True):
                    want = smem_of(int(backward), tile, gcfg.dim, *dims, mid)
                    got = xnode_train.tile_smem_bytes(dims, gcfg.dim, method,
                                                      tile, backward)
                    if got != want:
                        raise AssertionError(
                            f"tile_smem_bytes {shipped_name} {method} "
                            f"tile={tile} backward={backward}: {got} bytes, "
                            f"the kernel asks for {want}")
                    n_geom += 1
    print(f"  xnode_grad: tile_smem_bytes equals the launchers' shared "
          f"bytes at {n_geom} geometries")
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
    kernels = {"xnode_eval": xnode_eval.KERNEL, "xnode_train": xnode_train.KERNEL,
               "xnode_udu_fwd": xnode_train.FWD_KERNEL,
               "xnode_udu_fwd_store": xnode_train.FWD_STORE_KERNEL,
               "xnode_udu_bwd": xnode_train.BWD_KERNEL,
               "disc_fwd": disc_train.FWD_KERNEL,
               "disc_bwd": disc_train.BWD_KERNEL}
    errs = {n: 0.0 for n in kernels}

    def read_launches():
        return {n: k.launches for n, k in kernels.items()}

    def zero_launches():
        for k in kernels.values():
            k.launches = 0

    # 2a. serving and scoring ---------------------------------------------
    for k in kernels.values():
        k.launches = 0
    with torch.no_grad():
        t = time.perf_counter()
        u_served = evaluate_points(model, pts, problem, cfg)
        torch.cuda.synchronize()
        t_serve = time.perf_counter() - t
        t = time.perf_counter()
        u_paths = u_forward_fused(model, batch, problem, cfg)
        torch.cuda.synchronize()
        t_metric = time.perf_counter() - t
    launches = {n: k.launches for n, k in kernels.items()}
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
    solver = NODEWANSolver(cfg, problem)
    for k in kernels.values():
        k.launches = 0
    hist = solver.train_until(TRAIN_TOL, cfg.iterations)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()}
    iters = hist["iterations_run"]
    print(f"training: {iters} outer iterations to rel-L2 "
          f"{hist['rel_err_final']:.6f} in {hist['wall_train_s']:.3f} s "
          f"(train_until wall clock, {card}); launches {launches}")
    want = {"xnode_eval": 0, "xnode_train": iters, "xnode_udu_fwd": iters,
            "xnode_udu_fwd_store": cfg.n1 * iters,
            "xnode_udu_bwd": cfg.n1 * iters, "disc_fwd": 0, "disc_bwd": 0}
    if launches != want:
        raise AssertionError(f"training launches {launches}, expected {want}")
    if not hist["rel_err_final"] < TRAIN_TOL:
        raise AssertionError(f"training stopped at rel-L2 "
                             f"{hist['rel_err_final']} >= {TRAIN_TOL} after "
                             f"{iters} iterations")
    if not all(map(lambda v: v == v, hist["loss_u"])):
        raise AssertionError("training produced a non-finite loss_u")
    train_launches = dict(launches)
    launches["xnode_eval"] = serve_launches["xnode_eval"]
    trained = solver.state.u_params
    t_phase = phase_done("2b", t_phase)

    # 2c. the command line with fused_v ------------------------------------
    def cli_launches_want(n, c=cfg):
        return {"xnode_eval": 0, "xnode_train": n, "xnode_udu_fwd": n,
                "xnode_udu_fwd_store": c.n1 * n,
                "xnode_udu_bwd": c.n1 * n, "disc_fwd": (1 + c.n2) * n,
                "disc_bwd": c.n2 * n}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as work:
        yaml_path = os.path.join(work, "cube_pde_fused_v.yaml")
        with open(CONFIG) as fh:
            text = fh.read()
        with open(yaml_path, "w") as fh:
            fh.write(text.rstrip("\n") + "\nfused_v: true\n")
        argv = ["--params", yaml_path, "--funcs", "Ex4_1_funcs", "-w", work,
                "--report_it", "25"]
        for k in kernels.values():
            k.launches = 0
        t = time.perf_counter()
        out, fv_solver = run_cli(cli_main, argv)
        torch.cuda.synchronize()
        t_cli = time.perf_counter() - t
        cli_launches = {n: k.launches for n, k in kernels.items()}
        fv_iters = fv_solver.state.step
        records = read_jsonl(os.path.join(work, f"metrics_NODE_{cfg.dim}.jsonl"))
        print(f"command line, fused_v: {fv_iters} outer iterations to rel-L2 "
              f"{records[-1]['rel_err']:.6f} in {t_cli:.3f} s (wall clock, "
              f"{card}); launches {cli_launches}")
        if "Stopping Criterion Reached" not in out:
            raise AssertionError("the fused_v command-line run did not reach "
                                 f"rel-L2 < {TRAIN_TOL} in {fv_iters} "
                                 "iterations")
        if cli_launches != cli_launches_want(fv_iters):
            raise AssertionError(f"command-line launches {cli_launches}, "
                                 f"expected {cli_launches_want(fv_iters)}")
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

        for k in kernels.values():
            k.launches = 0
        _, resumed = run_cli(cli_main, argv + ["--resume", "--iterations", "3"])
        torch.cuda.synchronize()
        resumed_launches = {n: k.launches for n, k in kernels.items()}
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
        if resumed_launches != cli_launches_want(n_res):
            raise AssertionError(f"resumed launches {resumed_launches}, "
                                 f"expected {cli_launches_want(n_res)}")

        xnode_eval.KERNEL.launches = 0
        u_resumed = resumed.predict(pts)
        torch.cuda.synchronize()
        rel_resumed = float(rel_err(u_resumed, problem.u_sol(pts), ones,
                                    cube.V(), cfg.p))
        best = load_reference_state_dict(
            os.path.join(work, "best_model_weights_NODE.pth"), device=dev,
            dtype=torch.float32)
        with torch.no_grad():
            u_best = evaluate_points(best, pts, problem, cfg)
        rel_best = float(rel_err(u_best, problem.u_sol(pts), ones, cube.V(),
                                 cfg.p))
        print(f"served the resumed primal on {SERVE_POINTS} points: rel-L2 "
              f"{rel_resumed:.6f} ({xnode_eval.KERNEL.launches} launches of "
              f"#1); best weights through load_reference_state_dict: rel-L2 "
              f"{rel_best:.6f}")
        if xnode_eval.KERNEL.launches != 2:
            raise AssertionError("serving the resumed primal and the best "
                                 "weights did not launch kernel #1")
        if not rel_resumed < REL_L2_LIMIT:
            raise AssertionError(f"resumed primal serves at rel-L2 "
                                 f"{rel_resumed} >= {REL_L2_LIMIT}")
        if u_best.shape != (SERVE_POINTS,) or not bool(
                torch.isfinite(u_best).all()):
            raise AssertionError("the best weights serve non-finite values")
    for name in ("disc_fwd", "disc_bwd"):
        launches[name] = cli_launches[name]
    phase_launches = {"2a": serve_launches, "2b": train_launches,
                      "2c": cli_launches, "2c resume": resumed_launches,
                      "2c serve": {"xnode_eval": 2}}
    t_phase = phase_done("2c", t_phase)

    # 2d. training the shrinking cone ---------------------------------------
    ccfg = load_params(CONE_CONFIG)
    cproblem = load_problem("Ex4_1_funcs", dim=ccfg.dim)
    csolver = NODEWANSolver(ccfg, cproblem)
    cone = csolver.domain
    zero_launches()
    chist = csolver.train_until(TRAIN_TOL, CONE_MAX_ITERS)
    torch.cuda.synchronize()
    cone_launches = read_launches()
    c_iters = chist["iterations_run"]
    print(f"cone training ({type(cone).__name__}, d={ccfg.dim}, "
          f"N_r={ccfg.N_r}): {c_iters} outer iterations to rel-L2 "
          f"{chist['rel_err_final']:.6f} in {chist['wall_train_s']:.3f} s "
          f"(train_until wall clock, {card}); launches {cone_launches}")
    want = {"xnode_eval": 0, "xnode_train": c_iters, "xnode_udu_fwd": c_iters,
            "xnode_udu_fwd_store": ccfg.n1 * c_iters,
            "xnode_udu_bwd": ccfg.n1 * c_iters, "disc_fwd": 0, "disc_bwd": 0}
    if cone_launches != want:
        raise AssertionError(f"cone launches {cone_launches}, expected {want}")
    if not chist["rel_err_final"] < TRAIN_TOL:
        raise AssertionError(f"the cone stopped at rel-L2 "
                             f"{chist['rel_err_final']} >= {TRAIN_TOL} after "
                             f"{c_iters} iterations")
    if not all(map(lambda v: v == v, chist["loss_u"])):
        raise AssertionError("cone training produced a non-finite loss_u")
    cpts = inside_points(cone, SERVE_POINTS, gen, cone.r)
    xnode_eval.KERNEL.launches = 0
    u_cone = csolver.predict(cpts)
    torch.cuda.synchronize()
    rel_cone = float(rel_err(u_cone, cproblem.u_sol(cpts),
                             torch.ones_like(u_cone, dtype=torch.bool),
                             cone.V(), ccfg.p))
    print(f"served the trained cone primal through predict at "
          f"{SERVE_POINTS} points inside the cone: rel-L2 {rel_cone:.6f} "
          f"({xnode_eval.KERNEL.launches} launch of #1)")
    if xnode_eval.KERNEL.launches != 1:
        raise AssertionError("serving the cone did not launch kernel #1 once")
    if u_cone.shape != (SERVE_POINTS,) or not rel_cone < CONE_SERVE_LIMIT:
        raise AssertionError(f"the cone serves at rel-L2 {rel_cone} >= "
                             f"{CONE_SERVE_LIMIT}")
    phase_launches["2d"] = cone_launches
    phase_launches["2d serve"] = {"xnode_eval": 1}
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
        zero_launches()
        t = time.perf_counter()
        out, hsolver = run_cli(cli_main, argv + ["--iterations",
                                                 str(HOURGLASS_ITERS)])
        torch.cuda.synchronize()
        t_hcli = time.perf_counter() - t
        hg_launches = read_launches()
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
        if hg_launches != cli_launches_want(h_iters, hcfg):
            raise AssertionError(f"hourglass launches {hg_launches}, expected "
                                 f"{cli_launches_want(h_iters, hcfg)}")
        zero_launches()
        _, hresumed = run_cli(cli_main, argv + ["--resume", "--iterations",
                                                "3"])
        torch.cuda.synchronize()
        hg_res_launches = read_launches()
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
        if hg_res_launches != cli_launches_want(3, hcfg):
            raise AssertionError(f"resumed hourglass launches "
                                 f"{hg_res_launches}")
    hpts = inside_points(hg, SERVE_POINTS, gen, hg.r * (hg.T - hg.T0))
    h_entry, h_from_h = hg.entry(hpts)
    xnode_eval.KERNEL.launches = 0
    u_hg = hresumed.predict(hpts)
    torch.cuda.synchronize()
    if xnode_eval.KERNEL.launches != 1:
        raise AssertionError("serving the hourglass did not launch kernel #1")
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
    phase_launches["2e serve"] = {"xnode_eval": 1}
    t_phase = phase_done("2e", t_phase)

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
                print(f"  xnode_udu_bwd {label}: two launches bitwise equal")

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
                print(f"  xnode_udu_bwd {label}, all {n_p} paths: two "
                      "launches bitwise equal")

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
                      cfg.n_sub, cfg.solver)
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
                             cfg20.solver)

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
            print(f"  disc_bwd {label}, {disc_train.bwd_tile(geom)}-point "
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
        print(f"times ({card}), median of 20 CUDA-event runs, {method}; "
              f"#6 and #7 on {M_v} points, {vgeom}:")
        for name, (kern, plain) in timed.items():
            ms = time_ms(kern)
            plain_ms = time_ms(plain)
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
    step_runs = [time_ms(lambda: solver._outer_step(), reps=10, warmup=2)]
    fv_runs = [time_ms(lambda: fv_solver._outer_step(), reps=10, warmup=2)]
    fv_runs.append(time_ms(lambda: fv_solver._outer_step(), reps=10))
    step_runs.append(time_ms(lambda: solver._outer_step(), reps=10))
    step_ms, fv_step_ms = statistics.mean(step_runs), statistics.mean(fv_runs)
    sbatch, bbatch = solver._sample(solver.state.generator)
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
    print(f"training outer step ({card}), mean of two medians of 10 "
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
    fv_batch, _ = fv_solver._sample(fv_solver.state.generator)
    with torch.no_grad():
        fv_vside_ms = time_ms(lambda: fv_solver._losses.v_side(
            fv_solver.state.v_params, fv_batch), reps=10)
    fv_parts = {"disc_fwd (#6), 2 launches": 2 * kernel_ms["disc_fwd"],
                "disc_bwd (#7), 1 launch": kernel_ms["disc_bwd"]}

    # the adversary step alone (the n2 part of _step_on): loss_v on a
    # fixed u side, forward and weight gradient, in turns
    def adversary_step(s):
        b, _ = s._sample(s.state.generator)
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
    print(f"fused_v outer step ({card}), mean of two medians of 10 "
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
    cone_step_ms = time_ms(lambda: csolver._outer_step(), reps=10, warmup=2)
    cstate = csolver.state
    cb, cbb = csolver._sample(cstate.generator)
    cnet = xnode_train.flat_net(cstate.u_params)
    cpacked = cnet.packed()
    cargs = [a.contiguous() for a in (
        *xnode_train._prep_intervals(cb.times, cb.mask, cb.t_start,
                                     ccfg.n_sub),
        *xnode_train.path_tangent_inputs(cb, cproblem, ccfg))]
    c_sub, c_method = ccfg.n_sub, ccfg.solver
    cg = torch.Generator(device=dev).manual_seed(9)
    with torch.no_grad():
        cstates = xnode_train.u_du_fwd_cuda(cnet, cpacked, *cargs, c_sub,
                                            c_method, store=True)[2:]
        cub = torch.randn(cargs[0].shape, generator=cg, device=dev)
        cdub = torch.randn((*cargs[0].shape, ccfg.dim), generator=cg,
                           device=dev)
        csides = (*csolver._losses.u_side(cstate.u_params, cb),
                  *csolver._losses.v_side(cstate.v_params, cb))
        cone_parts = {
            "xnode_train (#2)": time_ms(lambda: xnode_train.path_forward_cuda(
                cnet, cargs[0], cargs[1], cargs[2], cargs[4], c_sub,
                c_method, packed=cpacked)),
            "xnode_udu_fwd (#3)": time_ms(lambda: xnode_train.u_du_fwd_cuda(
                cnet, cpacked, *cargs, c_sub, c_method)),
            "xnode_udu_fwd_store (#4)": ccfg.n1 * time_ms(
                lambda: xnode_train.u_du_fwd_cuda(cnet, cpacked, *cargs,
                                                  c_sub, c_method, True)),
            "xnode_udu_bwd (#5)": ccfg.n1 * time_ms(
                lambda: xnode_train.u_du_bwd_cuda(cnet, cpacked, *cargs,
                                                  *cstates, cub, cdub, c_sub,
                                                  c_method))}

    def cone_bdry():
        return weak_form.bdry_loss(apply_xnode, cstate.u_params, cbb,
                                   cproblem, ccfg, at_exit=True)

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

    c_fwd_ms = time_ms(cone_bdry, reps=10)
    cone_parts["boundary scan forward"] = ccfg.n1 * c_fwd_ms
    cone_parts["boundary scan backward"] = ccfg.n1 * (time_ms(
        lambda: torch.autograd.grad(cone_bdry(),
                                    list(cstate.u_params.parameters())),
        reps=10) - c_fwd_ms)
    cone_parts["grouped objective with its input gradients"] = (
        (ccfg.n1 + ccfg.n2) * time_ms(lambda: cone_objective(True), reps=10))
    pooled_ms = (ccfg.n1 + ccfg.n2) * time_ms(lambda: cone_objective(False),
                                              reps=10)
    print(f"cone outer step ({card}), median of 10 CUDA-event runs: "
          f"{cone_step_ms:.4f} ms (cube step: {step_ms:.4f} ms); shares, "
          "from each part timed alone times its calls per step:")
    for name, ms in cone_parts.items():
        print(f"  {name}: {ms:.4f} ms, {ms / cone_step_ms:.1%}")
    print(f"  rest (sampling, adversary side, losses, Adam, host): "
          f"{cone_step_ms - sum(cone_parts.values()):.4f} ms")
    print(f"  (the pooled objective on the same inputs, timed alone: "
          f"{pooled_ms:.4f} ms a step)")
    per_iter = {
        "cube (2b)": {n: c / iters for n, c in train_launches.items()},
        "cone (2d)": {n: c / c_iters for n, c in cone_launches.items()},
        "hourglass, fused_v (2e)": {n: c / h_iters
                                    for n, c in hg_launches.items()}}
    print(f"launches an outer iteration: {per_iter}")
    print(json.dumps({"training_cone": {
        "iterations": c_iters, "rel_err_final": chist["rel_err_final"],
        "wall_train_s": chist["wall_train_s"], "served_rel_err": rel_cone,
        "step_ms": cone_step_ms, "parts_ms": cone_parts,
        "pooled_objective_ms": pooled_ms,
        "hourglass_rel_err": [hrec[0]["rel_err"], hrec[-1]["rel_err"]],
        "hourglass_wall_cli_s": t_hcli, "launches_per_iteration": per_iter}}))
    phase_done("5", t_phase)

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
