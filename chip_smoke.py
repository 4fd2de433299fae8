#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``xnode_wan_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (the kernels are built for Hopper, ``sm_90a``) and
``nvcc``; imports nothing of JAX or of the JAX package. Phases, each of
which raises on failure:

1. build every CUDA kernel from ``xnode_wan_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel) and print the build time and ptxas usage;
2. the slice's main path at the d=5 width of ``configs/cube_pde.yaml``
   with the reference trainer's checkpoint: serve 65,536 points with
   ``evaluate_points`` and score the solution on 4,000 fresh interior
   paths with ``u_forward_fused``; every kernel launch counter is zeroed
   just before and read just after, and each kernel must have launched;
   the rel-L2 error against the exact solution must stay under 0.0125
   for the served points, the kernel path forward and the plain scan;
3. each kernel against its plain PyTorch version on the same card
   inputs, all four RK methods, within ``rtol=2e-4, atol=2e-5``;
4. CUDA-event times (median of 20 after warm-up) of each kernel and its
   plain version at the main path's shapes, beside the bound the card's
   published peaks put on the same work;
5. CUDA-event times (median of 10) of the two entry points as a user
   calls them, and the share of each that its kernel takes.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "benchmarks", "ref_run_nr4000",
                    "best_model_weights_NODE.pth")
CONFIG = os.path.join(ROOT, "configs", "cube_pde.yaml")
RTOL, ATOL = 2e-4, 2e-5       # kernel against plain; tests/test_pallas.py:33
REL_L2_LIMIT = 0.0125         # JAX on the CPU gives 0.0102-0.0104 here
SERVE_POINTS = 65536
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from xnode_wan_tpu_torch import (Hypercube, apply_xnode, evaluate_points,
                                     init_xnode, load_params, load_problem,
                                     load_reference_state_dict, rel_err,
                                     u_forward_fused)
    from xnode_wan_tpu_torch.ops.kernels import _build, steppers
    from xnode_wan_tpu_torch.ops.kernels import xnode_eval, xnode_train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    dev = torch.device("cuda", 0)

    # 1. build ---------------------------------------------------------
    t = time.perf_counter()
    libs = _build.build()
    print(f"build: {time.perf_counter() - t:.2f} s -> {_build.build_dir()}")
    for name in libs:
        log = _build.build_dir() / f"{name}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

    cfg = load_params(CONFIG)
    problem = load_problem("Ex4_1_funcs", dim=cfg.dim)
    model = load_reference_state_dict(CKPT, device=dev, dtype=torch.float32)
    cube = Hypercube(cfg.shape_param, cfg.dim, cfg.T0, cfg.T, cfg.N_t)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pts = torch.rand((SERVE_POINTS, cfg.dim + 1), generator=gen, device=dev)
    pts[:, 1:] = cube.bot + pts[:, 1:] * (cube.top - cube.bot)
    pts[:, 0] = cfg.T0 + pts[:, 0] * (cfg.T - cfg.T0)
    batch = cube.interior(gen, cfg.N_r)
    kernels = {"xnode_eval": xnode_eval.KERNEL, "xnode_train": xnode_train.KERNEL}

    # 2. the slice's main path -------------------------------------------
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
    print(f"main path launches: {launches}")
    for n, c in launches.items():
        if c < 1:
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

    # 3. each kernel against its plain version on the card -----------------
    net = xnode_train.flat_net(model)
    packed = net.packed()
    k_steps = max(cfg.min_steps, cfg.N_t) * cfg.n_sub
    t_pts, x_pts = pts[:, 0].contiguous(), pts[:, 1:].contiguous()
    ts = torch.full_like(t_pts, cfg.T0)
    seed = (problem.h(torch.cat([ts[:, None], x_pts], dim=-1))
            / cfg.u_scale_eff).contiguous()
    eval_args = (x_pts, t_pts, ts, seed)
    errs = {"xnode_eval": 0.0, "xnode_train": 0.0}
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
        from xnode_wan_tpu_torch.models.xnode import spatial_features
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

    # 4. times at the main path's shapes ------------------------------------
    t0, dt = xnode_train._prep_intervals(batch.times, batch.mask,
                                         batch.t_start, cfg.n_sub)
    path_args = (t0.contiguous(), dt.contiguous(), xs, path_seed)
    method = cfg.solver
    evals = steppers.EVALS_PER_STEP[method]
    once, per_eval = steppers.field_macs(net)
    lift_read = steppers.lift_readout_macs(net)
    n_w = packed.numel()

    def flops_per_path(steps):
        return 2.0 * (lift_read + once + steps * evals * per_eval)

    M, N, L = SERVE_POINTS, cfg.N_r, cfg.N_t
    work = {
        "xnode_eval": (M * flops_per_path(k_steps),
                       4.0 * (M * (net.F + 3) + n_w + M)),
        "xnode_train": (N * flops_per_path(L * cfg.n_sub),
                        4.0 * (N * (2 * L + net.F + 1) + n_w + N * L)),
    }
    with torch.no_grad():
        timed = {
            "xnode_eval": (
                lambda: xnode_eval.evaluate_cuda(net, *eval_args, k_steps,
                                                 method, packed=packed),
                lambda: xnode_eval.evaluate_plain(net, *eval_args, k_steps,
                                                  method), M, "points"),
            "xnode_train": (
                lambda: xnode_train.path_forward_cuda(net, *path_args,
                                                      cfg.n_sub, method,
                                                      packed=packed),
                lambda: xnode_train.path_forward_plain(net, *path_args,
                                                       cfg.n_sub, method), N,
                "paths"),
        }
        rows = []
        meta = {
            "xnode_eval": ("xnode_wan_tpu_torch/csrc/xnode_eval.cu",
                           "xnode_wan_tpu/ops/pallas/xnode_eval.py:60"),
            "xnode_train": ("xnode_wan_tpu_torch/csrc/xnode_train.cu",
                            "xnode_wan_tpu/ops/pallas/xnode_train.py:325"),
        }
        print(f"times ({card}), median of 20 CUDA-event runs, {method}:")
        for name, (kern, plain, count, unit) in timed.items():
            ms = time_ms(kern)
            plain_ms = time_ms(plain)
            bound_ms, bound_by = bound(*work[name])
            print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {1e3 * bound_ms:.2f} us ({bound_by}; "
                  f"{work[name][0] / 1e9:.3f} GFLOP, "
                  f"{work[name][1] / 1e6:.3f} MB), "
                  f"{count / (ms * 1e-3):.4g} {unit}/s, "
                  f"{work[name][0] / (ms * 1e-3) / 1e12:.3f} TFLOP/s")
            rows.append({
                "name": name, "route": "cuda", "source": meta[name][0],
                "replaces": meta[name][1], "launches": launches[name],
                "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None,
            })

    # 5. the entry points, steady state ------------------------------------
    kernel_ms = {row["name"]: row["ms"] for row in rows}

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
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
