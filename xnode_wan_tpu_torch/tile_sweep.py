"""Sweep the tile shape of the training kernels #3, #4 and #5
(``csrc/xnode_grad.cu``) on one GPU.

    python -m xnode_wan_tpu_torch.tile_sweep [--configs cube_pde ...]
        [--set key=value ...] [--tiles 2 4 8 16] [--threads 64 128 256]
        [--rule [--cluster C ...] | --same-tile
         | --path [--direct] [--rows R ... [--slices K ...]] [--ragged]
                  [--serve M] [--ablate]
         | --adversary [--cluster C ... | --ablate | --fwd-only]] [--f64]
        [--out example_run/tile_sweep.json]

For each config (``configs/<name>.yaml``; random weights from a seed, one
interior path batch of the config's ``N_r`` paths, its ``solver``) and
each (paths per tile, threads a block) whose block fits shared memory
(the wrappers' ``FWD_TILES`` / ``BWD_TILES`` and ``block_threads`` set
to that one shape while it runs), each kernel is held against its plain version (max error over
the tensor's largest value) and timed by CUDA events, median of ``--reps``
after warm-up. Prints ``ptxas``'s register and stack lines for the
kernels first, the card's name and power limit beside the times, and
writes every row to ``--out``. Needs a CUDA card and ``nvcc``.

``--set key=value`` overrides fields of every config (a YAML value:
``--set u_hidden_dim=64 u_hidden_hidden_dim=64`` is the 64/64 cube,
``--set dim=30 u_hidden_dim=48 u_hidden_hidden_dim=48
fourier_features=1`` the d=30 Fourier cube).

``--rule`` times each kernel once, at the wrappers' own tile choice, in
place of the sweep, on the first tangent chunk the route takes
(``kernel_route(...).d_chunk`` directions; the full d where it fits),
and gives each kernel's launches an iteration (``d / d_chunk`` times its
launches a step: #3 once, #4 and #5 ``n1`` times) and its time an
iteration beside the time a launch, so that a change of chunk compares
per iteration. It
needs nothing of the package but the wrappers and the sampling, so a
copy of this file in an older checkout's package times that checkout's
kernels on the same card and configs:

    mkdir -p example_run/parent && git archive HEAD~1 | tar -x -C example_run/parent
    cp xnode_wan_tpu_torch/tile_sweep.py example_run/parent/xnode_wan_tpu_torch/
    (cd example_run/parent && python -m xnode_wan_tpu_torch.tile_sweep --rule \
        --set u_hidden_dim=64 u_hidden_hidden_dim=64)

``--cluster C ...`` (with ``--rule``) times the rule once for each C,
with #5's cluster variant held to clusters of C blocks at the largest
tile that fits them: the rule's choice of the smallest C, timed against
the others (``--set u_hidden_dim=64 u_hidden_hidden_dim=64 --cluster 2 4
8``).

``--same-tile`` times kernel #5 with its accumulator in shared memory
against its variant with the accumulator in its block's row of
``partial`` (``xnode_udu_bwd_global_launch``), both through their
launchers at the same tile, threads and grid (the shared variant's: the
wrappers' tile, or each of ``--tiles`` that fits), alternated shared,
global, global, shared, and checks that the two are bitwise equal.

``--path`` times the path forwards #1 (serving, ``--serve`` points, 65,536
by default) and #2 (the metric, on the config's ``N_r`` interior paths,
and at 4,001 and 37 with ``--ragged``) instead, at each config's net with
``--set`` applied (random weights from seed 0): through their wrappers, in
the variant ``kernel_route`` picks; with ``--direct`` also the path-tile
kernel through its launch helpers at its own rule's tile, where the route
takes the register kernel (2t's and 2u's nets); and with ``--rows R ...
--slices K ...`` the path-tile kernel at each (paths a tile, weight
slice) that fits (``--slices 0`` the weights resident), each held against
its plain version (``rtol=2e-4, atol=2e-5``) and run twice, bitwise.
``--ablate`` times the
path-tile kernel at the route's tile in builds that each leave out its
waits and barriers before a slice, its weight copies too, its products'
multiply-adds, or copies and products (:data:`PATH_ABLATIONS`; timing
only). Like ``--rule``, a copy of this
file in an older checkout times that checkout's #1/#2 (its path-tile
variant at ``grad_tile``'s tile at d = 0): ``--set u_hidden_dim=128
u_hidden_hidden_dim=128`` is the 128/128 cube, ``--set dim=100
fourier_features=1 --direct`` 2t's net.

``--adversary`` times the adversary kernels #6 and #7 instead, through
their wrappers (``v_dv_fwd_cuda``, ``v_dv_bwd_cuda``: the variant and
tile they choose), at each config's discriminator with ``--set`` applied
(random weights from seed 0, ``tied_v`` and ``v_fourier_features`` from
the config) on ``N_r * N_t`` random points, each held against its plain
version (#6's plain version timed too), each twice for bitwise
equality; like ``--rule``, a copy of this file in an older checkout
times that checkout's kernels (``--set
v_hidden_dim=256`` is 2v's adversary, ``v_hidden_dim=558`` the widest the
JAX package runs at the shipped depth). With ``--cluster C ...`` it
times #7's rule once for each C, its cluster variant held to clusters of
C blocks (``disc_train.CLUSTER``), and the cluster variant through its
launcher at the largest tile that fits C blocks
(``disc_train.cluster_tile``, a tied net) where the route does not take
it. With ``--ablate`` it times #7's cluster variant at the route's shape
in builds of ``disc_train.cu`` that each leave one part out (timing only:
their gradients are wrong): the pushes into the peers, the FP32 forward,
the products, the weight sums, all arithmetic, and all but the barriers
and loops (:data:`ABLATIONS`), each built into ``_build/ablate/<part>``.
With ``--fwd-only`` it times #6 alone (the 558-wide net's global #7 takes
over a second a launch): ``--set v_hidden_dim=256`` is 2v's tile #6,
``v_hidden_dim=558`` the widest, ``v_hidden_dim=128 tied_v=false`` and
``v_layers=40 tied_v=false`` the untied nets of ``chip_smoke.py``'s phase
3; with ``--ablate`` too, the tile #6 at the route's shape in builds that
each leave out its weight copies, its FP32 forward, its tensor-core sweep
and ``gin``, both products, or all three (:data:`FWD_ABLATIONS`).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _time_ms(fn, reps: int) -> float:
    for _ in range(3):
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


def _scaled_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def f64_check(xt, net, args, want, ub, dub, gwant, n_sub, method):
    """Each output of the plain f32 version and of the kernels (the
    wrapper's tile) against the plain version in f64 on the same inputs:
    the largest error over each tensor's largest value, and how many
    elements of the kernels' output are off the plain f32 one by more
    than 2e-4 of that value."""
    from xnode_wan_tpu_torch.ops.kernels.steppers import FlatNet
    net64 = FlatNet([a.double() for a in net.flat], net.n_lift, net.n_field)
    a64 = [a.double() for a in args]
    with torch.no_grad():
        w64 = xt.u_du_fwd_plain(net64, *a64, n_sub, method, store=True)
        g64 = xt.u_du_bwd_plain(net64, *a64, *(a.double() for a in want[2:]),
                                ub.double(), dub.double(), n_sub, method)
        got = xt.u_du_fwd_cuda(net, net.packed(), *args, n_sub, method, True)
        ggot = xt.u_du_bwd_cuda(net, net.packed(), *args, *want[2:], ub, dub,
                                n_sub, method)
    out = {}
    names = ("u", "du", "hs", "hts", "grad")
    for nm, k, p32, ref in zip(names, (*got, ggot), (*want, gwant),
                               (*w64, g64)):
        scale = float(ref.abs().max())
        out[nm] = {
            "plain_f32_vs_f64": float((p32.double() - ref).abs().max()) / scale,
            "kernel_vs_f64": float((k.double() - ref).abs().max()) / scale,
            "kernel_vs_plain_over_2e-4": int(
                ((k - p32).abs() > 2e-4 * float(p32.abs().max())).sum()),
            "elements": k.numel()}
    # the paths whose du leaves the plain f32 version by more than 2e-4
    # of its largest value, and how close each path comes to a relu kink
    off = ((got[1] - want[1]).abs() > 2e-4 * float(want[1].abs().max()))
    off = off.flatten(1).any(1)
    with torch.no_grad():
        m = xt.relu_margins(net64, a64[0], a64[1], a64[2], a64[4], n_sub, method)
    out["relu_margin"] = {
        "paths_off": int(off.sum()),
        "margin_of_paths_off": [float(v) for v in m[off][:10]],
        "margin_quantiles_0_1e-3_0.5": [
            float(m.min()), float(torch.quantile(m, 1e-3)),
            float(m.median())],
        "paths_with_margin_below_1e-6": int((m < 1e-6).sum())}
    return out


def parse_sets(pairs) -> dict:
    """``["key=value", ...]`` as config overrides, each value read as
    YAML (``64``, ``true``, ``rk4``)."""
    import yaml
    out = {}
    for pair in pairs or ():
        key, sep, value = pair.partition("=")
        if not sep or not key:
            raise ValueError(f"--set takes key=value, got {pair!r}")
        out[key] = yaml.safe_load(value)
    return out


def config_batch(name: str, sets: dict, chunk: bool):
    """The net (random weights, seed 0), inputs and readout cotangents of
    one config with ``sets`` applied: ``(cfg, net, args, want, ub, dub,
    gwant)``, with ``want`` the plain #4's outputs and ``gwant`` the plain
    #5's gradient. With ``chunk`` the tangent inputs are cut to the first
    chunk of the route's ``d_chunk`` directions."""
    from xnode_wan_tpu_torch import (Hypercube, init_xnode, load_params,
                                     load_problem)
    from xnode_wan_tpu_torch.ops.kernels import xnode_train as xt

    dev = torch.device("cuda", 0)
    cfg = load_params(os.path.join(ROOT, "configs", f"{name}.yaml"))
    cfg = cfg.replace(**sets) if sets else cfg
    gen = torch.Generator(device=dev).manual_seed(0)
    net = xt.flat_net(init_xnode(cfg, gen, device=dev))
    cube = Hypercube(cfg.shape_param, cfg.dim, cfg.T0, cfg.T, cfg.N_t)
    batch = cube.interior(gen, cfg.N_r)
    inputs = [a.contiguous() for a in xt.path_tangent_inputs(
        batch, load_problem("Ex4_1_funcs", dim=cfg.dim), cfg)]
    d = cfg.dim
    if chunk:
        d = xt.kernel_route(net.dims(), cfg.dim, cfg.solver).d_chunk
        inputs[1] = inputs[1][:, :d].contiguous()
        inputs[3] = inputs[3][:, :d].contiguous()
    t0, dt = [a.contiguous() for a in xt._prep_intervals(
        batch.times, batch.mask, batch.t_start, cfg.n_sub)]
    args = (t0, dt, *inputs)
    N, L = cfg.N_r, cfg.N_t
    with torch.no_grad():
        want = xt.u_du_fwd_plain(net, *args, cfg.n_sub, cfg.solver,
                                 store=True)
        ub = torch.randn((N, L), generator=gen, device=dev)
        dub = torch.randn((N, L, d), generator=gen, device=dev)
        gwant = xt.u_du_bwd_plain(net, *args, *want[2:], ub, dub, cfg.n_sub,
                                  cfg.solver)
    return cfg, net, args, want, ub, dub, gwant


def _path_tile_helpers(xt, xe):
    """The path-tile #2 and #1 through their launch helpers at the rule's
    tile, or at ``tile`` (``(rows, slice)``); an older checkout's helpers
    (#3's body at d = 0) take ``grad_tile``'s tile and no ``tile``."""
    if hasattr(xt, "path_tile"):
        def rule(dims, method, tile=None):
            return xt.PathTile(*tile) if tile else xt.path_tile(dims, method)

        def path(net, packed, args, n_sub, method, tile=None):
            return xt._path_tile_forward(net, packed, *args, n_sub, method,
                                         rule(net.dims(), method, tile))
    else:
        def rule(dims, method, tile=None):
            if tile:
                raise ValueError("an older checkout's path tile takes no "
                                 "(rows, slice)")
            return xt.grad_tile(dims, 0, method, False)

        def path(net, packed, args, n_sub, method, tile=None):
            return xt._path_tile_forward(xt.PATH_TILE_KERNEL, net, packed,
                                         *args, n_sub, method,
                                         rule(net.dims(), method, tile))

    def serve(net, packed, args, k_steps, method, tile=None):
        return xe._serve_tile(net, packed, *args, k_steps, method,
                              rule(net.dims(), method, tile))
    return rule, path, serve


def path_config(name: str, sets: dict, reps: int, card: str, serve_m: int,
                direct: bool, rows, slices, ragged: bool) -> list:
    """#1 and #2 at one config's net (random weights, seed 0): the route,
    the path-tile kernel at its rule's tile with ``direct``, and at each
    fitting (rows, slice) of ``rows`` x ``slices``; each against its plain
    version, twice, bitwise, and timed."""
    from xnode_wan_tpu_torch import (Hypercube, init_xnode, load_params,
                                     load_problem)
    from xnode_wan_tpu_torch.models.xnode import (path_seed_fn,
                                                  spatial_features)
    from xnode_wan_tpu_torch.ops.kernels import xnode_eval as xe
    from xnode_wan_tpu_torch.ops.kernels import xnode_train as xt

    dev = torch.device("cuda", 0)
    cfg = load_params(os.path.join(ROOT, "configs", f"{name}.yaml"))
    cfg = cfg.replace(**sets) if sets else cfg
    gen = torch.Generator(device=dev).manual_seed(0)
    net = xt.flat_net(init_xnode(cfg, gen, device=dev))
    packed = net.packed()
    dims, method = net.dims(), cfg.solver
    problem = load_problem("Ex4_1_funcs", dim=cfg.dim)
    cube = Hypercube(cfg.shape_param, cfg.dim, cfg.T0, cfg.T, cfg.N_t)
    k_steps = max(cfg.min_steps, cfg.N_t) * cfg.n_sub
    rule, path_tile, serve_tile = _path_tile_helpers(xt, xe)
    route = xt.kernel_route(dims, 0, method)
    label = f"{name} {sets or ''} {dims} {method}"
    print(f"{label}: route {route.path} {route.path_tile}; "
          f"{len(packed)} weights ({card})")

    def path_args(n):
        b = cube.interior(gen, n)
        xs = b.space[:, 0, :].contiguous()
        t0, dt = xt._prep_intervals(b.times, b.mask, b.t_start, cfg.n_sub)
        return (t0.contiguous(), dt.contiguous(),
                spatial_features(xs, cfg.fourier_features).contiguous(),
                path_seed_fn(b, problem, cfg)(xs).contiguous())

    with torch.no_grad():
        pts = torch.rand((serve_m, cfg.dim + 1), generator=gen, device=dev)
        pts[:, 1:] = cube.bot + pts[:, 1:] * (cube.top - cube.bot)
        pts[:, 0] = cfg.T0 + pts[:, 0] * (cfg.T - cfg.T0)
        x_p = pts[:, 1:].contiguous()
        t_s = torch.full_like(pts[:, 0], cfg.T0)
        serve_args = (spatial_features(x_p, cfg.fourier_features).contiguous(),
                      pts[:, 0].contiguous(), t_s,
                      (problem.h(torch.cat([t_s[:, None], x_p], -1))
                       / cfg.u_scale_eff).contiguous())
        counts = [cfg.N_r] + ([cfg.N_r + 1, 37] if ragged else [])
        paths = {n: path_args(n) for n in counts}

    cases = []   # (kernel, how, launch, plain, work items)
    for n, args in paths.items():
        cases.append(("#2", f"route ({route.path}) N={n}",
                      lambda a=args: xt.path_forward_cuda(
                          net, *a, cfg.n_sub, method),
                      lambda a=args: xt.path_forward_plain(
                          net, *a, cfg.n_sub, method), n))
    cases.append(("#1", f"route ({route.path}) M={serve_m}",
                  lambda: xe.evaluate_cuda(net, *serve_args, k_steps, method),
                  lambda: xe.evaluate_plain(net, *serve_args, k_steps,
                                            method), serve_m))
    tiles = []
    if direct and route.path == "registers":
        tiles.append(None)
    tiles += [(r, k) for r in rows or () for k in slices or (0,)
              if xt.path_tile_smem_bytes(dims, method, r, k)
              <= xt.MAX_SMEM_BYTES] if hasattr(xt, "path_tile") else []
    for tile in tiles:
        how = f"tile {rule(dims, method, tile)}"
        for n, args in paths.items():
            cases.append(("#2", f"{how} N={n}",
                          lambda a=args, t=tile: path_tile(
                              net, packed, a, cfg.n_sub, method, t),
                          lambda a=args: xt.path_forward_plain(
                              net, *a, cfg.n_sub, method), n))
        cases.append(("#1", f"{how} M={serve_m}",
                      lambda t=tile: serve_tile(net, packed, serve_args,
                                                k_steps, method, t),
                      lambda: xe.evaluate_plain(net, *serve_args, k_steps,
                                                method), serve_m))
    rows_out = []
    for kernel, how, launch, plain_fn, items in cases:
        with torch.no_grad():
            got, again = launch(), launch()
            want = plain_fn()
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(got, again))
            err = float((got - want).abs().max())
            ok = bool(torch.allclose(got, want, rtol=2e-4, atol=2e-5))
            ms = _time_ms(launch, reps)
        print(f"  {kernel} {how}: {ms:.4f} ms, max |kernel - plain| "
              f"{err:.3e} ({'ok' if ok else 'FAIL'}), twice bitwise: "
              f"{bitwise}")
        if not (ok and bitwise):
            raise AssertionError(f"{label} {kernel} {how}: against plain "
                                 f"{err:.3e}, bitwise {bitwise}")
        rows_out.append({"config": name, "sets": sets, "dims": dims,
                         "method": method, "kernel": kernel, "how": how,
                         "items": items, "ms": ms, "err": err,
                         "card": card})
    return rows_out


def same_tile(name: str, sets: dict, tiles, reps: int, card: str) -> list:
    """#5's shared and global accumulators at the same tile, threads and
    grid, each through its launcher: times (alternated) and bitwise
    equality."""
    from xnode_wan_tpu_torch.ops.kernels import xnode_train as xt
    from xnode_wan_tpu_torch.ops.kernels.steppers import (MAX_SMEM_BYTES,
                                                          METHOD_IDS,
                                                          bwd_blocks)

    cfg, net, args, want, ub, dub, gwant = config_batch(name, sets, True)
    dev = ub.device
    dims, d, method = net.dims(), args[-1].shape[1], cfg.solver
    N, L = ub.shape
    packed = net.packed()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if tiles is None:
        tiles = [xt.grad_tile(dims, d, method, True).paths]
    rows = []
    for tile in tiles:
        smem = xt.tile_smem_bytes(dims, d, method, tile, True)
        if smem > MAX_SMEM_BYTES:
            continue
        threads = xt.block_threads(tile, d, dims[1], True)
        grid = bwd_blocks(N, tile, smem, threads, sms)

        def launch(kernel):
            part = torch.empty((grid, packed.numel()), device=dev)
            grad = torch.empty((packed.numel(),), device=dev)
            kernel(dev, packed.data_ptr(), packed.numel(),
                   *(a.data_ptr() for a in (*args, *want[2:], ub, dub, part,
                                            grad)),
                   N, L, d, *dims, cfg.n_sub, METHOD_IDS[method], tile,
                   threads, grid)
            return grad

        with torch.no_grad():
            got = {k: launch(getattr(xt, k))
                   for k in ("BWD_KERNEL", "BWD_GLOBAL_KERNEL")}
            times = {k: [] for k in got}
            for k in ("BWD_KERNEL", "BWD_GLOBAL_KERNEL", "BWD_GLOBAL_KERNEL",
                      "BWD_KERNEL"):
                times[k].append(_time_ms(lambda k=k: launch(getattr(xt, k)),
                                         reps))
        row = {"config": name, "set": sets, "dims": list(dims), "d": d,
               "tile": tile, "threads": threads, "grid": grid,
               "card": card,
               "bitwise": bool(torch.equal(got["BWD_KERNEL"],
                                           got["BWD_GLOBAL_KERNEL"])),
               "max_rel_err": _scaled_err(got["BWD_KERNEL"], gwant),
               "shared_ms": times["BWD_KERNEL"],
               "global_ms": times["BWD_GLOBAL_KERNEL"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def sweep_config(name: str, tiles, threads, reps: int, card: str,
                 f64: bool = False, rule: bool = False, sets=None,
                 cluster=None):
    from xnode_wan_tpu_torch.ops.kernels import xnode_train as xt
    from xnode_wan_tpu_torch.ops.kernels.steppers import MAX_SMEM_BYTES

    cfg, net, args, want, ub, dub, gwant = config_batch(name, sets, rule)
    packed, n_sub, method = net.packed(), cfg.n_sub, cfg.solver
    d = args[-1].shape[1]
    rows = []
    if f64:
        row = {"config": name, "card": card, "vs_f64": f64_check(
            xt, net, args, want, ub, dub, gwant, n_sub, method)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    kept = (xt.FWD_TILES, xt.BWD_TILES, xt.block_threads, xt.CLUSTERS)
    shapes = [("rule", None)] if rule else itertools.product(tiles, threads)
    try:
        for tile, thr in shapes:
            row = {"config": name, "set": sets, "tile": tile,
                   "threads": thr, "card": card}
            if rule:
                if cluster:
                    xt.CLUSTERS = (cluster,)
                    row["cluster"] = cluster
            else:
                xt.FWD_TILES = xt.BWD_TILES = (tile,)
                xt.block_threads = lambda *_, thr=thr: thr
            # the route is cached by shapes: taken anew for these rules
            xt.kernel_route.cache_clear()
            if rule:
                route = xt.kernel_route(net.dims(), cfg.dim, method)
                row.update(d_chunk=d, chunks=cfg.dim // d, route=repr(route))
            for kernel, backward in (("xnode_udu_fwd", False),
                                     ("xnode_udu_fwd_store", False),
                                     ("xnode_udu_bwd", True)):
                smem = None if rule else xt.tile_smem_bytes(
                    net.dims(), d, method, tile, backward)
                if smem is not None and smem > MAX_SMEM_BYTES:
                    continue
                if backward:
                    def run():
                        return xt.u_du_bwd_cuda(net, packed, *args, *want[2:],
                                                ub, dub, n_sub, method)
                else:
                    store = kernel.endswith("store")

                    def run():
                        return xt.u_du_fwd_cuda(net, packed, *args, n_sub,
                                                method, store)
                with torch.no_grad():
                    got = run()
                    torch.cuda.synchronize()
                    if backward:
                        err = _scaled_err(got, gwant)
                        bitwise = bool(torch.equal(got, run()))
                    else:
                        err = max(_scaled_err(g, w)
                                  for g, w in zip(got, want))
                        bitwise = None
                    ms = _time_ms(run, reps)
                row[kernel] = {"ms": ms, "smem": smem, "max_rel_err": err,
                               "bitwise_repeat": bitwise}
                if rule:  # a launch x d / d_chunk x its launches a step
                    per_it = cfg.dim // d * (
                        1 if kernel == "xnode_udu_fwd" else cfg.n1)
                    row[kernel].update(launches_per_iteration=per_it,
                                       ms_per_iteration=ms * per_it)
            if any(k.startswith("xnode_") for k in row):
                rows.append(row)
                print(json.dumps(row), flush=True)
    finally:
        xt.FWD_TILES, xt.BWD_TILES, xt.block_threads, xt.CLUSTERS = kept
        xt.kernel_route.cache_clear()
    return rows


def adversary_config(name: str, reps: int, card: str, sets=None,
                     cluster=None, fwd_only: bool = False) -> dict:
    from xnode_wan_tpu_torch import init_discriminator, load_params
    from xnode_wan_tpu_torch.models.discriminator import disc_features
    from xnode_wan_tpu_torch.ops.kernels import disc_train as dt

    dev = torch.device("cuda", 0)
    cfg = load_params(os.path.join(ROOT, "configs", f"{name}.yaml"))
    cfg = cfg.replace(**sets) if sets else cfg
    gen = torch.Generator(device=dev).manual_seed(0)
    L, tied = cfg.v_layers, cfg.tied_v
    vp = init_discriminator(cfg.dim, cfg.v_hidden_dim, L, tied,
                            cfg.v_fourier_features, generator=gen, device=dev)
    geom = dt.geom_of(vp, L, tied)
    packed = dt.live_packed_disc(vp, L, tied).detach()
    M = cfg.N_r * cfg.N_t
    pts = torch.rand((M, cfg.dim + 1), generator=gen, device=dev)
    pts[:, 1:] = 2.0 * pts[:, 1:] - 1.0
    feats = disc_features(pts, cfg.v_fourier_features).contiguous()
    vb = torch.randn((M,), generator=gen, device=dev)
    gb = torch.randn((M, geom.F), generator=gen, device=dev)
    row = {"config": name, "set": sets, "geom": list(geom), "points": M,
           "card": card, "route": repr(dt.disc_route(geom))}
    cases = [("disc_fwd", lambda: dt.v_dv_fwd_cuda(packed, feats, geom),
              lambda: dt.v_dv_fwd_plain(packed, feats, geom)),
             ("disc_bwd",
              lambda: dt.v_dv_bwd_cuda(packed, feats, vb, gb, geom),
              lambda: dt.v_dv_bwd_plain(packed, feats, vb, gb, geom))]
    if fwd_only:
        cases = cases[:1]
    if cluster:
        # the rule held to clusters of C blocks, and the cluster variant
        # through its launcher at the tile it gives them where the route
        # does not take it (below CLUSTER_MIN_TILE points)
        kept, dt.CLUSTER = dt.CLUSTER, cluster
        dt.disc_route.cache_clear()
        route = dt.disc_route(geom)
        row.update(cluster=cluster, route=repr(route))
        cases = cases[1:]
        tile = dt.cluster_tile(geom, cluster) if geom.tied else 0
        if route.bwd != "cluster" and tile and cluster <= geom.H:
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            rows = dt.bwd_grid(geom, "cluster", tile, M, sms, cluster,
                               dev.index)
            cases.append((
                f"disc_bwd cluster tile={tile}",
                lambda: dt._bwd_cluster(packed, feats, vb, gb, geom, tile,
                                        rows, cluster, dev), cases[0][2]))
    try:
        with torch.no_grad():
            for kernel, run, plain in cases:
                got, want = run(), plain()
                if kernel == "disc_fwd":
                    err = max(_scaled_err(g, w) for g, w in zip(got, want))
                    bitwise = all(torch.equal(g, h)
                                  for g, h in zip(got, run()))
                else:
                    err = _scaled_err(got, want)
                    bitwise = bool(torch.equal(got, run()))
                row[kernel] = {"ms": _time_ms(run, reps),
                               "max_rel_err": err, "bitwise_repeat": bitwise}
                if kernel == "disc_fwd":
                    row[kernel]["plain_ms"] = _time_ms(plain, 5)
    finally:
        if cluster:
            dt.CLUSTER = kept
            dt.disc_route.cache_clear()
    print(json.dumps(row), flush=True)
    return row


# The parts of #7's cluster variant an ablation build leaves out: (text in
# csrc/disc_train_cluster.cuh, its replacement) pairs
_CUT = {
    "pushes": [("t < items * C; t += blockDim.x)", "t < 0; t += blockDim.x)")],
    "forward": [("for (int k = 0; k < K; ++k) {", "for (int k = 0; k < 0; ++k) {")],
    "products": [("xk_tiles<NB>(d, nk,", "if (0) xk_tiles<NB>(d, nk,")],
    "weight sums": [("      xk_outer<NB>(", "      if (0) xk_outer<NB>("),
                    ("    xk_outer<NB>(", "    if (0) xk_outer<NB>(")],
}
ABLATIONS = dict(_CUT, **{
    "arithmetic": _CUT["forward"] + _CUT["products"] + _CUT["weight sums"],
    "all but barriers": (_CUT["forward"] + _CUT["products"]
                         + _CUT["weight sums"] + _CUT["pushes"])})


# The parts of the tile #6 an ablation build leaves out (text in
# csrc/disc_tile_fwd.cuh, its replacement)
_FWD_CUT = {
    "copies": [("    xf_issue(wbuf + b * y.slice, w, npass * OB,\n"
                "             nslice * (w.cols ? KB : KF), y);", "")],
    "forward": [("          if (!mine) continue;\n          const int kn",
                 "          continue;\n          const int kn")],
    "sweep": [("          xf_mma_slice<U, NB>(d,",
               "          if (0) xf_mma_slice<U, NB>(d,")],
}
FWD_ABLATIONS = dict(_FWD_CUT, **{
    "arithmetic": _FWD_CUT["forward"] + _FWD_CUT["sweep"],
    "all but barriers": (_FWD_CUT["forward"] + _FWD_CUT["sweep"]
                         + _FWD_CUT["copies"])})


# The parts of the path-tile #1/#2 an ablation build leaves out (text in
# csrc/xnode_path_tile.cu, its replacement; timing only, the outputs are
# wrong): the wait for a slice's copy and the barrier before it, the
# copies of the streamed slices too, the products' multiply-adds
_PATH_WAIT = ("    __pipeline_wait_prior(0);\n    __syncthreads();\n"
              "    const float* W;", "    const float* W;")
_PATH_CUT = {
    "waits": [_PATH_WAIT],
    "copies": [_PATH_WAIT, (
        "      xp_fetch(r, last ? (p + 1) % r.n_field : p, last ? 0 : c + 1,\n"
        "               r.slot ^ 1);\n", "")],
    "products": [("      xp_slice_fma(a, X + k0 * S, S, W, ld, k1 - k0, t.r0,\n"
                  "                   t.u0 < ld ? t.u0 : ld - 4);\n", "")]}
PATH_ABLATIONS = dict(_PATH_CUT, **{
    "copies and products": _PATH_CUT["copies"] + _PATH_CUT["products"]})


def _ablation_builds(source: str, ablations: dict,
                     target: str = "disc_train.cu") -> dict:
    """Copies of the kernel sources, one per entry of ``ablations`` and
    one untouched (``"none"``), each with its cuts made in ``source``, all
    built at once (``target``, the file nvcc compiles): ``{part:
    (directory, nvcc process)}``."""
    import shutil

    from xnode_wan_tpu_torch.ops.kernels import _build

    root = _build.BUILD_ROOT / "ablate"
    procs = {}
    for part, cuts in {"none": [], **ablations}.items():
        d = root / part.replace(" ", "_")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        src = d / source
        text = src.read_text()
        for old, new in cuts:
            if old not in text:
                raise ValueError(f"ablation {part}: {old!r} is not in the "
                                 "source")
            text = text.replace(old, new)
        src.write_text(text)
        procs[part] = (d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / target)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def path_ablations(name: str, sets: dict, reps: int, card: str,
                   serve_m: int) -> list:
    """The path-tile #2 (the config's ``N_r`` interior paths) and #1
    (``serve_m`` points) at the route's tile of the config's net (``--set``
    applied, random weights seed 0), in the tree's build and in one build
    per entry of :data:`PATH_ABLATIONS`, each through its own library."""
    import ctypes

    from xnode_wan_tpu_torch import Hypercube, init_xnode, load_params
    from xnode_wan_tpu_torch.models.xnode import spatial_features
    from xnode_wan_tpu_torch.ops.kernels import xnode_eval as xe
    from xnode_wan_tpu_torch.ops.kernels import xnode_train as xt

    procs = _ablation_builds("xnode_path_tile.cu", PATH_ABLATIONS,
                             "xnode_path_tile.cu")
    dev = torch.device("cuda", 0)
    cfg = load_params(os.path.join(ROOT, "configs", f"{name}.yaml"))
    cfg = cfg.replace(**sets) if sets else cfg
    gen = torch.Generator(device=dev).manual_seed(0)
    net = xt.flat_net(init_xnode(cfg, gen, device=dev))
    packed, dims = net.packed(), net.dims()
    route = xt.kernel_route(dims, 0, cfg.solver)
    if route.path != "tile":
        raise ValueError(f"{dims} routes #1/#2 to {route.path}: no path-tile "
                         "kernel to ablate")
    tile, mid = route.path_tile, xt.METHOD_IDS[cfg.solver]
    cube = Hypercube(cfg.shape_param, cfg.dim, cfg.T0, cfg.T, cfg.N_t)
    b = cube.interior(gen, cfg.N_r)
    t0, dt = [a.contiguous() for a in xt._prep_intervals(
        b.times, b.mask, b.t_start, cfg.n_sub)]
    feats = spatial_features(b.space[:, 0, :],
                             cfg.fourier_features).contiguous()
    seed = torch.rand((cfg.N_r,), generator=gen, device=dev)
    pts = torch.rand((serve_m, cfg.dim + 1), generator=gen, device=dev)
    s_feats = spatial_features(2.0 * pts[:, 1:] - 1.0,
                               cfg.fourier_features).contiguous()
    s_t, s_t0 = pts[:, 0].contiguous(), torch.zeros_like(pts[:, 0])
    s_seed = pts[:, 1].contiguous()
    k_steps = max(cfg.min_steps, cfg.N_t) * cfg.n_sub
    staged = torch.empty((xt.path_tile_staged_floats(dims),), device=dev)
    u = torch.empty((cfg.N_r, cfg.N_t), device=dev)
    out = torch.empty((serve_m,), device=dev)
    row = {"config": name, "set": sets, "dims": list(dims),
           "method": cfg.solver, "tile": list(tile), "paths": cfg.N_r,
           "points": serve_m, "card": card}
    stream = torch.cuda.current_stream(dev).cuda_stream
    for part, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"ablation {part}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        path, serve = lib.xnode_path_tile_launch, lib.xnode_serve_tile_launch
        path.argtypes = ([ctypes.c_int, ctypes.c_void_p]
                         + xt.PATH_TILE_KERNEL.argtypes)
        serve.argtypes = ([ctypes.c_int, ctypes.c_void_p]
                          + xe.TILE_KERNEL.argtypes)

        def run_path():
            err = path(0, stream, packed.data_ptr(), packed.numel(),
                       staged.data_ptr(), t0.data_ptr(), dt.data_ptr(),
                       feats.data_ptr(), seed.data_ptr(), u.data_ptr(),
                       cfg.N_r, cfg.N_t, *dims, cfg.n_sub, mid, *tile)
            if err:
                raise RuntimeError(f"ablation {part}: CUDA error {err}")

        def run_serve():
            err = serve(0, stream, packed.data_ptr(), packed.numel(),
                        staged.data_ptr(), s_feats.data_ptr(), s_t.data_ptr(),
                        s_t0.data_ptr(), s_seed.data_ptr(), out.data_ptr(),
                        serve_m, *dims, k_steps, mid, *tile)
            if err:
                raise RuntimeError(f"ablation {part}: CUDA error {err}")
        row[f"without {part}"] = {"#2 ms": _time_ms(run_path, reps),
                                  "#1 ms": _time_ms(run_serve, reps)}
    print(json.dumps(row), flush=True)
    return [row]


def fwd_ablations(name: str, sets: dict, reps: int, card: str) -> list:
    """The tile #6 at the route's shape (``--set`` applied to the config's
    discriminator, random weights seed 0, ``N_r * N_t`` points) in the
    tree's build and in one build per entry of :data:`FWD_ABLATIONS`,
    each timed through its own library."""
    import ctypes

    from xnode_wan_tpu_torch import init_discriminator, load_params
    from xnode_wan_tpu_torch.models.discriminator import disc_features
    from xnode_wan_tpu_torch.ops.kernels import disc_train as dt

    procs = _ablation_builds("disc_tile_fwd.cuh", FWD_ABLATIONS)
    dev = torch.device("cuda", 0)
    cfg = load_params(os.path.join(ROOT, "configs", f"{name}.yaml"))
    cfg = cfg.replace(**sets) if sets else cfg
    gen = torch.Generator(device=dev).manual_seed(0)
    L, tied = cfg.v_layers, cfg.tied_v
    vp = init_discriminator(cfg.dim, cfg.v_hidden_dim, L, tied,
                            cfg.v_fourier_features, generator=gen, device=dev)
    geom = dt.geom_of(vp, L, tied)
    packed = dt.live_packed_disc(vp, L, tied).detach()
    route = dt.disc_route(geom)
    if route.fwd != "tile":
        raise ValueError(f"{geom} routes #6 to {route.fwd}: no tile #6 to "
                         "ablate")
    M = cfg.N_r * cfg.N_t
    pts = torch.rand((M, cfg.dim + 1), generator=gen, device=dev)
    pts[:, 1:] = 2.0 * pts[:, 1:] - 1.0
    feats = disc_features(pts, cfg.v_fourier_features).contiguous()
    v = torch.empty((M,), device=dev)
    gin = torch.empty((M, geom.F), device=dev)
    row = {"config": name, "set": sets, "geom": list(geom), "points": M,
           "card": card, "route": repr(route)}
    for part, (d, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"ablation {part}: nvcc failed\n{out}")
        launch = ctypes.CDLL(str(d / "lib.so")).disc_tile_fwd_launch
        launch.argtypes = ([ctypes.c_int, ctypes.c_void_p]
                           + dt.FWD_TILE_KERNEL.argtypes)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def run():
            err = launch(0, stream, packed.data_ptr(), geom.n_params,
                         feats.data_ptr(), v.data_ptr(), gin.data_ptr(), M,
                         geom.F, geom.H, L, int(tied), route.fwd_tile)
            if err:
                raise RuntimeError(f"ablation {part}: CUDA error {err}")
        row[f"without {part}"] = {"ms": _time_ms(run, reps)}
    print(json.dumps(row), flush=True)
    return [row]


def cluster_ablations(name: str, sets: dict, reps: int, card: str) -> list:
    """#7's cluster variant at the route's shape (``--set`` applied to the
    config's discriminator, random weights seed 0, ``N_r * N_t`` points) in
    the tree's build and in one build per entry of :data:`ABLATIONS`, all
    built at once, each timed through its own library."""
    import ctypes

    from xnode_wan_tpu_torch import init_discriminator, load_params
    from xnode_wan_tpu_torch.models.discriminator import disc_features
    from xnode_wan_tpu_torch.ops.kernels import disc_train as dt

    procs = _ablation_builds("disc_train_cluster.cuh", ABLATIONS)
    dev = torch.device("cuda", 0)
    cfg = load_params(os.path.join(ROOT, "configs", f"{name}.yaml"))
    cfg = cfg.replace(**sets) if sets else cfg
    gen = torch.Generator(device=dev).manual_seed(0)
    L = cfg.v_layers
    vp = init_discriminator(cfg.dim, cfg.v_hidden_dim, L, True,
                            cfg.v_fourier_features, generator=gen, device=dev)
    geom = dt.geom_of(vp, L, True)
    packed = dt.live_packed_disc(vp, L, True).detach()
    route = dt.disc_route(geom)
    if route.bwd != "cluster":
        raise ValueError(f"{geom} routes #7 to {route.bwd}: no cluster "
                         "variant to ablate")
    M = cfg.N_r * cfg.N_t
    pts = torch.rand((M, cfg.dim + 1), generator=gen, device=dev)
    pts[:, 1:] = 2.0 * pts[:, 1:] - 1.0
    feats = disc_features(pts, cfg.v_fourier_features).contiguous()
    vb = torch.randn((M,), generator=gen, device=dev)
    gb = torch.randn((M, geom.F), generator=gen, device=dev)
    grad = torch.empty((geom.n_params,), device=dev)
    row = {"config": name, "set": sets, "geom": list(geom), "points": M,
           "card": card, "route": repr(route)}
    for part, (d, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"ablation {part}: nvcc failed\n{out}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        launch, occ = lib.disc_bwd_cluster_launch, lib.disc_cluster_occupancy
        launch.argtypes = ([ctypes.c_int, ctypes.c_void_p]
                           + dt.BWD_CLUSTER_KERNEL.argtypes)
        occ.argtypes = [ctypes.c_int] * 6
        clusters = min(-(-M // route.bwd_tile),
                       occ(0, geom.F, geom.H, L, route.bwd_tile,
                           route.cluster))
        partial = torch.empty((clusters, geom.n_params), device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def run():
            err = launch(0, stream, packed.data_ptr(), geom.n_params,
                         feats.data_ptr(), vb.data_ptr(), gb.data_ptr(),
                         partial.data_ptr(), grad.data_ptr(), M, geom.F,
                         geom.H, L, 1, route.bwd_tile, clusters,
                         route.cluster)
            if err:
                raise RuntimeError(f"ablation {part}: CUDA error {err}")
        row[f"without {part}"] = {"ms": _time_ms(run, reps)}
    print(json.dumps(row), flush=True)
    return [row]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--configs", nargs="+", default=["cube_pde"])
    ap.add_argument("--set", nargs="+", default=[], metavar="KEY=VALUE",
                    help="override these config fields (YAML values)")
    ap.add_argument("--tiles", nargs="+", type=int, default=None,
                    help="paths per tile (sweep default: 2 4 8 16; "
                         "--same-tile default: the wrappers' tile)")
    ap.add_argument("--threads", nargs="+", type=int,
                    default=[64, 128, 256])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rule", action="store_true",
                    help="time the wrappers' own tile choice only")
    ap.add_argument("--cluster", nargs="+", type=int, default=None,
                    help="with --rule (#5) or --adversary (#7): time the "
                         "cluster variant on clusters of each of these "
                         "many blocks")
    ap.add_argument("--same-tile", action="store_true",
                    help="time #5's shared accumulator against its "
                         "global one at the same tile and grid")
    ap.add_argument("--path", action="store_true",
                    help="time #1 and #2 at each config's net instead")
    ap.add_argument("--serve", type=int, default=65536,
                    help="with --path: points served by #1")
    ap.add_argument("--direct", action="store_true",
                    help="with --path: also the path-tile kernel at its "
                         "rule's tile where the route takes the register "
                         "kernel")
    ap.add_argument("--rows", nargs="+", type=int, default=None,
                    help="with --path: paths a tile of the path-tile kernel")
    ap.add_argument("--slices", nargs="+", type=int, default=None,
                    help="with --path and --rows: inputs a weight slice (0: "
                         "the weights resident)")
    ap.add_argument("--ragged", action="store_true",
                    help="with --path: #2 also at N_r + 1 and 37 paths")
    ap.add_argument("--adversary", action="store_true",
                    help="time kernels #6 and #7 at each config's "
                         "discriminator instead")
    ap.add_argument("--ablate", action="store_true",
                    help="with --adversary: time #7's cluster variant (with "
                         "--fwd-only: the tile #6), with --path the "
                         "path-tile #1/#2, in builds that each leave one "
                         "part out")
    ap.add_argument("--fwd-only", action="store_true",
                    help="with --adversary: time kernel #6 alone")
    ap.add_argument("--f64", action="store_true",
                    help="also hold the plain f32 version and the kernels "
                         "against the plain version in f64")
    ap.add_argument("--out", default=os.path.join(ROOT, "example_run",
                                                  "tile_sweep.json"))
    args = ap.parse_args(argv)
    sets = parse_sets(args.set)
    if not torch.cuda.is_available():
        print("tile_sweep: no CUDA device", file=sys.stderr)
        return 1
    from xnode_wan_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    if args.path and args.ablate:
        rows = [r for name in args.configs
                for r in path_ablations(name, sets, args.reps, card,
                                        args.serve)]
    elif args.path:
        sources = [s_ for s_ in ("xnode_path_tile", "xnode_grad")
                   if (_build.CSRC / f"{s_}.cu").exists()][:1]
        _build.build([(s_, None) for s_ in sources])
        for s_ in sources:
            log = (_build.build_dir() / f"{s_}.log").read_text()
            for line in log.splitlines():
                if ("Compiling" in line or "registers" in line
                        or "stack" in line):
                    print(f"  ptxas {s_}: {line.strip()}")
        rows = [r for name in args.configs
                for r in path_config(name, sets, args.reps, card, args.serve,
                                     args.direct, args.rows, args.slices,
                                     args.ragged)]
        for log in sorted(_build.build_dir().glob("xnode_fwd_*.log")):
            for line in log.read_text().splitlines():
                if "registers" in line or "stack" in line:
                    print(f"  ptxas {log.stem}: {line.strip()}")
    elif args.adversary and args.ablate:
        ablate = fwd_ablations if args.fwd_only else cluster_ablations
        rows = [r for name in args.configs
                for r in ablate(name, sets, args.reps, card)]
    elif args.adversary:
        rows = [adversary_config(name, args.reps, card, sets, c,
                                 args.fwd_only)
                for name in args.configs for c in args.cluster or [None]]
    else:
        _build.build([("xnode_grad", None)])
        log = _build.build_dir() / "xnode_grad.log"
        for line in log.read_text().splitlines():
            if "Compiling" in line or "registers" in line or "stack" in line:
                print(f"  ptxas: {line.strip()}")
        rows = []
        for name in args.configs:
            if args.same_tile:
                rows += same_tile(name, sets, args.tiles, args.reps, card)
            else:
                for c in args.cluster or [None]:
                    rows += sweep_config(name, args.tiles or [2, 4, 8, 16],
                                         args.threads, args.reps, card,
                                         args.f64, args.rule, sets, c)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
