"""Rank functions for ``tests/test_torch_parallel.py``: two processes
spawned over ``gloo`` on the CPU run each case on a mesh of the world and
save what the single-process twin is held against. This module imports
no JAX (a spawned rank imports it by name), and holds no test itself."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from xnode_wan_tpu_torch import NODEWANSolver, SolverConfig, load_problem
from xnode_wan_tpu_torch.models.xnode import evaluate_points
from xnode_wan_tpu_torch.parallel.mesh import init_distributed

STEP = dict(dim=2, N_t=6, N_r=24, N_b=16, u_hidden_dim=8,
            u_hidden_hidden_dim=8, u_layers=2, v_layers=3, v_hidden_dim=12,
            alpha=1e4, shape_param=(-1.0, 1.0), min_steps=4, seed=1,
            x64=True)

# name -> (config, problem, iterations); every case starts from seed 1
CASES = {
    "cube": (STEP, "cube_pde", 1),
    "cube_odd_nr": (dict(STEP, N_r=25, N_b=15), "cube_pde", 1),
    "cube_f32_fused_v": (dict(STEP, x64=False, fused_v=True), "cube_pde", 1),
    "hourglass": (dict(STEP, domain="NSphere_THourglass", shape_param=1.0,
                       N_r=16, N_b=16), "Ex4_1_funcs", 1),
    "ensemble": (dict(STEP, ensemble=2), "cube_pde", 1),
    "tangent": (dict(STEP, dim=3, tangent_shards=2), "cube_pde", 1),
    # f32: the ensemble through the plain versions of #2-#7 on each rank,
    # the tangent split's u side plain and its adversary through #6/#7
    "ensemble_f32_fused_v": (dict(STEP, ensemble=2, x64=False,
                                  fused_v=True), "cube_pde", 1),
    "tangent_f32_fused_v": (dict(STEP, dim=3, tangent_shards=2, x64=False,
                                 fused_v=True), "cube_pde", 1),
    "cube_20": (STEP, "cube_pde", 20),
}


def build(name: str, work_dir: str, **override) -> NODEWANSolver:
    kw, problem, _ = CASES[name]
    kw = dict(kw, **override)
    return NODEWANSolver(SolverConfig(**kw),
                         load_problem(problem, kw["dim"]), device="cpu",
                         work_dir=work_dir)


def state_arrays(solver: NODEWANSolver) -> list:
    """The parameters and Adam moments of the members this rank steps
    (all of them in one process), as numpy arrays."""
    out = []
    for st in (solver.members[k] for k in solver._owned):
        for module, opt in ((st.u_params, st.opt_u), (st.v_params, st.opt_v)):
            for p in module.parameters():
                out.append(p.detach().numpy().copy())
                for key in ("exp_avg", "exp_avg_sq"):
                    out.append(opt.state[p][key].numpy().copy())
    return out


def run_case(name: str, work_dir: str, **override) -> dict:
    """The case's iterations (one outer step, or ``train_until`` for the
    20-iteration case): metrics, parameters, moments and, after the step,
    the checkpoint file. Without an initialized world this is the
    single-process twin (``override``: N_r and N_b as a mesh rounded
    them)."""
    solver = build(name, work_dir, **override)
    iters = CASES[name][2]
    if iters == 1:
        metrics = solver._to_host(solver._outer_step())
        solver.save_checkpoint()
    else:
        hist = solver.train_until(1e-9, iters)
        metrics = {k: hist[k] for k in ("loss_u", "L2", "rel_err")}
    return {"metrics": metrics, "state": state_arrays(solver),
            "N_r": solver.cfg.N_r, "N_b": solver.cfg.N_b,
            "steps": [st.step for st in solver.members]}


def serve(work_dir: str) -> dict:
    """``evaluate_points`` of the cube's and the hourglass's primal on
    the mesh, against the same call without one on this rank."""
    out = {}
    for name in ("cube", "hourglass"):
        solver = build(name, work_dir)
        gen = torch.Generator().manual_seed(5)
        pts = torch.rand((101, solver.cfg.dim + 1), generator=gen,
                         dtype=torch.float64)
        pts[:, 1:] = 2 * pts[:, 1:] - 1
        params = solver._u_params_for_eval()
        args = (params, pts, solver.problem, solver.cfg)
        with torch.no_grad():
            sharded = evaluate_points(*args, domain=solver.domain,
                                      mesh=solver.mesh)
            whole = evaluate_points(*args, domain=solver.domain)
        out[name] = (sharded.numpy(), whole.numpy(),
                     solver.predict(pts).numpy())
    return out


def cli(work_root: str, rank: int) -> list:
    """The command line on every rank of the world, each rank with its
    own work directory: the files it wrote."""
    from xnode_wan_tpu_torch.main import main
    import yaml
    params = os.path.join(work_root, f"cli_{rank}.yaml")
    with open(params, "w") as fh:
        yaml.safe_dump(dict(STEP, shape_param=[-1.0, 1.0], x64=False,
                            iterations=3), fh)
    work = os.path.join(work_root, f"cli_run_{rank}")
    main(["--params", params, "--funcs", "cube_pde", "-w", work,
          "--device", "cpu", "--report_it", "5"])
    return sorted(os.listdir(work)) if os.path.isdir(work) else []


def rank_main(rank: int, world: int, port: int, out_dir: str,
              cases) -> None:
    torch.set_num_threads(1)
    init_distributed("cpu", init_method=f"tcp://localhost:{port}",
                     world_size=world, rank=rank)
    try:
        results = {}
        for name in cases:
            work = os.path.join(out_dir, f"{name}_rank{rank}")
            if name == "serve":
                results[name] = serve(work)
            elif name == "cli":
                results[name] = cli(out_dir, rank)
            else:
                results[name] = run_case(name, work)
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
