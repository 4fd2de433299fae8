"""Command-line entry point of the port, with the JAX package's flags
(``xnode_wan_tpu/main.py``) and ``--device``.

    python -m xnode_wan_tpu_torch.main --params configs/cube_pde.yaml \
        --funcs Ex4_1_funcs [--work_dir ./run] [--report_it 10] [--resume]

It trains on the current CUDA device and raises without one unless
``--device`` names another (``--device cpu`` runs every kernel's plain
PyTorch version). ``--resume`` continues from ``checkpoint_NODE.pt`` in
the work directory. The config picks the primal (``primal: wan``), the
ensemble (``ensemble: K``: each log record is the best member's, with
``best_member`` and ``rel_err_worst``) and the clouds (``qmc: halton``).
With the default ``--report`` the slice along axes (0, 1) is plotted at
every report step (``utils/viz.py``).

Under ``torchrun --nproc_per_node=N -m xnode_wan_tpu_torch.main ...``
(``WORLD_SIZE > 1``) each rank takes ``cuda:LOCAL_RANK`` (or ``--device``)
and joins the world (``parallel.mesh.init_distributed``); the solver's
mesh is then the world and rank 0 writes the files.
"""

from __future__ import annotations

import argparse
import os

import torch.distributed as dist

from xnode_wan_tpu_torch.config import load_params
from xnode_wan_tpu_torch.parallel.mesh import init_distributed
from xnode_wan_tpu_torch.problems import load_problem
from xnode_wan_tpu_torch.training import NODEWANSolver


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="XNODE-WAN PDE solver (PyTorch/CUDA)",
        description=("a general purpose parabolic PDE solver using the "
                     "XNODE-WAN architecture, on an NVIDIA GPU"))
    parser.add_argument("-w", "--work_dir", type=str, default="./",
                        help="directory for artifacts and checkpoints")
    parser.add_argument("--params", required=True,
                        help="YAML experiment setup (reference key set)")
    parser.add_argument("--funcs", required=True,
                        help="problem name or module path (e.g. Ex4_1_funcs)")
    parser.add_argument("--report", action="store_true", default=True)
    parser.add_argument("--no-report", dest="report", action="store_false")
    parser.add_argument("--report_it", type=int, default=10)
    parser.add_argument("--show_plt", action="store_true")
    parser.add_argument("--resume", action="store_true",
                        help="resume from checkpoint_NODE.pt in work_dir")
    parser.add_argument("--iterations", type=int, default=None,
                        help="override the YAML iteration count")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the current CUDA "
                             "device; 'cpu' runs the plain versions)")
    return parser


def main(argv=None) -> NODEWANSolver:
    """Parse ``argv``, train, and return the solver."""
    args = build_parser().parse_args(argv)
    cfg = load_params(args.params)
    problem = load_problem(args.funcs, dim=cfg.dim)
    device = args.device
    joined = (int(os.environ.get("WORLD_SIZE", "1")) > 1
              and not dist.is_initialized())
    if joined:
        device = init_distributed(
            device or f"cuda:{os.environ.get('LOCAL_RANK', '0')}")
    try:
        solver = NODEWANSolver(cfg, problem, device=device,
                               work_dir=args.work_dir)
        if args.resume:
            solver.load_checkpoint()
        solver.train(report=args.report, report_it=args.report_it,
                     show_plt=args.show_plt, iterations=args.iterations)
    finally:
        if joined:   # NCCL's communicators must close before the exit
            dist.destroy_process_group()
    return solver


if __name__ == "__main__":
    main()
