"""The port's command line and what it writes: the run logger against the
JAX package's, checkpoints and resume (bitwise on the CPU), the best
weights in the reference's layout, and ``python -m
xnode_wan_tpu_torch.main`` on a small d=2 ``fused_v`` config."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import yaml

from xnode_wan_tpu.main import build_parser as jbuild_parser
from xnode_wan_tpu.utils.logging import RunLogger as JRunLogger
from xnode_wan_tpu_torch import (NODEWANSolver, RunLogger, SolverConfig,
                                 load_problem, load_reference_state_dict)
from xnode_wan_tpu_torch.main import build_parser, main

SMALL = dict(dim=2, N_t=8, N_r=64, N_b=64, u_hidden_dim=8,
             u_hidden_hidden_dim=8, u_layers=2, v_layers=3, v_hidden_dim=12,
             iterations=40, alpha=1e4, shape_param=(-1.0, 1.0), min_steps=4,
             seed=1)
STEP = dict(SMALL, N_r=24, N_b=16, N_t=6)
ARTIFACTS = ("losses_NODE_2.json", "L2_NODE_2.json", "Time_NODE_2.json",
             "metrics_NODE_2.jsonl", "checkpoint_NODE.pt",
             "best_model_weights_NODE.pth")


def test_run_logger_matches_jax_files(tmp_path):
    # the same calls give the same file names and the same contents, but
    # for the wall-clock stamps
    n = 60
    loggers = [cls(3, str(tmp_path / name))
               for cls, name in ((RunLogger, "port"), (JRunLogger, "jax"))]
    for k in range(n):
        m = {"loss_u": 2.0 * k, "L2": k / 3, "rel_err": 0.5 / (k + 1)}
        if k == 4:
            del m["L2"]
        for logger in loggers:
            logger.log(k, m)
    for i, logger in enumerate(loggers):
        if i == 0:   # after two incremental flushes: 50 records, no lists
            path = tmp_path / "port" / "metrics_NODE_3.jsonl"
            assert sum(1 for _ in open(path)) == 50
            assert not (tmp_path / "port" / "L2_NODE_3.json").exists()
        logger.flush()
    names = [sorted(os.listdir(tmp_path / n)) for n in ("port", "jax")]
    assert names[0] == names[1] == ["L2_NODE_3.json", "Time_NODE_3.json",
                                    "losses_NODE_3.json",
                                    "metrics_NODE_3.jsonl"]
    for name in ("losses_NODE_3.json", "L2_NODE_3.json"):
        got, want = (json.load(open(tmp_path / n / name))
                     for n in ("port", "jax"))
        assert got == want
    t = json.load(open(tmp_path / "port" / "Time_NODE_3.json"))
    assert len(t) == n + 1 and all(b >= a for a, b in zip(t, t[1:]))
    recs = [[json.loads(line) for line in open(tmp_path / n /
                                               "metrics_NODE_3.jsonl")]
            for n in ("port", "jax")]
    strip = [[{k: v for k, v in r.items() if k != "time"} for r in rs]
             for rs in recs]
    assert strip[0] == strip[1] and [r["step"] for r in recs[0]] == \
        list(range(n))


def state_arrays(solver):
    """Every number the next iteration reads, as numpy arrays."""
    st = solver.state
    out = [p.detach().numpy() for p in st.u_params.parameters()]
    out += [p.detach().numpy() for p in st.v_params.parameters()]
    for opt in (st.opt_u, st.opt_v):
        for s in opt.state.values():
            out += [s["exp_avg"].numpy(), s["exp_avg_sq"].numpy(),
                    np.asarray(float(s["step"]))]
        out += [np.asarray(g["lr"]) for g in opt.param_groups]
    if st.u_ema is not None:
        out += [p.detach().numpy() for p in st.u_ema.parameters()]
    out.append(st.generator.get_state().numpy())
    return out


@pytest.mark.parametrize("extra", [dict(), dict(fused_v=True, ema_decay=0.9,
                                                lr_decay=0.9)],
                         ids=["plain", "fused_v_ema_decay"])
def test_resume_reproduces_uninterrupted_run_bitwise(tmp_path, extra):
    cfg = SolverConfig(**dict(STEP, **extra))
    problem = load_problem("cube_pde", 2)
    first = NODEWANSolver(cfg, problem, device="cpu",
                          work_dir=str(tmp_path / "split"))
    first.train(iterations=3)
    resumed = NODEWANSolver(cfg, problem, device="cpu",
                            work_dir=str(tmp_path / "split"))
    resumed.load_checkpoint()
    assert resumed.state.step == 3 and resumed.best_l == first.best_l
    m_resumed = resumed.train(iterations=2)
    whole = NODEWANSolver(cfg, problem, device="cpu",
                          work_dir=str(tmp_path / "whole"))
    m_whole = whole.train(iterations=5)
    assert resumed.state.step == whole.state.step == 5
    assert m_resumed == m_whole
    for a, b in zip(state_arrays(resumed), state_arrays(whole)):
        np.testing.assert_array_equal(a, b)


def test_best_weights_round_trip(tmp_path):
    solver = NODEWANSolver(SolverConfig(**STEP), load_problem("cube_pde", 2),
                           device="cpu", work_dir=str(tmp_path))
    solver.train(iterations=4)
    sd = torch.load(tmp_path / "best_model_weights_NODE.pth",
                    weights_only=True)
    assert "module.initial_layers.4.weight" in sd
    assert "module.ODE_rhs.net.0.weight" in sd
    assert "module.final_linear.bias" in sd
    loaded = load_reference_state_dict(
        str(tmp_path / "best_model_weights_NODE.pth"), device="cpu",
        dtype=torch.float32)
    best = solver.best_u_params
    for a, b in zip(loaded.parameters(), best.parameters()):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)
    pts = torch.tensor([[0.5, 0.1, -0.3], [1.0, 0.0, 0.0]])
    u = solver.predict(pts)
    assert u.shape == (2,) and solver.predict(pts[0]).shape == ()
    # one point against a batch of two: the CPU's matrix products may sum
    # in another order, so f32 rounding
    torch.testing.assert_close(solver.predict(pts[0]), u[0], rtol=1e-6,
                               atol=1e-6)


def write_config(tmp_path, **extra):
    path = tmp_path / "small.yaml"
    cfg = dict(SMALL, shape_param=[-1.0, 1.0], fused_v=True, **extra)
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_cli_fused_v_writes_artifacts_and_resumes(tmp_path, capsys):
    params = write_config(tmp_path)
    work = str(tmp_path / "run")
    argv = ["--params", params, "--funcs", "cube_pde", "-w", work,
            "--report_it", "2", "--device", "cpu"]
    solver = main(argv + ["--iterations", "4"])
    out = capsys.readouterr().out
    assert "iteration: 0 Loss u:" in out and "iteration: 2 Loss u:" in out
    assert " rel: " in out and "iteration: 1 " not in out
    for name in ARTIFACTS:
        assert os.path.exists(os.path.join(work, name)), name
    recs = [json.loads(line) for line in open(os.path.join(
        work, "metrics_NODE_2.jsonl"))]
    assert [r["step"] for r in recs] == [0, 1, 2, 3]
    assert solver.state.step == 4 and solver.cfg.fused_v

    fresh = NODEWANSolver(solver.cfg, load_problem("cube_pde", 2),
                          device="cpu", work_dir=work).load_checkpoint()
    assert fresh.state.step == 4
    for opt, want in ((fresh.state.opt_u, solver.state.opt_u),
                      (fresh.state.opt_v, solver.state.opt_v)):
        assert len(opt.state) == len(want.state) > 0
        for a, b in zip(opt.state.values(), want.state.values()):
            for key in ("step", "exp_avg", "exp_avg_sq"):
                torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)

    resumed = main(argv + ["--resume", "--iterations", "2", "--no-report"])
    assert capsys.readouterr().out == ""
    assert resumed.state.step == 6
    recs = [json.loads(line) for line in open(os.path.join(
        work, "metrics_NODE_2.jsonl"))]
    assert [r["step"] for r in recs] == [0, 1]


def test_train_stop_saves_and_reports(tmp_path, capsys):
    easy = dataclasses.replace(load_problem("cube_pde", 2), stop_rel_err=0.9)
    s = NODEWANSolver(SolverConfig(**dict(STEP, fused_v=True)), easy,
                      device="cpu", work_dir=str(tmp_path / "stop"))
    m = s.train(iterations=30)
    assert "Stopping Criterion Reached" in capsys.readouterr().out
    assert s.state.step < 30 and m["rel_err"] < 0.9
    for name in ARTIFACTS:
        assert (tmp_path / "stop" / name).exists(), name


def test_show_plt_raises(tmp_path):
    # plots are ported: --show_plt plots every report step instead
    work = tmp_path / "plots"
    solver = main(["--params", write_config(tmp_path, iterations=3),
                   "--funcs", "cube_pde", "-w", str(work), "--device", "cpu",
                   "--report_it", "2", "--show_plt"])
    assert solver.state.step == 3
    for step in (0, 2):
        assert (work / f"plot_at_{step}_along_[0, 1].png").exists()
    assert (work / "guess_cn.npy").exists() and (work / "error_cn.npy").exists()


def test_cli_flags_cover_the_jax_cli():
    ours = {a.dest for a in build_parser()._actions}
    theirs = {a.dest for a in jbuild_parser()._actions}
    assert theirs <= ours and ours - theirs == {"device"}
    args = build_parser().parse_args(["--params", "p.yaml", "--funcs", "f"])
    assert args.device is None and args.report and args.work_dir == "./"


def test_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--params", write_config(tmp_path), "--funcs", "cube_pde",
              "-w", str(tmp_path)])
