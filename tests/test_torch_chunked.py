"""Chunked training in the port: ``train(chunk=k)`` against ``train(chunk=1)``
(records, best weights, checkpoint, bit for bit on the CPU), the exact
stop of ``train_chunked`` (JAX ``tests/test_training.py:500-548``), the
best weights never past the stop (ADVICE.md on JAX ``training.py:618``),
``iterations_run`` and the records against the JAX package's, and
``profile_dir``."""

import dataclasses
import json

import jax
import numpy as np
import torch

from xnode_wan_tpu.config import SolverConfig as JConfig
from xnode_wan_tpu.problems import load_problem as jload_problem
from xnode_wan_tpu.training import NODEWANSolver as JSolver
from xnode_wan_tpu_torch import NODEWANSolver, SolverConfig, load_problem

SMALL = dict(dim=2, N_t=6, N_r=24, N_b=16, u_hidden_dim=8,
             u_hidden_hidden_dim=8, u_layers=2, v_layers=3, v_hidden_dim=12,
             iterations=12, alpha=1e4, shape_param=(-1.0, 1.0), min_steps=4,
             seed=1)


def counting_stop(at: int):
    """A stop callback that fires at iteration ``at`` (its call ``at + 1``)."""
    calls = []

    def stop(solver, metrics):
        calls.append(metrics["loss_u"])
        return len(calls) > at
    return stop, calls


def solver(tmp_path, name, stop=None, **kw):
    return NODEWANSolver(SolverConfig(**dict(SMALL, **kw)),
                         load_problem("cube_pde", 2), device="cpu",
                         stop=stop, work_dir=str(tmp_path / name))


def records(path):
    return [{k: v for k, v in json.loads(line).items() if k != "time"}
            for line in open(path)]


def test_chunked_train_equals_one_at_a_time(tmp_path):
    runs = {}
    for chunk in (1, 4):
        stop, calls = counting_stop(6)
        s = solver(tmp_path, f"c{chunk}", stop=stop)
        last = s.train(chunk=chunk)
        runs[chunk] = (s, last, calls)
    (s1, last1, calls1), (s4, last4, calls4) = runs[1], runs[4]
    assert s4.replay_bitwise is True and s1.replay_bitwise is None
    assert last1 == last4 and calls1 == calls4 and len(calls4) == 7
    assert s1.state.step == s4.state.step == 7 and s1.best_l == s4.best_l
    assert records(tmp_path / "c1" / "metrics_NODE_2.jsonl") == \
        records(tmp_path / "c4" / "metrics_NODE_2.jsonl")
    for name in ("best_model_weights_NODE.pth", "checkpoint_NODE.pt"):
        a = torch.load(tmp_path / "c1" / name, weights_only=True)
        b = torch.load(tmp_path / "c4" / name, weights_only=True)
        assert str(a) == str(b), name   # every tensor, number and key
    for a, b in zip(s1.best_u_params.parameters(),
                    s4.best_u_params.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_chunked_checkpoints_the_stop_state(tmp_path):
    easy = dataclasses.replace(load_problem("cube_pde", 2), stop_rel_err=0.9)
    s = NODEWANSolver(SolverConfig(**SMALL), easy, device="cpu",
                      work_dir=str(tmp_path / "a"))
    m = s.train_chunked(10, chunk=5)
    assert m["iterations_run"] == 1 and s.state.step == 1
    straight = solver(tmp_path, "b")
    straight._outer_step()
    sd = torch.load(tmp_path / "a" / "checkpoint_NODE.pt", weights_only=True)
    assert sd["members"][0]["step"] == 1
    for (k, v), p in zip(sd["members"][0]["u_params"].items(),
                         straight.state.u_params.parameters()):
        torch.testing.assert_close(v, p.detach(), rtol=0, atol=0, msg=k)


def test_best_is_the_mid_chunk_best_and_never_past_the_stop(tmp_path):
    # a primal rate large enough that loss_u oscillates
    kw = dict(u_rate=0.2)
    ref = solver(tmp_path, "ref", **kw)
    losses, params = [], []
    for _ in range(8):
        losses.append(ref._to_host(ref._outer_step())["loss_u"])
        params.append([p.detach().clone()
                       for p in ref.state.u_params.parameters()])
    # the best of one chunk of 4 sits inside it
    j = int(np.argmin(losses[:4]))
    assert j < 3, "need an oscillating run for this test"
    s = solver(tmp_path, "chunk3", **kw)
    s.train(iterations=4, chunk=4)
    for a, b in zip(s.best_u_params.parameters(), params[j]):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=0)
    best = torch.load(tmp_path / "chunk3" / "best_model_weights_NODE.pth",
                      weights_only=True)
    torch.testing.assert_close(best["module.final_linear.weight"],
                               params[j][-2], rtol=0, atol=0)
    # a stop before a later, lower loss of the same chunk: the best is
    # taken up to the stop only
    at = next(i for i in range(4, 7) if min(losses[4:8]) < min(losses[:i + 1])
              and min(losses[i + 1:8]) < min(losses[:i + 1]))
    stop, _ = counting_stop(at)
    s = solver(tmp_path, "stop", stop=stop, **kw)
    s.train_chunked(8, chunk=8)
    assert s.state.step == at + 1
    assert s.best_l == min(losses[:at + 1]) > min(losses[:8])
    k = int(np.argmin(losses[:at + 1]))
    for a, b in zip(s.best_u_params.parameters(), params[k]):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=0)


def test_iterations_run_and_records_match_jax(tmp_path):
    stop, _ = counting_stop(6)
    jstop, _ = counting_stop(6)
    jsolver = JSolver(JConfig(**SMALL), jload_problem("cube_pde", 2),
                      work_dir=str(tmp_path / "jax"), stop=jstop,
                      devices=jax.devices()[:1])
    jm = jsolver.train_chunked(20, chunk=4)
    s = solver(tmp_path, "torch", stop=stop)
    m = s.train_chunked(20, chunk=4)
    assert m["iterations_run"] == jm["iterations_run"] == 7
    assert len(s.logger.losses) == len(jsolver.logger.losses) == 7
    assert s.state.step == int(jsolver.state.step) == 7


def test_profile_dir_writes_a_trace(tmp_path):
    s = solver(tmp_path, "prof", profile_dir=str(tmp_path / "trace"))
    s.train(iterations=9)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    # the u side's plain path ran under the trace (kernel #4's wrapper)
    assert any("u_du" in str(n) or "aten::" in str(n) for n in names)
    assert s.state.step == 9
