"""The refinement recipes of the port's ``train_until``: the stall test
against the JAX package's bit for bit, each ``stall_action`` branch and the
``drop_lr_at`` milestone by property with a forced stall at a small window,
the files ``train_until`` writes, and the automatic ``u_scale`` by property
(against the JAX package's value in ``test_torch_training.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from xnode_wan_tpu.training import _window_stalled as j_window_stalled
from xnode_wan_tpu_torch import (NODEWANSolver, SolverConfig, load_problem,
                                 load_reference_state_dict)
from xnode_wan_tpu_torch import training

STEP = dict(dim=2, N_t=6, N_r=24, N_b=16, u_hidden_dim=8,
            u_hidden_hidden_dim=8, u_layers=2, v_layers=3, v_hidden_dim=12,
            alpha=1e4, shape_param=(-1.0, 1.0), min_steps=4, seed=1)


# -- the stall test -----------------------------------------------------------

def trajectories(kind, rng):
    """Seeded rel-L^2 windows of one kind, each with a ``best_rel``."""
    for _ in range(150):
        n = int(rng.integers(4, 60))
        level = 10.0 ** rng.uniform(-3, 0)
        trend = {"falling": rng.uniform(-0.08, -0.005),
                 "flat": 0.0}.get(kind, rng.uniform(-0.03, 0.03))
        noise = 0.0 if kind == "flat" else rng.uniform(0.0, 0.5)
        r = level * np.exp(trend * np.arange(n) + noise * rng.normal(size=n))
        best = float(r.min() * np.exp(rng.uniform(-0.5, 0.5)))
        if kind == "nan":
            r[rng.random(n) < 0.2] = rng.choice([np.nan, np.inf, -np.inf])
        elif kind == "zeros":
            r[rng.random(n) < 0.2] = rng.choice([0.0, -1.0, -0.0])
        elif kind == "short":
            r = r[:int(rng.integers(0, 6))]
        elif kind == "inf_best":
            best = rng.choice([np.inf, float(r.min())])
        yield r, best


@pytest.mark.parametrize("kind", ["random", "nan", "zeros", "short",
                                  "inf_best", "flat", "falling"])
def test_window_stalled_matches_jax_bitwise(kind):
    rng = np.random.default_rng(["random", "nan", "zeros", "short",
                                 "inf_best", "flat", "falling"].index(kind))
    seen = set()
    for r, best in trajectories(kind, rng):
        for margin in (2.0, 0.0):
            got = training._window_stalled(r.copy(), best, margin_sd=margin)
            want = j_window_stalled(r.copy(), best, margin_sd=margin)
            assert type(got) is bool and got == want, (r, best, margin)
            seen.add(got)
    if kind not in ("short", "inf_best", "falling"):
        assert seen == {True, False}
    # fewer than four usable points never stall
    assert not training._window_stalled([0.5, np.nan, 0.0, 0.4, 0.3], 0.1)


# -- the branches of train_until, with a forced stall -------------------------

def solver(tmp_path, name="run", **kw):
    return NODEWANSolver(SolverConfig(**dict(STEP, **kw)),
                         load_problem("cube_pde", 2), device="cpu",
                         work_dir=str(tmp_path / name))


def force_stalls(monkeypatch, verdicts=None):
    """Replace the stall test: ``verdicts`` in turn (all True when None).
    Returns the list of ``(best_rel, margin_sd, window length)`` calls."""
    calls = []
    answers = iter(verdicts) if verdicts is not None else None

    def stalled(window, best_rel, margin_sd=2.0):
        calls.append((best_rel, margin_sd, len(window)))
        return True if answers is None else next(answers)

    monkeypatch.setattr(training, "_window_stalled", stalled)
    return calls


def params_of(module):
    return [p.detach().clone() for p in module.parameters()]


def assert_same(a, b):
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def adam_steps(opt):
    return {int(s["step"]) for s in opt.state.values()}


def test_drop_lr_scales_rates_with_fresh_moments(tmp_path, monkeypatch):
    twin = solver(tmp_path, "twin")
    twin.train_until(1e-9, 3)
    s = solver(tmp_path)
    base = s.cfg
    calls = force_stalls(monkeypatch)
    hist = s.train_until(1e-9, 3, window=3, stall_action="drop_lr")
    assert hist["lr_drops_at"] == [3] and calls == [(np.inf, 2.0, 3)]
    assert s.cfg.u_rate == pytest.approx(0.1 * base.u_rate, rel=1e-15)
    assert s.cfg.v_rate == pytest.approx(0.1 * base.v_rate, rel=1e-15)
    assert s.cfg.lr_decay == 0.99 and s.state.step == 3
    # the parameters are those of the run without the drop; both
    # optimizers are new, at the new rates, with no moments yet
    assert_same(params_of(s.state.u_params), params_of(twin.state.u_params))
    assert_same(params_of(s.state.v_params), params_of(twin.state.v_params))
    for opt, rate, module in ((s.state.opt_u, s.cfg.u_rate, s.state.u_params),
                              (s.state.opt_v, s.cfg.v_rate, s.state.v_params)):
        assert not opt.state and opt.param_groups[0]["lr"] == rate
        assert opt.param_groups[0]["params"] == list(module.parameters())
    # the next updates count from 0 and decay from the dropped base rate
    s._outer_step()
    assert adam_steps(s.state.opt_u) == {s.cfg.n1}
    assert adam_steps(s.state.opt_v) == {s.cfg.n2}
    assert s.state.opt_u.param_groups[0]["lr"] == pytest.approx(
        s.cfg.u_rate * 0.99 ** ((s.cfg.n1 - 1) / 1000), rel=1e-12)


def test_max_lr_drops_caps_the_drops(tmp_path, monkeypatch):
    s = solver(tmp_path)
    base = s.cfg
    calls = force_stalls(monkeypatch)
    hist = s.train_until(1e-9, 9, window=3, stall_action="drop_lr",
                         max_lr_drops=2)
    assert hist["lr_drops_at"] == [3, 6] and hist["iterations_run"] == 9
    assert s.cfg.u_rate == pytest.approx(0.01 * base.u_rate, rel=1e-14)
    # the 2-sigma margin while drops remain, margin 0 once they are spent
    assert [c[1] for c in calls] == [2.0, 2.0, 0.0]


def test_give_up_after_three_stalled_windows(tmp_path, monkeypatch):
    s = solver(tmp_path)
    calls = force_stalls(monkeypatch,
                         [True, True, True, False, True, True, True])
    hist = s.train_until(1e-9, 40, window=2, stall_action="drop_lr")
    # drop at 2; stalled at 4 and 6; progress at 8 resets the count;
    # stalled at 10, 12 and 14, the third in a row: stop
    assert hist["lr_drops_at"] == [2]
    assert hist["iterations_run"] == 14 == s.state.step == len(calls) * 2
    assert len(hist["rel_err"]) == 14
    assert [c[1] for c in calls] == [2.0] + [0.0] * 6
    # best_rel is the least rel-L^2 over the windows checked before
    rel = hist["rel_err"]
    assert calls[0][0] == np.inf
    assert calls[3][0] == rel[:6].min() and calls[6][0] == rel[:12].min()


def test_drop_lr_at_fires_once_at_the_first_crossing(tmp_path, monkeypatch):
    twin = solver(tmp_path, "twin")
    rel = twin.train_until(1e-9, 8)["rel_err"]
    k = 1 + int(np.argmin(rel[1:]))       # a crossing after iteration 1
    milestone = float(rel[k] + min(rel[:k].min() - rel[k], 1e-3) / 2)
    assert rel[:k].min() > milestone > rel[k]
    force_stalls(monkeypatch, [])      # stall_action "none" never tests
    s = solver(tmp_path)
    base = s.cfg
    hist = s.train_until(1e-9, 8, window=2, drop_lr_at=milestone)
    assert hist["lr_drops_at"] == [k + 1]
    np.testing.assert_array_equal(hist["rel_err"][:k + 1], rel[:k + 1])
    assert s.cfg.u_rate == pytest.approx(0.1 * base.u_rate, rel=1e-15)
    assert s.cfg.lr_decay == 0.99


def test_reinit_v_replaces_only_the_adversary(tmp_path, monkeypatch):
    twin = solver(tmp_path, "twin")
    twin.train_until(1e-9, 3)
    s = solver(tmp_path)
    force_stalls(monkeypatch)
    hist = s.train_until(1e-9, 3, window=3, stall_action="reinit_v")
    assert hist["lr_drops_at"] == [] and s.cfg == twin.cfg
    assert s.state.step == twin.state.step == 3
    assert_same(params_of(s.state.u_params), params_of(twin.state.u_params))
    assert adam_steps(s.state.opt_u) == {3 * s.cfg.n1}
    for a, b in zip(s.state.opt_u.state.values(),
                    twin.state.opt_u.state.values()):
        assert_same(list(a.values()), list(b.values()))
    new_v, old_v = params_of(s.state.v_params), params_of(twin.state.v_params)
    assert not torch.equal(new_v[0], old_v[0])
    assert all(a.dtype == b.dtype and a.shape == b.shape
               for a, b in zip(new_v, old_v))
    assert not s.state.opt_v.state
    assert s.state.opt_v.param_groups[0]["lr"] == s.cfg.v_rate
    assert (s.state.opt_v.param_groups[0]["params"]
            == list(s.state.v_params.parameters()))


def test_restart_rerolls_both_networks_alike(tmp_path, monkeypatch):
    runs = []
    for name in ("a", "b"):
        s = solver(tmp_path, name)
        calls = force_stalls(monkeypatch, [True, False])
        hist = s.train_until(1e-9, 6, window=3, stall_action="restart")
        assert hist["iterations_run"] == 6 and s.state.step == 3
        # best_rel starts again from infinity after the restart
        assert [c[0] for c in calls] == [np.inf, np.inf]
        assert adam_steps(s.state.opt_u) == {3 * s.cfg.n1}
        runs.append(s)
    a, b = runs
    for x, y in ((a.state.u_params, b.state.u_params),
                 (a.state.v_params, b.state.v_params)):
        assert_same(params_of(x), params_of(y))
    assert torch.equal(a.state.generator.get_state(),
                       b.state.generator.get_state())
    # just after a restart: the fresh state of the derived seed, whose
    # networks are neither the run's nor the configured seed's
    twin = solver(tmp_path, "twin")
    twin.train_until(1e-9, 3)
    s = solver(tmp_path, "c")
    force_stalls(monkeypatch)
    s.train_until(1e-9, 3, window=3, stall_action="restart")
    reseeded = solver(tmp_path, "reseeded", seed=training._restart_seed(1, 3))
    assert s.state.step == 0 and not s.state.opt_u.state
    for mine, theirs, others in (
            (s.state.u_params, reseeded.state.u_params,
             (twin.state.u_params, solver(tmp_path, "d").state.u_params)),
            (s.state.v_params, reseeded.state.v_params,
             (twin.state.v_params, solver(tmp_path, "e").state.v_params))):
        assert_same(params_of(mine), params_of(theirs))
        for other in others:
            assert not torch.equal(params_of(mine)[0], params_of(other)[0])
    assert torch.equal(s.state.generator.get_state(),
                       reseeded.state.generator.get_state())


def test_unknown_stall_action_raises(tmp_path):
    s = solver(tmp_path)
    with pytest.raises(ValueError, match="stall_action"):
        s.train_until(0.01, 3, stall_action="drop")
    assert s.state.step == 0


# -- the files train_until writes ---------------------------------------------

def test_train_until_writes_best_weights_and_checkpoint(tmp_path):
    s = solver(tmp_path)
    hist = s.train_until(1e-9, 4, window=2)
    work = tmp_path / "run"
    best = load_reference_state_dict(str(work / "best_model_weights_NODE.pth"),
                                     device="cpu", dtype=torch.float32)
    assert_same(params_of(best), params_of(s.best_u_params))
    if "rel_err_best_saved" not in hist:
        assert_same(params_of(best), params_of(s.state.u_params))
    resumed = solver(tmp_path)
    resumed.load_checkpoint(str(work / "checkpoint_NODE.pt"))
    assert resumed.state.step == 4
    assert_same(params_of(resumed.state.u_params), params_of(s.state.u_params))
    resumed.train_until(1e-9, 2)
    assert resumed.state.step == 6


# -- automatic u_scale --------------------------------------------------------

@pytest.mark.parametrize("spec,h_factor", [("Ex4_3_consistent", 1.0),
                                           ("cube_pde", 0.1)])
def test_auto_u_scale_is_the_rms_of_h_over_the_probe(tmp_path, spec,
                                                     h_factor):
    problem = load_problem(spec, 2)
    problem = dataclasses.replace(problem,
                                  h=lambda X, h=problem.h: h_factor * h(X))
    s = NODEWANSolver(SolverConfig(**dict(STEP, u_scale=0.0)), problem,
                      device="cpu", work_dir=str(tmp_path))
    probe = s.domain.interior(torch.Generator().manual_seed(17), 512)
    rms = float(torch.sqrt(torch.mean(problem.h(probe.x[:, 0, :]) ** 2)))
    assert s.cfg.u_scale == max(1.0, rms) == s.cfg.u_scale_eff
    assert (rms > 1.0) == (h_factor == 1.0)
