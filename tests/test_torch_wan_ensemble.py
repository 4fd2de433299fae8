"""The WAN primal (``models/wan.py``), ``ensemble: K`` and their
checkpoints, against the JAX package in f64.

* ``apply_wan`` and ``evaluate_points`` with the weights of a JAX
  ``init_wan``, at 1e-9;
* one WAN outer step against JAX ``_outer_step`` on the same batches: the
  metrics, the parameters and the Adam moments, at 1e-9;
* one K=2 ensemble outer step against JAX ``_step_fn_ensemble``, both
  members on the same batches from the stacked JAX weights: each member's
  parameters and moments and the best member's scalars, ``best_member``
  and ``rel_err_worst`` among them, at 1e-9;
* checkpoint round trips of an ensemble and of a WAN run, ``predict``
  serving the best member, and the command line on both.

The ``independent_uv`` step is ``test_torch_training.py``'s
``f64_parity_flags`` case.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from xnode_wan_tpu.config import SolverConfig as JConfig
from xnode_wan_tpu.models import wan as jwan
from xnode_wan_tpu.ops.sampling import PathBatch as JPathBatch
from xnode_wan_tpu.problems import load_problem as jload_problem
from xnode_wan_tpu.training import NODEWANSolver as JSolver
from xnode_wan_tpu_torch import NODEWANSolver, SolverConfig, load_problem
from xnode_wan_tpu_torch.main import main
from xnode_wan_tpu_torch.models import wan as twan
from xnode_wan_tpu_torch.models import xnode as txnode
from xnode_wan_tpu_torch.ops.sampling import PathBatch
from xnode_wan_tpu_torch.utils.torch_compat import (state_from_jax,
                                                    wan_params_from_jax)

STEP = dict(dim=2, N_t=6, N_r=24, N_b=16, u_hidden_dim=8,
            u_hidden_hidden_dim=8, u_layers=2, v_layers=3, v_hidden_dim=12,
            iterations=4, alpha=1e4, shape_param=(-1.0, 1.0), min_steps=4,
            seed=1, x64=True)
RTOL = 1e-9


@pytest.fixture
def restore_x64():
    prior = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prior)


def path_arrays(n, L, d, seed, boundary=False):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0, 1, L))
    times[0], times[-1] = 0.0, 1.0
    xs = rng.uniform(-1, 1, (n, d))
    if boundary:
        face = np.arange(n) % (2 * d)
        xs[np.arange(n), face // 2] = np.where(face % 2 == 0, 1.0, -1.0)
    x = np.concatenate([np.broadcast_to(times[None, :, None], (n, L, 1)),
                        np.broadcast_to(xs[:, None], (n, L, d))], axis=-1)
    arrays = [np.ascontiguousarray(x), np.ones((n, L), bool), np.zeros(n),
              np.ones(n, bool)]
    return (JPathBatch(*map(jnp.asarray, arrays)),
            PathBatch(*map(torch.as_tensor, arrays)))


def assert_close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-6))


def layer_pairs(tlayers, jlayers):
    for layer, jl in zip(tlayers, jlayers):
        yield layer.weight, np.asarray(jl["w"]).T
        yield layer.bias, np.asarray(jl["b"])


def wan_pairs(tparams, jtree):
    return layer_pairs(tparams.net, jtree["net"])


def xnode_pairs(tparams, jtree):
    return layer_pairs([*tparams.lift, *tparams.field, tparams.readout],
                       [*jtree["lift"], *jtree["field"], jtree["readout"]])


def disc_pairs(tparams, jtree):
    return layer_pairs([tparams.inp, tparams.hidden, tparams.out],
                       [jtree["inp"], jtree["hidden"], jtree["out"]])


def check_state(st, jst, u_pairs, member=None):
    """A member's parameters and Adam moments against the JAX state (slice
    ``member`` of a stacked ensemble state)."""
    def pick(tree):
        return (tree if member is None
                else jax.tree.map(lambda a: np.asarray(a)[member], tree))

    for p, w in u_pairs(st.u_params, pick(jst.u_params)):
        assert_close(p.detach().numpy(), w)
    for p, w in disc_pairs(st.v_params, pick(jst.v_params)):
        assert_close(p.detach().numpy(), w)
    for opt, jopt, pairs in ((st.opt_u, jst.opt_u, u_pairs),
                             (st.opt_v, jst.opt_v, disc_pairs)):
        adam = next(x for x in jax.tree.leaves(
            pick(jopt.inner_state), is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(x, "mu"))
        module = st.u_params if pairs is u_pairs else st.v_params
        for (p, mu), (_, nu) in zip(pairs(module, adam.mu),
                                    pairs(module, adam.nu)):
            state = opt.state[p]
            assert int(state["step"]) == int(np.asarray(adam.count))
            assert_close(state["exp_avg"].numpy(), mu)
            assert_close(state["exp_avg_sq"].numpy(), nu)


def jax_and_port(tmp_path, **kw):
    cfg = dict(STEP, **kw)
    jsolver = JSolver(JConfig(**cfg), jload_problem("cube_pde", 2),
                      work_dir=str(tmp_path / "jax"),
                      devices=jax.devices()[:1])
    tsolver = NODEWANSolver(SolverConfig(**cfg), load_problem("cube_pde", 2),
                            device="cpu", work_dir=str(tmp_path / "port"))
    state_from_jax(tsolver, jax.tree.map(np.asarray, jsolver.state.u_params),
                   jax.tree.map(np.asarray, jsolver.state.v_params))
    return jsolver, tsolver


def test_apply_wan_and_evaluate_points_match_jax(restore_x64):
    cfg = dict(STEP, u_scale=2.5, u_layers=3)
    jcfg, tcfg = JConfig(**cfg), SolverConfig(**cfg)
    tree = jax.tree.map(np.asarray, jwan.init_wan(jax.random.PRNGKey(3),
                                                  jcfg))
    model = wan_params_from_jax(tree, "cpu", torch.float64)
    assert len(model.net) == cfg["u_layers"] + 2
    jb, tb = path_arrays(16, 6, 2, 4)
    jp = jload_problem("cube_pde", 2)
    tp = load_problem("cube_pde", 2)
    want = jwan.apply_wan(tree, jb, jp, jcfg)
    got = twan.apply_wan(model, tb, tp, tcfg)
    assert got.shape == (16, 6) and got.dtype == torch.float64
    assert_close(got.detach().numpy(), want)
    pts = np.random.default_rng(5).uniform(-1, 1, (40, 3))
    assert_close(twan.evaluate_points(model, torch.as_tensor(pts), tp,
                                      tcfg).detach().numpy(),
                 jwan.evaluate_points(tree, jnp.asarray(pts), jp, jcfg))
    # the port's own init: Xavier-uniform weights, zero biases, f64
    own = twan.init_wan(tcfg, torch.Generator().manual_seed(0))
    for layer in own.net:
        limit = (6.0 / sum(layer.weight.shape)) ** 0.5
        assert float(layer.weight.detach().abs().max()) <= limit
        assert not bool(layer.bias.any()) and layer.weight.dtype == \
            torch.float64


def test_wan_outer_step_matches_jax(restore_x64, tmp_path):
    jsolver, tsolver = jax_and_port(tmp_path, primal="wan")
    assert not tsolver._use_fused
    jb, tb = path_arrays(24, 6, 2, 0)
    jbb, tbb = path_arrays(16, 6, 2, 1, boundary=True)
    jeb, teb = path_arrays(24, 6, 2, 2)
    draws = iter([(jb, jbb, None), (jeb, None, None)])
    jsolver._sample = lambda key: next(draws)
    jstate, jm = jax.jit(jsolver._outer_step)(jsolver.state)
    tm = tsolver._to_host(tsolver._step_on(tsolver.state, tb, tbb, teb))
    for k in ("loss_u", "loss_v", "I", "int", "init", "bdry", "L2",
              "rel_err"):
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=RTOL, err_msg=k)
    assert tsolver.state.step == int(jstate.step) == 1
    check_state(tsolver.state, jstate, wan_pairs)


def test_ensemble_outer_step_matches_jax(restore_x64, tmp_path):
    jsolver, tsolver = jax_and_port(tmp_path, ensemble=2)
    assert len(tsolver.members) == 2 and tsolver._use_fused is False
    jb, tb = path_arrays(24, 6, 2, 0)
    jbb, tbb = path_arrays(16, 6, 2, 1, boundary=True)
    jeb, teb = path_arrays(24, 6, 2, 2)
    draws = iter([(jb, jbb, None), (jeb, None, None)])
    jsolver._sample = lambda key: next(draws)
    jstates, jm = jax.jit(jsolver._step_fn_ensemble)(jsolver.state)
    tm = tsolver._to_host(tsolver._ensemble_step([(tb, tbb, teb, None)] * 2))
    for k in ("loss_u", "loss_v", "I", "int", "init", "bdry", "L2",
              "rel_err", "rel_err_worst"):
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=RTOL, err_msg=k)
    assert tm["best_member"] == float(jm["best_member"])
    assert tm["rel_err_worst"] > tm["rel_err"]   # the members differ
    for k, st in enumerate(tsolver.members):
        assert st.step == 1
        check_state(st, jstates, xnode_pairs, member=k)


def small_cfg(**kw):
    return SolverConfig(**dict(STEP, x64=False, N_r=32, N_b=32, **kw))


@pytest.mark.parametrize("kw", [dict(ensemble=2), dict(primal="wan")],
                         ids=["ensemble", "wan"])
def test_checkpoint_round_trip(tmp_path, kw):
    problem = load_problem("cube_pde", 2)
    s = NODEWANSolver(small_cfg(**kw), problem, device="cpu",
                      work_dir=str(tmp_path))
    m = s.train(iterations=3)
    assert s.state.step == 3 and s.best_l < float("inf")
    fresh = NODEWANSolver(small_cfg(**kw), problem, device="cpu",
                          work_dir=str(tmp_path)).load_checkpoint()
    assert fresh.best_l == s.best_l and fresh._best_member == s._best_member
    assert len(fresh.members) == len(s.members) == s.cfg.ensemble
    for a, b in zip(fresh.members, s.members):
        assert a.step == b.step == 3
        for x, y in ((a.u_params, b.u_params), (a.v_params, b.v_params)):
            for p, q in zip(x.state_dict().values(),
                            y.state_dict().values()):
                assert torch.equal(p, q)
        assert torch.equal(a.generator.get_state(), b.generator.get_state())
    # the resumed run takes the same next step as the uninterrupted one
    torch.testing.assert_close(fresh._outer_step()["loss_u"],
                               s._outer_step()["loss_u"], rtol=0, atol=0)
    best = torch.load(tmp_path / "best_model_weights_NODE.pth",
                      weights_only=True)
    if kw.get("primal") == "wan":   # the WAN's own state_dict
        assert set(best) == set(s.state.u_params.state_dict())
    else:
        assert all(k.startswith("module.") for k in best)
        assert "best_member" in m and "rel_err_worst" in m


def test_predict_serves_the_best_member(tmp_path):
    s = NODEWANSolver(small_cfg(ensemble=3), load_problem("cube_pde", 2),
                      device="cpu", work_dir=str(tmp_path))
    hist = s.train_until(1e-9, 3)
    assert len(hist["best_member"]) == len(hist["rel_err_worst"]) == 3
    assert s._best_member == int(hist["best_member"][-1])
    assert (hist["rel_err_worst"] >= hist["rel_err"]).all()
    pts = torch.rand((50, 3), generator=torch.Generator().manual_seed(2))
    for k in range(3):
        s._best_member = k
        assert s.state is s.members[k]
        want = txnode.evaluate_points(s.members[k].u_params, pts, s.problem,
                                      s.cfg, domain=s.domain)
        assert torch.equal(s.predict(pts), want)
    # members start from different seeds
    assert not torch.equal(s.members[0].u_params.readout.weight,
                           s.members[1].u_params.readout.weight)


@pytest.mark.parametrize("kw", [dict(ensemble=2), dict(primal="wan",
                                                       fused_v=True)],
                         ids=["ensemble", "wan_fused_v"])
def test_cli_runs_and_resumes(tmp_path, kw):
    cfg = {k: list(v) if isinstance(v, tuple) else v
           for k, v in dict(STEP, x64=False, **kw).items()}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    argv = ["--params", str(path), "--funcs", "cube_pde", "-w",
            str(tmp_path), "--device", "cpu", "--no-report"]
    solver = main(argv)
    resumed = main(argv + ["--resume", "--iterations", "2"])
    assert solver.state.step == 4 and resumed.state.step == 6
    recs = [json.loads(line) for line in
            open(os.path.join(tmp_path, "metrics_NODE_2.jsonl"))]
    assert [r["step"] for r in recs] == [0, 1]   # the resumed run's log
    ensemble = "ensemble" in kw
    assert all(("best_member" in r and "rel_err_worst" in r) == ensemble
               for r in recs)
