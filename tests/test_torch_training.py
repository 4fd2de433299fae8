"""The port's trainer: one outer step against the JAX solver from the same
state and batches, convergence of the small d=2 config on the CPU, and the
``train`` / ``train_until`` surfaces.

Tolerances of the one-step comparison: 1e-9 relative in f64 (both sides
integrate the masked scan in forward mode); with ``lr_decay`` 1e-7 on the
parameters and 1e-6 on the metrics, whose log-ratio loss magnifies the
difference (optax evaluates ``exponential_decay`` in float32 even under
x64, 3e-8 off the exact rate); in f32 (the port's fused plain path against the JAX
package's XLA route on the CPU) 1e-4 on the parameters and Adam moments
after two Adam steps, 1e-5 on the metrics. The same holds with
``fused_v``: the port's adversary side through the plain versions of
kernels #6 and #7, the JAX package's through its XLA route (its gate takes
the kernels on a TPU only).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xnode_wan_tpu.config import SolverConfig as JConfig
from xnode_wan_tpu.ops.sampling import PathBatch as JPathBatch
from xnode_wan_tpu.problems import load_problem as jload_problem
from xnode_wan_tpu.training import NODEWANSolver as JSolver
from xnode_wan_tpu_torch import NODEWANSolver, SolverConfig, load_problem
from xnode_wan_tpu_torch.ops.sampling import PathBatch
from xnode_wan_tpu_torch.utils.torch_compat import state_from_jax

SMALL = dict(dim=2, N_t=8, N_r=64, N_b=64, u_hidden_dim=8,
             u_hidden_hidden_dim=8, u_layers=2, v_layers=3, v_hidden_dim=12,
             iterations=40, alpha=1e4, shape_param=(-1.0, 1.0), min_steps=4,
             seed=1)
STEP = dict(SMALL, N_r=24, N_b=16, N_t=6)


@pytest.fixture
def restore_x64():
    prior = jax.config.jax_enable_x64
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prior)


def path_arrays(n, L, d, seed, boundary=False, dtype=np.float32):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0, 1, L))
    times[0], times[-1] = 0.0, 1.0
    xs = rng.uniform(-1, 1, (n, d))
    if boundary:
        face = np.arange(n) % (2 * d)
        xs[np.arange(n), face // 2] = np.where(face % 2 == 0, 1.0, -1.0)
    x = np.concatenate([np.broadcast_to(times[None, :, None], (n, L, 1)),
                        np.broadcast_to(xs[:, None], (n, L, d))], axis=-1)
    arrays = [np.ascontiguousarray(x, dtype=dtype), np.ones((n, L), bool),
              np.zeros(n, dtype), np.ones(n, bool)]
    return (JPathBatch(*map(jnp.asarray, arrays)),
            PathBatch(*map(torch.as_tensor, arrays)))


def xnode_pairs(tparams, jtree):
    for layer, jl in zip([*tparams.lift, *tparams.field, tparams.readout],
                         [*jtree["lift"], *jtree["field"], jtree["readout"]]):
        yield layer.weight, np.asarray(jl["w"]).T
        yield layer.bias, np.asarray(jl["b"])


def disc_pairs(tparams, jtree):
    for name in ("inp", "hidden", "out"):
        layer = getattr(tparams, name)
        yield layer.weight, np.asarray(jtree[name]["w"]).T
        yield layer.bias, np.asarray(jtree[name]["b"])


def assert_close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-6))


def check_adam(opt, pairs_of, jopt, rtol):
    adam = next(x for x in jax.tree.leaves(
        jopt.inner_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(x, "mu"))
    for (p, mu), (_, nu) in zip(pairs_of(adam.mu), pairs_of(adam.nu)):
        state = opt.state[p]
        assert int(state["step"]) == int(adam.count)
        assert_close(state["exp_avg"].detach().numpy(), mu, rtol)
        assert_close(state["exp_avg_sq"].detach().numpy(), nu, rtol)


@pytest.mark.parametrize("dtype,extra,rtol,rtol_metrics", [
    (np.float64, {}, 1e-9, 1e-9),
    (np.float64, dict(grad_clip=0.5, lr_decay=0.9, ema_decay=0.9), 1e-7,
     1e-6),
    (np.float32, {}, 1e-4, 1e-5),
    (np.float32, dict(fused_v=True), 1e-4, 1e-5),
], ids=["f64", "f64_clip_decay_ema", "f32_fused_plain", "f32_fused_v_plain"])
def test_one_outer_step_matches_jax(restore_x64, tmp_path, dtype, extra,
                                    rtol, rtol_metrics):
    cfg = dict(STEP, x64=dtype == np.float64, **extra)
    jsolver = JSolver(JConfig(**cfg), jload_problem("cube_pde", 2),
                      work_dir=str(tmp_path), devices=jax.devices()[:1])
    tsolver = NODEWANSolver(SolverConfig(**cfg), load_problem("cube_pde", 2),
                            device="cpu")
    u_tree = jax.tree.map(np.asarray, jsolver.state.u_params)
    v_tree = jax.tree.map(np.asarray, jsolver.state.v_params)
    state_from_jax(tsolver, u_tree, v_tree)

    jb, tb = path_arrays(24, 6, 2, 0, dtype=dtype)
    jbb, tbb = path_arrays(16, 6, 2, 1, boundary=True, dtype=dtype)
    jeb, teb = path_arrays(24, 6, 2, 2, dtype=dtype)
    draws = iter([(jb, jbb, None), (jeb, None, None)])
    jsolver._sample = lambda key: next(draws)
    with jax.default_matmul_precision("highest"):
        jstate, jm = jax.jit(jsolver._outer_step)(jsolver.state)
    tm = tsolver._to_host(tsolver._step_on(tsolver.state, tb, tbb, teb))

    for k in ("loss_u", "loss_v", "I", "int", "init", "bdry", "L2",
              "rel_err"):
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=rtol_metrics,
                                   err_msg=k)
    st = tsolver.state
    assert st.step == int(jstate.step) == 1
    for p, w in xnode_pairs(st.u_params, jstate.u_params):
        assert_close(p.detach().numpy(), w, rtol)
    for p, w in disc_pairs(st.v_params, jstate.v_params):
        assert_close(p.detach().numpy(), w, rtol)
    check_adam(st.opt_u, lambda t: xnode_pairs(st.u_params, t), jstate.opt_u,
               rtol)
    check_adam(st.opt_v, lambda t: disc_pairs(st.v_params, t), jstate.opt_v,
               rtol)
    if extra.get("ema_decay"):
        for p, w in xnode_pairs(st.u_ema, jstate.u_ema):
            assert_close(p.detach().numpy(), w, rtol)


@pytest.fixture(scope="module")
def small_run():
    solver = NODEWANSolver(SolverConfig(**SMALL), load_problem("cube_pde", 2),
                           device="cpu")
    return solver, solver.train_until(1e-9, 40)


def test_small_config_error_halves(small_run):
    # as tests/test_training.py:33-37 asks of the JAX package
    solver, hist = small_run
    assert hist["iterations_run"] == 40 == solver.state.step
    assert len(hist["rel_err"]) == len(hist["L2"]) == len(hist["loss_u"]) == 40
    assert np.isfinite(hist["loss_u"]).all()
    assert hist["L2"][-1] < 0.5 * hist["L2"][0]
    assert hist["rel_err"][-1] < 0.5 * hist["rel_err"][0]


def test_train_until_keeps_best_weights(small_run):
    solver, hist = small_run
    assert set(hist) >= {"loss_u", "L2", "rel_err", "iterations_run",
                         "rel_err_final", "lr_drops_at", "wall_train_s"}
    assert hist["lr_drops_at"] == [] and hist["wall_train_s"] > 0
    assert hist["rel_err_final"] == hist["rel_err"][-1]
    assert solver.best_u_params is not None
    assert solver.best_u_params is not solver.state.u_params
    if "rel_err_best_saved" in hist:
        assert hist["rel_err_best_saved"] < hist["rel_err_final"]


def test_train_until_stops_at_tolerance():
    solver = NODEWANSolver(SolverConfig(**SMALL), load_problem("cube_pde", 2),
                           device="cpu")
    hist = solver.train_until(0.5, 30)
    iters = hist["iterations_run"]
    assert 0 < iters < 30
    assert hist["rel_err_final"] < 0.5 <= min(hist["rel_err"][:-1], default=1)
    assert len(hist["rel_err"]) == iters == solver.state.step


def test_train_stop_criteria(tmp_path):
    # train writes its logs and checkpoints into work_dir
    problem = dataclasses.replace(load_problem("cube_pde", 2),
                                  stop_rel_err=0.9)
    solver = NODEWANSolver(SolverConfig(**dict(SMALL, iterations=30)),
                           problem, device="cpu",
                           work_dir=str(tmp_path / "a"))
    m = solver.train()
    assert solver.state.step < 30 and m["rel_err"] < 0.9
    calls = []

    def stop(s, metrics):
        calls.append(metrics["loss_u"])
        return len(calls) >= 3

    solver = NODEWANSolver(SolverConfig(**dict(SMALL, iterations=30)),
                           load_problem("cube_pde", 2), device="cpu",
                           stop=stop, work_dir=str(tmp_path / "b"))
    solver.train()
    assert len(calls) == 3 == solver.state.step
    assert solver.best_u_params is not None


def test_same_seed_same_run():
    hists = []
    for _ in range(2):
        s = NODEWANSolver(SolverConfig(**dict(STEP, seed=3)),
                          load_problem("cube_pde", 2), device="cpu")
        hists.append(s.train_until(1e-9, 3)["loss_u"])
    np.testing.assert_array_equal(*hists)


@pytest.mark.parametrize("kw", [dict(ensemble=2), dict(adjoint=True),
                                dict(independent_uv=True), dict(primal="wan"),
                                dict(tangent_shards=2),
                                dict(domain="NSphere_TCone", shape_param=1.0,
                                     qmc="halton")])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError):
        NODEWANSolver(SolverConfig(**dict(SMALL, **kw)),
                      load_problem("cube_pde", 2), device="cpu")


def test_unported_train_until_recipes_raise():
    solver = NODEWANSolver(SolverConfig(**STEP), load_problem("cube_pde", 2),
                           device="cpu")
    with pytest.raises(NotImplementedError):
        solver.train_until(0.01, 5, stall_action="drop_lr")
    with pytest.raises(NotImplementedError):
        solver.train_until(0.01, 5, drop_lr_at=0.05)
    assert solver.state.step == 0


def test_solver_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NODEWANSolver(SolverConfig(**STEP), load_problem("cube_pde", 2))
