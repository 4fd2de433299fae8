"""The port's trainer: one outer step against the JAX solver from the same
state and batches, convergence of the small d=2 config on the CPU, and the
``train`` / ``train_until`` surfaces (the recipes of ``train_until`` are in
``test_torch_recipes.py``).

Tolerances of the one-step comparison: 1e-9 relative in f64 (both sides
integrate the masked scan in forward mode), also after
``drop_learning_rate(0.1)``; with ``lr_decay``, or a drop that sets it,
1e-7 on the parameters and 1e-6 on the metrics, whose log-ratio loss
magnifies the difference (optax evaluates ``exponential_decay`` in float32
even under x64, 3e-8 off the exact rate); in f32 (the port's fused plain
path against the JAX package's XLA route on the CPU) 1e-4 on the
parameters and Adam moments after two Adam steps, 1e-5 on the metrics.
The same holds with ``fused_v``: the port's adversary side through the
plain versions of kernels #6 and #7, the JAX package's through its XLA
route (its gate takes the kernels on a TPU only). The f64 case with the
reference-parity flags (``benchmarks/run_parity.py``) gives both solvers
the same ``independent_uv`` adversary cloud.
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
from xnode_wan_tpu_torch.ops.kernels.steppers import FUSED_KERNEL_METHODS
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


@pytest.mark.parametrize("dtype,extra,drop,rtol,rtol_metrics", [
    (np.float64, {}, None, 1e-9, 1e-9),
    (np.float64, dict(grad_clip=0.5, lr_decay=0.9, ema_decay=0.9), None,
     1e-7, 1e-6),
    (np.float32, {}, None, 1e-4, 1e-5),
    (np.float32, dict(fused_v=True), None, 1e-4, 1e-5),
    (np.float64, {}, {}, 1e-9, 1e-9),
    (np.float64, {}, dict(lr_decay=0.99), 1e-7, 1e-6),
    (np.float64, dict(s1_raw_v=True, independent_uv=True, init_all_rows=True),
     None, 1e-9, 1e-9),
    # one primal step: JAX's compile of the adaptive step dominates
    (np.float64, dict(solver="dopri5", n1=1), None, 1e-9, 1e-9),
], ids=["f64", "f64_clip_decay_ema", "f32_fused_plain", "f32_fused_v_plain",
        "f64_after_drop", "f64_after_drop_decay", "f64_parity_flags",
        "f64_dopri5"])
def test_one_outer_step_matches_jax(restore_x64, tmp_path, dtype, extra,
                                    drop, rtol, rtol_metrics):
    # ``drop``: drop_learning_rate(0.1, **drop) on both solvers first, so
    # the step runs at the scaled rates with fresh Adam moments
    cfg = dict(STEP, x64=dtype == np.float64, **extra)
    jsolver = JSolver(JConfig(**cfg), jload_problem("cube_pde", 2),
                      work_dir=str(tmp_path), devices=jax.devices()[:1])
    tsolver = NODEWANSolver(SolverConfig(**cfg), load_problem("cube_pde", 2),
                            device="cpu")
    u_tree = jax.tree.map(np.asarray, jsolver.state.u_params)
    v_tree = jax.tree.map(np.asarray, jsolver.state.v_params)
    state_from_jax(tsolver, u_tree, v_tree)
    if drop is not None:
        jsolver.drop_learning_rate(0.1, **drop)
        tsolver.drop_learning_rate(0.1, **drop)
        assert tsolver.cfg.to_dict() == jsolver.cfg.to_dict()

    jb, tb = path_arrays(24, 6, 2, 0, dtype=dtype)
    jbb, tbb = path_arrays(16, 6, 2, 1, boundary=True, dtype=dtype)
    jeb, teb = path_arrays(24, 6, 2, 2, dtype=dtype)
    # independent_uv: the adversary side's own interior cloud
    jvb, tvb = (path_arrays(24, 6, 2, 3, dtype=dtype)
                if extra.get("independent_uv") else (None, None))
    draws = iter([(jb, jbb, jvb), (jeb, None, None)])
    jsolver._sample = lambda key: next(draws)
    with jax.default_matmul_precision("highest"):
        jstate, jm = jax.jit(jsolver._outer_step)(jsolver.state)
    tm = tsolver._to_host(tsolver._step_on(tsolver.state, tb, tbb, teb, tvb))

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


def test_auto_u_scale_near_jax_on_the_cube(tmp_path):
    # each package's own 512-row probe of h: draws of two generators
    cfg = dict(STEP, u_scale=0.0)
    jsolver = JSolver(JConfig(**cfg), jload_problem("cube_pde", 2),
                      work_dir=str(tmp_path), devices=jax.devices()[:1])
    s = NODEWANSolver(SolverConfig(**cfg), load_problem("cube_pde", 2),
                      device="cpu", work_dir=str(tmp_path))
    assert s.cfg.u_scale == pytest.approx(jsolver.cfg.u_scale, rel=0.1)


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    solver = NODEWANSolver(SolverConfig(**SMALL), load_problem("cube_pde", 2),
                           device="cpu",
                           work_dir=str(tmp_path_factory.mktemp("small")))
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


def test_train_until_stops_at_tolerance(tmp_path):
    solver = NODEWANSolver(SolverConfig(**SMALL), load_problem("cube_pde", 2),
                           device="cpu", work_dir=str(tmp_path))
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


def test_same_seed_same_run(tmp_path):
    hists = []
    for i in range(2):
        s = NODEWANSolver(SolverConfig(**dict(STEP, seed=3)),
                          load_problem("cube_pde", 2), device="cpu",
                          work_dir=str(tmp_path / str(i)))
        hists.append(s.train_until(1e-9, 3)["loss_u"])
    np.testing.assert_array_equal(*hists)


@pytest.mark.parametrize("kw", [dict(solver="dopri5"), dict(adjoint=True),
                                dict(solver="explicit_adams"),
                                dict(solver="fixed_adams"),
                                dict(solver="adams")])
def test_integrator_options_train(kw, tmp_path):
    # one CPU outer step: the adaptive and multistep solvers close the
    # fused gate, as in the JAX package; adjoint: true means remat
    cfg = SolverConfig(**dict(SMALL, **kw))
    solver = NODEWANSolver(cfg, load_problem("cube_pde", 2), device="cpu",
                           work_dir=str(tmp_path))
    assert solver._use_fused == (cfg.solver in FUSED_KERNEL_METHODS)
    metrics = solver._to_host(solver._outer_step())
    assert solver.state.step == 1
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert all(bool(torch.isfinite(p).all())
               for p in solver.state.u_params.parameters())


@pytest.mark.parametrize("kw", [dict(tangent_shards=2)])
def test_unported_options_raise(kw):
    # tangent_shards is ported; one process cannot lay out its two shards
    with pytest.raises(ValueError, match="tangent_shards=2 cannot be laid"):
        NODEWANSolver(SolverConfig(**dict(SMALL, **kw)),
                      load_problem("cube_pde", 2), device="cpu")


def test_solver_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NODEWANSolver(SolverConfig(**STEP), load_problem("cube_pde", 2))


@pytest.mark.parametrize("entry", ["train_until", "train_chunked"])
def test_debug_nans_raises_at_the_poisoned_iteration(entry, tmp_path):
    # two clean iterations, then a NaN put into the adversary: the next
    # iteration's loss and updated weights are not finite, and debug_nans
    # names it from the metrics' host copy (each iteration's in
    # train_until, one a chunk in train_chunked)
    solver = NODEWANSolver(SolverConfig(**dict(STEP, debug_nans=True)),
                           load_problem("cube_pde", 2), device="cpu",
                           work_dir=str(tmp_path))
    if entry == "train_until":
        hist = solver.train_until(1e-9, 2)
        assert all(np.isfinite(hist["loss_u"]))
    else:
        m = solver.train_chunked(2, chunk=2, log=False)
        assert "weights_nan" not in m and np.isfinite(m["loss_u"])
    with torch.no_grad():
        next(solver.state.v_params.parameters()).fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="outer iteration 2 gave "
                       r"NaN \(.*loss_u.*weights\)"):
        if entry == "train_until":
            solver.train_until(1e-9, 3)
        else:
            solver.train_chunked(4, chunk=4, log=False)


def test_debug_nans_off_lets_non_finite_values_through(tmp_path):
    solver = NODEWANSolver(SolverConfig(**STEP), load_problem("cube_pde", 2),
                           device="cpu", work_dir=str(tmp_path))
    with torch.no_grad():
        next(solver.state.v_params.parameters()).fill_(float("nan"))
    m = solver._to_host(solver._outer_step())
    assert "weights_nan" not in m and not np.isfinite(m["loss_u"])


def test_debug_nans_lets_inf_through_as_jax_debug_nans_does(tmp_path):
    # jax_debug_nans raises on NaN only: an inf loss (the interior term's
    # I^2 overflows f32 on a cube of volume 2^100) trains on, a NaN in a
    # metric or in the weights raises, naming its iteration
    solver = NODEWANSolver(SolverConfig(**dict(STEP, debug_nans=True)),
                           load_problem("cube_pde", 2), device="cpu",
                           work_dir=str(tmp_path))
    inf, nan = float("inf"), float("nan")
    rows = [{"loss_u": inf, "rel_err": 0.5, "weights_nan": 0.0},
            {"loss_u": -inf, "rel_err": 0.4}]
    solver._check_nans(rows, 6)
    assert all("weights_nan" not in m for m in rows)
    with pytest.raises(FloatingPointError,
                       match=r"outer iteration 8 gave NaN \(rel_err\)"):
        solver._check_nans([{"loss_u": inf, "rel_err": 0.5},
                            {"loss_u": inf, "rel_err": 0.5},
                            {"loss_u": inf, "rel_err": nan}], 6)
    with pytest.raises(FloatingPointError,
                       match=r"outer iteration 6 gave NaN \(weights\)"):
        solver._check_nans([{"loss_u": inf, "weights_nan": 1.0}], 6)
