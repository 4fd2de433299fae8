"""The port's first slice as a whole: serve the reference trainer's trained
d=5 checkpoint and score it, against the JAX package and against the exact
solution."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xnode_wan_tpu.config import load_params as jload_params
from xnode_wan_tpu.models import xnode as jx
from xnode_wan_tpu.ops.pallas import xnode_train as jtrain
from xnode_wan_tpu.ops.sampling import PathBatch as JPathBatch
from xnode_wan_tpu.problems import load_problem as jload_problem
from xnode_wan_tpu.utils import metrics as jmetrics
from xnode_wan_tpu.utils.torch_compat import \
    load_reference_state_dict as jload_reference
from xnode_wan_tpu_torch import (Hypercube, PathBatch, apply_xnode,
                                 evaluate_points, l_norm, load_params,
                                 load_problem, load_reference_state_dict,
                                 rel_err, u_forward_fused)
from xnode_wan_tpu_torch.models.xnode import evaluate_points_fused
from xnode_wan_tpu_torch.utils import metrics as tmetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "benchmarks", "ref_run_nr4000",
                    "best_model_weights_NODE.pth")
CONFIG = os.path.join(REPO, "configs", "cube_pde.yaml")
REL_L2_LIMIT = 0.0125   # JAX on the CPU gives 0.0102-0.0104 on this checkpoint


def test_import_leaves_jax_out():
    code = ("import sys, xnode_wan_tpu_torch, xnode_wan_tpu_torch.ops.kernels."
            "xnode_eval, xnode_wan_tpu_torch.ops.kernels._build\n"
            "import xnode_wan_tpu_torch.training, xnode_wan_tpu_torch.ops."
            "weak_form, xnode_wan_tpu_torch.ops.coefficients\n"
            "import xnode_wan_tpu_torch.models.discriminator, "
            "xnode_wan_tpu_torch.utils.torch_compat\n"
            "from xnode_wan_tpu_torch.ops.kernels.xnode_train import ("
            "UDuFused, u_du_fused, fused_from_batch, u_du_bwd_cuda)\n"
            "import xnode_wan_tpu_torch.main, xnode_wan_tpu_torch.ops.kernels."
            "disc_train, xnode_wan_tpu_torch.utils.checkpoint, "
            "xnode_wan_tpu_torch.utils.logging, "
            "xnode_wan_tpu_torch.problems.ex4_3, xnode_wan_tpu_torch.ops.qmc, "
            "xnode_wan_tpu_torch.models.wan, xnode_wan_tpu_torch.ops.adjoint, "
            "xnode_wan_tpu_torch.ops.integrate, "
            "xnode_wan_tpu_torch.parallel.mesh, xnode_wan_tpu_torch.utils.viz\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'xnode_wan_tpu'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.strip() == "[]"


def uniform_grid_batch(n=64, L=21, d=5, seed=0):
    """The parity grid of tests/test_reference_parity.py: n_sub = 1 and a
    uniform grid from T0, as numpy for both packages."""
    rng = np.random.RandomState(seed)
    xs = rng.uniform(-1.0, 1.0, size=(n, d))
    times = np.linspace(0.0, 1.0, L)
    x = np.concatenate([np.broadcast_to(times[None, :, None], (n, L, 1)),
                        np.broadcast_to(xs[:, None, :], (n, L, d))], axis=-1)
    return x, np.ones((n, L), bool), np.zeros(n), np.ones(n, bool)


def test_checkpoint_forward_matches_jax_f64():
    # The same .pth through both packages' loaders and forwards, in f64:
    # the same-weights evidence that the reference-parity test gives where
    # the reference itself is installed.
    cfg = load_params(CONFIG).replace(N_t=21, x64=True)
    assert cfg.n_sub == 1
    arrays = uniform_grid_batch()
    ours = apply_xnode(load_reference_state_dict(CKPT, device="cpu"),
                       PathBatch(*map(torch.as_tensor, arrays)),
                       load_problem("Ex4_1_funcs", dim=5), cfg)
    jax.config.update("jax_enable_x64", True)
    try:
        jcfg = jload_params(CONFIG).replace(N_t=21, x64=True)
        theirs = jx.apply_xnode(jload_reference(CKPT),
                                JPathBatch(*map(jnp.asarray, arrays)),
                                jload_problem("Ex4_1_funcs", dim=5), jcfg)
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                                   rtol=1e-9, atol=1e-9)
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def slice_setup():
    cfg = load_params(CONFIG)
    model = load_reference_state_dict(CKPT, device="cpu", dtype=torch.float32)
    cube = Hypercube(cfg.shape_param, cfg.dim, cfg.T0, cfg.T, cfg.N_t)
    return cfg, model, load_problem("Ex4_1_funcs", dim=cfg.dim), cube


def test_trained_checkpoint_rel_l2(slice_setup):
    # 4,000 fresh torch-sampled interior paths, as the trainer's metric
    cfg, model, problem, cube = slice_setup
    batch = cube.interior(torch.Generator().manual_seed(0), cfg.N_r)
    u = u_forward_fused(model, batch, problem, cfg)
    assert u.shape == (cfg.N_r, cfg.N_t) and bool(torch.isfinite(u).all())
    sol = problem.u_sol(batch.x)
    rel = float(rel_err(u, sol, batch.mask, cube.V(), cfg.p))
    assert rel < REL_L2_LIMIT
    with torch.no_grad():
        u_scan = apply_xnode(model, batch, problem, cfg)
    torch.testing.assert_close(u, u_scan, rtol=2e-4, atol=2e-5)


def test_trained_checkpoint_served_points(slice_setup):
    cfg, model, problem, cube = slice_setup
    g = torch.Generator().manual_seed(1)
    pts = torch.rand((4096, cfg.dim + 1), generator=g)
    pts[:, 1:] = cube.bot + pts[:, 1:] * (cube.top - cube.bot)
    with torch.no_grad():
        u = evaluate_points(model, pts, problem, cfg)
    ones = torch.ones(4096, dtype=torch.bool)
    assert float(rel_err(u, problem.u_sol(pts), ones, cube.V(), cfg.p)) \
        < REL_L2_LIMIT
    t_entry, from_h = cube.entry(pts)
    torch.testing.assert_close(
        evaluate_points_fused(model, pts, problem, cfg, 20, t_entry, from_h),
        u, rtol=2e-4, atol=2e-5)


def test_slice_matches_jax_f32(slice_setup):
    # serving and the metric forward of the slice, the port's kernel paths
    # (plain versions on the CPU) against the JAX kernels in interpret mode
    cfg, model, problem, cube = slice_setup
    jcfg = jload_params(CONFIG)
    jparams = jload_reference(CKPT, dtype=jnp.float32)
    jproblem = jload_problem("Ex4_1_funcs", dim=5)
    rng = np.random.default_rng(2)
    n, L = 200, cfg.N_t
    times = np.sort(rng.uniform(0, 1, L)).astype(np.float32)
    times[0], times[-1] = 0.0, 1.0
    xs = rng.uniform(-1, 1, (n, 5)).astype(np.float32)
    x = np.concatenate([np.broadcast_to(times[None, :, None], (n, L, 1)),
                        np.broadcast_to(xs[:, None], (n, L, 5))], axis=-1)
    arrays = [x, np.ones((n, L), bool), np.zeros(n, np.float32),
              np.ones(n, bool)]
    jb = JPathBatch(*map(jnp.asarray, arrays))
    tb = PathBatch(*map(torch.as_tensor, arrays))
    want = np.asarray(jtrain.u_forward_fused(jparams, jb, jproblem, jcfg,
                                             interpret=True))
    got = u_forward_fused(model, tb, problem, cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
    rel_t = float(rel_err(got, problem.u_sol(tb.x), tb.mask, cube.V(), 2.0))
    rel_j = float(jmetrics.rel_err(jnp.asarray(want), jproblem.u_sol(jb.x),
                                   jb.mask, cube.V(), 2.0))
    assert rel_t == pytest.approx(rel_j, rel=1e-3)

    pts = x[:64, 7, :]
    want = jx.evaluate_points(jparams, jnp.asarray(pts), jproblem, jcfg)
    m = pts.shape[0]
    got = evaluate_points_fused(model, torch.as_tensor(pts), problem, cfg,
                                20, torch.zeros(m),
                                torch.ones(m, dtype=torch.bool))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("p", [1.0, 2.0, 3.0])
def test_metrics_match_jax(p):
    rng = np.random.default_rng(int(p))
    u, sol = rng.normal(size=(40, 6)), rng.normal(size=(40, 6))
    mask = rng.uniform(size=(40, 6)) < 0.7
    T = torch.as_tensor
    jax.config.update("jax_enable_x64", True)
    try:
        for fn, args in ((tmetrics.masked_lp, (u, mask, 2.5, p)),
                         (l_norm, (u, sol, mask, 2.5, p)),
                         (rel_err, (u, sol, mask, 2.5, p))):
            jfn = getattr(jmetrics, fn.__name__)
            got = fn(*(T(a) if isinstance(a, np.ndarray) else a
                       for a in args))
            np.testing.assert_allclose(float(got), float(jfn(*args)),
                                       rtol=1e-12)
        empty = tmetrics.masked_lp(T(u), T(np.zeros_like(mask)), 1.0, p)
        assert float(empty) == 0.0
    finally:
        jax.config.update("jax_enable_x64", False)
