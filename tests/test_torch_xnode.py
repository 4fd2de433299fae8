"""The port's XNODE forward against the JAX package on shared inputs.

Inputs are made with numpy from a seed; JAX parameters go across with
``params_from_jax``. f64 runs (JAX with ``jax_enable_x64``) agree to
1e-9, f32 runs within ``rtol=2e-4, atol=2e-5``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xnode_wan_tpu.config import SolverConfig as JConfig
from xnode_wan_tpu.models import xnode as jx
from xnode_wan_tpu.ops import integrate as jint
from xnode_wan_tpu.ops import sampling as jsampling
from xnode_wan_tpu.problems import load_problem as jload_problem
from xnode_wan_tpu_torch import SolverConfig, load_problem, params_from_jax
from xnode_wan_tpu_torch.models import xnode as tx
from xnode_wan_tpu_torch.ops import integrate as tint
from xnode_wan_tpu_torch.ops.sampling import Hypercube, PathBatch
from xnode_wan_tpu_torch.parallel.mesh import make_mesh

BASE = dict(dim=3, N_t=6, N_r=8, N_b=8, u_hidden_dim=8,
            u_hidden_hidden_dim=8, u_layers=2, v_layers=2, v_hidden_dim=8,
            min_steps=3, shape_param=(-1.0, 1.0))
TOL = {"f64": dict(rtol=1e-9, atol=1e-9), "f32": dict(rtol=2e-4, atol=2e-5)}
DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32,
                                                      torch.float32)}


@contextlib.contextmanager
def precision(name):
    """JAX computes in f64 only with ``jax_enable_x64``."""
    if name != "f64":
        yield
        return
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def configs(**kw):
    return JConfig(**{**BASE, **kw}), SolverConfig(**{**BASE, **kw})


def shared_params(jcfg, prec, seed=0):
    """JAX ``init_xnode`` weights as numpy, in both packages' forms."""
    npd, td = DTYPES[prec]
    tree = jax.tree.map(lambda a: np.asarray(a, npd),
                        jx.init_xnode(jax.random.PRNGKey(seed), jcfg))
    return jax.tree.map(jnp.asarray, tree), params_from_jax(
        tree, device="cpu", dtype=td)


def path_batch(n, L, d, prec, masked, seed=1):
    """Per-path sorted times, ragged masks, mixed t_start / h-or-g seeds."""
    npd, td = DTYPES[prec]
    rng = np.random.default_rng(seed)
    t_start = rng.uniform(0.0, 0.3, n) if masked else np.zeros(n)
    times = np.sort(rng.uniform(0.0, 1.0, (n, L)), axis=1)
    times = np.maximum(times, t_start[:, None])
    xs = rng.uniform(-1, 1, (n, d))
    x = np.concatenate([times[:, :, None],
                        np.broadcast_to(xs[:, None, :], (n, L, d))], axis=-1)
    mask = (rng.uniform(size=(n, L)) < 0.7) if masked else np.ones((n, L),
                                                                   bool)
    from_h = (rng.uniform(size=n) < 0.5) if masked else np.ones(n, bool)
    arrays = [x.astype(npd), mask, t_start.astype(npd), from_h]
    jb = jsampling.PathBatch(*map(jnp.asarray, arrays))
    tb = PathBatch(*map(torch.as_tensor, arrays))
    return jb, tb


def check(got, want, prec):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL[prec])


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("solver", ["euler", "midpoint", "heun", "rk4"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_apply_xnode_matches_jax(prec, solver, masked):
    jcfg, tcfg = configs(solver=solver)
    jp, tp = jload_problem("cube_pde"), load_problem("cube_pde")
    with precision(prec):
        jparams, tparams = shared_params(jcfg, prec)
        jb, tb = path_batch(16, 6, 3, prec, masked)
        want = jx.apply_xnode(jparams, jb, jp, jcfg)
        got = tx.apply_xnode(tparams, tb, tp, tcfg)
        assert got.shape == (16, 6) and got.dtype == DTYPES[prec][1]
        check(got, want, prec)


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("extra", [dict(fourier_features=2),
                                   dict(min_steps=6, u_scale=2.5),
                                   dict(u_layers=1)],
                         ids=["fourier2", "nsub2_uscale", "one_layer"])
def test_apply_xnode_variants_match_jax(prec, extra):
    jcfg, tcfg = configs(**extra)
    jp, tp = jload_problem("cube_pde"), load_problem("cube_pde")
    with precision(prec):
        jparams, tparams = shared_params(jcfg, prec, seed=2)
        jb, tb = path_batch(12, 6, 3, prec, masked=True, seed=4)
        check(tx.apply_xnode(tparams, tb, tp, tcfg),
              jx.apply_xnode(jparams, jb, jp, jcfg), prec)


def eval_points(m, d, npd, seed=5):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(0, 1, (m, 1)),
                           rng.uniform(-1, 1, (m, d))], axis=-1).astype(npd)


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("extra", [dict(), dict(fourier_features=2),
                                   dict(solver="rk4", min_steps=8)],
                         ids=["midpoint", "fourier2", "rk4_nsub3"])
def test_evaluate_points_matches_jax(prec, extra):
    jcfg, tcfg = configs(**extra)
    jp, tp = jload_problem("cube_pde"), load_problem("cube_pde")
    cube = Hypercube((-1.0, 1.0), 3, 0.0, 1.0, 6)
    jcube = jsampling.Hypercube((-1.0, 1.0), 3, 0.0, 1.0, 6)
    pts = eval_points(37, 3, DTYPES[prec][0])
    with precision(prec):
        jparams, tparams = shared_params(jcfg, prec, seed=3)
        want = jx.evaluate_points(jparams, jnp.asarray(pts), jp, jcfg,
                                  k_steps=7, domain=jcube)
        got = tx.evaluate_points(tparams, torch.as_tensor(pts), tp, tcfg,
                                 k_steps=7, domain=cube)
        assert got.shape == (37,)
        check(got, want, prec)
        # default k_steps = max(min_steps, N_t), no domain
        check(tx.evaluate_points(tparams, torch.as_tensor(pts), tp, tcfg),
              jx.evaluate_points(jparams, jnp.asarray(pts), jp, jcfg), prec)


@pytest.mark.parametrize("extra", [dict(), dict(fourier_features=2),
                                   dict(solver="heun", min_steps=6)],
                         ids=["midpoint", "fourier2", "heun_nsub2"])
def test_evaluate_points_kernel_branch_matches_jax(extra):
    # The branch evaluate_points takes on CUDA, run on CPU tensors (where
    # fused_evaluate takes its plain version), against the JAX scan path.
    jcfg, tcfg = configs(**extra)
    jp, tp = jload_problem("cube_pde"), load_problem("cube_pde")
    pts = eval_points(29, 3, np.float32, seed=6)
    jparams, tparams = shared_params(jcfg, "f32", seed=4)
    want = jx.evaluate_points(jparams, jnp.asarray(pts), jp, jcfg, k_steps=8)
    m = pts.shape[0]
    got = tx.evaluate_points_fused(
        tparams, torch.as_tensor(pts), tp, tcfg, 8,
        torch.zeros(m), torch.ones(m, dtype=torch.bool))
    check(got, want, "f32")


def test_lift_field_features_match_jax():
    jcfg, _ = configs(fourier_features=1)
    with precision("f64"):
        jparams, tparams = shared_params(jcfg, "f64", seed=7)
        rng = np.random.default_rng(8)
        seed = rng.normal(size=(10, 1))
        x = rng.uniform(-1, 1, (10, 3))
        t = rng.uniform(0, 1, 10)
        h = rng.normal(size=(10, 8))
        T = torch.as_tensor
        check(tx.lift_apply(tparams, T(seed)),
              jx.lift_apply(jparams, jnp.asarray(seed)), "f64")
        xf = tx.spatial_features(T(x), 1)
        check(xf, jx.spatial_features(jnp.asarray(x), 1), "f64")
        check(tx.field_apply(tparams, xf, T(t), T(h)),
              jx.field_apply(jparams, jx.spatial_features(jnp.asarray(x), 1),
                             jnp.asarray(t), jnp.asarray(h)), "f64")


def test_init_xnode_shapes_and_init():
    jcfg, tcfg = configs(fourier_features=1)
    jtree = jx.init_xnode(jax.random.PRNGKey(0), jcfg)
    model = tx.init_xnode(tcfg, torch.Generator().manual_seed(0))
    layers = [*model.lift, *model.field, model.readout]
    jlayers = [*jtree["lift"], *jtree["field"], jtree["readout"]]
    assert len(layers) == len(jlayers)
    for lin, jl in zip(layers, jlayers):
        assert tuple(lin.weight.shape) == tuple(jl["w"].shape[::-1])
        assert lin.weight.dtype == torch.float32
        fan_out, fan_in = lin.weight.shape
        assert float(lin.weight.detach().abs().max()) <= np.sqrt(6 / (fan_in + fan_out))
        assert not lin.bias.any()
    again = tx.init_xnode(tcfg, device="cpu")     # default: from cfg.seed
    same = tx.init_xnode(tcfg, device="cpu")
    assert torch.equal(again.field[0].weight, same.field[0].weight)
    assert tx.init_xnode(tcfg.replace(x64=True), device="cpu").readout \
        .weight.dtype == torch.float64


@pytest.mark.parametrize("method", ["euler", "midpoint", "heun", "rk4"])
@pytest.mark.parametrize("n_sub", [1, 3])
def test_integrate_matches_jax(method, n_sub):
    # a nonlinear field with explicit time dependence, ragged masks
    rng = np.random.default_rng(9)
    A = rng.normal(size=(4, 4)) * 0.5
    h0 = rng.normal(size=(5, 4))
    times = np.sort(rng.uniform(0, 1, (5, 7)), axis=1)
    mask = rng.uniform(size=(5, 7)) < 0.6
    t_start = np.full(5, 0.05)
    with precision("f64"):
        want = jint.integrate(
            lambda t, h: jnp.tanh(h @ A) * jnp.cos(t)[:, None],
            jnp.asarray(h0), jnp.asarray(times), jnp.asarray(t_start),
            jnp.asarray(mask), n_sub=n_sub, method=method)
        At = torch.as_tensor(A)
        got = tint.integrate(
            lambda t, h: torch.tanh(h @ At) * torch.cos(t)[:, None],
            torch.as_tensor(h0), torch.as_tensor(times),
            torch.as_tensor(t_start), torch.as_tensor(mask), n_sub=n_sub,
            method=method)
        check(got, want, "f64")


def test_unported_paths_raise():
    _, tcfg = configs()
    model = tx.init_xnode(tcfg, device="cpu")
    tp = load_problem("cube_pde")
    pts = torch.zeros((2, 4))
    # sharded serving is ported: a mesh of one rank serves as no mesh does
    with torch.no_grad():
        np.testing.assert_array_equal(
            tx.evaluate_points(model, pts, tp, tcfg,
                               mesh=make_mesh([0])).numpy(),
            tx.evaluate_points(model, pts, tp, tcfg).numpy())
    args = (lambda t, h: h, torch.zeros((1, 2)), torch.ones((1, 3)),
            torch.zeros(1), torch.ones((1, 3), dtype=torch.bool), 1)
    with pytest.raises(ValueError, match="unknown method"):
        tint.integrate(*args, method="leapfrog")
