"""The port's SolverConfig, problems and device rule against the JAX package."""

import contextlib
import dataclasses
import glob
import math
import os

import jax
import numpy as np
import pytest
import torch

from xnode_wan_tpu import config as jcfg
from xnode_wan_tpu.problems import load_problem as jload_problem
from xnode_wan_tpu_torch import config as tcfg
from xnode_wan_tpu_torch import default_device
from xnode_wan_tpu_torch.problems import Problem, load_problem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def test_same_fields_and_defaults():
    jf = {f.name: f.default for f in dataclasses.fields(jcfg.SolverConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tcfg.SolverConfig)}
    assert tf == jf


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs",
                                                               "*.yaml"))),
                         ids=os.path.basename)
def test_load_params_matches_jax(path):
    assert tcfg.load_params(path).to_dict() == jcfg.load_params(path).to_dict()


def test_unknown_keys_rejected():
    for cls in (jcfg.SolverConfig, tcfg.SolverConfig):
        with pytest.raises(KeyError, match="not_a_key"):
            cls.from_dict({"dim": 3, "not_a_key": 1})


def test_n_sub_and_u_scale_eff_rules():
    for min_steps in (1, 4, 5, 10, 33):
        for n_t in (2, 5, 20, 21):
            kw = dict(min_steps=min_steps, N_t=n_t)
            want = jcfg.SolverConfig(**kw).n_sub
            assert tcfg.SolverConfig(**kw).n_sub == want
            assert want == max(1, math.ceil(2 * min_steps / n_t))
    for u_scale in (-1.0, 0.0, 0.5, 3.0):
        assert (tcfg.SolverConfig(u_scale=u_scale).u_scale_eff
                == jcfg.SolverConfig(u_scale=u_scale).u_scale_eff)


def test_yaml_exponent_strings_coerced():
    kw = dict(dim=2, N_t=8, N_r="6.4e1", N_b=64, min_steps=4,
              shape_param=[-1.0, 1.0], alpha="1.0e4", ema_decay="9.0e-1",
              window_target_s="1.2e2", train_chunk="1e1", lr_decay="9.9e-1",
              grad_clip="0.0e0", u_scale="1.0e0", ode_rtol="1.0e-5")
    cfg = tcfg.SolverConfig(**kw)
    assert cfg.to_dict() == jcfg.SolverConfig(**kw).to_dict()
    assert cfg.N_r == 64 and isinstance(cfg.N_r, int)
    assert cfg.ema_decay == 0.9 and isinstance(cfg.ema_decay, float)
    assert cfg.shape_param == (-1.0, 1.0)


@pytest.mark.parametrize("bad", [dict(solver="implicit_adams"),
                                 dict(N_t=1), dict(T=0.0), dict(u_layers=0),
                                 dict(qmc="sobol"), dict(ensemble=0),
                                 dict(independent_uv=True, domain="NSphere_TCone")])
def test_validation_matches_jax(bad):
    with pytest.raises(ValueError) as jerr:
        jcfg.SolverConfig(**bad)
    with pytest.raises(ValueError) as terr:
        tcfg.SolverConfig(**bad)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("name", ["cube_pde", "cube_pde_funcs", "Ex4_1_funcs",
                                  "ex4_1"])
def test_problem_callables_match_jax(name):
    rng = np.random.default_rng(3)
    X = np.concatenate([rng.uniform(0, 1, (64, 1)),
                        rng.uniform(-1, 1, (64, 5))], axis=-1)
    jp, tp = jload_problem(name, dim=5), load_problem(name, dim=5)
    assert (tp.name, tp.a_kind, tp.stop_rel_err) == (jp.name, jp.a_kind,
                                                     jp.stop_rel_err)
    Xt = torch.as_tensor(X)
    with x64():
        for fn in ("h", "f", "g", "u_sol"):
            np.testing.assert_allclose(getattr(tp, fn)(Xt).numpy(),
                                       np.asarray(getattr(jp, fn)(X)),
                                       rtol=1e-12, atol=1e-12)
    u = torch.as_tensor(rng.normal(size=64))
    np.testing.assert_allclose(tp.c(Xt, u).numpy(),
                               np.asarray(jp.c(X, u.numpy())))


def test_problem_a_kind_checked():
    with pytest.raises(ValueError, match="a_kind"):
        Problem(name="x", h=None, f=None, g=None, c=None, a_kind="sparse")
    p = Problem(name="x", h=None, f=None, g=None, c=None)
    assert p.a(None) == 1.0


@pytest.mark.parametrize("dim", [2, 5, 20])
def test_ex4_3_matches_jax(dim):
    # the literal source term and the consistent one, u_sol, g, h, c
    rng = np.random.default_rng(dim)
    X = np.concatenate([rng.uniform(0, 1, (64, 1)),
                        rng.uniform(-1, 1, (64, dim))], axis=-1)
    Xt = torch.as_tensor(X)
    for name in ("Ex4_3_funcs", "ex4_3", "Ex4_3_consistent",
                 "ex4_3_consistent"):
        jp, tp = jload_problem(name, dim=dim), load_problem(name, dim=dim)
        assert (tp.name, tp.a_kind, tp.dim, tp.b, tp.stop_rel_err) == (
            jp.name, jp.a_kind, jp.dim, jp.b, jp.stop_rel_err)
        with x64():
            for fn in ("h", "f", "g", "u_sol"):
                want = np.asarray(getattr(jp, fn)(X))
                np.testing.assert_allclose(
                    getattr(tp, fn)(Xt).numpy(), want, rtol=1e-12,
                    atol=1e-12 * np.abs(want).max(), err_msg=f"{name}.{fn}")
        u = torch.as_tensor(rng.normal(size=64))
        np.testing.assert_array_equal(tp.c(Xt, u).numpy(),
                                      np.asarray(jp.c(X, u.numpy())))
    assert not np.allclose(load_problem("Ex4_3_funcs", dim).f(Xt).numpy(),
                           load_problem("Ex4_3_consistent", dim).f(Xt).numpy())


def ex4_3_residual(problem, X):
    """``u_t - Lap u + c(u) u - f`` at the points ``X`` by autograd."""
    X = X.clone().requires_grad_(True)
    u = problem.u_sol(X)
    grad = torch.autograd.grad(u.sum(), X, create_graph=True)[0]
    lap = sum(torch.autograd.grad(grad[:, i].sum(), X, retain_graph=True)[0][:, i]
              for i in range(1, X.shape[1]))
    return grad[:, 0] - lap + problem.c(X, u) * u - problem.f(X)


def test_ex4_3_consistent_zeroes_the_residual():
    # as tests/test_problems.py holds the JAX package's: the consistent f
    # at any dim, the reference's literal one not even at d = 2
    rng = np.random.default_rng(7)
    for d in (2, 7):
        X = torch.as_tensor(rng.uniform(0.05, 0.9, (16, d + 1)))
        res = ex4_3_residual(load_problem("Ex4_3_consistent", d), X)
        np.testing.assert_allclose(res.detach().numpy(), 0.0,
                                   atol=1e-10 * (math.pi / 2) ** d)
    X = torch.as_tensor(rng.uniform(0.05, 0.9, (16, 3)))
    res = ex4_3_residual(load_problem("Ex4_3_funcs", 2), X)
    assert float(res.detach().abs().max()) > 1e-3


def test_ex4_3_needs_a_dim():
    for name in ("Ex4_3_funcs", "Ex4_3_consistent"):
        with pytest.raises(ValueError, match="dimension"):
            load_problem(name, dim=None)
    assert load_problem("Ex4_3_funcs", dim=3).dim == 3


def test_default_device_needs_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()
    assert default_device("cpu") == torch.device("cpu")
