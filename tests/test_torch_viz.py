"""The port's contour plots (``utils/viz.py::proj``) against the JAX
package's with the same weights: ``guess_cn.npy`` and ``error_cn.npy``
within 1e-5 (both build the slice in float32, JAX ``viz.py:38``), the
cone's NaN mask identical, the PNG written; and ``train(report=True)``
plotting at each report step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xnode_wan_tpu.config import SolverConfig as JConfig
from xnode_wan_tpu.models import xnode as jx
from xnode_wan_tpu.ops import sampling as jsampling
from xnode_wan_tpu.problems import load_problem as jload_problem
from xnode_wan_tpu.utils.viz import proj as jproj
from xnode_wan_tpu_torch import (NODEWANSolver, SolverConfig, load_problem,
                                 make_domain, params_from_jax)
from xnode_wan_tpu_torch.models import xnode as tx
from xnode_wan_tpu_torch.utils.viz import proj

BASE = dict(dim=2, N_t=6, N_r=8, N_b=8, u_hidden_dim=8,
            u_hidden_hidden_dim=8, u_layers=2, v_layers=2, v_hidden_dim=8,
            min_steps=3)


@pytest.mark.parametrize("domain,shape", [("Hypercube", (-1.0, 1.0)),
                                          ("NSphere_TCone", 1.0)])
def test_proj_matches_jax(tmp_path, domain, shape):
    kw = dict(BASE, domain=domain, shape_param=shape)
    jcfg, tcfg = JConfig(**kw), SolverConfig(**kw)
    tree = jax.tree.map(np.asarray,
                        jx.init_xnode(jax.random.PRNGKey(2), jcfg))
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_jax(tree, device="cpu", dtype=torch.float32)
    jp, tp = jload_problem("Ex4_1_funcs", 2), load_problem("Ex4_1_funcs", 2)
    jdom = jsampling.make_domain(domain, shape, 2, 0.0, 1.0, 6)
    tdom = make_domain(domain, shape, 2, 0.0, 1.0, 6)
    down, up = (shape if isinstance(shape, tuple) else (-shape, shape))
    view = dict(axes=(0, 1), T=1.0, T0=0.0, down=down, up=up, resolution=40,
                colours=5, save=True)
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    jproj(lambda pts: jx.evaluate_points(jparams, pts, jp, jcfg,
                                         domain=jdom),
          2, 3, func_u_sol=jp.u_sol, work_dir=str(tmp_path / "jax"),
          domain=jdom, **view)

    def predict(pts):
        with torch.no_grad():
            return tx.evaluate_points(tparams, pts, tp, tcfg, domain=tdom)

    proj(predict, 2, 3, func_u_sol=tp.u_sol, work_dir=str(tmp_path / "torch"),
         domain=tdom, **view)
    for name in ("guess_cn.npy", "error_cn.npy"):
        want = np.load(tmp_path / "jax" / name)
        got = np.load(tmp_path / "torch" / name)
        assert got.shape == want.shape == (40, 40)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if domain == "NSphere_TCone":
        assert np.isnan(np.load(tmp_path / "torch" / "guess_cn.npy")).any()
    assert (tmp_path / "torch" / "plot_at_3_along_[0, 1].png").exists()


def test_train_report_plots_each_report_step(tmp_path, capsys):
    s = NODEWANSolver(SolverConfig(**dict(BASE, N_r=16, N_b=16)),
                      load_problem("cube_pde", 2), device="cpu",
                      work_dir=str(tmp_path))
    s.train(report=True, report_it=3, iterations=7, chunk=5)
    out = capsys.readouterr().out
    steps = [0, 3, 6]
    for step in steps:
        assert f"iteration: {step} Loss u:" in out
        assert (tmp_path / f"plot_at_{step}_along_[0, 1].png").exists()
    assert len(list(tmp_path.glob("plot_at_*"))) == len(steps)
    # the last plot's guess is the last report step's primal, served
    guess = np.load(tmp_path / "guess_cn.npy")
    assert guess.shape == (200, 200) and np.isfinite(guess).all()


def test_plot_catches_only_a_missing_matplotlib(tmp_path, monkeypatch,
                                                capsys):
    import builtins
    s = NODEWANSolver(SolverConfig(**BASE), load_problem("cube_pde", 2),
                      device="cpu", work_dir=str(tmp_path))
    real = builtins.__import__

    def no_matplotlib(name, *args, **kw):
        if name.startswith("matplotlib"):
            raise ModuleNotFoundError(f"No module named {name!r}",
                                      name=name)
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    s._maybe_plot(0, False)
    assert "No module named 'matplotlib'" in capsys.readouterr().out
    assert (tmp_path / "guess_cn.npy").exists()
    assert not list(tmp_path.glob("*.png"))
    monkeypatch.setattr(builtins, "__import__", real)

    def broken(*args, **kw):
        raise RuntimeError("kernel #1 failed")

    monkeypatch.setattr(s, "predict", broken)
    with pytest.raises(RuntimeError, match="kernel #1"):
        s._maybe_plot(0, False)
