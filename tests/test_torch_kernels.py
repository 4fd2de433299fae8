"""The kernel modules of the port: each plain version against the JAX
Pallas kernel in interpret mode, and the host side of each CUDA wrapper
(packing, argument contract, counters) that the CPU can check.

The CUDA kernels themselves build and run only on a GPU; ``chip_smoke.py``
holds each against its plain version there.
"""

import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xnode_wan_tpu.config import SolverConfig as JConfig
from xnode_wan_tpu.models.xnode import init_xnode as jinit_xnode
from xnode_wan_tpu.models.xnode import spatial_features as jfeatures
from xnode_wan_tpu.ops.pallas import steppers as jsteppers
from xnode_wan_tpu.ops.pallas import xnode_eval as jeval
from xnode_wan_tpu.ops.pallas import xnode_train as jtrain
from xnode_wan_tpu.ops.sampling import PathBatch as JPathBatch
from xnode_wan_tpu.problems import load_problem as jload_problem
from xnode_wan_tpu_torch import SolverConfig, load_problem, params_from_jax
from xnode_wan_tpu_torch.ops.kernels import _build, steppers, xnode_eval
from xnode_wan_tpu_torch.ops.kernels import xnode_train
from xnode_wan_tpu_torch.ops.sampling import PathBatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(dim=3, N_t=6, N_r=8, N_b=8, u_hidden_dim=8,
            u_hidden_hidden_dim=8, u_layers=2, min_steps=3,
            shape_param=(-1.0, 1.0))
TOL = dict(rtol=2e-4, atol=2e-5)   # kernel against scan, tests/test_pallas.py
METHODS = ["euler", "midpoint", "heun", "rk4"]


def shared(seed=0, **kw):
    jcfg = JConfig(**{**BASE, **kw})
    tree = jax.tree.map(np.asarray, jinit_xnode(jax.random.PRNGKey(seed),
                                                jcfg))
    return (jcfg, SolverConfig(**{**BASE, **kw}),
            jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, device="cpu"))


def test_fused_methods_and_unknown_method_rejected():
    assert steppers.FUSED_KERNEL_METHODS == jsteppers.FUSED_KERNEL_METHODS
    assert "fixed_adams" not in steppers.FUSED_KERNEL_METHODS
    assert "explicit_adams" not in steppers.FUSED_KERNEL_METHODS
    with pytest.raises(ValueError, match="fixed_adams") as terr:
        steppers.rk_step("fixed_adams", lambda t, h: h, 0.0, 0.1,
                         torch.ones(2))
    with pytest.raises(ValueError) as jerr:
        jsteppers.rk_step("fixed_adams", lambda t, h: h, 0.0, 0.1,
                          jnp.ones(2))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("method", METHODS)
def test_rk_step_matches_jax(method):
    rng = np.random.default_rng(1)
    A, h = rng.normal(size=(3, 3)), rng.normal(size=(4, 3))
    t, dt = rng.uniform(size=(4, 1)), rng.uniform(size=(4, 1)) * 0.1
    want = jsteppers.rk_step(method, lambda s, y: jnp.sin(y @ A) * s,
                             t, dt, h)
    At = torch.as_tensor(A)
    got = steppers.rk_step(method, lambda s, y: torch.sin(y @ At) * s,
                           torch.as_tensor(t), torch.as_tensor(dt),
                           torch.as_tensor(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("m", [37, 3])
def test_fused_evaluate_plain_matches_pallas(method, m):
    # M is no multiple of any block; per-point path origins t_start > 0
    _, _, jparams, tparams = shared(seed=1)
    rng = np.random.default_rng(m)
    pts = np.concatenate([rng.uniform(0.3, 1, (m, 1)),
                          rng.uniform(-1, 1, (m, 3))], axis=-1).astype(
                              np.float32)
    seed = rng.normal(size=m).astype(np.float32)
    t_start = rng.uniform(0, 0.3, m).astype(np.float32)
    want = jeval.fused_evaluate(jparams, jnp.asarray(pts), jnp.asarray(seed),
                                6, t_start=jnp.asarray(t_start),
                                method=method, interpret=True)
    before = xnode_eval.KERNEL.launches
    got = xnode_eval.fused_evaluate(tparams, torch.as_tensor(pts),
                                    torch.as_tensor(seed), 6,
                                    t_start=torch.as_tensor(t_start),
                                    method=method)
    assert xnode_eval.KERNEL.launches == before   # CPU: the plain version
    assert got.shape == (m,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fused_evaluate_plain_fourier_and_t0_match_pallas():
    _, _, jparams, tparams = shared(seed=2, fourier_features=2)
    rng = np.random.default_rng(2)
    pts = np.concatenate([rng.uniform(0.2, 1, (19, 1)),
                          rng.uniform(-1, 1, (19, 3))], axis=-1).astype(
                              np.float32)
    seed = rng.normal(size=19).astype(np.float32)
    feats = np.array(jfeatures(jnp.asarray(pts[:, 1:]), 2))
    want = jeval.fused_evaluate(jparams, jnp.asarray(pts), jnp.asarray(seed),
                                5, t0=0.1, feats=jnp.asarray(feats),
                                method="rk4", interpret=True)
    got = xnode_eval.fused_evaluate(tparams, torch.as_tensor(pts),
                                    torch.as_tensor(seed), 5, t0=0.1,
                                    feats=torch.as_tensor(feats),
                                    method="rk4")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def batch_pair(n, L, masked, seed=3):
    rng = np.random.default_rng(seed)
    t_start = rng.uniform(0, 0.2, n) if masked else np.zeros(n)
    times = np.maximum(np.sort(rng.uniform(0, 1, (n, L)), axis=1),
                       t_start[:, None])
    xs = rng.uniform(-1, 1, (n, 3))
    x = np.concatenate([times[:, :, None],
                        np.broadcast_to(xs[:, None], (n, L, 3))], axis=-1)
    mask = rng.uniform(size=(n, L)) < (0.6 if masked else 2.0)
    from_h = rng.uniform(size=n) < (0.5 if masked else 2.0)
    arrays = [x.astype(np.float32), mask, t_start.astype(np.float32), from_h]
    return (JPathBatch(*map(jnp.asarray, arrays)),
            PathBatch(*map(torch.as_tensor, arrays)))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_u_forward_fused_plain_matches_pallas(method, masked):
    jcfg, tcfg, jparams, tparams = shared(seed=4, solver=method)
    jb, tb = batch_pair(21, 6, masked)
    jp, tp = jload_problem("cube_pde"), load_problem("cube_pde")
    want = jtrain.u_forward_fused(jparams, jb, jp, jcfg, interpret=True)
    before = xnode_train.KERNEL.launches
    got = xnode_train.u_forward_fused(tparams, tb, tp, tcfg)
    assert xnode_train.KERNEL.launches == before
    assert got.shape == (21, 6) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("extra", [dict(min_steps=7, u_scale=3.0),
                                   dict(fourier_features=1)],
                         ids=["nsub3_uscale", "fourier1"])
def test_u_forward_fused_plain_variants_match_pallas(extra):
    jcfg, tcfg, jparams, tparams = shared(seed=5, **extra)
    jb, tb = batch_pair(9, 6, masked=True, seed=6)
    jp, tp = jload_problem("Ex4_1_funcs"), load_problem("Ex4_1_funcs")
    want = jtrain.u_forward_fused(jparams, jb, jp, jcfg, interpret=True)
    got = xnode_train.u_forward_fused(tparams, tb, tp, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n_sub", [1, 2])
def test_prep_intervals_matches_jax(n_sub):
    rng = np.random.default_rng(n_sub)
    t_start = rng.uniform(0, 0.3, 30).astype(np.float32)
    times = np.sort(rng.uniform(0, 1, (30, 8)), axis=1).astype(np.float32)
    mask = rng.uniform(size=(30, 8)) < 0.5
    mask[0] = False                          # a path with no valid sample
    want = jtrain._prep_intervals(jnp.asarray(times), jnp.asarray(mask),
                                  jnp.asarray(t_start), n_sub)
    got = xnode_train._prep_intervals(torch.as_tensor(times),
                                      torch.as_tensor(mask),
                                      torch.as_tensor(t_start), n_sub)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool((got[1][~torch.as_tensor(mask)] == 0).all())


def test_flatten_params_and_packed_layout():
    _, _, jparams, tparams = shared(seed=7, fourier_features=1)
    flat = xnode_train._flatten_params_t(tparams)
    jflat = jtrain._flatten_params_t(jparams)
    assert len(flat) == len(jflat)
    for t, j in zip(flat, jflat):
        np.testing.assert_array_equal(t.numpy().reshape(j.shape),
                                      np.asarray(j))
    # the offsets csrc/steppers.cuh computes into the packed buffer
    net = xnode_train.flat_net(tparams)
    H, Hh, F, n_lift, n_field = net.dims()
    assert (H, Hh, F, n_lift, n_field) == (8, 8, 9, 3, 3)
    packed = net.packed().numpy()
    fin = F + 1 + H
    n_params = ((H + H) + (n_lift - 1) * (H * H + H) + (fin * Hh + Hh)
                + (n_field - 2) * (Hh * Hh + Hh) + (Hh * H + H) + (H + 1))
    assert packed.shape == (n_params,)
    field_off = (H + H) + (n_lift - 1) * (H * H + H)
    w0, b0 = tparams.field[0].weight.detach(), tparams.field[0].bias.detach()
    np.testing.assert_array_equal(
        packed[field_off:field_off + fin * Hh].reshape(Hh, fin), w0.numpy())
    np.testing.assert_array_equal(
        packed[field_off + fin * Hh:field_off + fin * Hh + Hh], b0.numpy())
    readout = packed[n_params - (H + 1):]
    np.testing.assert_array_equal(
        readout[:H], tparams.readout.weight.detach().numpy()[0])
    assert readout[H] == tparams.readout.bias.detach().numpy()[0]


def test_d5_bound_counts():
    # the full-width d=5 net: 2,161 packed floats; 1,110 multiply-adds per
    # field evaluation after the hoisted feature columns
    cfg = SolverConfig()
    from xnode_wan_tpu_torch import init_xnode
    net = xnode_train.flat_net(init_xnode(cfg, device="cpu"))
    assert net.packed().numel() == 2161
    assert steppers.field_macs(net) == (50, 1110)
    assert steppers.lift_readout_macs(net) == 840


def cuda_signature(source, symbol):
    text = (_build.CSRC / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)", text, re.S)
    assert m, f"{symbol} not found in {source}.cu"
    return [p.strip() for p in m.group(1).split(",")]


@pytest.mark.parametrize("kernel", [xnode_eval.KERNEL, xnode_train.KERNEL],
                         ids=lambda k: k.symbol)
def test_ctypes_argtypes_match_c_signature(kernel):
    params = cuda_signature(kernel.source, kernel.symbol)
    declared = [ctypes.c_int, ctypes.c_void_p] + kernel.argtypes
    assert len(params) == len(declared)
    for p, ct in zip(params, declared):
        assert ct is (ctypes.c_void_p if "*" in p else ctypes.c_int), p
        assert "*" in p or p.startswith("int ")


def test_cuda_wrappers_reject_before_launch():
    _, _, _, tparams = shared(seed=8)
    net = xnode_train.flat_net(tparams)
    m = 4
    f32 = dict(dtype=torch.float32)
    ev = (torch.zeros((m, 3), **f32), torch.ones(m, **f32),
          torch.zeros(m, **f32), torch.zeros(m, **f32))
    before = xnode_eval.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA device"):
        xnode_eval.evaluate_cuda(net, *ev, 4, "midpoint")
    with pytest.raises(ValueError, match="fixed_adams"):
        xnode_eval.evaluate_cuda(net, *ev, 4, "fixed_adams")
    with pytest.raises(ValueError, match="k_steps"):
        xnode_eval.evaluate_cuda(net, *ev, 0, "midpoint")
    pf = (torch.zeros((m, 2), **f32), torch.zeros((m, 2), **f32),
          torch.zeros((m, 3), **f32), torch.zeros(m, **f32))
    with pytest.raises(ValueError, match="CUDA device"):
        xnode_train.path_forward_cuda(net, *pf, 1, "rk4")
    with pytest.raises(ValueError, match="no path-forward kernel"):
        xnode_train.path_forward(net, *(a.to("meta") for a in pf), 1, "rk4")
    assert xnode_eval.KERNEL.launches == before


@pytest.mark.parametrize("widths", [dict(u_hidden_dim=65),
                                    dict(u_hidden_hidden_dim=65),
                                    dict(u_hidden_dim=60, dim=70)])
def test_caps_enforced(widths):
    from xnode_wan_tpu_torch import init_xnode
    net = xnode_train.flat_net(init_xnode(SolverConfig(**{**BASE, **widths}),
                                          device="cpu"))
    with pytest.raises(ValueError, match="cap"):
        net.check_caps()


def test_caps_cover_shipped_configs():
    from xnode_wan_tpu_torch import init_xnode, load_params
    for name in ("cube_pde", "highdim_d20", "ex4_1_d10"):
        cfg = load_params(os.path.join(REPO, "configs", f"{name}.yaml"))
        xnode_train.flat_net(init_xnode(cfg, device="cpu")).check_caps()


def test_build_dir_keyed_on_sources():
    d = _build.build_dir()
    assert d.parent == _build.BUILD_ROOT and d == _build.build_dir()
    assert {p.name for p in _build.CSRC.glob("*.cu")} == {
        f"{s}.cu" for s in _build.KERNEL_SOURCES}
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert "xnode_wan_tpu_torch/_build/" in fh.read().split()
