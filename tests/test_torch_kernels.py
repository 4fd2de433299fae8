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


WIDE_NETS = [dict(dim=2, u_hidden_dim=72, u_hidden_hidden_dim=72),
             dict(dim=50, fourier_features=1)]
WIDE_IDS = ["72wide_d2", "d50_fourier_F150"]


def batch_pair_d(n, L, d, seed):
    """:func:`batch_pair`, masked, at ``d`` coordinates."""
    rng = np.random.default_rng(seed)
    t_start = rng.uniform(0, 0.2, n)
    times = np.maximum(np.sort(rng.uniform(0, 1, (n, L)), axis=1),
                       t_start[:, None])
    xs = rng.uniform(-1, 1, (n, d))
    x = np.concatenate([times[:, :, None],
                        np.broadcast_to(xs[:, None], (n, L, d))], axis=-1)
    arrays = [x.astype(np.float32), rng.uniform(size=(n, L)) < 0.7,
              t_start.astype(np.float32), rng.uniform(size=n) < 0.5]
    return (JPathBatch(*map(jnp.asarray, arrays)),
            PathBatch(*map(torch.as_tensor, arrays)))


@pytest.mark.parametrize("extra", WIDE_NETS, ids=WIDE_IDS)
def test_fused_evaluate_plain_matches_pallas_past_register_caps(extra):
    # the nets the path-tile kernel (a width past 64) and the register
    # kernel past its old field-input cap (F + 1 + H = 171) serve: the
    # plain version the card is held against, against JAX's Pallas #1
    jcfg, tcfg, jparams, tparams = shared(seed=7, **extra)
    rng = np.random.default_rng(7)
    m, d = 11, extra["dim"]
    pts = np.concatenate([rng.uniform(0.3, 1, (m, 1)),
                          rng.uniform(-1, 1, (m, d))], axis=-1).astype(
                              np.float32)
    seed = rng.normal(size=m).astype(np.float32)
    t_start = rng.uniform(0, 0.3, m).astype(np.float32)
    feats = np.array(jfeatures(jnp.asarray(pts[:, 1:]),
                               jcfg.fourier_features))
    want = jeval.fused_evaluate(jparams, jnp.asarray(pts), jnp.asarray(seed),
                                2, t_start=jnp.asarray(t_start),
                                feats=jnp.asarray(feats), interpret=True)
    got = xnode_eval.fused_evaluate(tparams, torch.as_tensor(pts),
                                    torch.as_tensor(seed), 2,
                                    t_start=torch.as_tensor(t_start),
                                    feats=torch.as_tensor(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("extra", WIDE_NETS, ids=WIDE_IDS)
def test_u_forward_fused_plain_matches_pallas_past_register_caps(extra):
    jcfg, tcfg, jparams, tparams = shared(seed=8, **extra)
    net = xnode_train.flat_net(tparams)
    assert net.H > 64 or net.F + 1 + net.H > 128
    jb, tb = batch_pair_d(7, 3, extra["dim"], seed=8)
    jp, tp = jload_problem("Ex4_1_funcs"), load_problem("Ex4_1_funcs")
    want = jtrain.u_forward_fused(jparams, jb, jp, jcfg, interpret=True)
    got = xnode_train.u_forward_fused(tparams, tb, tp, tcfg)
    assert got.shape == (7, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def no_tangents(n, F):
    return torch.zeros((n, 0, F)), torch.zeros((n, 0))


@pytest.mark.parametrize("entry", ["metric", "serving"])
def test_tangentless_twin_matches_fwd_only_and_xnode_eval(entry):
    # the plain version of #1/#2's tile variant: #3's forward with d = 0,
    # against the JAX package's _fwd_only_kernel (the metric, masked paths
    # with t_start > 0, midpoint) and its serving kernel (one interval from
    # t_start a point, dt = (t - t_start) / k_steps, rk4), interpret mode
    from xnode_wan_tpu_torch.models.xnode import path_seed_fn, spatial_features
    jcfg, tcfg, jparams, tparams = shared(seed=7, fourier_features=1,
                                          solver="midpoint")
    net = xnode_train.flat_net(tparams)
    if entry == "metric":
        jb, tb = batch_pair(17, 6, masked=True, seed=8)
        jp, tp = jload_problem("cube_pde"), load_problem("cube_pde")
        want = jtrain.u_forward_fused(jparams, jb, jp, jcfg, interpret=True)
        xs = tb.space[:, 0, :]
        t0, dt = xnode_train._prep_intervals(tb.times, tb.mask, tb.t_start,
                                             tcfg.n_sub)
        feats, seed = spatial_features(xs, 1), path_seed_fn(tb, tp, tcfg)(xs)
        u, du = xnode_train.u_du_fwd_plain(
            net, t0, dt, feats, no_tangents(17, net.F)[0], seed,
            no_tangents(17, net.F)[1], tcfg.n_sub, "midpoint")
        got = u * float(tcfg.u_scale_eff)
        assert du.shape == (17, 6, 0)
        torch.testing.assert_close(u, xnode_train.path_forward_plain(
            net, t0, dt, feats, seed, tcfg.n_sub, "midpoint"),
            rtol=1e-6, atol=1e-6)
    else:
        rng = np.random.default_rng(9)
        m, k = 23, 5
        pts = np.concatenate([rng.uniform(0.3, 1, (m, 1)),
                              rng.uniform(-1, 1, (m, 3))], -1).astype(
                                  np.float32)
        seed = rng.normal(size=m).astype(np.float32)
        t_start = rng.uniform(0, 0.3, m).astype(np.float32)
        feats = np.array(jfeatures(jnp.asarray(pts[:, 1:]), 1))
        want = jeval.fused_evaluate(jparams, jnp.asarray(pts),
                                    jnp.asarray(seed), k,
                                    t_start=jnp.asarray(t_start),
                                    feats=jnp.asarray(feats), method="rk4",
                                    interpret=True)
        t, ts = torch.as_tensor(pts[:, 0]), torch.as_tensor(t_start)
        u, _ = xnode_train.u_du_fwd_plain(
            net, ts[:, None], ((t - ts) / k)[:, None], torch.as_tensor(feats),
            no_tangents(m, net.F)[0], torch.as_tensor(seed),
            no_tangents(m, net.F)[1], k, "rk4")
        got = u[:, 0]
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


def test_d5_staged_copy_hand_count():
    # by columns, each padded to a multiple of four floats, then the bias:
    # lift 0 <20, 1> (1 + 1) * 20; lift 1-2 <20, 20> 2 * 21 * 20; field
    # 0's time and h columns <10, 21> 22 * 12; seven hidden <10, 10>
    # 7 * 11 * 12; field out <20, 10> 11 * 20; readout <1, 20> 21 * 4
    want = 40 + 840 + 264 + 924 + 220 + 84
    assert want == 2372
    cfg = SolverConfig()
    from xnode_wan_tpu_torch import init_xnode
    net = xnode_train.flat_net(init_xnode(cfg, device="cpu"))
    H, Hh, _, n_lift, n_field = net.dims()
    assert steppers.staged_floats(H, Hh, n_lift, n_field) == want
    # odd widths pad every column: H = 7 -> 8, Hh = 5 -> 8
    assert steppers.staged_floats(7, 5, 2, 2) == 2 * 8 + 8 * 8 + 9 * 8 \
        + 6 * 8 + 8 * 4


def test_nvcc_command_per_width_pair():
    libs = [_build.library_path("xnode_fwd", w) for w in ((20, 10), (24, 32))]
    assert libs[0] != libs[1]
    assert all(p.parent == _build.build_dir() for p in libs)
    assert libs[0].name == "libxnode_fwd_H20_Hh10.so"
    cmd = _build.nvcc_command("xnode_fwd", (24, 32), libs[1])
    assert cmd[0] == "nvcc" and cmd[-1] == str(_build.CSRC / "xnode_fwd.cu")
    assert "-DXN_H=24" in cmd and "-DXN_HH=32" in cmd
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "--use_fast_math" not in cmd
    grad = _build.nvcc_command("xnode_grad", None, "libxnode_grad.so")
    assert not any(a.startswith("-DXN_H") for a in grad)
    with pytest.raises(ValueError, match="width"):
        _build.nvcc_command("xnode_fwd", None, "lib.so")
    with pytest.raises(ValueError, match="width"):
        _build.library_path("xnode_grad", (20, 10))


def cuda_signature(source, symbol):
    text = (_build.CSRC / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)", text, re.S)
    assert m, f"{symbol} not found in {source}.cu"
    return [p.strip() for p in m.group(1).split(",")]


@pytest.mark.parametrize("kernel", [xnode_eval.KERNEL, xnode_train.KERNEL,
                                    xnode_eval.TILE_KERNEL,
                                    xnode_train.PATH_TILE_KERNEL],
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
                                    dict(u_hidden_hidden_dim=65)])
def test_caps_enforced(widths):
    from xnode_wan_tpu_torch import init_xnode
    net = xnode_train.flat_net(init_xnode(SolverConfig(**{**BASE, **widths}),
                                          device="cpu"))
    with pytest.raises(ValueError, match="cap"):
        net.check_caps()


@pytest.mark.parametrize("widths", [
    dict(u_hidden_dim=60, dim=70),
    dict(dim=100, fourier_features=1, u_hidden_dim=20,
         u_hidden_hidden_dim=10, u_layers=8),
    dict(dim=30, fourier_features=1, u_hidden_dim=48,
         u_hidden_hidden_dim=48, u_layers=8)],
    ids=["F70_H60", "2t", "2u"])
def test_register_kernel_takes_any_feature_width(widths):
    # the feature columns are applied once a path and staged nowhere, so
    # F + 1 + H past 128 (131, 321, 139) keeps #1/#2 in the register kernel
    from xnode_wan_tpu_torch import init_xnode
    net = xnode_train.flat_net(init_xnode(SolverConfig(**{**BASE, **widths}),
                                          device="cpu"))
    H, Hh, F, n_lift, n_field = net.dims()
    assert F + 1 + H > 128
    net.check_caps()
    assert steppers.register_fits(net.dims())
    for method in METHODS:
        route = xnode_train.kernel_route(net.dims(), 0, method)
        assert route.path == "registers" and route.path_tile is None


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


def test_kernel_variants_count_their_launches_together():
    # #1's register kernel and path-tile variant count as one kernel
    lv = xnode_eval.LAUNCHES
    kept = lv.by_variant()
    try:
        xnode_eval.KERNEL.launches, xnode_eval.TILE_KERNEL.launches = 2, 3
        assert lv.launches == 5
        assert lv.by_variant() == {"registers": 2, "tile": 3}
        lv.launches = 0
        assert lv.by_variant() == {"registers": 0, "tile": 0}
        with pytest.raises(ValueError, match="reset to 0"):
            lv.launches = 1
    finally:
        xnode_eval.KERNEL.launches = kept["registers"]
        xnode_eval.TILE_KERNEL.launches = kept["tile"]
    assert xnode_train.PATH_LAUNCHES.variants == {
        "registers": xnode_train.KERNEL,
        "tile": xnode_train.PATH_TILE_KERNEL}
    assert xnode_train.BWD_LAUNCHES.variants == {
        "shared": xnode_train.BWD_KERNEL,
        "cluster": xnode_train.BWD_CLUSTER_KERNEL,
        "global": xnode_train.BWD_GLOBAL_KERNEL}
