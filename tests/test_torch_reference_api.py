"""The reference's solver surface in the port, against the JAX package's:
``from_reference`` (``params``, ``p``, ``func_u_sol``), ``u_net`` with the
same weights (f64, 1e-9), a reference-style ``stop(solver, points,
domain)`` (JAX ``tests/test_training.py:85``, ``:122``), ``fillt`` bit for
bit, and ``CombLoader`` by property."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xnode_wan_tpu.ops import sampling as jsampling
from xnode_wan_tpu.training import NODEWANSolver as JSolver
from xnode_wan_tpu_torch import (CombLoader, NODEWANSolver, fillt,
                                 make_domain, params_from_jax)
from xnode_wan_tpu_torch.ops.sampling import PathBatch

SMALL = dict(dim=2, N_t=6, N_r=24, N_b=16, u_hidden_dim=8,
             u_hidden_hidden_dim=8, u_layers=2, v_layers=3, v_hidden_dim=12,
             alpha=1e4, shape_param=(-1.0, 1.0), min_steps=4, seed=1,
             iterations=20)


def reference_funcs(xp):
    """The reference's Ex4_1-style entrywise callables over ``xp`` (jnp or
    torch)."""
    def func_a(X, i, j):
        return (xp.ones if i == j else xp.zeros)(X.shape[:-1],
                                                 dtype=X.dtype)

    def func_b(X, i):
        return xp.zeros(X.shape[:-1], dtype=X.dtype)

    def func_c(X, u):
        return -u

    def func_u_sol(X):
        return (2 * xp.sin(math.pi / 2 * X[..., 1])
                * xp.cos(math.pi / 2 * X[..., 2]) * xp.exp(-X[..., 0]))

    def func_f(X):
        sc = xp.sin(math.pi / 2 * X[..., 1]) * xp.cos(math.pi / 2 * X[..., 2])
        return ((math.pi ** 2 - 2) * sc * xp.exp(-X[..., 0])
                - 4 * sc ** 2 * xp.exp(-2 * X[..., 0]))

    def func_h(X):
        return (2 * xp.sin(math.pi / 2 * X[..., 1])
                * xp.cos(math.pi / 2 * X[..., 2]))

    return func_a, func_b, func_c, func_h, func_f, func_u_sol, func_u_sol


def test_from_reference_matches_jax(tmp_path):
    prior = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        params = dict(SMALL, x64=True)
        jfuncs, tfuncs = reference_funcs(jnp), reference_funcs(torch)
        js = JSolver.from_reference(params, *jfuncs[:6], device=None,
                                    path=str(tmp_path / "jax"),
                                    func_u_sol=jfuncs[6], p=2)
        ts = NODEWANSolver.from_reference(params, *tfuncs[:6], device="cpu",
                                          path=str(tmp_path / "torch"),
                                          func_u_sol=tfuncs[6], p=2)
        assert ts.params == js.params and ts.p == js.p == 2
        assert ts.func_u_sol is tfuncs[6] and js.func_u_sol is jfuncs[6]
        assert ts.problem.a_kind == "full" and ts.device.type == "cpu"
        tree = jax.tree.map(np.asarray, js.state.u_params)
        ts.members[0].u_params = params_from_jax(tree, device="cpu",
                                                 dtype=torch.float64)
        rng = np.random.default_rng(0)
        n, L = 9, 6
        times = np.sort(rng.uniform(0, 1, L))
        x = np.concatenate(
            [np.broadcast_to(times[None, :, None], (n, L, 1)),
             np.broadcast_to(rng.uniform(-1, 1, (n, 1, 2)), (n, L, 2))], -1)
        arrays = [np.ascontiguousarray(x), np.ones((n, L), bool),
                  np.zeros(n), np.ones(n, bool)]
        want = js.u_net(jsampling.PathBatch(*map(jnp.asarray, arrays)))
        got = ts.u_net(PathBatch(*map(torch.as_tensor, arrays)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                                   atol=1e-9)
        # the problem's callables agree at the batch
        np.testing.assert_allclose(
            ts.problem.f(torch.as_tensor(arrays[0])).numpy(),
            np.asarray(js.problem.f(jnp.asarray(arrays[0]))), rtol=1e-12)
    finally:
        jax.config.update("jax_enable_x64", prior)


def test_l_norm_reference_api_matches_jax(tmp_path):
    # the reference-signature L^p norm (error and solution) on the same
    # weights and a masked batch, f64 to 1e-9
    from xnode_wan_tpu.utils.metrics import l_norm_reference_api as jl_norm
    from xnode_wan_tpu_torch.utils.metrics import l_norm_reference_api
    prior = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        params = dict(SMALL, x64=True)
        jfuncs, tfuncs = reference_funcs(jnp), reference_funcs(torch)
        js = JSolver.from_reference(params, *jfuncs[:6], device=None,
                                    path=str(tmp_path / "jax"),
                                    func_u_sol=jfuncs[6], p=2)
        ts = NODEWANSolver.from_reference(params, *tfuncs[:6], device="cpu",
                                          path=str(tmp_path / "torch"),
                                          func_u_sol=tfuncs[6], p=2)
        tree = jax.tree.map(np.asarray, js.state.u_params)
        ts.members[0].u_params = params_from_jax(tree, device="cpu",
                                                 dtype=torch.float64)
        rng = np.random.default_rng(1)
        n, L = 11, 6
        times = np.sort(rng.uniform(0, 1, (n, L)), axis=1)
        x = np.concatenate(
            [times[:, :, None],
             np.broadcast_to(rng.uniform(-1, 1, (n, 1, 2)), (n, L, 2))], -1)
        arrays = [np.ascontiguousarray(x), rng.uniform(size=(n, L)) < 0.7,
                  np.zeros(n), np.ones(n, bool)]
        jb = jsampling.PathBatch(*map(jnp.asarray, arrays))
        tb = PathBatch(*map(torch.as_tensor, arrays))
        for error in (True, False):
            want = jl_norm(jb, js.u_net, 2, js.func_u_sol, 4.0, n,
                           error=error)
            got = l_norm_reference_api(tb, ts.u_net, 2, ts.func_u_sol, 4.0,
                                       n, error=error)
            assert got.dtype == torch.float64
            np.testing.assert_allclose(float(got), float(want), rtol=1e-9)
    finally:
        jax.config.update("jax_enable_x64", prior)


def test_reference_stop_gets_fresh_points_and_stops_there(tmp_path):
    seen = []

    def stop(solver, points, domain):
        u = solver.u_net(points)
        sol = solver.func_u_sol(points.x)
        rel = float(torch.linalg.norm(u - sol) / torch.linalg.norm(sol))
        seen.append((points.x.shape[0], float(points.x.mean()), rel,
                     domain is solver.domain, solver.params["N_r"]))
        return len(seen) >= 3 and rel < 10.0

    funcs = reference_funcs(torch)
    s = NODEWANSolver.from_reference(SMALL, *funcs[:6], device="cpu",
                                     path=str(tmp_path), stop=stop,
                                     func_u_sol=funcs[6], p=2)
    s.train(report=False)
    assert len(seen) == 3 and s.state.step == 3
    assert all(n == SMALL["N_r"] == n_r and same for n, _, _, same, n_r
               in seen)
    # a fresh draw each call
    assert len({mean for _, mean, _, _, _ in seen}) == 3
    # the callback saw each iteration's weights: one at a time under it
    rels = [rel for _, _, rel, _, _ in seen]
    assert len(set(rels)) == 3


@pytest.mark.parametrize("entry", ["train_chunked", "train_chunk_4"])
def test_reference_stop_stops_chunked_runs_where_one_at_a_time_does(
        tmp_path, entry):
    # the adapted stop reads the solver, so a chunked entry point must
    # show it each iteration's state, not the chunk's last
    def stop(solver, points, domain):
        return solver.state.step >= 6

    funcs = reference_funcs(torch)
    runs = {}
    for name in ("one", entry):
        s = NODEWANSolver.from_reference(SMALL, *funcs[:6], device="cpu",
                                         path=str(tmp_path / name), stop=stop,
                                         func_u_sol=funcs[6], p=2)
        if name == "one":
            s.train(chunk=1)
        elif name == "train_chunked":
            s.train_chunked(SMALL["iterations"], chunk=4)
        else:
            s.train(chunk=4)
        runs[name] = s
    assert runs["one"].state.step == runs[entry].state.step == 6
    a = torch.load(tmp_path / "one" / "checkpoint_NODE.pt", weights_only=True)
    b = torch.load(tmp_path / entry / "checkpoint_NODE.pt", weights_only=True)
    assert str(a) == str(b)   # every tensor, number and key


def test_fillt_bit_for_bit_against_jax():
    # JAX computes the grid in float64 and rounds it once to its dtype;
    # under float32 its own h + 1e-9 assertion can fail on that rounding
    # alone, so the float32 grid is held against JAX's float64 one rounded
    prior = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    rng = np.random.default_rng(3)
    try:
        for _ in range(6):
            t = np.sort(rng.uniform(0.0, 1.0, rng.integers(2, 9)))
            t[0], t[-1] = 0.0, 1.0
            for dtype in (np.float64, np.float32):
                td = t.astype(dtype)
                jidx, jfilled = jsampling.fillt(jnp.asarray(td, np.float64),
                                                1.0, 0.0, min_steps=7)
                assert np.asarray(jfilled).size > t.size   # gaps above h
                idx, filled = fillt(torch.as_tensor(td), 1.0, 0.0,
                                    min_steps=7)
                np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
                np.testing.assert_array_equal(
                    filled.numpy(), np.asarray(jfilled).astype(dtype))
    finally:
        jax.config.update("jax_enable_x64", prior)


@pytest.mark.parametrize("domain,shape", [("Hypercube", (-1.0, 1.0)),
                                          ("NSphere_THourglass", 1.0)])
@pytest.mark.parametrize("independent_uv", [False, True])
def test_comb_loader(domain, shape, independent_uv):
    dom = make_domain(domain, shape, 3, 0.0, 1.0, 5)
    gen = torch.Generator().manual_seed(0)
    loader = CombLoader(12, 7, dom, gen, independent_uv=independent_uv)
    assert len(loader) == 1
    with pytest.raises(IndexError):
        loader[1]
    u, v, b = loader[0]
    rows = dom.interior_rows(12)
    assert u.x.shape == v.x.shape == (rows, 5, 4) and b.x.shape[0] == 7
    assert (v is u) != independent_uv
    if independent_uv:
        assert not torch.equal(u.x, v.x)
    # the trainer's order of draws: interior, boundary, then the v cloud
    gen = torch.Generator().manual_seed(0)
    torch.testing.assert_close(dom.interior(gen, 12).x, u.x, rtol=0, atol=0)
    torch.testing.assert_close(dom.boundary(gen, 7).x, b.x, rtol=0, atol=0)
