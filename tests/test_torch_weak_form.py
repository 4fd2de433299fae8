"""The weak form of the port against the JAX package on shared inputs and
weights: the discriminator, the coefficient contractions, the loss terms,
and ``loss_u`` / ``loss_v`` with their parameter gradients.

Tolerances: 1e-9 relative in f64, where both sides take forward mode
through the masked scan (``u_with_spatial_grad``); 1e-5 relative (values)
and 1e-4 (gradients, summed over every sample) in f32, where the port
takes the plain versions of the fused kernels and the JAX package on the
CPU its XLA route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xnode_wan_tpu.config import SolverConfig as JConfig
from xnode_wan_tpu.models import discriminator as jdisc
from xnode_wan_tpu.models import xnode as jx
from xnode_wan_tpu.ops import coefficients as jcoef
from xnode_wan_tpu.ops import weak_form as jwf
from xnode_wan_tpu.ops.sampling import PathBatch as JPathBatch
from xnode_wan_tpu.ops.sampling import make_domain
from xnode_wan_tpu.problems import from_reference_callables as jfrom_ref
from xnode_wan_tpu.problems import load_problem as jload_problem
from xnode_wan_tpu_torch import (SolverConfig, disc_params_from_jax,
                                 load_problem, params_from_jax)
from xnode_wan_tpu_torch.models import discriminator as tdisc
from xnode_wan_tpu_torch.models.xnode import apply_xnode
from xnode_wan_tpu_torch.ops import coefficients as tcoef
from xnode_wan_tpu_torch.ops import weak_form as twf
from xnode_wan_tpu_torch.ops.sampling import Hypercube, PathBatch
from xnode_wan_tpu_torch.problems import from_reference_callables

SMALL = dict(dim=2, N_t=6, N_r=24, N_b=16, u_hidden_dim=8,
             u_hidden_hidden_dim=8, u_layers=2, v_layers=3, v_hidden_dim=12,
             alpha=1e4, shape_param=(-1.0, 1.0), min_steps=3)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def disc_pair(seed, dim, hidden, layers, tied, n_freq, dtype):
    tree = np_tree(jdisc.init_discriminator(
        jax.random.PRNGKey(seed), dim, hidden, layers, tied, n_freq,
        dtype=jnp.float64 if dtype == torch.float64 else jnp.float32))
    rng = np.random.default_rng(seed)
    for layer in jax.tree.leaves(tree, is_leaf=lambda x: "b" in x):
        layer["b"] = (0.1 * rng.normal(size=layer["b"].shape)).astype(
            layer["w"].dtype)
    return (jax.tree.map(jnp.asarray, tree),
            disc_params_from_jax(tree, "cpu", dtype))


@pytest.mark.parametrize("tied,n_freq", [(True, 0), (False, 0), (True, 1)])
def test_discriminator_values_and_input_grads(x64, tied, n_freq):
    jp, tp = disc_pair(0, 3, 10, 4, tied, n_freq, torch.float64)
    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.uniform(0, 1, (30, 1)),
                          rng.uniform(-1, 1, (30, 3))], axis=-1)

    def jv(p):
        return jdisc.apply_discriminator(jp, p, 4, tied, n_freq)

    want = jv(jnp.asarray(pts))
    want_grad = jax.vmap(jax.grad(jv))(jnp.asarray(pts))
    x = torch.as_tensor(pts).requires_grad_(True)
    got = tdisc.apply_discriminator(tp, x, 4, tied, n_freq)
    (got_grad,) = torch.autograd.grad(got.sum(), x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad),
                               rtol=1e-9, atol=1e-12)


def test_init_discriminator_shapes_and_tied_layer():
    d = tdisc.init_discriminator(5, 50, 9, tied=True, device="cpu")
    assert isinstance(d.hidden, torch.nn.Linear)
    assert d.inp.weight.shape == (50, 6) and d.out.weight.shape == (1, 50)
    assert sum(p.numel() for p in d.parameters()) == (6 * 50 + 50) + (
        50 * 50 + 50) + (50 + 1)
    untied = tdisc.init_discriminator(2, 8, 3, tied=False, n_freq=1,
                                      device="cpu")
    assert len(untied.hidden) == 3 and untied.inp.weight.shape == (8, 7)


def _a_iso(X):
    return 1.0 + X[..., 0]


def _a_diag(X):
    return 1.0 + X[..., 1:] ** 2


@pytest.mark.parametrize("kind", ["zero", "isotropic", "diagonal", "full"])
def test_coefficient_contractions(x64, kind):
    rng = np.random.default_rng(2)
    X = rng.uniform(-1, 1, (7, 5, 4))
    dphi, du = rng.normal(size=(7, 5, 3)), rng.normal(size=(7, 5, 3))
    phi = rng.normal(size=(7, 5))
    A = rng.normal(size=(3, 3))
    a = {"zero": None, "isotropic": _a_iso, "diagonal": _a_diag,
         "full": lambda X: X[..., 1:2, None] * A}[kind]

    class P:
        a_kind = kind

    def b(X):
        return X[..., 1:] * 2.0

    jprob, tprob = P(), P()
    jprob.a, tprob.a = a, a
    jprob.b, tprob.b = b, b
    T = torch.as_tensor
    got = tcoef.diffusion_term(tprob, T(X), T(dphi), T(du))
    want = jcoef.diffusion_term(jprob, jnp.asarray(X), jnp.asarray(dphi),
                                jnp.asarray(du))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    got = tcoef.drift_term(tprob, T(X), T(phi), T(du))
    want = jcoef.drift_term(jprob, jnp.asarray(X), jnp.asarray(phi),
                            jnp.asarray(du))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_coefficients_from_entries(x64):
    def func_a(X, i, j):
        return X[..., 0] * (i + 1) + (j == i)

    def func_b(X, i):
        return X[..., i + 1] * 0.5

    X = np.random.default_rng(3).uniform(-1, 1, (4, 6, 3))
    for t_fn, j_fn in ((tcoef.full_a_from_entries(func_a, 2),
                        jcoef.full_a_from_entries(func_a, 2)),
                       (tcoef.b_from_entries(func_b, 2),
                        jcoef.b_from_entries(func_b, 2))):
        np.testing.assert_allclose(t_fn(torch.as_tensor(X)).numpy(),
                                   np.asarray(j_fn(jnp.asarray(X))),
                                   rtol=1e-12)
    assert tcoef.b_from_entries(None, 2) is None
    tp = from_reference_callables(func_a, func_b, lambda X, u: -u,
                                  lambda X: X[..., 1], lambda X: X[..., 0],
                                  lambda X: X[..., 2], dim=2)
    jp = jfrom_ref(func_a, func_b, lambda X, u: -u, lambda X: X[..., 1],
                   lambda X: X[..., 0], lambda X: X[..., 2], dim=2)
    assert tp.a_kind == jp.a_kind == "full" and tp.dim == 2


def batch_arrays(n, L, d, seed, masked=False, boundary=False):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0, 1, L))
    times[0], times[-1] = 0.0, 1.0
    xs = rng.uniform(-1, 1, (n, d))
    if boundary:
        face = np.arange(n) % (2 * d)
        xs[np.arange(n), face // 2] = np.where(face % 2 == 0, 1.0, -1.0)
    x = np.concatenate([np.broadcast_to(times[None, :, None], (n, L, 1)),
                        np.broadcast_to(xs[:, None], (n, L, d))], axis=-1)
    mask = (rng.uniform(size=(n, L)) < 0.7 if masked
            else np.ones((n, L), bool))
    from_h = rng.uniform(size=n) < (0.6 if masked else 2.0)
    return [np.ascontiguousarray(x), mask, np.zeros(n), from_h]


def pair(arrays, dtype):
    a = [arrays[0].astype(dtype), arrays[1], arrays[2].astype(dtype),
         arrays[3]]
    return (JPathBatch(*map(jnp.asarray, a)), PathBatch(*map(torch.as_tensor,
                                                             a)))


@pytest.mark.parametrize("s1_raw_v", [False, True])
def test_loss_terms_match_jax(x64, s1_raw_v):
    n, L, d = 20, 6, 2
    jb, tb = pair(batch_arrays(n, L, d, 4, masked=True), np.float64)
    rng = np.random.default_rng(5)
    u, v, phi = (rng.normal(size=(n, L)) for _ in range(3))
    du, dphi = rng.normal(size=(n, L, d)), rng.normal(size=(n, L, d + 1))
    jp, tp = jload_problem("cube_pde"), load_problem("cube_pde")
    jdom = make_domain("Hypercube", (-1.0, 1.0), d, 0.0, 1.0, L, x64=True)
    tdom = Hypercube((-1.0, 1.0), d, 0.0, 1.0, L, x64=True)
    J, T = jnp.asarray, torch.as_tensor
    want = jwf.interior_terms(J(u), J(du), J(v), J(phi), J(dphi), jb, jp,
                              jdom, s1_raw_v=s1_raw_v)
    got = twf.interior_terms(T(u), T(du), T(v), T(phi), T(dphi), tb, tp,
                             tdom, s1_raw_v=s1_raw_v)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-12)
    for all_rows in (False, True):
        np.testing.assert_allclose(
            float(twf.init_loss(T(u), tb, tp, all_rows=all_rows)),
            float(jwf.init_loss(J(u), jb, jp, all_rows=all_rows)), rtol=1e-12)
    for at_exit in (False, True):
        np.testing.assert_allclose(
            float(twf.bdry_from_values(T(u), tb, tp, at_exit=at_exit)),
            float(jwf.bdry_from_values(J(u), jb, jp, at_exit=at_exit)),
            rtol=1e-12)
    first, last, valid = twf._endpoint_indices(tb.mask)
    jfirst, jlast, jvalid = jwf._endpoint_indices(jb.mask)
    np.testing.assert_array_equal(first.numpy(), np.asarray(jfirst))
    np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


def test_bdry_loss_through_scan_matches_jax(x64):
    cfg = dict(SMALL, x64=True)
    jcfg, tcfg = JConfig(**cfg), SolverConfig(**cfg)
    tree = np_tree(jx.init_xnode(jax.random.PRNGKey(6), jcfg))
    jb, tb = pair(batch_arrays(16, 6, 2, 7, boundary=True), np.float64)
    jp, tp = jload_problem("cube_pde"), load_problem("cube_pde")
    tparams = params_from_jax(tree, "cpu", torch.float64)
    want = jwf.bdry_loss(jx.apply_xnode, jax.tree.map(jnp.asarray, tree), jb,
                         jp, jcfg)
    got = twf.bdry_loss(apply_xnode, tparams, tb, tp, tcfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-9)


def both_losses(dtype, seed):
    """The two packages' loss builders on one batch with one set of
    weights."""
    cfg = dict(SMALL, x64=dtype == np.float64)
    jcfg, tcfg = JConfig(**cfg), SolverConfig(**cfg)
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    u_tree = np_tree(jx.init_xnode(jax.random.PRNGKey(seed), jcfg))
    v_tree = np_tree(jdisc.init_discriminator(
        jax.random.PRNGKey(seed + 1), 2, 12, 3, dtype=jdt))
    jp, tp = jload_problem("cube_pde", 2), load_problem("cube_pde", 2)
    jdom = make_domain("Hypercube", (-1.0, 1.0), 2, 0.0, 1.0, 6,
                       x64=dtype == np.float64)
    tdom = Hypercube((-1.0, 1.0), 2, 0.0, 1.0, 6, x64=dtype == np.float64)

    def jv_apply(p, pts):
        return jdisc.apply_discriminator(p, pts, 3, True, 0)

    def tv_apply(p, pts):
        return tdisc.apply_discriminator(p, pts, 3, True, 0)

    jl = jwf.make_losses(jp, jdom, jcfg, jx.apply_xnode, jv_apply)
    tl = twf.make_losses(tp, tdom, tcfg, apply_xnode, tv_apply)
    jb, tb = pair(batch_arrays(24, 6, 2, seed + 2), dtype)
    jbb, tbb = pair(batch_arrays(16, 6, 2, seed + 3, boundary=True), dtype)
    return dict(jl=jl, tl=tl, jb=jb, tb=tb, jbb=jbb, tbb=tbb,
                ju=jax.tree.map(jnp.asarray, u_tree),
                jv=jax.tree.map(jnp.asarray, v_tree),
                tu=params_from_jax(u_tree, "cpu", tdt),
                tv=disc_params_from_jax(v_tree, "cpu", tdt))


def check_losses(s, rtol_value, rtol_grad):
    jl, tl = s["jl"], s["tl"]
    (jval, jaux), jgu = jax.value_and_grad(
        lambda p: jl.loss_u(p, s["jv"], s["jb"], s["jbb"]), has_aux=True)(
            s["ju"])
    tval, taux = tl.loss_u(s["tu"], s["tv"], s["tb"], s["tbb"])
    tval.backward()
    np.testing.assert_allclose(float(tval), float(jval), rtol=rtol_value)
    for k in ("I", "norm", "int", "init", "bdry"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=rtol_value, atol=1e-12)
    for tl_, jl_ in zip([*s["tu"].lift, *s["tu"].field, s["tu"].readout],
                        [*jgu["lift"], *jgu["field"], jgu["readout"]]):
        for g, w in ((tl_.weight.grad.numpy(), np.asarray(jl_["w"]).T),
                     (tl_.bias.grad.numpy(), np.asarray(jl_["b"]))):
            np.testing.assert_allclose(g, w, rtol=rtol_grad,
                                       atol=rtol_grad * np.abs(w).max())

    (jval, _), jgv = jax.value_and_grad(
        lambda p: jl.loss_v(p, s["ju"], s["jb"]), has_aux=True)(s["jv"])
    for p in s["tv"].parameters():
        p.grad = None
    tval, _ = tl.loss_v(s["tv"], s["tu"], s["tb"])
    tval.backward()
    np.testing.assert_allclose(float(tval), float(jval), rtol=rtol_value)
    for name in ("inp", "hidden", "out"):
        layer = getattr(s["tv"], name)
        for g, w in ((layer.weight.grad.numpy(), np.asarray(jgv[name]["w"]).T),
                     (layer.bias.grad.numpy(), np.asarray(jgv[name]["b"]))):
            np.testing.assert_allclose(g, w, rtol=rtol_grad,
                                       atol=rtol_grad * np.abs(w).max())


def test_losses_and_grads_match_jax_f64(x64):
    # both sides: forward mode through the masked scan
    s = both_losses(np.float64, 8)
    assert not twf.fused_gate(SolverConfig(**dict(SMALL, x64=True)))
    check_losses(s, 1e-9, 1e-9)


def test_losses_and_grads_match_jax_f32_fused_plain():
    # the port: the fused kernels' plain versions and the hand-derived
    # adjoint; the JAX package on the CPU: its XLA route
    s = both_losses(np.float32, 9)
    assert twf.fused_gate(SolverConfig(**SMALL))
    with jax.default_matmul_precision("highest"):
        check_losses(s, 1e-5, 1e-4)


def test_u_side_routes_agree_f32():
    # fused (plain versions) and forward mode through the scan, one batch
    s = both_losses(np.float32, 10)
    cfg = SolverConfig(**SMALL)
    u0, du0 = twf.u_with_spatial_grad(apply_xnode, s["tu"], s["tb"],
                                      load_problem("cube_pde"), cfg)
    u1, du1 = s["tl"].u_side(s["tu"], s["tb"])
    torch.testing.assert_close(u1, u0, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(du1, du0, rtol=2e-4, atol=2e-5)


def test_fused_gate_exclusions():
    base = SolverConfig(**SMALL)
    assert twf.fused_gate(base)
    for kw in (dict(x64=True), dict(fused_grad=False), dict(solver="dopri5"),
               dict(solver="fixed_adams"), dict(primal="wan"),
               dict(ensemble=2)):
        assert not twf.fused_gate(base.replace(**kw)), kw

