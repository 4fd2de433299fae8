"""The port's multistep, adaptive and VCABM integrators, remat and the
continuous adjoint against the JAX package, on shared numpy inputs in f64.

The integrators run on a smooth field (``tanh(h A) cos(3 t)``) with
masks, late ``t_start`` and a zero-width interval, at 1e-9. Remat changes
no value: its gradients equal those without it at 1e-12, and the XNODE's
u side, which carries its tangents through the integrator, equals
forward mode through the plain scan at 1e-12.

``apply_xnode`` with ``adams`` is held against JAX at the solver's own
tolerance, not at 1e-9: VCABM's startup steps are so short that its
high-order differences are roundoff, so a last-bit difference between the
two packages' fields (their matmuls and ``tanh``) moves the step sizes by
up to 1e-4 relative, and the solution by up to ``ode_rtol``, with every
accept and order decision the same.
"""

import dataclasses

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
from xnode_wan_tpu_torch.ops import weak_form as twf
from xnode_wan_tpu_torch.ops.sampling import PathBatch, _assemble

N, L, H = 7, 5, 3
BASE = dict(dim=3, N_t=6, N_r=8, N_b=8, u_hidden_dim=8,
            u_hidden_hidden_dim=8, u_layers=2, v_layers=2, v_hidden_dim=8,
            min_steps=3, shape_param=(-1.0, 1.0))


@pytest.fixture(autouse=True)
def x64():
    prior = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prior)


def grid(seed=0):
    """Sorted times, a 75% mask, a late ``t_start`` on path 0 (past most
    of its samples) and a zero-width interval on path 1."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(H, H))
    h0 = rng.normal(size=(N, H))
    t_start = rng.uniform(0, 0.3, N)
    t_start[0] = 0.8
    times = np.sort(rng.uniform(0, 1, (N, L)), axis=1)
    times[1, 2] = times[1, 1]
    mask = rng.uniform(size=(N, L)) < 0.75
    return A, h0, times, t_start, mask


def jfield(A):
    return lambda t, h: jnp.tanh(h @ jnp.asarray(A)) * jnp.cos(3 * t)[:, None]


def tfield(A):
    At = torch.as_tensor(A)
    return lambda t, h: torch.tanh(h @ At) * torch.cos(3 * t)[:, None]


def both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.as_tensor(a) for a in arrays])


def close(got, want, tol=1e-9):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got.detach()), want, rtol=tol,
                               atol=tol * max(np.nanmax(np.abs(want)), 1.0))


@pytest.mark.parametrize("n_sub", [1, 4])
@pytest.mark.parametrize("method", ["explicit_adams", "fixed_adams"])
def test_fixed_adams_match_jax(method, n_sub):
    A, *arrays = grid()
    j, t = both(arrays)
    want = jint.integrate(jfield(A), *j, n_sub=n_sub, method=method)
    close(tint.integrate(tfield(A), *t, n_sub=n_sub, method=method), want)


@pytest.mark.parametrize("method", list(tint.ADAPTIVE_METHODS))
def test_adaptive_match_jax(method):
    # two attempts an interval: one to all but one path of 7 exhaust them
    # and take the forced error-unchecked step; dopri5 and adams also with
    # the full budget, which every path meets
    A, *arrays = grid(1)
    j, t = both(arrays)
    for max_steps in (2, 16) if method in ("dopri5", "adams") else (2,):
        want = jint.integrate_adaptive(jfield(A), *j, max_steps=max_steps,
                                       method=method)
        got = tint.integrate_adaptive(tfield(A), *t, max_steps=max_steps,
                                      method=method)
        assert bool(torch.isfinite(got).all())
        close(got, want)


@pytest.mark.parametrize("method", ["dopri5", "adams"])
def test_strict_exhaustion_is_nan(method):
    A, *arrays = grid(2)
    j, t = both(arrays)
    want = np.asarray(jint.integrate_adaptive(
        jfield(A), *j, max_steps=1, strict=True, method=method))
    got = tint.integrate_adaptive(tfield(A), *t, max_steps=1, strict=True,
                                  method=method).numpy()
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    close(torch.as_tensor(np.nan_to_num(got)), np.nan_to_num(want))


def test_gamma_star_and_dop853_literals():
    assert tint._gamma_star(14) == jint._gamma_star(14)
    for name in ("_DOP853_C", "_DOP853_A", "_DOP853_B", "_DOP853_E5"):
        assert getattr(tint, name) == getattr(jint, name), name
    for method in tint.ADAPTIVE_METHODS[:-1]:
        assert tint._tableau(method) == jint._tableau(method), method


@pytest.mark.parametrize("method", ["midpoint", "fixed_adams", "dopri5",
                                    "adams"])
def test_remat_changes_no_gradient(method):
    # each sample interval checkpointed: same values, same gradients
    A, h0, times, t_start, mask = grid(3)
    Ap = torch.tensor(A, requires_grad=True)
    h0p = torch.tensor(h0, requires_grad=True)
    w = torch.as_tensor(np.random.default_rng(4).normal(size=(N, L, H)))

    def run(remat, closed):
        def field(t, h):
            return torch.tanh(h @ Ap) * torch.cos(3 * t)[:, None]
        args = (field, h0p, torch.as_tensor(times), torch.as_tensor(t_start),
                torch.as_tensor(mask))
        kw = dict(remat=remat, closed=closed, method=method)
        if method in tint.ADAPTIVE_METHODS:
            hs = tint.integrate_adaptive(*args, **kw)
        else:
            hs = tint.integrate(*args, n_sub=3, **kw)
        return hs, torch.autograd.grad((hs * w).sum(), (Ap, h0p))

    hs0, g0 = run(False, None)
    hs1, g1 = run(True, (Ap,))
    assert torch.equal(hs1, hs0)
    for a, b in zip(g1, g0):
        close(a, b.numpy(), 1e-12)
    # the recompute needs the tensors the field closes over
    with pytest.raises(ValueError, match="closed="):
        run(True, None)


def configs(**kw):
    return JConfig(**{**BASE, **kw}), SolverConfig(**{**BASE, **kw})


def shared(jcfg, seed=0):
    tree = jax.tree.map(lambda a: np.asarray(a, np.float64),
                        jx.init_xnode(jax.random.PRNGKey(seed), jcfg))
    return jax.tree.map(jnp.asarray, tree), params_from_jax(
        tree, device="cpu", dtype=torch.float64)


def path_batch(n, steps, d, seed=1):
    """Ragged masks, mixed t_start and h- or g-seeds."""
    rng = np.random.default_rng(seed)
    t_start = rng.uniform(0.0, 0.3, n)
    times = np.maximum(np.sort(rng.uniform(0.0, 1.0, (n, steps)), axis=1),
                       t_start[:, None])
    xs = rng.uniform(-1, 1, (n, d))
    x = np.concatenate([times[:, :, None],
                        np.broadcast_to(xs[:, None, :], (n, steps, d))], -1)
    arrays = [x, rng.uniform(size=(n, steps)) < 0.7, t_start,
              rng.uniform(size=n) < 0.5]
    return (jsampling.PathBatch(*map(jnp.asarray, arrays)),
            PathBatch(*map(torch.as_tensor, arrays)))


def grads(params):
    return [p.grad.numpy() for layer in [*params.lift, *params.field,
                                         params.readout]
            for p in (layer.weight, layer.bias)]


def jgrads(tree):
    return [np.asarray(a).T if k == "w" else np.asarray(a)
            for layer in [*tree["lift"], *tree["field"], tree["readout"]]
            for k, a in sorted(layer.items(), key=lambda kv: kv[0] != "w")]


@pytest.mark.parametrize("solver,tol", [("dopri5", 1e-9), ("adams", 1e-5)])
def test_apply_xnode_matches_jax(solver, tol):
    jcfg, tcfg = configs(solver=solver)
    jp, tp = jload_problem("cube_pde"), load_problem("cube_pde")
    jparams, tparams = shared(jcfg)
    jb, tb = path_batch(12, 6, 3)
    w = np.random.default_rng(2).normal(size=(12, 6))

    def loss(p):
        u = jx.apply_xnode(p, jb, jp, jcfg)
        return jnp.sum(u * w), u

    (_, want), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(jparams)
    u = tx.apply_xnode(tparams, tb, tp, tcfg)
    close(u, want, tol)
    (u * torch.as_tensor(w)).sum().backward()
    for g, gw in zip(grads(tparams), jgrads(jg)):
        close(torch.as_tensor(g), gw, 100 * tol)


@pytest.mark.parametrize("solver", ["midpoint", "fixed_adams", "dopri5",
                                    "adams"])
def test_u_side_under_remat_matches_forward_mode(solver):
    # the XNODE's u side carries its tangents through the integrator, each
    # interval checkpointed under remat_scan (the default); the reference
    # is one torch.func.jvp a direction through the plain scan
    _, tcfg = configs(solver=solver)
    _, tparams = shared(configs()[0], seed=3)
    _, tb = path_batch(10, 6, 3, seed=5)
    tp = load_problem("cube_pde")
    xs0 = tb.space[:, 0, :]

    def u_of(xs):
        b = dataclasses.replace(tb, x=_assemble(tb.times, xs))
        return tx.apply_xnode(tparams, b, tp, tcfg.replace(remat_scan=False))

    u0, du0 = torch.func.vmap(
        lambda e: torch.func.jvp(u_of, (xs0,), (e.expand_as(xs0),)),
        out_dims=(None, 0))(torch.eye(3, dtype=torch.float64))
    du0 = torch.movedim(du0, 0, -1)
    u1, du1 = twf.u_with_spatial_grad(tx.apply_xnode, tparams, tb, tp, tcfg)
    w = torch.as_tensor(np.random.default_rng(6).normal(size=(10, 6, 3)))
    leaves = list(tparams.parameters())
    g1 = torch.autograd.grad((du1 * w).sum() + (u1 * u1).sum(), leaves)
    g0 = torch.autograd.grad((du0 * w).sum() + (u0 * u0).sum(), leaves)
    assert torch.equal(u1, u0)
    close(du1, du0.detach().numpy(), 1e-12)
    for a, b in zip(g1, g0):
        close(a, b.numpy(), 1e-12)


@pytest.mark.parametrize("solver", ["midpoint", "rk4"])
def test_adjoint_matches_jax(solver):
    jcfg, tcfg = configs(solver=solver, min_steps=6)
    jp, tp = jload_problem("cube_pde"), load_problem("cube_pde")
    jparams, tparams = shared(jcfg, seed=4)
    jb, tb = path_batch(12, 6, 3, seed=7)
    w = np.random.default_rng(8).normal(size=(12, 6))
    want, jg = jax.jit(jax.value_and_grad(lambda p: jnp.sum(
        jx.apply_xnode_adjoint(p, jb, jp, jcfg) * w)))(jparams)
    u = tx.apply_xnode_adjoint(tparams, tb, tp, tcfg)
    # the forward is the scan's without remat, value for value
    assert torch.equal(u, tx.apply_xnode(tparams, tb, tp,
                                         tcfg.replace(remat_scan=False)))
    loss = (u * torch.as_tensor(w)).sum()
    close(loss, want)
    loss.backward()
    for g, gw in zip(grads(tparams), jgrads(jg)):
        close(torch.as_tensor(g), gw)


def test_adjoint_raises_on_time_gradients():
    _, tcfg = configs()
    _, tparams = shared(configs()[0])
    _, tb = path_batch(4, 6, 3)
    tp = load_problem("cube_pde")
    with pytest.raises(ValueError, match="adaptive|fixed-step"):
        tx.apply_xnode_adjoint(tparams, tb, tp, tcfg.replace(solver="dopri5"))
    x = tb.x.clone().requires_grad_(True)   # the times come from x
    with pytest.raises(ValueError, match="sample times or t_start"):
        tx.apply_xnode_adjoint(tparams, dataclasses.replace(tb, x=x), tp,
                               tcfg)
    t_start = tb.t_start.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="sample times or t_start"):
        tx.apply_xnode_adjoint(
            tparams, dataclasses.replace(tb, t_start=t_start), tp, tcfg)
