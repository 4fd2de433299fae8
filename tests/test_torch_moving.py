"""The moving domains of the port (the shrinking cone and the hourglass)
against the JAX package: the samplers, the per-exit-group objective, the
losses with their gradients, the u side, serving, one outer step, and the
command line on the shipped configs.

Torch and JAX generators draw different numbers from one seed, so the
samplers are held to the properties of ``tests/test_sampling.py``, not to
bits. Everything else takes the same numpy inputs in both packages:

- the samplers' deterministic pieces (``func_w``, ``entry``, ``V``,
  ``radius_at``, ``_anchored_paths``): 1e-12 in f64;
- ``grouped_interior_objective``: 1e-9 in f64; on the hypercube it equals
  the pooled objective to 1e-12;
- ``loss_u`` / ``loss_v`` and their parameter gradients on a batch drawn by
  the JAX hourglass sampler: 1e-9 in f64 (both sides take forward mode
  through the masked scan); in f32, where the port takes the plain
  versions of the fused kernels and the JAX package its XLA route, 1e-5
  on values and 1e-4 on gradients, as
  ``tests/test_torch_weak_form.py::test_losses_and_grads_match_jax_f32_fused_plain``;
- the plain versions of kernels #3/#4 and #5 on that batch against JAX's
  ``u_with_spatial_grad`` and its gradient: 1e-9 in f64;
- ``evaluate_points`` with the hourglass domain: 1e-9 in f64, ``rtol=2e-4,
  atol=2e-5`` in f32 through the serving kernel's plain version;
- one f64 outer step on the hourglass: metrics, parameters and Adam
  moments at 1e-9.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from xnode_wan_tpu.config import SolverConfig as JConfig
from xnode_wan_tpu.models import discriminator as jdisc
from xnode_wan_tpu.models import xnode as jx
from xnode_wan_tpu.ops import sampling as js
from xnode_wan_tpu.ops import weak_form as jwf
from xnode_wan_tpu.problems import load_problem as jload_problem
from xnode_wan_tpu.training import NODEWANSolver as JSolver
from xnode_wan_tpu_torch import (NODEWANSolver, SolverConfig,
                                 disc_params_from_jax, load_problem,
                                 params_from_jax)
from xnode_wan_tpu_torch.main import main
from xnode_wan_tpu_torch.models import discriminator as tdisc
from xnode_wan_tpu_torch.models import xnode as tx
from xnode_wan_tpu_torch.ops import sampling as ts
from xnode_wan_tpu_torch.ops import weak_form as twf
from xnode_wan_tpu_torch.ops.kernels import xnode_train
from xnode_wan_tpu_torch.ops.kernels.steppers import FlatNet
from xnode_wan_tpu_torch.utils.torch_compat import state_from_jax

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
NAMES = ["NSphere_TCone", "NSphere_THourglass"]
# the d=2 hourglass net of the loss, u-side and outer-step checks
SMALL = dict(dim=2, N_t=5, N_r=16, N_b=8, u_hidden_dim=6,
             u_hidden_hidden_dim=5, u_layers=2, v_layers=3, v_hidden_dim=8,
             alpha=1e4, shape_param=1.0, min_steps=3,
             domain="NSphere_THourglass")


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.fixture
def x64():
    prior = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prior)


@pytest.fixture
def cone():
    return ts.NSphereTCone(1.0, dim=3, T0=0.0, T=1.0, N_t=12)


@pytest.fixture
def hourglass():
    return ts.NSphereTHourglass(1.0, dim=2, T0=0.0, T=1.0, N_t=16)


# -- the samplers' properties ------------------------------------------------

def test_ball_stays_off_the_origin():
    x = ts._ball(gen(), 4096, 1, 1.0)
    assert float(x.abs().min()) >= 1e-6 and float(x.abs().max()) <= 1.0
    dirs = ts._unit_sphere(gen(1), 64, 3, dtype=torch.float64)
    np.testing.assert_allclose(torch.linalg.norm(dirs, dim=-1).numpy(), 1.0,
                               rtol=1e-12)


def test_cone_interior_mask_matches_geometry(cone):
    b = cone.interior(gen(), 256)
    assert b.x.shape == (256, 12, 4) and b.x.dtype == torch.float32
    w = cone.func_w(b.x).numpy()
    m = b.mask.numpy()
    # valid samples strictly inside, invalid ones outside or on the boundary
    assert (w[m] > 0).all()
    assert (w[~m] <= 1e-5).all()
    assert m[:, 0].all() and not m.all()
    assert bool(b.seed_from_h.all()) and bool((b.t_start == 0).all())


@pytest.mark.parametrize("name", NAMES)
def test_volume_monte_carlo(name):
    d = 3 if name == "NSphere_TCone" else 2
    dom = ts.make_domain(name, 1.0, d, 0.0, 1.0, 8)
    rng = np.random.default_rng(0)
    n = 40000
    x = rng.uniform(-1.0, 1.0, (n, d))
    t = rng.uniform(0.0, 1.0, n)
    pts = torch.as_tensor(np.concatenate([t[:, None], x], axis=-1))
    est = float((dom.func_w(pts) > 0).double().mean()) * 2.0 ** d
    assert est == pytest.approx(dom.V(), rel=0.05)


def test_cone_boundary_on_surface(cone):
    pts = dataclasses.replace(cone, path_boundary=False)
    b = pts.boundary(gen(), 512)
    assert b.x.shape == (512, 1, 4)
    np.testing.assert_allclose(pts.func_w(b.x).numpy(), 0.0, atol=1e-5)
    t = b.times[:, 0].numpy()
    assert (t >= 0).all() and (t <= 1).all()
    # density (d+1)(1-t)^d on [0, 1] has mean 1/(d+2)
    assert t.mean() == pytest.approx(1.0 / (3 + 2), abs=0.02)
    assert not bool(b.seed_from_h.any())


def test_cone_boundary_paths(cone):
    assert cone.boundary_at_exit
    b = cone.boundary(gen(), 128)
    assert b.x.shape == (128, 12, 4)
    np.testing.assert_allclose(cone.func_w(b.x[:, -1, :]).numpy(), 0.0,
                               atol=1e-5)
    assert (cone.func_w(b.x[:, :-1, :]).numpy() >= -1e-6).all()
    assert bool(b.seed_from_h.all()) and bool((b.t_start == 0).all())
    assert (np.diff(b.times.numpy(), axis=1) >= -1e-7).all()


def test_hourglass_masks(hourglass):
    n_r = 200
    assert hourglass.interior_rows(n_r) == 2 * n_r
    b = hourglass.interior(gen(), n_r)
    assert b.x.shape == (2 * n_r, 16, 3)
    m = b.mask.numpy()
    w = hourglass.func_w(b.x).numpy()
    assert (w[m] > -1e-6).all()
    assert m[:n_r, 0].all()
    seed = b.seed_from_h.numpy()
    assert seed[:n_r].all() and not seed[n_r:].any()
    # re-entry rows start at |x|/r and are valid only after it
    rho = torch.linalg.norm(b.space[n_r:, 0, :], dim=-1).numpy()
    t0 = b.t_start[n_r:].numpy()
    np.testing.assert_allclose(t0, rho, atol=1e-6)
    times, mb = b.times[n_r:].numpy(), m[n_r:]
    assert (times[mb] > np.broadcast_to(t0[:, None], times.shape)[mb]).all()
    # points inside the waist never exit: their re-entry row is dead
    never = rho <= 0.5
    assert never.any() and (~mb[never]).all() and mb[~never].any()
    np.testing.assert_array_equal(b.x[:n_r].numpy(), b.x[n_r:].numpy())


def test_hourglass_boundary_on_surface(hourglass):
    pts = dataclasses.replace(hourglass, path_boundary=False)
    b = pts.boundary(gen(), 512)
    np.testing.assert_allclose(pts.func_w(b.x).numpy(), 0.0, atol=1e-5)


def test_hourglass_boundary_paths(hourglass):
    b = hourglass.boundary(gen(), 128)
    assert b.x.shape == (128, 16, 3)
    np.testing.assert_allclose(hourglass.func_w(b.x[:, -1, :]).numpy(), 0.0,
                               atol=1e-5)
    # descending branch: h-seeded from T0; ascending: g-seeded at the
    # re-entry anchor |x|/r = t, a path of zero length
    t_last = b.times[:, -1].numpy()
    asc = t_last > hourglass.mid + 1e-9
    seed, t0 = b.seed_from_h.numpy(), b.t_start.numpy()
    assert asc.any() and (~asc).any()
    assert (~seed[asc]).all() and seed[~asc].all()
    np.testing.assert_allclose(t0[~asc], 0.0)
    rho = torch.linalg.norm(b.space[:, 0, :], dim=-1).numpy()
    np.testing.assert_allclose(t0[asc], rho[asc] / hourglass.r, atol=1e-6)
    span = np.ptp(b.times.numpy(), axis=1)
    assert (span[asc] <= 1e-6).all()


def test_hourglass_waist_cap(hourglass):
    capped = dataclasses.replace(hourglass, waist_cap=True)
    b = capped.boundary(gen(), 128)
    assert (b.times[:, -1].numpy() <= hourglass.mid + 1e-6).all()
    np.testing.assert_allclose(hourglass.func_w(b.x[:, -1, :]).numpy(), 0.0,
                               atol=1e-5)
    assert bool(b.seed_from_h.all()) and bool((b.t_start == 0).all())


def test_make_domain_registry_and_rejections():
    assert isinstance(ts.make_domain("Hypercube", [-1, 1], 5, 0.0, 1.0, 20),
                      ts.Hypercube)
    for name, cls in (("NSphere_TCone", ts.NSphereTCone),
                      ("NSphereTCone", ts.NSphereTCone),
                      ("NSphere_THourglass", ts.NSphereTHourglass),
                      ("NSphereTHourglass", ts.NSphereTHourglass)):
        dom = ts.make_domain(name, [0.0, 2.0], 3, 0.0, 1.0, 10,
                             waist_cap=True, x64=True)
        assert isinstance(dom, cls) and dom.r == 2.0
        assert dom.interior(gen(), 4).x.dtype == torch.float64
        with pytest.raises(ValueError, match="T0"):
            ts.make_domain(name, 1.0, 3, 0.3, 1.0, 10)
        qdom = ts.make_domain(name, 1.0, 3, 0.0, 1.0, 10, qmc="halton")
        assert isinstance(qdom, cls) and qdom.qmc == "halton"
        qb = qdom.interior(gen(), 4)
        assert qb.x.shape == (qdom.interior_rows(4), 10, 4)
    assert ts.make_domain("NSphere_THourglass", 1.0, 3, 0.0, 1.0, 10,
                          waist_cap=True).waist_cap
    with pytest.raises(KeyError):
        ts.make_domain("Nope", 1.0, 3, 0.0, 1.0, 10)


# -- the deterministic pieces against JAX ------------------------------------

def space_time_points(n, d, seed):
    """Points across both branches: inside, outside and past the waist."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(0.0, 1.0, (n, 1)),
                           rng.uniform(-1.0, 1.0, (n, d))], axis=-1)


@pytest.mark.parametrize("name", NAMES)
def test_deterministic_pieces_match_jax(x64, name):
    d = 3
    jdom = js.make_domain(name, 1.3, d, 0.0, 1.0, 7, x64=True)
    tdom = ts.make_domain(name, 1.3, d, 0.0, 1.0, 7, x64=True)
    pts = space_time_points(200, d, 1)
    J, T = jnp.asarray, torch.as_tensor
    np.testing.assert_allclose(tdom.func_w(T(pts)).numpy(),
                               np.asarray(jdom.func_w(J(pts))), rtol=1e-12,
                               atol=1e-12)
    paths = np.broadcast_to(pts[:, None, :], (200, 7, d + 1))
    np.testing.assert_allclose(tdom.func_w(T(paths.copy())).numpy(),
                               np.asarray(jdom.func_w(J(paths))), rtol=1e-12,
                               atol=1e-12)
    (te, th), (je, jh) = tdom.entry(T(pts)), jdom.entry(J(pts))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-12)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert tdom.V() == pytest.approx(jdom.V(), rel=1e-12)
    if name == "NSphere_THourglass":
        assert (~th.numpy()).any() and (te.numpy() > 0).any()
        np.testing.assert_allclose(tdom.radius_at(T(pts[:, 0])).numpy(),
                                   np.asarray(jdom.radius_at(J(pts[:, 0]))),
                                   rtol=1e-12)
    # the anchored boundary paths on the same numpy inputs
    rng = np.random.default_rng(2)
    x = rng.normal(size=(9, d))
    t_end = rng.uniform(0.2, 1.0, 9)
    t_anchor = np.where(rng.uniform(size=9) < 0.5, 0.0, t_end)
    from_h = t_anchor == 0.0
    got = ts._anchored_paths(T(x), T(t_end), T(t_anchor), T(from_h), 7)
    want = js._anchored_paths(J(x), J(t_end), J(t_anchor), J(from_h), 7,
                              jnp.float64)
    for g, w in zip((got.x, got.mask, got.t_start, got.seed_from_h),
                    (want.x, want.mask, want.t_start, want.seed_from_h)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)


# -- the per-exit-group objective --------------------------------------------

def sampled_pair(name, n, seed, dtype=np.float64, boundary=False, d=2,
                 n_t=5):
    """One batch drawn by the JAX sampler, as numpy for both packages."""
    jdom = js.make_domain(name, 1.0, d, 0.0, 1.0, n_t,
                          x64=dtype == np.float64)
    draw = jdom.boundary if boundary else jdom.interior
    jb = jax.jit(lambda key: draw(key, n))(jax.random.PRNGKey(seed))
    arrays = [np.array(a) for a in (jb.x, jb.mask, jb.t_start,
                                    jb.seed_from_h)]
    return jb, ts.PathBatch(*map(torch.as_tensor, arrays))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("s1_raw_v", [False, True])
def test_grouped_objective_matches_jax(x64, name, s1_raw_v):
    d, L = 2, 6
    jb, tb = sampled_pair(name, 30, 3, d=d, n_t=L)
    n = tb.x.shape[0]
    last = twf._endpoint_indices(tb.mask)[1]
    assert len(set(last[tb.mask.any(1)].tolist())) > 1  # several groups
    rng = np.random.default_rng(4)
    u, v, phi = (rng.normal(size=(n, L)) for _ in range(3))
    du, dphi = rng.normal(size=(n, L, d)), rng.normal(size=(n, L, d + 1))
    jp, tp = jload_problem("cube_pde"), load_problem("cube_pde")
    jdom = js.make_domain(name, 1.0, d, 0.0, 1.0, L, x64=True)
    tdom = ts.make_domain(name, 1.0, d, 0.0, 1.0, L, x64=True)
    J, T = jnp.asarray, torch.as_tensor
    want = jax.jit(lambda *a: jwf.grouped_interior_objective(
        *a, jb, jp, jdom, s1_raw_v=s1_raw_v))(J(u), J(du), J(v), J(phi),
                                              J(dphi))
    got = twf.grouped_interior_objective(T(u), T(du), T(v), T(phi), T(dphi),
                                         tb, tp, tdom, s1_raw_v=s1_raw_v)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-9)


def test_grouped_equals_pooled_on_cube():
    d, L, n = 2, 6, 20
    cube = ts.Hypercube((-1.0, 1.0), d, 0.0, 1.0, L, x64=True)
    b = cube.interior(gen(5), n)
    rng = np.random.default_rng(6)
    T = torch.as_tensor
    u, v, phi = (T(rng.normal(size=(n, L))) for _ in range(3))
    du, dphi = T(rng.normal(size=(n, L, d))), T(rng.normal(size=(n, L, d + 1)))
    tp = load_problem("cube_pde")
    gi, gI, gnorm = twf.grouped_interior_objective(u, du, v, phi, dphi, b, tp,
                                                   cube)
    current, norm = twf.interior_terms(u, du, v, phi, dphi, b, tp, cube)
    np.testing.assert_allclose(float(gi), float(torch.log(current ** 2)
                                                - torch.log(norm)),
                               rtol=1e-12)
    np.testing.assert_allclose(float(gI), float(current), rtol=1e-12)
    np.testing.assert_allclose(float(gnorm), float(norm), rtol=1e-12)


# -- losses, gradients, the u side and serving on the hourglass --------------

def shared_nets(dtype, seed, extra=None):
    cfg = dict(SMALL, x64=dtype == np.float64, **(extra or {}))
    jcfg, tcfg = JConfig(**cfg), SolverConfig(**cfg)
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    u_tree = jax.tree.map(np.asarray, jax.jit(
        lambda key: jx.init_xnode(key, jcfg))(jax.random.PRNGKey(seed)))
    v_tree = jax.tree.map(np.asarray, jax.jit(
        lambda key: jdisc.init_discriminator(
            key, 2, cfg["v_hidden_dim"], cfg["v_layers"], dtype=jdt))(
                jax.random.PRNGKey(seed + 1)))
    rng = np.random.default_rng(seed)
    for layer in [*u_tree["lift"], *u_tree["field"], u_tree["readout"]]:
        layer["b"] = (0.2 * rng.normal(size=layer["b"].shape)).astype(dtype)
    return dict(jcfg=jcfg, tcfg=tcfg,
                ju=jax.tree.map(jnp.asarray, u_tree),
                jv=jax.tree.map(jnp.asarray, v_tree),
                tu=params_from_jax(u_tree, "cpu", tdt),
                tv=disc_params_from_jax(v_tree, "cpu", tdt))


def hourglass_losses(dtype, seed):
    s = shared_nets(dtype, seed)
    jcfg, tcfg = s["jcfg"], s["tcfg"]
    jp, tp = jload_problem("Ex4_1_funcs", 2), load_problem("Ex4_1_funcs", 2)
    jdom = js.make_domain(jcfg.domain, 1.0, 2, 0.0, 1.0, jcfg.N_t,
                          x64=jcfg.x64)
    tdom = ts.make_domain(tcfg.domain, 1.0, 2, 0.0, 1.0, tcfg.N_t,
                          x64=tcfg.x64)

    def jv_apply(p, pts):
        return jdisc.apply_discriminator(p, pts, jcfg.v_layers, True, 0)

    def tv_apply(p, pts):
        return tdisc.apply_discriminator(p, pts, tcfg.v_layers, True, 0)

    s["jl"] = jwf.make_losses(jp, jdom, jcfg, jx.apply_xnode, jv_apply)
    s["tl"] = twf.make_losses(tp, tdom, tcfg, tx.apply_xnode, tv_apply)
    s["jb"], s["tb"] = sampled_pair(jcfg.domain, 16, seed + 2, dtype)
    s["jbb"], s["tbb"] = sampled_pair(jcfg.domain, 8, seed + 3, dtype,
                                      boundary=True)
    assert_row_kinds(s["tb"], s["tbb"])
    return s


def check_losses(s, rtol_value, rtol_grad):
    jl, tl = s["jl"], s["tl"]
    (jval, jaux), jgu = jax.jit(jax.value_and_grad(
        lambda p: jl.loss_u(p, s["jv"], s["jb"], s["jbb"]), has_aux=True))(
            s["ju"])
    tval, taux = tl.loss_u(s["tu"], s["tv"], s["tb"], s["tbb"])
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval),
                               rtol=rtol_value)
    for k in ("I", "norm", "int", "init", "bdry"):
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]),
                                   rtol=rtol_value, atol=1e-12, err_msg=k)
    for tl_, jl_ in zip([*s["tu"].lift, *s["tu"].field, s["tu"].readout],
                        [*jgu["lift"], *jgu["field"], jgu["readout"]]):
        for g, w in ((tl_.weight.grad.numpy(), np.asarray(jl_["w"]).T),
                     (tl_.bias.grad.numpy(), np.asarray(jl_["b"]))):
            np.testing.assert_allclose(g, w, rtol=rtol_grad,
                                       atol=rtol_grad * np.abs(w).max())
    (jval, _), jgv = jax.jit(jax.value_and_grad(
        lambda p: jl.loss_v(p, s["ju"], s["jb"]), has_aux=True))(s["jv"])
    for p in s["tv"].parameters():
        p.grad = None
    tval, _ = tl.loss_v(s["tv"], s["tu"], s["tb"])
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval),
                               rtol=rtol_value)
    for name in ("inp", "hidden", "out"):
        layer = getattr(s["tv"], name)
        for g, w in ((layer.weight.grad.numpy(), np.asarray(jgv[name]["w"]).T),
                     (layer.bias.grad.numpy(), np.asarray(jgv[name]["b"]))):
            np.testing.assert_allclose(g, w, rtol=rtol_grad,
                                       atol=rtol_grad * np.abs(w).max())


def assert_row_kinds(tb, tbb=None):
    """The hourglass batches below carry every kind of row the kernels
    must take: g-seeded rows that start after T0, rows that die partway,
    wholly dead rows and zero-length boundary paths."""
    n = tb.x.shape[0] // 2
    live = tb.mask.any(1)
    assert (~live).any() and (live & ~tb.seed_from_h).any()
    assert (tb.t_start[~tb.seed_from_h] > 0).all()
    assert (~tb.mask[:n].all(1)).any()
    if tbb is not None:
        zero = ~tbb.seed_from_h.numpy()
        assert zero.any() and (np.ptp(tbb.times.numpy(), axis=1)[zero]
                               < 1e-6).all()


def test_hourglass_losses_and_grads_match_jax_f64(x64):
    s = hourglass_losses(np.float64, 8)
    assert not twf.fused_gate(s["tcfg"])
    check_losses(s, 1e-9, 1e-9)


def test_hourglass_losses_and_grads_match_jax_f32_fused_plain():
    s = hourglass_losses(np.float32, 9)
    assert twf.fused_gate(s["tcfg"])
    with jax.default_matmul_precision("highest"):
        check_losses(s, 1e-5, 1e-4)


def test_hourglass_u_side_plain_kernels_match_jax_f64(x64):
    # the plain versions of #3/#4 (u, grad_x u) and #5 (the weight
    # gradient) in f64 on the hourglass batch, against JAX's forward mode
    # through the masked scan and its reverse-mode gradient
    s = shared_nets(np.float64, 12)
    jcfg, tcfg = s["jcfg"], s["tcfg"]
    jp, tp = jload_problem("Ex4_1_funcs", 2), load_problem("Ex4_1_funcs", 2)
    jb, tb = sampled_pair(jcfg.domain, 16, 13)
    _, tbb = sampled_pair(jcfg.domain, 8, 14, boundary=True)
    assert_row_kinds(tb, tbb)
    rng = np.random.default_rng(15)

    def plain(params, batch):
        net = FlatNet([a.detach() for a in xnode_train._live_params(params)],
                      len(params.lift), len(params.field))
        t0, dt = xnode_train._prep_intervals(batch.times, batch.mask,
                                             batch.t_start, tcfg.n_sub)
        args = (t0, dt, *xnode_train.path_tangent_inputs(batch, tp, tcfg))
        return net, args

    net, args = plain(s["tu"], tb)
    u, du, hs, hts = xnode_train.u_du_fwd_plain(net, *args, tcfg.n_sub,
                                                tcfg.solver, store=True)
    ju, jdu = jax.jit(lambda p: jwf.u_with_spatial_grad(
        jx.apply_xnode, p, jb, jp, jcfg))(s["ju"])
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(du.numpy(), np.asarray(jdu), rtol=1e-9,
                               atol=1e-12)
    ub, dub = rng.normal(size=u.shape), rng.normal(size=du.shape)
    grad = xnode_train.u_du_bwd_plain(net, *args, hs, hts, torch.as_tensor(ub),
                                      torch.as_tensor(dub), tcfg.n_sub,
                                      tcfg.solver)
    assert torch.isfinite(grad).all()

    def contraction(p):
        a, b = jwf.u_with_spatial_grad(jx.apply_xnode, p, jb, jp, jcfg)
        return jnp.sum(a * ub) + jnp.sum(b * dub)

    jg = jax.jit(jax.grad(contraction))(s["ju"])
    want = np.concatenate([
        np.asarray(x).reshape(-1)
        for layer in [*jg["lift"], *jg["field"], jg["readout"]]
        for x in (np.asarray(layer["w"]).T, layer["b"])])
    np.testing.assert_allclose(grad.numpy(), want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())
    # the zero-length boundary paths: every dt is 0, u is readout(lift(g))
    net, bargs = plain(s["tu"], tbb)
    zero = ~tbb.seed_from_h
    assert zero.any() and (bargs[1][zero] == 0).all()
    ub_, _ = xnode_train.u_du_fwd_plain(net, *bargs, tcfg.n_sub, tcfg.solver)
    np.testing.assert_allclose(
        ub_.numpy(), tx.apply_xnode(s["tu"], tbb, tp, tcfg).detach().numpy(),
        rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_evaluate_points_on_the_hourglass_matches_jax(x64, prec):
    dtype = np.float64 if prec == "f64" else np.float32
    s = shared_nets(dtype, 20)
    jcfg, tcfg = s["jcfg"], s["tcfg"]
    jp, tp = jload_problem("Ex4_1_funcs", 2), load_problem("Ex4_1_funcs", 2)
    jdom = js.make_domain(jcfg.domain, 1.0, 2, 0.0, 1.0, jcfg.N_t,
                          x64=jcfg.x64)
    tdom = ts.make_domain(tcfg.domain, 1.0, 2, 0.0, 1.0, tcfg.N_t,
                          x64=tcfg.x64)
    pts = space_time_points(41, 2, 21).astype(dtype)
    t_entry, from_h = tdom.entry(torch.as_tensor(pts))
    assert (~from_h).sum() > 3 and (t_entry > 0).any()
    want = np.asarray(jx.evaluate_points(s["ju"], jnp.asarray(pts), jp, jcfg,
                                         k_steps=7, domain=jdom))
    tol = dict(rtol=1e-9, atol=1e-9) if prec == "f64" else dict(rtol=2e-4,
                                                                atol=2e-5)
    with torch.no_grad():
        got = tx.evaluate_points(s["tu"], torch.as_tensor(pts), tp, tcfg,
                                 k_steps=7, domain=tdom)
        np.testing.assert_allclose(got.numpy(), want, **tol)
        if prec == "f32":
            # the branch evaluate_points takes on CUDA, through the serving
            # kernel's plain version
            got = tx.evaluate_points_fused(s["tu"], torch.as_tensor(pts), tp,
                                           tcfg, 7, t_entry, from_h)
            np.testing.assert_allclose(got.numpy(), want, **tol)


# -- one outer step on the hourglass -----------------------------------------

def test_one_outer_step_on_the_hourglass_matches_jax(x64, tmp_path):
    cfg = dict(SMALL, x64=True)
    jsolver = JSolver(JConfig(**cfg), jload_problem("Ex4_1_funcs", 2),
                      work_dir=str(tmp_path), devices=jax.devices()[:1])
    tsolver = NODEWANSolver(SolverConfig(**cfg),
                            load_problem("Ex4_1_funcs", 2), device="cpu")
    assert isinstance(tsolver.domain, ts.NSphereTHourglass)
    state_from_jax(tsolver, jax.tree.map(np.asarray, jsolver.state.u_params),
                   jax.tree.map(np.asarray, jsolver.state.v_params))
    (jb, tb), (jbb, tbb), (jeb, teb) = (
        sampled_pair(cfg["domain"], 16, 30), sampled_pair(
            cfg["domain"], 8, 31, boundary=True),
        sampled_pair(cfg["domain"], 16, 32))
    assert_row_kinds(tb, tbb)
    draws = iter([(jb, jbb, None), (jeb, None, None)])
    jsolver._sample = lambda key: next(draws)
    jstate, jm = jax.jit(jsolver._outer_step)(jsolver.state)
    tm = tsolver._to_host(tsolver._step_on(tsolver.state, tb, tbb, teb))
    for k in ("loss_u", "loss_v", "I", "int", "init", "bdry", "L2",
              "rel_err"):
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-9, err_msg=k)

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-9,
                                   atol=1e-9 * max(np.abs(want).max(), 1e-6))

    st = tsolver.state
    u_pairs = lambda t: [
        (layer.weight, jl["w"].T) if i == 0 else (layer.bias, jl["b"])
        for layer, jl in zip([*st.u_params.lift, *st.u_params.field,
                              st.u_params.readout],
                             [*t["lift"], *t["field"], t["readout"]])
        for i in (0, 1)]
    v_pairs = lambda t: [
        (getattr(st.v_params, n).weight, t[n]["w"].T) if i == 0
        else (getattr(st.v_params, n).bias, t[n]["b"])
        for n in ("inp", "hidden", "out") for i in (0, 1)]
    for p, w in u_pairs(jstate.u_params) + v_pairs(jstate.v_params):
        close(p, w)
    for opt, pairs, jopt in ((st.opt_u, u_pairs, jstate.opt_u),
                             (st.opt_v, v_pairs, jstate.opt_v)):
        adam = next(x for x in jax.tree.leaves(
            jopt.inner_state, is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(x, "mu"))
        for (p, mu), (_, nu) in zip(pairs(adam.mu), pairs(adam.nu)):
            assert int(opt.state[p]["step"]) == int(adam.count)
            close(opt.state[p]["exp_avg"], mu)
            close(opt.state[p]["exp_avg_sq"], nu)


# -- the command line --------------------------------------------------------

@pytest.mark.parametrize("name,extra", [
    ("cone_pde", {}), ("hourglass_pde", {"fused_v": True, "waist_cap": True})])
def test_cli_takes_the_shipped_moving_configs(tmp_path, name, extra):
    # the shipped YAML as it is, cut to a CPU size: narrow nets, few paths
    with open(os.path.join(CONFIGS, f"{name}.yaml")) as fh:
        raw = yaml.safe_load(fh)
    raw.update(N_r=12, N_b=8, N_t=5, u_hidden_dim=6, u_hidden_hidden_dim=5,
               u_layers=2, v_layers=3, v_hidden_dim=8, **extra)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw))
    solver = main(["--params", str(path), "--funcs", "Ex4_1_funcs", "-w",
                   str(tmp_path), "--iterations", "2", "--device", "cpu",
                   "--no-report"])
    assert solver.state.step == 2
    assert type(solver.domain).__name__ == raw["domain"].replace("_", "")
    records = [json.loads(line)
               for line in open(tmp_path / "metrics_NODE_3.jsonl")]
    assert [r["step"] for r in records] == [0, 1]
    assert all(np.isfinite(r["loss_u"]) and np.isfinite(r["rel_err"])
               for r in records)
    assert (tmp_path / "checkpoint_NODE.pt").exists()
    with torch.no_grad():
        u = solver.predict(torch.tensor([[0.9, 0.7, 0.0, 0.0],
                                         [0.2, 0.1, 0.1, 0.1]]))
    assert u.shape == (2,) and bool(torch.isfinite(u).all())
