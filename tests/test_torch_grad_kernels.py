"""The training kernels of the port (#3, #4, #5 in ``csrc/xnode_grad.cu``)
through their plain versions: the forward with spatial tangents and the
hand-derived backward, against the JAX package's Pallas kernels in
interpret mode and against autograd; and the host side of the CUDA
wrappers that the CPU can check.

Values are held to ``rtol=2e-4, atol=2e-5`` (f32, the tolerance of
``tests/test_pallas.py``). Weight gradients are sums over every path,
direction and interval, taken in another order by each side, so each
gradient tensor is held to ``rtol=1e-3`` with an absolute floor of
``1e-4`` of its largest value.
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xnode_wan_tpu.config import SolverConfig as JConfig
from xnode_wan_tpu.models.xnode import init_xnode as jinit_xnode
from xnode_wan_tpu.ops.pallas import xnode_train as jtrain
from xnode_wan_tpu.ops.sampling import PathBatch as JPathBatch
from xnode_wan_tpu.problems import load_problem as jload_problem
from xnode_wan_tpu_torch import SolverConfig, load_problem, params_from_jax
from xnode_wan_tpu_torch.ops.kernels import _build, steppers, xnode_train
from xnode_wan_tpu_torch.ops.kernels.steppers import FlatNet
from xnode_wan_tpu_torch.ops.sampling import PathBatch

BASE = dict(dim=3, N_t=5, N_r=13, N_b=8, u_hidden_dim=6,
            u_hidden_hidden_dim=7, u_layers=2, min_steps=3,
            shape_param=(-1.0, 1.0))
TOL = dict(rtol=2e-4, atol=2e-5)
METHODS = ["euler", "midpoint", "heun", "rk4"]
# (method, n_sub, fourier_features, masked): every method, masked paths,
# rk4 with two substeps, the Fourier bank
CASES = [("euler", 1, 0, False), ("midpoint", 1, 0, True),
         ("heun", 1, 0, False), ("rk4", 2, 1, True)]


def assert_grad_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-4 * float(np.abs(want).max()))


def shared_params(seed, **kw):
    """One set of weights for both packages, biases made non-zero so the
    relu masks split."""
    jcfg = JConfig(**{**BASE, **kw})
    tree = jax.tree.map(np.asarray, jinit_xnode(jax.random.PRNGKey(seed),
                                                jcfg))
    rng = np.random.default_rng(seed)
    for layer in [*tree["lift"], *tree["field"], tree["readout"]]:
        layer["b"] = (0.2 * rng.normal(size=layer["b"].shape)).astype(
            np.float32)
    return (jcfg, SolverConfig(**{**BASE, **kw}),
            jax.tree.map(jnp.asarray, tree), params_from_jax(tree, "cpu"))


def kernel_inputs(n, L, d, F, masked, n_sub, seed=0):
    """``(t0, dt, feats, dfeats, seed, dseed)`` as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0, 1, (n, L)), axis=1).astype(np.float32)
    mask = rng.uniform(size=(n, L)) < (0.6 if masked else 2.0)
    t0, dt = xnode_train._prep_intervals(
        torch.as_tensor(times), torch.as_tensor(mask), torch.zeros(n), n_sub)
    return [t0.numpy(), dt.numpy(),
            rng.normal(size=(n, F)).astype(np.float32),
            rng.normal(size=(n, d, F)).astype(np.float32),
            rng.normal(size=n).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32)]


class JaxLanes:
    """The Pallas kernels' feature-major, tangent-grouped layout for one
    block of ``n_pad`` lanes, and back."""

    def __init__(self, n, d, n_pad=128):
        self.n, self.d, self.n_pad = n, d, n_pad

    def cols(self, a):                      # [N, rows] -> [rows, n_pad]
        out = np.zeros((a.shape[1], self.n_pad), np.float32)
        out[:, :self.n] = a.T
        return jnp.asarray(out)

    def tan(self, a):                       # [N, d, F] -> [F, d * n_pad]
        return jtrain._tangent_lanes(jnp.asarray(a), self.n_pad, self.n_pad)

    def args(self, t0, dt, feats, dfeats, seed, dseed):
        return (self.cols(t0), self.cols(dt), self.cols(feats),
                self.tan(dfeats), self.cols(seed[:, None]),
                self.tan(dseed[:, :, None]))

    def u(self, a):                         # [L, n_pad] -> [N, L]
        return np.asarray(a)[:, :self.n].T

    def du(self, a):                        # [L, d * n_pad] -> [N, L, d]
        return np.asarray(jtrain._tangent_unlanes(a, self.n_pad, self.d))[
            :, :, :self.n].transpose(2, 0, 1)

    def hs(self, a):                        # [L, H, n_pad] -> [L, N, H]
        return np.asarray(a)[:, :, :self.n].transpose(0, 2, 1)

    def hts(self, a):                       # [L, H, d*n_pad] -> [L, N, d, H]
        L, H = a.shape[:2]
        return np.asarray(a).reshape(L, H, self.d, self.n_pad)[
            ..., :self.n].transpose(0, 3, 2, 1)

    def dub(self, a):                       # [N, L, d] -> [L, d * n_pad]
        out = np.zeros((a.shape[1], self.d, self.n_pad), np.float32)
        out[:, :, :self.n] = a.transpose(1, 2, 0)
        return jnp.asarray(out.reshape(a.shape[1], -1))


def case_setup(method, n_sub, ff, masked, seed):
    jcfg, _, jparams, tparams = shared_params(seed, solver=method,
                                              fourier_features=ff)
    net = xnode_train.flat_net(tparams)
    n, L, d = BASE["N_r"], BASE["N_t"], BASE["dim"]
    arrays = kernel_inputs(n, L, d, net.F, masked, n_sub, seed)
    lanes = JaxLanes(n, d)
    build = jtrain._build(net.n_lift, net.n_field, L, d, n_sub, method,
                          net.F, net.H, lanes.n_pad, lanes.n_pad, True)
    return net, jparams, arrays, lanes, build


@pytest.mark.parametrize("method,n_sub,ff,masked", CASES)
def test_u_du_fwd_plain_matches_pallas(method, n_sub, ff, masked):
    net, jparams, arrays, lanes, (fwd, fwd_store, _) = case_setup(
        method, n_sub, ff, masked, seed=1)
    flat = tuple(jtrain._flatten_params_t(jparams))
    jargs = lanes.args(*arrays)
    got = xnode_train.u_du_fwd_plain(net, *map(torch.as_tensor, arrays),
                                     n_sub, method, store=True)
    u, du = fwd(*jargs, flat)
    np.testing.assert_allclose(got[0].numpy(), lanes.u(u), **TOL)
    np.testing.assert_allclose(got[1].numpy(), lanes.du(du), **TOL)
    u, du, hs, hts = fwd_store(*jargs, flat)
    np.testing.assert_allclose(got[0].numpy(), lanes.u(u), **TOL)
    np.testing.assert_allclose(got[1].numpy(), lanes.du(du), **TOL)
    np.testing.assert_allclose(got[2].numpy(), lanes.hs(hs), **TOL)
    np.testing.assert_allclose(got[3].numpy(), lanes.hts(hts), **TOL)
    plain = xnode_train.u_du_fwd_plain(net, *map(torch.as_tensor, arrays),
                                       n_sub, method)
    for a, b in zip(plain, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("method,n_sub,ff,masked", CASES)
def test_u_du_bwd_plain_matches_pallas(method, n_sub, ff, masked):
    net, jparams, arrays, lanes, (_, fwd_store, bwd) = case_setup(
        method, n_sub, ff, masked, seed=2)
    flat = tuple(jtrain._flatten_params_t(jparams))
    jargs = lanes.args(*arrays)
    n, L, d = BASE["N_r"], BASE["N_t"], BASE["dim"]
    rng = np.random.default_rng(3)
    ub = rng.normal(size=(n, L)).astype(np.float32)
    dub = rng.normal(size=(n, L, d)).astype(np.float32)
    _, _, hs, hts = fwd_store(*jargs, flat)
    want = bwd(*jargs, flat, hs, hts, lanes.cols(ub), lanes.dub(dub))
    targs = list(map(torch.as_tensor, arrays))
    states = xnode_train.u_du_fwd_plain(net, *targs, n_sub, method,
                                        store=True)[2:]
    got = xnode_train.u_du_bwd_plain(net, *targs, *states,
                                     torch.as_tensor(ub),
                                     torch.as_tensor(dub), n_sub, method)
    sizes = [a.numel() for a in net.flat]
    assert got.shape == (sum(sizes),)
    for g, w in zip(torch.split(got, sizes), want):
        assert_grad_close(g.numpy(), np.asarray(w).reshape(-1))


@pytest.mark.parametrize("method", METHODS)
def test_u_du_bwd_plain_matches_autograd(method):
    # the hand-derived adjoint against reverse mode through the plain
    # forward, in f64 where the two orders of summation agree to 1e-10
    _, _, _, tparams = shared_params(4, solver=method)
    net = xnode_train.flat_net(tparams)
    net = FlatNet([a.double() for a in net.flat], net.n_lift, net.n_field)
    n_sub = 2 if method == "rk4" else 1
    n, L, d = BASE["N_r"], BASE["N_t"], BASE["dim"]
    args = [torch.as_tensor(a).double()
            for a in kernel_inputs(n, L, d, net.F, True, n_sub, seed=5)]
    rng = np.random.default_rng(6)
    ub = torch.as_tensor(rng.normal(size=(n, L)))
    dub = torch.as_tensor(rng.normal(size=(n, L, d)))
    states = xnode_train.u_du_fwd_plain(net, *args, n_sub, method,
                                        store=True)[2:]
    got = xnode_train.u_du_bwd_plain(net, *args, *states, ub, dub, n_sub,
                                     method)
    leaves = [a.clone().requires_grad_(True) for a in net.flat]
    u, du = xnode_train.u_du_fwd_plain(
        FlatNet(leaves, net.n_lift, net.n_field), *args, n_sub, method)
    want = torch.autograd.grad((u * ub).sum() + (du * dub).sum(), leaves)
    torch.testing.assert_close(got, torch.cat([w.reshape(-1) for w in want]),
                               rtol=1e-10, atol=1e-10)


def batch_pair(n, L, d, seed):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0, 1, (n, L)), axis=1)
    xs = rng.uniform(-1, 1, (n, d))
    x = np.concatenate([times[:, :, None],
                        np.broadcast_to(xs[:, None], (n, L, d))], axis=-1)
    arrays = [x.astype(np.float32), rng.uniform(size=(n, L)) < 0.7,
              np.zeros(n, np.float32), np.ones(n, bool)]
    return (JPathBatch(*map(jnp.asarray, arrays)),
            PathBatch(*map(torch.as_tensor, arrays)))


@pytest.mark.parametrize("extra", [dict(solver="midpoint"),
                                   dict(solver="rk4", min_steps=6,
                                        fourier_features=1, u_scale=2.5)],
                         ids=["midpoint", "rk4_nsub2_fourier_uscale"])
def test_u_du_fused_values_and_grads_match_pallas(extra):
    jcfg, tcfg, jparams, tparams = shared_params(7, **extra)
    jb, tb = batch_pair(BASE["N_r"], BASE["N_t"], BASE["dim"], seed=8)
    jp, tp = jload_problem("Ex4_1_funcs"), load_problem("Ex4_1_funcs")
    rng = np.random.default_rng(9)
    cu = rng.normal(size=(BASE["N_r"], BASE["N_t"])).astype(np.float32)
    cd = rng.normal(size=(BASE["N_r"], BASE["N_t"], BASE["dim"])).astype(
        np.float32)

    def contraction(u, du, lib):
        c_u, c_d = lib.asarray(cu), lib.asarray(cd)
        return ((u * c_u).sum() + (du * c_d).sum()
                + (lib.tanh(u) * du[..., 0]).sum())

    with jax.default_matmul_precision("highest"):
        ju, jdu = jtrain.fused_from_batch(jparams, jb, jp, jcfg,
                                          interpret=True)
        jgrad = jax.grad(lambda p: contraction(
            *jtrain.fused_from_batch(p, jb, jp, jcfg, interpret=True),
            jnp))(jparams)
    tu, tdu = xnode_train.fused_from_batch(tparams, tb, tp, tcfg)
    np.testing.assert_allclose(tu.detach().numpy(), np.asarray(ju), **TOL)
    np.testing.assert_allclose(tdu.detach().numpy(), np.asarray(jdu), **TOL)
    contraction(tu, tdu, torch).backward()
    for tl, jl in zip([*tparams.lift, *tparams.field, tparams.readout],
                      [*jgrad["lift"], *jgrad["field"], jgrad["readout"]]):
        assert_grad_close(tl.weight.grad.numpy(), np.asarray(jl["w"]).T)
        assert_grad_close(tl.bias.grad.numpy(), np.asarray(jl["b"]))


def test_u_du_fused_in_tangent_chunks_matches_pallas_chunks():
    # d = 4 in two launches of two directions (JAX's d_chunk): u, du and
    # the weight gradient against the JAX package's chunked kernels in
    # interpret mode, and against the port's own full-d call
    jcfg, tcfg, jparams, tparams = shared_params(15, dim=4)
    jb, tb = batch_pair(BASE["N_r"], BASE["N_t"], 4, seed=16)
    jp, tp = jload_problem("Ex4_1_funcs"), load_problem("Ex4_1_funcs")
    rng = np.random.default_rng(17)
    cu = rng.normal(size=(BASE["N_r"], BASE["N_t"])).astype(np.float32)
    cd = rng.normal(size=(BASE["N_r"], BASE["N_t"], 4)).astype(np.float32)

    def contraction(u, du, lib):
        return ((u * lib.asarray(cu)).sum() + (du * lib.asarray(cd)).sum()
                + (lib.tanh(u) * du[..., 3]).sum())

    with jax.default_matmul_precision("highest"):
        ju, jdu = jtrain.fused_from_batch(jparams, jb, jp, jcfg,
                                          interpret=True, d_chunk=2)
        jgrad = jax.grad(lambda p: contraction(
            *jtrain.fused_from_batch(p, jb, jp, jcfg, interpret=True,
                                     d_chunk=2), jnp))(jparams)
    inputs = xnode_train.path_tangent_inputs(tb, tp, tcfg)

    def port(d_chunk):
        return xnode_train.u_du_fused(
            tparams, *inputs, tb.times, tb.mask, tb.t_start,
            n_sub=tcfg.n_sub, method=tcfg.solver,
            scale=float(tcfg.u_scale_eff), d_chunk=d_chunk)

    tu, tdu = port(2)
    np.testing.assert_allclose(tu.detach().numpy(), np.asarray(ju), **TOL)
    np.testing.assert_allclose(tdu.detach().numpy(), np.asarray(jdu), **TOL)
    contraction(tu, tdu, torch).backward()
    layers = [*tparams.lift, *tparams.field, tparams.readout]
    chunked = [a.grad.clone() for a in tparams.parameters()]
    for tl, jl in zip(layers, [*jgrad["lift"], *jgrad["field"],
                               jgrad["readout"]]):
        assert_grad_close(tl.weight.grad.numpy(), np.asarray(jl["w"]).T)
        assert_grad_close(tl.bias.grad.numpy(), np.asarray(jl["b"]))
    tparams.zero_grad()
    fu, fdu = port(None)
    torch.testing.assert_close(tu, fu, rtol=0, atol=0)
    torch.testing.assert_close(tdu, fdu, **TOL)
    contraction(fu, fdu, torch).backward()
    for a, g in zip(tparams.parameters(), chunked):
        assert_grad_close(g.numpy(), a.grad.numpy())


@pytest.mark.parametrize("d_chunk", [3, 5, -1])
def test_d_chunk_must_divide_d(d_chunk):
    # as in the JAX package: a chunk that does not divide d raises
    _, tcfg, jparams, tparams = shared_params(18, dim=4)
    jb, tb = batch_pair(5, BASE["N_t"], 4, seed=19)
    jp, tp = jload_problem("Ex4_1_funcs"), load_problem("Ex4_1_funcs")
    inputs = xnode_train.path_tangent_inputs(tb, tp, tcfg)
    with pytest.raises(ValueError, match=f"d_chunk={d_chunk} must divide "
                       "d=4"):
        xnode_train.u_du_fused(tparams, *inputs, tb.times, tb.mask,
                               tb.t_start, n_sub=1, method="midpoint",
                               scale=1.0, d_chunk=d_chunk)
    if d_chunk > 0:
        jinputs = (jnp.zeros((5, 4)), jnp.zeros((5, 4, 4)), jnp.zeros(5),
                   jnp.zeros((5, 4)), jb.times, jb.mask, jb.t_start)
        with pytest.raises(ValueError, match=f"d_chunk={d_chunk} must "
                           "divide d=4"):
            jtrain.u_du_fused(jparams, *jinputs, n_sub=1, method="midpoint",
                              scale=1.0, interpret=True, d_chunk=d_chunk)


@pytest.mark.parametrize("domain,dim,problem,ff", [
    ("Hypercube", 5, "Ex4_1_funcs", 1), ("NSphere_THourglass", 3,
                                         "Ex4_1_funcs", 0),
    ("Hypercube", 20, "Ex4_3_consistent", 1)])
def test_path_tangent_inputs_match_one_jvp_a_direction(domain, dim, problem,
                                                       ff):
    # the d directions in one vmap, against a jvp for each direction
    from xnode_wan_tpu_torch.models.xnode import path_seed_fn, spatial_features
    from xnode_wan_tpu_torch.ops.sampling import make_domain

    cfg = SolverConfig(dim=dim, N_t=5, domain=domain, fourier_features=ff,
                       shape_param=1.0 if domain != "Hypercube"
                       else (-1.0, 1.0))
    prob = load_problem(problem, dim)
    batch = make_domain(cfg.domain, cfg.shape_param, dim, cfg.T0, cfg.T,
                        cfg.N_t).interior(torch.Generator().manual_seed(3), 37)
    xs = batch.space[:, 0, :]
    seed_of = path_seed_fn(batch, prob, cfg)
    want_seed, want_feats = [], []
    for e in torch.eye(dim):
        tan = e.expand_as(xs)
        want_seed.append(torch.func.jvp(seed_of, (xs,), (tan,))[1])
        want_feats.append(torch.func.jvp(
            lambda x: spatial_features(x, ff), (xs,), (tan,))[1])
    feats, dfeats, seed, dseed = xnode_train.path_tangent_inputs(batch, prob,
                                                                 cfg)
    for got, want in ((feats, spatial_features(xs, ff)),
                      (dfeats, torch.stack(want_feats, dim=1)),
                      (seed, seed_of(xs)),
                      (dseed, torch.stack(want_seed, dim=1))):
        assert got.shape == want.shape and torch.equal(got, want)


def test_u_du_fused_without_grad_stores_nothing():
    _, tcfg, _, tparams = shared_params(10)
    _, tb = batch_pair(BASE["N_r"], BASE["N_t"], BASE["dim"], seed=11)
    tp = load_problem("cube_pde")
    with torch.no_grad():
        u, du = xnode_train.fused_from_batch(tparams, tb, tp, tcfg)
    assert not u.requires_grad and du.shape == (*u.shape, BASE["dim"])
    u2, du2 = xnode_train.fused_from_batch(tparams, tb, tp, tcfg)
    assert u2.requires_grad and du2.grad_fn is not None
    torch.testing.assert_close(u, u2.detach(), rtol=0, atol=0)


def test_live_packed_matches_flat_net_and_carries_grad():
    _, _, _, tparams = shared_params(12, fourier_features=1)
    live = xnode_train.live_packed(tparams)
    torch.testing.assert_close(live.detach(),
                               xnode_train.flat_net(tparams).packed())
    live.sum().backward()
    assert all(bool((p.grad == 1).all()) for p in tparams.parameters())


@pytest.mark.parametrize("method,table", list(steppers.RK_TABLES.items()))
def test_rk_tables_reproduce_rk_step(method, table):
    # the RK tables the backward walks give the same step as rk_step
    C, A, B = table
    rng = np.random.default_rng(13)
    W = torch.as_tensor(rng.normal(size=(4, 4)))
    h = torch.as_tensor(rng.normal(size=(3, 4)))
    t = torch.as_tensor(rng.uniform(size=(3, 1)))
    dt = torch.as_tensor(rng.uniform(size=(3, 1)) * 0.2)

    def field(s, y):
        return torch.tanh(y @ W) * (1 + s)

    ks = [field(t, h)]
    for s in range(1, len(C)):
        ks.append(field(t + C[s] * dt, h + A[s] * dt * ks[-1]))
    got = h + dt * sum(b * k for b, k in zip(B, ks))
    torch.testing.assert_close(got, steppers.rk_step(method, field, t, dt, h),
                               rtol=1e-12, atol=1e-12)


def cuda_signature(source, symbol):
    text = (_build.CSRC / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)", text, re.S)
    assert m, f"{symbol} not found in {source}.cu"
    return [p.strip() for p in m.group(1).split(",")]


@pytest.mark.parametrize("kernel", [xnode_train.FWD_KERNEL,
                                    xnode_train.FWD_STORE_KERNEL,
                                    xnode_train.BWD_KERNEL,
                                    xnode_train.BWD_GLOBAL_KERNEL,
                                    xnode_train.BWD_CLUSTER_KERNEL,
                                    xnode_train.PATH_TILE_KERNEL],
                         ids=lambda k: k.symbol)
def test_grad_ctypes_argtypes_match_c_signature(kernel):
    # #2's path-tile variant has a source of its own since it stopped
    # running #3's body with d = 0
    assert kernel.source == ("xnode_path_tile"
                             if kernel is xnode_train.PATH_TILE_KERNEL
                             else "xnode_grad")
    params = cuda_signature(kernel.source, kernel.symbol)
    declared = [ctypes.c_int, ctypes.c_void_p] + kernel.argtypes
    assert len(params) == len(declared)
    for p, ct in zip(params, declared):
        assert ct is (ctypes.c_void_p if "*" in p else ctypes.c_int), p


def test_grad_cuda_wrappers_reject_cpu_tensors():
    _, _, _, tparams = shared_params(14)
    net = xnode_train.flat_net(tparams)
    n, L, d = 5, 4, BASE["dim"]
    args = [torch.as_tensor(a) for a in kernel_inputs(n, L, d, net.F, False,
                                                      1)]
    packed = net.packed()
    counts = [k.launches for k in (xnode_train.FWD_KERNEL,
                                   xnode_train.FWD_STORE_KERNEL,
                                   xnode_train.BWD_KERNEL)]
    with pytest.raises(ValueError, match="CUDA device"):
        xnode_train.u_du_fwd_cuda(net, packed, *args, 1, "midpoint")
    with pytest.raises(ValueError, match="CUDA device"):
        xnode_train.u_du_fwd_cuda(net, packed, *args, 1, "midpoint", True)
    hs, hts = torch.zeros(L, n, net.H), torch.zeros(L, n, d, net.H)
    with pytest.raises(ValueError, match="CUDA device"):
        xnode_train.u_du_bwd_cuda(net, packed, *args, hs, hts,
                                  torch.zeros(n, L), torch.zeros(n, L, d), 1,
                                  "midpoint")
    with pytest.raises(ValueError, match="fixed_adams"):
        xnode_train.u_du_fwd_cuda(net, packed, *args, 1, "fixed_adams")
    with pytest.raises(ValueError, match="no u_du kernel"):
        xnode_train.UDuFused.apply(packed.to("meta"), net,
                                   *(a.to("meta") for a in args), 1,
                                   "midpoint", False)
    assert counts == [k.launches for k in (xnode_train.FWD_KERNEL,
                                           xnode_train.FWD_STORE_KERNEL,
                                           xnode_train.BWD_KERNEL)]


SHIPPED = ("cube_pde", "ex4_1_d10", "highdim_d20")


def shipped_dims(name):
    import os
    from xnode_wan_tpu_torch import init_xnode, load_params
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_params(os.path.join(repo, "configs", f"{name}.yaml"))
    return cfg, xnode_train.flat_net(init_xnode(cfg, device="cpu"))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", SHIPPED)
def test_grad_tile_rule_fits_shipped_configs(name, method):
    # the tile of #3/#4 and of #5 fits one block's shared memory, with a
    # block of whole warps under the kernels' launch bound
    cfg, net = shipped_dims(name)
    dims = net.dims()
    for backward in (False, True):
        block = xnode_train.grad_tile(dims, cfg.dim, method, backward)
        tile, threads = block.paths, block.threads
        # the shipped nets keep #5's shared variant
        assert block.variant == "shared" and block.cluster == 1
        smem = xnode_train.tile_smem_bytes(dims, cfg.dim, method, tile,
                                           backward)
        assert 0 < smem <= 232448
        assert threads % 32 == 0 and 32 <= threads <= 1024
        assert threads <= xnode_train.MAX_THREADS
        # the largest listed tile whose block fits an SM twice (233,472
        # bytes, 1,024 a block reserved), else the smallest that fits
        tiles = xnode_train.BWD_TILES if backward else xnode_train.FWD_TILES
        size = {t: xnode_train.tile_smem_bytes(dims, cfg.dim, method, t,
                                               backward) for t in tiles}
        twice = [t for t in tiles if 2 * (size[t] + 1024) <= 233472]
        assert tile == (max(twice) if twice
                        else min(t for t in tiles if size[t] <= 232448))


def bwd_tile_walk(n_paths, tile, blocks):
    """The paths each block of kernel #5 walks, tile by tile in its order,
    as its loop does (``xnode_udu_bwd_kernel``): block ``b`` takes tiles
    ``b, b + blocks, ...``, the last one part full."""
    n_tiles = -(-n_paths // tile)
    return [[range(t * tile, min(n_paths, t * tile + tile))
             for t in range(b, n_tiles, blocks)] for b in range(blocks)]


@pytest.mark.parametrize("name, fwd, bwd", [
    ("cube_pde", (4, 64), (8, 128)),
    ("ex4_1_d10", (4, 64), (4, 128)),
    ("highdim_d20", (4, 256), (1, 256))])
def test_grad_tile_rule_picks_the_swept_shapes(name, fwd, bwd):
    # the (paths per tile, threads) the rule gives at each shipped config's
    # own solver, as timed by the tile sweep on the card: the largest tile
    # whose block fits an SM twice (ex4_1_d10's #5: 4 paths, 85 KiB, where
    # 8 paths take 167 KiB), else one path (highdim_d20's #5: two paths fit
    # once and measured slower), #5 at 128 threads where two blocks fit
    cfg, net = shipped_dims(name)
    assert xnode_train.grad_tile(net.dims(), cfg.dim, cfg.solver,
                                 False) == xnode_train.GradTile(*fwd)
    assert xnode_train.grad_tile(net.dims(), cfg.dim, cfg.solver,
                                 True) == xnode_train.GradTile(*bwd)


@pytest.mark.parametrize("n_paths", [1, 7, 4000, 4001])
def test_bwd_tile_walk_covers_every_path_once(n_paths):
    cfg, net = shipped_dims("cube_pde")
    dims = net.dims()
    block = xnode_train.grad_tile(dims, cfg.dim, cfg.solver, True)
    tile, threads = block.paths, block.threads
    smem = xnode_train.tile_smem_bytes(dims, cfg.dim, cfg.solver, tile, True)
    blocks = xnode_train.bwd_blocks(n_paths, tile, smem, threads, sms=132)
    assert 1 <= blocks <= -(-n_paths // tile)
    walk = bwd_tile_walk(n_paths, tile, blocks)
    assert len(walk) == blocks and all(walk)
    seen = [n for tiles in walk for r in tiles for n in r]
    assert sorted(seen) == list(range(n_paths))
    # each block walks its tiles in increasing order
    assert all([r.start for r in tiles] == sorted(r.start for r in tiles)
               for tiles in walk)


def test_grad_tile_rule_raises_where_nothing_fits():
    # H = Hh = 64, rk4: at d = 50 one path a tile does not fit #5's block,
    # but its slice of it fits a block of an 8-block cluster; at d = 60
    # not even that, nor the global variant's block
    dims = (64, 64, 50, 3, 16)
    assert xnode_train.tile_smem_bytes(dims, 50, "rk4", 1, True) > 232448
    assert xnode_train.grad_tile(dims, 50, "rk4", backward=True) == (
        xnode_train.GradTile(1, 128, "cluster", 8))
    with pytest.raises(ValueError, match="shared memory"):
        xnode_train.grad_tile(dims, 60, "rk4", backward=True)
    assert xnode_train.tile_smem_bytes(dims, 60, "rk4", 1, True,
                                       "global") > 232448
    assert xnode_train.cluster_smem_bytes(dims, 60, "rk4", 1, 8) > 232448


def test_grad_kernel_caps_cover_shipped_configs():
    for name in SHIPPED:
        cfg, net = shipped_dims(name)
        assert xnode_train.n_params_of(net.dims()) == net.packed().numel()
        for backward in (False, True):
            xnode_train.grad_tile(net.dims(), cfg.dim, cfg.solver, backward)


def test_relu_margins_find_a_kink():
    # a seed that puts a lift pre-activation exactly on zero gives its path
    # margin 0; the other paths stay off the kinks
    _, _, _, tparams = shared_params(15)
    net = xnode_train.flat_net(tparams)
    net = FlatNet([a.double() for a in net.flat], net.n_lift, net.n_field)
    n, L, d = 4, 3, BASE["dim"]
    t0, dt, feats, _, seed, _ = [torch.as_tensor(a).double() for a in
                                 kernel_inputs(n, L, d, net.F, False, 1)]
    m = xnode_train.relu_margins(net, t0, dt, feats, seed, 1, "midpoint")
    assert m.shape == (n,) and bool((m > 0).all()) and bool((m <= 1).all())
    w, b = net.lift[0]
    w[0, 0], b[0] = 2.0, -1.0
    seed[0] = 0.5
    m = xnode_train.relu_margins(net, t0, dt, feats, seed, 1, "midpoint")
    assert float(m[0]) == 0.0 and bool((m[1:] > 0).all())
    # a unit whose terms are all zero (0 / 0) is no kink, not a NaN
    w[1], b[1] = 0.0, 0.0
    m2 = xnode_train.relu_margins(net, t0, dt, feats, seed, 1, "midpoint")
    assert not bool(m2.isnan().any()) and float(m2[0]) == 0.0


def feature_sum_walk(net, t0, dt, feats, dfeats, seed, dseed, hs, hts, ub,
                     dub, n_sub, method):
    """Kernel #5's walk with the feature columns taken out of it, in torch:
    each stage's field VJP leaves field layer 0's feature columns alone and
    adds its layer-0 cotangents (``abar [N, Hh]`` on the primal rows,
    ``atbar [N, d, Hh]`` on the tangent rows) into one running sum over
    every stage, substep and interval; after the walk one product of that
    sum with the features (``feats``, ``dfeats``) gives those columns'
    gradient. The rest follows the plain version's order: intervals from
    the last, each re-run from its start state, the readout's cotangents
    injected, the substeps walked back, the lift last.

    A copy of the algorithm, not of the ``.cu``: it shows that summing the
    cotangents before the feature product gives the plain version's
    gradient, and nothing ties it to the kernel's code. The kernel is held
    on the card by ``chip_smoke.py``'s phase 3."""
    F = net.F
    g = [torch.zeros_like(a) for a in net.flat]
    pairs = [(g[2 * i], g[2 * i + 1]) for i in range(len(g) // 2)]
    gl, gf = pairs[:net.n_lift], pairs[net.n_lift:net.n_lift + net.n_field]
    ws = net.field_layers
    gs = feats.new_zeros(feats.shape[0], net.Hh)
    gst = feats.new_zeros(dfeats.shape[0], dfeats.shape[1], net.Hh)

    def zero_off(on, x):
        return torch.where(on, x, torch.zeros_like(x))

    def field_vjp(t, h, ht, obar, otbar):
        z = torch.cat([feats, t, h], -1)
        zt = torch.cat([dfeats, torch.zeros_like(ht[..., :1]), ht], -1)
        acts = [(z @ ws[0][0].T + ws[0][1], zt @ ws[0][0].T)]
        for w, b in ws[1:-1]:
            a, at = acts[-1]
            acts.append((torch.relu(a) @ w.T + b,
                         zero_off(a[:, None] > 0, at) @ w.T))
        a, at = acts[-1]
        y = torch.tanh(a)
        s = 1.0 - y * y
        gf[-1][0].add_(obar.T @ y + torch.einsum("bdj,bdi->ji", otbar,
                                                 s[:, None] * at))
        gf[-1][1].add_(obar.sum(0))
        ybar, ytbar = obar @ ws[-1][0], otbar @ ws[-1][0]
        abar = s * ybar - 2.0 * y * s * (at * ytbar).sum(1)
        atbar = s[:, None] * ytbar
        for li in range(len(ws) - 2, 0, -1):
            a_in, at_in = acts[li - 1]
            on = a_in > 0
            gf[li][0].add_(abar.T @ torch.relu(a_in) + torch.einsum(
                "bdj,bdi->ji", atbar, zero_off(on[:, None], at_in)))
            gf[li][1].add_(abar.sum(0))
            abar = zero_off(on, abar @ ws[li][0])
            atbar = zero_off(on[:, None], atbar @ ws[li][0])
        # layer 0: the time and state columns now, the features later
        gf[0][0][:, F:].add_(abar.T @ z[:, F:] + torch.einsum(
            "bdj,bdi->ji", atbar, zt[..., F:]))
        gf[0][1].add_(abar.sum(0))
        gs.add_(abar)
        gst.add_(atbar)
        w0h = ws[0][0][:, F + 1:]
        return abar @ w0h, atbar @ w0h

    C, A, B = steppers.RK_TABLES[method]
    wr = net.readout_layer[0]
    hbar, htbar = torch.zeros_like(hs[0]), torch.zeros_like(hts[0])
    for l in range(t0.shape[1] - 1, -1, -1):
        t0l, dtl = t0[:, l:l + 1], dt[:, l:l + 1]
        dtd = dtl[:, :, None]
        h_end, ht_end = steppers.interval_tan(ws, feats, dfeats, hs[l],
                                              hts[l], t0l, dtl, n_sub, method)
        ubl, dubl = ub[:, l:l + 1], dub[:, l]
        g[-2].add_(ubl.T @ h_end + torch.einsum("bd,bdh->h", dubl,
                                                 ht_end)[None])
        g[-1].add_(ubl.sum(0))
        hbar, htbar = hbar + ubl * wr, htbar + dubl[:, :, None] * wr
        starts = [(hs[l], hts[l])]
        for k in range(n_sub - 1):
            starts.append(steppers.interval_tan(ws, feats, dfeats,
                                                *starts[-1], t0l + k * dtl,
                                                dtl, 1, method))
        for k in range(n_sub - 1, -1, -1):
            t, (h, ht) = t0l + k * dtl, starts[k]
            ys, yts = [h], [ht]
            for s in range(1, len(C)):
                kv, kt = steppers.field_fwd_tan(ws, feats, dfeats,
                                                t + C[s - 1] * dtl, ys[-1],
                                                yts[-1])
                ys.append(h + (A[s] * dtl) * kv)
                yts.append(ht + (A[s] * dtd) * kt)
            hb_in, htb_in = hbar, htbar
            kb, ktb = dtl * B[-1] * hbar, dtd * B[-1] * htbar
            for s in range(len(C) - 1, -1, -1):
                yb, ytb = field_vjp(t + C[s] * dtl, ys[s], yts[s], kb, ktb)
                hb_in, htb_in = hb_in + yb, htb_in + ytb
                if s > 0:
                    kb = dtl * B[s - 1] * hbar + (A[s] * dtl) * yb
                    ktb = dtd * B[s - 1] * htbar + (A[s] * dtd) * ytb
            hbar, htbar = hb_in, htb_in
    gf[0][0][:, :F].add_(gs.T @ feats + torch.einsum("bdj,bdi->ji", gst,
                                                      dfeats))
    xnode_train._lift_vjp(net.lift, gl, seed[:, None], dseed[:, :, None],
                          hbar, htbar)
    return torch.cat([a.reshape(-1) for a in g])


@pytest.mark.parametrize("method", ["midpoint", "rk4"])
@pytest.mark.parametrize("n_sub", [1, 2])
@pytest.mark.parametrize("ff", [0, 1])
def test_feature_sum_walk_matches_plain_f64(method, n_sub, ff):
    # the layer-0 cotangent summed over the whole walk, one feature
    # product after it: the plain version's gradient in f64, masked
    # samples (dt = 0 intervals) included
    _, _, _, tparams = shared_params(21, solver=method, fourier_features=ff)
    net32 = xnode_train.flat_net(tparams)
    net = FlatNet([a.double() for a in net32.flat], net32.n_lift,
                  net32.n_field)
    n, L, d = BASE["N_r"], BASE["N_t"], BASE["dim"]
    args = [torch.as_tensor(a).double() for a in kernel_inputs(
        n, L, d, net.F, True, n_sub, seed=22)]
    rng = np.random.default_rng(23)
    ub = torch.as_tensor(rng.normal(size=(n, L)))
    dub = torch.as_tensor(rng.normal(size=(n, L, d)))
    states = xnode_train.u_du_fwd_plain(net, *args, n_sub, method,
                                        store=True)[2:]
    torch.testing.assert_close(
        feature_sum_walk(net, *args, *states, ub, dub, n_sub, method),
        xnode_train.u_du_bwd_plain(net, *args, *states, ub, dub, n_sub,
                                   method), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name,dims,d,tile,backward,floats", [
    # 2t's net (H = 20, Hh = 10, F = 300), the full d = 100, one path a
    # tile of #5 (R = 101, S = 108): the accumulator (5,112 = round4 of
    # 5,111 weights), GS and CF (10 x 108 each), seeds and readout
    # cotangents (108 each), times (4 + 4), the start state and four
    # cotangent buffers (5 x 20 x 108), the walk (midpoint: a stage input,
    # a stage, sum, end and substep start, 5 x 20 x 108, and 2 x 9 + 2
    # field buffers of 10 x 108), the staging (101 x 20 + 101 + 2)
    ("2t #5", (20, 10, 300, 3, 9), 100, 1, True,
     5112 + 2 * 1080 + 2 * 108 + 8 + 10800 + 10800 + 21600 + 2123),
    # #3/#4 there at 4 paths (R = 404, S = 404): CF, seeds, times, the
    # state, a stage input, a stage and the stage sum, two field buffers
    ("2t #3/#4", (20, 10, 300, 3, 9), 100, 4, False,
     (10 + 1 + 4 * 20 + 2 * 10) * 404 + 8),
    # highdim_d20 (H = 24, Hh = 32, F = 60), two paths of #5 (R = 42, S =
    # 44): 12,212 = round4 of 12,209 weights, GS and CF (32 x 44 each),
    # 44 + 44 + 4 + 4, 5 x 24 x 44, the walk 5 x 24 x 44 + 20 x 32 x 44,
    # the staging 42 x 24 + 42 + 4
    ("highdim_d20 #5", (24, 32, 60, 3, 9), 20, 2, True,
     12212 + 2 * 1408 + 96 + 5280 + 5280 + 28160 + 1054),
])
def test_tile_smem_hand_counts(name, dims, d, tile, backward, floats):
    # the bytes of tile_smem_bytes, counted by hand: the floats above and
    # one int a row; the features stay in global memory
    R = tile * (1 + d)
    assert xnode_train.tile_smem_bytes(dims, d, "midpoint", tile,
                                       backward) == 4 * floats + 4 * R
