"""The adversary's kernels of the port (#6 in ``csrc/disc_fwd.cu`` and
``csrc/disc_train.cu``, #7 in ``csrc/disc_train.cu``)
through their plain versions: against the JAX package's Pallas kernels in
interpret mode, the hand-derived backward against double-backward
autograd, the fused adversary side against the JAX one, and the host side
of the CUDA wrappers that the CPU can check.

Tolerances are those of ``tests/test_fused_disc.py`` (f32): values within
``atol=5e-6``, space-time gradients within ``atol=5e-5``, weight gradients
within ``3e-5`` of ``max(1, the tensor's largest value)``. The adjoint
against autograd in f64: 1e-10.
"""

import ctypes
import os
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xnode_wan_tpu.config import SolverConfig as JConfig
from xnode_wan_tpu.models.discriminator import \
    init_discriminator as jinit_discriminator
from xnode_wan_tpu.ops.pallas import disc_train as jdisc
from xnode_wan_tpu.ops.sampling import make_domain
from xnode_wan_tpu.ops.weak_form import \
    v_phi_grads_fused as jv_phi_grads_fused
from xnode_wan_tpu_torch import (Hypercube, SolverConfig, disc_params_from_jax,
                                 init_discriminator, load_params)
from xnode_wan_tpu_torch.ops import weak_form
from xnode_wan_tpu_torch.ops.kernels import _build, disc_train
from xnode_wan_tpu_torch.ops.kernels.disc_train import FWD_TILE_THREADS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM, H, L, M = 3, 10, 3, 200
# (tied, n_freq): tied and untied, and the Fourier bank at one and two
# frequencies
CASES = [(True, 0), (False, 0), (True, 1), (True, 2), (False, 1)]


def shared_disc(tied, n_freq, seed, width=H, layers=L):
    """One discriminator for both packages, biases made non-zero so the
    relu masks split."""
    tree = jax.tree.map(np.asarray, jinit_discriminator(
        jax.random.PRNGKey(seed), DIM, width, layers, tied, n_freq))
    rng = np.random.default_rng(seed)
    hidden = [tree["hidden"]] if tied else tree["hidden"]
    for layer in [tree["inp"], *hidden, tree["out"]]:
        layer["b"] = (0.2 * rng.normal(size=layer["b"].shape)).astype(
            np.float32)
    return (jax.tree.map(jnp.asarray, tree),
            disc_params_from_jax(tree, device="cpu"))


def sample_points(n, seed):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(0, 1, (n, 1)),
                          rng.uniform(-1, 1, (n, DIM))], axis=-1)
    return pts.astype(np.float32)


def torch_layers(tparams, tied):
    hidden = [tparams.hidden] if tied else list(tparams.hidden)
    return [tparams.inp, *hidden, tparams.out]


def jax_layers(tree, tied):
    hidden = [tree["hidden"]] if tied else list(tree["hidden"])
    return [tree["inp"], *hidden, tree["out"]]


def assert_grads_close(tparams, jgrads, tied, scale_rtol=3e-5):
    for tl, jl in zip(torch_layers(tparams, tied), jax_layers(jgrads, tied)):
        for got, want in ((tl.weight.grad, np.asarray(jl["w"]).T),
                          (tl.bias.grad, np.asarray(jl["b"]))):
            scale = max(float(np.abs(want).max()), 1.0)
            np.testing.assert_allclose(got.numpy(), want,
                                       atol=scale_rtol * scale)


@pytest.mark.parametrize("tied,n_freq", CASES)
def test_plain_versions_match_pallas(tied, n_freq):
    # v_dv_fused on CPU tensors runs v_dv_fwd_plain forward and
    # v_dv_bwd_plain backward; the JAX v_dv_fused runs _v_fwd_kernel and
    # _v_bwd_kernel in interpret mode
    jparams, tparams = shared_disc(tied, n_freq, seed=1)
    pts = sample_points(M, seed=2)
    rng = np.random.default_rng(3)
    vb = rng.normal(size=M).astype(np.float32)
    gb = rng.normal(size=(M, DIM + 1)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        (jv, jdv), vjp = jax.vjp(
            lambda p: jdisc.v_dv_fused(p, jnp.asarray(pts), v_layers=L,
                                       tied=tied, n_freq=n_freq,
                                       interpret=True), jparams)
        (jgrads,) = vjp((jnp.asarray(vb), jnp.asarray(gb)))
    v, dv = disc_train.v_dv_fused(tparams, torch.as_tensor(pts), v_layers=L,
                                  tied=tied, n_freq=n_freq)
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(jv), atol=5e-6)
    np.testing.assert_allclose(dv.detach().numpy(), np.asarray(jdv),
                               atol=5e-5)
    torch.autograd.backward((v, dv), (torch.as_tensor(vb),
                                      torch.as_tensor(gb)))
    assert_grads_close(tparams, jgrads, tied)


@pytest.mark.parametrize("tied", [True, False])
def test_bwd_plain_matches_double_backward_f64(tied):
    # the hand-derived adjoint against reverse-over-reverse: gin by
    # autograd with create_graph, then the weight gradient of
    # sum(v vb) + sum(gin gb)
    _, tparams = shared_disc(tied, 1, seed=4)
    geom = disc_train.geom_of(tparams, L, tied)
    packed = torch.cat([a.reshape(-1) for a in disc_train.flat_disc(
        tparams, L, tied)]).double()
    feats = disc_train.disc_features(
        torch.as_tensor(sample_points(60, seed=5)).double(), 1)
    rng = np.random.default_rng(6)
    vb = torch.as_tensor(rng.normal(size=60))
    gb = torch.as_tensor(rng.normal(size=(60, geom.F)))
    leaf = packed.clone().requires_grad_(True)
    z = feats.clone().requires_grad_(True)
    _, _, v = disc_train._forward(geom.unpack(leaf), geom, z)
    (gin,) = torch.autograd.grad(v.sum(), z, create_graph=True)
    (want,) = torch.autograd.grad((v * vb).sum() + (gin * gb).sum(), leaf)
    got = disc_train.v_dv_bwd_plain(packed, feats, vb, gb, geom)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)
    v_p, gin_p = disc_train.v_dv_fwd_plain(packed, feats, geom)
    torch.testing.assert_close(v_p, v.detach(), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(gin_p, gin.detach(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize(
    "tied,n_freq,width,layers",
    [(True, 0, H, L), (False, 0, H, L), (True, 1, H, L), (True, 21, 72, 2)],
    ids=["True-0", "False-0", "True-1", "True-21-H72-L2"])
def test_v_phi_grads_fused_matches_jax(tied, n_freq, width, layers):
    # the fused adversary side: values and the weight gradients of the
    # contraction of tests/test_fused_disc.py; the last case is past the
    # register #6's width cap and 128 features (H = 72, F = 1 + 3 (1 + 2
    # 21) = 130), with the weights carried over from JAX
    jparams, tparams = shared_disc(tied, n_freq, seed=7, width=width,
                                   layers=layers)
    kw = dict(dim=DIM, v_layers=layers, v_hidden_dim=width, tied_v=tied,
              v_fourier_features=n_freq, N_t=5, fused_v=True)
    jcfg, tcfg = JConfig(**kw), SolverConfig(**kw)
    jdom = make_domain("Hypercube", (-1.0, 1.0), DIM, 0.0, 1.0, 5)
    tdom = Hypercube((-1.0, 1.0), DIM, 0.0, 1.0, 5)
    x = sample_points(24 * 5, seed=8).reshape(24, 5, DIM + 1)
    rng = np.random.default_rng(9)
    cv, cp = (rng.normal(size=(24, 5)).astype(np.float32) for _ in range(2))
    cd = rng.normal(size=(24, 5, DIM + 1)).astype(np.float32)

    def contraction(v, phi, dphi, lib):
        return ((v * v * lib.asarray(cv)).sum() + (phi * lib.asarray(cp)).sum()
                + (dphi * lib.asarray(cd)).sum()
                + (lib.tanh(phi) * dphi[..., 0]).sum())

    with jax.default_matmul_precision("highest"):
        # one compiled program: the contraction's gradient is the vjp of
        # its own gradient in the outputs
        def jax_side(p):
            out, vjp = jax.vjp(lambda q: jv_phi_grads_fused(
                q, jnp.asarray(x), jdom.func_w, jcfg, interpret=True), p)
            return out, vjp(jax.grad(lambda o: contraction(*o, jnp))(out))[0]

        jout, jgrads = jax.jit(jax_side)(jparams)
    tout = weak_form.v_phi_grads_fused(tparams, torch.as_tensor(x),
                                       tdom.func_w, tcfg)
    for got, want, atol in zip(tout, jout, (5e-6, 5e-6, 5e-5)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=atol)
    contraction(*tout, torch).backward()
    assert_grads_close(tparams, jgrads, tied)


def test_fused_v_side_matches_plain_side():
    # make_losses dispatches v_side by the gate: the fused side and the
    # plain create_graph side agree on the same discriminator
    _, tparams = shared_disc(True, 0, seed=10)
    cfg = SolverConfig(dim=DIM, v_layers=L, v_hidden_dim=H, N_t=5)
    dom = Hypercube((-1.0, 1.0), DIM, 0.0, 1.0, 5)
    x = torch.as_tensor(sample_points(40, seed=11).reshape(8, 5, DIM + 1))

    def v_apply(p, pts):
        from xnode_wan_tpu_torch.models.discriminator import \
            apply_discriminator
        return apply_discriminator(p, pts, L, True, 0)

    fused = weak_form.v_phi_grads_fused(tparams, x, dom.func_w, cfg)
    plain = weak_form.v_phi_and_grads(v_apply, tparams, x, dom.func_w)
    for a, b in zip(fused, plain):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=5e-6)
    with torch.no_grad():
        bare = weak_form.v_phi_and_grads(v_apply, tparams, x, dom.func_w)
    assert all(a.grad_fn is None for a in bare)
    for a, b in zip(bare, plain):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)


def test_over_cap_v_side_plain_on_cpu_raises_elsewhere():
    # fused_v with a discriminator past the JAX package's Pallas bound (F
    # + H (2 L + 4) + 2 = 4 + 32 * 404 + 2 rows > 12,288), where JAX takes
    # its XLA side: CPU tensors take the plain side, any other device is
    # refused by name
    width, layers = 32, 200
    cfg = SolverConfig(dim=DIM, v_layers=layers, v_hidden_dim=width, N_t=5,
                       fused_v=True)
    dom = Hypercube((-1.0, 1.0), DIM, 0.0, 1.0, 5)
    tparams = init_discriminator(DIM, width, layers, True, 0, device="cpu")
    assert not disc_train.v_fused_fits(tparams, layers, True)
    pfits = {"inp": {"w": np.zeros((DIM + 1, 1))},
             "out": {"w": np.zeros((width, 1))}}
    assert not jdisc.v_fused_fits(pfits, DIM + 1, layers, True)

    def v_apply(p, pts):
        from xnode_wan_tpu_torch.models.discriminator import \
            apply_discriminator
        return apply_discriminator(p, pts, layers, True, 0)

    v_side = weak_form.make_losses(None, dom, cfg, None, v_apply).v_side
    x = torch.as_tensor(sample_points(40, seed=15).reshape(8, 5, DIM + 1))
    counts = [disc_train.FWD_LAUNCHES.launches,
              disc_train.BWD_LAUNCHES.launches]
    got = v_side(tparams, SimpleNamespace(x=x))
    want = weak_form.v_phi_and_grads(v_apply, tparams, x, dom.func_w)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="domain.*12934 rows, at most 12288"):
        v_side(tparams, SimpleNamespace(x=x.to("meta")))
    assert counts == [disc_train.FWD_LAUNCHES.launches,
                      disc_train.BWD_LAUNCHES.launches]


def test_fused_v_gate():
    base = dict(dim=2, fused_v=True)
    assert weak_form.fused_v_gate(SolverConfig(**base))
    assert not weak_form.fused_v_gate(SolverConfig(dim=2))
    assert not weak_form.fused_v_gate(SolverConfig(**base, x64=True))
    assert not weak_form.fused_v_gate(SolverConfig(**base, fused_grad=False))


def test_live_packed_carries_grad_and_ties_once():
    for tied in (True, False):
        _, tparams = shared_disc(tied, 0, seed=12)
        geom = disc_train.geom_of(tparams, L, tied)
        live = disc_train.live_packed_disc(tparams, L, tied)
        assert live.shape == (geom.n_params,)
        flat = disc_train.flat_disc(tparams, L, tied)
        assert len(flat) == 2 * (2 + geom.n_hidden)
        torch.testing.assert_close(live.detach(),
                                   torch.cat([a.reshape(-1) for a in flat]))
        pairs = geom.unpack(live.detach())
        assert pairs[1][0].data_ptr() != pairs[-1][0].data_ptr()
        torch.testing.assert_close(pairs[1][0], flat[2].reshape(H, H))
        live.sum().backward()
        assert all(bool((p.grad == 1).all()) for p in tparams.parameters())


def cuda_signature(source, symbol):
    text = (_build.CSRC / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)", text, re.S)
    assert m, f"{symbol} not found in {source}.cu"
    return [p.strip() for p in m.group(1).split(",")]


@pytest.mark.parametrize("kernel", [disc_train.FWD_KERNEL,
                                    disc_train.BWD_KERNEL,
                                    disc_train.FWD_TILE_KERNEL,
                                    disc_train.BWD_GLOBAL_KERNEL,
                                    disc_train.BWD_CLUSTER_KERNEL],
                         ids=lambda k: k.symbol)
def test_disc_ctypes_argtypes_match_c_signature(kernel):
    # the register #6 has a source of its own, built once per width; #7's
    # three variants and the tile #6 are in disc_train.cu (the cluster
    # variant's kernel in disc_train_cluster.cuh, the tile #6's in
    # disc_tile_fwd.cuh), built once. Each block size is a compile-time
    # constant of its source, mirrored in the wrapper.
    bwd = ("disc_train", "XD_BWD_THREADS", disc_train.BWD_THREADS,
           "disc_train.cu")
    source, define, threads, where = {
        "disc_fwd_launch": ("disc_fwd", "XD_FWD_THREADS",
                            disc_train.FWD_THREADS, "disc_fwd.cu"),
        "disc_bwd_launch": bwd, "disc_bwd_global_launch": bwd,
        "disc_bwd_cluster_launch": bwd,
        "disc_tile_fwd_launch": ("disc_train", "XF_THREADS",
                                 disc_train.FWD_TILE_THREADS,
                                 "disc_tile_fwd.cuh")}[kernel.symbol]
    assert kernel.source == source
    assert source in _build.KERNEL_SOURCES
    params = cuda_signature(source, kernel.symbol)
    declared = [ctypes.c_int, ctypes.c_void_p] + kernel.argtypes
    assert len(params) == len(declared)
    for p, ct in zip(params, declared):
        assert ct is (ctypes.c_void_p if "*" in p else ctypes.c_int), p
    text = (_build.CSRC / where).read_text()
    assert re.findall(r"#define " + define + r" (\d+)", text) == [str(threads)]


def test_disc_kernel_variants_count_together():
    # #6's register and tile variants, and #7's three accumulators, each
    # count as one kernel, read by variant
    assert disc_train.FWD_LAUNCHES.variants == {
        "registers": disc_train.FWD_KERNEL,
        "tile": disc_train.FWD_TILE_KERNEL}
    assert disc_train.BWD_LAUNCHES.variants == {
        "shared": disc_train.BWD_KERNEL,
        "cluster": disc_train.BWD_CLUSTER_KERNEL,
        "global": disc_train.BWD_GLOBAL_KERNEL}
    variants = disc_train.BWD_LAUNCHES.variants.values()
    kept = [k.launches for k in variants]
    try:
        for k, n in zip(variants, (2, 7, 3)):
            k.launches = n
        assert disc_train.BWD_LAUNCHES.launches == 12
        assert disc_train.BWD_LAUNCHES.by_variant() == {
            "shared": 2, "cluster": 7, "global": 3}
        disc_train.BWD_LAUNCHES.launches = 0
        assert disc_train.BWD_LAUNCHES.by_variant() == {
            "shared": 0, "cluster": 0, "global": 0}
    finally:
        for k, n in zip(variants, kept):
            k.launches = n


@pytest.mark.parametrize("symbol,ints", [
    ("disc_tile_smem_bytes", 6), ("disc_cluster_smem_bytes", 5),
    ("disc_cluster_occupancy", 6)])
def test_disc_host_entry_points_take_ints(symbol, ints):
    # the shared-memory rules' C twins (chip_smoke.py's phase 1 holds them
    # against tile_smem_bytes and cluster_smem_bytes) and the cluster
    # variant's occupancy (disc_train.cluster_occupancy) take only ints,
    # as their callers declare them
    text = (_build.CSRC / "disc_train.cu").read_text()
    m = re.search(r'extern "C" (?:long long|int) ' + symbol + r"\((.*?)\)",
                  text, re.S)
    assert m, symbol
    params = [p.strip() for p in m.group(1).split(",")]
    assert len(params) == ints
    assert all(p.startswith("int ") for p in params)


def test_disc_cuda_wrappers_reject_cpu_tensors():
    _, tparams = shared_disc(True, 0, seed=13)
    geom = disc_train.geom_of(tparams, L, True)
    packed = torch.cat([a.reshape(-1) for a in disc_train.flat_disc(
        tparams, L, True)])
    feats = torch.as_tensor(sample_points(9, seed=14))
    counts = [disc_train.FWD_LAUNCHES.launches,
              disc_train.BWD_LAUNCHES.launches]
    with pytest.raises(ValueError, match="CUDA device"):
        disc_train.v_dv_fwd_cuda(packed, feats, geom)
    with pytest.raises(ValueError, match="CUDA device"):
        disc_train.v_dv_bwd_cuda(packed, feats, torch.zeros(9),
                                 torch.zeros(9, geom.F), geom)
    # past the Pallas bound: 4 + 10 (2 * 2000 + 4) + 2 rows
    with pytest.raises(ValueError, match="domain.*40046 rows"):
        disc_train.v_dv_fwd_cuda(packed, feats, geom._replace(L=2000))
    with pytest.raises(ValueError, match="no disc kernel"):
        disc_train.VDvFused.apply(packed.to("meta"), geom, feats.to("meta"))
    assert counts == [disc_train.FWD_LAUNCHES.launches,
                      disc_train.BWD_LAUNCHES.launches]


def test_fits_gate_and_tiles():
    # the shipped d=5 and d=20 adversaries take the register #6 and the
    # shared #7, tied or not (#7 takes 32-point tiles for the tied d=5 net,
    # 16 for the untied d=5 and the tied d=20 ones, 8 for the untied d=20
    # one); test_fused_disc.py::test_fits_gate's absurd geometry is past
    # the Pallas bound
    for name, tiles in (("cube_pde", (32, 16)), ("highdim_d20", (16, 8))):
        cfg = load_params(os.path.join(REPO, "configs", f"{name}.yaml"))
        for tied, tile in zip((True, False), tiles):
            p = init_discriminator(cfg.dim, cfg.v_hidden_dim, cfg.v_layers,
                                   tied, cfg.v_fourier_features,
                                   device="cpu")
            assert disc_train.v_fused_fits(p, cfg.v_layers, tied), name
            geom = disc_train.geom_of(p, cfg.v_layers, tied)
            assert disc_train.disc_route(geom) == ("registers", 0, "shared",
                                                   tile, 1)
    # by hand: 2 (L + 1) H + 2 H + 2 F + 1 rows of tile + 4 floats (tile
    # floats at 8 points), then the n_params accumulator
    geom = disc_train.DiscGeom(F=6, H=50, L=9, tied=True)
    assert geom.n_params == 2951
    smem = disc_train.tile_smem_bytes
    assert smem(geom, "shared", 32) == 4 * (2951 + 36 * 1113)
    assert smem(geom, "shared", 32) == 172076
    d20 = disc_train.DiscGeom(F=61, H=64, L=9, tied=False)
    assert d20.n_params == 41473
    assert smem(d20, "shared", 8) == 4 * (41473 + 8 * 1531)
    assert smem(d20, "shared", 8) == 214884
    assert smem(d20, "shared", 16) > 232448
    big = init_discriminator(50, 400, 40, False, 4, device="cpu")
    assert not disc_train.v_fused_fits(big, 40, False)
    with pytest.raises(ValueError, match="domain"):
        disc_train.disc_route(disc_train.geom_of(big, 40, False))
    # past the old caps (F = 128, L = 32): its 141,441 weights fit no
    # shared accumulator and its staged copy no register #6 block, so the
    # tile #6 at 128 points and, untied, #7's global accumulator at 8
    wide = disc_train.DiscGeom(F=128, H=64, L=32, tied=False)
    assert smem(wide, "shared", 4) > 232448
    assert disc_train.disc_route(wide) == ("tile", 128, "global", 8, 1)


@pytest.mark.parametrize("source", ["disc_fwd", "disc_train"])
def test_disc_fwd_nvcc_command_per_width(source):
    # the register #6 is built once per adversary width, with -DXD_H=<H>;
    # disc_train.cu (#7, the tile #6) once, with every width at run time
    if source == "disc_train":
        lib = _build.library_path(source)
        assert lib.name == "libdisc_train.so"
        assert lib.parent == _build.build_dir()
        cmd = _build.nvcc_command(source, None, lib)
        assert cmd[-1] == str(_build.CSRC / "disc_train.cu")
        assert not any(a.startswith("-D") for a in cmd)
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "--use_fast_math" not in cmd
        for widths in ((50,), (50, 10)):
            with pytest.raises(ValueError, match="width"):
                _build.nvcc_command(source, widths, "lib.so")
        return
    libs = [_build.library_path(source, (H,)) for H in (50, 64)]
    assert [p.name for p in libs] == [f"lib{source}_H50.so",
                                      f"lib{source}_H64.so"]
    assert all(p.parent == _build.build_dir() for p in libs)
    cmd = _build.nvcc_command(source, (64,), libs[1])
    assert cmd[-1] == str(_build.CSRC / f"{source}.cu")
    assert "-DXD_H=64" in cmd and not any(a.startswith("-DXN_") for a in cmd)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "--use_fast_math" not in cmd
    for widths in (None, (50, 10)):
        with pytest.raises(ValueError, match="width"):
            _build.nvcc_command(source, widths, "lib.so")
    with pytest.raises(ValueError, match="width"):
        _build.library_path(source, None)


def tile_walk(packed, feats, vb, gb, geom, tile, blocks):
    """Kernel #7's algorithm in torch: block ``b`` walks tiles ``b, b +
    blocks, ...`` of ``tile`` points, zero past ``M``; per tile the
    forward keeps ``relu(a_i)`` (``i < L``) and ``a_L``, the sweep's
    reverse masks each product at its output by the next layer's sign, and
    every weight cotangent is added into the block's partial; the partials
    are summed in block order.

    A copy of the algorithm, not of the ``.cu``: it shows that the tile
    walk, the relu outputs standing in for the masks and the masks applied
    at the outputs give the plain version's gradient, and nothing ties it
    to the kernel's code. The kernel is held on the card by
    ``chip_smoke.py``'s phase 3."""
    pairs = geom.unpack(packed)
    (w0, b0), (wo, _) = pairs[0], pairs[-1]
    L, n_tiles = geom.L, -(-feats.shape[0] // tile)
    pad = n_tiles * tile - feats.shape[0]
    z_all, gb_all = (torch.cat([a, a.new_zeros(pad, a.shape[1])])
                     for a in (feats, gb))
    vb_all = torch.cat([vb, vb.new_zeros(pad)])

    def hid(i):
        return geom.hidden(pairs, i)

    def where(m, x):
        return torch.where(m > 0, x, torch.zeros_like(x))

    grad = torch.zeros_like(packed)
    for b in range(blocks):
        acc = torch.zeros_like(packed)
        gp = geom.unpack(acc)
        for t in range(b, n_tiles, blocks):
            z, g_b, v_b = (a[t * tile:(t + 1) * tile]
                           for a in (z_all, gb_all, vb_all))
            A = [torch.relu(z @ w0.T + b0)]
            for i in range(L):
                a = A[i] @ hid(i)[0].T + hid(i)[1]
                A.append(torch.relu(a) if i + 1 < L else a)
            y = torch.tanh(A[L])
            G = [None] * L + [wo * (1.0 - y * y)]
            for i in range(L - 1, -1, -1):
                G[i] = where(A[i], G[i + 1] @ hid(i)[0])
            tb = where(A[0], g_b @ w0.T)
            gp[0][0].add_(G[0].T @ g_b)
            for i in range(L):
                geom.hidden(gp, i)[0].add_(G[i + 1].T @ tb)
                nxt = tb @ hid(i)[0].T
                tb = where(A[i + 1], nxt) if i + 1 < L else nxt
            s = 1.0 - y * y
            gp[-1][0].add_((tb * s + v_b[:, None] * y).sum(0, keepdim=True))
            gp[-1][1].add_(v_b.sum())
            abar = (v_b[:, None] * wo - 2.0 * y * wo * tb) * s
            for i in range(L - 1, -1, -1):
                gw, gbias = geom.hidden(gp, i)
                gw.add_(abar.T @ A[i])
                gbias.add_(abar.sum(0))
                abar = where(A[i], abar @ hid(i)[0])
            gp[0][0].add_(abar.T @ z)
            gp[0][1].add_(abar.sum(0))
        grad += acc
    return grad


@pytest.mark.parametrize("tied,n_freq,n_points,tile,blocks",
                         [(True, 0, 77, 32, 2), (False, 0, 37, 8, 3),
                          (True, 1, 40, 16, 5)])
def test_bwd_tile_walk_matches_plain_f64(tied, n_freq, n_points, tile,
                                         blocks):
    # ragged last tiles, blocks with no tile (40 points, 3 tiles, 5
    # blocks), relu outputs standing in for the masks
    _, tparams = shared_disc(tied, n_freq, seed=16)
    geom = disc_train.geom_of(tparams, L, tied)
    packed = torch.cat([a.reshape(-1) for a in disc_train.flat_disc(
        tparams, L, tied)]).double()
    feats = disc_train.disc_features(torch.as_tensor(
        sample_points(n_points, seed=17)).double(), n_freq)
    rng = np.random.default_rng(18)
    vb = torch.as_tensor(rng.normal(size=n_points))
    gb = torch.as_tensor(rng.normal(size=(n_points, geom.F)))
    torch.testing.assert_close(
        tile_walk(packed, feats, vb, gb, geom, tile, blocks),
        disc_train.v_dv_bwd_plain(packed, feats, vb, gb, geom),
        rtol=1e-10, atol=1e-10)


def fwd_tile_walk(packed, feats, geom, tile, k_slice, width, blocks):
    """The tile #6's algorithm in torch: block ``b`` walks tiles ``b, b +
    blocks, ...`` of ``tile`` points, zero past ``M``; each product runs
    its outputs in passes of ``width`` and its inputs in slices of
    ``k_slice``, the forward keeps the relu signs of ``a_0 .. a_{L-1}`` as
    booleans (the bits) and only two activation buffers, ``v`` sums
    ``FWD_TILE_THREADS / tile`` ranges of units in order and adds the
    ranges in order, ``G_L`` replaces ``y``, the sweep masks each product
    at its output, and ``gin`` is written for the live points only.

    A copy of the algorithm, not of the ``.cuh``: it shows that the walk
    gives the plain version's outputs, and nothing ties it to the
    kernel's code. The kernel is held on the card by ``chip_smoke.py``'s
    phase 3."""
    pairs = geom.unpack(packed)
    (w0, b0), (wo, bo) = pairs[0], pairs[-1]
    M, F, H, L = feats.shape[0], geom.F, geom.H, geom.L
    n_tiles = -(-M // tile)
    z_all = torch.cat([feats, feats.new_zeros(n_tiles * tile - M, F)])
    v = torch.full((M,), float("nan"), dtype=feats.dtype)
    gin = torch.full((M, F), float("nan"), dtype=feats.dtype)

    def product(w, x):
        # W(o, k) = w[o, k]: passes of outputs, slices of inputs in order
        O, K = w.shape
        out = x.new_zeros(O, x.shape[1])
        for ob0 in range(0, O, width):
            acc = x.new_zeros(min(width, O - ob0), x.shape[1])
            for k0 in range(0, K, k_slice):
                acc += w[ob0:ob0 + width, k0:k0 + k_slice] @ \
                    x[k0:k0 + k_slice]
            out[ob0:ob0 + width] = acc
        return out

    ranges = FWD_TILE_THREADS // tile
    for b in range(blocks):
        for t in range(b, n_tiles, blocks):
            m0, n = t * tile, min(tile, M - t * tile)
            a = z_all[m0:m0 + tile].T                       # [F, tile]
            signs = []
            for q in range(L + 1):
                w, bias = pairs[0] if q == 0 else geom.hidden(pairs, q - 1)
                a = product(w, a) + bias[:, None]
                if q < L:
                    signs.append(a > 0)
                    a = torch.relu(a)
            y = torch.tanh(a)
            parts = [(wo[0, H * r // ranges:H * (r + 1) // ranges, None]
                      * y[H * r // ranges:H * (r + 1) // ranges]).sum(0)
                     for r in range(ranges)]
            total = parts[0]
            for part in parts[1:]:
                total = total + part
            v[m0:m0 + n] = (total + bo)[:n]
            g = wo[0, :, None] * (1.0 - y * y)              # G_L
            for i in range(L - 1, -1, -1):
                g = torch.where(signs[i], product(geom.hidden(pairs, i)[0].T,
                                                  g), torch.zeros_like(g))
            gin[m0:m0 + n] = product(w0.T, g).T[:n]
    return v, gin


@pytest.mark.parametrize(
    "tied,n_freq,n_points,tile,k_slice,width,blocks",
    [(True, 0, 77, 32, 8, 16, 2), (False, 0, 37, 8, 16, 8, 3),
     (True, 1, 40, 16, 24, 16, 5)])
def test_fwd_tile_walk_matches_plain_f64(tied, n_freq, n_points, tile,
                                         k_slice, width, blocks):
    # ragged last tiles, blocks with several tiles and with none (40
    # points, 3 tiles, 5 blocks), a last pass of fewer outputs (40 units
    # in passes of 16; 10 in passes of 8; gin's F = 10 at 16), a last
    # slice of fewer inputs (40 in slices of 8 or 24, 10 in slices of 16)
    _, tparams = shared_disc(tied, n_freq, seed=19, width=40 if tied else H)
    geom = disc_train.geom_of(tparams, L, tied)
    packed = torch.cat([a.reshape(-1) for a in disc_train.flat_disc(
        tparams, L, tied)]).double()
    feats = disc_train.disc_features(torch.as_tensor(
        sample_points(n_points, seed=20)).double(), n_freq)
    v, gin = fwd_tile_walk(packed, feats, geom, tile, k_slice, width,
                           blocks)
    v_p, gin_p = disc_train.v_dv_fwd_plain(packed, feats, geom)
    torch.testing.assert_close(v, v_p, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(gin, gin_p, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("source,table", [
    ("disc_tile_fwd.cuh", "FWD_ABLATIONS"),
    ("disc_train_cluster.cuh", "ABLATIONS")])
def test_tile_sweep_ablations_cut_the_sources(source, table):
    # tile_sweep.py --adversary --ablate builds copies of the kernels with
    # text cut out (every occurrence): every cut must still name text of
    # its source
    from xnode_wan_tpu_torch import tile_sweep

    text = (_build.CSRC / source).read_text()
    for part, cuts in getattr(tile_sweep, table).items():
        for old, _ in cuts:
            assert old in text, (part, old)


def test_disc_fwd_staged_copy_hand_count():
    # by columns, each padded to a multiple of four floats, then the bias:
    # d=5 (F = 6, H = 50 -> 52): layer 0 (6 + 1) * 52, hidden (50 + 1) *
    # 52 once when tied or nine times, output <1, 50> (50 + 1) * 4; d=20
    # with its Fourier bank (F = 61, H = 64): 62 * 64 + 65 * 64 + 65 * 4
    tied5 = disc_train.DiscGeom(F=6, H=50, L=9, tied=True)
    assert disc_train.staged_floats(tied5) == 364 + 2652 + 204 == 3220
    untied5 = tied5._replace(tied=False)
    assert disc_train.staged_floats(untied5) == 364 + 9 * 2652 + 204 == 24436
    d20 = disc_train.DiscGeom(F=61, H=64, L=9, tied=True)
    assert disc_train.staged_floats(d20) == 3968 + 4160 + 260 == 8388
    # for each of the block's 128 threads its sign words, ceil(H / 32) a
    # layer, and its slot of H floats
    assert disc_train.fwd_smem_bytes(tied5) == 4 * (3220 + (18 + 50) * 128)
    assert disc_train.fwd_smem_bytes(d20) == 4 * (8388 + (18 + 64) * 128)
    assert disc_train.fwd_smem_bytes(untied5) == 4 * (24436 + 68 * 128)


def stage_by_columns(flat):
    """Kernel #6's staged copy, built in torch from ``flat_disc``'s
    ``(W, b)`` pairs: each layer's columns at a stride of ``out`` rounded
    up to four, then ``b``; NaN in the padding. Returns the buffer and the
    offset of each layer."""
    segs, offs, size = [], [], 0
    for w, b in zip(flat[::2], flat[1::2]):
        out, inp = w.shape
        cols = torch.full((inp + 1, -(-out // 4) * 4), float("nan"))
        cols[:inp, :out] = w.T
        cols[inp, :out] = b
        segs.append(cols.reshape(-1))
        offs.append(size)
        size += cols.numel()
    return torch.cat(segs), offs


@pytest.mark.parametrize("dim,width,layers,tied,n_freq",
                         [(5, 50, 9, True, 0), (5, 50, 9, False, 0),
                          (20, 64, 9, True, 1), (2, 7, 3, False, 2)])
def test_disc_fwd_staged_layout_rebuilds_the_weights(dim, width, layers, tied,
                                                     n_freq):
    # pack by columns, then read every W and b back by the layout's
    # offsets: the twin's size is the end of the walk, and nothing but the
    # padding is left unwritten
    p = init_discriminator(dim, width, layers, tied, n_freq, device="cpu")
    geom = disc_train.geom_of(p, layers, tied)
    flat = disc_train.flat_disc(p, layers, tied)
    buf, offs = stage_by_columns(flat)
    assert buf.numel() == disc_train.staged_floats(geom)
    H, F, so = geom.H, geom.F, -(-geom.H // 4) * 4
    shapes = [(H, F)] + [(H, H)] * geom.n_hidden + [(1, H)]
    assert len(offs) == len(shapes) == len(flat) // 2
    n_pad = 0
    for (out, inp), off, w, b in zip(shapes, offs, flat[::2], flat[1::2]):
        s_out = -(-out // 4) * 4
        seg = buf[off:off + (inp + 1) * s_out].view(inp + 1, s_out)
        torch.testing.assert_close(seg[:inp, :out].T, w.reshape(out, inp),
                                   rtol=0, atol=0)
        torch.testing.assert_close(seg[inp, :out], b, rtol=0, atol=0)
        n_pad += (inp + 1) * (s_out - out)
    assert int(torch.isnan(buf).sum()) == n_pad
    assert so * (F + 1) == offs[1]
