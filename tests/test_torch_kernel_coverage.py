"""Every primal net the JAX package trains gets a hand-written kernel in
the port: for each geometry of the grid below, the JAX package trains the
net (through its Pallas kernels at the full d, in ``d_chunk`` tangent
chunks, or through its XLA u side, ``xnode_wan_tpu/ops/weak_form.py``),
and the port's wrappers pick a variant of kernels #1-#5 from the shapes
alone, without raising, unless one path with one tangent direction does
not fit one block's shared memory, where they raise before any launch.

Host arithmetic only: the kernels' shared-memory rules and the JAX
package's VMEM predicates, no launch.
"""

import numpy as np
import pytest
import torch

from xnode_wan_tpu.ops.pallas import xnode_train as jtrain
from xnode_wan_tpu_torch import SolverConfig, init_xnode
from xnode_wan_tpu_torch.ops.kernels import xnode_eval, xnode_train
from xnode_wan_tpu_torch.ops.kernels.steppers import (FUSED_KERNEL_METHODS,
                                                      MAX_SMEM_BYTES,
                                                      register_fits)

DIMS = (5, 20, 50, 100)
WIDTHS = ((20, 10), (24, 32), (48, 48), (64, 64), (96, 64))
GRID = [(d, H, Hh, ff) for d in DIMS for H, Hh in WIDTHS for ff in (0, 1)]


def net_of(**kw):
    cfg = SolverConfig(**kw)
    return cfg, xnode_train.flat_net(init_xnode(cfg, device="cpu"))


def jax_route(dims, d: int, cfg) -> str:
    """The u side the JAX package trains this net with (``weak_form.py``
    ``u_side``): its predicates read only the shapes of the weights."""
    H, Hh, F, n_lift, n_field = dims
    params = {"lift": [{"w": np.zeros((1, H))}] * n_lift,
              "field": [{"w": np.zeros((1, Hh))}] * n_field}
    args = (params, cfg.N_t, d, F, cfg.n_sub, cfg.solver)
    if jtrain.fused_fits(*args):
        return "pallas"
    if jtrain.fused_chunk(*args) is not None:
        return "pallas d_chunk"
    return "xla"


def one_path_fits(dims, method) -> bool:
    """One path with one direction fits #3/#4's block and #5's block
    without its accumulator: the bound that remains."""
    return (xnode_train.tile_smem_bytes(dims, 1, method, 1, False)
            <= MAX_SMEM_BYTES
            and xnode_train.tile_smem_bytes(dims, 1, method, 1, True,
                                            "global") <= MAX_SMEM_BYTES)


def fits(dims, d, method, tile, backward):
    return xnode_train.tile_smem_bytes(
        dims, d, method, tile.paths, backward, tile.variant,
        tile.cluster) <= MAX_SMEM_BYTES


def bwd_order(dims, d, method):
    """#5's variant by the route's order: shared where its accumulator
    fits beside one path, else the smallest cluster whose block fits one
    path, else global."""
    if xnode_train.tile_smem_bytes(dims, d, method, 1, True) <= MAX_SMEM_BYTES:
        return "shared", 1
    for c in xnode_train.CLUSTERS:
        if (min(dims[0], dims[1]) >= c and xnode_train.cluster_smem_bytes(
                dims, d, method, 1, c) <= MAX_SMEM_BYTES):
            return "cluster", c
    return "global", 1


@pytest.mark.parametrize("d,H,Hh,ff", GRID,
                         ids=[f"d{d}-{H}x{Hh}-ff{ff}" for d, H, Hh, ff in GRID])
def test_port_routes_every_net_the_jax_package_trains(d, H, Hh, ff):
    for method in FUSED_KERNEL_METHODS:
        cfg, net = net_of(dim=d, u_hidden_dim=H, u_hidden_hidden_dim=Hh,
                          fourier_features=ff, solver=method)
        dims = net.dims()
        assert jax_route(dims, d, cfg) in ("pallas", "pallas d_chunk", "xla")
        if not one_path_fits(dims, method):
            with pytest.raises(ValueError, match="one path with one tangent"):
                xnode_train.kernel_route(dims, d, method)
            continue
        route = xnode_train.kernel_route(dims, d, method)
        # #1/#2: the register kernels within their caps, else the path-tile
        # kernel, whose block fits; the same without tangents
        assert route.path == ("registers" if register_fits(dims) else "tile")
        assert xnode_train.kernel_route(dims, 0, method)[:2] == route[:2]
        if route.path == "registers":
            net.check_caps()
        else:
            assert xnode_train.path_tile_smem_bytes(
                dims, method, *route.path_tile) <= MAX_SMEM_BYTES
        # #3-#5: a divisor of d, the full d wherever its tiles fit
        dc = route.d_chunk
        assert d % dc == 0
        assert fits(dims, dc, method, route.fwd, False)
        assert fits(dims, dc, method, route.bwd, True)
        # #5: shared, then cluster, then global; the largest tile listed
        # that fits the variant's block
        bwd = route.bwd
        assert (bwd.variant, bwd.cluster) == bwd_order(dims, dc, method)
        if bwd.variant == "cluster":
            larger = [t for t in xnode_train.CLUSTER_TILES if t > bwd.paths]
            assert all(xnode_train.cluster_smem_bytes(
                dims, dc, method, t, bwd.cluster) > MAX_SMEM_BYTES
                for t in larger)
            assert bwd.threads <= xnode_train.MAX_THREADS
        full = (xnode_train.tile_smem_bytes(dims, d, method, 1, False)
                <= MAX_SMEM_BYTES
                and xnode_train.tile_smem_bytes(dims, d, method, 1, True,
                                                "global") <= MAX_SMEM_BYTES)
        assert (dc == d) == full
        # the largest such divisor: at a larger one, #3/#4 has no tile, or
        # one path does not fit one block of #5 without its accumulator
        # (#5's cluster variant may fit there, and does not move the chunk)
        for larger in range(dc + 1, d + 1):
            if d % larger == 0:
                if (xnode_train.tile_smem_bytes(dims, larger, method, 1,
                                                False) <= MAX_SMEM_BYTES):
                    assert xnode_train.tile_smem_bytes(
                        dims, larger, method, 1, True,
                        "global") > MAX_SMEM_BYTES
                else:
                    with pytest.raises(ValueError):
                        xnode_train.grad_tile(dims, larger, method, False)


def test_wide_cube_takes_kernel_5_on_a_cluster_of_blocks():
    # the cube at u_hidden_dim = u_hidden_hidden_dim = 64, d = 5: the
    # accumulator (46,337 floats) does not fit beside the block, so #5
    # runs on clusters of two blocks, each with half the units, half the
    # accumulator and its slice of a 4-path tile
    cfg, net = net_of(dim=5, u_hidden_dim=64, u_hidden_hidden_dim=64)
    dims = net.dims()
    assert xnode_train.n_params_of(dims) == 46337
    tile = xnode_train.grad_tile(dims, 5, cfg.solver, True)
    assert tile == xnode_train.GradTile(4, 256, "cluster", 2)
    assert tile.variant == "cluster"
    assert xnode_train.tile_smem_bytes(dims, 5, cfg.solver, 1,
                                       True) > MAX_SMEM_BYTES
    assert fits(dims, 5, cfg.solver, tile, True)
    assert xnode_train.kernel_route(dims, 5, cfg.solver).d_chunk == 5
    assert xnode_train.kernel_route(dims, 5, cfg.solver).bwd == tile


def test_d30_fourier_chunk_takes_kernel_5_on_a_cluster_of_blocks():
    # 2u's net: d = 30, H = Hh = 48, F = 90; with the features out of the
    # tiles one path of the full d fits one block of #3/#4 and of #5's
    # global variant (227,712 bytes; 233,760 with its 90 feature rows, when
    # the chunk was 15), and #5 stays on clusters of two blocks, one path
    # a tile
    cfg, net = net_of(dim=30, u_hidden_dim=48, u_hidden_hidden_dim=48,
                      fourier_features=1)
    dims = net.dims()
    assert net.F == 90
    route = xnode_train.kernel_route(dims, 30, cfg.solver)
    assert route.d_chunk == 30
    assert xnode_train.tile_smem_bytes(dims, 30, cfg.solver, 1, True,
                                       "global") == 227712
    assert route.bwd.variant == "cluster" and route.bwd.cluster == 2
    assert route.bwd.paths == 1
    assert fits(dims, 30, cfg.solver, route.bwd, True)
    assert not fits(dims, 30, cfg.solver, route.bwd._replace(
        paths=2 * route.bwd.paths), True)


def test_wide_field_keeps_kernel_5_with_its_accumulator_in_global_memory():
    # H = 64, Hh = 256 at d = 5: 2,014,724 bytes of accumulator, more than
    # eight blocks' shared memory; the JAX package trains it at d_chunk 1,
    # and #5 keeps its global variant there
    cfg, net = net_of(dim=5, u_hidden_dim=64, u_hidden_hidden_dim=256)
    dims = net.dims()
    assert 4 * xnode_train.n_params_of(dims) == 2014724
    assert all(xnode_train.cluster_acc_floats(dims, c) * 4 > MAX_SMEM_BYTES
               for c in xnode_train.CLUSTERS)
    route = xnode_train.kernel_route(dims, 5, cfg.solver)
    assert route.d_chunk == 1
    assert route.bwd == route.bwd._replace(variant="global", cluster=1)
    assert fits(dims, 1, cfg.solver, route.bwd, True)


UNIT_WIDTHS = sorted({w for pair in WIDTHS for w in pair}
                     | {0, 1, 5, 7, 90, 300})


@pytest.mark.parametrize("cluster", [2, 4, 8])
def test_cluster_unit_slices_cover_every_unit_once(cluster):
    # each layer's units split over a cluster's blocks: every unit in one
    # block's slice, the slices in rank order, none wider than the layout's
    # widest (the widths of every layer of the grid, the features too)
    for width in UNIT_WIDTHS:
        slices = xnode_train.unit_slices(width, cluster)
        assert len(slices) == cluster
        assert [u for s in slices for u in s] == list(range(width))
        assert max(len(s) for s in slices) == -(-width // cluster)
        assert max(len(s) for s in slices) - min(len(s) for s in slices) <= 1


def test_d100_fourier_cube_runs_in_tangent_chunks_and_tile_variant():
    # d = 100 with fourier_features 1: F = 300, which #1/#2's register
    # kernel takes (its feature columns are staged nowhere; before, F + 1
    # + H above 128 sent it to the path-tile variant); with the features
    # out of the tiles #3-#5 take the full d in one chunk (two chunks of 50
    # while each tile kept its 300 feature rows), #5 with its accumulator
    # in shared memory, one path a tile
    cfg, net = net_of(dim=100, fourier_features=1)
    assert net.F == 300 and register_fits(net.dims())
    route = xnode_train.kernel_route(net.dims(), 100, cfg.solver)
    assert route.path == "registers" and route.d_chunk == 100
    assert route.bwd.variant == "shared" and route.bwd.paths == 1


def test_wide_nets_reach_the_wrappers_past_the_caps():
    # no cap is raised before the device check: the CPU tensors are
    # refused for being on the CPU, not for the net's widths
    _, net = net_of(dim=5, u_hidden_dim=96, u_hidden_hidden_dim=64)
    assert not register_fits(net.dims())
    m, L = 4, 3
    f32 = dict(dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA device"):
        xnode_train.path_forward_cuda(
            net, torch.zeros((m, L), **f32), torch.zeros((m, L), **f32),
            torch.zeros((m, net.F), **f32), torch.zeros(m, **f32), 1,
            "midpoint")
    with pytest.raises(ValueError, match="CUDA device"):
        xnode_eval.evaluate_cuda(net, torch.zeros((m, net.F), **f32),
                                 torch.ones(m, **f32), torch.zeros(m, **f32),
                                 torch.zeros(m, **f32), 4, "midpoint")
    # the register kernels themselves still refuse it
    with pytest.raises(ValueError, match="cap"):
        net.check_caps()


TILE_NETS = [(72, 80), (96, 64), (128, 128), (256, 256)]


@pytest.mark.parametrize("H,Hh", TILE_NETS,
                         ids=[f"{H}x{Hh}" for H, Hh in TILE_NETS])
def test_path_tile_rule_fits_shared_memory(H, Hh):
    # past the register kernel's widths #1/#2 take the path-tile kernel at
    # every fixed method: its block (rows, weight slice) fits one block's
    # shared memory, and no block before it in the rule's order does
    order = xnode_train.PATH_ORDER
    for method in FUSED_KERNEL_METHODS:
        _, net = net_of(dim=5, u_hidden_dim=H, u_hidden_hidden_dim=Hh,
                        solver=method)
        dims = net.dims()
        route = xnode_train.kernel_route(dims, 0, method)
        tile = route.path_tile
        assert route.path == "tile" and tile == xnode_train.path_tile(
            dims, method)
        assert tuple(tile) in order and tile.rows in (16, 32)
        assert tile.slice == 0 or tile.slice in xnode_train.PATH_SLICES
        smem = xnode_train.path_tile_smem_bytes(dims, method, *tile)
        assert smem <= MAX_SMEM_BYTES
        assert all(xnode_train.path_tile_smem_bytes(dims, method, *t)
                   > MAX_SMEM_BYTES for t in order[:order.index(tuple(tile))])
        # the weights resident only where the whole staged copy fits
        assert (4 * xnode_train.path_tile_staged_floats(dims)
                > MAX_SMEM_BYTES) <= (tile.slice > 0)


def test_path_tile_bytes_count_each_buffer():
    # 128/128 at the cube's depth, 32 rows (a stride of 36), 64-input
    # slices, midpoint: two slots of 64 x 128 floats, two [129][36]
    # buffers, three [128][36] ones and two of 32 times; heun and rk4 keep
    # the stage sum [128][36] too; resident, the staged copy of
    # 129 x 128 + 7 x 128 x 128 + 128 x 128 floats
    dims = (128, 128, 5, 3, 9)
    base = 2 * 64 * 128 + 2 * 129 * 36 + 3 * 128 * 36 + 2 * 32
    assert xnode_train.path_tile_smem_bytes(dims, "midpoint", 32,
                                            64) == 4 * base
    assert xnode_train.path_tile_smem_bytes(dims, "rk4", 32, 64) == 4 * (
        base + 128 * 36)
    assert xnode_train.path_tile_staged_floats(dims) == (
        129 * 128 + 7 * 128 * 128 + 128 * 128)
    assert xnode_train.path_tile_smem_bytes(dims, "euler", 32, 0) == 4 * (
        base - 2 * 64 * 128 + xnode_train.path_tile_staged_floats(dims))
    with pytest.raises(ValueError, match="path-tile"):
        xnode_train.path_tile((64, 4096, 5, 3, 9), "rk4")


def test_wrappers_take_their_route_from_kernel_route(monkeypatch):
    # every wrapper of #1-#5 takes its variant, block and chunk from
    # kernel_route, asked with the shapes before the device is checked;
    # a launch of #3-#5 with more directions than its route takes raises
    asked = []

    def spy(dims, d, method):
        asked.append((dims, d, method))
        return route_of(dims, d, method)

    route_of = xnode_train.kernel_route
    for module in (xnode_train, xnode_eval):
        monkeypatch.setattr(module, "kernel_route", spy)
    _, net = net_of(dim=100, fourier_features=1)
    dims, (n, L) = net.dims(), (4, 3)
    f32 = dict(dtype=torch.float32)
    path = (torch.zeros((n, L), **f32), torch.zeros((n, L), **f32),
            torch.zeros((n, net.F), **f32))
    with pytest.raises(ValueError, match="CUDA device"):
        xnode_train.path_forward_cuda(net, *path, torch.zeros(n, **f32), 1,
                                      "rk4")
    with pytest.raises(ValueError, match="CUDA device"):
        xnode_eval.evaluate_cuda(net, path[2], torch.ones(n, **f32),
                                 torch.zeros(n, **f32), torch.zeros(n, **f32),
                                 4, "heun")
    assert asked == [(dims, 0, "rk4"), (dims, 0, "heun")]
    packed = net.packed()

    def tangents(d):
        return (torch.zeros((n, d, net.F), **f32), torch.zeros(n, **f32),
                torch.zeros((n, d), **f32))

    # 2t's widths take the full d = 100 a launch, and 100 of d = 200
    with pytest.raises(ValueError, match="CUDA device"):
        xnode_train.u_du_fwd_cuda(net, packed, *path, *tangents(100), 1,
                                  "midpoint")
    with pytest.raises(ValueError, match="CUDA device"):
        xnode_train.u_du_bwd_cuda(
            net, packed, *path, *tangents(100), torch.zeros((L, n, net.H)),
            torch.zeros((L, n, 100, net.H)), torch.zeros((n, L)),
            torch.zeros((n, L, 100)), 1, "midpoint")
    with pytest.raises(ValueError, match="at most 100 of d=200 directions"):
        xnode_train.u_du_fwd_cuda(net, packed, *path, *tangents(200), 1,
                                  "midpoint")
    assert asked[2:] == [(dims, 100, "midpoint")] * 2 + [
        (dims, 200, "midpoint")]


@pytest.mark.parametrize("method", FUSED_KERNEL_METHODS)
def test_what_stays_out_of_reach_raises_and_names_the_bound(method):
    # a field 1,024 wide and 16 layers deep: one path with one direction
    # does not fit #5's block even without its accumulator (every RK
    # stage keeps each field layer's activations)
    dims = (64, 1024, 5, 3, 16)
    assert not one_path_fits(dims, method)
    with pytest.raises(ValueError, match=f"{MAX_SMEM_BYTES} bytes a block"):
        xnode_train.u_chunk(dims, 5, method)
