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
            and xnode_train.tile_smem_bytes(dims, 1, method, 1, True, True)
            <= MAX_SMEM_BYTES)


def fits(dims, d, method, tile, backward):
    return xnode_train.tile_smem_bytes(
        dims, d, method, tile.paths, backward,
        tile.global_acc) <= MAX_SMEM_BYTES


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
        # #1/#2: the register kernels within their caps, else the tile
        # variant (d = 0), whose block fits; the same without tangents
        assert route.path == ("registers" if register_fits(dims) else "tile")
        assert xnode_train.kernel_route(dims, 0, method)[:2] == route[:2]
        if route.path == "registers":
            net.check_caps()
        else:
            assert fits(dims, 0, method, route.path_tile, False)
        # #3-#5: a divisor of d, the full d wherever its tiles fit
        dc = route.d_chunk
        assert d % dc == 0
        assert fits(dims, dc, method, route.fwd, False)
        assert fits(dims, dc, method, route.bwd, True)
        full = (xnode_train.tile_smem_bytes(dims, d, method, 1, False)
                <= MAX_SMEM_BYTES
                and xnode_train.tile_smem_bytes(dims, d, method, 1, True,
                                                True) <= MAX_SMEM_BYTES)
        assert (dc == d) == full
        # the largest such divisor
        for larger in range(dc + 1, d + 1):
            if d % larger == 0:
                with pytest.raises(ValueError):
                    xnode_train.grad_tile(dims, larger, method, False)
                    xnode_train.grad_tile(dims, larger, method, True)


def test_wide_cube_takes_kernel_5_with_its_accumulator_in_global_memory():
    # the cube at u_hidden_dim = u_hidden_hidden_dim = 64, d = 5: the
    # accumulator (46,337 floats) does not fit beside the block, the rest
    # does
    cfg, net = net_of(dim=5, u_hidden_dim=64, u_hidden_hidden_dim=64)
    dims = net.dims()
    assert xnode_train.n_params_of(dims) == 46337
    tile = xnode_train.grad_tile(dims, 5, cfg.solver, True)
    assert tile.global_acc
    assert xnode_train.tile_smem_bytes(dims, 5, cfg.solver, 1,
                                       True) > MAX_SMEM_BYTES
    assert fits(dims, 5, cfg.solver, tile, True)
    assert xnode_train.kernel_route(dims, 5, cfg.solver).d_chunk == 5


def test_d100_fourier_cube_runs_in_tangent_chunks_and_tile_variant():
    # d = 100 with fourier_features 1: F = 300, so #1/#2 take the tile
    # variant, and #3-#5 run in two chunks of 50 directions
    cfg, net = net_of(dim=100, fourier_features=1)
    assert net.F == 300 and not register_fits(net.dims())
    route = xnode_train.kernel_route(net.dims(), 100, cfg.solver)
    assert route.path == "tile" and route.d_chunk == 50


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

    with pytest.raises(ValueError, match="CUDA device"):
        xnode_train.u_du_fwd_cuda(net, packed, *path, *tangents(50), 1,
                                  "midpoint")
    with pytest.raises(ValueError, match="CUDA device"):
        xnode_train.u_du_bwd_cuda(
            net, packed, *path, *tangents(50), torch.zeros((L, n, net.H)),
            torch.zeros((L, n, 50, net.H)), torch.zeros((n, L)),
            torch.zeros((n, L, 50)), 1, "midpoint")
    with pytest.raises(ValueError, match="at most 50 of d=100 directions"):
        xnode_train.u_du_fwd_cuda(net, packed, *path, *tangents(100), 1,
                                  "midpoint")
    assert asked[2:] == [(dims, 50, "midpoint")] * 2 + [
        (dims, 100, "midpoint")]


@pytest.mark.parametrize("method", FUSED_KERNEL_METHODS)
def test_what_stays_out_of_reach_raises_and_names_the_bound(method):
    # a field 1,024 wide and 16 layers deep: one path with one direction
    # does not fit #5's block even without its accumulator (every RK
    # stage keeps each field layer's activations)
    dims = (64, 1024, 5, 3, 16)
    assert not one_path_fits(dims, method)
    with pytest.raises(ValueError, match=f"{MAX_SMEM_BYTES} bytes a block"):
        xnode_train.u_chunk(dims, 5, method)
