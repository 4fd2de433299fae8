"""Every adversary the JAX package runs through its Pallas kernels gets a
hand-written kernel in the port: for each geometry ``(F, H, L, tied)`` of
the grid below that the JAX package's ``v_fused_fits`` accepts
(``xnode_wan_tpu/ops/pallas/disc_train.py``), the port's
``disc_route`` picks a variant of kernels #6 and #7 from the shapes alone,
without raising, and each variant's block fits shared memory; where the
JAX package takes its XLA side, the route raises and names the bound.

Host arithmetic only: the kernels' shared-memory rules and the JAX
package's VMEM predicate, no launch.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from xnode_wan_tpu.ops.pallas import disc_train as jdisc
from xnode_wan_tpu_torch.ops.kernels import disc_train
from xnode_wan_tpu_torch.ops.kernels.disc_train import DiscGeom
from xnode_wan_tpu_torch.ops.kernels.steppers import MAX_SMEM_BYTES

# widths around the register #6's cap (64), the shared #7's reach and
# JAX's widest net at the shipped depth (558 at L = 9)
WIDTHS = (1, 7, 50, 64, 65, 128, 256, 557, 558, 559, 1024, 2047, 2048)
# depths up to JAX's deepest 50-wide net (120) and one past it
DEPTHS = (1, 2, 9, 40, 120, 121)
# feature widths: the d=5 cube, d=20 with three frequencies, and the
# thousands
FEATS = (1, 6, 141, 2500, 6000, 12279)


def jax_fits(geom: DiscGeom) -> bool:
    """The JAX package's predicate, which reads only the widths of the
    input and output layers (``w`` is ``[in, out]`` there)."""
    params = {"inp": {"w": np.zeros((geom.F, 1))},
              "out": {"w": np.zeros((geom.H, 1))}}
    return jdisc.v_fused_fits(params, geom.F, geom.L, geom.tied)


def _params(geom: DiscGeom):
    """Stand-in parameters with the one shape ``geom_of`` reads."""
    return SimpleNamespace(inp=SimpleNamespace(
        weight=SimpleNamespace(shape=(geom.H, geom.F))))


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("F", FEATS)
def test_port_routes_every_adversary_the_jax_package_runs(F, tied):
    inside = 0
    for H in WIDTHS:
        for L in DEPTHS:
            geom = DiscGeom(F, H, L, tied)
            if not jax_fits(geom):
                with pytest.raises(ValueError, match=(
                        f"domain.*{disc_train.jax_rows(geom)} rows, at most "
                        f"{disc_train.JAX_MAX_ROWS}")):
                    disc_train.disc_route(geom)
                continue
            inside += 1
            route = disc_train.disc_route(geom)
            # #6: the register kernel up to 64 wide where its staged
            # weights fit, else the tile variant; its block fits
            if route.fwd == "registers":
                assert H <= disc_train.REG_MAX_WIDTH
                assert disc_train.fwd_smem_bytes(geom) <= MAX_SMEM_BYTES
                assert route.fwd_tile == 0
            else:
                assert route.fwd == "tile"
                assert route.fwd_tile in disc_train.TILES
                assert disc_train.tile_smem_bytes(
                    geom, "tile", route.fwd_tile) <= MAX_SMEM_BYTES
                assert (H > disc_train.REG_MAX_WIDTH
                        or disc_train.fwd_smem_bytes(geom) > MAX_SMEM_BYTES)
            # #7: the shared accumulator wherever it fits, else the
            # global one, each at the largest tile that fits
            assert route.bwd in ("shared", "global")
            assert disc_train.tile_smem_bytes(
                geom, route.bwd, route.bwd_tile) <= MAX_SMEM_BYTES
            shared_fits = disc_train.tile_smem_bytes(
                geom, "shared", 4) <= MAX_SMEM_BYTES
            assert (route.bwd == "shared") == shared_fits
            larger = [t for t in disc_train.TILES if t > route.bwd_tile]
            assert all(disc_train.tile_smem_bytes(geom, route.bwd, t)
                       > MAX_SMEM_BYTES for t in larger)
            # the global variant and the tile #6 fit 4 points wherever the
            # JAX package runs (at most its rows a point)
            assert disc_train.tile_rows(geom, "global") <= \
                disc_train.jax_rows(geom) - F - 1
            assert disc_train.tile_rows(geom, "tile") <= \
                disc_train.jax_rows(geom)
            assert disc_train.v_fused_fits(_params(geom), L, tied)
    assert inside > 0


@pytest.mark.parametrize("geom,route", [
    (DiscGeom(6, 50, 9, True), ("registers", 0, "shared", 32)),
    (DiscGeom(141, 50, 9, True), ("registers", 0, "shared", 16)),
    (DiscGeom(6, 256, 9, True), ("tile", 16, "global", 8)),
    (DiscGeom(6, 558, 9, True), ("tile", 8, "global", 4)),
    (DiscGeom(6, 128, 9, False), ("tile", 32, "global", 16)),
    (DiscGeom(6, 50, 40, False), ("tile", 16, "global", 8)),
    (DiscGeom(6, 50, 40, True), ("registers", 0, "shared", 8)),
], ids=["cube", "d20-3freq", "256-tied", "558-tied", "128-untied",
        "deep-untied", "deep-tied"])
def test_routes_of_the_chip_checks(geom, route):
    # the nets that chip_smoke.py's phases 2v, 2w and 3 run
    assert disc_train.disc_route(geom) == route


def test_tile_smem_hand_counts():
    # 2v's net (F = 6, H = 256, L = 9, tied): #7 global keeps 2 (L + 1) H
    # + 2 H + 1 = 5120 + 512 + 1 rows, at 8 points (rows of 8 floats);
    # the tile #6 keeps (L + 2) H + F = 2816 + 6 rows, at 16 points (rows
    # of 20 floats)
    g = DiscGeom(6, 256, 9, True)
    assert disc_train.tile_rows(g, "global") == 5633
    assert disc_train.tile_smem_bytes(g, "global", 8) == 4 * 8 * 5633 \
        == 180256
    assert disc_train.tile_smem_bytes(g, "global", 16) > MAX_SMEM_BYTES
    assert disc_train.tile_rows(g, "tile") == 2822
    assert disc_train.tile_smem_bytes(g, "tile", 16) == 4 * 20 * 2822 \
        == 225760
    assert disc_train.tile_smem_bytes(g, "tile", 32) > MAX_SMEM_BYTES
    # the shared #7 adds the features, gb and the 67,841-float accumulator
    assert g.n_params == 6 * 256 + 256 + 256 * 257 + 257 == 67841
    assert disc_train.tile_smem_bytes(g, "shared", 4) == 4 * (
        67841 + 4 * (5633 + 12)) > MAX_SMEM_BYTES
    # JAX's widest net at the shipped depth (558 wide, 12,284 rows): #7
    # global at 4 points, 12,277 rows of 4 floats; the tile #6 at 8
    w = DiscGeom(6, 558, 9, True)
    assert disc_train.jax_rows(w) == 12284
    assert disc_train.tile_smem_bytes(w, "global", 4) == 16 * 12277 \
        == 196432
    assert disc_train.tile_smem_bytes(w, "tile", 8) == 32 * (11 * 558 + 6) \
        == 196608
    # the largest block the global #7 can ask for inside JAX's domain: 4
    # points of 12,287 rows at most
    assert 16 * (disc_train.JAX_MAX_ROWS - 1) <= MAX_SMEM_BYTES
