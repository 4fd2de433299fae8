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
                # the tile variant at the largest of its tiles that fits
                # (at least 8 points, so at least 4: no net keeps the
                # earlier tile kernel), with weight slices of fwd_slice
                # inputs, the largest of FWD_SLICES that fits there
                assert route.fwd == "tile"
                tile = route.fwd_tile
                assert tile in disc_train.FWD_TILES and tile >= 4
                k = disc_train.fwd_slice(geom, tile)
                assert k in disc_train.FWD_SLICES
                assert disc_train.tile_smem_bytes(geom, "tile", tile) == \
                    disc_train.fwd_tile_smem_bytes(geom, tile, k) \
                    <= MAX_SMEM_BYTES
                assert all(disc_train.fwd_tile_smem_bytes(geom, tile, j)
                           > MAX_SMEM_BYTES
                           for j in disc_train.FWD_SLICES if j > k)
                assert all(disc_train.tile_smem_bytes(geom, "tile", t)
                           > MAX_SMEM_BYTES
                           for t in disc_train.FWD_TILES if t > tile)
                assert (H > disc_train.REG_MAX_WIDTH
                        or disc_train.fwd_smem_bytes(geom) > MAX_SMEM_BYTES)
            # #7, in this order: the shared accumulator wherever it fits
            # beside a tile; else thread-block clusters of CLUSTER blocks,
            # for a tied net whose block (its hidden weights resident) fits
            # at 16 points or more (cluster_choice); else the global
            # accumulator. Each at the largest tile that fits
            shared_fits = disc_train.tile_smem_bytes(
                geom, "shared", 4) <= MAX_SMEM_BYTES
            clustered = disc_train.cluster_choice(geom)
            want = ("shared" if shared_fits else
                    "cluster" if clustered else "global")
            assert route.bwd == want
            C, min_tile = disc_train.CLUSTER, disc_train.CLUSTER_MIN_TILE
            if route.bwd == "cluster":
                tile = route.bwd_tile
                assert clustered == (tile, C) and route.cluster == C <= H
                assert tied and tile >= min_tile
                assert disc_train.cluster_smem_bytes(geom, C, tile) \
                    <= MAX_SMEM_BYTES
                assert all(disc_train.cluster_smem_bytes(geom, C, t)
                           > MAX_SMEM_BYTES
                           for t in disc_train.TILES if t > tile)
            elif not shared_fits:
                # the global variant where no cluster takes the net
                assert not tied or H < C or disc_train.cluster_smem_bytes(
                    geom, C, min_tile) > MAX_SMEM_BYTES
            if route.bwd != "cluster":
                assert route.cluster == 1
                assert disc_train.tile_smem_bytes(
                    geom, route.bwd, route.bwd_tile) <= MAX_SMEM_BYTES
                larger = [t for t in disc_train.TILES if t > route.bwd_tile]
                assert all(disc_train.tile_smem_bytes(geom, route.bwd, t)
                           > MAX_SMEM_BYTES for t in larger)
            # the global variant fits 4 points wherever the JAX package
            # runs (at most its rows a point), the tile #6 8 points
            assert disc_train.tile_rows(geom, "global") <= \
                disc_train.jax_rows(geom) - F - 1
            assert disc_train.fwd_slice(geom, disc_train.FWD_TILES[-1])
            assert disc_train.v_fused_fits(_params(geom), L, tied)
    assert inside > 0


@pytest.mark.parametrize("geom,route", [
    (DiscGeom(6, 50, 9, True), ("registers", 0, "shared", 32, 1)),
    (DiscGeom(141, 50, 9, True), ("registers", 0, "shared", 16, 1)),
    (DiscGeom(6, 256, 9, True), ("tile", 64, "cluster", 16, 8)),
    (DiscGeom(6, 558, 9, True), ("tile", 32, "global", 4, 1)),
    (DiscGeom(6, 128, 9, False), ("tile", 128, "global", 16, 1)),
    (DiscGeom(6, 50, 40, False), ("tile", 128, "global", 8, 1)),
    (DiscGeom(6, 50, 40, True), ("registers", 0, "shared", 8, 1)),
], ids=["cube", "d20-3freq", "256-tied", "558-tied", "128-untied",
        "deep-untied", "deep-tied"])
def test_routes_of_the_chip_checks(geom, route):
    # the nets that chip_smoke.py's phases 2v, 2w and 3 run: 2v's 256-wide
    # tied net on clusters of 8 blocks, 16 points a tile; the untied nets
    # and the 558-wide one keep the global accumulator (no cluster variant
    # for untied nets; the 558-wide block's weights do not fit). The tile
    # #6 takes 64 points at 2v's net (16 before its redesign), 32 at the
    # 558-wide one (8), 128 at the untied ones (32 and 16)
    assert disc_train.disc_route(geom) == route


def test_tile_smem_hand_counts():
    # 2v's net (F = 6, H = 256, L = 9, tied): #7 global keeps 2 (L + 1) H
    # + 2 H + 1 = 5120 + 512 + 1 rows, at 8 points (rows of 8 floats)
    g = DiscGeom(6, 256, 9, True)
    assert disc_train.tile_rows(g, "global") == 5633
    assert disc_train.tile_smem_bytes(g, "global", 8) == 4 * 8 * 5633 \
        == 180256
    assert disc_train.tile_smem_bytes(g, "global", 16) > MAX_SMEM_BYTES
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
    # the largest block the global #7 can ask for inside JAX's domain: 4
    # points of 12,287 rows at most
    assert 16 * (disc_train.JAX_MAX_ROWS - 1) <= MAX_SMEM_BYTES


def test_fwd_tile_smem_hand_counts():
    # The tile #6 at 2v's net and 64 points: two activation buffers of 256
    # rows of 72 floats (64 rounded up to an odd multiple of 8); the relu
    # bits of a_0 .. a_8, two words a unit and layer; a pass of all 256
    # outputs, so two weight slices, each the larger of the forward's, 256
    # rows of 32 inputs, and the sweep's, 24 rows of 264 floats (the most
    # multiple of 8 rows no larger); 256 partial sums of v: the cap exactly
    g = DiscGeom(6, 256, 9, True)
    assert disc_train.fwd_tile_stride(64) == 72
    assert disc_train.fwd_pass(g, 64) == 256
    assert disc_train.fwd_slice(g, 64) == 32
    assert disc_train.sweep_slice(g, 64, 32) == 24
    assert disc_train.fwd_tile_smem_bytes(g, 64, 32) == 4 * (
        2 * 256 * 72 + 9 * 256 * 2 + 2 * max(256 * 32, 24 * 264) + 256) \
        == 232448 == MAX_SMEM_BYTES
    assert disc_train.tile_smem_bytes(g, "tile", 64) == 232448
    assert disc_train.tile_smem_bytes(g, "tile", 128) > MAX_SMEM_BYTES
    # the 558-wide net at 32 points (rows of 40 floats): its 558 outputs
    # (560 rounded up to 16) in two passes of 288 (a pass's micro-tiles
    # cover 256 x 64 / 32 = 512), one relu word a unit and layer (5,022
    # rounded up to four), 8-input slices both, the sweep's the larger
    w = DiscGeom(6, 558, 9, True)
    assert disc_train.fwd_pass(w, 32) == 288
    assert disc_train.fwd_slice(w, 32) == 8
    assert disc_train.sweep_slice(w, 32, 8) == 8
    assert disc_train.tile_smem_bytes(w, "tile", 32) == 4 * (
        2 * 558 * 40 + 5024 + 2 * 8 * 296 + 256) == 218624
    assert disc_train.fwd_tile_smem_bytes(w, 32, 16) > MAX_SMEM_BYTES
    assert disc_train.tile_smem_bytes(w, "tile", 64) > MAX_SMEM_BYTES
    # the widest net of JAX's domain (H = 2047 at L = 1): passes of at
    # most FWD_PASS_MAX = 512 outputs leave room for 8 points
    x = DiscGeom(1, 2047, 1, True)
    assert disc_train.fwd_pass(x, 8) == 512
    assert disc_train.disc_route(x).fwd_tile == 8
    assert disc_train.tile_smem_bytes(x, "tile", 8) == 4 * (
        2 * 2047 * 8 + 2048 + 2 * 512 * 16 + 256) <= MAX_SMEM_BYTES


def test_cluster_smem_hand_counts():
    # #7's cluster variant at 2v's net on clusters of 8 blocks, 16 points
    # (rows of S = 20 floats), the hidden weights resident: two exchange
    # buffers of H rows, the block's 32 units of A_0..A_9, G_0..G_9 and two
    # cotangent buffers, the features, gb and vb: (2 H + 2 (L + 1) 32 + 2 32
    # + 2 F + 1) S; the accumulator: the hidden layer's 32 rows at a stride
    # of 264 (256 rounded up to 8 mod 32) and its 32 biases, then W0's 32
    # rows, b0, w_o and b_o, in all rounded up to 4; the split products'
    # partial tiles, 16 warps x 128 floats x 2 tiles of 8 points; and the
    # block's 32 rows and 32 columns of W_h at a stride of 260 (4 mod 32)
    g = DiscGeom(6, 256, 9, True)
    assert disc_train.hidden_acc_stride(256) == 264
    assert disc_train.cluster_acc_floats(g, 8) == \
        (32 * 264 + 32) + 32 * 6 + 32 + 32 + 1 + 3 == 8740
    assert disc_train.cluster_smem_bytes(g, 8, 16) == 4 * (
        (512 + 640 + 64 + 12 + 1) * 20 + 8740 + 16 * 128 * 2
        + 2 * 32 * 260) == 216224 <= MAX_SMEM_BYTES
    assert disc_train.cluster_smem_bytes(g, 8, 32) > MAX_SMEM_BYTES
    assert disc_train.cluster_tile(g, 8) == 16
    assert disc_train.cluster_choice(g) == (16, 8)
    # clusters of 4 blocks: 64 units a block, whose weights and eighth of
    # the accumulator leave no room for a tile
    assert disc_train.cluster_tile(g, 4) == 0
    # the 558-wide net: 70 units a block; their rows and columns of W_h
    # alone take 2 x 70 x 580 floats, 324,800 bytes
    w = DiscGeom(6, 558, 9, True)
    assert disc_train.cluster_smem_bytes(w, 8, 4) > 4 * 2 * 70 * 580 \
        > MAX_SMEM_BYTES
    assert disc_train.cluster_tile(w, 8) == 0
    assert disc_train.cluster_choice(w) is None


def _jax_params(geom: DiscGeom):
    """JAX-layout discriminator parameters (``w [in, out]``, ``b [out]``)
    whose entries are their own ids, in layer order."""
    shapes = ([(geom.F, geom.H)] + [(geom.H, geom.H)] * geom.n_hidden
              + [(geom.H, 1)])
    layers, nxt = [], 0
    for fan_in, fan_out in shapes:
        w = np.arange(nxt, nxt + fan_in * fan_out, dtype=np.float32)
        nxt += w.size
        b = np.arange(nxt, nxt + fan_out, dtype=np.float32)
        nxt += b.size
        layers.append({"w": w.reshape(fan_in, fan_out), "b": b})
    return {"inp": layers[0],
            "hidden": layers[1] if geom.tied else layers[1:-1],
            "out": layers[-1]}


@pytest.mark.parametrize("cluster", [2, 4, 8])
def test_cluster_slices_and_owned_entries_cover_the_net_once(cluster):
    # each layer's units split over a cluster's blocks, every unit in one
    # block's slice in rank order; every entry of the packed gradient
    # (_flatten_disc_t's order, the JAX package's) of a tied net owned by
    # exactly one block, which owns the weights of its units' rows (W [out,
    # in]), their biases and w_o, block 0 b_o too, each at a distinct place
    # of its accumulator inside cluster_acc_floats
    for H in WIDTHS:
        if H < cluster:
            continue
        slices = disc_train.unit_slices(H, cluster)
        assert [u for s in slices for u in s] == list(range(H))
        assert max(len(s) for s in slices) == -(-H // cluster)
        for L in (1, 2, 9):
            geom = DiscGeom(6, H, L, True)
            if not jax_fits(geom):
                continue
            packed = np.concatenate([a.reshape(-1) for a in (
                jdisc._flatten_disc_t(_jax_params(geom), L, True))])
            assert packed.size == geom.n_params
            ids = packed.astype(np.int64)
            # each id's output unit (w [in, out] row-major, then b)
            unit = np.full(geom.n_params, -1)
            off = 0
            for fan_in, fan_out in ([(geom.F, H)]
                                    + [(H, H)] * geom.n_hidden
                                    + [(H, 1)]):
                unit[off:off + fan_in * fan_out] = np.tile(
                    np.arange(fan_out), fan_in)
                unit[off + fan_in * fan_out:
                     off + (fan_in + 1) * fan_out] = np.arange(fan_out)
                off += (fan_in + 1) * fan_out
            seen = np.zeros(geom.n_params, dtype=np.int64)
            n_acc = disc_train.cluster_acc_floats(geom, cluster)
            owned = disc_train.cluster_owned(geom, cluster)
            for c, runs in enumerate(owned):
                slots = np.zeros(n_acc, dtype=np.int64)
                for a, p, length in runs:
                    assert 0 <= a and a + length <= n_acc
                    slots[a:a + length] += 1
                    seen[ids[p:p + length]] += 1
                    out = unit[ids[p:p + length]]
                    # w_o's and b_o's output unit is 0: by input unit
                    # or block 0
                    if p >= geom.n_params - H - 1:
                        assert (p + length <= geom.n_params - 1
                                and list(range(p, p + length)) ==
                                list(range(geom.n_params - H - 1
                                           + slices[c].start,
                                           geom.n_params - H - 1
                                           + slices[c].stop))
                                or (p, length, c) ==
                                (geom.n_params - 1, 1, 0))
                    else:
                        assert set(out.tolist()) <= set(slices[c])
                assert slots.max() <= 1
            assert (seen == 1).all()
