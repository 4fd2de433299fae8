"""The adversary's training hot path: the discriminator's value with its
input gradient, and the weight cotangents of both. Port of
``xnode_wan_tpu/ops/pallas/disc_train.py`` (the ``fused_v: true`` path).

**Kernel #6** (:func:`v_dv_fwd_cuda`) replaces ``_v_fwd_kernel``: for
features ``z [F]`` per point, the forward ``a0 = W0 z + b0``, ``a_{i+1} =
W_h relu(a_i) + b_h`` (``i < L = v_layers``), ``y = tanh(a_L)``, ``v = w_o
. y + b_o``, then one reverse sweep ``g_L = w_o (1 - y^2)``, ``g_i = [a_i >
0] (W_h^T g_{i+1})``, ``gin = W0^T g_0``: ``v [M]`` and ``dv/dz [M, F]``.
Two variants: ``registers`` (``csrc/disc_fwd.cu::disc_fwd_kernel``), built
once per adversary width ``H`` (``libdisc_fwd_H<H>.so``), one thread per
point over a block's copy of the weights staged by columns
(:func:`staged_floats`), for nets up to :data:`REG_MAX_WIDTH` wide whose
copy fits; and ``tile`` (``csrc/disc_tile_fwd.cuh::disc_tile_fwd_kernel``)
for every other net: a persistent grid walks tiles of up to 128 points
(:data:`FWD_TILES`), the relu signs kept as bits, each product's weights
streamed through shared memory by ``cp.async`` in slices of
:func:`fwd_slice` (the forward) or :func:`sweep_slice` inputs (the sweep),
the forward in FP32 FMAs and the sweep with ``gin`` on the tensor cores in
3xTF32 (:func:`fwd_tile_smem_bytes`).

**Kernel #7** (:func:`v_dv_bwd_cuda`, ``csrc/disc_train.cu::
disc_bwd_kernel``) replaces ``_v_bwd_kernel``: the gradient of ``sum(v
vb) + sum(gin gb)`` in the packed weights, second-order terms included,
summed over the points. The Pallas kernel takes it from ``jax.vjp`` of the
whole function; here the adjoint is derived by hand (:func:`v_dv_bwd_plain`
writes it as batched tensor math, the kernel per tile of points). A block
of :data:`BWD_THREADS` threads walks tiles of points with every layer's
vectors in shared memory (rows of :func:`bwd_stride` floats); each matrix
product runs as register micro-tiles (2 outputs x 4 points a thread, one
float4 of the tile and two weights per input), each weight cotangent as
micro-tiles of owned entries, summed over the tile's points in order. Its
accumulator sits in shared memory (``shared``); where the net's weights do
not fit beside the tile, it is split over the blocks of a thread-block
cluster (``cluster``, ``disc_bwd_cluster_launch``,
``csrc/disc_train_cluster.cuh``: 8 blocks walk a tile together, each
owning a slice of every layer's units (:func:`unit_slices`), the weight
cotangents of those units' rows (:func:`cluster_owned`) and, for the whole
launch, its rows and columns of the tied hidden layer; inputs exchanged
through distributed shared memory, the sweep, the reverses and the weight
sums on the tensor cores in 3xTF32, the forward recompute in FP32; a
tied net only, at 16 points a tile or more); and elsewhere in the
block's own row of
``partial`` (``global``, ``disc_bwd_global_launch``: the same owners in
the same order as ``shared``, so the two are bitwise equal at the same
tile and grid). The partials are summed over blocks (clusters) in a fixed
order, so two launches are bitwise equal. ``csrc/disc_train.cu`` is built
once, with every width a runtime value (``libdisc_train.so``).

:func:`disc_route` picks the variants and tiles from the shapes before any
launch, for every net the JAX package runs through its Pallas kernels
(its ``v_fused_fits``: ``F + H (2 v_layers + 4) + 2 <= 12,288``); past
that bound it raises, as the JAX package takes its XLA side there.

:class:`VDvFused` is the autograd function (forward #6, backward #7), and
:func:`v_dv_fused` the drop-in for ``(v, grad v)`` that
``ops/weak_form.py::v_phi_grads_fused`` assembles ``phi`` from. Weights
are packed as ``_flatten_disc_t`` orders them: input layer, the hidden
layer once when tied (else each of the ``v_layers``), output layer; each
``W [out, in]`` row-major, then ``b [out]``. On CPU tensors the wrappers
take the plain versions; on CUDA tensors they launch the kernels.

Bounds on an H100 SXM (67 TFLOP/s FP32 without tensor cores, 3.35 TB/s)
at the d=5 main path (F = 6, H = 50, L = 9, tied, M = 80,000 points):
#6 does 45,650 multiply-adds a point, 7.30 GFLOP (0.109 ms), against
4.2 MB (1.3 us); #7 recomputes the forward and the sweep and runs both
reverses, about 136,650 multiply-adds a point, 21.9 GFLOP (0.33 ms).
Both are bound by operations. Design notes in the ``.cu`` headers.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Tuple

import torch

from xnode_wan_tpu_torch.models.discriminator import disc_features
from xnode_wan_tpu_torch.ops.kernels._build import CudaKernel, KernelVariants
from xnode_wan_tpu_torch.ops.kernels.steppers import (MAX_SMEM_BYTES,
                                                      _ld_mod32, _pad4,
                                                      _widest, bwd_blocks,
                                                      require_cuda_f32,
                                                      unit_slices)

_P, _I = ctypes.c_void_p, ctypes.c_int
# kernel #6 in registers: packed weights, count, feats, v, gin; M F H
# v_layers tied
FWD_KERNEL = CudaKernel("disc_fwd", "disc_fwd_launch",
                        [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I])
# kernel #6 on tiles: the same, then points per tile
FWD_TILE_KERNEL = CudaKernel("disc_train", "disc_tile_fwd_launch",
                             FWD_KERNEL.argtypes + [_I])
# kernel #7: packed weights, count, feats, vb, gb, partial, grad;
# M F H v_layers tied, points per tile, blocks
BWD_KERNEL = CudaKernel("disc_train", "disc_bwd_launch",
                        [_P, _I, _P, _P, _P, _P, _P] + [_I] * 7)
# #7 with its accumulator in partial (the same arguments)
BWD_GLOBAL_KERNEL = CudaKernel("disc_train", "disc_bwd_global_launch",
                               BWD_KERNEL.argtypes)
# #7 on thread-block clusters: the same arguments, the grid as a number of
# clusters, then the blocks a cluster
BWD_CLUSTER_KERNEL = CudaKernel("disc_train", "disc_bwd_cluster_launch",
                                BWD_KERNEL.argtypes + [_I])
# launches of #6 and of #7, each over its variants
FWD_LAUNCHES = KernelVariants({"registers": FWD_KERNEL,
                               "tile": FWD_TILE_KERNEL})
BWD_LAUNCHES = KernelVariants({"shared": BWD_KERNEL,
                               "cluster": BWD_CLUSTER_KERNEL,
                               "global": BWD_GLOBAL_KERNEL})

# Constants of csrc/disc_fwd.cu and disc_train.cu
FWD_THREADS = 128     # XD_FWD_THREADS: a register #6 block, one point each
BWD_THREADS = 256     # XD_BWD_THREADS: a block of #7
FWD_TILE_THREADS = 256  # XF_THREADS: a block of the tile #6
CLUSTER_THREADS = 512  # XK_THREADS: a block of #7's cluster variant
TILES = (32, 16, 8, 4)  # points a tile of #7, largest first
# The tile #6: points a tile and inputs a slice of the forward's weights
# (multiples of 8), largest first; the outputs a pass covers at most
# (XF_OB_MAX: 8-input slices of the widest net fit beside its activations)
FWD_TILES = (128, 64, 32, 16, 8)
FWD_SLICES = (32, 24, 16, 8)
FWD_PASS_MAX = 512
# #7's cluster variant: blocks a cluster (a block's share of every buffer
# shrinks with it, so 8 fits wherever 4 or 2 do), and its smallest tile (at
# 8 points it was about as slow as the global variant at 2v's net)
CLUSTER = 8
CLUSTER_MIN_TILE = 16
# The register #6 holds a vector of H floats a thread: up to 64 wide, as
# #1/#2's register kernels (wider spills)
REG_MAX_WIDTH = 64
# The JAX package's v_fused_fits: its backward's VMEM rows, F + H (2L + 4)
# + 2, times 128 points x 4 bytes x 2 within 12 MiB
JAX_MAX_ROWS = 12 * 2 ** 20 // (128 * 4 * 2)
# Bytes of #7's partial rows ([blocks, n_params]) a launch may take: the
# grid shrinks below one block an SM for the widest untied nets
PARTIAL_BYTES = 2 ** 28
# disc_tile_smem_bytes's variant numbers (XdVariant)
VARIANT_IDS = {"shared": 0, "global": 1, "tile": 2}


class DiscGeom(NamedTuple):
    """The discriminator's shape as the kernels take it."""
    F: int        # feature width: 1 + d (1 + 2 n_freq)
    H: int        # v_hidden_dim
    L: int        # v_layers
    tied: bool

    @property
    def n_hidden(self) -> int:
        return 1 if self.tied else self.L

    @property
    def n_params(self) -> int:
        H = self.H
        return self.F * H + H + self.n_hidden * (H * H + H) + H + 1

    def unpack(self, packed: torch.Tensor):
        """Views ``[(W0, b0), (W_h, b_h) * n_hidden, (w_o [1, H], b_o [1])]``
        into the packed buffer (or a gradient laid out like it)."""
        shapes = ([(self.H, self.F)]
                  + [(self.H, self.H)] * self.n_hidden + [(1, self.H)])
        pairs, off = [], 0
        for rows, cols in shapes:
            w = packed[off:off + rows * cols].view(rows, cols)
            off += rows * cols
            pairs.append((w, packed[off:off + rows]))
            off += rows
        return pairs

    def hidden(self, pairs, i: int):
        return pairs[1] if self.tied else pairs[1 + i]


def geom_of(params, v_layers: int, tied: bool) -> DiscGeom:
    H, F = params.inp.weight.shape
    return DiscGeom(F, H, v_layers, tied)


def _live_params(params, v_layers: int, tied: bool) -> List[torch.Tensor]:
    layers = [params.inp]
    layers += [params.hidden] if tied else list(params.hidden)
    layers += [params.out]
    return [a for layer in layers for a in (layer.weight, layer.bias)]


def flat_disc(params, v_layers: int, tied: bool) -> List[torch.Tensor]:
    """The weights in the packed order, detached, in f32; the tied hidden
    layer appears once."""
    return [a.detach().float() for a in _live_params(params, v_layers, tied)]


def live_packed_disc(params, v_layers: int, tied: bool) -> torch.Tensor:
    """The packed f32 buffer built from the LIVE parameters, so that a
    gradient for the buffer reaches every ``nn.Linear``."""
    return torch.cat([a.float().reshape(-1)
                      for a in _live_params(params, v_layers, tied)])


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _forward(pairs, geom: DiscGeom, z):
    """Pre-activations ``a_0 .. a_{L-1}`` (the relu inputs), ``y =
    tanh(a_L)`` and ``v`` for features ``z [M, F]``."""
    w0, b0 = pairs[0]
    a = z @ w0.T + b0
    pre = []
    for i in range(geom.L):
        w, b = geom.hidden(pairs, i)
        pre.append(a)
        a = torch.relu(a) @ w.T + b
    y = torch.tanh(a)
    wo, bo = pairs[-1]
    return pre, y, (y @ wo.T + bo)[:, 0]


def _sweep(pairs, geom: DiscGeom, pre, y):
    """The reverse sweep's vectors ``[g_0, ..., g_L]``, each ``[M, H]``."""
    g = pairs[-1][0] * (1.0 - y * y)
    gs = [g]
    for i in range(geom.L - 1, -1, -1):
        g = torch.where(pre[i] > 0, g @ geom.hidden(pairs, i)[0],
                        torch.zeros_like(g))
        gs.append(g)
    return gs[::-1]


def v_dv_fwd_plain(packed: torch.Tensor, feats: torch.Tensor,
                   geom: DiscGeom) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel #6: ``v [M]`` and ``dv/dfeats [M, F]``."""
    pairs = geom.unpack(packed)
    pre, y, v = _forward(pairs, geom, feats)
    gs = _sweep(pairs, geom, pre, y)
    return v, gs[0] @ pairs[0][0]


def v_dv_bwd_plain(packed: torch.Tensor, feats: torch.Tensor,
                   vb: torch.Tensor, gb: torch.Tensor,
                   geom: DiscGeom) -> torch.Tensor:
    """Plain version of kernel #7: the packed weight gradient of
    ``sum(v vb) + sum(gin gb)`` for the outputs of :func:`v_dv_fwd_plain`,
    by the hand-derived adjoint and no autograd.

    The sweep ran last, so its reverse comes first: ``gbar_0 = gb W0^T``,
    ``dW0 += g_0^T gb``; for ``i = 0 .. L-1``: ``tbar = [a_i > 0] gbar_i``,
    ``dW_h += g_{i+1}^T tbar``, ``gbar_{i+1} = tbar W_h^T``. At the output
    ``dw_o += gbar_L (1 - y^2) + vb y``, ``db_o += vb`` and ``ybar = vb w_o
    - 2 y w_o gbar_L`` (the second-order tanh term), ``abar_L = ybar (1 -
    y^2)``. The forward's reverse: for ``i = L-1 .. 0``: ``dW_h += abar^T
    relu(a_i)``, ``db_h += abar``, ``abar = [a_i > 0] (abar W_h)``; then
    ``dW0 += abar^T z``, ``db0 += abar``. A tied ``W_h`` gets all 2L uses;
    the hidden biases get nothing from the sweep.
    """
    pairs = geom.unpack(packed)
    pre, y, _ = _forward(pairs, geom, feats)
    gs = _sweep(pairs, geom, pre, y)
    grad = torch.zeros_like(packed)
    gpairs = geom.unpack(grad)
    w0 = pairs[0][0]
    gpairs[0][0].add_(gs[0].T @ gb)
    gbar = gb @ w0.T
    for i in range(geom.L):
        tbar = torch.where(pre[i] > 0, gbar, torch.zeros_like(gbar))
        geom.hidden(gpairs, i)[0].add_(gs[i + 1].T @ tbar)
        gbar = tbar @ geom.hidden(pairs, i)[0].T
    wo = pairs[-1][0]
    s = 1.0 - y * y
    gpairs[-1][0].add_((gbar * s + vb[:, None] * y).sum(0, keepdim=True))
    gpairs[-1][1].add_(vb.sum())
    abar = (vb[:, None] * wo - 2.0 * y * wo * gbar) * s
    for i in range(geom.L - 1, -1, -1):
        gw, gbias = geom.hidden(gpairs, i)
        gw.add_(abar.T @ torch.relu(pre[i]))
        gbias.add_(abar.sum(0))
        abar = torch.where(pre[i] > 0, abar @ geom.hidden(pairs, i)[0],
                           torch.zeros_like(abar))
    gpairs[0][0].add_(abar.T @ feats)
    gpairs[0][1].add_(abar.sum(0))
    return grad


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def staged_floats(geom: DiscGeom) -> int:
    """Floats of the register #6's staged copy of the weights, twin of
    ``xd_staged_floats`` in ``csrc/disc_fwd.cu``: each layer ``W [out,
    in]`` by columns at a stride of ``out`` rounded up to four floats,
    then ``b`` padded the same; layer 0, the hidden layer (once when
    tied), the output layer ``[1, H]``."""
    def layer(out, inp):
        return (inp + 1) * _pad4(out)
    return (layer(geom.H, geom.F) + geom.n_hidden * layer(geom.H, geom.H)
            + layer(1, geom.H))


def fwd_smem_bytes(geom: DiscGeom) -> int:
    """Shared memory of one block of the register #6 (``xd_fwd_smem``):
    the staged copy, then for each thread its relu sign words, ``ceil(H /
    32)`` a layer, and its slot of ``H`` floats."""
    return 4 * (staged_floats(geom)
                + (geom.L * -(-geom.H // 32) + geom.H) * FWD_THREADS)


def bwd_stride(tile: int) -> int:
    """Floats a row of #7's tile buffers takes for ``tile`` points
    (``xd_bwd_stride``): ``tile + 4``, so that rows start on 16 bytes and
    eight rows an odd count apart fall on distinct banks; ``tile`` itself
    below 16 points, where the pad would not fit the untied d=20 net."""
    return tile + 4 if tile >= 16 else tile


def tile_rows(geom: DiscGeom, variant: str) -> int:
    """Rows of a block's tile buffers of #7 (``xd_tile_rows``): the
    activations and sweep vectors of each layer, two cotangent buffers and
    ``vb``, plus the features and ``gb`` where the ``shared`` variant
    stages them."""
    F, H, L = geom.F, geom.H, geom.L
    rows = 2 * (L + 1) * H + 2 * H + 1
    return rows + 2 * F if variant == "shared" else rows


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def fwd_tile_stride(tile: int) -> int:
    """Floats a row of the tile #6's activation buffers takes
    (``xf_stride``): the smallest odd multiple of 8 at least ``tile``, so
    that the eight row groups of a tensor-core fragment fall on distinct
    banks and rows start on 16 bytes."""
    return tile if tile % 16 == 8 else tile + 8


def fwd_pass(geom: DiscGeom, tile: int) -> int:
    """Outputs a pass of the tile #6's products covers (``XfLayout::OB``):
    at most its block's 8 x 8 micro-tiles at ``tile`` points and
    :data:`FWD_PASS_MAX`; the widest product's outputs (rounded up to 16)
    in as few passes of equal width, a multiple of 16, as that allows."""
    widest = _pad16(max(geom.H, geom.F))
    most = min(FWD_TILE_THREADS * 64 // tile, FWD_PASS_MAX)
    passes = -(-widest // most)
    return _pad16(-(-widest // passes))


def sweep_slice(geom: DiscGeom, tile: int, k_slice: int) -> int:
    """Inputs a slice of the tile #6's sweep and ``gin`` takes beside
    forward slices of ``k_slice`` (``XfLayout::KB``): the most multiple of
    8 (at least 8) whose slice, rows of :func:`fwd_pass` + 8 floats, is no
    larger than the forward's ``fwd_pass x k_slice``."""
    ob = fwd_pass(geom, tile)
    return max(8, k_slice * ob // (8 * (ob + 8)) * 8)


def fwd_tile_smem_bytes(geom: DiscGeom, tile: int, k_slice: int) -> int:
    """Shared memory of one block of the tile #6 at ``tile`` points and
    forward weight slices of ``k_slice`` inputs, twin of ``xf_layout`` in
    ``csrc/disc_tile_fwd.cuh``: two activation buffers of ``H`` rows of
    :func:`fwd_tile_stride` floats; the relu bits of ``a_0 .. a_{L-1}``,
    ``ceil(tile / 32)`` words a unit and layer (rounded up to four); two
    weight slices, each the larger of the forward's, :func:`fwd_pass` rows
    of ``k_slice`` floats, and the sweep's, :func:`sweep_slice` rows of
    :func:`fwd_pass` + 8; and the ``v`` reduction's
    :data:`FWD_TILE_THREADS` partial sums."""
    H, L, ob = geom.H, geom.L, fwd_pass(geom, tile)
    words = L * H * -(-tile // 32)
    kb = sweep_slice(geom, tile, k_slice)
    floats = (2 * H * fwd_tile_stride(tile) + _pad4(words)
              + 2 * max(kb * (ob + 8), ob * k_slice) + FWD_TILE_THREADS)
    return 4 * floats


def fwd_slice(geom: DiscGeom, tile: int) -> int:
    """Inputs a forward weight slice of the tile #6 at ``tile`` points
    (``xf_slice``): the largest of :data:`FWD_SLICES` whose block fits, 0
    where none does."""
    return next((k for k in FWD_SLICES
                 if fwd_tile_smem_bytes(geom, tile, k) <= MAX_SMEM_BYTES), 0)


def tile_smem_bytes(geom: DiscGeom, variant: str, tile: int) -> int:
    """Shared memory of one block of ``variant`` at ``tile`` points, twin
    of ``disc_tile_smem_bytes`` in ``csrc/disc_train.cu``: for ``"shared"``
    or ``"global"`` #7 the tile's rows of :func:`bwd_stride` floats, then
    the ``shared`` variant's gradient accumulator; for the ``"tile"`` #6
    :func:`fwd_tile_smem_bytes` at its :func:`fwd_slice` (at the smallest
    slice where none fits)."""
    if variant == "tile":
        return fwd_tile_smem_bytes(geom, tile,
                                   fwd_slice(geom, tile) or FWD_SLICES[-1])
    acc = geom.n_params if variant == "shared" else 0
    return 4 * (acc + bwd_stride(tile) * tile_rows(geom, variant))


def cluster_acc_floats(geom: DiscGeom, cluster: int) -> int:
    """Floats of one block's accumulator in #7's cluster variant, for a
    tied net (in ``xk_layout``): the rows of its units of the hidden layer
    (at a stride of :func:`hidden_acc_stride` floats) with their biases,
    then of ``W0`` (on 16 bytes), their biases and ``w_o`` (and ``b_o``),
    at the widest slice's count so that every block has one layout
    (:func:`cluster_owned`)."""
    mH = _widest(geom.H, cluster)
    return _pad4(_pad4(mH * hidden_acc_stride(geom.H) + mH)
                 + mH * geom.F + mH + mH + 1)


def hidden_acc_stride(H: int) -> int:
    """The row stride of the hidden layer's rows in a block's accumulator
    of #7's cluster variant (``ldh``): ``H`` rounded up to 8 mod 32, so that
    the eight row groups of a tensor-core tile's lanes fall on distinct
    banks of shared memory."""
    return _ld_mod32(H, 8)


def split_tiles(tile: int) -> int:
    """The 8-point tiles a warp of #7's cluster variant takes a product's
    16 units by (``xk_nb``): 1, 2 or 4."""
    return 1 if tile <= 8 else 2 if tile <= 16 else 4


def cluster_smem_bytes(geom: DiscGeom, cluster: int, tile: int) -> int:
    """Shared memory of one block of #7's cluster variant on clusters of
    ``cluster`` blocks at ``tile`` points, for a tied net, twin of
    ``xk_layout`` in ``csrc/disc_train_cluster.cuh``: two exchange buffers
    of a whole layer, the block's slice of ``A_0 .. A_L``, ``G_0 .. G_L``
    and two cotangent buffers, the features, ``gb`` and ``vb`` of every
    point (every row of the tile :func:`bwd_stride` floats), its
    accumulator, the split products' partial tiles (128 floats a warp and
    8-point tile, :func:`split_tiles`), and its rows and columns of the
    hidden layer, each row at :func:`steppers._ld_mod32` floats."""
    F, H, L = geom.F, geom.H, geom.L
    S, mH = bwd_stride(tile), _widest(H, cluster)
    floats = (2 * H + 2 * (L + 1) * mH + 2 * mH + 2 * F + 1) * S
    floats += (cluster_acc_floats(geom, cluster)
               + CLUSTER_THREADS // 32 * 128 * split_tiles(tile)
               + 2 * mH * _ld_mod32(H, 4))
    return 4 * floats


def cluster_owned(geom: DiscGeom, cluster: int) -> List[List[tuple]]:
    """For each block of a cluster of #7 (a tied net), the weight
    cotangents it owns as runs ``(offset in its accumulator, offset in the
    packed gradient, length)`` (``xk_write_row``): the rows of its units
    (:func:`unit_slices`) of ``W0`` and of the hidden layer, their biases
    and ``w_o``; ``b_o`` is block 0's. Every entry of the packed gradient
    has one owner."""
    F, H = geom.F, geom.H
    mH, ldh = _widest(H, cluster), hidden_acc_stride(H)
    a_w0 = _pad4(mH * ldh + mH)
    a_b0, a_wo = a_w0 + mH * F, a_w0 + mH * F + mH
    off, out_off = F * H + H, F * H + H + H * H + H
    owned = []
    for c, units in enumerate(unit_slices(H, cluster)):
        lo, n = units.start, len(units)
        runs = [(a_w0, lo * F, n * F), (a_b0, H * F + lo, n)]
        runs += [(j * ldh, off + (lo + j) * H, H) for j in range(n)]
        runs += [(mH * ldh, off + H * H + lo, n), (a_wo, out_off + lo, n)]
        if c == 0:
            runs.append((a_wo + mH, out_off + H, 1))
        owned.append(runs)
    return owned


def jax_rows(geom: DiscGeom) -> int:
    """The rows a point takes in the JAX package's backward, which its
    ``v_fused_fits`` bounds by :data:`JAX_MAX_ROWS`."""
    return geom.F + geom.H * (2 * geom.L + 4) + 2


class DiscRoute(NamedTuple):
    """What the wrappers launch for one discriminator on the card
    (:func:`disc_route`)."""
    fwd: str        # #6: "registers" or "tile"
    fwd_tile: int   # points a tile of the tile #6 (0 with registers)
    bwd: str        # #7's accumulator: "shared", "cluster" or "global"
    bwd_tile: int   # points a tile of #7 (a cluster's in "cluster")
    cluster: int = 1  # blocks a thread-block cluster of #7 ("cluster")


def _largest_tile(geom: DiscGeom, variant: str) -> int:
    tiles = FWD_TILES if variant == "tile" else TILES
    return next((t for t in tiles
                 if tile_smem_bytes(geom, variant, t) <= MAX_SMEM_BYTES), 0)


def cluster_tile(geom: DiscGeom, cluster: int) -> int:
    """The largest of :data:`TILES` at which a block of #7's cluster
    variant fits on clusters of ``cluster`` blocks (a tied net); 0 where
    none does."""
    return next((t for t in TILES
                 if cluster_smem_bytes(geom, cluster, t) <= MAX_SMEM_BYTES),
                0)


def cluster_choice(geom: DiscGeom):
    """``(tile, cluster)`` of #7's cluster variant for ``geom``, where the
    route takes it: a tied net at least :data:`CLUSTER` wide whose block
    fits at :data:`CLUSTER_MIN_TILE` points or more, on clusters of
    :data:`CLUSTER` blocks at its :func:`cluster_tile`; None elsewhere."""
    if not geom.tied or geom.H < CLUSTER:
        return None
    tile = cluster_tile(geom, CLUSTER)
    return (tile, CLUSTER) if tile >= CLUSTER_MIN_TILE else None


@functools.lru_cache(maxsize=None)
def disc_route(geom: DiscGeom) -> DiscRoute:
    """The variants and tiles of #6 and #7 for ``geom``: the one place
    where the wrappers choose them, from the shapes, before any launch.
    #6 in registers up to :data:`REG_MAX_WIDTH` wide where its staged
    weights fit a block, else on tiles, at the largest of
    :data:`FWD_TILES` that fits (every net of the domain fits 8 points). #7, in this order: with its accumulator in shared memory
    where it fits beside a tile (at the largest tile that fits); else on
    thread-block clusters (:func:`cluster_choice`); else in ``partial``,
    at the largest tile that fits. Raises, naming the bound, past the JAX
    package's Pallas domain (its ``v_fused_fits``)."""
    F, H, L = geom.F, geom.H, geom.L
    if min(F, H, L) < 1 or jax_rows(geom) > JAX_MAX_ROWS:
        raise ValueError(
            f"the discriminator {geom} is past the fused kernels' domain "
            f"(v_fused_fits, the JAX package's Pallas bound): F + "
            f"v_hidden_dim (2 v_layers + 4) + 2 = {jax_rows(geom)} rows, "
            f"at most {JAX_MAX_ROWS}")
    if H <= REG_MAX_WIDTH and fwd_smem_bytes(geom) <= MAX_SMEM_BYTES:
        fwd = ("registers", 0)
    else:
        fwd = ("tile", _largest_tile(geom, "tile"))
    shared = _largest_tile(geom, "shared")
    clustered = cluster_choice(geom)
    if shared:
        bwd = ("shared", shared)
    elif clustered:
        bwd = ("cluster", *clustered)
    else:
        bwd = ("global", _largest_tile(geom, "global"))
    if not (fwd[0] == "registers" or fwd[1]) or not bwd[1]:
        raise ValueError(f"the discriminator {geom} does not fit kernels "
                         f"#6/#7 at {FWD_TILES[-1]} / {TILES[-1]} points a "
                         "tile")
    return DiscRoute(*fwd, *bwd)


def v_fused_fits(params, v_layers: int, tied: bool) -> bool:
    """Whether kernels #6 and #7 take this discriminator: wherever the JAX
    package runs its Pallas kernels (:func:`disc_route`). Decided from
    shapes, before any launch."""
    try:
        disc_route(geom_of(params, v_layers, tied))
    except ValueError:
        return False
    return True


def bwd_grid(geom: DiscGeom, variant: str, tile: int, M: int, sms: int,
             cluster: int = 1, device: int = 0) -> int:
    """#7's persistent grid, one partial row each, at most
    :data:`PARTIAL_BYTES` of them: in blocks (``steppers.bwd_blocks``), or
    for the cluster variant in clusters, as many as ``device`` runs at once
    (:func:`cluster_occupancy`) and at most one a tile."""
    if variant == "cluster":
        rows = min(-(-M // tile), cluster_occupancy(device, geom, tile,
                                                    cluster))
    else:
        rows = bwd_blocks(M, tile, tile_smem_bytes(geom, variant, tile),
                          BWD_THREADS, sms)
    return max(1, min(rows, PARTIAL_BYTES // (4 * geom.n_params)))


@functools.lru_cache(maxsize=None)
def cluster_occupancy(device: int, geom: DiscGeom, tile: int,
                      cluster: int) -> int:
    """Clusters of #7's cluster variant at ``tile`` points on clusters of
    ``cluster`` blocks that the card runs at once
    (``disc_cluster_occupancy``); raises where it runs none."""
    lib, _ = BWD_CLUSTER_KERNEL.load()
    fn = lib.disc_cluster_occupancy
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    n = fn(device, geom.F, geom.H, geom.L, tile, cluster)
    if n <= 0:
        error = f" (CUDA error {-n})" if n < 0 else ""
        raise RuntimeError(f"#7's cluster variant at {tile} points on "
                           f"clusters of {cluster} for the net {geom}: the "
                           f"card runs no such cluster{error}")
    return n


def _checks(packed, feats, geom: DiscGeom):
    route = disc_route(geom)
    dev = require_cuda_f32([packed, feats])
    if packed.shape != (geom.n_params,) or feats.dim() != 2 \
            or feats.shape[1] != geom.F:
        raise ValueError(f"shape mismatch: packed [{geom.n_params}], feats "
                         f"[M, {geom.F}]")
    return route, dev


def _fwd_tile(packed, feats, geom: DiscGeom, tile: int, dev):
    """Launch the tile #6 at ``tile`` points a tile (its persistent grid
    and its slice are the launcher's)."""
    M = feats.shape[0]
    v = torch.empty((M,), dtype=torch.float32, device=dev)
    gin = torch.empty((M, geom.F), dtype=torch.float32, device=dev)
    FWD_TILE_KERNEL(dev, packed.data_ptr(), packed.numel(), feats.data_ptr(),
                    v.data_ptr(), gin.data_ptr(), M, geom.F, geom.H, geom.L,
                    int(geom.tied), tile)
    return v, gin


def v_dv_fwd_cuda(packed, feats, geom: DiscGeom):
    """Launch kernel #6, in the variant :func:`disc_route` picks, on
    PyTorch's current stream; same outputs as :func:`v_dv_fwd_plain`."""
    route, dev = _checks(packed, feats, geom)
    if route.fwd == "tile":
        return _fwd_tile(packed, feats, geom, route.fwd_tile, dev)
    M = feats.shape[0]
    v = torch.empty((M,), dtype=torch.float32, device=dev)
    gin = torch.empty((M, geom.F), dtype=torch.float32, device=dev)
    FWD_KERNEL(dev, packed.data_ptr(), packed.numel(), feats.data_ptr(),
               v.data_ptr(), gin.data_ptr(), M, geom.F, geom.H, geom.L,
               int(geom.tied), widths=(geom.H,))
    return v, gin


def _bwd(kernel, packed, feats, vb, gb, geom: DiscGeom, tile: int,
         blocks: int, dev) -> torch.Tensor:
    """Launch ``kernel`` (#7's shared or global variant) at ``tile``
    points a tile on ``blocks`` blocks, and its fixed-order reduce."""
    partial = torch.empty((blocks, geom.n_params), dtype=torch.float32,
                          device=dev)
    grad = torch.empty((geom.n_params,), dtype=torch.float32, device=dev)
    kernel(dev, packed.data_ptr(), packed.numel(), feats.data_ptr(),
           vb.data_ptr(), gb.data_ptr(), partial.data_ptr(), grad.data_ptr(),
           feats.shape[0], geom.F, geom.H, geom.L, int(geom.tied), tile,
           blocks)
    return grad


def _bwd_cluster(packed, feats, vb, gb, geom: DiscGeom, tile: int,
                 clusters: int, cluster: int, dev) -> torch.Tensor:
    """Launch #7's cluster variant at ``tile`` points a tile on
    ``clusters`` clusters of ``cluster`` blocks, and its fixed-order
    reduce."""
    partial = torch.empty((clusters, geom.n_params), dtype=torch.float32,
                          device=dev)
    grad = torch.empty((geom.n_params,), dtype=torch.float32, device=dev)
    BWD_CLUSTER_KERNEL(dev, packed.data_ptr(), packed.numel(),
                       feats.data_ptr(), vb.data_ptr(), gb.data_ptr(),
                       partial.data_ptr(), grad.data_ptr(), feats.shape[0],
                       geom.F, geom.H, geom.L, int(geom.tied), tile, clusters,
                       cluster)
    return grad


def v_dv_bwd_cuda(packed, feats, vb, gb, geom: DiscGeom) -> torch.Tensor:
    """Launch kernel #7, in the variant :func:`disc_route` picks, and its
    fixed-order reduce on PyTorch's current stream; same result as
    :func:`v_dv_bwd_plain`."""
    route, dev = _checks(packed, feats, geom)
    require_cuda_f32([vb, gb])
    M = feats.shape[0]
    if vb.shape != (M,) or gb.shape != (M, geom.F):
        raise ValueError("shape mismatch: vb [M], gb [M, F]")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = bwd_grid(geom, route.bwd, route.bwd_tile, M, sms, route.cluster,
                    dev.index)
    if route.bwd == "cluster":
        return _bwd_cluster(packed, feats, vb, gb, geom, route.bwd_tile,
                            rows, route.cluster, dev)
    kernel = BWD_GLOBAL_KERNEL if route.bwd == "global" else BWD_KERNEL
    return _bwd(kernel, packed, feats, vb, gb, geom, route.bwd_tile, rows,
                dev)


class VDvFused(torch.autograd.Function):
    """``(v [M], dv/dfeats [M, F])`` with the hand-written backward.

    Forward: kernel #6. Backward: kernel #7, the gradient of the packed
    weights only (the features are data, as the JAX package's
    ``_v_core_bwd`` returns zeros for them). Saves only ``(packed,
    feats)``; #7 recomputes the rest. CPU tensors take the plain versions.
    """

    @staticmethod
    def forward(ctx, packed, geom, feats):
        if packed.is_cuda:
            v, gin = v_dv_fwd_cuda(packed, feats, geom)
        elif packed.device.type == "cpu":
            v, gin = v_dv_fwd_plain(packed, feats, geom)
        else:
            raise ValueError(f"no disc kernel for device {packed.device}")
        ctx.save_for_backward(packed, feats)
        ctx.geom = geom
        return v, gin

    @staticmethod
    def backward(ctx, vb, gb):
        packed, feats = ctx.saved_tensors
        vb, gb = vb.contiguous(), gb.contiguous()
        if packed.is_cuda:
            grad = v_dv_bwd_cuda(packed, feats, vb, gb, ctx.geom)
        else:
            grad = v_dv_bwd_plain(packed, feats, vb, gb, ctx.geom)
        return grad, None, None


def fourier_pullback(g: torch.Tensor, pts: torch.Tensor,
                     n_freq: int) -> torch.Tensor:
    """``dv/dpts [M, C]`` from ``dv/dfeats [M, F]`` through
    :func:`disc_features`, in closed form per coordinate: ``d/dx_j =
    g[x_j] + sum_k (k pi/2)(g[sin_jk] cos(k pi/2 x_j) - g[cos_jk] sin(k
    pi/2 x_j))``. Linear in ``g`` and differentiable through it; no ``[M,
    C, F]`` Jacobian."""
    M, C = pts.shape
    d = C - 1
    k = torch.arange(1, n_freq + 1, dtype=g.dtype, device=g.device) * (
        math.pi / 2)
    ph = pts[:, 1:, None].to(g.dtype) * k                 # [M, d, K]
    bank = g[:, C:].reshape(M, d, 2 * n_freq)
    gs, gc = bank[..., :n_freq], bank[..., n_freq:]
    dx = g[:, 1:C] + (k * (gs * torch.cos(ph) - gc * torch.sin(ph))).sum(-1)
    return torch.cat([g[:, :1], dx], dim=-1)


def v_dv_fused(params, pts: torch.Tensor, *, v_layers: int, tied: bool,
               n_freq: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ``(v [M], dv [M, C])``: discriminator values and pointwise
    space-time gradients at ``pts [M, C]`` (time at channel 0), in f32,
    with a weight-only gradient. Same contract as the JAX package's
    ``v_dv_fused`` (``:262-309``); ``n_freq`` applies the
    ``v_fourier_features`` bank and pulls the feature gradient back to
    raw coordinates (:func:`fourier_pullback`)."""
    geom = geom_of(params, v_layers, tied)
    pts = pts.detach().float()
    feats = disc_features(pts, n_freq).contiguous()
    packed = live_packed_disc(params, v_layers, tied)
    if not (torch.is_grad_enabled() and packed.requires_grad):
        packed = packed.detach()
    v, g = VDvFused.apply(packed, geom, feats)
    if n_freq == 0:
        return v, g
    return v, fourier_pullback(g, pts, n_freq)
