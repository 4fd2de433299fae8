"""The adversary's training hot path: the discriminator's value with its
input gradient, and the weight cotangents of both. Port of
``xnode_wan_tpu/ops/pallas/disc_train.py`` (the ``fused_v: true`` path).

**Kernel #6** (:func:`v_dv_fwd_cuda`, ``csrc/disc_fwd.cu::
disc_fwd_kernel``) replaces ``_v_fwd_kernel``: for features ``z [F]`` per
point, the forward ``a0 = W0 z + b0``, ``a_{i+1} = W_h relu(a_i) + b_h``
(``i < L = v_layers``), ``y = tanh(a_L)``, ``v = w_o . y + b_o``, then one
reverse sweep ``g_L = w_o (1 - y^2)``, ``g_i = [a_i > 0] (W_h^T g_{i+1})``,
``gin = W0^T g_0``: ``v [M]`` and ``dv/dz [M, F]``. It is built once per
adversary width ``H`` (``libdisc_fwd_H<H>.so``), one thread per point over
a block's copy of the weights staged by columns (:func:`staged_floats`).

**Kernel #7** (:func:`v_dv_bwd_cuda`, ``csrc/disc_train.cu::
disc_bwd_kernel``) replaces
``_v_bwd_kernel``: the gradient of ``sum(v vb) + sum(gin gb)`` in the
packed weights, second-order terms included, summed over the points. The
Pallas kernel takes it from ``jax.vjp`` of the whole function; here the
adjoint is derived by hand (:func:`v_dv_bwd_plain` writes it as batched
tensor math, the kernel per tile of points). It is built once per
adversary width ``H`` (``libdisc_train_H<H>.so``). A block of
:data:`BWD_THREADS` threads walks tiles of :func:`bwd_tile` points with
every layer's vectors in shared memory (rows of :func:`bwd_stride`
floats); each matrix product runs as register micro-tiles (2 outputs x 4
points a thread, one float4 of the tile and two weights per input), each
weight cotangent as micro-tiles of owned entries, summed over the tile's
points in order; one partial per block, summed over blocks in a fixed
order, so two launches are bitwise equal.

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
import math
from typing import List, NamedTuple, Tuple

import torch

from xnode_wan_tpu_torch.models.discriminator import disc_features
from xnode_wan_tpu_torch.ops.kernels._build import CudaKernel
from xnode_wan_tpu_torch.ops.kernels.steppers import (MAX_SMEM_BYTES,
                                                      _pad4, bwd_blocks,
                                                      require_cuda_f32)

_P, _I = ctypes.c_void_p, ctypes.c_int
# kernel #6: packed weights, count, feats, v, gin; M F H v_layers tied
FWD_KERNEL = CudaKernel("disc_fwd", "disc_fwd_launch",
                        [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I])
# kernel #7: packed weights, count, feats, vb, gb, partial, grad;
# M F H v_layers tied, points per tile, blocks
BWD_KERNEL = CudaKernel("disc_train", "disc_bwd_launch",
                        [_P, _I, _P, _P, _P, _P, _P] + [_I] * 7)

# Compile-time constants of csrc/disc_net.cuh, disc_fwd.cu, disc_train.cu
MAX_WIDTH = 64        # XD_MAX_WIDTH: v_hidden_dim
MAX_FEATS = 128       # XD_MAX_FEATS: feature width F
MAX_LAYERS = 32       # XD_MAX_LAYERS: v_layers
FWD_THREADS = 128     # XD_FWD_THREADS: a kernel-#6 block, one point each
BWD_TILES = (32, 16, 8)  # points per tile of kernel #7, largest first
BWD_THREADS = 256     # XD_BWD_THREADS: a kernel-#7 block


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
    """Floats of kernel #6's staged copy of the weights, twin of
    ``xd_staged_floats`` in ``csrc/disc_fwd.cu``: each layer ``W [out,
    in]`` by columns at a stride of ``out`` rounded up to four floats,
    then ``b`` padded the same; layer 0, the hidden layer (once when
    tied), the output layer ``[1, H]``."""
    def layer(out, inp):
        return (inp + 1) * _pad4(out)
    return (layer(geom.H, geom.F) + geom.n_hidden * layer(geom.H, geom.H)
            + layer(1, geom.H))


def fwd_smem_bytes(geom: DiscGeom) -> int:
    """Shared memory of one kernel-#6 block (``xd_fwd_smem``): the staged
    copy, then for each thread its relu sign words, ``ceil(H / 32)`` a
    layer, and its slot of ``H`` floats."""
    return 4 * (staged_floats(geom)
                + (geom.L * -(-geom.H // 32) + geom.H) * FWD_THREADS)


def bwd_stride(tile: int) -> int:
    """Floats a row of kernel #7's tile buffers takes for ``tile`` points
    (``xd_bwd_stride``): ``tile + 4``, so that rows start on 16 bytes and
    eight rows an odd count apart fall on distinct banks; ``tile`` itself
    below 16 points, where the pad would not fit the untied d=20 net."""
    return tile + 4 if tile >= 16 else tile


def bwd_smem_bytes(geom: DiscGeom, tile: int) -> int:
    """Shared memory of one kernel-#7 block (``xd_bwd_smem`` in the
    ``.cu``): each layer's activations and sweep vectors, two cotangent
    buffers, features, ``gb`` and ``vb`` for ``tile`` points, rows of
    :func:`bwd_stride` floats, then the block's gradient accumulator."""
    F, H, L = geom.F, geom.H, geom.L
    rows = 2 * (L + 1) * H + 2 * H + 2 * F + 1
    return 4 * (geom.n_params + bwd_stride(tile) * rows)


def bwd_tile(geom: DiscGeom) -> int:
    """Points per tile of kernel #7: the largest of :data:`BWD_TILES` whose
    block fits shared memory."""
    for tile in BWD_TILES:
        if bwd_smem_bytes(geom, tile) <= MAX_SMEM_BYTES:
            return tile
    raise ValueError(f"the discriminator {geom} does not fit kernel #7's "
                     f"shared memory at {BWD_TILES[-1]} points a tile")


def _geom_fits(geom: DiscGeom) -> bool:
    return (1 <= geom.H <= MAX_WIDTH and 1 <= geom.F <= MAX_FEATS
            and 1 <= geom.L <= MAX_LAYERS
            and fwd_smem_bytes(geom) <= MAX_SMEM_BYTES
            and bwd_smem_bytes(geom, BWD_TILES[-1]) <= MAX_SMEM_BYTES)


def v_fused_fits(params, v_layers: int, tied: bool) -> bool:
    """Whether kernels #6 and #7 take this discriminator: widths under the
    compile-time caps, #6's staged weights with its sign words and #7's
    smallest tile in one block's shared memory. Decided from shapes,
    before any launch."""
    return _geom_fits(geom_of(params, v_layers, tied))


def check_fits(geom: DiscGeom) -> None:
    """Raise, naming the caps, unless kernels #6 and #7 take ``geom``."""
    if not _geom_fits(geom):
        raise ValueError(
            f"the discriminator {geom} exceeds the CUDA kernels' caps "
            f"(v_fused_fits): v_hidden_dim <= {MAX_WIDTH}, feature width <= "
            f"{MAX_FEATS}, v_layers <= {MAX_LAYERS}, and kernel #6's staged "
            f"weights and #7's {BWD_TILES[-1]}-point tile each within "
            f"{MAX_SMEM_BYTES} bytes of shared memory")


def _checks(packed, feats, geom: DiscGeom) -> torch.device:
    check_fits(geom)
    dev = require_cuda_f32([packed, feats])
    if packed.shape != (geom.n_params,) or feats.dim() != 2 \
            or feats.shape[1] != geom.F:
        raise ValueError(f"shape mismatch: packed [{geom.n_params}], feats "
                         f"[M, {geom.F}]")
    return dev


def v_dv_fwd_cuda(packed, feats, geom: DiscGeom):
    """Launch kernel #6, from the library built for ``geom.H``, on
    PyTorch's current stream; same outputs as :func:`v_dv_fwd_plain`."""
    dev = _checks(packed, feats, geom)
    M = feats.shape[0]
    v = torch.empty((M,), dtype=torch.float32, device=dev)
    gin = torch.empty((M, geom.F), dtype=torch.float32, device=dev)
    FWD_KERNEL(dev, packed.data_ptr(), packed.numel(), feats.data_ptr(),
               v.data_ptr(), gin.data_ptr(), M, geom.F, geom.H, geom.L,
               int(geom.tied), widths=(geom.H,))
    return v, gin


def v_dv_bwd_cuda(packed, feats, vb, gb, geom: DiscGeom) -> torch.Tensor:
    """Launch kernel #7, from the library built for ``geom.H``, and its
    fixed-order reduce on PyTorch's current stream; same result as
    :func:`v_dv_bwd_plain`."""
    dev = _checks(packed, feats, geom)
    require_cuda_f32([vb, gb])
    M = feats.shape[0]
    if vb.shape != (M,) or gb.shape != (M, geom.F):
        raise ValueError("shape mismatch: vb [M], gb [M, F]")
    tile = bwd_tile(geom)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = bwd_blocks(M, tile, bwd_smem_bytes(geom, tile), BWD_THREADS, sms)
    partial = torch.empty((blocks, geom.n_params), dtype=torch.float32,
                          device=dev)
    grad = torch.empty((geom.n_params,), dtype=torch.float32, device=dev)
    BWD_KERNEL(dev, packed.data_ptr(), packed.numel(), feats.data_ptr(),
               vb.data_ptr(), gb.data_ptr(), partial.data_ptr(),
               grad.data_ptr(), M, geom.F, geom.H, geom.L, int(geom.tied),
               tile, blocks, widths=(geom.H,))
    return grad


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
