"""The training hot path: XNODE path forwards with and without spatial
tangents, and the hand-derived backward. Port of
``xnode_wan_tpu/ops/pallas/xnode_train.py``.

**Tangentless path forward** ``u [N, L]``, the fresh-sample metric
forward. Replaces ``_fwd_only_kernel`` (reached through
``_build_fwd_only`` and ``u_forward_fused``), which the JAX trainer runs
every outer step to score the current solution (``training.py:230-240,
519``).

**Forward with spatial tangents and its backward** (:func:`u_du_fused`,
the :class:`UDuFused` autograd function): ``u [N, L]`` and ``grad_x u
[N, L, d]`` for the weak-form loss, with a weight gradient that runs a
hand-derived adjoint. Replaces ``_fwd_kernel`` (#3), ``_fwd_store_kernel``
(#4) and ``_bwd_kernel`` (#5) through ``_fused_core``. Kernels in
``csrc/xnode_grad.cu`` (design and bounds in its header); plain versions
:func:`u_du_fwd_plain` and :func:`u_du_bwd_plain`.

Kernel #2 comes in two variants, chosen from the net's shapes before
any launch (:func:`kernel_route`, the one place where every variant,
block and tangent chunk of #1-#5 is chosen). Within the caps of
``csrc/steppers.cuh`` (H, Hh <= 64 and the staged weights in one block's
shared memory; any feature width):
``csrc/xnode_fwd.cu::xnode_fwd_kernel<false>`` through
``xnode_path_fwd_launch``, the body it shares with serving (#1), built
once per width pair (H, Hh) so that each thread's state, RK stages and
activations live in registers. One thread per path, one warp a block. A
block stages the weights in shared memory (2,372 floats at the d=5
width, by columns padded to four floats); the block's feature rows pass
through shared memory once, coalesced, for field layer 0's feature
columns; the thread lifts its seed, then walks the L intervals with n_sub
RK substeps each and writes ``u`` after every interval. Masked samples
come with ``dt = 0`` from :func:`_prep_intervals`, so their interval is
the identity and the kernel needs no branch on the mask. Past the caps:
the path-tile kernel (``csrc/xnode_path_tile.cu``, launcher
``xnode_path_tile_launch``): a block walks a tile of 16 to 128 paths,
each layer one product of the tile's rows in FP32 register micro-tiles,
the field's weights resident in shared memory where they fit beside the
tile and streamed a slice at a time by ``cp.async`` otherwise
(:func:`path_tile`; :data:`PATH_LAUNCHES` counts both variants).

Kernel #5 has three variants (:func:`grad_tile`): its gradient
accumulator in shared memory; where that does not fit beside the rest of
the block (H = Hh = 64 at d = 5), on a thread-block cluster of 2, 4 or 8
blocks that split every layer's units, and with them the tile's state and
the accumulator (``xnode_udu_bwd_cluster_launch``,
``csrc/xnode_grad_cluster.cuh``); where not even a block's share of the
accumulator fits, in the block's row of the partial sums in global memory
(``xnode_udu_bwd_global_launch``), bitwise equal to the first at the same
tile and grid. Where no tile of #3-#5 fits one block at the full d,
:func:`fused_from_batch` runs them in tangent chunks (:func:`u_chunk`, the
port of the JAX package's ``d_chunk``).

Bound on an H100 SXM (67 TFLOP/s FP32 without tensor cores, 3.35 TB/s):
at the d=5 metric batch (N = 4,000, L = 20, midpoint, n_sub = 1) the work
is about 0.36 GFLOP (5.4 µs) and the bytes about 1.1 MB (0.3 µs). With
only 4,000 threads (125 warps, one per SM at 32 threads a block) the
kernel is bound by the latency of its serial chain of 40 field
evaluations, far above either figure: each SM issues one warp's chain of
about 1,800 instructions an evaluation. The design spreads the warps over
the SMs and keeps every operand in registers or shared memory; several
lanes a path is the next step.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from xnode_wan_tpu_torch.ops.kernels._build import CudaKernel, KernelVariants
from xnode_wan_tpu_torch.ops.kernels.steppers import (MAX_SMEM_BYTES,
                                                      METHOD_IDS, RK_TABLES,
                                                      SM_SMEM_BYTES,
                                                      FlatNet, _ld_mod32,
                                                      _widest, bwd_blocks,
                                                      field_fwd_tan,
                                                      interval_tan,
                                                      mlp_relu_fwd_tan,
                                                      register_fits,
                                                      require_cuda_f32,
                                                      rk_step, unit_slices)

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "xnode_fwd", "xnode_path_fwd_launch",
    [_P, _I,                  # packed weights, count
     _P, _P, _P, _P, _P,      # t0, dt, feats, seed, u
     _I, _I, _I, _I, _I, _I, _I, _I, _I])  # N L H Hh F n_lift n_field n_sub method
_GEOM = [_I] * 10             # N L d H Hh F n_lift n_field n_sub method
_PATH = [_P, _I, _P, _P, _P, _P, _P, _P]  # weights, count, t0 dt feats dfeats seed dseed
# kernel #3: u, du; paths per tile, threads
FWD_KERNEL = CudaKernel("xnode_grad", "xnode_udu_fwd_launch",
                        _PATH + [_P, _P] + _GEOM + [_I, _I])
# kernel #4: u, du, hs, hts; paths per tile, threads
FWD_STORE_KERNEL = CudaKernel("xnode_grad", "xnode_udu_fwd_store_launch",
                              _PATH + [_P, _P, _P, _P] + _GEOM + [_I, _I])
# kernel #5: hs, hts, ub, dub, partial, grad; paths per tile, threads, blocks
BWD_KERNEL = CudaKernel("xnode_grad", "xnode_udu_bwd_launch",
                        _PATH + [_P] * 6 + _GEOM + [_I, _I, _I])
# #5 with its accumulator in partial (the same arguments)
BWD_GLOBAL_KERNEL = CudaKernel("xnode_grad", "xnode_udu_bwd_global_launch",
                               BWD_KERNEL.argtypes)
# #5 on thread-block clusters: the same arguments, the grid as a number of
# clusters, then the blocks a cluster
BWD_CLUSTER_KERNEL = CudaKernel("xnode_grad", "xnode_udu_bwd_cluster_launch",
                                BWD_KERNEL.argtypes + [_I])
# #2 past the register kernel's caps (csrc/xnode_path_tile.cu): weights,
# count, the staged copy (scratch), t0, dt, feats, seed, u; N L H Hh F
# n_lift n_field n_sub method; paths a tile, inputs a weight slice
PATH_TILE_KERNEL = CudaKernel("xnode_path_tile", "xnode_path_tile_launch",
                              [_P, _I, _P, _P, _P, _P, _P, _P] + [_I] * 11)
# launches of #2 and of #5, each over its variants
PATH_LAUNCHES = KernelVariants({"registers": KERNEL,
                                "tile": PATH_TILE_KERNEL})
BWD_LAUNCHES = KernelVariants({"shared": BWD_KERNEL,
                               "cluster": BWD_CLUSTER_KERNEL,
                               "global": BWD_GLOBAL_KERNEL})
MAX_THREADS = 256             # XG_MAX_THREADS
# Paths per tile, largest first; the threads of a block follow from the
# tile (block_threads). From the tile sweep (tile_sweep.py) on an H100:
# the rule (grad_tile) picks the fastest #5 swept at cube_pde (8
# paths, 128 threads), ex4_1_d10 (4, 128), highdim_d20 (1, 256), the
# cube's widths at d = 20 (2, 128) and d = 50 (1, 128) and d = 100 with
# its Fourier bank (1, 256), and #3/#4 at the first three, d = 20 and d =
# 50 within 7% of the fastest
FWD_TILES = (4, 2, 1)
BWD_TILES = (8, 4, 2, 1)
# The path-tile #1/#2 (csrc/xnode_path_tile.cu): XP_THREADS threads a
# block; path_tile takes the first (paths a tile, inputs a weight slice;
# 0: the field's weights resident) of PATH_ORDER that fits. From the sweep
# on an H100 (tile_sweep.py --path at 128/128, 96/64, 72/80 and 256/256,
# #2 at 4,000 paths): 32 rows beat 16 at the same slice (and 64, which
# leave half the SMs idle), resident weights beat any streamed slice, a
# larger slice beats a smaller one (fewer waits and barriers); 32 rows
# at 32-input slices beat 16 rows with the weights resident (96/64), but
# 16 rows at 32 inputs beat 32 rows at 16 (256/256)
PATH_TILE_THREADS = 256
PATH_SLICES = (128, 64, 32, 16, 8)
PATH_ORDER = tuple([(32, k) for k in (0, 128, 64, 32)]
                   + [(16, k) for k in (0,) + PATH_SLICES]
                   + [(32, k) for k in (16, 8)])
# #5's shared and global variants take about 220 registers a thread
# (ptxas; chip_smoke.py's phase 1 prints them), so two of their blocks
# fit an SM's 65,536 registers at up to this many threads each
TWO_BLOCK_BWD_THREADS = 128
# #5's cluster variant: blocks a cluster, smallest first, and paths a tile
# (a cluster's), largest first
CLUSTERS = (2, 4, 8)
CLUSTER_TILES = (32, 16, 8, 4, 2, 1)


def _live_params(params) -> List[torch.Tensor]:
    """Weights ``[out, in]`` and biases ``[out]`` in the kernels' order:
    lift, field, readout."""
    return [a for layer in [*params.lift, *params.field, params.readout]
            for a in (layer.weight, layer.bias)]


def _flatten_params_t(params) -> List[torch.Tensor]:
    """:func:`_live_params` detached, in f32."""
    return [a.detach().float() for a in _live_params(params)]


def flat_net(params) -> FlatNet:
    return FlatNet(_flatten_params_t(params), len(params.lift),
                   len(params.field))


def _prep_intervals(times: torch.Tensor, mask: torch.Tensor,
                    t_start: torch.Tensor, n_sub: int):
    """Per-interval (start time, substep) with masking-by-zero-width.

    Each valid sample integrates from the previous VALID sample time (or
    ``t_start``); invalid samples get ``dt = 0``.
    """
    neg = torch.full_like(times, -float("inf"))
    prev = torch.cat([t_start[:, None], torch.where(mask, times, neg)[:, :-1]],
                     dim=1)
    t0 = torch.maximum(torch.cummax(prev, dim=1).values, t_start[:, None])
    dt = torch.where(mask, torch.clamp(times - t0, min=0.0),
                     torch.zeros_like(times)) / n_sub
    return t0, dt


def path_forward_plain(net: FlatNet, t0, dt, feats, seed, n_sub: int,
                       method: str) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``u [N, L]`` before scaling."""
    h = net.lift_apply(seed)

    def field(t, hh):
        return net.field_apply(feats, t, hh)

    us = []
    for l in range(t0.shape[1]):
        ta, d = t0[:, l:l + 1], dt[:, l:l + 1]
        for k in range(n_sub):
            h = rk_step(method, field, ta + k * d, d, h)
        us.append(net.readout(h))
    return torch.stack(us, dim=1)


def path_forward_cuda(net: FlatNet, t0, dt, feats, seed, n_sub: int,
                      method: str, packed=None) -> torch.Tensor:
    """Launch the path forward on PyTorch's current stream, in the variant
    :func:`kernel_route` picks: the register kernel of
    ``csrc/xnode_fwd.cu`` (from the library built for the net's widths),
    else the path-tile kernel of ``csrc/xnode_path_tile.cu``."""
    if method not in METHOD_IDS:
        rk_step(method, None, None, None, None)  # raises the shared error
    route = kernel_route(net.dims(), 0, method)
    if packed is None:
        packed = net.packed()
    if route.path == "tile":
        return _path_tile_forward(net, packed, t0, dt, feats, seed, n_sub,
                                  method, route.path_tile)
    dev = require_cuda_f32([packed, t0, dt, feats, seed])
    N, L = t0.shape
    H, Hh, F, n_lift, n_field = net.dims()
    _path_shapes(net, t0, dt, feats, seed)
    u = torch.empty((N, L), dtype=torch.float32, device=dev)
    KERNEL(dev, packed.data_ptr(), packed.numel(), t0.data_ptr(),
           dt.data_ptr(), feats.data_ptr(), seed.data_ptr(), u.data_ptr(), N,
           L, H, Hh, F, n_lift, n_field, n_sub, METHOD_IDS[method],
           widths=(H, Hh))
    return u


def _path_shapes(net: FlatNet, t0, dt, feats, seed) -> None:
    N, L = t0.shape
    if dt.shape != (N, L) or feats.shape != (N, net.F) or seed.shape != (N,):
        raise ValueError("shape mismatch: t0/dt [N, L], feats [N, F], seed [N]")


def _path_tile_forward(net: FlatNet, packed, t0, dt, feats, seed,
                       n_sub: int, method: str, tile: PathTile
                       ) -> torch.Tensor:
    """``u [N, L]`` from the path-tile kernel at ``tile`` (any tile that
    fits, :func:`path_tile_smem_bytes`), counted on
    :data:`PATH_TILE_KERNEL`; the launcher stages the field's weights into
    a scratch copy first (:func:`path_tile_staged_floats`)."""
    dev = require_cuda_f32([packed, t0, dt, feats, seed])
    _path_shapes(net, t0, dt, feats, seed)
    N, L = t0.shape
    u = torch.empty((N, L), dtype=torch.float32, device=dev)
    staged = torch.empty((path_tile_staged_floats(net.dims()),),
                         dtype=torch.float32, device=dev)
    PATH_TILE_KERNEL(dev, packed.data_ptr(), packed.numel(),
                     staged.data_ptr(), t0.data_ptr(), dt.data_ptr(),
                     feats.data_ptr(), seed.data_ptr(), u.data_ptr(), N, L,
                     *net.dims(), n_sub, METHOD_IDS[method], tile.rows,
                     tile.slice)
    return u


def path_forward(net: FlatNet, t0, dt, feats, seed, n_sub: int,
                 method: str) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if t0.is_cuda:
        return path_forward_cuda(net, t0, dt, feats, seed, n_sub, method)
    if t0.device.type == "cpu":
        return path_forward_plain(net, t0, dt, feats, seed, n_sub, method)
    raise ValueError(f"no path-forward kernel for device {t0.device}")


def u_forward_fused(params, batch, problem, cfg) -> torch.Tensor:
    """Primal values ``u [N, L]`` on a path batch, f32, no gradients.

    Seeds through :func:`models.xnode.path_seed_fn`, the seeding shared
    with the masked-scan forward.
    """
    from xnode_wan_tpu_torch.models.xnode import path_seed_fn, spatial_features

    with torch.no_grad():
        xs = batch.space[:, 0, :].float()
        seed = path_seed_fn(batch, problem, cfg)(xs)
        feats = spatial_features(xs, cfg.fourier_features)
        t0, dt = _prep_intervals(batch.times.float(), batch.mask,
                                 batch.t_start.float(), cfg.n_sub)
        u = path_forward(flat_net(params), t0.contiguous(), dt.contiguous(),
                         feats.contiguous(), seed.contiguous(), cfg.n_sub,
                         cfg.solver)
    return u * float(cfg.u_scale_eff)


# ---------------------------------------------------------------------------
# Forward with spatial tangents (#3, #4) and the backward (#5)
# ---------------------------------------------------------------------------


def live_packed(params) -> torch.Tensor:
    """The packed f32 weight buffer built from the LIVE parameters, so that
    a gradient for the buffer flows back to every ``nn.Linear``."""
    return torch.cat([a.float().reshape(-1) for a in _live_params(params)])


def u_du_fwd_plain(net: FlatNet, t0, dt, feats, dfeats, seed, dseed,
                   n_sub: int, method: str, store: bool = False):
    """Plain version of kernels #3 / #4: ``u [N, L]`` and ``du [N, L, d]``
    before scaling; with ``store`` also the interval start states ``hs
    [L, N, H]`` and ``hts [L, N, d, H]``. With d = 0 (``dfeats [N, 0,
    F]``, ``dseed [N, 0]``) it is the tangentless path forward."""
    h, ht = mlp_relu_fwd_tan(net.lift, seed[:, None], dseed[:, :, None])
    wr, br = net.readout_layer
    us, dus, hs, hts = [], [], [], []
    for l in range(t0.shape[1]):
        if store:
            hs.append(h)
            hts.append(ht)
        h, ht = interval_tan(net.field_layers, feats, dfeats, h, ht,
                             t0[:, l:l + 1], dt[:, l:l + 1], n_sub, method)
        us.append((h @ wr.T + br)[:, 0])
        dus.append((ht @ wr.T)[..., 0])
    u, du = torch.stack(us, dim=1), torch.stack(dus, dim=1)
    if store:
        return u, du, torch.stack(hs), torch.stack(hts)
    return u, du


def relu_margins(net, t0, dt, feats, seed, n_sub: int, method: str):
    """The smallest ``|a| / (|W| |z| + |b|)`` over the primal relu
    pre-activations of the lift and the field along each path (in the
    dtype of ``net``): how close a path comes to a kink, where its
    tangents jump. A pre-activation whose terms are all zero is exactly
    zero in any order of summation, and counts as no kink."""
    margins = []

    def margin(a, z, w, b):
        den = z.abs() @ w.abs().T + b.abs()
        ratio = torch.where(den > 0, a.abs() / den,
                            torch.full_like(den, float("inf")))
        return ratio.min(-1).values

    z = seed[:, None]
    for w, b in net.lift[:-1]:
        a = z @ w.T + b
        margins.append(margin(a, z, w, b))
        z = torch.relu(a)

    def field(t, h):
        z = torch.cat([feats, t, h], dim=-1)
        hidden = net.field_layers[:-1]
        for i, (w, b) in enumerate(hidden):
            a = z @ w.T + b
            if i < len(hidden) - 1:  # the last one feeds tanh
                margins.append(margin(a, z, w, b))
            z = torch.relu(a)
        w, b = net.field_layers[-1]
        return torch.tanh(a) @ w.T + b

    h = net.lift_apply(seed)
    for l in range(t0.shape[1]):
        for k in range(n_sub):
            h = rk_step(method, field, t0[:, l:l + 1] + k * dt[:, l:l + 1],
                        dt[:, l:l + 1], h)
    return torch.stack(margins).min(0).values


def _field_vjp(ws, g, xp, xt, t, h, ht, obar, otbar):
    """VJP of :func:`steppers.field_fwd_tan` at ``(t, h, ht)`` for the
    cotangents ``(obar [B, H], otbar [B, d, H])`` of its two outputs.
    Adds the weight gradients, summed over paths and directions, into
    ``g`` (pairs like ``ws``) and returns ``(hbar, htbar)``.

    Linear layer ``a = W z + b``, ``at = W zt``: ``Wbar += abar z^T +
    atbar zt^T``, ``bbar += abar``, ``zbar = W^T abar``. relu: both
    cotangents masked by ``a > 0``. tanh, ``yt = (1 - y^2) at``: ``atbar =
    (1 - y^2) ytbar`` and ``abar = (1 - y^2) ybar - 2 y (1 - y^2) sum_k
    at_k ytbar_k`` (the second-order term).
    """
    z = torch.cat([xp, t, h], dim=-1)
    zt = torch.cat([xt, torch.zeros_like(ht[..., :1]), ht], dim=-1)
    w, b = ws[0]
    acts = [(z @ w.T + b, zt @ w.T)]
    for w, b in ws[1:-1]:
        a, at = acts[-1]
        at = torch.where(a[:, None, :] > 0, at, torch.zeros_like(at))
        acts.append((torch.relu(a) @ w.T + b, at @ w.T))
    a, at = acts[-1]
    y = torch.tanh(a)
    s = 1.0 - y * y
    yt = s[:, None, :] * at
    wo = ws[-1][0]
    g[-1][0].add_(obar.T @ y + torch.einsum("bdj,bdi->ji", otbar, yt))
    g[-1][1].add_(obar.sum(0))
    ybar, ytbar = obar @ wo, otbar @ wo
    atbar = s[:, None, :] * ytbar
    abar = s * ybar - 2.0 * y * s * (at * ytbar).sum(1)
    for l in range(len(ws) - 2, 0, -1):
        a_in, at_in = acts[l - 1]
        on = a_in > 0
        r = torch.relu(a_in)
        rt = torch.where(on[:, None, :], at_in, torch.zeros_like(at_in))
        w = ws[l][0]
        g[l][0].add_(abar.T @ r + torch.einsum("bdj,bdi->ji", atbar, rt))
        g[l][1].add_(abar.sum(0))
        rbar, rtbar = abar @ w, atbar @ w
        abar = torch.where(on, rbar, torch.zeros_like(rbar))
        atbar = torch.where(on[:, None, :], rtbar, torch.zeros_like(rtbar))
    w0 = ws[0][0]
    g[0][0].add_(abar.T @ z + torch.einsum("bdj,bdi->ji", atbar, zt))
    g[0][1].add_(abar.sum(0))
    w0h = w0[:, xp.shape[-1] + 1:]
    return abar @ w0h, atbar @ w0h


def _step_vjp(ws, g, xp, xt, t, dt, h, ht, hbar, htbar, method: str):
    """VJP of one joint substep from ``(h, ht)`` at ``t`` through the RK
    table of ``method``: stage inputs are recomputed, then the stages are
    walked back. Returns the cotangents of ``(h, ht)``."""
    C, A, B = RK_TABLES[method]
    dtd = dt[:, :, None]
    ys, yts = [h], [ht]
    for s in range(1, len(C)):
        k, kt = field_fwd_tan(ws, xp, xt, t + C[s - 1] * dt, ys[-1], yts[-1])
        ys.append(h + (A[s] * dt) * k)
        yts.append(ht + (A[s] * dtd) * kt)
    hb_in, htb_in = hbar, htbar
    kb, ktb = dt * B[-1] * hbar, dtd * B[-1] * htbar
    for s in range(len(C) - 1, -1, -1):
        yb, ytb = _field_vjp(ws, g, xp, xt, t + C[s] * dt, ys[s], yts[s],
                             kb, ktb)
        hb_in, htb_in = hb_in + yb, htb_in + ytb
        if s > 0:
            kb = dt * B[s - 1] * hbar + (A[s] * dt) * yb
            ktb = dtd * B[s - 1] * htbar + (A[s] * dtd) * ytb
    return hb_in, htb_in


def _lift_vjp(ws, g, z, zt, hbar, htbar):
    """Weight gradients of :func:`steppers.mlp_relu_fwd_tan` (the lift)."""
    w, b = ws[0]
    acts = [(z @ w.T + b, zt @ w.T)]
    for w, b in ws[1:]:
        a, at = acts[-1]
        at = torch.where(a[:, None, :] > 0, at, torch.zeros_like(at))
        acts.append((torch.relu(a) @ w.T + b, at @ w.T))
    abar, atbar = hbar, htbar
    for l in range(len(ws) - 1, 0, -1):
        a_in, at_in = acts[l - 1]
        on = a_in > 0
        rt = torch.where(on[:, None, :], at_in, torch.zeros_like(at_in))
        g[l][0].add_(abar.T @ torch.relu(a_in)
                     + torch.einsum("bdj,bdi->ji", atbar, rt))
        g[l][1].add_(abar.sum(0))
        rbar, rtbar = abar @ ws[l][0], atbar @ ws[l][0]
        abar = torch.where(on, rbar, torch.zeros_like(rbar))
        atbar = torch.where(on[:, None, :], rtbar, torch.zeros_like(rtbar))
    g[0][0].add_(abar.T @ z + torch.einsum("bdj,bdi->ji", atbar, zt))
    g[0][1].add_(abar.sum(0))


def u_du_bwd_plain(net: FlatNet, t0, dt, feats, dfeats, seed, dseed, hs,
                   hts, ub, dub, n_sub: int, method: str) -> torch.Tensor:
    """Plain version of kernel #5: the packed weight gradient of
    ``sum(u * ub) + sum(du * dub)`` for the unscaled outputs of
    :func:`u_du_fwd_plain`, by the hand-derived adjoint and no autograd.

    Intervals are walked from ``l = L-1`` down to 0. Each one is re-run
    from its stored start state for the end state, the readout cotangents
    are injected there (``wr_bar += ub h_end^T + dub ht_end^T``,
    ``hbar += wr^T ub``, ``htbar += wr^T dub``), and its substeps are
    walked back (:func:`_step_vjp`), each recomputed from the interval
    start. The lift VJP on the seed and its tangents comes last.
    """
    g = [torch.zeros_like(a) for a in net.flat]
    pairs = [(g[2 * i], g[2 * i + 1]) for i in range(len(g) // 2)]
    g_lift = pairs[:net.n_lift]
    g_field = pairs[net.n_lift:net.n_lift + net.n_field]
    wr = net.readout_layer[0]
    hbar = torch.zeros_like(hs[0])
    htbar = torch.zeros_like(hts[0])
    for l in range(t0.shape[1] - 1, -1, -1):
        t0l, dtl = t0[:, l:l + 1], dt[:, l:l + 1]
        h_end, ht_end = interval_tan(net.field_layers, feats, dfeats, hs[l],
                                     hts[l], t0l, dtl, n_sub, method)
        ubl, dubl = ub[:, l:l + 1], dub[:, l]
        g[-2].add_(ubl.T @ h_end + torch.einsum("bd,bdh->h", dubl,
                                                 ht_end)[None])
        g[-1].add_(ubl.sum(0))
        hbar = hbar + ubl * wr
        htbar = htbar + dubl[:, :, None] * wr
        starts = [(hs[l], hts[l])]
        for k in range(n_sub - 1):
            starts.append(interval_tan(net.field_layers, feats, dfeats,
                                       *starts[-1], t0l + k * dtl, dtl, 1,
                                       method))
        for k in range(n_sub - 1, -1, -1):
            hbar, htbar = _step_vjp(net.field_layers, g_field, feats, dfeats,
                                    t0l + k * dtl, dtl, *starts[k], hbar,
                                    htbar, method)
    _lift_vjp(net.lift, g_lift, seed[:, None], dseed[:, :, None], hbar,
              htbar)
    return torch.cat([a.reshape(-1) for a in g])


def _grad_checks(net: FlatNet, method: str, args):
    """The route of a launch of #3-#5 (:func:`_udu_route`), chosen from
    the shapes before the device is checked, and the inputs' device."""
    if method not in METHOD_IDS:
        rk_step(method, None, None, None, None)  # raises the shared error
    t0, dt, feats, dfeats, seed, dseed = args[1:7]
    N, L = t0.shape
    d = dseed.shape[1] if dseed.dim() == 2 else -1
    if (dt.shape != (N, L) or feats.shape != (N, net.F) or seed.shape != (N,)
            or dfeats.shape != (N, d, net.F) or dseed.shape != (N, d)):
        raise ValueError("shape mismatch: t0/dt [N, L], feats [N, F], "
                         "dfeats [N, d, F], seed [N], dseed [N, d]")
    route = _udu_route(net, d, method)
    return route, require_cuda_f32(list(args))


def n_params_of(dims) -> int:
    """Packed weight count of a net ``(H, Hh, F, n_lift, n_field)``
    (``xn_n_params`` in ``csrc/steppers.cuh``)."""
    H, Hh, F, n_lift, n_field = dims
    fin = F + 1 + H
    return (2 * H + (n_lift - 1) * (H * H + H) + fin * Hh + Hh
            + (n_field - 2) * (Hh * Hh + Hh) + Hh * H + H + H + 1)


def tile_smem_bytes(dims, d: int, method: str, tile: int,
                    backward: bool, variant: str = "shared",
                    cluster: int = 1) -> int:
    """Shared memory of one block of kernel #3/#4 (``backward`` false) or
    #5 for ``tile`` paths (``xg_layout`` in ``csrc/xnode_grad.cu``). Rows:
    ``R = tile (1 + d)``, each buffer ``[width][S]`` with ``S`` the rows
    rounded up to a multiple of 4 whose quarter is odd. The features stay
    in global memory.

    Forward: field layer 0's feature product, seeds, times, the state, a
    stage input, a stage, the stage sum and two field buffers.
    Backward: the gradient accumulator (not in the ``"global"``
    ``variant`` of #5, which keeps it in global memory), the walk's summed
    layer-0 cotangent (with features), the same inputs plus the readout
    cotangents, the start state and four cotangent buffers, the stage
    inputs, stage, sum, end and substep start, every field layer's
    activation for every RK stage (or the lift's, after the walk), and the
    ``cp.async`` staging of one interval. The rows' primal indices (ints)
    come last. In the ``"cluster"`` variant, a block of #5 on clusters of
    ``cluster`` blocks (:func:`cluster_smem_bytes`), which keeps a copy of
    the features."""
    if variant not in BWD_LAUNCHES.variants:
        raise ValueError(f"#5 has no variant {variant!r}")
    if variant == "cluster":
        return cluster_smem_bytes(dims, d, method, tile, cluster)
    H, Hh, F, n_lift, n_field = dims
    R = tile * (1 + d)
    S = _row_stride(R)
    ns = len(RK_TABLES[method][0])
    floats = (Hh + 1) * S + 2 * _round4(tile)
    if not backward:
        floats += 4 * H * S + 2 * Hh * S
    else:
        if variant == "shared":
            floats += _round4(n_params_of(dims))
        if F:
            floats += Hh * S
        floats += S + 5 * H * S
        walk = (ns + 3) * H * S + (ns * n_field + 2) * Hh * S
        floats += max(walk, (n_lift + 1) * H * S) + R * H + R + 2 * tile
    return 4 * floats + 4 * R


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _row_stride(R: int) -> int:
    """``R`` rounded up to a multiple of 4 whose quarter is odd
    (``xg_stride``)."""
    q = -(-R // 4)
    return 4 * (q if q % 2 else q + 1)


def cluster_acc_floats(dims, cluster: int) -> int:
    """Floats of one block's accumulator in #5's cluster variant
    (``xc_acc``): the entries it owns of every layer, each weight by its
    input column (the lift's first layer and the biases by output unit),
    at the widest slice's widths, so that every block has one layout."""
    H, Hh, F, n_lift, n_field = dims
    mH, mHh, mF = (_widest(w, cluster) for w in (H, Hh, F))
    return _round4(2 * mH + (n_lift - 1) * (H * mH + mH)
                   + Hh * (mF + 1 + mH) + mHh
                   + (n_field - 2) * (Hh * mHh + mHh)
                   + H * mHh + mH + mH + 1)


def cluster_smem_bytes(dims, d: int, method: str, tile: int,
                       cluster: int) -> int:
    """Shared memory of one block of #5's cluster variant on clusters of
    ``cluster`` blocks for ``tile`` paths a cluster (``xc_layout`` in
    ``csrc/xnode_grad_cluster.cuh``): two exchange buffers of the widest
    layer for all rows, the block's accumulator, two buffers of a
    product's weights (the block's rows or columns of a layer), its
    units' biases, time column and lift and readout weights, the
    features, seeds, readout cotangents and times of all rows, and the
    block's slice of every other buffer of the shared variant (the field
    layer 0's feature product, the start state, three cotangent buffers,
    the stage inputs, stage, sum, end and substep start, every field
    layer's activations for every RK stage but the tanh layer's output,
    which the VJP recomputes, and a scratch buffer, or the lift's
    activations after the walk), and its units of the ``cp.async``
    staging."""
    H, Hh, F, n_lift, n_field = dims
    R = tile * (1 + d)
    S = _row_stride(R)
    ns = len(RK_TABLES[method][0])
    mH, mHh = _widest(H, cluster), _widest(Hh, cluster)
    floats = 2 * max(H, Hh) * S + cluster_acc_floats(dims, cluster)
    m, Wx = max(mH, mHh), max(H, Hh)
    floats += 2 * max(m * _ld_mod32(Wx, 4), Wx * _ld_mod32(m, 4))
    floats += _round4((n_lift + 3) * mH + n_field * mHh)
    floats += (F + mHh + 2) * S + 2 * _round4(tile) + 4 * mH * S
    walk = (ns + 3) * mH * S + (ns * (n_field - 1) + 2) * mHh * S
    floats += max(walk, n_lift * mH * S)
    floats += R * _round4(mH) + R + 2 * tile
    return 4 * floats + 4 * R


def block_threads(tile: int, d: int, Hh: int, backward: bool,
                  two_blocks: bool = False) -> int:
    """Threads a block of kernel #3/#4 or #5 for ``tile`` paths: the
    largest power of two in [64, :data:`MAX_THREADS`] not above ``k
    ceil(R / 4) Hh``, the (4-row chunk, unit) items of a field layer's
    product over the tile's ``R = tile (1 + d)`` rows, with ``k`` 1 for
    the forward and 2 for the backward, whose owner sums and transposed
    products add as much work again; for #5 at most
    :data:`TWO_BLOCK_BWD_THREADS` where two of its blocks fit an SM's
    shared memory (``two_blocks``), so that its registers let them."""
    items = (2 if backward else 1) * -(-tile * (1 + d) // 4) * Hh
    threads = 64
    while 2 * threads <= min(items, MAX_THREADS):
        threads *= 2
    if backward and two_blocks:
        threads = min(threads, TWO_BLOCK_BWD_THREADS)
    return threads


def fits_twice(smem: int) -> bool:
    """Two blocks of ``smem`` shared bytes fit one SM (as
    :func:`steppers.bwd_blocks` counts them)."""
    return 2 * (smem + 1024) <= SM_SMEM_BYTES


class GradTile(NamedTuple):
    """The block shape of kernel #3/#4 or #5 (:func:`grad_tile`):
    ``paths`` a tile, ``threads`` a block, and for #5 its ``variant``
    (``"shared"``, ``"cluster"`` or ``"global"``, where its accumulator
    lives) and the blocks a thread-block cluster (``cluster``, 1 but in
    the cluster variant, where ``paths`` is a cluster's tile)."""
    paths: int
    threads: int
    variant: str = "shared"
    cluster: int = 1


def grad_tile(dims, d: int, method: str, backward: bool) -> GradTile:
    """The block of kernel #3/#4 (``backward`` false) or #5: the largest
    tile of :data:`FWD_TILES` / :data:`BWD_TILES` whose block fits an SM twice
    (:func:`fits_twice`: two blocks to interleave, and room in the L1 cache
    for the weights they read through it), else the smallest whose block
    fits at all, with its :func:`block_threads`. #5 takes,
    in this order: its shared accumulator at that tile where it
    fits; else its cluster variant at the smallest of :data:`CLUSTERS` and
    then the largest of :data:`CLUSTER_TILES` whose block fits, with the
    threads of a block's slice of the field; else its global-accumulator
    variant at the first tile where the rest of the block fits. Raises
    where nothing fits at one path a tile."""
    H, Hh = dims[0], dims[1]
    tiles = BWD_TILES if backward else FWD_TILES
    smem = {t: tile_smem_bytes(dims, d, method, t, backward) for t in tiles}
    fit = [t for t in tiles if smem[t] <= MAX_SMEM_BYTES]
    if fit:
        twice = [t for t in fit if fits_twice(smem[t])]
        tile = twice[0] if twice else fit[-1]
        return GradTile(tile, block_threads(tile, d, Hh, backward,
                                            bool(twice)))
    if backward:
        for cluster in CLUSTERS:
            if min(H, Hh) < cluster:
                continue
            for tile in CLUSTER_TILES:
                if (cluster_smem_bytes(dims, d, method, tile, cluster)
                        <= MAX_SMEM_BYTES):
                    return GradTile(tile, block_threads(
                        tile, d, -(-Hh // cluster), True), "cluster",
                        cluster)
        for tile in tiles:
            if (tile_smem_bytes(dims, d, method, tile, True, "global")
                    <= MAX_SMEM_BYTES):
                return GradTile(tile, block_threads(tile, d, Hh, True),
                                "global")
    kernel = "#5" if backward else "#3/#4"
    raise ValueError(f"the net {dims} with d={d}, {method}, does not fit "
                     f"kernel {kernel}'s shared memory ({MAX_SMEM_BYTES} "
                     "bytes) at one path a tile")


def _one_path_fits(dims, d: int, method: str) -> bool:
    """One path with ``d`` directions fits one block of #3/#4 and of #5
    without its accumulator (its global variant)."""
    return (tile_smem_bytes(dims, d, method, 1, False) <= MAX_SMEM_BYTES
            and tile_smem_bytes(dims, d, method, 1, True, "global")
            <= MAX_SMEM_BYTES)


def u_chunk(dims, d: int, method: str) -> int:
    """Tangent directions a launch of #3-#5 carries: ``d`` where one path
    with the full d fits one block of #3/#4 and of #5 (without its
    accumulator), else the largest divisor of ``d`` that does (the JAX
    package's ``fused_chunk`` rule, ``d_chunk``); #5's cluster variant
    does not move the chunk. Raises, naming the bound, where one path with
    one direction does not fit one block's shared memory."""
    for dc in range(d, 0, -1):
        if d % dc == 0 and _one_path_fits(dims, dc, method):
            return dc
    fwd, bwd = (tile_smem_bytes(dims, 1, method, 1, False),
                tile_smem_bytes(dims, 1, method, 1, True, "global"))
    raise ValueError(f"the net {dims}, {method}: one path with one tangent "
                     f"direction does not fit kernels #3-#5's shared memory "
                     f"({MAX_SMEM_BYTES} bytes a block; #3/#4 {fwd}, #5 "
                     f"{bwd} bytes)")


class PathTile(NamedTuple):
    """The block of the path-tile #1/#2 (:func:`path_tile`): ``rows``
    paths a tile, and the inputs of a streamed weight slice (``slice``;
    0: the field's weights resident in shared memory)."""
    rows: int
    slice: int


def path_tile_staged_floats(dims) -> int:
    """Floats of the path-tile kernel's staged weight copy
    (``xp_staged_floats``): each field layer's ``W^T [in][pad4(out)]``,
    field layer 0 with its time and ``h`` columns only."""
    H, Hh, _, _, n_field = dims
    return ((1 + H) * _round4(Hh) + (n_field - 2) * Hh * _round4(Hh)
            + Hh * _round4(H))


def path_tile_smem_bytes(dims, method: str, rows: int, slice_: int) -> int:
    """Shared memory of one block of the path-tile #1/#2 (``xp_layout`` in
    ``csrc/xnode_path_tile.cu``): the weights (two slots of ``slice_``
    inputs at the wider layer's padded width, or the whole staged copy
    with ``slice_`` 0), the time-and-state and stage-input buffers ``[1 +
    H][S]`` (the output layer's partial sums between its slices in the
    latter's state rows), the stage sum ``[H][S]`` for heun and rk4, two
    activation buffers and field layer 0's feature columns ``[Hh][S]``,
    and the interval's times, ``S`` the rows rounded up to a multiple of 4
    whose quarter is odd."""
    H, Hh, _, _, n_field = dims
    S = _row_stride(rows)
    if slice_:
        floats = 2 * slice_ * max(_round4(H), _round4(Hh))
    else:
        floats = path_tile_staged_floats(dims)
    floats += 2 * (1 + H) * S + 3 * Hh * S + 2 * _round4(rows)
    if method in ("heun", "rk4"):
        floats += H * S
    return 4 * floats


def path_tile(dims, method: str) -> PathTile:
    """The block of the path-tile #1/#2 for a net: the first of
    :data:`PATH_ORDER` whose block fits one block's shared memory; raises
    where none fits."""
    for rows, slice_ in PATH_ORDER:
        if path_tile_smem_bytes(dims, method, rows, slice_) <= MAX_SMEM_BYTES:
            return PathTile(rows, slice_)
    raise ValueError(f"the net {dims}, {method}, does not fit the "
                     f"path-tile #1/#2's shared memory ({MAX_SMEM_BYTES} "
                     f"bytes a block) at 16 paths a tile and "
                     f"{min(PATH_SLICES)}-input weight slices")


class KernelRoute(NamedTuple):
    """What the wrappers launch for one net on the card
    (:func:`kernel_route`)."""
    path: str                      # #1/#2: "registers" or "tile"
    path_tile: Optional[PathTile]  # the tile kernel's block, else None
    d_chunk: int                   # tangent directions a launch of #3-#5
    fwd: Optional[GradTile]        # #3/#4 at d_chunk (None with d = 0)
    bwd: Optional[GradTile]        # #5 at d_chunk, with its variant


@functools.lru_cache(maxsize=None)
def kernel_route(dims, d: int, method: str) -> KernelRoute:
    """The variants and blocks of #1-#5 for a net ``(H, Hh, F, n_lift,
    n_field)`` with ``d`` spatial tangents (0 for #1/#2 alone): the one
    place where the wrappers choose them, from the shapes, before any
    launch. Raises where one path and one direction do not fit
    (:func:`u_chunk`)."""
    registers = register_fits(dims)
    path = ("registers" if registers else "tile",
            None if registers else path_tile(dims, method))
    if d == 0:
        return KernelRoute(*path, 0, None, None)
    dc = u_chunk(dims, d, method)
    return KernelRoute(*path, dc, grad_tile(dims, dc, method, False),
                       grad_tile(dims, dc, method, True))


def _udu_route(net: FlatNet, d: int, method: str) -> KernelRoute:
    """:func:`kernel_route` for a launch of #3-#5 with ``d`` directions,
    which must fit it whole."""
    if d < 1:
        raise ValueError(f"kernels #3-#5 take d >= 1 directions, got {d}")
    route = kernel_route(net.dims(), d, method)
    if route.d_chunk != d:
        raise ValueError(f"kernels #3-#5 take at most {route.d_chunk} of "
                         f"d={d} directions a launch at the net {net.dims()}"
                         f", {method}: pass d_chunk to u_du_fused")
    return route


def u_du_fwd_cuda(net: FlatNet, packed, t0, dt, feats, dfeats, seed, dseed,
                  n_sub: int, method: str, store: bool = False):
    """Launch kernel #3, or #4 with ``store``, on PyTorch's current
    stream. Same outputs as :func:`u_du_fwd_plain`."""
    args = (packed, t0, dt, feats, dfeats, seed, dseed)
    route, dev = _grad_checks(net, method, args)
    N, L = t0.shape
    d = dseed.shape[1]
    H, Hh, F, n_lift, n_field = net.dims()
    tile = route.fwd
    f32 = dict(dtype=torch.float32, device=dev)
    u = torch.empty((N, L), **f32)
    du = torch.empty((N, L, d), **f32)
    ptrs = [a.data_ptr() for a in args]
    ptrs.insert(1, packed.numel())
    geom = (N, L, d, H, Hh, F, n_lift, n_field, n_sub, METHOD_IDS[method],
            tile.paths, tile.threads)
    if not store:
        FWD_KERNEL(dev, *ptrs, u.data_ptr(), du.data_ptr(), *geom)
        return u, du
    hs = torch.empty((L, N, H), **f32)
    hts = torch.empty((L, N, d, H), **f32)
    FWD_STORE_KERNEL(dev, *ptrs, u.data_ptr(), du.data_ptr(), hs.data_ptr(),
                     hts.data_ptr(), *geom)
    return u, du, hs, hts


def u_du_bwd_cuda(net: FlatNet, packed, t0, dt, feats, dfeats, seed, dseed,
                  hs, hts, ub, dub, n_sub: int,
                  method: str) -> torch.Tensor:
    """Launch kernel #5, in the variant :func:`kernel_route` picks, and its
    fixed-order reduce on PyTorch's current stream; same result as
    :func:`u_du_bwd_plain`."""
    args = (packed, t0, dt, feats, dfeats, seed, dseed)
    route, dev = _grad_checks(net, method, args)
    require_cuda_f32([hs, hts, ub, dub])
    N, L = t0.shape
    d = dseed.shape[1]
    H, Hh, F, n_lift, n_field = net.dims()
    if (hs.shape != (L, N, H) or hts.shape != (L, N, d, H)
            or ub.shape != (N, L) or dub.shape != (N, L, d)):
        raise ValueError("shape mismatch: hs [L, N, H], hts [L, N, d, H], "
                         "ub [N, L], dub [N, L, d]")
    n_params = packed.numel()
    tile = route.bwd
    grid = bwd_grid(net.dims(), N, d, method, tile, dev)
    partial = torch.empty((grid, n_params), dtype=torch.float32, device=dev)
    grad = torch.empty((n_params,), dtype=torch.float32, device=dev)
    ptrs = [a.data_ptr() for a in args]
    ptrs.insert(1, n_params)
    kernel = BWD_LAUNCHES.variants[tile.variant]
    extra = (tile.cluster,) if tile.variant == "cluster" else ()
    kernel(dev, *ptrs, hs.data_ptr(), hts.data_ptr(), ub.data_ptr(),
           dub.data_ptr(), partial.data_ptr(), grad.data_ptr(), N, L, d, H,
           Hh, F, n_lift, n_field, n_sub, METHOD_IDS[method], tile.paths,
           tile.threads, grid, *extra)
    return grad


def bwd_grid(dims, N: int, d: int, method: str, tile: GradTile,
             dev: torch.device) -> int:
    """The persistent grid of #5 at ``tile``, one partial row each: in
    blocks (:func:`steppers.bwd_blocks`), or for the cluster variant in
    clusters, as many as the card runs at once
    (``cudaOccupancyMaxActiveClusters``) and at most one a tile."""
    n_tiles = -(-N // tile.paths)
    if tile.variant == "cluster":
        return max(1, min(n_tiles, cluster_occupancy(
            dev.index, dims, d, method, tile)))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return bwd_blocks(N, tile.paths, tile_smem_bytes(
        dims, d, method, tile.paths, True, tile.variant), tile.threads,
        sms)


@functools.lru_cache(maxsize=None)
def cluster_occupancy(device: int, dims, d: int, method: str,
                      tile: GradTile) -> int:
    """Clusters of #5's cluster variant at ``tile`` that the card runs at
    once (``xnode_udu_cluster_occupancy``); raises where it runs none."""
    lib, _ = BWD_CLUSTER_KERNEL.load()
    fn = lib.xnode_udu_cluster_occupancy
    fn.argtypes = [ctypes.c_int] * 11
    fn.restype = ctypes.c_int
    n = fn(device, d, *dims, METHOD_IDS[method], tile.paths, tile.threads,
           tile.cluster)
    if n <= 0:
        error = f" (CUDA error {-n})" if n < 0 else ""
        raise RuntimeError(f"#5's cluster variant at {tile} for the net "
                           f"{dims}, d={d}: the card runs no such "
                           f"cluster{error}")
    return n


class UDuFused(torch.autograd.Function):
    """``(u_raw [N, L], du_raw [N, L, d])`` with the hand-written backward.

    Forward: kernel #4 when a gradient is needed (it stores the start
    states the backward walks from), kernel #3 when not, as the JAX
    package's ``_fused_core_fwd`` / ``_fused_core`` do. Backward: kernel
    #5, the gradient of the packed weights only (the sample points,
    seeds and features are data). CPU tensors take the plain versions.
    """

    @staticmethod
    def forward(ctx, packed, net, t0, dt, feats, dfeats, seed, dseed,
                n_sub, method, store):
        data = (t0, dt, feats, dfeats, seed, dseed)
        if packed.is_cuda:
            out = u_du_fwd_cuda(net, packed, *data, n_sub, method, store)
        elif packed.device.type == "cpu":
            out = u_du_fwd_plain(net, *data, n_sub, method, store)
        else:
            raise ValueError(f"no u_du kernel for device {packed.device}")
        if store:
            ctx.save_for_backward(packed, *data, *out[2:])
            ctx.meta = (net, n_sub, method)
        return out[0], out[1]

    @staticmethod
    def backward(ctx, ub, dub):
        if not hasattr(ctx, "meta"):
            raise RuntimeError("u_du_fused ran without stored states; call "
                               "it with gradients enabled to differentiate")
        packed, *data, hs, hts = ctx.saved_tensors
        net, n_sub, method = ctx.meta
        ub, dub = ub.contiguous(), dub.contiguous()
        if packed.is_cuda:
            grad = u_du_bwd_cuda(net, packed, *data, hs, hts, ub, dub, n_sub,
                                 method)
        else:
            grad = u_du_bwd_plain(net, *data, hs, hts, ub, dub, n_sub, method)
        return (grad,) + (None,) * 10


def u_du_fused(params, feats, dfeats, seed, dseed, times, mask, t_start, *,
               n_sub: int, method: str, scale: float,
               d_chunk: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ``(u [N, L], grad_x u [N, L, d])`` with a weight gradient.

    ``feats [N, F]``: per-path field spatial input; ``dfeats [N, d, F]``:
    its Jacobian in the d raw coordinates. ``seed [N]``, ``dseed [N, d]``:
    the seed and its spatial gradient, already divided by ``scale``. The
    outputs are multiplied by ``scale``. Same contract as the JAX
    package's ``u_du_fused`` (``:713-801``).

    ``d_chunk``: carry this many tangent directions a launch (it must
    divide d; :func:`kernel_route` picks it): ``d / d_chunk`` launches of
    #3/#4 (and of #5 in the backward) on ``dfeats[:, lo:lo + d_chunk]``
    and ``dseed[:, lo:lo + d_chunk]``. ``u`` is the first chunk's, so its
    cotangent flows once, and the later chunks' ``u`` get a zero
    cotangent: the weight gradients summed over the chunks are exact.
    """
    d = dfeats.shape[1]
    dc = d if not d_chunk else int(d_chunk)
    if dc != d and (dc < 1 or dc > d or d % dc):
        raise ValueError(f"d_chunk={dc} must divide d={d}")
    net = flat_net(params)
    packed = live_packed(params)
    store = torch.is_grad_enabled() and packed.requires_grad
    if not store:
        packed = packed.detach()
    t0, dt = _prep_intervals(times.float(), mask, t_start.float(), n_sub)
    t0, dt, feats, dfeats, seed, dseed = [
        a.detach().float().contiguous()
        for a in (t0, dt, feats, dfeats, seed, dseed)]
    u, dus = None, []
    for lo in range(0, d, dc):
        chunk = [a[:, lo:lo + dc].contiguous() if dc != d else a
                 for a in (dfeats, dseed)]
        u_c, du_c = UDuFused.apply(packed, net, t0, dt, feats, chunk[0],
                                   seed, chunk[1], n_sub, method, store)
        u = u_c if u is None else u
        dus.append(du_c)
    du = dus[0] if len(dus) == 1 else torch.cat(dus, dim=-1)
    return u * scale, du * scale


def path_tangent_inputs(batch, problem, cfg):
    """``(feats [N, F], dfeats [N, d, F], seed [N], dseed [N, d])`` of a
    path batch, in the batch's dtype (the kernels take f32 batches): the
    seed through :func:`models.xnode.path_seed_fn` and the Fourier
    features, with their spatial tangents by forward mode
    (``torch.func.jvp``) in the d coordinate directions, all d in one
    ``torch.func.vmap``: one jvp a direction costs d times the host's
    launches (at d = 20 most of an outer step on the GPU)."""
    from xnode_wan_tpu_torch.models.xnode import path_seed_fn, spatial_features

    with torch.no_grad():
        xs = batch.space[:, 0, :]
        seed_of = path_seed_fn(batch, problem, cfg)

        def feats_of(x):
            return spatial_features(x, cfg.fourier_features)

        def tangents(e):
            tan = e.expand_as(xs)
            return (torch.func.jvp(seed_of, (xs,), (tan,))[1],
                    torch.func.jvp(feats_of, (xs,), (tan,))[1])

        dseed, dfeats = torch.func.vmap(tangents)(
            torch.eye(xs.shape[-1], dtype=xs.dtype, device=xs.device))
        return (feats_of(xs), dfeats.transpose(0, 1).contiguous(),
                seed_of(xs), dseed.t().contiguous())


def fused_from_batch(params, batch, problem, cfg):
    """:func:`u_du_fused` on a path batch (:func:`path_tangent_inputs`); a
    drop-in for ``ops/weak_form.py::u_with_spatial_grad``. On the card in
    the tangent chunks of :func:`kernel_route` (the full d where its
    tiles fit); on CPU tensors, whose plain versions have no shared-memory
    bound, at the full d."""
    d = batch.space.shape[-1]
    dc = (kernel_route(flat_net(params).dims(), d, cfg.solver).d_chunk
          if batch.space.is_cuda else d)
    return u_du_fused(params, *path_tangent_inputs(batch, problem, cfg),
                      batch.times, batch.mask, batch.t_start,
                      n_sub=cfg.n_sub, method=cfg.solver,
                      scale=float(cfg.u_scale_eff), d_chunk=dc)
