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

Kernel #2: ``csrc/xnode_fwd.cu::xnode_fwd_kernel<false>`` through
``xnode_path_fwd_launch``, the body it shares with serving (#1), built
once per width pair (H, Hh) so that each thread's state, RK stages and
activations live in registers. One thread per path, one warp a block. A
block stages the weights in shared memory (2,372 floats at the d=5
width, by columns padded to four floats); the thread lifts its seed, applies
the feature columns of field layer 0 once, then walks the L intervals
with n_sub RK substeps each and writes ``u`` after every interval.
Masked samples come with ``dt = 0`` from :func:`_prep_intervals`, so
their interval is the identity and the kernel needs no branch on the
mask.

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
from typing import List, Tuple

import torch

from xnode_wan_tpu_torch.ops.kernels._build import CudaKernel
from xnode_wan_tpu_torch.ops.kernels.steppers import (MAX_SMEM_BYTES,
                                                      METHOD_IDS, RK_TABLES,
                                                      FlatNet, bwd_blocks,
                                                      field_fwd_tan,
                                                      interval_tan,
                                                      mlp_relu_fwd_tan,
                                                      require_cuda_f32,
                                                      rk_step)

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
MAX_THREADS = 256             # XG_MAX_THREADS
# Paths per tile, largest first; the threads of a block follow from the
# tile (block_threads). From the tile sweep (tile_sweep.py) on an H100:
# the rule picks the fastest shape swept for cube_pde (#3/#4 4 paths and
# 64 threads, #5 8 and 128) and highdim_d20 (#3/#4 4 and 256, #5 1 and
# 256), and shapes within 8% of the fastest for ex4_1_d10
FWD_TILES = (4, 2, 1)
BWD_TILES = (8, 4, 1)


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
    """Launch ``csrc/xnode_fwd.cu`` (path forward) on PyTorch's
    current stream, from the library built for the net's widths."""
    if method not in METHOD_IDS:
        rk_step(method, None, None, None, None)  # raises the shared error
    net.check_caps()
    if packed is None:
        packed = net.packed()
    dev = require_cuda_f32([packed, t0, dt, feats, seed])
    N, L = t0.shape
    H, Hh, F, n_lift, n_field = net.dims()
    if dt.shape != (N, L) or feats.shape != (N, F) or seed.shape != (N,):
        raise ValueError("shape mismatch: t0/dt [N, L], feats [N, F], seed [N]")
    u = torch.empty((N, L), dtype=torch.float32, device=dev)
    KERNEL(dev, packed.data_ptr(), packed.numel(), t0.data_ptr(),
           dt.data_ptr(), feats.data_ptr(), seed.data_ptr(), u.data_ptr(),
           N, L, H, Hh, F, n_lift, n_field, n_sub, METHOD_IDS[method],
           widths=(H, Hh))
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
    [L, N, H]`` and ``hts [L, N, d, H]``."""
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


def _grad_checks(net: FlatNet, method: str, args) -> torch.device:
    if method not in METHOD_IDS:
        rk_step(method, None, None, None, None)  # raises the shared error
    dev = require_cuda_f32(list(args))
    t0, dt, feats, dfeats, seed, dseed = args[1:7]
    N, L = t0.shape
    d = dseed.shape[1] if dseed.dim() == 2 else -1
    if (dt.shape != (N, L) or feats.shape != (N, net.F) or seed.shape != (N,)
            or dfeats.shape != (N, d, net.F) or dseed.shape != (N, d)):
        raise ValueError("shape mismatch: t0/dt [N, L], feats [N, F], "
                         "dfeats [N, d, F], seed [N], dseed [N, d]")
    return dev


def n_params_of(dims) -> int:
    """Packed weight count of a net ``(H, Hh, F, n_lift, n_field)``
    (``xn_n_params`` in ``csrc/steppers.cuh``)."""
    H, Hh, F, n_lift, n_field = dims
    fin = F + 1 + H
    return (2 * H + (n_lift - 1) * (H * H + H) + fin * Hh + Hh
            + (n_field - 2) * (Hh * Hh + Hh) + Hh * H + H + H + 1)


def tile_smem_bytes(dims, d: int, method: str, tile: int,
                    backward: bool) -> int:
    """Shared memory of one block of kernel #3/#4 (``backward`` false) or
    #5 for ``tile`` paths (``xg_layout`` in ``csrc/xnode_grad.cu``). Rows:
    ``R = tile (1 + d)``, each buffer ``[width][S]`` with ``S`` the rows
    rounded up to a multiple of 4 whose quarter is odd.

    Forward: features, their field-layer-0 product, seeds, times, the
    state, a stage input, a stage, the stage sum and two field buffers.
    Backward: the gradient accumulator, the same inputs plus the readout
    cotangents, the start state and four cotangent buffers, the stage
    inputs, stage, sum, end and substep start, every field layer's
    activation for every RK stage (or the lift's, after the walk), and the
    ``cp.async`` staging of one interval. The rows' primal indices (ints)
    come last."""
    H, Hh, F, n_lift, n_field = dims
    R = tile * (1 + d)
    q = -(-R // 4)
    S = 4 * (q if q % 2 else q + 1)

    def round4(n):
        return -(-n // 4) * 4

    ns = len(RK_TABLES[method][0])
    floats = (F + Hh + 1) * S + 2 * round4(tile)
    if not backward:
        floats += 4 * H * S + 2 * Hh * S
    else:
        floats += round4(n_params_of(dims)) + S + 5 * H * S
        walk = (ns + 3) * H * S + (ns * n_field + 2) * Hh * S
        floats += max(walk, (n_lift + 1) * H * S) + R * H + R + 2 * tile
    return 4 * floats + 4 * R


def block_threads(tile: int, d: int, Hh: int, backward: bool) -> int:
    """Threads a block of kernel #3/#4 or #5 for ``tile`` paths: the
    largest power of two in [64, :data:`MAX_THREADS`] not above ``k
    ceil(R / 4) Hh``, the (4-row chunk, unit) items of a field layer's
    product over the tile's ``R = tile (1 + d)`` rows, with ``k`` 1 for
    the forward and 2 for the backward, whose owner sums and transposed
    products add as much work again."""
    items = (2 if backward else 1) * -(-tile * (1 + d) // 4) * Hh
    threads = 64
    while 2 * threads <= min(items, MAX_THREADS):
        threads *= 2
    return threads


def grad_tile(dims, d: int, method: str, backward: bool) -> Tuple[int, int]:
    """``(paths per tile, threads a block)`` of kernel #3/#4 or #5: the
    first tile of :data:`FWD_TILES` / :data:`BWD_TILES` (largest first)
    whose block fits one block's shared memory, with its
    :func:`block_threads`. Raises where none fits."""
    for tile in (BWD_TILES if backward else FWD_TILES):
        if tile_smem_bytes(dims, d, method, tile, backward) <= MAX_SMEM_BYTES:
            return tile, block_threads(tile, d, dims[1], backward)
    kernel = "#5" if backward else "#3/#4"
    raise ValueError(f"the net {dims} with d={d}, {method}, does not fit "
                     f"kernel {kernel}'s shared memory ({MAX_SMEM_BYTES} "
                     "bytes) at one path a tile")


def u_du_fwd_cuda(net: FlatNet, packed, t0, dt, feats, dfeats, seed, dseed,
                  n_sub: int, method: str, store: bool = False):
    """Launch kernel #3, or #4 with ``store``, on PyTorch's current
    stream. Same outputs as :func:`u_du_fwd_plain`."""
    args = (packed, t0, dt, feats, dfeats, seed, dseed)
    dev = _grad_checks(net, method, args)
    N, L = t0.shape
    d = dseed.shape[1]
    H, Hh, F, n_lift, n_field = net.dims()
    tile, threads = grad_tile(net.dims(), d, method, False)
    f32 = dict(dtype=torch.float32, device=dev)
    u = torch.empty((N, L), **f32)
    du = torch.empty((N, L, d), **f32)
    ptrs = [a.data_ptr() for a in args]
    ptrs.insert(1, packed.numel())
    geom = (N, L, d, H, Hh, F, n_lift, n_field, n_sub, METHOD_IDS[method],
            tile, threads)
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
    """Launch kernel #5 and its fixed-order reduce on PyTorch's current
    stream; same result as :func:`u_du_bwd_plain`."""
    args = (packed, t0, dt, feats, dfeats, seed, dseed)
    dev = _grad_checks(net, method, args)
    require_cuda_f32([hs, hts, ub, dub])
    N, L = t0.shape
    d = dseed.shape[1]
    H, Hh, F, n_lift, n_field = net.dims()
    if (hs.shape != (L, N, H) or hts.shape != (L, N, d, H)
            or ub.shape != (N, L) or dub.shape != (N, L, d)):
        raise ValueError("shape mismatch: hs [L, N, H], hts [L, N, d, H], "
                         "ub [N, L], dub [N, L, d]")
    n_params = packed.numel()
    tile, threads = grad_tile(net.dims(), d, method, True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = bwd_blocks(N, tile, tile_smem_bytes(net.dims(), d, method, tile,
                                                 True), threads, sms)
    partial = torch.empty((blocks, n_params), dtype=torch.float32,
                          device=dev)
    grad = torch.empty((n_params,), dtype=torch.float32, device=dev)
    ptrs = [a.data_ptr() for a in args]
    ptrs.insert(1, n_params)
    BWD_KERNEL(dev, *ptrs, hs.data_ptr(), hts.data_ptr(), ub.data_ptr(),
               dub.data_ptr(), partial.data_ptr(), grad.data_ptr(), N, L, d,
               H, Hh, F, n_lift, n_field, n_sub, METHOD_IDS[method], tile,
               threads, blocks)
    return grad


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
               n_sub: int, method: str, scale: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ``(u [N, L], grad_x u [N, L, d])`` with a weight gradient.

    ``feats [N, F]``: per-path field spatial input; ``dfeats [N, d, F]``:
    its Jacobian in the d raw coordinates. ``seed [N]``, ``dseed [N, d]``:
    the seed and its spatial gradient, already divided by ``scale``. The
    outputs are multiplied by ``scale``. Same contract as the JAX
    package's ``u_du_fused`` (``:713-801``).
    """
    net = flat_net(params)
    packed = live_packed(params)
    store = torch.is_grad_enabled() and packed.requires_grad
    if not store:
        packed = packed.detach()
    t0, dt = _prep_intervals(times.float(), mask, t_start.float(), n_sub)
    data = [a.detach().float().contiguous()
            for a in (t0, dt, feats, dfeats, seed, dseed)]
    u, du = UDuFused.apply(packed, net, *data, n_sub, method, store)
    return u * scale, du * scale


def path_tangent_inputs(batch, problem, cfg):
    """``(feats [N, F], dfeats [N, d, F], seed [N], dseed [N, d])`` of a
    path batch, in the batch's dtype (the kernels take f32 batches): the
    seed through :func:`models.xnode.path_seed_fn` and the Fourier
    features, with their spatial tangents by forward mode
    (``torch.func.jvp``) in each of the d coordinate directions."""
    from xnode_wan_tpu_torch.models.xnode import path_seed_fn, spatial_features

    with torch.no_grad():
        xs = batch.space[:, 0, :]
        seed_of = path_seed_fn(batch, problem, cfg)

        def feats_of(x):
            return spatial_features(x, cfg.fourier_features)

        dseed, dfeats = [], []
        for e in torch.eye(xs.shape[-1], dtype=xs.dtype, device=xs.device):
            tan = e.expand_as(xs)
            dseed.append(torch.func.jvp(seed_of, (xs,), (tan,))[1])
            dfeats.append(torch.func.jvp(feats_of, (xs,), (tan,))[1])
        return (feats_of(xs), torch.stack(dfeats, dim=1), seed_of(xs),
                torch.stack(dseed, dim=1))


def fused_from_batch(params, batch, problem, cfg):
    """:func:`u_du_fused` on a path batch (:func:`path_tangent_inputs`); a
    drop-in for ``ops/weak_form.py::u_with_spatial_grad``."""
    return u_du_fused(params, *path_tangent_inputs(batch, problem, cfg),
                      batch.times, batch.mask, batch.t_start,
                      n_sub=cfg.n_sub, method=cfg.solver,
                      scale=float(cfg.u_scale_eff))
