"""Serving: u at M arbitrary space-time points, one fresh ODE path each.

Replaces ``xnode_wan_tpu/ops/pallas/xnode_eval.py::_kernel`` (through
``fused_evaluate``), which ``models/xnode.py::evaluate_points`` and
``NODEWANSolver.predict`` reach.

Kernel: ``csrc/xnode_fwd.cu::xnode_fwd_kernel<true>`` through
``xnode_eval_launch``, the body it shares with the metric forward (#2),
built once per width pair (H, Hh) so that each thread's state, RK stages
and activations live in registers. One thread per point, 128 a block.
Each block stages the weights in shared memory once, by columns padded
to four floats (``steppers.staged_floats``), so that one broadcast load
feeds four independent accumulators; before that, the block's feature
rows pass through the same shared memory once, read coalesced, and each
thread applies the feature columns of field layer 0 to its point (any
feature width); each thread then lifts its seed, runs ``k_steps`` RK steps
of ``dt = (t - t_start) / k_steps`` and writes one value. The TPU kernel's
feature-major 128-lane layout and its VMEM block picker are not carried
over: here the point axis is the thread axis.

Past the register kernel's caps (a width above 64, or staged weights
above one block's shared memory; the choice is
``xnode_train.kernel_route``'s) serving takes the path-tile kernel
(``xnode_serve_tile_launch`` in ``csrc/xnode_path_tile.cu``, the body of
#2's variant) with the serving mapping of ``kServe``: each point is a path
of one interval from ``t_start`` with ``k_steps`` steps of ``dt = (t -
t_start) / k_steps``. :data:`LAUNCHES` counts both variants.

Bound on an H100 SXM (67 TFLOP/s FP32 without tensor cores, 3.35 TB/s):
at M = 65,536 points, 20 midpoint steps and the d=5 width, the field
takes 1,110 multiply-adds per evaluation after the hoisted feature
columns, 40 evaluations a point, about 5.9 GFLOP in all (88 µs), against
36 bytes a point moved (2.4 MB, 0.7 µs). The kernel is FP32-compute-bound
in principle and issue-bound in practice: about 1.25 instructions per
FMA (a 16-byte shared load per four weights), plain FMAs on the CUDA
cores (10-26 wide layers do not fill a tensor-core tile, and TF32 would
break f32 parity). Two points a thread, reusing each weight load, is the
next step.
"""

from __future__ import annotations

import ctypes

import torch

from xnode_wan_tpu_torch.ops.kernels._build import CudaKernel, KernelVariants
from xnode_wan_tpu_torch.ops.kernels.steppers import (METHOD_IDS, FlatNet,
                                                      require_cuda_f32,
                                                      rk_step)
from xnode_wan_tpu_torch.ops.kernels.xnode_train import (
    PathTile, flat_net, kernel_route, path_tile_staged_floats)

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "xnode_fwd", "xnode_eval_launch",
    [_P, _I,                  # packed weights, count
     _P, _P, _P, _P, _P,      # feats, t, t_start, seed, out
     _I, _I, _I, _I, _I, _I, _I, _I])  # M H Hh F n_lift n_field k_steps method
# #1 past the caps (csrc/xnode_path_tile.cu): weights, count, the staged
# copy (scratch), feats, t, t_start, seed, out; M H Hh F n_lift n_field
# k_steps method; paths a tile, inputs a weight slice
TILE_KERNEL = CudaKernel("xnode_path_tile", "xnode_serve_tile_launch",
                         [_P, _I, _P, _P, _P, _P, _P, _P] + [_I] * 10)
LAUNCHES = KernelVariants({"registers": KERNEL, "tile": TILE_KERNEL})


def evaluate_plain(net: FlatNet, feats, t, t_start, seed, k_steps: int,
                   method: str) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``u [M]`` before scaling."""
    h = net.lift_apply(seed)
    ts = t_start[:, None]
    dt = (t[:, None] - ts) / k_steps

    def field(tt, hh):
        return net.field_apply(feats, tt, hh)

    for k in range(k_steps):
        h = rk_step(method, field, ts + k * dt, dt, h)
    return net.readout(h)


def evaluate_cuda(net: FlatNet, feats, t, t_start, seed, k_steps: int,
                  method: str, packed=None) -> torch.Tensor:
    """Launch serving on PyTorch's current stream, in the variant
    ``xnode_train.kernel_route`` picks: ``csrc/xnode_fwd.cu`` from the
    library built for the net's widths, else the path-tile kernel
    (:func:`_serve_tile`)."""
    if method not in METHOD_IDS:
        rk_step(method, None, None, None, None)  # raises the shared error
    if k_steps < 1:
        raise ValueError(f"k_steps must be >= 1, got {k_steps}")
    route = kernel_route(net.dims(), 0, method)
    if packed is None:
        packed = net.packed()
    if route.path == "tile":
        return _serve_tile(net, packed, feats, t, t_start, seed, k_steps,
                           method, route.path_tile)
    dev = require_cuda_f32([packed, feats, t, t_start, seed])
    M = t.shape[0]
    H, Hh, F, n_lift, n_field = net.dims()
    _serve_shapes(net, feats, t, t_start, seed)
    out = torch.empty((M,), dtype=torch.float32, device=dev)
    KERNEL(dev, packed.data_ptr(), packed.numel(), feats.data_ptr(),
           t.data_ptr(), t_start.data_ptr(), seed.data_ptr(), out.data_ptr(),
           M, H, Hh, F, n_lift, n_field, k_steps, METHOD_IDS[method],
           widths=(H, Hh))
    return out


def _serve_shapes(net: FlatNet, feats, t, t_start, seed) -> None:
    M = t.shape[0]
    if feats.shape != (M, net.F) or t_start.shape != (M,) or seed.shape != (M,):
        raise ValueError("shape mismatch: feats [M, F], t/t_start/seed [M]")


def _serve_tile(net: FlatNet, packed, feats, t, t_start, seed, k_steps: int,
                method: str, tile: PathTile) -> torch.Tensor:
    """Serving on the path-tile kernel at ``tile`` (any tile that fits,
    ``xnode_train.path_tile_smem_bytes``), counted on :data:`TILE_KERNEL`:
    each point is a path of one interval from ``t_start``, ``k_steps``
    steps of ``dt = (t - t_start) / k_steps``."""
    dev = require_cuda_f32([packed, feats, t, t_start, seed])
    _serve_shapes(net, feats, t, t_start, seed)
    M = t.shape[0]
    out = torch.empty((M,), dtype=torch.float32, device=dev)
    staged = torch.empty((path_tile_staged_floats(net.dims()),),
                         dtype=torch.float32, device=dev)
    TILE_KERNEL(dev, packed.data_ptr(), packed.numel(), staged.data_ptr(),
                feats.data_ptr(), t.data_ptr(), t_start.data_ptr(),
                seed.data_ptr(), out.data_ptr(), M, *net.dims(), k_steps,
                METHOD_IDS[method], tile.rows, tile.slice)
    return out


def fused_evaluate(params, pts: torch.Tensor, seed: torch.Tensor,
                   k_steps: int, t0: float = 0.0,
                   t_start: torch.Tensor | None = None,
                   feats: torch.Tensor | None = None,
                   method: str = "midpoint") -> torch.Tensor:
    """Evaluate u at points ``pts [M, C]`` with seeds ``seed [M]`` -> ``[M]``.

    ``seed`` is the problem's h/g data at each point's path origin,
    ``t_start [M]`` that origin's time (default ``t0``), ``feats [M, F]``
    the field's spatial input when it is not the raw coordinates (the
    Fourier bank). Computes in f32. CUDA tensors go to the kernel, CPU
    tensors to the plain version.
    """
    with torch.no_grad():
        m = pts.shape[0]
        f32 = dict(dtype=torch.float32)
        if feats is None:
            feats = pts[:, 1:]
        if t_start is None:
            t_start = torch.full((m,), t0, device=pts.device, **f32)
        args = [a.to(**f32).contiguous()
                for a in (feats, pts[:, 0], t_start, seed)]
        net = flat_net(params)
        if pts.is_cuda:
            return evaluate_cuda(net, *args, k_steps, method)
        if pts.device.type == "cpu":
            return evaluate_plain(net, *args, k_steps, method)
        raise ValueError(f"no serving kernel for device {pts.device}")
