"""Serving: u at M arbitrary space-time points, one fresh ODE path each.

Replaces ``xnode_wan_tpu/ops/pallas/xnode_eval.py::_kernel`` (through
``fused_evaluate``), which ``models/xnode.py::evaluate_points`` and
``NODEWANSolver.predict`` reach.

Kernel: ``csrc/xnode_eval.cu::xnode_eval_kernel``, one thread per point.
Each block stages the packed weights in shared memory once; each thread
lifts its seed, applies the feature columns of field layer 0 once, runs
``k_steps`` RK steps of ``dt = (t - t_start) / k_steps`` and writes one
value. The TPU kernel's feature-major 128-lane layout and its VMEM block
picker are not carried over: here the point axis is the thread axis.

Bound on an H100 SXM (67 TFLOP/s FP32 without tensor cores, 3.35 TB/s):
at M = 65,536 points, 20 midpoint steps and the d=5 width, the field
takes 1,110 multiply-adds per evaluation after the hoisted feature
columns, 40 evaluations a point, about 5.9 GFLOP in all (88 µs), against
36 bytes a point moved (2.4 MB, 0.7 µs). The kernel is FP32-compute-bound
in principle; its design keeps every byte on chip and does plain FMAs on
the CUDA cores (10-26 wide layers do not fill a tensor-core tile, and
TF32 would break f32 parity). Its per-thread arrays are indexed by
runtime widths, so they live in local memory: that traffic, not the
FMAs, is what a later change should remove.
"""

from __future__ import annotations

import ctypes

import torch

from xnode_wan_tpu_torch.ops.kernels._build import CudaKernel
from xnode_wan_tpu_torch.ops.kernels.steppers import (METHOD_IDS, FlatNet,
                                                      require_cuda_f32,
                                                      rk_step)
from xnode_wan_tpu_torch.ops.kernels.xnode_train import flat_net

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "xnode_eval", "xnode_eval_launch",
    [_P, _I,                  # packed weights, count
     _P, _P, _P, _P, _P,      # feats, t, t_start, seed, out
     _I, _I, _I, _I, _I, _I, _I, _I])  # M H Hh F n_lift n_field k_steps method


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
    """Launch ``csrc/xnode_eval.cu`` on PyTorch's current stream."""
    if method not in METHOD_IDS:
        rk_step(method, None, None, None, None)  # raises the shared error
    if k_steps < 1:
        raise ValueError(f"k_steps must be >= 1, got {k_steps}")
    net.check_caps()
    if packed is None:
        packed = net.packed()
    dev = require_cuda_f32([packed, feats, t, t_start, seed])
    M = t.shape[0]
    H, Hh, F, n_lift, n_field = net.dims()
    if feats.shape != (M, F) or t_start.shape != (M,) or seed.shape != (M,):
        raise ValueError("shape mismatch: feats [M, F], t/t_start/seed [M]")
    out = torch.empty((M,), dtype=torch.float32, device=dev)
    KERNEL(dev, packed.data_ptr(), packed.numel(), feats.data_ptr(),
           t.data_ptr(), t_start.data_ptr(), seed.data_ptr(), out.data_ptr(),
           M, H, Hh, F, n_lift, n_field, k_steps, METHOD_IDS[method])
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
