"""Tangentless path forward ``u [N, L]``: the fresh-sample metric forward.

Replaces ``xnode_wan_tpu/ops/pallas/xnode_train.py::_fwd_only_kernel``
(reached through ``_build_fwd_only`` and ``u_forward_fused``), which
the JAX trainer runs every outer step to score the current solution
(``training.py:230-240, 519``). The gradient kernels of that module come
with the training port.

Kernel: ``csrc/xnode_train.cu::xnode_path_fwd_kernel``, one thread per
path. A block stages the packed weights (2,161 floats at the d=5 width)
in shared memory; the thread lifts its seed, applies the feature columns
of field layer 0 once, then walks the L intervals with n_sub RK substeps
each and writes ``u`` after every interval. Masked samples come with
``dt = 0`` from :func:`_prep_intervals`, so their interval is the
identity and the kernel needs no branch on the mask.

Bound on an H100 SXM (67 TFLOP/s FP32 without tensor cores, 3.35 TB/s):
at the d=5 metric batch (N = 4,000, L = 20, midpoint, n_sub = 1) the work
is about 0.36 GFLOP (5.4 µs) and the bytes about 1.1 MB (0.3 µs). With only 4,000 threads (125 warps, one per SM at 32 threads a
block) the kernel is bound by the latency of its serial chain of 40
field evaluations, far above either figure; the design spreads the
warps over the SMs and keeps every operand on chip, and leaves the
latency to a later change (more threads per path, for example one per
hidden unit).
"""

from __future__ import annotations

import ctypes
from typing import List

import torch

from xnode_wan_tpu_torch.ops.kernels._build import CudaKernel
from xnode_wan_tpu_torch.ops.kernels.steppers import (METHOD_IDS, FlatNet,
                                                      require_cuda_f32,
                                                      rk_step)

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "xnode_train", "xnode_path_fwd_launch",
    [_P, _I,                  # packed weights, count
     _P, _P, _P, _P, _P,      # t0, dt, feats, seed, u
     _I, _I, _I, _I, _I, _I, _I, _I, _I])  # N L H Hh F n_lift n_field n_sub method


def _flatten_params_t(params) -> List[torch.Tensor]:
    """Weights ``[out, in]`` and biases ``[out]`` in f32, in the order
    lift, field, readout."""
    flat = []
    for layer in [*params.lift, *params.field, params.readout]:
        flat += [layer.weight.detach().float(), layer.bias.detach().float()]
    return flat


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
    """Launch ``csrc/xnode_train.cu`` on PyTorch's current stream."""
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
           N, L, H, Hh, F, n_lift, n_field, n_sub, METHOD_IDS[method])
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
