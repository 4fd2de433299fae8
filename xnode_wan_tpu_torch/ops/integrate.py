"""Fixed-step ODE integration along path time grids, with masking.

Port of ``xnode_wan_tpu/ops/integrate.py::integrate``: a loop over the
``L`` sample times; each interval ``[t_prev, t_l]`` takes ``n_sub`` equal
substeps of euler, midpoint, heun or rk4, with the step bodies the
kernels' plain versions use (``ops/kernels/steppers.py::rk_step``).
Invalid samples leave the carried state and time untouched, and ``dt`` is
clamped at 0.
"""

from __future__ import annotations

from typing import Callable

import torch

from xnode_wan_tpu_torch.ops.kernels.steppers import (FUSED_KERNEL_METHODS,
                                                      rk_step)

Field = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (t [N], h [N,H])

ADAPTIVE_METHODS = ("dopri5", "bosh3", "adaptive_heun", "fehlberg2",
                    "dopri8", "adams")
MULTISTEP_METHODS = ("explicit_adams", "fixed_adams")


def integrate(field: Field, h0: torch.Tensor, times: torch.Tensor,
              t_start: torch.Tensor, mask: torch.Tensor, n_sub: int,
              method: str = "midpoint", remat: bool = False) -> torch.Tensor:
    """Integrate ``dh/dt = field(t, h)`` to every valid sample time.

    ``h0 [N, H]``, ``times [N, L]``, ``t_start [N]``, ``mask [N, L]``.
    Returns ``hs [N, L, H]``: the state at each sample time (the stale
    carry at invalid positions; callers mask them out).
    """
    if remat:
        raise NotImplementedError(
            "remat (activation checkpointing) comes with the training port")
    if method in MULTISTEP_METHODS or method in ADAPTIVE_METHODS:
        raise NotImplementedError(
            f"method {method!r} is not ported yet; the port integrates "
            f"with {FUSED_KERNEL_METHODS}")
    if method not in FUSED_KERNEL_METHODS:
        raise ValueError(f"unknown method {method!r}")

    def field_col(t, h):  # rk_step's times are columns [N, 1]
        return field(t[:, 0], h)

    h = h0
    t_prev = t_start.to(h0.dtype)
    hs = []
    for l in range(times.shape[1]):
        t_l, m_l = times[:, l], mask[:, l]
        dt = (torch.clamp(t_l - t_prev, min=0.0) / n_sub)[:, None]
        h_new = h
        for k in range(n_sub):
            h_new = rk_step(method, field_col, (t_prev + k * dt[:, 0])[:, None],
                            dt, h_new)
        h = torch.where(m_l[:, None], h_new, h)
        t_prev = torch.where(m_l, t_l, t_prev)
        hs.append(h)
    return torch.stack(hs, dim=1)
