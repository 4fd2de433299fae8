"""Error metrics: masked L^p norms and relative error.

Port of ``xnode_wan_tpu/utils/metrics.py`` (reference
``utils/auxillary_funcs.py:7-30``): ``rel_err = L_norm(err) /
L_norm(sol)`` is the paper's headline metric.
"""

from __future__ import annotations

import torch


def masked_lp(vals: torch.Tensor, mask: torch.Tensor, volume,
              p: float) -> torch.Tensor:
    """``(V * sum |vals|^p mask / sum mask)^{1/p}``."""
    m = mask.to(vals.dtype)
    mean = torch.sum(torch.abs(vals) ** p * m) / torch.clamp(m.sum(), min=1.0)
    return (volume * mean) ** (1.0 / p)


def l_norm(u_vals: torch.Tensor, sol_vals: torch.Tensor, mask: torch.Tensor,
           volume, p: float, error: bool = True) -> torch.Tensor:
    f = (sol_vals - u_vals) if error else sol_vals
    return masked_lp(f, mask, volume, p)


def rel_err(u_vals: torch.Tensor, sol_vals: torch.Tensor, mask: torch.Tensor,
            volume, p: float) -> torch.Tensor:
    return (l_norm(u_vals, sol_vals, mask, volume, p)
            / l_norm(u_vals, sol_vals, mask, volume, p, error=False))
