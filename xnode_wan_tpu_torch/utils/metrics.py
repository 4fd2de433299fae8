"""Error metrics: masked L^p norms and relative error.

Port of ``xnode_wan_tpu/utils/metrics.py`` (reference
``utils/auxillary_funcs.py:7-30``): ``rel_err = L_norm(err) /
L_norm(sol)`` is the paper's headline metric. On a mesh ``group`` is the
data group, and the sums are those over every rank's paths.
"""

from __future__ import annotations

import torch

from xnode_wan_tpu_torch.parallel.mesh import global_sum


def masked_lp(vals: torch.Tensor, mask: torch.Tensor, volume,
              p: float, group=None) -> torch.Tensor:
    """``(V * sum |vals|^p mask / sum mask)^{1/p}``."""
    m = mask.to(vals.dtype)
    mean = (global_sum(torch.sum(torch.abs(vals) ** p * m), group)
            / torch.clamp(global_sum(m.sum(), group), min=1.0))
    return (volume * mean) ** (1.0 / p)


def l_norm(u_vals: torch.Tensor, sol_vals: torch.Tensor, mask: torch.Tensor,
           volume, p: float, error: bool = True, group=None) -> torch.Tensor:
    f = (sol_vals - u_vals) if error else sol_vals
    return masked_lp(f, mask, volume, p, group=group)


def rel_err(u_vals: torch.Tensor, sol_vals: torch.Tensor, mask: torch.Tensor,
            volume, p: float, group=None) -> torch.Tensor:
    return (l_norm(u_vals, sol_vals, mask, volume, p, group=group)
            / l_norm(u_vals, sol_vals, mask, volume, p, error=False,
                     group=group))
