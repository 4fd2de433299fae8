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


def l_norm_reference_api(batch, u_apply_fn, p: float, func_u_sol, volume,
                         n_r: int, error: bool = True) -> torch.Tensor:
    """The reference's signature, ``L_norm(X, u_net, p, func_u_sol,
    volume, N_r)`` (reference ``utils/auxillary_funcs.py:7-22``), over a
    :class:`PathBatch` instead of ragged group lists: ``u_apply_fn(batch)``
    gives u at every sample, and the mask weights the samples, so ``n_r``
    (the reference's n_k / N_r weights) is not used. Port of the JAX
    package's ``l_norm_reference_api``."""
    del n_r
    u_vals = u_apply_fn(batch)
    return l_norm(u_vals, func_u_sol(batch.x), batch.mask, volume, p,
                  error=error)
