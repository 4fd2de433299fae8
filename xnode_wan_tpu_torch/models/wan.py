"""Vanilla-WAN primal network: a plain pointwise MLP ``u(t, x)``.

Port of ``xnode_wan_tpu/models/wan.py``, the paper's comparison baseline:
the same weak adversarial training with an ordinary network in place of
the data-seeded neural ODE (``primal: wan``). It has the XNODE's surface
(``init``, ``apply`` on a path batch, ``evaluate_points``), so the
trainer takes either through ``training.PRIMAL_MODELS``.

Architecture: ``Linear(d+1, H) -> [Tanh, Linear(H, H)] * u_layers ->
Linear(H, 1)``, Xavier-uniform weights and zero biases. No fused kernel
takes it: its u side runs by forward mode through the MLP, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from xnode_wan_tpu_torch.config import SolverConfig
from xnode_wan_tpu_torch.device import default_device
from xnode_wan_tpu_torch.models.layers import mlp_init
from xnode_wan_tpu_torch.ops.sampling import PathBatch
from xnode_wan_tpu_torch.parallel.mesh import serve_sharded


class WAN(nn.Module):
    """The MLP's layers, an ``nn.ModuleList`` of ``nn.Linear`` (weights
    ``[out, in]``)."""

    def __init__(self, net: nn.ModuleList):
        super().__init__()
        self.net = net


def init_wan(cfg: SolverConfig, generator: Optional[torch.Generator] = None,
             device=None) -> WAN:
    """Xavier-uniform WAN for ``cfg`` (f64 when ``cfg.x64``). Without a
    ``generator`` the weights come from ``cfg.seed``."""
    if generator is not None:
        dev = generator.device
    else:
        dev = default_device(device)
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    dt = torch.float64 if cfg.x64 else torch.float32
    h, d = cfg.u_hidden_dim, cfg.dim
    return WAN(mlp_init([d + 1] + [h] * (cfg.u_layers + 1) + [1], generator,
                        dev, dt))


def _mlp(params: WAN, pts: torch.Tensor) -> torch.Tensor:
    layers = params.net
    z = layers[0](pts)
    for layer in layers[1:]:
        z = layer(torch.tanh(z))
    return z[..., 0]


def apply_wan(params: WAN, batch: PathBatch, problem,
              cfg: SolverConfig) -> torch.Tensor:
    """u at every sample point of ``batch`` -> ``[N, L]``."""
    del problem
    return _mlp(params, batch.x) * cfg.u_scale_eff


def evaluate_points(params: WAN, pts: torch.Tensor, problem,
                    cfg: SolverConfig, k_steps: int | None = None,
                    domain=None, mesh=None) -> torch.Tensor:
    """u at arbitrary space-time points ``pts [M, C]`` -> ``[M]``: the MLP
    evaluates anywhere directly, so there is no path and no seeding. On a
    ``mesh`` each rank serves its share, as the XNODE's
    ``evaluate_points`` does."""
    if mesh is not None and mesh.size > 1:
        return serve_sharded(evaluate_points, mesh, params, pts, problem,
                             cfg)
    del problem, k_steps, domain
    return _mlp(params, pts) * cfg.u_scale_eff
