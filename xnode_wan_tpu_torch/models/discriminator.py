"""Adversarial test-function network ``v(t, x)``.

Port of ``xnode_wan_tpu/models/discriminator.py`` (reference
``src/model.py:18-51``): ``Linear(in -> v_hidden)``, then ``v_layers``
repetitions of ``[ReLU, hidden]`` where ``hidden`` is ONE shared
``nn.Linear`` (weights tied across depth) when ``tied``, else a stack of
``v_layers`` layers; then ``Tanh`` and ``Linear(-> 1)``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from xnode_wan_tpu_torch.models.layers import linear_init, mlp_init


class Discriminator(nn.Module):
    """The discriminator's three parts as ``nn.Linear``s (``hidden`` an
    ``nn.ModuleList`` when untied)."""

    def __init__(self, inp: nn.Linear, hidden, out: nn.Linear):
        super().__init__()
        self.inp = inp
        self.hidden = hidden   # nn.Linear (tied) or nn.ModuleList
        self.out = out


def init_discriminator(dim: int, v_hidden: int, v_layers: int,
                       tied: bool = True, n_freq: int = 0,
                       generator: Optional[torch.Generator] = None,
                       device=None, dtype=torch.float32) -> Discriminator:
    """Xavier-uniform weights, zero biases, drawn in the JAX package's
    order of parts (input, hidden, output) from ``generator``."""
    in_dim = 1 + dim * (1 + 2 * n_freq)
    inp = linear_init(in_dim, v_hidden, generator, device, dtype)
    hidden = (linear_init(v_hidden, v_hidden, generator, device, dtype)
              if tied else mlp_init([v_hidden] * (v_layers + 1), generator,
                                    device, dtype))
    out = linear_init(v_hidden, 1, generator, device, dtype)
    return Discriminator(inp, hidden, out)


def disc_features(pts: torch.Tensor, n_freq: int) -> torch.Tensor:
    """The discriminator's input at ``pts [..., d+1]``: time, then the
    spatial coordinates with, for ``n_freq > 0``, their ``sin/cos(k pi/2
    x)`` banks (``models.xnode.spatial_features``)."""
    if n_freq == 0:
        return pts
    from xnode_wan_tpu_torch.models.xnode import spatial_features
    return torch.cat([pts[..., :1], spatial_features(pts[..., 1:], n_freq)],
                     dim=-1)


def apply_discriminator(params: Discriminator, pts: torch.Tensor,
                        v_layers: int, tied: bool = True,
                        n_freq: int = 0) -> torch.Tensor:
    """``v`` at points ``pts [..., d+1]`` (time at channel 0) -> ``[...]``,
    on :func:`disc_features`."""
    z = params.inp(disc_features(pts, n_freq))
    for i in range(v_layers):
        layer = params.hidden if tied else params.hidden[i]
        z = layer(torch.relu(z))
    return params.out(torch.tanh(z))[..., 0]
