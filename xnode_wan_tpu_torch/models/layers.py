"""Linear layers with the reference initialization: Xavier-uniform weights
and zero biases (reference ``src/model.py:12-15``).

Weights are stored as ``nn.Linear`` does, ``[out, in]``; the JAX package
stores ``w`` as ``[in, out]`` (``xnode_wan_tpu/models/layers.py``).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch import nn


def linear_init(in_dim: int, out_dim: int, generator: Optional[torch.Generator],
                device, dtype) -> nn.Linear:
    layer = nn.Linear(in_dim, out_dim, device=device, dtype=dtype)
    limit = math.sqrt(6.0 / (in_dim + out_dim))
    with torch.no_grad():
        u = torch.rand((out_dim, in_dim), generator=generator,
                       device=device, dtype=dtype)
        layer.weight.copy_(u * (2.0 * limit) - limit)
        layer.bias.zero_()
    return layer


def mlp_init(dims: List[int], generator: Optional[torch.Generator], device,
             dtype) -> nn.ModuleList:
    return nn.ModuleList(linear_init(a, b, generator, device, dtype)
                         for a, b in zip(dims[:-1], dims[1:]))
