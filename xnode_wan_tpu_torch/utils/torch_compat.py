"""Weight carry-over into the port's :class:`~xnode_wan_tpu_torch.models.xnode.XNODE`.

* :func:`params_from_jax`: the JAX package's pytree
  ``{"lift": [...], "field": [...], "readout": {...}}`` of ``{"w", "b"}``
  layers as numpy arrays (``w [in, out]``, transposed here to ``[out, in]``).
* :func:`load_reference_state_dict`: the reference's
  ``best_model_weights_NODE.pth`` (``torch.save`` of a
  ``DataParallel(NeuralODE)`` state dict), mapped as

      module.initial_layers.{0,2,4}.{weight,bias} -> lift[0..2]
      module.ODE_rhs.net.{0,2,...}.{weight,bias}  -> field[0..k]
      module.final_linear.{weight,bias}           -> readout
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from xnode_wan_tpu_torch.device import default_device
from xnode_wan_tpu_torch.models.xnode import XNODE


def _linear(w_out_in, b, device, dtype) -> nn.Linear:
    w = torch.tensor(np.asarray(w_out_in), device=device, dtype=dtype)
    layer = nn.Linear(w.shape[1], w.shape[0], device=device, dtype=dtype)
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.copy_(torch.tensor(np.asarray(b), device=device,
                                      dtype=dtype))
    return layer


def _xnode(lift: Sequence[Tuple[Any, Any]], field: Sequence[Tuple[Any, Any]],
           readout: Tuple[Any, Any], device, dtype) -> XNODE:
    dev = default_device(device)
    return XNODE(
        lift=nn.ModuleList(_linear(w, b, dev, dtype) for w, b in lift),
        field=nn.ModuleList(_linear(w, b, dev, dtype) for w, b in field),
        readout=_linear(*readout, dev, dtype))


def params_from_jax(tree: Mapping[str, Any], device=None,
                    dtype=torch.float32) -> XNODE:
    """XNODE from a JAX ``init_xnode``-shaped pytree of numpy arrays."""
    def wb(layer):
        return np.asarray(layer["w"]).T, np.asarray(layer["b"])
    return _xnode([wb(l) for l in tree["lift"]],
                  [wb(l) for l in tree["field"]],
                  wb(tree["readout"]), device, dtype)


def load_reference_state_dict(path: str, device=None,
                              dtype=torch.float64) -> XNODE:
    """XNODE from a reference ``.pth`` (stored in f64 by the reference)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k.removeprefix("module."): v for k, v in sd.items()}

    def wb(prefix):
        return sd[f"{prefix}.weight"].numpy(), sd[f"{prefix}.bias"].numpy()

    lift_ids = sorted({int(k.split(".")[1])
                       for k in sd if k.startswith("initial_layers.")})
    field_ids = sorted({int(k.split(".")[2])
                        for k in sd if k.startswith("ODE_rhs.net.")})
    return _xnode([wb(f"initial_layers.{i}") for i in lift_ids],
                  [wb(f"ODE_rhs.net.{i}") for i in field_ids],
                  wb("final_linear"), device, dtype)
