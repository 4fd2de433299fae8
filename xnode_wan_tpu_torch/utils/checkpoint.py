"""Checkpoint save and restore, in PyTorch's idiom.

Counterpart of ``xnode_wan_tpu/utils/checkpoint.py``. The JAX package
writes flax msgpack (``checkpoint_NODE.msgpack``); the port neither reads
nor writes that format, so that it needs no flax. Its files:

* ``checkpoint_NODE.pt``: ``torch.save`` of the full training state, both
  networks' and both Adam optimizers' ``state_dict``s, the sampling
  generator's state, ``step``, ``best_l`` and, with ``ema_decay > 0``, the
  Polyak average. It holds tensors, numbers and containers only and loads
  with ``torch.load(..., weights_only=True)``.
* ``best_model_weights_NODE.pth``: the primal's weights in the reference
  trainer's own key layout (a ``DataParallel(NeuralODE)`` state dict,
  ``module.initial_layers.{2i}``, ``module.ODE_rhs.net.{2i}``,
  ``module.final_linear``), the inverse of
  ``torch_compat.load_reference_state_dict``, which reads it back.

Both are written to a temporary file and then renamed over the target,
so a crash never leaves half a file.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch


def save(path: str, obj: Any) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def load(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


def reference_state_dict(params) -> Dict[str, torch.Tensor]:
    """An ``XNODE``'s weights under the reference's keys."""
    sd = {}
    for prefix, layers in (("module.initial_layers", params.lift),
                           ("module.ODE_rhs.net", params.field)):
        for i, layer in enumerate(layers):
            sd[f"{prefix}.{2 * i}.weight"] = layer.weight.detach().cpu()
            sd[f"{prefix}.{2 * i}.bias"] = layer.bias.detach().cpu()
    sd["module.final_linear.weight"] = params.readout.weight.detach().cpu()
    sd["module.final_linear.bias"] = params.readout.bias.detach().cpu()
    return sd


def train_state_dict(state, best_l: float) -> Dict[str, Any]:
    """Everything ``training.TrainState`` needs to continue a run."""
    out = {"u_params": state.u_params.state_dict(),
           "v_params": state.v_params.state_dict(),
           "opt_u": state.opt_u.state_dict(),
           "opt_v": state.opt_v.state_dict(),
           "generator": state.generator.get_state(),
           "step": int(state.step), "best_l": float(best_l)}
    if state.u_ema is not None:
        out["u_ema"] = state.u_ema.state_dict()
    return out


def restore_train_state(state, sd: Dict[str, Any]) -> float:
    """Load :func:`train_state_dict`'s output into a freshly built state of
    the same configuration, in place; returns ``best_l``. Optimizer states
    map onto the parameters in their construction order, and the
    generator state (a CPU byte tensor for any device) is set as saved."""
    state.u_params.load_state_dict(sd["u_params"])
    state.v_params.load_state_dict(sd["v_params"])
    state.opt_u.load_state_dict(sd["opt_u"])
    state.opt_v.load_state_dict(sd["opt_v"])
    state.generator.set_state(sd["generator"])
    state.step = int(sd["step"])
    if state.u_ema is not None:
        state.u_ema.load_state_dict(sd["u_ema"])
    return float(sd["best_l"])
