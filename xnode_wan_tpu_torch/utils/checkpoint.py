"""Checkpoint save and restore, in PyTorch's idiom.

Counterpart of ``xnode_wan_tpu/utils/checkpoint.py``. The JAX package
writes flax msgpack (``checkpoint_NODE.msgpack``); the port neither reads
nor writes that format, so that it needs no flax. Its files:

* ``checkpoint_NODE.pt``: ``torch.save`` of the full training state: for
  each ensemble member (one without an ensemble) both networks' and both
  Adam optimizers' ``state_dict``s, the sampling generator's state,
  ``step`` and, with ``ema_decay > 0``, the Polyak average; then the best
  member's index and ``best_l``. It holds tensors, numbers and containers
  only and loads with ``torch.load(..., weights_only=True)``.
* ``best_model_weights_NODE.pth``: an XNODE's weights in the reference
  trainer's own key layout (a ``DataParallel(NeuralODE)`` state dict,
  ``module.initial_layers.{2i}``, ``module.ODE_rhs.net.{2i}``,
  ``module.final_linear``), the inverse of
  ``torch_compat.load_reference_state_dict``, which reads it back; a
  WAN primal's own ``state_dict``, since the reference has no such layout.

Both are written to a temporary file and then renamed over the target,
so a crash never leaves half a file.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Sequence, Tuple

import torch

from xnode_wan_tpu_torch.models.xnode import XNODE


def save(path: str, obj: Any) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def load(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


def cpu_parameters(params) -> Dict[str, torch.Tensor]:
    """A module's parameters by name, on the CPU, in one device-to-host
    copy (one copy a tensor would wait on the device once a tensor)."""
    named = list(params.named_parameters())
    flat = torch.cat([p.detach().reshape(-1) for _, p in named]).cpu()
    out, offset = {}, 0
    for name, p in named:
        out[name] = flat[offset:offset + p.numel()].view(p.shape).clone()
        offset += p.numel()
    return out


def reference_state_dict(params) -> Dict[str, torch.Tensor]:
    """An ``XNODE``'s weights under the reference's keys."""
    sd = {}
    for name, t in cpu_parameters(params).items():
        part, rest = name.split(".", 1)
        if part == "readout":
            sd[f"module.final_linear.{rest}"] = t
            continue
        i, kind = rest.split(".")
        prefix = ("module.initial_layers" if part == "lift"
                  else "module.ODE_rhs.net")
        sd[f"{prefix}.{2 * int(i)}.{kind}"] = t
    return sd


def best_weights_dict(params) -> Dict[str, torch.Tensor]:
    """The best-weights file's contents: the reference layout for an
    XNODE, the module's own parameters for any other primal."""
    if isinstance(params, XNODE):
        return reference_state_dict(params)
    return cpu_parameters(params)


def _member_dict(state) -> Dict[str, Any]:
    out = {"u_params": state.u_params.state_dict(),
           "v_params": state.v_params.state_dict(),
           "opt_u": state.opt_u.state_dict(),
           "opt_v": state.opt_v.state_dict(),
           "generator": state.generator.get_state(),
           "step": int(state.step)}
    if state.u_ema is not None:
        out["u_ema"] = state.u_ema.state_dict()
    return out


def train_state_dict(states: Sequence, best_l: float,
                     best_member: int = 0) -> Dict[str, Any]:
    """Everything the ``training.TrainState`` of each member needs to
    continue a run, with the best member's index and ``best_l``."""
    return {"members": [_member_dict(s) for s in states],
            "best_member": int(best_member), "best_l": float(best_l)}


def restore_train_state(states: Sequence, sd: Dict[str, Any]
                        ) -> Tuple[float, int]:
    """Load :func:`train_state_dict`'s output into freshly built states of
    the same configuration, in place; returns ``(best_l, best_member)``.
    Optimizer states map onto the parameters in their construction order,
    and each generator state (a CPU byte tensor for any device) is set as
    saved."""
    if len(sd["members"]) != len(states):
        raise ValueError(f"the checkpoint holds {len(sd['members'])} "
                         f"members, the solver {len(states)}")
    for state, msd in zip(states, sd["members"]):
        state.u_params.load_state_dict(msd["u_params"])
        state.v_params.load_state_dict(msd["v_params"])
        state.opt_u.load_state_dict(msd["opt_u"])
        state.opt_v.load_state_dict(msd["opt_v"])
        state.generator.set_state(msd["generator"])
        state.step = int(msd["step"])
        if state.u_ema is not None:
            state.u_ema.load_state_dict(msd["u_ema"])
    return float(sd["best_l"]), int(sd["best_member"])
