"""Weight carry-over into the port's networks.

* :func:`params_from_jax`: the JAX package's XNODE pytree
  ``{"lift": [...], "field": [...], "readout": {...}}`` of ``{"w", "b"}``
  layers as numpy arrays (``w [in, out]``, transposed here to ``[out, in]``).
* :func:`disc_params_from_jax`: the JAX discriminator pytree
  ``{"inp", "hidden", "out"}`` (``hidden`` one layer when tied, else a
  list);
* :func:`wan_params_from_jax`: the JAX ``init_wan`` pytree ``{"net":
  [...]}`` into a :class:`models.wan.WAN`;
* :func:`state_from_jax`: the primal (by ``cfg.primal``) and the
  discriminator into a solver, with fresh Adam moments; under
  ``ensemble: K`` the trees are JAX's stacked ``[K, ...]`` member trees;
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
from xnode_wan_tpu_torch.models.discriminator import Discriminator
from xnode_wan_tpu_torch.models.wan import WAN
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


def disc_params_from_jax(tree: Mapping[str, Any], device=None,
                         dtype=torch.float32) -> Discriminator:
    """Discriminator from a JAX ``init_discriminator``-shaped pytree."""
    dev = default_device(device)

    def lin(layer):
        return _linear(np.asarray(layer["w"]).T, np.asarray(layer["b"]), dev,
                       dtype)
    hidden = tree["hidden"]
    hidden = (lin(hidden) if isinstance(hidden, Mapping)
              else nn.ModuleList(lin(l) for l in hidden))
    return Discriminator(lin(tree["inp"]), hidden, lin(tree["out"]))


def wan_params_from_jax(tree: Mapping[str, Any], device=None,
                        dtype=torch.float32) -> WAN:
    """WAN from a JAX ``init_wan``-shaped pytree of numpy arrays."""
    dev = default_device(device)
    return WAN(nn.ModuleList(
        _linear(np.asarray(l["w"]).T, np.asarray(l["b"]), dev, dtype)
        for l in tree["net"]))


def _member(tree, k: int):
    """Member ``k`` of a pytree whose leaves are stacked ``[K, ...]``."""
    if isinstance(tree, Mapping):
        return {name: _member(v, k) for name, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_member(v, k) for v in tree]
    return np.asarray(tree)[k]


def state_from_jax(solver, u_tree: Mapping[str, Any],
                   v_tree: Mapping[str, Any]) -> None:
    """Give ``solver`` (a ``training.NODEWANSolver``) the JAX package's
    primal (an XNODE or a WAN, by ``cfg.primal``) and discriminator
    weights, with fresh Adam moments and each member's own generator, at
    step 0. Under ``ensemble: K`` the trees are the JAX solver's stacked
    ``[K, ...]`` ones, and member k gets slice k."""
    cfg = solver.cfg
    dtype = torch.float64 if cfg.x64 else torch.float32
    primal_from_jax = (params_from_jax if cfg.primal == "xnode"
                       else wan_params_from_jax)
    members = []
    for k, state in enumerate(solver.members):
        u_k, v_k = ((u_tree, v_tree) if cfg.ensemble == 1
                    else (_member(u_tree, k), _member(v_tree, k)))
        members.append(solver._fresh_state(
            primal_from_jax(u_k, solver.device, dtype),
            disc_params_from_jax(v_k, solver.device, dtype),
            state.generator))
    solver.members = members


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
