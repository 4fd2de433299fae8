"""Fixed-step RK step bodies and the plain XNODE network over packed weights.

Port of ``xnode_wan_tpu/ops/pallas/steppers.py``. Both kernels of this
package (``csrc/xnode_eval.cu``, ``csrc/xnode_train.cu``) integrate the
same XNODE field with the same four schemes, from one device copy in
``csrc/steppers.cuh``; this module is its plain PyTorch twin, which the
wrappers take for CPU tensors and ``chip_smoke.py`` holds the kernels
against on the card.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

# The fixed-step schemes the kernels implement, in the order of XnMethod
# in csrc/steppers.cuh. Adaptive methods and the Adams multisteps always
# take the masked-scan path.
FUSED_KERNEL_METHODS = ("euler", "midpoint", "heun", "rk4")
METHOD_IDS = {m: i for i, m in enumerate(FUSED_KERNEL_METHODS)}

# Compile-time caps of csrc/steppers.cuh, and the shared memory one block
# may use on Hopper (232,448 bytes).
MAX_WIDTH = 64
MAX_FIELD_IN = 128
MAX_SMEM_BYTES = 232448


def rk_step(method: str, field, t, dt, h):
    """One fixed step of ``method`` from state ``h`` at time ``t``.

    ``t`` and ``dt`` broadcast against ``h`` (``[B, 1]`` against
    ``[B, H]`` here); only elementwise ops and ``field`` touch them.
    """
    if method == "euler":
        return h + dt * field(t, h)
    if method == "midpoint":
        k1 = field(t, h)
        return h + dt * field(t + 0.5 * dt, h + 0.5 * dt * k1)
    if method == "heun":
        k1 = field(t, h)
        return h + 0.5 * dt * (k1 + field(t + dt, h + dt * k1))
    if method == "rk4":
        k1 = field(t, h)
        k2 = field(t + 0.5 * dt, h + 0.5 * dt * k1)
        k3 = field(t + 0.5 * dt, h + 0.5 * dt * k2)
        k4 = field(t + dt, h + dt * k3)
        return h + dt * (k1 + 2 * k2 + 2 * k3 + k4) / 6.0
    raise ValueError(
        f"fused kernels implement {FUSED_KERNEL_METHODS}, got {method!r}"
        " — callers must gate on FUSED_KERNEL_METHODS (weak_form."
        "fused_gate / models.xnode.evaluate_points)")


class FlatNet:
    """An XNODE's weights as the kernels take them: f32, ``W [out, in]``
    and ``b [out]`` per layer, lift then field then readout, plus the plain
    forward pieces over those tensors."""

    def __init__(self, flat: Sequence[torch.Tensor], n_lift: int,
                 n_field: int):
        self.flat = list(flat)
        self.n_lift, self.n_field = n_lift, n_field
        pairs = [(self.flat[2 * i], self.flat[2 * i + 1])
                 for i in range(len(self.flat) // 2)]
        self.lift = pairs[:n_lift]
        self.field_layers = pairs[n_lift:n_lift + n_field]
        self.readout_layer = pairs[-1]
        self.H = self.lift[-1][0].shape[0]
        self.Hh = self.field_layers[0][0].shape[0]
        self.F = self.field_layers[0][0].shape[1] - 1 - self.H

    def lift_apply(self, seed: torch.Tensor) -> torch.Tensor:
        """``seed [B] -> h [B, H]``."""
        w, b = self.lift[0]
        h = seed[:, None] @ w.T + b
        for w, b in self.lift[1:]:
            h = torch.relu(h) @ w.T + b
        return h

    def field_apply(self, feats: torch.Tensor, t: torch.Tensor,
                    h: torch.Tensor) -> torch.Tensor:
        """``F(x, t, h)``: ``feats [B, F]``, ``t [B, 1]``, ``h [B, H]``."""
        z = torch.cat([feats, t, h], dim=-1)
        w, b = self.field_layers[0]
        a = z @ w.T + b
        for w, b in self.field_layers[1:-1]:
            a = torch.relu(a) @ w.T + b
        w, b = self.field_layers[-1]
        return torch.tanh(a) @ w.T + b

    def readout(self, h: torch.Tensor) -> torch.Tensor:
        """``h [B, H] -> u [B]``."""
        w, b = self.readout_layer
        return (h @ w.T + b)[:, 0]

    def packed(self) -> torch.Tensor:
        """One contiguous f32 buffer in the layout of csrc/steppers.cuh."""
        return torch.cat([a.reshape(-1) for a in self.flat]).contiguous()

    def dims(self) -> Tuple[int, int, int, int, int]:
        return self.H, self.Hh, self.F, self.n_lift, self.n_field

    def check_caps(self) -> None:
        """Raise when the kernels' compile-time caps do not cover this net."""
        if self.H > MAX_WIDTH or self.Hh > MAX_WIDTH:
            raise ValueError(
                f"hidden widths H={self.H}, Hh={self.Hh} exceed the CUDA "
                f"kernels' cap of {MAX_WIDTH}")
        if self.F + 1 + self.H > MAX_FIELD_IN:
            raise ValueError(
                f"field input width {self.F + 1 + self.H} exceeds the CUDA "
                f"kernels' cap of {MAX_FIELD_IN}")
        n_bytes = 4 * sum(a.numel() for a in self.flat)
        if n_bytes > MAX_SMEM_BYTES:
            raise ValueError(f"{n_bytes} bytes of weights do not fit one "
                             f"block's shared memory ({MAX_SMEM_BYTES})")


def field_macs(net: FlatNet) -> Tuple[int, int]:
    """Multiply-adds of the kernels' field: ``(once per path, per
    evaluation)``. The feature columns of field layer 0 are applied once
    per path (the spatial point is frozen along it)."""
    H, Hh, F, _, n_field = net.dims()
    per_eval = (1 + H) * Hh + (n_field - 2) * Hh * Hh + Hh * H
    return F * Hh, per_eval


def lift_readout_macs(net: FlatNet) -> int:
    H = net.H
    return H + (net.n_lift - 1) * H * H + H


EVALS_PER_STEP = {"euler": 1, "midpoint": 2, "heun": 2, "rk4": 4}


def require_cuda_f32(tensors: List[torch.Tensor]) -> torch.device:
    """Check the kernels' input contract: one CUDA device, f32, contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if (t.device.type != "cuda" or t.device != dev
                or t.dtype != torch.float32 or not t.is_contiguous()):
            raise ValueError("kernel inputs must be contiguous float32 "
                             f"tensors on one CUDA device, got {t.dtype} on "
                             f"{t.device}")
    return dev
