"""Fixed-step RK step bodies and the plain XNODE network over packed weights.

Port of ``xnode_wan_tpu/ops/pallas/steppers.py``. The path-forward
kernels (``csrc/xnode_fwd.cu``: serving #1 and the metric #2) integrate
the XNODE field with these four schemes from one width-templated device
copy in ``csrc/steppers.cuh``; this module is its plain PyTorch twin,
which the wrappers take for CPU tensors and ``chip_smoke.py`` holds the
kernels against on the card.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

# The fixed-step schemes the kernels implement, in the order of XnMethod
# in csrc/steppers.cuh. Adaptive methods and the Adams multisteps always
# take the masked-scan path.
FUSED_KERNEL_METHODS = ("euler", "midpoint", "heun", "rk4")
METHOD_IDS = {m: i for i, m in enumerate(FUSED_KERNEL_METHODS)}

# Compile-time cap of csrc/steppers.cuh on H and Hh (#1/#2's register
# kernels, which take any feature width; past the cap the path-tile
# kernel serves), the shared memory one block may use on Hopper (232,448
# bytes), and that of one SM.
MAX_WIDTH = 64
MAX_SMEM_BYTES = 232448
SM_SMEM_BYTES = 233472


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
        """:func:`check_caps` of this net's shapes."""
        check_caps(self.dims())


def check_caps(dims) -> None:
    """Raise when the register kernels of ``csrc/xnode_fwd.cu`` (#1/#2)
    do not take a net ``(H, Hh, F, n_lift, n_field)``: a width above their
    compile-time cap, or a staged weight copy (:func:`staged_floats`)
    above one block's shared memory. Any feature width F fits: its columns
    are applied once a path and staged nowhere. The wrappers take the
    path-tile kernel past these caps (:func:`register_fits` selects)."""
    H, Hh, F, n_lift, n_field = dims
    if H > MAX_WIDTH or Hh > MAX_WIDTH:
        raise ValueError(f"hidden widths H={H}, Hh={Hh} exceed the CUDA "
                         f"kernels' cap of {MAX_WIDTH}")
    n_bytes = 4 * staged_floats(H, Hh, n_lift, n_field)
    if n_bytes > MAX_SMEM_BYTES:
        raise ValueError(f"{n_bytes} bytes of staged weights do not fit "
                         f"one block's shared memory ({MAX_SMEM_BYTES})")


def register_fits(dims) -> bool:
    """Whether #1/#2 take their register kernels (:func:`check_caps`
    passes) rather than the path-tile kernel."""
    try:
        check_caps(dims)
    except ValueError:
        return False
    return True


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def _ld_mod32(n: int, res: int) -> int:
    """The smallest multiple of 4 at least ``n`` that is ``res`` mod 32
    (``xc_ld``: a staged weight slice's row stride)."""
    ld = _pad4(n)
    while ld % 32 != res:
        ld += 4
    return ld


def unit_slices(width: int, cluster: int) -> List[range]:
    """The units of a layer ``width`` wide that each block of a cluster of
    #5 or #7 owns (``xc_lo``): block ``c`` takes ``[width c // C, width (c
    + 1) // C)``."""
    return [range(width * c // cluster, width * (c + 1) // cluster)
            for c in range(cluster)]


def _widest(width: int, cluster: int) -> int:
    return max(len(s) for s in unit_slices(width, cluster))


def staged_floats(H: int, Hh: int, n_lift: int, n_field: int) -> int:
    """Floats of the weights' staged copy in shared memory, twin of
    ``xn_staged_floats`` in ``csrc/steppers.cuh``: each layer ``W [out,
    in]`` by columns at a stride of ``out`` rounded up to four floats,
    then ``b`` padded the same; field layer 0 keeps only its time and
    ``h`` columns (the feature columns are applied once per path from
    global memory)."""
    def layer(out, inp):
        return (inp + 1) * _pad4(out)
    return (layer(H, 1) + (n_lift - 1) * layer(H, H) + layer(Hh, 1 + H)
            + (n_field - 2) * layer(Hh, Hh) + layer(H, Hh) + layer(1, H))


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

# The four schemes as explicit Runge-Kutta tables: stage s > 0 starts from
# ``h + A[s] * dt * k[s - 1]`` at ``t + C[s] * dt`` (every scheme here has
# one sub-diagonal entry), and the step is ``h + dt * sum_s B[s] k[s]``.
# The hand-written backward (``xnode_grad.py``, ``csrc/xnode_grad.cu``)
# walks these tables in reverse.
RK_TABLES = {
    "euler": ((0.0,), (0.0,), (1.0,)),
    "midpoint": ((0.0, 0.5), (0.0, 0.5), (0.0, 1.0)),
    "heun": ((0.0, 1.0), (0.0, 1.0), (0.5, 0.5)),
    "rk4": ((0.0, 0.5, 0.5, 1.0), (0.0, 0.5, 0.5, 1.0),
            (1.0 / 6, 2.0 / 6, 2.0 / 6, 1.0 / 6)),
}


# ---------------------------------------------------------------------------
# The joint primal + spatial-tangent network (kernels #3-#5). Natural
# layouts: primal ``[B, width]``, tangents ``[B, d, width]``; weights are
# ``(W [out, in], b [out])`` pairs as in :class:`FlatNet`. Sample times
# carry no tangent. Port of ``xnode_wan_tpu/ops/pallas/xnode_train.py``
# ``_mlp_relu_fwd_tan``, ``_field_fwd_tan`` and ``_interval``.
# ---------------------------------------------------------------------------


def mlp_relu_fwd_tan(ws, z: torch.Tensor, zt: torch.Tensor):
    """``linear -> [relu, linear]*`` (the lift) on ``z [B, in]`` and its
    tangents ``zt [B, d, in]``."""
    w, b = ws[0]
    a, at = z @ w.T + b, zt @ w.T
    for w, b in ws[1:]:
        at = torch.where(a[:, None, :] > 0, at, torch.zeros_like(at))
        a = torch.relu(a) @ w.T + b
        at = at @ w.T
    return a, at


def field_fwd_tan(ws, xp, xt, t, h, ht):
    """The ODE field and its tangents: ``xp [B, F]`` features, ``xt
    [B, d, F]`` their x-tangents, ``t [B, 1]``, ``h [B, H]``, ``ht
    [B, d, H]``. Returns ``(dh/dt [B, H], its tangents [B, d, H])``."""
    z = torch.cat([xp, t, h], dim=-1)
    zt = torch.cat([xt, torch.zeros_like(ht[..., :1]), ht], dim=-1)
    w, b = ws[0]
    a, at = z @ w.T + b, zt @ w.T
    for w, b in ws[1:-1]:
        at = torch.where(a[:, None, :] > 0, at, torch.zeros_like(at))
        a = torch.relu(a) @ w.T + b
        at = at @ w.T
    y = torch.tanh(a)
    yt = (1.0 - y * y)[:, None, :] * at
    w, b = ws[-1]
    return y @ w.T + b, yt @ w.T


def interval_tan(ws_field, xp, xt, h, ht, t0, dt, n_sub: int, method: str):
    """One sample interval: ``n_sub`` joint primal + tangent substeps of
    ``dt [B, 1]`` from ``t0 [B, 1]``; ``dt = 0`` is the identity."""
    dtd = dt[:, :, None]

    def f(t, hh, hht):
        return field_fwd_tan(ws_field, xp, xt, t, hh, hht)

    for k in range(n_sub):
        t = t0 + k * dt
        if method == "euler":
            k1, k1t = f(t, h, ht)
            h, ht = h + dt * k1, ht + dtd * k1t
        elif method == "midpoint":
            k1, k1t = f(t, h, ht)
            k2, k2t = f(t + 0.5 * dt, h + 0.5 * dt * k1, ht + 0.5 * dtd * k1t)
            h, ht = h + dt * k2, ht + dtd * k2t
        elif method == "heun":
            k1, k1t = f(t, h, ht)
            k2, k2t = f(t + dt, h + dt * k1, ht + dtd * k1t)
            h, ht = h + 0.5 * dt * (k1 + k2), ht + 0.5 * dtd * (k1t + k2t)
        elif method == "rk4":
            k1, k1t = f(t, h, ht)
            k2, k2t = f(t + 0.5 * dt, h + 0.5 * dt * k1, ht + 0.5 * dtd * k1t)
            k3, k3t = f(t + 0.5 * dt, h + 0.5 * dt * k2, ht + 0.5 * dtd * k2t)
            k4, k4t = f(t + dt, h + dt * k3, ht + dtd * k3t)
            h = h + dt * (k1 + 2 * k2 + 2 * k3 + k4) / 6.0
            ht = ht + dtd * (k1t + 2 * k2t + 2 * k3t + k4t) / 6.0
        else:
            rk_step(method, None, None, None, None)  # raises the shared error
    return h, ht


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


def bwd_blocks(n_items: int, tile: int, smem: int, threads: int,
               sms: int) -> int:
    """The persistent grid of a kernel that walks tiles of ``tile`` items
    and writes one partial row per block: as many blocks as fit the SMs at
    once by shared memory and threads, at most one per tile. Registers are
    not counted: where they allow fewer, the other blocks start as SMs
    free up, and the result is the same (one partial row per block)."""
    per_sm = min(SM_SMEM_BYTES // (smem + 1024), 2048 // threads)
    return max(1, min(-(-n_items // tile), per_sm * sms))
