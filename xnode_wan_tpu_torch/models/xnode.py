"""XNODE primal network: a neural ODE integrated along each sample path,
seeded with the PDE's known initial/boundary data.

Port of ``xnode_wan_tpu/models/xnode.py`` (reference ``src/model.py:54-156``):

* ``lift``: scalar -> hidden MLP ``Linear(1,H), ReLU, Linear(H,H), ReLU,
  Linear(H,H)``;
* ``field``: the ODE field with input ``(x, t, h)``: ``Linear(H+F+1, Hh),
  [ReLU, Linear]*(layers-1), Tanh, Linear(Hh, H)``;
* ``readout``: hidden -> scalar;
* seeding: ``h`` at the path's first sample when it starts at ``T0``,
  else ``g`` at its boundary-entry point.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from xnode_wan_tpu_torch.config import SolverConfig
from xnode_wan_tpu_torch.device import default_device
from xnode_wan_tpu_torch.models.layers import linear_init, mlp_init
from xnode_wan_tpu_torch.ops.integrate import ADAPTIVE_METHODS, integrate
from xnode_wan_tpu_torch.ops.kernels.steppers import FUSED_KERNEL_METHODS
from xnode_wan_tpu_torch.ops.kernels.xnode_eval import fused_evaluate
from xnode_wan_tpu_torch.ops.sampling import PathBatch


class XNODE(nn.Module):
    """The XNODE's three parts. ``lift`` and ``field`` are
    ``nn.ModuleList``s of ``nn.Linear`` (weights ``[out, in]``)."""

    def __init__(self, lift: nn.ModuleList, field: nn.ModuleList,
                 readout: nn.Linear):
        super().__init__()
        self.lift = lift
        self.field = field
        self.readout = readout


def _feature_dim(cfg: SolverConfig) -> int:
    """ODE-field spatial-input width: d raw coords + optional Fourier bank."""
    return cfg.dim * (1 + 2 * cfg.fourier_features)


def spatial_features(x: torch.Tensor, n_freq: int) -> torch.Tensor:
    """``[..., d] -> [..., d(1+2K)]``: raw coords plus ``sin/cos(k pi/2 x)``."""
    if n_freq == 0:
        return x
    k = torch.arange(1, n_freq + 1, dtype=x.dtype, device=x.device) * (math.pi / 2)
    phases = x[..., None] * k                       # [..., d, K]
    feats = torch.cat([torch.sin(phases), torch.cos(phases)], dim=-1)
    return torch.cat([x, feats.reshape(*x.shape[:-1], -1)], dim=-1)


def init_xnode(cfg: SolverConfig, generator: Optional[torch.Generator] = None,
               device=None) -> XNODE:
    """Xavier-uniform XNODE for ``cfg`` (f64 when ``cfg.x64``). Without a
    ``generator`` the weights come from ``cfg.seed``."""
    if generator is not None:
        dev = generator.device
    else:
        dev = default_device(device)
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    dt = torch.float64 if cfg.x64 else torch.float32
    h, hh = cfg.u_hidden_dim, cfg.u_hidden_hidden_dim
    field_dims = [h + _feature_dim(cfg) + 1] + [hh] * cfg.u_layers + [h]
    return XNODE(lift=mlp_init([1, h, h, h], generator, dev, dt),
                 field=mlp_init(field_dims, generator, dev, dt),
                 readout=linear_init(h, 1, generator, dev, dt))


def lift_apply(params: XNODE, seed: torch.Tensor) -> torch.Tensor:
    """Scalar seed ``[..., 1]`` -> hidden state ``[..., H]``."""
    z = params.lift[0](seed)
    for layer in params.lift[1:]:
        z = layer(torch.relu(z))
    return z


def field_apply(params: XNODE, x: torch.Tensor, t: torch.Tensor,
                h: torch.Tensor) -> torch.Tensor:
    """ODE field ``F(x, t, h) -> dh/dt``; ``x [N,F], t [N], h [N,H]``."""
    layers = params.field
    z = layers[0](torch.cat([x, t[:, None], h], dim=-1))
    for layer in layers[1:-1]:
        z = layer(torch.relu(z))
    return layers[-1](torch.tanh(z))


def path_seed_fn(batch: PathBatch, problem, cfg: SolverConfig):
    """The initial-value seeding, single-sourced for every forward.

    Returns ``seed_of(xs) -> [N]``: u's (u_scale-normalized) starting
    value per path: ``h`` at the path's first sample time where it begins
    at T0, ``g`` at ``t_start`` where it enters through the boundary.
    Computes in ``xs.dtype``.
    """
    def seed_of(xs):
        first_pts = torch.cat([batch.times[:, :1].to(xs.dtype), xs], dim=-1)
        entry_pts = torch.cat([batch.t_start.to(xs.dtype)[:, None], xs], dim=-1)
        return torch.where(batch.seed_from_h, problem.h(first_pts),
                           problem.g(entry_pts)) / cfg.u_scale_eff
    return seed_of


def apply_xnode(params: XNODE, batch: PathBatch, problem,
                cfg: SolverConfig) -> torch.Tensor:
    """u at every sample point of ``batch`` -> ``u [N, L]`` (masked scan).

    The path's spatial coords are frozen at its first point. Forward
    only here: ``remat_scan`` changes the backward's memory, not values,
    and comes with the training port.
    """
    if cfg.solver in ADAPTIVE_METHODS:
        raise NotImplementedError(
            f"adaptive solver {cfg.solver!r} is not ported yet")
    xs = batch.space[:, 0, :]                       # [N, d]
    seed = path_seed_fn(batch, problem, cfg)(xs)[:, None]
    h0 = lift_apply(params, seed)
    xs_f = spatial_features(xs, cfg.fourier_features)

    def field(t, h):
        return field_apply(params, xs_f, t, h)

    hs = integrate(field, h0, batch.times, batch.t_start, batch.mask,
                   n_sub=cfg.n_sub, method=cfg.solver)
    return params.readout(hs)[..., 0] * cfg.u_scale_eff   # [N, L]


def evaluate_points_fused(params: XNODE, pts: torch.Tensor, problem,
                          cfg: SolverConfig, k_steps: int,
                          t_entry: torch.Tensor,
                          seed_from_h: torch.Tensor) -> torch.Tensor:
    """The serving-kernel branch of :func:`evaluate_points`: seeds through
    :func:`path_seed_fn` on a one-sample batch at each point's entry time,
    then :func:`fused_evaluate` (the kernel on CUDA, its plain version on
    the CPU) with ``k_steps * n_sub`` steps."""
    m = pts.shape[0]
    entry_pts = pts.clone()
    entry_pts[:, 0] = t_entry
    seed_batch = PathBatch(
        x=entry_pts[:, None, :],
        mask=torch.ones((m, 1), dtype=torch.bool, device=pts.device),
        t_start=t_entry,
        seed_from_h=seed_from_h,
    )
    seed = path_seed_fn(seed_batch, problem, cfg)(pts[:, 1:])
    feats = spatial_features(pts[:, 1:], cfg.fourier_features)
    return fused_evaluate(params, pts, seed, k_steps * cfg.n_sub,
                          t_start=t_entry, feats=feats,
                          method=cfg.solver) * cfg.u_scale_eff


def evaluate_points(params: XNODE, pts: torch.Tensor, problem,
                    cfg: SolverConfig, k_steps: int | None = None,
                    domain=None, mesh=None) -> torch.Tensor:
    """Evaluate u at arbitrary space-time points ``pts [M, C]`` -> ``[M]``.

    Each point becomes a fresh path of ``k_steps`` uniform intervals from
    its domain-aware origin (``domain.entry``; without a domain, from
    ``T0`` with the h-seed). On CUDA, in f32, with ``cfg.use_pallas`` and a
    fixed-step RK solver, it runs the serving kernel
    (``csrc/xnode_eval.cu``); otherwise the masked scan, as the JAX
    package does for x64 and the Adams methods.
    """
    if mesh is not None:
        raise NotImplementedError("sharded serving is not ported yet")
    if k_steps is None:
        k_steps = max(cfg.min_steps, cfg.N_t)
    m = pts.shape[0]
    if domain is not None and hasattr(domain, "entry"):
        t_entry, seed_from_h = domain.entry(pts)
    else:
        t_entry = torch.full((m,), cfg.T0, dtype=pts.dtype, device=pts.device)
        seed_from_h = torch.ones((m,), dtype=torch.bool, device=pts.device)
    if (pts.is_cuda and cfg.use_pallas and pts.dtype == torch.float32
            and cfg.solver in FUSED_KERNEL_METHODS):
        return evaluate_points_fused(params, pts, problem, cfg, k_steps,
                                     t_entry, seed_from_h)
    t = pts[:, 0]
    frac = torch.linspace(0.0, 1.0, k_steps + 1, dtype=pts.dtype,
                          device=pts.device)
    times = t_entry[:, None] + frac[None, :] * (t - t_entry)[:, None]
    x_full = torch.cat(
        [times[:, :, None],
         pts[:, None, 1:].expand(m, k_steps + 1, pts.shape[1] - 1)], dim=-1)
    batch = PathBatch(
        x=x_full,
        mask=torch.ones((m, k_steps + 1), dtype=torch.bool, device=pts.device),
        t_start=t_entry,
        seed_from_h=seed_from_h,
    )
    return apply_xnode(params, batch, problem, cfg)[:, -1]
