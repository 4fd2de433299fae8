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
from torch.nn import functional as F

from xnode_wan_tpu_torch.config import SolverConfig
from xnode_wan_tpu_torch.device import default_device
from xnode_wan_tpu_torch.models.layers import linear_init, mlp_init
from xnode_wan_tpu_torch.ops.adjoint import make_adjoint_integrator
from xnode_wan_tpu_torch.ops.integrate import (ADAPTIVE_METHODS, Jet,
                                               integrate, integrate_adaptive)
from xnode_wan_tpu_torch.ops.kernels.steppers import FUSED_KERNEL_METHODS
from xnode_wan_tpu_torch.ops.kernels.xnode_eval import fused_evaluate
from xnode_wan_tpu_torch.ops.sampling import PathBatch
from xnode_wan_tpu_torch.parallel.mesh import serve_sharded


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


def field_weights(params: XNODE):
    """The field's ``(W0, b0, W1, b1, ...)``."""
    return tuple(w for layer in params.field
                 for w in (layer.weight, layer.bias))


def field_apply_weights(weights, x: torch.Tensor, t: torch.Tensor,
                        h: torch.Tensor) -> torch.Tensor:
    """ODE field ``F(x, t, h) -> dh/dt`` over :func:`field_weights`;
    ``x [N,F], t [N], h [N,H]``. ``F.linear`` is ``nn.Linear``'s forward,
    without the module call's overhead."""
    pairs = [weights[i:i + 2] for i in range(0, len(weights), 2)]
    z = F.linear(torch.cat([x, t[:, None], h], dim=-1), *pairs[0])
    for w, b in pairs[1:-1]:
        z = F.linear(torch.relu(z), w, b)
    return F.linear(torch.tanh(z), *pairs[-1])


def field_apply(params: XNODE, x: torch.Tensor, t: torch.Tensor,
                h: torch.Tensor) -> torch.Tensor:
    """ODE field ``F(x, t, h) -> dh/dt``; ``x [N,F], t [N], h [N,H]``."""
    return field_apply_weights(field_weights(params), x, t, h)


def field_jvp(params: XNODE, x: Jet, t: torch.Tensor, h: Jet) -> Jet:
    """:func:`field_apply` on :class:`Jet` features and state: the primal
    exactly as :func:`field_apply` computes it, the D tangents by its
    forward-mode derivative (the time column has none)."""
    wb = [(layer.weight, layer.bias) for layer in params.field]
    z = torch.cat([x.p, t[:, None], h.p], dim=-1)
    dz = torch.cat([x.t, x.t.new_zeros(x.t.shape[:-1] + (1,)), h.t], dim=-1)
    a, da = F.linear(z, *wb[0]), F.linear(dz, wb[0][0])
    for w, b in wb[1:-1]:
        # relu's derivative: da where a > 0, else 0
        da = F.linear(torch.ops.aten.threshold_backward(da, a, 0), w)
        a = F.linear(torch.relu(a), w, b)
    th = torch.tanh(a)
    return Jet(F.linear(th, *wb[-1]),
               F.linear(torch.ops.aten.tanh_backward(da, th), wb[-1][0]))


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


def _integrate(cfg: SolverConfig, field, h0, batch: PathBatch, closed):
    """The configured integrator (JAX ``models/xnode.py:131-146``): the
    adaptive and VCABM methods through :func:`integrate_adaptive` with
    ``ode_rtol``/``ode_atol``/``ode_max_steps``/``ode_strict``, the
    fixed-step ones through :func:`integrate`; each sample interval
    checkpointed under ``remat_scan`` (the default) or ``adjoint``, which
    means remat as in the JAX package (its ``docs/DESIGN.md`` §17.2);
    ``closed``: the tensors the field closes over."""
    remat = cfg.adjoint or cfg.remat_scan
    if cfg.solver in ADAPTIVE_METHODS:
        return integrate_adaptive(field, h0, batch.times, batch.t_start,
                                  batch.mask, rtol=cfg.ode_rtol,
                                  atol=cfg.ode_atol,
                                  max_steps=cfg.ode_max_steps, remat=remat,
                                  strict=cfg.ode_strict, method=cfg.solver,
                                  closed=closed)
    return integrate(field, h0, batch.times, batch.t_start, batch.mask,
                     n_sub=cfg.n_sub, method=cfg.solver, remat=remat,
                     closed=closed)


def apply_xnode(params: XNODE, batch: PathBatch, problem,
                cfg: SolverConfig) -> torch.Tensor:
    """u at every sample point of ``batch`` -> ``u [N, L]`` (masked scan,
    the configured integrator: :func:`_integrate`). The path's spatial
    coords are frozen at its first point."""
    xs = batch.space[:, 0, :]                       # [N, d]
    seed = path_seed_fn(batch, problem, cfg)(xs)[:, None]
    h0 = lift_apply(params, seed)
    xs_f = spatial_features(xs, cfg.fourier_features)

    def field(t, h):
        return field_apply(params, xs_f, t, h)

    hs = _integrate(cfg, field, h0, batch, (xs_f, *field_weights(params)))
    return params.readout(hs)[..., 0] * cfg.u_scale_eff   # [N, L]


def apply_xnode_with_spatial_grad(params: XNODE, batch: PathBatch, problem,
                                  cfg: SolverConfig,
                                  basis: Optional[torch.Tensor] = None):
    """``u [N, L]`` and ``grad_x u [N, L, D]``: :func:`apply_xnode` with the
    tangents carried through the integrator as a :class:`Jet`
    (:func:`field_jvp`), so that remat recomputes each interval of the u
    side too (a recompute cannot run inside ``torch.func.jvp``). The
    directions are the rows of ``basis [D, d]``, by default the d
    coordinate directions (a rank of a tangent group carries its slice,
    ``ops/weak_form.py::tangent_basis``). The start state and the features
    take their tangents by ``torch.func.jvp``, all D directions in one
    ``vmap``. The values are those of forward mode through
    :func:`apply_xnode`; ``u`` is :func:`apply_xnode`'s."""
    xs = batch.space[:, 0, :]
    if basis is None:
        basis = torch.eye(xs.shape[-1], dtype=xs.dtype, device=xs.device)
    seed_of = path_seed_fn(batch, problem, cfg)

    def start(x):
        return (lift_apply(params, seed_of(x)[:, None]),
                spatial_features(x, cfg.fourier_features))

    def one(e):
        return torch.func.jvp(start, (xs,), (e.expand_as(xs),))

    (h0, xs_f), (dh0, dxs_f) = torch.func.vmap(one, out_dims=(None, 0))(
        basis)
    feats = Jet(xs_f, dxs_f)

    def field(t, h):
        return field_jvp(params, feats, t, h)

    hs = _integrate(cfg, field, Jet(h0, dh0), batch,
                    (xs_f, dxs_f, *field_weights(params)))
    scale = cfg.u_scale_eff
    u = params.readout(hs.p)[..., 0] * scale
    du = F.linear(hs.t, params.readout.weight)[..., 0] * scale   # [D, N, L]
    return u, torch.movedim(du, 0, -1)


def apply_xnode_adjoint(params: XNODE, batch: PathBatch, problem,
                        cfg: SolverConfig) -> torch.Tensor:
    """:func:`apply_xnode` whose backward is the continuous adjoint
    (``ops/adjoint.py``, the reference's ``odeint_adjoint``): the adjoint
    ODE integrated backward in time, O(1) activations in the substeps,
    gradients exact only up to discretization error (JAX
    ``models/xnode.py:150-188``). The forward is :func:`apply_xnode`'s
    without remat, value for value. Cotangents reach the field's
    parameters, the features and the start state, so the lift, the seed
    and the readout get theirs by autograd. For reverse-mode consumers:
    the weak-form u side needs forward mode, so ``adjoint: true`` in a
    config means remat. Raises for the adaptive and multistep solvers."""
    if cfg.solver not in FUSED_KERNEL_METHODS:
        raise ValueError(
            "continuous adjoint supports the fixed-step RK methods "
            f"{FUSED_KERNEL_METHODS}, not {cfg.solver!r}")
    xs = batch.space[:, 0, :]
    seed = path_seed_fn(batch, problem, cfg)(xs)[:, None]
    h0 = lift_apply(params, seed)
    xs_f = spatial_features(xs, cfg.fourier_features)
    run = make_adjoint_integrator(field_apply_weights, cfg.n_sub, cfg.solver)
    hs = run(field_weights(params), xs_f, h0, batch.times,
             batch.t_start.to(h0.dtype), batch.mask)
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
    (``csrc/xnode_fwd.cu``); otherwise the masked scan, as the JAX
    package does for x64 and the Adams methods.

    ``mesh`` (a ``parallel.mesh.Mesh``): every rank serves its share of
    the points, the mesh collapsed to one data group as in JAX
    (``models/xnode.py:215-227``), and the shares are gathered; each
    point's value is the one a single process gives it.
    """
    if mesh is not None and mesh.size > 1:
        return serve_sharded(evaluate_points, mesh, params, pts, problem,
                             cfg, k_steps=k_steps, domain=domain)
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
