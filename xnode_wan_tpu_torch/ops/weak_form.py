"""Weak-form adversarial loss: a Monte-Carlo estimate of <A[u], v w> and
the log-ratio min-max objectives.

Port of ``xnode_wan_tpu/ops/weak_form.py`` (reference ``src/loss.py:12-96``),
with the same deliberate deviations from the reference: pointwise
``grad_x u`` by forward mode through the integrator (or the fused
kernels), u and v on one shared cloud, one masked global quadrature, and
the initial-value penalty on h-seeded paths only. Terms:

* ``s1``: ``V (u_T phi_T - h phi_0) / N``, at each path's first and last
  valid sample (``loss.py:64``);
* ``s2``: ``V u d_t(phi) / M`` (``:65``);
* ``s3``: diffusion, drift, reaction and source against ``phi``
  (``:66-70``);
* ``I = s1 - s2 + s3``; ``int = log max(I^2, eps) - log max(V sum v^2 / M,
  eps)``; ``loss_u = int + alpha (init + bdry)``, ``loss_v = -int``.

On the moving domains (``group_loss``, the default) ``int`` is the sum of
one such log ratio per exit group (:func:`grouped_interior_objective`),
each group's sums taken in a fixed order.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import torch

from xnode_wan_tpu_torch.config import SolverConfig
from xnode_wan_tpu_torch.ops.coefficients import diffusion_term, drift_term
from xnode_wan_tpu_torch.ops.kernels.disc_train import (check_fits, geom_of,
                                                        v_dv_fused,
                                                        v_fused_fits)
from xnode_wan_tpu_torch.ops.kernels.steppers import FUSED_KERNEL_METHODS
from xnode_wan_tpu_torch.ops.sampling import PathBatch, _assemble

_EPS = 1e-12


def fused_gate(cfg: SolverConfig) -> bool:
    """Whether the u side runs through the fused training kernels
    (``ops/kernels/xnode_train.py::u_du_fused``). Shared by the loss
    builder and the trainer's metric forward so the two cannot drift. The
    exclusions are the JAX package's: the WAN primal, ``fused_grad: false``,
    f64 parity runs, adaptive and multistep solvers, ensembles. On CUDA
    tensors the wrappers launch the kernels; on CPU tensors they take
    their plain versions."""
    return (cfg.primal == "xnode" and cfg.fused_grad and not cfg.x64
            and cfg.solver in FUSED_KERNEL_METHODS and cfg.ensemble == 1)


def fused_v_gate(cfg: SolverConfig) -> bool:
    """Whether the adversary side may run through kernels #6 and #7
    (``ops/kernels/disc_train.py``): the opt-in ``fused_v``, as in the JAX
    package (``weak_form.py:401-402``) without its mesh and TPU terms.
    ``make_losses`` also asks ``v_fused_fits`` of the discriminator's
    shapes: over the kernels' caps CPU tensors take the plain side, and
    any other device raises."""
    return cfg.fused_v and cfg.fused_grad and not cfg.x64


def u_with_spatial_grad(u_apply: Callable, u_params, batch: PathBatch,
                        problem, cfg: SolverConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``u [N, L]`` and ``grad_x u [N, L, d]`` by forward mode through
    ``u_apply`` (the masked scan), one ``torch.func.jvp`` per coordinate
    direction. Differentiable in the parameters by reverse mode."""
    xs0 = batch.space[:, 0, :]

    def u_of(xs):
        b = dataclasses.replace(batch, x=_assemble(batch.times, xs))
        return u_apply(u_params, b, problem, cfg)

    u, dus = None, []
    for e in torch.eye(xs0.shape[-1], dtype=xs0.dtype, device=xs0.device):
        u, du = torch.func.jvp(u_of, (xs0,), (e.expand_as(xs0),))
        dus.append(du)
    return u, torch.stack(dus, dim=-1)


def v_phi_and_grads(v_apply: Callable, v_params, pts: torch.Tensor,
                    func_w: Callable
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``v [N, L]``, ``phi = v w [N, L]`` and the pointwise ``(d_t,
    grad_x) phi [N, L, C]`` at ``pts [N, L, C]``. With gradients enabled
    the input gradient keeps its graph (``create_graph``), because
    ``loss_v`` differentiates through it; under ``torch.no_grad()`` the
    outputs carry no graph."""
    n, l, c = pts.shape
    keep_graph = torch.is_grad_enabled()
    flat = pts.reshape(-1, c).detach().requires_grad_(True)
    with torch.enable_grad():
        v = v_apply(v_params, flat)
        phi = v * func_w(flat)
        (dphi,) = torch.autograd.grad(phi.sum(), flat, create_graph=keep_graph)
    if not keep_graph:
        v, phi = v.detach(), phi.detach()
    return v.reshape(n, l), phi.reshape(n, l), dphi.reshape(n, l, c)


def v_phi_grads_fused(v_params, pts: torch.Tensor, func_w: Callable,
                      cfg: SolverConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused-kernel counterpart of :func:`v_phi_and_grads` (JAX
    ``weak_form.py:152-175``): ``v`` and its space-time gradient from
    ``disc_train.v_dv_fused`` (kernels #6 and #7), then ``phi = v w`` and
    ``grad phi = w grad v + v grad w``. The cutoff ``w`` and its gradient
    are sample data, taken by autograd on the points with no graph kept;
    the parameter gradient flows through the kernels' backward only."""
    n, l, c = pts.shape
    flat = pts.reshape(-1, c).detach()
    v, dv = v_dv_fused(v_params, flat, v_layers=cfg.v_layers,
                       tied=cfg.tied_v, n_freq=cfg.v_fourier_features)
    with torch.enable_grad():
        p = flat.detach().requires_grad_(True)
        w = func_w(p)
        (dw,) = torch.autograd.grad(w.sum(), p)
    w = w.detach()
    phi = v * w
    dphi = dv * w[:, None] + v[:, None] * dw
    return v.reshape(n, l), phi.reshape(n, l), dphi.reshape(n, l, c)


def _endpoint_indices(mask: torch.Tensor):
    """Per-path first/last valid time index and row validity."""
    l = mask.shape[1]
    m = mask.to(torch.int8)
    first = torch.argmax(m, dim=1)
    last = l - 1 - torch.argmax(torch.flip(m, dims=[1]), dim=1)
    return first, last, mask.any(dim=1)


def interior_terms(u, du, v, phi, dphi, batch: PathBatch, problem, domain,
                   s1_raw_v: bool = False):
    """The operator estimate ``I`` and the test norm ``V sum v^2 / M``.
    ``s1_raw_v`` pairs the temporal-boundary term with the raw ``v`` as
    the reference does (``loss.py:64``), instead of ``phi``."""
    dtype = u.dtype
    m = batch.mask.to(dtype)
    big_m = torch.clamp(m.sum(), min=1.0)
    vol = domain.V()

    first, last, row_valid = _endpoint_indices(batch.mask)
    rows = torch.arange(u.shape[0], device=u.device)
    rv = row_valid.to(dtype)
    n_valid = torch.clamp(rv.sum(), min=1.0)

    first_pts = batch.x[rows, first]
    init_vals = torch.where(batch.seed_from_h, problem.h(first_pts),
                            problem.g(first_pts))
    tf = v if s1_raw_v else phi
    s1 = u[rows, last] * tf[rows, last] - init_vals * tf[rows, first]
    s1 = vol * torch.sum(s1 * rv) / n_valid

    s2 = vol * torch.sum(u * dphi[..., 0] * m) / big_m

    X = batch.x
    s3f = (diffusion_term(problem, X, dphi[..., 1:], du)
           + drift_term(problem, X, phi, du)
           + problem.c(X, u) * u * phi + problem.f(X) * phi)
    s3 = vol * torch.sum(s3f * m) / big_m

    current = s1 - s2 + s3
    norm = vol * torch.sum(v * v * m) / big_m
    return current, norm


def init_loss(u, batch: PathBatch, problem, all_rows: bool = False):
    """``mean (u(t_first, x) - h(x))^2`` over h-seeded valid paths (all
    valid paths with ``all_rows``, the reference's form)."""
    first, _, row_valid = _endpoint_indices(batch.mask)
    rows = torch.arange(u.shape[0], device=u.device)
    h_vals = problem.h(batch.x[rows, first])
    w_rows = row_valid if all_rows else (batch.seed_from_h & row_valid)
    w = w_rows.to(u.dtype)
    sq = (u[rows, first] - h_vals) ** 2
    return torch.sum(sq * w) / torch.clamp(w.sum(), min=1.0)


def bdry_from_values(u_b, bbatch: PathBatch, problem, at_exit: bool = False):
    """Boundary penalty from ``u(BX) [N, L]`` (``loss.py:83-85``); with
    ``at_exit`` only at each path's last valid sample."""
    if at_exit:
        _, last, row_valid = _endpoint_indices(bbatch.mask)
        rows = torch.arange(u_b.shape[0], device=u_b.device)
        g_vals = problem.g(bbatch.x[rows, last])
        w = row_valid.to(u_b.dtype)
        sq = (u_b[rows, last] - g_vals) ** 2
        return torch.sum(sq * w) / torch.clamp(w.sum(), min=1.0)
    m = bbatch.mask.to(u_b.dtype)
    return (torch.sum((u_b - problem.g(bbatch.x)) ** 2 * m)
            / torch.clamp(m.sum(), min=1.0))


def bdry_loss(u_apply: Callable, u_params, bbatch: PathBatch, problem,
              cfg: SolverConfig, at_exit: bool = False):
    """``mean (u(BX) - g(BX))^2`` through ``u_apply`` (the plain masked
    scan, differentiated by autograd)."""
    return bdry_from_values(u_apply(u_params, bbatch, problem, cfg), bbatch,
                            problem, at_exit=at_exit)


def _bin_sums(vals: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """Per-bin sums of ``vals [N]`` over ``onehot [N, B]``: a reduction
    over N, which takes the same order in every run (a scatter-add takes
    the order of its atomics on CUDA, and so differs from run to run)."""
    return (onehot * vals[:, None]).sum(dim=0)


def grouped_interior_objective(u, du, v, phi, dphi, batch: PathBatch,
                               problem, domain, s1_raw_v: bool = False):
    """Per-exit-group log-ratio objective (JAX ``weak_form.py:285-345``).

    The reference takes a separate ``log I_g^2 - log norm_g`` per ragged
    path group, one group per boundary-exit time (``src/training.py:
    128-137``, ``src/loss.py:87-90``), so the adversary faces one residual
    channel per group. Here a path's group is its last valid time index
    (``L`` bins, dead rows in an overflow bin), with the weights ``V / (N_g
    L_n)`` of the reference's ``V / (N_g L_g)``. On the hypercube every
    path is in bin ``L - 1`` and this is the pooled objective.

    Returns ``(int_loss, I_total, norm_total)``.
    """
    dtype = u.dtype
    l = u.shape[1]
    m = batch.mask.to(dtype)
    vol = domain.V()

    first, last, row_valid = _endpoint_indices(batch.mask)
    rows = torch.arange(u.shape[0], device=u.device)
    rv = row_valid.to(dtype)
    seg = torch.where(row_valid, last, torch.full_like(last, l))
    onehot = torch.nn.functional.one_hot(seg, l + 1).to(dtype)
    n_g = _bin_sums(rv, onehot)[:l]
    occupied = n_g > 0
    n_g = torch.clamp(n_g, min=1.0)
    l_n = torch.clamp(m.sum(dim=1), min=1.0)   # per-path valid count

    first_pts = batch.x[rows, first]
    # h for T0-seeded rows, g(t_re, x) for the g-seeded re-entry rows
    init_vals = torch.where(batch.seed_from_h, problem.h(first_pts),
                            problem.g(first_pts))
    tf = v if s1_raw_v else phi
    s1_n = (u[rows, last] * tf[rows, last]
            - init_vals * tf[rows, first]) * rv

    X = batch.x
    s3f = (diffusion_term(problem, X, dphi[..., 1:], du)
           + drift_term(problem, X, phi, du)
           + problem.c(X, u) * u * phi + problem.f(X) * phi)
    s23_n = torch.sum((s3f - u * dphi[..., 0]) * m, dim=1) / l_n   # [N]
    v2_n = torch.sum(v * v * m, dim=1) / l_n

    i_g = vol * _bin_sums(s1_n + s23_n * rv, onehot)[:l] / n_g
    norm_g = vol * _bin_sums(v2_n * rv, onehot)[:l] / n_g

    per_g = (torch.log(torch.clamp(i_g ** 2, min=_EPS))
             - torch.log(torch.clamp(norm_g, min=_EPS)))
    zero = torch.zeros_like(per_g)
    return (torch.where(occupied, per_g, zero).sum(),
            torch.where(occupied, i_g, zero).sum(),
            torch.where(occupied, norm_g, zero).sum())


class WeakFormLosses(NamedTuple):
    """The two objectives and their hoisted split forms: inside one outer
    iteration the adversary side ``(v, phi, grad phi)`` is constant across
    the ``n1`` primal steps and the primal side ``(u, grad u)`` across the
    ``n2`` adversary steps, so the trainer computes each once and
    differentiates only the dependent half."""
    loss_u: Callable        # (u_params, v_params, batch, bbatch)
    loss_v: Callable        # (v_params, u_params, batch)
    v_side: Callable        # (v_params, batch) -> (v, phi, dphi)
    loss_u_vside: Callable  # (u_params, vside, batch, bbatch) -> (loss, aux)
    u_side: Callable        # (u_params, batch) -> (u, du)
    loss_v_uside: Callable  # (v_params, uside, batch) -> (loss, aux)


def make_losses(problem, domain, cfg: SolverConfig, u_apply: Callable,
                v_apply: Callable) -> WeakFormLosses:
    """Build the two objectives; each returns ``(loss, aux_dict)``."""
    use_fused = fused_gate(cfg)
    use_fused_v = fused_v_gate(cfg)
    bdry_at_exit = bool(getattr(domain, "boundary_at_exit", False))

    def u_side(u_params, batch):
        if use_fused:
            from xnode_wan_tpu_torch.ops.kernels.xnode_train import \
                fused_from_batch
            return fused_from_batch(u_params, batch, problem, cfg)
        return u_with_spatial_grad(u_apply, u_params, batch, problem, cfg)

    def v_side(v_params, batch):
        if use_fused_v:
            if v_fused_fits(v_params, cfg.v_layers, cfg.tied_v):
                return v_phi_grads_fused(v_params, batch.x, domain.func_w,
                                         cfg)
            # over the caps only CPU tensors take the plain side
            if batch.x.device.type != "cpu":
                check_fits(geom_of(v_params, cfg.v_layers, cfg.tied_v))
        return v_phi_and_grads(v_apply, v_params, batch.x, domain.func_w)

    # the hypercube's paths all share one exit group: the grouped
    # objective is the pooled one there, so the pooled form is taken
    grouped = cfg.group_loss and not getattr(domain, "single_exit_group",
                                             False)

    def int_from_sides(u, du, vside, batch):
        v, phi, dphi = vside
        if grouped:
            int_loss, current, norm = grouped_interior_objective(
                u, du, v, phi, dphi, batch, problem, domain,
                s1_raw_v=cfg.s1_raw_v)
        else:
            current, norm = interior_terms(u, du, v, phi, dphi, batch,
                                           problem, domain,
                                           s1_raw_v=cfg.s1_raw_v)
            int_loss = (torch.log(torch.clamp(current ** 2, min=_EPS))
                        - torch.log(torch.clamp(norm, min=_EPS)))
        return int_loss, {"I": current, "norm": norm, "int": int_loss}

    def loss_u_vside(u_params, vside, batch, bbatch):
        u, du = u_side(u_params, batch)
        int_loss, aux = int_from_sides(u, du, vside, batch)
        init = init_loss(u, batch, problem, all_rows=cfg.init_all_rows)
        # the boundary term stays on the plain masked scan, as in the JAX
        # package (weak_form.py:487-494)
        bdry = bdry_loss(u_apply, u_params, bbatch, problem, cfg,
                         at_exit=bdry_at_exit)
        total = int_loss + cfg.alpha * (init + bdry)
        return total, dict(aux, init=init, bdry=bdry, loss_u=total)

    def loss_v_uside(v_params, uside, batch):
        u, du = uside
        int_loss, aux = int_from_sides(u, du, v_side(v_params, batch), batch)
        return -int_loss, dict(aux, loss_v=-int_loss)

    def loss_u(u_params, v_params, batch, bbatch):
        return loss_u_vside(u_params, v_side(v_params, batch), batch, bbatch)

    def loss_v(v_params, u_params, batch):
        return loss_v_uside(v_params, u_side(u_params, batch), batch)

    return WeakFormLosses(loss_u, loss_v, v_side, loss_u_vside, u_side,
                          loss_v_uside)
