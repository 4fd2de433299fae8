"""Weak-form adversarial loss: a Monte-Carlo estimate of <A[u], v w> and
the log-ratio min-max objectives.

Port of ``xnode_wan_tpu/ops/weak_form.py`` (reference ``src/loss.py:12-96``),
with the same deliberate deviations from the reference: pointwise
``grad_x u`` by forward mode through the integrator (or the fused
kernels), u and v on one shared cloud (with ``independent_uv``, v on its
own interior cloud, paired elementwise, as the reference does), one
masked global quadrature, and the initial-value penalty on h-seeded
paths only. Terms:

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

On a mesh (``parallel/mesh.py``) each rank holds its shard of the paths,
and every sum over paths that feeds a clamp, a division or a log is the
global one (``group=``, :func:`parallel.mesh.global_sum`); with
``tangent_shards`` each rank of a tangent group carries its slice of the d
directions of ``grad_x u`` (:func:`u_with_spatial_grad`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import torch

from xnode_wan_tpu_torch.config import SolverConfig
from xnode_wan_tpu_torch.models.xnode import apply_xnode_with_spatial_grad
from xnode_wan_tpu_torch.ops.coefficients import diffusion_term, drift_term
from xnode_wan_tpu_torch.ops.kernels.disc_train import (disc_route, geom_of,
                                                        v_dv_fused,
                                                        v_fused_fits)
from xnode_wan_tpu_torch.ops.kernels.steppers import FUSED_KERNEL_METHODS
from xnode_wan_tpu_torch.ops.sampling import PathBatch, _assemble
from xnode_wan_tpu_torch.parallel.mesh import (gather_slices, global_sum,
                                               tangent_count, tangent_shard)

_EPS = 1e-12


def kernel_gate(cfg: SolverConfig) -> bool:
    """Whether the primal's tangentless forward, the fresh-sample metric,
    runs through kernel #2 (``ops/kernels/xnode_train.py::
    u_forward_fused``): the XNODE primal, ``fused_grad``, f32, and a
    solver of ``FUSED_KERNEL_METHODS``. No mesh term: a rank computes it
    on its own rows, which is one process's work on fewer rows."""
    return (cfg.primal == "xnode" and cfg.fused_grad and not cfg.x64
            and cfg.solver in FUSED_KERNEL_METHODS)


def fused_gate(cfg: SolverConfig, mesh=None) -> bool:
    """Whether the u side runs through the fused training kernels
    (``ops/kernels/xnode_train.py::u_du_fused``). Shared by the loss
    builder and the trainer so the two cannot drift. The exclusions are
    the JAX package's: the WAN primal, ``fused_grad: false``, f64 parity
    runs, adaptive and multistep solvers (:func:`kernel_gate`), and a
    ``tangent`` axis of more than one rank, whose ranks each carry a slice
    of the d directions that the kernels compute whole. Ensembles take
    the kernels, with a mesh or without: a rank steps one member at a
    time on its own rows, so each launch sees one member's shapes (JAX
    excludes them because its vmapped member axis overflowed the TPU's
    scoped VMEM, and for shard_map composition; neither applies here). On
    CUDA tensors the wrappers launch the kernels; on CPU tensors they take
    their plain versions."""
    return kernel_gate(cfg) and tangent_count(mesh) == 1


def fused_v_gate(cfg: SolverConfig) -> bool:
    """Whether the adversary side may run through kernels #6 and #7
    (``ops/kernels/disc_train.py``): the opt-in ``fused_v``, f32 and
    ``fused_grad``, as in the JAX package (``weak_form.py:401-402``)
    without its TPU term. No mesh term: the adversary reads no tangent of
    u, and a rank of any mesh runs it on its own rows. ``make_losses``
    also asks ``v_fused_fits`` of the discriminator's shapes: past the
    JAX package's Pallas bound (``F + v_hidden_dim (2 v_layers + 4) + 2 <=
    12,288``, ``disc_train.disc_route``) CPU tensors take the plain side,
    and any other device raises."""
    return cfg.fused_v and cfg.fused_grad and not cfg.x64


def tangent_basis(d: int, dtype, device, tangent=None) -> torch.Tensor:
    """The coordinate directions a rank carries: all d, or with
    ``tangent = (group, index, count)`` the ``index``-th of ``count`` equal
    slices of ``ceil(d / count)`` directions, the last padded with zero
    directions."""
    eye = torch.eye(d, dtype=dtype, device=device)
    if tangent is None:
        return eye
    _, index, count = tangent
    width = -(-d // count)
    rows = eye[index * width:(index + 1) * width]
    pad = rows.new_zeros((width - rows.shape[0], d))
    return torch.cat([rows, pad])


def u_with_spatial_grad(u_apply: Callable, u_params, batch: PathBatch,
                        problem, cfg: SolverConfig, tangent=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``u [N, L]`` and ``grad_x u [N, L, d]`` by forward mode through
    ``u_apply`` (the masked scan, or the WAN's MLP): one
    ``torch.func.jvp`` for each coordinate direction, all d in one
    ``torch.func.vmap``, as the JAX package's one vmapped ``jax.jvp``
    (one jvp a direction costs d times the host's launches). The primal
    rides along in each direction; the first copy is returned.
    Differentiable in the parameters by reverse mode.

    The XNODE carries its tangents through the integrator instead
    (:func:`models.xnode.apply_xnode_with_spatial_grad`): under remat (the
    default) a checkpointed interval cannot run inside ``torch.func.jvp``,
    and without it the explicit tangents take a fraction of the host's
    launches. Same values.

    ``tangent = (group, index, count)`` (``tangent_shards``, JAX
    ``weak_form.py:68-97``): this rank carries its slice of the directions
    (:func:`tangent_basis`) and the slices are gathered along the group,
    each rank's gradient flowing into its own slice only."""
    xs0 = batch.space[:, 0, :]
    d = xs0.shape[-1]
    basis = tangent_basis(d, xs0.dtype, xs0.device, tangent)
    if cfg.primal == "xnode":
        u, du = apply_xnode_with_spatial_grad(u_params, batch, problem, cfg,
                                              basis=basis)
    else:
        def u_of(xs):
            b = dataclasses.replace(batch, x=_assemble(batch.times, xs))
            return u_apply(u_params, b, problem, cfg)

        def one(e):
            return torch.func.jvp(u_of, (xs0,), (e.expand_as(xs0),))

        u_rep, du = torch.func.vmap(one)(basis)
        u, du = u_rep[0], torch.movedim(du, 0, -1)
    if tangent is not None:
        du = gather_slices(du, tangent[0], dim=-1)[..., :d]
    return u, du


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
                   s1_raw_v: bool = False, group=None):
    """The operator estimate ``I`` and the test norm ``V sum v^2 / M``.
    ``s1_raw_v`` pairs the temporal-boundary term with the raw ``v`` as
    the reference does (``loss.py:64``), instead of ``phi``. ``group``:
    the data group whose paths the sums run over (None: this rank's)."""
    dtype = u.dtype
    m = batch.mask.to(dtype)
    big_m = torch.clamp(global_sum(m.sum(), group), min=1.0)
    vol = domain.V()

    first, last, row_valid = _endpoint_indices(batch.mask)
    rows = torch.arange(u.shape[0], device=u.device)
    rv = row_valid.to(dtype)
    n_valid = torch.clamp(global_sum(rv.sum(), group), min=1.0)

    first_pts = batch.x[rows, first]
    init_vals = torch.where(batch.seed_from_h, problem.h(first_pts),
                            problem.g(first_pts))
    tf = v if s1_raw_v else phi
    s1 = u[rows, last] * tf[rows, last] - init_vals * tf[rows, first]
    s1 = vol * global_sum(torch.sum(s1 * rv), group) / n_valid

    s2 = vol * global_sum(torch.sum(u * dphi[..., 0] * m), group) / big_m

    X = batch.x
    s3f = (diffusion_term(problem, X, dphi[..., 1:], du)
           + drift_term(problem, X, phi, du)
           + problem.c(X, u) * u * phi + problem.f(X) * phi)
    s3 = vol * global_sum(torch.sum(s3f * m), group) / big_m

    current = s1 - s2 + s3
    norm = vol * global_sum(torch.sum(v * v * m), group) / big_m
    return current, norm


def init_loss(u, batch: PathBatch, problem, all_rows: bool = False,
              group=None):
    """``mean (u(t_first, x) - h(x))^2`` over h-seeded valid paths (all
    valid paths with ``all_rows``, the reference's form)."""
    first, _, row_valid = _endpoint_indices(batch.mask)
    rows = torch.arange(u.shape[0], device=u.device)
    h_vals = problem.h(batch.x[rows, first])
    w_rows = row_valid if all_rows else (batch.seed_from_h & row_valid)
    w = w_rows.to(u.dtype)
    sq = (u[rows, first] - h_vals) ** 2
    return (global_sum(torch.sum(sq * w), group)
            / torch.clamp(global_sum(w.sum(), group), min=1.0))


def bdry_from_values(u_b, bbatch: PathBatch, problem, at_exit: bool = False,
                     group=None):
    """Boundary penalty from ``u(BX) [N, L]`` (``loss.py:83-85``); with
    ``at_exit`` only at each path's last valid sample."""
    if at_exit:
        _, last, row_valid = _endpoint_indices(bbatch.mask)
        rows = torch.arange(u_b.shape[0], device=u_b.device)
        g_vals = problem.g(bbatch.x[rows, last])
        w = row_valid.to(u_b.dtype)
        sq = (u_b[rows, last] - g_vals) ** 2
        return (global_sum(torch.sum(sq * w), group)
                / torch.clamp(global_sum(w.sum(), group), min=1.0))
    m = bbatch.mask.to(u_b.dtype)
    return (global_sum(torch.sum((u_b - problem.g(bbatch.x)) ** 2 * m), group)
            / torch.clamp(global_sum(m.sum(), group), min=1.0))


def bdry_loss(u_apply: Callable, u_params, bbatch: PathBatch, problem,
              cfg: SolverConfig, at_exit: bool = False, group=None):
    """``mean (u(BX) - g(BX))^2`` through ``u_apply`` (the plain masked
    scan, differentiated by autograd)."""
    return bdry_from_values(u_apply(u_params, bbatch, problem, cfg), bbatch,
                            problem, at_exit=at_exit, group=group)


def _bin_sums(vals: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """Per-bin sums of ``vals [N]`` over ``onehot [N, B]``: a reduction
    over N, which takes the same order in every run (a scatter-add takes
    the order of its atomics on CUDA, and so differs from run to run)."""
    return (onehot * vals[:, None]).sum(dim=0)


def grouped_interior_objective(u, du, v, phi, dphi, batch: PathBatch,
                               problem, domain, s1_raw_v: bool = False,
                               group=None):
    """Per-exit-group log-ratio objective (JAX ``weak_form.py:285-345``).

    The reference takes a separate ``log I_g^2 - log norm_g`` per ragged
    path group, one group per boundary-exit time (``src/training.py:
    128-137``, ``src/loss.py:87-90``), so the adversary faces one residual
    channel per group. Here a path's group is its last valid time index
    (``L`` bins, dead rows in an overflow bin), with the weights ``V / (N_g
    L_n)`` of the reference's ``V / (N_g L_g)``. On the hypercube every
    path is in bin ``L - 1`` and this is the pooled objective.

    Returns ``(int_loss, I_total, norm_total)``; ``group`` as in
    :func:`interior_terms`.
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
    n_g = global_sum(_bin_sums(rv, onehot)[:l], group)
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

    i_g = vol * global_sum(_bin_sums(s1_n + s23_n * rv, onehot)[:l],
                           group) / n_g
    norm_g = vol * global_sum(_bin_sums(v2_n * rv, onehot)[:l], group) / n_g

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
    loss_u: Callable        # (u_params, v_params, batch, bbatch, vbatch=None)
    loss_v: Callable        # (v_params, u_params, batch, vbatch=None)
    v_side: Callable        # (v_params, batch, vbatch=None) -> (v, phi, dphi)
    loss_u_vside: Callable  # (u_params, vside, batch, bbatch) -> (loss, aux)
    u_side: Callable        # (u_params, batch) -> (u, du)
    loss_v_uside: Callable  # (v_params, uside, batch, vbatch=None) -> (loss, aux)


def make_losses(problem, domain, cfg: SolverConfig, u_apply: Callable,
                v_apply: Callable, mesh=None) -> WeakFormLosses:
    """Build the two objectives; each returns ``(loss, aux_dict)``.

    On a ``mesh`` the batches are this rank's rows and the sums run over
    the data group. With a tangent axis every rank of a tangent group
    computes the same ``u``, so only its first rank lets ``u`` (and the
    boundary term) into the primal's gradient; the others contribute
    their slice of ``grad_x u`` alone, and the trainer's one sum of the
    gradients over the ranks then counts every part once."""
    use_fused = fused_gate(cfg, mesh)
    use_fused_v = fused_v_gate(cfg)
    bdry_at_exit = bool(getattr(domain, "boundary_at_exit", False))
    group = None if mesh is None else mesh.group(cfg.data_axis)
    tangent = tangent_shard(mesh)
    owns_u = tangent is None or tangent[1] == 0

    def u_side(u_params, batch):
        if use_fused:
            # in tangent chunks where #3-#5's full-d tiles do not fit
            # (JAX's fused_chunk rule, without its opt-in: no XLA route)
            from xnode_wan_tpu_torch.ops.kernels.xnode_train import \
                fused_from_batch
            return fused_from_batch(u_params, batch, problem, cfg)
        return u_with_spatial_grad(u_apply, u_params, batch, problem, cfg,
                                   tangent=tangent)

    def v_side(v_params, batch, vbatch=None):
        # independent_uv: the v side on its own interior cloud, paired
        # elementwise with the u side on batch (reference src/loss.py:51-70)
        v_pts = batch.x if vbatch is None else vbatch.x
        if use_fused_v:
            if v_fused_fits(v_params, cfg.v_layers, cfg.tied_v):
                return v_phi_grads_fused(v_params, v_pts, domain.func_w, cfg)
            # past the Pallas bound only CPU tensors take the plain side
            if v_pts.device.type != "cpu":
                disc_route(geom_of(v_params, cfg.v_layers, cfg.tied_v))
        return v_phi_and_grads(v_apply, v_params, v_pts, domain.func_w)

    # the hypercube's paths all share one exit group: the grouped
    # objective is the pooled one there, so the pooled form is taken
    grouped = cfg.group_loss and not getattr(domain, "single_exit_group",
                                             False)

    def int_from_sides(u, du, vside, batch):
        v, phi, dphi = vside
        if grouped:
            int_loss, current, norm = grouped_interior_objective(
                u, du, v, phi, dphi, batch, problem, domain,
                s1_raw_v=cfg.s1_raw_v, group=group)
        else:
            current, norm = interior_terms(u, du, v, phi, dphi, batch,
                                           problem, domain,
                                           s1_raw_v=cfg.s1_raw_v, group=group)
            int_loss = (torch.log(torch.clamp(current ** 2, min=_EPS))
                        - torch.log(torch.clamp(norm, min=_EPS)))
        return int_loss, {"I": current, "norm": norm, "int": int_loss}

    def loss_u_vside(u_params, vside, batch, bbatch):
        u, du = u_side(u_params, batch)
        if not owns_u:
            u = u.detach()
        int_loss, aux = int_from_sides(u, du, vside, batch)
        init = init_loss(u, batch, problem, all_rows=cfg.init_all_rows,
                         group=group)
        # the boundary term stays on the plain masked scan, as in the JAX
        # package (weak_form.py:487-494)
        with torch.set_grad_enabled(owns_u and torch.is_grad_enabled()):
            bdry = bdry_loss(u_apply, u_params, bbatch, problem, cfg,
                             at_exit=bdry_at_exit, group=group)
        total = int_loss + cfg.alpha * (init + bdry)
        return total, dict(aux, init=init, bdry=bdry, loss_u=total)

    def loss_v_uside(v_params, uside, batch, vbatch=None):
        u, du = uside
        int_loss, aux = int_from_sides(u, du, v_side(v_params, batch, vbatch),
                                       batch)
        return -int_loss, dict(aux, loss_v=-int_loss)

    def loss_u(u_params, v_params, batch, bbatch, vbatch=None):
        return loss_u_vside(u_params, v_side(v_params, batch, vbatch), batch,
                            bbatch)

    def loss_v(v_params, u_params, batch, vbatch=None):
        return loss_v_uside(v_params, u_side(u_params, batch), batch, vbatch)

    return WeakFormLosses(loss_u, loss_v, v_side, loss_u_vside, u_side,
                          loss_v_uside)
