"""The XNODE-WAN solver: alternating primal / adversarial Adam training.

Port of ``xnode_wan_tpu/training.py`` (reference ``src/training.py:54-187``).
One outer iteration (:meth:`NODEWANSolver._outer_step`)
samples the domain's interior and boundary from the state's
``torch.Generator``, takes ``n1`` primal Adam steps on ``loss_u`` (the u
side through the fused kernels #4 and #5), ``n2`` adversary steps on
``loss_v`` (the u side once more through kernel #3, undifferentiated), and
scores the primal on a fresh interior draw (kernel #2). With ``fused_v``
the adversary side ``(v, phi, grad phi)`` comes from kernels #6 and #7
(``ops/kernels/disc_train.py``). PyTorch runs eagerly, so the JAX
package's compiled ``lax.scan`` / ``while_loop`` dispatch becomes a Python
loop; the stop criterion is read every iteration.

The domain comes from :func:`ops.sampling.make_domain`: the hypercube, or
the moving domains ``NSphere_TCone`` and ``NSphere_THourglass``, whose
paths die as the boundary passes them (the hourglass adds ``N_r``
g-seeded re-entry rows) and whose loss is the per-exit-group objective
under ``group_loss``; ``qmc: halton`` draws every cloud from a randomized
Halton set (``ops/qmc.py``).

The primal is the XNODE or, with ``primal: wan``, the plain MLP of
``models/wan.py`` (:data:`PRIMAL_MODELS`); only the XNODE runs through
kernels #1-#5. ``independent_uv`` evaluates the adversary side on a
second interior draw of the same generator. ``ensemble: K`` trains K
members, each with its own networks, Adam moments, generator (seeded
from ``SeedSequence([seed, k])``) and Polyak average; an outer iteration
steps them in turn through the kernels, one member a launch, where JAX
vmaps the members on XLA, and reports the best member's metrics
(:meth:`NODEWANSolver._ensemble_step`).

:meth:`NODEWANSolver.train` is the CLI's loop (``main.py``): it logs every
iteration (``utils/logging.py``), keeps the best weights by ``loss_u`` in
``best_model_weights_NODE.pth``, plots the solution's slice at each report
step (``utils/viz.py``) and writes the full state to
``checkpoint_NODE.pt`` (``utils/checkpoint.py``), which
:meth:`NODEWANSolver.load_checkpoint` resumes from. It runs ``train_chunk``
iterations back to back (:meth:`NODEWANSolver._run_chunk`: the metrics
stay on the device until the chunk ends, the best weights are tracked
there) and, when the stop fires inside a chunk, replays from the chunk's
snapshot to the stop iteration, so that its records, best weights and
checkpoint are those of one iteration at a time; ``train_chunked`` is the
same loop without reports. ``profile_dir`` traces iterations [3, 8) with
``torch.profiler``.

:meth:`NODEWANSolver.train_until` trains to a rel-L^p tolerance with the
JAX package's refinement recipes: on a window that shows no significant
progress (:func:`_window_stalled`) it drops both learning rates
(:meth:`NODEWANSolver.drop_learning_rate`), replaces the adversary or
restarts, and a milestone can drop the rates once the error crosses it.

Every ``solver`` of the config trains: the four RK schemes, the Adams
multisteps, the embedded pairs and VCABM ``adams``
(``ops/integrate.py``); all but the four RK schemes close the fused gate,
as in the JAX package, so their u side is the plain one. ``remat_scan``
(the default) and ``adjoint: true`` recompute each sample interval of
the plain scans in the backward.

On a mesh of ``torch.distributed`` ranks (``parallel/mesh.py``; the
world by default once it is initialized) every rank draws each global
batch from the member's generator and keeps its rows, the loss sums are
global and the gradients are summed once before the optimizer, so the
run follows the single-process one up to the order of its sums.
``ensemble: K`` puts the members on the ``member`` groups of
:func:`parallel.mesh.make_mesh_ensemble`, and ``tangent_shards`` splits
the d directions of ``grad_x u`` over a ``tangent`` axis. Every rank runs
the kernels on its own rows; a tangent axis closes #3-#5 only
(``ops/weak_form.py::fused_gate``). Only rank 0 writes files.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from xnode_wan_tpu_torch.config import SolverConfig
from xnode_wan_tpu_torch.device import default_device
from xnode_wan_tpu_torch.models.discriminator import (Discriminator,
                                                      apply_discriminator,
                                                      init_discriminator)
from xnode_wan_tpu_torch.models import wan as wan_model
from xnode_wan_tpu_torch.models import xnode as xnode_model
from xnode_wan_tpu_torch.ops.kernels.xnode_train import u_forward_fused
from xnode_wan_tpu_torch.ops.sampling import PathBatch, make_domain
from xnode_wan_tpu_torch.ops.weak_form import kernel_gate, make_losses
from xnode_wan_tpu_torch.parallel.mesh import (MEMBER_AXIS, TANGENT_AXIS,
                                               Mesh, all_gather_cat,
                                               all_reduce_sum, broadcast,
                                               make_mesh, make_mesh_2d,
                                               make_mesh_ensemble, round_up,
                                               shard_batch, world_ranks)
from xnode_wan_tpu_torch.problems import Problem, from_reference_callables
from xnode_wan_tpu_torch.utils import checkpoint as ckpt
from xnode_wan_tpu_torch.utils.logging import RunLogger
from xnode_wan_tpu_torch.utils.metrics import l_norm, rel_err
from xnode_wan_tpu_torch.utils.viz import proj, slice_points

STALL_ACTIONS = ("none", "drop_lr", "reinit_v", "restart")
# debug_nans: the metric that flags a NaN in the updated weights (taken
# out of the host's rows before they are logged)
WEIGHTS_NAN = "weights_nan"

# primal family -> (init, apply on a path batch, evaluate at points), as
# the JAX package's table (xnode_wan_tpu/training.py:50-55)
PRIMAL_MODELS = {
    "xnode": (xnode_model.init_xnode, xnode_model.apply_xnode,
              xnode_model.evaluate_points),
    "wan": (wan_model.init_wan, wan_model.apply_wan,
            wan_model.evaluate_points),
}


def _window_stalled(rel_window, best_rel: float,
                    margin_sd: float = 2.0) -> bool:
    """Trajectory-statistics stall test for one ``train_until`` window;
    the JAX package's ``_window_stalled`` (``xnode_wan_tpu/training.py``),
    copied so that the port imports nothing of it.

    A window is stalled when it (a) sets no *significant* new best: its
    minimum does not undercut ``best_rel`` by more than ``margin_sd``
    window-noise standard deviations in log space (rel_err is a
    fresh-sample Monte-Carlo estimate, so sub-noise dips are not
    progress), and (b) shows no significant downward trend: the
    least-squares slope of ``log rel_err`` over the window plus two
    standard errors is still >= 0.

    ``margin_sd``: 2.0 to trigger an intervention (an lr drop or a restart
    must not fire on noise dips); 0.0 to give up after the final lr drop,
    where post-drop refinement descends slower than the 2-sigma band can
    certify, so the bar is "no new best at all".
    """
    r = np.asarray(rel_window, dtype=np.float64)
    r = r[np.isfinite(r) & (r > 0)]
    if r.size < 4:
        return False
    y = np.log(r)
    t = np.arange(y.size, dtype=np.float64)
    t -= t.mean()
    denom = float((t * t).sum())
    slope = float((t * y).sum()) / denom
    resid = y - y.mean() - slope * t
    var = float((resid * resid).sum()) / max(y.size - 2, 1)
    noise_sd = math.sqrt(max(var, 0.0))
    if not np.isfinite(best_rel):
        return False  # no baseline yet: the first window can't stall
    if float(y.min()) < math.log(best_rel) - margin_sd * noise_sd:
        return False  # significant new best: real progress
    stderr = math.sqrt(max(var, 0.0) / denom)
    return slope + 2.0 * stderr >= 0.0


def _restart_seed(seed: int, done: int) -> int:
    """The seed of a ``restart`` after ``done`` iterations, and of ensemble
    member ``done``. The JAX package folds ``done`` into its key (or
    splits it per member); here numpy's ``SeedSequence`` mixes the run's
    seed with ``done``, so equal runs restart and seed their members
    alike."""
    return int(np.random.SeedSequence([seed % 2 ** 32, done])
               .generate_state(1)[0])


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat_into(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def _to_cpu(obj):
    """``obj`` with every tensor in it copied to the CPU."""
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


@dataclasses.dataclass
class TrainState:
    """Everything one outer iteration of one member reads and advances."""
    u_params: Any                # models.xnode.XNODE or models.wan.WAN
    v_params: Discriminator
    opt_u: torch.optim.Adam
    opt_v: torch.optim.Adam
    generator: torch.Generator
    step: int = 0
    # Polyak/EMA average of the primal iterates (None when ema_decay == 0)
    u_ema: Optional[Any] = None


class NODEWANSolver:
    """The solver of the JAX package's ``NODEWANSolver``.

    Args:
        params: a :class:`SolverConfig` or a reference-style flat dict.
        problem: the PDE.
        device: ``None`` for the current CUDA device (raises without one),
            or a device name such as ``"cpu"``, where every kernel takes
            its plain PyTorch version.
        stop: optional ``stop(solver, metrics) -> bool`` checked by
            :meth:`train` every iteration, beside ``problem.stop_rel_err``
            (after a chunk, with each iteration's metrics in turn; a
            callback that reads the solver's weights sets the attribute
            ``reads_solver = True`` and is called after each iteration).
        work_dir: where :meth:`train` writes its logs and checkpoints
            (the reference's ``path``).
        mesh: a :class:`parallel.mesh.Mesh` of ``torch.distributed``
            ranks; by default every rank of an initialized world (a
            ``data x tangent`` mesh with ``tangent_shards``), else none.
        devices: the ranks of the default mesh instead of the world's
            (``devices=[rank]``: one process, no collective).

    On a mesh every rank builds the solver and calls each method that
    trains, serves or saves at the same point: they are collective.
    """

    def __init__(self, params, problem: Problem, device=None,
                 stop: Optional[Callable] = None, work_dir: str = "./",
                 mesh: Optional[Mesh] = None, devices=None):
        cfg = (params if isinstance(params, SolverConfig)
               else SolverConfig.from_dict(dict(params)))
        if problem.dim is not None and problem.dim != cfg.dim:
            raise ValueError(
                f"problem fixes dim={problem.dim} but config has dim={cfg.dim}")
        self.device = default_device(device)
        self.problem = problem
        self.stop = stop
        self.mesh = self._layout(cfg, mesh, devices)
        cfg = self._shard_counts(cfg)
        self.domain = make_domain(cfg.domain, cfg.shape_param, cfg.dim,
                                  cfg.T0, cfg.T, cfg.N_t,
                                  path_boundary=cfg.boundary_paths,
                                  waist_cap=cfg.waist_cap, x64=cfg.x64,
                                  qmc=cfg.qmc)
        if cfg.u_scale == 0:  # auto: rms of the initial data over a probe
            probe = self.domain.interior(
                torch.Generator(device=self.device).manual_seed(17), 512)
            s = float(torch.sqrt(torch.mean(problem.h(probe.x[:, 0, :]) ** 2)))
            cfg = cfg.replace(u_scale=max(1.0, s))
        self.cfg = cfg
        self._init_u, self._u_apply, self._u_eval_points = \
            PRIMAL_MODELS[cfg.primal]
        # the metric forward through kernel #2 (the u side's own gate,
        # weak_form.fused_gate, also closes on a tangent axis)
        self._use_fused = kernel_gate(cfg)
        self._losses = make_losses(problem, self.domain, cfg, self._u_apply,
                                   self._v_apply, mesh=self.mesh)
        self.members: List[TrainState] = []
        self._best_member = 0
        self._reinit_state(cfg.seed)
        self.best_l = float("inf")
        self.best_u_params: Optional[Any] = None
        self.work_dir = work_dir
        self._writer = not dist.is_initialized() or dist.get_rank() == 0
        self.logger = RunLogger(cfg.dim, work_dir, write=self._writer)
        # whether the last stop inside a chunk replayed to metrics
        # bitwise equal to the chunk's own (None: no replay yet)
        self.replay_bitwise: Optional[bool] = None

    def _layout(self, cfg: SolverConfig, mesh: Optional[Mesh], devices
                ) -> Optional[Mesh]:
        """The mesh and its process groups (JAX ``:176-207``): by default
        the world (``data``, or ``data x tangent``), re-laid as ``member x
        data`` (or ``member``) for an ensemble; a mesh of one rank is
        none. Raises ``ValueError`` for a layout that cannot be built."""
        if mesh is None:
            ranks = list(devices) if devices is not None else world_ranks()
            if cfg.tangent_shards > 1:
                mesh = make_mesh_2d(ranks, cfg.data_axis,
                                    tangent_shards=cfg.tangent_shards)
            elif len(ranks) > 1:
                mesh = make_mesh(ranks, cfg.data_axis)
        if cfg.ensemble > 1:
            if cfg.tangent_shards > 1:
                raise ValueError(
                    "ensemble and tangent_shards do not compose; pick one")
            if mesh is not None and MEMBER_AXIS not in mesh.axis_names:
                mesh = make_mesh_ensemble(list(mesh.ranks.flat), cfg.ensemble,
                                          cfg.data_axis)
        if mesh is None or mesh.size == 1:
            return None
        mesh.group()   # builds every group, on every rank at this point
        return mesh

    def _shard_counts(self, cfg: SolverConfig) -> SolverConfig:
        """N_r and N_b rounded up to the data shard count (JAX
        ``:206-207``), and the groups the step sums over: the data group
        (the loss sums, the adversary's gradient), the primal gradient's
        group (every rank with ``tangent_shards``, whose ranks each give a
        slice of it), the flat group (metrics to the host) and the member
        group, with the members this rank steps."""
        mesh = self.mesh
        k = cfg.ensemble
        self._owned = list(range(k))
        self._data_group = self._u_grad_group = self._flat_group = None
        self._member_group = None
        if mesh is None:
            return cfg
        coord = mesh.coordinate()
        n_data = mesh.shape.get(cfg.data_axis, 1)
        self._data_group = mesh.group(cfg.data_axis)
        self._u_grad_group = (mesh.group() if TANGENT_AXIS in mesh.axis_names
                              else self._data_group)
        self._flat_group = mesh.group()
        if MEMBER_AXIS in mesh.axis_names:
            per = k // mesh.shape[MEMBER_AXIS]
            self._owned = list(range(coord[MEMBER_AXIS] * per,
                                     (coord[MEMBER_AXIS] + 1) * per))
            self._member_group = mesh.group(MEMBER_AXIS)
        return cfg.replace(N_r=round_up(cfg.N_r, n_data),
                           N_b=round_up(cfg.N_b, n_data))

    @property
    def state(self) -> TrainState:
        """The state of the best member (the only one without an
        ensemble); ``members`` holds all K."""
        return self.members[self._best_member]

    # ------------------------------------------------------------------
    def _v_apply(self, v_params, pts):
        cfg = self.cfg
        return apply_discriminator(v_params, pts, cfg.v_layers, cfg.tied_v,
                                   cfg.v_fourier_features)

    def _metric_u_apply(self, params, batch: PathBatch) -> torch.Tensor:
        """The fresh-sample metric forward: kernel #2 when
        ``weak_form.kernel_gate`` holds, else the primal's own apply (the
        XNODE's masked scan)."""
        if self._use_fused:
            return u_forward_fused(params, batch, self.problem, self.cfg)
        with torch.no_grad():
            return self._u_apply(params, batch, self.problem, self.cfg)

    @staticmethod
    def _make_tx(module: torch.nn.Module, lr: float) -> torch.optim.Adam:
        """Adam with optax's defaults; the learning rate lives in the
        optimizer's ``param_groups`` (the JAX package keeps it in the
        optimizer state through ``inject_hyperparams``)."""
        return torch.optim.Adam(module.parameters(), lr=lr,
                                betas=(0.9, 0.999), eps=1e-8)

    def _apply_tx(self, opt: torch.optim.Adam, module: torch.nn.Module,
                  base_lr: float, group=None) -> None:
        """One update from the gradients in ``module``: optional global-norm
        clipping (``optax.clip_by_global_norm``), then Adam at the rate of
        ``optax.exponential_decay(base_lr, 1000, lr_decay)`` at this
        optimizer's update count (``training.py:269-293``). With a
        ``group`` the gradients are first summed over its ranks, in one
        all-reduce, a parameter without a gradient on this rank taking
        zeros (on a tangent rank past the first, the primal's readout bias
        gets none)."""
        cfg = self.cfg
        if group is not None:
            params = list(module.parameters())
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in params]
            _unflat_into(all_reduce_sum(_flat(grads), group), grads)
        else:
            params = [p for p in module.parameters() if p.grad is not None]
        if cfg.grad_clip > 0:
            norm = torch.sqrt(sum(torch.sum(p.grad * p.grad) for p in params))
            scale = torch.where(norm < cfg.grad_clip,
                                torch.ones_like(norm), cfg.grad_clip / norm)
            for p in params:
                p.grad.mul_(scale)
        if cfg.lr_decay < 1.0:
            state = opt.state.get(params[0], {})
            count = int(state["step"]) if "step" in state else 0
            for group in opt.param_groups:
                group["lr"] = base_lr * cfg.lr_decay ** (count / 1000.0)
        opt.step()

    def _fresh_state(self, u_params, v_params: Discriminator,
                     generator: torch.Generator) -> TrainState:
        """A state with fresh Adam moments around the given networks."""
        cfg = self.cfg
        return TrainState(
            u_params=u_params, v_params=v_params,
            opt_u=self._make_tx(u_params, cfg.u_rate),
            opt_v=self._make_tx(v_params, cfg.v_rate),
            generator=generator,
            u_ema=copy.deepcopy(u_params) if cfg.ema_decay > 0 else None)

    def _reinit_state(self, seed: int) -> None:
        """Fresh networks and optimizers from ``seed`` (``:349-379``); with
        ``ensemble: K``, K members, member k from ``SeedSequence([seed,
        k])``."""
        k_members = self.cfg.ensemble
        seeds = ([seed] if k_members == 1
                 else [_restart_seed(seed, k) for k in range(k_members)])
        # on a mesh every rank holds all K, and steps its own (_owned)
        self.members = [self._member_state(s) for s in seeds]
        self._best_member = 0

    def _member_state(self, seed: int) -> TrainState:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        u_params = self._init_u(self.cfg, gen)
        return self._fresh_state(u_params, self._new_adversary(gen), gen)

    def _new_adversary(self, generator: torch.Generator) -> Discriminator:
        cfg = self.cfg
        return init_discriminator(
            cfg.dim, cfg.v_hidden_dim, cfg.v_layers, cfg.tied_v,
            cfg.v_fourier_features, generator=generator, device=self.device,
            dtype=torch.float64 if cfg.x64 else torch.float32)

    def drop_learning_rate(self, factor: float = 0.1,
                           lr_decay: Optional[float] = None) -> None:
        """Refinement phase: scale both Adam rates by ``factor`` (and set
        ``lr_decay`` when given) with fresh optimizer moments, keeping the
        parameters and the Polyak average (JAX ``:304-347``).

        The rates live in ``self.cfg``, which :meth:`_apply_tx` reads as the
        base of the decay schedule, and in the new optimizers'
        ``param_groups``; the fresh optimizers count their updates from 0,
        so the schedule restarts as optax's count does after ``init``.
        ``self._losses`` keeps the construction-time config: no rate enters
        the losses. Every ensemble member gets fresh optimizers.
        """
        cfg = self.cfg
        self.cfg = cfg.replace(
            u_rate=cfg.u_rate * factor, v_rate=cfg.v_rate * factor,
            lr_decay=cfg.lr_decay if lr_decay is None else lr_decay)
        for state in self.members:
            state.opt_u = self._make_tx(state.u_params, self.cfg.u_rate)
            state.opt_v = self._make_tx(state.v_params, self.cfg.v_rate)

    def _u_params_for_eval(self, state: Optional[TrainState] = None):
        """The serving parameters of ``state`` (default: the best member's):
        the Polyak average when ``ema_decay > 0`` (JAX ``:435-443``). On a
        member mesh the best member's come from the rank that steps it
        (:meth:`_serving_tensors`, collective)."""
        if state is not None or self._member_group is None:
            state = self.state if state is None else state
            return state.u_ema if self.cfg.ema_decay > 0 else state.u_params
        served = copy.deepcopy(self._u_params_for_eval(self.state))
        best = torch.tensor(self._best_member, device=self.device)
        with torch.no_grad():
            for p, t in zip(served.parameters(), self._serving_tensors(best)):
                p.copy_(t)
        return served

    def _serving_tensors(self, best: Optional[torch.Tensor]
                         ) -> List[torch.Tensor]:
        """The serving parameters of member ``best`` (a device scalar; None
        without an ensemble) as tensors, without a host sync: picked on
        the device among the members this rank steps and, on a member
        mesh, summed over the member group, where only the owner gives
        non-zeros (collective)."""
        if best is None:
            return [p.detach() for p in
                    self._u_params_for_eval(self.members[0]).parameters()]
        out = None
        for k in self._owned:
            ps = [p.detach() for p in
                  self._u_params_for_eval(self.members[k]).parameters()]
            if out is None:
                out = [torch.zeros_like(p) for p in ps]
            out = [torch.where(best == k, p, o) for p, o in zip(ps, out)]
        if self._member_group is not None:
            _unflat_into(all_reduce_sum(_flat(out), self._member_group), out)
        return out

    # ------------------------------------------------------------------
    def _sample(self, generator: torch.Generator):
        """An interior batch of ``domain.interior_rows(N_r)`` paths (``2
        N_r`` on the hourglass), a boundary batch and, with
        ``independent_uv``, the adversary side's own interior batch, a
        second interior draw of the same generator (``:444-464``); else
        None. On a mesh each is drawn whole and this rank keeps its rows."""
        batch = self._shard(self.domain.interior(generator, self.cfg.N_r))
        bbatch = self._shard(self.domain.boundary(generator, self.cfg.N_b))
        vbatch = (self._shard(self.domain.interior(generator, self.cfg.N_r))
                  if self.cfg.independent_uv else None)
        return batch, bbatch, vbatch

    def _shard(self, batch: PathBatch) -> PathBatch:
        return shard_batch(batch, self.mesh, self.cfg.data_axis)

    def _draw(self, state: TrainState):
        """The batches of one member's outer iteration, in the order
        :meth:`_step_on` takes them: interior, boundary, the fresh metric
        draw (None without an exact solution) and the adversary's own
        cloud (None without ``independent_uv``)."""
        batch, bbatch, vbatch = self._sample(state.generator)
        ebatch = (self._shard(self.domain.interior(state.generator,
                                                   self.cfg.N_r))
                  if self.problem.u_sol is not None else None)
        return batch, bbatch, ebatch, vbatch

    def _outer_step(self, state: Optional[TrainState] = None
                    ) -> Dict[str, torch.Tensor]:
        """One outer iteration (``:466-529``) on freshly sampled batches,
        returning its metrics as device scalars. Without ``state`` it
        advances the solver (every member under an ensemble, through
        :meth:`_ensemble_step`); with one it advances that state alone, in
        place."""
        if state is None and self.cfg.ensemble > 1:
            m = self._ensemble_step()
            stepped = [self.members[k] for k in self._owned]
        else:
            state = self.state if state is None else state
            m = self._step_on(state, *self._draw(state))
            stepped = [state]
        if self.cfg.debug_nans:
            # on the device: the host checks it with the metrics' copy
            m[WEIGHTS_NAN] = torch.stack([
                torch.isnan(p).any() for st in stepped
                for net in (st.u_params, st.v_params)
                for p in net.parameters()]).any().to(m["loss_u"].dtype)
        return m

    def _ensemble_step(self, draws: Optional[Sequence] = None
                       ) -> Dict[str, torch.Tensor]:
        """One outer iteration of every member in turn (JAX
        ``_step_fn_ensemble``, ``:401-423``), each on its own draws (or on
        ``draws[k]``, the arguments of :meth:`_step_on` after the state),
        so every kernel launch sees one member's shapes. Returns the best
        member's metrics, by ``rel_err`` or, without an exact solution, by
        ``init + bdry`` (``loss_u``'s min-max value can mark the member
        with the weakest adversary instead), with ``best_member`` and
        ``rel_err_worst``. On a member mesh a rank steps its own members
        and the members' metrics are gathered over the member group."""
        per = [self._step_on(self.members[k],
                             *(self._draw(self.members[k]) if draws is None
                               else draws[k]))
               for k in self._owned]
        names = list(per[0])
        local = torch.stack([torch.stack([p[n] for n in names]) for p in per])
        if self._member_group is not None:
            local = all_gather_cat(local, self._member_group)
            for k, st in enumerate(self.members):
                if k not in self._owned:
                    st.step += 1   # kept in step with the owner's count
        m = {name: local[:, j] for j, name in enumerate(names)}
        crit = m["rel_err"] if "rel_err" in m else m["init"] + m["bdry"]
        best = torch.argmin(crit)
        scalar = {name: v[best] for name, v in m.items()}
        scalar["best_member"] = best.to(torch.float32)
        if "rel_err" in m:
            scalar["rel_err_worst"] = torch.max(m["rel_err"])
        return scalar

    def _step_on(self, state: TrainState, batch: PathBatch,
                 bbatch: PathBatch, ebatch: Optional[PathBatch],
                 vbatch: Optional[PathBatch] = None
                 ) -> Dict[str, torch.Tensor]:
        """:meth:`_outer_step` of one member on given batches (``ebatch``:
        the fresh metric draw, or None; ``vbatch``: the adversary side's
        own cloud under ``independent_uv``, or None)."""
        cfg, losses = self.cfg, self._losses
        # the adversary side is constant across the n1 primal steps; taken
        # without a graph, so kernel #6 arms no backward and the plain path
        # builds no create_graph graph
        with torch.no_grad():
            vside = losses.v_side(state.v_params, batch, vbatch)
        u_params, v_params = state.u_params, state.v_params
        aux_u = None
        for _ in range(cfg.n1):
            state.opt_u.zero_grad(set_to_none=True)
            loss, aux_u = losses.loss_u_vside(u_params, vside, batch, bbatch)
            loss.backward()
            self._apply_tx(state.opt_u, u_params, cfg.u_rate,
                           self._u_grad_group)

        if cfg.ema_decay > 0:
            t = float(state.step + 1)
            decay = min(cfg.ema_decay, (1.0 + t) / (10.0 + t))
            with torch.no_grad():
                for e, p in zip(state.u_ema.parameters(),
                                u_params.parameters()):
                    e.copy_(e * decay + p * (1.0 - decay))

        with torch.no_grad():   # constant across the n2 adversary steps
            uside = losses.u_side(u_params, batch)
        aux_v = {"loss_v": torch.zeros((), device=self.device)}
        for _ in range(cfg.n2):
            state.opt_v.zero_grad(set_to_none=True)
            loss, aux_v = losses.loss_v_uside(v_params, uside, batch, vbatch)
            loss.backward()
            self._apply_tx(state.opt_v, v_params, cfg.v_rate,
                           self._data_group)

        metrics = {"loss_u": aux_u["loss_u"], "loss_v": aux_v["loss_v"],
                   "I": aux_u["I"], "int": aux_u["int"],
                   "init": aux_u["init"], "bdry": aux_u["bdry"]}
        metrics = {k: v.detach() for k, v in metrics.items()}
        if ebatch is not None:
            u_vals = self._metric_u_apply(self._u_params_for_eval(state),
                                          ebatch)
            sol = self.problem.u_sol(ebatch.x)
            vol = self.domain.V()
            group = self._data_group
            metrics["L2"] = l_norm(u_vals, sol, ebatch.mask, vol, cfg.p,
                                   group=group)
            metrics["rel_err"] = rel_err(u_vals, sol, ebatch.mask, vol, cfg.p,
                                         group=group)
        state.step += 1
        return metrics

    def _host_values(self, values: torch.Tensor) -> list:
        """One device-to-host copy of a vector, rank 0's on every rank of
        a mesh, so that every host decision is the same on all of them."""
        return broadcast(values, self._flat_group).tolist()

    def _to_host(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One device-to-host copy for all the step's scalars (checked
        under ``debug_nans``, :meth:`_check_nans`)."""
        names = list(metrics)
        values = self._host_values(
            torch.stack([metrics[k].double() for k in names]))
        m = dict(zip(names, values))
        self._check_nans([m], self.state.step - 1)
        return m

    def _check_nans(self, rows: List[Dict[str, float]], first: int) -> None:
        """``debug_nans`` (the JAX package's ``jax_debug_nans``, which
        raises on NaN and lets inf through): raise ``FloatingPointError``
        naming the first outer iteration (``first`` is that of
        ``rows[0]``) whose loss or metrics, or whose updated weights (the
        ``weights_nan`` flag :meth:`_outer_step` adds), hold a NaN. Reads
        the host copy the metrics take anyway, so it adds no sync; the
        flag is taken out of the rows."""
        if not self.cfg.debug_nans:
            return
        for i, m in enumerate(rows):
            weights_nan = m.pop(WEIGHTS_NAN, 0.0) != 0.0
            bad = sorted(k for k, v in m.items() if math.isnan(v))
            if bad or weights_nan:
                what = ", ".join(bad + (["weights"] if weights_nan else []))
                raise FloatingPointError(
                    f"debug_nans: outer iteration {first + i} gave NaN "
                    f"({what})")

    def _should_stop(self, m: Dict[str, float]) -> bool:
        thr = self.problem.stop_rel_err
        if thr is not None and m.get("rel_err", float("inf")) < thr:
            return True
        return self.stop is not None and bool(self.stop(self, m))

    # ------------------------------------------------------------------
    def predict(self, pts) -> torch.Tensor:
        """The trained primal at ``[..., (t, x)]`` points through the
        primal's ``evaluate_points`` (for the XNODE kernel #1 on the GPU),
        with the serving parameters (the best member's under ``ensemble``,
        the Polyak average under ``ema_decay``). Same contract as the JAX
        package's ``predict`` (``:942-958``)."""
        dtype = torch.float64 if self.cfg.x64 else torch.float32
        pts = torch.as_tensor(pts, dtype=dtype, device=self.device)
        squeeze = pts.dim() == 1
        if squeeze:
            pts = pts[None, :]
        with torch.no_grad():
            out = self._u_eval_points(self._u_params_for_eval(), pts,
                                      self.problem, self.cfg,
                                      domain=self.domain, mesh=self.mesh)
        return out[0] if squeeze else out

    def _save_best(self, params=None) -> None:
        params = self._u_params_for_eval() if params is None else params
        if self._writer:
            ckpt.save(os.path.join(self.work_dir,
                                   "best_model_weights_NODE.pth"),
                      ckpt.best_weights_dict(params))

    def _train_state(self) -> Dict[str, Any]:
        """:func:`utils.checkpoint.train_state_dict` of every member; on a
        member mesh each member's from a rank that steps it (collective)."""
        sd = ckpt.train_state_dict(self.members, self.best_l,
                                   self._best_member)
        if self._member_group is not None:
            mine = {k: _to_cpu(sd["members"][k]) for k in self._owned}
            every = [None] * dist.get_world_size(self._flat_group)
            dist.all_gather_object(every, mine, group=self._flat_group)
            for part in every:
                for k, member in part.items():
                    sd["members"][k] = member
        return sd

    def save_checkpoint(self, path: Optional[str] = None) -> str:
        """The full training state into ``path`` (default
        ``checkpoint_NODE.pt`` in ``work_dir``), written by rank 0."""
        path = path or os.path.join(self.work_dir, "checkpoint_NODE.pt")
        sd = self._train_state()
        if self._writer:
            ckpt.save(path, sd)
        return path

    def load_checkpoint(self, path: Optional[str] = None):
        path = path or os.path.join(self.work_dir, "checkpoint_NODE.pt")
        self.best_l, self._best_member = ckpt.restore_train_state(
            self.members, ckpt.load(path))
        return self

    # ------------------------------------------------------------------
    def _snapshot(self):
        """Everything an outer iteration advances, copied on the device
        without a host sync: each member's networks, both Adam states with
        their counts, the Polyak average, the generator's state and step,
        and the config (the rates), the best member and ``best_l``."""
        return (copy.deepcopy(ckpt.train_state_dict(
            self.members, self.best_l, self._best_member)), self.cfg)

    def _restore(self, snapshot) -> None:
        sd, self.cfg = snapshot
        self.best_l, self._best_member = ckpt.restore_train_state(
            self.members, sd)

    def _run_chunk(self, n: int):
        """``n`` outer iterations back to back with nothing copied to the
        host: each iteration's metrics are stacked on the device, and the
        serving weights of the best ``loss_u`` below ``best_l`` are kept
        there (``torch.where`` on a copy). Returns ``(names, metrics [n,
        k] float64, best loss, best weights)``; the best weights mean
        something only where the best loss is below ``best_l``."""
        names, rows, best_p = None, [], None
        best_l = None
        for _ in range(n):
            m = self._outer_step()
            if names is None:
                names = list(m)
                best_l = torch.full((), self.best_l, dtype=m["loss_u"].dtype,
                                    device=m["loss_u"].device)
            better = m["loss_u"] < best_l
            served = self._serving_tensors(m.get("best_member"))
            best_p = ([p.clone() for p in served] if best_p is None else
                      [torch.where(better, p, b)
                       for p, b in zip(served, best_p)])
            best_l = torch.where(better, m["loss_u"], best_l)
            rows.append(torch.stack([m[k].double() for k in names]))
        return names, torch.stack(rows), best_l, best_p

    def _chunk(self, n: int, can_stop: bool):
        """:meth:`_run_chunk` of ``n`` iterations and one copy of its
        metrics (and best loss) to the host, with the stop checked at each
        iteration in turn. When it fires at in-chunk index ``i < n - 1``,
        the snapshot taken before the chunk (when ``can_stop``; a chunk of
        one needs none) is
        restored and ``i + 1`` iterations replayed, so that the state, the
        best weights and ``best_l`` are those of the stop iteration (JAX
        ``:587-647``; its ``train`` runs past the stop, and tracks the best
        over the whole chunk). A ``stop`` that reads the solver's weights
        (``reads_solver``, as the reference adapter's) runs chunks of one,
        whatever ``n``, so that it sees each iteration's weights. Returns
        the kept iterations' metrics and whether the stop fired."""
        if getattr(self.stop, "reads_solver", False):
            n = 1
        snap = self._snapshot() if can_stop and n > 1 else None
        rows, best_l, best_p = self._chunk_rows(n)
        stop_at = next((i for i, m in enumerate(rows)
                        if self._should_stop(m)), None)
        if stop_at is not None and stop_at < n - 1:
            first = rows[:stop_at + 1]
            self._restore(snap)
            rows, best_l, best_p = self._chunk_rows(stop_at + 1)
            self.replay_bitwise = rows == first
        if best_l < self.best_l:
            self.best_l = best_l
            self.best_u_params = copy.deepcopy(self._u_params_for_eval(
                self.members[self._owned[0]]))
            with torch.no_grad():
                for p, b in zip(self.best_u_params.parameters(), best_p):
                    p.copy_(b)
            self._save_best(self.best_u_params)
        if "best_member" in rows[-1]:
            self._best_member = int(rows[-1]["best_member"])
        return rows, stop_at is not None

    def _chunk_rows(self, n: int):
        """:meth:`_run_chunk` with its metrics and best loss on the host:
        ``(one dict a iteration, best loss, best weights)``."""
        first = self.state.step
        names, stacked, best_l, best_p = self._run_chunk(n)
        flat = self._host_values(torch.cat([stacked.reshape(-1),
                                            best_l.double()[None]]))
        k = len(names)
        rows = [dict(zip(names, flat[i * k:(i + 1) * k])) for i in range(n)]
        self._check_nans(rows, first)
        return rows, flat[-1], best_p

    def _can_stop(self) -> bool:
        return self.problem.stop_rel_err is not None or self.stop is not None

    def train_chunked(self, iterations: int, chunk: int = 20,
                      log: bool = True) -> Dict[str, float]:
        """Chunks of ``chunk`` outer iterations (the last one shorter), the
        metrics copied to the host once a chunk (JAX ``:587-647``). On the
        stop, replayed to the stop iteration (:meth:`_chunk`), it saves the
        best weights and the checkpoint and returns; otherwise it runs
        ``iterations`` and saves neither. Returns the last iteration's
        metrics with ``iterations_run``."""
        done, last = 0, {}
        while done < iterations:
            rows, stopped = self._chunk(min(chunk, iterations - done),
                                        self._can_stop())
            if log:
                for i, m in enumerate(rows):
                    self.logger.log(done + i, m)
            done += len(rows)
            last = rows[-1]
            if stopped:
                self._save_best()
                self.save_checkpoint()
                break
        if log:
            self.logger.flush()
        return dict(last, iterations_run=done)

    def train(self, report: bool = False, report_it: int = 10,
              show_plt: bool = False, iterations: Optional[int] = None,
              chunk: Optional[int] = None) -> Dict[str, float]:
        """The alternating loop (reference ``train``,
        ``src/training.py:109-187``; JAX ``training.py:977-1073``) in chunks
        of ``chunk`` iterations (default ``cfg.train_chunk``; 1 with
        ``profile_dir``, and always 1 under a stop callback that reads the
        solver's weights, :meth:`_chunk`).

        Each iteration is logged under its index in this call (from 0),
        the weights of a new best ``loss_u`` go to
        ``best_model_weights_NODE.pth`` (and ``best_u_params``), and every
        ``report_it`` iterations with ``report`` the reference's report
        line is printed and the slice plotted (:meth:`_maybe_plot`; a
        chunk ends at each report step, so the plot shows that
        iteration's weights; ``show_plt`` also shows it). On
        ``problem.stop_rel_err`` or the ``stop`` callback it saves the
        best weights and the checkpoint, prints ``Stopping Criterion
        Reached`` and returns; a stop inside a chunk is replayed to
        (:meth:`_chunk`), so the records, best weights and checkpoint are
        those of ``chunk=1``. Otherwise it runs ``iterations`` (default
        ``cfg.iterations``) and saves the checkpoint. Under an ensemble
        the metrics (and the log records) are the best member's, with
        ``best_member`` and ``rel_err_worst``, and the best member serves.
        Returns the last iteration's metrics.
        """
        cfg = self.cfg
        iterations = cfg.iterations if iterations is None else iterations
        if chunk is None:
            chunk = 1 if cfg.profile_dir else cfg.train_chunk
        done, last, prof = 0, {}, None
        try:
            while done < iterations:
                n = min(chunk, iterations - done)
                if report:   # end the chunk at the next report step
                    n = min(n, -(-done // report_it) * report_it - done + 1)
                if cfg.profile_dir and done == 3 and self._writer:
                    prof = self._start_profile()
                rows, stopped = self._chunk(n, self._can_stop())
                for i, m in enumerate(rows):
                    step = done + i
                    self.logger.log(step, m)
                    if report and step % report_it == 0:
                        msg = (f"iteration: {step} Loss u: {m['loss_u']:.6g} "
                               f"Loss v: {m['loss_v']:.6g}")
                        if "L2" in m:
                            msg += (f" L^{cfg.p:g} error: {m['L2']:.6g}"
                                    f" rel: {m['rel_err']:.4g}")
                        if self._writer:
                            print(msg)
                        self._maybe_plot(step, show_plt)
                done += len(rows)
                last = rows[-1]
                if prof is not None and done >= 8:
                    self._end_profile(prof)
                    prof = None
                if stopped:
                    self._save_best()
                    self.save_checkpoint()
                    if self._writer:
                        print("Stopping Criterion Reached")
                    self.logger.flush()
                    return last
        finally:
            if prof is not None:
                self._end_profile(prof)
        self.logger.flush()
        self.save_checkpoint()
        return last

    def _start_profile(self):
        """``torch.profiler`` over the CPU and, on a GPU, the card, for the
        iterations [3, 8) (JAX ``:1054-1064``)."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    def _end_profile(self, prof) -> None:
        """Stop ``prof`` and write its Chrome trace, ``trace.json`` in
        ``profile_dir``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.cfg.profile_dir,
                                              "trace.json"))

    def _maybe_plot(self, step: int, show: bool) -> None:
        """The solution along axes (0, 1) at ``step`` (JAX ``:1075-1093``,
        the reference's ``resolution=200, colours=20``): ``guess_cn.npy``,
        ``error_cn.npy`` and ``plot_at_<step>_along_[0, 1].png`` in
        ``work_dir``. Where matplotlib is missing the arrays are written
        and the ImportError printed; anything else raises (a failed
        kernel #1 must not pass for a missing plot). On a mesh every rank
        serves its share of the slice and rank 0 writes."""
        cfg = self.cfg
        sp = cfg.shape_param
        down, up = (sp if isinstance(sp, (tuple, list)) else (-sp, sp))
        view = dict(axes=(0, 1), T=cfg.T, T0=cfg.T0, down=down, up=up,
                    resolution=200)
        if not self._writer:
            self.predict(torch.as_tensor(slice_points(cfg.dim, **view)[0]))
            return
        try:
            proj(self.predict, cfg.dim, step, colours=20, save=True,
                 show=show, func_u_sol=self.problem.u_sol,
                 work_dir=self.work_dir, domain=self.domain, **view)
        except ImportError as exc:
            if (exc.name or "").split(".")[0] != "matplotlib":
                raise
            print(f"plot at {step} not drawn (the slice's arrays are "
                  f"written): {exc}")

    def train_until(self, rel_tol: float, max_iters: int, window: int = 200,
                    stall_action: str = "none", max_lr_drops: int = 1,
                    drop_lr_at: float = 0.0):
        """Train until the fresh-sample rel-L^p error drops below
        ``rel_tol`` or ``max_iters`` iterations have run (JAX ``:649-893``),
        with the stop checked every iteration.

        Every ``window`` iterations (and at the end) the serving weights
        are kept when their error is the best seen at such a point. At the
        end they go to ``best_model_weights_NODE.pth`` and
        ``best_u_params`` when they beat the final error (reported as
        ``rel_err_best_saved``), else the final weights do; the full state
        goes to ``checkpoint_NODE.pt``.

        ``stall_action``: what to do when ``window`` iterations show no
        significant progress (:func:`_window_stalled`; ``best_rel`` is the
        best over the windows checked before):

        * ``"drop_lr"``: :meth:`drop_learning_rate` ``(0.1, lr_decay=0.99)``,
          at most ``max_lr_drops`` times (one by default: in JAX a second
          drop froze the hourglass's adversary and the run drifted). Once
          the drops are spent, a window must set any new best at all
          (margin 0), and three stalled windows in a row end the run.
        * ``"reinit_v"``: a new adversary; the primal and its moments stay.
        * ``"restart"``: fresh networks, optimizers and sampling stream
          from a seed derived from ``cfg.seed`` and the iteration count.

        ``drop_lr_at > 0`` drops the rates at the first iteration whose
        rel-L^p falls below it, once, against the same ``max_lr_drops``
        budget, under any ``stall_action``. (JAX checks it at the end of a
        device dispatch, on the dispatch's minimum.)

        Under an ensemble the best member is taken every iteration, the
        history is the best member's with ``best_member`` and
        ``rel_err_worst`` beside it, and the stall actions are off (the
        ensemble is the multi-start), as in JAX (``:805``).

        Returns the per-iteration ``loss_u``, ``L2`` and ``rel_err`` and
        the JAX package's summary keys, ``lr_drops_at`` among them.
        """
        if stall_action not in STALL_ACTIONS:
            raise ValueError(f"stall_action {stall_action!r} is not one of "
                             f"{STALL_ACTIONS}")
        if self.problem.u_sol is None:
            raise ValueError("train_until needs problem.u_sol")
        window = max(1, min(window, max_iters))
        hist = {name: [] for name in ("loss_u", "L2", "rel_err")}
        if self.cfg.ensemble > 1:
            hist.update(best_member=[], rel_err_worst=[])
        rel = float("inf")
        best = (float("inf"), None)   # (window-end rel, serving weights)
        best_rel = float("inf")       # best of the stall windows checked
        stall_buf: list = []
        lr_drops_at: list = []
        give_up_windows = 0
        done = 0
        t_train0 = time.perf_counter()
        while done < max_iters and rel > rel_tol:
            m = self._to_host(self._outer_step())
            if "best_member" in m:
                self._best_member = int(m["best_member"])
            for name in hist:
                hist[name].append(m[name])
            rel = m["rel_err"]
            done += 1
            if (done % window == 0 or rel <= rel_tol or done == max_iters) \
                    and rel < best[0]:
                best = (rel, copy.deepcopy(self._u_params_for_eval()))
            if (drop_lr_at > 0 and len(lr_drops_at) < max_lr_drops
                    and rel < drop_lr_at):
                lr_drops_at.append(done)
                self.drop_learning_rate(0.1, lr_decay=0.99)
                drop_lr_at = 0.0   # one milestone
            if stall_action == "none" or self.cfg.ensemble > 1:
                continue
            stall_buf.append(rel)
            if len(stall_buf) < window:
                continue
            # an intervention needs the 2-sigma certification; giving up
            # after the final drop only needs "no new best" (margin 0)
            final_drop_done = (stall_action == "drop_lr"
                               and len(lr_drops_at) >= max_lr_drops)
            stalled = _window_stalled(stall_buf, best_rel,
                                      margin_sd=0.0 if final_drop_done
                                      else 2.0)
            best_rel = min(best_rel, float(np.min(stall_buf)))
            stall_buf = []
            if not stalled:
                give_up_windows = 0
            elif stall_action == "drop_lr":
                if len(lr_drops_at) < max_lr_drops:
                    lr_drops_at.append(done)
                    self.drop_learning_rate(0.1, lr_decay=0.99)
                else:
                    # the refinement phase oscillates with long gaps between
                    # new bests; three stalled windows in a row is drift
                    give_up_windows += 1
                    if give_up_windows >= 3:
                        break
            elif stall_action == "reinit_v":   # the primal is kept
                state = self.state
                state.v_params = self._new_adversary(state.generator)
                state.opt_v = self._make_tx(state.v_params, self.cfg.v_rate)
            else:   # restart
                self._reinit_state(_restart_seed(self.cfg.seed, done))
                best_rel = float("inf")
        out = {name: np.asarray(v, dtype=np.float64) for name, v in hist.items()}
        out["iterations_run"] = done
        out["rel_err_final"] = rel
        out["lr_drops_at"] = lr_drops_at
        out["wall_train_s"] = time.perf_counter() - t_train0
        if best[1] is not None and best[0] < rel:
            out["rel_err_best_saved"] = best[0]
            self.best_u_params = best[1]
        else:
            self.best_u_params = copy.deepcopy(self._u_params_for_eval())
        self._save_best(self.best_u_params)
        self.save_checkpoint()
        return out

    # ------------------------------------------------------------------
    # The reference's solver surface: what a reference-style
    # ``stop(solver, points, domain)`` callback reads off the solver
    # (``configs/Ex4_1_funcs.py:36-37``: ``u_net``, ``func_u_sol``, ``p``,
    # ``params['N_r']``; JAX ``:1096-1159``).
    @property
    def u_net(self):
        """``u_net(batch) -> u [N, L]`` at the current serving weights."""
        params = self._u_params_for_eval()

        def net(batch: PathBatch) -> torch.Tensor:
            with torch.no_grad():
                return self._u_apply(params, batch, self.problem, self.cfg)
        return net

    @property
    def func_u_sol(self):
        return self.problem.u_sol

    @property
    def p(self) -> float:
        return self.cfg.p

    @property
    def params(self) -> dict:
        return dataclasses.asdict(self.cfg)

    @staticmethod
    def _adapt_reference_stop(ref_stop: Callable) -> Callable:
        """A reference-style ``stop(solver, points, domain)`` as the
        ``stop(solver, metrics)`` hook. Each call draws a fresh interior
        batch of ``N_r`` paths, call ``c`` from a generator seeded with
        ``SeedSequence([seed ^ 0x5709, c])`` (JAX folds ``c`` into the
        key of ``seed ^ 0x5709``), and passes the solver and the domain.
        It reads the solver's weights, so :meth:`train` steps one
        iteration at a time under it (``reads_solver``)."""
        counter = itertools.count()

        def adapted(solver, metrics):
            del metrics
            seed = _restart_seed(solver.cfg.seed ^ 0x5709, next(counter))
            gen = torch.Generator(device=solver.device).manual_seed(seed)
            points = solver.domain.interior(gen, solver.cfg.N_r)
            return bool(ref_stop(solver, points, solver.domain))

        adapted.reads_solver = True
        return adapted

    @classmethod
    def from_reference(cls, params, func_a, func_b, func_c, func_h, func_f,
                       func_g, device=None, path: str = "./", stop=None,
                       func_u_sol=None, p: float = 1.0):
        """The reference's constructor signature (``src/training.py:65-79``;
        JAX ``:1139-1159``): entrywise coefficient callables, ``p`` unless
        ``params`` gives it, and a reference-style ``stop`` adapted by
        :meth:`_adapt_reference_stop`. ``device`` is the port's device
        argument (JAX ignores it)."""
        raw = dict(params)
        raw.setdefault("p", p)
        cfg = SolverConfig.from_dict(raw)
        problem = from_reference_callables(
            func_a, func_b, func_c, func_h, func_f, func_g, dim=cfg.dim,
            func_u_sol=func_u_sol)
        stop_cb = cls._adapt_reference_stop(stop) if stop is not None else None
        return cls(cfg, problem, device=device, stop=stop_cb, work_dir=path)
