"""The XNODE-WAN solver: alternating primal / adversarial Adam training.

Port of ``xnode_wan_tpu/training.py`` (reference ``src/training.py:54-187``)
for one device. One outer iteration (:meth:`NODEWANSolver._outer_step`)
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
under ``group_loss``.

:meth:`NODEWANSolver.train` is the CLI's loop (``main.py``): it logs every
iteration (``utils/logging.py``), keeps the best weights by ``loss_u`` in
``best_model_weights_NODE.pth`` and writes the full state to
``checkpoint_NODE.pt`` (``utils/checkpoint.py``), which
:meth:`NODEWANSolver.load_checkpoint` resumes from.

Not ported yet (they raise): ensembles, QMC sampling, the stall /
milestone learning-rate recipes of ``train_until``, plots and
``train_chunked`` (ROADMAP.md §1 lists where each comes).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from xnode_wan_tpu_torch.config import SolverConfig, check_trainable
from xnode_wan_tpu_torch.device import default_device
from xnode_wan_tpu_torch.models.discriminator import (Discriminator,
                                                      apply_discriminator,
                                                      init_discriminator)
from xnode_wan_tpu_torch.models.xnode import (XNODE, apply_xnode,
                                              evaluate_points, init_xnode)
from xnode_wan_tpu_torch.ops.kernels.xnode_train import u_forward_fused
from xnode_wan_tpu_torch.ops.sampling import PathBatch, make_domain
from xnode_wan_tpu_torch.ops.weak_form import fused_gate, make_losses
from xnode_wan_tpu_torch.problems import Problem
from xnode_wan_tpu_torch.utils import checkpoint as ckpt
from xnode_wan_tpu_torch.utils.logging import RunLogger
from xnode_wan_tpu_torch.utils.metrics import l_norm, rel_err


@dataclasses.dataclass
class TrainState:
    """Everything one outer iteration reads and advances."""
    u_params: XNODE
    v_params: Discriminator
    opt_u: torch.optim.Adam
    opt_v: torch.optim.Adam
    generator: torch.Generator
    step: int = 0
    # Polyak/EMA average of the primal iterates (None when ema_decay == 0)
    u_ema: Optional[XNODE] = None


class NODEWANSolver:
    """The solver of the JAX package's ``NODEWANSolver`` on one device.

    Args:
        params: a :class:`SolverConfig` or a reference-style flat dict.
        problem: the PDE.
        device: ``None`` for the current CUDA device (raises without one),
            or a device name such as ``"cpu"``, where every kernel takes
            its plain PyTorch version.
        stop: optional ``stop(solver, metrics) -> bool`` checked by
            :meth:`train` every iteration, beside ``problem.stop_rel_err``.
        work_dir: where :meth:`train` writes its logs and checkpoints
            (the reference's ``path``).
    """

    def __init__(self, params, problem: Problem, device=None,
                 stop: Optional[Callable] = None, work_dir: str = "./"):
        cfg = (params if isinstance(params, SolverConfig)
               else SolverConfig.from_dict(dict(params)))
        check_trainable(cfg)
        if problem.dim is not None and problem.dim != cfg.dim:
            raise ValueError(
                f"problem fixes dim={problem.dim} but config has dim={cfg.dim}")
        self.device = default_device(device)
        self.problem = problem
        self.stop = stop
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
        self._use_fused = fused_gate(cfg)
        self._losses = make_losses(problem, self.domain, cfg, apply_xnode,
                                   self._v_apply)
        self._reinit_state(cfg.seed)
        self.best_l = float("inf")
        self.best_u_params: Optional[XNODE] = None
        self.work_dir = work_dir
        self.logger = RunLogger(cfg.dim, work_dir)

    # ------------------------------------------------------------------
    def _v_apply(self, v_params, pts):
        cfg = self.cfg
        return apply_discriminator(v_params, pts, cfg.v_layers, cfg.tied_v,
                                   cfg.v_fourier_features)

    def _metric_u_apply(self, params, batch: PathBatch) -> torch.Tensor:
        """The fresh-sample metric forward: kernel #2 when the fused gate
        holds, else the masked scan."""
        if self._use_fused:
            return u_forward_fused(params, batch, self.problem, self.cfg)
        with torch.no_grad():
            return apply_xnode(params, batch, self.problem, self.cfg)

    @staticmethod
    def _make_tx(module: torch.nn.Module, lr: float) -> torch.optim.Adam:
        """Adam with optax's defaults; the learning rate lives in the
        optimizer's ``param_groups`` (the JAX package keeps it in the
        optimizer state through ``inject_hyperparams``)."""
        return torch.optim.Adam(module.parameters(), lr=lr,
                                betas=(0.9, 0.999), eps=1e-8)

    def _apply_tx(self, opt: torch.optim.Adam, module: torch.nn.Module,
                  base_lr: float) -> None:
        """One update from the gradients in ``module``: optional global-norm
        clipping (``optax.clip_by_global_norm``), then Adam at the rate of
        ``optax.exponential_decay(base_lr, 1000, lr_decay)`` at this
        optimizer's update count (``training.py:269-293``)."""
        cfg = self.cfg
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

    def _fresh_state(self, u_params: XNODE, v_params: Discriminator,
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
        """Fresh networks and optimizers from ``seed`` (``:349-379``)."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        u_params = init_xnode(cfg, gen)
        v_params = init_discriminator(
            cfg.dim, cfg.v_hidden_dim, cfg.v_layers, cfg.tied_v,
            cfg.v_fourier_features, generator=gen, device=self.device,
            dtype=torch.float64 if cfg.x64 else torch.float32)
        self.state = self._fresh_state(u_params, v_params, gen)

    def _u_params_for_eval(self, state: Optional[TrainState] = None) -> XNODE:
        """The serving parameters: the Polyak average when ``ema_decay > 0``."""
        state = self.state if state is None else state
        return state.u_ema if self.cfg.ema_decay > 0 else state.u_params

    # ------------------------------------------------------------------
    def _sample(self, generator: torch.Generator):
        """An interior batch of ``domain.interior_rows(N_r)`` paths (``2
        N_r`` on the hourglass) and a boundary batch (``:444-464``)."""
        batch = self.domain.interior(generator, self.cfg.N_r)
        bbatch = self.domain.boundary(generator, self.cfg.N_b)
        return batch, bbatch

    def _outer_step(self, state: Optional[TrainState] = None
                    ) -> Dict[str, torch.Tensor]:
        """One outer iteration (``:466-529``) on freshly sampled batches;
        advances ``state`` (default: the solver's) in place and returns
        its metrics as device scalars."""
        state = self.state if state is None else state
        batch, bbatch = self._sample(state.generator)
        ebatch = (self.domain.interior(state.generator, self.cfg.N_r)
                  if self.problem.u_sol is not None else None)
        return self._step_on(state, batch, bbatch, ebatch)

    def _step_on(self, state: TrainState, batch: PathBatch,
                 bbatch: PathBatch, ebatch: Optional[PathBatch]
                 ) -> Dict[str, torch.Tensor]:
        """:meth:`_outer_step` on given batches (``ebatch``: the fresh
        metric draw, or None)."""
        cfg, losses = self.cfg, self._losses
        # the adversary side is constant across the n1 primal steps; taken
        # without a graph, so kernel #6 arms no backward and the plain path
        # builds no create_graph graph
        with torch.no_grad():
            vside = losses.v_side(state.v_params, batch)
        u_params, v_params = state.u_params, state.v_params
        aux_u = None
        for _ in range(cfg.n1):
            state.opt_u.zero_grad(set_to_none=True)
            loss, aux_u = losses.loss_u_vside(u_params, vside, batch, bbatch)
            loss.backward()
            self._apply_tx(state.opt_u, u_params, cfg.u_rate)

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
            loss, aux_v = losses.loss_v_uside(v_params, uside, batch)
            loss.backward()
            self._apply_tx(state.opt_v, v_params, cfg.v_rate)

        metrics = {"loss_u": aux_u["loss_u"], "loss_v": aux_v["loss_v"],
                   "I": aux_u["I"], "int": aux_u["int"],
                   "init": aux_u["init"], "bdry": aux_u["bdry"]}
        metrics = {k: v.detach() for k, v in metrics.items()}
        if ebatch is not None:
            u_vals = self._metric_u_apply(self._u_params_for_eval(state),
                                          ebatch)
            sol = self.problem.u_sol(ebatch.x)
            vol = self.domain.V()
            metrics["L2"] = l_norm(u_vals, sol, ebatch.mask, vol, cfg.p)
            metrics["rel_err"] = rel_err(u_vals, sol, ebatch.mask, vol, cfg.p)
        state.step += 1
        return metrics

    @staticmethod
    def _to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One device-to-host copy for all the step's scalars."""
        names = list(metrics)
        values = torch.stack([metrics[k].double() for k in names]).tolist()
        return dict(zip(names, values))

    def _should_stop(self, m: Dict[str, float]) -> bool:
        thr = self.problem.stop_rel_err
        if thr is not None and m.get("rel_err", float("inf")) < thr:
            return True
        return self.stop is not None and bool(self.stop(self, m))

    # ------------------------------------------------------------------
    def predict(self, pts) -> torch.Tensor:
        """The trained primal at ``[..., (t, x)]`` points through
        :func:`models.xnode.evaluate_points` (kernel #1 on the GPU), with
        the serving parameters (the Polyak average under ``ema_decay``).
        Same contract as the JAX package's ``predict`` (``:942-958``)."""
        dtype = torch.float64 if self.cfg.x64 else torch.float32
        pts = torch.as_tensor(pts, dtype=dtype, device=self.device)
        squeeze = pts.dim() == 1
        if squeeze:
            pts = pts[None, :]
        with torch.no_grad():
            out = evaluate_points(self._u_params_for_eval(), pts,
                                  self.problem, self.cfg, domain=self.domain)
        return out[0] if squeeze else out

    def _save_best(self) -> None:
        ckpt.save(os.path.join(self.work_dir, "best_model_weights_NODE.pth"),
                  ckpt.reference_state_dict(self._u_params_for_eval()))

    def save_checkpoint(self, path: Optional[str] = None) -> str:
        path = path or os.path.join(self.work_dir, "checkpoint_NODE.pt")
        ckpt.save(path, ckpt.train_state_dict(self.state, self.best_l))
        return path

    def load_checkpoint(self, path: Optional[str] = None):
        path = path or os.path.join(self.work_dir, "checkpoint_NODE.pt")
        self.best_l = ckpt.restore_train_state(self.state, ckpt.load(path))
        return self

    def train(self, report: bool = False, report_it: int = 10,
              show_plt: bool = False,
              iterations: Optional[int] = None) -> Dict[str, float]:
        """The alternating loop (reference ``train``,
        ``src/training.py:109-187``; JAX ``training.py:977-1073``), one
        outer iteration at a time.

        Each iteration is logged under its index in this call (from 0),
        the weights of a new best ``loss_u`` go to
        ``best_model_weights_NODE.pth`` (and ``best_u_params``), and every
        ``report_it`` iterations the reference's report line is printed.
        On ``problem.stop_rel_err`` or the ``stop`` callback it saves the
        best weights and the checkpoint, prints ``Stopping Criterion
        Reached`` and returns; otherwise it runs ``iterations`` (default
        ``cfg.iterations``) and saves the checkpoint. Returns the last
        iteration's metrics. Plots are not ported (``show_plt`` raises).
        """
        if show_plt:
            raise NotImplementedError(
                "plots (utils/viz.py) are not ported yet (ROADMAP item 8)")
        cfg = self.cfg
        iterations = cfg.iterations if iterations is None else iterations
        last: Dict[str, float] = {}
        for step in range(iterations):
            last = self._to_host(self._outer_step())
            self.logger.log(step, last)
            if last["loss_u"] < self.best_l:
                self.best_l = last["loss_u"]
                self.best_u_params = copy.deepcopy(self._u_params_for_eval())
                self._save_best()
            if report and step % report_it == 0:
                msg = (f"iteration: {step} Loss u: {last['loss_u']:.6g} "
                       f"Loss v: {last['loss_v']:.6g}")
                if "L2" in last:
                    msg += (f" L^{cfg.p:g} error: {last['L2']:.6g}"
                            f" rel: {last['rel_err']:.4g}")
                print(msg)
            if self._should_stop(last):
                self._save_best()
                self.save_checkpoint()
                print("Stopping Criterion Reached")
                self.logger.flush()
                return last
        self.logger.flush()
        self.save_checkpoint()
        return last

    def train_until(self, rel_tol: float, max_iters: int, window: int = 200,
                    stall_action: str = "none", drop_lr_at: float = 0.0):
        """Train until the fresh-sample rel-L^p error drops below
        ``rel_tol`` or ``max_iters`` iterations have run (``:649-893``).

        The stop is checked every iteration. Every ``window`` iterations
        (and at the end) the serving weights are kept in memory when their
        error is the best seen at such a point; ``best_u_params`` holds
        them afterwards, and ``rel_err_best_saved`` reports their error
        when it beats the final one. Returns the per-iteration ``loss_u``,
        ``L2`` and ``rel_err`` and the JAX package's summary keys.
        """
        if stall_action != "none" or drop_lr_at > 0:
            raise NotImplementedError(
                "the stall and milestone learning-rate recipes of "
                "train_until are not ported yet (ROADMAP.md §1)")
        if self.problem.u_sol is None:
            raise ValueError("train_until needs problem.u_sol")
        window = max(1, min(window, max_iters))
        hist = {"loss_u": [], "L2": [], "rel_err": []}
        rel = float("inf")
        best = (float("inf"), None)
        done = 0
        t_train0 = time.perf_counter()
        while done < max_iters and rel > rel_tol:
            m = self._to_host(self._outer_step())
            for name in hist:
                hist[name].append(m[name])
            rel = m["rel_err"]
            done += 1
            if (done % window == 0 or rel <= rel_tol or done == max_iters) \
                    and rel < best[0]:
                best = (rel, copy.deepcopy(self._u_params_for_eval()))
        out = {name: np.asarray(v, dtype=np.float64) for name, v in hist.items()}
        out["iterations_run"] = done
        out["rel_err_final"] = rel
        out["lr_drops_at"] = []
        out["wall_train_s"] = time.perf_counter() - t_train0
        if best[1] is not None and best[0] < rel:
            out["rel_err_best_saved"] = best[0]
            self.best_u_params = best[1]
        else:
            self.best_u_params = copy.deepcopy(self._u_params_for_eval())
        return out
