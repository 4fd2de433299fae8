"""Monte-Carlo samplers on the device of a caller-supplied ``torch.Generator``.

Port of the JAX package's ``xnode_wan_tpu/ops/sampling.py`` for the
time-independent hypercube. Every sampler emits one static-shape
:class:`PathBatch`: ``x [N, L, C]`` with time at channel 0, a validity
``mask [N, L]``, a per-path integration start ``t_start [N]`` and a seed
selector ``seed_from_h [N]``. Sample times are stratified (one uniform
draw per bin of width ``(T-T0)/N_t``, endpoints pinned), so a static
substep count keeps every ODE step under ``(T-T0)/min_steps``.

``torch.Generator`` and ``jax.random`` draw different numbers from one
seed: the samplers are held to the JAX samplers' properties, not bits.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass
class PathBatch:
    """A static-shape batch of space-time sample paths: ``x[N, L, C]`` with
    ``C = dim + 1``, time at channel 0, spatial coords constant along each
    path's time axis."""

    x: torch.Tensor            # [N, L, C]
    mask: torch.Tensor         # [N, L] bool: sample validity
    t_start: torch.Tensor      # [N] ODE integration start time
    seed_from_h: torch.Tensor  # [N] bool: seed from h(x) (else g(t_start, x))

    @property
    def times(self) -> torch.Tensor:
        return self.x[:, :, 0]

    @property
    def space(self) -> torch.Tensor:
        return self.x[:, :, 1:]


def stratified_times(generator: torch.Generator, T0: float, T: float, n: int,
                     dtype=torch.float32) -> torch.Tensor:
    """Sorted time grid: one uniform draw per bin, endpoints pinned."""
    dev = generator.device
    u = torch.rand((n,), generator=generator, device=dev, dtype=dtype)
    i = torch.arange(n, device=dev, dtype=dtype)
    t = T0 + (i + u) * (T - T0) / n
    t[0] = T0
    t[-1] = T
    return t


def _assemble(times_nl: torch.Tensor, x_spatial: torch.Tensor) -> torch.Tensor:
    """Broadcast per-path times [N,L] and spatial coords [N,d] into [N,L,C]."""
    n, l = times_nl.shape
    xs = x_spatial[:, None, :].expand(n, l, x_spatial.shape[-1])
    return torch.cat([times_nl[:, :, None], xs], dim=-1)


@dataclasses.dataclass(frozen=True)
class Hypercube:
    """Time-independent box ``[bot, top]^d`` (reference ``src/dataset.py:232-290``)."""

    shape_param: Tuple[float, float]  # (bot, top)
    dim: int
    T0: float
    T: float
    N_t: int
    x64: bool = False
    qmc: str = "none"
    # Every interior path spans the full grid, so the per-exit-group
    # objective has one occupied group: the weak form takes the pooled
    # estimator (ops/weak_form.py::make_losses).
    single_exit_group: bool = True

    def __post_init__(self):
        bot, top = self.shape_param
        if not top > bot:
            raise ValueError("The hypercube needs to have volume")
        if self.qmc != "none":
            raise NotImplementedError(
                f"qmc={self.qmc!r} needs ops/qmc.py, which is not ported yet")

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.x64 else torch.float32

    @property
    def bot(self) -> float:
        return float(self.shape_param[0])

    @property
    def top(self) -> float:
        return float(self.shape_param[1])

    def _uniform_box(self, generator, n: int) -> torch.Tensor:
        u = torch.rand((n, self.dim), generator=generator,
                       device=generator.device, dtype=self.dtype)
        return self.bot + u * (self.top - self.bot)

    def _paths(self, times: torch.Tensor, x: torch.Tensor) -> PathBatch:
        n, dev = x.shape[0], x.device
        return PathBatch(
            x=_assemble(times[None, :].expand(n, self.N_t), x),
            mask=torch.ones((n, self.N_t), dtype=torch.bool, device=dev),
            t_start=torch.full((n,), self.T0, dtype=self.dtype, device=dev),
            seed_from_h=torch.ones((n,), dtype=torch.bool, device=dev),
        )

    def interior(self, generator: torch.Generator, n_r: int) -> PathBatch:
        """Uniform spatial points over one shared stratified grid
        (reference ``src/dataset.py:246-255``)."""
        times = stratified_times(generator, self.T0, self.T, self.N_t,
                                 dtype=self.dtype)
        return self._paths(times, self._uniform_box(generator, n_r))

    def boundary(self, generator: torch.Generator, n_b: int) -> PathBatch:
        """One face coordinate pinned per path, faces assigned round-robin
        (``i % 2d``) as in the JAX sampler."""
        times = stratified_times(generator, self.T0, self.T, self.N_t,
                                 dtype=self.dtype)
        x = self._uniform_box(generator, n_b)
        face = torch.arange(n_b, device=x.device) % (2 * self.dim)
        val = torch.where(face % 2 == 0, self.top, self.bot).to(self.dtype)
        x[torch.arange(n_b, device=x.device), face // 2] = val
        return self._paths(times, x)

    def func_w(self, x: torch.Tensor) -> torch.Tensor:
        """Min distance to any face (reference ``src/dataset.py:278-282``)."""
        xs = x[..., 1:]
        dist = torch.minimum(torch.abs(self.top - xs), torch.abs(xs - self.bot))
        return torch.amin(dist, dim=-1)

    def entry(self, pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-point path origin for direct evaluation: every point's
        constant-x path back to ``T0`` stays inside, so h-seed from T0."""
        m = pts.shape[0]
        return (torch.full((m,), self.T0, dtype=pts.dtype, device=pts.device),
                torch.ones((m,), dtype=torch.bool, device=pts.device))

    def V(self) -> float:
        return (self.top - self.bot) ** self.dim * (self.T - self.T0)
