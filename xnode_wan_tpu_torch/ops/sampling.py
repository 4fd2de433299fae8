"""Monte-Carlo samplers on the device of a caller-supplied ``torch.Generator``.

Port of the JAX package's ``xnode_wan_tpu/ops/sampling.py``: the
time-independent hypercube and the two moving domains, the shrinking cone
(:class:`NSphereTCone`) and the hourglass (:class:`NSphereTHourglass`),
built by name through :func:`make_domain`. Every sampler emits one
static-shape :class:`PathBatch`: ``x [N, L, C]`` with time at channel 0, a
validity ``mask [N, L]``, a per-path integration start ``t_start [N]`` and
a seed selector ``seed_from_h [N]``. Sample times are stratified (one
uniform draw per bin of width ``(T-T0)/N_t``, endpoints pinned), so a
static substep count keeps every ODE step under ``(T-T0)/min_steps``.

On the moving domains raggedness becomes masking: a cone path is dead
after the shrinking boundary passes it, and the hourglass interior has
``2 N_r`` rows, the from-``T0`` segments and then the re-entry segments
(``t_start = |x|/r``, seeded from ``g``, dead before re-entry and wholly
dead where the path never exits). Boundary times are drawn by inverse CDF
with density ``∝ R(t)^d``.

``torch.Generator`` and ``jax.random`` draw different numbers from one
seed: the samplers are held to the JAX samplers' properties, not bits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple, Union

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


def _unit_sphere(generator: torch.Generator, n: int, dim: int,
                 dtype=torch.float32) -> torch.Tensor:
    """Uniform directions on S^{dim-1} (reference ``surf``, dataset.py:64-68)."""
    g = torch.randn((n, dim), generator=generator, device=generator.device,
                    dtype=dtype)
    return g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True),
                           min=1e-20)


def _ball(generator: torch.Generator, n: int, dim: int, radius: float,
          dtype=torch.float32) -> torch.Tensor:
    """Uniform points in a ball (reference dataset.py:82-83: surf * U^{1/d}).

    The radial draw lies in ``[1e-6, 1)``, strictly off the origin, as the
    JAX sampler's ``minval=1e-6``: the gradient of ``|x|`` at 0 is NaN,
    and it would poison the weak-form loss through ``grad(v w)``.
    """
    dirs = _unit_sphere(generator, n, dim, dtype=dtype)
    u = torch.rand((n, 1), generator=generator, device=generator.device,
                   dtype=dtype)
    u = 1e-6 + u * (1.0 - 1e-6)
    return radius * dirs * u ** (1.0 / dim)


def _assemble(times_nl: torch.Tensor, x_spatial: torch.Tensor) -> torch.Tensor:
    """Broadcast per-path times [N,L] and spatial coords [N,d] into [N,L,C]."""
    n, l = times_nl.shape
    xs = x_spatial[:, None, :].expand(n, l, x_spatial.shape[-1])
    return torch.cat([times_nl[:, :, None], xs], dim=-1)


def _anchored_paths(x: torch.Tensor, t_end: torch.Tensor,
                    t_anchor: torch.Tensor, seed_from_h: torch.Tensor,
                    n_t: int) -> PathBatch:
    """Boundary path batch: ``n_t`` samples from each point's anchor time
    to its supervision time, spatial point frozen (the cone boundary and
    both hourglass boundary modes)."""
    frac = torch.linspace(0.0, 1.0, n_t, dtype=x.dtype, device=x.device)
    times = t_anchor[:, None] + frac[None, :] * (t_end - t_anchor)[:, None]
    return PathBatch(
        x=_assemble(times, x),
        mask=torch.ones((x.shape[0], n_t), dtype=torch.bool, device=x.device),
        t_start=t_anchor,
        seed_from_h=seed_from_h,
    )


def _reject_qmc(qmc: str) -> None:
    if qmc != "none":
        raise NotImplementedError(
            f"qmc={qmc!r} needs ops/qmc.py, which is not ported yet")


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
        _reject_qmc(self.qmc)

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.x64 else torch.float32

    @property
    def bot(self) -> float:
        return float(self.shape_param[0])

    @property
    def top(self) -> float:
        return float(self.shape_param[1])

    def interior_rows(self, n_r: int) -> int:
        return n_r

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


def _ball_volume_coef(dim: int) -> float:
    return math.pi ** (dim / 2) / math.gamma(dim / 2 + 1)


def _reject_nonzero_T0(domain) -> None:
    # The radius laws, exit-time inversions, masks and V() of the moving
    # domains are written against absolute time with the reference's
    # implicit T0 = 0 (src/dataset.py:48-229 hardcodes 1 - t); a nonzero
    # T0 would corrupt the geometry, so it is rejected.
    if float(domain.T0) != 0.0:
        raise ValueError(
            f"{type(domain).__name__} requires T0 == 0 (got {domain.T0}): "
            "its radius law is defined on absolute time from 0")


@dataclasses.dataclass(frozen=True)
class NSphereTCone:
    """Shrinking sphere of radius ``r (1 - t)`` (reference ``src/dataset.py:162-229``).

    Paths start inside at ``T0`` and leave when the boundary sweeps past
    them: the mask is ``t < 1 - |x|/r``, valid at ``T0`` for every path.
    With ``path_boundary`` (the default) each boundary sample is a path
    from ``T0`` (h-seed) along its frozen spatial point up to its exit time
    ``t_b = 1 - |x_b|/r``, and the boundary penalty compares ``u`` with
    ``g`` at that last sample only (``boundary_at_exit``); without it,
    single-time points as in the reference.
    """

    shape_param: float  # radius r
    dim: int
    T0: float
    T: float
    N_t: int
    path_boundary: bool = True
    x64: bool = False
    qmc: str = "none"

    def __post_init__(self):
        _reject_nonzero_T0(self)
        _reject_qmc(self.qmc)

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.x64 else torch.float32

    @property
    def r(self) -> float:
        return float(self.shape_param)

    @property
    def boundary_at_exit(self) -> bool:
        return self.path_boundary

    def interior_rows(self, n_r: int) -> int:
        return n_r

    def interior(self, generator: torch.Generator, n_r: int) -> PathBatch:
        times = stratified_times(generator, self.T0, self.T, self.N_t,
                                 dtype=self.dtype)
        x = _ball(generator, n_r, self.dim, self.r, dtype=self.dtype)
        # inside while r (1 - t) > |x| (reference mask, dataset.py:192-195)
        t_exit = 1.0 - torch.linalg.norm(x, dim=-1) / self.r
        mask = times[None, :] < t_exit[:, None]
        mask[:, 0] = True  # every path is valid at T0
        dev = x.device
        return PathBatch(
            x=_assemble(times[None, :].expand(n_r, self.N_t), x),
            mask=mask,
            t_start=torch.full((n_r,), self.T0, dtype=self.dtype, device=dev),
            seed_from_h=torch.ones((n_r,), dtype=torch.bool, device=dev),
        )

    def boundary(self, generator: torch.Generator, n_b: int) -> PathBatch:
        """Boundary points with ``t``-density ``∝ (1-t)^d`` by inverse CDF
        (the reference's per-time-slice counts, ``src/dataset.py:203-214``):
        single points ``[N_b, 1, C]``, or with ``path_boundary`` paths
        ``[N_b, N_t, C]`` from ``T0`` to the exit point."""
        d1 = self.dim + 1
        u = torch.rand((n_b,), generator=generator, device=generator.device,
                       dtype=self.dtype)
        dirs = _unit_sphere(generator, n_b, self.dim, dtype=self.dtype)
        hi = (1.0 - self.T0) ** d1
        lo = (1.0 - self.T) ** d1
        t = 1.0 - (hi - u * (hi - lo)) ** (1.0 / d1)
        x = dirs * (self.r * (1.0 - t))[:, None]
        if not self.path_boundary:
            return PathBatch(
                x=_assemble(t[:, None], x),
                mask=torch.ones((n_b, 1), dtype=torch.bool, device=x.device),
                t_start=t,
                seed_from_h=torch.zeros((n_b,), dtype=torch.bool,
                                        device=x.device))
        # the final sample lies on the moving boundary, the others are
        # the point's interior history
        return _anchored_paths(x, t, torch.full_like(t, self.T0),
                               torch.ones((n_b,), dtype=torch.bool,
                                          device=x.device), self.N_t)

    def func_w(self, x: torch.Tensor) -> torch.Tensor:
        """``r(1 - t) - |x|`` (reference ``src/dataset.py:216-218``)."""
        return self.r * (1.0 - x[..., 0]) - torch.linalg.norm(x[..., 1:],
                                                              dim=-1)

    def entry(self, pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """A point inside the shrinking domain at ``t`` was inside at every
        earlier time: always the from-``T0`` h-seeded path."""
        m = pts.shape[0]
        return (torch.full((m,), self.T0, dtype=pts.dtype, device=pts.device),
                torch.ones((m,), dtype=torch.bool, device=pts.device))

    def V(self) -> float:
        d1 = self.dim + 1
        timecomp = ((1 - self.T0) ** d1 - (1 - self.T) ** d1) / d1
        return _ball_volume_coef(self.dim) * self.r ** self.dim * timecomp


@dataclasses.dataclass(frozen=True)
class NSphereTHourglass:
    """Sphere of radius ``r((T-T0) - t)`` up to the waist at ``(T-T0)/2``,
    then ``r t``: shrink, then regrow (reference ``src/dataset.py:48-159``).

    Paths can exit and re-enter. The interior batch has ``2 N_r`` rows:
    the first ``N_r`` are from-``T0`` segments, dead after exit; the
    second ``N_r`` are the same points' re-entry segments, with ``t_start
    = |x|/r`` and the ``g``-seed, dead before re-entry, and wholly dead for
    points inside the waist, which never exit.

    Boundary paths supervise ``g`` at the sampled ``(t, x)`` itself:
    descending-branch points were inside at every earlier time (a path
    from ``T0`` with the h-seed); an ascending-branch point (``t > mid``)
    re-enters at ``|x|/r = t``, so its path is anchored there with the
    g-seed and has zero length: the model's value there is
    ``readout(lift(g))``, which every re-entry segment starts from.
    ``waist_cap`` is the ablation that maps ascending points to their
    descending-branch exit time instead.
    """

    shape_param: float  # radius scale r
    dim: int
    T0: float
    T: float
    N_t: int
    path_boundary: bool = True
    x64: bool = False
    waist_cap: bool = False
    qmc: str = "none"

    def __post_init__(self):
        _reject_nonzero_T0(self)
        _reject_qmc(self.qmc)

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.x64 else torch.float32

    @property
    def r(self) -> float:
        return float(self.shape_param)

    @property
    def boundary_at_exit(self) -> bool:
        return self.path_boundary

    @property
    def mid(self) -> float:
        return (self.T - self.T0) / 2.0

    def radius_at(self, t: torch.Tensor) -> torch.Tensor:
        span = self.T - self.T0
        return self.r * torch.where(t <= self.mid, span - t, t)

    def interior_rows(self, n_r: int) -> int:
        return 2 * n_r

    def interior(self, generator: torch.Generator, n_r: int) -> PathBatch:
        span = self.T - self.T0
        times = stratified_times(generator, self.T0, self.T, self.N_t,
                                 dtype=self.dtype)
        x = _ball(generator, n_r, self.dim, self.r * span, dtype=self.dtype)
        rho = torch.linalg.norm(x, dim=-1)
        never_exits = rho <= self.r * self.mid
        t_exit = torch.where(never_exits, torch.full_like(rho, math.inf),
                             span - rho / self.r)
        t_re = rho / self.r
        # segment A: from T0 until the shrinking boundary passes the point
        mask_a = times[None, :] < t_exit[:, None]
        mask_a[:, 0] = True
        # segment B: after the growing boundary takes it back (if it left)
        mask_b = (times[None, :] > t_re[:, None]) & (~never_exits)[:, None]
        dev = x.device
        path_x = _assemble(times[None, :].expand(n_r, self.N_t), x)
        return PathBatch(
            x=torch.cat([path_x, path_x], dim=0),
            mask=torch.cat([mask_a, mask_b], dim=0),
            t_start=torch.cat([torch.full((n_r,), self.T0, dtype=self.dtype,
                                          device=dev), t_re]),
            seed_from_h=torch.cat([
                torch.ones((n_r,), dtype=torch.bool, device=dev),
                torch.zeros((n_r,), dtype=torch.bool, device=dev)]),
        )

    def boundary(self, generator: torch.Generator, n_b: int) -> PathBatch:
        """Boundary points with ``t``-density ``∝ R(t)^d`` by a piecewise
        inverse CDF (the reference's per-slice counts,
        ``src/dataset.py:106-117``)."""
        d1 = self.dim + 1
        span = self.T - self.T0
        mid = self.mid
        # the CDF on the descending branch: ((span-T0)^{d+1} - (span-t)^{d+1})/(d+1)
        c_mid = ((span - self.T0) ** d1 - (span - mid) ** d1) / d1
        c_tot = c_mid + (self.T ** d1 - mid ** d1) / d1
        u = torch.rand((n_b,), generator=generator, device=generator.device,
                       dtype=self.dtype) * c_tot
        dirs = _unit_sphere(generator, n_b, self.dim, dtype=self.dtype)
        # each branch's inverse is NaN off its own range; where picks
        t_desc = span - ((span - self.T0) ** d1 - u * d1) ** (1.0 / d1)
        t_asc = ((u - c_mid) * d1 + mid ** d1) ** (1.0 / d1)
        t = torch.where(u <= c_mid, t_desc, t_asc)
        x = dirs * self.radius_at(t)[:, None]
        dev = x.device
        if not self.path_boundary:
            return PathBatch(
                x=_assemble(t[:, None], x),
                mask=torch.ones((n_b, 1), dtype=torch.bool, device=dev),
                t_start=t,
                seed_from_h=torch.zeros((n_b,), dtype=torch.bool, device=dev))
        if self.waist_cap:
            # ablation: an ascending-branch sample shares its spatial point
            # with a descending-branch exit (|x| = r t_b = R(span - t_b));
            # supervise g at that earlier hit
            t_hit = torch.minimum(t, span - t)
            return _anchored_paths(x, t_hit, torch.full_like(t, self.T0),
                                   torch.ones((n_b,), dtype=torch.bool,
                                              device=dev), self.N_t)
        ascending = t > self.mid
        t_anchor = torch.where(ascending,
                               torch.linalg.norm(x, dim=-1) / self.r,
                               torch.full_like(t, self.T0))
        return _anchored_paths(x, t, t_anchor, ~ascending, self.N_t)

    def func_w(self, x: torch.Tensor) -> torch.Tensor:
        """Piecewise ``R(t) - |x|`` (reference ``src/dataset.py:119-125``)."""
        return self.radius_at(x[..., 0]) - torch.linalg.norm(x[..., 1:],
                                                             dim=-1)

    def entry(self, pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Boundary-entry seeding for direct evaluation (reference
        ``src/model.py:92-96`` and ``bound_pad``, ``src/dataset.py:127-152``).

        An ascending-branch point (``t > mid``, ``|x| > r mid``) was outside
        the domain during ``(span - |x|/r, |x|/r)``: its path starts at the
        re-entry time ``|x|/r`` (clamped to ``t`` for on-boundary queries)
        with the g-seed. Every other point integrates from ``T0`` with the
        h-seed.
        """
        t = pts[:, 0]
        rho = torch.linalg.norm(pts[:, 1:], dim=-1)
        reentered = (t > self.mid) & (rho > self.r * self.mid)
        t_re = torch.minimum(rho / self.r, t)
        t_entry = torch.where(reentered, t_re, torch.full_like(t, self.T0))
        return t_entry, ~reentered

    def V(self) -> float:
        # the integral of c_d R(t)^d over both branches; the reference's
        # hardcoded formula (src/dataset.py:154-159) at T0 = 0, T = 1
        d1 = self.dim + 1
        span = self.T - self.T0
        mid = self.mid
        desc = ((span - self.T0) ** d1 - (span - mid) ** d1) / d1
        asc = (self.T ** d1 - mid ** d1) / d1
        return _ball_volume_coef(self.dim) * self.r ** self.dim * (desc + asc)


Domain = Union[Hypercube, NSphereTCone, NSphereTHourglass]

DOMAIN_REGISTRY = {
    "Hypercube": Hypercube,
    "NSphere_TCone": NSphereTCone,
    "NSphereTCone": NSphereTCone,
    "NSphere_THourglass": NSphereTHourglass,
    "NSphereTHourglass": NSphereTHourglass,
}


def make_domain(name: str, shape_param, dim: int, T0: float, T: float,
                N_t: int, path_boundary: bool = True,
                waist_cap: bool = False, x64: bool = False,
                qmc: str = "none") -> Domain:
    """A domain by its config name (the reference's
    ``eval(params['domain'])``, ``src/training.py:84``). The spheres take
    a radius: a float, or a list whose last entry is the radius."""
    try:
        cls = DOMAIN_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown domain {name!r}; available: {sorted(DOMAIN_REGISTRY)}"
        ) from None
    if cls is Hypercube:
        return cls(tuple(shape_param), dim, float(T0), float(T), int(N_t),
                   x64=x64, qmc=qmc)
    if isinstance(shape_param, (tuple, list)):
        shape_param = float(shape_param[-1])
    if cls is NSphereTHourglass:
        return cls(float(shape_param), dim, float(T0), float(T), int(N_t),
                   path_boundary=path_boundary, x64=x64, waist_cap=waist_cap,
                   qmc=qmc)
    return cls(float(shape_param), dim, float(T0), float(T), int(N_t),
               path_boundary=path_boundary, x64=x64, qmc=qmc)
