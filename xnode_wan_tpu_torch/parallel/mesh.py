"""Data, member and tangent parallelism over ``torch.distributed``.

Port of ``xnode_wan_tpu/parallel/mesh.py``. JAX lays its devices out as a
``jax.sharding.Mesh`` and compiles one SPMD program over it; here every
rank is a process (``torchrun``, or ``init_distributed`` with an address),
a :class:`Mesh` lays the ranks out under the same axis names (``data``,
``member``, ``tangent``) and builds one process group for each axis
through ``torch.distributed.device_mesh.DeviceMesh``. The layouts and the
errors of impossible ones are JAX's.

What JAX's compiler inserts, the solver calls here:

* every rank draws the *global* batch from the member's generator and
  keeps its own rows (:func:`shard_batch`), so a sharded run follows the
  single-process trajectory up to the order of its sums;
* a sum over paths that feeds a clamp, a division or a log is the global
  sum (:func:`global_sum`): its value is the all-reduced one on every
  rank, its gradient reaches this rank's rows only, and the trainer sums
  the parameter gradients once before the optimizer;
* results are gathered (:func:`all_gather_cat`) or taken from their owner
  (:func:`all_reduce_sum` of a tensor that only the owner fills).

A group of one rank is ``None`` and every helper is then the identity, so
a single process runs no collective.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from xnode_wan_tpu_torch.device import default_device
from xnode_wan_tpu_torch.ops.sampling import PathBatch

# the axes a solver reads by name besides its ``data_axis``
MEMBER_AXIS = "member"
TANGENT_AXIS = "tangent"


def init_distributed(device=None, **kwargs) -> torch.device:
    """``torch.distributed.init_process_group(**kwargs)``, the counterpart
    of JAX's ``jax.distributed.initialize`` passthrough. The backend
    defaults to ``nccl`` when ``device`` (default: the current CUDA
    device) is a CUDA device and to ``gloo`` on the CPU; an explicit
    ``backend=`` is used as given. The address, world size and rank come
    from ``kwargs`` or from ``torchrun``'s environment. Returns the
    device, made current when it is a CUDA device."""
    dev = default_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs.setdefault("backend", "nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(**kwargs)
    return dev


def world_ranks() -> list:
    """Every rank of the initialized world, or ``[0]`` for one process."""
    return list(range(dist.get_world_size())) if dist.is_initialized() else [0]


@dataclasses.dataclass
class Mesh:
    """Ranks laid out along named axes (JAX's ``Mesh`` over devices).
    ``ranks`` has one dimension per name in ``axis_names``."""

    ranks: np.ndarray
    axis_names: tuple
    _groups: Optional[Dict[str, object]] = dataclasses.field(
        default=None, repr=False, compare=False)

    def __post_init__(self):
        self.ranks = np.asarray(self.ranks)
        self.axis_names = tuple(self.axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"{self.ranks.ndim}-d ranks for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def coordinate(self) -> Dict[str, int]:
        """This rank's index along each axis."""
        rank = dist.get_rank()
        where = np.argwhere(self.ranks == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not once in the mesh {self}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def group(self, axis: Optional[str] = None):
        """The process group of this rank along ``axis`` (all axes when
        None), or None when that group holds one rank. The first call
        builds every group; like ``new_group`` it is collective, so every
        rank of the world makes it at the same point."""
        if axis is not None and self.shape.get(axis, 1) == 1:
            return None
        if axis is None and self.size == 1:
            return None
        if self._groups is None:
            if not dist.is_initialized() or dist.get_world_size() != self.size:
                raise ValueError(
                    f"a mesh of {self.size} ranks needs an initialized world "
                    "of that size (init_distributed)")
            from torch.distributed.device_mesh import DeviceMesh
            device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
            dm = DeviceMesh(device_type, torch.as_tensor(self.ranks),
                            mesh_dim_names=self.axis_names)
            self._groups = {name: dm.get_group(name)
                            for name in self.axis_names}
            self._groups[None] = dist.group.WORLD
        return self._groups[axis]


def make_mesh(devices: Optional[Sequence[int]] = None,
              axis: str = "data") -> Mesh:
    """A 1-D mesh over ``devices`` (default: every rank of the world)."""
    devices = list(devices if devices is not None else world_ranks())
    return Mesh(np.array(devices), (axis,))


def make_mesh_ensemble(devices: Sequence[int], k: int,
                       data_axis: str = "data") -> Mesh:
    """``member x data`` mesh for ``ensemble: K`` runs (JAX ``:64-89``):
    K members on the ``member`` axis, each member's paths sharded over the
    remaining ``n / K`` ranks; member-only (several members a rank, paths
    unsharded) when K is a multiple of the rank count; anything else
    raises rather than dropping the mesh."""
    devices = list(devices)
    n = len(devices)
    if n % k == 0:
        return Mesh(np.array(devices).reshape(k, n // k),
                    (MEMBER_AXIS, data_axis))
    if k % n == 0:
        return Mesh(np.array(devices), (MEMBER_AXIS,))
    raise ValueError(
        f"ensemble={k} cannot be laid out on {n} devices: need the member "
        f"count to divide the device count (member x data mesh) or be a "
        f"multiple of it (member-only mesh). Pick K accordingly, or pass "
        f"devices=[rank] to run deliberately unsharded; refusing to "
        f"silently drop the mesh.")


def make_mesh_2d(devices: Optional[Sequence[int]] = None,
                 data_axis: str = "data", tangent_shards: int = 2) -> Mesh:
    """``data x tangent`` mesh (JAX ``:91-108``): paths over ``data``, the
    d forward-mode directions of ``grad_x u`` over ``tangent``. Raises
    ``ValueError`` where JAX asserts: the rank count must be a multiple
    of ``tangent_shards``."""
    devices = list(devices if devices is not None else world_ranks())
    n = len(devices)
    if tangent_shards < 1 or n % tangent_shards != 0:
        raise ValueError(f"tangent_shards={tangent_shards} cannot be laid out "
                         f"on {n} device(s): the device count must be a "
                         "multiple of it")
    return Mesh(np.array(devices).reshape(n // tangent_shards, tangent_shards),
                (data_axis, TANGENT_AXIS))


def round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def shard_rows(x: torch.Tensor, index: int, count: int) -> torch.Tensor:
    """Rows ``[index n / count, (index + 1) n / count)`` of ``x``."""
    if x.shape[0] % count:
        raise ValueError(f"{x.shape[0]} rows do not split into {count} shards")
    per = x.shape[0] // count
    return x[index * per:(index + 1) * per]


def shard_batch(batch: PathBatch, mesh: Optional[Mesh],
                axis: str = "data") -> PathBatch:
    """This rank's rows of a globally drawn batch along ``axis``; the
    batch itself without a mesh or along an axis of one rank."""
    if mesh is None or mesh.shape.get(axis, 1) == 1:
        return batch
    index, count = mesh.coordinate()[axis], mesh.shape[axis]
    return PathBatch(*(shard_rows(a, index, count)
                       for a in (batch.x, batch.mask, batch.t_start,
                                 batch.seed_from_h)))


def tangent_count(mesh: Optional[Mesh]) -> int:
    """The ranks of the ``tangent`` axis: 1 without one."""
    return 1 if mesh is None else mesh.shape.get(TANGENT_AXIS, 1)


def tangent_shard(mesh: Optional[Mesh]):
    """``(group, index, count)`` of this rank along the ``tangent`` axis,
    or None without one of more than one rank."""
    count = tangent_count(mesh)
    if count == 1:
        return None
    return (mesh.group(TANGENT_AXIS), mesh.coordinate()[TANGENT_AXIS], count)


# Collectives. Gloo takes CUDA tensors for each of these (it stages them
# through the host itself), so two ranks can share one card.
def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` in place (the identity for None)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def broadcast(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` of the group's first rank, in place."""
    if group is not None:
        dist.broadcast(t, dist.get_global_rank(group, 0), group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, concatenated along ``dim`` in the
    group's rank order."""
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _GlobalSum(torch.autograd.Function):
    """Value: the sum of ``x`` over the group; gradient: the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (this rank's part of a sum over paths) summed over ``group``.

    Every rank gets the same global value, and the gradient flows into
    this rank's own part only, so no path is counted twice: the trainer
    then sums the parameter gradients over the ranks once
    (``training.NODEWANSolver._apply_tx``). ``x`` itself for None."""
    if group is None:
        return x
    return _GlobalSum.apply(x, group)


class _GatherSlices(torch.autograd.Function):
    """Forward: every rank's slice along ``dim``, concatenated; backward:
    this rank's slice of the cotangent (each rank of the group computes
    the same loss from the gathered tensor, so the cotangent is the same
    on all of them and each keeps its own part)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.width = dim, x.shape[dim]
        ctx.index = dist.get_rank(group)
        return all_gather_cat(x.detach(), group, dim)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.index * ctx.width, ctx.width),
                None, None)


def gather_slices(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Gather the tangent slices of a ``tangent`` group along ``dim``, with
    the gradient of each rank flowing into its own slice only."""
    if group is None:
        return x
    return _GatherSlices.apply(x, group, dim % x.dim())


def serve_sharded(evaluate, mesh: Mesh, params, pts: torch.Tensor, *args,
                  **kwargs) -> torch.Tensor:
    """``evaluate(params, pts, *args, **kwargs)`` with the points split
    over every rank of ``mesh`` (any mesh is one data group here), padded
    to equal shares with copies of the last point, and the values
    gathered. Collective: every rank calls it with the same points."""
    group, count = mesh.group(), mesh.size
    index = dist.get_rank(group)
    m = pts.shape[0]
    per = -(-m // count)
    padded = torch.cat([pts, pts[-1:].expand(per * count - m, -1)])
    local = evaluate(params, padded[index * per:(index + 1) * per].contiguous(),
                     *args, **kwargs)
    return all_gather_cat(local, group)[:m]
