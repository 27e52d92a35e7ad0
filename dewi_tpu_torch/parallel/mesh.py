"""Device meshes over ``torch.distributed``: one process per device.

Counterpart of ``dewi_tpu/parallel/mesh.py``.  JAX runs one controller over
a ``Mesh`` of devices; the port runs one process per device, and a
:class:`Mesh` is this process's place in a ``(data, model)`` grid of the
default process group's ranks (rank ``r`` sits at row ``r // n_model``,
column ``r % n_model``) with the process groups of its row and column.

* axis ``"data"``  -- the corpus/document axis: index shards, signal batches;
* axis ``"model"`` -- the tensor-parallel axis of the large backbones.

The collectives here (:meth:`Mesh.all_gather`, :meth:`Mesh.broadcast`,
:meth:`Mesh.scatter`) are what the reference's ``shard_map`` bodies do with
``lax.all_gather`` and ``device_put``.  A gloo group takes host tensors:
for a gloo group the helpers copy a CUDA tensor to the host, run the
collective there and copy the result back (the rule is the group's backend,
not a retry).  A single-device mesh has no process group; its collectives
are the identity, so the meshless code path and a one-device mesh agree.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..utils.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _local_device(rank: int, device: DeviceLike) -> torch.device:
    """``device`` as given, except that ``None`` or a bare ``"cuda"`` is
    this rank's card: ``cuda:<LOCAL_RANK>`` modulo the visible cards
    (several ranks may share one)."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


@dataclass(frozen=True)
class Mesh:
    """This process's place in a ``(data, model)`` grid of ranks.

    ``groups`` maps an axis to the process group of this rank's column
    (``data``) or row (``model``), or ``None`` where the axis has one rank
    and no process group exists.  ``device`` is where this rank's shard
    lives."""

    n_data: int
    n_model: int
    rank: int
    device: torch.device
    groups: Dict[str, Any] = field(default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    @property
    def data_index(self) -> int:
        """This rank's position on the data axis (its corpus shard)."""
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    def group(self, axis: str = DATA_AXIS) -> Any:
        return self.groups.get(axis)

    def all_gather(self, t: torch.Tensor, dim: int = 0, axis: str = DATA_AXIS) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes), concatenated along ``dim`` in
        rank order on ``axis``, on every rank (the reference's tiled
        ``lax.all_gather``)."""
        return all_gather(t, self.group(axis), dim)

    def broadcast(self, t: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
        """``t`` of the first rank on ``axis`` written into ``t`` on every rank."""
        return broadcast(t, self.group(axis))

    def scatter(self, parts: Optional[List[torch.Tensor]], shape: Tuple[int, ...],
                dtype: torch.dtype, axis: str = DATA_AXIS) -> torch.Tensor:
        """This rank's part of ``parts`` (given on the first rank of ``axis``,
        ``None`` elsewhere), each of ``shape`` and ``dtype``, on ``device``."""
        return scatter(parts, shape, dtype, self.device, self.group(axis))

    def barrier(self) -> None:
        """Wait for every rank of the mesh."""
        if any(g is not None for g in self.groups.values()):
            dist.barrier()


def _stage(t: torch.Tensor, group: Any) -> torch.Tensor:
    """The tensor the collective runs on: gloo takes host tensors, so a CUDA
    tensor goes to the host for a gloo group; bool travels as uint8."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if t.device.type == "cuda" and dist.get_backend(group) == dist.Backend.GLOO:
        t = t.cpu()
    return t.contiguous()


def all_gather(t: torch.Tensor, group: Any, dim: int = 0) -> torch.Tensor:
    """``dist.all_gather`` (the list form) of equal-shaped tensors, joined
    along ``dim``; the identity without a group."""
    if group is None:
        return t
    src = _stage(t, group)
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(device=t.device, dtype=t.dtype)


def broadcast(t: torch.Tensor, group: Any) -> torch.Tensor:
    """``t`` of the group's first rank, copied into ``t`` on every rank."""
    if group is None:
        return t
    src = _stage(t, group)
    dist.broadcast(src, src=dist.get_global_rank(group, 0), group=group)
    if src.data_ptr() != t.data_ptr():
        t.copy_(src)
    return t


def scatter(parts: Optional[List[torch.Tensor]], shape: Tuple[int, ...], dtype: torch.dtype,
            device: torch.device, group: Any) -> torch.Tensor:
    """Part ``i`` of the first rank's ``parts`` to the group's rank ``i``."""
    if group is None:
        assert parts is not None and len(parts) == 1
        return parts[0].to(device)
    out = _stage(torch.empty(shape, dtype=dtype, device=device), group)
    root = dist.get_global_rank(group, 0)
    send = None
    if dist.get_rank() == root:
        assert parts is not None and len(parts) == dist.get_world_size(group)
        send = [_stage(p.to(device=out.device), group) for p in parts]
    dist.scatter(out, send, src=root, group=group)
    return out.to(device=device, dtype=dtype)


def _groups(world: int, rank: int, n_data: int, n_model: int) -> Dict[str, Any]:
    """The process groups of this rank's column (data) and row (model).

    Every rank creates every group, in one order, as ``dist.new_group``
    requires; an axis that spans the world uses the default group."""
    groups: Dict[str, Any] = {DATA_AXIS: None, MODEL_AXIS: None}
    if n_data > 1 or world == 1:
        if n_model == 1:
            groups[DATA_AXIS] = dist.group.WORLD
        else:
            for j in range(n_model):
                g = dist.new_group([i * n_model + j for i in range(n_data)])
                if rank % n_model == j:
                    groups[DATA_AXIS] = g
    if n_model > 1:
        if n_data == 1:
            groups[MODEL_AXIS] = dist.group.WORLD
        else:
            for i in range(n_data):
                g = dist.new_group([i * n_model + j for j in range(n_model)])
                if rank // n_model == i:
                    groups[MODEL_AXIS] = g
    return groups


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device: DeviceLike = None) -> Mesh:
    """A ``(data, model)`` mesh over the ranks of the default process group.

    ``n_data=None`` takes ``world / n_model``.  Without a process group the
    world is this one process (:func:`single_device_mesh`).  ``device=None``
    puts this rank on its card (``cuda:<LOCAL_RANK>`` modulo the cards);
    pass ``device="cpu"`` for a CPU mesh (gloo).
    """
    n_model = int(n_model)
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} devices")
    if world == 1 and not (dist.is_available() and dist.is_initialized()):
        return single_device_mesh(device)
    return Mesh(int(n_data), n_model, rank, _local_device(rank, device),
                _groups(world, rank, int(n_data), n_model))


def single_device_mesh(device: DeviceLike = None) -> Mesh:
    """A world of one: no process group, every collective the identity."""
    return Mesh(1, 1, 0, _local_device(0, device), {DATA_AXIS: None, MODEL_AXIS: None})


@dataclass(frozen=True)
class Sharding:
    """How a tensor lies on a mesh: ``spec[i]`` names the mesh axis that
    splits dim ``i`` into contiguous blocks (``None``: replicated)."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def data_sharding(mesh: Mesh, rank: int = 2) -> Sharding:
    """Split the leading (document) dim over the data axis; replicate the rest."""
    return Sharding(mesh, (DATA_AXIS,) + (None,) * (rank - 1))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def mesh_device(mesh: Optional[Mesh], device: DeviceLike) -> torch.device:
    """Where a caller given ``mesh`` and ``device`` runs: the mesh's device,
    which an explicit ``device`` must name; without a mesh, ``device``."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and (torch.empty(0, device=resolve_device(device)).device
                               != torch.empty(0, device=mesh.device).device):
        raise ValueError(f"device {device} is not the mesh's device {mesh.device}")
    return mesh.device


def check_mesh(mesh: Any) -> Mesh:
    """``mesh`` if it is a :class:`Mesh`, else ``TypeError``."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a dewi_tpu_torch.parallel.Mesh (make_mesh), got {type(mesh).__name__}")
    return mesh


__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "Sharding", "make_mesh", "single_device_mesh",
           "data_sharding", "replicated", "all_gather", "broadcast", "scatter", "check_mesh",
           "mesh_device"]
