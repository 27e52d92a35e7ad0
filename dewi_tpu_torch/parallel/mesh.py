"""Device meshes over ``torch.distributed``: one process per device.

Counterpart of ``dewi_tpu/parallel/mesh.py``.  JAX runs one controller over
a ``Mesh`` of devices; the port runs one process per device, and a
:class:`Mesh` is this process's place in a two-axis grid of the default
process group's ranks (rank ``r`` sits at row ``r // n_model``, column
``r % n_model``) with the process groups of its row and column.

* axis ``"data"``  -- the corpus/document axis: index shards, signal batches;
* axis ``"model"`` -- the model axis: tensor, sequence and expert parallelism
  and ring attention.  A pipeline names it ``"stage"``
  (``make_mesh(..., axes=("data", "stage"))``), as the reference's PP grid does.

The collectives here (:meth:`Mesh.all_gather`, :meth:`Mesh.broadcast`,
:meth:`Mesh.scatter`, :func:`all_reduce`, the point-to-point
:func:`isend`/:func:`irecv` and :func:`ring_shift`) are what the
reference's ``shard_map`` bodies do with ``lax.all_gather``, ``psum``,
``ppermute`` and ``device_put``.  A gloo group takes host tensors: for a
gloo group the helpers copy a CUDA tensor to the host, run the collective
there and copy the result back (the rule is the group's backend, not a
retry).  A single-device mesh has no process group; its collectives are the
identity, so the meshless code path and a one-device mesh agree.

The model axis needs collectives that autograd can see, written here as
``torch.autograd.Function`` (Megatron's mappings):

* :func:`copy_to_group` (Megatron's *f*): identity forward, all-reduce backward;
* :func:`reduce_from_group` (*g*): all-reduce forward, identity backward.
  ``torch.distributed.nn.functional.all_reduce`` is not *g*: its backward
  all-reduces a gradient that is already replicated, which multiplies it by
  the group size;
* :func:`gather_from_group`: all-gather along a dim; backward the slice, or
  the reduce-scatter where each rank used the gathered tensor differently
  (sequence parallelism);
* :func:`scatter_to_group`: its inverse, the slice or the reduce-scatter
  forward and the all-gather backward.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

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

    ``axes`` names the grid's two axes (``("data", "model")``, or
    ``("data", "stage")`` for a pipeline); ``groups`` maps an axis to the
    process group of this rank's column (the first axis) or row (the
    second), or ``None`` where the axis has one rank and no process group
    exists.  ``device`` is where this rank's shard lives."""

    n_data: int
    n_model: int
    rank: int
    device: torch.device
    groups: Dict[str, Any] = field(default_factory=dict)
    axes: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axes[0]: self.n_data, self.axes[1]: self.n_model}

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

    def index(self, axis: str) -> int:
        """This rank's position on ``axis`` (0 on an axis the mesh lacks)."""
        if axis == self.axes[0]:
            return self.data_index
        return self.model_index if axis == self.axes[1] else 0

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


def broadcast(t: torch.Tensor, group: Any, src: int = 0) -> torch.Tensor:
    """``t`` of the group's rank ``src`` (the first by default), copied into
    ``t`` on every rank."""
    if group is None:
        return t
    root = dist.get_global_rank(group, src)
    src = _stage(t, group)
    dist.broadcast(src, src=root, group=group)
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


def all_reduce(t: torch.Tensor, group: Any) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``group``, as a new tensor on
    ``t``'s device; ``t`` itself without a group."""
    if group is None:
        return t
    src = _stage(t, group)
    if src.data_ptr() == t.data_ptr():
        src = src.clone()
    dist.all_reduce(src, group=group)
    return src.to(device=t.device, dtype=t.dtype)


def reduce_scatter(t: torch.Tensor, group: Any, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every rank's ``t``.
    An all-reduce and a slice: gloo has no reduce-scatter in every PyTorch
    release, and one code path serves both backends."""
    return _block(all_reduce(t, group), group, dim)


def _block(t: torch.Tensor, group: Any, dim: int) -> torch.Tensor:
    """This rank's contiguous block of ``t`` along ``dim``."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split over {n} ranks")
    per = t.shape[dim] // n
    return t.narrow(dim, dist.get_rank(group) * per, per).contiguous()


def group_size(group: Any) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_index(group: Any) -> int:
    return 0 if group is None else dist.get_rank(group)


class Pending:
    """Point-to-point transfers in flight: :meth:`wait` finishes them and
    returns the received tensors on their devices."""

    def __init__(self, works: List[Any], staged: List[torch.Tensor],
                 received: List[Tuple[torch.Tensor, torch.Tensor]]) -> None:
        self._works = works
        self._staged = staged          # the sent buffers, alive until the wait
        self._received = received      # (buffer, tensor of the wanted device and dtype)

    def wait(self) -> List[torch.Tensor]:
        for w in self._works:
            w.wait()
        self._staged = []
        return [buf.to(device=like.device, dtype=like.dtype) for buf, like in self._received]


def isend(t: torch.Tensor, peer: int, group: Any, tag: int = 0) -> Pending:
    """Send ``t`` to the rank at ``peer`` in ``group`` without waiting."""
    src = _stage(t, group)
    work = dist.isend(src, dist.get_global_rank(group, peer), group=group, tag=tag)
    return Pending([work], [src], [])


def irecv(like: torch.Tensor, peer: int, group: Any, tag: int = 0) -> Pending:
    """Receive a tensor of ``like``'s shape, dtype and device from the rank
    at ``peer`` in ``group``; ``wait()[0]`` is the tensor."""
    buf = _stage(torch.empty_like(like), group)
    work = dist.irecv(buf, dist.get_global_rank(group, peer), group=group, tag=tag)
    return Pending([work], [], [(buf, like)])


def ring_shift(tensors: Sequence[torch.Tensor], group: Any) -> Pending:
    """Start handing ``tensors`` one step round the ring of ``group``: each
    goes to the next rank (``(i + 1) % n``) and the previous rank's arrive
    (``(i - 1) % n``), all posted at once by ``dist.batch_isend_irecv``.
    ``wait()`` returns the arrived tensors.  A group of one (or none) does no
    point-to-point: its own tensors come back."""
    n = group_size(group)
    if n == 1:
        return Pending([], [], [(t, t) for t in tensors])
    i = group_index(group)
    nxt = dist.get_global_rank(group, (i + 1) % n)
    prv = dist.get_global_rank(group, (i - 1) % n)
    ops, staged, received = [], [], []
    for tag, t in enumerate(tensors):
        src = _stage(t, group)
        buf = torch.empty_like(src)
        ops.append(dist.P2POp(dist.isend, src, nxt, group=group, tag=tag))
        ops.append(dist.P2POp(dist.irecv, buf, prv, group=group, tag=tag))
        staged.append(src)
        received.append((buf, t))
    return Pending(dist.batch_isend_irecv(ops), staged, received)


# ---- collectives that autograd sees (Megatron's mappings) --------------------


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: Any) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> Any:
        return all_reduce(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: Any) -> torch.Tensor:
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> Any:
        return grad, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, dim: int, group: Any, reduce_grad: bool) -> torch.Tensor:
        ctx.dim, ctx.group, ctx.reduce_grad = dim, group, reduce_grad
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> Any:
        if ctx.reduce_grad:
            return reduce_scatter(grad, ctx.group, ctx.dim), None, None, None
        return _block(grad, ctx.group, ctx.dim), None, None, None


class _ScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, dim: int, group: Any, reduce: bool) -> torch.Tensor:
        ctx.dim, ctx.group = dim, group
        return reduce_scatter(x, group, dim) if reduce else _block(x, group, dim)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> Any:
        return all_gather(grad.contiguous(), ctx.group, ctx.dim), None, None, None


def copy_to_group(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Megatron's *f*: ``x`` forward; the backward sums the gradient over
    ``group`` (``x`` feeds every rank's shard of a split layer)."""
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Megatron's *g*: the sum of every rank's ``x`` forward; the gradient,
    already replicated, passes through unchanged."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, dim: int, group: Any,
                      reduce_grad: bool = False) -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim`` in group order.  The backward
    is this rank's block of the gradient, or with ``reduce_grad`` the block
    of its sum over the group (where each rank used the gathered tensor for
    its own part, as sequence parallelism does)."""
    return x if group is None else _GatherFromGroup.apply(x, dim, group, reduce_grad)


def scatter_to_group(x: torch.Tensor, dim: int, group: Any, reduce: bool = False) -> torch.Tensor:
    """The inverse of :func:`gather_from_group`: this rank's block of ``x``
    along ``dim`` (with ``reduce``: of the sum of every rank's ``x``); the
    backward all-gathers the gradient."""
    return x if group is None else _ScatterToGroup.apply(x, dim, group, reduce)


def mark_sharded(param: torch.Tensor, group: Any) -> torch.Tensor:
    """Record that ``param`` holds this rank's shard over ``group`` (the
    gradient clip sums its squares over the group; a checkpoint refuses it)."""
    param.shard_group = group
    return param


def shard_group(param: torch.Tensor) -> Any:
    """The group a parameter is sharded over (:func:`mark_sharded`), else ``None``."""
    return getattr(param, "shard_group", None)


def _groups(world: int, rank: int, n_data: int, n_model: int,
            axes: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)) -> Dict[str, Any]:
    """The process groups of this rank's column (the first axis) and row
    (the second).

    Every rank creates every group, in one order, as ``dist.new_group``
    requires; an axis that spans the world uses the default group."""
    cols, rows = axes
    groups: Dict[str, Any] = {cols: None, rows: None}
    if n_data > 1 or world == 1:
        if n_model == 1:
            groups[cols] = dist.group.WORLD
        else:
            for j in range(n_model):
                g = dist.new_group([i * n_model + j for i in range(n_data)])
                if rank % n_model == j:
                    groups[cols] = g
    if n_model > 1 or world == 1:
        if n_data == 1:
            groups[rows] = dist.group.WORLD
        else:
            for i in range(n_data):
                g = dist.new_group([i * n_model + j for j in range(n_model)])
                if rank // n_model == i:
                    groups[rows] = g
    return groups


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device: DeviceLike = None,
              axes: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)) -> Mesh:
    """A two-axis mesh over the ranks of the default process group.

    ``n_data=None`` takes ``world / n_model``.  ``axes`` names the two axes
    (``("data", "stage")`` for a pipeline).  Without a process group the
    world is this one process (:func:`single_device_mesh`).  ``device=None``
    puts this rank on its card (``cuda:<LOCAL_RANK>`` modulo the cards);
    pass ``device="cpu"`` for a CPU mesh (gloo).
    """
    n_model = int(n_model)
    axes = (str(axes[0]), str(axes[1]))
    if axes[0] == axes[1]:
        raise ValueError(f"the mesh's axes must differ, got {axes}")
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} devices")
    if world == 1 and not (dist.is_available() and dist.is_initialized()):
        return single_device_mesh(device, axes)
    return Mesh(int(n_data), n_model, rank, _local_device(rank, device),
                _groups(world, rank, int(n_data), n_model, axes), axes)


def single_device_mesh(device: DeviceLike = None,
                       axes: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)) -> Mesh:
    """A world of one: no process group, every collective the identity."""
    return Mesh(1, 1, 0, _local_device(0, device), {axes[0]: None, axes[1]: None}, tuple(axes))


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
           "data_sharding", "replicated", "all_gather", "broadcast", "scatter", "all_reduce",
           "reduce_scatter", "isend", "irecv", "ring_shift", "Pending", "copy_to_group",
           "reduce_from_group", "gather_from_group", "scatter_to_group", "mark_sharded",
           "shard_group", "group_size", "group_index", "check_mesh", "mesh_device"]
