"""Tensor parallelism of the transformer backbones over the model axis.

Counterpart of ``dewi_tpu/parallel/tp.py``: the Megatron layout over the
``model`` axis.

* attention q/k/v and MLP ``fc_in`` are column-parallel: each rank holds a
  block of their output features, biases split with them;
* attention ``out`` and MLP ``fc_out`` are row-parallel: each rank holds the
  matching block of their input features and produces a partial sum, which
  Megatron's *g* (``mesh.reduce_from_group``) adds up over the group; the
  bias is added once, after the sum;
* embeddings and LayerNorms are replicated.  A layer's input passes through
  Megatron's *f* (``mesh.copy_to_group``), so its gradient sums the ranks'
  parts.

The reference splits each head's features (``f`` of its ``[d, h, f]``
kernels) and lets GSPMD all-reduce the partial ``QK^T``; the port's
attention holds ``nn.Linear(d, d)`` weights, so it splits whole heads, and
each rank runs ordinary attention on its heads.  The outputs agree.  A
layer whose split does not divide (``n_heads`` or ``d_ff`` by the axis
size) stays replicated, the reference's fallback.

:func:`shard_params` returns a copy of the model, the same module tree with
the same parameter names, holding this rank's slices; its forward is the
model's, and every rank of the model group runs it together.  Sharded
parameters are marked (``mesh.mark_sharded``) for the gradient clip.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.transformer import MLP, Attention, attend, dense, merge_heads
from .mesh import (MODEL_AXIS, Mesh, copy_to_group, group_index, group_size, mark_sharded,
                   reduce_from_group)

# parameter name suffix -> the dim of the [out, in] weight (or [out] bias) split over the axis
_COLUMN = ("attn.query.weight", "attn.query.bias", "attn.key.weight", "attn.key.bias",
           "attn.value.weight", "attn.value.bias", "mlp.fc_in.weight", "mlp.fc_in.bias")
_ROW = ("attn.out.weight", "mlp.fc_out.weight")


def _spec_for(name: str, ndim: int) -> Tuple[Optional[str], ...]:
    if name.endswith(_COLUMN):
        return (MODEL_AXIS,) + (None,) * (ndim - 1)
    if name.endswith(_ROW):
        return (None, MODEL_AXIS)
    return ()


def param_specs(model: nn.Module) -> Dict[str, Tuple[Optional[str], ...]]:
    """The TP layout of ``model``'s parameters: ``spec[i]`` names the mesh
    axis that splits dim ``i`` into contiguous blocks; ``()`` is replicated.
    Column-parallel weights ``[out, in]`` and their biases split dim 0,
    row-parallel weights dim 1."""
    return {name: _spec_for(name, p.ndim) for name, p in model.named_parameters()}


def _slice_linear(lin: nn.Linear, dim: int, n: int, i: int, group: Any,
                  split_bias: bool) -> nn.Linear:
    """A ``Linear`` holding block ``i`` of ``n`` of ``lin``'s weight along
    ``dim`` (and of its bias with ``split_bias``)."""
    w = lin.weight.detach().chunk(n, dim=dim)[i]
    out = nn.Linear(w.shape[1], w.shape[0], bias=lin.bias is not None,
                    device=w.device, dtype=w.dtype)
    with torch.no_grad():
        out.weight.copy_(w)
        mark_sharded(out.weight, group)
        if lin.bias is not None:
            out.bias.copy_(lin.bias.detach().chunk(n, dim=0)[i] if split_bias else lin.bias)
            if split_bias:
                mark_sharded(out.bias, group)
    return out


class TensorParallelAttention(Attention):
    """``Attention`` over this rank's ``n_heads / n`` heads."""

    def __init__(self, attn: Attention, group: Any) -> None:
        nn.Module.__init__(self)
        n, i = group_size(group), group_index(group)
        self.cfg, self.group = attn.cfg, group
        self.n_heads, self.head_dim = attn.n_heads // n, attn.head_dim
        for name in ("query", "key", "value"):
            setattr(self, name, _slice_linear(getattr(attn, name), 0, n, i, group, True))
        self.out = _slice_linear(attn.out, 1, n, i, group, False)

    def partial(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """This rank's heads through its rows of ``out``, before the sum
        over the group and without the bias."""
        dt = self.cfg.compute_dtype
        o = merge_heads(attend(*self.qkv(x), mask, dt))
        return F.linear(o.to(dt), self.out.weight.to(dt))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = reduce_from_group(self.partial(copy_to_group(x, self.group), mask), self.group)
        return y + self.out.bias.to(self.cfg.compute_dtype)


class TensorParallelMLP(MLP):
    """``MLP`` over this rank's ``d_ff / n`` hidden features."""

    def __init__(self, mlp: MLP, group: Any) -> None:
        nn.Module.__init__(self)
        n, i = group_size(group), group_index(group)
        self.cfg, self.group, self.act = mlp.cfg, group, mlp.act
        self.fc_in = _slice_linear(mlp.fc_in, 0, n, i, group, True)
        self.fc_out = _slice_linear(mlp.fc_out, 1, n, i, group, False)

    def partial(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        h = self.act(dense(self.fc_in, x, dt))
        return F.linear(h.to(dt), self.fc_out.weight.to(dt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = reduce_from_group(self.partial(copy_to_group(x, self.group)), self.group)
        return y + self.fc_out.bias.to(self.cfg.compute_dtype)


def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """A copy of ``model`` on the mesh's device whose attention and MLP
    layers hold this rank's tensor-parallel slices over the ``model`` axis.

    A layer whose heads (attention) or hidden features (MLP) do not divide
    by the axis size stays replicated.  Every rank of the model group must
    call the copy's forward together."""
    group = mesh.group(MODEL_AXIS)
    n = group_size(group)
    out = copy.deepcopy(model).to(mesh.device)
    for mod in list(out.modules()):
        for name, child in list(mod.named_children()):
            if type(child) is Attention and child.n_heads % n == 0:
                setattr(mod, name, TensorParallelAttention(child, group))
            elif type(child) is MLP and child.cfg.d_ff % n == 0:
                setattr(mod, name, TensorParallelMLP(child, group))
    return out


__all__ = ["param_specs", "shard_params", "TensorParallelAttention", "TensorParallelMLP"]
