"""Sequence (context) parallelism for the LM surprisal path.

Counterpart of ``dewi_tpu/parallel/sp.py``.  The reference shards a token
batch as ``(batch=data, sequence=model)`` and lets GSPMD derive the
attention collectives.  Here each rank of the ``model`` group runs its
``T/n`` tokens through the blocks with their global positions:

* every token-pointwise layer (embeddings, LayerNorms, MLPs, the head)
  runs on the rank's tokens alone;
* attention all-gathers K, V and the pad mask over the group
  (``mesh.gather_from_group`` with a reduce-scatter backward), and the
  rank's queries attend to the whole sequence under the causal mask of
  their global positions;
* the NLL of the rank's last position takes its target across the shard
  boundary, from the full ``ids`` every rank holds.

With a model from ``tp.shard_params`` the two compose the Megatron way,
over the same group: the sequence is all-gathered before the
column-parallel layers, each rank runs its heads or hidden features over
the whole sequence, and the row-parallel partial sums are reduce-scattered
back to the rank's tokens (instead of all-reduced), the bias added after.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import nn

from ..models.transformer import attend, dense, layer_norm, merge_heads
from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, all_gather, gather_from_group,
                   scatter_to_group)
from .tp import TensorParallelAttention, TensorParallelMLP


def shard_tokens(ids: Any, mask: Any, mesh: Mesh,
                 seq_axis: Optional[str] = MODEL_AXIS) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's ``[B/n_data, T/n_seq]`` block of a ``[B, T]`` token batch
    and its mask, on the mesh's device.  ``B`` must divide by the data axis
    and ``T`` by ``seq_axis`` (``None``: shard only the batch)."""
    ids, mask = torch.as_tensor(ids), torch.as_tensor(mask)
    b, t = ids.shape
    n_data = mesh.shape.get(DATA_AXIS, 1)
    n_seq = mesh.shape[seq_axis] if seq_axis else 1
    if b % n_data or t % n_seq:
        raise ValueError(f"batch [{b}, {t}] does not split over a {n_data} x {n_seq} mesh")
    bl, tl = b // n_data, t // n_seq
    r = mesh.index(DATA_AXIS) * bl
    c = (mesh.index(seq_axis) if seq_axis else 0) * tl
    return (ids[r:r + bl, c:c + tl].to(mesh.device), mask[r:r + bl, c:c + tl].to(mesh.device))


def _sp_attention(attn: nn.Module, x: torch.Tensor, mask: torch.Tensor, group: Any) -> torch.Tensor:
    """Attention for the rank's tokens ``x [b, T/n, d]``: K, V gathered over
    ``group``; ``mask [b, 1, T/n, T]``."""
    dt = attn.cfg.compute_dtype
    q, k, v = attn.qkv(x)
    k, v = (gather_from_group(t, 2, group, reduce_grad=True) for t in (k, v))
    return dense(attn.out, merge_heads(attend(q, k, v, mask, dt)), dt)


def _sp_tp(layer: nn.Module, x: torch.Tensor, group: Any, *mask: torch.Tensor) -> torch.Tensor:
    """A tensor-parallel layer under sequence parallelism: the sequence
    gathered before its column-parallel half, its row-parallel partial sums
    reduce-scattered back to the rank's tokens, then the bias."""
    full = gather_from_group(x, 1, group, reduce_grad=True)
    y = scatter_to_group(layer.partial(full, *mask), 1, group, reduce=True)
    bias = layer.out.bias if isinstance(layer, TensorParallelAttention) else layer.fc_out.bias
    return y + bias.to(layer.cfg.compute_dtype)


def sequence_sharded_nll(model: nn.Module, ids: Any, mask: Any, mesh: Mesh,
                         seq_axis: str = MODEL_AXIS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token NLL of a ``CausalLM`` (or its ``tp.shard_params`` copy) with
    the sequence sharded over ``seq_axis`` and the batch over ``data``.

    ``ids``/``mask``: the global ``[B, T]`` batch, the same on every rank.
    Returns the reference's global ``(nll [B, T-1], valid [B, T-1])`` on
    every rank; the values are the replicated forward's.  Every rank of the
    mesh calls it together.
    """
    cfg = model.cfg
    dt = cfg.compute_dtype
    group = mesh.group(seq_axis)
    ids_t = torch.as_tensor(ids).to(mesh.device).long()
    mask_t = torch.as_tensor(mask).to(mesh.device)
    ids_l, mask_l = shard_tokens(ids_t, mask_t, mesh, seq_axis)
    b, tl = ids_l.shape
    start = mesh.index(seq_axis) * tl
    qpos = start + torch.arange(tl, device=mesh.device)
    pad = all_gather(mask_l.to(torch.bool), group, dim=1)                 # [b, T]
    kpos = torch.arange(pad.shape[1], device=mesh.device)
    attn_mask = pad[:, None, None, :].expand(-1, 1, tl, -1)               # [b, 1, T/n, T]
    if cfg.causal:
        attn_mask = attn_mask & (kpos[None, :] <= qpos[:, None])
    x = model.wte.weight.to(dt)[ids_l] + model.wpe.weight.to(dt)[qpos][None]
    full_mask = None
    for i in range(cfg.n_layers):
        blk = getattr(model.encoder, f"block_{i}")
        h = layer_norm(blk.ln_attn, x)
        if isinstance(blk.attn, TensorParallelAttention):
            if full_mask is None:
                full_mask = all_gather(attn_mask, group, dim=2)            # [b, 1, T, T]
            x = x + _sp_tp(blk.attn, h, group, full_mask)
        else:
            x = x + _sp_attention(blk.attn, h, attn_mask, group)
        h = layer_norm(blk.ln_mlp, x)
        x = x + (_sp_tp(blk.mlp, h, group) if isinstance(blk.mlp, TensorParallelMLP)
                 else blk.mlp(h))
    x = layer_norm(model.encoder.ln_final, x)
    logits = torch.matmul(x.to(dt), model.wte.weight.to(dt).T).to(torch.float32)
    rows = slice(mesh.index(DATA_AXIS) * b, (mesh.index(DATA_AXIS) + 1) * b)
    nxt = torch.cat([ids_t[rows], torch.zeros_like(ids_t[rows, :1])], dim=1)
    targets = nxt[:, start + 1:start + tl + 1]
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(logits, -1, targets[..., None]).squeeze(-1)
    nll = gather_from_group(nll, 1, group)
    nll = gather_from_group(nll, 0, mesh.group(DATA_AXIS))[:, :-1]
    return nll, mask_t[:, 1:].to(torch.bool)


__all__ = ["shard_tokens", "sequence_sharded_nll"]
