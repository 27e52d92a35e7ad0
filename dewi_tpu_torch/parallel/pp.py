"""Pipeline parallelism: the GPipe microbatch schedule over a ``stage`` axis.

Counterpart of ``dewi_tpu/parallel/pp.py``.

* Layers are **stacked**: :func:`stack_block_params` turns a ``CausalLM``'s
  blocks into one state dict whose entries carry a leading ``[L, ...]``
  layer axis (the reference's stacked leaves, in the port's names;
  ``convert.stacked_blocks_from_flax`` carries the reference's across), and
  ``rest``: the embeddings and the final LayerNorm.  Checkpoints cross both
  ways through :func:`unstack_block_params`.
* Each stage holds its ``L/S`` blocks as an ``nn.ModuleList``
  (:func:`shard_stacked_params`).
* Forward, stage ``s`` runs microbatch ``m`` once stage ``s-1`` has handed
  it over and hands its activation to stage ``s+1`` (``mesh.isend`` /
  ``mesh.irecv``): the reference's ``M + S - 1`` ticks, stage ``s`` on
  microbatch ``t - s`` at tick ``t``.  The last stage's outputs reach every
  stage, the reference's ``psum`` over stages.
* Backward (:func:`pp_loss_and_grads`) runs the reverse schedule: the last
  stage takes the loss's gradient, each stage receives the output
  gradients of its microbatches from the next, runs ``backward`` on the
  outputs it kept and sends the input gradients back.  The head is tied to
  ``wte``, which stage 0 uses for the embedding: the ``rest`` gradients are
  summed over the stage group, so every rank applies one update.  The loss
  is normalized by the global count of valid tokens, and gradients are
  summed over the data group.
* ``remat=True`` recomputes each block in the backward
  (``torch.utils.checkpoint``, non-reentrant).

A ``(data, stage)`` mesh is ``make_mesh(n_data, n_stages, axes=("data",
"stage"))``; a stage-only one has ``n_data=1``.  Every rank of the mesh
calls these functions together, with the same ``ids``.  The bubble is
GPipe's ``(S-1)/(M+S-1)``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..models.lm import token_nll
from ..models.transformer import Block, TransformerConfig, make_attention_mask
from .mesh import (DATA_AXIS, Mesh, Pending, all_gather, all_reduce, broadcast, group_index,
                   group_size, irecv, isend)

_BLOCK = "encoder.block_"


# -- param restructuring -------------------------------------------------------


def stack_block_params(params: Any, n_layers: int) -> Tuple[Dict[str, torch.Tensor],
                                                            Dict[str, torch.Tensor]]:
    """Split a ``CausalLM`` (or its state dict) into ``(stacked, rest)``.

    ``stacked`` maps each parameter name of one ``Block`` (``"attn.query.weight"``,
    ...) to the ``[L, ...]`` stack of the blocks' tensors; ``rest`` holds
    every other entry (``wte``, ``wpe``, ``encoder.ln_final``)."""
    state = params.state_dict() if isinstance(params, nn.Module) else dict(params)
    first = f"{_BLOCK}0."
    names = [k[len(first):] for k in state if k.startswith(first)]
    stacked = {k: torch.stack([state[f"{_BLOCK}{i}.{k}"].detach() for i in range(n_layers)])
               for k in names}
    rest = {k: v.detach() for k, v in state.items() if not k.startswith(_BLOCK)}
    return stacked, rest


def unstack_block_params(stacked: Mapping[str, torch.Tensor], rest: Mapping[str, torch.Tensor],
                         n_layers: int) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`stack_block_params`: a ``CausalLM`` state dict."""
    out = dict(rest)
    for i in range(n_layers):
        out.update({f"{_BLOCK}{i}.{k}": v[i] for k, v in stacked.items()})
    return out


def shard_stacked_params(cfg: TransformerConfig, stacked: Mapping[str, torch.Tensor], mesh: Mesh,
                         stage_axis: str = "stage") -> nn.ModuleList:
    """This stage's ``L/S`` consecutive blocks, loaded from the stacked
    params, on the mesh's device (``cfg`` builds the ``Block``)."""
    n_stages, s = mesh.shape[stage_axis], mesh.index(stage_axis)
    n_layers = next(iter(stacked.values())).shape[0]
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split over {n_stages} stages")
    per = n_layers // n_stages
    blocks = nn.ModuleList(Block(cfg) for _ in range(per))
    for j, blk in enumerate(blocks):
        blk.load_state_dict({k: v[s * per + j] for k, v in stacked.items()}, strict=True)
    return blocks.to(mesh.device)


# -- embedding / head (the reference's, functional over ``rest``) --------------


def _embed(rest: Mapping[str, torch.Tensor], ids: torch.Tensor,
           cfg: TransformerConfig) -> torch.Tensor:
    dt = cfg.compute_dtype
    pos = torch.arange(ids.shape[-1], device=ids.device)
    return rest["wte.weight"][ids].to(dt) + rest["wpe.weight"][pos][None].to(dt)


def _head(rest: Mapping[str, torch.Tensor], x: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    dt = cfg.compute_dtype
    h = F.layer_norm(x.to(torch.float32), (cfg.d_model,), rest["encoder.ln_final.weight"],
                     rest["encoder.ln_final.bias"], cfg.ln_eps)
    # float32 accumulation over compute-dtype operands
    return torch.matmul(h.to(dt).to(torch.float32), rest["wte.weight"].to(dt).to(torch.float32).T)


# -- the schedule --------------------------------------------------------------


def _run_blocks(blocks: nn.ModuleList, x: torch.Tensor, mask: torch.Tensor,
                remat: bool) -> torch.Tensor:
    for blk in blocks:
        if remat and torch.is_grad_enabled():
            x = checkpoint(blk, x, mask, use_reentrant=False)
        else:
            x = blk(x, mask)
    return x


def _forward_schedule(blocks: nn.ModuleList, inputs: Callable[[int], torch.Tensor],
                      masks: torch.Tensor, like: torch.Tensor, group: Any, remat: bool,
                      keep: bool) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The stage's side of the GPipe forward over ``len(masks)``
    microbatches: ``(inputs, outputs)``.  Stage 0 reads ``inputs(m)``, the
    others receive from the previous stage; each hands its output to the
    next.  With ``keep`` every input is a leaf that requires grad, and the
    outputs keep their graphs for the backward."""
    n, s = group_size(group), group_index(group)
    ins, outs, sends = [], [], []
    for m in range(len(masks)):
        x = inputs(m) if s == 0 else irecv(like, s - 1, group, tag=m).wait()[0]
        if keep:
            x = x.detach().requires_grad_(True)
            ins.append(x)
        y = _run_blocks(blocks, x, masks[m], remat)
        outs.append(y)
        if s < n - 1:
            sends.append(isend(y.detach(), s + 1, group, tag=m))
    for p in sends:
        p.wait()
    return ins, outs


def _microbatches(t: torch.Tensor, n_microbatches: int, mesh: Mesh,
                  data_axis: Optional[str]) -> torch.Tensor:
    """``[B, ...]`` -> this data rank's ``[M, Bmb / n_data, ...]`` (the
    reference shards each microbatch's rows over ``data``)."""
    b = t.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} must divide into {n_microbatches} microbatches")
    t = t.reshape(n_microbatches, b // n_microbatches, *t.shape[1:])
    n_data = mesh.shape.get(data_axis, 1) if data_axis else 1
    if t.shape[1] % n_data:
        raise ValueError(f"microbatch of {t.shape[1]} rows does not split over {n_data} data ranks")
    per = t.shape[1] // n_data
    r = mesh.index(data_axis) * per if n_data > 1 else 0
    return t[:, r:r + per]


def _data_group(mesh: Mesh, data_axis: Optional[str]) -> Any:
    return mesh.group(data_axis) if data_axis and mesh.shape.get(data_axis, 1) > 1 else None


@torch.no_grad()
def pipeline_blocks(cfg: TransformerConfig, blocks: nn.ModuleList, x_mb: torch.Tensor,
                    attn_mb: torch.Tensor, mesh: Mesh, stage_axis: str = "stage",
                    data_axis: Optional[str] = DATA_AXIS, remat: bool = True) -> torch.Tensor:
    """Run the block stack as a GPipe pipeline (forward only).

    ``x_mb [M, Bmb, T, D]``: the embedded microbatches; ``attn_mb [M, Bmb,
    1, T, T]``: their attention masks; each microbatch's rows shard over
    ``data_axis`` when the mesh has it.  ``blocks``: this stage's
    (:func:`shard_stacked_params`).  Returns ``[M, Bmb, T, D]`` on every
    rank."""
    del cfg  # the blocks carry it
    group = mesh.group(stage_axis)
    n_data = mesh.shape.get(data_axis, 1) if data_axis else 1
    per = x_mb.shape[1] // n_data
    r = mesh.index(data_axis) * per if n_data > 1 else 0
    x_loc = x_mb[:, r:r + per].to(mesh.device)
    masks = attn_mb[:, r:r + per].to(mesh.device)
    _, outs = _forward_schedule(blocks, lambda m: x_loc[m], masks, x_loc[0], group, remat,
                                keep=False)
    y = broadcast(torch.stack(outs), group, src=group_size(group) - 1)
    return all_gather(y, _data_group(mesh, data_axis), dim=1)


@torch.no_grad()
def pipelined_lm_logits(cfg: TransformerConfig, blocks: nn.ModuleList,
                        rest: Mapping[str, torch.Tensor], ids: Any, pad_mask: Any, mesh: Mesh,
                        n_microbatches: int, stage_axis: str = "stage",
                        data_axis: Optional[str] = DATA_AXIS, remat: bool = True) -> torch.Tensor:
    """The ``CausalLM`` forward with the block stack pipelined: logits
    ``[B, T, V]`` (float32) on every rank.  Gradients come from
    :func:`pp_loss_and_grads`."""
    ids = torch.as_tensor(ids).to(mesh.device).long()
    pad = torch.as_tensor(pad_mask).to(mesh.device)
    b, t = ids.shape
    if b % n_microbatches:
        raise ValueError(f"batch {b} must divide into {n_microbatches} microbatches")
    x = _embed(rest, ids, cfg).reshape(n_microbatches, b // n_microbatches, t, -1)
    attn = make_attention_mask(pad.to(torch.bool), cfg.causal)
    attn = attn.reshape(n_microbatches, b // n_microbatches, *attn.shape[1:])
    y = pipeline_blocks(cfg, blocks, x, attn, mesh, stage_axis, data_axis, remat)
    return _head(rest, y.reshape(b, t, -1), cfg)


def pp_loss_and_grads(cfg: TransformerConfig, blocks: nn.ModuleList,
                      rest: Mapping[str, torch.Tensor], ids: Any, pad_mask: Any, mesh: Mesh,
                      n_microbatches: int, stage_axis: str = "stage",
                      data_axis: Optional[str] = DATA_AXIS, remat: bool = True) -> torch.Tensor:
    """The mean next-token NLL over the batch's valid tokens, with its
    gradients accumulated into ``.grad`` of this stage's blocks and of the
    ``rest`` tensors that require grad (summed over the stage and data
    groups, so every rank holds the full gradient of what it holds).
    Returns the loss on every rank."""
    ids = torch.as_tensor(ids).to(mesh.device).long()
    pad = torch.as_tensor(pad_mask).to(mesh.device)
    group = mesh.group(stage_axis)
    dgroup = _data_group(mesh, data_axis)
    n, s = group_size(group), group_index(group)
    ids_mb = _microbatches(ids, n_microbatches, mesh, data_axis)      # [M, b, T]
    pad_mb = _microbatches(pad, n_microbatches, mesh, data_axis)
    m_, b, t = ids_mb.shape
    masks = make_attention_mask(pad_mb.reshape(m_ * b, t).to(torch.bool), cfg.causal)
    masks = masks.reshape(m_, b, *masks.shape[1:])
    count = all_reduce(pad_mb[:, :, 1:].to(torch.float32).sum(), dgroup).clamp_min(1.0)

    x_emb = _embed(rest, ids_mb.reshape(m_ * b, t), cfg).reshape(m_, b, t, -1) if s == 0 else None
    like = torch.empty((b, t, cfg.d_model), dtype=cfg.compute_dtype, device=mesh.device)
    ins, outs = _forward_schedule(blocks, lambda m: x_emb[m], masks, like, group, remat, keep=True)

    sends: List[Pending] = []
    loss = torch.zeros((), device=mesh.device)
    if s == n - 1:
        logits = _head(rest, torch.cat(outs), cfg)
        nll, valid = token_nll(logits, ids_mb.reshape(m_ * b, t), pad_mb.reshape(m_ * b, t))
        part = (nll * valid.to(torch.float32)).sum() / count
        part.backward()
        loss = part.detach()
    for m in reversed(range(m_)):
        if s < n - 1:
            grad = irecv(outs[m], s + 1, group, tag=m_ + m).wait()[0]
            torch.autograd.backward(outs[m], grad)
        if s > 0:
            sends.append(isend(ins[m].grad, s - 1, group, tag=m_ + m))
    if s == 0:
        torch.autograd.backward(x_emb, torch.stack([x.grad for x in ins]))
    for p in sends:
        p.wait()

    for t_ in rest.values():
        if t_.requires_grad:
            g = t_.grad if t_.grad is not None else torch.zeros_like(t_)
            t_.grad = all_reduce(all_reduce(g, group), dgroup)
    if dgroup is not None:
        for p in blocks.parameters():
            if p.grad is not None:
                p.grad = all_reduce(p.grad, dgroup)
    return broadcast(all_reduce(loss, dgroup).contiguous(), group, src=n - 1)


def pp_train_step(cfg: TransformerConfig, optimizer: torch.optim.Optimizer, mesh: Mesh,
                  n_microbatches: int, stage_axis: str = "stage",
                  data_axis: Optional[str] = DATA_AXIS, remat: bool = True
                  ) -> Callable[..., torch.Tensor]:
    """A pipeline-parallel LM training step.

    ``optimizer`` updates this stage's blocks and the ``rest`` tensors
    (leaves that require grad).  Returns ``step((blocks, rest), ids,
    pad_mask) -> loss``, which updates them in place; the gradients have
    the stage's layout, so the optimizer's state stays with its stage."""

    def step(params: Tuple[nn.ModuleList, Mapping[str, torch.Tensor]], ids: Any,
             pad_mask: Any) -> torch.Tensor:
        blocks, rest = params
        optimizer.zero_grad(set_to_none=True)
        loss = pp_loss_and_grads(cfg, blocks, rest, ids, pad_mask, mesh, n_microbatches,
                                 stage_axis, data_axis, remat)
        optimizer.step()
        return loss

    return step


__all__ = [
    "stack_block_params",
    "unstack_block_params",
    "shard_stacked_params",
    "pipeline_blocks",
    "pipelined_lm_logits",
    "pp_loss_and_grads",
    "pp_train_step",
]
