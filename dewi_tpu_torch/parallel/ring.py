"""Ring attention: exact attention over a sequence too long for one device.

Counterpart of ``dewi_tpu/parallel/ring.py``, the multi-device path for
long-document surprisal: the whole context stays exact where one device
would score overlapping windows.

* Each rank of the axis group holds a ``[B, H, T/S, Dh]`` block of Q, K, V.
* Step ``i`` works on the K/V block ``(sid - i) % S``; after each step K, V
  and the key pad mask move one rank round the ring (``mesh.ring_shift``:
  one ``isend`` to the next rank, one ``irecv`` from the previous).  The
  shift of the next block is posted before the block's matmuls and waited
  for after them, so the transfer overlaps the compute.
* Attention is the reference's online softmax (running max, normalizer and
  accumulator in float32, ``NEG_INF`` for masked keys, a safe max for rows
  that have seen no key), so nothing of size ``[T, T]`` materializes.
* Causal and pad masks use global positions from the rank's block.  Under a
  causal mask a block that lies wholly after the rank's queries contributes
  nothing (its scores are all ``NEG_INF``), so its matmuls are skipped.

The forward (:func:`ring_lm_logits`) mirrors the reference's: embeddings in
the compute dtype, float32 LayerNorm, q/k/v/out and the MLP in the compute
dtype, the head tied to ``wte`` with float32 accumulation, positions offset
by the rank's block.  Inference only: the shifts are not seen by autograd.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
from torch import nn

from ..models.transformer import dense, layer_norm, merge_heads
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, all_gather, ring_shift

NEG_INF = -3.4e38


def _online_block(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor, sc: torch.Tensor,
                  vb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One online-softmax update.  ``sc [..., Tq, Tk]`` float32, ``vb [..., Tk, Dh]``."""
    m_new = torch.maximum(m, sc.amax(dim=-1))
    # Rows that have seen no unmasked key yet: keep exp() well-defined.
    safe = torch.where(m_new <= NEG_INF / 2, torch.zeros_like(m_new), m_new)
    p = torch.exp(sc - safe[..., None])
    corr = torch.exp(m - safe)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.matmul(p.to(vb.dtype), vb).to(torch.float32)
    return m_new, l_new, acc_new


@torch.no_grad()
def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                   axis: str = MODEL_AXIS, causal: bool = True,
                   pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact attention with the sequence sharded over ``axis``.

    ``q``, ``k``, ``v``: this rank's ``[B, H, T/S, Dh]`` blocks (rank ``i``
    of the axis holds positions ``i*T/S ... (i+1)*T/S - 1``); ``pad_mask``:
    its ``[B, T/S]`` block, 1 for a real token.  Returns this rank's
    ``[B, H, T/S, Dh]`` float32 block of single-device softmax attention.
    Every rank of the axis group calls it together.
    """
    group = mesh.group(axis)
    n = mesh.shape[axis]
    sid = mesh.index(axis)
    b, _, tl, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    pad = (torch.ones((b, tl), device=q.device) if pad_mask is None
           else pad_mask.to(device=q.device, dtype=torch.float32))
    qpos = sid * tl + torch.arange(tl, device=q.device)
    qf = q.to(torch.float32)  # scores in float32 (the reference's preferred_element_type)
    m = torch.full(q.shape[:3], NEG_INF, device=q.device)
    l = torch.zeros(q.shape[:3], device=q.device)
    acc = torch.zeros(q.shape, device=q.device)
    kb, vb, padb = k, v, pad
    for i in range(n):
        pending = ring_shift((kb, vb, padb), group) if i < n - 1 else None
        blk = (sid - i) % n
        if not (causal and blk > sid):
            sc = torch.matmul(qf, kb.to(torch.float32).transpose(-1, -2)) * scale
            mask = padb[:, None, None, :] > 0                       # [B, 1, 1, Tk]
            if causal:
                kpos = blk * tl + torch.arange(tl, device=q.device)
                mask = mask & (kpos[None, :] <= qpos[:, None])[None, None]
            sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
            m, l, acc = _online_block(m, l, acc, sc, vb)
        if pending is not None:
            kb, vb, padb = pending.wait()
    return acc / l.clamp_min(1e-30)[..., None]


def _batch_rows(n_rows: int, mesh: Mesh) -> slice:
    """This rank's rows of a ``[B, T]`` batch: its block over the data axis
    when ``B`` divides, else every row (a ``[1, T]`` document replicates)."""
    n_data = mesh.shape.get(DATA_AXIS, 1)
    if n_data > 1 and n_rows % n_data == 0:
        per = n_rows // n_data
        return slice(mesh.index(DATA_AXIS) * per, (mesh.index(DATA_AXIS) + 1) * per)
    return slice(0, n_rows)


def _ring_hidden(model: nn.Module, ids: torch.Tensor, pad_mask: torch.Tensor, mesh: Mesh,
                 axis: str = MODEL_AXIS) -> torch.Tensor:
    """The final LayerNorm's output (float32) for this rank's block of
    ``ids``/``pad_mask`` (``[b, T/S]``, the rank's position on ``axis``
    giving their global positions)."""
    cfg = model.cfg
    dt = cfg.compute_dtype
    b, tl = ids.shape
    pos = mesh.index(axis) * tl + torch.arange(tl, device=ids.device)
    x = model.wte.weight[ids].to(dt) + model.wpe.weight[pos][None].to(dt)
    enc = model.encoder
    for i in range(cfg.n_layers):
        blk = getattr(enc, f"block_{i}")
        q, k, v = blk.attn.qkv(layer_norm(blk.ln_attn, x).to(dt))
        o = ring_attention(q, k, v, mesh, axis=axis, causal=cfg.causal, pad_mask=pad_mask)
        x = x + dense(blk.attn.out, merge_heads(o.to(dt)), dt)
        x = x + blk.mlp(layer_norm(blk.ln_mlp, x).to(dt))
    return layer_norm(enc.ln_final, x)


def _tied_head(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``x @ wte^T`` over compute-dtype operands, accumulated in float32."""
    dt = model.cfg.compute_dtype
    return torch.matmul(x.to(dt).to(torch.float32), model.wte.weight.to(dt).to(torch.float32).T)


def _local_block(ids: Any, pad_mask: Any, mesh: Mesh, axis: str = MODEL_AXIS
                 ) -> Tuple[torch.Tensor, torch.Tensor, slice]:
    """This rank's ``[b, T/S]`` block of a global ``[B, T]`` batch on the
    mesh's device, and its rows."""
    ids = torch.as_tensor(ids).to(mesh.device)
    pad_mask = torch.as_tensor(pad_mask).to(mesh.device, torch.float32)
    n = mesh.shape[axis]
    t = ids.shape[1]
    if t % n:
        raise ValueError(f"sequence of {t} does not split over {n} ranks of {axis!r}")
    tl = t // n
    rows = _batch_rows(ids.shape[0], mesh)
    cols = slice(mesh.index(axis) * tl, (mesh.index(axis) + 1) * tl)
    return ids[rows, cols].long(), pad_mask[rows, cols], rows


@torch.no_grad()
def ring_lm_logits(model: nn.Module, ids: Any, pad_mask: Any, mesh: Mesh,
                   axis: str = MODEL_AXIS) -> torch.Tensor:
    """A ``CausalLM`` forward with ring attention: exact logits ``[B, T, V]``
    (float32) for contexts longer than one device holds.

    ``ids``/``pad_mask``: the global ``[B, T]`` batch (``T`` a multiple of
    the axis size), the same on every rank.  The batch shards over
    ``data`` when ``B`` divides, else replicates.  Every rank of the mesh
    calls it together and gets the whole ``[B, T, V]``.
    """
    ids_l, pad_l, rows = _local_block(ids, pad_mask, mesh, axis)
    logits = _tied_head(model, _ring_hidden(model, ids_l, pad_l, mesh, axis))
    logits = all_gather(logits, mesh.group(axis), dim=1)
    if rows.stop - rows.start != torch.as_tensor(ids).shape[0]:
        logits = all_gather(logits, mesh.group(DATA_AXIS), dim=0)
    return logits


@torch.no_grad()
def ring_token_nll(model: nn.Module, ids: Any, pad_mask: Any, mesh: Mesh,
                   axis: str = MODEL_AXIS) -> Tuple[torch.Tensor, torch.Tensor]:
    """``token_nll`` of the ring forward without gathering the logits:
    each rank takes the NLL of its block against the next global id and
    only the ``[B, T]`` NLL is gathered.  Returns ``(nll [B, T-1],
    valid [B, T-1])`` on every rank of the mesh."""
    ids_t = torch.as_tensor(ids).to(mesh.device).long()
    pad_t = torch.as_tensor(pad_mask).to(mesh.device, torch.float32)
    ids_l, pad_l, rows = _local_block(ids_t, pad_t, mesh, axis)
    tl = ids_l.shape[1]
    start = mesh.index(axis) * tl
    # The target of the block's last position is the next block's first id;
    # the document's last position has none (dropped below).
    nxt = torch.cat([ids_t[rows], torch.zeros_like(ids_t[rows, :1])], dim=1)
    targets = nxt[:, start + 1:start + tl + 1]
    logits = _tied_head(model, _ring_hidden(model, ids_l, pad_l, mesh, axis))
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(logits, -1, targets[..., None]).squeeze(-1)
    nll = all_gather(nll, mesh.group(axis), dim=1)
    if rows.stop - rows.start != ids_t.shape[0]:
        nll = all_gather(nll, mesh.group(DATA_AXIS), dim=0)
    return nll[:, :-1], pad_t[:, 1:].to(torch.bool)


__all__ = ["ring_attention", "ring_lm_logits", "ring_token_nll"]
