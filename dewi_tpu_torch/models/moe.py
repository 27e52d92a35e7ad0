"""Mixture-of-experts FFN (Switch-style top-1), with expert parallelism.

Counterpart of ``dewi_tpu/models/moe.py``: the same routing, capacity,
parameter layout and load-balance loss, so a checkpoint crosses between
the packages (``convert.moe_lm_params_{from,to}_flax``).

* **Router in float32**: softmax over ``n_experts`` logits, top-1 expert and
  its probability as the gate.
* **Static capacity** ``cap = max(1, ceil(n / E * capacity_factor))``; a
  token's slot is its rank among the tokens routed to its expert
  (``cumsum(onehot) * onehot - onehot``), and tokens at ``slot >= cap``
  drop to zero output (the residual carries them), as in the reference.
* **Padding tokens** take no capacity and are left out of the aux
  statistics.
* **Dispatch by index**: the reference routes with ``[N, E, C]`` one-hot
  einsums; here each kept token is copied into its ``[E * cap]`` buffer row
  with ``index_add`` (a row receives at most one token, so the copy is
  exact) and the combine gathers it back, times the gate.  Dropped and
  padding tokens go to one spare zero row.
* **The aux loss** (Switch: ``E * sum(f_e * p_e)``): each ``MoEMLP`` keeps
  its last forward's value in ``aux_loss``, where the reference sows it;
  :func:`load_balance_loss` averages them over the layers.
* **Expert parallelism** (:func:`shard_expert_params`): each rank of the
  axis group keeps ``E / n`` experts of the stacked leaves; the router is
  replicated.  Routing, slots and the capacity are computed over all
  tokens, as without a mesh, so the same tokens are kept in the same slots.
  Each rank fills and runs only its experts' buffer rows, gathers its
  tokens' outputs (zero for the others) and Megatron's *g* sums them over
  the group; the gate multiplies after the sum, and the experts' input
  passes through *f*, so every replicated parameter's gradient is the
  unsharded one.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import (check_mesh, copy_to_group, group_index, group_size, mark_sharded,
                             reduce_from_group)
from .transformer import (Attention, TransformerConfig, activation_fn, layer_norm,
                          make_attention_mask)


class MoEMLP(nn.Module):
    """Top-1 routed FFN: each token is processed by one of ``n_experts``."""

    def __init__(self, cfg: TransformerConfig, n_experts: int = 4,
                 capacity_factor: float = 1.25) -> None:
        super().__init__()
        self.cfg = cfg
        self.n_experts = int(n_experts)
        self.capacity_factor = float(capacity_factor)
        e, d, ff = self.n_experts, cfg.d_model, cfg.d_ff
        self.router = nn.Linear(d, e)
        # Stacked expert weights, the reference's raw [E, ...] leaves.
        self.w_in = nn.Parameter(torch.zeros(e, d, ff))
        self.b_in = nn.Parameter(torch.zeros(e, ff))
        self.w_out = nn.Parameter(torch.zeros(e, ff, d))
        self.b_out = nn.Parameter(torch.zeros(e, d))
        self.act = activation_fn(cfg.activation)
        self.aux_loss: Optional[torch.Tensor] = None
        # Expert parallelism: this rank holds experts expert_offset ... +
        # w_in.shape[0] - 1 of n_experts, and sums outputs over expert_group.
        self.expert_offset = 0
        self.expert_group: Any = None

    def forward(self, x: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        e, e_local, lo = self.n_experts, self.w_in.shape[0], self.expert_offset
        b, t, d = x.shape
        n = b * t
        cap = max(1, int(math.ceil(n / e * self.capacity_factor)))

        xf = x.reshape(n, d)
        logits = F.linear(xf.to(torch.float32), self.router.weight, self.router.bias)
        probs = torch.softmax(logits, dim=-1)                      # [N, E]
        gate, expert = probs.max(dim=-1)                           # [N]
        onehot = F.one_hot(expert, e).to(torch.float32)            # [N, E]
        if pad_mask is not None:
            live = pad_mask.reshape(n).to(torch.float32)
            onehot = onehot * live[:, None]
            probs = probs * live[:, None]
        # The running count along the tokens, scanned as [E, N] rows (a scan
        # over the outer dim of [N, E] runs on E threads).
        pos = torch.cumsum(onehot.t(), dim=1).t() * onehot - onehot  # [N, E]
        keep = (pos < cap).to(torch.float32) * onehot              # [N, E]
        kept = keep.sum(dim=-1) > 0                                # [N]
        slot = (pos * onehot).sum(dim=-1).to(torch.int64)
        # Buffer row of each token of this rank's experts: (expert - offset)
        # * cap + slot; every other token goes to the spare row.
        mine = kept & (expert >= lo) & (expert < lo + e_local)
        row = torch.where(mine, (expert - lo) * cap + slot, torch.full_like(slot, e_local * cap))

        group = self.expert_group
        buf = torch.zeros(e_local * cap + 1, d, dtype=dt, device=x.device)
        expert_in = buf.index_add(0, row, copy_to_group(xf, group).to(dt))
        expert_in = expert_in[: e_local * cap].view(e_local, cap, d)
        h = torch.bmm(expert_in, self.w_in.to(dt)) + self.b_in[:, None, :].to(dt)
        h = self.act(h)
        h = torch.bmm(h, self.w_out.to(dt)) + self.b_out[:, None, :].to(dt)
        h = torch.cat([h.reshape(e_local * cap, d), h.new_zeros(1, d)])
        out = reduce_from_group(h.index_select(0, row), group) * gate.to(dt)[:, None]  # [N, D]

        denom = (pad_mask.to(torch.float32).sum().clamp_min(1.0) if pad_mask is not None
                 else float(n))
        frac = onehot.sum(dim=0) / denom
        prob = probs.sum(dim=0) / denom
        self.aux_loss = e * (frac * prob).sum()
        return out.reshape(b, t, d)


class MoEBlock(nn.Module):
    """Pre-LN transformer block with a routed (MoE) FFN."""

    def __init__(self, cfg: TransformerConfig, n_experts: int = 4,
                 capacity_factor: float = 1.25) -> None:
        super().__init__()
        self.ln_attn = nn.LayerNorm(cfg.d_model, eps=cfg.ln_eps)
        self.attn = Attention(cfg)
        self.ln_mlp = nn.LayerNorm(cfg.d_model, eps=cfg.ln_eps)
        self.moe = MoEMLP(cfg, n_experts, capacity_factor)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(layer_norm(self.ln_attn, x), attn_mask)
        return x + self.moe(layer_norm(self.ln_mlp, x), pad_mask)


class MoECausalLM(nn.Module):
    """``CausalLM`` with an MoE FFN in every block; the reference's layout
    (``wte``, ``wpe``, ``block_i``, ``ln_final`` at the top level)."""

    def __init__(self, cfg: TransformerConfig, n_experts: int = 4,
                 capacity_factor: float = 1.25) -> None:
        super().__init__()
        self.cfg = cfg
        self.n_experts = int(n_experts)
        self.capacity_factor = float(capacity_factor)
        self.wte = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.wpe = nn.Embedding(cfg.max_len, cfg.d_model)
        for i in range(cfg.n_layers):
            self.add_module(f"block_{i}", MoEBlock(cfg, n_experts, capacity_factor))
        self.ln_final = nn.LayerNorm(cfg.d_model, eps=cfg.ln_eps)

    def forward(self, ids: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        """Logits ``[B, T, V]`` (float32); each layer's aux loss is left on
        its ``MoEMLP``."""
        dt = self.cfg.compute_dtype
        wte = self.wte.weight.to(dt)
        pos = torch.arange(ids.shape[1], device=ids.device)
        x = wte[ids] + self.wpe.weight.to(dt)[pos][None, :, :]
        attn_mask = make_attention_mask(pad_mask, self.cfg.causal)
        for i in range(self.cfg.n_layers):
            x = getattr(self, f"block_{i}")(x, attn_mask, pad_mask)
        x = layer_norm(self.ln_final, x)
        return torch.matmul(x.to(dt), wte.T).to(torch.float32)


def shard_expert_params(model: nn.Module, mesh: Any, axis: str = "model") -> nn.Module:
    """A copy of ``model`` on the mesh's device whose ``MoEMLP`` layers keep
    this rank's ``E / n`` experts of the stacked ``w_in``, ``b_in``,
    ``w_out``, ``b_out`` leaves (expert parallelism over ``axis``); the
    router and every other parameter are replicated.  With ``E % n != 0``
    the experts stay replicated.  Every rank of the axis group must call the
    copy's forward together."""
    group = check_mesh(mesh).group(axis)
    n, i = group_size(group), group_index(group)
    out = copy.deepcopy(model).to(mesh.device)
    for m in out.modules():
        if isinstance(m, MoEMLP) and m.n_experts % n == 0:
            per = m.n_experts // n
            with torch.no_grad():
                for name in ("w_in", "b_in", "w_out", "b_out"):
                    p = nn.Parameter(getattr(m, name)[i * per:(i + 1) * per].clone())
                    setattr(m, name, mark_sharded(p, group))
            m.expert_offset, m.expert_group = i * per, group
    return out


def load_balance_loss(model: nn.Module) -> torch.Tensor:
    """The mean of the Switch aux losses the model's ``MoEMLP`` layers kept
    from their last forward; ``0.0`` for a model that has none."""
    terms = [m.aux_loss for m in model.modules()
             if isinstance(m, MoEMLP) and m.aux_loss is not None]
    if not terms:
        return torch.tensor(0.0)
    return sum(terms) / len(terms)


__all__ = ["MoEMLP", "MoEBlock", "MoECausalLM", "load_balance_loss", "shard_expert_params"]
