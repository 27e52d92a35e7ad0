"""Mixture-of-experts FFN (Switch-style top-1) on one device.

Counterpart of ``dewi_tpu/models/moe.py`` without the mesh: the same
routing, capacity, parameter layout and load-balance loss, so a checkpoint
crosses between the packages (``convert.moe_lm_params_{from,to}_flax``).

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
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

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

    def forward(self, x: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        e = self.n_experts
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
        # Buffer row of each token: expert * cap + slot, or the spare row.
        row = torch.where(kept, expert * cap + slot, torch.full_like(slot, e * cap))

        buf = torch.zeros(e * cap + 1, d, dtype=dt, device=x.device)
        expert_in = buf.index_add(0, row, xf.to(dt))[: e * cap].view(e, cap, d)
        h = torch.bmm(expert_in, self.w_in.to(dt)) + self.b_in[:, None, :].to(dt)
        h = self.act(h)
        h = torch.bmm(h, self.w_out.to(dt)) + self.b_out[:, None, :].to(dt)
        h = torch.cat([h.reshape(e * cap, d), h.new_zeros(1, d)])
        out = h.index_select(0, row) * gate.to(dt)[:, None]        # [N, D]

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


def load_balance_loss(model: nn.Module) -> torch.Tensor:
    """The mean of the Switch aux losses the model's ``MoEMLP`` layers kept
    from their last forward; ``0.0`` for a model that has none."""
    terms = [m.aux_loss for m in model.modules()
             if isinstance(m, MoEMLP) and m.aux_loss is not None]
    if not terms:
        return torch.tensor(0.0)
    return sum(terms) / len(terms)


__all__ = ["MoEMLP", "MoEBlock", "MoECausalLM", "load_balance_loss"]
