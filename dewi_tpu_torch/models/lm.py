"""Causal language model for token-surprisal estimation.

Counterpart of ``dewi_tpu/models/lm.py``: a GPT-2-style decoder with a tied
head over byte/BPE tokens, and the per-token NLL from a gather-based
log-softmax (no one-hot).
"""

from __future__ import annotations

import torch
from torch import nn

from .transformer import Encoder, TransformerConfig


class CausalLM(nn.Module):
    """GPT-2-style decoder: tied-embedding LM head."""

    def __init__(self, cfg: TransformerConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.wpe = nn.Embedding(cfg.max_len, cfg.d_model)
        self.encoder = Encoder(cfg)

    def forward(self, ids: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        """Logits ``[B, T, V]`` (float32) for next-token prediction."""
        dt = self.cfg.compute_dtype
        wte = self.wte.weight.to(dt)  # Flax Embed(dtype=dt) gathers from the cast table
        t = ids.shape[1]
        pos = torch.arange(t, device=ids.device)
        x = wte[ids] + self.wpe.weight.to(dt)[pos][None, :, :]
        x = self.encoder(x, pad_mask)
        # Tied head (Embed.attend): x @ wte^T in the compute dtype, then f32.
        return torch.matmul(x.to(dt), wte.T).to(torch.float32)


def token_nll(logits: torch.Tensor, ids: torch.Tensor,
              pad_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token next-token NLL from shifted logits.

    Position ``i`` of the output is the NLL of token ``i+1`` given tokens
    ``<= i``.  Returns ``(nll [B, T-1], valid [B, T-1])``; positions whose
    target is padding are masked out.
    """
    shift = logits[:, :-1, :]
    targets = ids[:, 1:].long()
    logz = torch.logsumexp(shift, dim=-1)
    tgt = torch.gather(shift, -1, targets[..., None]).squeeze(-1)
    return logz - tgt, pad_mask[:, 1:].to(torch.bool)


__all__ = ["CausalLM", "token_nll"]
