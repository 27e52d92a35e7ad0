"""Shared transformer building blocks for the DEWI signal backbones.

Counterpart of ``dewi_tpu/models/transformer.py``: pre-LN blocks, compute
in ``cfg.dtype`` (bfloat16 by default) with float32 parameters.  Every cast
of the reference's Flax modules is mirrored here:

* a Dense with ``dtype=d`` casts its input, kernel and bias to ``d``;
* LayerNorm runs in float32 and returns float32;
* attention is Flax's ``MultiHeadDotProductAttention``: separate q/k/v
  projections with bias and an output projection, q divided by
  ``sqrt(head_dim)`` in the compute dtype before the product, masked logits
  set to ``finfo(compute dtype).min`` and the softmax in the compute dtype.

Attention is written as explicit matmuls and a softmax, the same on the CPU
and on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 258
    d_model: int = 256
    n_heads: int = 4
    n_layers: int = 4
    d_ff: int = 1024
    max_len: int = 512
    dropout: float = 0.0  # inference only: kept for config parity
    causal: bool = True
    dtype: str = "bfloat16"  # compute dtype; params stay float32
    # Numerics knobs for weight-import parity with external checkpoints
    # (GPT-2: ln_eps=1e-5; CLIP: quick_gelu + 1e-5; ViT: gelu_exact + 1e-12).
    ln_eps: float = 1e-6
    activation: str = "gelu"  # "gelu" (tanh approx) | "gelu_exact" | "quick_gelu"

    @property
    def compute_dtype(self) -> torch.dtype:
        return compute_dtype(self.dtype)


def compute_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")  # GPT-2's gelu_new
    if name == "gelu_exact":
        return F.gelu
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    raise ValueError(f"Unknown activation {name!r}")


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Flax ``Dense(dtype=dtype)``: input, kernel and bias cast to ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """Flax ``LayerNorm(dtype=float32)``: float32 in and out."""
    return F.layer_norm(x.to(torch.float32), ln.normalized_shape, ln.weight,
                        ln.bias, ln.eps)


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.fc_in = nn.Linear(cfg.d_model, cfg.d_ff)
        self.fc_out = nn.Linear(cfg.d_ff, cfg.d_model)
        self.act = activation_fn(cfg.activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        return dense(self.fc_out, self.act(dense(self.fc_in, x, dt)), dt)


class Attention(nn.Module):
    """Self-attention as Flax's ``MultiHeadDotProductAttention``."""

    def __init__(self, cfg: TransformerConfig) -> None:
        super().__init__()
        if cfg.d_model % cfg.n_heads:
            raise ValueError(f"d_model {cfg.d_model} is not a multiple of "
                             f"n_heads {cfg.n_heads}")
        self.cfg = cfg
        self.n_heads = cfg.n_heads
        self.head_dim = cfg.d_model // cfg.n_heads
        self.query = nn.Linear(cfg.d_model, cfg.d_model)
        self.key = nn.Linear(cfg.d_model, cfg.d_model)
        self.value = nn.Linear(cfg.d_model, cfg.d_model)
        self.out = nn.Linear(cfg.d_model, cfg.d_model)

    def qkv(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The projections as ``[B, heads, T, head_dim]`` (the heads this
        module holds: all of them, or a tensor-parallel rank's share)."""
        dt = self.cfg.compute_dtype
        b, t, _ = x.shape

        def heads(layer: nn.Linear) -> torch.Tensor:
            return dense(layer, x, dt).view(b, t, -1, self.head_dim).transpose(1, 2)

        return heads(self.query), heads(self.key), heads(self.value)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        o = attend(*self.qkv(x), mask, dt)
        return dense(self.out, merge_heads(o), dt)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: Optional[torch.Tensor], dt: torch.dtype) -> torch.Tensor:
    """Softmax attention of ``q [B, H, Tq, hd]`` over ``k, v [B, H, Tk, hd]``
    as Flax computes it; ``mask`` broadcasts to ``[B, H, Tq, Tk]``."""
    # jnp.sqrt(depth).astype(dtype): the f32 root rounded to the compute dtype.
    q = q / torch.tensor(math.sqrt(q.shape[-1]), dtype=torch.float32).to(dt)
    w = torch.matmul(q, k.transpose(-1, -2))  # [B, H, Tq, Tk]
    if mask is not None:
        w = w.masked_fill(~mask, torch.finfo(dt).min)
    return torch.matmul(torch.softmax(w, dim=-1), v)


def merge_heads(o: torch.Tensor) -> torch.Tensor:
    """``[B, H, T, hd]`` -> ``[B, T, H * hd]``."""
    b, _, t, _ = o.shape
    return o.transpose(1, 2).reshape(b, t, -1)


class Block(nn.Module):
    """Pre-LN transformer block: x + attn(ln(x)); x + mlp(ln(x))."""

    def __init__(self, cfg: TransformerConfig) -> None:
        super().__init__()
        self.ln_attn = nn.LayerNorm(cfg.d_model, eps=cfg.ln_eps)
        self.attn = Attention(cfg)
        self.ln_mlp = nn.LayerNorm(cfg.d_model, eps=cfg.ln_eps)
        self.mlp = MLP(cfg)

    def forward(self, x: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(layer_norm(self.ln_attn, x), attn_mask)
        return x + self.mlp(layer_norm(self.ln_mlp, x))


def make_attention_mask(pad_mask: torch.Tensor, causal: bool) -> torch.Tensor:
    """A ``[B, 1, T, T]`` boolean attention mask from a ``[B, T]`` pad mask."""
    pad = pad_mask.to(torch.bool)
    att = pad[:, None, None, :].expand(-1, -1, pad.shape[1], -1)
    if causal:
        t = pad.shape[-1]
        att = att & torch.ones(t, t, dtype=torch.bool, device=pad.device).tril()
    return att


class Encoder(nn.Module):
    """A stack of blocks over already-embedded inputs, then a final LayerNorm."""

    def __init__(self, cfg: TransformerConfig) -> None:
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.n_layers):  # Flax's names: block_0, block_1, ...
            self.add_module(f"block_{i}", Block(cfg))
        self.ln_final = nn.LayerNorm(cfg.d_model, eps=cfg.ln_eps)

    def forward(self, x: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        attn_mask = None
        if pad_mask is not None or self.cfg.causal:
            if pad_mask is None:
                pad_mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
            attn_mask = make_attention_mask(pad_mask, self.cfg.causal)
        for i in range(self.cfg.n_layers):
            x = getattr(self, f"block_{i}")(x, attn_mask)
        return layer_norm(self.ln_final, x)


__all__ = [
    "TransformerConfig",
    "Encoder",
    "Block",
    "Attention",
    "MLP",
    "make_attention_mask",
    "attend",
    "merge_heads",
    "activation_fn",
    "compute_dtype",
    "dense",
    "layer_norm",
]
