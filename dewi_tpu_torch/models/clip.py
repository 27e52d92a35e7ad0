"""CLIP-style dual encoder: text tower + image tower + projection heads.

Counterpart of ``dewi_tpu/models/clip.py``.  Text and image embeddings come
out L2-normalized, so cross-modal similarity and the query encoder of
search are plain matmuls on the caller's side.  The projections are
bias-free float32 Dense layers; TF32 is off for the package, so they stay
full float32 on the card.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from .mae import patchify
from .transformer import Encoder, TransformerConfig, dense, layer_norm


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    vocab_size: int = 258
    text_len: int = 77
    d_text: int = 256
    text_heads: int = 4
    text_layers: int = 4
    image_size: int = 224
    patch_size: int = 32
    d_image: int = 256
    image_heads: int = 4
    image_layers: int = 4
    d_embed: int = 256
    dtype: str = "bfloat16"
    # Import-parity knobs: OpenAI CLIP uses quick_gelu, ln_eps=1e-5, a
    # pre-encoder LayerNorm on the vision tower and explicit FF widths
    # (0 = 4*d).
    ln_eps: float = 1e-6
    activation: str = "gelu"
    image_pre_ln: bool = False
    text_ff: int = 0
    image_ff: int = 0

    def text_cfg(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=self.vocab_size, d_model=self.d_text, n_heads=self.text_heads,
            n_layers=self.text_layers, d_ff=self.text_ff or 4 * self.d_text,
            max_len=self.text_len, causal=True, dtype=self.dtype,
            ln_eps=self.ln_eps, activation=self.activation,
        )

    def image_cfg(self) -> TransformerConfig:
        p = (self.image_size // self.patch_size) ** 2
        return TransformerConfig(
            vocab_size=1, d_model=self.d_image, n_heads=self.image_heads,
            n_layers=self.image_layers, d_ff=self.image_ff or 4 * self.d_image,
            max_len=p + 1, causal=False, dtype=self.dtype, ln_eps=self.ln_eps,
            activation=self.activation,
        )


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


class CLIPTextTower(nn.Module):
    def __init__(self, cfg: CLIPConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.d_text)
        self.wpe = nn.Embedding(cfg.text_len, cfg.d_text)
        self.encoder = Encoder(cfg.text_cfg())
        self.text_proj = nn.Linear(cfg.d_text, cfg.d_embed, bias=False)

    def forward(self, ids: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.text_cfg().compute_dtype
        pos = torch.arange(ids.shape[1], device=ids.device)
        x = self.wte.weight.to(dt)[ids] + self.wpe.weight.to(dt)[pos][None, :, :]
        x = self.encoder(x, pad_mask)
        # Pool at the last valid token (CLIP's EOT pooling).
        last = (pad_mask.sum(dim=1).to(torch.int64) - 1).clamp_min(0)
        pooled = x[torch.arange(x.shape[0], device=x.device), last]
        return _normalize(dense(self.text_proj, pooled, torch.float32))


class CLIPImageTower(nn.Module):
    def __init__(self, cfg: CLIPConfig) -> None:
        super().__init__()
        self.cfg = cfg
        n_tok = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.patch_embed = nn.Linear(cfg.patch_size * cfg.patch_size * 3, cfg.d_image)
        self.cls = nn.Parameter(torch.zeros(1, 1, cfg.d_image))
        self.pos = nn.Parameter(torch.zeros(n_tok, cfg.d_image))
        if cfg.image_pre_ln:
            self.pre_ln = nn.LayerNorm(cfg.d_image, eps=cfg.ln_eps)
        self.encoder = Encoder(cfg.image_cfg())
        self.image_proj = nn.Linear(cfg.d_image, cfg.d_embed, bias=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.image_cfg().compute_dtype
        patches = patchify(images.to(torch.float32), cfg.patch_size)
        x = dense(self.patch_embed, patches, dt)
        cls = self.cls.to(x.dtype).expand(x.shape[0], 1, cfg.d_image)
        x = torch.cat([cls, x], dim=1)
        x = x + self.pos[None].to(x.dtype)
        if cfg.image_pre_ln:
            x = layer_norm(self.pre_ln, x)
        x = self.encoder(x)
        return _normalize(dense(self.image_proj, x[:, 0, :], torch.float32))


class CLIPDualEncoder(nn.Module):
    """Both towers and the logit scale under one module."""

    def __init__(self, cfg: CLIPConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.text_tower = CLIPTextTower(cfg)
        self.image_tower = CLIPImageTower(cfg)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def encode_text(self, ids: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        return self.text_tower(ids, pad_mask)

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.image_tower(images)

    def forward(self, ids: torch.Tensor, pad_mask: torch.Tensor,
                images: torch.Tensor) -> tuple:
        return self.encode_text(ids, pad_mask), self.encode_image(images), self.logit_scale


__all__ = ["CLIPConfig", "CLIPDualEncoder", "CLIPTextTower", "CLIPImageTower"]
