"""ViT-MAE for image-entropy estimation (masked reconstruction error).

Counterpart of ``dewi_tpu/models/mae.py``: patchify, mask a fixed share of
patches by an argsort of uniform noise with a static visible count, encode
the visible set, decode with mask tokens, and report per-patch MSE.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from .transformer import Encoder, TransformerConfig, compute_dtype, dense


@dataclasses.dataclass(frozen=True)
class MAEConfig:
    image_size: int = 224
    patch_size: int = 16
    d_model: int = 256
    n_heads: int = 4
    n_layers: int = 4
    d_ff: int = 1024
    dec_d_model: int = 128
    dec_n_heads: int = 4
    dec_n_layers: int = 2
    dec_d_ff: int = 512
    mask_ratio: float = 0.75
    norm_pix: bool = True
    dtype: str = "bfloat16"
    # Import-parity knobs: HF ViT-MAE prepends a CLS token in both encoder
    # and decoder, uses exact gelu and ln_eps=1e-12.
    ln_eps: float = 1e-6
    activation: str = "gelu"
    use_cls: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_visible(self) -> int:
        return max(1, round(self.num_patches * (1.0 - self.mask_ratio)))

    def encoder_cfg(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=1, d_model=self.d_model, n_heads=self.n_heads,
            n_layers=self.n_layers, d_ff=self.d_ff, max_len=self.num_patches + 1,
            causal=False, dtype=self.dtype, ln_eps=self.ln_eps,
            activation=self.activation,
        )

    def decoder_cfg(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=1, d_model=self.dec_d_model, n_heads=self.dec_n_heads,
            n_layers=self.dec_n_layers, d_ff=self.dec_d_ff,
            max_len=self.num_patches + 1, causal=False, dtype=self.dtype,
            ln_eps=self.ln_eps, activation=self.activation,
        )


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """``[B, H, W, C] -> [B, P, patch*patch*C]`` row-major patch grid."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx[:, :, None], axis=1)`` for ``[B, P, D]``."""
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[-1]))


class ViTMAE(nn.Module):
    """Masked autoencoder.

    ``patch_losses`` returns per-patch reconstruction MSE ``[B, P]`` and the
    mask of reconstructed (hidden) patches; ``forward`` reduces them to the
    per-image masked-patch MSE.
    """

    def __init__(self, cfg: MAEConfig) -> None:
        super().__init__()
        self.cfg = cfg
        p = cfg.num_patches
        n_pos = p + 1 if cfg.use_cls else p
        patch_dim = cfg.patch_size * cfg.patch_size * 3
        self.patch_embed = nn.Linear(patch_dim, cfg.d_model)
        self.enc_pos = nn.Parameter(torch.zeros(n_pos, cfg.d_model))
        if cfg.use_cls:
            self.cls = nn.Parameter(torch.zeros(1, 1, cfg.d_model))
        self.encoder = Encoder(cfg.encoder_cfg())
        self.dec_embed = nn.Linear(cfg.d_model, cfg.dec_d_model)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, cfg.dec_d_model))
        self.dec_pos = nn.Parameter(torch.zeros(n_pos, cfg.dec_d_model))
        self.decoder = Encoder(cfg.decoder_cfg())
        self.dec_pred = nn.Linear(cfg.dec_d_model, patch_dim)

    def forward(self, images: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        per_patch, mask = self.patch_losses(images, generator, noise)
        return (per_patch * mask).sum(1) / mask.sum(1).clamp_min(1.0)

    def patch_losses(self, images: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-patch MSE ``[B, P]`` and the hidden-patch mask ``[B, P]``.

        ``noise`` (``[B, P]``) overrides the generator, as the reference's
        ``noise=`` overrides its ``rng``."""
        cfg = self.cfg
        dt = compute_dtype(cfg.dtype)
        p, v = cfg.num_patches, cfg.num_visible
        bsz = images.shape[0]
        dev = images.device

        patches = patchify(images.to(torch.float32), cfg.patch_size)
        target = patches
        if cfg.norm_pix:
            mu = patches.mean(dim=-1, keepdim=True)
            var = patches.var(dim=-1, keepdim=True, correction=1)
            target = (patches - mu) / torch.sqrt(var + 1e-6)

        if noise is None:
            noise = torch.rand((bsz, p), generator=generator, device=dev)
        ids_shuffle = torch.argsort(noise.to(dev), dim=1, stable=True)
        ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
        ids_keep = ids_shuffle[:, :v]

        x = dense(self.patch_embed, patches, dt)
        grid_pos = self.enc_pos[1:] if cfg.use_cls else self.enc_pos
        x = x + grid_pos[None].to(dt)
        x_vis = _take_rows(x, ids_keep)
        if cfg.use_cls:
            cls_tok = (self.cls + self.enc_pos[None, :1]).to(x_vis.dtype)
            x_vis = torch.cat([cls_tok.expand(bsz, 1, cfg.d_model), x_vis], dim=1)
        x_vis = self.encoder(x_vis)

        y = dense(self.dec_embed, x_vis, dt)
        masked = self.mask_token.to(y.dtype).expand(bsz, p - v, cfg.dec_d_model)
        y_cls = None
        if cfg.use_cls:
            y_cls, y = y[:, :1], y[:, 1:]
        y_full = _take_rows(torch.cat([y, masked], dim=1), ids_restore)
        if cfg.use_cls:
            y_full = torch.cat([y_cls, y_full], dim=1)
        y_full = y_full + self.dec_pos[None].to(y_full.dtype)
        y_full = self.decoder(y_full)
        pred = dense(self.dec_pred, y_full, torch.float32)
        if cfg.use_cls:
            pred = pred[:, 1:]

        hidden = torch.cat([torch.zeros(bsz, v, device=dev),
                            torch.ones(bsz, p - v, device=dev)], dim=1)
        mask = torch.gather(hidden, 1, ids_restore)
        per_patch = ((pred - target) ** 2).mean(dim=-1)
        return per_patch, mask


def _luma(images: torch.Tensor) -> torch.Tensor:
    images = images.to(torch.float32)
    if images.ndim == 4 and images.shape[-1] == 3:
        return 0.299 * images[..., 0] + 0.587 * images[..., 1] + 0.114 * images[..., 2]
    return images.reshape(images.shape[0], images.shape[1], -1).mean(-1)


def pixel_entropy_proxy(images: torch.Tensor) -> torch.Tensor:
    """Model-free fallback: luma ``var / mean^2`` per image."""
    flat = _luma(images).reshape(images.shape[0], -1)
    return flat.var(dim=1, correction=0) / (flat.mean(dim=1) ** 2 + 1e-8)


def pixel_patch_proxy(images: torch.Tensor, patch: int = 8) -> torch.Tensor:
    """Per-patch ``var/mean^2`` proxy ``[B, P]`` (so the fallback also yields
    quantiles)."""
    luma = _luma(images)
    b, h, w = luma.shape
    gh, gw = h // patch, w // patch
    x = luma[:, : gh * patch, : gw * patch]
    x = x.reshape(b, gh, patch, gw, patch).permute(0, 1, 3, 2, 4).reshape(b, gh * gw, -1)
    return x.var(dim=2, correction=0) / (x.mean(dim=2) ** 2 + 1e-8)


__all__ = ["MAEConfig", "ViTMAE", "patchify", "pixel_entropy_proxy", "pixel_patch_proxy"]
