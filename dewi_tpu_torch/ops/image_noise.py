"""Batched image-noise pass: blur Laplacian and skin fraction.

Counterpart of ``dewi_tpu/ops/image_noise.py`` (which the reference runs
under ``jax.jit``, not Pallas), in plain PyTorch on the device, in groups of
:data:`CHUNK` images:

* blur — uint8 -> float32 / 255, BT.601 luma, a bilinear upscale to
  ``blur_size`` by two ``[S, H]``/``[S, W]`` matmuls with the half-pixel
  weights of ``io.images.resize_f32``, the 5-point Laplacian, its
  variance x 1e3;
* skin — the YCbCr gate and its mean at ``skin_size`` px.

Every group's aggregates stay on the device until one copy at the end.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from ..io.device_images import _resize_matrix
from ..utils.device import DeviceLike, resolve_device

#: BT.601 luma weights (as ``signals/noise.py``'s blur score).
_LUMA = np.array([0.299, 0.587, 0.114], np.float32)

#: Images per group: bounds the float32 intermediates (about 0.6 MB an
#: image at 224 px) and, for a host corpus, the upload buffer.
CHUNK = 2048


def _resize(x: torch.Tensor, h: int, w: int, size: int, specs: Tuple[str, str]) -> torch.Tensor:
    """Bilinear resize of the two spatial axes by two matmuls."""
    my = torch.from_numpy(_resize_matrix(h, size)).to(x.device)
    mx = torch.from_numpy(_resize_matrix(w, size)).to(x.device)
    rows, cols = specs
    x = torch.einsum(rows, my, x)
    return torch.einsum(cols, x, mx)


def _image_noise(imgs: torch.Tensor, blur_size: int,
                 skin_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lap_var [B], skin_frac [B])`` float32 for a uint8 ``[B, H, W, 3]``."""
    h, w = imgs.shape[1], imgs.shape[2]
    x = imgs.to(torch.float32) / 255.0
    luma = x @ torch.from_numpy(_LUMA).to(x.device)                  # [B, H, W]
    up = luma
    if (h, w) != (blur_size, blur_size):
        up = _resize(luma, h, w, blur_size, ("oh,bhw->bow", "bow,sw->bos"))
    lap = (-4.0 * up[:, 1:-1, 1:-1] + up[:, :-2, 1:-1] + up[:, 2:, 1:-1]
           + up[:, 1:-1, :-2] + up[:, 1:-1, 2:])
    lap_var = torch.var(lap, dim=(1, 2), correction=0) * 1e3

    xs = x
    if (h, w) != (skin_size, skin_size):
        xs = _resize(x, h, w, skin_size, ("oh,bhwc->bowc", "bowc,sw->bosc"))
    r, g, b = xs[..., 0], xs[..., 1], xs[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 0.564 * (b - y) + 0.5
    cr = 0.713 * (r - y) + 0.5
    skin = (cb > 0.30) & (cb < 0.50) & (cr > 0.52) & (cr < 0.68) & (y > 0.15)
    return lap_var, skin.to(torch.float32).mean(dim=(1, 2))


@torch.no_grad()
def batched_image_noise(imgs: Any, blur_size: int = 224, skin_size: int = 64,
                        device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
    """``(blur_score [B], skin_frac [B])`` float32 for a uniform ``[B, H, W, 3]``
    uint8 batch: a host ndarray (uploaded to ``device``, ``None``: the card,
    one group at a time) or a tensor, read where it lies (a
    ``DeviceImages`` corpus: no re-upload)."""
    if isinstance(imgs, torch.Tensor):
        dev = imgs.device
    else:
        imgs = np.ascontiguousarray(imgs)
        dev = resolve_device(device)
    blur, skin = [], []
    for s in range(0, imgs.shape[0], CHUNK):
        part = torch.as_tensor(imgs[s:s + CHUNK]).to(dev)
        lv, sf = _image_noise(part, blur_size, skin_size)
        blur.append(lv)
        skin.append(sf)
    if not blur:
        return np.zeros(0, np.float32), np.zeros(0, np.float32)
    return torch.cat(blur).cpu().numpy(), torch.cat(skin).cpu().numpy()


__all__ = ["batched_image_noise", "CHUNK"]
