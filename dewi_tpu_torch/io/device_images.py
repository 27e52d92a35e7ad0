"""Device-resident image corpora: upload once, every stage reads device memory.

Counterpart of ``dewi_tpu/io/device_images.py``.  A uniform-size uint8
corpus lives on the card as one ``[N, H, W, 3]`` tensor; the estimators'
batch iterators slice it there and, when a stage wants another resolution,
resize on the device with the half-pixel bilinear weights of
``io.images.resize_f32`` (two small matmuls).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device


@lru_cache(maxsize=32)
def _resize_matrix(src: int, dst: int) -> np.ndarray:
    """``[dst, src]`` bilinear interpolation matrix with half-pixel centres;
    row ``i`` holds the source weights of output pixel ``i``.  A copy of
    ``dewi_tpu/ops/image_noise.py``'s."""
    y = (np.arange(dst, dtype=np.float64) + 0.5) * src / dst - 0.5
    y0 = np.clip(np.floor(y).astype(np.int64), 0, src - 1)
    y1 = np.minimum(y0 + 1, src - 1)
    wy = np.clip(y - y0, 0.0, 1.0)
    m = np.zeros((dst, src), np.float32)
    rows = np.arange(dst)
    np.add.at(m, (rows, y0), (1.0 - wy).astype(np.float32))
    np.add.at(m, (rows, y1), wy.astype(np.float32))
    return m


def resize_batch(chunk: torch.Tensor, size: int) -> torch.Tensor:
    """``[B, H, W, 3]`` -> float32 ``[B, size, size, 3]`` in [0, 1] (uint8 is
    scaled by 1/255 first), on ``chunk``'s device."""
    h, w = chunk.shape[1], chunk.shape[2]
    x = chunk.to(torch.float32)
    if chunk.dtype == torch.uint8:
        x = x * (1.0 / 255.0)
    my = torch.from_numpy(_resize_matrix(h, size)).to(chunk.device)
    mx = torch.from_numpy(_resize_matrix(w, size)).to(chunk.device)
    x = torch.einsum("oh,bhwc->bowc", my, x)
    return torch.einsum("bowc,sw->bosc", x, mx)


class DeviceImages:
    """A ``[N, H, W, 3]`` uint8 image corpus resident on one device.

    A tensor stays on its device; an ndarray goes to ``device`` (``None``:
    the card).  ``rows_at(lo, hi, size)`` is a slice when ``size`` is the
    stored resolution, else an on-device bilinear resize to float32 in
    [0, 1] (the estimators' ``normalize_images`` passes floats through).
    """

    def __init__(self, images: Any, device: DeviceLike = None) -> None:
        self.shape = tuple(images.shape)
        if len(self.shape) != 4 or self.shape[-1] != 3:
            raise ValueError(f"expected [N, H, W, 3], got {self.shape}")
        if isinstance(images, torch.Tensor):
            self.base = images
        else:
            self.base = torch.from_numpy(np.ascontiguousarray(images)).to(
                resolve_device(device))

    @property
    def size(self) -> int:
        return self.shape[1]

    @property
    def device(self) -> torch.device:
        return self.base.device

    def __len__(self) -> int:
        return self.shape[0]

    def gather(self, idx: Any) -> "DeviceImages":
        """Device-side row gather (no host round trip)."""
        return DeviceImages(self.base[torch.as_tensor(np.asarray(idx), device=self.device)])

    def rows_at(self, lo: int, hi: int, size: int) -> torch.Tensor:
        chunk = self.base[lo:hi]
        if (self.shape[1], self.shape[2]) == (size, size):
            return chunk
        return resize_batch(chunk, size)


__all__ = ["DeviceImages", "resize_batch"]
