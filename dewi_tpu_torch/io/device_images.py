"""Device-resident image corpora: upload once, every stage reads device memory.

Counterpart of ``dewi_tpu/io/device_images.py``.  A uniform-size uint8
corpus lives on the card as one ``[N, H, W, 3]`` tensor; the estimators'
batch iterators slice it there and, when a stage wants another resolution,
resize on the device with the half-pixel bilinear weights of
``io.images.resize_f32`` (two small matmuls).  The upload is gated on a
byte budget (``DEWI_DEVICE_IMAGES_MAX_BYTES``, default 4 GiB, the same
variable as the reference's), so that a large corpus does not take the
index's device memory; over the budget, or not uint8, the corpus stays on
the host.

``non_blocking=True`` starts the upload on a side stream from a thread of
its own and returns at once; the first read of :attr:`DeviceImages.base`
waits for it.  The pipeline starts it before the text stage, so the copy
runs behind the language model, as the reference's asynchronous
``device_put`` does.
"""

from __future__ import annotations

import os
import threading
from functools import lru_cache
from typing import Any, Optional

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device

#: Upload gate: corpora above this many bytes stay on the host.
MAX_BYTES = int(os.environ.get("DEWI_DEVICE_IMAGES_MAX_BYTES", 4 << 30))


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


class _Upload:
    """A host tensor copied to a CUDA device by a thread of its own, on a
    side stream; :meth:`result` joins it, raises what it raised, and orders
    the caller's stream after the copy."""

    def __init__(self, host: torch.Tensor, device: torch.device) -> None:
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.out: Optional[torch.Tensor] = None
        self.error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, args=(host,), daemon=True)
        self.thread.start()

    def _run(self, host: torch.Tensor) -> None:
        try:
            with torch.cuda.stream(self.stream):
                self.out = host.to(self.device)
            self.stream.synchronize()
        except BaseException as e:  # raised again by result()
            self.error = e

    def result(self) -> torch.Tensor:
        self.thread.join()
        if self.error is not None:
            raise self.error
        current = torch.cuda.current_stream(self.device)
        current.wait_stream(self.stream)
        self.out.record_stream(current)
        return self.out


class DeviceImages:
    """A ``[N, H, W, 3]`` uint8 image corpus resident on one device.

    A tensor stays on its device; an ndarray goes to ``device`` (``None``:
    the card), in the background when ``non_blocking`` and the device is a
    card.  ``rows_at(lo, hi, size)`` is a slice when ``size`` is the stored
    resolution, else an on-device bilinear resize to float32 in [0, 1] (the
    estimators' ``normalize_images`` passes floats through).
    """

    def __init__(self, images: Any, device: DeviceLike = None,
                 non_blocking: bool = False) -> None:
        self.shape = tuple(images.shape)
        if len(self.shape) != 4 or self.shape[-1] != 3:
            raise ValueError(f"expected [N, H, W, 3], got {self.shape}")
        self._upload: Optional[_Upload] = None
        if isinstance(images, torch.Tensor):
            self._base = images
            return
        host = torch.from_numpy(np.ascontiguousarray(images))
        dev = resolve_device(device)
        if non_blocking and dev.type == "cuda":
            self._base = None
            self._upload = _Upload(host, dev)
        else:
            self._base = host.to(dev)

    @property
    def base(self) -> torch.Tensor:
        """The ``[N, H, W, 3]`` tensor (waits for a background upload)."""
        if self._base is None:
            self._base = self._upload.result()
            self._upload = None
        return self._base

    @property
    def size(self) -> int:
        return self.shape[1]

    @property
    def device(self) -> torch.device:
        return self._upload.device if self._upload is not None else self._base.device

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


def device_images_or_none(images: Any, device: DeviceLike = None,
                          non_blocking: bool = False) -> Optional[DeviceImages]:
    """A uniform uint8 ``[N, H, W, 3]`` ndarray corpus as :class:`DeviceImages`
    on ``device``, or ``None`` (the caller keeps the host path) when it is
    not such an array or is over :data:`MAX_BYTES`.  An upload that fails
    raises: the corpus does not move back to the host behind the caller."""
    if not (isinstance(images, np.ndarray) and images.ndim == 4
            and images.dtype == np.uint8 and images.shape[-1] == 3
            and images.shape[0] > 0):
        return None
    if images.nbytes > MAX_BYTES:
        return None
    return DeviceImages(images, device=device, non_blocking=non_blocking)


__all__ = ["DeviceImages", "MAX_BYTES", "device_images_or_none", "resize_batch"]
