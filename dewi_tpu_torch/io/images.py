"""Host-side image input: decode, resize and padded uint8 batches.

Part of ``dewi_tpu/io/images.py``: ``resize_f32``, ``resize_uint8`` and
``decode_image_uint8`` are copies (numpy, PIL optional), and
``iter_corpus_batches`` slices ndarray, tensor and :class:`DeviceImages`
corpora as the reference does.  Other sources (paths, PIL images, lists of
arrays) are decoded one after another on the calling thread; the reference's
threaded prefetch and its native JPEG pool come with a later slice.
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple, Union

import numpy as np
import torch

try:  # Optional dependency: only path/PIL inputs need it.
    from PIL import Image

    _HAS_PIL = True
except Exception:  # pragma: no cover
    Image = None  # type: ignore
    _HAS_PIL = False

ImageLike = Union["Image.Image", np.ndarray, str]
Batch = Union[np.ndarray, torch.Tensor]

#: Formats whose decoder supports DCT-space draft (downscale-while-decode).
_DRAFT_FORMATS = {"JPEG", "MPO"}


def _resize_pil(img: "Image.Image", size: int) -> np.ndarray:
    if img.mode != "RGB":
        img = img.convert("RGB")
    if img.size != (size, size):
        img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


def resize_uint8(arr: np.ndarray, size: int) -> np.ndarray:
    """Resize an ``[H, W, 3]`` uint8 array to ``[size, size, 3]`` uint8: PIL's
    bilinear resize, or nearest-neighbour sampling without PIL."""
    if arr.shape[:2] == (size, size):
        return arr
    if _HAS_PIL:
        return _resize_pil(Image.fromarray(arr, mode="RGB"), size)
    h, w = arr.shape[:2]
    yi = np.clip(((np.arange(size) + 0.5) * h / size).astype(np.int64), 0, h - 1)
    xi = np.clip(((np.arange(size) + 0.5) * w / size).astype(np.int64), 0, w - 1)
    return arr[yi][:, xi]


def resize_f32(arr: np.ndarray, size: int) -> np.ndarray:
    """Bilinear-resize an ``[H, W, C]`` float array to ``[size, size, C]`` in
    float (half-pixel centres), with no uint8 round trip."""
    arr = np.asarray(arr, dtype=np.float32)
    h, w = arr.shape[:2]
    if (h, w) == (size, size):
        return arr
    y = (np.arange(size, dtype=np.float64) + 0.5) * h / size - 0.5
    x = (np.arange(size, dtype=np.float64) + 0.5) * w / size - 0.5
    y0 = np.clip(np.floor(y).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(x).astype(np.int64), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = np.clip(y - y0, 0.0, 1.0).astype(np.float32)[:, None, None]
    wx = np.clip(x - x0, 0.0, 1.0).astype(np.float32)[None, :, None]
    top = arr[y0][:, x0] * (1 - wx) + arr[y0][:, x1] * wx
    bot = arr[y1][:, x0] * (1 - wx) + arr[y1][:, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


def _array_to_uint8(arr: np.ndarray, size: int) -> np.ndarray:
    """An in-memory array (f32 [0,1], f32 [0,255] or uint8; HxW or HxWx3)
    as ``[size, size, 3]`` uint8."""
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.dtype != np.uint8:
        a = arr.astype(np.float32)
        if a.size and float(a.max()) <= 1.5:  # [0,1] floats
            a = a * 255.0
        arr = np.clip(np.round(a), 0, 255).astype(np.uint8)
    return resize_uint8(arr, size)


def decode_image_uint8(src: ImageLike, size: int) -> np.ndarray:
    """Decode/resize a path, PIL image or array to ``[size, size, 3]`` uint8.

    Paths need PIL; JPEG paths decode in draft mode (DCT-space downscale).
    """
    if isinstance(src, str):
        if not _HAS_PIL:
            raise ImportError("PIL required to load images from paths")
        with Image.open(src) as img:
            if img.format in _DRAFT_FORMATS:
                img.draft("RGB", (size, size))
            img.load()
            return _resize_pil(img, size)
    if _HAS_PIL and Image is not None and isinstance(src, Image.Image):
        return _resize_pil(src, size)
    return _array_to_uint8(src, size)


def _pad_rows(chunk: Batch, batch_size: int) -> Batch:
    pad = batch_size - len(chunk)
    if not pad:
        return chunk
    if isinstance(chunk, torch.Tensor):
        return torch.cat([chunk, chunk.new_zeros((pad,) + tuple(chunk.shape[1:]))])
    return np.concatenate([chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])


def iter_corpus_batches(images: Sequence[ImageLike], size: int,
                        batch_size: int) -> Iterator[Tuple[Batch, int]]:
    """``(batch [bs, size, size, 3], pad)`` for an image corpus; the last
    batch is zero-padded to ``batch_size`` and ``pad`` counts its padding.

    A :class:`DeviceImages` corpus yields device slices (resized on the
    device where ``size`` differs); an ``[N, size, size, 3]`` ndarray or
    tensor is sliced as it is, float arrays in uint8 range (max > 1.5)
    scaled to [0, 1] per chunk; anything else is decoded to uint8 one image
    at a time.
    """
    from .device_images import DeviceImages

    n = len(images)
    if isinstance(images, DeviceImages):
        for s in range(0, n, batch_size):
            hi = min(s + batch_size, n)
            yield _pad_rows(images.rows_at(s, hi, size), batch_size), batch_size - (hi - s)
        return
    if (isinstance(images, (np.ndarray, torch.Tensor)) and images.ndim == 4
            and tuple(images.shape[1:3]) == (size, size)):
        floating = images.dtype not in (np.uint8, torch.uint8)
        scale = floating and n and float(images.max()) > 1.5
        for s in range(0, n, batch_size):
            chunk = images[s:s + batch_size]
            if scale:
                chunk = chunk.astype(np.float32) / 255.0 if isinstance(chunk, np.ndarray) \
                    else chunk.to(torch.float32) / 255.0
            yield _pad_rows(chunk, batch_size), batch_size - len(chunk)
        return
    for s in range(0, n, batch_size):
        m = min(batch_size, n - s)
        batch = np.zeros((batch_size, size, size, 3), np.uint8)
        for i in range(m):
            batch[i] = decode_image_uint8(images[s + i], size)
        yield batch, batch_size - m


__all__ = ["ImageLike", "decode_image_uint8", "iter_corpus_batches", "resize_f32",
           "resize_uint8"]
