"""Host-side image input: threaded decode, prefetched padded uint8 batches.

The port's copy of ``dewi_tpu/io/images.py`` (numpy, PIL optional):

* :func:`decode_image_uint8` — one decode (JPEG paths in PIL's draft mode)
  and a bilinear resize to the target square, as uint8;
* :func:`decode_batch` — ordered decode: JPEG paths through the port's
  native GIL-free decode pool (``csrc/native/dewi_jpeg.cpp``) when it is
  built, everything else (and any slot the pool refuses) on a PIL thread
  pool;
* :func:`iter_padded_batches` — a bounded-queue prefetcher: a producer
  thread decodes the next batches while the caller's device step runs;
* :class:`ImageCache` — decode once at a base size, serve smaller sizes;
* :func:`iter_corpus_batches` — slices ndarray, tensor and
  :class:`DeviceImages` corpora and prefetches everything else.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence, Tuple, Union

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


def effective_threads(threads: int, sources: Sequence[ImageLike]) -> int:
    """Clamp the decode pool to what can help: one thread on a one-core
    host (PIL holds the GIL for much of its decode) and for array sources
    (a resize is cheaper than a pool dispatch); else at most the cores."""
    ncpu = os.cpu_count() or 1
    if ncpu <= 1:
        return 1
    if sources and all(isinstance(s, np.ndarray) for s in sources):
        return 1
    return max(1, min(int(threads), ncpu))


def decode_batch(sources: Sequence[ImageLike], size: int, threads: int = 4,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
    """Ordered parallel decode of ``sources`` into ``[N, size, size, 3]`` uint8
    (into ``out`` when given).

    JPEG-suffixed paths go through the native decode pool first (libjpeg at
    the best DCT scale and a bilinear resize on ``std::thread`` workers, no
    GIL); the slots it cannot decode (other formats, CMYK, truncated files)
    and every non-path source take the PIL path.  Only JPEG suffixes enter
    the pool: probing a PNG there would read the whole file before the
    header check fails.
    """
    n = len(sources)
    if out is None:
        out = np.empty((n, size, size, 3), np.uint8)
    native_threads = max(1, min(int(threads), os.cpu_count() or 1))
    threads = effective_threads(threads, sources)

    todo = list(range(n))
    jpg_idx = [i for i in todo if isinstance(sources[i], str)
               and sources[i].lower().endswith((".jpg", ".jpeg", ".mpo"))]
    if jpg_idx:
        from ..native import decode_jpeg_batch

        whole = len(jpg_idx) == n and out.flags["C_CONTIGUOUS"]
        res = decode_jpeg_batch([sources[i] for i in jpg_idx], size,
                                threads=native_threads, out=out if whole else None)
        if res is not None:
            dec, ok = res
            if not whole:
                for j, i in enumerate(jpg_idx):
                    if ok[j]:
                        out[i] = dec[j]
            done = {i for j, i in enumerate(jpg_idx) if ok[j]}
            todo = [i for i in todo if i not in done]

    def work(i: int) -> None:
        out[i] = decode_image_uint8(sources[i], size)

    if len(todo) <= 1 or threads <= 1:
        for i in todo:
            work(i)
        return out
    with ThreadPoolExecutor(max_workers=min(threads, len(todo))) as pool:
        list(pool.map(work, todo))
    return out


def iter_padded_batches(sources: Sequence[ImageLike], size: int, batch_size: int,
                        threads: int = 4, depth: int = 2
                        ) -> Iterator[Tuple[np.ndarray, int]]:
    """Yield ``(batch [batch_size, size, size, 3] uint8, pad)`` in order.

    The last batch is zero-padded to ``batch_size`` (``pad`` rows).  Up to
    ``depth`` batches are decoded ahead by a producer thread, so host decode
    overlaps the caller's device work; a decode error is raised on the
    consuming thread at the failing batch.
    """
    n = len(sources)
    if n == 0:
        return
    threads = effective_threads(threads, sources)
    starts = list(range(0, n, batch_size))

    def decode_at(s: int) -> Tuple[np.ndarray, int]:
        batch = np.zeros((batch_size, size, size, 3), np.uint8)
        # Per-item indexing, not sources[s:s+batch_size]: slicing a lazy view
        # (PackedImages' resized rows) would resize the whole batch to count it.
        m = min(batch_size, n - s)
        decode_batch([sources[s + i] for i in range(m)], size, threads=threads,
                     out=batch[:m])
        return batch, batch_size - m

    if len(starts) == 1:
        yield decode_at(0)
        return
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def produce() -> None:
        try:
            for s in starts:
                if stop.is_set():
                    return
                q.put(decode_at(s))
            q.put(None)
        except BaseException as e:  # raised again on the consumer thread
            q.put(e)

    producer = threading.Thread(target=produce, daemon=True)
    producer.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # Drain so the producer's blocked put() returns, then join it.
        while producer.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            producer.join(timeout=0.05)


class ImageCache:
    """Decode a document set once; serve every stage's resolution from RAM.

    ``base`` holds ``[N, base_size, base_size, 3]`` uint8 (the largest size
    any stage needs); :meth:`at` derives smaller sizes on demand and keeps
    them.  :meth:`fits` checks the RAM budget first, so that corpus-scale
    callers can stream instead.
    """

    def __init__(self, sources: Sequence[ImageLike], base_size: int,
                 threads: int = 4) -> None:
        self.base_size = int(base_size)
        self.threads = int(threads)
        self.base = decode_batch(sources, self.base_size, threads=self.threads)
        self._derived: dict = {}

    @staticmethod
    def fits(n_images: int, base_size: int, budget_mb: int) -> bool:
        return n_images * base_size * base_size * 3 <= budget_mb * 2**20

    def at(self, size: int) -> np.ndarray:
        """``[N, size, size, 3]`` uint8 view of the corpus at ``size``."""
        size = int(size)
        if size == self.base_size:
            return self.base
        if size > self.base_size:
            raise ValueError(f"ImageCache holds {self.base_size}px; cannot serve {size}px")
        if size not in self._derived:
            n = len(self.base)
            out = np.empty((n, size, size, 3), np.uint8)

            def work(i: int) -> None:
                out[i] = resize_uint8(self.base[i], size)

            if self.threads > 1 and n > 1:
                with ThreadPoolExecutor(max_workers=self.threads) as pool:
                    list(pool.map(work, range(n)))
            else:
                for i in range(n):
                    work(i)
            self._derived[size] = out
        return self._derived[size]

    def __len__(self) -> int:
        return len(self.base)


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
    scaled to [0, 1] per chunk; anything else goes through
    :func:`iter_padded_batches` (threaded decode and prefetch).
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
    yield from iter_padded_batches(images, size, batch_size)


__all__ = ["ImageCache", "ImageLike", "decode_batch", "decode_image_uint8",
           "effective_threads", "iter_corpus_batches", "iter_padded_batches", "resize_f32",
           "resize_uint8"]
