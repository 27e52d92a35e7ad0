"""Packed pre-decoded image corpora: decode once offline, mmap at run time.

The port's own copy of ``dewi_tpu/io/packed.py`` (numpy and mmap only); it
writes and reads the same files, so a pack made by either package loads in
the other.

* :func:`pack_images` — one offline pass: decode + resize every source to a
  fixed square and append into a standard ``.npy`` uint8 array of shape
  ``[N, S, S, 3]`` (written incrementally via ``open_memmap``; RAM use is
  one batch, not the corpus).  On multi-core hosts the decode fans out over
  a spawn-context process pool (PIL holds the GIL for much of its decode
  path, so threads do not scale; processes sidestep it).  Mostly-JPEG path
  corpora decode through the port's native GIL-free JPEG pool instead,
  straight into the mapping, when that pool is built.
* :class:`PackedImages` — run-time view: ``np.load(mmap_mode="r")`` maps the
  file without reading it; per-row access faults in only the pages touched.
  Signal stages slice batches straight out of the mapping and downscale
  in-memory when a stage wants fewer pixels than the pack holds.

A sidecar ``<pack>.json`` records count/size/provenance so loads can
validate shape.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence, Union

import numpy as np

from .images import ImageLike, decode_image_uint8, resize_uint8

logger = logging.getLogger(__name__)

PACK_VERSION = 1


def _sidecar_path(pack_path: Union[str, Path]) -> Path:
    return Path(str(pack_path) + ".json")


def _decode_one(args: Any) -> np.ndarray:
    """Module-level worker so process pools can pickle it."""
    src, size = args
    return decode_image_uint8(src, size)


def _n_decode_workers(workers: Optional[int]) -> int:
    """Resolve the process-pool width: 0/None on 1-core hosts (processes
    would only add IPC overhead), else leave a core for the writer."""
    ncpu = os.cpu_count() or 1
    if workers is not None:
        return max(0, min(int(workers), ncpu))
    return max(0, ncpu - 1) if ncpu > 2 else 0


def pack_images(
    sources: Sequence[ImageLike],
    size: int,
    out_path: Union[str, Path],
    workers: Optional[int] = None,
    batch: int = 256,
    progress: Optional[Callable[[int], None]] = None,
) -> dict:
    """Decode ``sources`` once into ``out_path`` (``.npy`` uint8 [N,S,S,3]).

    Returns the sidecar metadata dict.  ``workers`` controls the decode
    process pool (default: ``cpu_count - 1`` when >2 cores, else in-process
    — on a single core a pool is pure overhead).  Peak RAM is one ``batch``
    of decoded images regardless of corpus size.
    """
    out_path = Path(out_path)
    n = len(sources)
    if n == 0:
        raise ValueError("No images to pack")
    size = int(size)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    # Write to a temp file and rename at the end (same discipline as the
    # pipeline's shard checkpoints): open_memmap pre-allocates the FULL
    # [N,S,S,3] file up front, so an interrupted pack at the final path
    # would leave a structurally valid corpus of zero images that later
    # runs silently accept.
    tmp_path = out_path.with_name(out_path.name + ".tmp.npy")
    mm = np.lib.format.open_memmap(
        tmp_path, mode="w+", dtype=np.uint8, shape=(n, size, size, 3)
    )
    nworkers = _n_decode_workers(workers)
    # Mostly-JPEG path corpora decode through the native thread pool, not a
    # process pool: the same core scaling without a spawn and a pickle per
    # image, written straight into the mapping (decode_batch sends the odd
    # non-JPEG slot to PIL).  ``workers`` bounds the native pool too.
    from .. import native as _native

    sample = [c for c in sources[:64] if isinstance(c, str)]
    mostly_jpeg = bool(sample) and 2 * sum(
        1 for c in sample if c.lower().endswith((".jpg", ".jpeg", ".mpo"))
    ) >= len(sample)
    use_native_pool = mostly_jpeg and _native.jpeg_pool_available()
    ncpu = os.cpu_count() or 1
    native_threads = ncpu if workers is None else max(1, min(int(workers), ncpu))
    pool = None
    if nworkers > 0 and not use_native_pool:
        # spawn (not fork): the parent may hold a live CUDA context whose
        # state must not leak into decode children.
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        try:
            pool = ProcessPoolExecutor(
                max_workers=nworkers, mp_context=mp.get_context("spawn")
            )
        except Exception as e:  # noqa: BLE001 — restricted envs
            logger.warning("process pool unavailable (%s); decoding "
                           "in-process", e)
            pool = None
    try:
        for s in range(0, n, batch):
            chunk = list(sources[s : s + batch])
            if pool is not None:
                rows = list(pool.map(
                    _decode_one, [(c, size) for c in chunk], chunksize=16
                ))
                mm[s : s + len(rows)] = np.stack(rows)
            elif use_native_pool:
                from .images import decode_batch

                decode_batch(chunk, size, threads=native_threads,
                             out=mm[s : s + len(chunk)])
            else:
                mm[s : s + len(chunk)] = np.stack(
                    [decode_image_uint8(c, size) for c in chunk]
                )
            if progress is not None:
                progress(len(chunk))
    except BaseException:
        del mm
        tmp_path.unlink(missing_ok=True)  # don't leave a 150 GB stub
        raise
    finally:
        if pool is not None:
            pool.shutdown()
    mm.flush()
    del mm
    tmp_path.replace(out_path)
    meta = {
        "version": PACK_VERSION,
        "n_images": int(n),
        "size": size,
        "dtype": "uint8",
        "sources": [
            str(c) if isinstance(c, (str, Path)) else f"<{type(c).__name__}>"
            for c in sources[: min(n, 3)]
        ],
    }
    _sidecar_path(out_path).write_text(json.dumps(meta, indent=2))
    return meta


class PackedImages:
    """mmap view over a packed corpus; a drop-in ``images`` sequence.

    ``pack[i]`` is a ``[S, S, 3]`` uint8 array backed by the file mapping —
    no decode, no copy until the bytes are touched.  Estimator batch paths
    (:func:`dewi_tpu_torch.io.images.iter_corpus_batches`) recognise the
    underlying 4-D ndarray and slice batches directly.
    """

    def __init__(self, path: Union[str, Path]) -> None:
        self.path = Path(path)
        self.data = np.load(self.path, mmap_mode="r")
        if self.data.ndim != 4 or self.data.shape[-1] != 3 or \
                self.data.dtype != np.uint8:
            raise ValueError(
                f"{self.path} is not a packed image corpus "
                f"(got {self.data.dtype}{list(self.data.shape)}; expected "
                "uint8 [N, S, S, 3])"
            )
        self.base_size = int(self.data.shape[1])
        side = _sidecar_path(self.path)
        self.meta = json.loads(side.read_text()) if side.exists() else {}
        if self.meta and int(self.meta.get("n_images", len(self.data))) != \
                len(self.data):
            raise ValueError(
                f"{side} metadata disagrees with array shape "
                f"({self.meta.get('n_images')} vs {len(self.data)})"
            )

    def __len__(self) -> int:
        return int(self.data.shape[0])

    def __getitem__(self, i: Any) -> np.ndarray:
        return self.data[i]

    # Downscale requests above this many rows return a lazy view instead of
    # one materialized [n, size, size, 3] allocation — a corpus-sized
    # resize request (e.g. the pHash stage over 1M rows) must stream
    # batch-by-batch, not pre-allocate gigabytes of host RAM.
    MATERIALIZE_ROWS = 8192

    def rows(self, idx_list: Sequence[int], size: int) -> np.ndarray:
        """Uint8 batch for ``idx_list`` at ``size``.

        Contiguous full-range requests return the mapping itself (zero
        copy); small downscale requests return a materialized
        ``[n, size, size, 3]`` array (≈50 µs/img, ~20× cheaper than a
        decode); downscale requests beyond :attr:`MATERIALIZE_ROWS` return
        a lazy per-row view the batch iterators and per-image loops stream
        through without ever holding the whole resized corpus.
        """
        size = int(size)
        idx = np.asarray(idx_list, dtype=np.int64)
        full = idx.size == len(self) and np.array_equal(
            idx, np.arange(len(self))
        )
        if size >= self.base_size:
            if size > self.base_size:
                logger.warning(
                    "Packed corpus holds %dpx but %dpx was requested; "
                    "serving %dpx (the model will upscale). Re-pack at a "
                    "larger size if this stage's fidelity matters.",
                    self.base_size, size, self.base_size,
                )
            # Full range: the mapping itself — a fancy-index here would
            # copy the whole file into RAM.
            return self.data if full else self.data[idx]
        if idx.size > self.MATERIALIZE_ROWS:
            return _ResizedRows(self.data, idx, size)
        out = np.empty((idx.size, size, size, 3), np.uint8)
        for j, i in enumerate(idx):
            out[j] = resize_uint8(self.data[i], size)
        return out

    def as_documents(self, ids: Optional[Sequence[str]] = None,
                     texts: Optional[Sequence[Optional[str]]] = None
                     ) -> List["Document"]:  # noqa: F821
        """One :class:`~dewi_tpu_torch.pipelines.Document` per packed row.

        Each document's ``image`` is the mmap row view — building 1M
        documents costs 1M small objects, not 1M decodes.
        """
        from ..pipelines import Document

        n = len(self)
        if ids is None:
            ids = [f"img{i:08d}" for i in range(n)]
        if texts is None:
            texts = [None] * n
        return [
            Document(doc_id=str(ids[i]), text=texts[i], image=self.data[i])
            for i in range(n)
        ]


class _ResizedRows:
    """Lazy downscaled view over packed mmap rows.

    Behaves as a sequence of ``[size, size, 3]`` uint8 images: per-item
    access resizes ONE mmap row, so corpus-scale consumers
    (``iter_padded_batches`` streaming, ``score_images``'s per-image pHash
    loop) never hold more than a batch in RAM.  ``np.asarray`` on a small
    instance still materializes correctly via the iteration protocol.
    """

    def __init__(self, data: np.ndarray, idx: np.ndarray, size: int) -> None:
        self._data = data
        self._idx = idx
        self._size = int(size)

    def __len__(self) -> int:
        return int(self._idx.size)

    def __getitem__(self, j: Any) -> Any:
        if isinstance(j, (int, np.integer)):
            return resize_uint8(self._data[self._idx[j]], self._size)
        sub = self._idx[j]  # slice/array: one materialized sub-batch
        out = np.empty((sub.size, self._size, self._size, 3), np.uint8)
        for p, i in enumerate(sub):
            out[p] = resize_uint8(self._data[i], self._size)
        return out

    def __iter__(self) -> Any:
        for j in range(len(self)):
            yield self[j]


def is_packed_corpus(path: Union[str, Path]) -> bool:
    """Cheap check: a ``.npy`` file whose header says uint8 rank-4."""
    p = Path(path)
    if not (p.is_file() and p.suffix == ".npy"):
        return False
    try:
        with open(p, "rb") as f:
            version = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            shape, _, dtype = read(f)
        return len(shape) == 4 and shape[-1] == 3 and dtype == np.uint8
    except Exception:  # noqa: BLE001
        return False


__all__ = ["PackedImages", "is_packed_corpus", "pack_images"]
