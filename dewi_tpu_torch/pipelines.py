"""Signal-computation pipeline: documents -> signals -> DEWI scores -> index.

Counterpart of ``dewi_tpu/pipelines.py``, with the same stages, checkpoints
and results:

* one implementation of every stage, over a
  :class:`~dewi_tpu_torch.corpus.Corpus` column store (``process_corpus``,
  ``compute_signals_corpus``, ``process_stream_corpus``,
  ``build_index_corpus``), and the ``Document`` API (``compute_signals``,
  ``ensure_embeddings``, ``compute_dewi_scores``, ``process_stream``,
  ``build_index``) as a veneer over it: each of its methods columnarises
  its Documents, runs the columnar stage and writes the results back;
* stage checkpoints (``<dir>/<stage>.npz`` with a digest of the Documents)
  that hash the same bytes as the reference's, so a checkpoint directory
  written by either package resumes in the other;
* documents without embeddings get CLIP embeddings (text tower, image
  tower, or the normalized mean of both), and the index records the
  encoder's provenance (``cross_modal``, ``mixed`` or ``external``).

``DewiPipeline(device=None)`` runs on the card and raises without one; the
device goes to every estimator, the scorer and the index.  Under ``mesh=``
(or ``mesh.data_parallel_signals: true`` in the config, which builds one
over the process group's ranks) the LM, MAE and CLIP forwards run
data-parallel and the redundancy scan splits its rows over the data axis;
the redundancy stage and the robust-statistics fit see the gathered
signals, so every rank ends with the same signals and scores as one
device would.  The index handoff and every file write happen on rank 0,
while the other ranks wait at a barrier.

While a ``torch.profiler`` session records, the stages name their calls
as spans (``dewi.process_corpus``, ``dewi.text_entropy``, ...
``dewi.index.build``; ``utils.profiling.span``) under either API; a span
never synchronises the device.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np

import torch

from .config import DewiConfig
from .types import SIGNAL_FIELDS, Payload, Weights
from .utils.device import DeviceLike
from .utils.profiling import span

logger = logging.getLogger(__name__)

PathLike = Union[str, Path]


@dataclass
class Document:
    """Per-document record; ``image`` holds an in-memory array source."""

    doc_id: str
    text: Optional[str] = None
    image_path: Optional[str] = None
    image: Optional[np.ndarray] = None
    embedding: Optional[np.ndarray] = None

    ht_mean: Optional[float] = None
    ht_q90: Optional[float] = None
    hi_mean: Optional[float] = None
    hi_q90: Optional[float] = None
    I_hat: Optional[float] = None
    redundancy: Optional[float] = None
    noise: Optional[float] = None
    dewi_score: Optional[float] = None

    def signals_dict(self) -> Dict[str, float]:
        """None-coalescing signal view."""
        return {k: float(getattr(self, k) or 0.0) for k in SIGNAL_FIELDS}

    def payload(self) -> Payload:
        return Payload(dewi=float(self.dewi_score or 0.0), **self.signals_dict())

    def image_source(self) -> Any:
        return self.image if self.image is not None else self.image_path


def create_document(
    doc_id: str,
    text: Optional[str] = None,
    image_path: Optional[PathLike] = None,
    embedding: Optional[np.ndarray] = None,
    image: Optional[np.ndarray] = None,
) -> Document:
    """A :class:`Document` with ``image_path`` as a string."""
    return Document(
        doc_id=doc_id,
        text=text,
        image_path=str(image_path) if image_path else None,
        image=image,
        embedding=embedding,
    )


class _StageCheckpoint:
    """Per-stage npz checkpoints: ``<dir>/<stage>.npz`` + corpus digest.

    Besides the doc count, each checkpoint records a digest of the corpus
    identity (doc ids, text content, image file identity), so resuming
    against a *different* same-length corpus (edited docs, reordered ids)
    discards the stale cache instead of applying cached signals to the
    wrong documents.  The digest hashes the same bytes as the reference's,
    so checkpoints cross between the packages both ways."""

    def __init__(self, directory: Optional[PathLike],
                 documents: Any, mesh: Any = None) -> None:
        self.dir = Path(directory) if directory else None
        self.mesh = mesh  # under a mesh, rank 0 writes
        self.n_docs = len(documents)
        self.digest = self._digest(documents) if self.dir else ""
        if self.dir:
            self.dir.mkdir(parents=True, exist_ok=True)

    @staticmethod
    def _digest(documents: Any) -> str:
        import hashlib
        import os

        h = hashlib.sha256()
        for d in documents:
            h.update(d.doc_id.encode())
            # Text CONTENT, not just length: same-length edits must
            # invalidate the cache.
            h.update((d.text or "").encode("utf-8", "replace"))
            h.update(b"\0")
            # Image identity: path plus size/mtime when it is a real file
            # (re-exported images with the same name invalidate too).
            ip = getattr(d, "image_path", None)
            if ip:
                h.update(str(ip).encode())
                try:
                    st = os.stat(ip)
                    h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())
                except OSError:
                    pass
            arr = getattr(d, "image", None)
            if arr is not None:
                # In-memory arrays: shape/dtype plus a strided byte sample
                # (hashing whole corpora of pixels would dominate resume).
                a = np.ascontiguousarray(arr)
                h.update(str((a.shape, str(a.dtype))).encode())
                flat = a.reshape(-1).view(np.uint8)
                h.update(flat[:: max(1, flat.size // 4096)].tobytes())
            h.update(b"\1")
        return h.hexdigest()[:16]

    def load(self, stage: str) -> Optional[Dict[str, np.ndarray]]:
        if not self.dir:
            return None
        path = self.dir / f"{stage}.npz"
        if not path.exists():
            return None
        data = np.load(path, allow_pickle=False)
        if int(data["n_docs"]) != self.n_docs:
            logger.warning("Checkpoint %s is for %d docs (have %d); ignoring.",
                           path, int(data["n_docs"]), self.n_docs)
            return None
        saved_digest = str(data["digest"]) if "digest" in data.files else ""
        if self.digest and saved_digest and saved_digest != self.digest:
            logger.warning(
                "Checkpoint %s was computed for a different corpus "
                "(digest %s != %s); ignoring.", path, saved_digest, self.digest
            )
            return None
        return {
            k: data[k] for k in data.files if k not in ("n_docs", "digest")
        }

    def save(self, stage: str, **arrays: np.ndarray) -> None:
        if not self.dir:
            return
        _on_rank0(self.mesh, lambda: np.savez(self.dir / f"{stage}.npz", n_docs=self.n_docs,
                                              digest=self.digest, **arrays))


_NO_CHECKPOINT = _StageCheckpoint(None, ())  # loads nothing, saves nothing


def _on_rank0(mesh: Any, fn: Any) -> Any:
    """``fn()`` on rank 0 only (its value there, ``None`` elsewhere); under a
    mesh every rank then waits at a barrier, so no rank reads a file before
    it is whole."""
    out = fn() if mesh is None or mesh.rank == 0 else None
    if mesh is not None:
        mesh.barrier()
    return out


class _CorpusImages:
    """Decode-once image cache for one ``compute_signals_corpus`` call.

    The corpus is decoded once at the largest resolution any stage needs
    (threaded, JPEG draft mode, uint8 — :mod:`dewi_tpu_torch.io`) and every
    stage (MAE, CLIP, blur/skin, pHash) reads from RAM.  Corpora beyond
    ``runtime.decode_cache_mb`` fall back to the estimators' own streaming
    prefetch decoders.
    """

    def __init__(self, sources: Any, img_idx: Any, base_size: int,
                 threads: int, budget_mb: int) -> None:
        from .io.images import ImageCache

        self.pos = {i: j for j, i in enumerate(img_idx)}
        self.sources = list(sources)  # aligned with img_idx
        self.cache = None
        if self.sources and ImageCache.fits(
            len(self.sources), base_size, budget_mb
        ):
            try:
                self.cache = ImageCache(
                    self.sources, base_size, threads=threads
                )
            except Exception as e:  # noqa: BLE001 — fall back to streaming
                logger.warning("Image decode cache unavailable (%s); "
                               "stages will decode independently.", e)

    def rows(self, idx_list: Any, size: int) -> Any:
        """Images for ``idx_list`` at ``size``: a ``[n, size, size, 3]``
        uint8 array when cached, else the original sources (streamed)."""
        if self.cache is None:
            return [self.sources[self.pos[i]] for i in idx_list]
        if size <= self.cache.base_size:
            arr = self.cache.at(size)
        else:  # stage wants more pixels than the cache holds: serve base
            logger.warning(
                "Image cache holds %dpx but a stage requested %dpx; serving "
                "the %dpx cache (the model will upscale). Raise the cache "
                "base size if this stage's fidelity matters.",
                self.cache.base_size, size, self.cache.base_size,
            )
            arr = self.cache.base
        rows = [self.pos[i] for i in idx_list]
        if rows == list(range(len(arr))):
            return arr
        return arr[np.asarray(rows, np.int64)]

    def source(self, i: int) -> Any:
        """Single image for host-side per-doc loops (noise heuristics)."""
        if self.cache is None:
            return self.sources[self.pos[i]]
        return self.cache.base[self.pos[i]]


class DewiPipeline:
    """Signals + scoring + index orchestration on one device or a mesh."""

    def __init__(self, config: Optional[DewiConfig] = None,
                 nsfw_fn: Any = None, mesh: Any = None,
                 device: DeviceLike = None) -> None:
        """``device=None`` runs on the card (raising without one), or on the
        mesh's device.  ``mesh`` (or ``config.mesh.data_parallel_signals:
        true``, which builds one: ``mesh.data: -1`` takes every rank the
        model axis leaves) runs the estimator forwards data-parallel."""
        from .parallel.mesh import check_mesh, make_mesh, mesh_device

        self.config = config or DewiConfig()
        self.mesh = check_mesh(mesh) if mesh is not None else None
        if self.mesh is None and self.config.mesh.data_parallel_signals:
            m = self.config.mesh
            self.mesh = make_mesh(n_data=m.data if m.data > 0 else None,
                                  n_model=max(1, int(m.model)), device=device)
        self.device = mesh_device(self.mesh, device)
        self._nsfw_fn = nsfw_fn
        self._text_entropy = None
        self._image_entropy = None
        self._cross_modal = None
        self._redundancy = None
        self._noise = None
        # Doc ids whose embeddings THIS pipeline filled via the CLIP towers
        # (vs supplied externally) — decides the provenance an index records.
        self._clip_embedded_ids: set = set()

    # -- lazy estimators (constructed on first use; ctor stays cheap) --------

    @property
    def text_entropy(self) -> Any:
        if self._text_entropy is None:
            from .signals.text_entropy import TextEntropyEstimator

            c = self.config.text
            self._text_entropy = TextEntropyEstimator(
                model_name=c.model,
                quantiles=c.quantiles,
                batch_size=c.batch_size,
                max_length=c.max_length,
                tokenizer=c.tokenizer,
                domain_model_name=c.domain_model,
                checkpoint=c.checkpoint,
                domain_checkpoint=c.domain_checkpoint,
                seed=c.seed,
                device=self.device,
                mesh=self.mesh,
            )
        return self._text_entropy

    @property
    def image_entropy(self) -> Any:
        if self._image_entropy is None:
            from .signals.image_entropy import ImageEntropyEstimator

            c = self.config.image
            self._image_entropy = ImageEntropyEstimator(
                model_name=c.model,
                patch_size=c.patch_size,
                image_size=c.image_size,
                mask_ratio=c.mask_ratio,
                batch_size=c.batch_size,
                checkpoint=c.checkpoint,
                seed=c.seed,
                device=self.device,
                mesh=self.mesh,
            )
        return self._image_entropy

    @property
    def cross_modal(self) -> Any:
        if self._cross_modal is None:
            from .signals.cross_modal import CrossModalDependency

            c = self.config.cross_modal
            self._cross_modal = CrossModalDependency(
                model_name=c.model,
                batch_size=c.batch_size,
                tokenizer=self.config.text.tokenizer,
                checkpoint=c.checkpoint,
                seed=c.seed,
                image_size=getattr(c, "image_size", None),
                device=self.device,
                mesh=self.mesh,
            )
        return self._cross_modal

    @property
    def redundancy(self) -> Any:
        if self._redundancy is None:
            from .signals.redundancy import RedundancyEstimator

            c = self.config.redundancy
            self._redundancy = RedundancyEstimator(
                model_name=self.config.cross_modal.model,
                text_sim=c.text_sim,
                image_sim=c.image_sim,
                cross_modal_density=c.cross_modal_density,
                block_size=c.block_size,
                threshold=c.threshold,
                clip=self._cross_modal,  # share towers when already built
                device=self.device,
                mesh=self.mesh,
            )
        return self._redundancy

    @property
    def noise(self) -> Any:
        if self._noise is None:
            from .signals.noise import NoiseEstimator

            c = self.config.noise
            self._noise = NoiseEstimator(
                expected_language=c.expected_language,
                blur_threshold=c.blur_threshold,
                ocr_min_coverage=c.ocr_min_coverage,
                nsfw_filter=c.nsfw_filter,
                nsfw_fn=self._nsfw_fn,
                device=self.device,
            )
        return self._noise

    # -- the Document API: a veneer over the columnar stages ------------------
    #
    # Each method columnarises its Documents (Corpus.from_documents), runs the
    # columnar stage and writes the results back, so both APIs run one
    # implementation of every stage and record the same spans.

    def compute_signals(
        self,
        documents: List[Document],
        progress: bool = False,
        checkpoint_dir: Optional[PathLike] = None,
        include_redundancy: bool = True,
    ) -> List[Document]:
        """Fill the seven signal fields of every document, stage by stage
        (:meth:`compute_signals_corpus` over the Documents' columns).

        ``checkpoint_dir`` keeps each stage in ``<dir>/<stage>.npz``, keyed
        to the Documents' digest; a later call on the same Documents loads
        the stages found there instead of running them.
        ``include_redundancy=False`` defers the (cross-document) redundancy
        stage and leaves that field as it was — used by
        :meth:`process_stream`, which runs it globally after all shards so
        sharding never changes scores.
        """
        if not documents:
            return []
        from .corpus import Corpus

        corpus = Corpus.from_documents(documents)
        self.compute_signals_corpus(
            corpus, progress=progress, include_redundancy=include_redundancy,
            _ckpt=_StageCheckpoint(checkpoint_dir, documents, self.mesh))
        self._note_clip_rows(corpus)
        kept = None if include_redundancy else [d.redundancy for d in documents]
        corpus.apply_to_documents(documents)
        if kept is not None:
            for d, r in zip(documents, kept):
                d.redundancy = r
        return documents

    def ensure_embeddings(
        self, documents: List[Document],
        images: Optional[_CorpusImages] = None,
    ) -> List[Document]:
        """Fill missing ``embedding`` fields from the CLIP towers
        (:meth:`ensure_embeddings_corpus`; ``images`` is a decode-once cache
        of the image documents, keyed by their positions)."""
        if documents:
            self._embedded(documents, images)
        return documents

    def compute_dewi_scores(
        self,
        documents: List[Document],
        weights: Optional[Union[Dict[str, float], Weights]] = None,
        delta: Optional[float] = None,
        mode: Optional[str] = None,
    ) -> List[Document]:
        """Fit robust stats and score all docs in one matrix call
        (:meth:`_score_corpus`; a signal left ``None`` counts as 0)."""
        if not documents:
            return []
        from .corpus import Corpus

        corpus = self._score_corpus(Corpus.from_documents(documents),
                                    weights, delta, mode)
        for d, s in zip(documents, corpus.dewi):
            d.dewi_score = float(s)
        return documents

    def process_stream(
        self,
        documents: List[Document],
        shard_size: Optional[int] = None,
        checkpoint_dir: Optional[PathLike] = None,
        weights: Any = None,
        delta: Optional[float] = None,
        mode: Optional[str] = None,
        progress: bool = False,
    ) -> List[Document]:
        """Sharded signal computation with per-shard resume + global scoring.

        Corpora larger than host or device memory process in
        ``shard_size`` chunks; each shard's signal stages checkpoint
        independently under ``<dir>/shard_NNNNN/`` (the reference's layout;
        a restarted run skips completed stages), and the redundancy stage
        (``<dir>/redundancy.npz``) and the robust statistics run GLOBALLY
        over all shards — identical results to the monolithic path.
        """
        if not documents:
            return []
        from .corpus import Corpus

        shard_size = int(shard_size or self.config.runtime.shard_size)
        ckpt_root = Path(checkpoint_dir) if checkpoint_dir else None
        n_shards = (len(documents) + shard_size - 1) // shard_size
        for s in range(n_shards):
            shard = documents[s * shard_size : (s + 1) * shard_size]
            sub = ckpt_root / f"shard_{s:05d}" if ckpt_root else None
            if progress:
                print(f"Shard {s + 1}/{n_shards} ({len(shard)} docs)")
            self.compute_signals(shard, progress=progress, checkpoint_dir=sub,
                                 include_redundancy=False)
        corpus = Corpus.from_documents(documents)
        with span("dewi.redundancy"):
            self._redundancy_corpus(
                corpus, ckpt=_StageCheckpoint(ckpt_root, documents, self.mesh))
        self._score_corpus(corpus, weights, delta, mode)
        corpus.apply_to_documents(documents)
        return documents

    def build_index(self, documents: List[Document],
                    **index_kwargs: Any) -> Any:
        """Documents -> built :class:`DewiIndex` (embeddings + payloads;
        :meth:`build_index_corpus`).  Under a mesh: rank 0's index, ``None``
        on the other ranks."""
        if not documents:
            raise ValueError("No documents to index")
        return self.build_index_corpus(self._embedded(documents),
                                       **index_kwargs)

    def _embedded(self, documents: List[Document],
                  images: Optional[_CorpusImages] = None) -> Any:
        """The Documents' corpus with every embedding filled: the CLIP
        towers fill the missing ones, which the Documents then carry too."""
        from .corpus import Corpus

        corpus = self._note_clip_rows(self.ensure_embeddings_corpus(
            Corpus.from_documents(documents), cache=images))
        for d, e in zip(documents, corpus.embeddings):
            if d.embedding is None:
                d.embedding = e
        return corpus

    def _note_clip_rows(self, corpus: Any) -> Any:
        """Provenance across Document API calls: remember the rows the CLIP
        towers filled, and mark as CLIP-filled every row whose Document this
        pipeline embedded, in this call or an earlier one (the Documents
        then carry those embeddings as if supplied)."""
        filled = getattr(corpus, "clip_filled_mask", None)
        if filled is not None:
            self._clip_embedded_ids.update(
                corpus.ids[i] for i in np.flatnonzero(filled))
        corpus.clip_filled_mask = np.array(
            [i in self._clip_embedded_ids for i in corpus.ids], bool)
        corpus.clip_embedded = bool(corpus.clip_filled_mask.all())
        return corpus

    # -- shared helpers -----------------------------------------------------------

    def _decode_sources(self, sources: Any,
                        img_idx: Any) -> _CorpusImages:
        sizes = [self._mae_image_size(), self._clip_image_size()]
        rt = self.config.runtime
        return _CorpusImages(
            sources, img_idx, base_size=max(sizes),
            threads=rt.io_threads, budget_mb=rt.decode_cache_mb,
        )

    def _mae_image_size(self) -> int:
        if self._image_entropy is not None:
            return self._image_entropy.image_size
        c = self.config.image
        side = self._sidecar_size(c.checkpoint)
        if side:
            return side
        if c.image_size:
            return int(c.image_size)
        if c.model in ("pixel", "none", "proxy"):
            return 224
        from .models.registry import mae_config

        return mae_config(c.model).image_size

    def _clip_image_size(self) -> int:
        if self._cross_modal is not None:
            return self._cross_modal.cfg.image_size
        side = self._sidecar_size(self.config.cross_modal.checkpoint)
        if side:
            return side
        over = getattr(self.config.cross_modal, "image_size", None)
        if over:
            return int(over)
        from .models.registry import clip_config

        return clip_config(self.config.cross_modal.model).image_size

    @staticmethod
    def _sidecar_size(checkpoint: Any) -> Optional[int]:
        """image_size from a checkpoint's architecture sidecar, if any."""
        if not checkpoint:
            return None
        from .models.import_hf import sidecar_config

        side = sidecar_config(checkpoint)
        if side and side.get("config", {}).get("image_size"):
            return int(side["config"]["image_size"])
        return None

    def encode_query(self, text: str) -> np.ndarray:
        """Text -> embedding for search (the CLIP text tower)."""
        return self.cross_modal.encode_texts([text])[0]

    def encoder_provenance(self) -> Dict[str, object]:
        """Identity of the embedding encoder (CLIP towers) for this pipeline.

        Recorded into any index built from these embeddings so search/eval
        can reconstruct the SAME query encoder (preset + tokenizer + seed +
        checkpoint) instead of guessing by embedding dim — a mismatched
        encoder returns meaningless rankings with no other symptom.
        """
        from .models.registry import checkpoint_fingerprint

        c = self.config.cross_modal
        return {
            "model": c.model,
            "tokenizer": self.config.text.tokenizer,
            "seed": int(c.seed),
            "checkpoint": c.checkpoint,
            "checkpoint_fingerprint": checkpoint_fingerprint(c.checkpoint),
            "d_embed": int(self.cross_modal.cfg.d_embed)
            if self._cross_modal is not None
            else None,
        }

    def _make_scorer(self, weights: Any = None,
                     delta: Optional[float] = None) -> Any:
        from .scorer import DewiScorer

        if weights is None:
            w = self.config.scoring.weights
            weights = Weights(
                alpha_t=w.alpha_t, alpha_i=w.alpha_i, alpha_m=w.alpha_m,
                alpha_r=w.alpha_r, alpha_n=w.alpha_n,
            )
        elif isinstance(weights, dict):
            weights = Weights(**weights)
        return DewiScorer(
            weights=weights, delta=delta or self.config.scoring.delta,
            device=self.device,
        )

    # -- the stages, over a Corpus column store ---------------------------------------
    #
    # No per-Document attribute traffic, no per-doc dict/stack in the hot
    # loop; the Document API above calls these.

    def _corpus_rows(self, corpus: Any, idx: Any, size: int,
                     cache: Any = None, dev: Any = None) -> Any:
        """Image batch for corpus rows ``idx`` at ``size`` (or source list).

        ``dev`` is an optional ``(DeviceImages, pos_map_or_None)`` pair: when
        set, the batch is served as device-resident rows (a DeviceImages
        view — ``iter_corpus_batches`` slices/resizes it on the device with
        no host decode or re-upload).  Only pass ``dev`` to consumers that
        stream through ``iter_corpus_batches``.
        """
        imgs = corpus.images
        idx = np.asarray(idx, np.int64)
        if dev is not None:
            di, pos = dev
            rows = (
                idx if pos is None
                else np.asarray([pos[int(i)] for i in idx], np.int64)
            )
            if rows.size == len(di) and np.array_equal(
                rows, np.arange(len(di))
            ):
                return di
            return di.gather(rows)
        if hasattr(imgs, "rows"):  # PackedImages: mmap slice (+downscale)
            return imgs.rows(idx, size)
        if isinstance(imgs, np.ndarray):  # dense pre-decoded corpus
            if idx.size == len(imgs) and np.array_equal(
                idx, np.arange(len(imgs))
            ):
                return imgs
            return imgs[idx]
        if cache is not None:
            return cache.rows(list(idx), size)
        return [imgs[i] for i in idx]

    def _device_corpus(self, corpus: Any, cache: Any = None,
                       non_blocking: bool = False) -> Any:
        """``(DeviceImages, pos_map_or_None)`` for this corpus, or ``None``.

        Uploads a uniform uint8 image corpus to the device ONCE so the MAE
        tower, the CLIP vision tower and the blur/skin noise pass all read
        device memory instead of each re-uploading the same bytes.  Sources,
        in order of preference: a dense ``[N, H, W, 3]`` corpus array, a
        PackedImages mmap (one sequential read), or the decode-once cache.
        Gated on the ``DEWI_DEVICE_IMAGES_MAX_BYTES`` budget — over-budget
        corpora keep the host paths (io/device_images.py).
        """
        from .io.device_images import device_images_or_none

        if self.mesh is not None and self.mesh.n_data > 1:
            # Residency would put the whole corpus on every rank's device;
            # under a data-parallel mesh each rank puts its slice of every
            # host batch there instead.
            return None
        imgs = corpus.images
        src, pos = None, None
        if isinstance(imgs, np.ndarray) and imgs.ndim == 4:
            src = imgs
        elif hasattr(imgs, "data") and isinstance(
            getattr(imgs, "data", None), np.ndarray
        ):
            src = imgs.data  # PackedImages: materialise the mmap once
        elif cache is not None and cache.cache is not None:
            src = cache.cache.base
            pos = cache.pos  # cache rows are img_idx-aligned, not doc-aligned
        di = (device_images_or_none(src, device=self.device, non_blocking=non_blocking)
              if src is not None else None)
        return (di, pos) if di is not None else None

    def compute_signals_corpus(self, corpus: Any, progress: bool = False,
                               include_redundancy: bool = True,
                               _ckpt: _StageCheckpoint = _NO_CHECKPOINT) -> Any:
        """Fill ``corpus.signals`` (all 7 columns) stage by stage.

        ``include_redundancy=False`` skips the cross-document redundancy
        stage — :meth:`process_stream_corpus` and :meth:`process_stream`
        run it globally after all shards so sharding never changes scores.
        ``_ckpt`` (the Documents' stage checkpoints, from
        :meth:`compute_signals` and the command line) loads each of the five
        stages it holds instead of running it, and saves the ones it runs.
        """
        from .corpus import COL
        from .utils.progress import ProgressMeter

        n = len(corpus)
        if n == 0:
            return corpus
        sig = corpus.signals
        tidx = np.nonzero(corpus.has_text)[0]
        iidx = np.nonzero(corpus.has_image)[0]
        # Start the one-time device-resident image upload FIRST, in the
        # background, so the corpus streams to the device while the text
        # LM runs instead of ahead of stage 2.  (Per-doc sources can't
        # pre-put: they decode below, after which _device_corpus retries
        # from the cache.)
        dev = (
            self._device_corpus(corpus, non_blocking=True)
            if iidx.size and (
                hasattr(corpus.images, "rows")
                or isinstance(corpus.images, np.ndarray)
            ) else None
        )
        if tidx.size:
            cached = _ckpt.load("text")
            if cached is None:
                m = ProgressMeter(int(tidx.size), "text entropy",
                                  enabled=progress)
                with span("dewi.text_entropy"):
                    means, q90s, _ = self.text_entropy.batch_compute_stats(
                        [corpus.texts[i] for i in tidx], progress=m.update
                    )
                m.close()
                _ckpt.save("text", idx=tidx, means=means, q90s=q90s)
            else:
                means, q90s = cached["means"], cached["q90s"]
            sig[tidx, COL["ht_mean"]] = means
            sig[tidx, COL["ht_q90"]] = q90s

        cache = None
        if iidx.size and not (
            hasattr(corpus.images, "rows")
            or isinstance(corpus.images, np.ndarray)
        ):
            # Per-doc sources (paths/PIL): decode once for every stage.
            cache = self._decode_sources(
                [corpus.images[i] for i in iidx], list(iidx)
            )
        if dev is None and iidx.size:
            dev = self._device_corpus(corpus, cache)
        if iidx.size:
            cached = _ckpt.load("image")
            if cached is None:
                m = ProgressMeter(int(iidx.size), "image entropy",
                                  enabled=progress)
                with span("dewi.image_entropy"):
                    means, q90s = self.image_entropy.batch_compute_stats(
                        self._corpus_rows(corpus, iidx,
                                          self.image_entropy.image_size,
                                          cache, dev=dev),
                        progress=m.update,
                    )
                m.close()
                _ckpt.save("image", idx=iidx, means=means, q90s=q90s)
            else:
                means, q90s = cached["means"], cached["q90s"]
            sig[iidx, COL["hi_mean"]] = means
            sig[iidx, COL["hi_q90"]] = q90s

        # Stages 3+4 share the CLIP towers: each tower encodes its modality
        # ONCE, the I_hat diagonal and the joint document embeddings both
        # read from the same arrays.
        pidx = np.nonzero(corpus.has_text & corpus.has_image)[0]
        cached = _ckpt.load("cross_modal") if pidx.size else None
        pairs = pidx if cached is None else pidx[:0]  # rows to encode for I_hat
        ext_mask = getattr(corpus, "ext_embedding_mask", None)
        need_emb = corpus.embeddings is None or (
            ext_mask is not None and not bool(ext_mask.all())
        )
        t_emb = v_emb = None
        tpos: Dict[int, int] = {}
        vpos: Dict[int, int] = {}
        if need_emb or pairs.size:
            # Encode exactly what downstream needs: the paired docs (for
            # I_hat) plus — when embeddings must be filled — the rows NOT
            # covered by an external mask.  Encoding all of tidx/iidx with
            # a 90%-external corpus would throw away 90% of the dominant
            # stage cost (tower forwards + image transfer).
            if not need_emb:
                t_want = v_want = pairs
            elif ext_mask is not None:
                fill = ~ext_mask
                t_want = np.union1d(pairs, tidx[fill[tidx]]).astype(np.int64)
                v_want = np.union1d(pairs, iidx[fill[iidx]]).astype(np.int64)
            else:
                t_want, v_want = tidx, iidx
            if t_want.size:
                with span("dewi.cross_modal.text"):
                    t_emb = self.cross_modal.encode_texts(
                        [corpus.texts[i] for i in t_want]
                    )
                tpos = {int(i): j for j, i in enumerate(t_want)}
            if v_want.size:
                m = ProgressMeter(int(v_want.size), "cross-modal encode",
                                  enabled=progress)
                with span("dewi.cross_modal.image"):
                    v_emb = self.cross_modal.encode_images(
                        self._corpus_rows(corpus, v_want,
                                          self.cross_modal.cfg.image_size,
                                          cache, dev=dev),
                        progress=m.update,
                    )
                m.close()
                vpos = {int(i): j for j, i in enumerate(v_want)}
        if pidx.size:
            if cached is None:
                trows = np.asarray([tpos[int(i)] for i in pidx])
                vrows = np.asarray([vpos[int(i)] for i in pidx])
                sims = np.sum(t_emb[trows] * v_emb[vrows], axis=1)
                _ckpt.save("cross_modal", idx=pidx, sims=sims)
            else:
                sims = cached["sims"]
            sig[pidx, COL["I_hat"]] = sims

        with span("dewi.embeddings"):
            self.ensure_embeddings_corpus(
                corpus, cache=cache, dev=dev,
                _t_emb=t_emb if need_emb else None,
                _v_emb=v_emb if need_emb else None,
                _t_idx=t_want if need_emb else None,
                _v_idx=v_want if need_emb else None,
            )
        if include_redundancy:
            with span("dewi.redundancy"):
                self._redundancy_corpus(corpus, cache=cache, ckpt=_ckpt)
        with span("dewi.noise"):
            return self._noise_corpus(corpus, cache=cache, dev=dev,
                                      progress=progress, ckpt=_ckpt)

    def ensure_embeddings_corpus(self, corpus: Any, cache: Any = None,
                                 dev: Any = None,
                                 _t_emb: Any = None, _v_emb: Any = None,
                                 _t_idx: Any = None,
                                 _v_idx: Any = None) -> Any:
        """Fill ``corpus.embeddings`` from the CLIP towers (vectorized
        combine).

        ``_t_emb``/``_v_emb`` (with their doc-index vectors ``_t_idx``/
        ``_v_idx``) let :meth:`compute_signals_corpus` pass the tower
        outputs it already computed for the cross-modal stage — no
        re-encode as long as they cover the rows being filled.

        Partial external embeddings (``corpus.ext_embedding_mask``) keep
        their supplied rows; only the unmasked rows are CLIP-filled.
        """
        ext_mask = getattr(corpus, "ext_embedding_mask", None)
        filled = getattr(corpus, "clip_filled_mask", None)
        if corpus.embeddings is not None and (
            ext_mask is None or bool(ext_mask.all())
            # Every non-external row already CLIP-filled (e.g. by
            # process_stream_corpus): re-encoding the towers over the
            # whole corpus here would redo the dominant cost monolithic.
            or (filled is not None and bool((ext_mask | filled).all()))
        ):
            if not hasattr(corpus, "clip_embedded"):
                corpus.clip_embedded = False  # supplied externally
            return corpus
        n = len(corpus)
        dim = self.cross_modal.cfg.d_embed
        ext = corpus.embeddings
        if ext is not None and ext.shape[1] != dim:
            raise ValueError(
                f"external embeddings are dim {ext.shape[1]} but the CLIP "
                f"towers emit dim {dim}; cannot fill the "
                f"{int((~ext_mask).sum())} docs without embeddings in the "
                "same index space — supply embeddings for every doc or "
                "match cross_modal.d_embed"
            )
        emb = np.zeros((n, dim), np.float32)
        cnt = np.zeros(n, np.float32)
        # Only rows actually being CLIP-filled need tower outputs — with a
        # partial external mask that's the unmasked rows, not the corpus.
        fill = np.ones(n, bool) if ext_mask is None else ~ext_mask

        def rows_from(done_emb: Any, done_idx: Any, want: Any) -> Any:
            """Reuse tower outputs for ``want`` rows when the caller's
            encode set covers them; encode just ``want`` otherwise."""
            if done_emb is not None and done_idx is not None:
                pos = {int(i): j for j, i in enumerate(done_idx)}
                if all(int(i) in pos for i in want):
                    return done_emb[[pos[int(i)] for i in want]]
            return None

        tidx = np.nonzero(corpus.has_text & fill)[0]
        if tidx.size:
            t_emb = rows_from(_t_emb, _t_idx, tidx)
            if t_emb is None:
                t_emb = self.cross_modal.encode_texts(
                    [corpus.texts[i] for i in tidx]
                )
            emb[tidx] += t_emb
            cnt[tidx] += 1
        iidx = np.nonzero(corpus.has_image & fill)[0]
        if iidx.size:
            v_emb = rows_from(_v_emb, _v_idx, iidx)
            if v_emb is None:
                v_emb = self.cross_modal.encode_images(
                    self._corpus_rows(corpus, iidx,
                                      self.cross_modal.cfg.image_size,
                                      cache, dev=dev)
                )
            emb[iidx] += v_emb
            cnt[iidx] += 1
        nz = cnt > 0
        emb[nz] /= cnt[nz, None]
        norms = np.linalg.norm(emb, axis=1, keepdims=True)
        np.divide(emb, norms, out=emb, where=norms > 0)
        if ext is not None:
            # Externally supplied rows win; CLIP fills only the gaps.
            emb = np.where(ext_mask[:, None], np.asarray(ext, np.float32),
                           emb)
            corpus.clip_filled_mask = ~ext_mask
            corpus.clip_embedded = False
        else:
            corpus.clip_filled_mask = np.ones(n, bool)
            corpus.clip_embedded = True
        corpus.embeddings = emb
        return corpus

    def _redundancy_corpus(self, corpus: Any, cache: Any = None,
                           ckpt: _StageCheckpoint = _NO_CHECKPOINT) -> Any:
        """Global redundancy over an embedded corpus.

        Modes (config.redundancy): ``text_sim: minhash|simhash`` hashes text
        docs; ``image_sim: phash`` perceptual-hashes image docs; anything
        else scores docs by embedding-space max-offdiag similarity.  When
        hash modes cover only one modality, the remaining docs fall back to
        the embedding mode, and a doc covered by several modes keeps its
        max; ``cross_modal_density`` adds the multimodal docs' density in
        their joint text+image embedding space.
        """
        from .corpus import COL

        cached = ckpt.load("redundancy")
        if cached is not None:
            corpus.signals[:, COL["redundancy"]] = cached["scores"]
            return corpus
        n = len(corpus)
        scores = np.zeros(n, np.float32)
        covered = np.zeros(n, bool)
        text_hash = self.config.redundancy.text_sim in ("minhash", "simhash")
        image_hash = self.config.redundancy.image_sim == "phash"
        tidx = np.nonzero(corpus.has_text)[0]
        iidx = np.nonzero(corpus.has_image)[0]
        if text_hash and tidx.size:
            scores[tidx] = self.redundancy.score_texts(
                [corpus.texts[i] for i in tidx]
            )
            covered[tidx] = True
        if image_hash and iidx.size:
            rows = self._corpus_rows(corpus, iidx, 32, cache)  # pHash DCT res
            scores[iidx] = np.maximum(
                scores[iidx], self.redundancy.score_images(rows)
            )
            covered[iidx] = True
        rest = np.nonzero(~covered)[0]
        if rest.size >= 2 and corpus.embeddings is not None:
            scores[rest] = np.maximum(
                scores[rest], self.redundancy.score(corpus.embeddings[rest])
            )
        if self.redundancy.cross_modal_density:
            both = np.nonzero(corpus.has_text & corpus.has_image)[0]
            if both.size >= 2 and corpus.embeddings is not None:
                scores[both] = np.maximum(
                    scores[both],
                    self.redundancy.cross_modal_density_scores(
                        corpus.embeddings[both]
                    ),
                )
        corpus.signals[:, COL["redundancy"]] = scores
        ckpt.save("redundancy", scores=scores)
        return corpus

    def _noise_corpus(self, corpus: Any, cache: Any = None,
                      dev: Any = None, progress: bool = False,
                      ckpt: _StageCheckpoint = _NO_CHECKPOINT) -> Any:
        from .corpus import COL
        from .signals.noise import BLUR_SIZE
        from .utils.progress import ProgressMeter

        cached = ckpt.load("noise")
        if cached is not None:
            corpus.signals[:, COL["noise"]] = cached["scores"]
            return corpus
        n = len(corpus)
        texts = corpus.texts if corpus.texts is not None else [None] * n
        present = None
        # Doc-aligned device corpus within the blur pass's fidelity window:
        # run blur+skin straight off device memory, present-masked.
        if (
            dev is not None and dev[1] is None and len(dev[0]) == n
            and dev[0].size <= BLUR_SIZE and dev[0].shape[2] <= BLUR_SIZE
        ):
            images, present = dev[0].base, corpus.has_image
        elif (
            isinstance(corpus.images, np.ndarray)
            and corpus.images.ndim == 4 and len(corpus.images) == n
        ):
            # Dense host corpus: the masked array path batches eligible
            # shapes and degrades to the per-doc loop internally otherwise.
            images, present = corpus.images, corpus.has_image
        elif cache is not None and cache.cache is not None and \
                cache.cache.base_size >= BLUR_SIZE:
            images = [
                cache.source(i) if corpus.has_image[i] else None
                for i in range(n)
            ]
        elif corpus.images is None:
            images = [None] * n
        else:
            images = [
                corpus.images[i] if corpus.has_image[i] else None
                for i in range(n)
            ]
        m = ProgressMeter(n, "noise", enabled=progress)
        corpus.signals[:, COL["noise"]] = self.noise.batch_compute(
            texts=texts, images=images, present=present, progress=m.update,
        )
        m.close()
        ckpt.save("noise", scores=corpus.signals[:, COL["noise"]])
        return corpus

    def process_corpus(self, corpus: Any, weights: Any = None,
                       delta: Optional[float] = None,
                       mode: Optional[str] = None,
                       progress: bool = False,
                       _ckpt: _StageCheckpoint = _NO_CHECKPOINT) -> Any:
        """Signals + fused fit-and-score, columnar end to end (``_ckpt``:
        see :meth:`compute_signals_corpus`)."""
        with span("dewi.process_corpus"):
            self.compute_signals_corpus(corpus, progress=progress, _ckpt=_ckpt)
            return self._score_corpus(corpus, weights, delta, mode)

    def _score_corpus(self, corpus: Any, weights: Any, delta: Optional[float],
                      mode: Optional[str]) -> Any:
        """One fused fit+score over ``corpus.signals`` into ``corpus.dewi``."""
        with span("dewi.score"):
            scorer = self._make_scorer(weights, delta)
            corpus.dewi = scorer.fit_and_score(
                corpus.signals, mode=mode or self.config.scoring.mode
            ).cpu().numpy().astype(np.float32)
        self._scorer = scorer
        return corpus

    @staticmethod
    def _corpus_shard_digest(corpus: Any, a: int, b: int) -> str:
        """Content digest of shard rows — per-shard resume must recompute
        when the slice changed (same contract as ``_StageCheckpoint``:
        text CONTENT not length, image identity via path or a strided
        pixel sample, external embedding bytes, delimited fields so
        id/text boundaries can't alias across rows)."""
        import hashlib
        import os

        h = hashlib.sha256()
        texts = corpus.texts
        emb = corpus.embeddings
        ext_mask = getattr(corpus, "ext_embedding_mask", None)
        pack_path = getattr(corpus.images, "path", None)
        if pack_path is not None:
            # PackedImages: the pack file IS the image identity — hash its
            # path/size/mtime plus the row range ONCE instead of sampling
            # pixels per row (which would fault in the whole mmap).
            h.update(f"pack:{pack_path}:{a}:{b}".encode())
            try:
                st = os.stat(pack_path)
                h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())
            except OSError:
                pass
        for i in range(a, b):
            h.update(str(corpus.ids[i]).encode())
            h.update(b"\0")
            t = texts[i] if texts is not None else None
            h.update((t or "").encode("utf-8", "replace"))
            h.update(b"\0")
            if corpus.has_image[i] and pack_path is None:
                src = corpus.images[i]
                if isinstance(src, (str, Path)):
                    h.update(str(src).encode())
                    try:
                        st = os.stat(src)
                        h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())
                    except OSError:
                        pass
                else:
                    arr = np.ascontiguousarray(src)
                    h.update(str((arr.shape, str(arr.dtype))).encode())
                    flat = arr.reshape(-1).view(np.uint8)
                    h.update(flat[:: max(1, flat.size // 256)].tobytes())
            h.update(b"\0")
            if emb is not None and (ext_mask is None or ext_mask[i]):
                h.update(np.ascontiguousarray(emb[i]).tobytes())
            h.update(b"\1")
        return h.hexdigest()[:32]

    def process_stream_corpus(self, corpus: Any,
                              shard_size: Optional[int] = None,
                              checkpoint_dir: Optional[PathLike] = None,
                              weights: Any = None,
                              delta: Optional[float] = None,
                              mode: Optional[str] = None,
                              progress: bool = False) -> Any:
        """Sharded columnar pipeline: per-shard signals (+resume), global
        redundancy, one fused global fit+score.

        The columnar analogue of :meth:`process_stream`: corpora larger
        than device memory or RAM stream in ``shard_size`` row ranges (each
        shard's device-resident image upload covers only its slice), completed
        shards resume from an ``.npz`` checkpoint keyed to a content
        digest, and the cross-document redundancy
        stage and the robust-stat fit run GLOBALLY so sharding never
        changes a single score.
        """
        n = len(corpus)
        if n == 0:
            return corpus
        shard_size = int(shard_size or self.config.runtime.shard_size)
        ckpt_root = Path(checkpoint_dir) if checkpoint_dir else None
        if ckpt_root:
            ckpt_root.mkdir(parents=True, exist_ok=True)
            stale = sorted(
                p.name for p in ckpt_root.glob("shard_*") if p.is_dir()
            )
            if stale:
                # The Document API's process_stream writes per-stage npz
                # files under shard_NNNNN/ directories; this columnar format
                # is one .npz per shard.  Be loud rather than silently
                # recomputing everything a user thought was checkpointed.
                logger.warning(
                    "%s holds %d Document-API shard directories (e.g. %s) "
                    "this columnar run cannot resume from; recomputing. "
                    "Use DewiPipeline.process_stream for the old format.",
                    ckpt_root, len(stale), stale[0],
                )
        n_shards = (n + shard_size - 1) // shard_size
        ext_mask = getattr(corpus, "ext_embedding_mask", None)
        # Original EXTERNAL embeddings (what shards may treat as supplied)
        # vs the accumulator shards fill — conflating them would hand
        # shard k>0 the zero placeholder rows as "external" vectors.
        orig_ext = corpus.embeddings
        emb_parent = (
            np.array(orig_ext, np.float32) if orig_ext is not None else None
        )
        filled_parent = np.zeros(n, bool)
        any_clip = False
        for s in range(n_shards):
            a, b = s * shard_size, min((s + 1) * shard_size, n)
            if progress:
                print(f"Shard {s + 1}/{n_shards} ({b - a} docs)")
            ck = ckpt_root / f"shard_{s:05d}.npz" if ckpt_root else None
            digest = (
                self._corpus_shard_digest(corpus, a, b) if ck else None
            )
            if ck is not None and ck.exists():
                try:
                    data = np.load(ck, allow_pickle=False)
                    if str(data["digest"]) == digest:
                        corpus.signals[a:b] = data["signals"]
                        if data["embeddings"].size:
                            if emb_parent is None:
                                emb_parent = np.zeros(
                                    (n, data["embeddings"].shape[1]),
                                    np.float32,
                                )
                            emb_parent[a:b] = data["embeddings"]
                        filled_parent[a:b] = data["clip_filled"]
                        any_clip = any_clip or bool(
                            data["clip_filled"].any()
                        )
                        continue
                    logger.warning(
                        "Shard %d checkpoint digest mismatch; recomputing.",
                        s,
                    )
                except Exception as e:  # noqa: BLE001 — corrupt ckpt
                    logger.warning(
                        "Shard %d checkpoint unreadable (%s); recomputing.",
                        s, e,
                    )
            from .corpus import Corpus

            sub = Corpus(
                ids=corpus.ids[a:b],
                texts=(
                    corpus.texts[a:b] if corpus.texts is not None else None
                ),
                # A row-range view of any images container: an ndarray view,
                # a list slice, or PackedImages (its __getitem__ slices the
                # mmap).  Never ``.data``: every ndarray has one.
                images=(None if corpus.images is None
                        else corpus.images[a:b]),
                embeddings=(
                    np.array(orig_ext[a:b], np.float32)
                    if orig_ext is not None else None
                ),
                signals=corpus.signals[a:b],  # view: stages write through
            )
            if ext_mask is not None and not bool(ext_mask[a:b].all()):
                sub.ext_embedding_mask = ext_mask[a:b]
            self.compute_signals_corpus(sub, progress=progress,
                                        include_redundancy=False)
            if sub.embeddings is not None:
                if emb_parent is None:
                    emb_parent = np.zeros(
                        (n, sub.embeddings.shape[1]), np.float32
                    )
                emb_parent[a:b] = sub.embeddings
            sub_filled = getattr(
                sub, "clip_filled_mask", np.zeros(b - a, bool)
            )
            filled_parent[a:b] = sub_filled
            any_clip = any_clip or bool(np.asarray(sub_filled).any())
            if ck is not None:
                def write(ck: Path = ck) -> None:
                    tmp = ck.with_suffix(".tmp.npz")
                    np.savez(
                        tmp, digest=digest, signals=corpus.signals[a:b],
                        embeddings=(
                            sub.embeddings if sub.embeddings is not None
                            else np.zeros((0, 0), np.float32)
                        ),
                        clip_filled=np.asarray(sub_filled, bool),
                    )
                    tmp.replace(ck)

                _on_rank0(self.mesh, write)
        corpus.embeddings = emb_parent
        corpus.clip_filled_mask = filled_parent
        corpus.clip_embedded = bool(
            any_clip and (ext_mask is None or not ext_mask.any())
            and (emb_parent is None or filled_parent.all())
        )
        # Cross-document stage LAST and GLOBAL (identical to the
        # monolithic path — shard boundaries must not hide duplicates).
        with span("dewi.redundancy"):
            self._redundancy_corpus(corpus)
        return self._score_corpus(corpus, weights, delta, mode)

    def build_index_corpus(self, corpus: Any,
                           **index_kwargs: Any) -> Any:
        """``Corpus`` -> built :class:`DewiIndex`: two array ops, no per-doc
        Python.  Under a mesh: rank 0's index, ``None`` on the other ranks."""
        if len(corpus) == 0:
            raise ValueError("No documents to index")
        with span("dewi.build_index_corpus"):
            self.ensure_embeddings_corpus(corpus)
            return _on_rank0(self.mesh, lambda: self._index_corpus(corpus, **index_kwargs))

    def _index_corpus(self, corpus: Any, **index_kwargs: Any) -> Any:
        with span("dewi.index.build"):
            index = self._make_index(dim=int(corpus.embeddings.shape[1]),
                                     **index_kwargs)
            filled = getattr(corpus, "clip_filled_mask", None)
            if getattr(corpus, "clip_embedded", False):
                index.encoder = {"source": "cross_modal",
                                 **self.encoder_provenance()}
            elif filled is not None and bool(filled.any()):
                # Some rows external, some CLIP-filled.
                index.encoder = {"source": "mixed", **self.encoder_provenance()}
            else:
                index.encoder = {"source": "external"}
            index.add_batch(list(corpus.ids),
                            np.asarray(corpus.embeddings, np.float32),
                            corpus.payload_matrix())
            index.build()
            return index

    # -- index handoff ------------------------------------------------------------

    def _make_index(self, dim: int, **index_kwargs: Any) -> Any:
        """Config-driven :class:`DewiIndex` construction (backend knobs,
        bf16 storage)."""
        from .index import DewiIndex
        from .index.facade import IndexBackend

        cfg = self.config.index
        kwargs = dict(
            space=cfg.metric,
            backend=cfg.ann,
            ef=cfg.ef_construction,
            M=cfg.M,
            ef_query=cfg.ef_query,
            rerank_eta=cfg.rerank_eta,
            entropy_pref=cfg.entropy_pref,
        )
        try:
            resolved = IndexBackend.from_str(str(cfg.ann)).resolve().__name__
        except ValueError:
            resolved = "ExactIndex"
        if resolved == "ExactIndex":
            kwargs.update(blockmax_select=cfg.blockmax_select)
        elif resolved == "IVFIndex":
            # probe_dtype "auto" resolves inside IVFIndex.build from the
            # store's embedding dtype (bf16 store -> bf16 buckets).
            kwargs.update(nlist=cfg.nlist, nprobe=cfg.nprobe,
                          dewi_tier=cfg.dewi_tier,
                          probe_dtype=cfg.probe_dtype,
                          probe_impl=cfg.probe_impl,
                          spill_frac=cfg.spill_frac)
        elif resolved == "QuantizedIndex":
            kwargs.update(refine_factor=cfg.refine_factor,
                          int8_queries=cfg.int8_queries,
                          bf16_scores=cfg.bf16_scores,
                          blockmax_select=cfg.blockmax_select,
                          int4_storage=(cfg.int4_storage
                                        or cfg.ann.lower() == "int4"))
        if self.config.mesh.dtype == "bfloat16":
            kwargs["dtype"] = torch.bfloat16  # half the index's bytes
        kwargs.update(index_kwargs)
        kwargs.setdefault("device", self.device)
        return DewiIndex(dim=dim, **kwargs)


__all__ = ["Document", "DewiPipeline", "create_document"]
