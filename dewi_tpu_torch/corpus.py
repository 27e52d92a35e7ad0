"""Columnar corpus: the array-native path through the pipeline.

The port's own copy of ``dewi_tpu/corpus.py`` (numpy only).  Moving
per-``Document`` Python objects between stages costs attribute traffic,
dict comprehensions and ``np.stack`` of per-doc arrays at every stage;
:class:`Corpus` stores
the whole corpus as columns — ``ids`` (list), ``texts`` (list),
``images`` (one 4-D uint8 array / packed mmap / per-doc source list),
``embeddings`` ``[N, D]``, ``signals`` ``[N, 7]`` (``SIGNAL_FIELDS``
order), ``dewi`` ``[N]`` — so every stage reads and writes array slices and
the index handoff is two ``np`` ops, no per-doc Python anywhere.

``Document`` stays as a veneer: :meth:`Corpus.from_documents` /
:meth:`Corpus.to_documents` / :meth:`Corpus.apply_to_documents` convert at
the boundary, and ``DewiPipeline``'s ``Document`` API runs its Documents
through the columnar stages with them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence

import numpy as np

from .types import SIGNAL_FIELDS

# Column indices into Corpus.signals (== SIGNAL_FIELDS order).
COL = {name: i for i, name in enumerate(SIGNAL_FIELDS)}


def _image_at(images: Any, i: int) -> Any:
    """Per-doc image source from any supported ``images`` container."""
    if images is None:
        return None
    return images[i]


@dataclass
class Corpus:
    """Column store for one corpus; arrays allocated once, stages fill slices.

    ``images`` accepts ``None``, a ``[N, S, S, 3]`` uint8 array (incl.
    :class:`~dewi_tpu_torch.io.packed.PackedImages` or its mmap), or a per-doc
    list of path/PIL/array/None sources.  ``has_text`` / ``has_image``
    record modality presence so :meth:`to_documents` restores ``None``
    (not-computed) semantics on the veneer.
    """

    ids: List[str]
    texts: Optional[List[Optional[str]]] = None
    images: Any = None
    embeddings: Optional[np.ndarray] = None
    signals: np.ndarray = field(default=None)  # type: ignore[assignment]
    dewi: Optional[np.ndarray] = None

    def __post_init__(self) -> None:
        n = len(self.ids)
        if self.signals is None:
            self.signals = np.zeros((n, len(SIGNAL_FIELDS)), np.float32)
        if self.signals.shape != (n, len(SIGNAL_FIELDS)):
            raise ValueError(
                f"signals must be [{n}, {len(SIGNAL_FIELDS)}], got "
                f"{self.signals.shape}"
            )
        if self.texts is not None and len(self.texts) != n:
            raise ValueError(f"texts has {len(self.texts)} rows, ids {n}")
        if self.embeddings is not None and len(self.embeddings) != n:
            raise ValueError(
                f"embeddings has {len(self.embeddings)} rows, ids {n}"
            )
        if self.images is not None and len(self.images) != n:
            raise ValueError(f"images has {len(self.images)} rows, ids {n}")
        self.has_text = np.array(
            [bool(t) for t in self.texts] if self.texts is not None
            else [False] * n
        )
        if self.images is None:
            self.has_image = np.zeros(n, bool)
        elif isinstance(self.images, np.ndarray) or hasattr(
            self.images, "base_size"
        ):
            self.has_image = np.ones(n, bool)  # dense array/packed corpus
        else:
            self.has_image = np.array(
                [_image_at(self.images, i) is not None for i in range(n)]
            )
        # bool[N] marking which ``embeddings`` rows were supplied externally;
        # None == all of them (when ``embeddings`` is set).  Rows outside the
        # mask are placeholders the pipeline's ensure_embeddings_corpus fills.
        self.ext_embedding_mask: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.ids)

    # -- signal column views --------------------------------------------------

    def col(self, name: str) -> np.ndarray:
        return self.signals[:, COL[name]]

    def payload_matrix(self) -> np.ndarray:
        """``[N, 8]`` ``PAYLOAD_FIELDS``-ordered matrix (dewi ‖ signals) —
        the vectorized equivalent of per-doc ``payload().to_array()``."""
        dewi = (
            self.dewi if self.dewi is not None
            else np.zeros(len(self), np.float32)
        )
        return np.concatenate(
            [np.asarray(dewi, np.float32)[:, None], self.signals], axis=1
        )

    # -- Document veneer -------------------------------------------------------

    @classmethod
    def from_documents(cls, documents: Sequence) -> "Corpus":
        """Columnarize a ``Document`` list (signals carried over if set)."""
        n = len(documents)
        sig = np.zeros((n, len(SIGNAL_FIELDS)), np.float32)
        for j, name in enumerate(SIGNAL_FIELDS):
            sig[:, j] = [
                float(v) if (v := getattr(d, name)) is not None else 0.0
                for d in documents
            ]
        dewi = None
        if any(d.dewi_score is not None for d in documents):
            dewi = np.array(
                [float(d.dewi_score or 0.0) for d in documents], np.float32
            )
        # External embeddings may be partial (e.g. the CLI's --embeddings
        # file alongside --texts): carry the supplied rows plus a mask so
        # ensure_embeddings_corpus fills ONLY the missing ones instead of
        # silently discarding and re-zeroing user vectors.
        emb = None
        ext_mask = np.array([d.embedding is not None for d in documents],
                            bool)
        if ext_mask.any() and n:
            dims = {
                len(d.embedding) for d in documents
                if d.embedding is not None
            }
            if len(dims) != 1:
                # Silently dropping user vectors here would re-encode the
                # whole corpus in a different embedding space than the
                # user's queries — fail loudly instead (an index could not
                # hold mixed dims either).
                raise ValueError(
                    "Documents carry external embeddings of mixed "
                    f"dimensions {sorted(dims)}; supply one dimension."
                )
            emb = np.zeros((n, dims.pop()), np.float32)
            for i, d in enumerate(documents):
                if d.embedding is not None:
                    emb[i] = np.asarray(d.embedding, np.float32)
        images: Any = [d.image_source() for d in documents]
        if not any(s is not None for s in images):
            images = None
        corpus = cls(
            ids=[d.doc_id for d in documents],
            texts=[d.text for d in documents],
            images=images,
            embeddings=emb,
            signals=sig,
            dewi=dewi,
        )
        if emb is not None and not ext_mask.all():
            corpus.ext_embedding_mask = ext_mask
        return corpus

    def to_documents(self) -> List:
        """Materialize the ``Document`` view (None where a modality was
        absent: that signal was not computed)."""
        from .pipelines import Document

        docs = [
            Document(
                doc_id=doc_id,
                text=self.texts[i] if self.texts is not None else None,
                image=(
                    np.asarray(_image_at(self.images, i))
                    if self.has_image[i] else None
                ),
            )
            for i, doc_id in enumerate(self.ids)
        ]
        return self.apply_to_documents(docs)

    def apply_to_documents(self, documents: Sequence) -> List:
        """Write computed columns back into existing ``Document`` objects.

        Preserves every attribute the column store doesn't carry (loose
        ``metadata``, original ``image_path`` sources) — the CLI runs the
        columnar path and re-attaches results to its loaded documents for
        artifact serialization.
        """
        if len(documents) != len(self):
            raise ValueError(
                f"{len(documents)} documents vs corpus of {len(self)}"
            )
        mask = self.ext_embedding_mask
        filled = getattr(self, "clip_filled_mask", None)
        for i, d in enumerate(documents):
            # Write a row back only if it was supplied externally or filled
            # by the CLIP towers — never a zero placeholder row.
            if self.embeddings is not None and (
                mask is None or mask[i]
                or (filled is not None and filled[i])
            ):
                d.embedding = self.embeddings[i]
            if self.has_text[i]:
                d.ht_mean = float(self.signals[i, COL["ht_mean"]])
                d.ht_q90 = float(self.signals[i, COL["ht_q90"]])
            if self.has_image[i]:
                d.hi_mean = float(self.signals[i, COL["hi_mean"]])
                d.hi_q90 = float(self.signals[i, COL["hi_q90"]])
            if self.has_text[i] and self.has_image[i]:
                d.I_hat = float(self.signals[i, COL["I_hat"]])
            d.redundancy = float(self.signals[i, COL["redundancy"]])
            d.noise = float(self.signals[i, COL["noise"]])
            if self.dewi is not None:
                d.dewi_score = float(self.dewi[i])
        return list(documents)


__all__ = ["COL", "Corpus"]
