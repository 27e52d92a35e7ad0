"""DewiIndex: the public index facade.

Counterpart of ``dewi_tpu/index/facade.py``, with the same constructor,
``add/add_batch/build/set_dewi_scores/search/search_batch/save/load`` and
the same ``config.json``/``meta.json`` layout.  Backend names:

* ``exact`` / ``bruteforce`` / ``auto`` / ``hnsw`` / ``faiss_hnsw`` -> ExactIndex
* ``quantized`` / ``int8`` / ``scann`` -> QuantizedIndex
* ``int4`` -> QuantizedIndex(int4_storage=True)
* ``ivf`` / ``faiss_ivfflat`` -> IVFIndex (k-means + probed buckets)

``device=None`` runs on the card and raises without one; pass
``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

import json
import logging
from enum import Enum
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..types import Payload
from ..utils.device import DeviceLike
from ..utils.profiling import span
from .base import BaseIndex
from .exact import ExactIndex
from .ivf import IVFIndex
from .quantized import QuantizedIndex

logger = logging.getLogger(__name__)

PathLike = Union[str, Path]


class IndexBackend(Enum):
    EXACT = "exact"
    IVF = "ivf"
    QUANTIZED = "quantized"
    HNSW = "hnsw"
    FAISS_IVFFLAT = "faiss_ivfflat"
    FAISS_HNSW = "faiss_hnsw"

    @classmethod
    def from_str(cls, name: str) -> "IndexBackend":
        name = name.lower()
        if name in ("auto", "bruteforce"):
            return cls.EXACT
        if name in ("int8", "scann", "int4"):
            return cls.QUANTIZED
        return cls(name)

    def resolve(self) -> type:
        if self in (IndexBackend.IVF, IndexBackend.FAISS_IVFFLAT):
            return IVFIndex
        if self is IndexBackend.QUANTIZED:
            return QuantizedIndex
        return ExactIndex


class DewiIndex:
    """Entropy-weighted index with DEWI re-ranked search.

    ``ef``/``M`` are accepted for API compatibility and inert."""

    def __init__(self, dim: int, space: str = "cosine",
                 backend: Union[str, IndexBackend] = "auto", ef: int = 200,
                 M: int = 32, use_ann: bool = True, ef_query: int = 200,
                 rerank_eta: float = 0.25, entropy_pref: float = 0.0,
                 device: DeviceLike = None, **kwargs: Any) -> None:
        self.dim = int(dim)
        self.space = space
        self._meta: Dict[str, Dict[str, Any]] = {}
        self.ef_query = ef_query
        self.rerank_eta = float(rerank_eta)
        self.entropy_pref = float(entropy_pref)
        self.encoder: Optional[Dict[str, Any]] = None
        self._built = False
        self._use_ann = bool(use_ann)

        if isinstance(backend, str):
            if backend.lower() == "int4":
                kwargs.setdefault("int4_storage", True)
            try:
                backend = IndexBackend.from_str(backend)
            except ValueError:
                logger.warning("Unknown backend %r; using ExactIndex.", backend)
                backend = IndexBackend.EXACT
        cls = backend.resolve() if self._use_ann else ExactIndex
        self._backend: BaseIndex = cls(dim, space, device=device, **kwargs)

    @property
    def device(self) -> torch.device:
        return self._backend.device

    # -- ingest --------------------------------------------------------------

    def add(self, doc_id: str, embedding: np.ndarray, payload: Payload,
            meta: Optional[Dict[str, Any]] = None) -> None:
        if meta is not None:
            self._meta[doc_id] = meta
        self._backend.add(doc_id, np.asarray(embedding, dtype=np.float32), payload)
        self._built = False

    def add_batch(self, doc_ids: Sequence[str], embeddings: np.ndarray,
                  payloads: np.ndarray) -> None:
        self._backend.add_batch(doc_ids, embeddings, payloads)
        self._built = False

    def build(self) -> None:
        self._backend.build()
        self._built = True

    def set_dewi_scores(self, scores: Union[np.ndarray, torch.Tensor]) -> None:
        """Write DEWI scores into every payload (column 0) in one call."""
        self._backend.store.set_dewi_scores(scores)
        self._built = False

    # -- search ----------------------------------------------------------------

    def search(self, query: np.ndarray, k: int = 10, eta: Optional[float] = None,
               entropy_pref: Optional[float] = None) -> List[Tuple[str, float, Payload]]:
        if not self._built:
            self.build()
        eta = self.rerank_eta if eta is None else eta
        entropy_pref = self.entropy_pref if entropy_pref is None else entropy_pref
        q = np.asarray(query, dtype=np.float32)
        if q.shape != (self.dim,):
            raise ValueError(f"Expected query shape ({self.dim},), got {q.shape}")
        return self._backend.search(q, k, eta, entropy_pref)

    def search_batch(self, queries: Any, k: int = 10, eta: Optional[float] = None,
                     entropy_pref: Optional[float] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[Q, D]`` -> ([Q, k] scores, [Q, k] row indices) on the device
        (the span ``dewi.search_batch`` while a profiler records)."""
        with span("dewi.search_batch"):
            if not self._built:
                self.build()
            eta = self.rerank_eta if eta is None else eta
            entropy_pref = self.entropy_pref if entropy_pref is None else entropy_pref
            return self._backend.search_batch(queries, k, eta, entropy_pref)

    # -- accessors ----------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._backend)

    @property
    def doc_ids(self) -> List[str]:
        return self._backend.store.doc_ids

    def get_payload(self, doc_id: str) -> Optional[Payload]:
        return self._backend.get_payload(doc_id)

    def get_embedding(self, doc_id: str) -> Optional[np.ndarray]:
        return self._backend.store.get_embedding(doc_id)

    def get_metadata(self, doc_id: str) -> Optional[Dict[str, Any]]:
        return self._meta.get(doc_id)

    # -- persistence ----------------------------------------------------------------

    def save(self, path: PathLike, write_jsonl: bool = True) -> None:
        p = Path(path)
        p.mkdir(parents=True, exist_ok=True)
        self._backend.save(p / "ann_index", write_jsonl=write_jsonl)
        with open(p / "config.json", "w", encoding="utf-8") as f:
            json.dump({
                "dim": self.dim,
                "space": self.space,
                "use_ann": self._use_ann,
                "ef_query": self.ef_query,
                "rerank_eta": self.rerank_eta,
                "entropy_pref": self.entropy_pref,
                "built": self._built,
                "backend_type": self._backend.__class__.__name__,
                "encoder": self.encoder,
            }, f)
        if self._meta:
            with open(p / "meta.json", "w", encoding="utf-8") as f:
                json.dump(self._meta, f)

    @classmethod
    def load(cls, path: PathLike, device: DeviceLike = None) -> "DewiIndex":
        p = Path(path)
        with open(p / "config.json", "r", encoding="utf-8") as f:
            cfg = json.load(f)
        from . import BACKEND_CLASSES

        backend_type = cfg.get("backend_type", "ExactIndex")
        ann_cls = BACKEND_CLASSES.get(backend_type, ExactIndex)
        ann = ann_cls.load(p / "ann_index", device=device)
        inst = cls(dim=cfg["dim"], space=cfg["space"], backend="exact",
                   use_ann=cfg.get("use_ann", True),
                   ef_query=cfg.get("ef_query", 200),
                   rerank_eta=cfg.get("rerank_eta", 0.25),
                   entropy_pref=cfg.get("entropy_pref", 0.0), device=device)
        inst._backend = ann
        inst._built = bool(cfg.get("built", False))
        inst.encoder = cfg.get("encoder")
        meta_path = p / "meta.json"
        if meta_path.exists():
            with open(meta_path, "r", encoding="utf-8") as f:
                inst._meta = json.load(f)
        return inst


__all__ = ["DewiIndex", "IndexBackend"]
