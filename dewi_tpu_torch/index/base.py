"""Abstract index interface + shared persistence.

Counterpart of ``dewi_tpu/index/base.py``, with the same disk layout so an
index saved by either package loads in the other: ``metadata.json``
(dim/space/doc_ids/is_trained/type/hyperparams), ``payloads.npy``,
``payloads.jsonl`` (one ``{"doc_id": ..., "payload": {...}}`` line per doc;
``"id"`` is accepted on read) and ``embeddings.npy``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..types import PAYLOAD_FIELDS, Payload
from ..utils.device import DeviceLike
from .store import DocStore

PathLike = Union[str, Path]


def write_payloads_jsonl(path: PathLike, doc_ids: Sequence[str],
                         matrix: np.ndarray) -> None:
    """Write ``{"doc_id": ..., "payload": {...}}`` lines."""
    matrix = np.asarray(matrix, dtype=np.float32)
    with open(path, "w", encoding="utf-8") as f:
        for doc_id, row in zip(doc_ids, matrix):
            f.write(json.dumps({"doc_id": doc_id,
                                "payload": Payload.from_array(row).to_dict()}) + "\n")


def read_payloads_jsonl(path: PathLike) -> Tuple[List[str], np.ndarray]:
    """Read back (doc_ids, [N, 8] matrix); tolerant of missing/extra keys."""
    ids: List[str] = []
    rows: List[np.ndarray] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            ids.append(str(d.get("doc_id", d.get("id", ""))))
            rows.append(Payload.from_dict(d.get("payload", {})).to_array())
    mat = np.stack(rows) if rows else np.zeros((0, len(PAYLOAD_FIELDS)), np.float32)
    return ids, mat


class BaseIndex:
    """Base class of the port's index backends."""

    def __init__(self, dim: int, space: str = "cosine",
                 device: DeviceLike = None, **kwargs: Any) -> None:
        self.dim = int(dim)
        self.space = space
        store_kw = {k: v for k, v in kwargs.items() if k in ("capacity", "dtype")}
        self.store = DocStore(dim, space, device=device, **store_kw)
        self._is_trained = False

    @property
    def device(self) -> Any:
        return self.store.device

    def __len__(self) -> int:
        return len(self.store)

    def add(self, doc_id: str, embedding: np.ndarray, payload: Payload) -> None:
        self.store.add(doc_id, embedding, payload)

    def add_batch(self, doc_ids: Sequence[str], embeddings: np.ndarray,
                  payloads: np.ndarray) -> None:
        self.store.add_batch(doc_ids, embeddings, payloads)

    def build(self, **kwargs: Any) -> None:
        raise NotImplementedError

    def search_batch(self, queries: Any, k: int = 10, eta: float = 0.5,
                     entropy_pref: float = 0.0) -> Any:
        raise NotImplementedError

    def search(self, query: np.ndarray, k: int = 10, eta: float = 0.5,
               entropy_pref: float = 0.0) -> List[Tuple[str, float, Payload]]:
        """Single-query search: (doc_id, adjusted_score, Payload), at most
        ``len(self)`` results."""
        if len(self.store) == 0:
            return []
        scores, idx = self.search_batch(query, k=k, eta=eta, entropy_pref=entropy_pref)
        scores = scores[0].cpu().numpy()
        idx = idx[0].cpu().numpy()
        pay = self.store.payload_matrix()
        results = []
        for rank in range(min(int(k), len(self.store))):
            i = int(idx[rank])
            results.append((self.store.doc_ids[i], float(scores[rank]),
                            Payload.from_array(pay[i])))
        return results

    def get_payload(self, doc_id: str) -> Optional[Payload]:
        return self.store.get_payload(doc_id)

    def _hyperparams(self) -> dict:
        """Constructor kwargs persisted across save/load."""
        return {}

    # -- persistence ---------------------------------------------------------

    def save(self, path: PathLike, write_jsonl: bool = True) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        metadata = {
            "dim": self.dim,
            "space": self.space,
            "doc_ids": self.store.doc_ids,
            "normalize": self.store.normalize,
            "is_trained": self._is_trained,
            "num_embeddings": len(self.store),
            "type": self.__class__.__name__,
            "hyperparams": self._hyperparams(),
        }
        with open(path / "metadata.json", "w") as f:
            json.dump(metadata, f)
        pay = self.store.payload_matrix()
        np.save(path / "payloads.npy", pay)
        if write_jsonl:
            write_payloads_jsonl(path / "payloads.jsonl", self.store.doc_ids, pay)
        if len(self.store):
            np.save(path / "embeddings.npy", self.store.embedding_matrix())

    @classmethod
    def load(cls, path: PathLike, device: DeviceLike = None,
             **kwargs: Any) -> "BaseIndex":
        path = Path(path)
        with open(path / "metadata.json") as f:
            metadata = json.load(f)
        from . import BACKEND_CLASSES

        index_cls = BACKEND_CLASSES.get(metadata.get("type", ""), cls)
        if index_cls is BaseIndex:
            index_cls = BACKEND_CLASSES["ExactIndex"]
        # Saved hyperparameters are restored unless the caller overrides
        # them: an IVF index built with nlist=1024/nprobe=32 reloads so.
        hyper = dict(metadata.get("hyperparams", {}))
        # The JAX package's approximate flat select has no counterpart (the
        # port's is always exact); a save by the port omits it, so the JAX
        # package loads its own default.
        hyper.pop("approx_select", None)
        hyper.update(kwargs)
        index = index_cls(dim=metadata["dim"], space=metadata["space"],
                          device=device, **hyper)
        doc_ids = metadata["doc_ids"]
        emb_path = path / "embeddings.npy"
        pay_npy = path / "payloads.npy"
        if emb_path.exists() and doc_ids:
            emb = np.load(emb_path).astype(np.float32)
            if pay_npy.exists():
                pay = np.load(pay_npy).astype(np.float32)
            else:
                pay = _payloads_from_jsonl(path, doc_ids)
            index.add_batch(doc_ids, emb, pay)
        index._is_trained = bool(metadata.get("is_trained", False))
        if index._is_trained and len(index):
            index.build()
        return index


def _payloads_from_jsonl(path: Path, doc_ids: List[str]) -> np.ndarray:
    jsonl = path / "payloads.jsonl"
    by_id = {}
    if jsonl.exists():
        ids, mat = read_payloads_jsonl(jsonl)
        by_id = {i: row for i, row in zip(ids, mat)}
    blank = Payload().to_array()
    return np.stack([by_id.get(i, blank) for i in doc_ids])


__all__ = ["BaseIndex", "write_payloads_jsonl", "read_payloads_jsonl"]
