"""Struct-of-arrays document store with power-of-two capacity growth.

Counterpart of ``dewi_tpu/index/store.py``.  A host numpy mirror holds the
raw rows; ``device_arrays()`` gives the cached device tensors

* ``embeddings [cap, D]`` -- L2-normalized on the device when cosine, then
  cast to ``dtype`` (float32 or bfloat16),
* ``sqnorms    [cap]``    -- row squared norms of the cast rows (L2 path),
* ``payloads   [cap, 8]`` -- PAYLOAD_FIELDS columns (dewi first),

and the live count ``n_valid``.  Rows >= ``n_valid`` are capacity slack and
are masked by every search.  ``get_payload`` hands out live ``Payload``
objects whose in-place edits are written back at the next device sync.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.similarity import l2_normalize
from ..types import PAYLOAD_FIELDS, Payload, payloads_to_matrix
from ..utils.device import DeviceLike, resolve_device

MIN_CAPACITY = 1024
DeviceArrays = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]


def _next_capacity(n: int) -> int:
    cap = MIN_CAPACITY
    while cap < n:
        cap *= 2
    return cap


class DocStore:
    """Growable SoA store for (doc_id, embedding, payload) triples."""

    def __init__(self, dim: int, space: str = "cosine",
                 capacity: int = MIN_CAPACITY,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None) -> None:
        if space not in ("cosine", "l2"):
            raise ValueError(f"space must be 'cosine' or 'l2', got {space!r}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        self.dim = int(dim)
        self.space = space
        self.normalize = space == "cosine"
        self.dtype = dtype
        self.device = resolve_device(device)
        cap = _next_capacity(capacity)
        self._emb = np.zeros((cap, self.dim), dtype=np.float32)
        self._pay = np.zeros((cap, len(PAYLOAD_FIELDS)), dtype=np.float32)
        self._ids: List[str] = []
        self._id_to_idx: Dict[str, int] = {}
        self._live: Dict[int, Payload] = {}
        self._dirty = True
        self._device: Optional[DeviceArrays] = None

    # ---- introspection ---------------------------------------------------

    def __len__(self) -> int:
        return len(self._ids)

    @property
    def capacity(self) -> int:
        return self._emb.shape[0]

    @property
    def doc_ids(self) -> List[str]:
        return self._ids

    # ---- mutation ----------------------------------------------------------

    def _ensure_capacity(self, n: int) -> None:
        if n <= self.capacity:
            return
        cap = _next_capacity(n)
        emb = np.zeros((cap, self.dim), dtype=np.float32)
        pay = np.zeros((cap, len(PAYLOAD_FIELDS)), dtype=np.float32)
        emb[: len(self)] = self._emb[: len(self)]
        pay[: len(self)] = self._pay[: len(self)]
        self._emb, self._pay = emb, pay
        self._dirty = True

    def add(self, doc_id: str, embedding: np.ndarray, payload: Payload) -> None:
        emb = np.asarray(embedding, dtype=np.float32)
        if emb.shape != (self.dim,):
            raise ValueError(f"Expected embedding of shape {(self.dim,)}, got {emb.shape}")
        idx = len(self)
        self._ensure_capacity(idx + 1)
        self._emb[idx] = emb
        self._pay[idx] = payload.to_array()
        self._ids.append(doc_id)
        self._id_to_idx[doc_id] = idx
        self._dirty = True

    def add_batch(self, doc_ids: Sequence[str], embeddings: np.ndarray,
                  payloads: Union[np.ndarray, Sequence[Payload]]) -> None:
        """Bulk ingest: one copy, no per-document Python."""
        emb = np.asarray(embeddings, dtype=np.float32)
        if emb.ndim != 2 or emb.shape[1] != self.dim:
            raise ValueError(f"Expected [N, {self.dim}] embeddings, got {emb.shape}")
        if not isinstance(payloads, np.ndarray):
            payloads = payloads_to_matrix(list(payloads))
        pay = np.asarray(payloads, dtype=np.float32)
        n_new = emb.shape[0]
        if len(doc_ids) != n_new or pay.shape != (n_new, len(PAYLOAD_FIELDS)):
            raise ValueError("doc_ids / embeddings / payloads length mismatch")
        start = len(self)
        self._ensure_capacity(start + n_new)
        self._emb[start: start + n_new] = emb
        self._pay[start: start + n_new] = pay
        for i, d in enumerate(doc_ids):
            self._id_to_idx[str(d)] = start + i
        self._ids.extend(str(d) for d in doc_ids)
        self._dirty = True

    def set_payload(self, doc_id: str, payload: Payload) -> None:
        idx = self._id_to_idx[doc_id]
        self._pay[idx] = payload.to_array()
        self._live.pop(idx, None)
        self._dirty = True

    def set_payload_matrix(self, matrix: np.ndarray) -> None:
        """Overwrite all live payload rows at once (bulk re-score path)."""
        mat = np.asarray(matrix, dtype=np.float32)
        if mat.shape != (len(self), len(PAYLOAD_FIELDS)):
            raise ValueError(
                f"Expected [{len(self)}, {len(PAYLOAD_FIELDS)}] payloads, got {mat.shape}")
        self._pay[: len(self)] = mat
        self._live.clear()
        self._dirty = True

    def set_dewi_scores(self, scores: Union[np.ndarray, torch.Tensor]) -> None:
        """Write DEWI scores into payload column 0."""
        if isinstance(scores, torch.Tensor):
            scores = scores.detach().cpu().numpy()
        scores = np.asarray(scores, dtype=np.float32).reshape(-1)
        if scores.shape[0] != len(self):
            raise ValueError("scores length != number of documents")
        self._pay[: len(self), 0] = scores
        for idx, p in self._live.items():
            p.dewi = float(scores[idx])
        self._dirty = True

    # ---- reads -------------------------------------------------------------

    def get_payload(self, doc_id: str) -> Optional[Payload]:
        idx = self._id_to_idx.get(doc_id)
        if idx is None:
            return None
        if idx not in self._live:
            self._live[idx] = Payload.from_array(self._pay[idx])
        return self._live[idx]

    def get_embedding(self, doc_id: str) -> Optional[np.ndarray]:
        idx = self._id_to_idx.get(doc_id)
        return None if idx is None else self._emb[idx].copy()

    def payload_matrix(self) -> np.ndarray:
        self._flush_live()
        return self._pay[: len(self)]

    def embedding_matrix(self) -> np.ndarray:
        return self._emb[: len(self)]

    # ---- device sync ---------------------------------------------------------

    def _flush_live(self) -> None:
        """Write back handed-out Payload objects the user may have mutated."""
        for idx, p in self._live.items():
            row = p.to_array()
            if not np.array_equal(row, self._pay[idx]):
                self._pay[idx] = row
                self._dirty = True

    def device_arrays(self) -> DeviceArrays:
        """(embeddings, sqnorms, payloads, n_valid), cached until mutated.

        Rows are normalized on the device (cosine), cast to ``dtype``, and
        the squared norms are taken from the cast rows.
        """
        self._flush_live()
        if self._device is not None and not self._dirty:
            return self._device
        emb = torch.from_numpy(self._emb).to(self.device, copy=True)
        if self.normalize:
            emb = l2_normalize(emb)
        emb = emb.to(self.dtype).contiguous()
        sqn = torch.sum(torch.square(emb.to(torch.float32)), dim=-1)
        pay = torch.from_numpy(self._pay).to(self.device, copy=True)
        self._device = (emb, sqn, pay, len(self))
        self._dirty = False
        return self._device

    def set_device_arrays(self, arrays: DeviceArrays) -> None:
        """Adopt already-prepared device arrays (state carried across from
        another index); the host mirror must already hold the same rows."""
        emb, sqn, pay, n = arrays
        if emb.shape != (self.capacity, self.dim) or n != len(self):
            raise ValueError("device arrays do not match the store's shape")
        self._device = (emb.to(self.device, self.dtype).contiguous(),
                        sqn.to(self.device, torch.float32).contiguous(),
                        pay.to(self.device, torch.float32).contiguous(), int(n))
        self._dirty = False


__all__ = ["DocStore", "MIN_CAPACITY"]
