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

``attach_device`` takes a corpus that already lies on the device: it is
padded, normalized and cast there, the host mirror is fetched only when an
accessor or ``save`` needs it, and documents added meanwhile are buffered
and merged on the device.  The mirror then holds the device's rows, which
for a cosine store are the normalized ones.

With a data ``sharding`` (``parallel.data_sharding``), the device holds only
this rank's contiguous block of rows, ``[r*cap/n, (r+1)*cap/n)`` of the
capacity, and ``device_arrays()`` returns that block with the *global*
``n_valid``; the whole corpus is never put on one device.  A sharded store
that was attached on the device holds only its block: the host accessors
and buffered adds then raise.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

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
                 device: DeviceLike = None, sharding: Optional[Any] = None) -> None:
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
        self._host_stale = False
        # Adds that arrive while the store is device-resident wait here and
        # merge on the device at the next device_arrays(): pulling the
        # corpus to the host for every add would cost a corpus-sized copy.
        self._pending_emb: List[np.ndarray] = []
        self._pending_pay: List[np.ndarray] = []
        self._sharding = sharding
        self._device_cap = 0  # capacity of a corpus attached on the device

    @property
    def sharding(self) -> Optional[Any]:
        return self._sharding

    @sharding.setter
    def sharding(self, value: Optional[Any]) -> None:
        """A new placement drops the cached device arrays; they are placed
        under it at the next ``device_arrays()``."""
        if value is self._sharding:
            return
        if self._device is not None:
            self._sync_host()  # keeps a corpus attached on the device
            self._device = None
            self._dirty = True
        self._sharding = value

    def _shard_range(self, cap: int) -> Tuple[int, int]:
        """Rows ``[lo, hi)`` of the capacity that this rank's device holds."""
        if self._sharding is None:
            return 0, cap
        mesh = self._sharding.mesh
        if cap % mesh.n_data:
            raise ValueError(f"capacity {cap} does not divide over {mesh.n_data} data shards")
        per = cap // mesh.n_data
        return mesh.data_index * per, (mesh.data_index + 1) * per

    # ---- introspection ---------------------------------------------------

    def __len__(self) -> int:
        return len(self._ids)

    @property
    def capacity(self) -> int:
        if self._host_stale and self._device is not None:
            return self._device_cap
        return self._emb.shape[0]

    @property
    def doc_ids(self) -> List[str]:
        return self._ids

    def index_of(self, doc_id: str) -> Optional[int]:
        """The row of ``doc_id``, or None for an id the store does not hold."""
        return self._id_to_idx.get(doc_id)

    # ---- mutation ----------------------------------------------------------

    def _ensure_capacity(self, n: int) -> None:
        if n <= self.capacity:
            return
        cap = _next_capacity(n)
        emb = np.zeros((cap, self.dim), dtype=np.float32)
        pay = np.zeros((cap, len(PAYLOAD_FIELDS)), dtype=np.float32)
        # The mirror may hold fewer rows than len(self): after attach_device
        # and buffered adds, _sync_host grows it before the pending rows
        # are written.
        k = min(len(self), self._emb.shape[0])
        emb[:k] = self._emb[:k]
        pay[:k] = self._pay[:k]
        self._emb, self._pay = emb, pay
        self._dirty = True

    def add(self, doc_id: str, embedding: np.ndarray, payload: Payload) -> None:
        emb = np.asarray(embedding, dtype=np.float32)
        if emb.shape != (self.dim,):
            raise ValueError(f"Expected embedding of shape {(self.dim,)}, got {emb.shape}")
        idx = len(self)
        if self._host_stale:
            self._pending_emb.append(emb)
            self._pending_pay.append(np.asarray(payload.to_array(), np.float32))
            self._ids.append(doc_id)
            self._id_to_idx[doc_id] = idx
            return
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
        for i, d in enumerate(doc_ids):
            self._id_to_idx[str(d)] = start + i
        self._ids.extend(str(d) for d in doc_ids)
        if self._host_stale:
            self._pending_emb.extend(emb)
            self._pending_pay.extend(pay)
            return
        self._ensure_capacity(start + n_new)
        self._emb[start: start + n_new] = emb
        self._pay[start: start + n_new] = pay
        self._dirty = True

    def attach_device(self, doc_ids: Sequence[str], embeddings: Any,
                      payloads: Any) -> None:
        """Ingest a corpus that already lies on the store's device.

        ``embeddings [N, dim]`` and ``payloads [N, 8]`` are tensors on the
        store's device (a tensor on another device raises; a numpy array is
        copied over): they are padded to capacity, normalized and cast on
        the device, and nothing passes through host memory.  Replaces the
        store's contents, adds buffered since an earlier attachment
        included.  Under a data sharding only this rank's block of rows is
        copied (a numpy array is sliced before it is uploaded).
        """
        if not isinstance(embeddings, torch.Tensor):
            embeddings = np.asarray(embeddings, dtype=np.float32)
        if not isinstance(payloads, torch.Tensor):
            payloads = np.asarray(payloads, dtype=np.float32)
        if len(embeddings.shape) != 2 or embeddings.shape[1] != self.dim:
            raise ValueError(f"Expected [N, {self.dim}] embeddings, got {tuple(embeddings.shape)}")
        n = int(embeddings.shape[0])
        if len(doc_ids) != n or tuple(payloads.shape) != (n, len(PAYLOAD_FIELDS)):
            raise ValueError("doc_ids / embeddings / payloads length mismatch")
        cap = _next_capacity(n)
        lo, hi = self._shard_range(cap)
        m = max(0, min(hi, n) - lo)
        emb = self._on_device(embeddings[lo:lo + m], "embeddings")
        pay = self._on_device(payloads[lo:lo + m], "payloads")
        emb_c = torch.zeros((hi - lo, self.dim), dtype=torch.float32, device=self.device)
        pay_c = torch.zeros((hi - lo, len(PAYLOAD_FIELDS)), dtype=torch.float32,
                            device=self.device)
        emb_c[:m] = emb
        pay_c[:m] = pay
        self._device_cap = cap
        self._ids = [str(d) for d in doc_ids]
        self._id_to_idx = {d: i for i, d in enumerate(self._ids)}
        self._live = {}
        self._pending_emb, self._pending_pay = [], []
        self._device = (*self._prepare_rows(emb_c), pay_c, n)
        self._dirty = False
        self._host_stale = True
        # The host mirrors become placeholders, fetched on demand.
        self._emb = np.zeros((0, self.dim), dtype=np.float32)
        self._pay = np.zeros((0, len(PAYLOAD_FIELDS)), dtype=np.float32)

    def _on_device(self, a: Any, what: str) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            # ``self.device`` with its index filled in, as tensors report it
            if a.device != torch.empty(0, device=self.device).device:
                raise ValueError(f"{what} lie on {a.device}, the store on {self.device}")
            return a.to(torch.float32)
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(self.device)

    def _prepare_rows(self, emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """f32 rows -> (normalized if cosine, cast to ``dtype``; their
        squared norms, taken from the cast rows)."""
        if self.normalize:
            emb = l2_normalize(emb)
        emb = emb.to(self.dtype).contiguous()
        return emb, torch.sum(torch.square(emb.to(torch.float32)), dim=-1)

    def _sync_host(self) -> None:
        """Fetch the host mirrors after :meth:`attach_device`, folding in
        adds that are still buffered."""
        if not self._host_stale:
            return
        self._refuse_sharded_attached("reading the host mirror")
        emb, _, pay, n_dev = self._device
        self._emb = emb.to(torch.float32).cpu().numpy()
        self._pay = pay.cpu().numpy()
        self._host_stale = False
        if self._pending_emb:
            self._ensure_capacity(len(self._ids))
            new_emb = np.stack(self._pending_emb)
            new_pay = np.stack(self._pending_pay)
            self._emb[n_dev: n_dev + len(new_emb)] = new_emb
            self._pay[n_dev: n_dev + len(new_pay)] = new_pay
            self._pending_emb, self._pending_pay = [], []
            self._dirty = True

    def set_payload(self, doc_id: str, payload: Payload) -> None:
        self._sync_host()
        idx = self._id_to_idx[doc_id]
        self._pay[idx] = payload.to_array()
        self._live.pop(idx, None)
        self._dirty = True

    def set_payload_matrix(self, matrix: np.ndarray) -> None:
        """Overwrite all live payload rows at once (bulk re-score path)."""
        self._sync_host()
        mat = np.asarray(matrix, dtype=np.float32)
        if mat.shape != (len(self), len(PAYLOAD_FIELDS)):
            raise ValueError(
                f"Expected [{len(self)}, {len(PAYLOAD_FIELDS)}] payloads, got {mat.shape}")
        self._pay[: len(self)] = mat
        self._live.clear()
        self._dirty = True

    def set_dewi_scores(self, scores: Union[np.ndarray, torch.Tensor]) -> None:
        """Write DEWI scores into payload column 0."""
        self._sync_host()
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
        self._sync_host()
        if idx not in self._live:
            self._live[idx] = Payload.from_array(self._pay[idx])
        return self._live[idx]

    def get_embedding(self, doc_id: str) -> Optional[np.ndarray]:
        idx = self._id_to_idx.get(doc_id)
        if idx is None:
            return None
        self._sync_host()
        return self._emb[idx].copy()

    def payload_matrix(self) -> np.ndarray:
        self._sync_host()
        self._flush_live()
        return self._pay[: len(self)]

    def embedding_matrix(self) -> np.ndarray:
        self._sync_host()
        return self._emb[: len(self)]

    # ---- device sync ---------------------------------------------------------

    def _refuse_sharded_attached(self, what: str) -> None:
        if self._sharding is not None and self._sharding.mesh.n_data > 1:
            raise NotImplementedError(
                f"{what}: this store was attached on the device under a data "
                "sharding and holds only this rank's rows")

    def _merge_pending_on_device(self) -> None:
        """Append the buffered adds to the device arrays: only the new rows
        cross from the host."""
        self._refuse_sharded_attached("adding documents")
        emb_d, sqn_d, pay_d, n_old = self._device
        total = len(self._ids)
        cap = _next_capacity(total)
        if cap > emb_d.shape[0]:
            grow = cap - emb_d.shape[0]
            emb_d = torch.cat([emb_d, emb_d.new_zeros((grow, self.dim))])
            sqn_d = torch.cat([sqn_d, sqn_d.new_zeros(grow)])
            pay_d = torch.cat([pay_d, pay_d.new_zeros((grow, pay_d.shape[1]))])
        new_emb, new_sqn = self._prepare_rows(
            torch.from_numpy(np.stack(self._pending_emb)).to(self.device))
        emb_d[n_old:total] = new_emb
        sqn_d[n_old:total] = new_sqn
        pay_d[n_old:total] = torch.from_numpy(np.stack(self._pending_pay)).to(self.device)
        self._device = (emb_d, sqn_d, pay_d, total)
        self._device_cap = cap
        self._pending_emb, self._pending_pay = [], []

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
        the squared norms are taken from the cast rows.  Under a data
        sharding: this rank's rows only, with the global ``n_valid``.
        """
        self._flush_live()
        if self._host_stale:
            if self._pending_emb:
                self._merge_pending_on_device()
            return self._device
        if self._device is not None and not self._dirty:
            return self._device
        lo, hi = self._shard_range(self._emb.shape[0])
        emb, sqn = self._prepare_rows(
            torch.from_numpy(self._emb[lo:hi]).to(self.device, copy=True))
        pay = torch.from_numpy(self._pay[lo:hi]).to(self.device, copy=True)
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
