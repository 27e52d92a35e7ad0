"""Carry a JAX-package index's state across to the port as numpy arrays.

``index_from_numpy_state`` builds a port ``DewiIndex`` that searches the
very same corpus, quantized codes and payloads as the JAX index it came
from: the ``DocStore.device_arrays()`` tuple (normalized, cast rows, their
squared norms, payloads, ``n_valid``) and, for the quantized tiers,
``QuantizedIndex._q_emb``/``_q_scales``, all as numpy.
``stats_from_numpy_state`` does the same for fitted ``RobustStats``.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from .index.facade import DewiIndex
from .index.quantized import QuantizedIndex
from .scorer import RobustStats
from .types import SIGNAL_FIELDS
from .utils.device import DeviceLike

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16 from a JAX array
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)  # a writable copy


def index_from_numpy_state(
    doc_ids: Sequence[str],
    device_arrays: Sequence[Any],
    *,
    space: str = "cosine",
    backend: str = "exact",
    q_emb: Optional[Any] = None,
    q_scales: Optional[Any] = None,
    device: DeviceLike = None,
    **index_kwargs: Any,
) -> DewiIndex:
    """Build a port index from ``(emb, sqnorms, payloads, n_valid)`` arrays.

    ``emb`` is ``[cap, D]`` float32 or bfloat16 (the store's dtype follows
    it); ``q_emb``/``q_scales`` are the quantized tier's stage-1 arrays
    (``[cap, D]`` int8, or ``[cap, D/2]`` packed int4 for ``backend="int4"``).
    The host mirror holds the given (already normalized) rows, so a later
    rebuild reproduces them.
    """
    emb, sqn, pay, n = device_arrays
    n = int(np.asarray(n))
    emb_np = np.asarray(emb)
    dtype = _DTYPES[emb_np.dtype.name]
    index = DewiIndex(dim=emb_np.shape[1], space=space, backend=backend,
                      device=device, dtype=dtype, capacity=emb_np.shape[0],
                      **index_kwargs)
    store = index._backend.store
    pay_np = np.asarray(pay, dtype=np.float32)
    store.add_batch(list(doc_ids), emb_np.astype(np.float32)[:n], pay_np[:n])
    dev = store.device
    store.set_device_arrays((_tensor(emb, dev), _tensor(sqn, dev),
                             _tensor(pay_np, dev), n))
    backend_obj = index._backend
    if isinstance(backend_obj, QuantizedIndex):
        if q_emb is None or q_scales is None:
            raise ValueError("a quantized index needs q_emb and q_scales")
        backend_obj._q_emb = _tensor(q_emb, dev).to(torch.int8).contiguous()
        backend_obj._q_scales = _tensor(q_scales, dev).to(torch.float32).contiguous()
        backend_obj._built_len = len(store)
    backend_obj._is_trained = True
    index._built = True
    return index


def stats_from_numpy_state(medians: Any, mads: Any,
                           keys: Sequence[str] = SIGNAL_FIELDS) -> RobustStats:
    """``RobustStats`` from per-key median and MAD arrays (or dicts)."""
    if isinstance(medians, dict):
        return RobustStats(medians={k: float(medians[k]) for k in keys},
                           mads={k: float(mads[k]) for k in keys}, keys=tuple(keys))
    med = np.asarray(medians, np.float32)
    mad = np.asarray(mads, np.float32)
    return RobustStats(medians={k: float(v) for k, v in zip(keys, med)},
                       mads={k: float(v) for k, v in zip(keys, mad)},
                       keys=tuple(keys))


__all__ = ["index_from_numpy_state", "stats_from_numpy_state"]
