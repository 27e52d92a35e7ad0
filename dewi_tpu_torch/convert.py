"""Carry a JAX-package index's state across to the port as numpy arrays.

``index_from_numpy_state`` builds a port ``DewiIndex`` that searches the
very same corpus, quantized codes and payloads as the JAX index it came
from: the ``DocStore.device_arrays()`` tuple (normalized, cast rows, their
squared norms, payloads, ``n_valid``) and, for the quantized tiers,
``QuantizedIndex._q_emb``/``_q_scales``, all as numpy.
``ivf_index_from_numpy_state`` also takes the JAX ``IVFIndex._dev`` tuple,
so the port searches the very same buckets.  ``stats_from_numpy_state``
does the same for fitted ``RobustStats``.
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


def ivf_index_from_numpy_state(
    doc_ids: Sequence[str],
    device_arrays: Sequence[Any],
    ivf_state: Sequence[Any],
    *,
    space: str = "cosine",
    device: DeviceLike = None,
    **index_kwargs: Any,
) -> DewiIndex:
    """Build a port IVF index from the store's arrays and the ``_dev`` tuple.

    ``ivf_state`` is the JAX ``IVFIndex._dev`` as numpy: centroids, the five
    bucket arrays (``b_emb``, ``b_pay``, ``b_valid``, ``b_docidx``,
    ``b_sqn``), the four overflow arrays (``o_emb``, ``o_pay``,
    ``o_docidx``, ``o_sqn``) and the overflow count ``o_n``.  The index is
    marked built, so it searches these buckets until a document is added.
    ``index_kwargs`` are the ``IVFIndex`` hyperparameters (``nlist``,
    ``nprobe``, ``spill_frac``, ...), which the search reads.
    """
    if len(ivf_state) != 11:
        raise ValueError(f"an IVF state has 11 arrays, got {len(ivf_state)}")
    index = index_from_numpy_state(doc_ids, device_arrays, space=space, backend="ivf",
                                   device=device, **index_kwargs)
    ivf = index._backend
    dev = ivf.device
    cent, b_emb, b_pay, b_valid, b_docidx, b_sqn, o_emb, o_pay, o_docidx, o_sqn, o_n = ivf_state
    ivf._dev = (
        _tensor(cent, dev).to(torch.float32), _tensor(b_emb, dev),
        _tensor(b_pay, dev).to(torch.float32), _tensor(b_valid, dev).to(torch.bool),
        _tensor(b_docidx, dev).to(torch.int32), _tensor(b_sqn, dev).to(torch.float32),
        _tensor(o_emb, dev), _tensor(o_pay, dev).to(torch.float32),
        _tensor(o_docidx, dev).to(torch.int32), _tensor(o_sqn, dev).to(torch.float32),
        int(np.asarray(o_n)),
    )
    ivf._built_len = len(ivf.store)
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


__all__ = ["index_from_numpy_state", "ivf_index_from_numpy_state",
           "stats_from_numpy_state"]
