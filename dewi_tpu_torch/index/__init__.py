"""Indexes: SoA store, exact, quantized and IVF backends, DewiIndex facade."""

from ..types import Payload
from .base import BaseIndex
from .exact import ExactIndex
from .facade import DewiIndex, IndexBackend
from .ivf import IVFIndex
from .quantized import QuantizedIndex
from .store import DocStore

# Registry for persistence round trips, keyed by the saved class name.  The
# JAX package's names map onto the port's backends as its own registry
# maps the reference's (FAISS's IVFFlat onto IVFIndex, HNSW onto exact).
BACKEND_CLASSES = {
    "ExactIndex": ExactIndex,
    "IVFIndex": IVFIndex,
    "QuantizedIndex": QuantizedIndex,
    "HNSWIndex": ExactIndex,
    "FAISSIndex": IVFIndex,
}

__all__ = ["Payload", "BaseIndex", "ExactIndex", "IVFIndex", "QuantizedIndex", "DewiIndex",
           "IndexBackend", "DocStore", "BACKEND_CLASSES"]
