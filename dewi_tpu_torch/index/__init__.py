"""Indexes: SoA store, exact and quantized backends, DewiIndex facade."""

from ..types import Payload
from .base import BaseIndex
from .exact import ExactIndex
from .facade import DewiIndex, IndexBackend
from .quantized import QuantizedIndex
from .store import DocStore

# Registry for persistence round trips, keyed by the saved class name.  The
# JAX package's names map onto the port's backends; IVFIndex/FAISSIndex are
# not ported yet (DewiIndex.load raises for them).
BACKEND_CLASSES = {
    "ExactIndex": ExactIndex,
    "QuantizedIndex": QuantizedIndex,
    "HNSWIndex": ExactIndex,
}

__all__ = ["Payload", "BaseIndex", "ExactIndex", "QuantizedIndex", "DewiIndex",
           "IndexBackend", "DocStore", "BACKEND_CLASSES"]
