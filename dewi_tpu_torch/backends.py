"""Compatibility import surface of the reference's ``backends`` module.

Counterpart of ``dewi_tpu/backends.py``: code written against the
hnswlib/FAISS-backed class names keeps working.  The graph and IVF engines
are the port's own tiers, so the availability flags are always True and
the old names alias their replacements.
"""

from .index import BACKEND_CLASSES, BaseIndex, DocStore, ExactIndex, IndexBackend, IVFIndex

# Aliases for code written against the hnswlib/FAISS-backed classes.
HNSWIndex = ExactIndex
FAISSIndex = IVFIndex

_HAS_FAISS = True  # the port's IVF tier is always available
_HAS_HNSW = True   # exact top-k subsumes graph ANN here

__all__ = [
    "BaseIndex",
    "ExactIndex",
    "IVFIndex",
    "HNSWIndex",
    "FAISSIndex",
    "IndexBackend",
    "DocStore",
    "BACKEND_CLASSES",
    "_HAS_FAISS",
    "_HAS_HNSW",
]
