"""Exact index: one matmul -> re-rank -> top-k search over the whole store.

Counterpart of ``dewi_tpu/index/exact.py`` with the same routing gates
(``_pallas_ok``, ``_blockmax_ok``, ``_fused_bmax_ok``) minus the Mosaic
probes: bf16-stored cosine indexes run stage 1 in the ``scores_matrix``
CUDA kernel at Q <= 32 and at a dim it takes (``kernel_takes``), else the
plain matmul; selection defaults to the two-pass block max.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from ..ops.cuda_search import (BLOCKMAX_SUB, BMAX_BLOCK, MAX_QUERIES, SCORES_BLOCK,
                               kernel_takes)
from ..ops.similarity import fused_search
from .base import BaseIndex


def as_queries(queries: Any, device: torch.device) -> torch.Tensor:
    """``[D]`` or ``[Q, D]`` array/tensor -> ``[Q, D]`` f32 on ``device``."""
    q = torch.as_tensor(np.asarray(queries, dtype=np.float32)
                        if not isinstance(queries, torch.Tensor) else queries)
    q = q.to(device=device, dtype=torch.float32)
    return q.reshape(1, -1) if q.dim() == 1 else q


class ExactIndex(BaseIndex):
    """Brute-force cosine / L2 search with fused DEWI re-ranking."""

    def __init__(self, dim: int, space: str = "cosine", use_pallas: bool = True,
                 blockmax_select: bool = True, fused_bmax: bool = False,
                 **kwargs: Any) -> None:
        super().__init__(dim, space, **kwargs)
        # ``use_pallas`` keeps the JAX package's name (it is persisted in
        # metadata.json): it enables the CUDA stage-1 kernel.
        self.use_pallas = bool(use_pallas)
        self.blockmax_select = bool(blockmax_select)
        self.fused_bmax = bool(fused_bmax)

    def _hyperparams(self) -> dict:
        return {"use_pallas": self.use_pallas,
                "blockmax_select": self.blockmax_select,
                "fused_bmax": self.fused_bmax}

    def _pallas_ok(self, n_queries: int) -> bool:
        return (
            self.use_pallas
            and self.store.normalize
            and self.store.dtype == torch.bfloat16
            and self.store.capacity % SCORES_BLOCK == 0
            and n_queries <= MAX_QUERIES
            and kernel_takes("bf16", self.dim, self.device)
        )

    def _blockmax_ok(self) -> bool:
        cap = self.store.capacity
        return self.blockmax_select and cap % BLOCKMAX_SUB == 0 and cap >= 4 * BLOCKMAX_SUB

    def _fused_bmax_ok(self, n_queries: int) -> bool:
        return (self.fused_bmax and self._blockmax_ok()
                and self._pallas_ok(n_queries)
                and self.store.capacity % BMAX_BLOCK == 0)

    def build(self, **kwargs: Any) -> None:
        if len(self.store) == 0:
            raise ValueError("No embeddings to build index from")
        self.store.device_arrays()
        self._is_trained = True

    def search_batch(self, queries: Any, k: int = 10, eta: float = 0.5,
                     entropy_pref: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[Q, D]`` queries -> ([Q, k] scores, [Q, k] row ids) on the device."""
        emb, sqn, pay, n = self.store.device_arrays()
        q = as_queries(queries, self.device)
        nq = int(q.shape[0])
        return fused_search(
            emb, sqn, pay, q, n, eta, entropy_pref,
            k=min(int(k), self.store.capacity),
            normalize=self.store.normalize,
            kernel_scores=self._pallas_ok(nq),
            blockmax_select=self._blockmax_ok(),
            fused_bmax=self._fused_bmax_ok(nq),
        )


__all__ = ["ExactIndex", "as_queries"]
