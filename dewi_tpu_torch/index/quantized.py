"""Quantized index: int8 / int4 corpus scan + f32 refinement.

Counterpart of ``dewi_tpu/index/quantized.py`` with the same routing gates
(``_pallas_stage1_ok``, ``_fused_bmax_block``), where the kernels' shape
predicate (``cuda_search.kernel_takes``) takes the place of the Mosaic
probes: every tier takes its kernels, ``bmax``/``scores_matrix`` with
float queries, ``bmax_s8``/``scores_matrix_s8`` with ``int8_queries``,
``bmax_s4``/``scores_matrix_s4`` on int4, at every dim they take, and the
plain route at any other, as the reference falls back to XLA when a probe
fails.  Two choices differ from the TPU build, neither changing a result:
the int4 corpus is always kept packed (the CUDA kernels unpack in
registers; the plain route unpacks it), and there is no 2x stream block
for Q <= 8 (a TPU block-size choice).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..ops.cuda_search import BMAX_BLOCK, MAX_QUERIES, SCORES_BLOCK, kernel_takes
from ..ops.quantized import quantize_rows, quantize_rows_int4, quantized_search
from .base import BaseIndex
from .exact import as_queries


class QuantizedIndex(BaseIndex):
    """Two-stage search: quantized stage 1, exact f32 stage 2."""

    def __init__(self, dim: int, space: str = "cosine", refine_factor: int = 8,
                 use_pallas: bool = True,
                 int8_queries: bool = False, bf16_scores: bool = False,
                 blockmax_select: bool = True, int4_storage: bool = False,
                 **kwargs: Any) -> None:
        if "approx_select" in kwargs:
            raise TypeError(
                "approx_select has no counterpart in the port: its flat "
                "candidate select is always an exact top-m")
        super().__init__(dim, space, **kwargs)
        self.refine_factor = max(1, int(refine_factor))
        self.use_pallas = bool(use_pallas)
        self.int8_queries = bool(int8_queries)
        self.bf16_scores = bool(bf16_scores)
        self.blockmax_select = bool(blockmax_select)
        self.int4_storage = bool(int4_storage)
        if self.int4_storage:
            self.int8_queries = True
        self._q_emb: Optional[torch.Tensor] = None
        self._q_scales: Optional[torch.Tensor] = None
        self._built_len = -1

    def _hyperparams(self) -> dict:
        return {
            "refine_factor": self.refine_factor,
            "use_pallas": self.use_pallas,
            "int8_queries": self.int8_queries,
            "bf16_scores": self.bf16_scores,
            "blockmax_select": self.blockmax_select,
            "int4_storage": self.int4_storage,
        }

    def _kernel_takes_dim(self) -> bool:
        """Whether this tier's stage-1 kernels take the index's dim."""
        kind = "s4" if self.int4_storage else "s8" if self.int8_queries else "int8"
        return kernel_takes(kind, self.dim, self.device)

    def _pallas_stage1_ok(self, n_queries: int) -> bool:
        cap = self.store.capacity
        return (
            self.use_pallas
            and cap >= SCORES_BLOCK
            and cap % SCORES_BLOCK == 0
            and n_queries <= MAX_QUERIES
            and self._kernel_takes_dim()
        )

    def _fused_bmax_block(self) -> int:
        """Routing block of the fused stage-1 + block-max kernel, or 0.

        Engaged at every batch size (quantized_search runs batches above
        32 queries in 32-query groups)."""
        cap = self.store.capacity
        if not (self.blockmax_select and self.use_pallas
                and cap % BMAX_BLOCK == 0 and cap >= 4 * BMAX_BLOCK
                and self._kernel_takes_dim()):
            return 0
        return BMAX_BLOCK

    def build(self, **kwargs: Any) -> None:
        if len(self.store) == 0:
            raise ValueError("No embeddings to build index from")
        emb, _, _, _ = self.store.device_arrays()
        if self.int4_storage:
            self._q_emb, self._q_scales = quantize_rows_int4(emb)
        else:
            self._q_emb, self._q_scales = quantize_rows(emb)
        self._built_len = len(self.store)
        self._is_trained = True

    def search_batch(self, queries: Any, k: int = 10, eta: float = 0.5,
                     entropy_pref: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._q_emb is None or self._built_len != len(self.store):
            self.build()
        emb, sqn, pay, n = self.store.device_arrays()
        q = as_queries(queries, self.device)
        cap = self.store.capacity
        k_eff = min(int(k), cap)
        # int4's 15-level grid needs a 4x-wider refine margin.
        boost = 4 if self.int4_storage else 1
        m = min(max(k_eff * self.refine_factor * boost, 32), cap)
        nq = int(q.shape[0])
        fused_block = self._fused_bmax_block()
        return quantized_search(
            self._q_emb, self._q_scales, emb, sqn, pay, q, n, eta, entropy_pref,
            k=k_eff, m=m, normalize=self.store.normalize,
            kernel_stage1=bool(fused_block) or self._pallas_stage1_ok(nq),
            kernel_block=fused_block,
            int8_queries=self.int8_queries,
            bf16_scores=self.bf16_scores,
            blockmax_select=self.blockmax_select,
            fused_bmax=bool(fused_block),
            int4_packed=self.int4_storage,
        )


__all__ = ["QuantizedIndex"]
