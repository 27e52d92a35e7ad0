"""Distributed DEWI search: each rank searches its block of the corpus.

Counterpart of ``dewi_tpu/parallel/distributed.py``.  Each rank of the data
axis holds a contiguous block of the document axis, runs the single-device
search on it (the fused similarity + DEWI re-rank + local top-k, the
quantized two-stage search, or the IVF probe), turns its row ids global,
and the ``(score, id)`` candidate lists are all-gathered over the data
group and merged with one more top-k.  Communication per query is
``n_data * k`` scores and ids, independent of the corpus size, and every
rank returns the merged result, as the reference's ``out_specs=P()``.

The per-shard bodies are the port's own single-device functions: plain
PyTorch for the exact path (the reference's is XLA), the CUDA stage-1
kernels of ``ops/quantized`` for the quantized path on the card, and
``index/ivf._ivf_search_kernel`` for IVF.  Each rank builds its
``make_sharded_*`` callable and passes its own shard, as each device runs
the reference's ``shard_map`` body.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..index.exact import as_queries
from ..index.ivf import QUERY_BLOCK, _dedup_topk, _ivf_search_kernel
from ..ops.cuda_search import BMAX_BLOCK, MAX_QUERIES, SCORES_BLOCK, kernel_takes
from ..ops.quantized import quantize_rows, quantize_rows_int4, quantized_search
from ..ops.similarity import fused_search, topk_merge
from .mesh import DATA_AXIS, Mesh, data_sharding

Result = Tuple[torch.Tensor, torch.Tensor]
SearchFn = Callable[..., Result]


def _local_rows(mesh: Mesh, shard_cap: int, n_valid: int) -> Tuple[int, int]:
    """``(first global row, live rows)`` of this rank's shard."""
    start = mesh.data_index * shard_cap
    return start, max(0, min(int(n_valid) - start, shard_cap))


def _merge(mesh: Mesh, vals: torch.Tensor, gidx: torch.Tensor, k: int) -> Result:
    all_vals = mesh.all_gather(vals, dim=1)
    all_idx = mesh.all_gather(gidx, dim=1)
    return topk_merge(all_vals, all_idx, min(k, all_vals.shape[1]))


def make_sharded_search(mesh: Mesh, k: int, normalize: bool = True,
                        blockmax_select: bool = True) -> SearchFn:
    """Sharded exact search for a fixed (mesh, k, space).

    The returned function takes this rank's ``emb [cap/n, D]``, ``sqn``,
    ``pay [cap/n, 8]``, the replicated queries and the global ``n_valid``,
    ``eta``, ``entropy_pref``, and returns the merged ``([Q, k] scores,
    [Q, k] global rows)`` on every rank.
    """
    def local_search(emb: torch.Tensor, sqn: torch.Tensor, pay: torch.Tensor,
                     queries: torch.Tensor, n_valid: int, eta: float,
                     entropy_pref: float) -> Result:
        shard_cap = emb.shape[0]
        start, local_n = _local_rows(mesh, shard_cap, n_valid)
        vals, idx = fused_search(emb, sqn, pay, queries, local_n, eta, entropy_pref,
                                 k=min(k, shard_cap), normalize=normalize,
                                 blockmax_select=blockmax_select)
        return _merge(mesh, vals, idx + start, k)

    return local_search


def make_sharded_quantized_search(mesh: Mesh, k: int, m: int, normalize: bool = True,
                                  kernel_stage1: bool = False, int8_queries: bool = False,
                                  bf16_scores: bool = False, blockmax_select: bool = False,
                                  fused_bmax: bool = False,
                                  int4_packed: bool = False) -> SearchFn:
    """Sharded two-stage search: each rank's quantized scan + f32 refine
    (``ops/quantized.quantized_search`` with the flags fixed here), then the
    exact path's all-gather and merge.  ``kernel_stage1``/``fused_bmax``
    route each shard's stage 1 through the CUDA kernels; the caller gates
    them on the dim and the shard's alignment (see
    :class:`ShardedQuantizedSearcher`)."""
    def local_search(emb_q: torch.Tensor, scales: torch.Tensor, emb: torch.Tensor,
                     sqn: torch.Tensor, pay: torch.Tensor, queries: torch.Tensor,
                     n_valid: int, eta: float, entropy_pref: float) -> Result:
        shard_cap = emb.shape[0]
        start, local_n = _local_rows(mesh, shard_cap, n_valid)
        vals, idx = quantized_search(
            emb_q, scales, emb, sqn, pay, queries, local_n, eta, entropy_pref,
            k=min(k, shard_cap), m=min(m, shard_cap), normalize=normalize,
            kernel_stage1=kernel_stage1, int8_queries=int8_queries,
            bf16_scores=bf16_scores, blockmax_select=blockmax_select,
            fused_bmax=fused_bmax, int4_packed=int4_packed)
        return _merge(mesh, vals, idx + start, k)

    return local_search


class ShardedExactSearcher:
    """Shard a :class:`DocStore` over the mesh's data axis and serve queries.

    Every rank builds its own store over the same documents; with the
    sharding set, ``device_arrays()`` puts only this rank's rows on its
    device."""

    def __init__(self, store: Any, mesh: Mesh, k: int = 10,
                 blockmax_select: bool = True) -> None:
        self.store = store
        self.mesh = mesh
        self.k = k
        self.blockmax_select = bool(blockmax_select)
        store.sharding = data_sharding(mesh, rank=2)
        self._fn = make_sharded_search(mesh, k, normalize=store.normalize,
                                       blockmax_select=self.blockmax_select)

    def search_batch(self, queries: Any, eta: float = 0.5, entropy_pref: float = 0.0,
                     k: Optional[int] = None) -> Result:
        if k is not None and k != self.k:
            self.k = k
            self._fn = make_sharded_search(self.mesh, k, normalize=self.store.normalize,
                                           blockmax_select=self.blockmax_select)
        emb, sqn, pay, n = self.store.device_arrays()
        return self._fn(emb, sqn, pay, as_queries(queries, emb.device), n, eta, entropy_pref)


class ShardedQuantizedSearcher:
    """Sharded int8/int4 search: quantized shard scans + f32 refinement.

    The distributed counterpart of :class:`QuantizedIndex`.  Each rank
    quantizes its shard's rows once (row-wise, so the scales equal the
    unsharded ones bit for bit); the routes are fixed at construction from
    the dim (``kernel_takes``) and the shard's alignment, as the reference
    decides them from its probes: stage 1 in the kernels where the shard is
    a whole number of ``SCORES_BLOCK`` rows, the fused block-max kernel
    where it is also a whole number of ``BMAX_BLOCK`` rows.  A shard
    smaller than a kernel block takes the plain route.
    """

    def __init__(self, store: Any, mesh: Mesh, k: int = 10, refine_factor: int = 8,
                 use_pallas: bool = True, int8_queries: bool = False,
                 bf16_scores: bool = False, blockmax_select: bool = True,
                 int4_storage: bool = False) -> None:
        self.store = store
        self.mesh = mesh
        self.k = k
        self.int8_queries = bool(int8_queries) or bool(int4_storage)
        self.bf16_scores = bool(bf16_scores)
        self.blockmax_select = bool(blockmax_select)
        self.int4_storage = bool(int4_storage)
        store.sharding = data_sharding(mesh, rank=2)
        self._quantize()
        m = max(32, k * refine_factor * (4 if self.int4_storage else 1))
        shard_cap = store.capacity // mesh.shape[DATA_AXIS]
        kind = "s4" if self.int4_storage else "s8" if self.int8_queries else "int8"
        self._pallas_capable = (bool(use_pallas) and shard_cap >= SCORES_BLOCK
                                and shard_cap % SCORES_BLOCK == 0
                                and kernel_takes(kind, store.dim, mesh.device))
        self._fused_bmax = (self.blockmax_select and self._pallas_capable
                            and shard_cap % BMAX_BLOCK == 0)
        common = dict(normalize=store.normalize, int8_queries=self.int8_queries,
                      bf16_scores=self.bf16_scores, blockmax_select=self.blockmax_select,
                      int4_packed=self.int4_storage)
        # Above MAX_QUERIES queries without the fused kernel: plain stage 1
        # (a launch holds at most that many queries on chip), block-max
        # selection kept; with it, quantized_search launches stage 1 per 32 queries.
        self._fn_large = make_sharded_quantized_search(mesh, k, m, **common)
        self._fn_small = (
            make_sharded_quantized_search(mesh, k, m, kernel_stage1=self._pallas_capable,
                                          fused_bmax=self._fused_bmax, **common)
            if self._pallas_capable else self._fn_large)

    def _quantize(self) -> None:
        emb, _, _, _ = self.store.device_arrays()
        quantize = quantize_rows_int4 if self.int4_storage else quantize_rows
        self._q_emb, self._scales = quantize(emb)
        self._built_len = len(self.store)

    def search_batch(self, queries: Any, eta: float = 0.5,
                     entropy_pref: float = 0.0) -> Result:
        if self._built_len != len(self.store):
            self._quantize()
        emb, sqn, pay, n = self.store.device_arrays()
        q = as_queries(queries, emb.device)
        fn = self._fn_small if q.shape[0] <= MAX_QUERIES or self._fused_bmax else self._fn_large
        return fn(self._q_emb, self._scales, emb, sqn, pay, q, n, eta, entropy_pref)


def make_sharded_ivf_search(mesh: Mesh, k: int, nprobe_per_shard: int,
                            normalize: bool = True, dedup: bool = False,
                            probe_impl: str = "scan") -> SearchFn:
    """Sharded IVF search: each rank scores its block of centroids, probes
    its top ``nprobe_per_shard`` buckets, scans its overflow slice exactly,
    and the candidates merge by all-gather + top-k.

    Probing is per shard (``n_data * nprobe_per_shard`` probes in all), so
    ``nprobe_per_shard`` equal to the local bucket count is exact search.
    ``dedup=True`` (spill-built indexes) re-runs the id dedup over the
    gathered candidates; copies of a doc on two shards can differ in the
    last ulp, so the merge keeps the highest-scoring copy (a sort by
    score, then the first occurrence of each id).  ``probe_impl`` is
    :class:`IVFIndex`'s (``"scan"`` or ``"gather"``).
    """
    def local_search(centroids: torch.Tensor, b_emb: torch.Tensor, b_pay: torch.Tensor,
                     b_valid: torch.Tensor, b_docidx: torch.Tensor, b_sqn: torch.Tensor,
                     o_emb: torch.Tensor, o_pay: torch.Tensor, o_docidx: torch.Tensor,
                     o_sqn: torch.Tensor, queries: torch.Tensor, eta: float,
                     entropy_pref: float) -> Result:
        nprobe = min(nprobe_per_shard, centroids.shape[0])
        # k clamps to the probed pool (nprobe buckets + overflow slice).
        k_local = min(k, nprobe * b_docidx.shape[1] + o_docidx.shape[0])
        vals, idx = _ivf_search_kernel(
            centroids, b_emb, b_pay, b_valid, b_docidx, b_sqn, o_emb, o_pay, o_docidx,
            o_sqn, o_emb.shape[0], queries, eta, entropy_pref, k=k_local, nprobe=nprobe,
            normalize=normalize, probe_impl=probe_impl, dedup=dedup)
        # b_docidx/o_docidx hold global store rows: no shard offset.
        all_vals = mesh.all_gather(vals, dim=1)
        all_idx = mesh.all_gather(idx, dim=1)
        k_out = min(k, all_vals.shape[1])
        if dedup:
            order = torch.sort(all_vals, dim=1, descending=True, stable=True)[1]
            return _dedup_topk(torch.gather(all_vals, 1, order),
                               torch.gather(all_idx, 1, order), k_out)
        return topk_merge(all_vals, all_idx, k_out)

    return local_search


def _pad0(a: torch.Tensor, mult: int, fill: Any = 0) -> torch.Tensor:
    pad = (-a.shape[0]) % mult
    if not pad:
        return a
    return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                                    device=a.device)])


class ShardedIVFSearcher:
    """Distributed counterpart of :class:`IVFIndex`.

    The first rank of the data axis holds the built index: its bucket and
    overflow arrays are padded to a multiple of the data axis (empty
    buckets: ``valid=False``, ``docidx=-1``; padded overflow slots:
    ``docidx=-1``) and scattered, each rank receiving its contiguous block
    of buckets and its overflow slice, as the reference places them with a
    data sharding.  The other ranks' ``ivf_index`` supplies only the
    hyperparameters and need not be built: a built copy could differ in
    the last ulp (k-means sums in a scatter), and one layout must hold.
    """

    def __init__(self, ivf_index: Any, mesh: Mesh, k: int = 10,
                 nprobe_per_shard: Optional[int] = None) -> None:
        self.k = k
        self.mesh = mesh
        n_dev = mesh.shape[DATA_AXIS]
        root = mesh.data_index == 0
        parts: List[Optional[List[torch.Tensor]]] = [None] * 10
        meta = None
        if root:
            if ivf_index._dev is None or ivf_index._built_len != len(ivf_index.store):
                ivf_index.build()
            (centroids, b_emb, b_pay, b_valid, b_docidx, b_sqn,
             o_emb, o_pay, o_docidx, o_sqn, o_n) = ivf_index._dev
            o_emb, o_pay = o_emb[:o_n], o_pay[:o_n]
            o_docidx, o_sqn = o_docidx[:o_n], o_sqn[:o_n]
            if o_n == 0:  # keep every shard's overflow slice non-empty
                o_docidx = torch.full((n_dev,), -1, dtype=o_docidx.dtype,
                                      device=o_docidx.device)
            arrays = (_pad0(centroids, n_dev), _pad0(b_emb, n_dev), _pad0(b_pay, n_dev),
                      _pad0(b_valid, n_dev, False), _pad0(b_docidx, n_dev, -1),
                      _pad0(b_sqn, n_dev), _pad0(o_emb, n_dev), _pad0(o_pay, n_dev),
                      _pad0(o_docidx, n_dev, -1), _pad0(o_sqn, n_dev))
            if o_n == 0:
                arrays = arrays[:6] + (
                    torch.zeros((n_dev, o_emb.shape[1]), dtype=o_emb.dtype, device=o_emb.device),
                    torch.zeros((n_dev, o_pay.shape[1]), dtype=o_pay.dtype, device=o_pay.device),
                    arrays[8],
                    torch.zeros((n_dev,), dtype=o_sqn.dtype, device=o_sqn.device))
            parts = [list(torch.chunk(a, n_dev)) for a in arrays]
            meta = [(tuple(p[0].shape), p[0].dtype) for p in parts]
            meta.append((int(ivf_index.nprobe), bool(ivf_index.store.normalize),
                         float(ivf_index.spill_frac), ivf_index._resolved_probe_impl()))
        meta = _broadcast_object(mesh, meta)
        self._dev = tuple(mesh.scatter(parts[i], shape, dtype)
                          for i, (shape, dtype) in enumerate(meta[:10]))
        nprobe, normalize, spill_frac, self._probe_impl = meta[10]
        local_nlist = int(self._dev[0].shape[0])
        if nprobe_per_shard is None:
            nprobe_per_shard = max(1, -(-nprobe // n_dev))
        self._nprobe = min(int(nprobe_per_shard), local_nlist)
        self._fn = make_sharded_ivf_search(
            mesh, k, self._nprobe, normalize=normalize, probe_impl=self._probe_impl,
            # A spill-built bucket may hold a doc twice, possibly on two
            # shards: dedup in each shard and again at the merge.
            dedup=spill_frac > 0.0)

    def search_batch(self, queries: Any, eta: float = 0.5,
                     entropy_pref: float = 0.0) -> Result:
        """Blocks of queries, as :meth:`IVFIndex.search_batch`: the probe
        working set stays near 1 GB (the gather route holds every probed
        bucket of a block at once)."""
        q = as_queries(queries, self._dev[0].device)
        b_emb = self._dev[1]
        per_rank = int(b_emb.shape[1]) * int(b_emb.shape[2]) * b_emb.element_size()
        bytes_per_q = per_rank * (1 if self._probe_impl == "scan" else self._nprobe)
        block = max(1, min(QUERY_BLOCK, (1 << 30) // max(bytes_per_q, 1)))
        outs = [self._fn(*self._dev, q[s:s + block], eta, entropy_pref)
                for s in range(0, q.shape[0], block)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def _broadcast_object(mesh: Mesh, obj: Any) -> Any:
    """``obj`` of the first rank on the data axis, on every rank."""
    group = mesh.group(DATA_AXIS)
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group,
                               device=torch.device("cpu")
                               if dist.get_backend(group) == dist.Backend.GLOO else mesh.device)
    return box[0]


__all__ = [
    "make_sharded_search",
    "make_sharded_quantized_search",
    "make_sharded_ivf_search",
    "ShardedExactSearcher",
    "ShardedQuantizedSearcher",
    "ShardedIVFSearcher",
]
