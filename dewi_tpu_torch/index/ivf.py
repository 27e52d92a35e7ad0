"""IVF index: k-means coarse quantizer + probed fixed-size buckets.

Counterpart of ``dewi_tpu/index/ivf.py``, with the same layout and the same
search:

* clusters are materialized as fixed-capacity buckets
  ``[nlist, bucket_cap, D]``, so a probe is a gather + batched product;
* docs that overflow a bucket, and the ``dewi_tier`` leaders of the
  query-independent score terms, go to a dense *overflow tier* that every
  query scans exactly;
* search = centroid product -> top-nprobe -> bucket gather -> DEWI re-rank
  -> top-k, one pass per query block.

It holds no hand-written kernel: what the reference leaves to XLA here
(products, gathers, scatters, sorts) is plain PyTorch on the index's
device.  Where the reference's ``top_k``/``argsort`` order of equal values
decides membership (probe choice, the DEWI tier, the spill set), a stable
sort keeps its choice: the lower index first.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..ops.kmeans import assign_clusters, assign_clusters_top2, kmeans
from ..ops.similarity import f32_scalar, l2_normalize, rerank_scores
from ..types import Payload
from .base import BaseIndex
from .exact import as_queries

NEG_INF = float("-inf")
QUERY_BLOCK = 64
_PROBE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
IVFState = Tuple[Any, ...]


def _top_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, the lower index first among equal
    values (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _f32_dots(eq: str, q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``einsum`` with an f32 result: bf16 operands are widened first (their
    products are exact in f32), as the reference's
    ``preferred_element_type=float32``; a bf16 product would round the sum."""
    return torch.einsum(eq, q.to(torch.float32), rows.to(torch.float32))


def _ivf_search_kernel(
    centroids: torch.Tensor,   # [nlist, D]
    b_emb: torch.Tensor,       # [nlist, cap, D] (f32 or bf16)
    b_pay: torch.Tensor,       # [nlist, cap, 8]
    b_valid: torch.Tensor,     # [nlist, cap] bool
    b_docidx: torch.Tensor,    # [nlist, cap] int32 (-1 pad)
    b_sqn: torch.Tensor,       # [nlist, cap]
    o_emb: torch.Tensor,       # [o_cap, D]
    o_pay: torch.Tensor,       # [o_cap, 8]
    o_docidx: torch.Tensor,    # [o_cap]
    o_sqn: torch.Tensor,       # [o_cap]
    o_n: int,
    queries: torch.Tensor,     # [Q, D]
    eta: Any,
    entropy_pref: Any,
    k: int,
    nprobe: int,
    normalize: bool,
    probe_impl: str = "scan",
    dedup: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One query block of the IVF search: ([Q, k] scores, [Q, k] doc rows;
    -inf and -1 where the probed pool is exhausted or a copy was deduped)."""
    dev = centroids.device
    q = queries.to(torch.float32)
    c32 = centroids.to(torch.float32)
    if normalize:
        q = l2_normalize(q)
        csim = q @ c32.T
    else:
        cn = torch.sum(c32 * c32, dim=1)
        csim = 2.0 * (q @ c32.T) - cn[None, :]
    # Empty buckets must not win probe slots (their centroid similarity of
    # ~0 can outrank real centroids when every true similarity is negative).
    nonempty = torch.any(b_valid, dim=1)
    csim = torch.where(nonempty[None, :], csim, torch.full_like(csim, NEG_INF))
    _, probes = _top_stable(csim, nprobe)  # [Q, nprobe]

    eta_t = f32_scalar(eta, dev)
    ep_t = f32_scalar(entropy_pref, dev)
    qe = q.to(b_emb.dtype)  # match bucket storage
    qn = torch.sum(q * q, dim=-1)

    def _scores_from(ps: torch.Tensor, pp: torch.Tensor, pv: torch.Tensor,
                     dots: torch.Tensor) -> torch.Tensor:
        if normalize:
            sim = dots
        else:
            extra = qn[:, None, None] if dots.dim() == 3 else qn[:, None]
            sim = 2.0 * dots - ps - extra
        adj = ((1.0 - eta_t) * sim + eta_t * pp[..., 0]
               + ep_t * 0.5 * (pp[..., 1] + pp[..., 3]))
        return torch.where(pv, adj, torch.full_like(adj, NEG_INF))

    nq = q.shape[0]
    if probe_impl == "scan":
        # One probe rank at a time: [Q, cap, D] live instead of the one-shot
        # gather's [Q, nprobe, cap, D].  Same contractions with f32 sums.
        adjs, idxs = [], []
        for j in range(nprobe):
            pj = probes[:, j]
            dots = _f32_dots("qd,qcd->qc", qe, b_emb[pj])
            adjs.append(_scores_from(b_sqn[pj], b_pay[pj], b_valid[pj], dots))
            idxs.append(b_docidx[pj])
        flat_scores = torch.stack(adjs, dim=1).reshape(nq, -1)
        flat_idx = torch.stack(idxs, dim=1).reshape(nq, -1)
    else:
        dots = _f32_dots("qd,qncd->qnc", qe, b_emb[probes])
        adj = _scores_from(b_sqn[probes], b_pay[probes], b_valid[probes], dots)
        flat_scores = adj.reshape(nq, -1)
        flat_idx = b_docidx[probes].reshape(nq, -1)

    # Overflow tier: always scanned exactly (in the bucket storage dtype).
    osim = _f32_dots("qd,od->qo", q.to(o_emb.dtype), o_emb)
    if not normalize:
        osim = 2.0 * osim - o_sqn[None, :] - torch.sum(q * q, dim=-1, keepdim=True)
    oadj = rerank_scores(osim, o_pay, eta_t, ep_t)
    ovalid = ((torch.arange(o_emb.shape[0], device=dev)[None, :] < o_n)
              & (o_docidx >= 0)[None, :])
    oadj = torch.where(ovalid, oadj, torch.full_like(oadj, NEG_INF))

    all_scores = torch.cat([flat_scores, oadj], dim=1)
    all_idx = torch.cat([flat_idx, o_docidx[None, :].expand(nq, -1)], dim=1)
    # torch.topk here: equal scores of two distinct docs are rounding
    # coincidences, the copies of one spilled doc are deduped below, and
    # every -inf slot carries id -1, so the order among equals decides
    # nothing but the order of such a pair in the result.
    if not dedup:
        vals, pos = torch.topk(all_scores, k, dim=1)
        return vals, torch.gather(all_idx, 1, pos)
    kk = min(2 * k, all_scores.shape[1])
    vals, pos = torch.topk(all_scores, kk, dim=1)
    return _dedup_topk(vals, torch.gather(all_idx, 1, pos), k)


def _dedup_topk(vals: torch.Tensor, ids: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kill every later occurrence of a repeated id, re-select top-k.

    ``vals``/``ids`` are score-descending candidate rows (e.g. a top-2k).
    Duplicate slots get score -inf and id -1, the exhausted-pool sentinel.
    The first occurrence is found by a stable sort of the ids (positions
    stay ascending inside a run of equal ids) rather than the reference's
    ``[Q, 2k, 2k]`` comparison; the result is the same."""
    kk = ids.shape[1]
    sorted_ids, order = torch.sort(ids, dim=1, stable=True)
    repeat = torch.zeros_like(ids, dtype=torch.bool)
    repeat[:, 1:] = sorted_ids[:, 1:] == sorted_ids[:, :-1]
    is_dup = torch.zeros_like(repeat).scatter_(1, order, repeat) & (ids >= 0)
    vals = torch.where(is_dup, torch.full_like(vals, NEG_INF), vals)
    ids = torch.where(is_dup, torch.full_like(ids, -1), ids)
    vals_k, pos_k = _top_stable(vals, min(k, kk))
    return vals_k, torch.gather(ids, 1, pos_k)


def _ivf_plan(assign: torch.Tensor, pay: torch.Tensor, doc_of: torch.Tensor,
              nlist: int, cap: int, tier_n: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bucket planning on the device: stable sort by cluster, rank within
    the cluster, and the in-bucket mask (entries past ``cap`` or in the
    high-DEWI tier go to the exact overflow scan).  ``assign [Nx]`` holds
    cluster ids (``Nx >= N`` with spill copies), ``pay [N, 8]`` the original
    payloads, ``doc_of [Nx]`` the original doc of each entry; the tier is
    picked over original docs, so a tiered doc's every copy overflows."""
    n = assign.shape[0]
    assign = assign.long()
    order = torch.sort(assign, stable=True)[1]
    sorted_assign = assign[order]
    counts = torch.bincount(assign, minlength=nlist)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=assign.device) - starts[sorted_assign]
    in_bucket = rank < cap
    if tier_n > 0:
        # The leaders of both query-independent score terms: clipped DEWI
        # scores tie at 0 and 1, so the order of equals decides membership.
        _, dewi_idx = _top_stable(pay[:, 0], tier_n)
        _, ent_idx = _top_stable(0.5 * (pay[:, 1] + pay[:, 3]), tier_n)
        is_tier = torch.zeros(pay.shape[0], dtype=torch.bool, device=pay.device)
        is_tier[dewi_idx] = True
        is_tier[ent_idx] = True
        in_bucket &= ~is_tier[doc_of.long()[order]]
    return order, rank, in_bucket


def _ivf_materialize(emb: torch.Tensor, sqn: torch.Tensor, pay: torch.Tensor,
                     order: torch.Tensor, rank: torch.Tensor, in_bucket: torch.Tensor,
                     assign: torch.Tensor, doc_of: torch.Tensor, nlist: int, cap: int,
                     o_cap: int, emb_dtype: torch.dtype = torch.float32
                     ) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Scatter the planned layout into fixed-shape bucket and overflow
    arrays on the device.  Rejected entries all write the trash row
    ``nlist`` (or slot ``o_cap``), which is cut off: only there do the
    scatters see an index twice.  ``b_docidx``/``o_docidx`` hold original
    doc rows, so a spill copy gathers the same row as its primary."""
    dev = emb.device
    sorted_assign = assign.long()[order]
    src = doc_of.long()[order].to(torch.int32)
    dest_row = torch.where(in_bucket, sorted_assign, torch.full_like(sorted_assign, nlist))
    dest_col = torch.where(in_bucket, torch.clamp(rank, max=cap - 1), torch.zeros_like(rank))
    b_docidx = torch.full((nlist + 1, cap), -1, dtype=torch.int32, device=dev)
    b_docidx[dest_row, dest_col] = src
    b_docidx = b_docidx[:nlist].contiguous()

    # Pack overflow docs densely: position = running count of overflow rows.
    is_over = ~in_bucket
    pos = torch.cumsum(is_over, 0) - 1
    o_dest = torch.where(is_over, pos, torch.full_like(pos, o_cap))
    o_docidx = torch.full((o_cap + 1,), -1, dtype=torch.int32, device=dev)
    o_docidx[o_dest] = src
    o_docidx = o_docidx[:o_cap].contiguous()

    def take(docidx: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        valid = docidx >= 0
        g = torch.clamp(docidx, min=0).long()
        zero = torch.zeros((), dtype=emb.dtype, device=dev)
        # sqn stays f32 (taken from the store's rows, not from a bf16 copy).
        return (torch.where(valid[..., None], emb[g], zero).to(emb_dtype),
                torch.where(valid[..., None], pay[g], torch.zeros((), device=dev)),
                valid,
                torch.where(valid, sqn[g], torch.zeros((), device=dev)))

    b_emb, b_pay, b_valid, b_sqn = take(b_docidx)
    o_emb, o_pay, _, o_sqn = take(o_docidx)
    return (b_emb, b_pay, b_valid, b_docidx, b_sqn), (o_emb, o_pay, o_docidx, o_sqn)


class IVFIndex(BaseIndex):
    """Inverted-file index over k-means buckets with an exact overflow tier."""

    def __init__(self, dim: int, space: str = "cosine", nlist: int = 100, nprobe: int = 8,
                 bucket_load_factor: float = 1.5, kmeans_iters: int = 10,
                 train_sample: int = 100_000, dewi_tier: int = 1024, seed: int = 0,
                 probe_dtype: str = "float32", probe_impl: str = "auto",
                 spill_frac: float = 0.0, **kwargs: Any) -> None:
        super().__init__(dim, space, **kwargs)
        self.nlist = int(nlist)
        self.nprobe = int(nprobe)
        self.bucket_load_factor = float(bucket_load_factor)
        self.kmeans_iters = int(kmeans_iters)
        self.train_sample = int(train_sample)
        # Bucket/overflow storage dtype: "bfloat16" halves the bucket copies
        # and the gather's reads; "auto" follows the store's dtype at build.
        aliases = {"bf16": "bfloat16", "f32": "float32", "fp32": "float32"}
        self.probe_dtype = aliases.get(str(probe_dtype), str(probe_dtype))
        if self.probe_dtype not in ("auto", "float32", "bfloat16"):
            raise ValueError(
                f"probe_dtype must be auto|float32|bfloat16, got {probe_dtype!r}")
        # "gather" takes all probed buckets at once ([Q, nprobe, cap, D]),
        # "scan" one probe rank at a time ([Q, cap, D] live).  Same math and
        # rankings; scores can differ in the last ulps.  "auto" picks scan
        # on the CPU and gather on a CUDA device: at 1M x 256, nlist 1024,
        # nprobe 32 on an H100 80GB HBM3 (700 W) gather read 0.097-0.099
        # ms/query at Q=1000 and 1.0-2.0 ms at Q=1, scan 0.127-0.149 and
        # 6.6-8.0 (chip_smoke.py; PERF.md).
        if probe_impl not in ("auto", "scan", "gather"):
            raise ValueError(f"probe_impl must be auto|scan|gather, got {probe_impl!r}")
        self.probe_impl = str(probe_impl)
        # The ``dewi_tier`` docs with the highest DEWI scores (and entropy
        # means) go to the exact overflow scan: at high eta the ranking is
        # led by documents the coarse quantizer has no reason to probe.
        self.dewi_tier = int(dewi_tier)
        # The ``spill_frac`` fraction of docs with the smallest top-2
        # centroid margin are also written into their second-closest
        # bucket; the copies are deduped at top-k.
        self.spill_frac = float(spill_frac)
        if not 0.0 <= self.spill_frac <= 1.0:
            raise ValueError(f"spill_frac must be in [0, 1], got {spill_frac}")
        self.seed = int(seed)
        self._dev: Optional[IVFState] = None
        self._built_len = -1

    def _hyperparams(self) -> dict:
        return {
            "nlist": self.nlist,
            "nprobe": self.nprobe,
            "bucket_load_factor": self.bucket_load_factor,
            "kmeans_iters": self.kmeans_iters,
            "train_sample": self.train_sample,
            "dewi_tier": self.dewi_tier,
            "seed": self.seed,
            "probe_dtype": self.probe_dtype,
            "probe_impl": self.probe_impl,
            "spill_frac": self.spill_frac,
        }

    def _resolved_probe_impl(self) -> str:
        if self.probe_impl != "auto":
            return self.probe_impl
        return "scan" if self.device.type == "cpu" else "gather"

    # -- build -------------------------------------------------------------

    def build(self, sample_idx: Optional[Any] = None, init_idx: Optional[Any] = None,
              **kwargs: Any) -> None:
        """Bucketize the corpus on the device: k-means on a training sample,
        assignment, the stable sort, ranks, the tier pick and all gathers;
        the one host sync is the overflow count (it sizes the overflow
        arrays).  The sample and the initial centroids are each drawn from
        a ``torch.Generator`` seeded with ``seed`` on the index's device, as
        the reference draws both from one key; ``sample_idx`` (rows of the
        corpus) and ``init_idx`` (rows of the sample) override the draws."""
        n = len(self.store)
        if n == 0:
            raise ValueError("No embeddings to build index from")
        emb_dev, sqn_dev, pay_dev, _ = self.store.device_arrays()
        emb, sqn, pay = emb_dev[:n], sqn_dev[:n], pay_dev[:n]
        dev = emb.device

        nlist = min(self.nlist, n)
        if n > self.train_sample:
            if sample_idx is None:
                gen = torch.Generator(device=dev).manual_seed(self.seed)
                sample_idx = torch.randperm(n, generator=gen, device=dev)[:self.train_sample]
            train = emb[torch.as_tensor(sample_idx, device=dev).long()]
        else:
            train = emb
        centroids, _ = kmeans(train, n_clusters=nlist, n_iters=self.kmeans_iters,
                              spherical=self.store.normalize, seed=self.seed,
                              init_idx=init_idx)
        n_spill = int(round(self.spill_frac * n)) if nlist >= 2 else 0
        arange = torch.arange(n, dtype=torch.int32, device=dev)
        if n_spill > 0:
            a2, margin = assign_clusters_top2(emb, centroids)
            # Smallest-margin docs sit on cluster boundaries; copy them into
            # their runner-up bucket (equal margins: the lower doc first).
            _, spill_idx = _top_stable(-margin, n_spill)
            assign_x = torch.cat([a2[:, 0], a2[spill_idx, 1]])
            doc_of = torch.cat([arange, spill_idx.to(torch.int32)])
        else:
            assign_x = assign_clusters(emb, centroids)
            doc_of = arange

        n_eff = n + n_spill  # spill copies share the bucket budget
        cap = max(8, int(np.ceil(self.bucket_load_factor * max(1, n_eff / nlist) / 8.0)) * 8)
        tier_n = min(self.dewi_tier, n)
        order, rank, in_bucket = _ivf_plan(assign_x, pay, doc_of, nlist=nlist, cap=cap,
                                           tier_n=tier_n)
        o_n = int(torch.sum(~in_bucket))
        o_cap = max(8, -(-max(o_n, 1) // 8) * 8)

        probe_dtype = self.probe_dtype
        if probe_dtype == "auto":
            probe_dtype = "bfloat16" if emb.dtype == torch.bfloat16 else "float32"
        b_arrays, o_arrays = _ivf_materialize(
            emb, sqn, pay, order, rank, in_bucket, assign_x, doc_of, nlist=nlist, cap=cap,
            o_cap=o_cap, emb_dtype=_PROBE_DTYPES[probe_dtype])
        self._dev = (centroids.to(torch.float32), *b_arrays, *o_arrays, o_n)
        self._built_len = len(self.store)
        self._is_trained = True

    # -- search ------------------------------------------------------------

    def search_batch(self, queries: Any, k: int = 10, eta: float = 0.5,
                     entropy_pref: float = 0.0, nprobe: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._dev is None or self._built_len != len(self.store):
            self.build()  # docs added since build() are in no bucket
        nprobe = min(int(nprobe or self.nprobe), min(self.nlist, len(self.store)))
        q = as_queries(queries, self.device)
        b_emb, o_emb = self._dev[1], self._dev[6]
        # The candidate pool is nprobe buckets + the overflow tier: a larger
        # k clamps to the pool, not to the corpus.
        bucket_cap = int(b_emb.shape[1])
        pool = nprobe * bucket_cap + int(o_emb.shape[0])
        k_eff = min(int(k), len(self.store), pool)

        # Bound the probe working set to ~1 GB: the scan path holds one
        # probe rank ([block, cap, D]) live at a time, the gather path all.
        per_rank = bucket_cap * self.dim * b_emb.element_size()
        probe_impl = self._resolved_probe_impl()
        bytes_per_q = per_rank if probe_impl == "scan" else nprobe * per_rank
        block_size = max(1, min(QUERY_BLOCK, (1 << 30) // max(bytes_per_q, 1)))

        outs_v, outs_i = [], []
        for start in range(0, q.shape[0], block_size):
            v, i = _ivf_search_kernel(
                *self._dev, q[start:start + block_size], eta, entropy_pref, k=k_eff,
                nprobe=nprobe, normalize=self.store.normalize, probe_impl=probe_impl,
                dedup=self.spill_frac > 0.0)  # spill buckets may hold two copies
            outs_v.append(v)
            outs_i.append(i)
        return torch.cat(outs_v, dim=0), torch.cat(outs_i, dim=0)

    def search(self, query: np.ndarray, k: int = 10, eta: float = 0.5,
               entropy_pref: float = 0.0) -> List[Tuple[str, float, Payload]]:
        """As ``BaseIndex.search``; empty and deduped slots (id -1) are skipped."""
        if len(self.store) == 0:
            return []
        scores, idx = self.search_batch(query, k=k, eta=eta, entropy_pref=entropy_pref)
        scores = scores[0].cpu().numpy()
        idx = idx[0].cpu().numpy()
        pay = self.store.payload_matrix()
        results = []
        for rank in range(min(int(k), idx.shape[0])):
            i = int(idx[rank])
            if i < 0:
                continue
            results.append((self.store.doc_ids[i], float(scores[rank]),
                            Payload.from_array(pay[i])))
        return results


__all__ = ["IVFIndex", "QUERY_BLOCK"]
