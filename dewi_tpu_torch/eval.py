"""Config-driven retrieval evaluation over the port's indexes.

Counterpart of ``dewi_tpu/eval.py``: given an index, queries and ground
truth, :func:`evaluate_index` runs the ``EvalConfig`` metric suite (recall@k,
nDCG@k, MRR, DEWI-bin stratification) and returns one report dict;
:func:`recall_vs_exact` is the ANN acceptance sweep (recall of an ANN tier
against exact search on the same queries).  The index answers on its own
device.  ``evaluate_index`` searches the queries in groups of
:data:`QUERY_GROUP`, the most one stage-1 kernel launch takes, so that an
index whose gates route small batches to the kernels (a quantized index
under 65,536 rows) answers an eval as it answers a search; the rankings are
the same either way.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .config import EvalConfig
from .metrics import mrr, ndcg_at_k, recall_at_k, recall_matrix, stratify_by_dewi

QUERY_GROUP = 32  # queries per search_batch call of evaluate_index


def _host(a: Any) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def evaluate_index(
    index: Any,
    queries: np.ndarray,
    ground_truth: Dict[str, Sequence[str]],
    query_ids: Optional[Sequence[str]] = None,
    config: Optional[EvalConfig] = None,
    eta: float = 0.0,
    entropy_pref: float = 0.0,
    relevance: Optional[Dict[str, Dict[str, int]]] = None,
) -> dict:
    """Run the EvalConfig metric suite against an index.

    ``ground_truth`` maps query id -> relevant doc ids; ``relevance``
    optionally maps query id -> {doc id: graded relevance} for nDCG (binary
    grades from ``ground_truth`` by default).
    """
    config = config or EvalConfig()
    queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
    if query_ids is None:
        query_ids = [f"q{i}" for i in range(len(queries))]
    max_k = max(list(config.recall_k) + list(config.ndcg_k) + [10])

    idx = np.concatenate([
        _host(index.search_batch(queries[s:s + QUERY_GROUP], k=max_k, eta=eta,
                                 entropy_pref=entropy_pref)[1])
        for s in range(0, len(queries), QUERY_GROUP)])
    doc_ids = index.doc_ids if hasattr(index, "doc_ids") else index.store.doc_ids
    n_live = len(doc_ids)
    rankings = {
        qid: [doc_ids[j] for j in row[:max_k] if 0 <= j < n_live]
        for qid, row in zip(query_ids, idx)
    }

    report: dict = {"n_queries": len(queries)}
    for k in config.recall_k:
        report[f"recall@{k}"] = recall_at_k(ground_truth, rankings, k=k)
    if relevance is None:
        relevance = {q: {d: 1 for d in docs} for q, docs in ground_truth.items()}
    for k in config.ndcg_k:
        report[f"ndcg@{k}"] = ndcg_at_k(relevance, rankings, k=k)
    if config.mrr:
        report["mrr"] = mrr(ground_truth, rankings)
    if config.dewi_bins and len(config.dewi_bins) >= 2:
        doc_dewi = {
            d: float(index.get_payload(d).dewi)
            for docs in rankings.values()
            for d in docs
            if index.get_payload(d) is not None
        }
        strat = stratify_by_dewi(list(config.dewi_bins), doc_dewi, rankings)
        report["dewi_bins"] = {f"{lo}-{hi}": v for (lo, hi), v in strat.items()}
    return report


def recall_vs_exact(
    ann_index: Any,
    exact_index: Any,
    queries: np.ndarray,
    k: int = 10,
    eta: float = 0.0,
    entropy_pref: float = 0.0,
) -> float:
    """ANN acceptance sweep: recall of an ANN backend against exact search."""
    queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
    _, ai = ann_index.search_batch(queries, k=k, eta=eta, entropy_pref=entropy_pref)
    _, ei = exact_index.search_batch(queries, k=k, eta=eta, entropy_pref=entropy_pref)
    return recall_matrix(_host(ai), _host(ei))


__all__ = ["evaluate_index", "recall_vs_exact"]
