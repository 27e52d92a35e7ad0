"""Plain reference of DEWI scoring and of DEWI re-ranked search.

Scoring: per-signal median and MAD (the mean of the two middle values for
an even count; a MAD of 0 floored at 1e-8), ``z = (v - med) / (1.4826 *
mad)``, ``U = a_t*Ht + a_i*Hi - a_m*I - a_r*R - a_n*N`` with ``Ht``/``Hi``
the means of the two text/image z-scores, clipped to ``+-delta``, then a
sigmoid.  Search: cosine similarity to every document, re-ranked as
``(1 - eta) * sim + eta * dewi + entropy_pref * (ht_mean + hi_mean) / 2``,
top k.  Signal columns are ``(ht_mean, ht_q90, hi_mean, hi_q90, I_hat,
redundancy, noise)``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

MAD_CONSISTENCY = 1.4826
MAD_FLOOR = 1e-8


def median0(x: torch.Tensor) -> torch.Tensor:
    s = torch.sort(x, dim=0).values
    n = x.shape[0]
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def dewi_scores(signals: torch.Tensor, alphas: Sequence[float] = (1, 1, 1, 1, 1),
                delta: float = 3.0, dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """``[N, 7]`` signals -> ``[N]`` DEWI scores (standard mode) in ``dtype``."""
    x = signals.to(dtype)
    med = median0(x)
    mad = median0((x - med).abs())
    mad = torch.where(mad == 0, torch.full_like(mad, MAD_FLOOR), mad)
    z = (x - med) / (MAD_CONSISTENCY * mad)
    at, ai, am, ar, an = alphas
    u = (at * 0.5 * (z[:, 0] + z[:, 1]) + ai * 0.5 * (z[:, 2] + z[:, 3])
         - am * z[:, 4] - ar * z[:, 5] - an * z[:, 6])
    return torch.sigmoid(u.clamp(-delta, delta))


def normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def adjusted_scores(queries: torch.Tensor, docs_n: torch.Tensor, dewi: torch.Tensor,
                    ent: torch.Tensor, eta: float, entropy_pref: float) -> torch.Tensor:
    """``[Q, N]`` re-ranked scores of normalized queries against normalized docs."""
    sim = torch.matmul(normalize(queries.to(docs_n.dtype)), docs_n.t())
    return (1.0 - eta) * sim + eta * dewi[None, :] + entropy_pref * ent[None, :]


def search(queries: torch.Tensor, docs_n: torch.Tensor, dewi: torch.Tensor, ent: torch.Tensor,
           eta: float, entropy_pref: float, k: int, block: int = 64
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top k: ``([Q, k] scores, [Q, k] rows)``, ``block`` queries at a time."""
    out_s, out_i = [], []
    for a in range(0, queries.shape[0], block):
        s, i = torch.topk(adjusted_scores(queries[a:a + block], docs_n, dewi, ent, eta,
                                          entropy_pref), k, dim=1)
        out_s.append(s)
        out_i.append(i)
    return torch.cat(out_s), torch.cat(out_i)


def judge(queries: torch.Tensor, served_rows: torch.Tensor, served_scores: torch.Tensor,
          docs_n: torch.Tensor, dewi: torch.Tensor, ent: torch.Tensor, eta: float,
          entropy_pref: float, k: int, block: int = 64) -> Tuple[float, float]:
    """``(score_gap, recall_miss)`` of served answers.  ``score_gap``: the
    widest gap between a served score and the reference's score of the
    same document.  ``recall_miss``: the share of the reference's k best
    documents, over all queries, that were not served (1 - recall@k).  A
    served row that is missing (-1), repeated or out of range counts as a
    score gap of 1 and as not served."""
    score_gap, missed = 0.0, 0
    n = docs_n.shape[0]
    for a in range(0, queries.shape[0], block):
        adj = adjusted_scores(queries[a:a + block], docs_n, dewi, ent, eta, entropy_pref)
        best = torch.topk(adj, k, dim=1).indices.cpu().tolist()
        rows = served_rows[a:a + block].to(adj.device).long()
        ok = (rows >= 0) & (rows < n)
        for r, row in enumerate(rows.cpu().tolist()):
            valid = [x for x, good in zip(row, ok[r].tolist()) if good]
            if len(set(valid)) != len(row):
                score_gap = max(score_gap, 1.0)
            missed += len(set(best[r]) - set(valid))
        got = torch.gather(adj, 1, rows.clamp(0, n - 1))
        served = served_scores[a:a + block].to(adj.device, adj.dtype)
        score_gap = max(score_gap, float((got - served).abs().max()))
    return score_gap, missed / max(1, k * queries.shape[0])


__all__ = ["dewi_scores", "search", "judge", "adjusted_scores", "normalize", "median0"]
