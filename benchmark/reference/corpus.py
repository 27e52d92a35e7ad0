"""Plain reference of the corpus deployment's text signals.

* Surprisal: a document is ``[BOS] + its UTF-8 bytes`` (BOS = 256, the
  byte tokenizer's fixed 258-token vocabulary).  One of at most ``ctx``
  tokens is scored whole; a longer one over windows of ``ctx`` tokens that
  advance by ``ctx - ctx // 4``, where every window after the first drops
  its first ``ctx // 4 - 1`` targets, so each kept token has that much left
  context.  The per-token NLL stream gives the mean and the 0.9 quantile
  (linear interpolation, as ``numpy.quantile``).
* Embedding: the CLIP text tower over ``[BOS] + bytes`` cut to the tower's
  length; for a text-only document this is the index embedding.
* Redundancy: each document's largest cosine similarity to another
  document of the same ``process_corpus`` call.
* Noise: ``1 - (0.7 * quality + 0.3 * language)`` in float32, quality starting at 1,
  less 0.4 where under 30% of the characters are letters or digits and
  less 0.2 where over half are symbols; language 0.5 (unknown) unless
  ``langdetect`` is installed, then 1 for ``expected`` and 0 otherwise.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .models import Matmul, Weights, clip_text_embed, exact, lm_token_nll

BOS = 256


def token_ids(text: str) -> List[int]:
    return [BOS] + list(text.encode("utf-8"))


def windows(ids: List[int], ctx: int) -> List[Tuple[List[int], int]]:
    """``(window ids, targets to drop)`` covering a document."""
    if len(ids) <= ctx:
        return [(ids, 0)]
    overlap = ctx // 4
    return [(ids[s:s + ctx], 0 if s == 0 else overlap - 1)
            for s in range(0, max(len(ids) - overlap, 1), ctx - overlap)]


def surprisal_stats(texts: Sequence[str], w: Weights, cfg: Dict, ctx: int,
                    mm: Matmul = exact, batch: int = 32) -> np.ndarray:
    """``[N, 2]`` (mean, q90) of each document's token surprisal (nats)."""
    device = w["wte.weight"].device
    jobs = []  # (doc, window number, window ids, targets to drop)
    for d, t in enumerate(texts):
        for j, (win, drop) in enumerate(windows(token_ids(t), ctx)):
            jobs.append((d, j, win, drop))
    jobs.sort(key=lambda job: len(job[2]))
    streams: Dict[int, Dict[int, np.ndarray]] = {}
    for a in range(0, len(jobs), batch):
        chunk = jobs[a:a + batch]
        t = max(len(job[2]) for job in chunk)
        ids = torch.zeros((len(chunk), t), dtype=torch.long)
        for r, (_, _, win, _) in enumerate(chunk):
            ids[r, :len(win)] = torch.tensor(win)
        nll = lm_token_nll(ids.to(device), w, cfg, mm).cpu().numpy()
        for r, (d, j, win, drop) in enumerate(chunk):
            streams.setdefault(d, {})[j] = nll[r, drop:len(win) - 1]
    out = np.zeros((len(texts), 2), np.float64)
    for d in range(len(texts)):
        s = np.concatenate([streams[d][j] for j in sorted(streams[d])])
        out[d] = s.mean(), np.quantile(s, 0.9)
    return out


def text_embeddings(texts: Sequence[str], w: Weights, cfg: Dict, mm: Matmul = exact,
                    batch: int = 256) -> torch.Tensor:
    """``[N, d_embed]`` normalized CLIP text embeddings (float32)."""
    device = w["text_tower.wte.weight"].device
    t = cfg["max_position_embeddings"]
    out = []
    for a in range(0, len(texts), batch):
        ids_l = [token_ids(x)[:t] for x in texts[a:a + batch]]
        ids = torch.zeros((len(ids_l), t), dtype=torch.long)
        for r, x in enumerate(ids_l):
            ids[r, :len(x)] = torch.tensor(x)
        lens = torch.tensor([len(x) for x in ids_l])
        out.append(clip_text_embed(ids.to(device), lens.to(device), w, cfg, mm))
    return torch.cat(out)


def redundancy(emb: torch.Tensor) -> torch.Tensor:
    """Each row's largest cosine similarity to another row."""
    e = emb.double()
    e = e / torch.linalg.vector_norm(e, dim=-1, keepdim=True).clamp_min(1e-12)
    sim = e @ e.t()
    sim.fill_diagonal_(float("-inf"))
    return sim.max(dim=1).values


def _language(text: str, expected: str) -> float:
    try:
        from langdetect import detect
    except Exception:  # noqa: BLE001 -- not installed: unknown
        return 0.5
    if not text or len(text.strip()) < 2:
        return 0.5
    try:
        return 1.0 if detect(text) == expected else 0.0
    except Exception:  # noqa: BLE001
        return 0.5


def text_noise(texts: Sequence[Optional[str]], expected: str = "en") -> np.ndarray:
    """Each document's text noise in float32, the terms summed in the
    order ``1 - (0.7 q + 0.3 l)``, so the comparison can be exact."""
    out = np.zeros(len(texts), np.float32)
    f = np.float32
    for i, t in enumerate(texts):
        if t is None:
            continue
        q = 0.0
        if t:
            alnum = sum(c.isalnum() for c in t)
            symbol = sum((not c.isalnum()) and c not in " \n\t\r" for c in t)
            q = min(max(1.0 - 0.4 * (alnum / len(t) < 0.3) - 0.2 * (symbol / len(t) > 0.5),
                        0.0), 1.0)
        lang = _language(t, expected)
        out[i] = f(1.0) - (f(0.7) * f(q) + f(0.3) * f(lang))
    return out


__all__ = ["surprisal_stats", "text_embeddings", "redundancy", "text_noise", "windows",
           "token_ids"]
