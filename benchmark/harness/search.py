"""The search deployment: its index, its queries, and its check.

The deployment (``configs/*.json``, ``"kind": "search_index"``) is the
reference's bench protocol: ``n_docs`` unit-normalized normal vectors of
``dim`` in a store of ``capacity`` rows, seven gamma(2) signals per
document scored by ``DewiScorer``, a ``DewiIndex`` of the configured
backend filled on the card with ``attach_device``.  Everything is drawn on
the card from the run's seed.

The drivers of the search cells (``drivers/*.py``) build on it.  The
check compares the DEWI scores the index holds, and a seeded sample of
the served answers, with ``reference/search.py`` in float64.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from reference import search as ref

from .common import Run, rng, sync, torch_generator


def draw_corpus(cfg: Dict[str, Any], seed: int, device: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(embeddings [n, dim], signals [n, 7])`` on ``device``: normal
    vectors and gamma(2, 1) signals (the sum of two unit exponentials)."""
    g = torch_generator(seed, device, "corpus")
    n, d = cfg["n_docs"], cfg["dim"]
    emb = torch.randn((n, d), generator=g, device=device)
    u = torch.rand((n, 7, 2), generator=g, device=device)
    return emb, -torch.log1p(-u).sum(-1)


def build_index(cfg: Dict[str, Any], seed: int, device: Any) -> Any:
    from dewi_tpu_torch import DewiIndex, DewiScorer

    emb, sig = draw_corpus(cfg, seed, device)
    dewi = DewiScorer(device=device).fit_and_score(sig)
    pay = torch.cat([dewi[:, None], sig], dim=1)
    idx = cfg["index"]
    index = DewiIndex(dim=cfg["dim"], backend=idx["backend"], device=device,
                      rerank_eta=cfg["eta"], entropy_pref=cfg["entropy_pref"],
                      **idx.get("options", {}))
    index._backend.store.attach_device([str(i) for i in range(cfg["n_docs"])], emb, pay)
    index.build()
    if index._backend.store.capacity != cfg["capacity"]:
        raise RuntimeError(f"capacity {index._backend.store.capacity}, "
                           f"the configuration states {cfg['capacity']}")
    del emb, sig, dewi, pay
    sync(device)
    return index


def queries(seed: int, salt: str, n: int, d: int) -> np.ndarray:
    return rng(seed, salt).standard_normal((n, d), dtype=np.float32)


# -- the check ------------------------------------------------------------------


def held_dewi(index: Any, n: int) -> torch.Tensor:
    """The DEWI scores the index holds (payload column 0 of its live rows)."""
    return index._backend.store.device_arrays()[2][:n, 0]


def check(run: Run, cfg: Dict[str, Any], held: torch.Tensor, seed: int, device: Any,
          q: np.ndarray, rows: np.ndarray, scores: np.ndarray, limits: Dict[str, float]) -> None:
    """DEWI scores ``held`` by the index and the served answers
    ``rows``/``scores`` of queries ``q`` against the float64 reference."""
    held = held.double()
    emb, sig = draw_corpus(cfg, seed, device)
    dewi = ref.dewi_scores(sig)
    run.checks.append(("dewi_gap", float((held - dewi).abs().max()), limits["dewi_gap"]))
    del held
    docs = ref.normalize(emb.double())
    del emb
    ent = 0.5 * (sig[:, 0] + sig[:, 2]).double()
    score_gap, recall_miss = ref.judge(torch.from_numpy(q).to(device).double(),
                                    torch.from_numpy(rows), torch.from_numpy(scores), docs,
                                    dewi, ent, cfg["eta"], cfg["entropy_pref"], cfg["k"])
    run.checks.append(("score_gap", score_gap, limits["score_gap"]))
    run.checks.append(("recall_miss", recall_miss, limits["recall_miss"]))


__all__ = ["build_index", "draw_corpus", "check", "held_dewi", "queries"]
