"""DEWI^tau training-data sampling and submodular coverage selection.

Counterpart of ``dewi_tpu/sampling.py``:

* :func:`dewi_tau_probabilities` / :func:`sample_by_dewi` — ``p(doc) ∝
  dewi^tau``; without replacement by the Gumbel-top-k trick (one top-k over
  ``log w + Gumbel noise``), with replacement by categorical draws.  The
  noise comes from a ``torch.Generator`` seeded by ``seed``: PyTorch's
  random stream is not JAX's, so for the same seed the port draws other
  indices from the same distribution.
* :func:`submodular_pick` — greedy facility location over the ``[N, N]``
  similarity matrix: each step is one ``[N]``-wide gain, argmax and
  max-update on the device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .utils.device import DeviceLike, resolve_device


def dewi_tau_probabilities(dewi: np.ndarray, tau: float = 1.0) -> np.ndarray:
    """``p(doc) ∝ dewi^tau`` normalized (tau=0 -> uniform)."""
    d = np.clip(np.asarray(dewi, dtype=np.float64), 1e-12, None)
    w = d ** float(tau)
    return (w / w.sum()).astype(np.float64)


def _log_weights(dewi: np.ndarray, tau: float, device: torch.device) -> torch.Tensor:
    d = torch.as_tensor(np.asarray(dewi, np.float32), device=device)
    return torch.log(d.clamp_min(1e-12)) * tau


def _gumbel_topk(log_w: torch.Tensor, uniform: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the top ``k`` of ``log_w + Gumbel(uniform)``."""
    g = -torch.log(-torch.log(uniform))
    return torch.topk(log_w + g, k).indices


def uniform_noise(n: int, seed: int, device: torch.device) -> torch.Tensor:
    """``[n]`` uniforms in [1e-12, 1) from a generator seeded by ``seed`` (the
    reference's ``uniform(minval=1e-12, maxval=1.0)``)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(n, generator=gen, device=device)
    return 1e-12 + u * (1.0 - 1e-12)


def sample_by_dewi(dewi: np.ndarray, k: int, tau: float = 1.0, seed: int = 0,
                   replace: bool = False, device: DeviceLike = None) -> np.ndarray:
    """Sample ``k`` doc indices with probability ``∝ dewi^tau`` on ``device``
    (``None``: the card)."""
    dewi = np.asarray(dewi)
    n = dewi.shape[0]
    if k > n and not replace:
        raise ValueError(f"Cannot draw {k} distinct docs from {n}")
    dev = resolve_device(device)
    log_w = _log_weights(dewi, tau, dev)
    if replace:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        probs = torch.softmax(log_w.double(), dim=0)
        return torch.multinomial(probs, k, replacement=True, generator=gen).cpu().numpy()
    return _gumbel_topk(log_w, uniform_noise(n, seed, dev), k).cpu().numpy()


def _facility_location(emb_n: torch.Tensor, k: int) -> torch.Tensor:
    """Greedy facility location: add, k times, the doc that most increases
    ``sum_i max_{s in S} sim(i, s)``.  The ``[N, N]`` similarity matrix is
    built once; each step is one masked argmax and max-update."""
    n = emb_n.shape[0]
    sims = emb_n @ emb_n.T
    covered = torch.zeros(n, dtype=torch.float32, device=emb_n.device)
    selected = torch.zeros(n, dtype=torch.bool, device=emb_n.device)
    picks = torch.empty(k, dtype=torch.int64, device=emb_n.device)
    for step in range(k):
        # Gain of candidate j = sum_i max(0, sim[j, i] - covered[i]).
        gains = (sims - covered[None, :]).clamp_min(0.0).sum(dim=1)
        gains.masked_fill_(selected, -torch.inf)
        j = torch.argmax(gains)
        covered = torch.maximum(covered, sims[j])
        selected[j] = True
        picks[step] = j
    return picks


def submodular_pick(embeddings: np.ndarray, k: int, dewi: Optional[np.ndarray] = None,
                    device: DeviceLike = None) -> np.ndarray:
    """Coverage-maximizing subset of ``k`` docs (facility location).

    When ``dewi`` is given, similarities are scaled by the candidates' DEWI
    scores so the pick balances coverage with usefulness.
    """
    dev = resolve_device(device)
    emb = torch.as_tensor(np.asarray(embeddings, np.float32), device=dev)
    emb = emb / emb.norm(dim=1, keepdim=True).clamp_min(1e-12)
    if dewi is not None:
        d = torch.as_tensor(np.asarray(dewi, np.float32), device=dev)
        emb = emb * torch.sqrt(d.clamp_min(1e-6))[:, None]
    n = emb.shape[0]
    if k >= n:
        return np.arange(n)
    return _facility_location(emb, k).cpu().numpy()


def training_sample(dewi: np.ndarray, embeddings: Optional[np.ndarray], k: int,
                    tau: float = 1.0, use_submodular: bool = False, seed: int = 0,
                    device: DeviceLike = None) -> np.ndarray:
    """Config-driven entry point (``TrainingSamplingConfig`` semantics)."""
    if use_submodular:
        if embeddings is None:
            raise ValueError("submodular_pick requires embeddings")
        return submodular_pick(embeddings, k, dewi=dewi, device=device)
    return sample_by_dewi(dewi, k, tau=tau, seed=seed, device=device)


__all__ = [
    "dewi_tau_probabilities",
    "sample_by_dewi",
    "submodular_pick",
    "training_sample",
]
