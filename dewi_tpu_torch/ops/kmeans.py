"""Lloyd k-means for the IVF coarse quantizer.

Counterpart of ``dewi_tpu/ops/kmeans.py``: assignment is a chunked matmul +
argmin, the update an ``index_add_`` scatter, all on the corpus's device.
The scatter sums in another order than JAX's ``segment_sum``, so centroids
agree with the reference to f32 rounding and a row on a cluster boundary
may be assigned differently.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .similarity import l2_normalize

ASSIGN_CHUNK = 16384  # rows per assignment matmul block


def _neg_dist(xb: torch.Tensor, centroids: torch.Tensor, cn: torch.Tensor) -> torch.Tensor:
    """``|c|^2 - 2 x.c`` per (row, centroid): ``|x|^2`` is constant per row."""
    return cn[None, :] - 2.0 * (xb @ centroids.T)


def assign_clusters(x: torch.Tensor, centroids: torch.Tensor,
                    chunk: int = ASSIGN_CHUNK) -> torch.Tensor:
    """Nearest-centroid assignment, ``chunk`` rows at a time so the
    ``[chunk, K]`` distance tile stays small.  Returns int32 ``[N]``; among
    equal distances the lower centroid wins (``argmin`` returns the first)."""
    x = x.to(torch.float32)
    cn = torch.sum(centroids * centroids, dim=1)
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    for r0 in range(0, x.shape[0], chunk):
        d = _neg_dist(x[r0:r0 + chunk], centroids, cn)
        out[r0:r0 + chunk] = torch.argmin(d, dim=1)
    return out


def assign_clusters_top2(x: torch.Tensor, centroids: torch.Tensor,
                         chunk: int = ASSIGN_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two nearest centroids per row plus the assignment margin.

    Returns ``(assign2 [N, 2] int32, margin [N] f32)`` where ``margin`` is
    ``d2 - d1`` (squared-distance gap; small = near a cluster boundary).
    Each is a first-minimum reduction, so among equal distances the lower
    centroid comes first, as ``jax.lax.top_k`` orders them.
    """
    x = x.to(torch.float32)
    n = x.shape[0]
    cn = torch.sum(centroids * centroids, dim=1)
    a2 = torch.empty((n, 2), dtype=torch.int32, device=x.device)
    margin = torch.empty(n, dtype=torch.float32, device=x.device)
    for r0 in range(0, n, chunk):
        d = _neg_dist(x[r0:r0 + chunk], centroids, cn)
        d1, i1 = torch.min(d, dim=1)
        d.scatter_(1, i1[:, None], float("inf"))
        d2, i2 = torch.min(d, dim=1)
        a2[r0:r0 + chunk, 0] = i1
        a2[r0:r0 + chunk, 1] = i2
        margin[r0:r0 + chunk] = d2 - d1
    return a2, margin


def kmeans(x: torch.Tensor, n_clusters: int, n_iters: int = 10, spherical: bool = False,
           chunk: int = ASSIGN_CHUNK, seed: int = 0,
           init_idx: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit ``n_clusters`` centroids on ``x [N, D]``; returns (centroids, assign).

    The initial centroids are the rows ``init_idx`` (``[n_clusters]``), by
    default the head of a permutation drawn from a ``torch.Generator``
    seeded with ``seed`` on ``x``'s device (the reference draws it from a
    JAX key; the two streams differ).  ``spherical=True`` re-normalizes the
    centroids each iteration (cosine space).  Empty clusters keep their
    previous centroid.
    """
    x = x.to(torch.float32)
    n = x.shape[0]
    if init_idx is None:
        g = torch.Generator(device=x.device).manual_seed(int(seed))
        init_idx = torch.randperm(n, generator=g, device=x.device)[:n_clusters]
    cent = x[torch.as_tensor(init_idx, device=x.device).long()]
    if spherical:
        cent = l2_normalize(cent)
    ones = torch.ones(n, dtype=torch.float32, device=x.device)
    for _ in range(n_iters):
        a = assign_clusters(x, cent, chunk=chunk).long()
        sums = torch.zeros_like(cent).index_add_(0, a, x)
        counts = torch.zeros(n_clusters, dtype=torch.float32,
                             device=x.device).index_add_(0, a, ones)[:, None]
        cent = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), cent)
        if spherical:
            cent = l2_normalize(cent)
    return cent, assign_clusters(x, cent, chunk=chunk)


__all__ = ["ASSIGN_CHUNK", "assign_clusters", "assign_clusters_top2", "kmeans"]
