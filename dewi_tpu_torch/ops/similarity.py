"""Exact similarity + DEWI re-rank + top-k search.

Counterpart of ``dewi_tpu/ops/similarity.py``:

  sim = Q @ E^T
  adj = (1-eta)*sim + eta*dewi + entropy_pref*(ht_mean+hi_mean)/2
  top-k over the valid rows

The re-rank and the validity mask fold into per-row ``mult``/``add``
vectors, so the ``[Q, cap]`` epilogue is one multiply-add.  Over bf16
stores (and Q <= 32) stage 1 runs in the ``scores_matrix`` CUDA kernel;
otherwise it is a full-f32 matmul (``folded_dot``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from . import cuda_search
from .cuda_search import BLOCKMAX_SUB

NEG_INF = float("-inf")
Scalar = Union[float, torch.Tensor]
# Rows of a store that is not f32 converted to f32 per step of
# ``folded_dot``: 16384 rows of 256 dims are 16 MiB, inside an H100's L2.
ROW_CHUNK = 16384


def l2_normalize(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Row-wise L2 normalization; zero vectors pass through unchanged."""
    x = x.to(torch.float32)
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    return torch.where(norm > eps, x / safe, x)


def f32_scalar(v: Scalar, device: torch.device) -> torch.Tensor:
    """A 0-d float32 tensor on ``device``, so scalar arithmetic such as
    ``1 - eta`` rounds in f32 as the JAX package's f32 scalars do."""
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def rerank_scores(sim: torch.Tensor, payloads: torch.Tensor, eta: Scalar,
                  entropy_pref: Scalar) -> torch.Tensor:
    """DEWI-blended adjusted score; ``payloads`` [N, 8] in PAYLOAD_FIELDS
    order (dewi at column 0, ht_mean at 1, hi_mean at 3)."""
    eta = f32_scalar(eta, sim.device)
    ep = f32_scalar(entropy_pref, sim.device)
    dewi = payloads[:, 0]
    mean_entropy = 0.5 * (payloads[:, 1] + payloads[:, 3])
    return (1.0 - eta) * sim + eta * dewi[None, :] + ep * mean_entropy[None, :]


def folded_dot(q: torch.Tensor, rows: torch.Tensor, mult: torch.Tensor,
               add: torch.Tensor, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(q @ rows^T) * mult + add`` in full f32 -> ``[Q, cap]`` of ``out_dtype``.

    The epilogue runs in place on the product; a store that is not f32
    (bf16, int8) is converted ``ROW_CHUNK`` rows at a time, so no f32 copy
    of the whole store is made.
    """
    nq, cap = q.shape[0], rows.shape[0]
    if rows.dtype == torch.float32:
        return (q @ rows.T).mul_(mult).add_(add).to(out_dtype)
    out = torch.empty((nq, cap), dtype=out_dtype, device=q.device)
    for r0 in range(0, cap, ROW_CHUNK):
        r1 = min(r0 + ROW_CHUNK, cap)
        acc = (q @ rows[r0:r1].to(torch.float32).T).mul_(mult[r0:r1])
        torch.add(acc, add[r0:r1], out=out[:, r0:r1])
    return out


def s8_folded_dot(q_i8: torch.Tensor, rows_i8: torch.Tensor, q_scale: torch.Tensor,
                  mult: torch.Tensor, add: torch.Tensor,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``float(q_i8 @ rows_i8^T) * (q_scale * mult) + add`` -> ``[Q, cap]``.

    The s8 x s8 dot is exact, as the JAX package's int32 dot (an f32 sum is
    exact only while 127^2 * D < 2^24), and the epilogue rounds once
    (``addcmul``), as XLA contracts it.  On the card the dot is
    ``torch._int_mm`` (int32), whose shape rules want more than 16 queries
    and dims and rows in multiples of 8: the queries, and where needed the
    dims and the last chunk's rows, are zero-padded, which leaves the sums
    as they are.  On the CPU it is the f64 dot, exact for these integers.
    Rows go ``ROW_CHUNK`` at a time.
    """
    nq, d = q_i8.shape
    cap = rows_i8.shape[0]
    out = torch.empty((nq, cap), dtype=out_dtype, device=q_i8.device)
    if q_i8.is_cuda:
        d8 = -(-d // 8) * 8
        q_pad = torch.zeros((-(-max(nq, 32) // 8) * 8, d8), dtype=torch.int8,
                            device=q_i8.device)
        q_pad[:nq, :d] = q_i8
    for r0 in range(0, cap, ROW_CHUNK):
        r1 = min(r0 + ROW_CHUNK, cap)
        if q_i8.is_cuda:
            chunk = rows_i8[r0:r1]
            n8 = -(-(r1 - r0) // 8) * 8
            if (n8, d8) != tuple(chunk.shape):
                chunk = torch.nn.functional.pad(chunk, (0, d8 - d, 0, n8 - (r1 - r0)))
            acc = torch._int_mm(q_pad, chunk.T)[:nq, :r1 - r0].float()
        else:
            acc = cuda_search.s8_dot(rows_i8[r0:r1], q_i8)
        out[:, r0:r1] = torch.addcmul(add[r0:r1], acc, q_scale[:, None] * mult[None, r0:r1])
    return out


def _block_candidates(bid: torch.Tensor) -> torch.Tensor:
    """``[Q, s]`` block ids -> ``[Q, s*128]`` doc ids of those blocks."""
    nq, s = bid.shape
    offs = torch.arange(BLOCKMAX_SUB, device=bid.device, dtype=bid.dtype)
    return (bid[:, :, None] * BLOCKMAX_SUB + offs[None, None, :]).reshape(
        nq, s * BLOCKMAX_SUB)


def fused_search(
    embeddings: torch.Tensor,   # [cap, D] pre-normalized rows if cosine
    sqnorms: torch.Tensor,      # [cap] row squared norms (L2 path)
    payloads: torch.Tensor,     # [cap, 8] PAYLOAD_FIELDS order
    queries: torch.Tensor,      # [Q, D]
    n_valid: int,
    eta: Scalar,
    entropy_pref: Scalar,
    k: int = 10,
    normalize: bool = True,     # True: cosine; False: negative squared L2
    kernel_scores: bool = False,
    blockmax_select: bool = False,
    fused_bmax: bool = False,
    kernel_block: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact DEWI search over the full store: ([Q, k] scores, [Q, k] idx).

    Rows at index >= n_valid are masked to -inf before selection.
    ``kernel_scores`` computes stage 1 in the ``scores_matrix`` kernel
    (bf16 query rounding, as ``pallas_scores_matrix``).  ``blockmax_select``
    replaces the flat top-k with the two-pass block max: max of each
    128-doc block, top-k blocks by max, then top-k over the winning blocks'
    scores; the values are exact (the block holding the rank-i doc has max
    >= its score).  ``fused_bmax`` (with both) takes the block maxima from
    the ``bmax`` kernel and re-scores the winning blocks with the same
    bf16-dot math.  ``kernel_block`` is the routing block (tests).
    """
    device = embeddings.device
    q = queries.to(torch.float32).contiguous()
    if normalize:
        q = l2_normalize(q)
    eta_t = f32_scalar(eta, device)
    ep_t = f32_scalar(entropy_pref, device)
    cap, d = embeddings.shape
    nq = q.shape[0]

    one_m_eta = 1.0 - eta_t
    add = eta_t * payloads[:, 0] + ep_t * 0.5 * (payloads[:, 1] + payloads[:, 3])
    ones = torch.ones(cap, dtype=torch.float32, device=device)
    if normalize:
        mult = one_m_eta * ones
    else:
        mult = 2.0 * one_m_eta * ones
        add = add - one_m_eta * sqnorms
    valid = torch.arange(cap, device=device) < n_valid
    add = torch.where(valid, add, torch.full_like(add, NEG_INF))

    sub = BLOCKMAX_SUB
    blockmax_ok = blockmax_select and cap % sub == 0 and cap >= 4 * sub
    nb = cap // sub
    s = min(nb, k)
    l2_const = (one_m_eta * torch.sum(q * q, dim=-1, keepdim=True)
                if not normalize else None)

    use_fused = False
    if fused_bmax and blockmax_ok and kernel_scores:
        bmax_block = kernel_block or cuda_search.BMAX_BLOCK
        use_fused = cap % bmax_block == 0 and bmax_block % sub == 0
    if use_fused:
        bmax = cuda_search.bmax(embeddings, mult, add, q)
        _, bid = torch.topk(bmax, s, dim=1)
        cand = _block_candidates(bid)
        ce = embeddings.view(nb, sub, d)[bid].reshape(nq, s * sub, d)
        cm = mult.view(nb, sub)[bid].reshape(nq, s * sub)
        ca = add.view(nb, sub)[bid].reshape(nq, s * sub)
        sim = torch.einsum("qd,qmd->qm", q.to(torch.bfloat16).float(),
                           ce.to(torch.bfloat16).float())
        adjc = sim * cm + ca
        if l2_const is not None:
            adjc = adjc - l2_const
        vals, pos = torch.topk(adjc, k, dim=1)
        return vals, torch.gather(cand, 1, pos)

    if kernel_scores:
        adj = cuda_search.scores_matrix(embeddings, mult, add, q)
    else:
        adj = folded_dot(q, embeddings, mult, add)
    if l2_const is not None:
        adj = adj - l2_const
    if blockmax_ok:
        adj3 = adj.view(nq, nb, sub)
        bmax = adj3.amax(dim=-1)
        _, bid = torch.topk(bmax, s, dim=1)
        cs = torch.gather(adj3, 1, bid[:, :, None].expand(nq, s, sub))
        cand = _block_candidates(bid)
        vals, pos = torch.topk(cs.reshape(nq, s * sub), k, dim=1)
        return vals, torch.gather(cand, 1, pos)
    return torch.topk(adj, k, dim=1)


def topk_merge(scores: torch.Tensor, indices: torch.Tensor,
               k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard candidates: ([Q, S*k], [Q, S*k] global idx) -> top-k."""
    vals, pos = torch.topk(scores, k, dim=1)
    return vals, torch.gather(indices, 1, pos)


def pairwise_cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Normalized [Na, Nb] cosine similarity matrix (full f32)."""
    return l2_normalize(a) @ l2_normalize(b).T


__all__ = ["l2_normalize", "rerank_scores", "fused_search", "folded_dot", "s8_folded_dot",
           "topk_merge", "pairwise_cosine", "f32_scalar"]
