"""Quantized two-stage search: int8 / int4 corpus scan + exact f32 refine.

Counterpart of ``dewi_tpu/ops/quantized.py``:

* stage 1 streams the quantized corpus with the DEWI re-rank, the dequant
  scale and the validity mask folded into per-row ``mult``/``add``, and
  picks candidates (the block max of 128-doc blocks, or a flat top-m);
* stage 2 gathers the candidates' f32 rows and re-ranks them exactly.

Stage 1 runs in the CUDA kernels of ``cuda_search`` where the JAX package
runs its Pallas kernels, through the same routing gates line for line
(the corpus-major ``*_t`` kernels included, taken where the stream block
is not a multiple of 16384 rows), else in plain PyTorch where it ran XLA.
One routing difference, which changes no result of the TPU route: the
TPU's ``lax.approx_max_k`` candidate select becomes an exact
``torch.topk``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_search
from .cuda_search import BLOCKMAX_SUB
from .similarity import NEG_INF, Scalar, f32_scalar, folded_dot, l2_normalize, s8_folded_dot

# Above this query count the blockmax refine gathers the winning blocks'
# stage-1 SCORES, takes top-m within them and row-gathers only m docs,
# instead of gathering s*128 rows per query; the fused route instead runs
# the small-Q pipeline per group of this many queries.
BLOCKMAX_REFINE_MAX_Q = 32


def _f32_reciprocal(c: float) -> torch.Tensor:
    """XLA rewrites ``x / const`` as ``x * f32(1/const)``; the scales do the
    same so that they match the JAX package bit for bit."""
    return torch.tensor(1.0 / c, dtype=torch.float32)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization: (int8 values, f32 scales).

    ``x ~= values * scales[:, None]``; zero rows get scale 0 and quantize to
    0.  ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    x = x.to(torch.float32)
    absmax = torch.amax(torch.abs(x), dim=-1)
    scale = absmax * _f32_reciprocal(127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe[:, None]), -127, 127).to(torch.int8)
    return q, scale


def quantize_rows_int4(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int4 quantization, nibble-packed 2 per byte.

    Returns ``(packed [N, D/2] int8, scales [N] f32)`` with values in
    [-7, 7] (scale = absmax/7).  Byte ``j`` is ``hi*16 + (lo+8)`` in int8
    arithmetic, hi = dim j and lo = dim j + D/2: the kernels' contract.
    """
    x = x.to(torch.float32)
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"int4 packing needs an even dim, got {d}")
    absmax = torch.amax(torch.abs(x), dim=-1)
    scale = absmax * _f32_reciprocal(7.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe[:, None]), -7, 7).to(torch.int8)
    hi = q[:, : d // 2]
    lo = q[:, d // 2:]
    packed = (hi * 16 + (lo + 8)).to(torch.int8)
    return packed, scale


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_rows_int4`'s packing: ``[N, D] int8``."""
    hi = packed >> 4          # int8 arithmetic shift keeps the sign
    lo = (packed & 15) - 8
    return torch.cat([hi, lo], dim=-1).to(torch.int8)


def quantized_search(
    emb_i8: torch.Tensor,    # [cap, D] int8 ([cap, D/2] if int4_packed)
    scales: torch.Tensor,    # [cap] f32 row scales
    emb_f32: torch.Tensor,   # [cap, D] refine rows (f32 or bf16)
    sqnorms: torch.Tensor,   # [cap] f32 row squared norms (L2 path)
    payloads: torch.Tensor,  # [cap, 8]
    queries: torch.Tensor,   # [Q, D]
    n_valid: int,
    eta: Scalar,
    entropy_pref: Scalar,
    k: int,
    m: int,
    normalize: bool = True,
    kernel_stage1: bool = False,
    kernel_block: int = 0,
    int8_queries: bool = False,
    bf16_scores: bool = False,
    blockmax_select: bool = False,
    fused_bmax: bool = False,
    int4_packed: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-stage quantized -> f32 search: ([Q, k] scores, [Q, k] idx).

    Flags as in the JAX package.  ``kernel_stage1`` routes stage 1 through
    the CUDA kernels (the JAX ``pallas_stage1``); ``blockmax_select`` picks
    the top-s 128-doc blocks by stage-1 max with a margin of k+2 blocks
    (2(k+2) on the int4 grid); ``fused_bmax`` takes the block maxima
    straight from the fused ``bmax``/``bmax_s8``/``bmax_s4`` kernel so no ``[Q, cap]``
    matrix is written, and runs batches above 32 queries in 32-query
    groups.  ``int4_packed`` reads ``emb_i8`` as the nibble-packed corpus
    (the index keeps int4 packed, so the JAX ``int4_values`` layout has no
    counterpart here).  ``int8_queries`` quantizes the queries to s8 and
    takes the s8 kernels (``bmax_s8``, ``scores_matrix_s8``); without a
    kernel its exact integer dot runs in plain PyTorch.  A fused
    ``kernel_block`` that is not a multiple of 16384 rows (and not the
    whole corpus) takes the corpus-major kernels (``bmax_t``,
    ``bmax_s8_t``), as the JAX package does.
    """
    device = emb_i8.device
    int4_grid = int4_packed  # the wider margins follow the values, not the layout
    q = queries.to(torch.float32).contiguous()
    if normalize:
        q = l2_normalize(q)
    eta_t = f32_scalar(eta, device)
    ep_t = f32_scalar(entropy_pref, device)

    # Fold: adj = acc * mult + add, with the dequant scale, (1-eta), the
    # re-rank, the L2 row norm and the validity mask in mult/add.  The L2
    # per-query constant -(1-eta)|q|^2 is omitted: stage-1 values are only
    # used for selection, and stage 2 recomputes the scores exactly.
    ent = 0.5 * (payloads[:, 1] + payloads[:, 3])
    one_m_eta = 1.0 - eta_t
    add = eta_t * payloads[:, 0] + ep_t * ent
    if normalize:
        mult = one_m_eta * scales
    else:
        mult = 2.0 * one_m_eta * scales
        add = add - one_m_eta * sqnorms
    nq, cap = q.shape[0], emb_i8.shape[0]
    blockmax_ok = (blockmax_select and cap % BLOCKMAX_SUB == 0
                   and cap >= 4 * BLOCKMAX_SUB)
    use_fused = False
    bmax_block = 0
    if fused_bmax and blockmax_ok and kernel_stage1:
        bmax_block = kernel_block or cuda_search.BMAX_BLOCK
        use_fused = (cap % bmax_block == 0 and bmax_block % BLOCKMAX_SUB == 0
                     and (bmax_block // BLOCKMAX_SUB) % 8 == 0)
    # The JAX package's layout gate: a stream block that is not a multiple
    # of 128 sub-blocks (and not the whole corpus) writes its maxima
    # corpus-major.
    t_layout = (bmax_block // BLOCKMAX_SUB) % BLOCKMAX_SUB != 0 and bmax_block != cap

    if int4_packed:
        # The int4 kernels take int8 queries and are query-major only; any
        # other configuration unpacks the nibbles and rides the int8 paths
        # below (a corpus-major fused block then runs unfused, as in JAX).
        s4_t_layout = use_fused and t_layout
        if not int8_queries or s4_t_layout:
            use_fused = False
        if not (kernel_stage1 and int8_queries) or s4_t_layout:
            emb_i8 = unpack_int4(emb_i8)
            int4_packed = False

    if use_fused and nq > BLOCKMAX_REFINE_MAX_Q:
        # Chunk into 32-query groups, the last padded with q[0], and run
        # the small-Q fused pipeline per group (the JAX lax.map dispatch).
        g = BLOCKMAX_REFINE_MAX_Q
        n_groups = -(-nq // g)
        pad_rows = n_groups * g - nq
        qpad = torch.cat([q, q[:1].expand(pad_rows, q.shape[1])]) if pad_rows else q
        outs = [
            quantized_search(
                emb_i8, scales, emb_f32, sqnorms, payloads,
                qpad[i * g:(i + 1) * g], n_valid, eta_t, ep_t, k=k, m=m,
                normalize=normalize, kernel_stage1=True,
                kernel_block=kernel_block, int8_queries=int8_queries,
                bf16_scores=bf16_scores, blockmax_select=True,
                fused_bmax=True, int4_packed=int4_packed,
            )
            for i in range(n_groups)
        ]
        return (torch.cat([o[0] for o in outs])[:nq],
                torch.cat([o[1] for o in outs])[:nq])

    valid = torch.arange(cap, device=device) < n_valid
    if bf16_scores and not use_fused:
        # Centre the additive term on its valid-row mean (a per-query
        # invariant shift) so bf16 keeps the small score differences.
        denom = max(float(n_valid), 1.0)
        add = add - torch.sum(torch.where(valid, add, torch.zeros_like(add))) / denom
    add = torch.where(valid, add, torch.full_like(add, NEG_INF))
    out_dtype = torch.bfloat16 if bf16_scores else torch.float32

    adj1: Optional[torch.Tensor] = None
    bmax: Optional[torch.Tensor] = None
    if use_fused:
        if int4_packed:
            q_i8, q_scale = quantize_rows(q)
            bmax = cuda_search.bmax_s4(emb_i8, mult, add, q_i8, q_scale)
        elif int8_queries:
            q_i8, q_scale = quantize_rows(q)
            if t_layout:
                bmax = cuda_search.bmax_s8_t(emb_i8, mult, add, q_i8, q_scale).T
            else:
                bmax = cuda_search.bmax_s8(emb_i8, mult, add, q_i8, q_scale)
        elif t_layout:
            bmax = cuda_search.bmax_t(emb_i8, mult, add, q).T
        else:
            bmax = cuda_search.bmax(emb_i8, mult, add, q)
    elif kernel_stage1 and int8_queries:
        q_i8, q_scale = quantize_rows(q)
        kernel = cuda_search.scores_matrix_s4 if int4_packed else cuda_search.scores_matrix_s8
        adj1 = kernel(emb_i8, mult, add, q_i8, q_scale, out_dtype=out_dtype)
    elif kernel_stage1:
        adj1 = cuda_search.scores_matrix(emb_i8, mult, add, q, out_dtype=out_dtype)
    elif int8_queries:
        # The s8 x s8 dot, exact as JAX's int32 accumulator.
        q_i8, q_scale = quantize_rows(q)
        adj1 = s8_folded_dot(q_i8, emb_i8, q_scale, mult, add, out_dtype)
    else:
        adj1 = folded_dot(q.to(torch.bfloat16).float(), emb_i8, mult, add, out_dtype)

    d = emb_f32.shape[1]
    if blockmax_ok:
        nb = cap // BLOCKMAX_SUB
        margin = 2 * (k + 2) if int4_grid else k + 2
        s = min(nb, max(margin, -(-m // BLOCKMAX_SUB)))
        if bmax is None:
            assert adj1 is not None
            bmax = adj1.view(nq, nb, BLOCKMAX_SUB).amax(dim=-1)
        _, bid = torch.topk(bmax, s, dim=1)
        offs = torch.arange(BLOCKMAX_SUB, device=device, dtype=bid.dtype)
        cand = (bid[:, :, None] * BLOCKMAX_SUB + offs).reshape(nq, s * BLOCKMAX_SUB)
        if nq > BLOCKMAX_REFINE_MAX_Q:
            assert adj1 is not None
            cs = torch.gather(
                adj1.view(nq, nb, BLOCKMAX_SUB), 1,
                bid[:, :, None].expand(nq, s, BLOCKMAX_SUB),
            ).reshape(nq, s * BLOCKMAX_SUB).float()
            _, pos1 = torch.topk(cs, m, dim=1)
            cand = torch.gather(cand, 1, pos1)
            ce, cp, csq = emb_f32[cand], payloads[cand], sqnorms[cand]
        else:
            # Block-granular gather: s contiguous 128-row blocks per query.
            ce = emb_f32.view(nb, BLOCKMAX_SUB, d)[bid].reshape(nq, s * BLOCKMAX_SUB, d)
            cp = payloads.view(nb, BLOCKMAX_SUB, -1)[bid].reshape(
                nq, s * BLOCKMAX_SUB, payloads.shape[1])
            csq = sqnorms.view(nb, BLOCKMAX_SUB)[bid].reshape(nq, -1)
    else:
        assert adj1 is not None
        _, cand = torch.topk(adj1, m, dim=1)
        ce, cp, csq = emb_f32[cand], payloads[cand], sqnorms[cand]

    # Stage 2: exact f32 over the gathered candidates only.
    sim2 = torch.einsum("qd,qmd->qm", q, ce.to(torch.float32))
    if not normalize:
        sim2 = 2.0 * sim2 - csq - torch.sum(q * q, dim=-1, keepdim=True)
    adj2 = (one_m_eta * sim2 + eta_t * cp[..., 0]
            + ep_t * 0.5 * (cp[..., 1] + cp[..., 3]))
    adj2 = torch.where(cand < n_valid, adj2, torch.full_like(adj2, NEG_INF))
    scores, pos = torch.topk(adj2, k, dim=1)
    return scores, torch.gather(cand, 1, pos)


__all__ = [
    "BLOCKMAX_REFINE_MAX_Q",
    "quantize_rows",
    "quantize_rows_int4",
    "unpack_int4",
    "quantized_search",
]
