"""Operations and bytes that the measured work needs, from its shapes.

Bytes: each input byte read once and each output byte written once,
whatever a kernel reads again.  FLOPs: two per multiply-add, real tokens
only; for causal attention only the unmasked half (``T (T + 1) / 2``
scores per head), for the windows of a long document every window's
tokens (the scoring that the configuration states overlaps them).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List

BLOCK_ROWS = 128  # rows per block maximum of the stage-1 kernels


def bmax_s8_bytes(cap: int, dim: int, nq: int) -> int:
    """One ``dewi_bmax_s8`` launch over ``cap`` int8 rows of ``dim`` for
    ``nq`` s8 queries: the corpus, the per-row ``mult``/``add`` (f32), the
    queries and their scales in; the ``[nq, cap / 128]`` f32 maxima out."""
    return cap * dim + 2 * 4 * cap + nq * dim + 4 * nq + 4 * nq * (cap // BLOCK_ROWS)


def bmax_s8_ops(cap: int, dim: int, nq: int) -> int:
    return 2 * cap * dim * nq


def windows(tokens: int, ctx: int) -> List[int]:
    """Token counts of the forwards that score a document of ``tokens``:
    one, or windows of ``ctx`` advancing by ``ctx - ctx // 4``."""
    if tokens <= ctx:
        return [tokens]
    overlap = ctx // 4
    return [min(ctx, tokens - s) for s in range(0, max(tokens - overlap, 1), ctx - overlap)]


def decoder_flops(t: int, d: int, layers: int, ff: int) -> int:
    """A pre-LN causal stack over ``t`` tokens: the q/k/v/out and MLP
    matmuls, and the unmasked half of ``QK^T`` and ``AV``."""
    dense = 2 * t * (4 * d * d + 2 * d * ff)
    attn = 2 * 2 * d * (t * (t + 1) // 2)
    return layers * (dense + attn)


def lm_flops(t: int, c: Dict[str, Any]) -> int:
    """GPT-2 over ``t`` tokens, with the tied vocabulary head."""
    d = c["n_embd"]
    return decoder_flops(t, d, c["n_layer"], c["n_inner"]) + 2 * t * d * c["vocab_size"]


def clip_text_flops(t: int, c: Dict[str, Any]) -> int:
    """The CLIP text tower over ``t`` real tokens and its projection."""
    tc = c["text_config"]
    d = tc["hidden_size"]
    return (decoder_flops(t, d, tc["num_hidden_layers"], tc["intermediate_size"])
            + 2 * d * c["projection_dim"])


def corpus_flops(doc_tokens: Iterable[int], lm: Dict[str, Any], clip: Dict[str, Any],
                 ctx: int) -> int:
    """Forward FLOPs of text documents of ``doc_tokens`` tokens (BOS
    included): the LM over its windows, the CLIP text tower over at most
    its context."""
    cap = clip["text_config"]["max_position_embeddings"]
    total = 0
    for n in doc_tokens:
        total += sum(lm_flops(t, lm) for t in windows(int(n), ctx))
        total += clip_text_flops(min(int(n), cap), clip)
    return total


__all__ = ["bmax_s8_bytes", "bmax_s8_ops", "windows", "decoder_flops", "lm_flops",
           "clip_text_flops", "corpus_flops"]
