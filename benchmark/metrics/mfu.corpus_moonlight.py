"""Share (%) of the bf16 peak (989 TFLOP/s) that the traced shard's
forwards reach: the model FLOPs of Moonlight over its real tokens
(``text.tokens``, the causal pairs ``text.attention_pairs`` and the routed
rows ``moe.routed_rows``, the program's own counters; ``forward_flops``)
and of the CLIP text tower over the shard's documents, as ``mfu.corpus``
counts it, over the host seconds of the spans ``dewi.process_corpus`` and
``dewi.build_index_corpus``, which end once the card is done (the results
are copied back).  A program without those counters reads None."""

from harness.moonlight import forward_flops
from harness.peaks import BF16_FLOPS
from harness.roofline import clip_text_flops


def value(stats, moonlight, clip, doc_tokens):
    c, s = (stats or {}).get("counters", {}), (stats or {}).get("spans", {})
    need = ("text.tokens", "text.attention_pairs", "moe.routed_rows")
    if not all(c.get(n) for n in need) or not all(
            n in s for n in ("dewi.process_corpus", "dewi.build_index_corpus")):
        return None
    secs = s["dewi.process_corpus"]["total_s"] + s["dewi.build_index_corpus"]["total_s"]
    cap = clip["text_config"]["max_position_embeddings"]
    f = forward_flops(c["text.tokens"], c["text.attention_pairs"], c["moe.routed_rows"],
                      moonlight)
    f += sum(clip_text_flops(min(int(n), cap), clip) for n in doc_tokens)
    return None if secs <= 0 else 100.0 * f / secs / BF16_FLOPS


def read(run):
    try:
        from dewi_tpu_torch.utils.profiling import trace_stats
    except ImportError:
        return None
    toks = run.values.get("traced_doc_tokens")
    if not toks or "moonlight" not in run.shapes:
        return None
    return value(trace_stats(), run.shapes["moonlight"], run.shapes["clip"], toks)
