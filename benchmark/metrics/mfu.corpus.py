"""Share (%) of the bf16 peak (989 TFLOP/s) that the window's forward
passes reach: the FLOPs the processed documents need through GPT-2 and
the CLIP text tower (``corpus_flops``: real tokens only, not padding;
the masked half of causal attention not counted) over the sum of the
``process_corpus`` + ``build_index_corpus`` calls' times."""

from harness.peaks import BF16_FLOPS
from harness.roofline import corpus_flops


def read(run):
    busy, toks = run.counts.get("busy_s"), run.values.get("doc_tokens")
    if not busy or not toks:
        return None
    f = corpus_flops(toks, run.shapes["lm"], run.shapes["clip"], run.shapes["ctx"])
    return 100.0 * f / busy / BF16_FLOPS
