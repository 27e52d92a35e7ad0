"""Share (%) of the traced shard's program time spent in the text-entropy
stage: 100 * the host seconds of the span ``dewi.text_entropy`` over those
of ``dewi.process_corpus`` and ``dewi.build_index_corpus``, the program's
own spans (``dewi_tpu_torch.utils.profiling.trace_stats``), which record
only while the profiler does.  A program without those spans reads None."""


def value(stats):
    s = (stats or {}).get("spans", {})
    names = ("dewi.text_entropy", "dewi.process_corpus", "dewi.build_index_corpus")
    if not all(n in s for n in names):
        return None
    whole = s["dewi.process_corpus"]["total_s"] + s["dewi.build_index_corpus"]["total_s"]
    return None if whole <= 0 else 100.0 * s["dewi.text_entropy"]["total_s"] / whole


def read(run):
    try:
        from dewi_tpu_torch.utils.profiling import trace_stats
    except ImportError:
        return None
    return value(trace_stats())
