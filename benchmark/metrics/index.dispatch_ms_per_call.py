"""Host milliseconds per ``search_batch`` call of the traced calls: the
host seconds of the span ``dewi.search_batch`` over its count, the
program's own span (``dewi_tpu_torch.utils.profiling.trace_stats``), which
records only while the profiler does.  The span does not wait for the
device, so this is the host's time to launch a call's work (under the
profiler), and where the card's queue fills, the wait for room in it.  A
program without the span reads None."""


def value(stats):
    rec = (stats or {}).get("spans", {}).get("dewi.search_batch")
    if not rec or not rec.get("count"):
        return None
    return 1e3 * rec["total_s"] / rec["count"]


def read(run):
    try:
        from dewi_tpu_torch.utils.profiling import trace_stats
    except ImportError:
        return None
    return value(trace_stats())
