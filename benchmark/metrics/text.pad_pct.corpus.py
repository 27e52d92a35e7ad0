"""Share (%) of the token slots that the LM's traced forwards carried and
that were padding: 100 * (1 - ``text.tokens`` / ``text.token_slots``), the
program's own counters (``dewi_tpu_torch.utils.profiling.trace_stats``),
which count only while the profiler records: the traced shard.  A program
without those counters reads None."""


def value(stats):
    c = (stats or {}).get("counters", {})
    slots, tokens = c.get("text.token_slots"), c.get("text.tokens")
    if not slots or tokens is None:
        return None
    return 100.0 * (1.0 - tokens / slots)


def read(run):
    try:
        from dewi_tpu_torch.utils.profiling import trace_stats
    except ImportError:
        return None
    return value(trace_stats())
