"""Sequences (whole documents and long documents' windows) that the LM's
traced forwards carried, a forward: ``text.sequences`` / ``text.forwards``,
the program's own counters (``dewi_tpu_torch.utils.profiling.trace_stats``),
which count only while the profiler records: the traced shard.  It reads
how many sequences a flat forward packs; a program without the packed
route has no ``text.sequences`` and reads None."""


def value(stats):
    c = (stats or {}).get("counters", {})
    seqs, forwards = c.get("text.sequences"), c.get("text.forwards")
    if not seqs or not forwards:
        return None
    return seqs / forwards


def read(run):
    try:
        from dewi_tpu_torch.utils.profiling import trace_stats
    except ImportError:
        return None
    return value(trace_stats())
