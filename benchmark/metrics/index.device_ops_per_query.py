"""Device operations (kernel launches, copies and fills the host issued,
matched to the trace by correlation id) per query of the traced
``search_batch`` calls."""


def read(run):
    t, q = run.trace, run.counts.get("traced_queries")
    if t is None or not q or not t.host_ops:
        return None
    return t.host_ops / q
