"""Queries of all ``search_batch`` calls completed in the window, results
on the host, over the window's length (host clock)."""


def read(run):
    q = run.counts.get("queries")
    return None if not q or run.window_s <= 0 else q / run.window_s
