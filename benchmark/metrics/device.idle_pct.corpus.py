"""Share (%) of the traced window in which no operation ran on the
device: 100 * (1 - busy / window), the busy time being the union of the
device's operations in ``torch.profiler``'s trace."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
