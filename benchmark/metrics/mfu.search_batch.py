"""Share (%) of the int8 tensor-core peak (1,979 TOP/s) that the window's
``search_batch`` calls reach: the stage-1 operations a call needs
(``2 * queries * capacity * dim``: every query against every stored row;
the refine's few f32 FLOPs are left out) over the window's length."""

from harness.peaks import INT8_OPS
from harness.roofline import bmax_s8_ops


def read(run):
    q, sh = run.counts.get("queries"), run.shapes
    if not q or run.window_s <= 0:
        return None
    return 100.0 * bmax_s8_ops(sh["capacity"], sh["dim"], q) / run.window_s / INT8_OPS
