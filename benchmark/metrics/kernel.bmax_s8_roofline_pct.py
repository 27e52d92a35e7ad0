"""Share (%) of its bound that ``dewi_bmax_s8`` reaches in the traced
calls: the bytes its launches need (``bmax_s8_bytes``: each input byte
read once, each output byte written once) over 3.35 TB/s, summed, over
those launches' summed device time.  The s8-query block-max kernel is
``stage1_mma_kernel<3, 1, NT>`` (kind kS8, mode kBlockMax)."""

import re

from harness.peaks import HBM_BYTES_PER_S
from harness.roofline import bmax_s8_bytes

NAME = re.compile(r"stage1_mma_kernel<3, ?1, ?\d+>")


def read(run):
    t = run.trace
    if t is None:
        return None
    launches, secs = 0, 0.0
    for name, (s, c) in t.ops_by_name.items():
        if NAME.search(name):
            launches, secs = launches + c, secs + s
    if not launches or secs <= 0:
        return None
    sh = run.shapes
    groups = -(-sh["queries_per_call"] // sh["group"])
    rows = groups * sh["group"] * run.counts["traced_calls"]
    if rows % launches:
        return None
    need = launches * bmax_s8_bytes(sh["capacity"], sh["dim"], rows // launches)
    return 100.0 * need / HBM_BYTES_PER_S / secs
