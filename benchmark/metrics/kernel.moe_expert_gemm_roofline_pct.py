"""Share (%) of their roofline that the expert GEMMs reach in the traced
shard: ``max(FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s)`` over the summed
device time of the kernels that compute them.  FLOPs are
``routed_row_flops`` per routed row (``moe.routed_rows``, the program's
counter); bytes are the expert weights once a layer-forward
(``moe.layer_forwards``) and each routed row's input, gate/up output,
activation and output (``expert_gemm_bytes``).  The kernels are the
grouped GEMMs, found by name in the device trace (``torch._grouped_mm``'s
CUTLASS kernel on the H100, ``cutlass::device_kernel<...GemmUniversal<
cutlass::gemm::GroupProblemShape...``, or a kernel whose name says it is
grouped).
A program or trace without them reads None."""

import re

from harness.moonlight import expert_gemm_bytes, routed_row_flops
from harness.peaks import BF16_FLOPS, HBM_BYTES_PER_S

NAME = re.compile(r"GroupProb|grouped", re.IGNORECASE)


def value(trace, stats, moonlight):
    c = (stats or {}).get("counters", {})
    rows, forwards = c.get("moe.routed_rows"), c.get("moe.layer_forwards")
    if trace is None or not rows or not forwards:
        return None
    secs = sum(s for name, (s, _) in trace.ops_by_name.items() if NAME.search(name))
    if secs <= 0:
        return None
    flops = rows * routed_row_flops(moonlight)
    need = max(flops / BF16_FLOPS, expert_gemm_bytes(rows, forwards, moonlight) / HBM_BYTES_PER_S)
    return 100.0 * need / secs


def read(run):
    try:
        from dewi_tpu_torch.utils.profiling import trace_stats
    except ImportError:
        return None
    if "moonlight" not in run.shapes:
        return None
    return value(run.trace, trace_stats(), run.shapes["moonlight"])
