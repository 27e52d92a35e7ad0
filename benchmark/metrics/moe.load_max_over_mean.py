"""The busiest expert's load over the mean expert's in the traced shard:
``n_routed_experts * moe.busiest_expert_rows / moe.routed_rows``, the
program's own counters (``dewi_tpu_torch.utils.profiling.trace_stats``;
the busiest expert's rows are summed over the MoE layer-forwards).  1 is an
even spread; a program without those counters reads None.

It reads the routing that the seeded weights make (``harness/moonlight.py``),
not a choice of the program: a correct program routes as the model does,
so only another draw of the weights moves it.  It says how uneven the
expert GEMMs' groups are, which ``kernel.moe_expert_gemm_roofline_pct``
depends on."""


def value(stats, experts):
    c = (stats or {}).get("counters", {})
    rows, busiest = c.get("moe.routed_rows"), c.get("moe.busiest_expert_rows")
    if not rows or busiest is None:
        return None
    return experts * busiest / rows


def read(run):
    try:
        from dewi_tpu_torch.utils.profiling import trace_stats
    except ImportError:
        return None
    shapes = run.shapes.get("moonlight")
    return None if not shapes else value(trace_stats(), shapes["n_routed_experts"])
