"""Utilities of the port: the timing and tracing harness among them."""

from .profiling import Timer, summarize, torch_trace, write_metrics

__all__ = ["Timer", "torch_trace", "summarize", "write_metrics"]
