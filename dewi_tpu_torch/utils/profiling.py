"""Device traces for ``process``.

Counterpart of ``dewi_tpu/utils/profiling.py``'s ``xla_trace``, and for now
only that: :func:`torch_trace` runs a block under ``torch.profiler`` (the
CPU and, where a CUDA device is present, the card) and writes a Chrome
trace into ``trace_dir``.  The rest of that module (timers, metrics
summaries) comes with the multi-device slice.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Any, Iterator, Optional

import torch


@contextlib.contextmanager
def torch_trace(trace_dir: Optional[str]) -> Iterator[Any]:
    """Profile the block and write ``<trace_dir>/trace_<unix ms>.json``;
    a no-op when ``trace_dir`` is None."""
    if trace_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / f"trace_{int(time.time() * 1e3)}.json"))


__all__ = ["torch_trace"]
