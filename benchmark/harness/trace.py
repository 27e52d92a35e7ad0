"""The device trace of a window, from ``torch.profiler``.

A session opens with ``LEAD`` empty kernels: in a process some seconds old
the profiler drops the first device events of a session, so those empty
kernels are dropped in the window's place (the same remedy as the port's
``utils.profiling.launched_kernels``, whose arithmetic is copied here so
that the yardstick stays with the benchmark).  The traced window is the
span of a ``record_function`` range around the body.

What the readers take from a trace:

* ``busy_s``: the union of the device's operations over the window;
* ``host_ops``: the launches, copies and fills the host issued in the window
  (the host's records stay whole where the device's first events are lost);
* ``ops_by_name``: device seconds and launches per operation name;
* ``idle_gaps``: the longest stretches without a device operation, each
  named by the innermost host range that covers its middle.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .common import sync

LEAD = 256
WINDOW_RANGE = "bench.window"
# Host calls that put an operation on a device stream, by name.
HOST_OPS = ("LaunchKernel", "Memcpy", "Memset")
# Host ranges that name nothing the host is doing.
_NOT_ACTIVITY = (WINDOW_RANGE, "ProfilerStep", "Activity Buffer Request")


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    host_ops: int = 0
    ops_by_name: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def device_ops(self, top: int = 10) -> List[List[Any]]:
        rows = sorted(self.ops_by_name.items(), key=lambda kv: -kv[1][0])[:top]
        return [[name, secs] for name, (secs, _) in rows]


def merge_intervals(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted, overlapping ``(start, end)`` spans merged into disjoint ones."""
    out: List[Tuple[int, int]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def clip(spans: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    return [(max(a, lo), min(b, hi)) for a, b in spans if b > lo and a < hi]


def gaps(busy: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The stretches of ``[lo, hi)`` that no merged busy span covers."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."


def _label(mid: int, host: List[Tuple[int, int, str]]) -> str:
    """The innermost host range covering ``mid``; "none" where none does."""
    best: Optional[Tuple[int, str]] = None
    for a, b, name in host:
        if a <= mid < b and (best is None or b - a < best[0]):
            best = (b - a, name)
    return short(best[1], 80) if best else "none"


def analyse(events: List[Any]) -> Trace:
    """A ``Trace`` from ``kineto_results.events()`` of one session."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type() == DeviceType.CPU]
    window = [e for e in cpu if e.name() == WINDOW_RANGE]
    if not window:
        return Trace()
    lo = window[0].start_ns()
    hi = lo + window[0].duration_ns()
    launches = sorted((e for e in cpu if any(op in e.name() for op in HOST_OPS)),
                      key=lambda e: e.start_ns())
    lead = {e.correlation_id() for e in launches[:LEAD]}
    issued = {e.correlation_id() for e in launches[LEAD:] if lo <= e.start_ns() < hi}
    dev = [e for e in events if e.device_type() == DeviceType.CUDA
           and not e.is_user_annotation() and e.correlation_id() not in lead]
    spans = clip([(e.start_ns(), e.start_ns() + e.duration_ns()) for e in dev], lo, hi)
    busy = merge_intervals(spans)
    by_name: Dict[str, Tuple[float, int]] = {}
    for e in dev:
        a, b = max(e.start_ns(), lo), min(e.start_ns() + e.duration_ns(), hi)
        if e.start_ns() >= hi or e.start_ns() + e.duration_ns() < lo:
            continue
        s, c = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (s + max(b - a, 0) / 1e9, c + 1)
    host = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in cpu
            if not any(x in e.name() for x in _NOT_ACTIVITY)]
    idle = sorted(gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:10]
    return Trace(
        window_s=(hi - lo) / 1e9,
        busy_s=sum(b - a for a, b in busy) / 1e9,
        host_ops=len(issued),
        ops_by_name={short(k): v for k, v in by_name.items()},
        idle_gaps=[[_label((a + b) // 2, host), (b - a) / 1e9] for a, b in idle],
    )


class Session:
    """``with Session(device) as s: ... with s.window(): body``: one
    profiled session whose window is the body.  ``trace`` holds the result
    once the session has closed."""

    def __init__(self, device: Any) -> None:
        self.device = device
        self.trace: Optional[Trace] = None
        self._prof: Any = None

    def __enter__(self) -> "Session":
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        sync(self.device)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        if cuda:
            with torch.cuda.device(self.device):
                for _ in range(LEAD):
                    torch.cuda._sleep(0)
        sync(self.device)
        return self

    @contextlib.contextmanager
    def window(self) -> Iterator[None]:
        import torch

        with torch.profiler.record_function(WINDOW_RANGE):
            yield
            sync(self.device)

    def __exit__(self, *exc: Any) -> None:
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = analyse(list(self._prof.profiler.kineto_results.events()))


__all__ = ["LEAD", "Session", "Trace", "analyse", "merge_intervals", "gaps", "clip"]
