"""Timing and tracing harness.

Counterpart of ``dewi_tpu/utils/profiling.py``:

* :class:`Timer`: named host-clock spans that end after the device has
  finished the span's results (``torch.cuda.synchronize`` where the
  reference calls ``jax.block_until_ready``), with percentile summaries;
* :func:`torch_trace`: ``torch.profiler`` over a block, written as a Chrome
  trace (the counterpart of ``xla_trace``);
* :func:`summarize` and :func:`write_metrics`: the ``metrics.json`` shape
  of the reference (docs/s, QPS, latency percentiles);
* :func:`span` and :func:`count`: the program's own stage spans and
  counters, recorded only while a ``torch.profiler`` session records in
  the calling thread (the benchmark's ``--trace 1`` stretch, or
  ``runtime.profile``); :func:`trace_stats` reads them.

Helpers of the ``scripts/torch_*`` profilers: :func:`device_name` and
:func:`card_line` (what a result names its device by), :func:`chained_ms`
(ms per call of back-to-back calls between two CUDA events) and
:func:`launched_kernels` (the device operations of one call, from
``torch.profiler``, checked against the host's launches).
"""

from __future__ import annotations

import contextlib
import functools
import json
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


def _cuda_device_of(result: Any) -> Optional[torch.device]:
    """The device of the first CUDA tensor in ``result`` (a tensor, or
    lists and tuples of them), else None."""
    if isinstance(result, torch.Tensor):
        return result.device if result.is_cuda else None
    if isinstance(result, (list, tuple)):
        for item in result:
            dev = _cuda_device_of(item)
            if dev is not None:
                return dev
    return None


class Timer:
    """Named wall-clock spans with percentile summaries.

    ``result=`` is read when the span ends, so a list filled inside the
    block works:

    >>> t = Timer()
    >>> out = []
    >>> with t.span("search", result=out):
    ...     out.append(index.search_batch(q))
    >>> t.percentile("search", 50)
    """

    def __init__(self) -> None:
        self.spans: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str, result: Any = None) -> Iterator[None]:
        """Time a block.  Where ``result`` is (or holds) a CUDA tensor, the
        span ends after ``torch.cuda.synchronize`` of its device; a CPU
        tensor or None ends it at once."""
        start = time.perf_counter()
        try:
            yield
        finally:
            dev = _cuda_device_of(result)
            if dev is not None:
                torch.cuda.synchronize(dev)
            self.spans.setdefault(name, []).append(
                (time.perf_counter() - start) * 1e3
            )

    def record(self, name: str, millis: float) -> None:
        self.spans.setdefault(name, []).append(float(millis))

    def percentile(self, name: str, q: float) -> float:
        return float(np.percentile(self.spans[name], q))

    def mean(self, name: str) -> float:
        return float(np.mean(self.spans[name]))

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, vals in self.spans.items():
            out[name] = {
                "count": len(vals),
                "mean_ms": round(float(np.mean(vals)), 4),
                "p50_ms": round(float(np.percentile(vals, 50)), 4),
                "p99_ms": round(float(np.percentile(vals, 99)), 4),
                "total_ms": round(float(np.sum(vals)), 2),
            }
        return out


# Whether a torch.profiler session records in this thread: the gate of
# ``span`` and ``count``, about a tenth of a microsecond.
tracing: Callable[[], bool] = torch._C._autograd._profiler_enabled


class _Registry:
    """Per span name: count, total and self host seconds, and the seconds
    spent under each enclosing span; per counter name: a sum.  Each thread
    keeps its own stack of open spans."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.local = threading.local()
        self.spans: Dict[str, Dict[str, Any]] = {}
        self.counters: Dict[str, int] = {}

    def stack(self) -> List["_Span"]:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def add_span(self, name: str, parent: Optional[str], total: float, own: float) -> None:
        with self.lock:
            rec = self.spans.get(name)
            if rec is None:
                rec = self.spans[name] = {"count": 0, "total_s": 0.0, "self_s": 0.0,
                                          "parents": {}}
            rec["count"] += 1
            rec["total_s"] += total
            rec["self_s"] += own
            rec["parents"][parent] = rec["parents"].get(parent, 0.0) + total

    def add_count(self, name: str, n: int) -> None:
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + int(n)


_REGISTRY = _Registry()


class _Span:
    """An open span: a ``record_function`` range in the trace, and its
    host seconds, less those of its child spans, into the registry."""

    __slots__ = ("name", "parent", "child_s", "start", "range")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> None:
        stack = _REGISTRY.stack()
        self.parent = stack[-1] if stack else None
        self.child_s = 0.0
        stack.append(self)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.start = time.perf_counter()

    def __exit__(self, *exc: Any) -> None:
        total = time.perf_counter() - self.start
        self.range.__exit__(*exc)
        _REGISTRY.stack().pop()
        parent = self.parent
        if parent is not None:
            parent.child_s += total
        _REGISTRY.add_span(self.name, parent.name if parent is not None else None,
                           total, total - self.child_s)


class _Off:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: Any) -> None:
        return None


_OFF = _Off()


def span(name: str) -> Any:
    """``with span(name):`` a stage of the program.  While ``tracing()``,
    a ``record_function`` range of that name in the profiler's trace (on
    the clock of the device's operations) and host seconds in the
    registry; else nothing.  Never synchronises the device."""
    if not tracing():
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while ``tracing()``."""
    if tracing():
        _REGISTRY.add_count(name, n)


def trace_stats() -> Dict[str, Any]:
    """A snapshot of the registry: ``{"spans": {name: {"count", "total_s",
    "self_s", "parents": {enclosing span name or None: total_s under
    it}}}, "counters": {name: sum}}``.  ``self_s`` is ``total_s`` less
    the time the span's children cover."""
    with _REGISTRY.lock:
        spans = {k: dict(v, parents=dict(v["parents"])) for k, v in _REGISTRY.spans.items()}
        return {"spans": spans, "counters": dict(_REGISTRY.counters)}


def reset_trace_stats() -> None:
    """Empty the registry (the open spans of every thread still close
    into it)."""
    with _REGISTRY.lock:
        _REGISTRY.spans.clear()
        _REGISTRY.counters.clear()


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


def summarize(
    timer: Timer,
    n_docs: int,
    n_queries: int,
    build_span: str = "build",
    query_span: str = "query",
    extra: Optional[dict] = None,
) -> dict:
    """metrics.json shape parity with reference profile_index.py:288-291."""
    metrics: dict = {"n_docs": n_docs, "n_queries": n_queries}
    if build_span in timer.spans:
        build_s = timer.mean(build_span) / 1e3
        metrics["build_seconds"] = round(build_s, 3)
        metrics["docs_per_sec"] = round(n_docs / max(build_s, 1e-9), 1)
    if query_span in timer.spans:
        metrics["mean_latency_ms"] = round(timer.mean(query_span), 4)
        metrics["p50_latency_ms"] = round(timer.percentile(query_span, 50), 4)
        metrics["p99_latency_ms"] = round(timer.percentile(query_span, 99), 4)
        total_s = sum(timer.spans[query_span]) / 1e3
        metrics["queries_per_sec"] = round(
            len(timer.spans[query_span]) / max(total_s, 1e-9), 1
        )
    if extra:
        metrics.update(extra)
    return metrics


def write_metrics(metrics: dict, path: Any) -> None:
    Path(path).write_text(json.dumps(metrics, indent=2), encoding="utf-8")


def device_name(device: torch.device) -> str:
    """``torch.cuda.get_device_name`` of a CUDA device, else its type."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (a
    card below its 700 W limit runs slower under load), or "unknown"."""
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    lines = proc.stdout.strip().splitlines()
    return lines[0] if proc.returncode == 0 and lines else "unknown"


@functools.lru_cache(maxsize=None)
def _sleep_cycles_per_ms(index: int) -> float:
    """Clock cycles of ``torch.cuda._sleep`` per ms on CUDA device ``index``."""
    with torch.cuda.device(index):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        cycles = 20_000_000
        torch.cuda._sleep(cycles)  # the clock ramps up under load
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        b.synchronize()
        return cycles / a.elapsed_time(b)


def chained_ms(fn: Callable[[], Any], device: torch.device, chain: int,
               reps: int) -> Tuple[List[float], float]:
    """ms per call of ``fn`` in windows of ``chain`` back-to-back calls:
    ``(one value per window, the host's ms to queue one call)``.

    On a CUDA device a window lies between two CUDA events behind a sleep
    kernel that outlasts the time the host takes to queue the window (taken
    from one window on the host clock first), so the events bracket the
    card's work and not the host's launch rate, as a loop of the calls in
    one dispatch would.  The host's pace comes back where a call waits for
    the card (a blocking copy) or a window holds more launches than the
    card queues (keep ``chain`` x launches a call within a few hundred).
    On the CPU a window is the host clock.  Call ``fn`` once before to
    warm it up.
    """
    def host_window() -> float:
        t = time.perf_counter()
        for _ in range(chain):
            fn()
        return (time.perf_counter() - t) * 1e3 / chain

    host_ms = host_window()
    if device.type != "cuda":
        return [host_ms] + [host_window() for _ in range(reps - 1)], host_ms
    torch.cuda.synchronize(device)
    lead = int((1.5 * host_ms * chain + 1.0) * _sleep_cycles_per_ms(device.index or 0))
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(lead)
        a.record()
        for _ in range(chain):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / chain)
    return out, host_ms


# Host calls that put an operation on a device stream, by name.
_HOST_OPS = ("LaunchKernel", "Memcpy", "Memset")
# Empty kernels that open a profiled session, at first and at most.
_LEAD, _MAX_LEAD = 256, 4096


def launched_kernels(fn: Callable[[], Any], device: torch.device) -> Dict[str, Any]:
    """The device operations of one call of ``fn``, from ``torch.profiler``:
    ``kernels`` (``{name: launches}``), ``device_ms`` (their summed device
    time), ``ops`` (the launches, copies and fills the host issued),
    ``complete`` (each of those shows on the device), ``lead_lost`` and
    ``calls`` (how often ``fn`` ran).  On the CPU ``{}``, "not measured",
    0, None, 0 and 0, without a call.

    In a process some minutes old the profiler drops the first device
    events of a session (tens, more as the process ages, now and then
    hundreds) while it keeps the host's launch records
    (``scripts/torch_profiler_drift.py`` counts them).  So ``_LEAD`` empty
    sleep kernels open the session to be dropped in ``fn``'s place;
    ``complete`` matches the host's calls after them to the device's
    events by correlation id, and ``lead_lost`` counts the lead kernels
    that went missing.  Where ``fn``'s events are still incomplete, ``fn``
    runs again behind four times the lead, up to ``_MAX_LEAD``."""
    if device.type != "cuda":
        return {"kernels": {}, "device_ms": "not measured", "ops": 0, "complete": None,
                "lead_lost": 0, "calls": 0}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lead, calls = _LEAD, 0
    while True:
        calls += 1
        torch.cuda.synchronize(device)
        with torch.cuda.device(device):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(lead):
                    torch.cuda._sleep(0)
                fn()
                torch.cuda.synchronize(device)
        events = list(prof.profiler.kineto_results.events())
        host = sorted((e for e in events if e.device_type() == DeviceType.CPU
                       and any(op in e.name() for op in _HOST_OPS)),
                      key=lambda e: e.start_ns())
        leading = {e.correlation_id() for e in host[:lead]}
        issued = {e.correlation_id() for e in host[lead:]}
        dev = [e for e in events if e.device_type() == DeviceType.CUDA
               and not e.is_user_annotation()]
        seen = {e.correlation_id() for e in dev}
        dev = [e for e in dev if e.correlation_id() not in leading]
        complete = issued <= seen
        if complete or lead >= _MAX_LEAD:
            break
        lead = min(4 * lead, _MAX_LEAD)
    kernels: Dict[str, int] = {}
    for e in dev:
        kernels[e.name()] = kernels.get(e.name(), 0) + 1
    total_ns = sum(e.duration_ns() for e in dev)
    return {"kernels": kernels,
            "device_ms": total_ns / 1e6 if total_ns > 0 else "not measured",
            "ops": len(issued), "complete": complete, "lead_lost": len(leading - seen),
            "calls": calls}


__all__ = ["Timer", "torch_trace", "summarize", "write_metrics", "device_name",
           "card_line", "chained_ms", "launched_kernels", "tracing", "span", "count",
           "trace_stats", "reset_trace_stats"]
