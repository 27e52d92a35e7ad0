"""Throttled per-batch progress reporting for corpus-scale stages.

A copy of ``dewi_tpu/utils/progress.py``: a :class:`ProgressMeter` prints ``stage: done/total docs (rate docs/s, ETA)``
at most once per ``interval`` seconds, so a 1M-doc stage shows live
throughput instead of a silent multi-minute gap between stage names.

Estimator batch loops accept an optional ``progress`` callable invoked with
the number of items just completed; :func:`meter_callback` adapts a meter to
that contract.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Callable, Optional


def _fmt_eta(seconds: float) -> str:
    seconds = max(0, int(seconds))
    if seconds >= 3600:
        return f"{seconds // 3600}h{(seconds % 3600) // 60:02d}m"
    return f"{seconds // 60}m{seconds % 60:02d}s"


class ProgressMeter:
    """Prints throttled ``label: n/total (rate/s, ETA ...)`` lines.

    ``enabled=False`` makes every method a no-op so callers can thread one
    object through unconditionally.  Output goes to stderr (stdout stays
    machine-parseable for the CLI's JSON modes).
    """

    def __init__(
        self,
        total: int,
        label: str,
        enabled: bool = True,
        interval: float = 1.0,
        stream: Any = None,
    ) -> None:
        self.total = int(total)
        self.label = label
        self.enabled = bool(enabled) and self.total > 0
        self.interval = float(interval)
        self.stream = stream if stream is not None else sys.stderr
        self.done = 0
        self._t0 = time.perf_counter()
        self._last_print = 0.0
        self._printed = False

    def update(self, n: int = 1) -> None:
        if not self.enabled:
            return
        self.done += int(n)
        now = time.perf_counter()
        if now - self._last_print < self.interval and self.done < self.total:
            return
        self._last_print = now
        elapsed = max(now - self._t0, 1e-9)
        rate = self.done / elapsed
        remaining = (self.total - self.done) / rate if rate > 0 else 0.0
        print(
            f"  {self.label}: {self.done}/{self.total} docs "
            f"({rate:,.0f} docs/s, ETA {_fmt_eta(remaining)})",
            file=self.stream,
        )
        self._printed = True

    def close(self) -> None:
        """Final line (always printed once if anything was reported)."""
        if not self.enabled or not self._printed or self.done >= self.total:
            # done >= total already printed unthrottled in update().
            return
        self._last_print = -self.interval  # bypass the throttle
        self.update(0)


def meter_callback(meter: Optional[ProgressMeter]) -> Optional[Callable[[int], None]]:
    """Adapt a meter to the estimators' ``progress(n_done)`` contract."""
    if meter is None or not meter.enabled:
        return None
    return meter.update


__all__ = ["ProgressMeter", "meter_callback"]
