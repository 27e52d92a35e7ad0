"""Seeds, clocks and the record a run leaves for the metric readers."""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import numpy as np


def seed_state(seed: int, *salt: str) -> int:
    """A 64-bit seed for one stream of a run: the run's ``--seed`` (any
    whole number) and the stream's name, mixed by ``SeedSequence``."""
    words = [abs(int(seed)) & 0xFFFFFFFF, abs(int(seed)) >> 32, int(seed < 0)]
    words += [int.from_bytes(s.encode(), "little") & 0xFFFFFFFF for s in salt]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])


def rng(seed: int, *salt: str) -> np.random.Generator:
    return np.random.default_rng(seed_state(seed, *salt))


def torch_generator(seed: int, device: Any, *salt: str) -> Any:
    import torch

    return torch.Generator(device=device).manual_seed(seed_state(seed, *salt))


def sync(device: Any) -> None:
    import torch

    if getattr(device, "type", str(device)) == "cuda":
        torch.cuda.synchronize(device)


def now() -> float:
    return time.perf_counter()


def end_setup(t_start: float) -> float:
    """Set-up's last step, and its length: a full garbage collection, so
    that collecting what set-up left behind (the corpus, the warm-up) does
    not fall in the window at a random time; the window's own garbage is
    still collected inside it."""
    gc.collect()
    return now() - t_start


@dataclass
class Run:
    """What a driver hands to the metric readers and to the result line.

    ``counts`` and ``values`` hold what the readers read, by name; ``shapes``
    the sizes that operation and byte counts are worked out from;
    ``checks`` the compared numbers as ``(name, value, limit)``.
    """

    cell: str
    traced: bool
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    counts: Dict[str, float] = field(default_factory=dict)
    values: Dict[str, Any] = field(default_factory=dict)
    shapes: Dict[str, Any] = field(default_factory=dict)
    trace: Any = None
    memory_peak_bytes: int = 0
    checks: List[Tuple[str, float, float]] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)

    def correct(self) -> bool:
        return bool(self.checks) and all(
            np.isfinite(v) and v <= lim for _, v, lim in self.checks)


__all__ = ["Run", "seed_state", "rng", "torch_generator", "sync", "now", "end_setup"]
