"""The memory-rate probe's read-once reduction: CUDA wrapper, plain version.

``reduce_sum_f32(x)`` is the f32 sum of an int8 tensor, read once.  It
replaces no TPU kernel: ``scripts/probe_hbm_bw.py``'s ``reduce_sum_f32`` row
is ``sum(a.astype(float32))``, which XLA fuses into one pass at the memory
rate, where torch's ``x.sum(dtype=torch.float32)`` read 0.242 TB/s on an
H100 (NVIDIA H100 80GB HBM3, 700 W; ``PERF.md``).  So the port's probe
(``scripts/torch_probe_hbm_bw.py``) times this kernel in that row.

On a CUDA tensor the wrapper launches ``dewi_probe_reduce_sum``
(``csrc/probe_kernels.cu``: a grid-stride read of 16 bytes at a time,
exact integer sums, per-CTA partials and a one-CTA second pass, so the
result is the exact sum rounded to f32 once, the same in every run) and
adds one to ``cuda_search.launch_counts["probe_reduce_f32"]``; on a CPU
tensor it returns the plain version.  There is no fallback from the kernel
to the plain version.  Bound: the bytes, ``x.numel()`` over the memory rate.
"""

from __future__ import annotations

import functools

import torch

from .cuda_search import _library, _launch, _require, _stream

CTAS_PER_SM = 4     # CTAs of the first pass per streaming multiprocessor


def reduce_sum_f32_plain(x: torch.Tensor) -> torch.Tensor:
    """The exact sum (f64 is exact for int8 sums below 2^53) rounded to f32."""
    return x.to(torch.float64).sum().to(torch.float32)


@functools.lru_cache(maxsize=None)
def _threads() -> int:
    return int(_library().dewi_probe_threads())


def reduce_sum_f32(x: torch.Tensor) -> torch.Tensor:
    """The f32 sum of an int8 tensor, a 0-dim float32 tensor on its device."""
    _require(x.dtype == torch.int8, f"reduce_sum_f32: x must be int8, got {x.dtype}")
    _require(x.is_contiguous(), "reduce_sum_f32: x must be contiguous")
    _require(x.device.type in ("cpu", "cuda"), f"reduce_sum_f32: unsupported device {x.device}")
    if x.device.type == "cpu":
        return reduce_sum_f32_plain(x)
    _require(x.data_ptr() % 16 == 0, "reduce_sum_f32: x must be 16-byte aligned")
    n = x.numel()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    n_ctas = max(1, min(CTAS_PER_SM * sms, -(-(n // 16) // _threads())))
    partials = torch.empty(n_ctas, dtype=torch.int64, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    _launch("probe_reduce_f32", "dewi_probe_reduce_sum", x.device, x.data_ptr(), n,
            partials.data_ptr(), n_ctas, out.data_ptr(), _stream(x))
    return out


__all__ = ["reduce_sum_f32", "reduce_sum_f32_plain", "CTAS_PER_SM"]
