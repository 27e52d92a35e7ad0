"""Robust statistics: median / MAD / quantiles over ``[N, K]`` columns.

Counterpart of ``dewi_tpu/ops/robust.py``.  ``torch.median`` returns the
LOWER middle value for an even count, where ``jnp.median`` and
``np.median`` average the two middle values, so the median here is a sort
followed by the mean of the two middle rows.
"""

from __future__ import annotations

import torch

MAD_CONSISTENCY = 1.4826  # MAD -> sigma for a normal distribution
MAD_FLOOR = 1e-8


def _median0(x: torch.Tensor) -> torch.Tensor:
    """Median along dim 0, averaging the two middle values for even N."""
    n = x.shape[0]
    s = torch.sort(x, dim=0).values
    if n % 2:
        return s[n // 2]
    return (s[n // 2 - 1] + s[n // 2]) * 0.5


def median_mad(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-column median and MAD of an ``[N, K]`` matrix.

    MAD is floored at ``1e-8`` exactly when it is zero (the reference's
    fit-time ``median(...) or 1e-8``).
    """
    x = x.to(torch.float32)
    med = _median0(x)
    mad = _median0(torch.abs(x - med[None, :]))
    mad = torch.where(mad == 0.0, torch.full_like(mad, MAD_FLOOR), mad)
    return med, mad


def robust_z(x: torch.Tensor, med: torch.Tensor, mad: torch.Tensor) -> torch.Tensor:
    """``z = (x - med) / (1.4826 * mad)`` broadcast over rows."""
    return (x - med) / (MAD_CONSISTENCY * mad)


def local_weights_kernel(s: torch.Tensor) -> torch.Tensor:
    """Per-token/per-patch surprisal -> positive weights.

    Robust z with an additive ``+1e-8`` MAD epsilon, clip to +-5, then
    softplus via ``log1p(exp(z))``.
    """
    s = s.to(torch.float32).reshape(-1)
    med = _median0(s)
    mad = _median0(torch.abs(s - med)) + MAD_FLOOR
    z = (s - med) / (MAD_CONSISTENCY * mad)
    z = torch.clamp(z, -5.0, 5.0)
    return torch.log1p(torch.exp(z))


def quantiles(x: torch.Tensor, qs: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Linear-interpolation quantiles, matching ``np.quantile`` defaults."""
    x = x.to(torch.float32)
    return torch.quantile(x, qs.to(device=x.device, dtype=torch.float32), dim=axis)


__all__ = ["MAD_CONSISTENCY", "MAD_FLOOR", "median_mad", "robust_z",
           "local_weights_kernel", "quantiles"]
