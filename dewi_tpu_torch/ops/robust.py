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


def masked_mean_and_quantiles(values: torch.Tensor, mask: torch.Tensor,
                              qs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise mean and quantiles of ``values [B, T]`` under ``mask [B, T]``.

    Padding is excluded from both.  Quantiles interpolate linearly, as
    ``np.quantile``, on the sorted valid prefix of each row: invalid entries
    sort to the tail behind the float32-max sentinel and are never gathered
    (``pos = q * (n - 1)`` with a floor/ceil gather).  A row with no valid
    entries reports 0.
    """
    values = values.to(torch.float32)
    mask = mask.to(torch.float32)
    qs = qs.to(device=values.device, dtype=torch.float32)
    raw_counts = mask.sum(dim=1)
    counts = raw_counts.clamp_min(1.0)
    mean = (values * mask).sum(dim=1) / counts
    big = torch.finfo(torch.float32).max
    sorted_vals = torch.sort(torch.where(mask > 0, values, torch.full_like(values, big)),
                             dim=1).values
    pos = qs[None, :] * (counts[:, None] - 1.0)  # [B, Q]
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.ceil(pos).to(torch.int64)
    frac = pos - lo.to(torch.float32)
    v_lo = torch.gather(sorted_vals, 1, lo)
    v_hi = torch.gather(sorted_vals, 1, hi)
    q_vals = v_lo + frac * (v_hi - v_lo)
    empty = (raw_counts == 0.0)[:, None]
    return mean, torch.where(empty, torch.zeros_like(q_vals), q_vals)


__all__ = ["MAD_CONSISTENCY", "MAD_FLOOR", "median_mad", "robust_z",
           "local_weights_kernel", "quantiles", "masked_mean_and_quantiles"]
