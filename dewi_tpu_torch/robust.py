"""Compatibility shim: Payload-based robust stats.

Counterpart of ``dewi_tpu/robust.py``: the reference's ``robust`` import
surface onto the port's unified :class:`dewi_tpu_torch.scorer.RobustStats`,
with the additive-epsilon z-score helper.
"""

from typing import Any

from .ops.robust import MAD_CONSISTENCY
from .scorer import PAYLOAD_STAT_FIELDS, RobustStats


def _robust_standardize(x: Any, med: Any, mad: Any) -> Any:
    """Additive-epsilon z-score: ``(x - med) / (1.4826 * (mad + 1e-8))``."""
    mad = float(mad) + 1e-8
    return (x - med) / (MAD_CONSISTENCY * mad)


__all__ = ["RobustStats", "PAYLOAD_STAT_FIELDS", "_robust_standardize"]
