"""Local (per-token / per-patch) weights: the reference's ``local_weights``
import surface (``dewi_tpu/local_weights.py``), onto the port's scorer."""

from .scorer import local_weights_from_surprisal

__all__ = ["local_weights_from_surprisal"]
