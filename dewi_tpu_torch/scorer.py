"""DEWI scorer: robust standardization + weighted utility + sigmoid.

Counterpart of ``dewi_tpu/scorer.py``; the math is the same:

* fit: per-signal median and MAD (MAD floored at 1e-8 when zero),
* z: ``(v - med) / (1.4826 * mad)``,
* components: ``Ht = 0.5*(z(ht_mean)+z(ht_q90))``, ``Hi`` likewise, and
  ``I/R/N`` straight z-scores,
* standard mode: ``U = at*Ht + ai*Hi - am*I - ar*R - an*N`` clipped to
  ``+-delta`` then sigmoid,
* conditional mode: ``Ht-I`` / ``Hi-I`` and no ``alpha_m`` term.

Fitting and scoring run over ``[N, K]`` signal tensors on the scorer's
device; the scalar ``score``/``score_conditional`` run in Python floats.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from .ops.robust import MAD_CONSISTENCY, local_weights_kernel, median_mad
from .types import SIGNAL_FIELDS, Payload, RowLike, Signals, Weights, rows_to_matrix
from .utils.device import DeviceLike, resolve_device

PAYLOAD_STAT_FIELDS = ("ht_mean", "hi_mean", "redundancy", "noise")
MatrixLike = Union[np.ndarray, torch.Tensor]


@dataclass
class RobustStats:
    """Median/MAD per signal; ``mads`` are stored already floored."""

    medians: Dict[str, float]
    mads: Dict[str, float]
    keys: tuple = field(default=SIGNAL_FIELDS)

    @classmethod
    def fit(cls, rows: Sequence[RowLike], device: DeviceLike = None) -> "RobustStats":
        """Fit from dict/Signals rows; the key set comes from the first row.

        ``device=None`` fits on the card (raising without one)."""
        if not rows:
            raise ValueError("Cannot fit statistics on an empty dataset")
        first = rows[0] if isinstance(rows[0], Mapping) else rows[0].to_dict()
        keys = tuple(first.keys())
        return cls.fit_matrix(rows_to_matrix(rows, keys), keys, device=device)

    @classmethod
    def fit_matrix(cls, mat: MatrixLike, keys: Sequence[str],
                   device: DeviceLike = None) -> "RobustStats":
        """Fit from an ``[N, K]`` column matrix on ``device`` (``None``: the card)."""
        x = torch.as_tensor(mat, dtype=torch.float32, device=resolve_device(device))
        med, mad = median_mad(x)
        med_l = med.cpu().tolist()
        mad_l = mad.cpu().tolist()
        return cls(
            medians={k: float(m) for k, m in zip(keys, med_l)},
            mads={k: float(m) for k, m in zip(keys, mad_l)},
            keys=tuple(keys),
        )

    @classmethod
    def from_payloads(cls, payloads: Sequence[Payload],
                      keys: Sequence[str] = PAYLOAD_STAT_FIELDS,
                      device: DeviceLike = None) -> "RobustStats":
        if not payloads:
            raise ValueError("Cannot compute statistics from empty dataset")
        mat = np.array([[float(getattr(p, k)) for k in keys] for p in payloads],
                       dtype=np.float32)
        return cls.fit_matrix(mat, keys, device=device)

    def z(self, name: str, val: float) -> float:
        return float((val - self.medians[name]) / (MAD_CONSISTENCY * self.mads[name]))

    def arrays(self, keys: Optional[Sequence[str]] = None) -> Any:
        keys = tuple(keys or self.keys)
        med = np.array([self.medians[k] for k in keys], dtype=np.float32)
        mad = np.array([self.mads[k] for k in keys], dtype=np.float32)
        return med, mad

    def to_dict(self) -> dict:
        return {"medians": self.medians, "mads": self.mads, "keys": list(self.keys)}

    @classmethod
    def from_dict(cls, d: dict) -> "RobustStats":
        return cls(medians=dict(d["medians"]), mads=dict(d["mads"]),
                   keys=tuple(d.get("keys", SIGNAL_FIELDS)))


def score_matrix(x: torch.Tensor, med: torch.Tensor, mad: torch.Tensor,
                 alphas: torch.Tensor, delta: torch.Tensor,
                 mode: str = "standard") -> torch.Tensor:
    """z -> components -> clipped utility -> sigmoid over ``[N, 7]``.

    Column order is SIGNAL_FIELDS:
    (ht_mean, ht_q90, hi_mean, hi_q90, I_hat, redundancy, noise).
    """
    z = (x.to(torch.float32) - med[None, :]) / (MAD_CONSISTENCY * mad[None, :])
    ht = 0.5 * (z[:, 0] + z[:, 1])
    hi = 0.5 * (z[:, 2] + z[:, 3])
    i_hat, red, noise = z[:, 4], z[:, 5], z[:, 6]
    at, ai, am, ar, an = alphas[0], alphas[1], alphas[2], alphas[3], alphas[4]
    if mode == "conditional":
        u = at * (ht - i_hat) + ai * (hi - i_hat) - ar * red - an * noise
    else:
        u = at * ht + ai * hi - am * i_hat - ar * red - an * noise
    u = torch.clamp(u, -delta, delta)
    return torch.sigmoid(u)


class DewiScorer:
    """Robust DEWI scorer with standard and conditional modes.

    Fits and scores on ``device`` (``None`` -> CUDA, raising when there is
    none).  An explicit ``delta`` overrides ``weights.delta`` only when given.
    """

    def __init__(self, weights: Optional[Weights] = None,
                 delta: Optional[float] = None, device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.weights = weights or Weights()
        if delta is not None:
            self.weights.delta = float(delta)
        self.stats: Optional[RobustStats] = None

    # ---- fitting ---------------------------------------------------------

    def fit_stats(self, rows: Sequence[RowLike]) -> None:
        self.stats = RobustStats.fit(rows, device=self.device)

    def fit_stats_matrix(self, mat: MatrixLike,
                         keys: Sequence[str] = SIGNAL_FIELDS) -> None:
        self.stats = RobustStats.fit_matrix(mat, keys, device=self.device)

    def is_fitted(self) -> bool:
        return self.stats is not None

    # ---- scalar scoring ----------------------------------------------------

    def _components(self, sig: RowLike) -> Dict[str, float]:
        if self.stats is None:
            raise AssertionError("Call fit_stats() before scoring.")
        s = self.stats
        d = sig if isinstance(sig, Mapping) else sig.to_dict()
        return {
            "Ht": 0.5 * (s.z("ht_mean", d["ht_mean"]) + s.z("ht_q90", d["ht_q90"])),
            "Hi": 0.5 * (s.z("hi_mean", d["hi_mean"]) + s.z("hi_q90", d["hi_q90"])),
            "I": s.z("I_hat", d["I_hat"]),
            "R": s.z("redundancy", d["redundancy"]),
            "N": s.z("noise", d["noise"]),
        }

    @staticmethod
    def _sigmoid(x: float) -> float:
        return float(1.0 / (1.0 + np.exp(-x)))

    def score(self, sig: RowLike) -> float:
        c = self._components(sig)
        w = self.weights
        u = (w.alpha_t * c["Ht"] + w.alpha_i * c["Hi"] - w.alpha_m * c["I"]
             - w.alpha_r * c["R"] - w.alpha_n * c["N"])
        return self._sigmoid(float(np.clip(u, -w.delta, w.delta)))

    def score_conditional(self, sig: RowLike) -> float:
        c = self._components(sig)
        w = self.weights
        u = (w.alpha_t * (c["Ht"] - c["I"]) + w.alpha_i * (c["Hi"] - c["I"])
             - w.alpha_r * c["R"] - w.alpha_n * c["N"])
        return self._sigmoid(float(np.clip(u, -w.delta, w.delta)))

    # ---- batch scoring -------------------------------------------------------

    def _as_matrix(self, signals: Union[MatrixLike, Sequence[RowLike]]) -> torch.Tensor:
        if not isinstance(signals, (np.ndarray, torch.Tensor)):
            signals = rows_to_matrix(signals, SIGNAL_FIELDS)
        return torch.as_tensor(signals, dtype=torch.float32, device=self.device)

    def score_batch(self, signals: Union[MatrixLike, Sequence[RowLike]],
                    mode: str = "standard") -> torch.Tensor:
        """Score N documents: ``[N, 7]`` (SIGNAL_FIELDS order) or rows ->
        ``[N]`` DEWI scores in [0, 1] on the scorer's device."""
        if self.stats is None:
            raise AssertionError("Call fit_stats() before scoring.")
        med, mad = self.stats.arrays(SIGNAL_FIELDS)
        dev = self.device
        return score_matrix(
            self._as_matrix(signals),
            torch.as_tensor(med, device=dev),
            torch.as_tensor(mad, device=dev),
            torch.as_tensor(self.weights.alphas(), device=dev),
            torch.tensor(self.weights.delta, dtype=torch.float32, device=dev),
            mode=mode,
        )

    def fit_and_score(self, signals: Union[MatrixLike, Sequence[RowLike]],
                      mode: str = "standard") -> torch.Tensor:
        """Fit stats and score in one go: the bulk corpus path."""
        mat = self._as_matrix(signals)
        self.fit_stats_matrix(mat)
        return self.score_batch(mat, mode=mode)


def local_weights_from_surprisal(s: Any, device: DeviceLike = None) -> np.ndarray:
    """Per-token/per-patch surprisal -> positive weights, computed on
    ``device`` (``None``: the card) and returned as host numpy."""
    x = torch.as_tensor(np.asarray(s), dtype=torch.float32, device=resolve_device(device))
    return local_weights_kernel(x).cpu().numpy()


__all__ = ["DewiScorer", "RobustStats", "Signals", "Weights", "score_matrix",
           "local_weights_from_surprisal", "PAYLOAD_STAT_FIELDS"]
