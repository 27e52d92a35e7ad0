"""Sidecar configs of imported checkpoints.

Counterpart of the ``sidecar_config`` reader of
``dewi_tpu/models/import_hf.py``: an imported checkpoint carries
``<checkpoint>.config.json`` with its exact architecture, which overrides
the named preset.  The HF importers themselves come with the next slice.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional


def sidecar_config(checkpoint: Any) -> Optional[dict]:
    """The sidecar written beside ``checkpoint``, or None."""
    if checkpoint is None:
        return None
    p = Path(str(checkpoint) + ".config.json")
    if not p.exists():
        return None
    return json.loads(p.read_text(encoding="utf-8"))


__all__ = ["sidecar_config"]
