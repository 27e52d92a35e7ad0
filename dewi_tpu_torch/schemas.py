"""JSON Schema export for the config and payload types.

Counterpart of ``dewi_tpu/schemas.py``: pydantic ``TypeAdapter`` schemas of
:class:`DewiConfig`, :class:`Payload`, :class:`Signals` and
:class:`Weights`, one ``<name>.schema.json`` each.  pydantic is imported
only when :func:`export` runs.

    python -m dewi_tpu_torch.schemas   # writes docs/schemas/*.schema.json
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Union

from .config import DewiConfig
from .types import Payload, Signals, Weights

EXPORTED = {
    "dewi_config": DewiConfig,
    "payload": Payload,
    "signals": Signals,
    "weights": Weights,
}


def export(out_dir: Union[str, Path] = "docs/schemas") -> list:
    """Write one ``<name>.schema.json`` per exported type; returns the paths."""
    from pydantic import TypeAdapter

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for name, cls in EXPORTED.items():
        schema = TypeAdapter(cls).json_schema()
        path = out / f"{name}.schema.json"
        path.write_text(json.dumps(schema, indent=2, sort_keys=True), encoding="utf-8")
        written.append(path)
    return written


if __name__ == "__main__":
    for p in export():
        print(p)
