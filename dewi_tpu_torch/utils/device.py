"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means CUDA, and raises when there is no CUDA device.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a CUDA device); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: dewi_tpu_torch runs on the GPU by default; "
                "pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def refuse_multi_device(**args: object) -> None:
    """Raise for the model-axis arguments (``ring_mesh=``, ``chip_len=``)
    that a caller set: ring attention over the mesh's model axis is not
    ported yet (the data axis, ``mesh=``, is)."""
    given = sorted(name for name, value in args.items() if value is not None)
    if given:
        raise NotImplementedError(
            f"{', '.join(given)}: the model axis (ring attention over a mesh) "
            "is not ported yet (ROADMAP.md queue 1 step 12b)"
        )


__all__ = ["DeviceLike", "resolve_device", "refuse_multi_device"]
