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


__all__ = ["DeviceLike", "resolve_device"]
