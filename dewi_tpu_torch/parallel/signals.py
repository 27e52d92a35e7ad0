"""Data-parallel placement for the signal estimators' batches.

Counterpart of ``dewi_tpu/parallel/signals.py``.  The estimator forwards
(LM surprisal, MAE reconstruction, the CLIP towers) dominate corpus
processing.  Under a mesh every rank runs the same forward on its slice of
each batch:

* the model's weights are replicated once (:meth:`DataParallel.replicate`
  broadcasts the first rank's ``state_dict``);
* every padded batch is sliced to this rank's contiguous rows
  (:meth:`DataParallel.put`), and the per-row outputs are all-gathered back
  into the whole batch, in rank order, on every rank
  (:meth:`DataParallel.gather`); the per-document math is row-independent,
  so the forward itself needs no collective;
* batch sizes round up to a multiple of the data axis
  (:meth:`DataParallel.round_batch`), so every batch divides evenly.

The host work (tokenization, length bucketing, image decode) runs on every
rank over the whole batch, so the slices line up.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..utils.device import DeviceLike
from .mesh import DATA_AXIS, Mesh, check_mesh, mesh_device, single_device_mesh


class DataParallel:
    """Batch placement held by each estimator.

    Without a mesh it is a world of one on ``device``: it slices and gathers
    nothing, so one code path serves the meshless estimator, one card and
    many."""

    def __init__(self, mesh: Optional[Mesh] = None, device: DeviceLike = None) -> None:
        self.mesh = check_mesh(mesh) if mesh is not None else single_device_mesh(device)
        self.device = mesh_device(self.mesh, device)
        self.n_data = int(self.mesh.shape[DATA_AXIS])

    def round_batch(self, batch_size: int) -> int:
        """Smallest multiple of the data-axis size >= ``batch_size``."""
        bs = int(batch_size)
        return ((bs + self.n_data - 1) // self.n_data) * self.n_data

    def replicate(self, module: torch.nn.Module) -> torch.nn.Module:
        """Give ``module`` the first data rank's weights on every rank."""
        if self.mesh.group(DATA_AXIS) is not None:
            with torch.no_grad():
                for t in module.state_dict().values():
                    self.mesh.broadcast(t)
        return module

    def put(self, arr: Any, batch_axis: int = 0) -> torch.Tensor:
        """This rank's contiguous slice of the padded batch ``arr`` along
        ``batch_axis``, on the mesh's device (a host array is sliced before
        it is copied)."""
        size = arr.shape[batch_axis]
        if size % self.n_data:
            raise ValueError(f"batch of {size} does not divide over {self.n_data} data ranks")
        per = size // self.n_data
        lo = self.mesh.data_index * per
        part = arr[(slice(None),) * batch_axis + (slice(lo, lo + per),)]
        if not isinstance(part, torch.Tensor):
            part = torch.from_numpy(np.ascontiguousarray(part))
        return part.to(self.device)

    def gather(self, out: torch.Tensor, batch_axis: int = 0) -> torch.Tensor:
        """Every rank's slice joined back into the whole batch, on every rank."""
        return self.mesh.all_gather(out, dim=batch_axis)


__all__ = ["DataParallel"]
