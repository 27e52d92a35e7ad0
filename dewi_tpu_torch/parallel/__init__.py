"""Mesh/runtime layer over ``torch.distributed``: meshes, shardings,
distributed search and data-parallel estimator placement.

Counterpart of ``dewi_tpu/parallel``'s data axis.  The model axis (ring
attention, sequence, tensor and pipeline parallelism) is not ported yet.
"""

from .distributed import (
    ShardedExactSearcher,
    ShardedIVFSearcher,
    ShardedQuantizedSearcher,
    make_sharded_ivf_search,
    make_sharded_quantized_search,
    make_sharded_search,
)
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    data_sharding,
    make_mesh,
    replicated,
    single_device_mesh,
)
from .runtime import (
    default_mesh,
    device_summary,
    initialize_runtime,
    launch_local,
    shard_batch,
)
from .signals import DataParallel

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "make_mesh",
    "data_sharding",
    "replicated",
    "single_device_mesh",
    "make_sharded_search",
    "ShardedExactSearcher",
    "ShardedQuantizedSearcher",
    "ShardedIVFSearcher",
    "make_sharded_quantized_search",
    "make_sharded_ivf_search",
    "initialize_runtime",
    "device_summary",
    "shard_batch",
    "default_mesh",
    "launch_local",
    "DataParallel",
]
