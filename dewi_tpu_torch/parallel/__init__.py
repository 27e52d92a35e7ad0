"""Mesh/runtime layer over ``torch.distributed``: meshes, shardings,
distributed search, data-parallel estimator placement, and the model axis.

Counterpart of ``dewi_tpu/parallel``.  The model axis lives in its modules:
``ring`` (ring attention), ``tp`` (tensor parallelism), ``sp`` (sequence
parallelism) and ``pp`` (pipeline parallelism); expert parallelism is
``models.moe.shard_expert_params``.
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
from .sp import sequence_sharded_nll, shard_tokens

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
    "shard_tokens",
    "sequence_sharded_nll",
]
