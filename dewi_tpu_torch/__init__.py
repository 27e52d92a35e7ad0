"""dewi_tpu_torch: the PyTorch/CUDA port of DEWI-TPU.

Same system as ``dewi_tpu`` (which stays the reference): documents get
DEWI scores from the robust median/MAD scorer and go into a ``DewiIndex``
that searches with ``(1-eta)*sim + eta*dewi + entropy_pref*mean_entropy``.
Stage 1 of the search and the two streaming searches run in hand-written
CUDA kernels (``dewi_tpu_torch/csrc``), built with nvcc at first use.  ``serve`` holds
the micro-batching ``MicroBatcher`` and the HTTP ``SearchServer``.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); ``device=None`` raises when there is no CUDA device.

Full-f32 products: TF32 is switched off here, at import, for both cuBLAS
matmuls and cuDNN, because the reference's f32 products are full f32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .convert import (index_from_numpy_state, ivf_index_from_numpy_state,  # noqa: E402
                      stats_from_numpy_state)
from .index import DewiIndex, ExactIndex, IndexBackend, IVFIndex, QuantizedIndex  # noqa: E402
from .scorer import DewiScorer, RobustStats, local_weights_from_surprisal  # noqa: E402
from .serve import MicroBatcher, OverloadedError, SearchServer, retier_index  # noqa: E402
from .types import Payload, Signals, Weights  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "DewiIndex", "DewiScorer", "ExactIndex", "IVFIndex", "IndexBackend", "MicroBatcher",
    "OverloadedError", "Payload", "QuantizedIndex", "RobustStats",
    "SearchServer", "Signals", "Weights", "index_from_numpy_state",
    "ivf_index_from_numpy_state",
    "local_weights_from_surprisal", "retier_index", "stats_from_numpy_state",
    "__version__",
]
