"""Training loops for the DEWI signal backbones.

Counterpart of ``dewi_tpu/training``: the port's backbones start at random
init, so it must be able to *produce* weights.  Four loops over
``torch.optim.AdamW`` with optax's clipping and cosine schedule: causal-LM
next-token CE, the MoE LM's CE plus its load-balance loss, MAE
reconstruction and CLIP InfoNCE.  Checkpoints land in the msgpack format the
estimators load through ``checkpoint=`` (in both packages).
"""

from .loops import TrainState, lm_batches, train_clip, train_lm, train_mae, train_moe_lm

__all__ = ["TrainState", "train_lm", "train_mae", "train_clip", "train_moe_lm", "lm_batches"]
