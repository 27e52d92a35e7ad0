"""Signal backbones of the port: causal LM, ViT-MAE, CLIP dual encoder.

Counterparts of ``dewi_tpu/models`` as ``torch.nn.Module``s, the
single-device mixture-of-experts LM (``moe``) and Moonlight-16B-A3B
(``moonlight``, a DeepSeek-V3 decoder the text-entropy estimator scores
with); ``registry`` holds the presets, seeded init and checkpoints.
"""

from .clip import CLIPConfig, CLIPDualEncoder
from .lm import CausalLM, token_nll
from .mae import MAEConfig, ViTMAE, patchify, pixel_entropy_proxy
from .moe import MoECausalLM, MoEMLP, load_balance_loss
from .moonlight import MoonlightConfig, MoonlightLM, init_moonlight, moonlight_config
from .registry import (clip_config, init_clip, init_lm, init_mae, init_moe_lm, lm_config,
                       load_params, mae_config, param_count, save_params)
from .transformer import Encoder, TransformerConfig

__all__ = [
    "CausalLM", "token_nll", "ViTMAE", "MAEConfig", "patchify", "pixel_entropy_proxy",
    "CLIPDualEncoder", "CLIPConfig", "Encoder", "TransformerConfig",
    "MoECausalLM", "MoEMLP", "load_balance_loss",
    "MoonlightConfig", "MoonlightLM", "init_moonlight", "moonlight_config",
    "lm_config", "mae_config", "clip_config", "init_lm", "init_mae", "init_clip", "init_moe_lm",
    "save_params", "load_params", "param_count",
]
