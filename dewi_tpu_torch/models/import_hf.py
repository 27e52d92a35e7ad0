"""HuggingFace -> dewi_tpu_torch weight importers.

Counterpart of ``dewi_tpu/models/import_hf.py``: maps HF GPT-2, CLIP and
ViT-MAE torch state dicts onto the port's ``CausalLM``,
``CLIPDualEncoder`` and ``ViTMAE`` with exact-numerics configs (LayerNorm
epsilon, activation), so an imported model reproduces the HF forward in
float32.

Each importer first lays the HF state dict out as the reference's Flax
parameter tree (numpy), then loads that tree through
:mod:`dewi_tpu_torch.convert`, so the one mapping that carries checkpoints
between the packages also carries imported weights: there is one mapping
to keep right, not two.

Usage (a local or cached HF model; ``transformers`` is needed only by
:func:`convert_pretrained`, the importers need only torch):

    from transformers import GPT2LMHeadModel
    from dewi_tpu_torch.models.import_hf import import_gpt2
    from dewi_tpu_torch.models.registry import save_params

    cfg, model = import_gpt2(GPT2LMHeadModel.from_pretrained("gpt2"))
    save_params(model, "gpt2.msgpack")
    # then: TextConfig(model="gpt2", tokenizer="gpt2", checkpoint="gpt2.msgpack")

``python -m dewi_tpu_torch import-weights gpt2 gpt2.msgpack --kind gpt2``
does the same and writes the ``.config.json`` sidecar beside it.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
from torch import nn

from ..utils.device import DeviceLike, resolve_device
from .clip import CLIPConfig, CLIPDualEncoder
from .lm import CausalLM
from .mae import MAEConfig, ViTMAE
from .transformer import TransformerConfig


def _to_numpy_state(model_or_state: Any) -> Dict[str, np.ndarray]:
    """torch module / state_dict -> {name: float32 ndarray}."""
    state = (model_or_state.state_dict() if hasattr(model_or_state, "state_dict")
             else model_or_state)
    out = {}
    for k, v in state.items():
        if hasattr(v, "detach"):
            v = v.detach().float().cpu().numpy()
        out[k] = np.asarray(v, dtype=np.float32)
    return out


def _split_heads(w: np.ndarray, n_heads: int) -> np.ndarray:
    """[d_in, d_out] kernel -> [d_in, n_heads, head_dim] (flax DenseGeneral)."""
    d_in, d_out = w.shape
    return w.reshape(d_in, n_heads, d_out // n_heads)


def _attn_params(q_w: np.ndarray, k_w: np.ndarray, v_w: np.ndarray, o_w: np.ndarray,
                 q_b: np.ndarray, k_b: np.ndarray, v_b: np.ndarray, o_b: np.ndarray,
                 n_heads: int) -> dict:
    """Flax ``MultiHeadDotProductAttention`` params from ``[d, d]`` projection
    kernels in Flax's orientation (kernel[in, out])."""
    d = q_w.shape[0]
    hd = d // n_heads

    def qkv(w: np.ndarray, b: np.ndarray) -> dict:
        return {"kernel": _split_heads(w, n_heads), "bias": b.reshape(n_heads, hd)}

    return {"query": qkv(q_w, q_b), "key": qkv(k_w, k_b), "value": qkv(v_w, v_b),
            "out": {"kernel": o_w.reshape(n_heads, hd, d), "bias": o_b}}


def _ln(state: Dict[str, np.ndarray], prefix: str) -> dict:
    return {"scale": state[f"{prefix}.weight"], "bias": state[f"{prefix}.bias"]}


def _linear(state: Dict[str, np.ndarray], prefix: str) -> dict:
    """torch nn.Linear (weight [out, in]) -> flax Dense (kernel [in, out])."""
    p = {"kernel": state[f"{prefix}.weight"].T}
    if f"{prefix}.bias" in state:
        p["bias"] = state[f"{prefix}.bias"]
    return p


def _conv_patch_embed(weight: np.ndarray) -> np.ndarray:
    """Conv2d patch projection [d, c, p, p] -> Dense kernel [p*p*c, d] in
    ``patchify``'s (row, col, channel) flattening order."""
    return weight.transpose(2, 3, 1, 0).reshape(-1, weight.shape[0])


def _place(model: nn.Module, tree: dict, device: DeviceLike) -> nn.Module:
    """Load a reference-layout param tree into ``model`` and move it."""
    from .. import convert

    loader = {CausalLM: convert.lm_params_from_flax, ViTMAE: convert.mae_params_from_flax,
              CLIPDualEncoder: convert.clip_params_from_flax}[type(model)]
    model.load_state_dict(loader(tree), strict=True)
    return model.to(resolve_device(device)).eval()


# ---------------------------------------------------------------------------
# GPT-2 -> CausalLM
# ---------------------------------------------------------------------------


def gpt2_tree(model_or_state: Any, hf_config: Any = None) -> Tuple[TransformerConfig, dict]:
    """An HF ``GPT2LMHeadModel`` as ``(TransformerConfig, {"params": tree})``
    in the reference's ``CausalLM`` layout (f32, tied LM head, gelu_new)."""
    if hf_config is None:
        hf_config = model_or_state.config
    state = _to_numpy_state(model_or_state)
    # Strip the tied lm_head and the leading "transformer." prefix.
    state = {k[len("transformer."):] if k.startswith("transformer.") else k: v
             for k, v in state.items() if not k.startswith("lm_head.")}
    if getattr(hf_config, "scale_attn_by_inverse_layer_idx", False):
        raise ValueError("scale_attn_by_inverse_layer_idx is not supported")
    if getattr(hf_config, "activation_function", "gelu_new") not in (
            "gelu_new", "gelu_pytorch_tanh"):
        raise ValueError(f"Unsupported GPT-2 activation {hf_config.activation_function!r}")

    n_heads = int(hf_config.n_head)
    cfg = TransformerConfig(
        vocab_size=int(hf_config.vocab_size), d_model=int(hf_config.n_embd),
        n_heads=n_heads, n_layers=int(hf_config.n_layer),
        d_ff=int(getattr(hf_config, "n_inner", None) or 4 * hf_config.n_embd),
        max_len=int(hf_config.n_positions), causal=True,
        ln_eps=float(hf_config.layer_norm_epsilon), activation="gelu", dtype="float32",
    )
    d = cfg.d_model
    blocks = {}
    for i in range(cfg.n_layers):
        p = f"h.{i}"
        # GPT-2's Conv1D stores weight [in, out]: already Flax's orientation.
        w, b = state[f"{p}.attn.c_attn.weight"], state[f"{p}.attn.c_attn.bias"]
        blocks[f"block_{i}"] = {
            "ln_attn": _ln(state, f"{p}.ln_1"),
            "attn": _attn_params(w[:, :d], w[:, d:2 * d], w[:, 2 * d:],
                                 state[f"{p}.attn.c_proj.weight"],
                                 b[:d], b[d:2 * d], b[2 * d:],
                                 state[f"{p}.attn.c_proj.bias"], n_heads),
            "ln_mlp": _ln(state, f"{p}.ln_2"),
            "mlp": {"fc_in": {"kernel": state[f"{p}.mlp.c_fc.weight"],
                              "bias": state[f"{p}.mlp.c_fc.bias"]},
                    "fc_out": {"kernel": state[f"{p}.mlp.c_proj.weight"],
                               "bias": state[f"{p}.mlp.c_proj.bias"]}},
        }
    tree = {"params": {"wte": {"embedding": state["wte.weight"]},
                       "wpe": {"embedding": state["wpe.weight"]},
                       "encoder": {**blocks, "ln_final": _ln(state, "ln_f")}}}
    return cfg, tree


def import_gpt2(model_or_state: Any, hf_config: Any = None,
                device: DeviceLike = None) -> Tuple[TransformerConfig, CausalLM]:
    """An HF ``GPT2LMHeadModel`` as ``(TransformerConfig, CausalLM)`` whose
    logits reproduce the HF model's (f32).  ``hf_config`` is needed only
    when a bare state dict is passed."""
    cfg, tree = gpt2_tree(model_or_state, hf_config)
    return cfg, _place(CausalLM(cfg), tree, device)


# ---------------------------------------------------------------------------
# CLIP -> CLIPDualEncoder
# ---------------------------------------------------------------------------


def clip_tree(model_or_state: Any, hf_config: Any = None) -> Tuple[CLIPConfig, dict]:
    """An HF ``CLIPModel`` as ``(CLIPConfig, {"params": tree})`` in the
    reference's ``CLIPDualEncoder`` layout (quick_gelu, the config's ln_eps,
    the vision tower's pre-LN)."""
    if hf_config is None:
        hf_config = model_or_state.config
    state = _to_numpy_state(model_or_state)
    tc, vc = hf_config.text_config, hf_config.vision_config
    act = {"quick_gelu": "quick_gelu", "gelu": "gelu_exact"}.get(tc.hidden_act)
    if act is None:
        raise ValueError(f"Unsupported CLIP activation {tc.hidden_act!r}")
    cfg = CLIPConfig(
        vocab_size=int(tc.vocab_size), text_len=int(tc.max_position_embeddings),
        d_text=int(tc.hidden_size), text_heads=int(tc.num_attention_heads),
        text_layers=int(tc.num_hidden_layers), image_size=int(vc.image_size),
        patch_size=int(vc.patch_size), d_image=int(vc.hidden_size),
        image_heads=int(vc.num_attention_heads), image_layers=int(vc.num_hidden_layers),
        d_embed=int(hf_config.projection_dim), ln_eps=float(tc.layer_norm_eps),
        activation=act, image_pre_ln=True, text_ff=int(tc.intermediate_size),
        image_ff=int(vc.intermediate_size), dtype="float32",
    )

    def tower_blocks(prefix: str, n_layers: int, n_heads: int) -> dict:
        blocks = {}
        for i in range(n_layers):
            p = f"{prefix}.encoder.layers.{i}"
            q, k, v, o = (_linear(state, f"{p}.self_attn.{n}")
                          for n in ("q_proj", "k_proj", "v_proj", "out_proj"))
            blocks[f"block_{i}"] = {
                "ln_attn": _ln(state, f"{p}.layer_norm1"),
                "attn": _attn_params(q["kernel"], k["kernel"], v["kernel"], o["kernel"],
                                     q["bias"], k["bias"], v["bias"], o["bias"], n_heads),
                "ln_mlp": _ln(state, f"{p}.layer_norm2"),
                "mlp": {"fc_in": _linear(state, f"{p}.mlp.fc1"),
                        "fc_out": _linear(state, f"{p}.mlp.fc2")},
            }
        return blocks

    emb = "text_model.embeddings"
    text = {
        "wte": {"embedding": state[f"{emb}.token_embedding.weight"]},
        "wpe": {"embedding": state[f"{emb}.position_embedding.weight"]},
        "encoder": {**tower_blocks("text_model", cfg.text_layers, cfg.text_heads),
                    "ln_final": _ln(state, "text_model.final_layer_norm")},
        "text_proj": {"kernel": state["text_projection.weight"].T},
    }
    d_im = cfg.d_image
    emb = "vision_model.embeddings"
    image = {
        "cls": state[f"{emb}.class_embedding"].reshape(1, 1, d_im),
        "pos": state[f"{emb}.position_embedding.weight"],
        # CLIP's patch conv has no bias; the Dense here has one: zero it.
        "patch_embed": {"kernel": _conv_patch_embed(state[f"{emb}.patch_embedding.weight"]),
                        "bias": state.get(f"{emb}.patch_embedding.bias",
                                          np.zeros(d_im, np.float32))},
        "pre_ln": _ln(state, "vision_model.pre_layrnorm"),
        "encoder": {**tower_blocks("vision_model", cfg.image_layers, cfg.image_heads),
                    "ln_final": _ln(state, "vision_model.post_layernorm")},
        "image_proj": {"kernel": state["visual_projection.weight"].T},
    }
    tree = {"params": {"text_tower": text, "image_tower": image,
                       "logit_scale": state["logit_scale"].reshape(())}}
    return cfg, tree


def import_clip(model_or_state: Any, hf_config: Any = None,
                device: DeviceLike = None) -> Tuple[CLIPConfig, CLIPDualEncoder]:
    """An HF ``CLIPModel`` as ``(CLIPConfig, CLIPDualEncoder)`` reproducing
    HF's text and image embeddings.  Text pooling matches HF when the EOS
    token is the last valid (unpadded) token, as the port's tokenizers emit
    CLIP text batches."""
    cfg, tree = clip_tree(model_or_state, hf_config)
    return cfg, _place(CLIPDualEncoder(cfg), tree, device)


# ---------------------------------------------------------------------------
# ViT-MAE -> ViTMAE
# ---------------------------------------------------------------------------


def vit_mae_tree(model_or_state: Any, hf_config: Any = None) -> Tuple[MAEConfig, dict]:
    """An HF ``ViTMAEForPreTraining`` as ``(MAEConfig, {"params": tree})`` in
    the reference's ``ViTMAE`` layout (``use_cls=True``, the fixed sincos
    position tables imported as constants)."""
    if hf_config is None:
        hf_config = model_or_state.config
    state = _to_numpy_state(model_or_state)
    if hf_config.hidden_act not in ("gelu",):
        raise ValueError(f"Unsupported MAE activation {hf_config.hidden_act!r}")
    cfg = MAEConfig(
        image_size=int(hf_config.image_size), patch_size=int(hf_config.patch_size),
        d_model=int(hf_config.hidden_size), n_heads=int(hf_config.num_attention_heads),
        n_layers=int(hf_config.num_hidden_layers), d_ff=int(hf_config.intermediate_size),
        dec_d_model=int(hf_config.decoder_hidden_size),
        dec_n_heads=int(hf_config.decoder_num_attention_heads),
        dec_n_layers=int(hf_config.decoder_num_hidden_layers),
        dec_d_ff=int(hf_config.decoder_intermediate_size),
        mask_ratio=float(hf_config.mask_ratio), norm_pix=bool(hf_config.norm_pix_loss),
        ln_eps=float(hf_config.layer_norm_eps), activation="gelu_exact", use_cls=True,
        dtype="float32",
    )

    def vit_blocks(prefix: str, n_layers: int, n_heads: int) -> dict:
        blocks = {}
        for i in range(n_layers):
            p = f"{prefix}.{i}"
            q, k, v = (_linear(state, f"{p}.attention.attention.{n}")
                       for n in ("query", "key", "value"))
            o = _linear(state, f"{p}.attention.output.dense")
            blocks[f"block_{i}"] = {
                "ln_attn": _ln(state, f"{p}.layernorm_before"),
                "attn": _attn_params(q["kernel"], k["kernel"], v["kernel"], o["kernel"],
                                     q["bias"], k["bias"], v["bias"], o["bias"], n_heads),
                "ln_mlp": _ln(state, f"{p}.layernorm_after"),
                "mlp": {"fc_in": _linear(state, f"{p}.intermediate.dense"),
                        "fc_out": _linear(state, f"{p}.output.dense")},
            }
        return blocks

    proj = "vit.embeddings.patch_embeddings.projection"
    tree = {"params": {
        "cls": state["vit.embeddings.cls_token"],
        "enc_pos": state["vit.embeddings.position_embeddings"][0],  # [P+1, d]
        "patch_embed": {"kernel": _conv_patch_embed(state[f"{proj}.weight"]),
                        "bias": state[f"{proj}.bias"]},
        "encoder": {**vit_blocks("vit.encoder.layer", cfg.n_layers, cfg.n_heads),
                    "ln_final": _ln(state, "vit.layernorm")},
        "dec_embed": _linear(state, "decoder.decoder_embed"),
        "mask_token": state["decoder.mask_token"],
        "dec_pos": state["decoder.decoder_pos_embed"][0],           # [P+1, dd]
        "decoder": {**vit_blocks("decoder.decoder_layers", cfg.dec_n_layers, cfg.dec_n_heads),
                    "ln_final": _ln(state, "decoder.decoder_norm")},
        "dec_pred": _linear(state, "decoder.decoder_pred"),
    }}
    return cfg, tree


def import_vit_mae(model_or_state: Any, hf_config: Any = None,
                   device: DeviceLike = None) -> Tuple[MAEConfig, ViTMAE]:
    """An HF ``ViTMAEForPreTraining`` as ``(MAEConfig, ViTMAE)`` reproducing
    HF's per-patch reconstruction losses given the same masking noise."""
    cfg, tree = vit_mae_tree(model_or_state, hf_config)
    return cfg, _place(ViTMAE(cfg), tree, device)


# ---------------------------------------------------------------------------
# One-call conversion
# ---------------------------------------------------------------------------

_IMPORTERS = {"gpt2": import_gpt2, "clip": import_clip, "vit-mae": import_vit_mae}


def convert_pretrained(name_or_path: str, kind: str, out_path: Any,
                       device: DeviceLike = None) -> dict:
    """Load an HF checkpoint (local directory or cached hub name) through
    ``transformers``, import it, save it with
    :func:`~.registry.save_params` and write its sidecar; returns a summary."""
    from .registry import save_params

    kind = kind.lower()
    if kind not in _IMPORTERS:
        raise ValueError(f"kind must be one of {sorted(_IMPORTERS)}")
    if kind == "gpt2":
        from transformers import GPT2LMHeadModel as Cls
    elif kind == "clip":
        from transformers import CLIPModel as Cls
    else:
        from transformers import ViTMAEForPreTraining as Cls
    cfg, model = _IMPORTERS[kind](Cls.from_pretrained(name_or_path), device=device)
    save_params(model, out_path)
    sidecar = write_sidecar_config(out_path, kind, cfg)
    return {"kind": kind, "source": name_or_path, "out": str(out_path),
            "config": cfg.__class__.__name__, "sidecar": str(sidecar)}


def write_sidecar_config(out_path: Any, kind: str, cfg: Any) -> Path:
    """Write ``<checkpoint>.config.json`` with the exact architecture; the
    estimators read it when given ``checkpoint=``, so an imported model runs
    with its true config (ln_eps, activation, dims), not the nearest preset."""
    sidecar = Path(str(out_path) + ".config.json")
    sidecar.write_text(json.dumps({"kind": kind, "config": dataclasses.asdict(cfg)}),
                       encoding="utf-8")
    return sidecar


def sidecar_config(checkpoint: Any) -> Optional[dict]:
    """The sidecar written beside ``checkpoint``, or None."""
    if checkpoint is None:
        return None
    p = Path(str(checkpoint) + ".config.json")
    if not p.exists():
        return None
    return json.loads(p.read_text(encoding="utf-8"))


__all__ = [
    "import_gpt2", "import_clip", "import_vit_mae",
    "gpt2_tree", "clip_tree", "vit_mae_tree",
    "convert_pretrained", "write_sidecar_config", "sidecar_config",
]
