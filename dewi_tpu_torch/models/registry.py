"""Model presets, seeded init, and checkpoint save/load.

Counterpart of ``dewi_tpu/models/registry.py``: the same named presets and
config functions; ``init_*`` build a model on a device with Flax's
initializers *by distribution* (``lecun_normal`` truncated normals for
Dense kernels, Flax's ``Embed`` default for embeddings, normal(0.02) for
the position, CLS and mask parameters, zero biases, unit LayerNorm
scales).  The random stream is PyTorch's, so a seeded model here is not the
reference's model for the same seed; weights cross between the packages
only through checkpoints or :mod:`dewi_tpu_torch.convert`.

The text-entropy LM may also be a Moonlight preset (``MOONLIGHT_PRESETS``,
``models/moonlight.py``): ``init_moonlight`` builds it on its device in its
own dtype, with no draw on the CPU; it has no checkpoint layout.

Checkpoints are the reference's msgpack files (``flax.serialization``
layout), read and written by :mod:`dewi_tpu_torch.utils.msgpack`.  The
reference's orbax checkpoint directories are read too, through
``tensorstore`` (imported only then); they are not written.
"""

from __future__ import annotations

import hashlib
import json
import math
from pathlib import Path
from typing import Any, Optional, Union

import torch
from torch import nn

from ..utils.device import DeviceLike, resolve_device
from ..utils.msgpack import packb, unpackb
from .clip import CLIPConfig, CLIPDualEncoder
from .lm import CausalLM
from .mae import MAEConfig, ViTMAE
from .moe import MoECausalLM
from .moonlight import MOONLIGHT_PRESETS, init_moonlight, moonlight_config
from .transformer import TransformerConfig

PathLike = Union[str, Path]

LM_PRESETS = {
    "tiny": dict(d_model=64, n_heads=2, n_layers=2, d_ff=256, max_len=128),
    "small": dict(d_model=256, n_heads=4, n_layers=4, d_ff=1024, max_len=512),
    "base": dict(d_model=768, n_heads=12, n_layers=12, d_ff=3072, max_len=1024),
    "gpt2": dict(d_model=768, n_heads=12, n_layers=12, d_ff=3072, max_len=1024),
    "distilroberta-base": dict(
        d_model=768, n_heads=12, n_layers=6, d_ff=3072, max_len=512
    ),
}

MAE_PRESETS = {
    "tiny": dict(
        image_size=32, patch_size=8, d_model=64, n_heads=2, n_layers=2,
        d_ff=256, dec_d_model=64, dec_n_heads=2, dec_n_layers=1, dec_d_ff=256,
    ),
    "small": dict(
        image_size=224, patch_size=16, d_model=256, n_heads=4, n_layers=4,
        d_ff=1024, dec_d_model=128, dec_n_heads=4, dec_n_layers=2, dec_d_ff=512,
    ),
    "base": dict(
        image_size=224, patch_size=16, d_model=768, n_heads=12, n_layers=12,
        d_ff=3072, dec_d_model=512, dec_n_heads=16, dec_n_layers=8, dec_d_ff=2048,
    ),
}
MAE_PRESETS["vit-mae-base"] = MAE_PRESETS["base"]
MAE_PRESETS["facebook/vit-mae-base"] = MAE_PRESETS["base"]

CLIP_PRESETS = {
    "tiny": dict(
        text_len=32, d_text=64, text_heads=2, text_layers=2,
        image_size=32, patch_size=8, d_image=64, image_heads=2, image_layers=2,
        d_embed=64,
    ),
    "small": dict(
        text_len=77, d_text=256, text_heads=4, text_layers=4,
        image_size=224, patch_size=32, d_image=256, image_heads=4,
        image_layers=4, d_embed=256,
    ),
    "base": dict(
        text_len=77, d_text=512, text_heads=8, text_layers=12,
        image_size=224, patch_size=32, d_image=768, image_heads=12,
        image_layers=12, d_embed=512,
    ),
}
CLIP_PRESETS["clip-vit-base-patch32"] = CLIP_PRESETS["base"]
CLIP_PRESETS["openai/clip-vit-base-patch32"] = CLIP_PRESETS["base"]


def _preset(table: dict, name: str, kind: str) -> dict:
    if name not in table:
        raise ValueError(
            f"Unknown {kind} preset {name!r}; choose from {sorted(table)}"
        )
    return dict(table[name])


def lm_config(name: str = "small", vocab_size: int = 258,
              **over: Any) -> TransformerConfig:
    kw = _preset(LM_PRESETS, name, "LM")
    kw.update(over)
    return TransformerConfig(vocab_size=vocab_size, causal=True, **kw)


def mae_config(name: str = "small", **over: Any) -> MAEConfig:
    kw = _preset(MAE_PRESETS, name, "MAE")
    kw.update(over)
    return MAEConfig(**kw)


def clip_config(name: str = "small", vocab_size: int = 258,
                **over: Any) -> CLIPConfig:
    kw = _preset(CLIP_PRESETS, name, "CLIP")
    kw.update(over)
    return CLIPConfig(vocab_size=vocab_size, **kw)


# ---------------------------------------------------------------------------
# Init + checkpoints
# ---------------------------------------------------------------------------

# Flax's raw parameters initialised by normal(0.02); logit_scale is a constant.
_NORMAL_002 = ("enc_pos", "dec_pos", "mask_token", "cls", "pos")
# The MoE's stacked expert kernels [E, in, out]: lecun_normal, whose fan_in
# counts the leading axes with the input axis.
_STACKED_KERNELS = ("w_in", "w_out")


@torch.no_grad()
def _flax_init(model: nn.Module, seed: int, device: DeviceLike) -> nn.Module:
    """Draw every parameter as Flax's default initializers would, on the CPU
    from ``seed`` (so the CPU and the card hold the same weights), then move
    the model to ``device`` in eval mode."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    for m in model.modules():
        if isinstance(m, nn.Linear):  # lecun_normal: fan_in, truncated at 2 sd
            sd = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, std=sd, a=-2 * sd, b=2 * sd, generator=g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):  # variance_scaling(1, fan_in, normal)
            m.weight.normal_(0.0, math.sqrt(1.0 / m.embedding_dim), generator=g)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        for name, p in m.named_parameters(recurse=False):
            if name in _NORMAL_002:
                p.normal_(0.0, 0.02, generator=g)
            elif name in _STACKED_KERNELS:
                sd = math.sqrt(1.0 / (p.numel() // p.shape[-1])) / 0.87962566103423978
                nn.init.trunc_normal_(p, std=sd, a=-2 * sd, b=2 * sd, generator=g)
            elif name == "logit_scale":
                p.fill_(math.log(1 / 0.07))
    return model.to(dev).eval()


def init_lm(cfg: TransformerConfig, seed: int = 0, device: DeviceLike = None) -> CausalLM:
    return _flax_init(CausalLM(cfg), seed, device)


def init_mae(cfg: MAEConfig, seed: int = 0, device: DeviceLike = None) -> ViTMAE:
    return _flax_init(ViTMAE(cfg), seed, device)


def init_clip(cfg: CLIPConfig, seed: int = 0, device: DeviceLike = None) -> CLIPDualEncoder:
    return _flax_init(CLIPDualEncoder(cfg), seed, device)


def init_moe_lm(cfg: TransformerConfig, n_experts: int = 4, capacity_factor: float = 1.25,
                seed: int = 0, device: DeviceLike = None) -> MoECausalLM:
    return _flax_init(MoECausalLM(cfg, n_experts, capacity_factor), seed, device)


def _is_orbax_path(path: PathLike) -> bool:
    """The reference's rule: a path with no suffix (``ckpt``, ``ckpt/``) or an
    existing directory is an orbax checkpoint."""
    path = Path(path)
    return path.suffix == "" or path.is_dir()


def refuse_orbax_write(path: Optional[PathLike]) -> None:
    """Raise for a checkpoint path that ``save_params`` would have to write
    as an orbax directory (no suffix, or an existing directory).
    The training loops call it before their first step."""
    if path is not None and _is_orbax_path(path):
        raise NotImplementedError(
            f"{path}: dewi_tpu_torch reads orbax checkpoint directories but does "
            "not write them (ROADMAP.md section 3, deliberate differences); save "
            "to a msgpack file instead, a path with a suffix such as "
            "'model.msgpack', which both packages load"
        )


def _read_orbax(path: Path) -> dict:
    """The ``{"params": ...}`` tree of an orbax ``StandardCheckpointer``
    directory (OCDBT layout, orbax's default), read leaf by leaf with
    ``tensorstore``."""
    root = path.resolve()
    meta_file = root / "_METADATA"
    if not meta_file.is_file():
        raise FileNotFoundError(f"{path}: not an orbax checkpoint (no _METADATA)")
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            f"{path}: reading an orbax checkpoint directory needs the "
            "'tensorstore' package, which is not installed; install it, or "
            "convert the directory to a msgpack file (a path with a suffix) "
            "with the reference's load_params and save_params"
        ) from e
    meta = json.loads(meta_file.read_text())
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{path}: only orbax's OCDBT layout is read (use_ocdbt: true)")
    array_format = "zarr3" if meta.get("use_zarr3", False) else "zarr"
    keys, reads = [], []
    for leaf in meta["tree_metadata"].values():
        key = [str(k["key"]) for k in leaf["key_metadata"]]
        spec = {"driver": array_format, "kvstore": {"driver": "ocdbt", "base": f"file://{root}/",
                                              "path": ".".join(key)}}
        keys.append(key)
        reads.append(ts.open(spec, open=True, read=True).result().read())
    tree: dict = {}
    for key, fut in zip(keys, reads):
        node = tree
        for k in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1]] = fut.result()
    return tree


def _converters(model: nn.Module) -> tuple:
    from .. import convert

    table = {CausalLM: (convert.lm_params_to_flax, convert.lm_params_from_flax),
             ViTMAE: (convert.mae_params_to_flax, convert.mae_params_from_flax),
             CLIPDualEncoder: (convert.clip_params_to_flax, convert.clip_params_from_flax),
             MoECausalLM: (convert.moe_lm_params_to_flax, convert.moe_lm_params_from_flax)}
    if type(model) not in table:
        raise TypeError(f"no checkpoint layout for {type(model).__name__}")
    return table[type(model)]


def refuse_sharded_write(model: nn.Module, path: Optional[PathLike]) -> None:
    """Raise when ``path`` is set and ``model`` holds a rank's shards
    (``parallel.tp.shard_params``, ``shard_expert_params``): its tensors
    are slices, and a checkpoint of them would not load as the model."""
    from ..parallel.mesh import shard_group

    if path is not None and any(shard_group(p) is not None for p in model.parameters()):
        raise ValueError(f"{path}: a model sharded over a mesh holds this rank's slices; "
                         "save the unsharded model")


def save_params(model: nn.Module, path: PathLike) -> None:
    """Write ``model``'s weights as the reference's msgpack checkpoint: the
    ``{"params": ...}`` tree its ``init_*`` returns, which its ``load_params``
    reads into the same architecture.  An orbax directory path (no suffix,
    or an existing directory) raises: the port does not write that format;
    so does a model sharded over a mesh."""
    refuse_orbax_write(path)
    refuse_sharded_write(model, path)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(packb(_converters(model)[0](model)))


def load_params(model: nn.Module, path: PathLike) -> nn.Module:
    """Read a checkpoint (the reference's or the port's) into ``model``, in
    place, and return it: a msgpack file, or, for a path with no suffix or
    an existing directory, the reference's orbax directory.  Every parameter
    must be present with its shape (``load_state_dict(strict=True)``)."""
    if _is_orbax_path(path):
        tree = _read_orbax(Path(path))
    else:
        tree = unpackb(Path(path).read_bytes())
    state = _converters(model)[1](tree)
    dev = next(model.parameters()).device
    model.load_state_dict({k: v.to(dev) for k, v in state.items()}, strict=True)
    return model


def maybe_load(model: nn.Module, checkpoint: Optional[PathLike]) -> nn.Module:
    return model if checkpoint is None else load_params(model, checkpoint)


def param_count(model: nn.Module) -> int:
    return int(sum(p.numel() for p in model.parameters()))


def checkpoint_fingerprint(path: Optional[PathLike]) -> Optional[str]:
    """Cheap stable fingerprint of a checkpoint for provenance records.

    Files: sha256 of (size || first 8 MiB).  Directories: sha256 of the
    sorted (relative-name, size) manifest.  None for a missing/None path:
    callers treat a None fingerprint as "unverifiable", not as a mismatch.
    """
    if path is None:
        return None
    p = Path(path)
    h = hashlib.sha256()
    if p.is_file():
        h.update(str(p.stat().st_size).encode())
        with open(p, "rb") as f:
            h.update(f.read(8 << 20))
        return h.hexdigest()[:16]
    if p.is_dir():
        for sub in sorted(p.rglob("*")):
            if sub.is_file():
                h.update(str(sub.relative_to(p)).encode())
                h.update(str(sub.stat().st_size).encode())
        return h.hexdigest()[:16]
    return None


__all__ = [
    "LM_PRESETS", "MAE_PRESETS", "CLIP_PRESETS", "MOONLIGHT_PRESETS",
    "lm_config", "mae_config", "clip_config", "moonlight_config",
    "init_lm", "init_mae", "init_clip", "init_moe_lm", "init_moonlight",
    "save_params", "load_params", "maybe_load", "refuse_orbax_write", "refuse_sharded_write",
    "param_count", "checkpoint_fingerprint",
]
