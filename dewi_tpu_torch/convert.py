"""Carry a JAX-package index's state across to the port as numpy arrays.

``index_from_numpy_state`` builds a port ``DewiIndex`` that searches the
very same corpus, quantized codes and payloads as the JAX index it came
from: the ``DocStore.device_arrays()`` tuple (normalized, cast rows, their
squared norms, payloads, ``n_valid``) and, for the quantized tiers,
``QuantizedIndex._q_emb``/``_q_scales``, all as numpy.
``ivf_index_from_numpy_state`` also takes the JAX ``IVFIndex._dev`` tuple,
so the port searches the very same buckets.  ``stats_from_numpy_state``
does the same for fitted ``RobustStats``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from torch import nn

from .index.facade import DewiIndex
from .models.clip import CLIPDualEncoder
from .models.lm import CausalLM
from .models.mae import ViTMAE
from .models.moe import MoECausalLM
from .models.transformer import Attention
from .index.quantized import QuantizedIndex
from .scorer import RobustStats
from .types import SIGNAL_FIELDS
from .utils.device import DeviceLike

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16 from a JAX array
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)  # a writable copy


def index_from_numpy_state(
    doc_ids: Sequence[str],
    device_arrays: Sequence[Any],
    *,
    space: str = "cosine",
    backend: str = "exact",
    q_emb: Optional[Any] = None,
    q_scales: Optional[Any] = None,
    device: DeviceLike = None,
    **index_kwargs: Any,
) -> DewiIndex:
    """Build a port index from ``(emb, sqnorms, payloads, n_valid)`` arrays.

    ``emb`` is ``[cap, D]`` float32 or bfloat16 (the store's dtype follows
    it); ``q_emb``/``q_scales`` are the quantized tier's stage-1 arrays
    (``[cap, D]`` int8, or ``[cap, D/2]`` packed int4 for ``backend="int4"``).
    The host mirror holds the given (already normalized) rows, so a later
    rebuild reproduces them.
    """
    emb, sqn, pay, n = device_arrays
    n = int(np.asarray(n))
    emb_np = np.asarray(emb)
    dtype = _DTYPES[emb_np.dtype.name]
    index = DewiIndex(dim=emb_np.shape[1], space=space, backend=backend,
                      device=device, dtype=dtype, capacity=emb_np.shape[0],
                      **index_kwargs)
    store = index._backend.store
    pay_np = np.asarray(pay, dtype=np.float32)
    store.add_batch(list(doc_ids), emb_np.astype(np.float32)[:n], pay_np[:n])
    dev = store.device
    store.set_device_arrays((_tensor(emb, dev), _tensor(sqn, dev),
                             _tensor(pay_np, dev), n))
    backend_obj = index._backend
    if isinstance(backend_obj, QuantizedIndex):
        if q_emb is None or q_scales is None:
            raise ValueError("a quantized index needs q_emb and q_scales")
        backend_obj._q_emb = _tensor(q_emb, dev).to(torch.int8).contiguous()
        backend_obj._q_scales = _tensor(q_scales, dev).to(torch.float32).contiguous()
        backend_obj._built_len = len(store)
    backend_obj._is_trained = True
    index._built = True
    return index


def ivf_index_from_numpy_state(
    doc_ids: Sequence[str],
    device_arrays: Sequence[Any],
    ivf_state: Sequence[Any],
    *,
    space: str = "cosine",
    device: DeviceLike = None,
    **index_kwargs: Any,
) -> DewiIndex:
    """Build a port IVF index from the store's arrays and the ``_dev`` tuple.

    ``ivf_state`` is the JAX ``IVFIndex._dev`` as numpy: centroids, the five
    bucket arrays (``b_emb``, ``b_pay``, ``b_valid``, ``b_docidx``,
    ``b_sqn``), the four overflow arrays (``o_emb``, ``o_pay``,
    ``o_docidx``, ``o_sqn``) and the overflow count ``o_n``.  The index is
    marked built, so it searches these buckets until a document is added.
    ``index_kwargs`` are the ``IVFIndex`` hyperparameters (``nlist``,
    ``nprobe``, ``spill_frac``, ...), which the search reads.
    """
    if len(ivf_state) != 11:
        raise ValueError(f"an IVF state has 11 arrays, got {len(ivf_state)}")
    index = index_from_numpy_state(doc_ids, device_arrays, space=space, backend="ivf",
                                   device=device, **index_kwargs)
    ivf = index._backend
    dev = ivf.device
    cent, b_emb, b_pay, b_valid, b_docidx, b_sqn, o_emb, o_pay, o_docidx, o_sqn, o_n = ivf_state
    ivf._dev = (
        _tensor(cent, dev).to(torch.float32), _tensor(b_emb, dev),
        _tensor(b_pay, dev).to(torch.float32), _tensor(b_valid, dev).to(torch.bool),
        _tensor(b_docidx, dev).to(torch.int32), _tensor(b_sqn, dev).to(torch.float32),
        _tensor(o_emb, dev), _tensor(o_pay, dev).to(torch.float32),
        _tensor(o_docidx, dev).to(torch.int32), _tensor(o_sqn, dev).to(torch.float32),
        int(np.asarray(o_n)),
    )
    ivf._built_len = len(ivf.store)
    return index


def stats_from_numpy_state(medians: Any, mads: Any,
                           keys: Sequence[str] = SIGNAL_FIELDS) -> RobustStats:
    """``RobustStats`` from per-key median and MAD arrays (or dicts)."""
    if isinstance(medians, dict):
        return RobustStats(medians={k: float(medians[k]) for k in keys},
                           mads={k: float(mads[k]) for k in keys}, keys=tuple(keys))
    med = np.asarray(medians, np.float32)
    mad = np.asarray(mads, np.float32)
    return RobustStats(medians={k: float(v) for k, v in zip(keys, med)},
                       mads={k: float(v) for k, v in zip(keys, mad)},
                       keys=tuple(keys))


# ---- Flax param trees <-> the signal models' state dicts -------------------

_QKV = ("query", "key", "value")


def _state_from_flax(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for name, sub in tree.items():
        key = prefix + name
        if not isinstance(sub, dict):  # a raw parameter (positions, CLS, ...)
            out[key] = _param(sub)
        elif "kernel" in sub and set(sub) <= {"kernel", "bias"}:  # Dense(General)
            k = np.asarray(sub["kernel"])
            if name in _QKV and k.ndim == 3:      # [d, H, hd] -> [H*hd, d]
                w = k.reshape(k.shape[0], -1).T
            elif k.ndim == 3:                     # out: [H, hd, d] -> [d, H*hd]
                w = k.reshape(-1, k.shape[-1]).T
            else:                                 # Dense: [in, out] -> [out, in]
                w = k.T
            out[key + ".weight"] = _param(w)
            if "bias" in sub:
                out[key + ".bias"] = _param(np.asarray(sub["bias"]).reshape(-1))
        elif set(sub) == {"embedding"}:
            out[key + ".weight"] = _param(sub["embedding"])
        elif set(sub) == {"scale", "bias"}:
            out[key + ".weight"] = _param(sub["scale"])
            out[key + ".bias"] = _param(sub["bias"])
        else:
            out.update(_state_from_flax(sub, key + "."))
    return out


def _param(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _module_to_flax(module: nn.Module) -> dict:
    tree: dict = {name: _np(p) for name, p in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        if isinstance(child, Attention):
            h, hd = child.n_heads, child.head_dim
            sub = {}
            for part in _QKV:
                lin = getattr(child, part)
                sub[part] = {"kernel": _np(lin.weight).T.reshape(-1, h, hd),
                             "bias": _np(lin.bias).reshape(h, hd)}
            sub["out"] = {"kernel": _np(child.out.weight).T.reshape(h, hd, -1),
                          "bias": _np(child.out.bias)}
            tree[name] = sub
        elif isinstance(child, nn.Linear):
            tree[name] = {"kernel": np.ascontiguousarray(_np(child.weight).T)}
            if child.bias is not None:
                tree[name]["bias"] = _np(child.bias)
        elif isinstance(child, nn.Embedding):
            tree[name] = {"embedding": _np(child.weight)}
        elif isinstance(child, nn.LayerNorm):
            tree[name] = {"scale": _np(child.weight), "bias": _np(child.bias)}
        else:
            tree[name] = _module_to_flax(child)
    return tree


def _from_flax(tree: dict, kind: str, keys: Sequence[str]) -> Dict[str, torch.Tensor]:
    params = tree.get("params", tree)
    missing = [k for k in keys if k not in params]
    if missing:
        raise ValueError(f"not a {kind} param tree: it lacks {missing} "
                         f"(top-level keys {sorted(params)})")
    return _state_from_flax(params)


def _to_flax(model: nn.Module, cls: type) -> dict:
    if not isinstance(model, cls):
        raise TypeError(f"expected a {cls.__name__}, got {type(model).__name__}")
    return {"params": _module_to_flax(model)}


def lm_params_from_flax(tree: dict) -> Dict[str, torch.Tensor]:
    """A ``CausalLM`` state dict from the reference's ``init_lm`` param tree."""
    return _from_flax(tree, "causal LM", ("wte", "wpe", "encoder"))


def stacked_blocks_from_flax(stacked: dict) -> Dict[str, torch.Tensor]:
    """The pipeline's stacked block params (``parallel.pp.stack_block_params``)
    from the reference's: one ``Block`` tree whose leaves carry a leading
    ``[L, ...]`` layer axis, each layer converted as ``lm_params_from_flax``
    converts a block."""
    n_layers = int(np.asarray(next(iter(_leaves(stacked)))).shape[0])
    layers = [_state_from_flax(_index_tree(stacked, i)) for i in range(n_layers)]
    return {k: torch.stack([layer[k] for layer in layers]) for k in layers[0]}


def _leaves(tree: dict) -> Any:
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _index_tree(tree: dict, i: int) -> dict:
    return {k: _index_tree(v, i) if isinstance(v, dict) else np.asarray(v)[i]
            for k, v in tree.items()}


def mae_params_from_flax(tree: dict) -> Dict[str, torch.Tensor]:
    """A ``ViTMAE`` state dict from the reference's ``init_mae`` param tree."""
    return _from_flax(tree, "ViT-MAE", ("patch_embed", "encoder", "decoder", "mask_token"))


def clip_params_from_flax(tree: dict) -> Dict[str, torch.Tensor]:
    """A ``CLIPDualEncoder`` state dict from the reference's ``init_clip`` tree."""
    return _from_flax(tree, "CLIP", ("text_tower", "image_tower", "logit_scale"))


def moe_lm_params_from_flax(tree: dict) -> Dict[str, torch.Tensor]:
    """A ``MoECausalLM`` state dict from the reference's ``MoECausalLM`` tree:
    ``block_i/{ln_attn,attn,ln_mlp}`` as in the causal LM, ``moe/router`` a
    Dense kernel ``[d, E]`` (a Linear weight ``[E, d]``), and the stacked
    expert leaves ``w_in``, ``b_in``, ``w_out``, ``b_out`` kept as they are."""
    return _from_flax(tree, "MoE causal LM", ("wte", "wpe", "block_0", "ln_final"))


def lm_params_to_flax(model: CausalLM) -> dict:
    """``{"params": tree}`` as the reference's ``init_lm`` lays it out."""
    return _to_flax(model, CausalLM)


def mae_params_to_flax(model: ViTMAE) -> dict:
    """``{"params": tree}`` as the reference's ``init_mae`` lays it out."""
    return _to_flax(model, ViTMAE)


def clip_params_to_flax(model: CLIPDualEncoder) -> dict:
    """``{"params": tree}`` as the reference's ``init_clip`` lays it out."""
    return _to_flax(model, CLIPDualEncoder)


def moe_lm_params_to_flax(model: MoECausalLM) -> dict:
    """``{"params": tree}`` as the reference's ``MoECausalLM.init`` lays it out."""
    return _to_flax(model, MoECausalLM)


__all__ = ["index_from_numpy_state", "ivf_index_from_numpy_state",
           "stats_from_numpy_state", "lm_params_from_flax", "mae_params_from_flax",
           "clip_params_from_flax", "lm_params_to_flax", "mae_params_to_flax",
           "clip_params_to_flax", "moe_lm_params_from_flax", "moe_lm_params_to_flax",
           "stacked_blocks_from_flax"]
