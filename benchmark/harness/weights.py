"""Seeded weights of the corpus deployment's backbones, made on the device.

The layouts are the parameter names and shapes of the port's modules at
the configuration's widths, which is how the weights are handed to the
program (``load_state_dict(strict=True)``, so a layout that disagrees with
the program's fails at once).  Each model's values come from one
``torch.randn`` on a generator seeded from the run's seed, then scaled per
leaf: a linear kernel by ``1/sqrt(fan_in)``, an embedding by
``1/sqrt(width)`` (both ``"fan_in"``: the second axis), biases, LayerNorm shifts and positions by 0.02, and
LayerNorm scales as ``1 + 0.02 n``.  float32, the type the program holds
its parameters in.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

Layout = List[Tuple[str, Tuple[int, ...], str]]


def _linear(name: str, n_in: int, n_out: int, bias: bool = True) -> Layout:
    out: Layout = [(f"{name}.weight", (n_out, n_in), "fan_in")]
    return out + ([(f"{name}.bias", (n_out,), "small")] if bias else [])


def _ln(name: str, d: int) -> Layout:
    return [(f"{name}.weight", (d,), "scale"), (f"{name}.bias", (d,), "small")]


def _encoder(p: str, layers: int, d: int, ff: int) -> Layout:
    out: Layout = []
    for i in range(layers):
        b = f"{p}.block_{i}"
        out += _ln(f"{b}.ln_attn", d)
        for n in ("query", "key", "value", "out"):
            out += _linear(f"{b}.attn.{n}", d, d)
        out += _ln(f"{b}.ln_mlp", d)
        out += _linear(f"{b}.mlp.fc_in", d, ff) + _linear(f"{b}.mlp.fc_out", ff, d)
    return out + _ln(f"{p}.ln_final", d)


def lm_layout(c: Dict[str, Any]) -> Layout:
    d = c["n_embd"]
    return ([("wte.weight", (c["vocab_size"], d), "fan_in"),
             ("wpe.weight", (c["n_positions"], d), "small")]
            + _encoder("encoder", c["n_layer"], d, c["n_inner"]))


def clip_layout(c: Dict[str, Any]) -> Layout:
    t, v = c["text_config"], c["vision_config"]
    dt, dv, de = t["hidden_size"], v["hidden_size"], c["projection_dim"]
    n_tok = (v["image_size"] // v["patch_size"]) ** 2 + 1
    return ([("text_tower.wte.weight", (t["vocab_size"], dt), "fan_in"),
             ("text_tower.wpe.weight", (t["max_position_embeddings"], dt), "small")]
            + _encoder("text_tower.encoder", t["num_hidden_layers"], dt, t["intermediate_size"])
            + _linear("text_tower.text_proj", dt, de, bias=False)
            + _linear("image_tower.patch_embed", v["patch_size"] ** 2 * 3, dv)
            + [("image_tower.cls", (1, 1, dv), "small"), ("image_tower.pos", (n_tok, dv), "small")]
            + _encoder("image_tower.encoder", v["num_hidden_layers"], dv, v["intermediate_size"])
            + _linear("image_tower.image_proj", dv, de, bias=False)
            + [("logit_scale", (), "logit_scale")])


def make(layout: Layout, generator: torch.Generator, device: Any) -> Dict[str, torch.Tensor]:
    """One draw for the whole model, scaled leaf by leaf (views of it)."""
    sizes = [math.prod(s) for _, s, _ in layout]
    z = torch.randn(sum(sizes), generator=generator, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for (name, shape, kind), n in zip(layout, sizes):
        x = z[at:at + n].view(shape)
        at += n
        if kind == "fan_in":
            x.mul_(1.0 / math.sqrt(shape[1]))
        elif kind == "scale":
            x.mul_(0.02).add_(1.0)
        elif kind == "logit_scale":
            x.fill_(math.log(1 / 0.07))
        else:
            x.mul_(0.02)
        out[name] = x
    return out


def n_params(layout: Layout) -> int:
    return sum(math.prod(s) for _, s, _ in layout)


__all__ = ["lm_layout", "clip_layout", "make", "n_params"]
