"""The port's signal models against ``dewi_tpu.models`` on the same weights.

Weights go from the reference's Flax param tree into the port through
``dewi_tpu_torch.convert``; inputs are seeded numpy arrays.  Tolerances:

* ``TransformerConfig(dtype="float32")`` runs both packages in float32:
  max relative deviation (max |port - ref| / max |ref|) 1e-5;
* bfloat16 (the default): encoder outputs and logits within 3e-2
  relative, per-token NLL within 1e-2 and MAE losses within 5e-3 (about
  three times the largest deviation measured here: 3.2e-3 and 1.5e-3),
  CLIP embeddings with cosine >= 0.999 against the reference (the two
  libraries round bf16 matmuls, softmax and GELU at different points);
* ``masked_mean_and_quantiles``: 1e-6 relative.

The full-width presets (``gpt2``, ``vit-mae-base``, ``clip-vit-base-patch32``
and the rest) are checked by shape and parameter count against
``jax.eval_shape`` of the reference's ``init``, without a full init.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dewi_tpu.models import registry as jreg
from dewi_tpu.models.lm import token_nll as j_token_nll
from dewi_tpu.models.transformer import Encoder as JEncoder
from dewi_tpu.ops import robust as jrobust
from dewi_tpu_torch import convert
from dewi_tpu_torch.models import registry as treg
from dewi_tpu_torch.models.import_hf import sidecar_config
from dewi_tpu_torch.models.lm import token_nll as t_token_nll
from dewi_tpu_torch.models.transformer import Encoder as TEncoder
from dewi_tpu_torch.models.transformer import TransformerConfig
from dewi_tpu_torch.ops import robust as trobust

F32_RTOL = 1e-5
BF16_RTOL = 3e-2
BF16_NLL_RTOL = 1e-2
BF16_MAE_RTOL = 5e-3
BF16_COS = 0.999
QUANTILE_RTOL = 1e-6
DTYPES = ("float32", "bfloat16")
# The tiny presets, plus the small preset's widths cut to 2 layers.
LM_CASES = {"tiny": ("tiny", {}), "small2": ("small", {"n_layers": 2, "max_len": 64})}
MAE_CASES = {"tiny": ("tiny", {}),
             "small2": ("small", {"image_size": 64, "n_layers": 2, "dec_n_layers": 1})}
CLIP_CASES = {"tiny": ("tiny", {}),
              "small2": ("small", {"text_len": 24, "text_layers": 2, "image_size": 64,
                                   "image_layers": 2})}


@functools.lru_cache(maxsize=None)
def ref_params(cfg):
    """The reference's ``init`` tree for ``cfg``, jitted (the eager init
    dispatches op by op).  Parameters are float32 whatever ``cfg.dtype``,
    so one tree serves both compute dtypes."""
    cfg = dataclasses.replace(cfg, dtype="float32")
    if isinstance(cfg, jreg.MAEConfig):
        model, args = jreg.ViTMAE(cfg), (jnp.zeros((1, cfg.image_size, cfg.image_size, 3)),
                                         jax.random.PRNGKey(1))
    elif isinstance(cfg, jreg.CLIPConfig):
        model = jreg.CLIPDualEncoder(cfg)
        args = (jnp.zeros((1, cfg.text_len), jnp.int32), jnp.ones((1, cfg.text_len)),
                jnp.zeros((1, cfg.image_size, cfg.image_size, 3)))
    else:
        model, args = jreg.CausalLM(cfg), (jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8)))
    return jax.jit(lambda key: model.init(key, *args))(jax.random.PRNGKey(0))


def ref_apply(model, params, *args, method=None):
    return jax.jit(lambda p, *a: model.apply(p, *a, method=method))(params, *args)


def rel_dev(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def rtol(dtype, bf16=BF16_RTOL):
    return F32_RTOL if dtype == "float32" else bf16


def np_tree(params):
    return jax.tree.map(np.asarray, params)


def ids_and_mask(rng, b, t, vocab=258):
    ids = rng.integers(0, vocab, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.float32)
    mask[1, t // 2:] = 0.0
    mask[-1, 3:] = 0.0
    return ids, mask


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("pad", [True, False])
def test_encoder(dtype, causal, pad):
    cfg = dict(d_model=64, n_heads=4, n_layers=2, d_ff=128, max_len=32, causal=causal,
               dtype=dtype)
    from dewi_tpu.models.transformer import TransformerConfig as JConfig

    jenc = JEncoder(JConfig(**cfg))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 20, 64)).astype(np.float32)
    _, mask = ids_and_mask(rng, 3, 20)
    jmask = mask if pad else None
    params = jax.jit(lambda k: jenc.init(k, x, jmask))(jax.random.PRNGKey(0))
    want = np.asarray(ref_apply(jenc, params, x, jmask))
    tenc = TEncoder(TransformerConfig(**cfg))
    tenc.load_state_dict(convert._state_from_flax(np_tree(params)["params"]))
    with torch.no_grad():
        got = tenc(torch.from_numpy(x), torch.from_numpy(mask) if pad else None).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert rel_dev(got, want) <= rtol(dtype)


def _lm_pair(case, dtype):
    name, over = LM_CASES[case]
    jcfg = jreg.lm_config(name, dtype=dtype, **over)
    jmodel, params = jreg.CausalLM(jcfg), ref_params(jcfg)
    tmodel = treg.init_lm(treg.lm_config(name, dtype=dtype, **over), seed=5, device="cpu")
    tmodel.load_state_dict(convert.lm_params_from_flax(np_tree(params)))
    return jmodel, params, tmodel


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_causal_lm_logits_and_token_nll(case, dtype):
    jmodel, params, tmodel = _lm_pair(case, dtype)
    ids, mask = ids_and_mask(np.random.default_rng(2), 4, 30)
    want = np.asarray(ref_apply(jmodel, params, ids, mask))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    assert rel_dev(got.numpy(), want) <= rtol(dtype)
    # token_nll on identical logits: the gather log-softmax itself.
    jn, jv = j_token_nll(jnp.asarray(want), ids, mask)
    tn, tv = t_token_nll(torch.from_numpy(want.copy()), torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert rel_dev(tn.numpy(), jn) <= F32_RTOL
    # And the NLL of each model's own logits.
    tn2, _ = t_token_nll(got, torch.from_numpy(ids), torch.from_numpy(mask))
    valid = np.asarray(jv)
    assert rel_dev(tn2.numpy()[valid], np.asarray(jn)[valid]) <= rtol(dtype, BF16_NLL_RTOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("use_cls", [False, True])
@pytest.mark.parametrize("case", sorted(MAE_CASES))
def test_mae_patch_losses_with_injected_noise(case, use_cls, dtype):
    name, over = MAE_CASES[case]
    jcfg = jreg.mae_config(name, dtype=dtype, use_cls=use_cls, norm_pix=True, **over)
    jmodel, params = jreg.ViTMAE(jcfg), ref_params(jcfg)
    tmodel = treg.init_mae(treg.mae_config(name, dtype=dtype, use_cls=use_cls,
                                           norm_pix=True, **over), seed=5, device="cpu")
    tmodel.load_state_dict(convert.mae_params_from_flax(np_tree(params)))
    rng = np.random.default_rng(3)
    s = jcfg.image_size
    images = rng.random((3, s, s, 3)).astype(np.float32)
    noise = rng.random((3, jcfg.num_patches)).astype(np.float32)
    jpp, jmask = ref_apply(jmodel, params, images, None, noise, method=jmodel.patch_losses)
    jloss = ref_apply(jmodel, params, images, None, noise)
    with torch.no_grad():
        tpp, tmask = tmodel.patch_losses(torch.from_numpy(images), noise=torch.from_numpy(noise))
        tloss = tmodel(torch.from_numpy(images), noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert int(tmask.sum()) == 3 * (jcfg.num_patches - jcfg.num_visible)
    assert rel_dev(tpp.numpy(), jpp) <= rtol(dtype, BF16_MAE_RTOL)
    assert rel_dev(tloss.numpy(), jloss) <= rtol(dtype, BF16_MAE_RTOL)


def test_mae_noise_overrides_the_generator():
    model = treg.init_mae(treg.mae_config("tiny"), seed=0, device="cpu")
    images = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    noise = torch.rand(2, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = model.patch_losses(images, generator=torch.Generator().manual_seed(7), noise=noise)
        b = model.patch_losses(images, generator=torch.Generator().manual_seed(8), noise=noise)
        c = model.patch_losses(images, generator=torch.Generator().manual_seed(7))
        d = model.patch_losses(images, generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(c, d, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pre_ln", [False, True])
@pytest.mark.parametrize("case", sorted(CLIP_CASES))
def test_clip_towers(case, pre_ln, dtype):
    name, over = CLIP_CASES[case]
    jcfg = jreg.clip_config(name, dtype=dtype, image_pre_ln=pre_ln, **over)
    jmodel, params = jreg.CLIPDualEncoder(jcfg), ref_params(jcfg)
    tmodel = treg.init_clip(treg.clip_config(name, dtype=dtype, image_pre_ln=pre_ln, **over),
                            seed=5, device="cpu")
    tmodel.load_state_dict(convert.clip_params_from_flax(np_tree(params)))
    rng = np.random.default_rng(4)
    ids, mask = ids_and_mask(rng, 4, jcfg.text_len)
    images = rng.random((3, jcfg.image_size, jcfg.image_size, 3)).astype(np.float32)
    jt = np.asarray(ref_apply(jmodel, params, ids, mask, method=jmodel.encode_text))
    ji = np.asarray(ref_apply(jmodel, params, images, method=jmodel.encode_image))
    with torch.no_grad():
        tt, ti, scale = tmodel(torch.from_numpy(ids), torch.from_numpy(mask),
                               torch.from_numpy(images))
    assert tt.dtype == ti.dtype == torch.float32
    np.testing.assert_allclose(np.linalg.norm(tt.numpy(), axis=1), 1.0, rtol=1e-5)
    assert float(scale.detach()) == float(params["params"]["logit_scale"])
    if dtype == "float32":
        assert rel_dev(tt.numpy(), jt) <= F32_RTOL
        assert rel_dev(ti.numpy(), ji) <= F32_RTOL
    else:
        assert (tt.numpy() * jt).sum(1).min() >= BF16_COS
        assert (ti.numpy() * ji).sum(1).min() >= BF16_COS


@pytest.mark.parametrize("rows", ["empty", "one", "two", "ragged"])
def test_masked_mean_and_quantiles(rows):
    rng = np.random.default_rng(5)
    t = 17
    counts = {"empty": [0, 0], "one": [1, 1, 0], "two": [2, 2, 1], "ragged": [0, 1, 2, 5, 9, 17]}[rows]
    values = rng.gamma(2.0, size=(len(counts), t)).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.asarray(counts)[:, None]).astype(np.float32)
    mask = np.ascontiguousarray(mask[:, rng.permutation(t)])  # valid entries anywhere
    qs = np.asarray([0.5, 0.9, 0.99], np.float32)
    jm, jq = jrobust.masked_mean_and_quantiles(values, mask, qs)
    tm, tq = trobust.masked_mean_and_quantiles(torch.from_numpy(values), torch.from_numpy(mask),
                                               torch.from_numpy(qs))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=QUANTILE_RTOL, atol=0)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=QUANTILE_RTOL, atol=0)
    for r, n in enumerate(counts):  # and against numpy on the valid entries
        v = values[r][mask[r] > 0]
        want = np.quantile(v, qs) if n else np.zeros(3)
        np.testing.assert_allclose(tq.numpy()[r], want, rtol=QUANTILE_RTOL)


def _flax_shapes(kind, name):
    if kind == "lm":
        cfg = jreg.lm_config(name)
        model = jreg.CausalLM(cfg)
        args = (jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8)))
    elif kind == "mae":
        cfg = jreg.mae_config(name)
        model = jreg.ViTMAE(cfg)
        args = (jnp.zeros((1, cfg.image_size, cfg.image_size, 3)), jax.random.PRNGKey(1))
    else:
        cfg = jreg.clip_config(name)
        model = jreg.CLIPDualEncoder(cfg)
        args = (jnp.zeros((1, cfg.text_len), jnp.int32), jnp.ones((1, cfg.text_len)),
                jnp.zeros((1, cfg.image_size, cfg.image_size, 3)))
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args))


PRESETS = ([("lm", n) for n in jreg.LM_PRESETS] + [("mae", n) for n in jreg.MAE_PRESETS]
           + [("clip", n) for n in jreg.CLIP_PRESETS])


@pytest.mark.parametrize("kind,name", PRESETS)
def test_preset_shapes_and_param_count(kind, name):
    """Every preset, full width: the port's state dict has the shapes that
    the converter makes of the reference's ``init`` tree, and as many
    parameters."""
    shapes = _flax_shapes(kind, name)
    # Zero-stride stand-ins: the converter reshapes and transposes them
    # exactly as it would real weights.
    zero = np.zeros(1, np.float32)
    stand_in = jax.tree.map(lambda s: np.lib.stride_tricks.as_strided(
        zero, s.shape, (0,) * len(s.shape)), shapes)
    from_flax = {"lm": convert.lm_params_from_flax, "mae": convert.mae_params_from_flax,
                 "clip": convert.clip_params_from_flax}[kind]
    want = {k: tuple(v.shape) for k, v in from_flax(stand_in).items()}
    build = {"lm": (treg.lm_config, treg.CausalLM), "mae": (treg.mae_config, treg.ViTMAE),
             "clip": (treg.clip_config, treg.CLIPDualEncoder)}[kind]
    with torch.device("meta"):
        model = build[1](build[0](name))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    ref_count = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert treg.param_count(model) == ref_count
    assert set(treg.__dict__[f"{kind.upper()}_PRESETS"]) == set(jreg.__dict__[f"{kind.upper()}_PRESETS"])


KINDS = {
    "lm": (jreg.lm_config, treg.lm_config, treg.init_lm),
    "mae": (jreg.mae_config, treg.mae_config, treg.init_mae),
    "clip": (jreg.clip_config, treg.clip_config, treg.init_clip),
}
TO_FLAX = {"lm": convert.lm_params_to_flax, "mae": convert.mae_params_to_flax,
           "clip": convert.clip_params_to_flax}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_reference_checkpoint_loads_bit_for_bit(kind, tmp_path):
    jcfg_fn, tcfg_fn, tinit = KINDS[kind]
    params = ref_params(jcfg_fn("tiny"))
    path = tmp_path / "ref.msgpack"
    jreg.save_params(params, path)
    model = treg.load_params(tinit(tcfg_fn("tiny"), seed=9, device="cpu"), path)
    back = jax.tree.map(np.asarray, TO_FLAX[kind](model))
    ref = np_tree(params)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_port_checkpoint_loads_into_the_reference_bit_for_bit(kind, tmp_path):
    jcfg_fn, tcfg_fn, tinit = KINDS[kind]
    model = tinit(tcfg_fn("tiny"), seed=11, device="cpu")
    path = tmp_path / "port.msgpack"
    treg.save_params(model, path)
    template = ref_params(jcfg_fn("tiny"))
    loaded = np_tree(jreg.load_params(template, path))
    want = TO_FLAX[kind](model)
    assert jax.tree.structure(loaded) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # The port reads its own file back unchanged, and the fingerprint is stable.
    again = treg.load_params(tinit(tcfg_fn("tiny"), seed=0, device="cpu"), path)
    for (k, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), k
    assert treg.checkpoint_fingerprint(path) == jreg.checkpoint_fingerprint(path)


def test_checkpoint_kind_and_format_checks(tmp_path):
    lm = treg.init_lm(treg.lm_config("tiny"), device="cpu")
    clip = treg.init_clip(treg.clip_config("tiny"), device="cpu")
    path = tmp_path / "lm.msgpack"
    treg.save_params(lm, path)
    with pytest.raises(ValueError, match="not a CLIP param tree"):
        treg.load_params(clip, path)
    with pytest.raises(NotImplementedError, match="orbax"):
        treg.save_params(lm, tmp_path / "orbax_dir")
    # A suffix-less path is read as an orbax directory (tests/test_torch_orbax.py);
    # this one holds no checkpoint.
    with pytest.raises(FileNotFoundError, match="_METADATA"):
        treg.load_params(lm, tmp_path / "orbax_dir/")
    assert treg.maybe_load(lm, None) is lm
    assert treg.checkpoint_fingerprint(None) is None
    assert treg.checkpoint_fingerprint(tmp_path / "missing.msgpack") is None


def test_sidecar_config(tmp_path):
    ckpt = tmp_path / "m.msgpack"
    assert sidecar_config(None) is None and sidecar_config(ckpt) is None
    from dewi_tpu.models.import_hf import write_sidecar_config

    write_sidecar_config(ckpt, "lm", jreg.lm_config("tiny", ln_eps=1e-5))
    side = sidecar_config(ckpt)
    assert side["kind"] == "lm"
    assert TransformerConfig(**side["config"]) == treg.lm_config("tiny", ln_eps=1e-5)


def test_seeded_init_follows_flax_distributions():
    """By distribution, not by stream: embeddings normal(1/sqrt(d)), Dense
    kernels lecun-normal (standard deviation 1/sqrt(fan_in), truncated at
    two of the underlying normal's), zero biases, unit LayerNorm scales,
    normal(0.02) raw parameters, logit_scale log(1/0.07)."""
    clip = treg.init_clip(treg.clip_config("small"), seed=0, device="cpu")
    sd = {k: v.detach() for k, v in clip.state_dict().items()}
    d = 256
    for key, std in (("text_tower.wte.weight", d ** -0.5),
                     ("text_tower.encoder.block_0.mlp.fc_in.weight", d ** -0.5),
                     ("text_tower.encoder.block_0.mlp.fc_out.weight", (4 * d) ** -0.5),
                     ("image_tower.pos", 0.02), ("image_tower.cls", 0.02)):
        assert float(sd[key].std()) == pytest.approx(std, rel=0.05 if sd[key].numel() > 999 else 0.5), key
    bound = 2 * d ** -0.5 / 0.87962566103423978
    assert float(sd["text_tower.encoder.block_0.mlp.fc_in.weight"].abs().max()) <= bound
    assert torch.count_nonzero(sd["text_tower.encoder.block_0.attn.query.bias"]) == 0
    assert torch.all(sd["text_tower.encoder.ln_final.weight"] == 1)
    assert float(sd["logit_scale"]) == pytest.approx(float(np.log(1 / 0.07)), rel=1e-6)
    again = treg.init_clip(treg.clip_config("small"), seed=0, device="cpu").state_dict()
    other = treg.init_clip(treg.clip_config("small"), seed=1, device="cpu").state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["text_tower.wte.weight"], other["text_tower.wte.weight"])


def test_entry_points_default_to_the_card():
    """Without ``device=`` the models and estimators run on the card, and
    raise where there is none; ``chip_len=`` is taken, and ``ring_mesh=``
    and ``mesh=`` take only a Mesh."""
    from dewi_tpu_torch.io import DeviceImages
    from dewi_tpu_torch.signals import (CrossModalDependency, ImageEntropyEstimator,
                                        TextEntropyEstimator)

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for build in (lambda: treg.init_lm(treg.lm_config("tiny")),
                  lambda: treg.init_mae(treg.mae_config("tiny")),
                  lambda: treg.init_clip(treg.clip_config("tiny")),
                  lambda: TextEntropyEstimator("tiny"),
                  lambda: ImageEntropyEstimator("tiny"),
                  lambda: ImageEntropyEstimator("pixel"),
                  lambda: CrossModalDependency("tiny"),
                  lambda: DeviceImages(np.zeros((2, 8, 8, 3), np.uint8))):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    assert TextEntropyEstimator("tiny", device="cpu", chip_len=32).chip_len == 32
    with pytest.raises(TypeError, match="mesh"):
        TextEntropyEstimator("tiny", device="cpu", ring_mesh=object())
    # mesh= is the data axis (ported): anything but a Mesh is refused.
    with pytest.raises(TypeError, match="mesh"):
        ImageEntropyEstimator("tiny", device="cpu", mesh=object())
    with pytest.raises(TypeError, match="mesh"):
        CrossModalDependency("tiny", device="cpu", mesh=object())
    assert next(treg.init_lm(treg.lm_config("tiny"), device="cpu").parameters()).device.type == "cpu"
