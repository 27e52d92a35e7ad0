"""The port's HF importers (``dewi_tpu_torch.models.import_hf``) against the
HF models and against the JAX package's importers.

Random-init HF GPT-2, CLIP and ViT-MAE models (built offline from seeded
configs) go through both packages' importers.  Tolerances, all in float32:
logits, features and per-patch losses within 1e-4 of the HF model's and
within 1e-5 of the reference's imported model; the reference-layout
parameter trees equal bit for bit.  ``import-weights`` runs on a local
directory that holds a random GPT-2 with the ``tests/fixtures/gpt2_mini``
BPE vocabulary.
"""

import os
import shutil
from pathlib import Path

import numpy as np
import pytest

os.environ.setdefault("USE_TF", "0")  # transformers: the torch classes only
torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dewi_tpu.models import import_hf as j_imp  # noqa: E402
from dewi_tpu_torch.models import import_hf as t_imp  # noqa: E402

FIXTURE = Path(__file__).parent / "fixtures" / "gpt2_mini"
HF_TOL = 1e-4
REF_TOL = 1e-5


def _trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def _gpt2(seed=0, **over):
    from transformers import GPT2Config, GPT2LMHeadModel

    cfg = dict(vocab_size=97, n_positions=32, n_embd=32, n_layer=2, n_head=4,
               resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    cfg.update(over)
    torch.manual_seed(seed)
    return GPT2LMHeadModel(GPT2Config(**cfg)).eval()


@pytest.fixture(scope="module")
def hf_gpt2():
    return _gpt2()


@pytest.fixture(scope="module")
def hf_clip():
    from transformers import CLIPConfig, CLIPModel

    cfg = CLIPConfig(
        text_config={"vocab_size": 53, "hidden_size": 32, "intermediate_size": 64,
                     "num_hidden_layers": 2, "num_attention_heads": 4,
                     "max_position_embeddings": 24, "hidden_act": "quick_gelu",
                     "eos_token_id": 52, "bos_token_id": 1, "pad_token_id": 0,
                     "attention_dropout": 0.0},
        vision_config={"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
                       "num_attention_heads": 4, "image_size": 32, "patch_size": 8,
                       "hidden_act": "quick_gelu", "attention_dropout": 0.0},
        projection_dim=16,
    )
    torch.manual_seed(0)
    return CLIPModel(cfg).eval()


@pytest.fixture(scope="module")
def hf_mae():
    from transformers import ViTMAEConfig, ViTMAEForPreTraining

    cfg = ViTMAEConfig(image_size=32, patch_size=8, num_channels=3, hidden_size=32,
                       num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                       decoder_hidden_size=32, decoder_num_hidden_layers=1,
                       decoder_num_attention_heads=4, decoder_intermediate_size=64,
                       mask_ratio=0.75, norm_pix_loss=True, hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    return ViTMAEForPreTraining(cfg).eval()


# ---- GPT-2 ---------------------------------------------------------------------


def test_gpt2_tree_equals_reference(hf_gpt2):
    cfg, tree = t_imp.gpt2_tree(hf_gpt2)
    jcfg, jtree = j_imp.import_gpt2(hf_gpt2)
    assert cfg.__dict__ == jcfg.__dict__
    _trees_equal(tree, jtree)
    # A bare state dict with its config gives the same model.
    _, model = t_imp.import_gpt2(hf_gpt2.state_dict(), hf_gpt2.config, device="cpu")
    _, again = t_imp.import_gpt2(hf_gpt2, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, again.state_dict()[k])


@pytest.mark.parametrize("pad_from", [16, 10, 3])
def test_gpt2_logits(hf_gpt2, pad_from):
    from dewi_tpu.models.lm import CausalLM as JCausalLM

    cfg, model = t_imp.import_gpt2(hf_gpt2, device="cpu")
    assert cfg.dtype == "float32" and cfg.ln_eps == hf_gpt2.config.layer_norm_epsilon
    torch.manual_seed(1)
    ids = torch.randint(0, 97, (2, 16))
    mask = torch.ones(2, 16)
    mask[1, pad_from:] = 0.0
    with torch.no_grad():
        want = hf_gpt2(ids, attention_mask=mask).logits.numpy()
        got = model(ids, mask).numpy()
    jcfg, jparams = j_imp.import_gpt2(hf_gpt2)
    ref = np.asarray(jax.jit(JCausalLM(jcfg).apply)(
        jparams, jnp.asarray(ids.numpy()), jnp.asarray(mask.numpy())))
    valid = mask.numpy().astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=HF_TOL, rtol=0)
    np.testing.assert_allclose(got[valid], ref[valid], atol=REF_TOL, rtol=0)


def test_gpt2_rejects_unsupported_configs():
    with pytest.raises(ValueError, match="scale_attn_by_inverse_layer_idx"):
        t_imp.import_gpt2(_gpt2(scale_attn_by_inverse_layer_idx=True), device="cpu")
    with pytest.raises(ValueError, match="activation"):
        t_imp.import_gpt2(_gpt2(activation_function="relu"), device="cpu")


def test_gpt2_defaults_to_the_card(hf_gpt2):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_imp.import_gpt2(hf_gpt2)


# ---- CLIP ----------------------------------------------------------------------


def test_clip_tree_equals_reference(hf_clip):
    cfg, tree = t_imp.clip_tree(hf_clip)
    jcfg, jtree = j_imp.import_clip(hf_clip)
    assert cfg.__dict__ == jcfg.__dict__ and cfg.image_pre_ln and cfg.activation == "quick_gelu"
    _trees_equal(tree, jtree)


def test_clip_text_features(hf_clip):
    from dewi_tpu.models.clip import CLIPDualEncoder as JCLIP

    cfg, model = t_imp.import_clip(hf_clip, device="cpu")
    # EOT (the largest id, 52) at the last valid position, right padding after.
    ids = np.array([[1, 7, 9, 11, 52, 0, 0, 0], [1, 5, 52, 0, 0, 0, 0, 0],
                    [1, 3, 4, 5, 6, 7, 8, 52]], np.int64)
    mask = (ids != 0).astype(np.float32)
    with torch.no_grad():
        want = hf_clip.get_text_features(input_ids=torch.tensor(ids),
                                         attention_mask=torch.tensor(mask)).numpy()
        got = model.encode_text(torch.tensor(ids), torch.tensor(mask)).numpy()
    want = want / np.linalg.norm(want, axis=-1, keepdims=True)
    jcfg, jparams = j_imp.import_clip(hf_clip)
    ref = np.asarray(JCLIP(jcfg).apply(jparams, jnp.asarray(ids.astype(np.int32)),
                                       jnp.asarray(mask), method=JCLIP.encode_text))
    np.testing.assert_allclose(got, want, atol=HF_TOL, rtol=0)
    np.testing.assert_allclose(got, ref, atol=REF_TOL, rtol=0)


def test_clip_image_features(hf_clip):
    from dewi_tpu.models.clip import CLIPDualEncoder as JCLIP

    cfg, model = t_imp.import_clip(hf_clip, device="cpu")
    torch.manual_seed(2)
    pix = torch.randn(3, 3, 32, 32)
    imgs = pix.permute(0, 2, 3, 1).contiguous()  # NCHW -> NHWC
    with torch.no_grad():
        want = hf_clip.get_image_features(pixel_values=pix).numpy()
        got = model.encode_image(imgs).numpy()
    want = want / np.linalg.norm(want, axis=-1, keepdims=True)
    jcfg, jparams = j_imp.import_clip(hf_clip)
    ref = np.asarray(JCLIP(jcfg).apply(jparams, jnp.asarray(imgs.numpy()),
                                       method=JCLIP.encode_image))
    np.testing.assert_allclose(got, want, atol=HF_TOL, rtol=0)
    np.testing.assert_allclose(got, ref, atol=REF_TOL, rtol=0)


# ---- ViT-MAE -------------------------------------------------------------------


def test_vit_mae_tree_equals_reference(hf_mae):
    cfg, tree = t_imp.vit_mae_tree(hf_mae)
    jcfg, jtree = j_imp.import_vit_mae(hf_mae)
    assert cfg.__dict__ == jcfg.__dict__ and cfg.use_cls
    _trees_equal(tree, jtree)


@pytest.mark.parametrize("seed", [3, 4])
def test_vit_mae_losses(hf_mae, seed):
    from dewi_tpu.models.mae import ViTMAE as JViTMAE
    from dewi_tpu_torch.models.mae import patchify

    cfg, model = t_imp.import_vit_mae(hf_mae, device="cpu")
    rng = np.random.default_rng(seed)
    pix = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)
    noise = rng.uniform(size=(2, cfg.num_patches)).astype(np.float32)
    imgs = torch.from_numpy(pix.transpose(0, 2, 3, 1).copy())
    with torch.no_grad():
        out = hf_mae(pixel_values=torch.tensor(pix), noise=torch.tensor(noise))
        per_patch, mask = model.patch_losses(imgs, noise=torch.from_numpy(noise))
        target = patchify(imgs, cfg.patch_size).numpy()
    np.testing.assert_array_equal(mask.numpy(), out.mask.numpy())
    mu = target.mean(-1, keepdims=True)
    var = target.var(-1, keepdims=True, ddof=1)  # torch's unbiased variance
    want = ((out.logits.numpy() - (target - mu) / np.sqrt(var + 1e-6)) ** 2).mean(-1)
    jcfg, jparams = j_imp.import_vit_mae(hf_mae)
    ref, ref_mask = JViTMAE(jcfg).apply(jparams, jnp.asarray(imgs.numpy()),
                                        noise=jnp.asarray(noise), method=JViTMAE.patch_losses)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_allclose(per_patch.numpy(), want, atol=HF_TOL, rtol=0)
    np.testing.assert_allclose(per_patch.numpy(), np.asarray(ref), atol=REF_TOL, rtol=0)
    loss = float((per_patch * mask).sum() / mask.sum())
    assert loss == pytest.approx(float(out.loss), rel=1e-4)


# ---- checkpoints, sidecars, the command ----------------------------------------------


@pytest.mark.parametrize("kind", ["gpt2", "clip", "vit-mae"])
def test_checkpoint_and_sidecar_cross_packages(tmp_path, kind, hf_gpt2, hf_clip, hf_mae):
    """The port saves an imported model as the reference's msgpack layout
    with the reference's sidecar; the reference loads it into its own
    import of the same HF model, bit for bit."""
    from dewi_tpu.models.registry import load_params as j_load
    from dewi_tpu_torch.models.registry import save_params

    hf = {"gpt2": hf_gpt2, "clip": hf_clip, "vit-mae": hf_mae}[kind]
    t_fn, j_fn = t_imp._IMPORTERS[kind], j_imp._IMPORTERS[kind]
    cfg, model = t_fn(hf, device="cpu")
    jcfg, jparams = j_fn(hf)
    save_params(model, tmp_path / "port.msgpack")
    t_imp.write_sidecar_config(tmp_path / "port.msgpack", kind, cfg)
    j_imp.write_sidecar_config(tmp_path / "ref.msgpack", kind, jcfg)
    assert ((tmp_path / "port.msgpack.config.json").read_text()
            == (tmp_path / "ref.msgpack.config.json").read_text())
    assert t_imp.sidecar_config(tmp_path / "port.msgpack") == \
        j_imp.sidecar_config(tmp_path / "ref.msgpack")
    _trees_equal(j_load(jparams, tmp_path / "port.msgpack"), jparams)


def _gpt2_mini_dir(tmp_path):
    """A local HF directory: a random GPT-2 over the fixture's BPE
    vocabulary, with that tokenizer saved beside it."""
    from transformers import GPT2TokenizerFast

    src = tmp_path / "hf_gpt2_mini"
    src.mkdir()
    for f in ("vocab.json", "merges.txt"):
        shutil.copy(FIXTURE / f, src / f)
    tok = GPT2TokenizerFast(vocab_file=str(src / "vocab.json"),
                            merges_file=str(src / "merges.txt"))
    tok.save_pretrained(src)
    _gpt2(seed=5, vocab_size=len(tok), n_positions=64).save_pretrained(src)
    return src


def test_import_weights_on_gpt2_mini(tmp_path):
    """``import-weights`` on a local directory (the offline path), then the
    port's and the reference's text estimators on the converted checkpoint
    and the fixture's tokenizer: per-token NLL against HF's and each other."""
    from transformers import GPT2LMHeadModel

    from dewi_tpu.signals.text_entropy import TextEntropyEstimator as JText
    from dewi_tpu_torch import cli
    from dewi_tpu_torch.signals.text_entropy import TextEntropyEstimator

    src = _gpt2_mini_dir(tmp_path)
    out = tmp_path / "gpt2_mini.msgpack"
    assert cli.main(["--device", "cpu", "import-weights", str(src), str(out),
                     "--kind", "gpt2"]) == 0
    assert out.exists() and (tmp_path / "gpt2_mini.msgpack.config.json").exists()
    est = TextEntropyEstimator(checkpoint=str(out), tokenizer=str(src), batch_size=2,
                               max_length=64, device="cpu")
    ref = JText(checkpoint=str(out), tokenizer=str(src), batch_size=2, max_length=64)
    hf = GPT2LMHeadModel.from_pretrained(src).eval()
    for text in ("hello world, this is a test.", "Don't stop believing; it's late"):
        got = np.array(est.compute_entropy(text).token_entropies)
        want_ref = np.array(ref.compute_entropy(text).token_entropies)
        ids = torch.tensor([est.tokenizer.encode(text, 64)])
        with torch.no_grad():
            logp = hf(ids).logits[:, :-1].log_softmax(-1)
        want = -logp.gather(-1, ids[:, 1:, None]).squeeze(-1)[0].numpy()
        np.testing.assert_allclose(got, want, atol=HF_TOL, rtol=0)
        np.testing.assert_allclose(got, want_ref, atol=REF_TOL, rtol=0)


def test_import_weights_errors(tmp_path, capsys):
    from dewi_tpu_torch import cli

    assert cli.main(["--device", "cpu", "import-weights", str(tmp_path / "missing"),
                     str(tmp_path / "x.msgpack"), "--kind", "gpt2"]) == 1
    assert "Conversion failed" in capsys.readouterr().err
    assert cli.main(["import-weights", "a", "b"]) == 2  # --kind is required
    with pytest.raises(ValueError, match="kind must be one of"):
        t_imp.convert_pretrained("gpt2", "bert", tmp_path / "y.msgpack", device="cpu")
