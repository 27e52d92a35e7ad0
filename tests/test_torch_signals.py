"""The port's signal estimators against ``dewi_tpu.signals`` on the same weights.

Both packages load one msgpack checkpoint written by the port, with a
sidecar config that fixes the architecture and the compute dtype, so the
estimators run the same weights.  Tolerances, as max |port - ref| over
max |ref| per output:

* float32 sidecar: 1e-5 (per-doc NLL mean, q90, q99, per-token NLL, CLIP
  embeddings and cosines);
* bfloat16 (the default dtype): per-doc NLL mean and q90 within 1e-2
  (measured here: 1.9e-3), per-token NLL and the domain-relative mean and
  q90 (differences of two NLLs) within 3e-2 (measured: 5.5e-3 and
  1.3e-2), CLIP embeddings with cosine >= 0.999 against the reference.

The image estimator draws its masks from PyTorch's generator, which is not
JAX's, so it is held to the reference at model level with injected noise
(``test_torch_models.py``) and here for determinism per seed, independence
from how the corpus is grouped, and the model-free proxy path (1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dewi_tpu.io import device_images as j_device_images
from dewi_tpu.io import images as j_images
from dewi_tpu.models import registry as jreg
from dewi_tpu.models.import_hf import write_sidecar_config
from dewi_tpu.ops.image_noise import _resize_matrix as j_resize_matrix
from dewi_tpu.signals import cross_modal as j_cross
from dewi_tpu.signals import image_entropy as j_image
from dewi_tpu.signals import text_entropy as j_text
from dewi_tpu.signals import tokenizer as j_tok
from dewi_tpu_torch.io import DeviceImages, device_images, images as t_images
from dewi_tpu_torch.models import registry as treg
from dewi_tpu_torch.ops.robust import masked_mean_and_quantiles
from dewi_tpu_torch.signals import (CrossModalDependency, ImageEntropyEstimator,
                                    TextEntropyEstimator)
from dewi_tpu_torch.signals import image_entropy as t_image
from dewi_tpu_torch.signals import tokenizer as t_tok

F32_RTOL = 1e-5
BF16_RTOL = 3e-2
BF16_DOC_RTOL = 1e-2
BF16_COS = 0.999
PROXY_RTOL = 1e-6
MAX_LEN = 64  # the text LM's context: longer documents are windowed
# Byte lengths across the 32 and 64 buckets, at their edges, and past the
# context (windows).
TEXT_LENGTHS = (0, 3, 20, 30, 31, 32, 40, 62, 63, 64, 100, 250)
# Long documents of 2, 3, 5 and 7 windows of 64 tokens (48 apart) between
# short ones: with batches of 4 their 17 windows take five forwards, and
# windows of one document straddle batches and share them with others'.
PACKED_LENGTHS = (20, 90, 40, 330, 140, 3, 230, 62)
PACKED_WINDOWS = (2, 7, 3, 5)


def rel_dev(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    if not want.size:
        return 0.0
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _texts(seed=0, lengths=TEXT_LENGTHS):
    rng = np.random.default_rng(seed)
    words = ["tpu", "cuda", "entropy", "image", "token", "zebra", "quartz", "ü", "日本"]
    out = []
    for n in lengths:
        s = ""
        while len(s.encode()) < n:
            s += rng.choice(words) + " "
        out.append(s.encode()[:n].decode("utf-8", "ignore"))
    return out


def _jit_init(model_cls, *args):
    """The reference's ``init_*`` jitted: the estimators below load a
    checkpoint over these params, so only the speed of the init changes."""
    def init(cfg, seed=0):
        model = model_cls(cfg)
        built = [a(cfg) if callable(a) else a for a in args]
        return model, jax.jit(lambda k: model.init(k, *built))(jax.random.PRNGKey(seed))
    return init


_REF_INITS = {
    (j_text, "init_lm"): _jit_init(jreg.CausalLM, jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8))),
    (j_cross, "init_clip"): _jit_init(
        jreg.CLIPDualEncoder, lambda c: jnp.zeros((1, c.text_len), jnp.int32),
        lambda c: jnp.ones((1, c.text_len)),
        lambda c: jnp.zeros((1, c.image_size, c.image_size, 3))),
}


def _ref(build):
    with pytest.MonkeyPatch.context() as mp:
        for (mod, name), fn in _REF_INITS.items():
            mp.setattr(mod, name, fn)
        return build()


def _checkpoint(tmp, name, kind, cfg, model):
    path = tmp / f"{name}.msgpack"
    treg.save_params(model, path)
    write_sidecar_config(path, kind, cfg)
    return str(path)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def text_pair(request, tmp_path_factory):
    dtype = request.param
    tmp = tmp_path_factory.mktemp(f"text_{dtype}")
    cfg = treg.lm_config("tiny", max_len=MAX_LEN, dtype=dtype)
    ckpt = _checkpoint(tmp, "lm", "lm", cfg, treg.init_lm(cfg, seed=1, device="cpu"))
    # The domain LM comes from the preset (dtype bfloat16 in both packages)
    # with the base model's context, as both estimators build it.
    dom = treg.init_lm(treg.lm_config("tiny", max_len=MAX_LEN), seed=2, device="cpu")
    dckpt = tmp / "domain.msgpack"
    treg.save_params(dom, dckpt)
    kw = dict(model_name="tiny", domain_model_name="tiny", batch_size=4, max_length=MAX_LEN,
              checkpoint=ckpt, domain_checkpoint=str(dckpt))
    ref = _ref(lambda: j_text.TextEntropyEstimator(**kw))
    port = TextEntropyEstimator(device="cpu", **kw)
    return dtype, ref, port


def test_text_estimator_uses_the_sidecar(text_pair):
    dtype, ref, port = text_pair
    assert port.cfg == treg.lm_config("tiny", max_len=MAX_LEN, dtype=dtype)
    assert port.chip_len == ref.chip_len == MAX_LEN


@pytest.mark.parametrize("relative", [False, True])
def test_text_batch_compute_stats(text_pair, relative):
    dtype, ref, port = text_pair
    texts = _texts()
    want = ref.batch_compute_stats(texts, relative_to_domain=relative)
    seen = []
    got = port.batch_compute_stats(texts, relative_to_domain=relative, progress=seen.append)
    assert sum(seen) == len(texts)
    names = ("mean", "q90", "q99")
    for name, g, w in zip(names, got, want):
        assert g.dtype == np.float32 and g.shape == (len(texts),)
        if dtype == "float32" and not relative:
            assert rel_dev(g, w) <= F32_RTOL, name
        elif name != "q99":
            # bf16 rounding in either package (the domain LM is bf16 in
            # both, so the relative mode is held to a bf16 bound).
            assert rel_dev(g, w) <= (BF16_RTOL if relative else BF16_DOC_RTOL), name


def test_text_batch_compute_token_lists(text_pair):
    dtype, ref, port = text_pair
    texts = _texts(1)
    want = ref.batch_compute(texts)
    got = port.batch_compute(texts)
    tol = F32_RTOL if dtype == "float32" else BF16_RTOL
    for g, w in zip(got, want):
        assert len(g.token_entropies) == len(w.token_entropies)
        assert rel_dev(g.token_entropies, w.token_entropies) <= tol
        doc_tol = F32_RTOL if dtype == "float32" else BF16_DOC_RTOL
        assert rel_dev([g.mean_entropy, g.q90_entropy], [w.mean_entropy, w.q90_entropy]) <= doc_tol
    single = port.compute_entropy(texts[-1])
    assert single.mean_entropy == pytest.approx(got[-1].mean_entropy, rel=1e-5)
    assert port(texts[2]).to_dict()["mean"] == pytest.approx(got[2].mean_entropy, rel=1e-5)


def test_text_long_document_windows(text_pair):
    """A document of 250 bytes over a 64-token context: windows of 64 that
    advance by 48, with each later window's first 15 targets dropped."""
    dtype, ref, port = text_pair
    text = _texts()[-1]
    n_tok = 1 + len(text.encode())
    got = port.batch_compute([text])[0]
    want = ref.batch_compute([text])[0]
    overlap = MAX_LEN // 4
    lens = [min(MAX_LEN, n_tok - s) for s in range(0, n_tok - overlap, MAX_LEN - overlap)]
    assert len(lens) > 1
    kept = (lens[0] - 1) + sum(max(n - 1 - (overlap - 1), 0) for n in lens[1:])
    assert len(got.token_entropies) == len(want.token_entropies) == kept
    tol = F32_RTOL if dtype == "float32" else BF16_RTOL
    assert rel_dev(got.token_entropies, want.token_entropies) <= tol


@pytest.mark.parametrize("relative", [False, True])
def test_text_long_windows_pack_across_documents(text_pair, relative):
    """Long documents whose windows share forwards with each other's match
    the reference per document, and the port's own one-document calls."""
    dtype, ref, port = text_pair
    texts = _texts(2, PACKED_LENGTHS)
    overlap, stride = MAX_LEN // 4, MAX_LEN - MAX_LEN // 4
    n_tok = [1 + len(t.encode()) for t in texts]
    assert [-(-(n - overlap) // stride) for n in n_tok if n > MAX_LEN] == list(PACKED_WINDOWS)
    kw = dict(relative_to_domain=relative)
    got, want = port.batch_compute(texts, **kw), ref.batch_compute(texts, **kw)
    got_s, want_s = port.batch_compute_stats(texts, **kw), ref.batch_compute_stats(texts, **kw)
    f32 = dtype == "float32" and not relative
    tok_tol = F32_RTOL if f32 else BF16_RTOL
    doc_tol = F32_RTOL if f32 else (BF16_RTOL if relative else BF16_DOC_RTOL)
    for d, (text, g, w) in enumerate(zip(texts, got, want)):
        assert len(g.token_entropies) == len(w.token_entropies), d
        assert rel_dev(g.token_entropies, w.token_entropies) <= tok_tol, d
        g_doc, w_doc = [g.mean_entropy, g.q90_entropy], [w.mean_entropy, w.q90_entropy]
        assert rel_dev(g_doc, w_doc) <= doc_tol, d
        assert rel_dev([x[d] for x in got_s[:2]], [x[d] for x in want_s[:2]]) <= doc_tol, d
        one = port.batch_compute([text], **kw)[0]
        one_s = port.batch_compute_stats([text], **kw)
        assert one.token_entropies == pytest.approx(g.token_entropies, rel=1e-6), d
        assert [one.mean_entropy, one.q90_entropy, one.q99_entropy] == pytest.approx(
            [g.mean_entropy, g.q90_entropy, g.q99_entropy], rel=1e-6), d
        assert [x[0] for x in one_s] == pytest.approx([x[d] for x in got_s], rel=1e-6), d


def test_text_empty_and_vocab_check(tmp_path):
    port = TextEntropyEstimator("tiny", device="cpu", max_length=MAX_LEN)
    means, q90s, q99s = port.batch_compute_stats([])
    assert means.shape == q90s.shape == q99s.shape == (0,)
    assert port.batch_compute([]) == []
    cfg = treg.lm_config("tiny", vocab_size=300)
    ckpt = _checkpoint(tmp_path, "v300", "lm", cfg, treg.init_lm(cfg, device="cpu"))
    with pytest.raises(ValueError, match="300-token vocabulary"):
        TextEntropyEstimator(device="cpu", checkpoint=ckpt)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def clip_pair(request, tmp_path_factory):
    dtype = request.param
    tmp = tmp_path_factory.mktemp(f"clip_{dtype}")
    cfg = treg.clip_config("tiny", dtype=dtype)
    ckpt = _checkpoint(tmp, "clip", "clip", cfg, treg.init_clip(cfg, seed=3, device="cpu"))
    kw = dict(model_name="tiny", batch_size=4, checkpoint=ckpt)
    ref = _ref(lambda: j_cross.CrossModalDependency(**kw))
    port = CrossModalDependency(device="cpu", **kw)
    return dtype, ref, port


def _images(n, size=32, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def _hold(dtype, got, want):
    assert got.dtype == np.float32 and got.shape == want.shape
    if dtype == "float32":
        assert rel_dev(got, want) <= F32_RTOL
    else:
        assert (got * want).sum(-1).min() >= BF16_COS


def test_clip_encoders(clip_pair):
    dtype, ref, port = clip_pair
    texts = _texts(2)[:9]
    _hold(dtype, port.encode_texts(texts), ref.encode_texts(texts))
    imgs = _images(9)
    _hold(dtype, port.encode_images(imgs), ref.encode_images(imgs))
    # Other corpus forms: a list of arrays at another size, floats in [0, 1].
    small = list(_images(3, size=20, seed=1))
    _hold(dtype, port.encode_images(small), ref.encode_images(small))
    floats = imgs[:5].astype(np.float32) / 255.0
    _hold(dtype, port.encode_images(floats), ref.encode_images(floats))
    assert port.encode_texts([]).shape == (0, port.cfg.d_embed)


def test_clip_batch_compute_and_matrix(clip_pair):
    dtype, ref, port = clip_pair
    texts = _texts(3)[:7]
    imgs = _images(7, seed=2)
    got = np.asarray([r.info_nce_score for r in port.batch_compute(texts, imgs)])
    want = np.asarray([r.info_nce_score for r in ref.batch_compute(texts, imgs)])
    # In bf16 a cosine of two embeddings, each within cosine 0.999 of the
    # reference's, is within 2 * sqrt(2 * (1 - 0.999)) of the reference's.
    tol = F32_RTOL if dtype == "float32" else 2 * np.sqrt(2 * (1 - BF16_COS))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(port.batch_diagonal(texts, imgs), got, rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.similarity_matrix(texts, imgs[:3]),
                               ref.similarity_matrix(texts, imgs[:3]), rtol=0, atol=tol)
    one = port.compute_similarity(texts[0], imgs[0])
    assert one.info_nce_score == pytest.approx(got[0], abs=1e-6)
    with pytest.raises(ValueError, match="must match"):
        port.batch_compute(texts, imgs[:2])


def test_clip_image_size_checks():
    with pytest.raises(ValueError, match="multiple"):
        CrossModalDependency("tiny", device="cpu", image_size=33)
    assert CrossModalDependency("tiny", device="cpu", image_size=48).cfg.image_size == 48


# ---- image entropy -----------------------------------------------------------


@pytest.fixture(scope="module")
def mae_estimator():
    return ImageEntropyEstimator("tiny", device="cpu", batch_size=4, seed=0)


def test_image_determinism_per_seed(mae_estimator):
    imgs = _images(10)
    a = mae_estimator.batch_compute_stats(imgs, seed=5)
    b = mae_estimator.batch_compute_stats(imgs, seed=5)
    c = mae_estimator.batch_compute_stats(imgs, seed=6)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    assert all(np.isfinite(x).all() and x.shape == (10,) for x in a)


def test_image_independent_of_grouping(mae_estimator):
    """Batch ``b`` draws its masks from ``(seed, b * batch_size)`` alone: the
    corpus as an ndarray, a tensor, a ``DeviceImages`` or a list of images
    gives the same values, and each batch equals the model run on it alone."""
    imgs = _images(10, seed=4)
    seed, bs = 7, mae_estimator.batch_size
    want = mae_estimator.batch_compute_stats(imgs, seed=seed)
    for corpus in (torch.from_numpy(imgs), DeviceImages(imgs, device="cpu"), list(imgs)):
        got = mae_estimator.batch_compute_stats(corpus, seed=seed)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    q90 = torch.tensor([0.9])
    for b in range(3):
        chunk = torch.zeros((bs, 32, 32, 3), dtype=torch.uint8)
        part = torch.from_numpy(imgs[b * bs:(b + 1) * bs])
        chunk[:len(part)] = part
        with torch.no_grad():
            pp, mask = mae_estimator.model.patch_losses(
                t_image.normalize_images(chunk),
                generator=t_image.batch_generator(seed, b * bs, torch.device("cpu")))
        mean, qs = masked_mean_and_quantiles(pp, mask, q90)
        np.testing.assert_array_equal(mean[:len(part)].numpy(), want[0][b * bs:b * bs + len(part)])
        np.testing.assert_array_equal(qs[:len(part), 0].numpy(), want[1][b * bs:b * bs + len(part)])
    # The scalar losses are the masked means of the same masks.
    losses = mae_estimator.batch_compute(imgs, seed=seed)
    np.testing.assert_allclose(losses, want[0], rtol=1e-6)
    assert mae_estimator.score(imgs[4], seed=seed) != losses[4]  # its own batch 0
    assert mae_estimator.score(imgs[0], seed=seed) == pytest.approx(losses[0], rel=1e-6)


def test_image_resizes_other_resolutions(mae_estimator):
    big = _images(3, size=64, seed=8)
    dev = mae_estimator.batch_compute_stats(DeviceImages(big, device="cpu"))
    host = mae_estimator.batch_compute_stats(list(big))
    for x in dev + host:
        assert x.shape == (3,) and np.isfinite(x).all()


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_image_pixel_proxy_matches_reference(kind):
    imgs = _images(7, seed=9)
    if kind == "float":
        imgs = imgs.astype(np.float32) / 255.0
    ref = j_image.ImageEntropyEstimator("pixel", batch_size=4, image_size=32)
    port = ImageEntropyEstimator("pixel", device="cpu", batch_size=4, image_size=32)
    np.testing.assert_allclose(port.batch_compute(imgs), ref.batch_compute(imgs),
                               rtol=PROXY_RTOL)
    for g, w in zip(port.batch_compute_stats(imgs), ref.batch_compute_stats(imgs)):
        np.testing.assert_allclose(g, w, rtol=PROXY_RTOL)


def test_normalize_images_multiplies_by_the_f32_reciprocal():
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1).repeat(3, -1)
    got = t_image.normalize_images(torch.from_numpy(u8)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_image.normalize_images(jnp.asarray(u8))))
    f = np.random.default_rng(0).random((2, 4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(t_image.normalize_images(torch.from_numpy(f)).numpy(), f)


@pytest.mark.parametrize("src", ["gray_float", "rgb_255_float", "uint8", "resize_float"])
def test_to_image_array(src):
    rng = np.random.default_rng(1)
    image = {"gray_float": rng.random((32, 32)).astype(np.float32),
             "rgb_255_float": (rng.random((32, 32, 3)) * 255).astype(np.float32),
             "uint8": rng.integers(0, 256, (40, 24, 3), dtype=np.uint8),
             "resize_float": rng.random((50, 20, 3)).astype(np.float32)}[src]
    np.testing.assert_array_equal(t_image.to_image_array(image, 32),
                                  j_image.to_image_array(image, 32))


def test_device_images_resize_matches_reference():
    imgs = _images(5, size=40, seed=3)
    port = DeviceImages(imgs, device="cpu")
    ref = j_device_images.DeviceImages(imgs)
    assert len(port) == 5 and port.size == 40
    np.testing.assert_array_equal(port.rows_at(1, 4, 40).numpy(), np.asarray(ref.rows_at(1, 4, 40)))
    for size in (32, 56):
        np.testing.assert_allclose(port.rows_at(0, 5, size).numpy(),
                                   np.asarray(ref.rows_at(0, 5, size)), rtol=0, atol=1e-6)
    for src, dst in ((40, 32), (20, 64), (7, 7)):
        np.testing.assert_array_equal(device_images._resize_matrix(src, dst),
                                      j_resize_matrix(src, dst))
    np.testing.assert_array_equal(port.gather([4, 0]).base.numpy(), imgs[[4, 0]])
    with pytest.raises(ValueError, match="expected"):
        DeviceImages(np.zeros((2, 8, 8), np.uint8), device="cpu")


@pytest.mark.parametrize("form", ["ndarray", "tensor", "float255", "list", "device"])
def test_iter_corpus_batches(form):
    imgs = _images(7, size=16, seed=5)
    corpus = {"ndarray": imgs, "tensor": torch.from_numpy(imgs),
              "float255": imgs.astype(np.float32), "list": list(imgs),
              "device": DeviceImages(imgs, device="cpu")}[form]
    got = list(t_images.iter_corpus_batches(corpus, 16, 3))
    want = list(j_images.iter_corpus_batches(
        imgs.astype(np.float32) if form == "float255" else imgs, 16, 3))
    assert [p for _, p in got] == [p for _, p in want] == [0, 0, 2]
    for (g, _), (w, _) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_decode_and_resize_helpers(tmp_path):
    rng = np.random.default_rng(2)
    arr = rng.integers(0, 256, (30, 20, 3), dtype=np.uint8)
    np.testing.assert_array_equal(t_images.resize_uint8(arr, 16), j_images.resize_uint8(arr, 16))
    f = rng.random((30, 20, 3)).astype(np.float32)
    np.testing.assert_array_equal(t_images.resize_f32(f, 16), j_images.resize_f32(f, 16))
    from PIL import Image

    path = tmp_path / "x.png"
    Image.fromarray(arr).save(path)
    np.testing.assert_array_equal(t_images.decode_image_uint8(str(path), 24),
                                  j_images.decode_image_uint8(str(path), 24))


def test_tokenizer_copy_encodes_alike():
    texts = _texts(4)
    tb, jb = t_tok.get_tokenizer("byte"), j_tok.get_tokenizer("byte")
    for a, b in zip(tb.encode_batch(texts, 48, pad_to=64), jb.encode_batch(texts, 48, pad_to=64)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tb.encode_lengths(texts, 40), jb.encode_lengths(texts, 40))
    assert [t_tok.bucket_length(n, max_len=512) for n in (1, 33, 64, 65, 900)] == \
        [j_tok.bucket_length(n, max_len=512) for n in (1, 33, 64, 65, 900)]
