"""The port's own copies of the framework-free modules (config, corpus,
packed images, progress, the rest of ``io``) and its sampling, against the
JAX package on the same inputs (the port on the CPU).

Copies must agree exactly: equal dicts, equal arrays, equal files.
Sampling draws from PyTorch's random stream, not JAX's, so the Gumbel
top-k is held to the reference with the same uniforms injected into both,
and the draws by seed are held to ``p ∝ dewi^tau`` in distribution (a
chi-square bound at p < 1e-4, so that a correct sampler fails it about once
in ten thousand runs).  ``submodular_pick`` must return the same indices.
"""

import io
import json

import jax
import numpy as np
import pytest
import torch

import dewi_tpu.config as j_config
import dewi_tpu.corpus as j_corpus
import dewi_tpu.io.device_images as j_devimg
import dewi_tpu.io.images as j_images
import dewi_tpu.io.packed as j_packed
import dewi_tpu.pipelines as j_pipe
import dewi_tpu.sampling as j_sampling
import dewi_tpu.utils.progress as j_progress
from dewi_tpu_torch import config as t_config
from dewi_tpu_torch import corpus as t_corpus
from dewi_tpu_torch import pipelines as t_pipe
from dewi_tpu_torch import sampling as t_sampling
from dewi_tpu_torch.io import device_images as t_devimg
from dewi_tpu_torch.io import images as t_images
from dewi_tpu_torch.io import packed as t_packed
from dewi_tpu_torch.utils import progress as t_progress

# ---- config -----------------------------------------------------------------

CONFIG_CASES = [
    {},
    {"text": {"model": "tiny", "quantiles": [0.5], "unknown": 1},
     "scoring": {"weights": {"alpha_t": 0.3}, "delta": 2.0, "mode": "conditional"},
     "index": {"ann": "int8", "int8_queries": True}, "mesh": {"dtype": "bfloat16"},
     "bogus_section": {"x": 1}},
    {"redundancy": {"text_sim": "minhash", "image_sim": "phash"},
     "runtime": {"shard_size": 7, "io_threads": 2}, "noise": None},
]


@pytest.mark.parametrize("data", CONFIG_CASES)
def test_config_from_dict_to_dict(data):
    port, ref = t_config.DewiConfig.from_dict(data), j_config.DewiConfig.from_dict(data)
    assert port.to_dict() == ref.to_dict()
    assert t_config.DewiConfig.from_dict(port.to_dict()).to_dict() == port.to_dict()


@pytest.mark.parametrize("preset", t_config.PRESETS)
def test_presets(preset):
    assert t_config.PRESETS == j_config.PRESETS
    port = t_config.apply_preset(t_config.get_default_config(), preset)
    ref = j_config.apply_preset(j_config.get_default_config(), preset)
    assert port.to_dict() == ref.to_dict()
    with pytest.raises(ValueError):
        t_config.apply_preset(t_config.DewiConfig(), "nope")


def test_config_yaml_round_trip_between_packages(tmp_path):
    pytest.importorskip("yaml")
    cfg = t_config.DewiConfig.from_dict(CONFIG_CASES[1])
    cfg.to_yaml(tmp_path / "port.yaml")
    assert j_config.DewiConfig.from_yaml(tmp_path / "port.yaml").to_dict() == cfg.to_dict()
    j_config.DewiConfig.from_dict(CONFIG_CASES[2]).to_yaml(tmp_path / "ref.yaml")
    assert t_config.DewiConfig.from_yaml(tmp_path / "ref.yaml").to_dict() == \
        j_config.DewiConfig.from_dict(CONFIG_CASES[2]).to_dict()


def test_config_imports_no_yaml():
    import subprocess
    import sys

    code = ("import sys; import dewi_tpu_torch.config as c; c.DewiConfig.from_dict({}); "
            "sys.exit(1 if 'yaml' in sys.modules else 0)")
    assert subprocess.run([sys.executable, "-c", code], timeout=120).returncode == 0


# ---- corpus -------------------------------------------------------------------


def _doc_specs():
    rng = np.random.default_rng(0)
    return [
        dict(doc_id="a", text="hello"),
        dict(doc_id="b", image=rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)),
        dict(doc_id="c", text="both", image=rng.random((8, 8, 3)).astype(np.float32),
             embedding=np.arange(4, dtype=np.float32)),
        dict(doc_id="d", text=""),
        dict(doc_id="e", image_path="/nonexistent/e.png"),
    ]


def _corpora():
    port = t_corpus.Corpus.from_documents([t_pipe.create_document(**d) for d in _doc_specs()])
    ref = j_corpus.Corpus.from_documents([j_pipe.create_document(**d) for d in _doc_specs()])
    return port, ref


def test_corpus_from_documents():
    port, ref = _corpora()
    assert port.ids == ref.ids and port.texts == ref.texts
    assert np.array_equal(port.has_text, ref.has_text)
    assert np.array_equal(port.has_image, ref.has_image)
    assert np.array_equal(port.embeddings, ref.embeddings)
    assert np.array_equal(port.ext_embedding_mask, ref.ext_embedding_mask)
    assert t_corpus.COL == j_corpus.COL


def test_corpus_columns_and_documents():
    port, ref = _corpora()
    rng = np.random.default_rng(1)
    sig = rng.random(port.signals.shape).astype(np.float32)
    for c in (port, ref):
        c.signals[:] = sig
        c.dewi = sig[:, 0] * 0.5
        c.clip_filled_mask = np.array([True, True, False, False, True])
    assert np.array_equal(port.payload_matrix(), ref.payload_matrix())
    assert np.array_equal(port.col("noise"), ref.col("noise"))
    pd, rd = port.to_documents(), ref.to_documents()
    for p, r in zip(pd, rd):
        assert p.signals_dict() == r.signals_dict() and p.dewi_score == r.dewi_score
        assert (p.embedding is None) == (r.embedding is None)
    with pytest.raises(ValueError):
        port.apply_to_documents(pd[:2])
    with pytest.raises(ValueError):
        t_corpus.Corpus(ids=["x"], signals=np.zeros((2, 7), np.float32))
    with pytest.raises(ValueError):
        t_corpus.Corpus.from_documents([
            t_pipe.Document("x", embedding=np.zeros(3, np.float32)),
            t_pipe.Document("y", embedding=np.zeros(4, np.float32))])


def test_document_veneer():
    d = t_pipe.create_document("x", text="t", image_path="/tmp/a.png")
    r = j_pipe.create_document("x", text="t", image_path="/tmp/a.png")
    assert d.image_path == r.image_path and d.image_source() == r.image_source()
    d.ht_mean, r.ht_mean, d.dewi_score, r.dewi_score = 2.5, 2.5, 0.8, 0.8
    assert d.payload().to_array().tolist() == r.payload().to_array().tolist()


# ---- packed images --------------------------------------------------------------


def test_packed_images_cross_packages(tmp_path):
    rng = np.random.default_rng(2)
    srcs = [rng.integers(0, 256, (20, 20, 3), dtype=np.uint8) for _ in range(9)]
    meta_ref = j_packed.pack_images(srcs, 16, tmp_path / "ref.npy", workers=0)
    meta_port = t_packed.pack_images(srcs, 16, tmp_path / "port.npy", workers=0)
    assert meta_ref == meta_port
    assert (tmp_path / "ref.npy").read_bytes() == (tmp_path / "port.npy").read_bytes()
    assert t_packed.is_packed_corpus(tmp_path / "ref.npy")
    assert not t_packed.is_packed_corpus(tmp_path / "ref.npy.json")
    port = t_packed.PackedImages(tmp_path / "ref.npy")
    ref = j_packed.PackedImages(tmp_path / "ref.npy")
    assert len(port) == 9 and port.base_size == 16 and port.meta == ref.meta
    for idx, size in (([0, 3, 8], 16), (list(range(9)), 16), ([1, 2], 8), ([4], 32)):
        assert np.array_equal(port.rows(idx, size), ref.rows(idx, size))
    port.MATERIALIZE_ROWS = 2
    lazy = port.rows([0, 1, 5], 8)
    assert len(lazy) == 3 and np.array_equal(np.stack(list(lazy)), ref.rows([0, 1, 5], 8))
    docs = port.as_documents(texts=[f"t{i}" for i in range(9)])
    assert [d.doc_id for d in docs] == [d.doc_id for d in ref.as_documents()]
    c = t_corpus.Corpus(ids=[d.doc_id for d in docs], images=port)
    assert c.has_image.all()


# ---- io -------------------------------------------------------------------------


@pytest.fixture
def pil_jpeg(monkeypatch):
    """PIL decode for JPEG paths in both packages (``DEWI_TPU_NO_NATIVE=1``
    semantics); ``tests/test_torch_native.py`` holds the two native pools to
    each other."""
    import dewi_tpu.native as j_native
    import dewi_tpu_torch.native as t_native

    monkeypatch.setattr(j_native, "decode_jpeg_batch", lambda *a, **k: None)
    monkeypatch.setattr(t_native, "decode_jpeg_batch", lambda *a, **k: None)


def _sources(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(3)
    out = [rng.integers(0, 256, (30, 40, 3), dtype=np.uint8),
           rng.random((25, 25, 3)).astype(np.float32),
           rng.random((12, 12)).astype(np.float32)]
    for i, fmt in enumerate(("png", "jpg")):
        p = tmp_path / f"im{i}.{fmt}"
        Image.fromarray(rng.integers(0, 256, (50, 60, 3), dtype=np.uint8)).save(p)
        out.append(str(p))
    return out


def test_dense_array_at_another_size_batches():
    """A dense ``[N, H, W, 3]`` corpus whose resolution is not the batch's
    goes through the decode path one thread; the reference raises there on
    the array's truth value (``dewi_tpu/io/images.py:151``), so it is held
    to the reference's per-image resize of the same rows."""
    rng = np.random.default_rng(5)
    dense = rng.integers(0, 256, (7, 20, 20, 3), dtype=np.uint8)
    assert t_images.effective_threads(4, dense) == 1
    got = list(t_images.iter_corpus_batches(dense, 16, 4))
    want = list(j_images.iter_padded_batches(list(dense), 16, 4, threads=1))
    assert [p for _, p in got] == [p for _, p in want] == [0, 1]
    for (g, _), (w, _) in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))


def test_decode_batch_and_prefetch(tmp_path, pil_jpeg):
    pytest.importorskip("PIL")
    srcs = _sources(tmp_path)
    for threads in (1, 4):
        assert np.array_equal(t_images.decode_batch(srcs, 24, threads=threads),
                              j_images.decode_batch(srcs, 24, threads=threads))
    assert t_images.effective_threads(8, srcs[:1]) == 1
    assert t_images.effective_threads(2, srcs) == j_images.effective_threads(2, srcs)
    for bs in (2, 5, 16):
        got = list(t_images.iter_padded_batches(srcs, 16, bs, threads=2))
        want = list(j_images.iter_padded_batches(srcs, 16, bs, threads=2))
        assert [p for _, p in got] == [p for _, p in want]
        assert all(np.array_equal(g, w) for (g, _), (w, _) in zip(got, want))
    via = list(t_images.iter_corpus_batches(srcs, 16, 2))
    assert all(np.array_equal(g, w) for (g, _), (w, _) in
               zip(via, j_images.iter_corpus_batches(srcs, 16, 2)))
    assert list(t_images.iter_padded_batches([], 16, 2)) == []


def test_prefetch_raises_on_the_consumer():
    srcs = [np.zeros((4, 4, 3), np.uint8)] * 3 + ["/nonexistent.png"] * 3
    with pytest.raises((FileNotFoundError, ImportError)):
        list(t_images.iter_padded_batches(srcs, 8, 2))


def test_image_cache(tmp_path, pil_jpeg):
    pytest.importorskip("PIL")
    srcs = _sources(tmp_path)
    port = t_images.ImageCache(srcs, 32, threads=2)
    ref = j_images.ImageCache(srcs, 32, threads=2)
    assert np.array_equal(port.base, ref.base) and len(port) == len(srcs)
    assert np.array_equal(port.at(16), ref.at(16)) and port.at(32) is port.base
    with pytest.raises(ValueError):
        port.at(64)
    assert t_images.ImageCache.fits(10, 224, 2) == j_images.ImageCache.fits(10, 224, 2)


def test_device_images_or_none():
    imgs = np.random.default_rng(4).integers(0, 256, (5, 6, 6, 3), dtype=np.uint8)
    di = t_devimg.device_images_or_none(imgs, device="cpu")
    assert di is not None and torch.equal(di.base, torch.from_numpy(imgs))
    assert di.device.type == "cpu" and len(di) == 5
    for bad in (imgs.astype(np.float32), imgs[..., :2], imgs[:0], list(imgs), imgs[0]):
        assert t_devimg.device_images_or_none(bad, device="cpu") is None
        assert j_devimg.device_images_or_none(bad) is None
    assert t_devimg.MAX_BYTES == j_devimg.MAX_BYTES


def test_device_images_budget(monkeypatch):
    imgs = np.zeros((4, 8, 8, 3), np.uint8)
    monkeypatch.setattr(t_devimg, "MAX_BYTES", imgs.nbytes - 1)
    assert t_devimg.device_images_or_none(imgs, device="cpu") is None
    monkeypatch.setattr(t_devimg, "MAX_BYTES", imgs.nbytes)
    assert t_devimg.device_images_or_none(imgs, device="cpu", non_blocking=True) is not None


def test_progress_meter():
    outs = []
    for mod in (t_progress, j_progress):
        buf = io.StringIO()
        m = mod.ProgressMeter(10, "stage", interval=1e9, stream=buf)
        for _ in range(4):
            m.update(2)
        m.close()
        m.update(2)
        outs.append(buf.getvalue().count("stage:"))
        assert mod.meter_callback(mod.ProgressMeter(0, "x")) is None
    assert outs[0] == outs[1]


# ---- sampling -------------------------------------------------------------------


def _dewi(n, seed):
    return np.random.default_rng(seed).random(n).astype(np.float32)


@pytest.mark.parametrize("tau", [0.0, 0.5, 1.0, 3.0])
def test_tau_probabilities(tau):
    d = _dewi(50, 1)
    assert np.array_equal(t_sampling.dewi_tau_probabilities(d, tau),
                          j_sampling.dewi_tau_probabilities(d, tau))


@pytest.mark.parametrize("n,k,tau", [(20, 5, 1.0), (100, 30, 2.0), (7, 7, 0.5)])
def test_gumbel_topk_with_injected_uniforms(n, k, tau, monkeypatch):
    """The same uniforms through both Gumbel top-k samplers: equal indices."""
    d = _dewi(n, n)
    u = t_sampling.uniform_noise(n, seed=k, device=torch.device("cpu")).numpy()
    log_w = np.log(np.clip(d, 1e-12, None)) * np.float32(tau)
    monkeypatch.setattr(j_sampling.jax.random, "uniform",
                        lambda key, shape, minval, maxval: jax.numpy.asarray(u))
    _, want = j_sampling._gumbel_topk.__wrapped__(jax.numpy.asarray(log_w),
                                                  jax.random.PRNGKey(0), k)
    got = t_sampling._gumbel_topk(torch.from_numpy(log_w), torch.from_numpy(u), k)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert u.min() >= 1e-12 and u.max() < 1.0


def _chi2_ok(counts, probs, draws):
    """Pearson's chi-square below its 1e-4 upper quantile."""
    from scipy.stats import chi2

    expected = probs * draws
    stat = float(((counts - expected) ** 2 / expected).sum())
    return stat <= chi2.ppf(1 - 1e-4, len(probs) - 1), stat


@pytest.mark.parametrize("tau", [0.5, 2.0])
def test_sampling_distribution(tau):
    d = np.array([0.05, 0.2, 0.4, 0.6, 0.9, 1.0], np.float32)
    p = t_sampling.dewi_tau_probabilities(d, tau)
    draws = t_sampling.sample_by_dewi(d, 6000, tau=tau, seed=3, replace=True, device="cpu")
    ok, stat = _chi2_ok(np.bincount(draws, minlength=6), p, 6000)
    assert ok, stat
    firsts = np.array([t_sampling.sample_by_dewi(d, 1, tau=tau, seed=s, device="cpu")[0]
                       for s in range(3000)])
    ok, stat = _chi2_ok(np.bincount(firsts, minlength=6), p, 3000)
    assert ok, stat
    picks = t_sampling.sample_by_dewi(d, 6, tau=tau, seed=1, device="cpu")
    assert sorted(picks.tolist()) == list(range(6))
    with pytest.raises(ValueError):
        t_sampling.sample_by_dewi(d, 7, device="cpu")
    assert np.array_equal(t_sampling.sample_by_dewi(d, 3, seed=9, device="cpu"),
                          t_sampling.sample_by_dewi(d, 3, seed=9, device="cpu"))


@pytest.mark.parametrize("with_dewi", [False, True])
def test_submodular_pick(with_dewi):
    rng = np.random.default_rng(5)
    emb = rng.normal(size=(60, 16)).astype(np.float32)
    d = _dewi(60, 6) if with_dewi else None
    got = t_sampling.submodular_pick(emb, 12, dewi=d, device="cpu")
    assert np.array_equal(got, np.asarray(j_sampling.submodular_pick(emb, 12, dewi=d)))
    assert np.array_equal(t_sampling.submodular_pick(emb[:5], 9, device="cpu"), np.arange(5))
    assert np.array_equal(
        t_sampling.training_sample(d if d is not None else _dewi(60, 7), emb, 12,
                                   use_submodular=True, device="cpu"),
        np.asarray(j_sampling.training_sample(d if d is not None else _dewi(60, 7), emb, 12,
                                              use_submodular=True)))
    with pytest.raises(ValueError):
        t_sampling.training_sample(_dewi(5, 1), None, 2, use_submodular=True, device="cpu")


def test_config_json_files_cross(tmp_path):
    (tmp_path / "c.json").write_text(json.dumps(j_config.DewiConfig().to_dict()))
    data = json.loads((tmp_path / "c.json").read_text())
    assert t_config.DewiConfig.from_dict(data).to_dict() == data
