"""Data-parallel signal extraction on four gloo ranks against the meshless
JAX package.

``DataParallel``, the three model-backed estimators under ``mesh=``, the
sharded redundancy scan and ``DewiPipeline(mesh=)`` run on four CPU ranks
started by ``parallel.launch_local`` (one launch, a module-scoped fixture;
the rank functions live at module level and JAX is imported only in the
test bodies).  Each is held to the reference *without* a mesh (the
reference's own mesh-vs-meshless pipeline test is a known failure), on the
same msgpack checkpoints with float32 sidecars:

* text NLL mean/q90/q99, per-token NLL, CLIP embeddings and cosines: 1e-5
  (max |port - ref| over max |ref|);
* MAE mean/q90: 1e-5, with the reference's masking noise injected into the
  port's estimator (``_batch_noise``), since PyTorch's stream is not JAX's;
* ``max_offdiag_similarity_sharded``: within 1e-6 of both the reference's
  sharded scan (on 4 virtual devices) and its single-device scan;
* the pipeline's seven signal columns: 1e-5, and its DEWI scores: the
  reference's scorer over the port's signals, 1e-6.
"""

import numpy as np
import pytest
import torch

from dewi_tpu_torch.parallel import DataParallel, launch_local, make_mesh

RANKS = 4
LAUNCH_TIMEOUT = 120.0
RTOL = 1e-5
MAX_LEN = 64
IMAGE_SEED = 7
BS = 4
N_PIPE = 24


def rel_dev(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    if not want.size:
        return 0.0
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _texts():
    rng = np.random.default_rng(0)
    words = ["tpu", "cuda", "entropy", "image", "token", "zebra", "quartz", "ü", "日本"]
    out = []
    for n in (0, 3, 20, 31, 32, 40, 63, 64, 100, 250):  # buckets, their edges, windows
        s = ""
        while len(s.encode()) < n:
            s += rng.choice(words) + " "
        out.append(s.encode()[:n].decode("utf-8", "ignore"))
    return out


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


def _embeddings():
    return np.random.default_rng(3).normal(size=(300, 16)).astype(np.float32)


def _pipe_corpus_parts():
    """Text-only, image-only and paired docs, two planted duplicates."""
    rng = np.random.default_rng(11)
    words = ["cat", "photo", "river", "entropy", "zebra", "quartz", "ü", "日本", "!!"]
    texts, has_img = [], []
    for i in range(N_PIPE):
        kind = i % 3  # 0 text, 1 image, 2 both
        texts.append(None if kind == 1 else " ".join(rng.choice(words, int(rng.integers(1, 30)))))
        has_img.append(kind != 0)
    imgs = _images(N_PIPE, seed=12)
    texts[9] = texts[0]           # a text duplicate (doc 9 is text-only)
    imgs[10] = imgs[1]            # an image duplicate
    return texts, np.asarray(has_img), imgs


def _config_dict(ckpt):
    return {
        "text": {"model": "tiny", "batch_size": BS, "max_length": MAX_LEN,
                 "checkpoint": ckpt["lm"]},
        "image": {"model": "tiny", "batch_size": BS, "image_size": 32, "patch_size": 8,
                  "checkpoint": ckpt["mae"]},
        "cross_modal": {"model": "tiny", "batch_size": BS, "checkpoint": ckpt["clip"]},
        "redundancy": {"block_size": 8},
    }


# ---- rank function (no JAX) -----------------------------------------------------


def _corpus(corpus_cls, document_cls):
    """The pipeline corpus in either package's ``Corpus``."""
    texts, has_img, imgs = _pipe_corpus_parts()
    return corpus_cls.from_documents([
        document_cls(doc_id=f"d{i}", text=texts[i], image=imgs[i] if has_img[i] else None)
        for i in range(N_PIPE)])


def _injected(est, noises):
    """The reference's masking noise, batch by batch (keyed by offset)."""
    est._batch_noise = lambda seed, offset, rows: torch.from_numpy(noises[offset])
    return est


def _signals_worker(ckpt, tmp, image_noises, pipe_noises):
    import torch.distributed as dist

    from dewi_tpu_torch import Corpus, DewiConfig, DewiPipeline, Document
    from dewi_tpu_torch.signals import (CrossModalDependency, ImageEntropyEstimator,
                                        TextEntropyEstimator)
    from dewi_tpu_torch.signals.redundancy import (RedundancyEstimator,
                                                   max_offdiag_similarity_sharded)

    mesh = make_mesh(device="cpu")
    rank = dist.get_rank()
    out = {}

    dp = DataParallel(mesh)
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    part = dp.put(x)
    layered = np.stack([x, -x])  # [S, bs, ...]: the batch on axis 1
    out["dp"] = dict(round=[dp.round_batch(b) for b in (1, 4, 5, 9)],
                     part=part.numpy(), gathered=dp.gather(part).numpy(),
                     axis1=dp.gather(dp.put(layered, batch_axis=1), batch_axis=1).numpy())
    net = torch.nn.Linear(3, 2)
    with torch.no_grad():
        net.weight.fill_(float(rank))
    dp.replicate(net)
    weights = [torch.zeros(2, 3) for _ in range(RANKS)]
    dist.all_gather(weights, net.weight.detach().clone())
    out["dp"]["replicated"] = [w.numpy() for w in weights]

    texts = _texts()
    lm = TextEntropyEstimator("tiny", batch_size=6, max_length=MAX_LEN, checkpoint=ckpt["lm"],
                              mesh=mesh)
    res = lm.batch_compute(texts)
    out["text"] = dict(batch_size=lm.batch_size, device=str(lm.device),
                       stats=lm.batch_compute_stats(texts),
                       tokens=[np.asarray(r.token_entropies, np.float32) for r in res])

    imgs = _images(10)
    mae = _injected(ImageEntropyEstimator("tiny", batch_size=BS, checkpoint=ckpt["mae"],
                                          mesh=mesh), image_noises)
    out["image"] = dict(stats=mae.batch_compute_stats(imgs, seed=IMAGE_SEED),
                        losses=np.asarray(mae.batch_compute(imgs, seed=IMAGE_SEED)))

    clip = CrossModalDependency("tiny", batch_size=BS, checkpoint=ckpt["clip"], mesh=mesh)
    out["clip"] = dict(texts=clip.encode_texts(texts), images=clip.encode_images(imgs),
                       diagonal=clip.batch_diagonal(texts, imgs))

    emb = _embeddings()
    out["redundancy"] = dict(
        sharded=max_offdiag_similarity_sharded(emb, mesh, block=32),
        estimator=RedundancyEstimator(mesh=mesh, block_size=32).fit(emb).score())

    cfg = DewiConfig.from_dict(_config_dict(ckpt))
    pipe = DewiPipeline(cfg, mesh=mesh)
    _injected(pipe.image_entropy, pipe_noises)
    corpus = pipe.process_corpus(_corpus(Corpus, Document))
    stream = DewiPipeline(cfg, mesh=mesh)
    for name in ("_text_entropy", "_image_entropy", "_cross_modal"):
        setattr(stream, name, getattr(pipe, name))
    streamed = stream.process_stream_corpus(_corpus(Corpus, Document), shard_size=10,
                                            checkpoint_dir=tmp)
    index = pipe.build_index_corpus(corpus)
    built = [None] * RANKS
    dist.all_gather_object(built, index is not None)
    knob = DewiConfig.from_dict({**_config_dict(ckpt), "mesh": {"data_parallel_signals": True}})
    out["pipeline"] = dict(
        signals=corpus.signals, dewi=corpus.dewi, embeddings=corpus.embeddings,
        streamed=streamed.signals, streamed_dewi=streamed.dewi, built=built,
        self_hits=(index.search_batch(corpus.embeddings[2:7], k=1, eta=0.0,
                                      entropy_pref=0.0)[1][:, 0].tolist()
                   if index is not None else None),
        knob_shape=DewiPipeline(knob, device="cpu").mesh.shape)
    return out


# ---- the reference --------------------------------------------------------------


def _jit_init(model_cls, *args):
    """The reference's ``init_*`` jitted: its estimators load a checkpoint
    over these params, so only the speed of the init changes."""
    import jax

    def init(cfg, seed=0):
        model = model_cls(cfg)
        built = [a(cfg) if callable(a) else a for a in args]
        return model, jax.jit(lambda k: model.init(k, *built))(jax.random.PRNGKey(seed))
    return init


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The checkpoints, the reference's meshless estimators and pipeline
    results, and its masking noise."""
    import jax
    import jax.numpy as jnp

    import dewi_tpu.io.device_images as j_device_images
    from dewi_tpu.config import DewiConfig as JConfig
    from dewi_tpu.corpus import Corpus as JCorpus
    from dewi_tpu.models import registry as jreg
    from dewi_tpu.models.import_hf import write_sidecar_config
    from dewi_tpu.pipelines import DewiPipeline as JPipeline
    from dewi_tpu.pipelines import Document as JDocument
    from dewi_tpu.signals import cross_modal as j_cross
    from dewi_tpu.signals import image_entropy as j_image
    from dewi_tpu.signals import text_entropy as j_text
    from dewi_tpu_torch.models import registry as treg

    tmp = tmp_path_factory.mktemp("parallel_signals")
    ckpt = {}
    for kind, cfg, init in (
            ("lm", treg.lm_config("tiny", max_len=MAX_LEN, dtype="float32"), treg.init_lm),
            ("mae", treg.mae_config("tiny", dtype="float32"), treg.init_mae),
            ("clip", treg.clip_config("tiny", dtype="float32"), treg.init_clip)):
        path = tmp / f"{kind}.msgpack"
        treg.save_params(init(cfg, seed=3, device="cpu"), path)
        write_sidecar_config(path, kind, cfg)
        ckpt[kind] = str(path)

    inits = {
        (j_text, "init_lm"): _jit_init(jreg.CausalLM, jnp.zeros((1, 8), jnp.int32),
                                       jnp.ones((1, 8))),
        (j_cross, "init_clip"): _jit_init(
            jreg.CLIPDualEncoder, lambda c: jnp.zeros((1, c.text_len), jnp.int32),
            lambda c: jnp.ones((1, c.text_len)),
            lambda c: jnp.zeros((1, c.image_size, c.image_size, 3))),
        (j_image, "init_mae"): _jit_init(
            jreg.ViTMAE, lambda c: jnp.zeros((1, c.image_size, c.image_size, 3)),
            jax.random.PRNGKey(1)),
    }
    with pytest.MonkeyPatch.context() as mp:
        for (mod, name), fn in inits.items():
            mp.setattr(mod, name, fn)
        # Host batch paths on both sides (the port's mesh skips residency).
        mp.setattr(j_device_images, "MAX_BYTES", 0)
        texts, imgs = _texts(), _images(10)
        lm = j_text.TextEntropyEstimator("tiny", batch_size=6, max_length=MAX_LEN,
                                         checkpoint=ckpt["lm"])
        mae = j_image.ImageEntropyEstimator("tiny", batch_size=BS, checkpoint=ckpt["mae"])
        clip = j_cross.CrossModalDependency("tiny", batch_size=BS, checkpoint=ckpt["clip"])
        ref = dict(
            text_stats=lm.batch_compute_stats(texts),
            text_tokens=[np.asarray(r.token_entropies, np.float32)
                         for r in lm.batch_compute(texts)],
            image_stats=mae.batch_compute_stats(imgs, seed=IMAGE_SEED),
            image_losses=np.asarray(mae.batch_compute(imgs, seed=IMAGE_SEED)),
            clip_texts=clip.encode_texts(texts), clip_images=clip.encode_images(imgs),
            clip_diagonal=np.asarray([r.info_nce_score for r in clip.batch_compute(texts, imgs)]))
        _, has_img, _ = _pipe_corpus_parts()
        pipe = JPipeline(JConfig.from_dict(_config_dict(ckpt)))
        jc = pipe.process_corpus(_corpus(JCorpus, JDocument))
        ref.update(pipe_signals=np.asarray(jc.signals), pipe_embeddings=np.asarray(jc.embeddings))

    def noise(seed, n_images):
        patches = mae.cfg.num_patches
        key = jax.random.PRNGKey(seed)
        return {b: np.asarray(jax.random.uniform(jax.random.fold_in(key, b), (BS, patches)))
                for b in range(0, n_images, BS)}

    return dict(ckpt=ckpt, tmp=tmp, ref=ref, image_noises=noise(IMAGE_SEED, 10),
                pipe_noises=noise(0, int(has_img.sum())))


@pytest.fixture(scope="module")
def port(reference):
    return launch_local(_signals_worker, RANKS,
                        (reference["ckpt"], str(reference["tmp"] / "stream"),
                         reference["image_noises"], reference["pipe_noises"]),
                        timeout=LAUNCH_TIMEOUT, threads=1)


# ---- DataParallel ----------------------------------------------------------------


def test_round_batch(port):
    assert port["dp"]["round"] == [4, 4, 8, 12]


def test_put_slices_and_gather_joins(port):
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    np.testing.assert_array_equal(port["dp"]["part"], x[:2])  # rank 0's rows
    np.testing.assert_array_equal(port["dp"]["gathered"], x)
    np.testing.assert_array_equal(port["dp"]["axis1"], np.stack([x, -x]))


def test_replicate_gives_every_rank_the_first_ranks_weights(port):
    for w in port["dp"]["replicated"]:
        np.testing.assert_array_equal(w, np.zeros((2, 3), np.float32))


def test_data_parallel_refuses_what_is_not_a_mesh():
    with pytest.raises(TypeError, match="mesh"):
        DataParallel(object())
    one = DataParallel(make_mesh(device="cpu"))
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(one.gather(one.put(x)), x)


# ---- the estimators ------------------------------------------------------------------


def test_text_stats_match_meshless_reference(port, reference):
    assert port["text"]["batch_size"] == 8 and port["text"]["device"] == "cpu"
    for got, want in zip(port["text"]["stats"], reference["ref"]["text_stats"]):
        assert rel_dev(got, want) <= RTOL


def test_text_token_streams_match_meshless_reference(port, reference):
    got, want = port["text"]["tokens"], reference["ref"]["text_tokens"]
    assert [len(g) for g in got] == [len(w) for w in want]
    assert rel_dev(np.concatenate(got), np.concatenate(want)) <= RTOL


def test_image_stats_match_meshless_reference(port, reference):
    for got, want in zip(port["image"]["stats"], reference["ref"]["image_stats"]):
        assert rel_dev(got, want) <= RTOL
    assert rel_dev(port["image"]["losses"], reference["ref"]["image_losses"]) <= RTOL


@pytest.mark.parametrize("what", ["texts", "images", "diagonal"])
def test_clip_towers_match_meshless_reference(port, reference, what):
    assert rel_dev(port["clip"][what], reference["ref"][f"clip_{what}"]) <= RTOL


@pytest.mark.parametrize("which", ["sharded", "estimator"])
def test_sharded_redundancy_scan(port, which):
    import jax

    from dewi_tpu.parallel import make_mesh as jmake_mesh
    from dewi_tpu.signals.redundancy import (max_offdiag_similarity,
                                             max_offdiag_similarity_sharded)

    emb = _embeddings()
    got = port["redundancy"][which]
    jmesh = jmake_mesh(RANKS, 1, devices=jax.devices()[:RANKS])
    np.testing.assert_allclose(got, max_offdiag_similarity_sharded(emb, jmesh, block=32),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, max_offdiag_similarity(emb, block=32), rtol=0, atol=1e-6)


def test_sharded_scan_equals_the_single_device_scan():
    """On one rank the sharded scan is the single-device scan, bit for bit."""
    from dewi_tpu_torch.signals.redundancy import (max_offdiag_similarity,
                                                   max_offdiag_similarity_sharded)

    emb = _embeddings()
    np.testing.assert_array_equal(
        max_offdiag_similarity_sharded(emb, make_mesh(device="cpu"), block=32),
        max_offdiag_similarity(emb, block=32, device="cpu"))


# ---- the pipeline ---------------------------------------------------------------------


def test_pipeline_signals_match_meshless_reference(port, reference):
    from dewi_tpu_torch.types import SIGNAL_FIELDS

    got, want = port["pipeline"]["signals"], reference["ref"]["pipe_signals"]
    for j, name in enumerate(SIGNAL_FIELDS):
        assert rel_dev(got[:, j], want[:, j]) <= RTOL, name
    assert rel_dev(port["pipeline"]["embeddings"], reference["ref"]["pipe_embeddings"]) <= RTOL
    red = got[:, SIGNAL_FIELDS.index("redundancy")]
    assert red[9] == pytest.approx(1.0, abs=1e-5) and red[10] == pytest.approx(1.0, abs=1e-5)


def test_pipeline_dewi_through_the_reference_scorer(port):
    from dewi_tpu.scorer import DewiScorer as JScorer

    want = np.asarray(JScorer().fit_and_score(port["pipeline"]["signals"]))
    assert rel_dev(port["pipeline"]["dewi"], want) <= 1e-6


def test_pipeline_stream_with_checkpoints_equals_monolithic(port, reference):
    """Shard checkpoints are written by rank 0 while the others wait.  The
    MAE columns are left out: a shard's masks are drawn from offsets within
    the shard, in both packages."""
    from dewi_tpu_torch.types import SIGNAL_FIELDS

    keep = [j for j, name in enumerate(SIGNAL_FIELDS) if name not in ("hi_mean", "hi_q90")]
    np.testing.assert_allclose(port["pipeline"]["streamed"][:, keep],
                               port["pipeline"]["signals"][:, keep], rtol=1e-6, atol=1e-6)
    assert np.isfinite(port["pipeline"]["streamed_dewi"]).all()
    written = sorted(p.name for p in (reference["tmp"] / "stream").iterdir())
    assert written == [f"shard_{s:05d}.npz" for s in range(3)]


def test_pipeline_index_handoff_on_rank_zero(port):
    assert port["pipeline"]["built"] == [True] + [False] * (RANKS - 1)
    assert port["pipeline"]["self_hits"] == [2, 3, 4, 5, 6]


def test_config_knob_builds_a_mesh_over_the_ranks(port):
    assert port["pipeline"]["knob_shape"] == {"data": RANKS, "model": 1}
