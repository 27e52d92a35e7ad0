"""The port's ``DewiPipeline`` against ``dewi_tpu.pipelines`` on the same inputs.

Both packages load the same three msgpack checkpoints (LM, MAE, CLIP)
written by the port, each with a ``.config.json`` sidecar that fixes the
architecture and the compute dtype, so the signal models run the same
weights; the reference's pipeline runs without a mesh.  Tolerances, as max
|port - ref| over max(|ref|, 1) per column, with float32 sidecars:

* ``ht_mean``, ``ht_q90``, ``I_hat``, embeddings, redundancy: 1e-5;
* noise: 1e-6;
* ``hi_mean``, ``hi_q90``: the MAE masks come from PyTorch's generator,
  not JAX's, so these columns are held to the port's own
  ``ImageEntropyEstimator`` on the same uint8 images (1e-6), as the
  signal tests do; the model-level test injects the reference's noise;
* ``dewi``: the port's signal matrix through both scorers, 1e-6;
* the bfloat16 sidecar (the default dtype): 1e-2, as the signal tests
  hold the per-doc NLL.

Indexes built by both packages from the same corpus columns return equal
ids (except where two scores tie exactly) and record the same encoder
provenance.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dewi_tpu.corpus as j_corpus
import dewi_tpu.pipelines as j_pipe
from dewi_tpu.config import DewiConfig as JConfig
from dewi_tpu.models import registry as jreg
from dewi_tpu.models.import_hf import write_sidecar_config
from dewi_tpu.scorer import DewiScorer as JScorer
from dewi_tpu.signals import cross_modal as j_cross
from dewi_tpu.signals import image_entropy as j_image
from dewi_tpu.signals import text_entropy as j_text
from dewi_tpu_torch import Corpus, DewiConfig, DewiPipeline, DewiScorer, Document
from dewi_tpu_torch import pipelines as t_pipe
from dewi_tpu_torch.io import decode_batch
from dewi_tpu_torch.models import registry as treg
from dewi_tpu_torch.types import SIGNAL_FIELDS

F32_RTOL = 1e-5
NOISE_TOL = 1e-6
DEWI_TOL = 1e-6
BF16_RTOL = 1e-2
COL = {name: i for i, name in enumerate(SIGNAL_FIELDS)}
N_DOCS = 40


def rel_dev(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    if not want.size:
        return 0.0
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1.0))


def _jit_init(model_cls, *args):
    """The reference's ``init_*`` jitted: its estimators load a checkpoint
    over these params, so only the speed of the init changes."""
    def init(cfg, seed=0):
        model = model_cls(cfg)
        built = [a(cfg) if callable(a) else a for a in args]
        return model, jax.jit(lambda k: model.init(k, *built))(jax.random.PRNGKey(seed))
    return init


_REF_INITS = {
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


@pytest.fixture(scope="module", autouse=True)
def jitted_reference_inits():
    with pytest.MonkeyPatch.context() as mp:
        for (mod, name), fn in _REF_INITS.items():
            mp.setattr(mod, name, fn)
        yield


def _checkpoints(tmp, dtype):
    """LM, MAE and CLIP checkpoints (tiny presets) with sidecars."""
    out = {}
    for kind, cfg, init in (
            ("lm", treg.lm_config("tiny", max_len=64, dtype=dtype), treg.init_lm),
            ("mae", treg.mae_config("tiny", dtype=dtype), treg.init_mae),
            ("clip", treg.clip_config("tiny", dtype=dtype), treg.init_clip)):
        path = tmp / f"{kind}.msgpack"
        treg.save_params(init(cfg, seed=3, device="cpu"), path)
        write_sidecar_config(path, kind, cfg)
        out[kind] = str(path)
    return out


def _config_dict(ckpt, **over):
    cfg = {
        "text": {"model": "tiny", "batch_size": 4, "max_length": 64,
                 "checkpoint": ckpt["lm"]},
        "image": {"model": "tiny", "batch_size": 4, "image_size": 32, "patch_size": 8,
                  "checkpoint": ckpt["mae"]},
        "cross_modal": {"model": "tiny", "batch_size": 4, "checkpoint": ckpt["clip"]},
        "redundancy": {"block_size": 8},
    }
    for k, v in over.items():
        cfg[k] = {**cfg.get(k, {}), **v}
    return cfg


def _docs(seed=0, n=N_DOCS):
    """Text-only, image-only and multimodal docs, exact duplicates, ASCII
    and non-ASCII text, uint8 and float images at two sizes."""
    rng = np.random.default_rng(seed)
    words = ["cat", "photo", "river", "entropy", "zebra", "quartz", "ü", "日本", "!!", "#"]
    docs = []
    for i in range(n):
        kind = i % 4  # 0 text, 1 image, 2 both, 3 both with a float image
        text = None
        if kind != 1:
            text = " ".join(rng.choice(words, size=int(rng.integers(1, 30))))
        image = None
        if kind == 1 or kind == 2:
            image = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
        elif kind == 3:
            image = rng.random((48, 48, 3)).astype(np.float32)
        docs.append((f"d{i}", text, image))
    docs[5] = ("d5", docs[1][1], docs[1][2])     # an image duplicate
    docs[8] = ("d8", docs[0][1], None)           # a text duplicate
    docs[10] = ("d10", docs[2][1], docs[2][2])   # a pair duplicate
    return docs


def _port_docs(spec):
    return [Document(doc_id=i, text=t, image=im) for i, t, im in spec]


def _ref_docs(spec):
    return [j_pipe.Document(doc_id=i, text=t, image=im) for i, t, im in spec]


def _doc_columns(docs):
    return np.array([[float(getattr(d, k) or 0.0) for k in SIGNAL_FIELDS] for d in docs])


@pytest.fixture(scope="module")
def f32(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe_f32")
    ckpt = _checkpoints(tmp, "float32")
    cfg = _config_dict(ckpt)
    ref = j_pipe.DewiPipeline(JConfig.from_dict(cfg))
    port = DewiPipeline(DewiConfig.from_dict(cfg), device="cpu")
    spec = _docs()
    rdocs = ref.compute_signals(_ref_docs(spec))
    pdocs = port.compute_signals(_port_docs(spec))
    return dict(ckpt=ckpt, cfg=cfg, ref=ref, port=port, spec=spec, rdocs=rdocs, pdocs=pdocs)


def _pipelines(f32, **over):
    """A port and a reference pipeline with ``over`` in their config that
    share the f32 fixture's signal models (built and, for the reference,
    compiled once)."""
    cfg = _config_dict(f32["ckpt"], **over)
    port = DewiPipeline(DewiConfig.from_dict(cfg), device="cpu")
    ref = j_pipe.DewiPipeline(JConfig.from_dict(cfg))
    for new, old in ((port, f32["port"]), (ref, f32["ref"])):
        new._text_entropy = old.text_entropy
        new._image_entropy = old.image_entropy
        new._cross_modal = old.cross_modal
    return port, ref


def _image_rows(port, spec):
    """The uint8 rows the pipeline's decode-once cache hands the MAE."""
    idx = [i for i, (_, _, im) in enumerate(spec) if im is not None]
    size = max(port.image_entropy.image_size, port.cross_modal.cfg.image_size)
    return idx, decode_batch([spec[i][2] for i in idx], size)


def _check_columns(port_sig, ref_sig, port, spec, emb_port, emb_ref, rtol=F32_RTOL):
    for name in ("ht_mean", "ht_q90", "I_hat", "redundancy"):
        dev = rel_dev(port_sig[:, COL[name]], ref_sig[:, COL[name]])
        assert dev <= rtol, f"{name}: {dev}"
    assert np.abs(port_sig[:, COL["noise"]] - ref_sig[:, COL["noise"]]).max() <= NOISE_TOL
    assert rel_dev(emb_port, emb_ref) <= rtol
    idx, rows = _image_rows(port, spec)
    means, q90s = port.image_entropy.batch_compute_stats(rows)
    assert rel_dev(port_sig[idx, COL["hi_mean"]], means) <= 1e-6
    assert rel_dev(port_sig[idx, COL["hi_q90"]], q90s) <= 1e-6
    no_image = [i for i, (_, _, im) in enumerate(spec) if im is None]
    assert not port_sig[no_image, COL["hi_mean"]].any()


def test_object_path_matches_reference(f32):
    pd, rd = f32["pdocs"], f32["rdocs"]
    for p, r in zip(pd, rd):
        for name in SIGNAL_FIELDS:
            assert (getattr(p, name) is None) == (getattr(r, name) is None), name
    _check_columns(_doc_columns(pd), _doc_columns(rd), f32["port"], f32["spec"],
                   np.stack([d.embedding for d in pd]), np.stack([d.embedding for d in rd]))
    red = np.array([d.redundancy for d in pd])
    assert red[5] == pytest.approx(1.0, abs=1e-6) and red[8] == pytest.approx(1.0, abs=1e-6)


def test_columnar_path_matches_reference(f32):
    spec = f32["spec"]
    pc = f32["port"].process_corpus(Corpus.from_documents(_port_docs(spec)))
    rc = f32["ref"].process_corpus(j_corpus.Corpus.from_documents(_ref_docs(spec)))
    _check_columns(pc.signals, rc.signals, f32["port"], spec, pc.embeddings, rc.embeddings)
    # The Document API is a veneer over the same columnar stages.
    assert np.array_equal(pc.signals, _doc_columns(f32["pdocs"]))
    assert pc.clip_embedded and rc.clip_embedded
    assert np.isfinite(pc.dewi).all() and pc.dewi.shape == (N_DOCS,)


def test_dewi_through_both_scorers(f32):
    sig = _doc_columns(f32["pdocs"]).astype(np.float32)
    port = f32["port"].compute_dewi_scores(f32["pdocs"])
    got = np.array([d.dewi_score for d in port])
    want = np.asarray(JScorer().fit_and_score(sig))
    assert np.abs(got - want).max() <= DEWI_TOL
    assert np.abs(DewiScorer(device="cpu").fit_and_score(sig).numpy() - want).max() <= DEWI_TOL


def _ref_corpus_like(pc):
    """A reference ``Corpus`` holding the port corpus's columns."""
    rc = j_corpus.Corpus(ids=list(pc.ids), texts=list(pc.texts), images=pc.images,
                         embeddings=pc.embeddings.copy(), signals=pc.signals.copy(),
                         dewi=pc.dewi.copy())
    rc.clip_embedded = pc.clip_embedded
    rc.clip_filled_mask = pc.clip_filled_mask.copy()
    return rc


def _same_ids(got_s, got_i, want_s, want_i):
    got_s, want_s = np.asarray(got_s), np.asarray(want_s)
    assert np.abs(got_s - want_s).max() <= 1e-5
    for gs, gi, wi in zip(got_s, np.asarray(got_i), np.asarray(want_i)):
        for j in range(len(gi)):
            if gi[j] != wi[j]:  # only where two docs' scores tie exactly
                assert np.sum(gs == gs[j]) > 1, (gi, wi)


@pytest.mark.parametrize("index", [
    {"ann": "auto"},
    {"ann": "int8", "int8_queries": True},
    {"ann": "int4"},
    {"ann": "ivf", "nlist": 4, "nprobe": 4},
], ids=["auto", "int8_s8", "int4", "ivf"])
def test_build_index_corpus_matches_reference(f32, index):
    port, ref = _pipelines(f32, index=index)
    pc = port.process_corpus(Corpus.from_documents(_port_docs(f32["spec"])))
    pidx = port.build_index_corpus(pc)
    ridx = ref.build_index_corpus(_ref_corpus_like(pc))
    assert pidx.encoder == ridx.encoder and pidx.encoder["source"] == "cross_modal"
    assert type(pidx._backend).__name__ == type(ridx._backend).__name__
    queries = np.stack([port.encode_query(t) for t in ("a cat photo", "river entropy", "日本")])
    assert rel_dev(queries, np.stack([ref.encode_query(t) for t in
                                      ("a cat photo", "river entropy", "日本")])) <= F32_RTOL
    ps, pi = pidx.search_batch(queries, k=5)
    rs, ri = ridx.search_batch(queries, k=5)
    _same_ids(ps.numpy(), pi.numpy(), rs, ri)


def test_build_index_object_path_provenance(f32):
    """``build_index``: ``cross_modal`` when the towers filled every
    embedding, ``mixed`` with some external rows, ``external`` with none."""
    port, ref = f32["port"], f32["ref"]
    pidx = port.build_index(f32["pdocs"])
    ridx = ref.build_index(f32["rdocs"])
    assert pidx.encoder == ridx.encoder and pidx.encoder["source"] == "cross_modal"
    assert len(pidx) == len(ridx) == N_DOCS
    rng = np.random.default_rng(1)
    ext = [np.asarray(rng.normal(size=64), np.float32) for _ in range(3)]
    for make, source in (((lambda: [Document("x0", text="abc", embedding=ext[0]),
                                    Document("x1", text="de fg")]), "mixed"),
                         ((lambda: [Document("y0", text="abc", embedding=ext[1]),
                                    Document("y1", text="de", embedding=ext[2])]),
                          "external")):
        p2, r2 = _pipelines(f32)
        pdocs = make()
        rdocs = [j_pipe.Document(doc_id=d.doc_id, text=d.text, embedding=d.embedding)
                 for d in pdocs]
        p2.compute_dewi_scores(p2.compute_signals(pdocs))
        r2.compute_dewi_scores(r2.compute_signals(rdocs))
        pe, re_ = p2.build_index(pdocs).encoder, r2.build_index(rdocs).encoder
        assert pe["source"] == re_["source"] == source
        assert {k: v for k, v in pe.items() if k != "d_embed"} == \
            {k: v for k, v in re_.items() if k != "d_embed"}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_stage_checkpoints_cross_packages(f32, tmp_path, writer, monkeypatch):
    """A checkpoint directory written by either package resumes in the
    other: same digest, no stage recomputed; a changed text invalidates."""
    spec = f32["spec"][:12]
    port_docs, ref_docs = _port_docs(spec), _ref_docs(spec)
    assert t_pipe._StageCheckpoint._digest(port_docs) == \
        j_pipe._StageCheckpoint._digest(ref_docs)
    first, second = (f32["ref"], f32["port"]) if writer == "reference" else \
        (f32["port"], f32["ref"])
    first_docs, second_docs = (ref_docs, port_docs) if writer == "reference" else \
        (port_docs, ref_docs)
    first.compute_signals(first_docs, checkpoint_dir=tmp_path)
    assert {p.name for p in tmp_path.iterdir()} == {
        "text.npz", "image.npz", "cross_modal.npz", "redundancy.npz", "noise.npz"}

    calls = []
    est = second.text_entropy
    monkeypatch.setattr(est, "batch_compute_stats",
                        lambda *a, **k: calls.append(1) or (_ for _ in ()).throw(
                            AssertionError("recomputed")))
    for stage in ("image_entropy", "noise"):
        monkeypatch.setattr(getattr(second, stage), "batch_compute_stats" if stage ==
                            "image_entropy" else "batch_compute",
                            lambda *a, **k: (_ for _ in ()).throw(AssertionError(stage)))
    out = second.compute_signals(second_docs, checkpoint_dir=tmp_path)
    assert rel_dev(_doc_columns(out), _doc_columns(first_docs)) == 0.0

    changed = list(spec)
    changed[0] = (spec[0][0], spec[0][1] + " edited", spec[0][2])
    docs = _port_docs(changed) if writer == "reference" else _ref_docs(changed)
    with pytest.raises(AssertionError, match="recomputed"):
        second.compute_signals(docs, checkpoint_dir=tmp_path)
    assert calls


def test_process_stream_corpus_equals_monolithic(f32, tmp_path):
    """Shards of 7 (with a resume from the shard checkpoints) give the same
    columns and scores as one pass; the pixel proxy stands in for the MAE,
    whose per-batch masks depend on where a batch starts."""
    cfg = _config_dict(f32["ckpt"], image={"model": "pixel"})
    port = DewiPipeline(DewiConfig.from_dict(cfg), device="cpu")
    spec = f32["spec"]
    mono = port.process_corpus(Corpus.from_documents(_port_docs(spec)))
    for _ in range(2):  # the second pass resumes every shard
        shard = port.process_stream_corpus(Corpus.from_documents(_port_docs(spec)),
                                           shard_size=7, checkpoint_dir=tmp_path)
        assert rel_dev(shard.signals, mono.signals) <= 1e-6
        assert rel_dev(shard.embeddings, mono.embeddings) <= 1e-6
        assert np.abs(shard.dewi - mono.dewi).max() <= 1e-6
    assert len(list(tmp_path.glob("shard_*.npz"))) == 6
    docs = port.process_stream(_port_docs(spec), shard_size=7)
    assert rel_dev(_doc_columns(docs), mono.signals) <= 1e-6


def test_document_api_records_the_stage_spans(f32, tmp_path):
    """``compute_signals`` with stage checkpoints runs the columnar stages,
    so a recording profiler session names them as spans."""
    from dewi_tpu_torch.utils.profiling import reset_trace_stats, trace_stats

    reset_trace_stats()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        f32["port"].compute_signals(_port_docs(f32["spec"][:12]), checkpoint_dir=tmp_path)
    spans = set(trace_stats()["spans"])
    reset_trace_stats()
    assert {"dewi.text_entropy", "dewi.embeddings", "dewi.redundancy", "dewi.noise"} <= spans
    assert (tmp_path / "noise.npz").exists()


def test_process_stream_resumes_from_its_shard_checkpoints(f32, tmp_path, monkeypatch):
    """``process_stream`` keeps each shard's stages under ``shard_NNNNN/``
    and the global redundancy beside them; a second call loads every stage."""
    port, spec = f32["port"], f32["spec"][:12]
    first = port.process_stream(_port_docs(spec), shard_size=5, checkpoint_dir=tmp_path)
    assert {p.name for p in tmp_path.iterdir()} == {
        "redundancy.npz", "shard_00000", "shard_00001", "shard_00002"}
    assert {p.name for p in (tmp_path / "shard_00000").iterdir()} == {
        "text.npz", "image.npz", "cross_modal.npz", "noise.npz"}

    def recomputed(*a, **k):
        raise AssertionError("recomputed")

    monkeypatch.setattr(port.text_entropy, "batch_compute_stats", recomputed)
    monkeypatch.setattr(port.image_entropy, "batch_compute_stats", recomputed)
    monkeypatch.setattr(port.noise, "batch_compute", recomputed)
    monkeypatch.setattr(port.redundancy, "score", recomputed)
    second = port.process_stream(_port_docs(spec), shard_size=5, checkpoint_dir=tmp_path)
    assert np.array_equal(_doc_columns(second), _doc_columns(first))
    assert [d.dewi_score for d in second] == [d.dewi_score for d in first]


@pytest.mark.parametrize("redundancy", [
    {"text_sim": "minhash"},
    {"text_sim": "simhash", "image_sim": "phash"},
    {"image_sim": "phash", "cross_modal_density": False},
    {"cross_modal_density": False},
], ids=["minhash", "simhash+phash", "phash", "embedding-only"])
def test_redundancy_modes_match_reference(f32, redundancy, monkeypatch):
    import dewi_tpu.native
    import dewi_tpu_torch.native

    for native in (dewi_tpu.native, dewi_tpu_torch.native):  # numpy minhash in both
        monkeypatch.setattr(native, "minhash_signatures_native", lambda *a, **k: None)
    port, ref = _pipelines(f32, redundancy=redundancy)
    spec = f32["spec"]
    pc = port.process_corpus(Corpus.from_documents(_port_docs(spec)))
    rc = ref.process_corpus(j_corpus.Corpus.from_documents(_ref_docs(spec)))
    col = COL["redundancy"]
    assert rel_dev(pc.signals[:, col], rc.signals[:, col]) <= F32_RTOL
    pdocs = port.compute_signals(_port_docs(spec))
    assert rel_dev(_doc_columns(pdocs)[:, col], pc.signals[:, col]) <= 1e-6


def test_multi_device_arguments_raise(f32):
    """``mesh=`` takes a Mesh and nothing else; the config knob builds one
    over the process group's ranks (without a group: a world of one)."""
    with pytest.raises(TypeError, match="mesh"):
        DewiPipeline(DewiConfig.from_dict(f32["cfg"]), mesh=object(), device="cpu")
    cfg = _config_dict(f32["ckpt"], mesh={"data_parallel_signals": True})
    pipe = DewiPipeline(DewiConfig.from_dict(cfg), device="cpu")
    assert pipe.mesh is not None and pipe.mesh.shape == {"data": 1, "model": 1}
    assert DewiPipeline(DewiConfig.from_dict(f32["cfg"]), device="cpu").mesh is None


def test_pipeline_defaults_to_the_card(f32):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        DewiPipeline(DewiConfig.from_dict(f32["cfg"]))


def test_bf16_sidecar_within_tolerance(tmp_path):
    """The default compute dtype (bfloat16) in both packages."""
    ckpt = _checkpoints(tmp_path, "bfloat16")
    cfg = _config_dict(ckpt)
    spec = _docs(seed=2, n=16)
    pc = DewiPipeline(DewiConfig.from_dict(cfg), device="cpu").process_corpus(
        Corpus.from_documents(_port_docs(spec)))
    rc = j_pipe.DewiPipeline(JConfig.from_dict(cfg)).process_corpus(
        j_corpus.Corpus.from_documents(_ref_docs(spec)))
    for name in ("ht_mean", "ht_q90", "I_hat", "redundancy", "noise"):
        assert rel_dev(pc.signals[:, COL[name]], rc.signals[:, COL[name]]) <= BF16_RTOL, name
    assert rel_dev(pc.embeddings, rc.embeddings) <= BF16_RTOL


def test_config_sidecar_round_trip(f32):
    assert json.loads(json.dumps(DewiConfig.from_dict(f32["cfg"]).to_dict())) == \
        JConfig.from_dict(f32["cfg"]).to_dict()
    assert dataclasses.asdict(DewiConfig.from_dict(f32["cfg"])) == \
        dataclasses.asdict(JConfig.from_dict(f32["cfg"]))
