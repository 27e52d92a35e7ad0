"""The port's twin of ``tests/test_integration.py``: every subsystem in one flow.

corpus -> signals -> scores -> quantized index -> text-query search and
eval -> sharded search -> DEWI^tau sampling -> LM training -> re-scoring,
through ``scripts/torch_integration_flow.py`` (the port's side, which
imports no JAX; ``chip_smoke.py`` phase 15 runs it on the card), held step
by step to the reference's flow on the same inputs.  The reference's
sizes: the eight sentences (``d0``/``d1`` a duplicate pair), ``tiny``
presets, ``text.max_length`` 64, ``redundancy.block_size`` 8,
``index.ann: quantized`` with ``refine_factor`` 8.  Both packages load
the same float32 LM and CLIP checkpoints, the reference's seeded initial
params saved by the reference (msgpack with a config sidecar), so they
compute the same thing.  Tolerances, as in ``tests/test_torch_pipeline.py``
and ``tests/test_torch_training.py``:

* signals ``ht_mean``, ``ht_q90``, ``I_hat``, redundancy, the embeddings
  and ``dewi_score``: max |port - ref| over max(|ref|, 1) within 1e-5
  (``F32_RTOL``); noise within 1e-6 (``NOISE_TOL``); the duplicates'
  redundancy 1 within 1e-3 on both sides (the reference's bound);
* the text query ``encode_query(docs[0].text)`` within 1e-5, its top hit
  in ``{d0, d1}`` and ``evaluate_index``'s recall@5 1.0 on both sides, and
  at the capacities where the kernels' routes engage the same top two;
* sharded exact search on four gloo ranks returns the single-device id
  set and the reference's ``ShardedExactSearcher``'s (8 CPU devices);
* ``sample_by_dewi`` with the port's uniforms injected into the
  reference's Gumbel top-k, and ``submodular_pick``: the same indices;
* ``train_lm``, 40 steps from the same initial params on the same
  batches: the losses fall on both sides, the first within 1e-5
  (``LOSS_RTOL``), the later logged ones (steps 10-40) within 1e-4
  (``LOSS_DRIFT``: they drift apart as Adam turns rounding noise into
  updates, see ``tests/test_torch_training.py``; measured 3.4e-6 at step
  10 up to 1.1e-5 at step 40); the port's checkpoint makes a corpus
  sentence less surprising than gibberish; the port's estimator on the
  reference's trained checkpoint scores ``docs[0]`` as the reference's
  estimator does, within 1e-5.

JAX is imported inside fixtures and tests only: the gloo ranks import this
module's neighbours by name and never load it.  Cost, alone under
``-n 6 --dist loadfile``: about 45 s (the reference's flow and its 40 jitted
training steps, one launch of four ranks).
"""

import sys

import numpy as np
import pytest
import torch

from torch_reference import ROOT, jitted_reference_inits, one_torch_thread  # noqa: F401

sys.path.insert(0, str(ROOT / "scripts"))
import torch_integration_flow as flow  # noqa: E402
from torch_profile_e2e import col_dev as rel_dev  # noqa: E402

F32_RTOL = 1e-5
NOISE_TOL = 1e-6
DUP_TOL = 1e-3
LOSS_RTOL = 1e-5
LOSS_DRIFT = 1e-4        # relative, the logged losses after the first
CPU = torch.device("cpu")
COLUMNS = ("ht_mean", "ht_q90", "I_hat", "redundancy")


def _col(docs, name):
    return np.array([float(getattr(d, name) or 0.0) for d in docs])


@pytest.fixture(scope="module")
def flows(tmp_path_factory):
    from dewi_tpu import DewiConfig as JConfig
    from dewi_tpu import DewiPipeline as JPipeline
    from dewi_tpu import create_document as j_create
    from dewi_tpu.models import registry as jreg
    from dewi_tpu.models.import_hf import write_sidecar_config
    from dewi_tpu.signals import cross_modal as j_cross
    from dewi_tpu.signals import text_entropy as j_text

    tmp = tmp_path_factory.mktemp("integration")
    lm_cfg = jreg.lm_config("tiny", max_len=64, dtype="float32")
    clip_cfg = jreg.clip_config("tiny", dtype="float32")
    paths = {"lm": tmp / "lm.msgpack", "clip": tmp / "clip.msgpack"}
    with jitted_reference_inits():
        lm_model, lm_params = j_text.init_lm(lm_cfg, seed=0)
        _, clip_params = j_cross.init_clip(clip_cfg, seed=0)
        for kind, params, cfg in (("lm", lm_params, lm_cfg), ("clip", clip_params, clip_cfg)):
            jreg.save_params(params, paths[kind])
            write_sidecar_config(paths[kind], kind, cfg)
        cfg = flow.config_dict(paths["lm"], paths["clip"])
        ref_pipe = JPipeline(JConfig.from_dict(cfg))
        ref_docs = [j_create(f"d{i}", text=t) for i, t in enumerate(flow.CORPUS)]
        ref_docs = ref_pipe.compute_dewi_scores(ref_pipe.compute_signals(ref_docs))
        ref_index = ref_pipe.build_index(ref_docs)
    pipe, docs, index = flow.build(cfg, CPU)
    return dict(tmp=tmp, paths=paths, lm=(lm_model, lm_params, lm_cfg), cfg=cfg,
                ref=(ref_pipe, ref_docs, ref_index), port=(pipe, docs, index))


def test_signals_and_scores_complete(flows):
    _, docs, _ = flows["port"]
    _, ref_docs, _ = flows["ref"]
    for ds in (docs, ref_docs):
        for d in ds:
            assert d.ht_mean is not None and d.redundancy is not None
            assert 0.0 <= d.dewi_score <= 1.0
        assert abs(ds[0].redundancy - 1.0) <= DUP_TOL and abs(ds[1].redundancy - 1.0) <= DUP_TOL
    for name in COLUMNS:
        assert rel_dev(_col(docs, name), _col(ref_docs, name)) <= F32_RTOL, name
    assert np.abs(_col(docs, "noise") - _col(ref_docs, "noise")).max() <= NOISE_TOL
    assert rel_dev(np.stack([d.embedding for d in docs]),
                   np.stack([d.embedding for d in ref_docs])) <= F32_RTOL
    assert rel_dev([d.dewi_score for d in docs], [d.dewi_score for d in ref_docs]) <= F32_RTOL


def test_quantized_backend_from_config(flows):
    from dewi_tpu.index import QuantizedIndex as JQuantizedIndex
    from dewi_tpu_torch.index import QuantizedIndex

    assert isinstance(flows["port"][2]._backend, QuantizedIndex)
    assert isinstance(flows["ref"][2]._backend, JQuantizedIndex)


def test_text_query_search_and_eval(flows):
    from dewi_tpu.eval import evaluate_index as j_evaluate

    pipe, docs, index = flows["port"]
    ref_pipe, ref_docs, ref_index = flows["ref"]
    q, rq = pipe.encode_query(docs[0].text), ref_pipe.encode_query(ref_docs[0].text)
    assert np.abs(q - rq).max() <= F32_RTOL
    assert ref_index.search(rq, k=2, eta=0.0)[0][0] in ("d0", "d1")
    assert j_evaluate(ref_index, np.stack([rq]), {"q0": ["d0", "d1"]})["recall@5"] == \
        pytest.approx(1.0)
    leg = flow.query_leg(q, index, CPU)
    assert leg["top2"][0] in ("d0", "d1") and leg["recall_at_5"] == pytest.approx(1.0)
    for cap in flow.KERNEL_CAPACITIES:
        other = flow.query_leg(q, pipe.build_index(docs, capacity=cap), CPU)
        assert other["capacity"] == cap and other["top2"] == leg["top2"]
        assert max(abs(a - b) for a, b in zip(other["top2_scores"], leg["top2_scores"])) \
            <= flow.ROUTE_SCORE_TOL


def test_sharded_search_matches_single_chip(flows):
    from dewi_tpu.index.store import DocStore as JDocStore
    from dewi_tpu.parallel import ShardedExactSearcher as JSharded
    from dewi_tpu.parallel import make_mesh as j_make_mesh
    from dewi_tpu_torch.parallel import launch_local

    pipe, docs, _ = flows["port"]
    ref_pipe, ref_docs, _ = flows["ref"]
    emb, pay, ids = flow.doc_arrays(docs)
    q = pipe.encode_query(flow.SHARDED_QUERY)
    got = launch_local(flow.sharded_ids, 4, (emb, pay, ids, q, "cpu"), threads=1)
    single = flow.single_device_ids(docs, q, CPU)
    remb, rpay, rids = flow.doc_arrays(ref_docs)
    store = JDocStore(dim=remb.shape[1])
    store.add_batch(rids, remb, rpay)
    rq = ref_pipe.encode_query(flow.SHARDED_QUERY)
    _, want = JSharded(store, j_make_mesh(n_data=8, n_model=1), k=3).search_batch(
        rq[None], eta=flow.ETA, entropy_pref=flow.EP)
    assert set(got.tolist()) == set(single.tolist()) == set(np.asarray(want)[0].tolist())


def test_sampling_over_scores(flows, monkeypatch):
    from dewi_tpu import sampling as j_sampling
    from dewi_tpu_torch import sampling as t_sampling

    _, docs, _ = flows["port"]
    res = flow.sampling_leg(docs, CPU)
    assert len(set(res["picks"])) == 4 and len(set(res["cover"])) == 3
    dewi = np.array([d.dewi_score for d in docs])
    emb = np.stack([d.embedding for d in docs])
    u = t_sampling.uniform_noise(len(docs), 0, CPU).numpy()
    monkeypatch.setattr(j_sampling.jax.random, "uniform",
                        lambda key, shape, minval, maxval: j_sampling.jnp.asarray(u))
    # Unjitted, so the injected uniforms take effect even where an earlier
    # test in this process compiled the sampler at this shape.
    monkeypatch.setattr(j_sampling, "_gumbel_topk", j_sampling._gumbel_topk.__wrapped__)
    assert res["picks"] == np.asarray(j_sampling.sample_by_dewi(dewi, k=4, tau=2.0,
                                                                seed=0)).tolist()
    assert res["cover"] == np.asarray(j_sampling.submodular_pick(emb, k=3)).tolist()


def test_training_then_rescore(flows):
    from dewi_tpu.models.import_hf import write_sidecar_config
    from dewi_tpu.signals import TextEntropyEstimator as JEstimator
    from dewi_tpu.training import train_lm as j_train_lm
    from dewi_tpu_torch.signals import TextEntropyEstimator

    _, docs, _ = flows["port"]
    texts = [d.text for d in docs]
    tmp = flows["tmp"]
    port = flow.train_leg(texts, CPU, tmp / "port_lm.msgpack",
                          init_checkpoint=flows["paths"]["lm"], dtype="float32")
    model, params, cfg = flows["lm"]
    ref_ckpt = tmp / "ref_lm.msgpack"
    with jitted_reference_inits():
        ref = j_train_lm(model, params, texts * 4, checkpoint=str(ref_ckpt), **flow.TRAIN)
        write_sidecar_config(ref_ckpt, "lm", cfg)
        ref_score = JEstimator(model_name="tiny", max_length=64, batch_size=4,
                               checkpoint=str(ref_ckpt)).compute_entropy(texts[0]).mean_entropy
    losses, ref_losses = port["losses"], [float(v) for v in ref.losses]
    assert len(losses) == len(ref_losses) == 5
    assert losses[-1] < losses[0] and ref_losses[-1] < ref_losses[0]
    np.testing.assert_allclose(losses[0], ref_losses[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(losses[1:], ref_losses[1:], rtol=LOSS_DRIFT)
    assert port["seen"] < port["novel"]
    got = TextEntropyEstimator(model_name="tiny", max_length=64, batch_size=4,
                               checkpoint=str(ref_ckpt), device="cpu")
    assert abs(got.compute_entropy(texts[0]).mean_entropy - ref_score) <= F32_RTOL * max(
        abs(ref_score), 1.0)
