"""The port's measurement layer against the reference's.

* ``Timer``, ``summarize`` and ``write_metrics`` of
  ``dewi_tpu_torch.utils.profiling`` against ``dewi_tpu.utils.profiling``
  on the same recorded spans: equal summaries, percentiles, means, metrics
  and bytes written.
* ``scripts/torch_profile_index.py``'s ``generate_synthetic_data`` equal to
  ``scripts/profile_index.py``'s bit for bit, and the profiler's metrics
  with the reference's keys and a ``recall_vs_exact`` within 0.02 of the
  reference's on the same arguments.
* The two IVF profilers on the reference's own corpus: each script's
  ``draw_corpus`` takes the reference's JAX draws (checked equal to the
  corpus and queries the reference's run attaches), ``measure`` starts
  k-means from the reference's first centroids, and every recall (each
  family, nprobe 8 and 64, spill 0 and 0.5, the DEWI-tier row; the 1M
  profile's sweep and bf16 tier) is held within 0.02 of the reference's.
* The scan breakdown at 16,384 x 64 on the CPU: every row with its ms and
  GB/s; ``full_two_stage``'s ids and scores equal to
  ``DewiIndex(backend="int8", int8_queries=True)``'s, the port's and the
  reference's, on the same corpus.
* The serving profiler (2 clients x 1 s, 2,048 docs): the reference
  ``MicroBatcher.stage_summary``'s stage keys.
* Every profiler refuses to run without a card unless ``--device cpu`` is
  given; card tests time a sleep kernel through ``Timer.span`` and hold
  ``launched_kernels``'s profile to the host's launches.
* The probe's read-once reduction (``ops.cuda_probe``): its plain version
  equal to numpy's float64 sum rounded to float32 (both exact sums rounded
  once) and the wrapper's checks; on the card the kernel equals the plain
  version bit for bit at ragged sizes.

The port runs on the CPU, the reference under ``JAX_PLATFORMS=cpu``; the
reference's scripts are loaded from their files and run with
``DEWI_COMPILE_CACHE=0``.
"""

import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from dewi_tpu_torch import utils as tutils
from dewi_tpu_torch.utils import profiling as tprof

ROOT = Path(__file__).resolve().parent.parent
# The profilers that run on the card (the tokenize profiles are CPU only,
# and torch_run_all_perf.py runs these as subprocesses).
SCRIPTS = ("torch_profile_index", "torch_probe_hbm_bw", "torch_profile_scan_breakdown",
           "torch_profile_serving", "torch_profile_ivf_1m", "torch_profile_ivf_recall_curve",
           "torch_profiler_drift", "torch_profile_e2e", "torch_profile_signals",
           "torch_profile_signals_sharded")
# The probe's sum against numpy's float64 sum rounded to float32: the
# plain version sums exactly in float64 and rounds once, so they are equal
PROBE_SUM_TOL = 0.0


def _jprof():
    # Imported here: the card's machine, which runs the card test below,
    # has no JAX.
    from dewi_tpu.utils import profiling

    return profiling


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_prof_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reference(monkeypatch, name, argv):
    monkeypatch.setenv("DEWI_COMPILE_CACHE", "0")
    monkeypatch.setattr(sys, "argv", [name] + argv)
    assert _load(name).main() == 0


def _spans():
    rng = np.random.default_rng(0)
    return {"build": [float(v) for v in rng.gamma(2.0, 300.0, 3)],
            "query": [float(v) for v in rng.gamma(2.0, 0.8, 57)]}


def _timers(spans):
    pt, jt = tprof.Timer(), _jprof().Timer()
    for name, vals in spans.items():
        for v in vals:
            pt.record(name, v)
            jt.record(name, v)
    return pt, jt


def test_utils_exports():
    assert set(tutils.__all__) == {"Timer", "summarize", "write_metrics", "torch_trace"}
    assert tutils.Timer is tprof.Timer and tutils.torch_trace is tprof.torch_trace


def test_timer_matches_reference():
    pt, jt = _timers(_spans())
    assert pt.summary() == jt.summary()
    for name in ("build", "query"):
        assert pt.mean(name) == jt.mean(name)
        for q in (0, 50, 90, 99, 100):
            assert pt.percentile(name, q) == jt.percentile(name, q)


@pytest.mark.parametrize("result", [None, "cpu_tensor", "list_of_cpu_tensors"])
def test_span_records_one_entry(result):
    t = tprof.Timer()
    res = {None: None, "cpu_tensor": torch.ones(3),
           "list_of_cpu_tensors": [torch.ones(2), (torch.zeros(1),)]}[result]
    with t.span("s", result=res):
        time.sleep(0.002)
    assert len(t.spans["s"]) == 1 and t.spans["s"][0] >= 2.0


@pytest.mark.parametrize("case", ["build_and_query", "query_only", "extra"])
def test_summarize_matches_reference(case):
    spans = _spans()
    if case == "query_only":
        del spans["build"]
    pt, jt = _timers(spans)
    extra = {"device": "x", "queries_per_sec": 12.5} if case == "extra" else None
    got = tprof.summarize(pt, 100_000, 1000, extra=extra)
    want = _jprof().summarize(jt, 100_000, 1000, extra=extra)
    assert got == want and list(got) == list(want)


def test_write_metrics_same_bytes(tmp_path):
    pt, jt = _timers(_spans())
    m = tprof.summarize(pt, 2048, 32, extra={"backend": "exact", "recall_vs_exact": 0.9876})
    tprof.write_metrics(m, tmp_path / "port.json")
    jprof = _jprof()
    jprof.write_metrics(jprof.summarize(jt, 2048, 32, extra={
        "backend": "exact", "recall_vs_exact": 0.9876}), tmp_path / "ref.json")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()


@pytest.mark.parametrize("clustered", [False, True])
def test_synthetic_data_bit_for_bit(clustered):
    port = _load("torch_profile_index").generate_synthetic_data(3000, 48, clustered=clustered)
    ref = _load("profile_index").generate_synthetic_data(3000, 48, clustered=clustered)
    assert port[0] == ref[0]
    for a, b in zip(port[1:], ref[1:]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("backend", ["exact", "quantized"])
def test_profile_index_matches_reference(backend, tmp_path, monkeypatch):
    args = ["--n-docs", "2048", "--dim", "64", "--n-queries", "32", "--latency-samples", "8",
            "--backend", backend]
    assert _load("torch_profile_index").main(
        args + ["--device", "cpu", "--output", str(tmp_path / "port.json")]) == 0
    _run_reference(monkeypatch, "profile_index", args + ["--output", str(tmp_path / "ref.json")])
    port = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "ref.json").read_text())
    assert set(port) == set(ref)
    assert port["device"] == "cpu" and port["n_docs"] == 2048
    assert port["p50_latency_ms"] > 0 and port["queries_per_sec"] > 0
    if backend == "quantized":
        assert abs(port["recall_vs_exact"] - ref["recall_vs_exact"]) <= 0.02


def _key_tree(x):
    if isinstance(x, dict):
        return {k: _key_tree(v) for k, v in x.items()}
    return None


def _spy_on_reference(monkeypatch) -> dict:
    """Record the first corpus the reference's scripts attach and every
    query block they give the exact index."""
    from dewi_tpu.index.exact import ExactIndex as JExactIndex
    from dewi_tpu.index.store import DocStore as JDocStore

    seen: dict = {"corpus": None, "queries": []}
    attach, search = JDocStore.attach_device, JExactIndex.search_batch

    def spy_attach(self, ids, emb, pay):
        if seen["corpus"] is None:
            seen["corpus"] = (np.asarray(emb), np.asarray(pay))
        return attach(self, ids, emb, pay)

    def spy_search(self, queries, *a, **kw):
        seen["queries"].append(np.asarray(queries))
        return search(self, queries, *a, **kw)

    monkeypatch.setattr(JDocStore, "attach_device", spy_attach)
    monkeypatch.setattr(JExactIndex, "search_batch", spy_search)
    return seen


def _jax_tensor(x, dtype=None):
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


class _CurveDraws:
    """The recall-curve reference's draws: ``jax.random.split(PRNGKey(7), 8)``."""

    def __init__(self):
        import jax

        self.jax = jax
        self.keys = jax.random.split(jax.random.PRNGKey(7), 8)

    def normal(self, stream, shape):
        return _jax_tensor(self.jax.random.normal(self.keys[stream], shape))

    def randint(self, stream, shape, high):
        return _jax_tensor(self.jax.random.randint(self.keys[stream], shape, 0, high), torch.long)


class _OneMDraws(_CurveDraws):
    """The 1M reference's draws: ``kc1, kc2, kc3, kq1, kq2`` of
    ``jax.random.split(PRNGKey(7), 5)``, payloads from ``PRNGKey(1)``."""

    def __init__(self):
        super().__init__()
        self.keys = self.jax.random.split(self.jax.random.PRNGKey(7), 5)

    def categorical(self, stream, probs, n):
        import jax.numpy as jnp

        w = 1.0 / (jnp.arange(len(probs)) + 1.0)
        return _jax_tensor(self.jax.random.categorical(
            self.keys[stream], jnp.log(w / w.sum()), shape=(n,)), torch.long)

    def payloads(self, n):
        return _jax_tensor(self.jax.random.gamma(self.jax.random.PRNGKey(1), 2.0, (n, 8)))


def _reference_init(n, nlist):
    """The reference k-means's first centroids: ``permutation(PRNGKey(0))``
    of the training rows (the whole corpus below ``train_sample``)."""
    import jax

    return _jax_tensor(jax.random.permutation(jax.random.PRNGKey(0), n)[:min(nlist, n)],
                       torch.long)


def _same_corpus(seen, emb, pay, queries):
    np.testing.assert_allclose(emb.numpy(), seen["corpus"][0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(pay.numpy(), seen["corpus"][1])
    for got, want in zip(queries, seen["queries"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_profile_ivf_1m_matches_reference(tmp_path, monkeypatch):
    """The profile's DEWI column is gamma(2)-valued and its tier keeps the
    1,024 highest-DEWI docs, so the true top 10 lie in the tier and recall
    is 1.0 at any nprobe (the recall curve below is the test that bites);
    held here: the same corpus, keys and recalls as the reference."""
    args = ["--n-docs", "4096", "--dim", "64", "--modes", "64", "--nlist", "32", "--nprobe", "2",
            "--n-queries", "32"]
    seen = _spy_on_reference(monkeypatch)
    _run_reference(monkeypatch, "profile_ivf_1m", args + ["--output", str(tmp_path / "ref.json")])
    ref = json.loads((tmp_path / "ref.json").read_text())
    mod = _load("torch_profile_ivf_1m")
    pargs = mod.parse_args(args + ["--device", "cpu"])
    cpu = torch.device("cpu")
    emb, pay, queries = mod.draw_corpus(4096, 64, 64, 32, cpu, draws=_OneMDraws())
    _same_corpus(seen, emb, pay, [queries])
    port = mod.measure(pargs, emb, pay, queries, cpu, build_kw={"init_idx": _reference_init(4096, 32)})
    assert _key_tree(port) == _key_tree(ref)
    recalls = [k for k in ref if k.startswith("recall_at_k")]
    assert len(recalls) == 5  # nprobe 8, 16, 2 (the dial), 64 and the bf16 tier
    for k in recalls:
        assert abs(port[k] - ref[k]) <= 0.02, k
    assert port["probe_impl_auto_resolved"] == "scan"
    own = mod.draw_corpus(512, 16, 8, 4, cpu)  # the script's own draws
    assert [tuple(t.shape) for t in own] == [(512, 16), (512, 8), (4, 16)]


def test_profile_ivf_recall_curve_matches_reference(tmp_path, monkeypatch):
    """The reference's corpus (its JAX draws through the port's
    ``draw_corpus``) and its first k-means centroids, so the two runs see
    the same data: every recall of every family, nprobe and spill within
    0.02 of the reference's."""
    n, nlist = 8192, 64
    args = ["--n-docs", str(n), "--dim", "64", "--modes", "256", "--nlist", str(nlist),
            "--n-queries", "32", "--nprobes", "8,64"]
    seen = _spy_on_reference(monkeypatch)
    _run_reference(monkeypatch, "profile_ivf_recall_curve",
                   args + ["--output", str(tmp_path / "ref.json")])
    ref = json.loads((tmp_path / "ref.json").read_text())
    mod = _load("torch_profile_ivf_recall_curve")
    pargs = mod.parse_args(args + ["--device", "cpu"])
    cpu = torch.device("cpu")
    emb, pay, families = mod.draw_corpus(n, 64, 256, 32, cpu, draws=_CurveDraws())
    _same_corpus(seen, emb, pay, list(families.values()))
    port = mod.measure(pargs, emb, pay, families, cpu,
                       build_kw={"init_idx": _reference_init(n, nlist)})
    assert _key_tree(port) == _key_tree(ref)
    curves = [(port["recall_curves"], ref["recall_curves"]),
              (port["spill"]["spill0.5"]["recall_curves"],
               ref["spill"]["spill0.5"]["recall_curves"]),
              ({"boundary": port["recall_boundary_dewi_tier1024"]},
               {"boundary": ref["recall_boundary_dewi_tier1024"]})]
    partial = []
    for got, want in curves:
        for fam in want:
            assert set(got[fam]) == {"nprobe8", "nprobe64"}
            for p, r in want[fam].items():
                assert abs(got[fam][p] - r) <= 0.02, (fam, p, got[fam][p], r)
            assert got[fam]["nprobe64"] == 1.0  # every list probed: exact
            partial.append(want[fam]["nprobe8"])
    assert set(port["recall_curves"]) == {"boundary", "offcenter", "center"}
    assert min(partial) < 0.95  # nprobe 8 misses neighbours: the curve can fail
    for key in ("shipped_default_nprobe", "shipped_default_spill_frac", "shipped_gate_curve",
                "min_nprobe_recall_0.99_all_families",
                "min_nprobe_recall_0.99_all_families_spill0.5"):
        assert port[key] == ref[key], key
    own = mod.draw_corpus(512, 16, 8, 4, cpu)  # the script's own draws
    assert tuple(own[0].shape) == (512, 16) and set(own[2]) == set(families)


def test_scan_breakdown_rows_and_answer(tmp_path):
    from dewi_tpu_torch import DewiIndex

    mod = _load("torch_profile_scan_breakdown")
    n, d = 16384, 64
    out = tmp_path / "sb.json"
    assert mod.main(["--device", "cpu", "--n-docs", str(n), "--dim", str(d), "--chain", "2",
                     "--reps", "2", "--output", str(out)]) == 0
    res = json.loads(out.read_text())
    rows = res["results"]
    for name in ("scores_pallas_bf16", "scores_pallas_s8", "bmax_s8", "bmax_s8_b4096",
                 "scores_pallas_s4", "bmax_s4", "scores_xla_bf16", "scores_xla_s8",
                 "select_approx", "select_exact", "refine", "batched128_two_stage",
                 "batched128_blockmax_scoregather", "batched128_blockmax_bf16",
                 "batched128_fused_chunked", "batched128_invmem_topk", "full_two_stage",
                 "full_two_stage_blockmax", "full_two_stage_blockmax_fused",
                 "full_two_stage_exact_select", "exact_bf16_xla_topk",
                 "exact_bf16_xla_blockmax", "exact_bf16_pallas_topk",
                 "exact_bf16_pallas_blockmax", "exact_bf16_pallas_blockmax_fused",
                 "exact_bf16_batched128_topk", "exact_bf16_batched128_blockmax"):
        assert rows[name]["p50_ms"] > 0 and rows[name]["gbps"] > 0, name
        assert rows[name]["l2_resident"] == (rows[name]["read_bytes"] <= 50 << 20)
    assert rows["bmax_s8_b4096"]["layout"].startswith("corpus-major")
    assert rows["bmax_s8"]["route"] == "plain"  # the wrappers' plain versions on the CPU
    x = mod.make_inputs(n, d, torch.device("cpu"))
    index = DewiIndex(dim=d, backend="int8", int8_queries=True, device="cpu")
    index._backend.store.attach_device([str(i) for i in range(n)], x["emb"], x["pay"])
    index.build()
    s, ids = index.search_batch(x["q0"], k=10, eta=mod.ETA, entropy_pref=mod.EP)
    from dewi_tpu import DewiIndex as JDewiIndex

    ref = JDewiIndex(dim=d, backend="int8", int8_queries=True)
    ref.add_batch([str(i) for i in range(n)], x["emb"].numpy(), x["pay"].numpy())
    ref.build()
    rs, rids = ref.search_batch(x["q0"].numpy(), k=10, eta=mod.ETA, entropy_pref=mod.EP)
    got = res["full_two_stage_top10"]
    for want_s, want_ids in ((s[0].numpy(), ids[0].tolist()),
                             (np.asarray(rs)[0], np.asarray(rids)[0].tolist())):
        np.testing.assert_allclose(got["scores"], want_s, rtol=1e-5, atol=1e-6)
        for j, (a, b) in enumerate(zip(got["ids"], want_ids)):
            if a != b:  # a swap of equal scores only
                assert abs(got["scores"][j] - float(want_s[j])) <= 1e-6


def test_serving_stage_keys_match_reference(tmp_path):
    from dewi_tpu.index import DewiIndex as JDewiIndex
    from dewi_tpu.serve import MicroBatcher as JMicroBatcher

    out = tmp_path / "sv.json"
    assert _load("torch_profile_serving").main(
        ["--device", "cpu", "--n-docs", "2048", "--dim", "64", "--clients", "2",
         "--seconds", "1", "--shed-clients", "4", "--shed-max-pending", "1",
         "--output", str(out)]) == 0
    res = json.loads(out.read_text())

    rng = np.random.default_rng(0)
    jidx = JDewiIndex(dim=16, backend="exact")
    jidx.add_batch([f"d{i}" for i in range(64)], rng.normal(size=(64, 16)).astype(np.float32),
                   rng.random((64, 8)).astype(np.float32))
    jidx.build()
    batcher = JMicroBatcher(jidx)
    try:
        for f in [batcher.submit(rng.normal(size=16)) for _ in range(3)]:
            f.result(timeout=120)
        ref_keys = set(batcher.stage_summary())
    finally:
        batcher.shutdown()

    (level,) = res["levels"]
    assert level["clients"] == 2 and level["requests"] > 0 and level["qps"] > 0
    assert set(level["stages_ms"]) == ref_keys
    assert level["stages_ms"]["n"] > 0
    assert level["server_p50_ms"] == level["stages_ms"]["total"]["p50_ms"]
    assert set(res["overload"]["stages_ms"]) == ref_keys
    assert res["overload"]["shed_429"] > 0 and 0 < res["overload"]["shed_rate"] < 1


@pytest.mark.parametrize("name", SCRIPTS)
def test_profilers_refuse_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _load(name).main(["--output", "unused.json"])


def test_launched_kernels_on_the_cpu():
    assert tprof.launched_kernels(lambda: torch.ones(3) + 1, torch.device("cpu")) == {
        "kernels": {}, "device_ms": "not measured", "ops": 0, "complete": None,
        "lead_lost": 0, "calls": 0}


@pytest.mark.cuda
def test_card_launched_kernels_complete():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    x = torch.zeros(1024, device=dev)

    def fn():
        for _ in range(100):
            x.add_(1.0)
        return x.sum()

    prof = tprof.launched_kernels(fn, dev)
    assert prof["complete"] is True and prof["ops"] >= 101
    assert sum(prof["kernels"].values()) == prof["ops"] and prof["device_ms"] > 0
    assert prof["calls"] >= 1


@pytest.mark.cuda
def test_card_span_waits_for_the_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cycles = 200_000_000
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    b.synchronize()
    sleep_ms = a.elapsed_time(b)
    t = tprof.Timer()
    out = []
    with t.span("sleep", result=out):
        torch.cuda._sleep(cycles)
        out.append(torch.ones(1, device="cuda"))
    assert t.spans["sleep"][0] >= sleep_ms > 10.0


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 4099, 1 << 16])
def test_probe_reduction_plain_matches_numpy(n):
    from dewi_tpu_torch.ops import cuda_probe

    x = np.random.default_rng(n).integers(-128, 128, n).astype(np.int8)
    got = cuda_probe.reduce_sum_f32(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.dim() == 0
    want = np.float32(x.astype(np.float64).sum())
    assert abs(float(got) - float(want)) <= PROBE_SUM_TOL * max(np.abs(x).sum(), 1)


def test_probe_reduction_checks():
    from dewi_tpu_torch.ops import cuda_probe

    with pytest.raises(ValueError, match="int8"):
        cuda_probe.reduce_sum_f32(torch.zeros(8, dtype=torch.int16))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_probe.reduce_sum_f32(torch.zeros((8, 8), dtype=torch.int8).T)


@pytest.mark.cuda
def test_card_probe_reduction_equals_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dewi_tpu_torch.ops import cuda_probe
    from dewi_tpu_torch.ops import cuda_search as cs

    gen = torch.Generator(device="cuda").manual_seed(0)
    for n in (0, 1, 15, 17, 4099, (1 << 20) + 5, 64 << 20):
        x = torch.randint(-128, 128, (n,), dtype=torch.int8, device="cuda", generator=gen)
        before = cs.launch_counts["probe_reduce_f32"]
        got = cuda_probe.reduce_sum_f32(x)
        assert cs.launch_counts["probe_reduce_f32"] == before + 1
        assert float(got) == float(cuda_probe.reduce_sum_f32_plain(x)), n
