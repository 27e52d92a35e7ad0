"""The Moonlight cell on the CPU at a tiny size (``moonlight-tiny``, whose
float32 forward meets the float32 reference on the same bfloat16-rounded
weights), its faults, and on the card one forward of each bucket length
the traffic uses against the reference at the published widths."""

import copy
import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import run as bench_run
from conftest import BENCH, tiny_corpus
from harness.spec import load_cell

CELL = "corpus-web-text-moonlight"


def tiny_moonlight():
    from dewi_tpu_torch.models.moonlight import moonlight_config

    base = tiny_corpus("corpus-web-text")
    cell = load_cell(CELL)
    cfg = copy.deepcopy(cell.config)
    tiny = dataclasses.asdict(moonlight_config("moonlight-tiny"))
    cfg.update({k: v for k, v in tiny.items() if k in cfg})
    cfg["dewi_config"]["text"].update(model="moonlight-tiny", batch_size=4, max_length=64)
    cfg["dewi_config"]["cross_modal"] = base.config["dewi_config"]["cross_modal"]
    cfg["dewi_config"]["runtime"]["shard_size"] = 24
    cfg["clip"] = base.config["clip"]
    cell.config = cfg
    t = copy.deepcopy(cell.traffic)
    t["text"] = base.traffic["text"]
    t.update(check_docs=100_000, control_shards=2)  # every document of the window
    cell.traffic = t
    return cell


def run_cell(cell, seed=2 ** 31 + 7):
    r = bench_run.execute(cell, seed, 1.0, False, torch.device("cpu"), 0.0)
    return r.correct(), {n: (v, lim) for n, v, lim in r.checks}


def test_tiny_cell_is_correct():
    ok, got = run_cell(tiny_moonlight())
    assert ok, got
    assert got["ht_mean_gap"][0] < 1e-4, got


def test_tiny_control_fails():
    cell = tiny_moonlight()
    r = cell.driver.control(cell, 2 ** 31 + 9, torch.device("cpu"))
    assert not r.correct(), r.checks


def _patch_text(monkeypatch, fault):
    from dewi_tpu_torch.signals.text_entropy import TextEntropyEstimator

    real = TextEntropyEstimator.batch_compute_stats

    def broken(self, texts, *a, **kw):
        means, q90s, q99s = real(self, texts, *a, **kw)
        if fault == "swap":  # the two most different documents' rows swapped
            i, j = int(np.argmin(means)), int(np.argmax(means))
            means[[i, j]], q90s[[i, j]] = means[[j, i]], q90s[[j, i]]
        elif fault == "shift":  # each surprisal mean off by 0.1 nats
            means += 0.1
        return means, q90s, q99s

    monkeypatch.setattr(TextEntropyEstimator, "batch_compute_stats", broken)


@pytest.mark.parametrize("fault", ["swap", "shift"])
def test_tiny_text_faults_fail(monkeypatch, fault):
    _patch_text(monkeypatch, fault)
    ok, got = run_cell(tiny_moonlight())
    assert not ok and got["ht_rms_gap"][0] > got["ht_rms_gap"][1], got


def test_loading_the_new_cells_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; import run; from harness import spec;"
            "[spec.load_cell(w) for w in %r];"
            "import dewi_tpu_torch.pipelines, dewi_tpu_torch.models.moonlight;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))"
            % (str(BENCH), str(BENCH.parent), [CELL], {"jax", "jaxlib", "flax", "dewi_tpu"}))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.cuda
def test_card_bucket_forwards_match_reference():
    """One ``[16, L]`` forward of the program at each bucket length the
    traffic uses (128 ... 8,192), at the published widths with the cell's
    weights, against the float32 reference over two of its rows, per
    token: the median, mean and largest gap of each row, and the gap of the
    row's mean NLL, printed.  In bfloat16 a token near a routing tie may
    take another expert in one of the 26 MoE layers, which moves that token
    alone; the row's mean NLL (what the cell compares) holds within the
    cell's ``ht_mean_gap`` limit, and the median token within 0.3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dewi_tpu_torch.models.moonlight import init_moonlight, moonlight_config
    from harness import moonlight as hm
    from reference import models as refm
    from reference import moonlight as refl

    device = torch.device("cuda", 0)
    cfg = load_cell(CELL).config
    seed = 2 ** 31 + 11
    model = init_moonlight(moonlight_config("moonlight-16b-a3b"), device=device)
    hm.load_into(model, cfg, seed, device)
    rng = np.random.default_rng(5)
    rows = {}
    for length in (128, 256, 512, 1024, 2048, 4096, 8192):
        lens = [length] + [int(rng.integers(length // 2 + 1, length + 1)) for _ in range(15)]
        ids = torch.full((16, length), 257, dtype=torch.long)
        mask = torch.zeros(16, length)
        for r, n in enumerate(lens):
            ids[r, :n] = torch.as_tensor(rng.integers(0, 256, n))
            ids[r, 0] = 256
            mask[r, :n] = 1
        nll, _ = model.token_nll(ids.to(device), mask.to(device))
        rows[length] = [(ids[r, :lens[r]].tolist(), nll[r, :lens[r] - 1].double().cpu().numpy())
                        for r in (0, 15)]
    del model
    torch.cuda.empty_cache()
    old = refm.no_tf32()
    try:
        seqs = [s for v in rows.values() for s, _ in v]
        want = refl.token_nll(seqs, hm.layer_weights(cfg, seed, device), cfg, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    limit = load_cell(CELL).limits["ht_mean_gap"]
    got = [g for v in rows.values() for _, g in v]
    lengths = [length for length, v in rows.items() for _ in v]
    stats = []
    for length, g, r in zip(lengths, got, want):
        gap = np.abs(g - r)
        stats.append((float(np.median(gap)), abs(float(g.mean() - r.mean()))))
        print("bucket", length, "tokens", len(g) + 1, "median", stats[-1][0],
              "mean", float(gap.mean()), "max", float(gap.max()), "mean_nll_gap", stats[-1][1])
    assert all(med <= 0.3 and mean <= limit for med, mean in stats), stats
