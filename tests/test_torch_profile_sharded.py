"""``scripts/torch_profile_signals_sharded.py`` against the reference's
``scripts/profile_signals_sharded.py``.

The port runs on the CPU as a world of one (gloo, in this process) and as
two gloo ranks (``launch_local``); the reference as a mesh of one of the
conftest's CPU devices, its twin, with its model inits jitted (on a mesh
of more than one device the reference's ``process_corpus`` over a dense
image array fails in ``dewi_tpu/io/images.py:151``, a fault of the
reference); the same tiny inputs (``tiny`` presets, batch 16, 32-px
images).  The reference skips its ``process_corpus`` smoke
(``--pipeline-docs 0``: on the CPU it compiles every stage twice, about
30 s), so the port's ``pipeline_e2e_sharded`` row (16 docs, two ranks) is
held to that row's keys as the reference writes them
(``scripts/profile_signals_sharded.py:196-216``).  Held:

* the same metric keys apart from the deliberate differences: the reference's ``--target-chips``
  projection (``target_chips``, ``projection_formula``,
  ``*_1M_s_<N>chip``, ``full_signals_1M_*_<N>chip_projected``), its
  5-minute budget (``budget_min``, ``within_budget``) and its residuals
  read from a TPU artifact are dropped; the port has per-card figures
  (``*_1M_s_per_card``, ``full_signals_1M_{s,min}_per_card``) and
  ``backend``, ``card``, ``ranks_share_one_card``, ``scaling``,
  ``superbatch``; no projection to N cards is written;
* every per-device rate is the sharded rate over the mesh's devices, every
  per-card figure 1M over the per-device rate, and the full figure their
  sum.

Cost, alone under ``-n 6 --dist loadfile``: about 45 s (the reference's jit
compiles and one launch of two ranks).
"""

import importlib
import json

import pytest

from torch_reference import (ROOT, jitted_reference_inits, key_diff,  # noqa: F401
                             one_torch_thread, run_reference)

ARGS = ["--model", "tiny", "--n-docs", "64", "--batch-size", "16", "--image-size", "32"]
REF_PIPELINE_KEYS = {"n_docs", "cold_s", "warm_s", "warm_docs_per_sec", "warm_signals_s",
                     "warm_scoring_s", "meshless_warm_docs_per_sec", "mesh_vs_meshless",
                     "note"}
REF_ONLY = {"target_chips", "projection_formula", "text_1M_s_16chip", "image_1M_s_16chip",
            "clip_1M_s_16chip", "full_signals_1M_s_16chip_projected",
            "full_signals_1M_min_16chip_projected", "budget_min", "within_budget"}
REF_RESIDUALS = {"redundancy_1M_s_single_chip_unsharded", "noise_1M_s_4hosts"}
PORT_ONLY = {"text_1M_s_per_card", "image_1M_s_per_card", "clip_1M_s_per_card",
             "full_signals_1M_s_per_card", "full_signals_1M_min_per_card", "backend", "card",
             "ranks_share_one_card", "scaling", "superbatch"}
STAGES = (("text", "docs"), ("image", "docs"), ("clip", "pairs"))


def _port(tmp_path, monkeypatch, extra):
    """The port's script, imported by name (the spawned ranks import its
    rank function's module by name)."""
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))
    out = tmp_path / "port.json"
    assert importlib.import_module("torch_profile_signals_sharded").main(
        ARGS + extra + ["--device", "cpu", "--output", str(out)]) == 0
    return json.loads(out.read_text())


def _per_card(res):
    for stage, unit in STAGES:
        sharded = res[f"{stage}_{unit}_per_sec_sharded"]
        per_dev = res[f"{stage}_{unit}_per_sec_per_device"]
        assert sharded > 0 and abs(per_dev - sharded / res["mesh_devices"]) <= 0.1
        # each rate is rounded to 0.1 and each figure to 0.1 s
        assert 1e6 / (per_dev + 0.05) - 0.05 <= res[f"{stage}_1M_s_per_card"] \
            <= 1e6 / (per_dev - 0.05) + 0.05
    total = sum(res[f"{stage}_1M_s_per_card"] for stage, _ in STAGES)
    assert res["full_signals_1M_s_per_card"] == pytest.approx(total, abs=0.05)
    assert not [k for k in res if "chip" in k or "cards" in k]


def test_world_of_one_matches_reference(tmp_path, monkeypatch):
    port = _port(tmp_path, monkeypatch, ["--pipeline-docs", "0"])
    import jax

    import dewi_tpu.parallel as jparallel

    one = jparallel.make_mesh
    monkeypatch.setattr(jparallel, "make_mesh",
                        lambda *a, **kw: one(n_data=1, devices=jax.devices()[:1]))
    with jitted_reference_inits():
        run_reference(monkeypatch, "profile_signals_sharded",
                      ARGS + ["--pipeline-docs", "0", "--output", str(tmp_path / "ref.json")])
    ref = json.loads((tmp_path / "ref.json").read_text())
    only_ref, only_port = key_diff(port, ref)
    assert set(only_ref) - REF_RESIDUALS == REF_ONLY
    assert set(only_port) == PORT_ONLY
    assert "pipeline_e2e_sharded" not in port and "pipeline_e2e_sharded" not in ref
    assert port["mesh_devices"] == 1 and port["backend"] == "gloo"
    assert port["ranks_share_one_card"] is False and "not measured" in port["scaling"]
    _per_card(port)


def test_two_gloo_ranks(tmp_path, monkeypatch):
    port = _port(tmp_path, monkeypatch, ["--ranks", "2", "--pipeline-docs", "16"])
    assert port["mesh_devices"] == 2 and port["backend"] == "gloo"
    _per_card(port)
    row = port["pipeline_e2e_sharded"]
    assert set(row) == REF_PIPELINE_KEYS and row["n_docs"] == 16
    assert row["warm_docs_per_sec"] > 0 and row["mesh_vs_meshless"] > 0
    assert port["pipeline_e2e_docs_per_sec_sharded"] == row["warm_docs_per_sec"]
