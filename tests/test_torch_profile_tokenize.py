"""The port's CPU-side profilers against the reference's: the two tokenize
profiles and the run-all script.

* ``scripts/torch_profile_tokenize.py``: ``synth_corpus`` equal to the
  reference's; on one locally trained BPE (``tokenizers``, 500 tokens, in a
  temporary directory) the port's ``make_hf_adapter`` gives the token ids,
  masks and packed ids the reference's adapter gives, per text and in
  batches, and the byte tokenizer's packed ids equal the reference's (a
  value check); the script's keys equal the reference script's on the same
  small arguments (the reference's fixed BPE directory redirected to a
  temporary one).
* ``scripts/torch_profile_tokenize_scaling.py``: the reference's keys and
  ``multi_core``'s meaning (4 cores or more).
* ``scripts/torch_run_all_perf.py``: its stages, in order and with their
  timeouts, are the reference's less ``bench`` (left out until the port has
  a bench, which ``--dry-run`` says), each running an existing
  ``scripts/torch_*.py`` with its artifact under ``chiprun_out/perf/``.

Both tokenize scripts are CPU only (no ``--device``; they touch no
device), so they are not among the profilers that refuse to run without a
card.  Cost, alone under ``-n 6 --dist loadfile``: about 15 s.
"""

import json
import os
import sys

import numpy as np
import pytest

from torch_reference import ROOT, key_diff, load_script, one_torch_thread  # noqa: F401

TOK_ARGS = ["--n-docs", "300", "--words", "20", "--vocab-size", "500", "--max-len", "64",
            "--train-docs", "200"]


@pytest.fixture(scope="module")
def bpe(tmp_path_factory):
    """One BPE trained by the reference's ``train_bpe``, and the corpus."""
    pytest.importorskip("tokenizers")
    ref = load_script("profile_tokenize")
    corpus = ref.synth_corpus(300, 20)
    tok, _ = ref.train_bpe(corpus[:200], 500, tmp_path_factory.mktemp("bpe"))
    return tok, corpus


def test_synth_corpus_equals_reference():
    port, ref = load_script("torch_profile_tokenize"), load_script("profile_tokenize")
    assert port.synth_corpus(50, 12, seed=3) == ref.synth_corpus(50, 12, seed=3)


def test_token_ids_equal_reference(bpe):
    from dewi_tpu.signals.tokenizer import ByteTokenizer as JByte
    from dewi_tpu.signals.tokenizer import make_hf_adapter as j_adapter
    from dewi_tpu_torch.signals.tokenizer import ByteTokenizer, make_hf_adapter

    tok, corpus = bpe
    port, ref = make_hf_adapter(tok), j_adapter(tok)
    assert (port.vocab_size, port.pad_id, port.pad_is_exclusive) == (
        ref.vocab_size, ref.pad_id, ref.pad_is_exclusive)
    for got, want in zip(port.encode_batch(corpus, 64, pad_to=64),
                         ref.encode_batch(corpus, 64, pad_to=64)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.encode_batch_u16(corpus, 64, pad_to=64),
                                  ref.encode_batch_u16(corpus, 64, pad_to=64))
    assert [port.encode(t, 64) for t in corpus[:30]] == [ref.encode(t, 64) for t in corpus[:30]]
    np.testing.assert_array_equal(ByteTokenizer().encode_batch_u16(corpus, 64, pad_to=64),
                                  JByte().encode_batch_u16(corpus, 64, pad_to=64))


def test_tokenize_keys_match_reference(tmp_path, monkeypatch):
    pytest.importorskip("tokenizers")
    out = tmp_path / "port.json"
    assert load_script("torch_profile_tokenize").main(TOK_ARGS + ["--output", str(out)]) == 0
    port = json.loads(out.read_text())
    ref_mod = load_script("profile_tokenize")
    train = ref_mod.train_bpe
    monkeypatch.setattr(ref_mod, "train_bpe",
                        lambda corpus, vocab, _dir: train(corpus, vocab, tmp_path / "ref_bpe"))
    monkeypatch.setattr(sys, "argv", ["profile_tokenize"] + TOK_ARGS
                        + ["--output", str(tmp_path / "ref.json")])
    assert ref_mod.main() == 0
    ref = json.loads((tmp_path / "ref.json").read_text())
    assert key_diff(port, ref) == ([], [])
    assert port["bpe_vocab_size"] == ref["bpe_vocab_size"]
    for k in ("byte_u16", "bpe_fast_batch", "bpe_fast_u16", "bpe_per_text"):
        assert port[f"{k}_docs_per_sec"] > 0, k


def test_tokenize_scaling_keys_match_reference(tmp_path, monkeypatch):
    pytest.importorskip("transformers")
    args = ["--n-docs", "256", "--max-len", "128"]
    assert load_script("torch_profile_tokenize_scaling").main(
        args + ["-o", str(tmp_path / "port.json")]) == 0
    monkeypatch.setattr(sys, "argv", ["x"] + args + ["-o", str(tmp_path / "ref.json")])
    assert load_script("profile_tokenize_scaling").main() == 0
    port = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "ref.json").read_text())
    assert key_diff(port, ref) == ([], [])
    assert port["cpu_count"] == os.cpu_count() and port["multi_core"] == (os.cpu_count() >= 4)
    assert port["batch_vs_per_text"] > 0


@pytest.mark.parametrize("name", ["torch_profile_tokenize", "torch_profile_tokenize_scaling"])
def test_tokenize_scripts_are_cpu_only(name):
    mod = load_script(name)
    assert "CPU only" in " ".join(mod.__doc__.split())
    with pytest.raises(SystemExit):
        mod.parse_args(["--device", "cpu"])


def test_run_all_perf_stages(capsys):
    port, ref = load_script("torch_run_all_perf"), load_script("run_all_perf")
    want = [(name, timeout) for name, timeout, _ in ref.STAGES if name != "bench"]
    assert [(name, timeout) for name, timeout, _ in port.STAGES] == want
    for name, _, cmd in port.STAGES:
        script = cmd[1]
        assert script.startswith("scripts/torch_") and (ROOT / script).is_file(), name
        out = cmd[cmd.index("--output" if "--output" in cmd else "-o") + 1]
        assert out.startswith("chiprun_out/perf/"), name
    assert set(port.LEFT_OUT) == {"bench"}
    assert port.main(["--dry-run"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0][3:] for ln in lines if ln.startswith("== ")][:-1] == [
        n for n, _ in want] + ["bench"]
    assert "left out" in [ln for ln in lines if ln.startswith("== bench")][0]
    assert port.main(["--dry-run", "--only", "serving"]) == 0
    assert "== serving: " in capsys.readouterr().out
