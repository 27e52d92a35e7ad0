"""The port's command line (``python -m dewi_tpu_torch``) against the JAX
package's click CLI.

* Every command's arguments and options carry the click command's names,
  defaults, choices and types (``dewi_tpu.cli.cli.commands[...].params``).
* The ``DEWI_TEST_MODE`` fake mode writes the same artifacts, and ``config``
  the same text; the YAML emitter equals ``yaml.dump`` on the four presets.
* A real ``process`` at the ``tiny`` presets (float32 sidecars), from the
  same files and the same checkpoints saved by the reference, gives
  ``signals_summary.json`` rows within 1e-5 of the reference CLI's, matched
  by ``metadata.source`` (ids are uuid4).  With images, the MAE columns and
  the DEWI score are left out of that comparison: the port draws MAE masks
  from PyTorch's random stream (``ROADMAP.md`` §3, deliberate).
* ``search`` on the port's index returns the reference CLI's documents
  wherever the scores differ by more than 1e-4; the port searches,
  evaluates and samples an output saved by the reference CLI.

Everything here runs with ``--device cpu``.
"""

import json
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import yaml
from click.testing import CliRunner

from dewi_tpu import cli as jcli
from dewi_tpu_torch import cli

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
COMMANDS = ("config", "process", "search", "serve", "pack-images", "import-weights",
            "sample", "eval")


@pytest.fixture(autouse=True)
def _real_mode(request, monkeypatch):
    """The tests of real runs switch the suite's fake mode off."""
    if "processed" in request.fixturenames:
        monkeypatch.setenv("DEWI_TEST_MODE", "0")


def _port(argv, capsys=None):
    rc = cli.main(["--device", "cpu", *argv])
    out = capsys.readouterr() if capsys is not None else None
    return rc, out


def _actions(name):
    parser = cli.build_parser()
    sub = next(a for a in parser._actions if a.dest == "command")
    return {a.dest: a for a in sub.choices[name]._actions if a.dest != "help"}


# ---- the command surface -----------------------------------------------------------


def test_every_command_is_there():
    assert set(jcli.cli.commands) == set(COMMANDS)
    parser = cli.build_parser()
    sub = next(a for a in parser._actions if a.dest == "command")
    assert set(sub.choices) == set(COMMANDS)


@pytest.mark.parametrize("name", COMMANDS)
def test_options_and_defaults_equal_click(name):
    import click

    actions = _actions(name)
    command = jcli.cli.commands[name]
    ctx = click.Context(command)
    params = [p for p in command.params if p.name != "help"]
    assert {p.name for p in params} == set(actions)
    for p in params:
        a = actions[p.name]
        if isinstance(p, click.Argument):
            assert not a.option_strings, p.name
            continue
        assert set(a.option_strings) == set(p.opts) | set(p.secondary_opts), p.name
        want_default = p.get_default(ctx)
        if want_default is None or "UNSET" in repr(want_default):  # click 8.2+: no default
            want_default = False if p.is_flag else None
        assert a.default == want_default, p.name
        assert bool(a.required) == bool(p.required), p.name
        if p.is_flag:
            assert a.nargs == 0 and a.const is True, p.name
        if isinstance(p.type, click.Choice):
            assert list(a.choices) == list(p.type.choices), p.name
        elif isinstance(p.type, click.types.IntParamType):
            assert a.type is int, p.name
        elif isinstance(p.type, click.types.FloatParamType):
            assert a.type is float, p.name


def test_usage_errors_exit_2(tmp_path, capsys):
    assert cli.main([]) == 2
    assert cli.main(["frob"]) == 2
    assert cli.main(["process", str(tmp_path / "missing.yaml"), str(tmp_path)]) == 2
    assert cli.main(["config", "--preset", "nope"]) == 2
    assert cli.main(["search", str(tmp_path)]) == 2
    (tmp_path / "f").write_text("")
    assert cli.main(["process", str(tmp_path / "f"), str(tmp_path / "f")]) == 2
    err = capsys.readouterr().err
    assert "does not exist" in err and "invalid choice" in err
    assert cli.main(["--version"]) == 0
    assert "dewi-tpu-torch, version 0.1.0" in capsys.readouterr().out


def test_module_entry_point():
    proc = subprocess.run([sys.executable, "-m", "dewi_tpu_torch", "--help"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and all(c in proc.stdout for c in COMMANDS)


def test_create_document():
    d = cli.create_document(text="hello")
    j = jcli.create_document(text="hello")
    assert len(d.doc_id) == len(j.doc_id) == 36 and d.doc_id != j.doc_id
    assert d.text == "hello" and d.metadata == {} == j.metadata


# ---- config ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["default", "web", "product", "balanced"])
def test_config_equals_click(tmp_path, capsys, preset):
    from dewi_tpu_torch.config import apply_preset, get_default_config

    tree = apply_preset(get_default_config(), preset).to_dict()
    assert cli.yaml_dump(tree) == yaml.dump(tree, default_flow_style=False, sort_keys=False)
    runner = CliRunner()
    assert cli.main(["config", "--preset", preset]) == 0
    assert capsys.readouterr().out == runner.invoke(jcli.cli, ["config", "--preset", preset]).output
    assert cli.main(["config", "--preset", preset, "-o", str(tmp_path / "p.yaml")]) == 0
    runner.invoke(jcli.cli, ["config", "--preset", preset, "-o", str(tmp_path / "j.yaml")])
    assert (tmp_path / "p.yaml").read_bytes() == (tmp_path / "j.yaml").read_bytes()


def test_yaml_emitter_on_other_trees():
    trees = [
        {"a": {"b": [], "c": {}, "d": None, "e": "/x y/clip.msgpack", "f": "yes", "g": "1.5",
               "h": 1e-6, "i": 1e20, "j": [[1, 2], [3]], "k": [{"x": 1, "y": [1]}], "l": "",
               "m": "it's", "n": "-x", "o": "a: b", "p": float("inf"), "q": True, "r": "null",
               "s": "é\tz", "t": -3, "u": "- a", "v": "2024-01-01", "w": 0.1 + 0.2}},
        {},
        {"only": [0.5, "x", None, False]},
    ]
    for tree in trees:
        assert cli.yaml_dump(tree) == yaml.dump(tree, default_flow_style=False,
                                                sort_keys=False)


def test_config_overwrite_guard(tmp_path, capsys):
    out = tmp_path / "cfg.yaml"
    out.write_text("existing")
    assert cli.main(["config", "-o", str(out)]) == 1
    assert "already exists" in capsys.readouterr().err and out.read_text() == "existing"
    assert cli.main(["config", "-o", str(out), "--overwrite"]) == 0
    assert yaml.safe_load(out.read_text())["scoring"]["weights"]["alpha_t"] == 1.0


def test_config_file_without_pyyaml(tmp_path, monkeypatch):
    """Without PyYAML a config is read as JSON; other YAML is an error that
    names pyyaml."""
    (tmp_path / "c.json").write_text(json.dumps({"scoring": {"delta": 2.0}}))
    (tmp_path / "c.yaml").write_text("scoring:\n  delta: 2.0\n")
    (tmp_path / "empty.yaml").write_text("")
    assert cli.load_config_file(tmp_path / "c.yaml") == {"scoring": {"delta": 2.0}}
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert cli.load_config_file(tmp_path / "c.json") == {"scoring": {"delta": 2.0}}
    assert cli.load_config_file(tmp_path / "empty.yaml") == {}
    with pytest.raises(ValueError, match="pyyaml"):
        cli.load_config_file(tmp_path / "c.yaml")


# ---- the fake mode ---------------------------------------------------------------------


def _tree(out):
    return sorted(str(p.relative_to(out)) for p in out.rglob("*"))


def test_test_mode_process_artifacts_equal(tmp_path, capsys):
    runner = CliRunner()
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("{}\n")
    res = runner.invoke(jcli.cli, ["process", str(cfg), str(tmp_path / "ref")])
    assert res.exit_code == 0, res.output
    assert cli.main(["process", str(cfg), str(tmp_path / "port")]) == 0
    assert capsys.readouterr().out == res.output.replace(str(tmp_path / "ref"),
                                                         str(tmp_path / "port"))
    ref, port = tmp_path / "ref", tmp_path / "port"
    assert _tree(port) == _tree(ref)
    for name in ("documents_batch_0001.jsonl", "signals_summary.json", "index/config.json"):
        assert (port / name).read_bytes() == (ref / name).read_bytes()
    a, b = np.load(port / "embeddings.npz"), np.load(ref / "embeddings.npz")
    assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)
    ma, mb = (json.loads((d / "metadata.json").read_text()) for d in (port, ref))
    assert ma.pop("created_at") and mb.pop("created_at") and ma == mb
    # A second run backs the first up, as the reference does.
    assert cli.main(["process", str(cfg), str(port)]) == 0
    assert "Created backup of existing output" in capsys.readouterr().out
    assert len(list(tmp_path.glob("port_backup_*"))) == 1


def test_test_mode_search_equal(tmp_path, capsys):
    res = CliRunner().invoke(jcli.cli, ["search", str(tmp_path), "hello", "--k", "3",
                                        "--test-mode"])
    assert cli.main(["search", str(tmp_path), "hello", "--k", "3", "--test-mode"]) == 0
    out = capsys.readouterr().out
    assert out == res.output
    assert cli.main(["search", str(tmp_path), "q", "-o", str(tmp_path / "r.json")]) == 0
    assert len(json.loads((tmp_path / "r.json").read_text())) == 5


def test_process_without_documents(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("DEWI_TEST_MODE", "0")
    (tmp_path / "cfg.yaml").write_text("{}\n")
    (tmp_path / "empty").mkdir()
    rc, out = _port(["process", str(tmp_path / "cfg.yaml"), str(tmp_path / "o"),
                     "--texts", str(tmp_path / "empty")], capsys)
    assert rc == 1 and "No documents to process" in out.err


# ---- a real process at the tiny presets, against the reference CLI ------------------------


def _ref_checkpoints(tmp):
    """LM, MAE and CLIP checkpoints saved by the reference (float32 sidecars)."""
    import jax

    from dewi_tpu.models import registry as jreg
    from dewi_tpu.models.import_hf import write_sidecar_config

    out = {}
    for kind, cfg, init in (
            ("lm", jreg.lm_config("tiny", max_len=64, dtype="float32"), jreg.init_lm),
            ("mae", jreg.mae_config("tiny", dtype="float32"), jreg.init_mae),
            ("clip", jreg.clip_config("tiny", dtype="float32"), jreg.init_clip)):
        params = init(cfg, seed=3)
        params = params[1] if isinstance(params, tuple) else params
        params = jax.tree.map(lambda x: x + 0.01 * np.sin(np.arange(x.size).reshape(x.shape)),
                              params)
        path = tmp / f"{kind}.msgpack"
        jreg.save_params(params, path)
        write_sidecar_config(path, kind, cfg)
        out[kind] = str(path)
    return out


def _corpus(tmp, with_images):
    rng = np.random.default_rng(0)
    words = ["cat", "photo", "river", "entropy", "zebra", "quartz", "über", "日本", "the"]
    texts = tmp / "texts"
    texts.mkdir()
    for i in range(14):
        (texts / f"t{i:02d}.txt").write_text(" ".join(rng.choice(words, int(rng.integers(1, 25)))))
    (texts / "t14.txt").write_text((texts / "t03.txt").read_text())  # a duplicate
    (texts / "notes.md").write_text("# a markdown file counts as text")
    if not with_images:
        return texts, None
    images = tmp / "images"
    images.mkdir()
    from PIL import Image

    for i in range(5):
        img = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
        Image.fromarray(img).save(images / f"i{i}.png")
    return texts, images


@pytest.fixture(scope="module", params=["texts", "texts+images"])
def processed(request, tmp_path_factory):
    """The same corpus and checkpoints through both CLIs."""
    tmp = tmp_path_factory.mktemp(request.param.replace("+", "_"))
    ckpt = _ref_checkpoints(tmp)
    cfg = {"text": {"model": "tiny", "batch_size": 4, "max_length": 64, "checkpoint": ckpt["lm"]},
           "image": {"model": "tiny", "batch_size": 4, "image_size": 32, "patch_size": 8,
                     "checkpoint": ckpt["mae"]},
           "cross_modal": {"model": "tiny", "batch_size": 4, "checkpoint": ckpt["clip"]},
           "redundancy": {"block_size": 8}}
    (tmp / "cfg.yaml").write_text(yaml.dump(cfg))
    texts, images = _corpus(tmp, request.param == "texts+images")
    extra = ["--texts", str(texts)] + (["--images", str(images)] if images else [])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DEWI_TEST_MODE", "0")
        res = CliRunner().invoke(jcli.cli, ["process", str(tmp / "cfg.yaml"), str(tmp / "ref"),
                                            *extra])
        assert res.exit_code == 0, res.output
        assert cli.main(["--device", "cpu", "process", str(tmp / "cfg.yaml"), str(tmp / "port"),
                         *extra]) == 0
    return dict(tmp=tmp, cfg=cfg, images=images is not None)


def _rows(out):
    """source -> (summary row, document row)."""
    docs = {}
    for f in sorted(out.glob("documents_batch_*.jsonl")):
        for line in f.read_text().splitlines():
            d = json.loads(line)
            docs[d["id"]] = d
    return {docs[r["id"]]["metadata"]["source"]: (r, docs[r["id"]])
            for r in json.loads((out / "signals_summary.json").read_text())}


def test_process_rows_match_reference(processed):
    port, ref = (_rows(processed["tmp"] / d) for d in ("port", "ref"))
    assert set(port) == set(ref) and len(port) == (21 if processed["images"] else 16)
    skip = {"hi_mean", "hi_q90", "dewi_score"} if processed["images"] else set()
    worst = 0.0
    for src, (prow, pdoc) in port.items():
        rrow, rdoc = ref[src]
        assert set(prow) == set(rrow)
        assert pdoc["text"] == rdoc["text"] and pdoc["metadata"] == rdoc["metadata"]
        for k in set(prow) - {"id"} - skip:
            worst = max(worst, abs(prow[k] - rrow[k]))
        assert 0.0 <= prow["dewi_score"] <= 1.0
    assert worst <= TOL
    tmp = processed["tmp"]
    for name in ("metadata.json", "index/config.json"):
        a, b = (json.loads((tmp / d / name).read_text()) for d in ("port", "ref"))
        a.pop("created_at", None), b.pop("created_at", None)
        if name == "index/config.json":
            a.pop("encoder"), b.pop("encoder")
        assert a == b


def test_process_embeddings_match_reference(processed):
    tmp = processed["tmp"]

    def by_source(out):
        rows = _rows(out)
        src = {d["id"]: s for s, (_, d) in rows.items()}
        emb = {}
        for f in sorted(out.glob("embeddings_batch_*.npz")):
            z = np.load(f, allow_pickle=True)
            emb.update({src[str(i)]: e for i, e in zip(z["doc_ids"], z["embeddings"])})
        return emb

    port, ref = by_source(tmp / "port"), by_source(tmp / "ref")
    assert set(port) == set(ref)
    assert max(float(np.abs(port[s] - ref[s]).max()) for s in port) <= TOL


def _search(argv, reference=False):
    if reference:
        res = CliRunner().invoke(jcli.cli, ["search", *argv])
        assert res.exit_code == 0, res.output
        out = res.output
    else:
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(["--device", "cpu", "search", *argv]) == 0
        out = buf.getvalue()
    return json.loads(out[out.index("["):out.rindex("]") + 1])


def _sources(out, results):
    src = {d["id"]: s for s, (_, d) in _rows(out).items()}
    return [src[r["id"]] for r in results]


def _same_ranking(a, a_src, b, b_src, tol=1e-4):
    sa = np.array([r["score"] for r in a])
    sb = np.array([r["score"] for r in b])
    assert len(a) == len(b) and np.abs(sa - sb).max() <= tol
    for i in range(len(a)):
        tied = (np.abs(sb - sb[i]) <= tol).sum() > 1
        assert a_src[i] == b_src[i] or tied


@pytest.mark.parametrize("query", ["cat photo river", "quartz zebra entropy", "日本 über"])
def test_search_matches_reference(processed, query):
    tmp = processed["tmp"]
    for extra in ([], ["--eta", "0", "--entropy-pref", "0"]):
        got = _search([str(tmp / "port" / "index"), query, "--k", "5", *extra])
        want = _search([str(tmp / "ref" / "index"), query, "--k", "5", *extra], reference=True)
        _same_ranking(got, _sources(tmp / "port", got), want, _sources(tmp / "ref", want))
        # The port searches the index the reference CLI saved: same ids.
        on_ref = _search([str(tmp / "ref" / "index"), query, "--k", "5", *extra])
        _same_ranking(on_ref, [r["id"] for r in on_ref], want, [r["id"] for r in want])


def test_npy_query_and_eval_on_the_reference_output(processed, capsys):
    tmp = processed["tmp"]
    ref_index = tmp / "ref" / "index"
    rows = _rows(tmp / "ref")
    z = np.load(sorted((tmp / "ref").glob("embeddings_batch_*.npz"))[0], allow_pickle=True)
    np.save(tmp / "q.npy", z["embeddings"][2])
    got = _search([str(ref_index), str(tmp / "q.npy"), "--k", "4"])
    want = _search([str(ref_index), str(tmp / "q.npy"), "--k", "4"], reference=True)
    _same_ranking(got, [r["id"] for r in got], want, [r["id"] for r in want])
    # eval: vectors and texts as queries, each doc's own id as its qrel.
    text_docs = [(s, d) for s, (_, d) in rows.items() if d["text"]][:6]
    qids = np.array([f"q{i}" for i in range(len(text_docs))])
    np.savez(tmp / "qt.npz", query_ids=qids, texts=np.array([d["text"] for _, d in text_docs]))
    np.savez(tmp / "qv.npz", query_ids=np.array(["a", "b"]), embeddings=z["embeddings"][:2])
    (tmp / "qrels.json").write_text(json.dumps(
        {**{q: [d["id"]] for q, (_, d) in zip(qids, text_docs)},
         "a": [str(z["doc_ids"][0])], "b": [str(z["doc_ids"][1])]}))
    (tmp / "eval.yaml").write_text(yaml.dump({"eval": {"recall_k": [1, 3], "ndcg_k": [3]}}))
    for queries in ("qt.npz", "qv.npz"):
        for extra in ([], ["--config", str(tmp / "eval.yaml"), "--eta", "0.3"]):
            args = ["eval", str(ref_index), str(tmp / queries), str(tmp / "qrels.json"), *extra]
            capsys.readouterr()
            assert cli.main(["--device", "cpu", *args]) == 0
            got = json.loads(capsys.readouterr().out)
            res = CliRunner().invoke(jcli.cli, args)
            assert res.exit_code == 0, res.output
            assert got == json.loads(res.output)


def test_sample_on_the_reference_output(processed, capsys):
    out = processed["tmp"] / "ref"
    ids = {r["id"] for r in json.loads((out / "signals_summary.json").read_text())}
    capsys.readouterr()
    assert cli.main(["--device", "cpu", "sample", str(out), "5", "--submodular"]) == 0
    got = capsys.readouterr().out.split()
    res = CliRunner().invoke(jcli.cli, ["sample", str(out), "5", "--submodular"])
    assert got == res.output.split()
    assert cli.main(["--device", "cpu", "sample", str(out), "7", "--seed", "3",
                     "-o", str(out.parent / "s.txt")]) == 0
    picked = (out.parent / "s.txt").read_text().split()
    assert len(picked) == len(set(picked)) == 7 and set(picked) <= ids
    assert cli.main(["--device", "cpu", "sample", str(out.parent), "3"]) == 1


def test_search_refusals(processed, capsys, tmp_path):
    """No provenance and a missing checkpoint are the command's error."""
    from dewi_tpu_torch import DewiIndex

    idx = DewiIndex.load(processed["tmp"] / "port" / "index", device="cpu")
    idx.encoder = None
    idx.save(tmp_path / "noprov")
    rc, out = _port(["search", str(tmp_path / "noprov"), "a query"], capsys)
    assert rc == 1 and "no encoder provenance" in out.err
    idx.encoder = {"model": "tiny", "checkpoint": str(tmp_path / "gone.msgpack")}
    idx.save(tmp_path / "gone")
    rc, out = _port(["search", str(tmp_path / "gone"), "a query"], capsys)
    assert rc == 1 and "does not exist here" in out.err
    np.savez(tmp_path / "q.npz", query_ids=np.array(["q0"]), texts=np.array(["a query"]))
    (tmp_path / "qrels.json").write_text('{"q0": []}')
    rc, out = _port(["eval", str(tmp_path / "gone"), str(tmp_path / "q.npz"),
                     str(tmp_path / "qrels.json")], capsys)
    assert rc == 1 and "does not exist here" in out.err


def test_serve_answers_like_search(processed):
    """``python -m dewi_tpu_torch serve`` in a child process."""
    tmp = processed["tmp"]
    index = tmp / "port" / "index"
    proc = subprocess.Popen([sys.executable, "-m", "dewi_tpu_torch", "--device", "cpu", "serve",
                             str(index), "--port", "0", "--backend", "quantized"], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        lines = []  # read on a thread, so that a server that never starts fails the test

        def read_two():
            lines.extend(proc.stdout.readline() for _ in range(2))

        import threading

        reader = threading.Thread(target=read_two, daemon=True)
        reader.start()
        reader.join(timeout=120)
        assert not reader.is_alive(), "serve printed nothing in 120 s"
        assert lines[0].startswith("Re-tiered"), lines
        line = lines[1]
        assert line.startswith("Serving"), lines
        port = int(line.split("http://")[1].split()[0].rsplit(":", 1)[1])
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/search",
            data=json.dumps({"text": "cat photo river", "k": 3, "eta": 0.5,
                             "entropy_pref": 1.0}).encode(),
            headers={"Content-Type": "application/json"})
        got = json.loads(urllib.request.urlopen(req, timeout=60).read())
    finally:
        proc.terminate()
        rest, _ = proc.communicate(timeout=60)
    assert "Shutting down." in rest
    from dewi_tpu_torch import DewiIndex, retier_index
    from dewi_tpu_torch.serve import query_encoder_for_index

    idx = retier_index(DewiIndex.load(index, device="cpu"), "quantized")
    want = idx.search(query_encoder_for_index(idx).encode_texts(["cat photo river"])[0],
                      k=3, eta=0.5, entropy_pref=1.0)
    assert got["ids"] == [d for d, _, _ in want]
    np.testing.assert_allclose(got["scores"], [s for _, s, _ in want], atol=1e-6)


def test_process_refuses_without_cuda_and_index_failures_fail(processed, capsys, monkeypatch):
    """``--device cuda`` with no card, and a failed index build, end the
    command with exit 1 (the reference exits 0 after a warning for the
    latter)."""
    import torch

    from dewi_tpu_torch import pipelines

    monkeypatch.setenv("DEWI_TEST_MODE", "0")
    tmp = processed["tmp"]
    args = ["process", str(tmp / "cfg.yaml"), str(tmp / "again"), "--texts", str(tmp / "texts")]
    if not torch.cuda.is_available():
        rc = cli.main(args)
        assert rc == 1 and "CUDA" in capsys.readouterr().err
    assert cli.main(["--device", "cuda", *args[:3], "--device", "cpu", *args[3:]]) == 0

    def broken(self, *a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(pipelines.DewiPipeline, "build_index_corpus", broken)
    capsys.readouterr()
    rc = cli.main(["--device", "cpu", *args])
    err = capsys.readouterr().err
    assert rc == 1 and "Error during processing: kernel launch failed" in err


def test_process_routes(processed, capsys, monkeypatch):
    """The stage-checkpoint and the sharded routes give the columnar rows."""
    monkeypatch.setenv("DEWI_TEST_MODE", "0")
    tmp = processed["tmp"]
    base = ["--device", "cpu", "process", str(tmp / "cfg.yaml")]
    extra = ["--texts", str(tmp / "texts")]
    if processed["images"]:
        extra += ["--images", str(tmp / "images")]
    assert cli.main([*base, str(tmp / "ck"), *extra, "--checkpoint-dir", str(tmp / "c1")]) == 0
    assert cli.main([*base, str(tmp / "sh"), *extra, "--shard-size", "6",
                     "--checkpoint-dir", str(tmp / "c2")]) == 0
    want = _rows(tmp / "port")
    for d in ("ck", "sh"):
        got = _rows(tmp / d)
        assert set(got) == set(want)
        skip = {"id", "hi_mean", "hi_q90", "dewi_score"} if processed["images"] else {"id"}
        dev = max(abs(got[s][0][k] - want[s][0][k]) for s in got for k in set(got[s][0]) - skip)
        assert dev <= TOL, d
    assert any((tmp / "c2").iterdir())


def test_process_profile_writes_a_trace(processed, capsys):
    """``runtime.profile: true`` runs ``process`` under ``torch.profiler``
    and writes a Chrome trace into ``<out>/profile``."""
    tmp = processed["tmp"]
    cfg = {**processed["cfg"], "runtime": {"profile": True}}
    (tmp / "profile.json").write_text(json.dumps(cfg))
    assert cli.main(["--device", "cpu", "process", str(tmp / "profile.json"), str(tmp / "prof"),
                     "--texts", str(tmp / "texts")]) == 0
    assert "torch.profiler trace written" in capsys.readouterr().out
    traces = list((tmp / "prof" / "profile").glob("trace_*.json"))
    assert len(traces) == 1 and json.loads(traces[0].read_text())["traceEvents"]
