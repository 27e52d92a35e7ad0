#!/usr/bin/env python3
"""Run the port's command line, ``process``, over a synthetic corpus on one
CUDA card, timed per stage.

    python3 scripts/torch_cli_process.py [--texts N] [--images M] [--seed S]
        [--workdir DIR]

Writes ``--texts`` text files of 1-500 bytes (the synthetic texts of
``scripts/torch_process_corpus.py``) and ``--images`` random 224-px uint8
images as a packed ``.npy`` (with its ``.json`` sidecar and manifest), saves
seeded LM, MAE and CLIP checkpoints at the reference's default widths
(``gpt2``, ``vit-mae-base``, ``clip-vit-base-patch32``), writes the default
config with the three checkpoints and the decode cache of that script's runs
as JSON, and runs ``cli.main(["--device", "cuda", "process", CONFIG, OUT,
"--texts", DIR, "--images", PACK])`` in this process: the function that
``python -m dewi_tpu_torch`` runs.  The index is ``int8`` with int8
queries.  Prints one JSON line: the total, the seconds of loading the
documents, of each signal stage (the estimator calls timed to a
``synchronize``), of scoring, ``_save_results``, the index build and the
index save, the route ``process`` took, peak device memory, then
``--queries`` text queries through ``search`` (the index loaded and the
query encoded anew each call, as the command does) with the stage-1
kernels' launches.  The texts and the images are separate documents, as
``process`` makes them.  ``chip_smoke.py`` phase 10 uses the helpers below.
Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import torch_process_corpus as tpc  # noqa: E402

STAGE1 = ("bmax_s8", "scores_matrix_s8")


def write_texts(directory: Path, n: int, seed: int) -> list:
    """``n`` text files ``t0000000.txt``... of 1-500 bytes; returns the texts."""
    directory.mkdir(parents=True, exist_ok=True)
    texts = tpc.synthetic_texts(n, seed)
    for i, t in enumerate(texts):
        (directory / f"t{i:07d}.txt").write_text(t, encoding="utf-8")
    return texts


def write_pack(path: Path, n: int, seed: int) -> np.ndarray:
    """``n`` random 224-px images as a packed corpus: the ``.npy`` (uint8
    ``[n, 224, 224, 3]``), the sidecar ``pack_images`` writes and a manifest
    of row names.  Returns the mapped array."""
    from dewi_tpu_torch.io.packed import PACK_VERSION, _sidecar_path

    mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.uint8, shape=(n, 224, 224, 3))
    for s in range(0, n, 8192):
        m = min(8192, n - s)
        mm[s:s + m] = tpc.synthetic_images(m, seed + s)
    mm.flush()
    _sidecar_path(path).write_text(json.dumps({
        "version": PACK_VERSION, "n_images": n, "size": 224, "dtype": "uint8",
        "sources": ["<ndarray>"] * min(n, 3)}, indent=2))
    Path(str(path) + ".manifest.json").write_text(
        json.dumps([f"img{i:07d}" for i in range(n)]))
    return np.load(path, mmap_mode="r")


def save_checkpoints(directory: Path, seed: int) -> dict:
    """Seeded LM, MAE and CLIP checkpoints at the default widths."""
    from dewi_tpu_torch.models import registry

    paths = {k: directory / f"{k}.msgpack" for k in ("text", "image", "cross_modal")}
    # The text estimator's context is the config's text.max_length (512).
    registry.save_params(registry.init_lm(registry.lm_config("gpt2", max_len=512), seed=seed,
                                          device="cpu"), paths["text"])
    registry.save_params(registry.init_mae(registry.mae_config("vit-mae-base"), seed=seed,
                                           device="cpu"), paths["image"])
    registry.save_params(registry.init_clip(registry.clip_config("clip-vit-base-patch32"),
                                            seed=seed, device="cpu"), paths["cross_modal"])
    return {k: str(p) for k, p in paths.items()}


def cli_config(checkpoints: dict, **over: dict) -> dict:
    """The default config tree (``config`` writes it) with the checkpoints
    and ``over`` merged in."""
    from dewi_tpu_torch.config import apply_preset, get_default_config

    cfg = apply_preset(get_default_config(), "default").to_dict()
    for section, path in checkpoints.items():
        cfg[section]["checkpoint"] = path
    for section, values in over.items():
        cfg[section].update(values)
    return cfg


@contextlib.contextmanager
def clocked_process():
    """Time what ``cli.main(["process", ...])`` does: each pipeline it makes
    gets a ``StageClock``; document loading, ``_save_results``, the index
    build and save are wrapped.  Yields the dict the seconds go into."""
    from dewi_tpu_torch import cli, pipelines
    from dewi_tpu_torch.index import DewiIndex

    rec: dict = {"stage_seconds": None, "routes": []}
    saved = {}

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            rec[name] = rec.get(name, 0.0) + time.perf_counter() - t
            return out
        return run

    init = pipelines.DewiPipeline.__init__

    def clocked_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        clock = tpc.StageClock(self)
        rec["stage_seconds"] = clock.seconds
        for route in ("process_corpus", "process_stream_corpus", "compute_signals"):
            def mark(fn, route=route):
                def run(*a, **k):
                    rec["routes"].append(route)
                    return fn(*a, **k)
                return run
            setattr(self, route, mark(getattr(self, route)))

    patches = [(pipelines.DewiPipeline, "__init__", clocked_init),
               (cli, "_load_documents", timed("load_documents_s", cli._load_documents)),
               (cli, "_save_results", timed("save_results_s", cli._save_results)),
               (pipelines.DewiPipeline, "build_index_corpus",
                timed("index_build_s", pipelines.DewiPipeline.build_index_corpus)),
               (DewiIndex, "save", timed("index_save_s", DewiIndex.save))]
    for owner, name, fn in patches:
        saved[(owner, name)] = getattr(owner, name)
        setattr(owner, name, fn)
    try:
        yield rec
    finally:
        for (owner, name), fn in saved.items():
            setattr(owner, name, fn)


def run_process(argv: list) -> dict:
    """``cli.main(argv)`` under :func:`clocked_process`: its exit code, the
    total seconds, the breakdown and the stage-1 launches."""
    from dewi_tpu_torch import cli
    from dewi_tpu_torch.ops import cuda_search as cs

    cs.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with clocked_process() as rec:
        t = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        rec["seconds"] = time.perf_counter() - t
    rec["rc"] = rc
    rec["launches"] = {k: cs.launch_counts[k] for k in STAGE1}
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    stages = rec["stage_seconds"] or {}
    accounted = sum(stages.values()) + sum(rec.get(k, 0.0) for k in (
        "load_documents_s", "save_results_s", "index_build_s", "index_save_s"))
    rec["other_seconds"] = rec["seconds"] - accounted
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--texts", type=int, default=196_608)
    ap.add_argument("--images", type=int, default=65_536)
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=None,
                    help="Where the corpus and the output go (default: a temporary "
                         "directory in the repository, removed at the end)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_cli_process: no CUDA device", file=sys.stderr)
        return 2
    # The whole image corpus may live on the card (80 GB), as in the
    # pipeline script's runs.
    os.environ.setdefault("DEWI_DEVICE_IMAGES_MAX_BYTES", str(48 << 30))
    card = tpc.card_line()
    print(f"card: {card}", flush=True)
    with tempfile.TemporaryDirectory(dir=args.workdir or ROOT) as tmp:
        tmp = Path(tmp)
        t = time.perf_counter()
        write_texts(tmp / "texts", args.texts, args.seed)
        if args.images:
            write_pack(tmp / "images.npy", args.images, args.seed + 1)
        ckpts = save_checkpoints(tmp, args.seed)
        decode_mb = max(4096, (args.images * 224 * 224 * 3 >> 20) + 1)
        cfg = cli_config(ckpts, runtime={"decode_cache_mb": decode_mb},
                         index={"ann": "int8", "int8_queries": True})
        (tmp / "dewi.json").write_text(json.dumps(cfg))
        setup_s = time.perf_counter() - t
        argv = ["--device", "cuda", "process", str(tmp / "dewi.json"), str(tmp / "out"),
                "--texts", str(tmp / "texts")]
        if args.images:
            argv += ["--images", str(tmp / "images.npy")]
        rec = run_process(argv)
        n = args.texts + args.images
        summary = json.loads((tmp / "out" / "signals_summary.json").read_text())
        dewi = np.array([r["dewi_score"] for r in summary], np.float64)
        rec.update(docs=n, texts=args.texts, images=args.images, setup_s=setup_s,
                   docs_per_s=n / rec["seconds"], summary_rows=len(summary),
                   dewi_in_0_1=bool(((dewi >= 0) & (dewi <= 1)).all()),
                   disk_gb=float(subprocess.run(["du", "-sb", str(tmp)], capture_output=True,
                                                text=True).stdout.split()[0]) / 1e9)
        print("cli process: " + json.dumps({**rec, "card": card}), flush=True)
        search = search_run(tmp / "out" / "index", args.queries, args.seed + 2)
        print("cli search: " + json.dumps({**search, "card": card}), flush=True)
    ok = (rec["rc"] == 0 and rec["summary_rows"] == n and rec["dewi_in_0_1"]
          and search["ok"])
    return 0 if ok else 1


def search_run(index_dir: Path, n: int, seed: int) -> dict:
    """``n`` text queries through ``cli.main(["search", ...])``: ms per call
    and the stage-1 launches."""
    from dewi_tpu_torch import cli
    from dewi_tpu_torch.ops import cuda_search as cs

    cs.reset_launch_counts()
    ms, rcs = [], []
    for i, q in enumerate(tpc.synthetic_texts(n, seed, lo=3, hi=120)):
        t = time.perf_counter()
        rcs.append(cli.main(["--device", "cuda", "search", str(index_dir), q,
                             "-o", str(index_dir.parent / f"search{i}.json")]))
        ms.append((time.perf_counter() - t) * 1e3)
    launches = {k: cs.launch_counts[k] for k in STAGE1}
    return {"queries": n, "ms": ms, "ms_p50": float(np.median(ms)), "launches": launches,
            "ok": all(rc == 0 for rc in rcs) and launches["bmax_s8"] > 0}


if __name__ == "__main__":
    sys.exit(main())
