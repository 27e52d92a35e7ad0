#!/usr/bin/env python3
"""Signal-extraction throughput through the port's data-parallel path.

    python3 scripts/torch_profile_signals_sharded.py --model small
    python3 scripts/torch_profile_signals_sharded.py --model small --ranks 4

Counterpart of ``scripts/profile_signals_sharded.py``: the estimator
forwards through ``parallel.signals.DataParallel`` (each rank runs its
slice of every staged batch, the per-doc outputs all-gathered back), text,
image and CLIP each as a sharded rate and a per-device rate, then
``process_corpus`` on a ``DewiPipeline(mesh=)`` beside the meshless
pipeline on the same docs (``pipeline_e2e_sharded``).

* ``--ranks 1`` (the default): a world of one in this process, over NCCL on
  the card (gloo on the CPU), through a file rendezvous;
* ``--ranks N``: N gloo ranks on this host (``parallel.launch_local``); on
  one card they share it, since NCCL refuses two ranks on one GPU, and the
  collectives are staged through the host.

Neither measures scaling: a world of one runs the sharded code path with
nothing to share, and ranks sharing one card share its time; the JSON
says so (``scaling``).  Each device stage is ``torch_profile_signals``'s
staged forward (``text_device``, ``image_device``, ``clip_device``):
``SUPERBATCH`` staged batches a call, 4 timed calls after a warm one, host
clock to a synchronize.

Deliberate differences from the reference's keys: the reference's
``--target-chips`` projection to a TPU slice (``*_1M_s_<N>chip``,
``full_signals_1M_*_<N>chip_projected``) and its 5-minute budget
(``budget_min``, ``within_budget``), and its residuals read from a TPU
artifact (``redundancy_1M_s_single_chip_unsharded``, ``noise_1M_s_4hosts``)
are dropped; each stage has ``*_1M_s_per_card`` (1M docs over the
per-device rate) and ``full_signals_1M_s_per_card`` their sum, with no
projection to N cards.  Added: ``card``, ``backend``, ``ranks_share_one_card``,
``scaling``, ``superbatch``.  Writes ``--output`` (JSON, default under
``chiprun_out/``).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

from torch_profile_signals import (SUPERBATCH, TARGET_N, _sync,  # noqa: E402
                                   clip_device, device_rate, image_device, make_texts,
                                   text_device)

LAUNCH_TIMEOUT_S = 1800.0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="small")
    ap.add_argument("--n-docs", type=int, default=4096)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--pipeline-docs", type=int, default=512,
                    help="docs for the public process_corpus smoke (0 skips it)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="1: a world of one in this process; N: N gloo ranks")
    ap.add_argument("--output", default=str(REPO / "chiprun_out" / "signals_sharded.json"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    return ap.parse_args(argv)


def measure(args, device) -> dict:
    """Every row on the mesh of the current process group (a world of one
    without one); rank 0's metrics."""
    import torch

    from dewi_tpu_torch.config import DewiConfig
    from dewi_tpu_torch.corpus import Corpus
    from dewi_tpu_torch.parallel import make_mesh
    from dewi_tpu_torch.pipelines import DewiPipeline
    from dewi_tpu_torch.signals import (CrossModalDependency, ImageEntropyEstimator,
                                        TextEntropyEstimator)

    mesh = make_mesh(device=device)
    dev = mesh.device
    n_dev = mesh.n_data
    rng = np.random.default_rng(0)
    texts = make_texts(args.n_docs, rng)
    metrics: dict = {"model": args.model, "mesh_devices": int(n_dev)}

    def rate_row(name: str, unit: str, call, per_call: int) -> None:
        dps = device_rate(call, per_call, dev)
        per_dev = dps / n_dev
        metrics[f"{name}_{unit}_per_sec_sharded"] = round(dps, 1)
        metrics[f"{name}_{unit}_per_sec_per_device"] = round(per_dev, 1)
        metrics[f"{name}_1M_s_per_card"] = round(TARGET_N / per_dev, 1)
        if mesh.data_index == 0:
            print(f"{name}: {dps:,.0f} {unit}/s sharded ({per_dev:,.0f}/device)", flush=True)

    # ---- the staged device forwards of torch_profile_signals, each rank on
    # its slice of every batch (the estimators' DataParallel)
    est = TextEntropyEstimator(model_name=args.model, batch_size=args.batch_size,
                               max_length=512, mesh=mesh)
    rate_row("text", "docs", *text_device(est, texts)[:2])
    del est

    ie = ImageEntropyEstimator(model_name=args.model, batch_size=64,
                               image_size=args.image_size, mesh=mesh)
    imgs = rng.random((ie.batch_size, args.image_size, args.image_size, 3)).astype(np.float32)
    rate_row("image", "docs", *image_device(ie, imgs)[:2])
    del ie

    cm = CrossModalDependency(model_name=args.model, batch_size=128, mesh=mesh)
    pair_texts = texts[:cm.batch_size]
    cimgs = rng.random((len(pair_texts), cm.cfg.image_size, cm.cfg.image_size, 3)
                       ).astype(np.float32)
    rate_row("clip", "pairs", *clip_device(cm, pair_texts, cimgs)[:2])
    del cm

    # ---- the public process_corpus through the mesh, beside the meshless
    # pipeline on the same corpus and config (rank 0)
    n_small = min(args.n_docs, max(args.pipeline_docs, 0))
    if n_small:
        cfg = DewiConfig()
        cfg.text.model = args.model
        cfg.text.batch_size = args.batch_size
        cfg.image.model = args.model
        cfg.cross_modal.model = args.model
        small_imgs = (rng.random((n_small, args.image_size, args.image_size, 3))
                      * 255).astype(np.uint8)

        def mk_corpus():
            return Corpus(ids=[f"d{i}" for i in range(n_small)], texts=texts[:n_small],
                          images=small_imgs)

        pipe = DewiPipeline(cfg, mesh=mesh)

        def timed_run(fn) -> float:
            mesh.barrier()
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            return time.perf_counter() - t0

        cold_s = timed_run(lambda: pipe.process_corpus(mk_corpus()))
        e2e_s = timed_run(lambda: pipe.process_corpus(mk_corpus()))
        sig_s = timed_run(lambda: pipe.compute_signals_corpus(mk_corpus()))
        row = {"n_docs": n_small, "cold_s": round(cold_s, 2), "warm_s": round(e2e_s, 2),
               "warm_docs_per_sec": round(n_small / e2e_s, 1),
               "warm_signals_s": round(sig_s, 2),
               "warm_scoring_s": round(max(e2e_s - sig_s, 0.0), 2)}
        del pipe
        if mesh.data_index == 0:
            plain = DewiPipeline(cfg, device=dev)
            plain.process_corpus(mk_corpus())  # cold
            t0 = time.perf_counter()
            plain.process_corpus(mk_corpus())
            _sync(dev)
            nomesh_s = time.perf_counter() - t0
            row["meshless_warm_docs_per_sec"] = round(n_small / nomesh_s, 1)
            row["mesh_vs_meshless"] = round(nomesh_s / e2e_s, 3)
            del plain
        mesh.barrier()
        row["note"] = ("small-corpus smoke: proves the public process_corpus(mesh=) path "
                       "end to end; per-doc rates at this size are set by per-batch "
                       "dispatch and the host feed, not device compute; the staged "
                       "rates above are the capacity numbers.")
        metrics["pipeline_e2e_sharded"] = row
        metrics["pipeline_e2e_docs_per_sec_sharded"] = row["warm_docs_per_sec"]
    return metrics


def rank_main(args) -> dict:
    """One gloo rank of ``--ranks N`` (started by ``launch_local``)."""
    import torch.distributed as dist

    from dewi_tpu_torch.utils.device import resolve_device

    out = measure(args, resolve_device(args.device))
    out["backend"] = dist.get_backend()
    return out


def world_of_one(args, device) -> dict:
    """``measure`` in this process as a process group of one: NCCL on the
    card, gloo on the CPU."""
    import torch.distributed as dist

    backend = "nccl" if device.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", world_size=1,
                                rank=0, timeout=datetime.timedelta(seconds=LAUNCH_TIMEOUT_S))
        try:
            out = measure(args, None if backend == "nccl" else device)
        finally:
            dist.destroy_process_group()
    out["backend"] = backend
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    from dewi_tpu_torch.utils.device import resolve_device
    from dewi_tpu_torch.utils.profiling import card_line, device_name

    device = resolve_device(args.device)
    if args.ranks == 1:
        metrics = world_of_one(args, device)
    else:
        from dewi_tpu_torch.parallel import launch_local

        if device.type == "cuda":
            from dewi_tpu_torch.ops import _build

            _build.load_library()  # one build before the ranks load it
        metrics = launch_local(rank_main, args.ranks, (args,), backend="gloo",
                               timeout=LAUNCH_TIMEOUT_S,
                               threads=max(1, (os.cpu_count() or 1) // args.ranks))
    metrics.update({
        "device_kind": device_name(device),
        "card": card_line() if device.type == "cuda" else "cpu",
        "ranks_share_one_card": device.type == "cuda" and args.ranks > 1,
        "superbatch": SUPERBATCH,
        "scaling": ("not measured: a world of one runs the sharded code path with nothing "
                    "to share, and ranks on one card share its time"),
        "parity": ("sharded == single-device asserted by tests/test_torch_parallel_signals.py "
                   "and chip_smoke.py phase 12c"),
    })
    total = sum(metrics[f"{s}_1M_s_per_card"] for s in ("text", "image", "clip"))
    metrics["full_signals_1M_s_per_card"] = round(total, 1)
    metrics["full_signals_1M_min_per_card"] = round(total / 60, 2)
    print(f"FULL SIGNALS 1M (device stages, one card's rate): {total / 60:,.2f} min", flush=True)
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    Path(args.output).write_text(json.dumps(metrics, indent=2))
    print(json.dumps(metrics, indent=2), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
