#!/usr/bin/env python3
"""Process a synthetic text+image corpus through the port's ``DewiPipeline``
on one CUDA card, and time the redundancy scan at scale.

    python3 scripts/torch_process_corpus.py [--n N] [--image-frac F]
        [--dup-pairs P] [--redundancy-n M] [--profile-n K] [--dim D] [--seed S]

1. ``process_corpus`` at the reference's default widths (``gpt2``,
   ``vit-mae-base``, ``clip-vit-base-patch32``, batch sizes 64/64/128;
   seeded weights) on ``--n`` docs: texts of 1-500 bytes, ``--image-frac``
   of the docs carrying a random 224-px uint8 image (one dense array; a
   per-doc list of its rows unless every doc has one), ``--dup-pairs``
   planted duplicate pairs (same text, same image).  Prints per-stage
   seconds (text, image, cross-modal encode, redundancy, noise, score, and
   the rest: decode cache and upload), docs/s and peak device memory as one
   JSON line (``--n 0`` skips it); then ``--profile-n`` docs (default
   2,048; 0 skips) under ``torch.profiler``: device busy time, idle share
   and the costliest kernels.
2. ``max_offdiag_similarity`` and ``topk_density`` on ``--redundancy-n``
   unit vectors of ``--dim`` (1,024 planted duplicates), default block and
   chunk: seconds and f32 TFLOP/s (2 N^2 D over the time), 512 sampled rows
   held against float64 on the host within 1e-5 (``--redundancy-n 0``
   skips it).

``chip_smoke.py`` phase 9 runs both at its own sizes through the helpers
below.  Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
SCAN_TOL = 1e-5             # the scans against float64 on the host
N_SCAN_DUPS = 1024
N_SCAN_CHECK = 512
STAGES = {                  # stage -> (pipeline estimator, method) it times
    "text": (("text_entropy", "batch_compute_stats"),),
    "image": (("image_entropy", "batch_compute_stats"),),
    "cross_modal_encode": (("cross_modal", "encode_texts"), ("cross_modal", "encode_images")),
    "redundancy": (("redundancy", "score"), ("redundancy", "cross_modal_density_scores"),
                   ("redundancy", "score_texts"), ("redundancy", "score_images")),
    "noise": (("noise", "batch_compute"),),
}
_WORDS = ("entropy", "signal", "image", "caption", "corpus", "index", "query", "token",
          "a", "the", "of", "and", "with", "over", "under", "river", "mountain", "city",
          "night", "blue", "red", "quiet", "loud", "graph", "kernel", "tensor", "photo",
          "dog", "cat", "bicycle", "market", "ocean", "forest", "winter", "summer")


def sync() -> None:
    torch.cuda.synchronize()


def synthetic_texts(n: int, seed: int, lo: int = 1, hi: int = 500) -> list:
    """``n`` texts of random words, byte lengths uniform in ``[lo, hi]``."""
    rng = np.random.default_rng(seed)
    words = rng.choice(_WORDS, size=(n, hi // 2 + 1))
    lens = rng.integers(lo, hi + 1, n)
    return [" ".join(w)[:m] for w, m in zip(words, lens)]


def synthetic_images(n: int, seed: int, size: int = 224, device: str = "cuda") -> np.ndarray:
    """``[n, size, size, 3]`` uint8 made on ``device`` (the card): a colour,
    a smooth random field and pixel noise per image, so that images differ
    in more than their noise."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = np.empty((n, size, size, 3), np.uint8)
    for s in range(0, n, 1024):
        m = min(1024, n - s)
        base = torch.rand(m, 3, 1, 1, device=device, generator=g) * 200 + 20
        field = torch.nn.functional.interpolate(
            torch.rand(m, 3, 7, 7, device=device, generator=g) * 120 - 60, size=(size, size),
            mode="bilinear", align_corners=False)
        noise = torch.randn(m, 3, size, size, device=device, generator=g) * 20
        img = (base + field + noise).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
        out[s:s + m] = img.cpu().numpy()
    return out


def make_corpus(n: int, n_images: int, dup_pairs: int, seed: int, size: int = 224,
                device: str = "cuda") -> tuple:
    """A ``Corpus`` of ``n`` docs, ``n_images`` of them with an image, and
    ``dup_pairs`` planted pairs; returns ``(corpus, planted doc indices,
    the dense [n_images, size, size, 3] image array)``."""
    from dewi_tpu_torch import Corpus

    rng = np.random.default_rng(seed)
    texts = synthetic_texts(n, seed)
    dense = synthetic_images(n_images, seed + 1, size, device)
    img_docs = np.sort(rng.choice(n, n_images, replace=False))
    pick = rng.choice(n_images, 2 * dup_pairs, replace=False)
    src, dst = pick[:dup_pairs], pick[dup_pairs:]
    dense[dst] = dense[src]
    for a, b in zip(img_docs[src], img_docs[dst]):
        texts[b] = texts[a]
    if n_images == n:
        images = dense  # one dense array: the pipeline uploads it in the background
    else:
        images = [None] * n
        for j, i in enumerate(img_docs):
            images[i] = dense[j]
    corpus = Corpus(ids=[f"doc{i:07d}" for i in range(n)], texts=texts, images=images)
    return corpus, np.sort(np.concatenate([img_docs[src], img_docs[dst]])), dense


class StageClock:
    """Wall seconds per pipeline stage, to a ``synchronize``: wraps the
    estimator methods of :data:`STAGES` and ``_score_corpus`` on one
    pipeline instance."""

    def __init__(self, pipe) -> None:
        self.seconds = {name: 0.0 for name in (*STAGES, "score")}
        for stage, methods in STAGES.items():
            for attr, name in methods:
                est = getattr(pipe, attr)  # builds the estimator
                setattr(est, name, self._timed(stage, getattr(est, name)))
        pipe._score_corpus = self._timed("score", pipe._score_corpus)

    def _timed(self, stage: str, fn):
        def run(*args, **kwargs):
            sync()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            self.seconds[stage] += time.perf_counter() - t
            return out
        return run


def pipeline_config(clip_checkpoint: str, **over) -> dict:
    """The reference's default config with the CLIP towers from a file (so
    that the index's provenance names it) and ``over`` merged in."""
    cfg = {"cross_modal": {"checkpoint": clip_checkpoint}}
    for k, v in over.items():
        cfg[k] = {**cfg.get(k, {}), **v}
    return cfg


def save_clip(path: Path, seed: int = 0) -> str:
    from dewi_tpu_torch.models import registry

    registry.save_params(registry.init_clip(registry.clip_config("clip-vit-base-patch32"),
                                            seed=seed), path)
    return str(path)


def process_run(pipe, corpus) -> dict:
    """``pipe.process_corpus(corpus)`` timed per stage."""
    clock = StageClock(pipe)
    sync()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    pipe.process_corpus(corpus)
    sync()
    total = time.perf_counter() - t
    n = len(corpus)
    return {"docs": n, "images": int(corpus.has_image.sum()), "seconds": total,
            "docs_per_s": n / total, "stage_seconds": clock.seconds,
            "other_seconds": total - sum(clock.seconds.values()),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def profile_run(pipe, n: int, n_images: int, seed: int) -> dict:
    """``process_corpus`` on a fresh ``n``-doc corpus under ``torch.profiler``:
    the host-clock seconds of one call, the device's busy seconds, the idle
    share between them and the costliest kernels."""
    from chip_smoke import device_profile
    from dewi_tpu_torch import Corpus

    corpus, _, _ = make_corpus(n, n_images, 4, seed)

    def run() -> None:
        pipe.process_corpus(Corpus(ids=corpus.ids, texts=corpus.texts, images=corpus.images))

    run()
    sync()
    t = time.perf_counter()
    run()
    sync()
    wall_ms = (time.perf_counter() - t) * 1e3
    prof = device_profile(run, reps=1, top_n=6)
    busy = prof["device_ms"]
    return {"docs": n, "images": n_images, "wall_ms": wall_ms, **prof,
            "idle_share": 1 - busy / wall_ms if isinstance(busy, float) else "not measured"}


def scan_reference(emb64: np.ndarray, rows: np.ndarray, top: int = 8) -> tuple:
    """Float64 max off-diagonal cosine and top-``top`` density of ``rows``."""
    sims = emb64[rows] @ emb64.T
    sims[np.arange(len(rows)), rows] = -np.inf
    part = -np.partition(-sims, top - 1, axis=1)[:, :top]
    return np.clip(sims.max(axis=1), -1, 1), np.clip(part, -1, 1).mean(axis=1)


def redundancy_run(n: int, dim: int, seed: int = 0) -> dict:
    """The two scans on ``n`` unit vectors on the card, timed, and held
    against float64 on the host at sampled rows."""
    from dewi_tpu_torch.signals.redundancy import max_offdiag_similarity, topk_density

    g = torch.Generator(device="cuda").manual_seed(seed)
    emb = torch.randn(n, dim, device="cuda", generator=g)
    emb = emb / emb.norm(dim=1, keepdim=True)
    perm = torch.randperm(n, device="cuda", generator=g)
    dups = min(N_SCAN_DUPS, n // 2)
    emb[perm[:dups]] = emb[perm[dups:2 * dups]]
    planted = perm[:2 * dups].cpu().numpy()
    max_offdiag_similarity(emb[:8192])  # warm-up: cuBLAS handles and the allocator
    topk_density(emb[:8192])
    out = {"n": n, "dim": dim, "flop": 2.0 * n * n * dim}
    got = {}
    for name, fn in (("max_offdiag", max_offdiag_similarity), ("topk_density", topk_density)):
        sync()
        t = time.perf_counter()
        got[name] = fn(emb)
        sec = time.perf_counter() - t
        out[name] = {"seconds": sec, "tflops": out["flop"] / sec / 1e12,
                     "bound_s": out["flop"] / F32_OPS_PER_S,
                     "share_of_bound": out["flop"] / F32_OPS_PER_S / sec}
    rng = np.random.default_rng(seed)
    rows = np.unique(np.concatenate([planted[:N_SCAN_CHECK // 4],
                                     rng.choice(n, N_SCAN_CHECK, replace=False)]))[:N_SCAN_CHECK]
    want_max, want_dens = scan_reference(emb.double().cpu().numpy(), rows)
    out["max_abs_err"] = {"max_offdiag": float(np.abs(got["max_offdiag"][rows] - want_max).max()),
                          "topk_density": float(np.abs(got["topk_density"][rows]
                                                       - want_dens).max())}
    out["planted_min"] = float(got["max_offdiag"][planted].min())
    out["checked_rows"] = len(rows)
    out["ok"] = (max(out["max_abs_err"].values()) <= SCAN_TOL and out["planted_min"] >= 0.99)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--image-frac", type=float, default=0.5)
    ap.add_argument("--dup-pairs", type=int, default=256)
    ap.add_argument("--redundancy-n", type=int, default=1 << 20)
    ap.add_argument("--profile-n", type=int, default=2048)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_process_corpus: no CUDA device", file=sys.stderr)
        return 2
    # The whole image corpus may live on the card (80 GB) and in the cache.
    os.environ.setdefault("DEWI_DEVICE_IMAGES_MAX_BYTES", str(48 << 30))
    from dewi_tpu_torch import DewiConfig, DewiPipeline
    from dewi_tpu_torch.utils.profiling import card_line

    card = card_line()
    print(f"card: {card}", flush=True)
    ok = True
    if args.n:
        n_images = int(round(args.n * args.image_frac))
        with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
            cfg = DewiConfig.from_dict(pipeline_config(
                save_clip(Path(tmp) / "clip.msgpack", args.seed),
                runtime={"decode_cache_mb": max(4096, (n_images * 224 * 224 * 3 >> 20) + 1)}))
            t = time.perf_counter()
            corpus, planted, _ = make_corpus(args.n, n_images, args.dup_pairs, args.seed)
            setup_s = time.perf_counter() - t
            pipe = DewiPipeline(cfg)
            warm, _, _ = make_corpus(256, int(round(256 * args.image_frac)), 4, args.seed + 9)
            pipe.process_corpus(warm)  # warm-up: builds the estimators, allocator, handles
            row = process_run(pipe, corpus)
        red = corpus.col("redundancy")
        rest = np.setdiff1d(np.arange(args.n), planted)
        row.update(setup_s=setup_s, planted=len(planted),
                   planted_min_redundancy=float(red[planted].min()),
                   rest_median_redundancy=float(np.median(red[rest])),
                   finite=bool(np.isfinite(corpus.signals).all()
                               and np.isfinite(corpus.dewi).all()))
        ok &= row["finite"] and row["planted_min_redundancy"] >= 0.99
        print("process_corpus: " + json.dumps({**row, "card": card}), flush=True)
        if args.profile_n:
            prof = profile_run(pipe, args.profile_n, int(round(args.profile_n * args.image_frac)),
                               args.seed + 7)
            print("process_corpus profile: " + json.dumps({**prof, "card": card}), flush=True)
    if args.redundancy_n:
        row = redundancy_run(args.redundancy_n, args.dim, args.seed)
        ok &= row["ok"]
        print("redundancy scan: " + json.dumps({**row, "card": card}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
