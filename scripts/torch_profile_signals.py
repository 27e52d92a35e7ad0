#!/usr/bin/env python3
"""Signal-extraction throughput of the port: all five DEWI signal stages.

    python3 scripts/torch_profile_signals.py --n-docs 8192 --model small
    python3 scripts/torch_profile_signals.py --model base --n-docs 1024 \\
        --n-images 128 --n-pairs 256 --redundancy-n 65536

Counterpart of ``scripts/profile_signals.py``: the same arguments (plus
``--device``, the card unless ``cpu`` is asked for), the same corpus
(``WORDS``, seed 0) and the same stages, each backbone stage measured two
ways:

* ``*_device``: the forward on inputs already on the card, ``SUPERBATCH``
  staged batches a call (the reference's superbatch), 4 timed calls after
  a warm one, host clock to a ``torch.cuda.synchronize``;
* ``*_host``: the estimator's public path (``batch_compute_stats``,
  ``batch_compute``), tokenizing and the host-to-device copy included.

Each backbone stage also holds its two rows to each other on one shared
batch (``*_device_vs_host_max_rel_dev``: per doc, the largest
``|device - host|`` over ``max(|host|, 1)``; text over the docs no longer
than the staged 256 tokens, images with the host path's first masking
noise).  Redundancy times ``max_offdiag_similarity`` on ``--redundancy-n``
random rows and charges it its O(N^2) cost at 1M exactly as the reference
does (``redundancy_s_exact`` is the time the extrapolation uses); noise is
host docs/s; the ingest rows need PIL and are skipped without it, with the
reference's message.  The headline charges every doc every stage.

Deliberate differences from the reference's keys: every ``*_single_chip``
is ``*_single_card`` (one card's figures); the reference's v5e-16 budget
keys (``budget_min_single_chip`` = 80 and ``within_budget``) are dropped,
a target set for a TPU slice that says nothing of a card; added are
``card``, ``superbatch``, ``redundancy_s_exact`` and the three
``*_device_vs_host_max_rel_dev``.  Writes ``--output`` (JSON, default under
``chiprun_out/``).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

from torch_profile_e2e import WORDS, col_dev, make_texts  # noqa: E402, F401  (one corpus)

TARGET_N = 1_000_000
SUPERBATCH = 8      # staged batches a timed device call (the reference's superbatch)
TEXT_PAD = 256      # the staged text batch's length (the reference's dominant bucket)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-docs", type=int, default=8192)
    ap.add_argument("--n-images", type=int, default=512)
    ap.add_argument("--n-pairs", type=int, default=1024)
    ap.add_argument("--redundancy-n", type=int, default=100_000)
    ap.add_argument("--model", default="small", help="backbone preset")
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--skip", default="", help="comma list: text,image,clip,"
                    "redundancy,noise,ingest")
    ap.add_argument("--io-threads", type=int, default=8)
    ap.add_argument("--jpeg-size", type=int, default=512,
                    help="stored resolution of the synthetic ingest JPEGs")
    ap.add_argument("--output", default=str(REPO / "chiprun_out" / "signals_metrics.json"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    return ap.parse_args(argv)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device, *args, **kw):
    """``(result, seconds)`` of ``fn``, host clock to a synchronize."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    _sync(device)
    return out, time.perf_counter() - t0


def device_rate(fn, per_call_docs: int, device, iters: int = 4) -> float:
    """Steady docs/s of ``fn`` on staged inputs: one warm call, then ``iters``."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return per_call_docs * iters / (time.perf_counter() - t0)


def text_device(est, texts: list):
    """``(call, per-call docs, staged means, docs kept)``: ``SUPERBATCH``
    forwards of one staged ``[batch, 256]`` batch and their per-doc
    means and quantiles, as the estimator's ``_score`` computes them.

    The batch is placed by the estimator's ``DataParallel`` (``put``, then
    ``gather`` of the per-token losses), so under a mesh each rank runs its
    slice; without one both are plain copies."""
    import torch

    from dewi_tpu_torch.models.lm import token_nll
    from dewi_tpu_torch.ops.robust import masked_mean_and_quantiles

    bs, dp = est.batch_size, est._dp
    ids, mask = est.tokenizer.encode_batch(texts[:bs], est.cfg.max_len, pad_to=TEXT_PAD)
    ids_t, mask_t = dp.put(ids).long(), dp.put(mask)

    @torch.no_grad()
    def one():
        nll, valid = token_nll(est.model(ids_t, mask_t), ids_t, mask_t)
        return masked_mean_and_quantiles(dp.gather(nll), dp.gather(valid), est._qs)

    def call():
        return [one() for _ in range(SUPERBATCH)]

    kept = np.nonzero(mask.sum(1) < TEXT_PAD)[0]  # not cut at the staged length
    return call, SUPERBATCH * len(ids), one()[0].cpu().numpy(), kept


def image_device(ie, imgs: np.ndarray):
    """``SUPERBATCH`` MAE forwards of one staged batch with the host path's
    first masking noise (seed 0, offset 0), and its per-image means; placed
    by the estimator's ``DataParallel`` as in ``text_device``."""
    import torch

    from dewi_tpu_torch.ops.robust import masked_mean_and_quantiles
    from dewi_tpu_torch.signals.image_entropy import normalize_images

    bs, dp = ie.batch_size, ie._dp
    img_t = dp.put(imgs[:bs])
    noise_t = dp.put(ie._batch_noise(0, 0, bs))
    q90 = torch.tensor([0.9], dtype=torch.float32, device=dp.device)

    @torch.no_grad()
    def one():
        per_patch, pmask = ie.model.patch_losses(normalize_images(img_t), noise=noise_t)
        return masked_mean_and_quantiles(dp.gather(per_patch), dp.gather(pmask), q90)

    def call():
        return [one() for _ in range(SUPERBATCH)]

    return call, SUPERBATCH * len(imgs[:bs]), one()[0].cpu().numpy()


def clip_device(cm, pair_texts: list, pair_imgs: np.ndarray):
    """``SUPERBATCH`` passes of both CLIP towers over one staged batch of
    pairs, and the batch's per-pair cosine; placed by the estimator's
    ``DataParallel`` as in ``text_device``."""
    import torch

    from dewi_tpu_torch.signals.image_entropy import normalize_images

    bs, tl, dp = cm.batch_size, cm.cfg.text_len, cm._dp
    ids, mask = cm.tokenizer.encode_batch(pair_texts[:bs], tl, pad_to=tl)
    ids_t, mask_t = dp.put(ids).long(), dp.put(mask)
    img_t = dp.put(pair_imgs[:bs])

    @torch.no_grad()
    def one():
        return (dp.gather(cm.model.encode_text(ids_t, mask_t)),
                dp.gather(cm.model.encode_image(normalize_images(img_t))))

    def call():
        return [one() for _ in range(SUPERBATCH)]

    t, v = one()
    return call, SUPERBATCH * len(ids), (t * v).sum(dim=1).cpu().numpy()


def ingest_rows(args, rng, metrics: dict, skip: set, device) -> None:
    """The from-JPEG-files image path: naive PIL decode, the port's decode
    pool, the estimator fed files, a packed corpus and the host feed."""
    try:
        from PIL import Image
    except ImportError:
        print("ingest: PIL unavailable, skipped", flush=True)
        return
    import torch

    from dewi_tpu_torch.io import decode_batch
    from dewi_tpu_torch.io.packed import PackedImages, pack_images
    from dewi_tpu_torch.signals import ImageEntropyEstimator

    n_files = min(args.n_images, 512)
    with tempfile.TemporaryDirectory() as td:
        paths = []
        for i in range(n_files):
            arr = (rng.random((args.jpeg_size, args.jpeg_size, 3)) * 255).astype(np.uint8)
            p = Path(td) / f"{i:04d}.jpg"
            Image.fromarray(arr).save(p, quality=90)
            paths.append(str(p))

        def naive_decode():  # the reference's inline decode: full decode + f32
            for p in paths:
                with Image.open(p) as img:
                    np.asarray(img.convert("RGB").resize((args.image_size, args.image_size)),
                               dtype=np.float32)

        _, t_naive = timed(naive_decode, device)
        _, t_one = timed(decode_batch, device, paths, args.image_size, 1)
        _, t_many = timed(decode_batch, device, paths, args.image_size, args.io_threads)
        metrics["ingest_jpeg_px"] = args.jpeg_size
        metrics["ingest_naive_imgs_per_sec"] = round(n_files / t_naive, 1)
        metrics["ingest_draft_imgs_per_sec_1thread"] = round(n_files / t_one, 1)
        metrics[f"ingest_draft_imgs_per_sec_{args.io_threads}threads"] = round(
            n_files / t_many, 1)
        print(f"ingest ({args.jpeg_size}px JPEG -> {args.image_size}): naive "
              f"{n_files / t_naive:,.0f}/s, pool x1 {n_files / t_one:,.0f}/s, "
              f"x{args.io_threads} {n_files / t_many:,.0f}/s", flush=True)
        if "image" in skip:
            return
        ie2 = ImageEntropyEstimator(model_name=args.model, batch_size=64,
                                    image_size=args.image_size, device=device)
        ie2.batch_compute_stats(paths[:128])
        _, t_e2e = timed(ie2.batch_compute_stats, device, paths)
        metrics["image_docs_per_sec_from_files"] = round(n_files / t_e2e, 1)
        pack_path = Path(td) / "corpus.npy"
        _, t_pack = timed(pack_images, device, paths, args.image_size, pack_path)
        metrics["pack_imgs_per_sec"] = round(n_files / t_pack, 1)
        pack = PackedImages(pack_path)
        ie2.batch_compute_stats(pack.data[:128])
        _, t_packed = timed(ie2.batch_compute_stats, device, pack.data)
        metrics["image_docs_per_sec_packed"] = round(n_files / t_packed, 1)

        def feed():
            for s in range(0, len(pack), 64):
                np.ascontiguousarray(pack.data[s:s + 64])

        _, t_feed = timed(feed, device)
        metrics["packed_feed_imgs_per_sec"] = round(n_files / t_feed, 1)
        probe = torch.zeros((64, args.image_size, args.image_size, 3), dtype=torch.uint8)
        timed(lambda: probe.to(device), device)
        _, t_xfer = timed(lambda: probe.to(device), device)
        metrics["host_to_device_MBps_measured"] = round(probe.numel() / t_xfer / 2**20, 1)
        if "image_docs_per_sec_device" in metrics:
            metrics["image_e2e_production_bound_imgs_per_sec"] = round(
                min(n_files / t_feed, metrics["image_docs_per_sec_device"]), 1)


def main(argv=None) -> int:
    args = parse_args(argv)
    skip = set(filter(None, args.skip.split(",")))
    import torch

    from dewi_tpu_torch.signals import (CrossModalDependency, ImageEntropyEstimator,
                                        NoiseEstimator, TextEntropyEstimator)
    from dewi_tpu_torch.signals.redundancy import max_offdiag_similarity
    from dewi_tpu_torch.utils.device import resolve_device
    from dewi_tpu_torch.utils.profiling import card_line, device_name

    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    texts = make_texts(args.n_docs, rng)
    print(f"Device: {device_name(device)}", flush=True)
    metrics: dict = {"model": args.model, "device": device_name(device),
                     "card": card_line() if device.type == "cuda" else "cpu",
                     "superbatch": SUPERBATCH,
                     "assumption": "every doc has text AND an image"}
    per_doc_s = 0.0  # worst-case seconds a document

    if "text" not in skip:
        est = TextEntropyEstimator(model_name=args.model, batch_size=args.batch_size,
                                   max_length=512, device=device)
        est.batch_compute_stats(texts)  # warm: every bucket shape
        _, text_s = timed(est.batch_compute_stats, device, texts)
        host_dps = args.n_docs / text_s
        call, per_call, dev_means, kept = text_device(est, texts)
        dps = device_rate(call, per_call, device)
        host_means = est.batch_compute_stats(texts[:est.batch_size])[0]
        per_doc_s += 1.0 / dps
        metrics["text_docs_per_sec_device"] = round(dps, 1)
        metrics["text_docs_per_sec_host"] = round(host_dps, 1)
        metrics["text_1M_s_single_card"] = round(TARGET_N / dps, 1)
        metrics["text_device_vs_host_max_rel_dev"] = col_dev(dev_means[kept], host_means[kept])
        print(f"text ({args.model}): device {dps:,.0f} docs/s (host path {host_dps:,.0f}) "
              f"-> 1M: {TARGET_N / dps:,.0f}s", flush=True)
        del est

    if "image" not in skip:
        imgs = rng.random((args.n_images, args.image_size, args.image_size, 3)).astype(np.float32)
        ie = ImageEntropyEstimator(model_name=args.model, batch_size=64,
                                   image_size=args.image_size, device=device)
        ie.batch_compute_stats(imgs[:128])
        _, img_s = timed(ie.batch_compute_stats, device, imgs)
        host_dps = args.n_images / img_s
        call, per_call, dev_means = image_device(ie, imgs)
        dps = device_rate(call, per_call, device)
        host_means = ie.batch_compute_stats(imgs[:ie.batch_size])[0]
        per_doc_s += 1.0 / dps
        metrics["image_docs_per_sec_device"] = round(dps, 1)
        metrics["image_docs_per_sec_host"] = round(host_dps, 1)
        metrics["image_1M_s_single_card"] = round(TARGET_N / dps, 1)
        metrics["image_device_vs_host_max_rel_dev"] = col_dev(dev_means, host_means)
        print(f"image ({args.model}): device {dps:,.0f} imgs/s (host path {host_dps:,.0f}) "
              f"-> 1M: {TARGET_N / dps:,.0f}s", flush=True)
        del ie

    if "clip" not in skip:
        cm = CrossModalDependency(model_name=args.model, batch_size=128, device=device)
        pair_texts = texts[:args.n_pairs]
        pair_imgs = rng.random((args.n_pairs, cm.cfg.image_size, cm.cfg.image_size, 3)
                               ).astype(np.float32)
        cm.batch_compute(pair_texts[:256], list(pair_imgs[:256]))  # warm
        _, clip_s = timed(cm.batch_compute, device, pair_texts, list(pair_imgs))
        host_dps = args.n_pairs / clip_s
        call, per_call, dev_cos = clip_device(cm, pair_texts, pair_imgs)
        dps = device_rate(call, per_call, device)
        host_cos = cm.batch_diagonal(pair_texts[:cm.batch_size], pair_imgs[:cm.batch_size])
        per_doc_s += 1.0 / dps
        metrics["clip_pairs_per_sec_device"] = round(dps, 1)
        metrics["clip_pairs_per_sec_host"] = round(host_dps, 1)
        metrics["clip_1M_s_single_card"] = round(TARGET_N / dps, 1)
        metrics["clip_device_vs_host_max_rel_dev"] = col_dev(dev_cos, host_cos)
        print(f"clip ({args.model}): device {dps:,.0f} pairs/s (host path {host_dps:,.0f}) "
              f"-> 1M: {TARGET_N / dps:,.0f}s", flush=True)
        del cm

    if "redundancy" not in skip:
        gen = torch.Generator(device=device).manual_seed(0)
        emb = torch.randn((args.redundancy_n, args.dim), device=device, generator=gen)
        max_offdiag_similarity(emb, block=4096)  # warm
        _, red_s = timed(max_offdiag_similarity, device, emb, 4096)
        red_1m = red_s * (TARGET_N / args.redundancy_n) ** 2
        per_doc_s += red_1m / TARGET_N
        metrics["redundancy_n"] = args.redundancy_n
        metrics["redundancy_s"] = round(red_s, 2)
        metrics["redundancy_s_exact"] = red_s
        metrics["redundancy_1M_s_single_card"] = round(red_1m, 1)
        print(f"redundancy: {args.redundancy_n} docs in {red_s:.3f}s -> 1M: {red_1m:,.0f}s",
              flush=True)
        del emb

    if "noise" not in skip:
        ne = NoiseEstimator(device=device)
        _, noise_s = timed(ne.batch_compute, device, texts=texts, images=[None] * len(texts))
        dps = args.n_docs / noise_s
        per_doc_s += 1.0 / dps
        metrics["noise_docs_per_sec"] = round(dps, 1)
        print(f"noise: {dps:,.0f} docs/s -> 1M: {TARGET_N / dps:,.0f}s", flush=True)

    if "ingest" not in skip:
        ingest_rows(args, rng, metrics, skip, device)

    total_1m_s = per_doc_s * TARGET_N
    metrics["full_signals_1M_s_single_card"] = round(total_1m_s, 1)
    metrics["full_signals_1M_min_single_card"] = round(total_1m_s / 60, 2)
    print(f"FULL SIGNALS 1M docs on one card: {total_1m_s / 60:,.1f} min", flush=True)
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    Path(args.output).write_text(json.dumps(metrics, indent=2))
    print(json.dumps(metrics, indent=2), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
