#!/usr/bin/env python3
"""Warm end-to-end pipeline benchmark of the port: corpus -> signals -> scores -> index.

    python3 scripts/torch_profile_e2e.py --n-docs 16000 [--model small]
    python3 scripts/torch_profile_e2e.py --n-docs 8000 --images --image-size 64 \\
        --clip-image-size 64 --skip-object

Counterpart of ``scripts/profile_e2e.py``: the same arguments (less
``--warm-docs``, plus ``--device``, the card unless ``cpu`` is asked for),
the same corpus
(``make_texts``, seed 0, ``WORDS``; with ``--images`` one random uint8
image a doc) and the same config (``text``/``image``/``cross_modal`` at
``--model``, ``index.ann: quantized``), for both pipeline paths:

* **columnar**: ``process_corpus`` -> ``build_index_corpus``;
* **object**: ``compute_signals`` -> ``compute_dewi_scores`` -> ``build_index``.

Reports warm docs/s of each path with its host-CPU seconds, the speedup,
and the columnar run's per-stage split (``columnar_stage_s``,
``columnar_stage_host_cpu_s``) under the reference's stage names; with
``--images`` the ``upload_overlap`` block (the background upload of the
device-resident images beside the text stage).  Every span ends after
``torch.cuda.synchronize`` (``Timer``), where the reference ends a stage
by fetching a value.  Deliberate differences from the reference's keys:

* ``cold_s_incl_build`` for ``cold_s_incl_compiles``: there is no jit
  here, but the first full-size run still pays the kernel build, cuBLAS's
  warm-up and the allocator's growth;
* ``columnar_extrapolated_1M_min_single_card`` for ``..._single_chip``;
* ``max_rel_dev_object_vs_columnar`` (new): per signal column, the largest
  ``|object - columnar|`` over ``max(|columnar|, 1)`` of the two paths'
  signal matrices on the same docs (``rel_dev_object_vs_columnar``), the
  worst column; ``dewi_rel_dev_object_vs_columnar`` the same for their
  DEWI scores.  It checks the ``Document`` API, a veneer that runs the
  columnar stages on the Documents' columns, so it should read 0;
* ``card``: the card's name and power limit (``nvidia-smi``);
* no ``--warm-docs``: the reference parses it and never reads it (its
  warm-up is the full-size cold run, as here).

Writes ``--output`` (JSON, default under ``chiprun_out/``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

WORDS = (
    "alpha beta gamma delta entropy index corpus signal token image model "
    "robust search weight noise data surprise useful document query"
).split()


def make_texts(n: int, rng) -> list:
    """The reference's corpus: 20-59 words of ``WORDS`` a doc."""
    return [" ".join(rng.choice(WORDS, size=rng.integers(20, 60))) for _ in range(n)]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-docs", type=int, default=30000)
    ap.add_argument("--model", default="small")
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--images", action="store_true",
                    help="attach a synthetic pre-decoded image per doc")
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--clip-image-size", type=int, default=None,
                    help="cross_modal.image_size override (run the CLIP vision "
                         "tower at corpus resolution instead of 224)")
    ap.add_argument("--skip-object", action="store_true",
                    help="measure only the columnar path")
    ap.add_argument("--output", default=str(REPO / "chiprun_out" / "e2e_metrics.json"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    return ap.parse_args(argv)


def config_dict(args) -> dict:
    """The reference's config for these arguments."""
    return {
        "text": {"model": args.model, "batch_size": args.batch_size},
        "image": {"model": args.model, "batch_size": 64, "image_size": args.image_size},
        "cross_modal": {"model": args.model, "batch_size": args.batch_size,
                        "image_size": args.clip_image_size},
        "index": {"ann": "quantized"},
    }


def col_dev(got, want) -> float:
    """Largest ``|got - want|`` over ``max(|want|, 1)``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0)) if want.size else 0.0


class Stages:
    """Named stage spans (a ``Timer``) that end after a synchronize of the
    device, with the host-CPU seconds of each."""

    def __init__(self, device) -> None:
        import torch

        from dewi_tpu_torch.utils.profiling import Timer

        self.timer = Timer()
        self.token = torch.empty(0, device=device)  # Timer syncs its device
        self.cpu_s: dict = {}

    def run(self, name: str, fn, cpu: bool = True):
        out: list = []
        c0 = time.process_time()
        with self.timer.span(name, result=self.token):
            out.append(fn())
        if cpu:
            self.cpu_s[name] = time.process_time() - c0
        return out[0]

    def seconds(self, name: str) -> float:
        return self.timer.spans[name][-1] / 1e3


def main(argv=None) -> int:
    args = parse_args(argv)
    from dewi_tpu_torch.config import DewiConfig
    from dewi_tpu_torch.corpus import COL, Corpus
    from dewi_tpu_torch.io.device_images import DeviceImages
    from dewi_tpu_torch.pipelines import DewiPipeline, create_document
    from dewi_tpu_torch.types import SIGNAL_FIELDS
    from dewi_tpu_torch.utils.device import resolve_device
    from dewi_tpu_torch.utils.profiling import card_line, device_name

    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    n = args.n_docs
    texts = make_texts(n, rng)
    ids = [f"doc{i:08d}" for i in range(n)]
    images = None
    if args.images:
        images = rng.integers(0, 256, (n, args.image_size, args.image_size, 3), dtype=np.uint8)

    metrics: dict = {
        "n_docs": n,
        "preset": args.model,
        "modality": "text+image" if args.images else "text-only",
        "device": device_name(device),
        "card": card_line() if device.type == "cuda" else "cpu",
    }

    def corpus():
        return Corpus(ids=list(ids), texts=list(texts),
                      images=images if images is None else images.copy())

    pipe = DewiPipeline(DewiConfig.from_dict(config_dict(args)), device=device)
    st = Stages(device)

    # ---- cold: one full-size run builds the models and the kernels and warms
    # every batch shape, index capacity and allocator size the warm run uses.
    st.run("cold", lambda: pipe.build_index_corpus(pipe.process_corpus(corpus())), cpu=False)
    t_cold = st.seconds("cold")
    print(f"cold (incl. the build, {n} docs): {t_cold:,.1f} s", flush=True)
    metrics["cold_s_incl_build"] = round(t_cold, 1)

    # ---- columnar warm ------------------------------------------------------
    c = corpus()
    st.run("columnar", lambda: pipe.build_index_corpus(pipe.process_corpus(c)))
    t_col, cpu_col = st.seconds("columnar"), st.cpu_s["columnar"]
    metrics["columnar_warm_s"] = round(t_col, 2)
    metrics["columnar_host_cpu_s"] = round(cpu_col, 2)
    metrics["columnar_docs_per_sec"] = round(n / t_col, 1)
    metrics["columnar_extrapolated_1M_min_single_card"] = round(1e6 / (n / t_col) / 60, 2)
    print(f"columnar: {n / t_col:,.0f} docs/s ({1e6 / (n / t_col) / 60:,.1f} min / 1M docs)",
          flush=True)

    # ---- columnar per-stage breakdown ---------------------------------------
    c2 = corpus()
    tidx = np.nonzero(np.array([bool(t) for t in texts]))[0]
    te = pipe.text_entropy
    tok = te.tokenizer
    encode = tok.encode_batch_u16 if hasattr(tok, "encode_batch_u16") else tok.encode_batch
    st.run("tokenize_only", lambda: encode(texts, te.cfg.max_len, pad_to=te.cfg.max_len),
           cpu=False)
    means, q90s, _ = st.run("text_entropy", lambda: te.batch_compute_stats(texts))
    c2.signals[tidx, COL["ht_mean"]] = means[tidx]
    c2.signals[tidx, COL["ht_q90"]] = q90s[tidx]
    # The real columnar path's one device-resident upload, which the stages
    # then slice (io/device_images.py); None keeps the host arrays.
    dev = None
    if images is not None:
        def upload():
            d = pipe._device_corpus(c2, non_blocking=True)
            if d is not None:
                d[0].base  # waits for the background copy
            return d

        dev = st.run("device_upload", upload, cpu=False)
    dev_imgs = dev[0] if dev is not None else images
    if images is not None:
        m2, q2 = st.run("image_entropy", lambda: pipe.image_entropy.batch_compute_stats(dev_imgs))
        c2.signals[:, COL["hi_mean"]] = m2
        c2.signals[:, COL["hi_q90"]] = q2
    # The towers encode once on the columnar path (I_hat and the embeddings
    # share them); time them as the pipeline runs them.
    t_emb = st.run("clip_text_encode", lambda: pipe.cross_modal.encode_texts(texts))
    v_emb = None
    if images is not None:
        v_emb = st.run("clip_image_encode", lambda: pipe.cross_modal.encode_images(dev_imgs),
                       cpu=False)
        c2.signals[:, COL["I_hat"]] = np.sum(t_emb * v_emb, axis=1)
    st.run("embeddings", lambda: pipe.ensure_embeddings_corpus(c2, _t_emb=t_emb, _v_emb=v_emb),
           cpu=False)
    st.run("redundancy", lambda: pipe._redundancy_corpus(c2))
    st.run("noise", lambda: pipe._noise_corpus(c2, dev=dev))
    scorer = pipe._make_scorer()
    c2.dewi = st.run("score", lambda: scorer.fit_and_score(c2.signals, mode="standard")
                     .cpu().numpy(), cpu=False)
    st.run("index_build", lambda: pipe.build_index_corpus(c2), cpu=False)
    names = ("tokenize_only", "text_entropy", "device_upload", "image_entropy",
             "clip_text_encode", "clip_image_encode", "embeddings", "redundancy", "noise",
             "score", "index_build")
    metrics["columnar_stage_s"] = {k: round(st.seconds(k), 2) for k in names
                                   if k in st.timer.spans}
    metrics["columnar_stage_host_cpu_s"] = {k: round(v, 2) for k, v in st.cpu_s.items()
                                            if k in names}
    print("stage breakdown:", metrics["columnar_stage_s"], flush=True)
    print("stage host-CPU:", metrics["columnar_stage_host_cpu_s"], flush=True)

    # ---- upload/compute overlap: the upload alone, then issued in the
    # background ahead of the text stage; what is left to wait for after the
    # text stage is the part the text stage did not hide.
    if images is not None:
        st.run("upload_alone", lambda: DeviceImages(images.copy(), device=device,
                                                    non_blocking=True).base, cpu=False)
        di2 = DeviceImages(images.copy(), device=device, non_blocking=True)
        st.run("text_during_upload", lambda: te.batch_compute_stats(texts), cpu=False)
        st.run("upload_residual", lambda: di2.base, cpu=False)
        t_alone, t_resid = st.seconds("upload_alone"), st.seconds("upload_residual")
        metrics["upload_overlap"] = {
            "upload_alone_s": round(t_alone, 2),
            "text_stage_during_upload_s": round(st.seconds("text_during_upload"), 2),
            "upload_residual_after_text_s": round(t_resid, 2),
            "hidden_fraction": round(max(0.0, 1.0 - t_resid / max(t_alone, 1e-9)), 3),
        }
        print("upload overlap:", metrics["upload_overlap"], flush=True)

    # ---- object-path comparison ---------------------------------------------
    if not args.skip_object:
        docs = [create_document(ids[i], text=texts[i],
                                image=None if images is None else images[i])
                for i in range(n)]

        def run_object():
            d2 = pipe.compute_dewi_scores(pipe.compute_signals(docs))
            pipe.build_index(d2)

        st.run("object", run_object)
        t_obj, cpu_obj = st.seconds("object"), st.cpu_s["object"]
        metrics["object_warm_s"] = round(t_obj, 2)
        metrics["object_host_cpu_s"] = round(cpu_obj, 2)
        metrics["object_docs_per_sec"] = round(n / t_obj, 1)
        metrics["columnar_speedup_vs_object"] = round(t_obj / t_col, 2)
        metrics["columnar_host_cpu_speedup_vs_object"] = round(cpu_obj / max(cpu_col, 1e-9), 2)
        obj = np.array([[float(getattr(d, k) or 0.0) for k in SIGNAL_FIELDS] for d in docs])
        devs = {k: col_dev(obj[:, j], c.signals[:, j]) for j, k in enumerate(SIGNAL_FIELDS)}
        metrics["rel_dev_object_vs_columnar"] = devs
        metrics["max_rel_dev_object_vs_columnar"] = max(devs.values())
        metrics["dewi_rel_dev_object_vs_columnar"] = col_dev([d.dewi_score for d in docs],
                                                             c.dewi)
        print(f"object: {n / t_obj:,.0f} docs/s; columnar speedup {t_obj / t_col:,.2f}x wall, "
              f"{cpu_obj / max(cpu_col, 1e-9):,.2f}x host-CPU; max rel dev "
              f"{metrics['max_rel_dev_object_vs_columnar']:.3g}", flush=True)

    metrics["note"] = (
        "Warm = after one full-size run that builds the models and kernels. Full "
        "library path: signals (LM surprisal [+ MAE + CLIP diagonal] + CLIP "
        "embeddings + redundancy + noise) -> fused fit+score -> "
        "build_index(quantized). Every stage span ends after a device synchronize."
    )
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    Path(args.output).write_text(json.dumps(metrics, indent=2))
    print(json.dumps(metrics, indent=2), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
