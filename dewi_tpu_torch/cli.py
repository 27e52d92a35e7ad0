"""Command line of the port: ``python -m dewi_tpu_torch <command>``.

Counterpart of ``dewi_tpu/cli.py`` (click there, ``argparse`` here, so that
a machine with only PyTorch and numpy runs it): the eight commands
``config | process | search | serve | pack-images | import-weights |
sample | eval`` with the reference's arguments, options, defaults,
messages, artifacts and exit codes (1 for a command's error, 2 for a usage
error), and the ``DEWI_TEST_MODE`` fake mode.

Device: the top-level ``--device`` (default ``cuda``) places every command
that touches a model or an index; without a CUDA device ``cuda`` raises, as
the library's ``device=None`` does.  ``process --device`` is the
reference's own flag and, given, overrides the top-level one.

Where the port differs from the reference CLI:

* ``process`` ends with an error (exit 1) when the index build fails; the
  reference prints a warning and exits 0, which on the card would hide a
  kernel that did not build or launch;
* a text query needs the index's encoder provenance to name a CLIP
  checkpoint (:func:`dewi_tpu_torch.serve.query_encoder_for_index`); the
  reference rebuilds a seed-only encoder, or guesses a preset from the dim;
* ``config`` writes YAML with its own emitter (the very text
  ``yaml.dump(..., default_flow_style=False, sort_keys=False)`` writes),
  and a config file is read with PyYAML where it is installed and as JSON
  (a subset of YAML) where it is not.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import signal
import sys
import uuid
from datetime import datetime
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

PROG = "dewi-tpu-torch"
VERSION = "0.1.0"
PRESETS = ("default", "web", "product", "balanced")
TEXT_EXTS = (".txt", ".md", ".json", ".jsonl")
IMAGE_GLOBS = ("**/*.jpg", "**/*.jpeg", "**/*.png")


class CliError(Exception):
    """A command's error: printed as ``Error: <message>``, exit code 1."""


def _test_mode() -> bool:
    return os.getenv("DEWI_TEST_MODE", "").lower() in ("1", "true", "yes")


def echo(msg: str = "", err: bool = False) -> None:
    print(msg, file=sys.stderr if err else sys.stdout, flush=True)


# ---------------------------------------------------------------------------
# config files: a YAML emitter for the config tree, and the reader
# ---------------------------------------------------------------------------

# PyYAML's implicit resolvers (YAML 1.1): a plain scalar matching one of
# these would not read back as a string, so such a string is quoted.
_IMPLICIT = re.compile(r"""^(?:
    yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF
  | ~|null|Null|NULL
  | [-+]?0b[0-1_]+ | [-+]?0[0-7_]+ | [-+]?(?:0|[1-9][0-9_]*) | [-+]?0x[0-9a-fA-F_]+
  | [-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+
  | [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)? | \.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
  | [-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]* | [-+]?\.(?:inf|Inf|INF) | \.(?:nan|NaN|NAN)
  | [0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?.* | <<|=
)$""", re.X)
_INDICATORS = set(",[]{}#&*!|>'\"%@`")
_ESCAPES = {"\0": "0", "\a": "a", "\b": "b", "\t": "t", "\n": "n", "\v": "v", "\f": "f",
            "\r": "r", "\x1b": "e", '"': '"', "\\": "\\", "\x85": "N", "\xa0": "_",
            "\u2028": "L", "\u2029": "P"}


def _yaml_double_quoted(s: str) -> str:
    """PyYAML's double-quoted style without ``allow_unicode``."""
    out = []
    for c in s:
        if c in _ESCAPES:
            out.append("\\" + _ESCAPES[c])
        elif " " <= c <= "~":
            out.append(c)
        elif ord(c) <= 0xFF:
            out.append(f"\\x{ord(c):02X}")
        elif ord(c) <= 0xFFFF:
            out.append(f"\\u{ord(c):04X}")
        else:
            out.append(f"\\U{ord(c):08X}")
    return '"' + "".join(out) + '"'


def _yaml_str(s: str) -> str:
    if any(not (" " <= c <= "~") for c in s):
        return _yaml_double_quoted(s)
    lead_ok = s[:1] not in _INDICATORS and not (s[:1] in "-?:" and s[1:2] in ("", " "))
    plain = (s and s == s.strip() and lead_ok and not s.startswith(("---", "..."))
             and ": " not in s and " #" not in s and not s.endswith(":")
             and not _IMPLICIT.match(s))
    return s if plain else "'" + s.replace("'", "''") + "'"


def _yaml_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        return text.replace("e", ".0e", 1) if "." not in text and "e" in text else text
    if isinstance(v, str):
        return _yaml_str(v)
    raise TypeError(f"no YAML form for {type(v).__name__}")


def _yaml_lines(v: Any, indent: int) -> List[str]:
    pad = " " * indent
    lines: List[str] = []
    if isinstance(v, dict):
        for k, x in v.items():
            key = _yaml_scalar(k)
            if isinstance(x, dict) and x:
                lines += [f"{pad}{key}:", *_yaml_lines(x, indent + 2)]
            elif isinstance(x, (list, tuple)) and x:
                lines += [f"{pad}{key}:", *_yaml_lines(list(x), indent)]
            else:
                lines.append(f"{pad}{key}: {_yaml_inline(x)}")
    else:
        for x in v:
            if isinstance(x, dict) and x:
                sub = _yaml_lines(x, indent + 2)
                lines += [f"{pad}- {sub[0].lstrip()}", *sub[1:]]
            elif isinstance(x, (list, tuple)) and x:
                sub = _yaml_lines(list(x), indent + 2)
                lines += [f"{pad}- {sub[0].lstrip()}", *sub[1:]]
            else:
                lines.append(f"{pad}- {_yaml_inline(x)}")
    return lines


def _yaml_inline(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _yaml_scalar(v)


def yaml_dump(tree: dict) -> str:
    """Block-style YAML of a plain config tree (nested dicts, lists, str,
    int, float, bool, None), as ``yaml.dump(tree, default_flow_style=False,
    sort_keys=False)`` writes it."""
    return "\n".join(_yaml_lines(tree, 0)) + "\n" if tree else "{}\n"


def load_config_file(path: Any) -> dict:
    """A config file's tree: ``yaml.safe_load`` where PyYAML is installed,
    else JSON (which is YAML too); other YAML without PyYAML is an error
    that names it."""
    text = Path(path).read_text(encoding="utf-8")
    try:
        import yaml
    except ImportError:
        if not text.strip():
            return {}
        try:
            return json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(
                f"{path} is not JSON, and PyYAML (pip package pyyaml), which "
                f"reads YAML, is not installed: {e}") from None
    return yaml.safe_load(text) or {}


# ---------------------------------------------------------------------------
# argument types
# ---------------------------------------------------------------------------


def _path_type(exists: bool = False, file_okay: bool = True,
               dir_okay: bool = True) -> Callable[[str], str]:
    def check(value: str) -> str:
        p = Path(value)
        if exists and not p.exists():
            raise argparse.ArgumentTypeError(f"Path '{value}' does not exist.")
        if p.exists() and not file_okay and p.is_file():
            raise argparse.ArgumentTypeError(f"Path '{value}' is a file.")
        if p.exists() and not dir_okay and p.is_dir():
            raise argparse.ArgumentTypeError(f"Path '{value}' is a directory.")
        return value
    return check


def _device(args: argparse.Namespace) -> Any:
    from .utils.device import resolve_device

    return resolve_device(args.global_device)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


def cmd_config(args: argparse.Namespace) -> int:
    """Generate a configuration file."""
    from .config import apply_preset, get_default_config

    cfg = apply_preset(get_default_config(), args.preset)
    text = yaml_dump(cfg.to_dict())
    if args.output:
        path = Path(args.output)
        if path.exists() and not args.overwrite:
            echo(f"Error: File {args.output} already exists. Use --overwrite to replace it.",
                 err=True)
            return 1
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text, encoding="utf-8")
        echo(f"Configuration saved to {path}")
    else:
        echo("# DEWI-TPU Configuration")
        echo(f"# Preset: {args.preset}\n")
        echo(text)
    return 0


# ---------------------------------------------------------------------------
# process
# ---------------------------------------------------------------------------


def cmd_process(args: argparse.Namespace) -> int:
    """Compute DEWI signals + scores for a corpus and write artifacts."""
    try:
        from contextlib import nullcontext

        from .config import DewiConfig
        from .pipelines import DewiPipeline, _StageCheckpoint
        from .utils.device import resolve_device
        from .utils.profiling import reset_trace_stats, torch_trace, trace_stats, write_metrics

        out = Path(args.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        cfg = DewiConfig.from_dict(load_config_file(args.config_path))
        if args.batch_size:
            cfg.text.batch_size = args.batch_size
            cfg.image.batch_size = args.batch_size
            cfg.cross_modal.batch_size = args.batch_size
        if args.delta is not None:
            cfg.scoring.delta = float(args.delta)
        if args.mode is not None:
            cfg.scoring.mode = args.mode

        documents = _load_documents(args.texts, args.images, args.embeddings,
                                    max_workers=cfg.runtime.io_threads)
        if not documents:
            raise CliError("No documents to process. Provide --texts and/or --images")
        echo(f"Processing {len(documents)} documents...")

        if _test_mode():
            _save_results(None, out)  # fabricates mock artifacts
            echo(f"✓ Processed {len(documents)} documents. Results saved to {out}")
            return 0

        device = resolve_device(args.device or args.global_device)
        pipeline = DewiPipeline(cfg, device=device)
        # Shard when asked (--shard-size), when periodic checkpoints are
        # configured (runtime.checkpoint_every docs between flushes), or when
        # the corpus exceeds runtime.shard_size.
        shard_size, checkpoint_dir = args.shard_size, args.checkpoint_dir
        if not shard_size and cfg.runtime.checkpoint_every > 0:
            shard_size = cfg.runtime.checkpoint_every
            if checkpoint_dir is None:
                checkpoint_dir = str(out / "checkpoints")
        if not shard_size and len(documents) > cfg.runtime.shard_size:
            shard_size = cfg.runtime.shard_size

        trace = torch_trace(str(out / "profile")) if cfg.runtime.profile else nullcontext()
        reset_trace_stats()
        with trace:
            # Signals, scores and the index flow as arrays; the Documents get
            # the results back for the artifacts.
            corpus = _as_corpus(documents, args.texts, args.images, args.embeddings)
            if shard_size:
                # Sharded stream: per-shard signals with resume, global
                # redundancy, one fused fit-and-score.
                pipeline.process_stream_corpus(
                    corpus, shard_size=shard_size, progress=True,
                    checkpoint_dir=checkpoint_dir,
                    delta=cfg.scoring.delta, mode=cfg.scoring.mode)
            else:
                # With --checkpoint-dir: stage checkpoints keyed to the
                # Documents' digest, the reference's format.
                pipeline.process_corpus(
                    corpus, delta=cfg.scoring.delta, mode=cfg.scoring.mode, progress=True,
                    _ckpt=_StageCheckpoint(checkpoint_dir, documents, pipeline.mesh))
        docs = corpus.apply_to_documents(documents)
        if cfg.runtime.profile:
            write_metrics(trace_stats(), out / "profile" / "spans.json")
            echo(f"✓ torch.profiler trace written to {out / 'profile'} (spans in spans.json)")
        _save_results(docs, out)
        index = pipeline.build_index_corpus(corpus)
        index.save(out / "index")
        echo(f"✓ Index saved to {out / 'index'}")
        echo(f"✓ Processed {len(docs)} documents. Results saved to {out}")
        return 0
    except CliError:
        raise
    except Exception as e:  # noqa: BLE001 — any failure is the command's error
        if _test_mode():
            import traceback

            traceback.print_exc()
        raise CliError(f"Error during processing: {e}") from e


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def cmd_search(args: argparse.Namespace) -> int:
    """Search a DEWI index with a text query or a ``.npy`` vector."""
    fake = args.test_mode or _test_mode()
    # The reference CLI's search defaults.
    eta = 0.5 if args.eta is None else args.eta
    entropy_pref = 1.0 if args.entropy_pref is None else args.entropy_pref
    query = args.query
    try:
        import numpy as np

        from .index import DewiIndex

        echo(f"Searching for '{query}'...")
        if fake:
            results: Sequence[Any] = [
                (f"doc_{i}", 0.9 - 0.05 * i,
                 {"dewi": 0.8 - 0.04 * i, "ht_mean": 0.5, "hi_mean": 0.4})
                for i in range(min(args.k, 5))
            ]
        else:
            index = DewiIndex.load(args.index_dir, device=_device(args))
            if query.endswith(".npy") and Path(query).exists():
                qvec = np.load(query).astype(np.float32).reshape(-1)
            else:
                qvec = _encode_query_text(query, index)
            results = index.search(qvec, k=args.k, eta=eta, entropy_pref=entropy_pref)

        formatted: List[Dict[str, Any]] = []
        for doc_id, score, payload in results:
            p = payload.to_dict() if hasattr(payload, "to_dict") else dict(payload)
            formatted.append({
                "id": doc_id,
                "score": float(score),
                "dewi_score": p.get("dewi"),
                "entropy": (p.get("ht_mean", 0.0) + p.get("hi_mean", 0.0)) / 2,
                "metadata": {},
                "text": "",
            })
        if not formatted:
            echo("No results found.")
            return 0
        blob = json.dumps(formatted, indent=2)
        if args.output:
            path = Path(args.output)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(blob, encoding="utf-8")
            echo(f"✓ Results saved to {path}")
        else:
            echo(blob)
        if fake:
            echo("\n[TEST MODE] Results are simulated")
        return 0
    except Exception as e:  # noqa: BLE001
        echo(f"Error during search: {e}", err=True)
        if fake:
            import traceback

            traceback.print_exc()
        return 1


_QUERY_ENCODERS: Dict[str, Any] = {}  # keyed by provenance and device (eval reuses one)


def _encode_query_text(query: str, index: Any) -> Any:
    """Text -> query embedding through the CLIP text tower the index's
    embeddings came from (its recorded provenance)."""
    return _query_encoder_for_index(index).encode_texts([query])[0]


def _query_encoder_for_index(index: Any) -> Any:
    """The index's query encoder, built once per provenance and device.
    Refusals (no provenance, external embeddings, no or a missing
    checkpoint) are the command's error."""
    from .serve import query_encoder_for_index

    key = json.dumps([getattr(index, "encoder", None), str(index.device)],
                     sort_keys=True, default=str)
    enc = _QUERY_ENCODERS.get(key)
    if enc is None:
        try:
            enc = query_encoder_for_index(index)
        except ValueError as e:
            raise CliError(str(e)) from None
        _QUERY_ENCODERS[key] = enc
    return enc


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------


def cmd_serve(args: argparse.Namespace) -> int:
    """Serve a DEWI index over HTTP with micro-batched device dispatch.

    Endpoints: POST /search {"text"|"vector", "k", "eta", "entropy_pref"},
    POST /search_batch {"queries": [...]}, GET /healthz.
    """
    from .index import DewiIndex
    from .serve import SearchServer, retier_index

    index = DewiIndex.load(args.index_dir, device=_device(args))
    if args.backend is not None:
        was = type(index._backend).__name__
        index = retier_index(index, args.backend)
        if type(index._backend).__name__ != was:
            echo(f"Re-tiered {was} -> {args.backend}")
    server = SearchServer(index, host=args.host, port=args.port,
                          window_ms=args.window_ms, max_batch=args.max_batch)

    def stop(signum: int, frame: Any) -> None:
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, stop)
    echo(f"Serving {len(index)} docs (dim {index.dim}) on "
         f"http://{args.host}:{server.port} — Ctrl-C to stop")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        echo("Shutting down.")
        server.shutdown()
    return 0


# ---------------------------------------------------------------------------
# pack-images, import-weights
# ---------------------------------------------------------------------------


def cmd_pack_images(args: argparse.Namespace) -> int:
    """Pre-decode an image directory into a packed mmap corpus.

    One offline decode pass writes OUT_PATH (.npy uint8 [N, size, size, 3])
    plus a .json sidecar; ``process --images OUT_PATH`` then reads the corpus
    with no decode at run time (the file is memory-mapped).
    """
    from .io.packed import pack_images
    from .utils.progress import ProgressMeter

    p = Path(args.images_dir)
    image_files: List[Path] = []
    for pattern in IMAGE_GLOBS:
        image_files.extend(sorted(p.glob(pattern)))
    if not image_files:
        raise CliError(f"No images found under {args.images_dir}")
    meter = ProgressMeter(len(image_files), "pack", enabled=True)
    meta = pack_images([str(f) for f in image_files], args.size, args.out_path,
                       workers=args.workers, progress=meter.update)
    meter.close()
    # Row order is the sorted file order; the manifest maps rows to files.
    manifest = Path(str(args.out_path) + ".manifest.json")
    manifest.write_text(json.dumps([str(f) for f in image_files]))
    echo(json.dumps({**meta, "out": str(args.out_path), "manifest": str(manifest)}))
    return 0


def cmd_import_weights(args: argparse.Namespace) -> int:
    """Convert an HF checkpoint (local dir or cached hub name) to a
    checkpoint that the config's ``checkpoint:`` fields load.

    Example: import-weights gpt2 gpt2.msgpack --kind gpt2, then set
    text: {model: gpt2, tokenizer: gpt2, checkpoint: gpt2.msgpack}.
    """
    from .models.import_hf import convert_pretrained

    try:
        info = convert_pretrained(args.source, args.kind, args.out_path, device=_device(args))
    except ImportError as e:
        raise CliError(f"torch/transformers required: {e}") from None
    except Exception as e:  # noqa: BLE001
        raise CliError(f"Conversion failed: {e}") from None
    echo(f"✓ Imported {args.kind} weights from {args.source} -> {args.out_path}")
    echo(json.dumps(info))
    return 0


# ---------------------------------------------------------------------------
# sample
# ---------------------------------------------------------------------------


def cmd_sample(args: argparse.Namespace) -> int:
    """Select K training docs from a ``process`` output directory:
    p(doc) ∝ DEWI^tau, or a facility-location coverage pick with
    --submodular, over the saved signals summary and embeddings."""
    import numpy as np

    from .sampling import training_sample

    pdir = Path(args.processed_dir)
    summary_path = pdir / "signals_summary.json"
    if not summary_path.exists():
        raise CliError(f"No signals_summary.json in {pdir}")
    summary = json.loads(summary_path.read_text(encoding="utf-8"))
    ids = [str(r["id"]) for r in summary]
    dewi = np.array([float(r.get("dewi_score") or 0.0) for r in summary], np.float32)

    embeddings = None
    if args.submodular:
        by_id = {}
        for npz in sorted(pdir.glob("embeddings*.npz")):
            data = np.load(npz, allow_pickle=True)
            for d, e in zip(data["doc_ids"], data["embeddings"]):
                by_id[str(d)] = np.asarray(e, np.float32)
        missing = [i for i in ids if i not in by_id]
        if missing:
            raise CliError(f"--submodular needs embeddings for every doc "
                           f"({len(missing)} missing)")
        embeddings = np.stack([by_id[i] for i in ids])

    picks = training_sample(dewi, embeddings, k=min(args.k, len(ids)), tau=args.tau,
                            use_submodular=args.submodular, seed=args.seed,
                            device=_device(args))
    selected = [ids[int(i)] for i in picks]
    if args.output:
        Path(args.output).write_text("\n".join(selected) + "\n", encoding="utf-8")
        echo(f"✓ {len(selected)} doc ids saved to {args.output}")
    else:
        for doc_id in selected:
            echo(doc_id)
    return 0


# ---------------------------------------------------------------------------
# eval
# ---------------------------------------------------------------------------


def cmd_eval(args: argparse.Namespace) -> int:
    """Run the EvalConfig metric suite against a saved index.

    QUERIES: ``.npz`` with ``query_ids`` + ``embeddings`` arrays (or
    ``texts`` to encode with the CLIP text tower, one at a time).  QRELS:
    JSON mapping query id -> list of relevant doc ids.
    """
    import numpy as np

    from .config import DewiConfig
    from .eval import evaluate_index
    from .index import DewiIndex

    cfg = None
    if args.config_path:
        cfg = DewiConfig.from_dict(load_config_file(args.config_path)).eval
    index = DewiIndex.load(args.index_dir, device=_device(args))
    data = np.load(args.queries, allow_pickle=True)
    qids = [str(q) for q in data["query_ids"]]
    if "embeddings" in data:
        qvecs = np.asarray(data["embeddings"], np.float32)
    elif "texts" in data:
        qvecs = np.stack([_encode_query_text(str(t), index) for t in data["texts"]])
    else:
        raise CliError("queries npz needs embeddings or texts")
    with open(args.qrels, encoding="utf-8") as f:
        ground_truth = json.load(f)
    report = evaluate_index(index, qvecs, ground_truth, query_ids=qids, config=cfg,
                            eta=args.eta, entropy_pref=args.entropy_pref)
    blob = json.dumps(report, indent=2)
    if args.output:
        Path(args.output).write_text(blob, encoding="utf-8")
        echo(f"✓ Report saved to {args.output}")
    else:
        echo(blob)
    return 0


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def create_document(text: Optional[str] = None, metadata: Optional[Dict] = None) -> Any:
    """A :class:`~dewi_tpu_torch.pipelines.Document` with a uuid4 id and a
    loose ``metadata`` attribute."""
    from .pipelines import Document

    doc = Document(doc_id=str(uuid.uuid4()), text=text)
    doc.metadata = metadata or {}  # type: ignore[attr-defined]
    return doc


def _load_documents(texts_path: Optional[str], images_dir: Optional[str],
                    embeddings_path: Optional[str], max_workers: int = 4) -> List[Any]:
    """Documents from text files (read on a thread pool), an image directory
    or a packed image corpus, and an embeddings archive: text-only,
    image-only and embedding-only documents, in that order."""
    if _test_mode():
        return [create_document(text=f"Test document {i}", metadata={"test": True, "id": i})
                for i in range(5)]

    from concurrent.futures import ThreadPoolExecutor

    documents: List[Any] = []
    if texts_path:
        p = Path(texts_path)
        files: List[Path] = []
        if p.is_file() and p.suffix.lower() in TEXT_EXTS:
            files.append(p)
        elif p.is_dir():
            for ext in TEXT_EXTS:
                files.extend(sorted(p.glob(f"**/*{ext}")))

        def read_one(fp: Path) -> Any:
            try:
                content = fp.read_text(encoding="utf-8", errors="replace")
                return create_document(text=content,
                                       metadata={"source": str(fp), "type": "text"})
            except Exception as e:  # noqa: BLE001
                echo(f"Error reading {fp}: {e}", err=True)
                return None

        with ThreadPoolExecutor(max_workers=max_workers) as ex:
            documents.extend(d for d in ex.map(read_one, files) if d is not None)

    if images_dir:
        from .io.packed import PackedImages, is_packed_corpus

        p = Path(images_dir)
        if is_packed_corpus(p):
            # Every document's image is a row view of the mapping: no decode.
            pack = PackedImages(p)
            manifest = Path(str(p) + ".manifest.json")
            names = json.loads(manifest.read_text()) if manifest.exists() else None
            for i in range(len(pack)):
                src = names[i] if names else f"{p}[{i}]"
                doc = create_document(text=None, metadata={"source": src, "type": "image"})
                doc.image = pack[i]
                documents.append(doc)
        else:
            image_files: List[Path] = []
            for pattern in IMAGE_GLOBS:
                image_files.extend(sorted(p.glob(pattern)))
            for img in image_files:
                doc = create_document(text=None,
                                      metadata={"source": str(img), "type": "image"})
                doc.image_path = str(img)
                documents.append(doc)

    if embeddings_path:
        import numpy as np

        try:
            data = np.load(embeddings_path, allow_pickle=True)
            if "embeddings" in data and "doc_ids" in data:
                for emb, doc_id in zip(data["embeddings"], data["doc_ids"]):
                    doc = create_document(text=None, metadata={"source": str(doc_id),
                                                                "type": "embedding"})
                    doc.embedding = np.asarray(emb, dtype=np.float32)
                    documents.append(doc)
        except Exception as e:  # noqa: BLE001
            echo(f"Error loading embeddings from {embeddings_path}: {e}", err=True)
    return documents


def _as_corpus(documents: Any, texts: Any, images: Any, embeddings: Any) -> Any:
    """Columnarize the loaded documents.  A pure packed-image corpus hands
    the pipeline the mapping itself, not per-doc row views, so the signal
    stages slice it (and upload it to the card) whole."""
    import numpy as np

    from .corpus import Corpus
    from .io.packed import PackedImages, is_packed_corpus

    corpus = Corpus.from_documents(documents)
    if images and not texts and not embeddings and is_packed_corpus(images):
        pack = PackedImages(images)
        if len(pack) == len(corpus):
            corpus.images = pack
            corpus.has_image = np.ones(len(corpus), bool)
    return corpus


def _save_results(documents: Any, output_dir: Path, batch_size: int = 1000) -> None:
    """Batched JSONL, npz, ``signals_summary.json`` and ``metadata.json``,
    after a timestamped backup of a non-empty output directory."""
    import numpy as np

    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    if any(out.iterdir()):
        ts = datetime.now().strftime("%Y%m%d_%H%M%S")
        backup = out.parent / f"{out.name}_backup_{ts}"
        shutil.copytree(out, backup)
        echo(f"Created backup of existing output at {backup}")

    if _test_mode() or documents is None:
        docs = [
            {
                "id": f"doc_{i}",
                "text": f"Test document {i} content.",
                "metadata": {"source": "test", "id": i, "type": "test"},
                "signals": {
                    "ht_mean": round(0.5 + i * 0.1, 4),
                    "hi_mean": round(0.4 + i * 0.05, 4),
                    "I_hat": round(0.3 + i * 0.02, 4),
                    "redundancy": round(0.1 + i * 0.01, 4),
                    "noise": round(0.05 + i * 0.005, 4),
                },
                "dewi_score": round(0.7 - i * 0.05, 4),
                "embedding": [round(0.1 * (i + 1), 4)] * 10,
            }
            for i in range(10)
        ]
        with open(out / "documents_batch_0001.jsonl", "w", encoding="utf-8") as f:
            for d in docs:
                f.write(json.dumps(d, ensure_ascii=False) + "\n")
        with open(out / "signals_summary.json", "w", encoding="utf-8") as f:
            json.dump([{"id": d["id"], **d["signals"], "dewi_score": d["dewi_score"]}
                       for d in docs], f, indent=2)
        np.savez_compressed(out / "embeddings.npz",
                            embeddings=np.array([d["embedding"] for d in docs], np.float32),
                            doc_ids=[d["id"] for d in docs])
        (out / "index").mkdir(exist_ok=True)
        (out / "index" / "config.json").write_text(
            json.dumps({"test_mode": True, "dim": 10}), encoding="utf-8")
        (out / "metadata.json").write_text(json.dumps({
            "version": "1.0.0",
            "created_at": datetime.now().isoformat(),
            "num_documents": len(docs),
            "dimensions": 10,
            "test_mode": True,
        }, indent=2), encoding="utf-8")
        return

    signals_summary: List[Dict[str, Any]] = []
    n_batches = (len(documents) + batch_size - 1) // batch_size
    for b in range(n_batches):
        batch = documents[b * batch_size:(b + 1) * batch_size]
        rows = []
        embs, ids = [], []
        for d in batch:
            sig = d.signals_dict()
            rows.append({"id": d.doc_id, "text": d.text,
                         "metadata": getattr(d, "metadata", {}), "signals": sig,
                         "dewi_score": d.dewi_score})
            if d.embedding is not None:
                ids.append(d.doc_id)
                embs.append(np.asarray(d.embedding, np.float32))
            signals_summary.append({"id": d.doc_id, **sig, "dewi_score": d.dewi_score})
        with open(out / f"documents_batch_{b + 1:04d}.jsonl", "w", encoding="utf-8") as f:
            for row in rows:
                f.write(json.dumps(row, ensure_ascii=False) + "\n")
        if embs:
            np.savez_compressed(out / f"embeddings_batch_{b + 1:04d}.npz",
                                doc_ids=ids, embeddings=np.stack(embs))
        echo(f"Processed batch {b + 1}/{n_batches} ({len(batch)} documents)")

    with open(out / "signals_summary.json", "w", encoding="utf-8") as f:
        json.dump(signals_summary, f, indent=2, ensure_ascii=False)
    dims = (len(documents[0].embedding)
            if documents and documents[0].embedding is not None else 0)
    (out / "metadata.json").write_text(json.dumps({
        "version": "1.0.0",
        "created_at": datetime.now().isoformat(),
        "num_documents": len(documents),
        "dimensions": dims,
        "test_mode": False,
    }, indent=2), encoding="utf-8")


# ---------------------------------------------------------------------------
# parser and entry point
# ---------------------------------------------------------------------------


class _Parser(argparse.ArgumentParser):
    """Usage errors exit 2 with the usage line, as click's do."""

    def error(self, message: str) -> None:  # type: ignore[override]
        self.print_usage(sys.stderr)
        self.exit(2, f"Error: {message}\n")


def build_parser() -> argparse.ArgumentParser:
    ap = _Parser(prog=PROG, description="DEWI: entropy-weighted index for text+image "
                                        "corpora; the PyTorch/CUDA port.")
    ap.add_argument("--version", action="version", version=f"{PROG}, version {VERSION}")
    ap.add_argument("--device", dest="global_device", default="cuda",
                    help="Device of every command (default: cuda; raises without one)")
    sub = ap.add_subparsers(dest="command", metavar="COMMAND", parser_class=_Parser)
    sub.required = True

    p = sub.add_parser("config", help="Generate a configuration file")
    p.add_argument("--output", "-o", help="Output config file path")
    p.add_argument("--overwrite", action="store_true",
                   help="Overwrite output file if it exists")
    p.add_argument("--preset", choices=PRESETS, default="default",
                   help="Configuration preset")
    p.set_defaults(func=cmd_config)

    p = sub.add_parser("process", help="Compute DEWI signals + scores for a corpus")
    p.add_argument("config_path", type=_path_type(exists=True, dir_okay=False))
    p.add_argument("output_dir", type=_path_type(file_okay=False))
    p.add_argument("--texts", type=_path_type(exists=True),
                   help="Text file or directory of text files")
    p.add_argument("--images", type=_path_type(exists=True),
                   help="Directory containing images, or a packed corpus (.npy from "
                        "pack-images: no decode at run time, mmap-backed)")
    p.add_argument("--embeddings", type=_path_type(exists=True),
                   help="npz file with doc_ids + embeddings arrays")
    p.add_argument("--batch-size", type=int, help="Override batch size")
    p.add_argument("--device", help="Device of this command (overrides the top-level one)")
    p.add_argument("--delta", type=float, help="Override scoring delta")
    p.add_argument("--mode", choices=("standard", "conditional"), help="Scoring mode")
    p.add_argument("--checkpoint-dir", type=_path_type(),
                   help="Stage-checkpoint directory for resumable signal runs")
    p.add_argument("--shard-size", type=int,
                   help="Process the corpus in resumable shards of this many docs")
    p.set_defaults(func=cmd_process)

    p = sub.add_parser("search", help="Search a DEWI index")
    p.add_argument("index_dir", type=_path_type(exists=True, file_okay=False))
    p.add_argument("query")
    p.add_argument("--k", type=int, default=10, help="Number of results")
    p.add_argument("--eta", type=float, help="Weight for DEWI score (0-1)")
    p.add_argument("--entropy-pref", type=float, help="Entropy preference weight")
    p.add_argument("--output", "-o", type=_path_type(), help="JSON output path")
    p.add_argument("--test-mode", action="store_true", help="Run with mock data")
    p.set_defaults(func=cmd_search)

    p = sub.add_parser("serve", help="Serve a DEWI index over HTTP")
    p.add_argument("index_dir", type=_path_type(exists=True, file_okay=False))
    p.add_argument("--host", default="127.0.0.1", help="Bind address")
    p.add_argument("--port", type=int, default=8321, help="Bind port (0 = any)")
    p.add_argument("--window-ms", type=float, default=2.0,
                   help="Micro-batch coalescing window")
    p.add_argument("--max-batch", type=int, default=256,
                   help="Max queries fused into one device dispatch")
    p.add_argument("--backend", default=None, choices=("exact", "quantized", "ivf"),
                   help="Serve from a different index tier than the saved one "
                        "(re-tiers the stored corpus in memory)")
    p.set_defaults(func=cmd_serve)

    p = sub.add_parser("pack-images", help="Pre-decode an image directory into a pack")
    p.add_argument("images_dir", type=_path_type(exists=True, file_okay=False))
    p.add_argument("out_path", type=_path_type())
    p.add_argument("--size", type=int, default=224,
                   help="Packed square resolution (the largest any signal stage needs; "
                        "smaller sizes derive by downscale)")
    p.add_argument("--workers", type=int, default=None,
                   help="Decode processes (default: cpu_count-1 when >2 cores)")
    p.set_defaults(func=cmd_pack_images)

    p = sub.add_parser("import-weights", help="Convert an HF checkpoint")
    p.add_argument("source")
    p.add_argument("out_path", type=_path_type())
    p.add_argument("--kind", choices=("gpt2", "clip", "vit-mae"), required=True,
                   help="Architecture family of the HF checkpoint")
    p.set_defaults(func=cmd_import_weights)

    p = sub.add_parser("sample", help="Select K training docs from a process output")
    p.add_argument("processed_dir", type=_path_type(exists=True, file_okay=False))
    p.add_argument("k", type=int)
    p.add_argument("--tau", type=float, default=1.0, help="DEWI^tau temperature (0 = uniform)")
    p.add_argument("--submodular", action="store_true",
                   help="Facility-location coverage pick instead of sampling")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", "-o", type=_path_type(),
                   help="Write selected doc ids (one per line)")
    p.set_defaults(func=cmd_sample)

    p = sub.add_parser("eval", help="Run the EvalConfig metric suite against an index")
    p.add_argument("index_dir", type=_path_type(exists=True, file_okay=False))
    p.add_argument("queries", type=_path_type(exists=True, dir_okay=False))
    p.add_argument("qrels", type=_path_type(exists=True, dir_okay=False))
    p.add_argument("--config", dest="config_path", type=_path_type(exists=True),
                   help="Config file providing the eval section")
    p.add_argument("--eta", type=float, default=0.0)
    p.add_argument("--entropy-pref", type=float, default=0.0)
    p.add_argument("--output", "-o", type=_path_type(), help="Report JSON path")
    p.set_defaults(func=cmd_eval)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run one command; returns its exit code (0, 1 for the command's error,
    2 for a usage error).  The command's other exceptions propagate."""
    try:
        args = build_parser().parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)
    try:
        return int(args.func(args))
    except CliError as e:
        echo(f"Error: {e}", err=True)
        return 1


__all__ = ["main", "build_parser", "create_document", "yaml_dump", "load_config_file",
           "CliError"]
