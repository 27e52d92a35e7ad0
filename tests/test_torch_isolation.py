"""The port stands alone: it imports neither JAX nor the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "click", "dewi_tpu")
# tensorstore reads the reference's orbax directories, imported inside that
# reader only: importing any module of the port must not load it.
LOAD_FORBIDDEN = FORBIDDEN + ("tensorstore",)


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


PORT_FILES = (sorted((ROOT / "dewi_tpu_torch").rglob("*.py"))
              + sorted((ROOT / "scripts").glob("torch_*.py"))
              + sorted((ROOT / "examples").glob("torch_*.py")) + [ROOT / "chip_smoke.py"])


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_pulls_in_no_jax():
    code = ("import sys, dewi_tpu_torch, dewi_tpu_torch.convert; "
            "import dewi_tpu_torch.ops.cuda_search, dewi_tpu_torch.ops._build; "
            "import dewi_tpu_torch.ops.kmeans, dewi_tpu_torch.index.ivf; "
            "import dewi_tpu_torch.models, dewi_tpu_torch.models.registry; "
            "import dewi_tpu_torch.models.import_hf, dewi_tpu_torch.utils.msgpack; "
            "import dewi_tpu_torch.signals, dewi_tpu_torch.signals.text_entropy; "
            "import dewi_tpu_torch.signals.image_entropy, dewi_tpu_torch.signals.cross_modal; "
            "import dewi_tpu_torch.io, dewi_tpu_torch.io.device_images; "
            "import dewi_tpu_torch.config, dewi_tpu_torch.corpus, dewi_tpu_torch.pipelines; "
            "import dewi_tpu_torch.sampling, dewi_tpu_torch.io.packed; "
            "import dewi_tpu_torch.ops.image_noise, dewi_tpu_torch.utils.progress; "
            "import dewi_tpu_torch.signals.redundancy, dewi_tpu_torch.signals.noise; "
            "import dewi_tpu_torch.cli, dewi_tpu_torch.__main__, dewi_tpu_torch.native; "
            "import dewi_tpu_torch.eval, dewi_tpu_torch.metrics, dewi_tpu_torch.schemas; "
            "import dewi_tpu_torch.backends, dewi_tpu_torch.local_weights; "
            "import dewi_tpu_torch.robust, dewi_tpu_torch.utils.profiling; "
            "import dewi_tpu_torch.training, dewi_tpu_torch.training.loops; "
            "import dewi_tpu_torch.models.moe; "
            "import dewi_tpu_torch.parallel, dewi_tpu_torch.parallel.mesh; "
            "import dewi_tpu_torch.parallel.runtime, dewi_tpu_torch.parallel.distributed; "
            "import dewi_tpu_torch.parallel.signals, dewi_tpu_torch.parallel.ring; "
            "import dewi_tpu_torch.parallel.tp, dewi_tpu_torch.parallel.sp; "
            "import dewi_tpu_torch.parallel.pp; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{LOAD_FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_import_builds_nothing():
    """Importing the package compiles no kernel: the build runs at first use."""
    code = ("import dewi_tpu_torch.ops._build as b, dewi_tpu_torch.ops.cuda_search; "
            "import sys; sys.exit(0 if b._lib is None else 1)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_new_modules_are_checked():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"dewi_tpu_torch/ops/kmeans.py", "dewi_tpu_torch/index/ivf.py",
            "scripts/torch_stream_chunks.py", "scripts/torch_stage1_sweep.py"} <= names
    signal_slice = {f"dewi_tpu_torch/{m}.py" for m in (
        "models/transformer", "models/lm", "models/mae", "models/clip", "models/registry",
        "models/import_hf", "convert", "signals/tokenizer", "ops/robust",
        "signals/text_entropy", "io/images", "io/device_images", "signals/image_entropy",
        "signals/cross_modal", "serve", "utils/msgpack")}
    assert signal_slice <= names
    pipeline_slice = {f"dewi_tpu_torch/{m}.py" for m in (
        "config", "corpus", "pipelines", "sampling", "io/packed", "io/images",
        "io/device_images", "ops/image_noise", "utils/progress", "signals/redundancy",
        "signals/noise")} | {"scripts/torch_process_corpus.py"}
    assert pipeline_slice <= names
    cli_slice = {f"dewi_tpu_torch/{m}.py" for m in (
        "cli", "__main__", "native/__init__", "eval", "metrics", "schemas", "backends",
        "local_weights", "robust", "utils/profiling", "models/import_hf")} | {
        "scripts/torch_cli_process.py"}
    assert cli_slice <= names
    training_slice = {"dewi_tpu_torch/training/__init__.py", "dewi_tpu_torch/training/loops.py",
                      "dewi_tpu_torch/models/moe.py"} | {
        f"examples/torch_{m}.py" for m in ("quickstart", "index_tiers", "columnar_pipeline")}
    assert training_slice <= names
    parallel_slice = {f"dewi_tpu_torch/parallel/{m}.py" for m in (
        "__init__", "mesh", "runtime", "distributed", "signals")} | {
        "examples/torch_multichip_search.py"}
    assert parallel_slice <= names
    model_axis_slice = {f"dewi_tpu_torch/parallel/{m}.py" for m in ("ring", "tp", "sp", "pp")} | {
        "dewi_tpu_torch/models/moe.py", "dewi_tpu_torch/training/loops.py",
        "dewi_tpu_torch/signals/text_entropy.py"}
    assert model_axis_slice <= names
    profiling_slice = {"dewi_tpu_torch/utils/profiling.py"} | {
        f"scripts/torch_{m}.py" for m in (
            "profile_index", "probe_hbm_bw", "profile_scan_breakdown", "profile_serving",
            "profile_ivf_1m", "profile_ivf_recall_curve", "profiler_drift")}
    assert profiling_slice <= names
    integration_slice = {"dewi_tpu_torch/ops/cuda_probe.py"} | {
        f"scripts/torch_{m}.py" for m in (
            "profile_e2e", "profile_signals", "profile_signals_sharded", "profile_tokenize",
            "profile_tokenize_scaling", "run_all_perf", "integration_flow")}
    assert integration_slice <= names


def test_native_build_stays_in_its_directory(tmp_path):
    """Building the native library in a copy of the package writes nothing
    outside ``dewi_tpu_torch/_build/``, reads its sources from
    ``csrc/native/``, and builds again when a source is newer."""
    import os
    import shutil
    import time

    pkg = tmp_path / "dewi_tpu_torch"
    shutil.copytree(ROOT / "dewi_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))

    def listing():
        return {str(p.relative_to(tmp_path)): p.stat().st_mtime_ns
                for p in tmp_path.rglob("*") if "__pycache__" not in p.parts}

    code = ("import sys; sys.path.insert(0, sys.argv[1]); import dewi_tpu_torch.native as n; "
            "ok = n.available(); print(n.LIB_PATH); sys.exit(0 if ok else 1)")
    env = {k: v for k, v in os.environ.items() if k != "DEWI_TPU_NO_NATIVE"}
    before = listing()
    proc = subprocess.run([sys.executable, "-B", "-c", code, str(tmp_path)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == str(pkg / "_build" / "native" / "libdewi_native.so")
    after = listing()
    new = sorted(set(after) - set(before))
    assert new == ["dewi_tpu_torch/_build", "dewi_tpu_torch/_build/native",
                   "dewi_tpu_torch/_build/native/libdewi_native.so"], new
    # Every file that was there is untouched (a directory's own mtime moves
    # when _build/ appears in it).
    assert all(after[k] == v for k, v in before.items() if (tmp_path / k).is_file())
    # A source newer than the library builds it again; an older one does not.
    lib = pkg / "_build" / "native" / "libdewi_native.so"
    built = lib.stat().st_mtime_ns
    subprocess.run([sys.executable, "-B", "-c", code, str(tmp_path)], env=env, check=True,
                   capture_output=True, timeout=300)
    assert lib.stat().st_mtime_ns == built
    time.sleep(0.01)
    (pkg / "csrc" / "native" / "dewi_native.cpp").touch()
    subprocess.run([sys.executable, "-B", "-c", code, str(tmp_path)], env=env, check=True,
                   capture_output=True, timeout=300)
    assert lib.stat().st_mtime_ns > built
    assert sorted(set(listing()) - set(before)) == new


@pytest.mark.cuda
def test_card_cli_search_launches_a_kernel(tmp_path):
    """``cli.main(["--device", "cuda", "search", ...])`` on a small int8
    index with int8 queries launches a stage-1 kernel."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dewi_tpu_torch import DewiIndex, cli
    from dewi_tpu_torch.ops import cuda_search as cs

    rng = np.random.default_rng(0)
    n = 10_000  # capacity 16,384: the gates route stage 1 to a kernel from 8,192 rows
    emb = rng.normal(size=(n, 64)).astype(np.float32)
    index = DewiIndex(dim=64, backend="int8", int8_queries=True, device="cpu")
    index.add_batch([f"d{i}" for i in range(n)], emb, rng.random((n, 8)).astype(np.float32))
    index.build()
    index.save(tmp_path / "index")
    np.save(tmp_path / "q.npy", emb[7])
    cs.reset_launch_counts()
    assert cli.main(["--device", "cuda", "search", str(tmp_path / "index"),
                     str(tmp_path / "q.npy"), "--eta", "0", "--entropy-pref", "0",
                     "-o", str(tmp_path / "r.json")]) == 0
    assert sum(cs.launch_counts.values()) > 0
    import json

    assert json.loads((tmp_path / "r.json").read_text())[0]["id"] == "d7"


def test_ivf_defaults_to_the_card():
    """``IVFIndex(dim)`` without ``device=`` runs on the card, and raises
    where there is none; so does the facade's ``backend="ivf"``."""
    import torch

    from dewi_tpu_torch import DewiIndex, IVFIndex

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        IVFIndex(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        DewiIndex(dim=8, backend="ivf")
    assert IVFIndex(8, device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
