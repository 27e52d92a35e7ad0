"""The port stands alone: it imports neither JAX nor the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dewi_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


PORT_FILES = (sorted((ROOT / "dewi_tpu_torch").rglob("*.py"))
              + sorted((ROOT / "scripts").glob("torch_*.py")) + [ROOT / "chip_smoke.py"])


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_pulls_in_no_jax():
    code = ("import sys, dewi_tpu_torch, dewi_tpu_torch.convert; "
            "import dewi_tpu_torch.ops.cuda_search, dewi_tpu_torch.ops._build; "
            "import dewi_tpu_torch.ops.kmeans, dewi_tpu_torch.index.ivf; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
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
