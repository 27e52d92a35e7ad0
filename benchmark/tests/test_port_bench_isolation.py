"""Nothing the harness imports is JAX or the JAX package, compared by whole
top-level names (so ``dewi_tpu_torch`` passes), and nothing under
``benchmark/reference/`` imports the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "dewi_tpu"}
FILES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not set(roots(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not set(roots(path)) & {"dewi_tpu_torch", "harness"}


def test_whole_names_are_compared():
    import run as bench_run

    assert "dewi_tpu" in bench_run.FORBIDDEN
    assert not {"dewi_tpu_torch".split(".")[0]} & set(bench_run.FORBIDDEN)


def test_loading_the_harness_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; import run; from harness import spec;"
            "[spec.load_cell(w) for w in ('search-batch-q1000', 'corpus-web-text')];"
            "import dewi_tpu_torch.index, dewi_tpu_torch.pipelines;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))"
            % (str(BENCH), str(BENCH.parent), FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"
