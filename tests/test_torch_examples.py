"""The port's examples (``examples/torch_*.py``) run end to end on the CPU.

Counterpart of ``tests/test_examples.py``: each example runs in a
subprocess with ``--device cpu`` at the sizes that test gives the
reference's examples (``DEWI_EXAMPLE_DOCS``), and prints the lines that
test checks.  On the card the examples run with no argument.
"""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _run(script: str, docs: str = "") -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"  # tiny models; the test workers share the host's cores
    if docs:
        env["DEWI_EXAMPLE_DOCS"] = docs
    return subprocess.run([sys.executable, str(REPO / "examples" / script), "--device", "cpu"],
                          capture_output=True, text=True, timeout=480, env=env, cwd=REPO)


def test_torch_columnar_pipeline_example():
    out = _run("torch_columnar_pipeline.py", "96")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "resumed run:" in out.stdout
    assert "search 'solar particles in the atmosphere'" in out.stdout


def test_torch_index_tiers_example():
    out = _run("torch_index_tiers.py", "1024")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "all tiers hold the >=0.99 recall gate" in out.stdout


def test_torch_quickstart_example():
    out = _run("torch_quickstart.py")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Search 'northern lights in the atmosphere'" in out.stdout
    assert "Eval: recall@5=" in out.stdout
    assert "DEWI^tau sample (tau=2):" in out.stdout


def test_torch_multichip_search_example():
    """Four gloo ranks on the CPU; the sharded answers equal one device's."""
    out = _run("torch_multichip_search.py", "4096")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "over 4 gloo ranks on cpu" in out.stdout
    assert "exact tier: sharded top-10 == single-device top-10 over 4096 docs x 4 shards" \
        in out.stdout
    assert "int8 tier: sharded top-10 == single-device top-10" in out.stdout
