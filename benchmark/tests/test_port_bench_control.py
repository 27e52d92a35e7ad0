"""The control, the reference in the program's place one precision below
the deployment's, comes out not correct under each cell's limits; and on
the card (marker ``cuda``), a short run of each cell comes out correct."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, tiny_corpus, tiny_search


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_search_control_fails(seed):
    cell = tiny_search("search-batch-q1000")
    run = cell.driver.control(cell, seed, torch.device("cpu"))
    assert not run.correct(), run.checks


@pytest.mark.parametrize("seed", [1, 2])
def test_corpus_control_fails(seed):
    cell = tiny_corpus("corpus-web-text")
    run = cell.driver.control(cell, seed, torch.device("cpu"))
    assert not run.correct(), run.checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["search-batch-q1000", "corpus-web-text"])
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", cell,
                          "--seed", "4242", "--seconds", "5", "--trace", "0"],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu", line
