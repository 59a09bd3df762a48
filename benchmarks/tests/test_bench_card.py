"""The benchmark on the card: one short run of each cell must print a
correct result line. Marked ``cuda``; skipped where no card is found.

    python -m pytest benchmarks/tests -m cuda
"""

import json
import os
import subprocess
import sys

import pytest

from bench_helpers import REPO

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's runs need the card")


def _cells():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("cell", _cells())
def test_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "benchmarks/run.py", "--workload", cell, "--seed", "2147483659",
                          "--seconds", "2", "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu", res
