"""Helpers of the benchmark's CPU tests: a copy of the benchmark in a
temporary directory, with cells added by files, and a run of it on the
CPU."""

from __future__ import annotations

import json
import os
import shutil
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)
if BENCH_DIR not in sys.path:
    sys.path.insert(0, BENCH_DIR)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

SMALL_SIM = "sim-small"
SMALL_TRIAL = "trial-small"
SMALL_MSA = "trial-small-msa"


def copy_with_small_cells(tmp: str) -> str:
    """A copy of BENCHMARK.json and benchmarks/ under ``tmp`` with two cells
    added the way a later change adds one, by new files and new entries: a
    simulator configuration of 32-frame batches, a trial traffic with no
    insertions or deletions (no strand needs the MSA, so a trial fits a
    CPU test), and a trial traffic with a few deletions under a trial
    configuration that checks a dozen aligned strands in one process.
    Returns the copy's benchmark directory."""
    bench = os.path.join(tmp, "benchmarks")
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp)
    with open(os.path.join(bench, "configs", "park2023-code-awgn.json")) as f:
        sim = json.load(f)
    sim.update(name="small-code-awgn", batch=32, frames_per_call=64, check={"among_first_calls": 1})
    with open(os.path.join(bench, "configs", "small-code-awgn.json"), "w") as f:
        json.dump(sim, f)
    with open(os.path.join(bench, "traffic", "reads-small.json"), "w") as f:
        json.dump({"reads": 72000, "channel": {"substitution": 0.01, "insertion": 0.0, "deletion": 0.0,
                                               "q_high": 70, "q_low": 40, "p_low_quality": 0.05}}, f)
    with open(os.path.join(bench, "traffic", "reads-small-msa.json"), "w") as f:
        json.dump({"reads": 72000, "channel": {"substitution": 0.01, "insertion": 0.0, "deletion": 1e-5,
                                               "q_high": 70, "q_low": 40, "p_low_quality": 0.05}}, f)
    with open(os.path.join(bench, "configs", "park2023-trial.json")) as f:
        trial = json.load(f)
    trial.update(name="small-trial", check={"k2_pairs": 64, "msa_clusters": 12, "msa_workers": 1})
    with open(os.path.join(bench, "configs", "small-trial.json"), "w") as f:
        json.dump(trial, f)
    with open(os.path.join(tmp, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "small-code-awgn", "source": sim["source"],
                            "file": "benchmarks/configs/small-code-awgn.json", "reduced": ["batch"], "why": "test"})
    spec["configs"].append({"name": "small-trial", "source": trial["source"],
                            "file": "benchmarks/configs/small-trial.json", "reduced": ["check"], "why": "test"})
    spec["workloads"] += [
        {"name": SMALL_SIM, "config": "small-code-awgn", "traffic": "awgn-4.25db", "chips": 1, "why": "test"},
        {"name": SMALL_TRIAL, "config": "park2023-trial", "traffic": "reads-small", "chips": 1, "why": "test"},
        {"name": SMALL_MSA, "config": "small-trial", "traffic": "reads-small-msa", "chips": 1, "why": "test"},
    ]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            if "trial-72k" in m["workloads"]:
                m["workloads"] += [SMALL_TRIAL, SMALL_MSA]
            if "sim-awgn-4.25db" in m["workloads"]:
                m["workloads"].append(SMALL_SIM)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return bench


def run_cell(bench: str, cell: str, seed: int, trace: int = 0, seconds: float = 0.5, capsys=None,
             control: bool = False) -> dict:
    """Run ``cell`` of the copy at ``bench`` on the CPU (as the control of
    ``correct`` with ``control``); returns the result line as a dict (the
    run must print one)."""
    import run

    argv = ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    code = run.run(argv + ["--control"] * control, device="cpu", repo=os.path.dirname(bench), bench_dir=bench)
    assert code == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])
