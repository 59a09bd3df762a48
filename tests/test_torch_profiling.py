"""The port's tracing hooks (``utils/profiling.py``): ``PhaseTimer``
reports as the JAX package's does on the same clock readings;
``device_trace`` on the CPU writes a Chrome trace that holds the ranges
``annotate`` opened inside it, nested."""

import json
import os

import pytest
import torch

from dna_ldpc_tpu.utils import profiling as j_prof
from dna_ldpc_tpu_torch.utils import profiling as t_prof

# The suite runs in several worker processes that share the cores: one
# intra-op thread per process keeps OpenMP from oversubscribing them.
torch.set_num_threads(1)


def _timer_report(mod, monkeypatch):
    ticks = iter([1.0, 1.25, 2.0, 2.5, 3.0, 3.125])
    monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
    timer = mod.PhaseTimer()
    for name in ("rs_decode", "llr", "rs_decode"):
        with timer.phase(name):
            pass
    return timer.times, timer.report()


def test_phase_timer_report_matches_jax(monkeypatch):
    got = _timer_report(t_prof, monkeypatch)
    assert got == _timer_report(j_prof, monkeypatch)
    assert got[0] == {"rs_decode": 0.375, "llr": 0.5}
    assert got[1].splitlines()[-1].split() == ["total:", "0.875", "s"]


def test_device_trace_writes_nested_annotations(tmp_path):
    log_dir = str(tmp_path / "trace")
    with t_prof.device_trace(log_dir) as prof:
        with t_prof.annotate("trial"):
            with t_prof.annotate("llr"):
                torch.ones(64).cumsum(0)
    with open(os.path.join(log_dir, t_prof.TRACE_FILE)) as f:
        events = {e["name"]: e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"}
    outer, inner = events["trial"], events["llr"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert any(e.startswith("aten::cumsum") for e in events)
    assert {"trial", "llr"} <= {e.key for e in prof.key_averages()}
