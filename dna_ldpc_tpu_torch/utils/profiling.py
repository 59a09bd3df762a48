"""Tracing / profiling hooks.

Port of ``dna_ldpc_tpu/utils/profiling.py``. The reference's
observability is wall-clock prints per phase (decoder.py:47-676) plus
elapsed time in result files (DNA_main.cpp:1092-1101). Here:

- ``PhaseTimer`` — structured named-phase wall timings (carried as it is);
- ``device_trace`` — a ``torch.profiler`` capture of the enclosed block
  (CPU activity, plus the card's kernels when CUDA is present) written as
  a Chrome trace into a directory, viewable in Perfetto or
  ``chrome://tracing``;
- ``annotate`` — a ``torch.profiler.record_function`` range, plus an NVTX
  range when CUDA is present, so pipeline phases show up in traces.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@dataclass
class PhaseTimer:
    times: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{name:>20}: {t:8.3f} s" for name, t in self.times.items()]
        lines.append(f"{'total':>20}: {total:8.3f} s")
        return "\n".join(lines)


TRACE_FILE = "trace.json"  # the Chrome trace device_trace writes into its log_dir


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the enclosed block with ``torch.profiler`` (CPU, and CUDA
    when a card is present) and write ``log_dir/trace.json``. Yields the
    profiler, whose ``key_averages()`` and ``events()`` hold the same
    events."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str):
    """A named range in profiler traces (and in NVTX on a card); costs a
    few microseconds when nothing traces."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(name)
            try:
                yield
            finally:
                torch.cuda.nvtx.range_pop()
        else:
            yield
