#!/usr/bin/env python3
"""Trace one warm smoke trial of the PyTorch/CUDA port on one GPU.

    python3 trace_trial.py [--out DIR]

Builds ``chip_smoke.py``'s phase-5 trial (the same 272 codewords and
72,000 simulated reads: the script's seeded draws replayed), decodes it
once on the card to warm up (kernel builds, allocator, caches), then once
more under ``dna_ldpc_tpu_torch.utils.profiling.device_trace``, the whole
``decode_trial`` inside one span ``trace_trial``. It prints:

- the card's name and power limit, as nvidia-smi prints them;
- the traced trial's wall time and outcome (clusters, pairs, fail_final);
- the trial's record (``profiling.recent_trials()``): per span name, in
  the tree's order, the spans, their host and device seconds and counts;
- the card's busy and idle time over the ``trace_trial`` range: busy is
  the union of the intervals of every kernel, copy and memset the trace
  holds, idle the rest of the range;
- the idle time charged to the program's ranges: each idle gap goes to
  the innermost range open on the host at its middle (the arithmetic of
  ``benchmarks/benchlib/trace.py::idle_gaps``, over the program's spans):
  what the host did while the card waited;
- the device kernels in order of total time, each under its own name,
  with launches and share of the kernel time.

The trace (``trace.json``) goes to ``--out`` (default
``build/trace_trial``). Without CUDA the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import bisect
import importlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP_KERNELS = 25
WINDOW = "trace_trial"


def smoke_trial():
    """(codewords, reads, quals) of chip_smoke.py's phase 5: the draws of
    its generator (seed 1) through phases 2 and 3 replayed, then the 272
    codewords and the 72,000 reads (seed 7)."""
    import numpy as np

    from chip_smoke import _coverage_llrs, _noisy_pairs
    from dna_ldpc_tpu_torch.models.blocked import dna_storage_blocked
    from dna_ldpc_tpu_torch.pipeline.simulate import ChannelModel, encode_oligos, group_union_codewords, simulate_reads

    rng = np.random.default_rng(1)
    code = dna_storage_blocked()
    _coverage_llrs(rng, group_union_codewords(code, 64, rng), 3.7, 0.02, "cpu")    # phase 2
    _coverage_llrs(rng, group_union_codewords(code, 64, rng), 1.5, 0.05, "cpu")    # phase 2, low coverage
    _noisy_pairs(rng, 512)                                                         # phase 3
    cws = group_union_codewords(code, 272, rng)
    reads, quals = simulate_reads(encode_oligos(cws), 72000, ChannelModel(), seed=7)
    return cws, reads, quals


def device_time(trace_path: str, window_name: str):
    """(window length, busy us, {kernel: [launches, us]}, {range: idle us})
    of the card's activity inside the ``window_name`` annotation; idle
    gaps are charged to the innermost annotation (a program span) open at
    their middle, ``window_name`` where none is."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    window = [e for e in ranges if e.get("name") == window_name]
    if len(window) != 1:
        raise RuntimeError(f"expected one {window_name!r} range in the trace, found {len(window)}")
    w0, w1 = window[0]["ts"], window[0]["ts"] + window[0]["dur"]
    spans, kernels = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        spans.append((a, b))
        if e["cat"] == "kernel":
            k = kernels.setdefault(e["name"], [0, 0.0])
            k[0] += 1
            k[1] += e["dur"]
    if not kernels:
        raise RuntimeError("the trace holds no device kernel: torch.profiler did not see the card")
    busy, end, gaps = 0.0, w0, []
    for a, b in sorted(spans):  # union of the intervals, and the gaps between them
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if w1 > end:
        gaps.append((end, w1))
    return w1 - w0, busy, kernels, idle_by_range(gaps, ranges, window_name)


def idle_by_range(gaps, ranges, outside: str) -> dict:
    """{range name: us}: each gap (a, b) charged to the shortest range
    open at its middle (the innermost, ranges being nested), ``outside``
    where none is."""
    by_name: dict = {}
    for e in sorted(ranges, key=lambda e: e["ts"]):
        starts, ends = by_name.setdefault(e["name"], ([], []))
        starts.append(e["ts"])
        ends.append(e["ts"] + e["dur"])
    out: dict = {}
    for a, b in gaps:
        mid, best = (a + b) / 2, (float("inf"), outside)
        for name, (starts, ends) in by_name.items():  # ranges of one name do not overlap
            k = bisect.bisect_right(starts, mid) - 1
            if k >= 0 and mid <= ends[k]:
                best = min(best, (ends[k] - starts[k], name))
        out[best[1]] = out.get(best[1], 0.0) + (b - a)
    return out


def record_table(record: list) -> list[str]:
    """The trial record as lines, one per span name in the tree's order
    (indented by depth): kind, spans, host seconds, device seconds, counts."""
    rows: dict = {}
    for s in record:
        d, p = 0, s["parent"]
        while p >= 0:
            d, p = d + 1, record[p]["parent"]
        r = rows.setdefault(s["name"], {"depth": d, "kind": s["kind"], "n": 0, "host": 0.0, "device": None,
                                        "counts": {}})
        r["n"] += 1
        r["host"] += s["host_s"]
        if s["device_s"] is not None:
            r["device"] = (r["device"] or 0.0) + s["device_s"]
        for k, v in s["counts"].items():
            r["counts"][k] = r["counts"].get(k, 0) + v
    lines = [f"{'span':<34} {'kind':>6} {'spans':>6} {'host s':>10} {'device s':>10}  counts"]
    for name, r in rows.items():
        dev = "" if r["device"] is None else f"{r['device']:.4f}"
        counts = ", ".join(f"{k} {v}" for k, v in r["counts"].items())
        lines.append(f"{'  ' * r['depth'] + name:<34} {r['kind']:>6} {r['n']:>6} {r['host']:>10.4f} {dev:>10}  {counts}")
    return lines


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("trace_trial: no CUDA device available", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(REPO, "build", "trace_trial"))
    args = parser.parse_args()

    from dna_ldpc_tpu_torch.ops.msa import pairhmm_cuda
    from dna_ldpc_tpu_torch.pipeline.decode import TrialConfig, decode_trial
    from dna_ldpc_tpu_torch.utils.profiling import TRACE_FILE, device_trace, recent_trials, span

    msa_align = importlib.import_module("dna_ldpc_tpu_torch.ops.msa.align")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    cws, reads, quals = smoke_trial()
    t0 = time.time()
    warm = decode_trial(reads, quals, cws, TrialConfig())
    torch.cuda.synchronize()
    print(f"warm-up trial: {time.time() - t0:.2f} s (kernel builds included), fail_final {warm.fail_final}")

    msa_align.msa_clusters = pairhmm_cuda.pairs = 0
    with device_trace(args.out):
        with span(WINDOW):
            t0 = time.time()
            res = decode_trial(reads, quals, cws, TrialConfig())
            torch.cuda.synchronize()
            wall = time.time() - t0
    if res.fail_final:
        raise AssertionError(f"traced trial not recovered: fail_final {res.fail_final}")
    print(f"traced trial: wall {wall:.3f} s, MSA clusters {msa_align.msa_clusters}, pairs {pairhmm_cuda.pairs}, "
          f"fail_first {res.fail_first}, fail_final {res.fail_final}")
    print("phase_times: " + ", ".join(f"{k}={v:.4f}" for k, v in res.phase_times.items()))
    print("the trial's record (the program's spans; device seconds from CUDA events under the profiler):")
    for line in record_table(recent_trials()[-1]):
        print("  " + line)

    length, busy, kernels, idle = device_time(os.path.join(args.out, TRACE_FILE), WINDOW)
    n_launch = sum(n for n, _ in kernels.values())
    kernel_us = sum(us for _, us in kernels.values())
    print(f"card over the {WINDOW!r} range ({length / 1e6:.3f} s): busy {busy / 1e6:.3f} s, idle "
          f"{(length - busy) / 1e6:.3f} s ({100 * (length - busy) / length:.1f} %); {n_launch} kernel launches, "
          f"{kernel_us / 1e6:.3f} s of kernel time")
    print("idle time by the innermost program range open on the host at each gap's middle (s, share of the idle):")
    for name, us in sorted(idle.items(), key=lambda kv: -kv[1]):
        print(f"  {us / 1e6:10.4f} s  {100 * us / max(length - busy, 1e-9):5.1f} %  {name}")
    print("top device kernels by total time (launches, ms, share of kernel time):")
    for name, (n, us) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP_KERNELS]:
        print(f"  {us / 1e3:10.3f} ms  {n:7d}  {100 * us / kernel_us:5.1f} %  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
