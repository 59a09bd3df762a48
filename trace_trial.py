#!/usr/bin/env python3
"""Trace one warm smoke trial of the PyTorch/CUDA port on one GPU.

    python3 trace_trial.py [--out DIR]

Builds ``chip_smoke.py``'s phase-5 trial (the same 272 codewords and
72,000 simulated reads: the script's seeded draws replayed), decodes it
once on the card to warm up (kernel builds, allocator, caches), then once
more under ``dna_ldpc_tpu_torch.utils.profiling.device_trace``, the whole
``decode_trial`` inside one ``annotate("trial")`` range. From the Chrome
trace it prints:

- the card's name and power limit, as nvidia-smi prints them;
- the traced trial's wall time and outcome (clusters, pairs, fail_final);
- the card's busy and idle time over the ``trial`` range: busy is the
  union of the intervals of every kernel, copy and memset the trace
  holds, idle the rest of the range;
- the device kernels in order of total time, each under its own name,
  with launches and share of the kernel time.

The trace (``trace.json``) goes to ``--out`` (default
``build/trace_trial``). Without CUDA the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP_KERNELS = 25


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
    """(window length, busy us, {kernel: [launches, us]}) of the card's
    activity inside the ``window_name`` annotation."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    window = [e for e in events if e.get("ph") == "X" and e.get("name") == window_name
              and e.get("cat") == "user_annotation"]
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
    busy, end = 0.0, w0
    for a, b in sorted(spans):  # union of the intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    return w1 - w0, busy, kernels


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
    from dna_ldpc_tpu_torch.utils.profiling import TRACE_FILE, annotate, device_trace

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
        with annotate("trial"):
            t0 = time.time()
            res = decode_trial(reads, quals, cws, TrialConfig())
            torch.cuda.synchronize()
            wall = time.time() - t0
    if res.fail_final:
        raise AssertionError(f"traced trial not recovered: fail_final {res.fail_final}")
    print(f"traced trial: wall {wall:.3f} s, MSA clusters {msa_align.msa_clusters}, pairs {pairhmm_cuda.pairs}, "
          f"fail_first {res.fail_first}, fail_final {res.fail_final}")
    print("phase_times: " + ", ".join(f"{k}={v:.4f}" for k, v in res.phase_times.items()))

    span, busy, kernels = device_time(os.path.join(args.out, TRACE_FILE), "trial")
    n_launch = sum(n for n, _ in kernels.values())
    kernel_us = sum(us for _, us in kernels.values())
    print(f"card over the 'trial' range ({span / 1e6:.3f} s): busy {busy / 1e6:.3f} s, idle "
          f"{(span - busy) / 1e6:.3f} s ({100 * (span - busy) / span:.1f} %); {n_launch} kernel launches, "
          f"{kernel_us / 1e6:.3f} s of kernel time")
    print("top device kernels by total time (launches, ms, share of kernel time):")
    for name, (n, us) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP_KERNELS]:
        print(f"  {us / 1e3:10.3f} ms  {n:7d}  {100 * us / kernel_us:5.1f} %  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
