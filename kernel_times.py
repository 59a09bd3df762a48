#!/usr/bin/env python3
"""Compare two checkouts' kernels — K1 (fused BP), K2 (pair-HMM) and the
device MSA's merge — on one GPU in one call, at the shapes
``chip_smoke.py`` times, and print ``nvcc -Xptxas -v`` for their sources.
``chip_smoke.py`` holds the kernels against their twins and reports the
committed tree's times and bounds; this script only takes turns between
versions.

    python3 kernel_times.py                 # this checkout: one JSON line of ms (and trial walls in s)
    python3 kernel_times.py --against DIR   # DIR, here, here, DIR: one JSON line per turn
    python3 kernel_times.py --ptxas         # registers, shared memory, spills of every kernel
    python3 kernel_times.py --generic       # K1's generic kernel on other codes, tiles staged and in place
    python3 kernel_times.py --k2 [--against DIR]  # K2's trial route and _pairs_k2 only
    python3 kernel_times.py --merge [--against DIR]  # the merge rows only

``DIR`` is a second checkout (``git archive <commit> | tar -x -C tmp_parent``);
each turn is a process of its own that imports ``dna_ldpc_tpu_torch`` from
its checkout. Shapes, generators and the timer come from ``chip_smoke.py``:
K1 on 64 trial-like codewords (200 iterations), on a 1024-frame AWGN batch
at 4.25 dB (50 iterations, early stop and fixed work) and on its first 32
frames (and that run's bound, ``utils/roofline.py``); K2 on 512 pairs at
Lmax = 160 and on one launch of the trial's size, then on the same two
sizes as the trial calls it (row indices of one read table where the
checkout's ``post_ea`` takes them, per-pair copies before);
the merge (BuildPost + MEA DP + walk: ``mea_cuda.merge_walk``) on 512
clusters of 8 reads at the first and the last progressive wave and on 64
clusters of 32 reads at a refinement bipartition of 16 reads a side (with
its bound, as the others' in ``chip_smoke.py``); the consistency
transform at the trial's buckets 4, 8 and 12 (``chip_smoke.py`` phase 17:
the kernel's call and device time, the plain block product, the bound;
a checkout without the kernel times its own transform there). Then
``chip_smoke.py``'s phase-5 trial: one warm-up ``decode_trial``, then two
more, each wall on the host clock ending in a synchronize; then
``align._pairs_k2`` whole on the clusters of that trial and of phase 13's
140,000 reads, its host seconds and K2's event seconds apart.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from chip_smoke import (  # noqa: E402
    K2_TRIAL_PAIRS, _consistency_times, _coverage_llrs, _cuda_ms, _merge_waves, _noisy_pairs, _strand_reads,
)


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _awgn_llrs(code, frames: int, ebno_db: float, dev):
    """BPSK over AWGN on codewords of the deployed code, LLR = 2 y / sigma^2."""
    import numpy as np
    import torch

    from dna_ldpc_tpu_torch.pipeline.simulate import group_union_codewords

    cw = torch.as_tensor(group_union_codewords(code, frames, np.random.default_rng(2)), device=dev)
    sigma2 = 1.0 / (2.0 * (16572 / 18432) * 10 ** (ebno_db / 10))  # the deployed H has rank 1860
    noise = torch.randn(cw.shape, generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    return (2.0 / sigma2) * ((1.0 - 2.0 * cw.float()) + math.sqrt(sigma2) * noise)


def _k2_posteriors():
    """K2 over read pairs in the checkout on the path: ``pairhmm.k2_posteriors``,
    or ``align._pair_posteriors`` in checkouts that predate it."""
    import importlib

    from dna_ldpc_tpu_torch.ops.msa import pairhmm

    return getattr(pairhmm, "k2_posteriors", None) or getattr(
        importlib.import_module("dna_ldpc_tpu_torch.ops.msa.align"), "_pair_posteriors")


def trial_walls(dev) -> dict:
    """Seconds of ``chip_smoke.py``'s phase-5 trial in the checkout on the
    path, twice after a warm-up; then ``pairs_k2_times``."""
    import torch

    from dna_ldpc_tpu_torch.pipeline.decode import TrialConfig, decode_trial
    from trace_trial import smoke_trial

    cws, reads, quals = smoke_trial()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        res = decode_trial(reads, quals, cws, TrialConfig())
        torch.cuda.synchronize()
        walls.append(round(time.time() - t0, 3))
        if res.fail_final:
            raise AssertionError(f"the trial left fail_final {res.fail_final}")
    return {"trial_device_s": walls[1:], **pairs_k2_times(dev, cws, reads, quals)}


def k2_trial_route_times(dev) -> dict:
    """K2 as the trial calls it, at 512 and K2_TRIAL_PAIRS pairs of clusters
    of 8 reads of one strand: through row indices of one read table where
    the checkout's ``post_ea`` takes them (``k2_route`` "index"), else on
    per-pair copies of the rows ("copies"). The kernel entry alone."""
    import inspect

    import numpy as np
    import torch

    from dna_ldpc_tpu_torch.ops.msa import pairhmm_cuda
    from dna_ldpc_tpu_torch.ops.msa.pairhmm import encode_pairs

    rng = np.random.default_rng(10)
    clusters = [_strand_reads(rng, 8) for _ in range(-(-K2_TRIAL_PAIRS // 28))]
    reads = [r for cl in clusters for r in cl]
    ti, tj = np.triu_indices(8, 1)
    first = 8 * np.arange(len(clusters))[:, None]
    a, b = ((first + t).ravel()[:K2_TRIAL_PAIRS].astype(np.int32) for t in (ti, tj))
    codes, _, lengths, _ = (torch.as_tensor(v, device=dev) for v in encode_pairs(reads, reads, 160))
    by_index = "a" in inspect.signature(pairhmm_cuda.post_ea).parameters
    out = {"k2_route": "index" if by_index else "copies"}
    for P, reps in ((512, 10), (K2_TRIAL_PAIRS, 3)):
        at, bt = (torch.as_tensor(v[:P], device=dev) for v in (a, b))
        if by_index:
            out[f"k2_route_{P}pairs_L160"] = _cuda_ms(
                lambda: pairhmm_cuda.post_ea(codes, codes, lengths, lengths, 160, at, bt), reps)
        else:
            copies = (codes[at.long()], codes[bt.long()], lengths[at.long()], lengths[bt.long()])
            out[f"k2_route_{P}pairs_L160"] = _cuda_ms(lambda: pairhmm_cuda.post_ea(*copies, 160), reps)
    return out


def pairs_k2_times(dev, cws, reads72k, quals72k) -> dict:
    """``align._pairs_k2`` whole on the clusters the trial hands the MSA
    at 72,000 reads (``chip_smoke.py`` phase 5) and 140,000 (phase 13), in
    the device flow's order: the wall of a call (ending in a synchronize)
    and the host seconds of its spans ``msa.pairs`` (the pair lists, or
    the read table) and ``msa.k2`` (uploads, launches, casts, downloads),
    each the mean of 3 calls after a warm one; then one call under the
    profiler for K2's event-timed seconds; K2 pairs, launches and the
    ``reads`` count where the checkout counts them."""
    import importlib

    import torch

    from dna_ldpc_tpu_torch.ops.msa.device_msa import MSA_BUCKETS
    from dna_ldpc_tpu_torch.ops.msa.pairhmm import padded_lmax
    from dna_ldpc_tpu_torch.pipeline.decode import TrialConfig, decode_trial
    from dna_ldpc_tpu_torch.pipeline.simulate import ChannelModel, encode_oligos, simulate_reads
    from dna_ldpc_tpu_torch.utils import profiling

    msa_align = importlib.import_module("dna_ldpc_tpu_torch.ops.msa.align")
    out = {}
    for name, (reads, quals) in (("72k", (reads72k, quals72k)),
                                 ("140k", simulate_reads(encode_oligos(cws), 140000, ChannelModel(), seed=5))):
        seen = []
        align_clusters = msa_align.align_clusters
        msa_align.align_clusters = lambda cl, *args, **kw: seen.append(cl) or align_clusters(cl, *args, **kw)
        try:
            decode_trial(reads, quals, cws, TrialConfig())
        finally:
            msa_align.align_clusters = align_clusters
        clusters = seen[0]
        by_bucket: dict = {}
        for c, seqs in enumerate(clusters):
            if 2 <= len(seqs) <= MSA_BUCKETS[-1]:
                by_bucket.setdefault(next(b for b in MSA_BUCKETS if b >= len(seqs)), []).append(c)
        order = [c for nb in sorted(by_bucket) for c in by_bucket[nb]]
        Lmax = padded_lmax(max(len(s) for c in order for s in clusters[c]))
        rows = []
        for k in range(5):
            traced = k == 4
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) if traced
                  else contextlib.nullcontext()):
                with profiling.span("kernel_times.pairs_k2", root=True):
                    res = msa_align._pairs_k2(clusters, order, Lmax, dev, {})
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            del res
            rec = profiling.recent_records("kernel_times.pairs_k2")[-1]
            spans = {s["name"]: s for s in rec}
            rows.append((wall, spans["msa.pairs"]["host_s"], spans["msa.k2"]["host_s"], spans["msa.k2"]["device_s"],
                         spans["msa.k2"]["counts"]))
        timed = rows[1:4]
        out[f"pairs_k2_{name}"] = {
            "clusters": len(order), "Lmax": Lmax,
            "wall_s": round(sum(r[0] for r in timed) / 3, 4),
            "msa_pairs_host_s": round(sum(r[1] for r in timed) / 3, 4),
            "msa_k2_host_s": round(sum(r[2] for r in timed) / 3, 4),
            "k2_event_s": rows[4][3], "traced_wall_s": round(rows[4][0], 4),
            "counts": rows[1][4],
        }
        torch.cuda.empty_cache()
    return out


def merge_times(dev) -> dict:
    """Milliseconds per batched merge (module docstring) and per whole
    ``_merge_step`` (the two projections, the merge, the gap insertion),
    with the number of device kernels one ``_merge_step`` launches
    (``torch.profiler``)."""
    import numpy as np
    import torch

    from dna_ldpc_tpu_torch.ops.msa import device_msa, mea_cuda
    from dna_ldpc_tpu_torch.utils import roofline

    out = {}
    k2 = _k2_posteriors()
    for k, margs, step in _merge_waves(np.random.default_rng(8), dev, 8, 512, 160, posteriors=k2):
        if k in (0, 6):
            out[f"merge_512x8_wave{k + 1}"] = _cuda_ms(lambda: mea_cuda.merge_walk(*margs), 10)
            out[f"merge_step_512x8_wave{k + 1}"] = _cuda_ms(lambda: device_msa._merge_step(*step), 10)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                device_msa._merge_step(*step)
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages() if "memcpy" not in e.key.lower() and "memset" not in e.key.lower()]
            out[f"merge_step_kernels_wave{k + 1}"] = sum(e.count for e in events)
            # device time of the hand-written kernel alone, without its wrapper's host time
            out[f"merge_step_dp_kernel_device_ms_wave{k + 1}"] = sum(
                e.device_time_total for e in events if "_dp_kernel" in e.key) / 1e3
            out[f"merge_step_device_ms_wave{k + 1}"] = sum(e.device_time_total for e in events) / 1e3
    del margs, step
    # a refinement bipartition of aligned clusters of 32 reads, 16 a side: 256 loads per cell
    for k, margs, _ in _merge_waves(np.random.default_rng(9), dev, 32, 64, 160, consistency_iters=0, posteriors=k2):
        if k == 31:
            out["merge_64x32_refine16x16"] = _cuda_ms(lambda: mea_cuda.merge_walk(*margs), 5)
            _, _, _, mA, mB, wA, wB, Cmax, _ = margs
            out["merge_64x32_refine16x16_bound"] = roofline.merge_bound_ms(
                mA.sum(1).tolist(), mB.sum(1).tolist(), wA.tolist(), wB.tolist(), Cmax)
    return out


def measure(repo: str) -> dict:
    """Milliseconds per call of the kernels of the checkout ``repo``."""
    sys.path.insert(0, repo)
    import numpy as np
    import torch

    from dna_ldpc_tpu_torch.models.blocked import dna_storage_blocked
    from dna_ldpc_tpu_torch.ops import bp_cuda
    from dna_ldpc_tpu_torch.ops.msa import pairhmm_cuda
    from dna_ldpc_tpu_torch.ops.msa.pairhmm import encode_pairs
    from dna_ldpc_tpu_torch.pipeline.simulate import group_union_codewords
    from dna_ldpc_tpu_torch.utils import roofline

    dev, rng, code = torch.device("cuda", 0), np.random.default_rng(1), dna_storage_blocked()
    trial = _coverage_llrs(rng, group_union_codewords(code, 64, rng), 3.7, 0.02, dev)
    awgn = _awgn_llrs(code, 1024, 4.25, dev)
    big = [torch.as_tensor(a, device=dev) for a in encode_pairs(*_noisy_pairs(rng, K2_TRIAL_PAIRS), 160)]
    bp, k2 = bp_cuda.bp_decode_blocked, pairhmm_cuda.post_ea
    return {
        "repo": os.path.relpath(repo, HERE), "card": _card(),
        "k1_trial64_200it": _cuda_ms(lambda: bp(code, trial, 200), 5),
        "k1_awgn1024_50it_early": _cuda_ms(lambda: bp(code, awgn, 50), 3),
        "k1_awgn1024_50it_fixed": _cuda_ms(lambda: bp(code, awgn, 50, False), 3),
        "k1_awgn32_50it_fixed": _cuda_ms(lambda: bp(code, awgn[:32], 50, False), 3),
        "k1_awgn32_50it_fixed_bound": roofline.k1_bound_ms(code.G * code.J * code.q, code.n_vars, [50] * 32),
        "k2_512pairs_L160": _cuda_ms(lambda: k2(*[a[:512] for a in big], 160), 10),
        f"k2_{K2_TRIAL_PAIRS}pairs_L160": _cuda_ms(lambda: k2(*big, 160), 3),
        **k2_trial_route_times(dev),
        **merge_times(dev),
        **{name: {k: row[k] for k in ("ms", "kernel_device_ms", "plain_ms", "bound_ms", "share_pct")}
           for name, row in _consistency_times(dev).items()},
        **trial_walls(dev),
    }


def measure_k2(repo: str) -> dict:
    """K2's part of ``measure``: the route the trial takes and
    ``_pairs_k2`` whole (``--k2``)."""
    sys.path.insert(0, repo)
    import torch

    from trace_trial import smoke_trial

    dev = torch.device("cuda", 0)
    return {"repo": os.path.relpath(repo, HERE), "card": _card(), **k2_trial_route_times(dev),
            **pairs_k2_times(dev, *smoke_trial())}


def measure_merge(repo: str) -> dict:
    """The merge's part of ``measure`` (``--merge``)."""
    sys.path.insert(0, repo)
    import torch

    return {"repo": os.path.relpath(repo, HERE), "card": _card(), **merge_times(torch.device("cuda", 0))}


def ptxas() -> None:
    """Registers, shared memory and spills of every kernel of the port."""
    from dna_ldpc_tpu_torch import cuda_lib

    for name in ("bp_blocked.cu", "pairhmm.cu", "mea_dp.cu", "consistency.cu"):
        proc = subprocess.run(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", os.devnull,
             os.path.join(HERE, "dna_ldpc_tpu_torch", "csrc", name)], capture_output=True, text=True)
        print(f"ptxas {name} (exit {proc.returncode}):")
        print("\n".join(ln for ln in proc.stderr.splitlines() if "Compiling" in ln or "registers" in ln or "spill" in ln))


def generic() -> dict:
    """K1's generic kernel on codes other than the deployed one: the layout
    the wrapper picks and, where that stages its tiles, the same kernel
    reading them in place; each equal to the twin, in turns forth and back;
    264 words, 30 iterations of fixed work."""
    import numpy as np
    import torch

    from dna_ldpc_tpu_torch.models import BlockedCode, build_rs_ldpc
    from dna_ldpc_tpu_torch.ops import bp_cuda
    from dna_ldpc_tpu_torch.pipeline.simulate import group_union_codewords

    dev, out, picked_layout = torch.device("cuda", 0), {"card": _card()}, bp_cuda.kernel_layout
    for params in ((6, 32, 3), (8, 64, 3), (9, 20, 3)):  # q = 64; q = 256, J = 64; q = 512 (in place)
        code = BlockedCode.detect(build_rs_ldpc(*params))
        rng = np.random.default_rng(params[0])
        llr = _coverage_llrs(rng, group_union_codewords(code, 264, rng), 2.5, 0.04, dev)
        ref = bp_cuda.bp_decode_blocked_ref(code, llr, 30, False)
        n, lay = code.J * code.q, picked_layout(code.J, code.q)
        variants = {"picked": lay}
        if lay.staged:
            variants["in_place"] = dataclasses.replace(lay, staged=False, pi_stride=4 * n, smem_bytes=8 * n)
        times = {name: [] for name in variants}
        for name in [*variants, *reversed(variants)]:
            bp_cuda.kernel_layout = lambda J, q, name=name: variants[name]
            code.__dict__.pop("_torch_packed_pi", None)  # packed for the layout before
            got = bp_cuda.bp_decode_blocked(code, llr, 30, False)
            for field in ("bits", "success", "unsat", "iterations"):
                if not torch.equal(getattr(got, field), getattr(ref, field)):
                    raise AssertionError(f"{params} {name}: {field} differs from the twin")
            times[name].append(_cuda_ms(lambda: bp_cuda.bp_decode_blocked(code, llr, 30, False), 5))
        bp_cuda.kernel_layout = picked_layout
        code.__dict__.pop("_torch_packed_pi", None)
        out[f"rs_ldpc{params}"] = {"G_J_q": (code.G, code.J, code.q), "picked_staged": lay.staged, "ms": times}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=HERE, help="checkout to import dna_ldpc_tpu_torch from")
    ap.add_argument("--ptxas", action="store_true", help="print nvcc -Xptxas -v for every kernel and stop")
    ap.add_argument("--generic", action="store_true", help="time K1's generic kernel, tiles staged and in place")
    ap.add_argument("--k2", action="store_true", help="time only K2's trial route and _pairs_k2 (with --against too)")
    ap.add_argument("--merge", action="store_true", help="time only the merge (with --against too)")
    ap.add_argument("--against", help="a second checkout: run it, this one twice, and it again")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device available", file=sys.stderr)
        return 2
    if a.against:
        for repo in (a.against, HERE, HERE, a.against):
            cmd = ([sys.executable, os.path.abspath(__file__), "--repo", os.path.abspath(repo)] + ["--k2"] * a.k2
                   + ["--merge"] * a.merge)
            rc = subprocess.run(cmd, cwd=os.path.abspath(repo)).returncode
            if rc:
                return rc
        return 0
    if a.ptxas:
        ptxas()
        return 0
    if a.generic:
        print(json.dumps(generic()))
    else:
        print(json.dumps((measure_k2 if a.k2 else measure_merge if a.merge else measure)(os.path.abspath(a.repo))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
