#!/usr/bin/env python3
"""Compare two checkouts' kernels — K1 (fused BP), K2 (pair-HMM) and the
device MSA's merge — on one GPU in one call, at the shapes
``chip_smoke.py`` times, and print ``nvcc -Xptxas -v`` for their sources.
``chip_smoke.py`` holds the kernels against their twins and reports the
committed tree's times and bounds; this script only takes turns between
versions.

    python3 kernel_times.py --against DIR   # DIR, here, here, DIR: one JSON line of ms per turn
    python3 kernel_times.py --ptxas         # registers, shared memory, spills of every kernel
    python3 kernel_times.py --generic       # K1's generic kernel on other codes, tiles staged and in place

``DIR`` is a second checkout (``git archive <commit> | tar -x -C tmp_parent``);
each turn is a process of its own that imports ``dna_ldpc_tpu_torch`` from
its checkout. Shapes, generators and the timer come from ``chip_smoke.py``:
K1 on 64 trial-like codewords (200 iterations), on a 1024-frame AWGN batch
at 4.25 dB (50 iterations, early stop and fixed work) and on its first 32
frames; K2 on 512 pairs at Lmax = 160 and on one launch of the trial's size;
the merge (BuildPost + MEA DP + walk: ``mea_cuda.merge_walk`` where the
checkout has it, else ``_build_post`` into device memory followed by
``mea_walk``) on 512 clusters of 8 reads at the first and the last
progressive wave and on 64 clusters of 32 reads at a refinement
bipartition of 16 reads a side; ``mea_dp`` alone on the first wave's planes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from chip_smoke import K2_TRIAL_PAIRS, _coverage_llrs, _cuda_ms, _merge_waves, _noisy_pairs  # noqa: E402


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


def merge_times(dev) -> dict:
    """Milliseconds per batched merge of the checkout on the path (module
    docstring), of ``mea_dp`` alone and of a whole ``_merge_step`` (the two
    projections, the merge, the gap insertion), with the number of device
    kernels one ``_merge_step`` launches (``torch.profiler``)."""
    import numpy as np
    import torch

    from dna_ldpc_tpu_torch.ops.msa import device_msa, mea_cuda

    # BuildPost lives beside the merge kernels where the checkout has ``merge_walk``
    build_post = getattr(mea_cuda, "_build_post", None) or device_msa._build_post

    def composite(Pblock, cposA, cposB, mA, mB, wA, wB, Cmax, L):
        return mea_cuda.mea_walk(build_post(Pblock, cposA, cposB, mA, mB, Cmax, L), wA, wB, Cmax)

    merge = getattr(mea_cuda, "merge_walk", composite)
    out = {"merge_is": "merge_dp" if merge is not composite else "_build_post + mea_dp"}
    for k, margs, step in _merge_waves(np.random.default_rng(8), dev, 8, 512, 160):
        if k in (0, 6):
            out[f"merge_512x8_wave{k + 1}"] = _cuda_ms(lambda: merge(*margs), 10)
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
        if k == 0:
            Pblock, cposA, cposB, mA, mB, wA, wB, Cmax, L = margs
            plane = build_post(Pblock, cposA, cposB, mA, mB, Cmax, L)
            out["mea_dp_512_Cmax192"] = _cuda_ms(lambda: mea_cuda.mea_walk(plane, wA, wB, Cmax), 20)
            del plane
    del margs, step
    # a refinement bipartition of aligned clusters of 32 reads, 16 a side: 256 loads per cell
    for k, margs, _ in _merge_waves(np.random.default_rng(9), dev, 32, 64, 160, consistency_iters=0):
        if k == 31:
            out["merge_64x32_refine16x16"] = _cuda_ms(lambda: merge(*margs), 5)
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
        "k2_512pairs_L160": _cuda_ms(lambda: k2(*[a[:512] for a in big], 160), 10),
        f"k2_{K2_TRIAL_PAIRS}pairs_L160": _cuda_ms(lambda: k2(*big, 160), 3),
        **merge_times(dev),
    }


def ptxas() -> None:
    """Registers, shared memory and spills of every kernel of the port."""
    from dna_ldpc_tpu_torch import cuda_lib

    for name in ("bp_blocked.cu", "pairhmm.cu", "mea_dp.cu"):
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
    ap.add_argument("--against", help="a second checkout: run it, this one twice, and it again")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device available", file=sys.stderr)
        return 2
    if a.against:
        for repo in (a.against, HERE, HERE, a.against):
            cmd = [sys.executable, os.path.abspath(__file__), "--repo", os.path.abspath(repo)]
            rc = subprocess.run(cmd, cwd=os.path.abspath(repo)).returncode
            if rc:
                return rc
        return 0
    if a.ptxas:
        ptxas()
        return 0
    print(json.dumps(generic() if a.generic else measure(os.path.abspath(a.repo))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
