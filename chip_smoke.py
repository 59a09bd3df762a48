#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dna_ldpc_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:

1. the card's name and power limit, as nvidia-smi prints them, then the
   build of the CUDA kernels (nvcc, sm_90a) and the native host library
   from source;
2. K1, the fused BP kernel, against its plain torch twin on the card:
   64 trial-like codewords of the deployed 2048 x 18432 code, 200
   iterations — success, unsat and iterations equal, bits equal where
   decoding succeeded — then 64 low-coverage words (Poisson(1.5) reads,
   eps 0.05) that run to the iteration cap, where bits, unsat and
   iterations must all be equal;
3. K2, the pair-HMM kernel, against its twin: 512 read pairs at
   Lmax = 160 — posteriors within atol = rtol = 1e-4, EA scores equal to
   the native mea_score of the bf16-rounded kernel posterior;
4. the device edit distance against the native one on the same pairs
   (bit-equal);
5. one full trial at the reference's scale: 272 codewords, 72,000
   simulated reads, ``decode_trial`` on the card — every codeword must be
   recovered, through both kernels (their launch counts are reset just
   before and read just after).

The line before the last is a JSON object with each kernel's launches on
the trial, error against its twin, and time beside the twin's; the last
line is ``{"ok": true, "device": {...}}``. Without CUDA, or without the
repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time


def _cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _noisy_pairs(rng, n: int, length: int = 136):
    """Read pairs of one strand each: two independent copies with
    substitutions (1%) and 0-3 deletions."""
    xs, ys = [], []
    for _ in range(n):
        base = rng.integers(0, 4, length)
        pair = []
        for _ in range(2):
            s = base.copy()
            sub = rng.random(length) < 0.01
            s[sub] = (s[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
            s = s[~(rng.random(length) < rng.integers(0, 4) / length)]
            pair.append("".join("ACGT"[k] for k in s))
        xs.append(pair[0])
        ys.append(pair[1])
    return xs, ys


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    from dna_ldpc_tpu_torch import cuda_lib, native_lib
    from dna_ldpc_tpu_torch.models.blocked import dna_storage_blocked
    from dna_ldpc_tpu_torch.models.rs_ldpc import dna_storage_pchk
    from dna_ldpc_tpu_torch.ops import bp_cuda
    from dna_ldpc_tpu_torch.ops.editdist import edit_distance_pairs_device
    from dna_ldpc_tpu_torch.ops.msa import pairhmm_cuda
    from dna_ldpc_tpu_torch.ops.msa.pairhmm import encode_pairs
    from dna_ldpc_tpu_torch.pipeline.decode import TrialConfig, decode_trial
    from dna_ldpc_tpu_torch.pipeline.simulate import (
        ChannelModel, encode_oligos, group_union_codewords, simulate_reads,
    )

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.time()
    cuda_lib.load()
    t_cuda = time.time() - t0
    t0 = time.time()
    native_lib.load()
    print(f"[1] build: CUDA kernels {t_cuda:.2f} s (nvcc sm_90a), native host library "
          f"{time.time() - t0:.2f} s (g++)")

    rng = np.random.default_rng(1)
    code = dna_storage_blocked()

    # ---- 2. K1 against its twin ------------------------------------------
    def coverage_llrs(cw, cov_mean, eps):
        cov = rng.poisson(cov_mean, cw.shape)
        errs = rng.binomial(cov, eps)
        mag = math.log((1 - eps) / eps)
        return torch.as_tensor(
            ((cov - 2 * errs) * mag * np.where(cw == 0, 1.0, -1.0)).astype(np.float32), device=dev
        )

    cw = group_union_codewords(code, 64, rng)
    llr = coverage_llrs(cw, 3.7, 0.02)
    k = bp_cuda.bp_decode_blocked(code, llr, 200)
    r = bp_cuda.bp_decode_blocked_ref(code, llr, 200)
    torch.cuda.synchronize()
    for name in ("success", "unsat", "iterations"):
        if not torch.equal(getattr(k, name), getattr(r, name)):
            raise AssertionError(f"K1 {name} differs from its twin")
    ok = k.success
    bits_diff = (k.bits[ok].int() - r.bits[ok].int()).abs().max().item() if bool(ok.any()) else 0
    if bits_diff:
        raise AssertionError("K1 bits differ from the twin's where decoding succeeded")
    low = coverage_llrs(group_union_codewords(code, 64, rng), 1.5, 0.05)
    k_low = bp_cuda.bp_decode_blocked(code, low, 200)
    r_low = bp_cuda.bp_decode_blocked_ref(code, low, 200)
    torch.cuda.synchronize()
    for name in ("bits", "success", "unsat", "iterations"):
        if not torch.equal(getattr(k_low, name), getattr(r_low, name)):
            raise AssertionError(f"K1 {name} differs from its twin on low-coverage words")
    n_capped = int((k_low.iterations == 200).sum())
    if n_capped == 0:
        raise AssertionError("no low-coverage word ran to the iteration cap")
    k1_err = float(bits_diff)
    n_ok = int(ok.sum())
    bit_err = int((k.bits.cpu().numpy()[ok.cpu().numpy()] != cw[ok.cpu().numpy()]).sum())
    k1_ms = _cuda_ms(lambda: bp_cuda.bp_decode_blocked(code, llr, 200), 5)
    k1_plain = _cuda_ms(lambda: bp_cuda.bp_decode_blocked_ref(code, llr, 200), 2)
    print(f"[2] K1 bp_blocked vs twin: 64 codewords, {n_ok} decoded, bit errors {bit_err}, "
          f"mean iterations {k.iterations.float().mean().item():.2f}; equal; kernel "
          f"{k1_ms:.3f} ms ({64e3 / k1_ms:.0f} cw/s), twin {k1_plain:.3f} ms "
          f"({64e3 / k1_plain:.0f} cw/s); low coverage: {n_capped} of 64 words at the "
          f"200-iteration cap, bits, unsat and iterations equal")

    # ---- 3. K2 against its twin ------------------------------------------
    Lmax = 160
    xs, ys = _noisy_pairs(rng, 512)
    X, Y, lx, ly = encode_pairs(xs, ys, Lmax)
    args = [torch.as_tensor(a, device=dev) for a in (X, Y, lx, ly)]
    post_k, ea_k = pairhmm_cuda.post_ea(*args, Lmax)
    post_r, ea_r = pairhmm_cuda.post_ea_ref(*args, Lmax)
    torch.cuda.synchronize()
    k2_err = (post_k - post_r).abs().max().item()
    if not torch.allclose(post_k, post_r, atol=1e-4, rtol=1e-4):
        raise AssertionError(f"K2 posteriors differ from the twin's (max abs {k2_err:.3e})")
    pb = post_k.to(torch.bfloat16).float().cpu().numpy()
    ea_np = ea_k.cpu().numpy()
    for p in range(len(xs)):
        host = native_lib.mea_score_native(pb[p, : lx[p], : ly[p]])
        if np.float32(host) != ea_np[p]:
            raise AssertionError(f"K2 EA score of pair {p} is not the native mea_score")
    ea_diff = (ea_k - ea_r).abs().max().item()
    k2_ms = _cuda_ms(lambda: pairhmm_cuda.post_ea(*args, Lmax), 5)
    k2_plain = _cuda_ms(lambda: pairhmm_cuda.post_ea_ref(*args, Lmax), 2)
    print(f"[3] K2 pairhmm vs twin: 512 pairs at Lmax={Lmax}; posterior max abs diff "
          f"{k2_err:.3e} (atol = rtol = 1e-4), EA max abs diff vs twin {ea_diff:.3e}, "
          f"EA == native mea_score; "
          f"kernel {k2_ms * 1e3 / 512:.3f} ms per 1000 pairs, twin "
          f"{k2_plain * 1e3 / 512:.3f} ms per 1000 pairs")

    # ---- 4. device edit distance against the native one -------------------
    seqs = xs + ys
    buf, offs, lens = native_lib.pack_seqs(seqs)
    pa, pb_idx = np.arange(512), np.arange(512, 1024)
    native = native_lib.edit_distance_batch_native(buf, offs, lens, pa, pb_idx)
    from dna_ldpc_tpu_torch.utils.dna import seqs_to_matrix

    device_d = edit_distance_pairs_device(
        seqs_to_matrix(seqs, fill=b"\x00"), lens.astype(np.int64), pa, pb_idx, dev
    )
    if not np.array_equal(native, device_d):
        raise AssertionError("device edit distances differ from the native ones")
    print(f"[4] edit distance: device == native on 512 pairs (mean {native.mean():.2f})")

    # ---- 5. one full trial -----------------------------------------------
    cws = group_union_codewords(code, 272, rng)
    if dna_storage_pchk().mulvec(cws).any():
        raise AssertionError("synthetic codewords violate H")
    reads, quals = simulate_reads(encode_oligos(cws), 72000, ChannelModel(), seed=7)
    bp_cuda.launches = 0
    pairhmm_cuda.launches = pairhmm_cuda.pairs = 0
    torch.cuda.synchronize()
    t0 = time.time()
    res = decode_trial(reads, quals, cws, TrialConfig(device="cuda"))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"bp_blocked": bp_cuda.launches, "pairhmm": pairhmm_cuda.launches}
    msa_pairs = pairhmm_cuda.pairs
    print(f"[5] trial: {len(reads)} reads, n_reads_kept {res.n_reads_kept}, MSA pairs {msa_pairs}, "
          f"fail_first {res.fail_first}, fail_final {res.fail_final}, n_anneal_iters "
          f"{res.n_anneal_iters}, erasure strands {res.n_erasure_strands}, wall {wall:.2f} s, "
          f"launches {launches}")
    print("[5] phase_times: " + ", ".join(f"{k}={v:.4f}" for k, v in res.phase_times.items()))
    if res.fail_final or not np.array_equal(res.decoded_bits, cws):
        raise AssertionError(f"trial not recovered: fail_final {res.fail_final}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    kernels = [
        {"name": "bp_blocked", "route": "cuda", "source": "dna_ldpc_tpu_torch/csrc/bp_blocked.cu",
         "replaces": "dna_ldpc_tpu/ops/bp_pallas.py:55", "launches": launches["bp_blocked"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "pairhmm", "route": "cuda", "source": "dna_ldpc_tpu_torch/csrc/pairhmm.cu",
         "replaces": "dna_ldpc_tpu/ops/msa/pairhmm_pallas.py:114",
         "launches": launches["pairhmm"], "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
