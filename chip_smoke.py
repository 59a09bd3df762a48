#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dna_ldpc_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:

1. the card's name and power limit, as nvidia-smi prints them, then the
   build of the CUDA kernels (one nvcc process per source, all started
   together, sm_90a) and the native host library from source;
2. K1, the fused BP kernel, against its plain torch twin on the card:
   64 trial-like codewords of the deployed 2048 x 18432 code, 200
   iterations — success, unsat and iterations equal, bits equal where
   decoding succeeded — then 64 low-coverage words (Poisson(1.5) reads,
   eps 0.05) that run to the iteration cap, where bits, unsat and
   iterations must all be equal;
3. K2, the pair-HMM kernel, against its twin: 512 read pairs at
   Lmax = 160 — posteriors within atol = rtol = 1e-4, EA scores equal to
   the native mea_score of the bf16-rounded kernel posterior — then 6,000
   pairs, the size of one launch of the trial (the 512 are its first):
   the same tolerance against the twin, the first 512 pairs bit-equal to
   the small batch, and the time the ``kernels`` line reports;
4. the device edit distance against the native one on the same pairs
   (bit-equal);
5. one full trial at the reference's scale: 272 codewords, 72,000
   simulated reads, ``decode_trial`` on the card through the device MSA
   — every codeword must be recovered, through K1, K2 and ``merge_dp``
   (every launch count is reset just before and read just after), with at
   most 1 % of the MSA clusters handed to the host aligner;
6. the same reads with ``DNA_LDPC_DEVICE_MSA=0`` (the host-aligner MSA
   flow) must give the same ``fail_first``, ``fail_final`` and
   ``n_anneal_iters``; the number of LLR-table entries that differ is
   printed;
7. the merge kernels of the device MSA against their twins on a bucket-8
   batch of 512 clusters (reads as in phase 3, Lmax = 160, Cmax = 192),
   codes and positions bit-equal: ``merge_dp`` (BuildPost + MEA DP + walk
   from the pair posteriors) at the first progressive wave (single reads
   a side) and at the last (several gapped reads a side), beside the time
   of BuildPost into device memory followed by ``mea_dp``; and ``mea_dp``
   (the same DP for a caller that holds the plane) on the first wave's
   BuildPost planes, which must also give ``merge_dp``'s path;
8. the same trial once more through the command line,
   ``python -m dna_ldpc_tpu_torch.cli simulate``, on codeword and oligo
   files written to a temporary directory in the reference's formats;
9. the code simulator (``ops/simulation.py``) on the card, on the deployed
   code: (a) the ``bp`` FER waterfall over Eb/No 3.75-4.5 dB through K1
   (its launches reset just before and read just after; FER must not rise
   with Eb/No, must be above 0 at the lowest point and below that at the
   highest), (b) the same points with ``min_sum`` on the gather path,
   (c) K1 against its twin on one simulator batch at 4.25 dB, early-stopped
   and in fixed-work mode (``early_stop=False``), both equal to the twin's
   and to each other word for word, (d) one point each of quantized
   min-sum/AWGN, Gallager B/BSC, threshold FAID/BSC and peeling/BEC, each
   also equal to the same decoder on the CPU on 8 frames, then a LUT FAID
   on the 192 x 2048 column-weight-3 RS-LDPC code, (e) error cases saved on
   the card replayed there bit for bit, (f) the code-construction CLI:
   ``rs-ldpc 8 72 8``, ``alist-to-pchk``, ``pchk-to-alist`` (alist back
   byte-equal), ``make-gen`` and ``encode`` of four messages, whose
   codewords must satisfy the pchk. It prints each decoder's ms per
   iteration at a batch of 32 and at its full batch, and K1's codewords
   per second with and without early stop.

Phases 2, 3, 7 and 9c print each kernel's time beside its bound at the
timed shape — the least time the card could take for that work
(``dna_ldpc_tpu_torch/utils/roofline.py``: the bytes that must move at
3.35 TB/s against the f32 operations at 67 TFLOP/s and the
special-function operations at 16 per clock and SM, from this run's
shapes and the iteration counts it returned) — and the share reached.

The line before the last is a JSON object with each kernel's launches on
the trial of phase 5 (K1: plus the waterfall of phase 9a), error against
its twin, time beside the twin's and beside its bound, and
``library_ms`` (null: no single PyTorch call computes any of the four).
``mea_dp``, the plane entry of the merge kernel, is on no driven path — the
trial's merges launch ``merge_dp`` — so its count on the trial is 0 and it
is held against its twin in phase 7 only. The
last line is ``{"ok": true, "device": {...}}``. Without CUDA, or
without the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Phase 9. Batches are sized from the card's memory, not the TPU default:
# one f32 edge tensor of the deployed code is 147,456 x B x 4 bytes (0.3 GB
# at B = 512), and the gather decoders hold about six of them.
SIM_EBNO = [3.75, 4.0, 4.25, 4.5]
BP_BATCH, BP_MAX_FRAMES = 1024, 32768
ZOO_BATCH, ZOO_MAX_FRAMES = 512, 2048
SMALL_BATCH = 32  # per-iteration times here and at full batch: launch- or memory-bound
K2_TRIAL_PAIRS = 6000  # pairs in one K2 launch of the 72,000-read trial (47,327 pairs in 7 launches)
ZOO_POINTS = [("quantized_min_sum", "awgn", 4.75), ("gallager_b", "bsc", 0.005), ("faid", "bsc", 0.003),
              ("bec", "bec", 0.055)]


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


def _strand_reads(rng, n: int, length: int = 136) -> list[str]:
    """n independent copies of one random strand with substitutions (1%)
    and 0-3 deletions."""
    base = rng.integers(0, 4, length)
    out = []
    for _ in range(n):
        s = base.copy()
        sub = rng.random(length) < 0.01
        s[sub] = (s[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        s = s[~(rng.random(length) < rng.integers(0, 4) / length)]
        out.append("".join("ACGT"[k] for k in s))
    return out


def _noisy_pairs(rng, n: int):
    """Read pairs of one strand each."""
    pairs = [_strand_reads(rng, 2) for _ in range(n)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _merge_waves(rng, dev, nb: int, C: int, Lmax: int, consistency_iters: int = 2):
    """One device-MSA batch and its merges: C clusters of nb reads of one
    strand each, pair posteriors from K2, UPGMA join orders. Yields
    (k, margs, step) for a batched merge: the progressive waves
    k = 0 .. nb - 2, then, as k = nb - 1, a refinement bipartition of the
    aligned batch (even against odd reads). ``margs`` are the arguments of
    ``mea_cuda.merge_walk``, ``step`` those of ``device_msa._merge_step``
    for the same merge; the batch moves on by ``_merge_step`` between
    yields."""
    import numpy as np
    import torch

    from dna_ldpc_tpu_torch.ops.msa import align as msa_align
    from dna_ldpc_tpu_torch.ops.msa import device_msa

    clusters = [_strand_reads(rng, nb) for _ in range(C)]
    prs = msa_align.cluster_pairs(nb)
    npair = len(prs)
    posts, ea = msa_align._pair_posteriors(
        [cl[i] for cl in clusters for i, _ in prs], [cl[j] for cl in clusters for _, j in prs], Lmax, dev
    )
    P = device_msa.assemble_transform(
        posts, torch.arange(C * npair, device=dev), torch.ones(C * npair, dtype=torch.bool, device=dev),
        torch.full((C,), 1.0 / nb, device=dev), nb, consistency_iters, C, Lmax,
    )
    del posts
    waves = [
        device_msa.wave_masks(
            msa_align.upgma_join_order(msa_align._ea_dists(cl, ea[c * npair : (c + 1) * npair])), nb, nb
        )
        for c, cl in enumerate(clusters)
    ]
    Cmax = Lmax + device_msa.COLUMN_SLACK
    Pblock = device_msa.build_pblock(P, nb)
    del P
    lens = torch.as_tensor([[len(r) for r in cl] for cl in clusters], device=dev)
    cpos, width = device_msa._msa_init(lens, Cmax, Lmax)
    live = torch.ones(C, dtype=torch.bool, device=dev)
    even = (torch.arange(nb, device=dev) % 2 == 0).expand(C, nb)
    for k in range(nb):
        if k < nb - 1:
            mA = torch.as_tensor(np.stack([w[0][k] for w in waves]), device=dev)
            mB = torch.as_tensor(np.stack([w[1][k] for w in waves]), device=dev)
        else:
            mA, mB = even, ~even
        cposA, wA = device_msa._project(cpos, mA, Cmax, Lmax)
        cposB, wB = device_msa._project(cpos, mB, Cmax, Lmax)
        step = (Pblock, cpos, width, mA, mB, live, Cmax, Lmax)
        yield k, (Pblock, cposA, cposB, mA, mB, wA, wB, Cmax, Lmax), step
        cpos, width, _, _ = device_msa._merge_step(*step)


def _coverage_llrs(rng, cw, cov_mean: float, eps: float, dev):
    """Trial-like LLRs of codewords ``cw``: Poisson(cov_mean) reads per
    bit, each wrong with probability eps."""
    import numpy as np
    import torch

    cov = rng.poisson(cov_mean, cw.shape)
    errs = rng.binomial(cov, eps)
    mag = math.log((1 - eps) / eps)
    return torch.as_tensor(((cov - 2 * errs) * mag * np.where(cw == 0, 1.0, -1.0)).astype(np.float32), device=dev)


def _same(a, b, what: str) -> None:
    """Two BpResults equal field by field, or raise."""
    import torch

    for name in ("bits", "success", "unsat", "iterations"):
        if not torch.equal(getattr(a, name).cpu(), getattr(b, name).cpu()):
            raise AssertionError(f"{what}: {name} differs")


def _point_line(r) -> str:
    return (f"{r.param:g}: {r.frame_errors}/{r.frames} frames wrong (FER {r.fer:.4f}), bit errors {r.bit_errors}, "
            f"undetected {r.undetected_errors}, mean iterations {r.mean_iters:.2f}, {r.seconds:.2f} s")


def _simulator_phase(dev, clock_mhz: float) -> int:
    """Phase 9 (see the module docstring). Returns K1's launches in the
    bp waterfall."""
    import dataclasses

    import numpy as np
    import torch

    from dna_ldpc_tpu_torch import cli
    from dna_ldpc_tpu_torch.models.ldpc_graph import LdpcGraph
    from dna_ldpc_tpu_torch.models.mod2 import random_codewords
    from dna_ldpc_tpu_torch.models.rs_ldpc import build_rs_ldpc, dna_storage_pchk
    from dna_ldpc_tpu_torch.ops import bp_cuda
    from dna_ldpc_tpu_torch.ops import simulation as sim
    from dna_ldpc_tpu_torch.ops.channels import bsc_flips
    from dna_ldpc_tpu_torch.ops.faid import faid_decode, lut_rule
    from dna_ldpc_tpu_torch.pipeline.decode import deployed_graph
    from dna_ldpc_tpu_torch.utils import roofline
    from dna_ldpc_tpu_torch.utils.io_formats import read_pchk

    H, graph = dna_storage_pchk(), deployed_graph()
    rate = (H.n_cols - H.n_rows) / H.n_cols
    cfg_bp = sim.SimConfig(decoder="bp", channel="awgn", max_iter=50, batch=BP_BATCH, target_frame_errors=50,
                           max_frames=BP_MAX_FRAMES, device=str(dev))

    # (a) the bp waterfall through K1
    bp_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    res_bp = sim.run_simulation(H, SIM_EBNO, cfg_bp, n_codewords=64, graph=graph)
    torch.cuda.synchronize()
    wall = time.time() - t0
    k1_launches = bp_cuda.launches
    for r in res_bp:
        print(f"[9a] bp AWGN Eb/No {_point_line(r)}")
    fer = [r.fer for r in res_bp]
    print(f"[9a] run_simulation wall {wall:.2f} s (64 random codewords drawn on the host included), "
          f"batch {BP_BATCH}, K1 launches {k1_launches}")
    if k1_launches == 0:
        raise AssertionError("the bp waterfall never launched K1")
    if any(b > a for a, b in zip(fer, fer[1:])) or not fer[0] > 0 or not fer[-1] < fer[0]:
        raise AssertionError(f"bp FER does not fall with Eb/No: {fer}")

    # the codewords run_simulation drew, for the steps below
    cws = random_codewords(H.to_dense(), 64, np.random.default_rng(cfg_bp.seed))
    cw_dev = torch.as_tensor(cws, device=dev)

    def batch_of(cfg, param, batch_index=0, rows=None):
        """Channel output of the simulator's batch ``batch_index`` (or of
        ``rows`` frames drawn by its generator)."""
        idx = (torch.arange(rows or cfg.batch, device=dev) + batch_index * cfg.batch) % len(cws)
        return sim._apply_channel(cfg, cw_dev[idx], sim.batch_generator(cfg.seed, batch_index, dev), param, rate)

    def ms_per_iteration(cfg, g, param) -> float:
        """One batch decoded twice; the second timed, over the loop's passes."""
        rx = batch_of(cfg, param)
        sim._decode(cfg, g, rx)
        torch.cuda.synchronize()
        t0 = time.time()
        res = sim._decode(cfg, g, rx)
        torch.cuda.synchronize()
        return (time.time() - t0) * 1e3 / max(int(res.iterations.max()), 1)

    # (b) the same points with min-sum on the gather path
    cfg_ms = dataclasses.replace(cfg_bp, decoder="min_sum", batch=ZOO_BATCH, max_frames=ZOO_MAX_FRAMES)
    before = bp_cuda.launches
    res_ms = [sim.simulate_point(H, graph, cws, p, cfg_ms, rate) for p in SIM_EBNO]
    for r in res_ms:
        print(f"[9b] min_sum AWGN Eb/No {_point_line(r)}")
    if bp_cuda.launches != before:
        raise AssertionError("min-sum launched the BP kernel")
    if any(b.fer > a.fer for a, b in zip(res_ms, res_ms[1:])):
        raise AssertionError(f"min-sum FER rises with Eb/No: {[r.fer for r in res_ms]}")

    # (c) K1 against its twin on one simulator batch, both modes
    llr = batch_of(cfg_bp, 4.25)
    blocked = graph.blocked
    k_es = bp_cuda.bp_decode_blocked(blocked, llr, 50)
    k_fw = bp_cuda.bp_decode_blocked(blocked, llr, 50, early_stop=False)
    r_es = bp_cuda.bp_decode_blocked_ref(blocked, llr, 50)
    r_fw = bp_cuda.bp_decode_blocked_ref(blocked, llr, 50, early_stop=False)
    torch.cuda.synchronize()
    _same(k_es, r_es, "K1 vs twin (early stop)")
    _same(k_fw, r_fw, "K1 vs twin (fixed work)")
    _same(k_fw, k_es, "K1 fixed work vs early stop")
    ms_es = _cuda_ms(lambda: bp_cuda.bp_decode_blocked(blocked, llr, 50), 3)
    ms_fw = _cuda_ms(lambda: bp_cuda.bp_decode_blocked(blocked, llr, 50, early_stop=False), 3)
    n_fail = int((~k_es.success).sum())
    n_edges = blocked.G * blocked.J * blocked.q
    b_es, _ = roofline.k1_bound_ms(n_edges, blocked.n_vars, k_es.iterations.tolist(), clock_mhz)
    b_fw, by = roofline.k1_bound_ms(n_edges, blocked.n_vars, [50] * BP_BATCH, clock_mhz)
    print(f"[9c] K1 bound ({by}): early-stopped {b_es:.3f} ms ({100 * b_es / ms_es:.1f} % reached), fixed work "
          f"{b_fw:.3f} ms ({100 * b_fw / ms_fw:.1f} % reached)")
    print(f"[9c] K1 vs twin on a {BP_BATCH}-frame simulator batch at 4.25 dB ({n_fail} frames fail, mean iterations "
          f"{k_es.iterations.float().mean().item():.2f}): early stop and fixed work both equal to the twin and to "
          f"each other; K1 {ms_es:.3f} ms ({BP_BATCH * 1e3 / ms_es:.0f} cw/s) early-stopped, {ms_fw:.3f} ms "
          f"({BP_BATCH * 1e3 / ms_fw:.0f} cw/s, {ms_fw / 50:.3f} ms per iteration) fixed work of 50 iterations")
    k1_small = _cuda_ms(lambda: bp_cuda.bp_decode_blocked(blocked, llr[:SMALL_BATCH], 50, early_stop=False), 3)
    per_iter = [f"bp (K1) {k1_small / 50:.3f} / {ms_fw / 50:.3f}"]
    for decoder, channel, param in [("min_sum", "awgn", 4.25)] + ZOO_POINTS:
        cfg = dataclasses.replace(cfg_ms, decoder=decoder, channel=channel)
        small = ms_per_iteration(dataclasses.replace(cfg, batch=SMALL_BATCH), graph, param)
        per_iter.append(f"{decoder} {small:.3f} / {ms_per_iteration(cfg, graph, param):.3f}")
    print(f"[9c] ms per iteration on the deployed code at batch {SMALL_BATCH} / batch {ZOO_BATCH} "
          f"(K1: {BP_BATCH}, fixed work): " + "; ".join(per_iter))

    # (d) one point of each other decoder and channel, equal to the CPU on 8 frames
    for decoder, channel, param in ZOO_POINTS:
        cfg = dataclasses.replace(cfg_ms, decoder=decoder, channel=channel)
        r = sim.simulate_point(H, graph, cws, param, cfg, rate)
        rx = batch_of(cfg, param, rows=8)
        _same(sim._decode(cfg, graph, rx), sim._decode(cfg, graph, rx.cpu()), f"{decoder} on the card vs the CPU")
        print(f"[9d] {decoder} {channel.upper()} at {_point_line(r)}; 8 frames equal to the CPU's")
        if decoder == "bec" and r.undetected_errors:
            raise AssertionError("peeling reported success on a wrong word")
    H6 = build_rs_ldpc(6, 32, 3)
    if set(H6.col_weights().tolist()) != {3}:
        raise AssertionError("the LUT FAID code must have every column of weight 3")
    g6 = LdpcGraph.from_sparse(H6)
    cw6 = torch.as_tensor(random_codewords(H6.to_dense(), 256, np.random.default_rng(7)), device=dev)
    hard = bsc_flips(sim.batch_generator(7, 0, dev), cw6, 0.003)
    lut = faid_decode(g6, hard, 50, lut_rule())
    _same(lut, faid_decode(g6, hard.cpu(), 50, lut_rule()), "LUT FAID on the card vs the CPU")
    print(f"[9d] LUT FAID (planjery7_t2) on the {H6.n_rows} x {H6.n_cols} column-weight-3 code, BSC 0.003: "
          f"{int((lut.bits != cw6).any(1).sum())}/256 frames wrong, mean iterations "
          f"{lut.iterations.float().mean().item():.2f}; equal to the CPU's")

    # (e) error cases saved on the card replay there bit for bit
    cfg_e = dataclasses.replace(cfg_bp, batch=256, target_frame_errors=1, max_frames=256, save_error_cases=3)
    r = sim.simulate_point(H, graph, cws, 4.0, cfg_e, rate)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as d:
        path = os.path.join(d, "cases.json")
        sim.save_error_cases(path, [r])
        cases = sim.load_error_cases(path)
    if not cases:
        raise AssertionError("no error case saved at 4.0 dB")
    for case in cases:
        seed, bi = case.key_data
        rx_full = batch_of(cfg_e, case.param, bi)
        full = sim._decode(cfg_e, graph, rx_full)
        res, cw, rx = sim.replay_error_case(H, graph, cws, case, cfg_e)
        if seed != cfg_e.seed or case.device != dev.type or not np.array_equal(rx, rx_full[case.slot].cpu().numpy()):
            raise AssertionError("replayed channel output differs")
        for name in ("bits", "success", "unsat", "iterations"):
            if not torch.equal(getattr(res, name)[0], getattr(full, name)[case.slot]):
                raise AssertionError(f"replayed {name} differs")
        if not (res.bits[0].cpu().numpy() != cw).any():
            raise AssertionError("a replayed error case decoded correctly")
    print(f"[9e] replay: {len(cases)} error cases saved on the card at 4.0 dB replayed bit for bit "
          f"(channel output, bits, unsat, iterations)")

    # (f) the code-construction CLI round trip
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as d:
        f = lambda name: os.path.join(d, name)
        t0 = time.time()
        for argv in (["rs-ldpc", "8", "72", "8", f("code.alist")], ["alist-to-pchk", f("code.alist"), f("code.pchk")],
                     ["pchk-to-alist", f("code.pchk"), f("back.alist")], ["make-gen", f("code.pchk"), f("gen.npz")]):
            if cli.main(argv) != 0:
                raise AssertionError(f"CLI {argv[0]} failed")
        with open(f("code.alist"), "rb") as a, open(f("back.alist"), "rb") as b:
            if a.read() != b.read():
                raise AssertionError("alist -> pchk -> alist is not byte-equal")
        k = len(np.load(f("gen.npz"))["info_cols"])
        np.savetxt(f("msgs.txt"), np.random.default_rng(9).integers(0, 2, (4, k)), fmt="%d")
        if cli.main(["encode", f("code.pchk"), f("msgs.txt"), f("cw.txt")]) != 0:
            raise AssertionError("CLI encode failed")
        cw = np.loadtxt(f("cw.txt"), dtype=np.uint8, ndmin=2)
        Hf = read_pchk(f("code.pchk"))
        if cw.shape != (4, Hf.n_cols) or Hf.mulvec(cw).any():
            raise AssertionError("encoded codewords do not satisfy the pchk")
    print(f"[9f] CLI rs-ldpc 8 72 8 -> alist-to-pchk -> pchk-to-alist (byte-equal) -> make-gen (k = {k}) -> "
          f"encode of 4 messages: codewords satisfy the {Hf.n_rows} x {Hf.n_cols} pchk; {time.time() - t0:.2f} s")
    return k1_launches


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
    from dna_ldpc_tpu_torch.ops.msa import align as msa_align
    from dna_ldpc_tpu_torch.ops.msa import device_msa, mea_cuda, pairhmm_cuda
    from dna_ldpc_tpu_torch.ops.msa.pairhmm import encode_pairs
    from dna_ldpc_tpu_torch.pipeline import decode as trial_decode
    from dna_ldpc_tpu_torch.pipeline.report import parse_result
    from dna_ldpc_tpu_torch.pipeline.simulate import (
        ChannelModel, encode_oligos, group_union_codewords, simulate_reads,
    )
    from dna_ldpc_tpu_torch.utils import roofline
    from dna_ldpc_tpu_torch.utils.io_formats import write_lines, write_vector

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0])
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
    cw = group_union_codewords(code, 64, rng)
    llr = _coverage_llrs(rng, cw, 3.7, 0.02, dev)
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
    low = _coverage_llrs(rng, group_union_codewords(code, 64, rng), 1.5, 0.05, dev)
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
    k1_bound, k1_by = roofline.k1_bound_ms(code.G * code.J * code.q, code.n_vars, k.iterations.tolist(), clock_mhz)
    print(f"[2] K1 bp_blocked vs twin: 64 codewords, {n_ok} decoded, bit errors {bit_err}, "
          f"mean iterations {k.iterations.float().mean().item():.2f}; equal; kernel "
          f"{k1_ms:.3f} ms ({64e3 / k1_ms:.0f} cw/s), twin {k1_plain:.3f} ms "
          f"({64e3 / k1_plain:.0f} cw/s); low coverage: {n_capped} of 64 words at the "
          f"200-iteration cap, bits, unsat and iterations equal; bound {k1_bound:.4f} ms ({k1_by}, SM clock "
          f"{clock_mhz:.0f} MHz), {100 * k1_bound / k1_ms:.1f} % reached")

    # ---- 3. K2 against its twin ------------------------------------------
    Lmax = 160
    xs, ys = _noisy_pairs(rng, 512)
    more_x, more_y = _noisy_pairs(np.random.default_rng(3), K2_TRIAL_PAIRS - 512)  # rng stays as the trial needs it
    X, Y, lx, ly = encode_pairs(xs + more_x, ys + more_y, Lmax)
    big = [torch.as_tensor(a, device=dev) for a in (X, Y, lx, ly)]
    args = [a[:512] for a in big]
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
    k2_bound, k2_by = roofline.k2_bound_ms(lx[:512], ly[:512], Lmax, clock_mhz)
    n_differ = int((post_k != post_r).sum())
    print(f"[3] K2 pairhmm vs twin: 512 pairs at Lmax={Lmax}; posterior max abs diff "
          f"{k2_err:.3e} (atol = rtol = 1e-4), {n_differ} of {post_k.numel()} entries differ at all, "
          f"EA max abs diff vs twin {ea_diff:.3e}, "
          f"EA == native mea_score; "
          f"kernel {k2_ms * 1e3 / 512:.3f} ms per 1000 pairs, twin "
          f"{k2_plain * 1e3 / 512:.3f} ms per 1000 pairs; bound {k2_bound * 1e3 / 512:.3f} ms per 1000 pairs "
          f"({k2_by}), {100 * k2_bound / k2_ms:.1f} % reached")
    # the size of one launch of the trial: this is the shape the kernels line reports
    post_b, ea_b = pairhmm_cuda.post_ea(*big, Lmax)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    post_rb, ea_rb = pairhmm_cuda.post_ea_ref(*big, Lmax)  # about ten seconds: timed in the call that is compared
    stop.record()
    torch.cuda.synchronize()
    k2_plain_big = start.elapsed_time(stop)
    k2_err_big = (post_b - post_rb).abs().max().item()
    if not torch.allclose(post_b, post_rb, atol=1e-4, rtol=1e-4):
        raise AssertionError(f"K2 posteriors of {K2_TRIAL_PAIRS} pairs differ from the twin's (max abs {k2_err_big:.3e})")
    if not (torch.equal(post_b[:512], post_k) and torch.equal(ea_b[:512], ea_k)):
        raise AssertionError("K2 gives a pair other values in a larger batch")
    n_differ_big, ea_diff_big = int((post_b != post_rb).sum()), (ea_b - ea_rb).abs().max().item()
    del post_b, post_rb
    k2_ms_big = _cuda_ms(lambda: pairhmm_cuda.post_ea(*big, Lmax), 3)
    k2_bound_big, k2_by_big = roofline.k2_bound_ms(lx, ly, Lmax, clock_mhz)
    print(f"[3] K2 on {K2_TRIAL_PAIRS} pairs (one launch of the trial's size): posterior max abs diff {k2_err_big:.3e}, "
          f"{n_differ_big} entries differ at all, EA max abs diff vs twin {ea_diff_big:.3e}, the first 512 pairs "
          f"bit-equal to the small batch; kernel {k2_ms_big:.3f} ms ({k2_ms_big * 1e3 / K2_TRIAL_PAIRS:.3f} per 1000 "
          f"pairs), twin {k2_plain_big:.1f} ms; bound {k2_bound_big:.3f} ms ({k2_by_big}), "
          f"{100 * k2_bound_big / k2_ms_big:.1f} % reached")

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

    # ---- 5. one full trial through the device MSA --------------------------
    cws = group_union_codewords(code, 272, rng)
    if dna_storage_pchk().mulvec(cws).any():
        raise AssertionError("synthetic codewords violate H")
    reads, quals = simulate_reads(encode_oligos(cws), 72000, ChannelModel(), seed=7)
    # decode_trial's LLR table, captured from its call of compute_trial_llrs
    llr_tables = []
    compute_trial_llrs = trial_decode.compute_trial_llrs

    def capture_llrs(*args, **kwargs):
        llr_tables.append(compute_trial_llrs(*args, **kwargs))
        return llr_tables[-1]

    trial_decode.compute_trial_llrs = capture_llrs

    def run_trial():
        """decode_trial on the card with every launch count reset just
        before and read just after; returns (result, LLR table, launches,
        MSA clusters, host-aligner fallbacks, wall seconds)."""
        bp_cuda.launches = 0
        pairhmm_cuda.launches = pairhmm_cuda.pairs = 0
        mea_cuda.launches = mea_cuda.merge_launches = 0
        msa_align.msa_clusters = msa_align.fallback_clusters = 0
        torch.cuda.synchronize()
        t0 = time.time()
        res = trial_decode.decode_trial(reads, quals, cws, trial_decode.TrialConfig())
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {"bp_blocked": bp_cuda.launches, "pairhmm": pairhmm_cuda.launches,
                    "merge_dp": mea_cuda.merge_launches, "mea_dp": mea_cuda.launches}
        return res, llr_tables[-1], launches, msa_align.msa_clusters, msa_align.fallback_clusters, wall

    res, llr_dev, launches, n_msa, n_fb, wall = run_trial()
    msa_pairs = pairhmm_cuda.pairs
    print(f"[5] trial (device MSA): {len(reads)} reads, n_reads_kept {res.n_reads_kept}, MSA clusters "
          f"{n_msa}, MSA pairs {msa_pairs}, host-aligner fallbacks {n_fb}, fail_first {res.fail_first}, "
          f"fail_final {res.fail_final}, n_anneal_iters {res.n_anneal_iters}, erasure strands "
          f"{res.n_erasure_strands}, wall {wall:.2f} s, launches {launches}")
    print("[5] phase_times: " + ", ".join(f"{k}={v:.4f}" for k, v in res.phase_times.items()))
    if res.fail_final or not np.array_equal(res.decoded_bits, cws):
        raise AssertionError(f"trial not recovered: fail_final {res.fail_final}")
    if min(launches[name] for name in ("bp_blocked", "pairhmm", "merge_dp")) == 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if n_fb > 0.01 * n_msa:
        raise AssertionError(f"{n_fb} of {n_msa} MSA clusters fell back to the host aligner")

    # ---- 6. the same reads through the host-aligner MSA flow ----------------
    os.environ["DNA_LDPC_DEVICE_MSA"] = "0"
    try:
        res0, llr_host, launches0, _, _, wall0 = run_trial()
    finally:
        del os.environ["DNA_LDPC_DEVICE_MSA"]
    n_diff = int((llr_host != llr_dev).sum())
    print(f"[6] trial (DNA_LDPC_DEVICE_MSA=0): fail_first {res0.fail_first}, fail_final "
          f"{res0.fail_final}, n_anneal_iters {res0.n_anneal_iters}, wall {wall0:.2f} s, launches "
          f"{launches0}; LLR-table entries that differ from phase 5: {n_diff} of {llr_dev.size}")
    print("[6] phase_times: " + ", ".join(f"{k}={v:.4f}" for k, v in res0.phase_times.items()))
    for name in ("fail_first", "fail_final", "n_anneal_iters"):
        if getattr(res0, name) != getattr(res, name):
            raise AssertionError(f"{name} differs between the device MSA and the host-aligner flow")

    # ---- 7. the merge kernels against their twins ----------------------------
    nb, C7, Cmax = 8, 512, Lmax + device_msa.COLUMN_SLACK
    merge_err, merge_lines, merge_stats = 0, [], {}
    for k, margs, _ in _merge_waves(np.random.default_rng(8), dev, nb, C7, Lmax):
        if k in (0, nb - 2):
            _, _, _, mA, mB, wA, wB, _, _ = margs
            codes_k, pos_k = mea_cuda.merge_walk(*margs)
            codes_r, pos_r = mea_cuda.merge_walk_ref(*margs)
            torch.cuda.synchronize()
            err = max((codes_k.int() - codes_r.int()).abs().max().item(), (pos_k - pos_r).abs().max().item())
            if err:
                raise AssertionError(f"merge_dp differs from its twin at wave {k} (max abs {err})")
            merge_err = max(merge_err, err)
            ms = _cuda_ms(lambda: mea_cuda.merge_walk(*margs), 20)
            plain = _cuda_ms(lambda: mea_cuda.merge_walk_ref(*margs), 2)
            composite = _cuda_ms(
                lambda: mea_cuda.mea_walk(mea_cuda._build_post(*margs[:5], Cmax, Lmax), wA, wB, Cmax), 5)
            nA, nB = mA.sum(1).tolist(), mB.sum(1).tolist()
            bound, by = roofline.merge_bound_ms(nA, nB, wA.tolist(), wB.tolist(), Cmax, clock_mhz)
            merge_lines.append(
                f"[7] merge_dp vs twin, wave {k + 1} of {nb - 1}: {C7} clusters of {nb} reads, "
                f"{sum(nA) / C7:.2f} x {sum(nB) / C7:.2f} reads a side, mean widths {wA.float().mean().item():.1f} x "
                f"{wB.float().mean().item():.1f}, Cmax={Cmax}, mean path length "
                f"{(codes_k != 0).sum(1).float().mean().item():.1f}; codes and positions equal; kernel {ms:.3f} ms, "
                f"BuildPost into device memory + mea_dp {composite:.3f} ms, twin {plain:.3f} ms per merge; bound "
                f"{bound:.4f} ms ({by}), {100 * bound / ms:.1f} % reached")
            if k == 0:
                merge_stats = {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by}
                # mea_dp, the entry for a caller that holds the plane: the same clusters' BuildPost planes
                plane = mea_cuda._build_post(*margs[:5], Cmax, Lmax)
                codes_p, pos_p = mea_cuda.mea_walk(plane, wA, wB, Cmax)
                codes_pr, pos_pr = mea_cuda.mea_walk_ref(plane, wA, wB, Cmax)
                torch.cuda.synchronize()
                mea_err = max((codes_p.int() - codes_pr.int()).abs().max().item(),
                              (pos_p - pos_pr).abs().max().item())
                if mea_err:
                    raise AssertionError(f"mea_dp differs from its twin (max abs {mea_err})")
                if not (torch.equal(codes_p, codes_k) and torch.equal(pos_p, pos_k)):
                    raise AssertionError("mea_dp on the BuildPost plane and merge_dp give different paths")
                path_len = (codes_p != 0).sum(1).float().mean().item()
                mea_ms = _cuda_ms(lambda: mea_cuda.mea_walk(plane, wA, wB, Cmax), 20)
                mea_plain = _cuda_ms(lambda: mea_cuda.mea_walk_ref(plane, wA, wB, Cmax), 2)
                mea_bound, mea_by = roofline.mea_bound_ms(wA.tolist(), wB.tolist(), Cmax, clock_mhz)
                del plane
    print(f"[7] mea_dp vs twin: {C7} clusters of {nb} reads, first progressive wave, Cmax={Cmax}, "
          f"mean path length {path_len:.1f}; codes and positions equal, and equal to merge_dp's; kernel "
          f"{mea_ms:.3f} ms, twin {mea_plain:.3f} ms per merge of {C7} clusters; bound {mea_bound:.4f} ms "
          f"({mea_by}), {100 * mea_bound / mea_ms:.1f} % reached")
    print("\n".join(merge_lines))
    del margs

    # ---- 8. the same trial through the command line ------------------------
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as d:
        for i in range(len(cws)):
            write_vector(os.path.join(d, f"codeword_n18432_m1860_{i + 1}.txt"), cws[i])
        write_lines(os.path.join(d, "final_DNA.txt"), encode_oligos(cws))
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "dna_ldpc_tpu_torch.cli", "simulate", "--rs", "72000", "--start", "0",
             "--end", "1", "--epsil", "0.02", "--seed", "7", "--oligos", os.path.join(d, "final_DNA.txt"),
             "--codeword-dir", d, "--out-dir", d],
            cwd=REPO, capture_output=True, text=True, timeout=600,
        )
        cli_s = time.time() - t0
        if proc.returncode != 0:
            raise AssertionError(
                f"CLI simulate exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}"
            )
        with open(os.path.join(d, "o_72000_0_0.020000_result.txt")) as f:
            report = parse_result(f.read())
    if not report["success"] or report["fail_final"] != res.fail_final:
        raise AssertionError(f"CLI trial report: {report}")
    print(f"[8] CLI simulate: exit 0 in {cli_s:.2f} s (process included); report {report}; "
          f"{proc.stdout.strip().splitlines()[-1]}")

    # ---- 9. the code simulator on the card ----------------------------------
    k1_sim_launches = _simulator_phase(dev, clock_mhz)

    kernels = [
        {"name": "bp_blocked", "route": "cuda", "source": "dna_ldpc_tpu_torch/csrc/bp_blocked.cu",
         "replaces": "dna_ldpc_tpu/ops/bp_pallas.py:55", "launches": launches["bp_blocked"] + k1_sim_launches,
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None},
        {"name": "pairhmm", "route": "cuda", "source": "dna_ldpc_tpu_torch/csrc/pairhmm.cu",
         "replaces": "dna_ldpc_tpu/ops/msa/pairhmm_pallas.py:114",
         "launches": launches["pairhmm"], "max_abs_err": max(k2_err, k2_err_big), "ms": k2_ms_big,
         "plain_ms": k2_plain_big, "bound_ms": k2_bound_big, "bound_by": k2_by_big, "library_ms": None},
        {"name": "mea_dp", "route": "cuda", "source": "dna_ldpc_tpu_torch/csrc/mea_dp.cu",
         "replaces": "dna_ldpc_tpu/ops/msa/device_msa.py:212", "launches": launches["mea_dp"],
         "max_abs_err": float(mea_err), "ms": mea_ms, "plain_ms": mea_plain, "bound_ms": mea_bound,
         "bound_by": mea_by, "library_ms": None},
        {"name": "merge_dp", "route": "cuda", "source": "dna_ldpc_tpu_torch/csrc/mea_dp.cu",
         "replaces": "dna_ldpc_tpu/ops/msa/device_msa.py:175", "launches": launches["merge_dp"],
         "max_abs_err": float(merge_err), **merge_stats, "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
