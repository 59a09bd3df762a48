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
7. the merge kernel of the device MSA against its twin on a bucket-8
   batch of 512 clusters (reads as in phase 3, Lmax = 160, Cmax = 192),
   codes and positions bit-equal: ``merge_dp`` (BuildPost + MEA DP + walk
   from the pair posteriors) at the first progressive wave (single reads
   a side) and at the last (several gapped reads a side);
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
   per second with and without early stop;
10. the per-cluster route, ``compute_trial_llrs(..., aligner=msa_aligner)``
    (what ``decode_trial(..., aligner=msa_aligner)`` runs), on the reads of
    the first quarter of phase 5's strands (1,086 MSA clusters; the whole
    trial's 4,285 take too long for this script, ``PERF.md`` §5): one
    ``align()``
    per mixed cluster, K2 launched once per cluster on the card, the host
    C++ aligner after it. The LLR entries that differ from phase 6's rows
    are printed (the consistency sums run on the CPU here, in a ``bmm`` on
    the card there), and phase 6's table with these rows spliced in must
    decode to phase 6's ``fail_first``, ``fail_final`` and
    ``n_anneal_iters``; the seconds per cluster of each stage (the
    pre-filter, the aligner and, inside it, ``align()``'s pair-HMM, EA,
    consistency and host aligner, counting) are printed;
11. (a) the general-table pair-HMM (plain torch) with the default tables on
    phase 3's 512 pairs, within atol = rtol = 1e-4 of K2, its time per
    1000 pairs beside K2's; (b) diversified ensembles of 4 replicates on
    16 mixed clusters of phase 5 (replicate 0 through K2, 1-3 through the
    general path), each replicate equal row for row to the CPU's, with
    their CC values and qscores against replicate 0;
12. index-free clustering: ``kmer_cluster(k=5, threshold=0.75)`` of 72,000
    reads of 18,432 random 152-nt oligos on the card (purity at least
    0.99 against the source oligos), its first 4,096 reads equal to the
    CPU's assignment, and ``super_align`` of the reads of 64 oligos (rows
    of one width that de-gap to their inputs, equal to the CPU's);
13. double coverage, 140,000 reads of phase 5's pool (seed 5):
    ``fail_final == []``, with the clusters handed to the host aligner
    (``fallback_clusters``);
14. the reference bench's annealing stress point (65,500 reads of the pool,
    ``ChannelModel()``, seed 123): every codeword decodes at the first pass
    there. Then 65,480 reads, where six codewords fail and annealing leaves
    two: ``fail_first``, ``fail_final`` and ``n_anneal_iters`` must be those
    the JAX package's decode gives on the same reads on the CPU
    (``STRESS_REFERENCE``). Then the lowered count ``STRESS_READS``:
    ``n_anneal_iters > 0``, ``fail_final == []``, and the
    ``DNA_LDPC_DEVICE_MSA=0`` run's outcome. The pool's failures set in
    abruptly and not monotonically in the read count, so the counts are
    fixed, not searched for;
15. SC-LDPC windowed decoding on the card (``ops/scldpc.py``: the windows'
    BP through the window kernel ``csrc/window_bp.cu``, the peeling step
    eager torch), on the chain
    ``couple(build_rs_ldpc(6, 6, 3), L=64, w=2)`` (12,672 x 24,576, windows
    of W = 6: 1,152 x 3,072, not blocked) and the all-zero codeword:
    (a) 1,024 AWGN frames through ``sliding_window_decode`` and
    ``pipeline_decode``, which must be equal and must both have launched
    the window kernel once a window (a tick) and K1 never, the first 8
    frames equal to ``device="cpu"``, BER below the channel's; frames per
    second, FER, and the ms per BP iteration of one window (the kernel
    beside its plain version, the eager ``bp_decode_generic``, and beside
    its bound, ``utils/roofline.py::window_bp_bound_ms``: the count of the
    benchmark's ``wbp_roofline.sc``) at a batch of 32 and 1,024, and per
    peeling round; (c) the same three times on the benchmark cell's window
    (lifting 256: 4,608 x 12,288), its line in ``kernels``;
    (b) 1,024 BEC frames through every windowed BEC variant (``_oc`` and
    ``_step`` with eta = 2, ``_ra`` on ``ra_extend``'s layout) and the
    global ``bec_decode_save`` / ``bec_decode_target``, each equal to
    ``device="cpu"`` on 8 frames exactly; erasures left and wall of each;
16. multi-process BP (``parallel/``): (a) a one-rank NCCL group, mesh
    (cw 1, graph 1): ``make_sharded_cuda_decoder`` (K1 on the rank's
    codeword rows) on the LLRs of phase 5's first decode, gathered over
    ``cw``, bit-equal to ``bp_decode_blocked``; ``make_sharded_decoder``
    and ``make_sharded_blocked_decoder`` on 64 of those words at 50
    iterations outcome-equal to ``bp_decode_generic``, with their ms per
    iteration beside K1's; (b) two processes sharing the card through
    ``initialize()`` from the environment (gloo: two NCCL ranks cannot
    share one card), mesh (cw 2, graph 1), K1 on 136 words each, the
    gathered result bit-equal to 16a's; each rank reports its K1 launches;
17. the batched consistency transform, ``consistency_clusters``, on the
    card and with ``device="cpu"``, on the pair posteriors (K2, Lmax = 160,
    its launches reset just before and read just after) of the first 1,024
    of phase 10's MSA clusters of phase 5's reads: within atol = 2e-5,
    rtol = 1e-4 of each other, the clusters the routing passes through or
    sends to the host loop bit-equal; the clusters per bucket, the host
    loop's share and the walls of both calls beside the card's name and
    power limit; then the consistency kernel alone at the trial's shapes
    (buckets 4, 8 and 12 with 3, 5 and 9 reads of 152 nt, 65 clusters,
    L = 160, 2 iterations; K2 posteriors): ``assemble_transform`` and the
    kernel's device time beside the bound (``transform_work`` at the f32
    peak) and the plain version (the block product through ``torch.bmm``
    that the port ran before the kernel, also ``library_ms``), within one
    bf16 step of it.

Phases 10-12 and 17 print the K2 launches they made. Phases 2, 3, 7, 9c
and 15 print each kernel's time beside its bound at the
timed shape — the least time the card could take for that work
(``dna_ldpc_tpu_torch/utils/roofline.py``: the bytes that must move at
3.35 TB/s against the f32 operations at 67 TFLOP/s and the
special-function operations at 16 per clock and SM, from this run's
shapes and the iteration counts it returned) — and the share reached.

The line before the last is a JSON object with each kernel's launches on
the trial of phase 5 (K1: plus the waterfall of phase 9a and the sharded
decodes of phase 16, its subprocesses' included), error against
its twin, time beside the twin's and beside its bound, and
``library_ms`` (null for K1, K2 and ``merge_dp``: no single PyTorch call
computes them; the consistency kernel's is its plain version's block
product through ``torch.bmm``, at bucket 8); the window kernel's launches
are phase 15's, its times those of the cell's window at 1,024 frames.
The last line is ``{"ok": true, "device": {...}}``. Without CUDA, or
without the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import importlib
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
ENSEMBLE_CLUSTERS = 16  # phase 11b
PER_CLUSTER_STRANDS = 18432 // 4  # phase 10: the first quarter of the strands (1,086 MSA clusters)
# phase 14: the bench's count (bench.py:141-153); a count whose outcome the JAX package's decode
# gives on the CPU on the same reads (fail_first, fail_final, n_anneal_iters:
# tests/test_torch_stress_point.py); a count at which a codeword fails and annealing recovers it
STRESS_BENCH_READS = 65500
STRESS_REFERENCE = (65480, [77, 90, 106, 129, 149, 260], [90, 149], 37)
STRESS_READS = 65340
ZOO_POINTS = [("quantized_min_sum", "awgn", 4.75), ("gallager_b", "bsc", 0.005), ("faid", "bsc", 0.003),
              ("bec", "bec", 0.055)]
# phase 15: the (3,6)-regular base of the SC-LDPC literature at lifting 64 (192 x 384), L = 64
# positions, memory 2: a 12,672 x 24,576 chain, windows of 6 positions (1,152 x 3,072); the
# all-zero codeword through AWGN at SC_EBNO and through the BEC at SC_ERASURE (where the base
# windowed peel leaves erasures in about a fifth of the frames)
SC_FRAMES, SC_W, SC_ITERS, SC_EBNO, SC_ERASURE = 1024, 6, 20, 2.5, 0.42
SC_BEC_VARIANTS = [("sliding_window_bec", {}), ("sliding_window_bec_save", {}), ("sliding_window_bec_two", {}),
                   ("sliding_window_bec_two_cross", {}), ("sliding_window_bec_two_indi", {}),
                   ("sliding_window_bec_target", {}), ("sliding_window_bec_step", {"eta": 2}),
                   ("sliding_window_bec_oc", {"eta": 2}), ("sliding_window_bec_ra", {})]
SHARDED_WORDS, SHARDED_ITERS = 64, 50  # phase 16a: the check- and coset-sharded decoders
# phase 17: the first of phase 10's 1,086 MSA clusters, routed with consistency_clusters' default
CONSISTENCY_CLUSTERS, MIN_DEVICE_CLUSTERS = 1024, 4

# phase 16b: one rank of two that share the card, configured through the environment
PHASE16_WORKER = r"""
import os, sys
import numpy as np
import torch

from dna_ldpc_tpu_torch.models.blocked import dna_storage_blocked
from dna_ldpc_tpu_torch.ops import bp_cuda
from dna_ldpc_tpu_torch.parallel import distributed
from dna_ldpc_tpu_torch.parallel.sharded_bp import make_sharded_cuda_decoder

inputs, out = sys.argv[1:3]
torch.cuda.set_device(0)  # both ranks drive the one card
torch.cuda.init()
distributed.initialize(backend="gloo")  # two NCCL ranks cannot share one card
mesh = distributed.global_mesh(max_graph=1)
assert tuple(mesh.shape) == (2, 1), mesh.shape
llr = distributed.process_local_batch(np.load(inputs)["llr"], mesh)
decode = make_sharded_cuda_decoder(dna_storage_blocked(), mesh, 200)
bp_cuda.launches = 0
local = decode(llr)
torch.cuda.synchronize()
launches = bp_cuda.launches
full = distributed.allgather_result(local, mesh)
if int(os.environ["RANK"]) == 0:
    np.savez(out, **{f: getattr(full, f).cpu().numpy() for f in ("bits", "success", "iterations", "unsat")})
# leave together and tear the groups down before exit: a gloo group left to the
# interpreter's shutdown can abort a rank whose peers have already gone
torch.distributed.barrier()
torch.distributed.destroy_process_group()
print("RANK", os.environ["RANK"], "ROWS", llr.shape[0], "K1_LAUNCHES", launches, flush=True)
"""


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


def _merge_waves(rng, dev, nb: int, C: int, Lmax: int, consistency_iters: int = 2, posteriors=None):
    """One device-MSA batch and its merges: C clusters of nb reads of one
    strand each, pair posteriors from K2 (``posteriors``, by default
    ``pairhmm.k2_posteriors``), UPGMA join orders. Yields
    (k, margs, step) for a batched merge: the progressive waves
    k = 0 .. nb - 2, then, as k = nb - 1, a refinement bipartition of the
    aligned batch (even against odd reads). ``margs`` are the arguments of
    ``mea_cuda.merge_walk``, ``step`` those of ``device_msa._merge_step``
    for the same merge; the batch moves on by ``_merge_step`` between
    yields."""
    import numpy as np
    import torch

    from dna_ldpc_tpu_torch.ops.msa import device_msa

    msa_align = importlib.import_module("dna_ldpc_tpu_torch.ops.msa.align")
    if posteriors is None:
        from dna_ldpc_tpu_torch.ops.msa.pairhmm import k2_posteriors as posteriors
    clusters = [_strand_reads(rng, nb) for _ in range(C)]
    prs = msa_align.cluster_pairs(nb)
    npair = len(prs)
    posts, ea = posteriors(
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


# the consistency kernel alone (phase 17): (bucket, reads a cluster) of the trial's device MSA,
# clusters per call (what the byte budget gave the block product at bucket 8), reads of the oligos' 152 nt
CONSISTENCY_SHAPES, CONSISTENCY_CALL_CLUSTERS, CONSISTENCY_READ_NT = ((4, 3), (8, 5), (12, 9)), 65, 152


def _consistency_times(dev, iters: int = 2) -> dict:
    """The consistency transform at the trial's shapes (CONSISTENCY_SHAPES,
    L = 160, K2 posteriors of reads of one strand): milliseconds per
    ``assemble_transform`` call (the kernel's main-path entry, with the gap
    row's zero fill and the work list's upload) and the kernel's device
    time alone (``torch.profiler``); the plain version, which is the block
    product through ``torch.bmm`` that the port ran before the kernel, as
    ``plain_ms`` (also ``library_ms``); the bound (``transform_work`` at
    the reads' true lengths, f32 FLOPs at 67 TFLOP/s or bytes at 3.35 TB/s)
    and the share; the largest bf16 step between the kernel and the plain
    version. Checkouts whose ``assemble_transform`` takes no lengths give
    their own transform's time under the same names."""
    import inspect

    import numpy as np
    import torch

    from dna_ldpc_tpu_torch.ops.msa import consistency, device_msa
    from dna_ldpc_tpu_torch.ops.msa.align import cluster_pairs
    from dna_ldpc_tpu_torch.ops.msa.pairhmm import k2_posteriors
    from dna_ldpc_tpu_torch.utils import roofline

    takes_lengths = "lengths" in inspect.signature(device_msa.assemble_transform).parameters
    plain = getattr(consistency, "consistency_core_ref", consistency.consistency_core)
    rng, L, C, out = np.random.default_rng(15), 160, CONSISTENCY_CALL_CLUSTERS, {}
    for nb, n in CONSISTENCY_SHAPES:
        clusters = [_strand_reads(rng, n, CONSISTENCY_READ_NT) for _ in range(C)]
        prs, npair = cluster_pairs(n), nb * (nb - 1) // 2
        posts, _ = k2_posteriors([cl[i] for cl in clusters for i, _ in prs],
                                 [cl[j] for cl in clusters for _, j in prs], L, dev)
        slot = {pair: s for s, pair in enumerate(cluster_pairs(nb))}
        ids, mask = np.zeros(C * npair, np.int64), np.zeros(C * npair, bool)
        lens = np.zeros((C, nb), np.int32)
        for c, cl in enumerate(clusters):
            lens[c, :n] = [len(q) for q in cl]
            for p, pair in enumerate(prs):
                ids[c * npair + slot[pair]], mask[c * npair + slot[pair]] = c * len(prs) + p, True
        ids_t, mask_t = torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev)
        inv_t = torch.full((C,), 1.0 / n, device=dev)
        kw = {"lengths": lens} if takes_lengths else {}

        def kernel():
            return device_msa.assemble_transform(posts, ids_t, mask_t, inv_t, nb, iters, C, L, **kw)

        pm = torch.where(mask_t[:, None, None], posts[ids_t], 0).float().view(C, npair, L, L)
        got = kernel()[:, :, :L, :L].contiguous()
        want = plain(pm, inv_t, nb, iters).to(torch.bfloat16)
        ulps = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs().max().item()
        ms = _cuda_ms(kernel, 5)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            kernel()
            torch.cuda.synchronize()
        kernel_device_ms = sum(e.device_time_total for e in prof.key_averages()
                               if "consistency_kernel" in e.key) / 1e3
        plain_ms = _cuda_ms(lambda: plain(pm, inv_t, nb, iters), 3)
        flops, nbytes = map(sum, zip(*(consistency.transform_work([len(q) for q in cl], iters) for cl in clusters)))
        bound, by = roofline.bound_ms(nbytes, flops)
        out[f"consistency_b{nb}_n{n}"] = {
            "clusters": C, "L": L, "ms": ms, "kernel_device_ms": kernel_device_ms, "plain_ms": plain_ms,
            "library_ms": plain_ms, "bound_ms": bound, "bound_by": by, "share_pct": 100 * bound / ms,
            "kernel_share_pct": 100 * bound / kernel_device_ms if kernel_device_ms else None,
            "max_bf16_steps": ulps,
        }
        del posts, pm, got, want
    return out


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


def _per_cluster_phase(dev, reads, quals, cws, llr_host, res0) -> list[list[str]]:
    """Phase 10: the per-cluster route (``aligner=msa_aligner``) over the
    reads of the first PER_CLUSTER_STRANDS strands of phase 5's trial; its
    LLR rows spliced into phase 6's table must decode to phase 6's
    outcome. Returns the clusters it aligned (pre-filter survivors)."""
    import numpy as np
    import torch

    from dna_ldpc_tpu_torch.ops.msa import msa_aligner, pairhmm_cuda
    from dna_ldpc_tpu_torch.pipeline import decode as trial_decode
    from dna_ldpc_tpu_torch.pipeline.llr import FilteredReads, compute_trial_llrs, rs_filter_reads

    filtered = rs_filter_reads(reads, quals)
    keep = filtered.strands < PER_CLUSTER_STRANDS
    block = FilteredReads([p for p, k in zip(filtered.payloads, keep) if k], filtered.quals[keep],
                          filtered.strands[keep], int(keep.sum()), int(keep.sum()))
    clusters = []
    stages, align_stages = {}, {}

    def aligner(seqs):
        clusters.append(list(seqs))
        return msa_aligner(seqs, timings=align_stages)

    config = trial_decode.TrialConfig()
    pairhmm_cuda.launches = pairhmm_cuda.pairs = 0
    torch.cuda.synchronize()
    t0 = time.time()
    table = compute_trial_llrs(block, config.epsil, aligner=aligner, timings=stages)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, pairs = pairhmm_cuda.launches, pairhmm_cuda.pairs
    spliced = llr_host.copy()
    spliced[:PER_CLUSTER_STRANDS] = table[:PER_CLUSTER_STRANDS]
    n_diff = int((spliced != llr_host).sum())
    _, fail_first, fail_final, n_iters = trial_decode.anneal_decode(
        trial_decode.deployed_graph(), spliced.T.copy(), cws, config)
    print(f"[10] per-cluster route (compute_trial_llrs(aligner=msa_aligner): one align() per mixed cluster, its "
          f"pair-HMM on the card) on strands 0-{PER_CLUSTER_STRANDS - 1}: {len(block.payloads)} reads, "
          f"{len(clusters)} MSA clusters, K2 launches {launches} for {pairs} pairs, {wall:.2f} s "
          f"({1e3 * wall / max(len(clusters), 1):.1f} ms per cluster); LLR entries that differ from phase 6's rows: "
          f"{n_diff} of {spliced[:PER_CLUSTER_STRANDS].size}; phase 6's table with these rows decodes to fail_first "
          f"{fail_first}, fail_final {fail_final}, n_anneal_iters {n_iters}")
    # where a cluster's time goes (host clock): cluster_llr's stages, and align()'s inside "msa"
    # ("pairhmm": K2's launch, the download and bf16 rounding of its posteriors)
    split = {**stages, **{f"msa.{k}": v for k, v in align_stages.items()}}
    print("[10] stages, ms per MSA cluster: " + ", ".join(
        f"{k} {1e3 * v / max(len(clusters), 1):.2f}" for k, v in split.items()))
    if len(clusters) < 1000:
        raise AssertionError(f"the block holds {len(clusters)} MSA clusters, fewer than 1000")
    if (launches, pairs) != (len(clusters), sum(len(c) * (len(c) - 1) // 2 for c in clusters)):
        raise AssertionError("the per-cluster route did not launch K2 once per MSA cluster")
    if (fail_first, fail_final, n_iters) != (res0.fail_first, res0.fail_final, res0.n_anneal_iters):
        raise AssertionError("the per-cluster rows do not decode to phase 6's outcome")
    return clusters


def _general_tables_phase(dev, k2_args, post_k, k2_ms: float, xs, ys) -> None:
    """Phase 11a: the general-table pair-HMM (plain torch) with the default
    tables on phase 3's 512 pairs (``k2_args``: their codes and lengths,
    numpy), against K2's posteriors ``post_k``."""
    import numpy as np
    import torch

    from dna_ldpc_tpu_torch.ops.msa import pairhmm, pairhmm_cuda

    X, Y, lx, ly = k2_args
    Lmax = X.shape[1]
    args = [torch.as_tensor(a, device=dev) for a in (X, Y, pairhmm._rev_pad(X, lx), pairhmm._rev_pad(Y, ly), lx, ly)]
    params = pairhmm.nucleo_params()
    pairhmm_cuda.launches = 0
    post_g, _ = pairhmm._posteriors_device(*args, Lmax, params)
    torch.cuda.synchronize()
    err = (post_g - post_k).abs().max().item()
    if not torch.allclose(post_g, post_k, atol=1e-4, rtol=1e-4):
        raise AssertionError(f"general-table posteriors differ from K2's (max abs {err:.3e})")
    rounded = post_g.to(torch.bfloat16).float().cpu().numpy()
    for p, got in enumerate(pairhmm.batch_posteriors(xs, ys, Lmax, params=params, device=dev)):
        if not np.array_equal(got, rounded[p, : lx[p], : ly[p]]):
            raise AssertionError(f"batch_posteriors(params=) of pair {p} is not the general path's bf16 rounding")
    ms = _cuda_ms(lambda: pairhmm._posteriors_device(*args, Lmax, params), 2)
    if pairhmm_cuda.launches:
        raise AssertionError("the general-table path launched K2")
    print(f"[11a] general-table pair-HMM (plain torch, nucleo_params()) on phase 3's 512 pairs at Lmax={Lmax}: max abs "
          f"diff vs K2 {err:.3e} (atol = rtol = 1e-4); {ms * 1e3 / 512:.1f} ms per 1000 pairs against K2's "
          f"{k2_ms * 1e3 / 512:.3f}; batch_posteriors(params=) returns its bf16 rounding; K2 launches 0")


def _ensemble_phase(dev, clusters) -> None:
    """Phase 11b: diversified ensembles of 4 replicates on the card, each
    replicate equal row for row to the CPU's, on ``clusters`` (phase 10's
    pre-filter survivors, which phase 5 aligned too)."""
    import numpy as np
    import torch

    from dna_ldpc_tpu_torch.ops.msa import pairhmm_cuda
    from dna_ldpc_tpu_torch.ops.msa.ensemble import ensemble_align, qscore, select_by_cc

    if len(clusters) < ENSEMBLE_CLUSTERS:
        raise AssertionError(f"phase 5 gave only {len(clusters)} clusters of >= 3 reads")
    pairhmm_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    card = [ensemble_align(cl, replicates=4, mode="diversified", device=dev) for cl in clusters]
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = pairhmm_cuda.launches
    t0 = time.time()
    host = [ensemble_align(cl, replicates=4, mode="diversified", device="cpu") for cl in clusters]
    wall_cpu = time.time() - t0
    for k, (a, b) in enumerate(zip(card, host)):
        if a != b:
            raise AssertionError(f"ensemble of cluster {k}: the card's replicates differ from the CPU's")
    for k, (cl, ens) in enumerate(zip(clusters, card)):
        cc = select_by_cc(ens)[1]
        qs = [qscore(rep, ens[0]) for rep in ens[1:]]
        print(f"[11b] cluster {k} ({len(cl)} reads): CC {np.round(cc, 4).tolist()}; Q/TC of replicates 1-3 vs 0 "
              + ", ".join(f"{q['Q']:.4f}/{q['TC']:.4f}" for q in qs))
    print(f"[11b] ensemble_align(mode='diversified', replicates=4) on {len(clusters)} clusters of phase 5's pre-filter "
          f"survivors (from phase 10): every replicate equal row for row to device='cpu'; card {wall:.2f} s, CPU {wall_cpu:.2f} s; "
          f"K2 launches {launches} (replicate 0; replicates 1-3 run the general path)")


def _kmer_cluster_phase(dev, n_oligos: int = 18432, n_reads: int = 72000, n_super: int = 64) -> None:
    """Phase 12: k-mer clustering of 72,000 reads of 18,432 random oligos on
    the card; 4,096 reads and a super-alignment of the reads of 64 oligos
    against the CPU."""
    import numpy as np
    import torch

    from dna_ldpc_tpu_torch.ops.cluster import kmer_cluster, super_align
    from dna_ldpc_tpu_torch.ops.msa import pairhmm_cuda
    from dna_ldpc_tpu_torch.pipeline.simulate import ChannelModel, simulate_reads

    seed = 12
    codes = np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng(seed).integers(0, 4, (n_oligos, 152))]
    oligos = [row.tobytes().decode() for row in codes]
    reads, _ = simulate_reads(oligos, n_reads, ChannelModel(), seed=seed)
    source = np.random.default_rng(seed).integers(0, n_oligos, n_reads)  # simulate_reads' first draw
    pairhmm_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    cl = kmer_cluster(reads, k=5, threshold=0.75, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    # purity: reads whose cluster's majority oligo is their own; completeness:
    # reads in the cluster that holds most of their oligo's reads
    pair = np.stack([cl.assignment, source], 1)
    uniq, counts = np.unique(pair, axis=0, return_counts=True)
    by_cluster = np.zeros(cl.n_clusters, np.int64)
    np.maximum.at(by_cluster, uniq[:, 0], counts)
    by_oligo = np.zeros(n_oligos, np.int64)
    np.maximum.at(by_oligo, uniq[:, 1], counts)
    purity, completeness = by_cluster.sum() / n_reads, by_oligo.sum() / n_reads
    print(f"[12] kmer_cluster(k=5, threshold=0.75) of {n_reads} reads of {n_oligos} random 152-nt oligos on the card: "
          f"{cl.n_clusters} clusters ({len(np.unique(source))} oligos drawn), purity {purity:.5f}, completeness "
          f"{completeness:.5f}, wall {wall:.2f} s")
    if purity < 0.99:
        raise AssertionError(f"k-mer clustering purity {purity:.5f} < 0.99")
    few = reads[:4096]
    a, b = kmer_cluster(few, device=dev), kmer_cluster(few, device="cpu")
    if not (np.array_equal(a.assignment, b.assignment) and np.array_equal(a.centroids, b.centroids)):
        raise AssertionError("kmer_cluster of 4096 reads: the card's assignment differs from the CPU's")
    sub = [r for r, s in zip(reads, source) if s < n_super]
    t0 = time.time()
    rows = super_align(sub, device=dev)
    torch.cuda.synchronize()
    wall_sa = time.time() - t0
    launches = pairhmm_cuda.launches
    if sorted(i for i, _ in rows) != list(range(len(sub))) or len({len(r) for _, r in rows}) != 1:
        raise AssertionError("super_align rows are not one width over every input")
    if any(r.replace("-", "") != sub[i] for i, r in rows):
        raise AssertionError("a super_align row does not de-gap to its input")
    if rows != super_align(sub, device="cpu"):
        raise AssertionError("super_align on the card differs from the CPU's")
    print(f"[12] kmer_cluster of the first 4096 reads: card == CPU ({a.n_clusters} clusters); super_align of the "
          f"{len(sub)} reads of {n_super} oligos: width {len(rows[0][1])}, rows de-gap to the inputs, equal to the CPU's; "
          f"card {wall_sa:.2f} s, K2 launches {launches}")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _timed(fn):
    """(fn's result, seconds on the card's side of a synchronize)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def _window_bp_times(dev, graph, llr, clock_mhz: float) -> dict:
    """The window kernel's ms per iteration (fixed work, SC_ITERS
    iterations) on ``llr``'s first rows at a batch of SMALL_BATCH and of
    all of them, beside the eager ``bp_decode_generic`` (its plain
    version) and its bound."""
    from dna_ldpc_tpu_torch.ops import window_bp
    from dna_ldpc_tpu_torch.ops.bp import bp_decode_generic
    from dna_ldpc_tpu_torch.utils import roofline

    out = {}
    for b in (SMALL_BATCH, llr.shape[0]):
        x = llr[:b]
        ms = _cuda_ms(lambda: window_bp.decode(graph, x, SC_ITERS, early_stop=False), 3) / SC_ITERS
        plain = _cuda_ms(lambda: bp_decode_generic(graph, x, SC_ITERS, early_stop=False), 2) / SC_ITERS
        bound, by = roofline.window_bp_bound_ms(graph.n_edges, graph.n_vars, [SC_ITERS] * b, clock_mhz)
        out[b] = {"ms": ms, "plain_ms": plain, "bound_ms": bound / SC_ITERS, "bound_by": by,
                  "share_pct": 100 * bound / SC_ITERS / ms}
    return out


def _times_line(times: dict) -> str:
    ms = " / ".join(f"{r['ms']:.4f}" for r in times.values())
    bound = " / ".join(f"{r['bound_ms']:.4f} ms, {r['share_pct']:.1f} %" for r in times.values())
    plain = " / ".join(f"{r['plain_ms']:.3f}" for r in times.values())
    return f"{ms} ms per iteration (bound {bound}; the eager plain version {plain} ms)"


def _scldpc_phase(dev, clock_mhz: float) -> dict:
    """Phase 15 (see the module docstring). Returns the window kernel's
    times on the cell's window at the full batch."""
    import numpy as np
    import torch

    from dna_ldpc_tpu_torch.models.ldpc_graph import LdpcGraph
    from dna_ldpc_tpu_torch.models.rs_ldpc import build_rs_ldpc
    from dna_ldpc_tpu_torch.models.scldpc import couple
    from dna_ldpc_tpu_torch.ops import bp_cuda, scldpc, window_bp
    from dna_ldpc_tpu_torch.ops.bp import bp_posteriors
    from dna_ldpc_tpu_torch.ops.decoders import peel_values

    t0 = time.time()
    chain = couple(build_rs_ldpc(6, 6, 3), L=64, w=2, seed=0)
    graph, ra_graph = scldpc._window_graph(chain, SC_W), scldpc._ra_window_graph(chain, SC_W)
    full = LdpcGraph.from_sparse(chain.H)
    t_build = time.time() - t0
    if graph.blocked is not None or (graph.n_checks, graph.n_vars) != (1152, 3072):
        raise AssertionError("the window graph is not the irregular 1152 x 3072 window")
    N, F = chain.n_vars, SC_FRAMES
    rate = 1 - chain.n_checks / N
    sigma = math.sqrt(1 / (2 * rate * 10 ** (SC_EBNO / 10)))
    rng = np.random.default_rng(15)
    llr = (2 * (1 + sigma * rng.standard_normal((F, N))) / sigma**2).astype(np.float32)  # all-zero word, BPSK +1
    print(f"[15] SC-LDPC chain couple(build_rs_ldpc(6, 6, 3), L=64, w=2): {chain.n_checks} x {N} (rate {rate:.4f}), "
          f"windows of W={SC_W}: {graph.n_checks} x {graph.n_vars}, dc {graph.dc_max}, dv {graph.dv_max}, not blocked; "
          f"RA windows {ra_graph.n_checks} x {ra_graph.n_vars}; built in {t_build:.2f} s (host)")

    # (a) windowed BP: sliding window and the pipelined schedule, 1024 AWGN frames
    launches = bp_cuda.launches
    window_bp.launches = 0
    sw, t_sw = _timed(lambda: scldpc.sliding_window_decode(chain, llr, W=SC_W, iters=SC_ITERS, device=dev))
    pl, t_pl = _timed(lambda: scldpc.pipeline_decode(chain, llr, W=SC_W, iters=SC_ITERS, device=dev))
    main_launches = window_bp.launches  # the main path's alone: the timings and the probe below launch more
    if bp_cuda.launches != launches:
        raise AssertionError("windowed BP launched the K1 kernel")
    if main_launches != chain.L + (chain.L + F - 1):
        raise AssertionError(f"{main_launches} window kernel launches, not one a window and a tick")
    if not np.array_equal(pl, sw):
        raise AssertionError(f"pipeline_decode differs from sliding_window_decode in {int((pl != sw).sum())} bits")
    cpu = scldpc.sliding_window_decode(chain, llr[:8], W=SC_W, iters=SC_ITERS, device="cpu")
    if not np.array_equal(cpu, sw[:8]):
        raise AssertionError("sliding_window_decode on the card differs from the CPU on 8 frames")
    raw_ber, ber = float((llr < 0).mean()), float(sw.mean())
    print(f"[15a] windowed BP, {F} AWGN frames at Eb/No {SC_EBNO} dB (channel BER {raw_ber:.4f}), {SC_ITERS} iterations "
          f"a window: FER {float(sw.any(1).mean()):.4f}, BER {ber:.3e}; sliding_window_decode {chain.L} windows "
          f"{t_sw:.2f} s ({F / t_sw:.0f} frames/s); pipeline_decode {chain.L + F - 1} ticks {t_pl:.2f} s "
          f"({F / t_pl:.0f} frames/s), equal to the sliding window; 8 frames equal to device='cpu'")
    if not ber < raw_ber:
        raise AssertionError(f"windowed BP leaves BER {ber} above the channel's {raw_ber}")
    win = torch.as_tensor(llr[:, : graph.n_vars], device=dev)
    times = _window_bp_times(dev, graph, win, clock_mhz)
    erased = torch.as_tensor(np.where(rng.random((F, graph.n_vars)) < SC_ERASURE, 2, 0).astype(np.int8), device=dev)
    per_round = [_cuda_ms(lambda: peel_values(graph, erased[:b], 1), 10) for b in (SMALL_BATCH, F)]
    print(f"[15a] on one window at batch {SMALL_BATCH} / {F}, fixed work: the window kernel {_times_line(times)}; "
          f"a peeling round {per_round[0]:.3f} / {per_round[1]:.3f} ms (its host sync included)")
    cell_graph = scldpc._window_graph(couple(build_rs_ldpc(8, 6, 3), L=64, w=2, seed=0), SC_W)
    cell_llr = (2 / sigma**2) * (1 + sigma * torch.randn((F, cell_graph.n_vars), device=dev))
    cell = _window_bp_times(dev, cell_graph, cell_llr, clock_mhz)
    post = torch.empty_like(cell_llr)
    window_bp._kernel(cell_graph, cell_llr, 3, False, post)
    err = float((post - bp_posteriors(cell_graph, cell_llr, 3)).abs().max())
    if err:
        raise AssertionError(f"the window kernel's posteriors after 3 iterations are {err} from the plain version's")
    print(f"[15c] the cell's window (lifting 256: {cell_graph.n_checks} x {cell_graph.n_vars}, {cell_graph.n_edges} "
          f"edges, {window_bp.smem_bytes(cell_graph)} bytes of shared memory a frame) at batch {SMALL_BATCH} / {F}, "
          f"fixed work: the window kernel {_times_line(cell)}; posteriors after 3 iterations equal to the plain version's")

    # (b) every windowed BEC variant and the global peels, 1024 BEC frames, each equal to the CPU on 8 frames
    vals = np.where(rng.random((F, N)) < SC_ERASURE, 2, 0).astype(np.int8)
    ra_vals = np.where(rng.random((F, N + chain.n_checks)) < SC_ERASURE, 2, 0).astype(np.int8)
    runs = [(name, (lambda name=name, kw=kw: lambda v, device: getattr(scldpc, name)(
        chain, v, W=SC_W, **kw, device=device))()) for name, kw in SC_BEC_VARIANTS]
    runs += [("bec_decode_save", lambda v, device: scldpc.bec_decode_save(full, v, [chain.b_v] * chain.L,
                                                                            device=device)),
             ("bec_decode_target", lambda v, device: scldpc.bec_decode_target(full, v, (1, N // 4), device=device))]
    lines = []
    for name, run in runs:
        v = ra_vals if name == "sliding_window_bec_ra" else vals
        out, wall = _timed(lambda: run(v, dev))
        small, host = run(v[:8], dev), run(v[:8], "cpu")
        for a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (small, host))):
            if not np.array_equal(a, b):
                raise AssertionError(f"{name}: the card differs from the CPU on 8 frames")
        bits = out[0] if isinstance(out, tuple) else out
        # frames are independent, but for bec_decode_target's exit: the whole batch's target is clean
        if name != "bec_decode_target" and not np.array_equal(bits[:8], small[0] if isinstance(small, tuple) else small):
            raise AssertionError(f"{name}: 8 frames decode otherwise inside the batch of {F}")
        extra = (f", {out[2]} rounds" if name == "bec_decode_save" else
                 f", {out[1]} rounds, target clean {out[2]}" if name == "bec_decode_target" else "")
        lines.append(f"{name.replace('sliding_window_bec', 'sw')} {int((bits == 2).sum())} erasures left in "
                     f"{int((bits == 2).any(1).sum())} frames, {wall:.2f} s{extra}")
        if (bits == 1).any():
            raise AssertionError(f"{name} decoded a bit of the all-zero word to 1")
    print(f"[15b] {F} BEC frames at erasure rate {SC_ERASURE} ({int((vals == 2).sum())} erasures; RA layout "
          f"{N + chain.n_checks} variables), each equal to device='cpu' on 8 frames: " + "; ".join(lines))
    return {"launches": main_launches, "max_abs_err": err, **cell[F]}


def _multiprocess_phase(dev, llr_trial) -> int:
    """Phase 16 (see the module docstring): ``llr_trial`` [272, N] are the
    LLRs of phase 5's first decode. Returns K1's launches on the sharded
    path (16a's rank and the two ranks of 16b)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from dna_ldpc_tpu_torch.models.blocked import dna_storage_blocked
    from dna_ldpc_tpu_torch.models.ldpc_graph import LdpcGraph
    from dna_ldpc_tpu_torch.models.rs_ldpc import dna_storage_pchk
    from dna_ldpc_tpu_torch.ops import bp_cuda
    from dna_ldpc_tpu_torch.ops.bp import bp_decode_generic
    from dna_ldpc_tpu_torch.parallel import distributed
    from dna_ldpc_tpu_torch.parallel.mesh import build_mesh
    from dna_ldpc_tpu_torch.parallel.sharded_bp import (
        make_sharded_blocked_decoder, make_sharded_cuda_decoder, make_sharded_decoder,
    )

    code = dna_storage_blocked()
    graph = LdpcGraph.from_sparse(dna_storage_pchk(), detect_blocked=False)
    # (a) one NCCL rank on the card, mesh (1, 1); a failed NCCL group fails the phase
    torch.cuda.set_device(dev)
    t0 = time.time()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0)
    try:
        mesh = build_mesh()
        t_init = time.time() - t0
        if tuple(mesh.shape) != (1, 1) or dist.get_backend() != "nccl":
            raise AssertionError(f"mesh {tuple(mesh.shape)} over {dist.get_backend()}")
        x = distributed.process_local_batch(llr_trial, mesh)
        decode = make_sharded_cuda_decoder(code, mesh, 200)

        def first_call():
            r = decode(x)
            return r, distributed.allgather_result(r, mesh)

        bp_cuda.launches = 0
        (local, got), t_first = _timed(first_call)
        launches = bp_cuda.launches
        _same(got, bp_cuda.bp_decode_blocked(code, torch.as_tensor(llr_trial, device=dev), 200),
              "make_sharded_cuda_decoder vs bp_decode_blocked")
        if launches != 1:
            raise AssertionError(f"the sharded K1 decoder launched K1 {launches} times")
        # warm: NCCL makes its communicator at the first collective, the first call's gather
        warm = [_cuda_ms(fn, 5) for fn in (lambda: decode(x), lambda: bp_cuda.bp_decode_blocked(code, x, 200),
                                           lambda: distributed.allgather_result(local, mesh))]
        print(f"[16a] one NCCL rank, mesh (cw 1, graph 1), process group and mesh in {t_init:.2f} s: "
              f"make_sharded_cuda_decoder on phase 5's {len(llr_trial)} trial words (200 iterations), gathered over cw, "
              f"bit-equal to bp_decode_blocked (bits, success, iterations, unsat), K1 launches {launches}; first call "
              f"{t_first * 1e3:.2f} ms (the NCCL communicator made at its gather); warm: the sharded decoder {warm[0]:.3f} "
              f"ms, bp_decode_blocked {warm[1]:.3f} ms, the gather {warm[2]:.3f} ms")
        words = x[:SHARDED_WORDS]
        ref = bp_decode_generic(graph, words, SHARDED_ITERS)
        ok, its = ref.success.cpu(), max(int(ref.iterations.max()), 1)
        decoders = {"bp_decode_generic": lambda w: bp_decode_generic(graph, w, SHARDED_ITERS),
                    "K1": lambda w: bp_cuda.bp_decode_blocked(code, w, SHARDED_ITERS),
                    "make_sharded_decoder": make_sharded_decoder(graph, mesh, SHARDED_ITERS),
                    "make_sharded_blocked_decoder": make_sharded_blocked_decoder(code, mesh, SHARDED_ITERS)}
        for name in ("make_sharded_decoder", "make_sharded_blocked_decoder"):
            res = decoders[name](words)
            if not torch.equal(res.success.cpu(), ok):
                raise AssertionError(f"{name}: success differs from bp_decode_generic")
            if not torch.equal(res.bits.cpu()[ok], ref.bits.cpu()[ok]):
                raise AssertionError(f"{name}: bits differ from bp_decode_generic on converged words")
        timings = [f"{name} {_cuda_ms(lambda: fn(words), 3) / its:.3f}" for name, fn in decoders.items()]
        print(f"[16a] {SHARDED_WORDS} trial words of the deployed code, {SHARDED_ITERS} iterations "
              f"({int(ok.sum())} converge, at most {its} iterations): make_sharded_decoder and "
              f"make_sharded_blocked_decoder outcome-equal to bp_decode_generic (success; bits where converged); warm "
              f"ms per iteration of the longest word: " + ", ".join(timings))
    finally:
        dist.destroy_process_group()

    # (b) two processes sharing the card, configured through the environment, mesh (2 cw, 1 graph)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as d:
        inputs, out = os.path.join(d, "llr.npz"), os.path.join(d, "out.npz")
        np.savez(inputs, llr=llr_trial)
        port = str(_free_port())
        procs = []
        t0 = time.time()
        try:
            for rank in range(2):
                env = {**os.environ, "PYTHONPATH": REPO, "MASTER_ADDR": "localhost", "MASTER_PORT": port,
                       "WORLD_SIZE": "2", "RANK": str(rank), "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": "2"}
                procs.append(subprocess.Popen([sys.executable, "-c", PHASE16_WORKER, inputs, out], cwd=REPO, env=env,
                                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            texts = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        wall = time.time() - t0
        for rank, (p, text) in enumerate(zip(procs, texts)):
            if p.returncode != 0:
                raise AssertionError(f"phase 16b rank {rank} exited {p.returncode}:\n{text[-4000:]}")
        reports = [line.split() for text in texts for line in text.splitlines() if line.startswith("RANK ")]
        rows = [int(r[3]) for r in reports]
        sub_launches = sum(int(r[5]) for r in reports)
        saved = np.load(out)
        for name in ("bits", "success", "iterations", "unsat"):
            if not np.array_equal(saved[name], getattr(got, name).cpu().numpy()):
                raise AssertionError(f"phase 16b: the gathered {name} differs from phase 16a's")
    if sorted(rows) != [len(llr_trial) // 2] * 2 or sub_launches != 2:
        raise AssertionError(f"phase 16b ranks report rows {rows}, K1 launches {sub_launches}")
    print(f"[16b] two processes on the card through initialize() from the environment (gloo), mesh (cw 2, graph 1): "
          f"K1 on {rows[0]} words per rank, the all-gather over cw bit-equal to phase 16a; K1 launches {sub_launches} "
          f"(reported by the ranks); {wall:.2f} s with process start-up")
    return launches + sub_launches


def _consistency_phase(dev, clusters, card: str) -> None:
    """Phase 17: ``consistency_clusters`` on the card against
    ``device="cpu"`` on the K2 pair posteriors of ``clusters`` (the first
    CONSISTENCY_CLUSTERS of phase 10's MSA clusters); ``card`` is the
    nvidia-smi line of the card's name and power limit."""
    import numpy as np
    import torch

    from dna_ldpc_tpu_torch.ops.msa import pairhmm_cuda
    from dna_ldpc_tpu_torch.ops.msa.align import cluster_pairs
    from dna_ldpc_tpu_torch.ops.msa.consistency import N_BUCKETS, consistency_clusters
    from dna_ldpc_tpu_torch.ops.msa.pairhmm import k2_posteriors

    if len(clusters) < CONSISTENCY_CLUSTERS:
        raise AssertionError(f"phase 10 gave only {len(clusters)} MSA clusters")
    clusters = clusters[:CONSISTENCY_CLUSTERS]
    Lmax = 160
    pairs = [cluster_pairs(len(cl)) for cl in clusters]
    xs = [cl[i] for cl, prs in zip(clusters, pairs) for i, _ in prs]
    ys = [cl[j] for cl, prs in zip(clusters, pairs) for _, j in prs]
    pairhmm_cuda.launches = 0
    torch.cuda.synchronize()
    posts, _ = k2_posteriors(xs, ys, Lmax, dev)
    torch.cuda.synchronize()
    k2_launches = pairhmm_cuda.launches
    flat = []  # each pair's posterior, cropped to its reads, f32 on the host
    for lo in range(0, len(xs), 1024):
        block = posts[lo : lo + 1024].float().cpu().numpy()
        flat += [block[k, : len(xs[lo + k]), : len(ys[lo + k])].copy() for k in range(len(block))]
    del posts
    cluster_posts, lo = [], 0
    for prs in pairs:
        cluster_posts.append(flat[lo : lo + len(prs)])
        lo += len(prs)

    # the routing consistency_clusters applies (its docstring), for the report and the exact check:
    # bucket None passes through, bucket 0 (above the top one) takes the host loop
    bucket_of = [None if len(cl) < 3 else next((b for b in N_BUCKETS if b >= len(cl)), 0) for cl in clusters]
    per_bucket = {b: bucket_of.count(b) for b in sorted({b for b in bucket_of if b})}
    exact = [b is None or b == 0 or per_bucket[b] < MIN_DEVICE_CLUSTERS for b in bucket_of]
    n_host = sum(e and b is not None for e, b in zip(exact, bucket_of))

    torch.cuda.synchronize()
    t0 = time.time()
    card_out = consistency_clusters(cluster_posts, min_device_clusters=MIN_DEVICE_CLUSTERS, device=dev)
    torch.cuda.synchronize()
    card_s = time.time() - t0
    t0 = time.time()
    cpu_out = consistency_clusters(cluster_posts, min_device_clusters=MIN_DEVICE_CLUSTERS, device="cpu")
    cpu_s = time.time() - t0
    err = 0.0
    for c, (a_list, b_list) in enumerate(zip(card_out, cpu_out)):
        for a, b, p in zip(a_list, b_list, cluster_posts[c]):
            if a.shape != p.shape or b.shape != p.shape or not np.isfinite(a).all():
                raise AssertionError(f"cluster {c}: shapes {a.shape}, {b.shape} for {p.shape}, or values not finite")
            if exact[c] and not np.array_equal(a, b):
                raise AssertionError(f"cluster {c} took the host loop or passed through, yet differs from the CPU's")
            if not np.allclose(a, b, atol=2e-5, rtol=1e-4):
                raise AssertionError(f"cluster {c}: the card differs from the CPU (max abs {np.abs(a - b).max():.3e})")
            err = max(err, float(np.abs(a - b).max(initial=0.0)))
    print(f"[17] consistency_clusters on the card: the first {len(clusters)} MSA clusters of phase 5's reads (phase "
          f"10's), {len(xs)} pairs, posteriors from K2 at Lmax={Lmax} ({k2_launches} K2 launches); clusters per bucket "
          f"{per_bucket}, passed through (n < 3) {bucket_of.count(None)}, host loop {n_host} "
          f"({100 * n_host / len(clusters):.1f} %); max abs diff vs device='cpu' {err:.3e} (atol 2e-5, rtol 1e-4), "
          f"pass-through and host-loop clusters equal; card {card_s:.3f} s, device='cpu' {cpu_s:.3f} s ({card})")
    if k2_launches == 0:
        raise AssertionError("phase 17 never launched K2")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_main = time.time()

    from dna_ldpc_tpu_torch import cuda_lib, native_lib
    from dna_ldpc_tpu_torch.models.blocked import dna_storage_blocked
    from dna_ldpc_tpu_torch.models.rs_ldpc import dna_storage_pchk
    from dna_ldpc_tpu_torch.ops import bp_cuda
    from dna_ldpc_tpu_torch.ops.editdist import edit_distance_pairs_device
    from dna_ldpc_tpu_torch.ops.msa import consistency, device_msa, mea_cuda, pairhmm_cuda
    from dna_ldpc_tpu_torch.ops.msa.pairhmm import encode_pairs
    from dna_ldpc_tpu_torch.pipeline import decode as trial_decode
    from dna_ldpc_tpu_torch.pipeline.report import parse_result
    from dna_ldpc_tpu_torch.pipeline.simulate import (
        ChannelModel, encode_oligos, group_union_codewords, simulate_reads,
    )
    from dna_ldpc_tpu_torch.utils import roofline
    from dna_ldpc_tpu_torch.utils.io_formats import write_lines, write_vector

    msa_align = importlib.import_module("dna_ldpc_tpu_torch.ops.msa.align")
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
    oligos = encode_oligos(cws)
    reads, quals = simulate_reads(oligos, 72000, ChannelModel(), seed=7)
    # decode_trial's LLR table, captured from its call of compute_trial_llrs
    llr_tables = []
    compute_trial_llrs = trial_decode.compute_trial_llrs

    def capture_llrs(*args, **kwargs):
        llr_tables.append(compute_trial_llrs(*args, **kwargs))
        return llr_tables[-1]

    trial_decode.compute_trial_llrs = capture_llrs

    def run_trial(reads=reads, quals=quals):
        """decode_trial of ``cws`` on the card with every launch count reset
        just before and read just after; returns (result, LLR table,
        launches, MSA clusters, host-aligner fallbacks, wall seconds)."""
        bp_cuda.launches = 0
        pairhmm_cuda.launches = pairhmm_cuda.pairs = 0
        mea_cuda.merge_launches = 0
        consistency.launches = 0
        msa_align.msa_clusters = msa_align.fallback_clusters = 0
        torch.cuda.synchronize()
        t0 = time.time()
        res = trial_decode.decode_trial(reads, quals, cws, trial_decode.TrialConfig())
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {"bp_blocked": bp_cuda.launches, "pairhmm": pairhmm_cuda.launches,
                    "merge_dp": mea_cuda.merge_launches, "consistency": consistency.launches}
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
    if min(launches[name] for name in ("bp_blocked", "pairhmm", "merge_dp", "consistency")) == 0:
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

    # ---- 7. the merge kernel against its twin --------------------------------
    nb, C7, Cmax = 8, 512, Lmax + device_msa.COLUMN_SLACK
    merge_err, merge_stats = 0, {}
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
            nA, nB = mA.sum(1).tolist(), mB.sum(1).tolist()
            bound, by = roofline.merge_bound_ms(nA, nB, wA.tolist(), wB.tolist(), Cmax, clock_mhz)
            print(
                f"[7] merge_dp vs twin, wave {k + 1} of {nb - 1}: {C7} clusters of {nb} reads, "
                f"{sum(nA) / C7:.2f} x {sum(nB) / C7:.2f} reads a side, mean widths {wA.float().mean().item():.1f} x "
                f"{wB.float().mean().item():.1f}, Cmax={Cmax}, mean path length "
                f"{(codes_k != 0).sum(1).float().mean().item():.1f}; codes and positions equal; kernel {ms:.3f} ms, "
                f"twin {plain:.3f} ms per merge; bound {bound:.4f} ms ({by}), {100 * bound / ms:.1f} % reached")
            if k == 0:
                merge_stats = {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by}
    del margs

    # ---- 8. the same trial through the command line ------------------------
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as d:
        for i in range(len(cws)):
            write_vector(os.path.join(d, f"codeword_n18432_m1860_{i + 1}.txt"), cws[i])
        write_lines(os.path.join(d, "final_DNA.txt"), oligos)
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

    # ---- 10. the per-cluster route on the first quarter of the strands -------
    msa_clusters = _per_cluster_phase(dev, reads, quals, cws, llr_host, res0)

    # ---- 11. the general-table pair-HMM and ensembles -------------------------
    _general_tables_phase(dev, [a[:512] for a in (X, Y, lx, ly)], post_k, k2_ms, xs, ys)
    _ensemble_phase(dev, [c for c in msa_clusters if len(c) >= 3][:ENSEMBLE_CLUSTERS])

    # ---- 12. index-free clustering at trial scale -----------------------------
    _kmer_cluster_phase(dev)

    # ---- 13. double coverage; 14. the annealing stress point -----------------
    dreads, dquals = simulate_reads(oligos, 140000, ChannelModel(), seed=5)
    rd, _, launches_d, n_msa_d, n_fb_d, wd = run_trial(dreads, dquals)
    print(f"[13] double coverage: 140000 reads (seed 5): fail_first {rd.fail_first}, fail_final {rd.fail_final}, "
          f"n_anneal_iters {rd.n_anneal_iters}, MSA clusters {n_msa_d}, fallback_clusters {n_fb_d}, K2 pairs "
          f"{pairhmm_cuda.pairs}, wall {wd:.2f} s, launches {launches_d}")
    print("[13] phase_times: " + ", ".join(f"{k}={v:.4f}" for k, v in rd.phase_times.items()))
    if rd.fail_final or not np.array_equal(rd.decoded_bits, cws):
        raise AssertionError(f"double-coverage trial not recovered: fail_final {rd.fail_final}")

    n_ref, *want = STRESS_REFERENCE
    for n_reads in (STRESS_BENCH_READS, n_ref, STRESS_READS):
        sreads, squals = simulate_reads(oligos, n_reads, ChannelModel(), seed=123)
        rs, _, _, _, _, ws = run_trial(sreads, squals)
        got = [rs.fail_first, rs.fail_final, rs.n_anneal_iters]
        print(f"[14] stress point: {n_reads} reads (seed 123): fail_first {got[0][:20]}, fail_final "
              f"{got[1][:20]}, n_anneal_iters {got[2]}, wall {ws:.2f} s"
              + (f"; the JAX package's on the CPU: {want}" if n_reads == n_ref else ""))
        if n_reads == n_ref:
            if got != want:
                raise AssertionError(f"{n_reads} reads: outcome {got}, the JAX package's {want}")
        elif rs.fail_final or not np.array_equal(rs.decoded_bits, cws):
            raise AssertionError(f"{n_reads} reads not recovered: fail_final {rs.fail_final}")
    if rs.n_anneal_iters == 0:
        raise AssertionError(f"{STRESS_READS} reads did not make the trial anneal")
    os.environ["DNA_LDPC_DEVICE_MSA"] = "0"
    try:
        rs0, _, _, _, _, ws0 = run_trial(sreads, squals)
    finally:
        del os.environ["DNA_LDPC_DEVICE_MSA"]
    print(f"[14] stress point at {n_reads} reads, DNA_LDPC_DEVICE_MSA=0: fail_first {rs0.fail_first}, fail_final "
          f"{rs0.fail_final}, n_anneal_iters {rs0.n_anneal_iters}, wall {ws0:.2f} s; annealing rounds "
          f"{rs.phase_times['second_decode']:.4f} s on the card (second_decode)")
    for name in ("fail_first", "fail_final", "n_anneal_iters"):
        if getattr(rs0, name) != getattr(rs, name):
            raise AssertionError(f"stress point: {name} differs between the device MSA and the host-aligner flow")
    # ---- 15. SC-LDPC windowed decoders; 16. multi-process BP ---------------
    t15 = time.time()
    window_bp_row = _scldpc_phase(dev, clock_mhz)
    t16 = time.time()
    k1_sharded_launches = _multiprocess_phase(dev, np.ascontiguousarray(llr_dev.T, np.float32))
    print(f"[15-16] phase 15 {t16 - t15:.2f} s, phase 16 {time.time() - t16:.2f} s; the script so far "
          f"{time.time() - t_main:.2f} s")

    # ---- 17. the batched consistency transform -------------------------------
    t17 = time.time()
    _consistency_phase(dev, msa_clusters, smi)
    cons = _consistency_times(dev)
    for name, row in cons.items():
        print(f"[17] the consistency kernel alone, {name} ({row['clusters']} clusters, L {row['L']}, 2 iterations): "
              f"assemble_transform {row['ms']:.4f} ms, the kernel's device time {row['kernel_device_ms']:.4f} ms; "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), share {row['share_pct']:.1f} % of the call, "
              f"{row['kernel_share_pct']:.1f} % of the kernel; the plain version (the block product through "
              f"torch.bmm, also library_ms) {row['plain_ms']:.3f} ms; at most {row['max_bf16_steps']} bf16 steps "
              f"from it ({smi})")
        if row["max_bf16_steps"] > 1:
            raise AssertionError(f"{name}: the consistency kernel is {row['max_bf16_steps']} bf16 steps off")
    print(f"[17] phase 17 {time.time() - t17:.2f} s")

    kernels = [
        {"name": "bp_blocked", "route": "cuda", "source": "dna_ldpc_tpu_torch/csrc/bp_blocked.cu",
         "replaces": "dna_ldpc_tpu/ops/bp_pallas.py:55",
         "launches": launches["bp_blocked"] + k1_sim_launches + k1_sharded_launches,
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None},
        {"name": "pairhmm", "route": "cuda", "source": "dna_ldpc_tpu_torch/csrc/pairhmm.cu",
         "replaces": "dna_ldpc_tpu/ops/msa/pairhmm_pallas.py:114",
         "launches": launches["pairhmm"], "max_abs_err": max(k2_err, k2_err_big), "ms": k2_ms_big,
         "plain_ms": k2_plain_big, "bound_ms": k2_bound_big, "bound_by": k2_by_big, "library_ms": None},
        {"name": "merge_dp", "route": "cuda", "source": "dna_ldpc_tpu_torch/csrc/mea_dp.cu",
         "replaces": "dna_ldpc_tpu/ops/msa/device_msa.py:175", "launches": launches["merge_dp"],
         "max_abs_err": float(merge_err), **merge_stats, "library_ms": None},
        {"name": "consistency", "route": "cuda", "source": "dna_ldpc_tpu_torch/csrc/consistency.cu",
         "replaces": None, "launches": launches["consistency"],
         **{k: v for k, v in cons["consistency_b8_n5"].items() if k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "kernel_device_ms", "max_bf16_steps")}},
        {"name": "window_bp", "route": "cuda", "source": "dna_ldpc_tpu_torch/csrc/window_bp.cu",
         "replaces": None, "library_ms": None, **window_bp_row},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
