"""End-to-end trial decoding: reads -> soft information -> batched BP ->
epsilon-annealing re-decode -> result report.

Port of ``dna_ldpc_tpu/pipeline/decode.py``. All 272 codewords of a trial
decode as one batched BP call on ``TrialConfig.device`` (the fused CUDA
kernel on the card), and each annealing round re-decodes only the failing
subset. LLRs are uploaded as float32.

Semantics mirrored exactly from the reference (``ex_decoder/
decoder.py:44-727``):

- first decoding failure = any bit mismatch vs the oracle codeword
  (decoder.py:565-581), not syndrome success;
- ``re_decode`` counters: bits where the decoder output differs from the
  channel hard decision (LLR >= 0 -> 0), thresholded at 140 to report
  "erasure strands" (decoder.py:544, 571-573, 591);
- annealing: epsil2 starts at eps-0.0005; each round rescales the ORIGINAL
  soft values by log((1-eps')/eps')/log((1-eps)/eps) with
  eps' = epsil2-0.0005 (zeros stay zero), decrements epsil2 by 0.0005, and
  stops when no failures remain or epsil2 <= 0.001 (decoder.py:594-664).

``strict_reference_failure_tracking=True`` reproduces the reference's
quirk of keeping only the last re-decoded codeword's failure per round
(decoder.py:660-662).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from ..models.blocked import dna_storage_blocked
from ..models.ldpc_graph import LdpcGraph
from ..models.rs_ldpc import dna_storage_pchk
from ..ops.bp import bp_decode
from ..utils.device import DEFAULT_DEVICE, require_device
from .llr import Aligner, compute_trial_llrs, rs_filter_reads

ERASURE_THRESHOLD = 140  # decoder.py:591


@dataclass
class TrialConfig:
    epsil: float = 0.02
    max_iter: int = 200          # def_func.py:49 (ldpc argv max_iter)
    anneal_step: float = 0.0005
    anneal_floor: float = 0.001
    strict_reference_failure_tracking: bool = False
    device: str = DEFAULT_DEVICE  # where BP, the pair-HMM and the MSA stages run

    def __post_init__(self):
        require_device(self.device)


@dataclass
class TrialResult:
    success: bool
    fail_first: list[int]        # 1-based codeword indices, first decoding
    fail_final: list[int]
    n_anneal_iters: int
    n_erasure_strands: int
    decoded_bits: np.ndarray     # [272, 18432] final decoder outputs
    total_time: float
    phase_times: dict = field(default_factory=dict)
    n_reads_kept: int = 0


@functools.lru_cache(maxsize=None)
def deployed_graph() -> LdpcGraph:
    """The deployed 2048 x 18432 code with its canonical blocked
    decomposition attached (the shipped pchk is column-shuffled, so
    natural block detection does not find it)."""
    g = LdpcGraph.from_sparse(dna_storage_pchk(), detect_blocked=False)
    return dataclasses.replace(g, blocked=dna_storage_blocked())


def _decode_batch(graph: LdpcGraph, llrs: np.ndarray, max_iter: int, device) -> np.ndarray:
    """BP-decode [K, N] soft values on ``device`` -> [K, N] hard outputs."""
    llr = torch.as_tensor(np.ascontiguousarray(llrs, np.float32), device=device)
    return bp_decode(graph, llr, max_iter=max_iter).bits.cpu().numpy()


def anneal_decode(
    graph: LdpcGraph,
    soft: np.ndarray,
    codewords: np.ndarray,
    config: TrialConfig | None = None,
    phase: dict | None = None,
    resume: tuple[np.ndarray, list[int], list[int], int] | None = None,
    save_cb=None,
) -> tuple[np.ndarray, list[int], list[int], int]:
    """First decoding of all codewords in one batch, then the reference's
    second-decoding epsilon-annealing loop over failures
    (``ex_decoder/decoder.py:553-664``).

    Returns (decoded bits [K, N], fail_first, fail_final, n_anneal_iters);
    failure indices are 1-based codeword numbers as the reference reports
    them. ``resume`` = (decoded bits, fail_first, fail_current,
    n_anneal_iters) from a checkpoint skips the first decode and restarts
    the annealing loop at the epsilon it had reached. ``save_cb(dec,
    fail_first, fail, n_iters)``, when given, is invoked after the first
    decode and after every annealing round."""
    config = config or TrialConfig()
    phase = phase if phase is not None else {}
    if resume is not None:
        dec, fail_first, fail, n_iters = resume
        dec = np.array(dec)
        fail = list(fail)
        fail_first = list(fail_first)
        phase["first_decode"] = 0.0
    else:
        t0 = time.time()
        dec = _decode_batch(graph, soft, config.max_iter, config.device)
        phase["first_decode"] = time.time() - t0

        errs = (dec != codewords).sum(axis=1)
        fail_first = [int(i) + 1 for i in np.nonzero(errs)[0]]
        fail = list(fail_first)
        n_iters = 0
        if save_cb is not None:
            save_cb(dec, fail_first, fail, n_iters)

    t0 = time.time()
    epsil2 = config.epsil - config.anneal_step * (n_iters + 1)
    base_mag = np.log((1 - config.epsil) / config.epsil)
    while fail and epsil2 > config.anneal_floor:
        n_iters += 1
        eps_eff = epsil2 - config.anneal_step
        scale = np.log((1 - eps_eff) / eps_eff) / base_mag
        idx = np.array(fail) - 1
        re_soft = soft[idx] * scale  # zeros stay zero
        epsil2 -= config.anneal_step

        dec_f = _decode_batch(graph, re_soft, config.max_iter, config.device)
        dec[idx] = dec_f
        errs_f = (dec_f != codewords[idx]).sum(axis=1)
        if config.strict_reference_failure_tracking:
            # literal decoder.py:660-662: only the last failure survives
            fail = [fail[-1]] if errs_f[-1] != 0 else []
        else:
            fail = [int(fail[k]) for k in range(len(fail)) if errs_f[k] != 0]
        if save_cb is not None:
            save_cb(dec, fail_first, fail, n_iters)
    phase["second_decode"] = time.time() - t0
    return dec, fail_first, fail, n_iters


def decode_trial(
    reads: Sequence[str],
    quals: Sequence[str | int],
    codewords: np.ndarray,
    config: TrialConfig | None = None,
    aligner: Aligner | None = None,
    graph: LdpcGraph | None = None,
    checkpoint_path: str | None = None,
) -> TrialResult:
    """Decode one trial. codewords: [272, 18432] oracle bits, used for
    error counting exactly as the reference does.

    ``aligner``: None routes mixed-length clusters through the
    cross-cluster batched MSA (the default); an aligner (for example
    ``ops.msa.msa_aligner``) takes them one cluster at a time.

    ``checkpoint_path``: optional npz path; if it holds a checkpoint for
    the same epsilon, the ingest stage (RS + clustering + MSA + counting)
    is skipped and decoding resumes from the stored LLR table — and, when
    the checkpoint also carries decoder progress, the annealing loop
    restarts where it was. The checkpoint is written after ingest and
    updated after the first decode and after every annealing round."""
    from .checkpoint import TrialCheckpoint

    config = config or TrialConfig()
    t_start = time.time()
    graph = graph or deployed_graph()
    phase = {}

    ckpt = None
    if checkpoint_path:
        ckpt = TrialCheckpoint.load(checkpoint_path)
        if ckpt is not None and abs(ckpt.epsil - config.epsil) > 1e-12:
            ckpt = None

    if ckpt is not None:
        llr_table = ckpt.llr_table
        n_kept = ckpt.n_reads_kept
        phase["rs_decode"] = phase["llr"] = 0.0
    else:
        t0 = time.time()
        filtered = rs_filter_reads(reads, quals)
        phase["rs_decode"] = time.time() - t0
        n_kept = len(filtered.payloads)

        t0 = time.time()
        llr_sub: dict = {}
        llr_table = compute_trial_llrs(
            filtered, config.epsil, aligner, device=config.device, timings=llr_sub
        )  # [18432, 272]
        phase["llr"] = time.time() - t0
        for k, v in llr_sub.items():
            phase[f"llr_{k}"] = v
        if checkpoint_path:
            TrialCheckpoint(
                epsil=config.epsil, llr_table=llr_table, n_reads_kept=n_kept
            ).save(checkpoint_path)
    soft = llr_table.T.copy()  # [272, 18432] per-codeword soft inputs

    resume = None
    if ckpt is not None and ckpt.decoded_bits is not None and ckpt.fail_current is not None:
        resume = (
            ckpt.decoded_bits,
            [int(i) for i in (ckpt.fail_first if ckpt.fail_first is not None else [])],
            [int(i) for i in ckpt.fail_current],
            ckpt.anneal_iters,
        )

    save_cb = None
    if checkpoint_path:
        def save_cb(dec_now, ff, fc, iters):
            TrialCheckpoint(
                epsil=config.epsil,
                llr_table=llr_table,
                decoded_bits=np.asarray(dec_now, np.uint8),
                fail_first=np.asarray(ff, np.int64),
                fail_current=np.asarray(fc, np.int64),
                anneal_iters=iters,
                n_reads_kept=n_kept,
            ).save(checkpoint_path)

    dec, fail_first, fail, n_iters = anneal_decode(
        graph, soft, codewords, config, phase, resume=resume, save_cb=save_cb
    )

    hard = (soft < 0).astype(np.uint8)  # LLR >= 0 -> 0 (decoder.py:565-571)
    re_decode = (dec != hard).sum(axis=0)  # [18432] per-strand flip counts
    n_erasure = int((re_decode > ERASURE_THRESHOLD).sum())

    return TrialResult(
        success=not fail,
        fail_first=fail_first,
        fail_final=fail,
        n_anneal_iters=n_iters,
        n_erasure_strands=n_erasure,
        decoded_bits=dec,
        total_time=time.time() - t_start,
        phase_times=phase,
        n_reads_kept=n_kept,
    )
