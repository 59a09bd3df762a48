"""Soft-information (LLR) extraction over clustered sequencing reads.

Port of ``dna_ldpc_tpu/pipeline/llr.py`` (``rs_filter_reads``,
``cluster_llr``, ``compute_trial_llrs`` and the batched mixed-cluster
path), which reproduces rule for rule the per-cluster LLR computation of the reference
trial script (``ex_decoder/decoder.py:148-535``):

- reads are RS-index-decoded, kept if cnumerr <= 2 (decoder.py:86-92) and
  the decoded 16-bit index is in the codebook (decoder.py:110-115), then
  clustered by index;
- cluster of >1 reads, all exactly 136 nt -> direct per-bit counting;
- cluster of >1 reads, mixed lengths -> all-pairs edit-distance pre-filter
  (keep reads in some pair with distance < 15, decoder.py:178-187; none
  survive -> the strand becomes an erasure), MSA of the survivors, rows
  whose aligned length == 136 counted; rows of other lengths contribute
  (only if NO row aligned to 136) their last character to bit 271 for
  reads with quality > 63 (decoder.py:266-289);
- single read shorter than 136 -> only bit 271 gets +/-log((1-e)/e), from
  the read's last bit, if quality > 63 (decoder.py:237-261);
- per-bit LLR = (count0 - count1) * log((1-eps)/eps), where the alignment
  gap '-' (bit symbol 2) counts as a ONE vote;
- bit 271: reads with quality < 53 are excluded from counting
  (decoder.py:294-295), with the literal two-read quality rule of
  decoder.py:305-311;
- strands with no usable reads get all-zero LLRs (decoder.py:514-517).

Countable clusters are tallied by the native C++ pass
(``use_native=True``). The clusters it leaves take one of two routes:

- batched (``aligner=None``, ``batch_msa=True``, the default): one
  edit-distance pre-filter over every cluster's pairs (on the device when
  ``device`` is CUDA, in native code otherwise) and the cross-cluster MSA
  (``ops.msa.align.align_clusters``) on ``device``;
- per cluster: ``cluster_llr`` with the caller's ``aligner`` (for example
  ``ops.msa.msa_aligner``, one ``align()`` per cluster), its pre-filter in
  numpy.

Without the native pass (``use_native=False``) every cluster goes through
``cluster_llr``, with ``ops.msa.msa_aligner`` on ``device`` unless an
aligner is given. (The JAX package sends every cluster to its batched
route in that case, which erases single-read clusters and aligns all-136
ones; the port does not follow it there.)

Output is the [18432, 272] LLR table (strand-major).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from .. import native_lib
from ..models.codebook import N_STRANDS, PAYLOAD_BITS, PAYLOAD_NT, codebook_rank
from ..models.rs_index import decode_index_bits
from ..ops.editdist import edit_distance_pairs
from ..utils import dna
from ..utils.device import DEFAULT_DEVICE, require_device
from ..utils.profiling import HOST, span

# aligner: list of sequences -> list of (input ordinal, aligned row) in MSA
# output order (rows may be reordered, like MUSCLE output).
Aligner = Callable[[Sequence[str]], list[tuple[int, str]]]

EDIT_PREFILTER_THRESHOLD = 15  # decoder.py:182 "temp < 15"
Q_LOW = 53                     # decoder.py:294 (Phred+33 '5' ~ Q20)
Q_HIGH = 63                    # decoder.py:305 ('?' ~ Q30)


@dataclass
class FilteredReads:
    """Reads surviving RS-index decoding + codebook filtering, sorted by
    strand (stable, preserving file order within a cluster)."""

    payloads: list[str]       # payload part (read[16:]) per kept read
    quals: np.ndarray         # int quality per kept read
    strands: np.ndarray       # codebook rank 0..18431 per kept read
    n_input: int
    n_rs_pass: int            # cnumerr in {0,1,2}


def rs_filter_reads(reads: Sequence[str], quals: Sequence[str | int]) -> FilteredReads:
    """RS-decode the 16-nt index prefix of each read; keep reads whose
    decoder corrected <= 2 symbols and whose index is a valid codebook
    entry. Mirrors decoder.py:59-119."""
    n = len(reads)
    qual_ints = np.array(
        [q if isinstance(q, (int, np.integer)) else ord(q) for q in quals], dtype=np.int64
    )
    idx_mat = dna.seqs_to_matrix([r[:16] for r in reads], pad=16, fill=b"-")
    idx_bits = dna.dna_to_bits(idx_mat)
    dec_bits, cnumerr = decode_index_bits(idx_bits)
    rs_pass = (cnumerr >= 0) & (cnumerr <= 2)

    values = dna.bits_to_int_msb(dec_bits)
    ranks = codebook_rank()[values]
    keep = rs_pass & (ranks >= 0)

    order = np.argsort(ranks[keep], kind="stable")
    kept_idx = np.nonzero(keep)[0][order]
    return FilteredReads(
        payloads=[reads[i][16:] for i in kept_idx],
        quals=qual_ints[kept_idx],
        strands=ranks[keep][order].astype(np.int64),
        n_input=n,
        n_rs_pass=int(rs_pass.sum()),
    )


def _count_llr(rows: list[str], rq: list[int], mag: float) -> np.ndarray:
    """Per-bit counting over equal-width (2*136-bit) rows with the bit-271
    quality rules. Only the first 272 bits are counted."""
    bits = dna.dna_to_bits(dna.seqs_to_matrix(rows))[:, :PAYLOAD_BITS]
    q = np.asarray(rq)
    llr = np.zeros(PAYLOAD_BITS, dtype=np.float64)

    is_zero = bits == 0  # '1' and gap-'2' both count as one votes
    c0 = is_zero.sum(axis=0)
    c1 = (~is_zero).sum(axis=0)
    llr[:] = (c0 - c1) * mag

    # bit 271: exclude reads with q < 53 from counting
    counted = q >= Q_LOW
    z271 = is_zero[counted, PAYLOAD_BITS - 1]
    q271 = q[counted]
    c0_l, c1_l = int(z271.sum()), int((~z271).sum())
    if c0_l == 1 and c1_l == 1:
        qs0 = int(q271[z271].sum())
        qs1 = int(q271[~z271].sum())
        # literal decoder.py:305-311; both +/-2*mag branches are dead given
        # the q>=53 exclusion above, so this resolves to 0
        if qs0 < Q_LOW and qs1 >= Q_HIGH:
            llr[PAYLOAD_BITS - 1] = -2 * mag
        elif qs0 >= Q_HIGH and qs1 < Q_LOW:
            llr[PAYLOAD_BITS - 1] = 2 * mag
        else:
            llr[PAYLOAD_BITS - 1] = 0.0
    else:
        llr[PAYLOAD_BITS - 1] = (c0_l - c1_l) * mag
    return llr


def _misaligned_llr(error_q: list[tuple[int, str]], mag: float) -> np.ndarray:
    """LLRs of a cluster none of whose MSA rows has 136 columns: only bit
    271, from the last character of the high-quality rows (gap/'2' counts
    as a one vote; decoder.py:266-289)."""
    llr = np.zeros(PAYLOAD_BITS, dtype=np.float64)
    c0 = c1 = 0
    for qq, ch in error_q:
        if qq > Q_HIGH:
            lsb = dna.dna_to_bits(dna.seq_to_bytes(ch))[1]
            if lsb == 0:
                c0 += 1
            else:
                c1 += 1
    llr[PAYLOAD_BITS - 1] = (c0 - c1) * mag
    return llr


def _aligned_llr(rows_out, subq: list[int], mag: float) -> np.ndarray:
    """LLRs of a cluster from its MSA rows: rows of 136 columns counted,
    the rest kept for the bit-271 rule (decoder.py:209-289)."""
    rows, rq, error_q = [], [], []
    for ordinal, aseq in rows_out:
        if len(aseq) != PAYLOAD_NT:
            error_q.append((subq[ordinal], aseq[-1]))  # decoder.py:223-226
        else:
            rows.append(aseq)
            rq.append(subq[ordinal])
    if not rows:
        return _misaligned_llr(error_q, mag)
    return _count_llr(rows, rq, mag)


def cluster_llr(
    reads: list[str], quals: list[int], epsil: float, aligner: Aligner | None,
    timings: dict | None = None,
) -> np.ndarray | None:
    """LLR vector for one cluster, or None when the strand is an erasure
    (no reads survive the edit-distance pre-filter). ``timings``
    accumulates the seconds of a mixed cluster's stages: "edit_prefilter",
    "msa" (the aligner) and "counting"."""
    mag = math.log((1 - epsil) / epsil)
    if timings is None:
        timings = {}

    if len(reads) != 1:
        if all(len(r) == PAYLOAD_NT for r in reads):
            return _count_llr(reads, quals, mag)
        # mixed lengths: all-pairs pre-filter (decoder.py:178-187)
        with span("llr.prefilter", kind=HOST, timings=timings, key="edit_prefilter"):
            n = len(reads)
            ii, kk = np.triu_indices(n, k=1)
            mat = dna.seqs_to_matrix(reads, fill=b"\x00")
            lens = np.array([len(r) for r in reads])
            dists = edit_distance_pairs(mat, lens, ii, kk)
            close = dists < EDIT_PREFILTER_THRESHOLD
            keep = np.unique(np.concatenate([ii[close], kk[close]]))
        if len(keep) == 0:
            return None  # erasure (decoder.py:188-197)
        if aligner is None:
            raise ValueError("mixed-length cluster requires an aligner")
        with span("llr.aligner", timings=timings, key="msa"):
            rows = aligner([reads[i] for i in keep])
        with span("llr.counting", kind=HOST, timings=timings, key="counting"):
            return _aligned_llr(rows, [quals[i] for i in keep], mag)

    # single-read cluster
    r = reads[0]
    if len(r) < PAYLOAD_NT:
        llr = np.zeros(PAYLOAD_BITS, dtype=np.float64)
        if quals[0] > Q_HIGH:
            lsb = dna.dna_to_bits(dna.seq_to_bytes(r))[-1]
            llr[PAYLOAD_BITS - 1] = mag if lsb == 0 else -mag
        return llr
    return _count_llr([r], [quals[0]], mag)


def compute_trial_llrs(
    filtered: FilteredReads,
    epsil: float,
    aligner: Aligner | None = None,
    use_native: bool = True,
    batch_msa: bool = True,
    device=DEFAULT_DEVICE,
    timings: dict | None = None,
) -> np.ndarray:
    """Full [18432, 272] LLR table for one trial (erasure strands zero).

    With ``use_native`` (the native library must build), countable
    clusters (all-136 multi-read, single reads) are tallied in one native
    pass; the rest take the batched pre-filter + MSA route on ``device``
    when ``aligner`` is None and ``batch_msa``, else go one by one through
    ``cluster_llr`` with ``aligner``. Without ``use_native`` every cluster
    goes through ``cluster_llr``, with ``ops.msa.msa_aligner`` on
    ``device`` when ``aligner`` is None (the batched route counts neither
    single reads nor all-136 clusters). ``timings`` accumulates seconds
    per stage: "native_count", then the batched route's keys or
    ``cluster_llr``'s."""
    require_device(device)
    if timings is None:
        timings = {}
    if aligner is None and not use_native:
        from ..ops.msa import msa_aligner

        aligner = functools.partial(msa_aligner, device=device)
    out = np.zeros((N_STRANDS, PAYLOAD_BITS), dtype=np.float64)
    strands = filtered.strands
    if len(strands) == 0:
        return out
    with span("llr.native_count", kind=HOST, timings=timings, key="native_count"):
        boundaries = np.nonzero(np.diff(strands))[0] + 1
        starts = np.concatenate([[0], boundaries]).astype(np.int64)
        ends = np.concatenate([boundaries, [len(strands)]]).astype(np.int64)
        strand_of_cluster = strands[starts].astype(np.int32)

        pending_mask = np.ones(len(starts), dtype=np.int32)
        if use_native:
            buf, offsets, lengths = native_lib.pack_seqs(filtered.payloads)
            mag = math.log((1 - epsil) / epsil)
            pending_mask = native_lib.count_trial_llrs_native(
                buf, offsets, lengths, np.ascontiguousarray(filtered.quals, np.int64),
                starts, ends, strand_of_cluster, mag, out,
            )
    pending = np.nonzero(pending_mask)[0]
    if len(pending) == 0:
        return out
    if aligner is None and batch_msa:
        _process_mixed_clusters_batched(
            filtered, starts, ends, strands, pending, epsil, out, device, timings
        )
        return out
    for c in pending:
        s, e = starts[c], ends[c]
        llr = cluster_llr(filtered.payloads[s:e], list(filtered.quals[s:e]), epsil, aligner, timings)
        out[int(strands[s])] = 0.0 if llr is None else llr
    return out


def _edit_distances(filtered: FilteredReads, pa: np.ndarray, pb: np.ndarray, device) -> np.ndarray:
    """Pre-filter distances of read pairs (pa[k], pb[k]): on a CUDA device
    the torch antidiagonal DP over the reads that appear in pairs, else
    the native C++ pass (bit-identical integer results)."""
    if torch.device(device).type == "cuda":
        from ..ops.editdist import edit_distance_pairs_device

        uniq, inv = np.unique(np.concatenate([pa, pb]), return_inverse=True)
        sub = [filtered.payloads[i] for i in uniq]
        mat = dna.seqs_to_matrix(sub, fill=b"\x00")
        lengths = np.array([len(p) for p in sub], dtype=np.int64)
        return edit_distance_pairs_device(mat, lengths, inv[: len(pa)], inv[len(pa) :], device)
    buf, offsets, lengths = native_lib.pack_seqs(filtered.payloads)
    return native_lib.edit_distance_batch_native(buf, offsets, lengths, pa, pb)


def _process_mixed_clusters_batched(
    filtered: FilteredReads, starts, ends, strands, pending, epsil: float,
    out: np.ndarray, device=DEFAULT_DEVICE, timings: dict | None = None,
) -> None:
    """Mixed-length clusters, vectorized across the trial: one batched
    edit-distance pass for every cluster's pre-filter pairs, one
    cross-cluster MSA (ops.msa.align.align_clusters), then the per-cluster
    counting rules."""
    from ..ops.msa.align import align_clusters

    require_device(device)
    if timings is None:
        timings = {}
    mag = math.log((1 - epsil) / epsil)

    # ---- batched edit-distance pre-filter --------------------------------
    with span("llr.prefilter", timings=timings, key="edit_prefilter"):
        with span("llr.prefilter.pairs", kind=HOST):
            infos = []
            pa, pb = [], []
            for c in pending:
                s, e = int(starts[c]), int(ends[c])
                reads = filtered.payloads[s:e]
                quals = list(filtered.quals[s:e])
                ii, kk = np.triu_indices(len(reads), k=1)
                infos.append((int(strands[s]), reads, quals, len(pa), len(ii)))
                pa.extend((s + ii).tolist())
                pb.extend((s + kk).tolist())
            pa = np.asarray(pa, np.int64)
            pb = np.asarray(pb, np.int64)
        with span("llr.prefilter.editdist"):
            dists = _edit_distances(filtered, pa, pb, device) if len(pa) else np.zeros(0, np.int32)

        # ---- build MSA jobs ----------------------------------------------
        with span("llr.prefilter.keep", kind=HOST):
            jobs = []  # (strand, sub_reads, sub_quals)
            for strand, reads, quals, off, npairs in infos:
                ii, kk = np.triu_indices(len(reads), k=1)
                close = dists[off : off + npairs] < EDIT_PREFILTER_THRESHOLD
                keep = np.unique(np.concatenate([ii[close], kk[close]]))
                if len(keep) == 0:
                    continue  # erasure strand: LLRs stay zero
                jobs.append((strand, [reads[i] for i in keep], [quals[i] for i in keep]))
    if not jobs:
        return

    # ---- cross-cluster batched MSA + counting ----------------------------
    aligned = align_clusters([reads for _, reads, _ in jobs], device=device, timings=timings)
    with span("llr.counting", kind=HOST, timings=timings, key="counting"):
        for (strand, _, subq), rows_out in zip(jobs, aligned):
            out[strand] = _aligned_llr(rows_out, subq, mag)
