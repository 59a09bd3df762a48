"""Raw-read ingestion: paired-end FASTQ merging (the upstream FLASH step).

Carried from ``dna_ldpc_tpu/pipeline/ingest.py`` as numpy code.

The reference repo ships zipped Illumina R1/R2 FASTQ pairs
(``fastq files/Exp #1..3``) and notes that reads were merged with the
external FLASH tool before entering the pipeline (``README.md`` "Thanks
to libraries"; SURVEY.md §2.6). The merged ``72000_RS_<t>.txt`` /
``72000_RS_Q_<t>.txt`` trial files are what ``decoder.py:48-57``
consumes. This module provides that upstream step natively so the
framework covers the full raw-FASTQ -> trial-file path:

- :func:`reverse_complement_batch` — vectorized A<->T / C<->G flip;
- :func:`merge_pairs` — overlap-merge R1 with reverse-complemented R2,
  FLASH-style: score every candidate overlap by mismatch density, keep
  the densest-match overlap, and build the consensus taking the
  higher-quality base at disagreements (quality = max on agreement,
  the winner's quality on disagreement);
- :func:`merged_read_and_qline` — reduce each merged read's quality
  string to the single per-read quality character the trial files carry
  (the minimum payload quality, the conservative summary consistent
  with how ``decoder.py:90`` thresholds one char per read).

Overlap scoring runs in the native host library (``native/ingest.cpp``
``merge_overlap_batch``, built by the port's loader; a failed build
raises); ``score_overlaps_ref`` is its numpy twin, vectorized over the
whole batch of read pairs per overlap shift, which the tests hold it to.
Bases are compared as uint8 codes. 'N' bases never count
as matches but are not counted as mismatches either (unknown, not
conflicting), matching common merger behavior.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import native_lib
from ..utils.dna import seqs_to_matrix

_COMP = np.zeros(256, np.uint8)
for a, b in zip(b"ACGTN-", b"TGCAN-"):
    _COMP[a] = b


def reverse_complement_batch(mat: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Reverse-complement each row of a right-padded uint8 base matrix."""
    n, L = mat.shape
    comp = _COMP[mat]
    out = np.full_like(mat, ord("-"))
    # place the reversed length-l prefix of each row at the left edge
    idx = np.arange(L)[None, :]
    src = lengths[:, None] - 1 - idx  # position l-1-i
    valid = src >= 0
    rows = np.arange(n)[:, None]
    out[valid] = comp[rows.repeat(L, 1)[valid], src[valid]]
    return out


@dataclasses.dataclass
class MergeResult:
    merged: list[str]        # merged sequences (empty string where unmerged)
    merged_qual: list[str]   # per-base quality strings
    overlap: np.ndarray      # [n] chosen overlap length (0 = not merged)
    mismatches: np.ndarray   # [n] mismatch count in the chosen overlap

    @property
    def ok(self) -> np.ndarray:
        return self.overlap > 0


def merge_pairs(
    r1: list[str],
    q1: list[str],
    r2: list[str],
    q2: list[str],
    min_overlap: int = 10,
    max_mismatch_density: float = 0.25,
) -> MergeResult:
    """Merge paired-end reads (R2 given in sequencing orientation; it is
    reverse-complemented here). For each pair, every overlap length
    ``o`` in [min_overlap, min(len1, len2)] aligns the last ``o`` bases
    of R1 with the first ``o`` bases of rc(R2); the overlap with the
    lowest mismatch density (ties -> longer overlap) wins, and the pair
    merges iff that density <= ``max_mismatch_density``.
    """
    n = len(r1)
    if n == 0:
        return MergeResult([], [], np.zeros(0, np.int64), np.zeros(0, np.int64))
    l1 = np.array([len(s) for s in r1], np.int64)
    l2 = np.array([len(s) for s in r2], np.int64)
    L = int(max(l1.max(), l2.max()))
    m1 = seqs_to_matrix(r1, pad=L)
    m2 = reverse_complement_batch(seqs_to_matrix(r2, pad=L), l2)
    qm1 = seqs_to_matrix(q1, pad=L, fill=b"\x00")
    qm2r = seqs_to_matrix(q2, pad=L, fill=b"\x00")
    # reverse the quality strings alongside rc(R2)
    qm2 = np.zeros_like(qm2r)
    idx = np.arange(L)[None, :]
    src = l2[:, None] - 1 - idx
    valid = src >= 0
    rows = np.arange(n)[:, None].repeat(L, 1)
    qm2[valid] = qm2r[rows[valid], src[valid]]

    best_o, best_mm = native_lib.merge_overlap_batch_native(m1, m2, l1, l2, min_overlap)
    best_density = np.where(best_o > 0, best_mm / np.maximum(best_o, 1), np.inf)

    merged_mask = (best_o >= min_overlap) & (best_density <= max_mismatch_density)
    best_o = np.where(merged_mask, best_o, 0)

    merged: list[str] = []
    quals: list[str] = []
    for i in range(n):
        o = int(best_o[i])
        if o == 0:
            merged.append("")
            quals.append("")
            continue
        a1, a2 = int(l1[i]), int(l2[i])
        head = m1[i, : a1 - o]
        qhead = qm1[i, : a1 - o]
        ov1, ov2 = m1[i, a1 - o : a1], m2[i, :o]
        qo1, qo2 = qm1[i, a1 - o : a1], qm2[i, :o]
        agree = ov1 == ov2
        take1 = qo1 >= qo2
        ov = np.where(agree, ov1, np.where(take1, ov1, ov2))
        qov = np.where(agree, np.maximum(qo1, qo2), np.where(take1, qo1, qo2))
        tail = m2[i, o:a2]
        qtail = qm2[i, o:a2]
        merged.append(bytes(np.concatenate([head, ov, tail])).decode())
        quals.append(bytes(np.concatenate([qhead, qov, qtail])).decode())
    return MergeResult(merged, quals, best_o, best_mm)


def score_overlaps_ref(m1, m2, l1, l2, min_overlap):
    """Best (lowest mismatch density, ties -> longest) overlap per pair:
    the numpy twin of ``native_lib.merge_overlap_batch_native``."""
    max_o = np.minimum(l1, l2)
    n, L = m1.shape
    best_o = np.zeros(n, np.int64)
    best_mm = np.zeros(n, np.int64)
    best_density = np.full(n, np.inf)

    is_n1 = m1 == ord("N")
    is_n2 = m2 == ord("N")
    for o in range(min_overlap, L + 1):
        # last o bases of R1 start at l1-o (per row); first o of rc(R2)
        cols = np.arange(o)[None, :]
        s1 = l1[:, None] - o + cols  # [n, o]
        ok_rows = max_o >= o
        if not ok_rows.any():
            break
        r = np.nonzero(ok_rows)[0]
        a = m1[r[:, None], s1[r]]
        b = m2[r][:, :o]
        informative = ~(is_n1[r[:, None], s1[r]] | is_n2[r][:, :o])
        mm = ((a != b) & informative).sum(1)
        density = mm / o
        upd = density < best_density[r] - 1e-12
        # equal density -> prefer the longer overlap (later o wins ties)
        upd |= np.abs(density - best_density[r]) <= 1e-12
        ri = r[upd]
        best_o[ri] = o
        best_mm[ri] = mm[upd]
        best_density[ri] = density[upd]
    return best_o, best_mm


def merged_read_and_qline(result: MergeResult, index_len: int = 16):
    """Project a merge result into the trial-file convention: the read
    line is the merged sequence; the quality line is ONE character per
    read (``decoder.py:54,90`` reads a single char) — the minimum
    payload-region quality, a conservative per-read summary."""
    reads, qchars = [], []
    for seq, qual, o in zip(result.merged, result.merged_qual, result.overlap):
        if o == 0:
            continue
        reads.append(seq)
        payload_q = qual[index_len:] or qual
        qchars.append(min(payload_q) if payload_q else "!")
    return reads, qchars
