"""Sequencing-read simulator: synthesizes trials from the encoded oligo
pool for end-to-end runs.

Carried from ``dna_ldpc_tpu/pipeline/simulate.py`` as numpy code: the
channel model, ``load_oligos`` and ``simulate_reads``. Calibration
against shipped quality files is not ported. Sample oligos with a
coverage distribution, apply substitution/insertion/deletion noise per
base, and emit one quality character per read (the reference's quality
files carry exactly one char per read, decoder.py:54,90).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils import dna


@dataclass
class ChannelModel:
    """Per-base error rates. Defaults are calibrated to the regime the
    reference pipeline actually tolerates: its LLR rules keep only MSA
    rows whose aligned width is exactly 136 (decoder.py:209-233), so ANY
    cluster containing an insertion read (aligned width >= 137) becomes
    an all-but-bit-271 erasure. The real dataset is deletion-dominant;
    at Illumina-like insertion rates (~1e-5/nt) insertion-erased clusters
    stay rare enough for BP to absorb."""

    substitution: float = 0.01
    insertion: float = 2e-5
    deletion: float = 5e-4
    # quality chars: high-quality reads get > '?' (63), low-quality < '5' (53)
    q_high: int = 70
    q_low: int = 40
    p_low_quality: float = 0.05


def load_oligos(path: str) -> list[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def simulate_reads(
    oligos: list[str],
    n_reads: int,
    channel: ChannelModel = ChannelModel(),
    seed: int = 0,
) -> tuple[list[str], list[str]]:
    """Sample n_reads uniformly from the oligo pool through the noisy
    channel. Returns (reads, quality_chars).

    Vectorized over the whole batch: substitutions are applied as one
    masked matrix update; only reads that actually draw an indel (a few
    percent at the calibrated rates) take a per-read slow path."""
    rng = np.random.default_rng(seed)
    picks = rng.integers(0, len(oligos), size=n_reads)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)

    pool = dna.seqs_to_matrix(oligos)          # [n_oligos, L] uint8
    L = pool.shape[1]
    seqs = pool[picks].copy()                  # [n_reads, L]

    # substitutions: replace with one of the three other bases
    sub_mask = rng.random(seqs.shape) < channel.substitution
    if sub_mask.any():
        r, c = np.nonzero(sub_mask)
        offs = rng.integers(1, 4, size=len(r))
        cur = dna.dna_to_symbols(seqs[r, c])
        seqs[r, c] = bases[(cur + offs) % 4]

    del_mask = rng.random(seqs.shape) < channel.deletion
    # one insertion slot before each base plus one at the end
    ins_mask = rng.random((n_reads, L + 1)) < channel.insertion
    ins_base = bases[rng.integers(0, 4, size=(n_reads, L + 1))]
    has_indel = del_mask.any(axis=1) | ins_mask.any(axis=1)

    reads: list[str] = [""] * n_reads
    clean = np.nonzero(~has_indel)[0]
    for i in clean:
        reads[i] = seqs[i].tobytes().decode("ascii")
    for i in np.nonzero(has_indel)[0]:
        seq = seqs[i][~del_mask[i]]
        im = ins_mask[i][np.concatenate([~del_mask[i], [True]])]
        if im.any():
            ib = ins_base[i][np.concatenate([~del_mask[i], [True]])]
            out = np.empty(len(seq) + int(im.sum()), np.uint8)
            # positions shift right by the number of insertions at or
            # before each slot
            shift = np.cumsum(im)
            out[np.nonzero(im)[0] + shift[im] - 1] = ib[im]
            pos = np.arange(len(seq)) + shift[:-1][np.arange(len(seq))]
            out[pos] = seq
            seq = out
        reads[i] = seq.tobytes().decode("ascii")

    qv = np.where(
        rng.random(n_reads) < channel.p_low_quality, channel.q_low, channel.q_high
    ).astype(np.uint8)
    quals = [chr(q) for q in qv]
    return reads, quals


# ---------------------------------------------------------------------------
# Synthetic trials: codewords and their oligo pool
# ---------------------------------------------------------------------------


def group_union_codewords(code, n: int, rng: np.random.Generator) -> np.ndarray:
    """[n, N] uint8 codewords of a permutation-blocked code (external
    column order), each the union of a random even-sized subset of the
    code's J column groups. Every check meets each column group exactly
    once, so an even union satisfies every check — valid codewords without
    an encoder."""
    bits_c = np.zeros((n, code.J, code.q), np.uint8)
    for k in range(n):
        size = 2 * int(rng.integers(0, code.J // 2 + 1))
        bits_c[k, rng.choice(code.J, size, replace=False)] = 1
    return bits_c.reshape(n, code.n_vars)[:, code.external_gather()]


def strand_index_dna() -> np.ndarray:
    """[18432, 16] uint8 DNA bytes: the RS(8,4)-encoded 16-nt index prefix
    of every strand, in the bit packing rs_filter_reads decodes
    (rs_dec_init.m; decoder.py:59-64)."""
    from ..models.codebook import index_codebook
    from ..models.rs_index import rs_encode

    msg_bits = dna.int_to_bits_msb(index_codebook(), 16)      # [S, 16]
    syms = msg_bits.reshape(-1, 4, 4) @ (1 << np.arange(3, -1, -1))
    cw = rs_encode(syms)                                      # [S, 8] GF(16)
    return dna.bits_to_dna(dna.int_to_bits_msb(cw, 4).reshape(-1, 32))


def encode_oligos(codewords: np.ndarray) -> list[str]:
    """The 18,432 oligos (index + 136-nt payload) that store [272, 18432]
    codeword bits: strand s carries bit column s."""
    payload = dna.bits_to_dna(np.ascontiguousarray(codewords.T, np.uint8))
    oligo = np.concatenate([strand_index_dna(), payload], axis=1)
    return [row.tobytes().decode("ascii") for row in oligo]
