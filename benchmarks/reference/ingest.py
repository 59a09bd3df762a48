"""Plain reference of a trial's read ingest: the RS(8,4) index filter, the
clustering by strand, and the LLR rows of the strands whose reads need no
alignment.

The rules of the reference trial script (``ex_decoder/decoder.py``):

- a read's first 16 nt are its index: 32 bits, any non-ACGT base makes it
  undecodable; the RS(8,4) decoder over GF(16) (bounded distance, t = 2)
  keeps a read when it corrected at most 2 symbols and the decoded 16-bit
  value is in the index codebook; the read's strand is the value's rank
  there, its payload the rest of the read, its quality the code of its one
  quality character (decoder.py:59-119);
- a strand with more than one read, all of 136 nt, and a strand with one
  read, are counted without alignment: per bit, LLR = (zeros - ones) *
  log((1 - eps) / eps) over the reads' 272 bits (an out-of-alphabet
  symbol is a one vote); bit 271 counts only reads of quality >= 53, with
  the literal two-read rule of decoder.py:305-311; a single read shorter
  than 136 nt gives only bit 271, from its last bit, if its quality is
  above 63 (decoder.py:148-311); a strand with no read has LLRs 0;
- a strand with more than one read of mixed lengths goes through the
  pre-filter and the alignment (``reference/msa.py``).

Nothing of the program is imported.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from benchlib import recipe

Q_LOW, Q_HIGH = 53, 63


@functools.lru_cache(maxsize=None)
def _syndrome_table():
    """65536-entry tables from the packed syndrome (S1..S4 of the full
    15-symbol word, 4 bits each) to the error pattern of weight <= 2 that
    gives it: (count, -1 where none; positions [2]; values [2])."""
    exp, _ = recipe._gf16()
    # x_pow[j, k] = (alpha^j)^(14 - k): word symbol k is the coefficient of x^(14-k)
    x_pow = np.array([[exp[(j * (14 - k)) % 15] for k in range(15)] for j in range(1, 5)])
    count = np.full(1 << 16, -1, np.int64)
    pos = np.full((1 << 16, 2), -1, np.int64)
    val = np.zeros((1 << 16, 2), np.int64)
    count[0] = 0

    def key(s):
        return (s[0] << 12) | (s[1] << 8) | (s[2] << 4) | s[3]

    v = np.arange(1, 16)
    for p1 in range(15):
        s1 = recipe.gf16_mul(x_pow[:, p1][:, None], v[None, :])       # [4, 15]
        k = key(s1)
        count[k], pos[k, 0], val[k, 0] = 1, p1, v
        for p2 in range(p1 + 1, 15):
            s2 = recipe.gf16_mul(x_pow[:, p2][:, None], v[None, :])
            s = s1[:, :, None] ^ s2[:, None, :]                       # [4, 15, 15]
            k = key(s).reshape(-1)
            count[k] = 2
            pos[k, 0], pos[k, 1] = p1, p2
            val[k, 0] = np.repeat(v, 15)
            val[k, 1] = np.tile(v, 15)
    return x_pow, count, pos, val


def rs_decode_indices(idx_bytes: np.ndarray):
    """[R, 16] index bases -> (decoded 16-bit values [R], corrected symbol
    counts [R], -1 where undecodable)."""
    bits = recipe.dna_bits(idx_bytes).astype(np.int64)               # [R, 32]
    bad = (bits > 1).any(axis=1)
    syms = np.where(bits > 1, 0, bits).reshape(-1, 8, 4) @ np.array([8, 4, 2, 1])
    x_pow, count, pos, val = _syndrome_table()
    # the 8 sent symbols are word positions 7..14 (7 leading zeros shortened away)
    s = np.stack([np.bitwise_xor.reduce(recipe.gf16_mul(syms, x_pow[j, 7:][None, :]), axis=1)
                  for j in range(4)], axis=1)
    k = (s[:, 0] << 12) | (s[:, 1] << 8) | (s[:, 2] << 4) | s[:, 3]
    n_err = count[k]
    word = np.concatenate([np.zeros((len(syms), 7), np.int64), syms], axis=1)
    rows = np.arange(len(syms))
    for e in range(2):
        p = pos[k, e]
        fix = (n_err > 0) & (p >= 0)
        word[rows[fix], p[fix]] ^= val[k, e][fix]
    msg = word[:, 7:11]
    values = ((msg[:, 0] << 12) | (msg[:, 1] << 8) | (msg[:, 2] << 4) | msg[:, 3])
    return values, np.where(bad, -1, n_err)


def filter_reads(reads, quals) -> dict:
    """strand -> list of (payload, quality) of its kept reads, in read order."""
    idx = recipe.to_matrix([r[:16] for r in reads], width=16)
    values, n_err = rs_decode_indices(idx)
    rank = recipe.codebook_rank()[values]
    keep = (n_err >= 0) & (n_err <= 2) & (rank >= 0)
    out: dict = {}
    for i in np.nonzero(keep)[0]:
        out.setdefault(int(rank[i]), []).append((reads[i][16:], ord(quals[i]) if isinstance(quals[i], str) else int(quals[i])))
    return out


def needs_alignment(strand_reads) -> bool:
    return len(strand_reads) > 1 and any(len(p) != recipe.PAYLOAD_NT for p, _ in strand_reads)


def count_rows(payloads, quals, mag: float) -> np.ndarray:
    """LLRs of equal-width rows (decoder.py:293-311)."""
    bits = recipe.dna_bits(recipe.to_matrix(payloads))[:, : recipe.PAYLOAD_BITS]
    q = np.asarray(quals)
    zero = bits == 0
    llr = (zero.sum(0) - (~zero).sum(0)).astype(np.float64) * mag
    z = zero[q >= Q_LOW, recipe.PAYLOAD_BITS - 1]
    qz = q[q >= Q_LOW]
    c0, c1 = int(z.sum()), int((~z).sum())
    if c0 == 1 and c1 == 1:
        q0, q1 = int(qz[z].sum()), int(qz[~z].sum())
        llr[-1] = -2 * mag if (q0 < Q_LOW and q1 >= Q_HIGH) else (2 * mag if (q0 >= Q_HIGH and q1 < Q_LOW) else 0.0)
    else:
        llr[-1] = (c0 - c1) * mag
    return llr


def counted_row(strand_reads, epsil: float) -> np.ndarray:
    """The LLR row of a strand whose reads need no alignment."""
    mag = math.log((1 - epsil) / epsil)
    if not strand_reads:
        return np.zeros(recipe.PAYLOAD_BITS)
    if len(strand_reads) == 1:
        p, q = strand_reads[0]
        if len(p) < recipe.PAYLOAD_NT:
            llr = np.zeros(recipe.PAYLOAD_BITS)
            if q > Q_HIGH:
                last = recipe.dna_bits(recipe.to_matrix([p]))[0, -1]
                llr[-1] = mag if last == 0 else -mag
            return llr
        return count_rows([p], [q], mag)
    return count_rows([p for p, _ in strand_reads], [q for _, q in strand_reads], mag)
