"""The benchmark's data recipe, frozen: the index codebook, the RS(8,4)
index encoder and decoder over GF(16), the oligo layout and the read
channel.

A frozen numpy copy of what ``dna_ldpc_tpu_torch/models/codebook.py``,
``models/rs_index.py``, ``utils/dna.py`` and ``pipeline/simulate.py``
(``encode_oligos``, ``ChannelModel``, ``simulate_reads``) do, so that a
change to the program cannot move the yardstick. It imports nothing of the
program. The semantics are those of the reference pipeline
(``sjpark0905/DNA-LDPC-codes``, ``ex_decoder``): A=00, C=01, G=10, T=11,
any other character is the symbol 2 in both bit positions; each oligo is a
16-nt RS(8,4)-encoded index followed by a 136-nt payload; strand ``s``
carries bit column ``s`` of the [272, 18432] codeword matrix.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

N_STRANDS = 18432
PAYLOAD_BITS = 272
PAYLOAD_NT = 136
INDEX_NT = 16

# ---------------------------------------------------------------------------
# DNA <-> bits
# ---------------------------------------------------------------------------

_HI = np.full(256, 2, np.uint8)
_LO = np.full(256, 2, np.uint8)
for _b, (_h, _l) in {"A": (0, 0), "C": (0, 1), "G": (1, 0), "T": (1, 1)}.items():
    _HI[ord(_b)], _LO[ord(_b)] = _h, _l
BASES = np.frombuffer(b"ACGT", np.uint8)


def to_matrix(seqs, fill: int = ord("-"), width: int | None = None) -> np.ndarray:
    """[n, L] uint8 rows of ``seqs`` padded with ``fill``."""
    arrs = [np.frombuffer(s.encode("latin1"), np.uint8) for s in seqs]
    L = width if width is not None else max((len(a) for a in arrs), default=0)
    out = np.full((len(arrs), L), fill, np.uint8)
    for i, a in enumerate(arrs):
        out[i, : min(len(a), L)] = a[:L]
    return out


def dna_bits(seq_bytes: np.ndarray) -> np.ndarray:
    """[..., L] bases -> [..., 2L] bit symbols in {0, 1, 2}."""
    out = np.stack([_HI[seq_bytes], _LO[seq_bytes]], axis=-1)
    return out.reshape(seq_bytes.shape[:-1] + (2 * seq_bytes.shape[-1],))


def bits_dna(bits: np.ndarray) -> np.ndarray:
    """[..., 2L] bits in {0, 1} -> [..., L] bases."""
    b = np.asarray(bits, np.uint8)
    pairs = b.reshape(b.shape[:-1] + (b.shape[-1] // 2, 2))
    return BASES[(pairs[..., 0] << 1) | pairs[..., 1]]


def msb_bits(values: np.ndarray, width: int) -> np.ndarray:
    shifts = np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((np.asarray(values, np.int64)[..., None] >> shifts) & 1).astype(np.uint8)


# ---------------------------------------------------------------------------
# The index codebook (ex_decoder/pre_processing.py:20-86)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def index_codebook() -> np.ndarray:
    """The 18,432 valid 16-bit index values, ascending: 14-bit patterns
    whose quaternary symbols 2/3 and 5/6 differ, each followed by
    [j, (popcount(rank) + j) mod 2] — the parity taken from the rank in the
    filtered table, as the reference script does."""
    i = np.arange(1 << 14, dtype=np.int64)
    bits = (i[:, None] >> np.arange(13, -1, -1)) & 1
    sym = 2 * bits[:, 0::2] + bits[:, 1::2]
    kept = i[(sym[:, 2] != sym[:, 3]) & (sym[:, 5] != sym[:, 6])]
    pop = np.array([bin(r).count("1") for r in range(len(kept))], np.int64)
    j = np.array([0, 1], np.int64)
    vals = (kept[:, None] << 2) | (j[None, :] << 1) | ((pop[:, None] + j[None, :]) % 2)
    return np.sort(vals.reshape(-1))


@functools.lru_cache(maxsize=None)
def codebook_rank() -> np.ndarray:
    """2^16 table: index value -> strand number, -1 where invalid."""
    table = np.full(1 << 16, -1, np.int64)
    table[index_codebook()] = np.arange(N_STRANDS)
    return table


# ---------------------------------------------------------------------------
# GF(16) and the RS(8,4) index code (MATLAB rsenc/rsdec defaults: narrow
# sense, roots alpha^1..alpha^4, primitive polynomial x^4 + x + 1, the
# (15, 11) code shortened to (8, 4), corrects two symbol errors)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _gf16():
    exp = np.zeros(30, np.int64)
    x = 1
    for k in range(15):
        exp[k] = x
        x <<= 1
        if x & 16:
            x ^= 0b10011
    exp[15:] = exp[:15]
    log = np.full(16, -1, np.int64)
    log[exp[:15]] = np.arange(15)
    return exp, log


def gf16_mul(a, b):
    exp, log = _gf16()
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    return np.where((a == 0) | (b == 0), 0, exp[(log[a] + log[b]) % 15])


@functools.lru_cache(maxsize=None)
def _rs_generator() -> np.ndarray:
    """g(x) = prod_{j=1..4} (x + alpha^j), coefficients high degree first."""
    exp, _ = _gf16()
    g = np.array([1], np.int64)
    for j in range(1, 5):
        g = np.concatenate([g, [0]]) ^ np.concatenate([[0], gf16_mul(g, exp[j])])
    return g


def rs_encode(msgs: np.ndarray) -> np.ndarray:
    """[..., 4] GF(16) message symbols -> [..., 8] systematic codewords
    [message, parity] (first symbol = highest degree)."""
    g = _rs_generator()
    msgs = np.asarray(msgs, np.int64)
    rem = np.concatenate([msgs, np.zeros(msgs.shape[:-1] + (4,), np.int64)], axis=-1)
    for k in range(4):
        lead = rem[..., k].copy()
        rem[..., k : k + 5] ^= gf16_mul(lead[..., None], g[None, :])
    return np.concatenate([msgs, rem[..., 4:]], axis=-1)


def strand_index_dna() -> np.ndarray:
    """[18432, 16] bases: the RS(8,4)-encoded index of every strand."""
    msg = msb_bits(index_codebook(), 16).reshape(-1, 4, 4) @ np.array([8, 4, 2, 1])
    return bits_dna(msb_bits(rs_encode(msg), 4).reshape(-1, 32))


def encode_oligos(codewords: np.ndarray) -> np.ndarray:
    """[272, 18432] codeword bits -> [18432, 152] oligo bases (index +
    payload; strand s carries bit column s)."""
    payload = bits_dna(np.ascontiguousarray(np.asarray(codewords, np.uint8).T))
    return np.concatenate([strand_index_dna(), payload], axis=1)


# ---------------------------------------------------------------------------
# The read channel
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ChannelModel:
    """Per-base error rates and the two quality characters (one quality
    character per read, as the reference's quality files carry)."""

    substitution: float = 0.01
    insertion: float = 2e-5
    deletion: float = 5e-4
    q_high: int = 70
    q_low: int = 40
    p_low_quality: float = 0.05


def simulate_reads(pool: np.ndarray, n_reads: int, channel: ChannelModel, rng: np.random.Generator):
    """Draw ``n_reads`` reads uniformly from the [n_oligos, L] base matrix
    ``pool`` through the channel: a substitution to one of the three other
    bases, a deletion of a base, an insertion slot before every base and at
    the end. Returns (reads, quality characters) as lists of str."""
    picks = rng.integers(0, len(pool), size=n_reads)
    L = pool.shape[1]
    seqs = pool[picks].copy()
    sub = rng.random(seqs.shape) < channel.substitution
    if sub.any():
        r, c = np.nonzero(sub)
        sym = (_HI[seqs[r, c]] << 1) | _LO[seqs[r, c]]
        seqs[r, c] = BASES[(sym + rng.integers(1, 4, size=len(r))) % 4]
    dele = rng.random(seqs.shape) < channel.deletion
    ins = rng.random((n_reads, L + 1)) < channel.insertion
    ins_base = BASES[rng.integers(0, 4, size=(n_reads, L + 1))]
    indel = np.nonzero(dele.any(axis=1) | ins.any(axis=1))[0]
    reads = [row.tobytes().decode("ascii") for row in seqs]
    if len(indel):
        # slot k of a read: the base inserted before base k, then base k (slot L: an insertion at the end)
        vals = np.stack([ins_base[indel], np.pad(seqs[indel], ((0, 0), (0, 1)))], axis=2).reshape(len(indel), -1)
        keep = np.stack([ins[indel], np.pad(~dele[indel], ((0, 0), (0, 1)))], axis=2).reshape(len(indel), -1)
        flat = vals[keep].tobytes().decode("ascii")
        ends = np.cumsum(keep.sum(axis=1))
        for i, a, b in zip(indel, ends - keep.sum(axis=1), ends):
            reads[i] = flat[a:b]
    q = np.where(rng.random(n_reads) < channel.p_low_quality, channel.q_low, channel.q_high)
    return reads, [chr(c) for c in q]
