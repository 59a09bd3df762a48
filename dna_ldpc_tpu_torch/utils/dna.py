"""Carried from ``dna_ldpc_tpu/utils/dna.py`` as numpy code: the
JAX package cannot be imported without ``jax``. tests/test_torch_models.py
holds it equal to the original.

DNA <-> bit/symbol mappings, vectorized over numpy byte arrays.

Reproduces the exact mapping of the reference (``ex_decoder/def_func.py:
97-117``): A=00, C=01, G=10, T=11, and any other character (including the
alignment gap '-') maps to the out-of-alphabet symbol 2 for *both* bits.
The reference keeps sequences as Python strings; here they are uint8 code
arrays so whole read batches convert in one shot.
"""

from __future__ import annotations

import numpy as np

# Per-base 2-bit values indexed by ASCII byte; out-of-alphabet bases get
# bit value 2 in both positions (def_func.py:111-112 maps them to "2 2").
_BASE_BITS_HI = np.full(256, 2, dtype=np.uint8)
_BASE_BITS_LO = np.full(256, 2, dtype=np.uint8)
for _b, (_hi, _lo) in {"A": (0, 0), "C": (0, 1), "G": (1, 0), "T": (1, 1)}.items():
    _BASE_BITS_HI[ord(_b)] = _hi
    _BASE_BITS_LO[ord(_b)] = _lo

_BITS_BASE = np.frombuffer(b"ACGT", dtype=np.uint8)


def seq_to_bytes(seq: str) -> np.ndarray:
    return np.frombuffer(seq.encode("ascii"), dtype=np.uint8)


def seqs_to_matrix(seqs, pad: int | None = None, fill: bytes = b"-") -> np.ndarray:
    """Stack variable-length sequences into a [n, L] uint8 matrix padded
    with ``fill``; L = max length (or ``pad``)."""
    arrs = [seq_to_bytes(s) if isinstance(s, str) else np.asarray(s, np.uint8) for s in seqs]
    L = pad if pad is not None else max((len(a) for a in arrs), default=0)
    out = np.full((len(arrs), L), fill[0], dtype=np.uint8)
    for i, a in enumerate(arrs):
        out[i, : len(a)] = a[:L]
    return out


def dna_to_bits(seq_bytes: np.ndarray) -> np.ndarray:
    """[..., L] base bytes -> [..., 2L] bit symbols in {0,1,2} (2 = non-ACGT,
    counted as a "one" vote by the LLR rules, decoder.py:298-303)."""
    hi = _BASE_BITS_HI[seq_bytes]
    lo = _BASE_BITS_LO[seq_bytes]
    out = np.stack([hi, lo], axis=-1)
    return out.reshape(seq_bytes.shape[:-1] + (2 * seq_bytes.shape[-1],))


def bits_to_dna(bits: np.ndarray) -> np.ndarray:
    """[..., 2L] bits in {0,1} -> [..., L] base bytes (inverse mapping)."""
    b = np.asarray(bits)
    pairs = b.reshape(b.shape[:-1] + (b.shape[-1] // 2, 2))
    return _BITS_BASE[(pairs[..., 0] << 1) | pairs[..., 1]]


def dna_to_symbols(seq_bytes: np.ndarray) -> np.ndarray:
    """Base bytes -> quaternary symbols 0..3 (A,C,G,T); non-ACGT -> 4."""
    hi = _BASE_BITS_HI[seq_bytes].astype(np.int8)
    lo = _BASE_BITS_LO[seq_bytes].astype(np.int8)
    sym = (hi << 1) | lo
    return np.where((hi == 2), np.int8(4), sym)


def bits_to_int_msb(bits: np.ndarray) -> np.ndarray:
    """MSB-first bits -> integer, vectorized ``binary2decimal``
    (def_func.py:120-124)."""
    bits = np.asarray(bits, dtype=np.int64)
    w = 1 << np.arange(bits.shape[-1] - 1, -1, -1, dtype=np.int64)
    return bits @ w


def int_to_bits_msb(values: np.ndarray, width: int) -> np.ndarray:
    values = np.asarray(values, dtype=np.int64)
    shifts = np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((values[..., None] >> shifts) & 1).astype(np.uint8)
