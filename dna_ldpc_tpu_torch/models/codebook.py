"""Carried from ``dna_ldpc_tpu/models/codebook.py`` as numpy code: the
JAX package cannot be imported without ``jax``. tests/test_torch_models.py
holds it equal to the original.

The 18,432-entry valid index codebook.

Vectorized reproduction of ``ex_decoder/pre_processing.py:20-86``: from the
2^14 14-bit patterns, keep those whose quaternary symbols satisfy the
run-length constraint (symbol[2] != symbol[3] and symbol[5] != symbol[6]),
then append two bits [j, (popcount + j) mod 2] for j in {0, 1}.

Reference quirk preserved deliberately: the parity bit uses the popcount of
row ``r`` of the *unfiltered* 2^14-pattern table, where ``r`` is the rank of
the pattern in the *filtered* table (``pre_processing.py:78`` indexes
``index[i]`` with the filtered loop variable). The codebook defines which
decoded read indices survive filtering (decoder.py:110-115), so the build
must match the reference set exactly, quirk included; the test suite checks
set equality against an execution of the reference enumeration.
"""

from __future__ import annotations

import functools

import numpy as np

N_STRANDS = 18432
INDEX_BITS = 16
PAYLOAD_BITS = 272
PAYLOAD_NT = 136
INDEX_NT = 16
STRAND_NT = INDEX_NT + PAYLOAD_NT


@functools.lru_cache(maxsize=None)
def index_codebook() -> np.ndarray:
    """Sorted int64 array of the 18,432 valid 16-bit index values."""
    n14 = 1 << 14
    i = np.arange(n14, dtype=np.int64)
    bits = (i[:, None] >> np.arange(13, -1, -1)) & 1  # [16384, 14] MSB-first
    sym = 2 * bits[:, 0::2] + bits[:, 1::2]  # [16384, 7] quaternary
    keep = (sym[:, 2] != sym[:, 3]) & (sym[:, 5] != sym[:, 6])
    kept = i[keep]  # 9216 patterns, ascending

    # Popcount quirk: parity source is the unfiltered table at the filtered
    # rank, i.e. popcount(rank), not popcount(pattern).
    ranks = np.arange(len(kept), dtype=np.int64)
    pop = np.bitwise_count(ranks) if hasattr(np, "bitwise_count") else np.array(
        [bin(int(r)).count("1") for r in ranks], dtype=np.int64
    )

    j = np.array([0, 1], dtype=np.int64)
    vals = (kept[:, None] << 2) | (j[None, :] << 1) | ((pop[:, None] + j[None, :]) % 2)
    return np.sort(vals.reshape(-1))


@functools.lru_cache(maxsize=None)
def codebook_lookup() -> np.ndarray:
    """Boolean table of size 2^16: table[v] == v is a valid index."""
    table = np.zeros(1 << INDEX_BITS, dtype=bool)
    table[index_codebook()] = True
    return table


@functools.lru_cache(maxsize=None)
def codebook_rank() -> np.ndarray:
    """int32 table of size 2^16 mapping a valid index value to its rank
    (strand number 0..18431 in sorted order); -1 for invalid values."""
    table = np.full(1 << INDEX_BITS, -1, dtype=np.int32)
    table[index_codebook()] = np.arange(N_STRANDS, dtype=np.int32)
    return table
