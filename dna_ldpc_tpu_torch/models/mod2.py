"""Carried from ``dna_ldpc_tpu/models/mod2.py`` as numpy code: the
JAX package cannot be imported without ``jax``. tests/test_torch_codes.py
holds it equal to the original.

Dense GF(2) linear algebra on bit-packed numpy arrays.

Replacement for the reference's GF(2) matrix toolchain
(``LDPC_dec/ldpc/mod2dense.cpp``, ``mod2sparse_decomp`` LU decomposition,
``make_gen.cpp`` generator construction and ``enc.cpp`` encoding): rows are
packed 64 columns per uint64 word so elimination steps are whole-row XORs.

Used for: codeword/test-vector generation (nullspace bases), generator
construction from a parity-check matrix (pivot column selection by Gaussian
elimination, the dense-mode strategy of make_gen.cpp:39-…), rank/dependent
row analysis (the deployed H has 2048 rows of rank 1860), and systematic
encoding.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def pack_rows(dense: np.ndarray) -> np.ndarray:
    """[m, n] 0/1 -> [m, ceil(n/64)] uint64, little-endian bit order."""
    dense = np.asarray(dense, dtype=np.uint8)
    m, n = dense.shape
    pad = (-n) % 64
    if pad:
        dense = np.concatenate([dense, np.zeros((m, pad), np.uint8)], axis=1)
    b = dense.reshape(m, -1, 64).astype(np.uint64)
    shifts = np.arange(64, dtype=np.uint64)
    return (b << shifts).sum(axis=2, dtype=np.uint64)


def unpack_rows(packed: np.ndarray, n: int) -> np.ndarray:
    shifts = np.arange(64, dtype=np.uint64)
    bits = (packed[:, :, None] >> shifts) & np.uint64(1)
    return bits.reshape(packed.shape[0], -1)[:, :n].astype(np.uint8)


@dataclasses.dataclass
class Elimination:
    """Result of Gaussian elimination on a GF(2) matrix."""

    rank: int
    pivot_cols: np.ndarray      # [rank] column of each pivot
    pivot_rows: np.ndarray      # [rank] original row index of each pivot row
    rre: np.ndarray             # [m, n] reduced row-echelon form (unpacked)
    dependent_rows: np.ndarray  # original indices of linearly dependent rows


def eliminate(dense: np.ndarray) -> Elimination:
    """Reduced row echelon form over GF(2) with partial column pivoting."""
    dense = np.asarray(dense, dtype=np.uint8)
    m, n = dense.shape
    P = pack_rows(dense)
    row_of = np.arange(m)
    pivot_cols, pivot_rows = [], []
    r = 0
    for c in range(n):
        if r >= m:
            break
        word, bit = divmod(c, 64)
        col = (P[r:, word] >> np.uint64(bit)) & np.uint64(1)
        nz = np.nonzero(col)[0]
        if len(nz) == 0:
            continue
        p = r + nz[0]
        if p != r:
            P[[r, p]] = P[[p, r]]
            row_of[[r, p]] = row_of[[p, r]]
        # clear this column in all other rows
        has = ((P[:, word] >> np.uint64(bit)) & np.uint64(1)).astype(bool)
        has[r] = False
        P[has] ^= P[r]
        pivot_cols.append(c)
        pivot_rows.append(row_of[r])
        r += 1
    rank = r
    return Elimination(
        rank=rank,
        pivot_cols=np.array(pivot_cols, dtype=np.int64),
        pivot_rows=np.array(pivot_rows, dtype=np.int64),
        rre=unpack_rows(P, n),
        dependent_rows=np.sort(row_of[rank:]),
    )


def rank(dense: np.ndarray) -> int:
    return eliminate(dense).rank


def nullspace_basis(dense: np.ndarray) -> np.ndarray:
    """[n-rank, n] basis of {x : A x = 0} over GF(2)."""
    e = eliminate(dense)
    m, n = np.asarray(dense).shape
    free_cols = np.setdiff1d(np.arange(n), e.pivot_cols)
    basis = np.zeros((len(free_cols), n), dtype=np.uint8)
    for k, fc in enumerate(free_cols):
        basis[k, fc] = 1
        # pivot rows: x_pivot = sum of free col entries in that row
        basis[k, e.pivot_cols] = e.rre[: e.rank, fc]
    return basis


@dataclasses.dataclass
class Generator:
    """Systematic encoder derived from H: codeword bits at ``info_cols``
    carry the message; bits at ``parity_cols`` are computed.

    The reference builds the same object via LU decomposition of an
    invertible column subset (make_gen.cpp dense/mixed strategies,
    ``mod2sparse_decomp``); here the pivot columns of Gaussian elimination
    play that role and the parity map is materialized as a dense bit
    matrix for one-matmul encoding.
    """

    n: int
    info_cols: np.ndarray    # [k]
    parity_cols: np.ndarray  # [rank]
    parity_map: np.ndarray   # [rank, k] uint8: parity = map @ message (mod 2)

    @property
    def k(self) -> int:
        return len(self.info_cols)

    def encode(self, message: np.ndarray) -> np.ndarray:
        """message: [..., k] -> codeword [..., n] with H @ cw = 0."""
        message = np.asarray(message, dtype=np.uint8)
        parity = (message @ self.parity_map.T) % 2
        out = np.zeros(message.shape[:-1] + (self.n,), dtype=np.uint8)
        out[..., self.info_cols] = message
        out[..., self.parity_cols] = parity
        return out


def make_generator(dense_H: np.ndarray) -> Generator:
    e = eliminate(dense_H)
    m, n = np.asarray(dense_H).shape
    info_cols = np.setdiff1d(np.arange(n), e.pivot_cols)
    # In RREF, pivot-row r reads: x[pivot_cols[r]] = sum_free rre[r, free]
    parity_map = e.rre[: e.rank][:, info_cols]
    return Generator(
        n=n, info_cols=info_cols, parity_cols=e.pivot_cols, parity_map=parity_map
    )


def random_codewords(dense_H: np.ndarray, count: int, rng: np.random.Generator) -> np.ndarray:
    gen = make_generator(dense_H)
    msgs = rng.integers(0, 2, size=(count, gen.k), dtype=np.uint8)
    return gen.encode(msgs)
