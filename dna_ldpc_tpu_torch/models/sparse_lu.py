"""Carried from ``dna_ldpc_tpu/models/sparse_lu.py`` as numpy code;
tests/test_torch_codes.py holds it equal to the original.

Sparse LU decomposition over GF(2) and the three encoding strategies.

Replaces the reference's generator-construction / encoding chain:
``mod2sparse_decomp`` (LU of an invertible column subset of H,
``LDPC_dec/ldpc/mod2sparse.h:162-165``), the ``make_gen.cpp`` standalone
tool (sparse / dense / mixed strategies, make_gen.cpp:39-373) and
``enc.cpp``'s ``sparse_encode`` / ``dense_encode`` / ``mixed_encode``
(enc.h:1-24).

Encoding solves A p = B s for the parity bits p, where A is the (rank x
rank) pivot-column submatrix of H and s the message on the remaining
columns:

- ``sparse``: forward-substitute the recorded elimination row-ops (L),
  then back-substitute the upper-triangular factor (U) — O(nnz(L)+nnz(U))
  per codeword, batch-vectorized on bit-packed words;
- ``dense``: one [rank, k] matmul with the precomputed parity map
  (models/mod2.make_generator);
- ``mixed``: dense right-hand side (B s as a packed matmul) + sparse
  triangular solves, the trade the reference's mixed mode makes.

Rank-deficient H (the deployed matrix has 2048 rows of rank 1860) is
handled by dropping dependent rows, exactly what the pipeline's effective
m=1860 reflects.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.io_formats import SparseBinaryMatrix
from .mod2 import make_generator, pack_rows, unpack_rows


@dataclasses.dataclass
class SparseLU:
    """GF(2) LU factorization of H's pivot-column submatrix.

    ``l_ops`` replays forward elimination on a right-hand side; ``u_rows``
    holds, per pivot r (in elimination order), the later pivots whose
    parity bits feed back into pivot r's equation.
    """

    n: int
    rank: int
    pivot_cols: np.ndarray       # [rank] columns carrying parity bits
    info_cols: np.ndarray        # [n - rank] columns carrying the message
    row_order: np.ndarray        # [rank] original row of pivot r
    l_ops: np.ndarray            # [n_ops, 3] (kind 0=swap / 1=xor, a, b)
    u_rows: list                 # rank entries: int64 arrays of later pivot ids
    B_packed: np.ndarray         # [n_info_words] packed H[:, info_cols] by row
    dependent_rows: np.ndarray


def lu_decompose(H: SparseBinaryMatrix) -> SparseLU:
    """Forward elimination with first-column pivoting (same pivot choice
    as mod2.eliminate, so all strategies agree on the information set)."""
    dense = H.to_dense()
    m, n = dense.shape
    P = pack_rows(dense)
    row_of = np.arange(m)
    l_ops = []
    pivot_cols = []
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
            l_ops.append((0, r, p))
        below = ((P[r + 1 :, word] >> np.uint64(bit)) & np.uint64(1)).astype(bool)
        for t in np.nonzero(below)[0]:
            P[r + 1 + t] ^= P[r]
            l_ops.append((1, r + 1 + t, r))
        pivot_cols.append(c)
        r += 1
    rank = r
    pivot_cols = np.array(pivot_cols, dtype=np.int64)
    info_cols = np.setdiff1d(np.arange(n), pivot_cols)

    # U restricted to pivot columns: for pivot row r, which later pivots
    # appear (U is unit-diagonal upper-triangular in elimination order)
    ref = unpack_rows(P[:rank], n)
    u_rows = []
    for i in range(rank):
        cols = np.nonzero(ref[i][pivot_cols])[0]
        u_rows.append(cols[cols > i].astype(np.int64))

    B = dense[:, info_cols]
    return SparseLU(
        n=n,
        rank=rank,
        pivot_cols=pivot_cols,
        info_cols=info_cols,
        row_order=row_of[:rank],
        l_ops=np.array(l_ops, dtype=np.int64).reshape(-1, 3),
        u_rows=u_rows,
        B_packed=pack_rows(B),
        dependent_rows=np.sort(row_of[rank:]),
    )


def _rhs(lu: SparseLU, messages: np.ndarray) -> np.ndarray:
    """b = B s for a batch of messages, as [batch, m-rows-of-H] bits."""
    msg_packed = pack_rows(messages)  # [batch, words]
    # b_i = parity(popcount(B_row_i & msg)) per batch element
    ands = lu.B_packed[None, :, :] & msg_packed[:, None, :]
    # popcount per uint64 via unpackbits-free trick
    cnt = np.zeros(ands.shape[:2], np.uint64)
    x = ands.copy()
    while x.any():
        cnt += (x & np.uint64(1)).sum(axis=2, dtype=np.uint64)
        x >>= np.uint64(1)
    return (cnt & np.uint64(1)).astype(np.uint8)


def sparse_encode(lu: SparseLU, messages: np.ndarray) -> np.ndarray:
    """Encode [batch, k] messages via the sparse triangular solves."""
    messages = np.atleast_2d(np.asarray(messages, np.uint8))
    b = _rhs(lu, messages)  # [batch, m] over ALL rows of H

    # forward substitution: replay the elimination's swaps and XORs in
    # order, starting from original row order (as the elimination did)
    y = b.copy()
    for kind, a, s in lu.l_ops:
        if kind == 0:
            y[:, [a, s]] = y[:, [s, a]]
        else:
            y[:, a] ^= y[:, s]
    if lu.rank < y.shape[1] and y[:, lu.rank :].any():
        raise ValueError("message not encodable: dependent checks inconsistent")

    # back substitution on U (unit diagonal)
    p = np.zeros((messages.shape[0], lu.rank), np.uint8)
    for i in range(lu.rank - 1, -1, -1):
        acc = y[:, i].copy()
        later = lu.u_rows[i]
        if len(later):
            acc ^= p[:, later].sum(axis=1).astype(np.uint8) & 1
        p[:, i] = acc & 1

    out = np.zeros((messages.shape[0], lu.n), np.uint8)
    out[:, lu.info_cols] = messages
    out[:, lu.pivot_cols] = p
    return out


def dense_encode(H: SparseBinaryMatrix, messages: np.ndarray) -> np.ndarray:
    """One-matmul systematic encode (the dense strategy)."""
    gen = make_generator(H.to_dense())
    return gen.encode(np.atleast_2d(np.asarray(messages, np.uint8)))


def _gf2_matmul_packed(X: np.ndarray, Yt_packed: np.ndarray) -> np.ndarray:
    """(X @ Y) mod 2 for uint8 X [batch, m] against packed rows of Y^T
    ([cols(Y), words]): parity of popcount(x & y_col) per output bit."""
    Xp = pack_rows(X)
    ands = Yt_packed[None, :, :] & Xp[:, None, :]
    cnt = np.zeros(ands.shape[:2], np.uint64)
    x = ands.copy()
    while x.any():
        cnt += (x & np.uint64(1)).sum(axis=2, dtype=np.uint64)
        x >>= np.uint64(1)
    return (cnt & np.uint64(1)).astype(np.uint8)


def _mixed_maps(lu: SparseLU) -> tuple[np.ndarray, np.ndarray]:
    """Dense Inv(A)-style maps for the mixed strategy, built once by
    running the recorded sparse solves on the identity RHS.

    Returns (solve_map_packed [rank, words(m)] — row r holds the GF(2)
    inner-product mask giving parity bit r from an RHS b over H's m rows —
    and residual_map_packed [m-rank, words(m)], the dependent-row
    consistency conditions; both are cached on the LU object)."""
    cached = getattr(lu, "_mixed_maps", None)
    if cached is not None:
        return cached
    m = lu.B_packed.shape[0]
    y = np.eye(m, dtype=np.uint8)  # row i = Op(e_i), built by replay
    for kind, a, s in lu.l_ops:
        if kind == 0:
            y[:, [a, s]] = y[:, [s, a]]
        else:
            y[:, a] ^= y[:, s]
    # back substitution on the unit-diagonal U, columns restricted to y
    p = np.zeros((m, lu.rank), np.uint8)
    for i in range(lu.rank - 1, -1, -1):
        acc = y[:, i].copy()
        later = lu.u_rows[i]
        if len(later):
            acc ^= p[:, later].sum(axis=1).astype(np.uint8) & 1
        p[:, i] = acc & 1
    solve_packed = pack_rows(p.T)                       # [rank, words(m)]
    residual_packed = pack_rows(y[:, lu.rank :].T)      # [m-rank, words(m)]
    maps = (solve_packed, residual_packed)
    object.__setattr__(lu, "_mixed_maps", maps)
    return maps


def mixed_encode(lu: SparseLU, messages: np.ndarray) -> np.ndarray:
    """The reference's mixed strategy (enc.cpp:118-160): sparse
    right-hand side x = B s, then one DENSE multiply by Inv(A) — here a
    packed GF(2) matmul against the precomputed inverse maps — instead of
    the sparse triangular solves. Bit-identical to sparse_encode."""
    messages = np.atleast_2d(np.asarray(messages, np.uint8))
    b = _rhs(lu, messages)  # [batch, m]
    solve_packed, residual_packed = _mixed_maps(lu)
    if residual_packed.shape[0] and _gf2_matmul_packed(b, residual_packed).any():
        raise ValueError("message not encodable: dependent checks inconsistent")
    p = _gf2_matmul_packed(b, solve_packed)  # [batch, rank]
    out = np.zeros((messages.shape[0], lu.n), np.uint8)
    out[:, lu.info_cols] = messages
    out[:, lu.pivot_cols] = p
    return out
