"""Carried from ``dna_ldpc_tpu/utils/io_formats.py`` as numpy code: the
sparse GF(2) matrix container the code construction needs, and the
one-line numeric and line-per-read text files the CLI reads and writes.
The other codecs (pchk, alist, FASTA/FASTQ, .mat) are not on the port's
path yet.
"""

from __future__ import annotations

import numpy as np


class SparseBinaryMatrix:
    """Row-major sparse GF(2) matrix: per-row sorted column index lists.

    Plays the role of the reference's linked-list ``mod2sparse`` store
    (``LDPC_dec/ldpc/mod2sparse.h:42-118``) but as flat numpy arrays:
    ``indptr``/``indices`` CSR pair, columns sorted within each row (the
    reference inserts in sorted order too).
    """

    def __init__(self, n_rows: int, n_cols: int, indptr: np.ndarray, indices: np.ndarray):
        self.n_rows = int(n_rows)
        self.n_cols = int(n_cols)
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int64)

    @classmethod
    def from_rows(cls, n_rows, n_cols, rows):
        indptr = np.zeros(n_rows + 1, dtype=np.int64)
        chunks = []
        for i, r in enumerate(rows):
            r = np.sort(np.asarray(r, dtype=np.int64))
            chunks.append(r)
            indptr[i + 1] = indptr[i] + len(r)
        indices = np.concatenate(chunks) if chunks else np.zeros(0, np.int64)
        return cls(n_rows, n_cols, indptr, indices)

    @classmethod
    def from_coo(cls, n_rows, n_cols, rows, cols):
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        order = np.lexsort((cols, rows))
        rows, cols = rows[order], cols[order]
        indptr = np.zeros(n_rows + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr)
        return cls(n_rows, n_cols, indptr, cols)

    @property
    def nnz(self) -> int:
        return len(self.indices)

    def row(self, i: int) -> np.ndarray:
        return self.indices[self.indptr[i] : self.indptr[i + 1]]

    def row_weights(self) -> np.ndarray:
        return np.diff(self.indptr)

    def col_weights(self) -> np.ndarray:
        return np.bincount(self.indices, minlength=self.n_cols)

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n_rows, self.n_cols), dtype=np.uint8)
        r = np.repeat(np.arange(self.n_rows), self.row_weights())
        out[r, self.indices] = 1
        return out

    def transpose(self) -> "SparseBinaryMatrix":
        r = np.repeat(np.arange(self.n_rows), self.row_weights())
        return SparseBinaryMatrix.from_coo(self.n_cols, self.n_rows, self.indices, r)

    def mulvec(self, x: np.ndarray) -> np.ndarray:
        """H @ x over GF(2); x is [..., n_cols] of 0/1."""
        x = np.asarray(x)
        seg = np.add.reduceat(
            x[..., self.indices], self.indptr[:-1], axis=-1
        ) if self.nnz else np.zeros(x.shape[:-1] + (self.n_rows,), np.int64)
        # reduceat with empty rows misbehaves; handle the regular case fast
        # and fall back below when empty rows exist.
        if np.any(np.diff(self.indptr) == 0):
            gathered = x[..., self.indices]
            out = np.zeros(x.shape[:-1] + (self.n_rows,), dtype=np.int64)
            rows = np.repeat(np.arange(self.n_rows), self.row_weights())
            np.add.at(out.reshape(-1, self.n_rows).T, rows, gathered.reshape(-1, self.nnz).T)
            seg = out
        return (seg % 2).astype(np.uint8)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, SparseBinaryMatrix)
            and self.n_rows == other.n_rows
            and self.n_cols == other.n_cols
            and np.array_equal(self.indptr, other.indptr)
            and np.array_equal(self.indices, other.indices)
        )


# ---------------------------------------------------------------------------
# One-line numeric files (codeword / soft LLR) — def_func.py:29-57
# ---------------------------------------------------------------------------


def read_vector(path: str, dtype=np.int64) -> np.ndarray:
    """Read a single-line space-separated numeric file (codeword or soft
    file). Mirrors ``file_read`` int/float mode, which returns the first
    line only (def_func.py:40-43)."""
    with open(path) as f:
        line = f.readline()
    return np.array(line.split(), dtype=dtype)


def write_vector(path: str, values, fmt: str | None = None) -> None:
    """Write values as a single line of space-separated entries with a
    trailing space, byte-identical to ``write_codeword``
    (def_func.py:54-57) given matching string formatting."""
    values = np.asarray(values)
    if fmt is None:
        conv = (lambda v: repr(float(v))) if values.dtype.kind == "f" else str
    else:
        conv = lambda v: fmt % v
    with open(path, "w") as f:
        for v in values.tolist():
            f.write(conv(v) + " ")


def read_lines(path: str) -> list[str]:
    """str-mode file_read: all lines, newline-stripped (def_func.py:38-39)."""
    with open(path) as f:
        return [line.rstrip("\n") for line in f]


def write_lines(path: str, lines) -> None:
    with open(path, "w") as f:
        for line in lines:
            f.write(str(line) + "\n")
