"""Carried from ``dna_ldpc_tpu/utils/io_formats.py`` as numpy code;
tests/test_torch_cli.py and tests/test_torch_codes.py hold it equal to
the original.

Codecs for every on-disk artifact format used by the reference pipeline.

The reference moves all data between stages through text/binary files
(SURVEY.md §2.6). This module reads and writes those formats so the
port can consume the bundled datasets and emit byte-compatible
artifacts:

- binary ``.pchk`` parity-check matrices (magic 0x5080 + mod2sparse stream
  of little-endian 4-byte ints; ``LDPC_dec/ldpc/rcode.cpp:54-86``,
  ``mod2sparse.cpp:338-427``, ``intio.cpp:35-81``)
- ``alist`` text format as emitted by the RS-LDPC constructor
  (``RS LDPC encode/RS_LDPC/RS_LDPC.c:432-479``)
- one-line space-separated codeword / soft (LLR) files
  (``ex_decoder/def_func.py:29-57``)
- read / quality-score line files (``ex_decoder/decoder.py:48-57``)
- FASTA and FASTQ sequence files (``def_func.py:68-87``; MUSCLE MFA I/O)
"""

from __future__ import annotations

import io
import os

import numpy as np

PCHK_MAGIC = (ord("P") << 8) + 0x80  # 0x5080


# ---------------------------------------------------------------------------
# Sparse GF(2) matrix container
# ---------------------------------------------------------------------------


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
# intio: little-endian signed 4-byte integer stream (intio.cpp:35-81)
# ---------------------------------------------------------------------------


def _read_ints(f: io.BufferedReader, n: int) -> np.ndarray:
    data = f.read(4 * n)
    return np.frombuffer(data, dtype="<i4")


def _write_ints(f, values) -> None:
    np.asarray(values, dtype="<i4").tofile(f)


# ---------------------------------------------------------------------------
# pchk binary format
# ---------------------------------------------------------------------------


def read_pchk(path: str) -> SparseBinaryMatrix:
    """Read a Radford-Neal-style binary parity check file.

    Stream layout (mod2sparse_write, ``mod2sparse.cpp:338-376``): magic
    0x5080, n_rows, n_cols, then for each nonempty row ``-(row+1)`` followed
    by ``col+1`` per entry, terminated by a single 0.
    """
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        vals = _read_ints(f, size // 4)
    if len(vals) < 3 or vals[0] != PCHK_MAGIC:
        raise ValueError(f"{path}: not a parity check file (bad magic)")
    n_rows, n_cols = int(vals[1]), int(vals[2])
    body = vals[3:]
    end = np.nonzero(body == 0)[0]
    if len(end) == 0:
        raise ValueError(f"{path}: truncated pchk stream")
    body = body[: end[0]]
    neg = body < 0
    row_of = np.cumsum(neg)  # which row-marker each token falls under
    rows_seen = -body[neg] - 1
    cols = body[~neg] - 1
    row_ids = rows_seen[row_of[~neg] - 1]
    return SparseBinaryMatrix.from_coo(n_rows, n_cols, row_ids, cols)


def write_pchk(path: str, m: SparseBinaryMatrix) -> None:
    out = [np.array([PCHK_MAGIC, m.n_rows, m.n_cols], dtype=np.int64)]
    for i in range(m.n_rows):
        r = m.row(i)
        if len(r):
            out.append(np.concatenate(([-(i + 1)], r + 1)))
    out.append(np.array([0]))
    with open(path, "wb") as f:
        _write_ints(f, np.concatenate(out))


# ---------------------------------------------------------------------------
# alist text format (as emitted by RS_LDPC.c:432-479)
# ---------------------------------------------------------------------------


def read_alist(path: str) -> SparseBinaryMatrix:
    with open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)
    n_rows, n_cols = int(next(it)), int(next(it))
    next(it), next(it)  # max row weight, max col weight
    row_w = [int(next(it)) for _ in range(n_rows)]
    [int(next(it)) for _ in range(n_cols)]  # col weights
    rows = [[int(next(it)) - 1 for _ in range(w)] for w in row_w]
    return SparseBinaryMatrix.from_rows(n_rows, n_cols, rows)


def write_alist(path: str, m: SparseBinaryMatrix) -> None:
    """Write alist with the same field order as the reference constructor:
    dims, (max) row/col weight, per-row weights, per-col weights, 1-based
    row entries, 1-based column entries."""
    row_w = m.row_weights()
    col_w = m.col_weights()
    mt = m.transpose()
    with open(path, "w") as f:
        f.write(f"{m.n_rows} {m.n_cols}\n")
        f.write(f"{int(row_w.max(initial=0))} {int(col_w.max(initial=0))}\n")
        f.write(" ".join(map(str, row_w)) + " \n")
        f.write(" ".join(map(str, col_w)) + " \n")
        for i in range(m.n_rows):
            f.write(" ".join(str(c + 1) for c in m.row(i)) + " \n")
        for j in range(m.n_cols):
            f.write(" ".join(str(r + 1) for r in mt.row(j)) + " \n")


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


# ---------------------------------------------------------------------------
# FASTA / FASTQ
# ---------------------------------------------------------------------------


def read_fasta(path: str) -> list[tuple[str, str]]:
    records: list[tuple[str, str]] = []
    label, chunks = None, []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if label is not None:
                    records.append((label, "".join(chunks)))
                label, chunks = line[1:], []
            elif line:
                chunks.append(line)
    if label is not None:
        records.append((label, "".join(chunks)))
    return records


def write_fasta(path: str, records, wrap: int | None = None) -> None:
    """Write FASTA; ``wrap=80`` reproduces MUSCLE's 80-column wrapping
    (MUSCLE/src/myutils.cpp:2712-2740)."""
    with open(path, "w") as f:
        for label, seq in records:
            f.write(f">{label}\n")
            if wrap:
                for i in range(0, len(seq), wrap):
                    f.write(seq[i : i + wrap] + "\n")
            else:
                f.write(seq + "\n")


def read_fastq(path: str):
    """4-line-record FASTQ parser; returns (headers, seqs, quals) like the
    reference ``Fastq`` class (def_func.py:68-87)."""
    headers, seqs, quals = [], [], []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.rstrip("\n")
            m = i % 4
            if m == 0:
                headers.append(line)
            elif m == 1:
                seqs.append(line)
            elif m == 3:
                quals.append(line)
    return headers, seqs, quals


# ---------------------------------------------------------------------------
# MATLAB .mat interop (rs_dec.exe artifacts)
# ---------------------------------------------------------------------------


def write_index_mats(out_dir: str, dec_binary_index: np.ndarray, cnumerr: np.ndarray) -> None:
    """Write ``dec_binary_index.mat`` / ``cnumerr.mat`` exactly as
    rs_dec.exe does (``rs_dec_init.m:52-53``): variable names match, so
    the reference's ``scipy.io.loadmat`` consumer (``decoder.py:76-80``)
    can read our files interchangeably."""
    from scipy.io import savemat

    savemat(
        os.path.join(out_dir, "dec_binary_index.mat"),
        {"dec_binary_index": np.asarray(dec_binary_index, np.float64)},
    )
    savemat(
        os.path.join(out_dir, "cnumerr.mat"),
        {"cnumerr": np.asarray(cnumerr, np.float64).reshape(-1, 1)},
    )


def read_index_mats(out_dir: str):
    """Read rs_dec.exe's output pair; returns (dec_binary_index [N, 16]
    uint8, cnumerr [N] int32) with MATLAB's -1 failure sentinel kept."""
    from scipy.io import loadmat

    m1 = loadmat(os.path.join(out_dir, "dec_binary_index.mat"))
    m2 = loadmat(os.path.join(out_dir, "cnumerr.mat"))
    dec = np.asarray(m1["dec_binary_index"]).astype(np.uint8)
    cn = np.asarray(m2["cnumerr"]).reshape(-1).astype(np.int32)
    return dec, cn


def write_index_txt(path: str, index_bits: np.ndarray) -> None:
    """``index.txt`` as decoder.py:63-64 writes it: the 32 index bits of
    each read, whitespace-separated (rs_dec_init.m fscanf('%d'))."""
    bits = np.asarray(index_bits).reshape(-1, 32)
    with open(path, "w") as f:
        for row in bits:
            f.write(" ".join(str(int(b)) for b in row) + "\n")


def read_index_txt(path: str) -> np.ndarray:
    vals = np.loadtxt(path, dtype=np.int64).reshape(-1, 32)
    return vals.astype(np.uint8)
