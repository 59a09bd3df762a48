"""Protograph (permutation-block) structure of an LDPC code.

Carried from ``dna_ldpc_tpu/models/blocked.py`` as numpy code. The one-hot
routing operators of the JAX package (``routing_tables``) are left out:
the port's decoders route with an indexed gather through ``pi``.

The deployed RS-LDPC matrix is, in its canonical construction column order,
a G x J grid of q x q permutation blocks (G=8 cosets, J=72 RS symbol
positions, q=256 field elements): every check row has exactly one edge in
each column group, and within block (g, j) the map check->variable is a
bijection. ``BlockedCode.detect`` recognizes the structure in natural
column order; ``dna_storage_blocked`` composes the canonical construction
with the deployed column permutation (the shipped pchk is a column shuffle
of the canonical H — ``models/rs_ldpc.py:deployed_column_permutation``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..utils.io_formats import SparseBinaryMatrix


@dataclasses.dataclass(frozen=True, eq=False)
class BlockedCode:
    """Permutation-block decomposition of a parity-check matrix.

    ``pi[g, j, r]`` = variable element v (within column group j) on the
    edge of check r (within check group g). Each ``pi[g, j]`` is a
    permutation of range(q).

    ``col_to_canonical`` maps *external* column index -> canonical blocked
    column index (identity when the matrix is natively blocked). LLRs are
    permuted into canonical order on entry and hard decisions permuted
    back on exit; both are exact (pure routing).
    """

    n_checks: int
    n_vars: int
    q: int
    G: int                       # check groups (= column weight dv)
    J: int                       # column groups (= row weight dc)
    pi: np.ndarray               # [G, J, q] int32
    col_to_canonical: np.ndarray  # [N] int32

    @classmethod
    def detect(
        cls, H: SparseBinaryMatrix, col_to_canonical: np.ndarray | None = None
    ) -> "BlockedCode | None":
        """Return the blocked decomposition of H, or None if H does not
        have permutation-block structure (in the given column order)."""
        M, N = H.n_rows, H.n_cols
        rw = H.row_weights()
        cw = H.col_weights()
        if M == 0 or N == 0 or rw.size == 0:
            return None
        dc, dv = int(rw.max()), int(cw.max())
        if not ((rw == dc).all() and (cw == dv).all()):
            return None  # irregular
        if dc <= 0 or dv <= 0 or M % dv or N % dc:
            return None
        q = M // dv
        if N // dc != q or q < 2:
            return None

        rows = np.repeat(np.arange(M), rw)
        cols = H.indices
        if col_to_canonical is not None:
            cols = col_to_canonical[cols]
        g, r = rows // q, rows % q
        j, v = cols // q, cols % q
        pi = np.full((dv, dc, q), -1, np.int32)
        pi[g, j, r] = v
        if (pi < 0).any():
            return None  # some (check, col-group) slot has no edge
        # duplicate (g, j, r) writes or non-bijective blocks leave some v
        # missing: each block must be a permutation
        srt = np.sort(pi, axis=-1)
        if not (srt == np.arange(q, dtype=np.int32)).all():
            return None
        return cls(
            n_checks=M,
            n_vars=N,
            q=q,
            G=dv,
            J=dc,
            pi=pi,
            col_to_canonical=(
                np.arange(N, dtype=np.int32)
                if col_to_canonical is None
                else np.asarray(col_to_canonical, np.int32)
            ),
        )

    def canonical_gather(self):
        """Index array: llr_canonical = llr_external[..., idx]."""
        idx = np.empty(self.n_vars, np.int64)
        idx[self.col_to_canonical] = np.arange(self.n_vars)
        return idx

    def external_gather(self):
        """Index array: bits_external = bits_canonical[..., idx]."""
        return self.col_to_canonical


@functools.lru_cache(maxsize=None)
def dna_storage_blocked() -> BlockedCode:
    """Blocked decomposition of the deployed n=18432 DNA-storage code, in
    the shipped pchk column order (external) routed through the canonical
    construction order (internal)."""
    from .rs_ldpc import deployed_column_permutation, dna_storage_pchk

    # shipped position s holds canonical column colperm[s]
    # (rs_ldpc.permute_columns), so external -> canonical IS colperm.
    colperm = deployed_column_permutation()
    code = BlockedCode.detect(dna_storage_pchk(), col_to_canonical=colperm)
    if code is None:
        raise RuntimeError("deployed code must be permutation-blocked")
    return code
