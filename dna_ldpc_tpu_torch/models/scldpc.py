"""Spatially-coupled (SC) LDPC chain construction.

Carried from ``dna_ldpc_tpu/models/scldpc.py`` as numpy code (the JAX
package cannot be imported without ``jax``); tests/test_torch_scldpc.py
holds ``couple`` equal to the original.

The reference ships a family of sliding-window and pipeline decoders for
SC-LDPC chains (``LDPC_dec/ldpc/dec.cpp`` Run_SW_Decoder / BEC_SW /
Pipeline families, declarations ``dec.h:48-74,158-181``) but no chain
constructor — chains arrive as pre-built pchk files. Here the chain is
built from a base block by the standard edge-spreading construction so
the windowed decoders (ops/scldpc.py) can be exercised end to end:

Given a base parity-check matrix ``H0`` (b_c x b_v) and memory ``w``, the
coupled chain of ``L`` spatial positions splits H0 into ``w + 1`` random
(seeded) summands ``H0 = sum_k H_k`` and tiles them diagonally:

    row block t (t = 0..L+w-1) sees variable blocks t-w..t through
    H_w..H_0 — a band-diagonal matrix of L*b_v variables and
    (L+w)*b_c checks, with termination (the first/last w row blocks are
    partially filled, giving the chain its decoding wave).

The band structure is exactly what the sliding-window decoders exploit:
a window of W spatial positions touches only checks in the same band.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.io_formats import SparseBinaryMatrix


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: the window graphs' cache key
class ScChain:
    """An SC-LDPC chain with its spatial layout metadata."""

    H: SparseBinaryMatrix
    L: int            # spatial positions (variable blocks)
    w: int            # coupling memory
    b_v: int          # variables per position
    b_c: int          # checks per row block

    @property
    def n_vars(self) -> int:
        return self.L * self.b_v

    @property
    def n_checks(self) -> int:
        return (self.L + self.w) * self.b_c

    def var_block(self, t: int) -> slice:
        return slice(t * self.b_v, (t + 1) * self.b_v)

    def check_block(self, t: int) -> slice:
        return slice(t * self.b_c, (t + 1) * self.b_c)

    def window_slices(self, t0: int, W: int) -> tuple[slice, slice]:
        """Variable and check index ranges of a window anchored at spatial
        position t0 covering W positions: variables t0..t0+W-1 and every
        check they touch (row blocks t0..t0+W-1+w, clipped)."""
        v_lo, v_hi = t0 * self.b_v, min(t0 + W, self.L) * self.b_v
        c_lo = t0 * self.b_c
        c_hi = min(t0 + W + self.w, self.L + self.w) * self.b_c
        return slice(v_lo, v_hi), slice(c_lo, c_hi)


def couple(
    H0: SparseBinaryMatrix, L: int, w: int = 1, seed: int = 0
) -> ScChain:
    """Edge-spread H0 into an L-position chain with memory w.

    Every edge of H0 is assigned a delay k in 0..w uniformly (seeded);
    summand H_k collects the edges with delay k. Variable block t couples
    into row blocks t..t+w.
    """
    if L < 1 or w < 0:
        raise ValueError("need L >= 1 and w >= 0")
    b_c, b_v = H0.n_rows, H0.n_cols
    rng = np.random.default_rng(seed)
    rows0 = np.repeat(np.arange(b_c), H0.row_weights())
    cols0 = H0.indices
    delay = rng.integers(0, w + 1, size=len(cols0))

    rows = []
    cols = []
    for t in range(L):
        rows.append((t + delay) * b_c + rows0)
        cols.append(t * b_v + cols0)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    H = SparseBinaryMatrix.from_coo((L + w) * b_c, L * b_v, rows, cols)
    return ScChain(H=H, L=L, w=w, b_v=b_v, b_c=b_c)


def chain_from_reference(ref) -> ScChain:
    """Build the port's chain from another chain object's numpy fields
    (``H.indptr`` / ``H.indices`` / ``H.n_rows`` / ``H.n_cols``, ``L``,
    ``w``, ``b_v``, ``b_c``), so that a test can run both packages'
    windowed decoders on one chain."""
    H = SparseBinaryMatrix(int(ref.H.n_rows), int(ref.H.n_cols), np.asarray(ref.H.indptr), np.asarray(ref.H.indices))
    return ScChain(H=H, L=int(ref.L), w=int(ref.w), b_v=int(ref.b_v), b_c=int(ref.b_c))
