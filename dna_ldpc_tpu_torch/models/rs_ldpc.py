"""Carried from ``dna_ldpc_tpu/models/rs_ldpc.py`` as numpy code: the
JAX package cannot be imported without ``jax``. tests/test_torch_models.py
holds it equal to the original.

RS-based LDPC parity-check matrix construction (Djurdjevic et al.).

A from-scratch, vectorized re-derivation of the construction implemented
scalar-style in the reference encoder (``RS LDPC encode/RS_LDPC/
RS_LDPC.c:221-479``):

1. Over GF(q), q = 2^s, build the generator polynomial g(x) of an RS code
   of length rho with roots alpha^1..alpha^(rho-2) (degree rho-2).
2. Span the 2-dimensional RS subcode with generator rows g(x) and x*g(x);
   enumerate its q^2 codewords.
3. Find the first codeword of full weight rho; its q scalar multiples form
   the base coset Cb^(1).
4. Repeatedly pick the first codeword not in any previous coset and add it
   to the base coset to form cosets Cb^(2)..Cb^(gamma).
5. Each coset row becomes a binary check row: location map
   ``H[i][j*q + loc(Cb[i][j])] = 1`` where loc(0)=0 and loc(alpha^e)=e+1,
   giving an (M=gamma*q) x (N=rho*q) regular matrix with row weight rho and
   column weight gamma.

The deployed DNA-storage code uses s=8, rho=72, gamma=8 -> 2048 x 18432
(verified bit-identical to the shipped
``ex_decoder/decode_n18432_m2048_final.pchk`` by the test suite).

The blocked structure matters for the TPU decoder layout: every check row
has exactly one edge in each of the rho q-column blocks, and each variable
has exactly one edge in each of the gamma cosets — so check- and
variable-side edge tables are dense with zero padding, and sharding checks
by coset makes the BP variable-update a pure psum (see parallel/).
"""

from __future__ import annotations

import functools
import os

import numpy as np

from ..utils.gf import get_field
from ..utils.io_formats import SparseBinaryMatrix


def _gen_poly_exponents(field, rho: int) -> np.ndarray:
    """Generator polynomial coefficients (exponent form, low degree first)
    of the length-rho RS code with roots alpha^1..alpha^(rho-2).

    Mirrors make_gen_poly (RS_LDPC.c:188-199): start from (x + alpha^1) and
    multiply in (x + alpha^(i+1)) for i = 1..rho-3.
    """
    # Work in polynomial form: g = [alpha^1, 1]  (low -> high degree)
    g = np.array([field.exp_table[1], 1], dtype=np.int64)
    for i in range(1, rho - 2):
        root = field.exp_table[(1 + i) % (field.q - 1)]
        # g(x) * (x + root):  new[k] = g[k-1] + root*g[k]
        new = np.zeros(len(g) + 1, dtype=np.int64)
        new[1:] = g
        new[:-1] = field.add(new[:-1], field.mul(np.full(len(g), root), g))
        g = new
    return field.poly_to_exp(g)  # exponent form with -1 for zero


@functools.lru_cache(maxsize=None)
def build_rs_ldpc(s: int, rho: int, gamma: int) -> SparseBinaryMatrix:
    """Construct the binary RS-LDPC parity-check matrix H(s, rho, gamma)."""
    field = get_field(s)
    q = field.q

    gen_exp = _gen_poly_exponents(field, rho)  # degree rho-2, length rho-1
    gen_poly = field.exp_to_poly(gen_exp)
    # Two generator rows of the 2-D subcode: g(x) and x*g(x), length rho
    # (RS_LDPC.c "make two rows of the generator matrix").
    row1 = np.concatenate([gen_poly, [0]])  # g
    row2 = np.concatenate([[0], gen_poly])  # x*g

    # All q^2 codewords a*row1 + b*row2 with (a, b) running over the same
    # (-1..q-2)x(-1..q-2) exponent order as the reference (encode(),
    # RS_LDPC.c:202-217): index (i+1)*q + (j+1) with scalars alpha^i,
    # alpha^j and exponent -1 denoting zero.
    scal = np.concatenate([[0], field.exp_table[: q - 1]])  # exponent -1..q-2
    a = scal[:, None, None]  # [q,1,1]
    b = scal[None, :, None]  # [1,q,1]
    cw = field.add(field.mul(a, row1[None, None, :]), field.mul(b, row2[None, None, :]))
    cw = cw.reshape(q * q, rho)

    # First full-weight codeword -> base coset = its q scalar multiples.
    weights = np.count_nonzero(cw, axis=1)
    selected = int(np.argmax(weights == rho))
    base = field.mul(scal[:, None], cw[selected][None, :])  # [q, rho]

    # Coset membership bookkeeping via hashing rows.
    cw_keys = {}
    for idx, row in enumerate(cw):
        cw_keys.setdefault(row.tobytes(), idx)
    coset_of = np.full(q * q, -1, dtype=np.int64)

    def mark(rows):
        for row in rows:
            k = row.tobytes()
            if k in cw_keys:
                coset_of[cw_keys[k]] = 0  # value unused; only -1/-not-1 matters

    cosets = [base]
    mark(base)
    for _ in range(1, gamma):
        leader_idx = int(np.argmax(coset_of == -1))
        leader = cw[leader_idx]
        coset = field.add(base, leader[None, :])
        cosets.append(coset)
        mark(coset)

    Cb = np.concatenate(cosets, axis=0)  # [gamma*q, rho] polynomial form

    # Location map: column j*q + (0 if zero else log+1)  (RS_LDPC.c:420-428,
    # where the exponent-form offset is Cb+1).
    loc = np.where(Cb == 0, 0, field.log_table[np.maximum(Cb, 1)] + 1)
    cols = np.arange(rho)[None, :] * q + loc  # [M, rho]

    M, N = gamma * q, rho * q
    rows = np.repeat(np.arange(M), rho)
    return SparseBinaryMatrix.from_coo(M, N, rows, cols.reshape(-1))


def permute_columns(H: SparseBinaryMatrix, colperm: np.ndarray) -> SparseBinaryMatrix:
    """Return H with columns reordered: new column s = old column colperm[s]."""
    inv = np.empty_like(colperm)
    inv[colperm] = np.arange(len(colperm))
    rows = np.repeat(np.arange(H.n_rows), H.row_weights())
    return SparseBinaryMatrix.from_coo(H.n_rows, H.n_cols, rows, inv[H.indices])


@functools.lru_cache(maxsize=None)
def deployed_column_permutation() -> np.ndarray:
    """Column order of the deployed parity-check matrix relative to the
    canonical construction.

    The shipped ``ex_decoder/decode_n18432_m2048_final.pchk`` is exactly a
    column permutation of build_rs_ldpc(8, 72, 8) (verified: identical
    column-support multisets; all 18,432 column supports are UNIQUE, so
    this is THE permutation, not one of several matchings).

    Closed-form hypotheses tested and eliminated (r4):

    - NOT block-preserving: only ~70% of columns stay in their q=256
      coordinate block, so it cannot factor as (coordinate permutation)
      x (per-coordinate GF element relabeling) — which rules out every
      "different primitive element / exponent offset / coset enumeration
      order" explanation in one stroke;
    - not a lexicographic sort of column supports, not any
      reshape-transpose of the index space, not an involution;
    - deployed block 0 IS structured: it equals eight stacked 256x256
      identities (each column's check row is its own index in every
      coset; equivalently an exponent rotation by 190 of our canonical
      block 0), and 95.8% of adjacent deployed columns are ordered by
      their coset-0 row — i.e. the matrix is NEARLY sorted with
      localized disruptions.

    That signature — a convenient invertible block moved to the front,
    order mostly preserved elsewhere with pivot-like swaps — is what
    Neal's generator-construction tooling produces: ``make-gen``'s
    sparse-LU column pivoting reorders pchk columns so the leading M
    form the decomposable submatrix (LDPC_dec/ldpc/make_gen.cpp,
    mod2sparse_decomp), and the file's ``_final`` suffix marks that
    post-processed artifact. The exact order depends on the pivoting
    run (heuristic + tie-breaking state), so no independent closed form
    exists; the permutation ships as a data table derived once from the
    pchk. Column order is load-bearing: it defines the bit positions of
    the shipped codeword files.
    """
    path = os.path.join(os.path.dirname(__file__), "..", "data", "deployed_colperm.npz")
    return np.load(path)["colperm"]


def dna_storage_pchk() -> SparseBinaryMatrix:
    """The deployed n=18432, m=2048 DNA-storage parity-check matrix, in the
    exact column order of the shipped pchk/codeword artifacts."""
    return permute_columns(build_rs_ldpc(8, 72, 8), deployed_column_permutation())
