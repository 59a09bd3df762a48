"""Product-code construction and iterative (turbo-product) decoding.

Port of ``dna_ldpc_tpu/ops/product.py``: the component-matrix splitter
``make_check_H`` (``LDPC_dec/ldpc/rcode.cpp:89-144``) and the product-code
decoder family (``LDPC_dec/ldpc/dec.h:186-204``).

A product codeword is an [n2, n1] bit array whose every row is a codeword
of C1 (H1: m1 x n1) and every column a codeword of C2 (H2: m2 x n2). The
full parity-check matrix stacks the Kronecker forms

    H = [ I_{n2} (x) H1 ]      (row constraints)
        [ H2 (x) I_{n1} ]      (column constraints)

A half-iteration runs the component BP (``bp_posteriors``) on ALL rows of
all frames at once (the row axis folds into the batch axis), the next on
all columns, exchanging extrinsic information turbo style.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.ldpc_graph import LdpcGraph
from ..utils.device import DEFAULT_DEVICE, require_device
from ..utils.io_formats import SparseBinaryMatrix
from .bp import bp_posteriors


def product_pchk(H1: SparseBinaryMatrix, H2: SparseBinaryMatrix) -> SparseBinaryMatrix:
    """Full parity-check matrix of the product code C1 (rows) x C2
    (columns), variables indexed row-major as r * n1 + c."""
    n1, n2 = H1.n_cols, H2.n_cols
    m1, m2 = H1.n_rows, H2.n_rows
    rows1 = np.repeat(np.arange(m1), H1.row_weights())
    cols1 = H1.indices
    rows2 = np.repeat(np.arange(m2), H2.row_weights())
    cols2 = H2.indices

    # row constraints: for each product row r, H1 acts on vars r*n1 + *
    rr = (np.arange(n2)[:, None] * m1 + rows1[None, :]).reshape(-1)
    rc = (np.arange(n2)[:, None] * n1 + cols1[None, :]).reshape(-1)
    # column constraints: for each product column c, H2 acts on vars *n1+c
    cr = n2 * m1 + (np.arange(n1)[:, None] * m2 + rows2[None, :]).reshape(-1)
    cc = (cols2[None, :] * n1 + np.arange(n1)[:, None]).reshape(-1)

    return SparseBinaryMatrix.from_coo(
        n2 * m1 + n1 * m2,
        n1 * n2,
        np.concatenate([rr, cr]),
        np.concatenate([rc, cc]),
    )


def split_pchk(H: SparseBinaryMatrix, row_sizes) -> list[SparseBinaryMatrix]:
    """Split H into stacked row-range submatrices — the ``make_check_H``
    analog (rcode.cpp:89-144) used to hand each component decoder its own
    constraint block."""
    if sum(row_sizes) != H.n_rows:
        raise ValueError("row_sizes must partition the rows of H")
    dense = H.to_dense()
    out = []
    lo = 0
    for size in row_sizes:
        block = dense[lo : lo + size]
        out.append(SparseBinaryMatrix.from_coo(size, H.n_cols, *np.nonzero(block)))
        lo += size
    return out


def product_decode(
    graph1: LdpcGraph,
    graph2: LdpcGraph,
    llr: np.ndarray,
    outer_iters: int = 8,
    inner_iters: int = 10,
    damping: float = 0.5,
    device=DEFAULT_DEVICE,
):
    """Iterative soft decoding of a product code on ``device``.

    llr: [B, n2, n1] channel LLRs. Each outer iteration runs the row-code
    BP on all B*n2 rows as one batch, extracts extrinsics, then the
    column-code BP on all B*n1 columns; ``damping`` scales the exchanged
    extrinsic (standard turbo-product stabilization).

    Returns (bits [B, n2, n1] uint8, satisfied [B] bool) where satisfied
    checks both component syndromes of the final hard decisions.
    """
    dev = require_device(device)
    llr = np.asarray(llr, np.float32)
    if llr.ndim == 2:
        llr = llr[None]
    B, n2, n1 = llr.shape
    if graph1.n_vars != n1 or graph2.n_vars != n2:
        raise ValueError(f"llr [B, n2, n1] = {llr.shape} does not match the component codes")

    ch = torch.as_tensor(llr, device=dev)
    ext_col = torch.zeros_like(ch)  # extrinsic from column decoder

    for _ in range(outer_iters):
        row_in = ch + damping * ext_col
        post = bp_posteriors(graph1, row_in.reshape(B * n2, n1), inner_iters)
        ext_row = post.reshape(B, n2, n1) - row_in

        col_in = ch + damping * ext_row
        post = bp_posteriors(graph2, col_in.transpose(1, 2).reshape(B * n1, n2), inner_iters)
        ext_col = post.reshape(B, n1, n2).transpose(1, 2) - col_in

    total = ch + ext_row + ext_col
    bits = (~(total > 0)).to(torch.uint8).cpu().numpy()

    # verify both component syndromes on host
    ok = np.ones(B, bool)
    for b in range(B):
        w = bits[b]
        ok[b] = _syndrome_all(graph1, w) and _syndrome_all(graph2, w.T)
    return bits, ok


def _syndrome_all(graph: LdpcGraph, words: np.ndarray) -> bool:
    """True iff every row of ``words`` satisfies the graph's checks."""
    cv = np.maximum(graph.check_vars, 0)
    gathered = words[:, cv] * graph.check_mask[None]
    return bool(((gathered.sum(axis=-1) % 2) == 0).all())
