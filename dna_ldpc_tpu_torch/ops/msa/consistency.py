"""Batched consistency transform for the MPC pipeline.

Port of ``dna_ldpc_tpu/ops/msa/consistency.py::_consistency_core``. The
reference applies two consistency iterations per cluster
(``MUSCLE/src/consflat.cpp:5-23``, ``relaxflat.cpp:4-91``):

    P'_XY = (2 P_XY + sum_{Z != X,Y} P_XZ @ P_ZY) / n

restricted to P_XY's existing support (entries below 0.01 are zeroed).
Clusters of one size are stacked into a block tensor A[c, i, j, a, b]
(A[c,i,i] = 0, A[c,j,i] = A[c,i,j]^T), for which sum_z A[i,z] @ A[z,j]
equals the reference's sum over Z != X,Y because the diagonal blocks are
zero — so each iteration is one batched [n*L, n*L] matrix product, in
full float32 (TF32 off), matching the JAX package's HIGHEST precision.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .pairhmm import MIN_SPARSE_PROB


@contextlib.contextmanager
def _full_f32_matmul():
    """Run CUDA float32 matrix products without TF32 (restored after)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def consistency_core(pair_mats: torch.Tensor, inv_n: torch.Tensor, n: int, iters: int) -> torch.Tensor:
    """pair_mats: [C, n*(n-1)/2, L, L] float32 i<j pair posteriors of C
    clusters of n sequences (cluster_pairs order, zero padded); inv_n: [C]
    float32 1/n. Returns the transformed pairs in the same layout."""
    C, npair, L, _ = pair_mats.shape
    ii, jj = np.triu_indices(n, k=1)
    ii = torch.as_tensor(ii, device=pair_mats.device)
    jj = torch.as_tensor(jj, device=pair_mats.device)
    A = pair_mats.new_zeros((C, n, n, L, L))
    A[:, ii, jj] = pair_mats
    A[:, jj, ii] = pair_mats.transpose(-1, -2)
    scale = inv_n.to(pair_mats.dtype)[:, None, None, None, None]
    with _full_f32_matmul():
        for _ in range(iters):
            # rows (i, a), columns (z, b): S = A @ A sums over z and b
            Am = A.permute(0, 1, 3, 2, 4).reshape(C, n * L, n * L)
            S = torch.bmm(Am, Am).view(C, n, L, n, L).permute(0, 1, 3, 2, 4)
            A = torch.where(A < MIN_SPARSE_PROB, 0.0, (2.0 * A + S) * scale)
    return A[:, ii, jj]
