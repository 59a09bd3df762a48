"""Batched Levenshtein edit distance via antidiagonal dynamic programming.

Port of ``dna_ldpc_tpu/ops/editdist.py``: the numpy sweep
(``edit_distance_pairs``, carried unchanged, and its scalar wrapper
``edit_distance``) and the device sweep
(``edit_distance_pairs_device``), which runs the same integer recurrence
as plain torch ops on any device — every pair of a trial in one pass of
2L antidiagonal steps. Distances are integers, so both are bit-identical
to the scalar recurrence (substitution/insert/delete all cost 1) and to
the native C++ one.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import DEFAULT_DEVICE, require_device
from ..utils.dna import seqs_to_matrix


def edit_distance_pairs(
    seqs: np.ndarray, lengths: np.ndarray, pairs_a: np.ndarray, pairs_b: np.ndarray
) -> np.ndarray:
    """Edit distances for specified sequence pairs.

    seqs: [n, Lmax] uint8 padded byte matrix; lengths: [n]; pairs_a/b: [P]
    row indices. Returns [P] int32 distances between the unpadded strings.
    """
    if len(pairs_a) == 0:
        return np.zeros(0, dtype=np.int32)
    A = seqs[pairs_a]
    B = seqs[pairs_b]
    la = lengths[pairs_a].astype(np.int64)
    lb = lengths[pairs_b].astype(np.int64)
    P, L = A.shape
    if L == 0:
        return np.zeros(P, dtype=np.int32)

    # dp has (L+1) x (L+1) conceptual cells per pair; we keep two previous
    # antidiagonals. Cell (i, j) = distance between A[:i], B[:j].
    # Antidiagonal d holds cells with i + j = d, i in [max(0,d-L), min(d,L)].
    INF = np.int32(1 << 20)
    maxd = 2 * L
    # prev2 = diag d-2, prev1 = diag d-1, indexed by i (row coordinate)
    prev2 = np.full((P, L + 1), INF, dtype=np.int32)
    prev1 = np.full((P, L + 1), INF, dtype=np.int32)
    prev1[:, 0] = 1  # (0,1)
    prev1[:, 1] = 1  # (1,0)
    prev2[:, 0] = 0  # (0,0)
    dists = np.zeros(P, dtype=np.int32)
    # record boundary results when (i, j) == (la, lb), i.e. d == la + lb
    done_d = la + lb
    dists[done_d == 0] = 0
    dists[done_d == 1] = 1  # one string empty, the other length 1

    i_all = np.arange(L + 1)
    for d in range(2, maxd + 1):
        cur = np.full((P, L + 1), INF, dtype=np.int32)
        i_lo, i_hi = max(0, d - L), min(d, L)
        i = i_all[i_lo : i_hi + 1]
        j = d - i
        # deletion (i-1, j) lives on prev1 at i-1; insertion (i, j-1) on
        # prev1 at i; substitution/match (i-1, j-1) on prev2 at i-1.
        del_ = np.where(i[None, :] >= 1, prev1[:, np.maximum(i - 1, 0)], INF)
        ins_ = prev1[:, i]
        sub_ = np.where(i[None, :] >= 1, prev2[:, np.maximum(i - 1, 0)], INF)
        # character comparison for (i, j): A[i-1] vs B[j-1]; valid when
        # 1 <= i <= la and 1 <= j <= lb (outside, cells are unused)
        ai = np.take_along_axis(A, np.maximum(i - 1, 0)[None, :].repeat(P, 0), axis=1)
        bj = np.take_along_axis(B, np.maximum(j - 1, 0)[None, :].repeat(P, 0), axis=1)
        eq = ai == bj
        cost = np.minimum(np.minimum(del_, ins_), sub_) + 1
        cost = np.where(eq & (i[None, :] >= 1) & (j[None, :] >= 1), np.minimum(cost, sub_), cost)
        # boundary rows/cols of the DP table
        cur[:, i_lo : i_hi + 1] = cost
        if d <= L:
            cur[:, 0] = d   # (0, d)
            cur[:, d] = d   # (d, 0)
        hit = done_d == d
        if hit.any():
            dists[hit] = cur[hit, la[hit]]
        prev2, prev1 = prev1, cur
        if d >= done_d.max():
            break
    return dists


def edit_distance_pairs_device(
    seqs: np.ndarray, lengths: np.ndarray, pairs_a: np.ndarray, pairs_b: np.ndarray,
    device=DEFAULT_DEVICE,
) -> np.ndarray:
    """The same distances as ``edit_distance_pairs``, computed on
    ``device``: the read matrix and pair lists are uploaded once and every
    pair's DP advances together, one antidiagonal per step. Row i of a
    pair's slab is DP cell (i, d - i); the B operand is kept diagonal-
    aligned by one roll plus one inserted column per step."""
    dev = require_device(device)
    P = len(pairs_a)
    if P == 0:
        return np.zeros(0, dtype=np.int32)
    S = torch.as_tensor(np.ascontiguousarray(seqs, np.uint8), device=dev)
    lens = torch.as_tensor(np.asarray(lengths, np.int64), device=dev)
    pa = torch.as_tensor(np.asarray(pairs_a, np.int64), device=dev)
    pb = torch.as_tensor(np.asarray(pairs_b, np.int64), device=dev)
    A, B = S[pa], S[pb]
    la, lb = lens[pa], lens[pb]
    L = A.shape[1]
    if L == 0:
        return np.zeros(P, dtype=np.int32)
    INF = 1 << 20
    i32 = torch.int32
    lane = torch.arange(L + 1, device=dev)[None, :]
    ai = torch.cat([torch.zeros((P, 1), dtype=A.dtype, device=dev), A], 1)  # ai[p, i] = A[p, i-1]
    done_d = la + lb
    inf_col = torch.full((P, 1), INF, dtype=i32, device=dev)

    def shr(x):  # value at row i-1
        return torch.cat([inf_col, x[:, :-1]], 1)

    prev2 = torch.full((P, L + 1), INF, dtype=i32, device=dev)
    prev2[:, 0] = 0
    prev1 = torch.full((P, L + 1), INF, dtype=i32, device=dev)
    prev1[:, :2] = 1
    yd = torch.where(lane == 0, B[:, :1], torch.zeros_like(B[:, :1]))  # yd[p, i] = B[p, d-1-i]
    dist = torch.where(done_d <= 1, done_d, torch.zeros_like(done_d)).to(i32)
    last = int(done_d.max())
    for d in range(2, min(2 * L, last) + 1):
        yd = torch.where(lane == 0, B[:, min(d - 1, L - 1)][:, None], torch.roll(yd, 1, 1))
        j = d - lane
        sub_ = shr(prev2)
        cost = torch.minimum(torch.minimum(shr(prev1), prev1), sub_) + 1
        eq = (ai == yd) & (lane >= 1) & (j >= 1)
        cost = torch.where(eq, torch.minimum(cost, sub_), cost)
        if d <= L:
            cost = torch.where((lane == 0) | (lane == d), torch.full_like(cost, d), cost)
        cost = torch.where(j < 0, torch.full_like(cost, INF), cost)
        dist = torch.where(done_d == d, cost.gather(1, la[:, None])[:, 0], dist)
        prev2, prev1 = prev1, cost
    return dist.cpu().numpy().astype(np.int32)


def edit_distance(s1: str, s2: str) -> int:
    """Scalar convenience wrapper (test parity with def_func.edit_dist)."""
    mat = seqs_to_matrix([s1, s2], fill=b"\x00")
    lengths = np.array([len(s1), len(s2)])
    return int(edit_distance_pairs(mat, lengths, np.array([0]), np.array([1]))[0])
