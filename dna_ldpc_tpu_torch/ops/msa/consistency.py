"""Batched consistency transform for the MPC pipeline.

Port of ``dna_ldpc_tpu/ops/msa/consistency.py``. The reference applies
two consistency iterations per cluster (``MUSCLE/src/consflat.cpp:5-23``,
``relaxflat.cpp:4-91``):

    P'_XY = (2 P_XY + sum_{Z != X,Y} P_XZ @ P_ZY) / n

restricted to P_XY's existing support (entries below 0.01 are zeroed).
Clusters of one size are stacked into a block tensor A[c, i, j, a, b]
(A[c,i,i] = 0, A[c,j,i] = A[c,i,j]^T), for which sum_z A[i,z] @ A[z,j]
equals the reference's sum over Z != X,Y because the diagonal blocks are
zero — so each iteration is one batched [n*L, n*L] matrix product, in
full float32 (TF32 off), matching the JAX package's HIGHEST precision.

``consistency_clusters`` is the public batched entry: numpy posteriors of
many clusters in, transformed numpy posteriors out, routed as the JAX
function routes them — sizes bucketed to ``N_BUCKETS`` (zero member
blocks are inert; the divide uses each cluster's true n), the block
product on ``device``, and sizes above the top bucket or bucket groups
too small to batch through the host loop ``_consistency_host``. Left out
as TPU workarounds: padding the cluster axis to a full chunk (one
compiled program per bucket; zero blocks give the same results) and the
sparse top-k transport (``top_k``, ``cluster_sparse``).
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils.device import DEFAULT_DEVICE, full_f32_matmul, require_device
from ...utils.profiling import device_time, wait
from .pairhmm import MIN_SPARSE_PROB

N_BUCKETS = (3, 4, 6, 8, 12, 16, 24, 32)


def consistency_core(pair_mats: torch.Tensor, inv_n: torch.Tensor, n: int, iters: int) -> torch.Tensor:
    """pair_mats: [C, n*(n-1)/2, L, L] float32 i<j pair posteriors of C
    clusters of n sequences (cluster_pairs order, zero padded); inv_n: [C]
    float32 1/n. Returns the transformed pairs in the same layout. On the
    card, the work between the index uploads and the return is event-timed
    into the innermost span while a profiler records."""
    C, npair, L, _ = pair_mats.shape
    dev = pair_mats.device
    ii, jj = np.triu_indices(n, k=1)
    ii = torch.as_tensor(ii, device=dev)
    jj = torch.as_tensor(jj, device=dev)
    wait(dev, 2)
    with device_time(dev):
        A = pair_mats.new_zeros((C, n, n, L, L))
        A[:, ii, jj] = pair_mats
        A[:, jj, ii] = pair_mats.transpose(-1, -2)
        scale = inv_n.to(pair_mats.dtype)[:, None, None, None, None]
        with full_f32_matmul():
            for _ in range(iters):
                # rows (i, a), columns (z, b): S = A @ A sums over z and b
                Am = A.permute(0, 1, 3, 2, 4).reshape(C, n * L, n * L)
                S = torch.bmm(Am, Am).view(C, n, L, n, L).permute(0, 1, 3, 2, 4)
                A = torch.where(A < MIN_SPARSE_PROB, 0.0, (2.0 * A + S) * scale)
        return A[:, ii, jj]


def transform_work(lengths, iters: int) -> tuple[int, int]:
    """The consistency transform's work on one cluster at its reads' true
    lengths ``lengths`` (padding not counted): (FLOPs, bytes). FLOPs:
    per iteration, for every pair i < j and every z not in {i, j}, the
    product P_iz @ P_zj, 2 L_i L_z L_j operations; summed, 6 e3(L) with
    e3 the third elementary symmetric polynomial of the lengths. Bytes:
    every pair posterior read once and written once at rest in bf16,
    4 e2(L)."""
    L = np.asarray(lengths, np.int64)
    p1, p2, p3 = int(L.sum()), int((L * L).sum()), int((L * L * L).sum())
    e3_6 = p1 ** 3 - 3 * p1 * p2 + 2 * p3  # 6 e3
    e2_2 = p1 * p1 - p2                    # 2 e2
    return iters * e3_6, 2 * e2_2


def _consistency_host(posts: list[np.ndarray], n: int, iters: int) -> list[np.ndarray]:
    """Host-numpy consistency for one cluster (align()'s reference loop);
    used for cluster sizes where batching on the device isn't worth it.
    A copy of the JAX package's loop."""
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    d = {(i, j): p for (i, j), p in zip(pairs, posts)}
    for _ in range(iters):
        new = {}
        for (i, j), Pij in d.items():
            acc = 2.0 * Pij
            for z in range(n):
                if z == i or z == j:
                    continue
                Piz = d[(i, z)] if i < z else d[(z, i)].T
                Pzj = d[(z, j)] if z < j else d[(j, z)].T
                acc = acc + Piz @ Pzj
            upd = acc / n
            upd[Pij < MIN_SPARSE_PROB] = 0.0
            new[(i, j)] = upd
        d = new
    return [d[p] for p in pairs]


def consistency_clusters(
    cluster_posts: list[list[np.ndarray]],
    iters: int = 2,
    chunk_elems: int = 1 << 26,
    min_device_clusters: int = 4,
    device=DEFAULT_DEVICE,
) -> list[list[np.ndarray]]:
    """Apply ``iters`` consistency iterations to every cluster's pair
    posteriors, the block products on ``device``.

    ``cluster_posts[c]`` holds cluster c's C(n_c, 2) posteriors in
    cluster_pairs order, with per-pair shapes [len_i, len_j]. Clusters
    with fewer than 3 sequences pass through unchanged (mpcflat.cpp:185).
    Each other cluster joins the first bucket of ``N_BUCKETS`` that holds
    it; sizes above the top bucket, and buckets of fewer than
    ``min_device_clusters`` clusters, go through ``_consistency_host``.
    ``chunk_elems`` bounds the element count of each stacked block.
    """
    dev = require_device(device)
    out: list[list[np.ndarray] | None] = [None] * len(cluster_posts)

    groups: dict[int, list[tuple[int, int]]] = {}  # bucket -> [(c, n_true)]
    host_jobs: list[tuple[int, int]] = []
    for c, posts in enumerate(cluster_posts):
        npair = len(posts)
        if npair < 3:  # n < 3: consistency skipped
            out[c] = posts
            continue
        n = int(round((1 + np.sqrt(1 + 8 * npair)) / 2))
        nb = next((b for b in N_BUCKETS if b >= n), None)
        if nb is None:
            host_jobs.append((c, n))
        else:
            groups.setdefault(nb, []).append((c, n))

    # one L for every group: the trial's reads are all ~136 nt, so 160
    L_all = max((max(p.shape) for posts in cluster_posts for p in posts), default=1)
    L = max(32, -(-L_all // 32) * 32)

    for nb, members in sorted(groups.items()):
        if len(members) < min_device_clusters:
            host_jobs.extend(members)
            continue
        npair_b = nb * (nb - 1) // 2
        ii_b, jj_b = np.triu_indices(nb, k=1)
        slot_of = {(int(a), int(b)): s for s, (a, b) in enumerate(zip(ii_b, jj_b))}
        chunk = max(1, chunk_elems // (npair_b * L * L))
        for lo in range(0, len(members), chunk):
            batch = members[lo : lo + chunk]
            stacked = np.zeros((len(batch), npair_b, L, L), np.float32)
            inv_n = np.empty(len(batch), np.float32)
            for bi, (c, n) in enumerate(batch):
                inv_n[bi] = 1.0 / n
                pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
                for (i, j), mat in zip(pairs, cluster_posts[c]):
                    stacked[bi, slot_of[(i, j)], : mat.shape[0], : mat.shape[1]] = mat
            trans = consistency_core(
                torch.from_numpy(stacked).to(dev), torch.from_numpy(inv_n).to(dev), nb, iters
            ).cpu().numpy()
            for bi, (c, n) in enumerate(batch):
                pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
                out[c] = [
                    trans[bi, slot_of[(i, j)], : mat.shape[0], : mat.shape[1]]
                    for (i, j), mat in zip(pairs, cluster_posts[c])
                ]

    for c, n in host_jobs:
        out[c] = _consistency_host(cluster_posts[c], n, iters)
    return out
