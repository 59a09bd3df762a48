"""MUSCLE-v5-equivalent multiple sequence alignment (MPC pipeline).

Port of the host pieces of ``dna_ldpc_tpu/ops/msa/align.py`` (EA
distances, UPGMA5 join order, ``align()`` on its native path) and of
``align_clusters`` in the configuration that runs the pair-HMM kernel and
the consistency transform on the device and the progressive and refine
stages in the host C++ aligner (the JAX package's ``_align_clusters_fused``
flow, ``DNA_LDPC_DEVICE_MSA=0``):

1. all C(n,2) read pairs of every cluster go through the pair-HMM kernel
   in batches sized from a byte budget; the posteriors stay on the device
   in bf16 (the value set the JAX package's sparse transport carries) and
   the EA scores come from the kernel;
2. EA distances (EA = MEA-score / min(LX, LY), FixEADistMx) give each
   cluster's UPGMA5 join order (biased linkage 0.1*avg + 0.9*min);
3. clusters of n >= 3 get the consistency transform on the device, in
   batches of equal-size clusters; each batch's transformed posteriors are
   downloaded and its clusters' progressive alignment + refinement run in
   native code on a thread pool while the device works on the next batch.

Output per cluster: [(input ordinal, aligned row)] in input order, the
aligner interface of ``pipeline.llr``.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ... import native_lib
from .consistency import consistency_core
from .pairhmm import batch_post_ea, encode_pairs, padded_lmax
from .pairhmm_cuda import post_ea

CONSISTENCY_ITERS = 2   # pairhmm.h:8
REFINE_ITERS = 100      # pairhmm.h:9
CONVERGE_AFTER = 5      # refinement stops after 5 unchanged iterations
BUDGET_BYTES = 2 << 30  # device bytes one pair-HMM or consistency batch may use
N_WORKERS = min(8, os.cpu_count() or 1)  # host aligner threads


def cluster_pairs(n: int) -> list[tuple[int, int]]:
    return [(i, j) for i in range(n) for j in range(i + 1, n)]


def mea_score(post: np.ndarray) -> float:
    """Score-only MEA sweep (CalcAlnScoreFlat) for EA distances."""
    return native_lib.mea_score_native(post)


def upgma_join_order(dist: np.ndarray) -> list[tuple[int, int]]:
    """UPGMA clustering with LINKAGE_Biased; returns the join list in
    creation order, node ids: leaves 0..n-1, internal n+k for join k —
    the exact structure ProgressiveAlign consumes (progalnflat.cpp)."""
    n = dist.shape[0]
    D = dist.astype(np.float64).copy()
    np.fill_diagonal(D, np.inf)
    active = list(range(n))
    node_of = {i: i for i in range(n)}
    joins = []
    next_node = n
    for _ in range(n - 1):
        # find global nearest pair among active rows
        sub = D[np.ix_(active, active)]
        k = int(np.argmin(sub))
        ai, aj = divmod(k, len(active))
        i, j = active[ai], active[aj]
        joins.append((node_of[i], node_of[j]))
        # merge j into i with biased linkage
        for m in active:
            if m in (i, j):
                continue
            dm = 0.1 * (D[i, m] + D[j, m]) / 2 + 0.9 * min(D[i, m], D[j, m])
            D[i, m] = D[m, i] = dm
        active.remove(j)
        node_of[i] = next_node
        next_node += 1
    return joins


def _ea_dists(seqs: list[str], ea: np.ndarray) -> np.ndarray:
    """[n, n] distances 1 - clip(EA / min(LX, LY), 0, 1) from the MEA
    scores of the cluster's pairs (FixEADistMx, upgma5.cpp:423-438)."""
    n = len(seqs)
    dist = np.zeros((n, n), dtype=np.float64)
    for p, (i, j) in enumerate(cluster_pairs(n)):
        e = float(ea[p]) / min(len(seqs[i]), len(seqs[j]))
        dist[i, j] = dist[j, i] = 1.0 - min(max(e, 0.0), 1.0)
    return dist


def _refine_masks(n: int, refine_iters: int, seed: int) -> np.ndarray:
    """Refinement bipartitions (rand()%2 -> seeded numpy draws), all-same
    rows removed; the same stream as the JAX package's align()."""
    if n < 3 or not refine_iters:
        return np.zeros((0, n), np.uint8)
    masks = np.random.default_rng(seed).integers(0, 2, (refine_iters, n)).astype(np.uint8)
    keep = ~((masks.all(axis=1)) | (~masks.any(axis=1)))
    return masks[keep]


def _consistency_host(posts: list[np.ndarray], n: int, iters: int) -> list[np.ndarray]:
    """One cluster's consistency transform on the CPU (align() without
    precomputed transformed posteriors)."""
    L = max(max(p.shape) for p in posts)
    stacked = np.zeros((1, len(posts), L, L), np.float32)
    for k, p in enumerate(posts):
        stacked[0, k, : p.shape[0], : p.shape[1]] = p
    inv_n = torch.tensor([1.0 / n], dtype=torch.float32)
    out = consistency_core(torch.from_numpy(stacked), inv_n, n, iters).numpy()
    return [out[0, k, : p.shape[0], : p.shape[1]] for k, p in enumerate(posts)]


def align(
    seqs: list[str],
    refine_iters: int = REFINE_ITERS,
    consistency_iters: int = CONSISTENCY_ITERS,
    seed: int = 0,
    pair_posts: list[np.ndarray] | None = None,
    pair_dists: np.ndarray | None = None,
) -> list[tuple[int, str]]:
    """Align one cluster; returns [(input ordinal, aligned row)] in input
    order. A single sequence passes through unchanged.

    Without ``pair_posts`` every stage runs on the CPU (the pair-HMM
    through its plain twin); the device path is ``align_clusters``.

    ``pair_posts``: precomputed match posteriors in cluster_pairs(n) order
    (computed here and rounded through bf16 otherwise).
    ``pair_dists``: the [n, n] EA distance matrix — required when
    ``pair_posts`` already had the consistency transform applied (EA
    distances come from the PRE-consistency posteriors, mpcflat.cpp
    CalcPosteriors -> m_DistMx)."""
    n = len(seqs)
    if n == 0:
        return []
    if n == 1:
        return [(0, seqs[0])]
    pairs = cluster_pairs(n)
    if pair_posts is None:
        post, _ea, lx, ly, _L = batch_post_ea([seqs[i] for i, _ in pairs], [seqs[j] for _, j in pairs])
        post = post.to(torch.bfloat16).to(torch.float32).numpy()
        pair_posts = [post[p, : lx[p], : ly[p]] for p in range(len(pairs))]
    if pair_dists is None:
        pair_dists = _ea_dists(seqs, np.array([mea_score(p) for p in pair_posts], np.float32))
    if n >= 3 and consistency_iters:
        pair_posts = _consistency_host(pair_posts, n, consistency_iters)
    joins = upgma_join_order(pair_dists)
    rows = native_lib.msa_progressive_refine_native(
        seqs, joins, pair_posts, _refine_masks(n, refine_iters, seed), CONVERGE_AFTER
    )
    return list(enumerate(rows))


def align_clusters(
    clusters: list[list[str]],
    refine_iters: int = REFINE_ITERS,
    consistency_iters: int = CONSISTENCY_ITERS,
    seed: int = 0,
    device="cpu",
    timings: dict | None = None,
) -> list[list[tuple[int, str]]]:
    """Align many clusters with the pair-HMM and consistency stages
    batched across clusters on ``device`` (module docstring). Results
    match per-cluster ``align()``. ``timings`` accumulates seconds under
    "pairhmm" (kernel + EA download), "consistency" (transform + posterior
    download) and "progressive_refine" (waiting for the host aligner after
    the last batch)."""
    if timings is None:
        timings = {}
    dev = torch.device(device)
    out: list = [None] * len(clusters)
    multi = []
    for c, seqs in enumerate(clusters):
        if len(seqs) < 2:
            out[c] = [(0, seqs[0])] if seqs else []
        else:
            multi.append(c)
    if not multi:
        return out

    # ---- 1. pair-HMM over every pair of every cluster -------------------
    t0 = time.time()
    span: dict[int, tuple[int, int]] = {}
    xs: list[str] = []
    ys: list[str] = []
    for c in multi:
        seqs = clusters[c]
        lo = len(xs)
        for i, j in cluster_pairs(len(seqs)):
            xs.append(seqs[i])
            ys.append(seqs[j])
        span[c] = (lo, len(xs))
    Lmax = padded_lmax(max(len(s) for s in xs + ys))
    X, Y, lx_all, ly_all = encode_pairs(xs, ys, Lmax)
    ntot = len(xs)
    posts = torch.empty((ntot, Lmax, Lmax), dtype=torch.bfloat16, device=dev)
    ea_all = np.zeros(ntot, np.float32)
    # kernel bytes per pair: forward M-plane scratch + f32 posterior + bf16 copy
    per_pair = (2 * Lmax + 1) * (Lmax + 1) * 4 + Lmax * Lmax * 6
    chunk = max(1, BUDGET_BYTES // per_pair)
    for lo in range(0, ntot, chunk):
        hi = min(ntot, lo + chunk)
        post, ea = post_ea(
            torch.as_tensor(X[lo:hi], device=dev), torch.as_tensor(Y[lo:hi], device=dev),
            torch.as_tensor(lx_all[lo:hi], device=dev), torch.as_tensor(ly_all[lo:hi], device=dev),
            Lmax,
        )
        posts[lo:hi] = post.to(torch.bfloat16)
        ea_all[lo:hi] = ea.cpu().numpy()
        del post, ea
    timings["pairhmm"] = timings.get("pairhmm", 0.0) + (time.time() - t0)

    # ---- 2-3. EA distances, consistency batches, host aligner -----------
    t0 = time.time()
    futures = {}

    def crops(c, mats):
        lo, _ = span[c]
        return [mats[k, : lx_all[lo + k], : ly_all[lo + k]] for k in range(len(mats))]

    def submit(pool, c, pair_posts):
        lo, hi = span[c]
        futures[c] = pool.submit(
            align, clusters[c], refine_iters, 0, seed, pair_posts,
            _ea_dists(clusters[c], ea_all[lo:hi]),
        )

    by_n: dict[int, list[int]] = {}
    with ThreadPoolExecutor(max_workers=N_WORKERS) as pool:
        for c in multi:
            n = len(clusters[c])
            if n >= 3 and consistency_iters:
                by_n.setdefault(n, []).append(c)
            else:  # no transform: the bf16 posteriors go to the aligner as they are
                lo, hi = span[c]
                submit(pool, c, crops(c, posts[lo:hi].to(torch.float32).cpu().numpy()))
        for n in sorted(by_n):
            members = by_n[n]
            npair = n * (n - 1) // 2
            # block tensor, its product and the updated copy, f32
            cap = max(1, BUDGET_BYTES // (4 * 4 * n * n * Lmax * Lmax))
            for blo in range(0, len(members), cap):
                batch = members[blo : blo + cap]
                idx = torch.as_tensor(
                    np.concatenate([np.arange(*span[c]) for c in batch]), device=dev
                )
                mats = posts[idx].to(torch.float32).view(len(batch), npair, Lmax, Lmax)
                inv_n = torch.full((len(batch),), 1.0 / n, dtype=torch.float32, device=dev)
                res = consistency_core(mats, inv_n, n, consistency_iters).cpu().numpy()
                for bi, c in enumerate(batch):
                    submit(pool, c, crops(c, res[bi]))
        timings["consistency"] = timings.get("consistency", 0.0) + (time.time() - t0)
        t0 = time.time()
        for c, fut in futures.items():
            out[c] = fut.result()
    timings["progressive_refine"] = timings.get("progressive_refine", 0.0) + (time.time() - t0)
    return out
