"""MUSCLE-v5-equivalent multiple sequence alignment (MPC pipeline).

Port of ``dna_ldpc_tpu/ops/msa/align.py``: the host pieces (EA
distances, UPGMA5 join order, ``align()`` on its native path) and
``align_clusters`` in its two device configurations:

- the default, ``_align_clusters_device``: the pair-HMM kernel, the
  consistency transform, and the progressive joins and refinement
  (``device_msa.py``, with the MEA-DP kernel) all on the device; only the
  column maps leave it;
- ``DNA_LDPC_DEVICE_MSA=0``, ``_align_clusters_fused``: the pair-HMM
  kernel and the consistency transform on the device, the progressive and
  refine stages in the host C++ aligner. The device flow also hands it the
  clusters it does not take (more than 32 reads, column overflow).

Common to both: all C(n,2) read pairs go through the pair-HMM kernel in
batches sized from a byte budget, the posteriors stay on the device in
bf16 (the value set the JAX package's transport carries), and the EA
scores (EA = MEA-score / min(LX, LY), FixEADistMx) give each cluster's
UPGMA5 join order (biased linkage 0.1*avg + 0.9*min).

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
from ...utils.device import DEFAULT_DEVICE, require_device
from .consistency import consistency_core
from .pairhmm import batch_post_ea, encode_pairs, padded_lmax
from .pairhmm_cuda import kernel_layout, post_ea

CONSISTENCY_ITERS = 2   # pairhmm.h:8
REFINE_ITERS = 100      # pairhmm.h:9
CONVERGE_AFTER = 5      # refinement stops after 5 unchanged iterations
BUDGET_BYTES = 2 << 30  # device bytes one pair-HMM, consistency or MSA batch may use
N_WORKERS = min(8, os.cpu_count() or 1)  # host aligner threads

# clusters of >= 2 reads align_clusters was given, and of those the clusters
# the device MSA handed to the host aligner (oversized or column overflow),
# since the last reset
msa_clusters = 0
fallback_clusters = 0


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
        post, _ea, lx, ly, _L = batch_post_ea([seqs[i] for i, _ in pairs], [seqs[j] for _, j in pairs],
                                                device="cpu")
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
    device=DEFAULT_DEVICE,
    timings: dict | None = None,
) -> list[list[tuple[int, str]]]:
    """Align many clusters with the device stages batched across clusters
    on ``device``. Results match per-cluster ``align()``.

    The default is the fully device-resident MSA
    (``_align_clusters_device``); ``DNA_LDPC_DEVICE_MSA=0`` selects the
    flow that feeds the host C++ aligner (``_align_clusters_fused``), as
    in the JAX package (``dna_ldpc_tpu/ops/msa/align.py:554-566``).
    ``timings`` accumulates seconds per stage."""
    global msa_clusters
    require_device(device)
    if timings is None:
        timings = {}
    msa_clusters += sum(1 for seqs in clusters if len(seqs) >= 2)
    if os.environ.get("DNA_LDPC_DEVICE_MSA", "1") != "0":
        return _align_clusters_device(clusters, refine_iters, consistency_iters, seed, device, timings)
    return _align_clusters_fused(clusters, refine_iters, consistency_iters, seed, device, timings)


def _tick(timings: dict, key: str, t0: float) -> float:
    now = time.time()
    timings[key] = timings.get(key, 0.0) + (now - t0)
    return now


def _sync(dev: torch.device) -> None:
    """Wait for the card, so that a stage's time is its own."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _pair_posteriors(xs: list[str], ys: list[str], Lmax: int, dev: torch.device):
    """K2 over read pairs in batches sized from the byte budget. Returns
    (posteriors [P, Lmax, Lmax] bf16 on ``dev`` — the value set the JAX
    package's transport carries — and the EA scores [P] f32 numpy)."""
    X, Y, lx, ly = encode_pairs(xs, ys, Lmax)
    ntot = len(xs)
    posts = torch.empty((ntot, Lmax, Lmax), dtype=torch.bfloat16, device=dev)
    ea_all = np.zeros(ntot, np.float32)
    # kernel bytes per pair: forward-M scratch + f32 posterior + bf16 copy
    per_pair = kernel_layout(Lmax)["fm_stride"] * 4 + Lmax * Lmax * 6
    chunk = max(1, BUDGET_BYTES // per_pair)
    for lo in range(0, ntot, chunk):
        hi = min(ntot, lo + chunk)
        post, ea = post_ea(
            torch.as_tensor(X[lo:hi], device=dev), torch.as_tensor(Y[lo:hi], device=dev),
            torch.as_tensor(lx[lo:hi], device=dev), torch.as_tensor(ly[lo:hi], device=dev),
            Lmax,
        )
        posts[lo:hi] = post.to(torch.bfloat16)
        ea_all[lo:hi] = ea.cpu().numpy()
        del post, ea
    return posts, ea_all


def _align_clusters_device(
    clusters: list[list[str]],
    refine_iters: int,
    consistency_iters: int,
    seed: int,
    device,
    timings: dict,
) -> list[list[tuple[int, str]]]:
    """Fully device-resident align_clusters (``dna_ldpc_tpu/ops/msa/
    align.py:705-972``): the posteriors stay on the device from the
    pair-HMM to the last refinement merge; only the column maps leave it.

    1. clusters of 2..32 reads are grouped into the device-MSA buckets
       (``device_msa.MSA_BUCKETS``), and K2 runs over every pair of them
       (buckets ascending, clusters contiguous), posteriors kept in bf16;
    2. EA distances give each cluster's UPGMA join order;
    3. per batch of a bucket (its size from the byte budget),
       ``assemble_transform`` gathers the pairs and applies the
       consistency transform, and ``start_msa_batch`` runs every
       progressive join and refinement iteration as batched merges.

    Clusters larger than the top bucket, or whose alignment overflows the
    device column budget, go through ``_align_clusters_fused`` (K2 and the
    consistency transform on the device, the host C++ aligner).
    ``timings`` keys: "pairhmm", "consistency" (assembly + transform),
    "msa_device" (joins + merges), "msa_collect" (column-map download and
    rows), plus the fallback flow's keys when it runs."""
    global fallback_clusters
    from .device_msa import MSA_BUCKETS, assemble_transform, cluster_bytes, start_msa_batch

    dev = torch.device(device)
    out: list = [None] * len(clusters)
    fallback: list[int] = []
    by_bucket: dict[int, list[int]] = {}
    maxlen = 1
    for c, seqs in enumerate(clusters):
        n = len(seqs)
        if n < 2:
            out[c] = [(0, seqs[0])] if seqs else []
        elif n > MSA_BUCKETS[-1]:
            fallback.append(c)
        else:
            by_bucket.setdefault(next(b for b in MSA_BUCKETS if b >= n), []).append(c)
            # only reads that reach the device set the padding
            maxlen = max(maxlen, max(len(s) for s in seqs))
    Lmax = padded_lmax(maxlen)
    if Lmax > 254:  # the JAX package's column-map bound (uint8 transport)
        return _align_clusters_fused(clusters, refine_iters, consistency_iters, seed, device, timings)

    t0 = time.time()
    span: dict[int, tuple[int, int]] = {}
    xs: list[str] = []
    ys: list[str] = []
    for nb in sorted(by_bucket):
        for c in by_bucket[nb]:
            seqs = clusters[c]
            lo = len(xs)
            for i, j in cluster_pairs(len(seqs)):
                xs.append(seqs[i])
                ys.append(seqs[j])
            span[c] = (lo, len(xs))
    if xs:
        posts, ea_all = _pair_posteriors(xs, ys, Lmax, dev)
    _tick(timings, "pairhmm", t0)

    for nb in sorted(by_bucket):
        members = by_bucket[nb]
        npair = nb * (nb - 1) // 2
        slot_of = {pair: sl for sl, pair in enumerate(cluster_pairs(nb))}
        C_cap = max(1, BUDGET_BYTES // cluster_bytes(nb, Lmax))
        for mlo in range(0, len(members), C_cap):
            batch = members[mlo : mlo + C_cap]
            t0 = time.time()
            ids = np.zeros(len(batch) * npair, np.int64)
            mask = np.zeros(len(batch) * npair, bool)
            inv_n = np.ones(len(batch), np.float32)
            for bi, c in enumerate(batch):
                n = len(clusters[c])
                inv_n[bi] = 1.0 / n
                for pi, pair in enumerate(cluster_pairs(n)):
                    sl = bi * npair + slot_of[pair]
                    ids[sl] = span[c][0] + pi
                    mask[sl] = True
            P = assemble_transform(
                posts, torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev),
                torch.as_tensor(inv_n, device=dev), nb, consistency_iters, len(batch), Lmax,
            )
            _sync(dev)
            t0 = _tick(timings, "consistency", t0)

            joins_list = [
                upgma_join_order(_ea_dists(clusters[c], ea_all[span[c][0] : span[c][1]])) for c in batch
            ]
            job = start_msa_batch(
                P, [clusters[c] for c in batch], joins_list, nb, Lmax, refine_iters, seed
            )
            del P
            _sync(dev)
            t0 = _tick(timings, "msa_device", t0)

            rows_out, _ovf = job.collect()
            for c, rows in zip(batch, rows_out):
                if rows is None:
                    fallback.append(c)
                else:
                    out[c] = rows
            _tick(timings, "msa_collect", t0)
    posts = None  # free the pair posteriors before the fallback computes its own

    if fallback:
        fallback_clusters += len(fallback)
        rows = _align_clusters_fused(
            [clusters[c] for c in fallback], refine_iters, consistency_iters, seed, device, timings
        )
        for c, r in zip(fallback, rows):
            out[c] = r
    return out


def _align_clusters_fused(
    clusters: list[list[str]],
    refine_iters: int,
    consistency_iters: int,
    seed: int,
    device,
    timings: dict,
) -> list[list[tuple[int, str]]]:
    """The ``DNA_LDPC_DEVICE_MSA=0`` flow, counterpart of the JAX
    package's ``_align_clusters_fused``: K2 over every pair and the
    consistency transform on ``device`` (module docstring), the
    progressive and refine stages in the host C++ aligner. ``timings``
    keys: "pairhmm" (kernel + EA download), "consistency" (transform +
    posterior download) and "progressive_refine" (waiting for the host
    aligner after the last batch)."""
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
    posts, ea_all = _pair_posteriors(xs, ys, Lmax, dev)
    t0 = _tick(timings, "pairhmm", t0)

    # ---- 2-3. EA distances, consistency batches, host aligner -----------
    futures = {}

    def crops(c, mats):
        lo, _ = span[c]
        return [
            mats[k, : len(xs[lo + k]), : len(ys[lo + k])] for k in range(len(mats))
        ]

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
        t0 = _tick(timings, "consistency", t0)
        for c, fut in futures.items():
            out[c] = fut.result()
    _tick(timings, "progressive_refine", t0)
    return out
