"""K-mer read clustering and the clustered "super" alignment pipeline.

Port of ``dna_ldpc_tpu/ops/cluster.py``: numpy copies of ``kmer_profiles``,
``Clustering`` and the greedy clusterer, whose read-against-centroid
similarity product goes to ``device`` (``torch.matmul`` in f32, TF32 off)
above 2^18 products; ``super_align`` aligns each cluster with ``align()``
and joins the cluster MSAs on the host profile path, its pair-HMMs on
``device``.

Counterparts of MUSCLE's large-input machinery that the
reference vendors but does not reach from the decode path (SURVEY.md
§2.4 "not on decode path"): the k-mer scanners and greedy centroid
clusterers (``MUSCLE/src/{kmerscan.cpp,uclust.cpp,usorter.cpp}``) and
the clustered Super4/Super5 align pipeline (``MUSCLE/src/super4.cpp``,
``super5.cpp``: cluster the input, align each cluster, then join the
cluster MSAs profile-by-profile).

Design: sequences become L2-normalized k-mer count profiles
``[n, 4^k]``; all similarity scoring is cosine similarity via one
matmul per candidate block instead of uclust's per-pair word scans. Clustering is the same greedy centroid scheme as
uclust (first sufficiently-similar centroid wins, else the read founds
a new centroid, reads visited in length order) but processed in
batches: each round matmuls every unassigned read against all existing
centroids, and the misses elect new centroids in similarity-masked
blocks.

Beyond MUSCLE parity this gives the decoder an *index-free* clustering
path: reads whose RS index decode failed (dropped at
``decoder.py:86-92``) can still be pooled by payload similarity.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import DEFAULT_DEVICE, full_f32_matmul, require_device

_CODE = np.full(256, -1, np.int8)
for i, b in enumerate(b"ACGT"):
    _CODE[b] = i


def kmer_profiles(seqs: list[str], k: int = 5, normalize: bool = True) -> np.ndarray:
    """[n, 4^k] float32 k-mer count profiles. K-mers containing non-ACGT
    characters are skipped (uclust treats wildcards the same way)."""
    n = len(seqs)
    dim = 4**k
    out = np.zeros((n, dim), np.float32)
    weights = (4 ** np.arange(k - 1, -1, -1)).astype(np.int64)
    for i, s in enumerate(seqs):
        codes = _CODE[np.frombuffer(s.encode(), np.uint8)]
        if codes.size < k:
            continue
        windows = np.lib.stride_tricks.sliding_window_view(codes, k)
        ok = (windows >= 0).all(1)
        if not ok.any():
            continue
        ids = (windows[ok].astype(np.int64) * weights).sum(1)
        np.add.at(out[i], ids, 1.0)
    if normalize:
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        out /= np.maximum(norms, 1e-30)
    return out


def _matmul(a: np.ndarray, b: np.ndarray, device=DEFAULT_DEVICE) -> np.ndarray:
    """Similarity matmul a @ b.T: on ``device`` in f32 (TF32 off) above 2^18
    products when ``device`` is not the CPU, else numpy."""
    dev = require_device(device)
    if dev.type == "cpu" or a.shape[0] * b.shape[0] <= 1 << 18:
        return a @ b.T
    with full_f32_matmul():
        return torch.matmul(torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev).T).cpu().numpy()


@dataclasses.dataclass
class Clustering:
    assignment: np.ndarray   # [n] int64 cluster id per read
    centroids: np.ndarray    # [m] int64 read index that founded each cluster

    @property
    def n_clusters(self) -> int:
        return len(self.centroids)

    def members(self) -> list[np.ndarray]:
        order = np.argsort(self.assignment, kind="stable")
        splits = np.searchsorted(self.assignment[order], np.arange(1, self.n_clusters))
        return np.split(order, splits)


def kmer_cluster(
    seqs: list[str],
    k: int = 5,
    threshold: float = 0.75,
    block: int = 1024,
    device=DEFAULT_DEVICE,
) -> Clustering:
    """Greedy centroid clustering at cosine similarity ``threshold``.

    Matches uclust's invariants: reads are visited longest-first; a read
    joins the most similar existing centroid if that similarity reaches
    the threshold, otherwise it founds a new cluster whose profile is
    the read's own. Similarities against the centroids are computed on
    ``device``.
    """
    require_device(device)
    n = len(seqs)
    if n == 0:
        return Clustering(np.zeros(0, np.int64), np.zeros(0, np.int64))
    prof = kmer_profiles(seqs, k=k)
    order = np.argsort([-len(s) for s in seqs], kind="stable")

    assignment = np.full(n, -1, np.int64)
    centroid_reads: list[int] = []
    centroid_rows: list[np.ndarray] = []

    pos = 0
    while pos < n:
        cand = order[pos : pos + block]
        pos += len(cand)
        p = prof[cand]
        if centroid_rows:
            C = np.concatenate(centroid_rows, axis=0)
            sims = _matmul(p, C, device)  # [b, m]
            best = sims.argmax(1)
            hit = sims[np.arange(len(cand)), best] >= threshold
            assignment[cand[hit]] = best[hit]
        else:
            hit = np.zeros(len(cand), bool)
        misses = cand[~hit]
        if misses.size == 0:
            continue
        # elect new centroids among the misses: a miss joins an earlier
        # new centroid of this round if similar enough, else founds one
        pm = prof[misses]
        sim_mm = pm @ pm.T
        leader_of = np.full(misses.size, -1, np.int64)
        new_rows = []
        for i in range(misses.size):
            if leader_of[i] >= 0:
                continue
            cid = len(centroid_reads)
            centroid_reads.append(int(misses[i]))
            new_rows.append(prof[misses[i] : misses[i] + 1])
            assignment[misses[i]] = cid
            later = np.arange(i + 1, misses.size)
            close = later[(sim_mm[i, later] >= threshold) & (leader_of[later] < 0)]
            leader_of[close] = cid
            assignment[misses[close]] = cid
        leader_of[leader_of < 0] = 0  # founders already assigned
        centroid_rows.extend(new_rows)
    return Clustering(assignment, np.asarray(centroid_reads, np.int64))


def super_align(
    seqs: list[str],
    k: int = 5,
    threshold: float = 0.75,
    refine_iters: int = 0,
    seed: int = 0,
    device=DEFAULT_DEVICE,
) -> list[tuple[int, str]]:
    """Clustered alignment of a large input set (the Super5 pipeline,
    ``MUSCLE/src/super5.cpp``): k-mer-cluster the sequences, align each
    cluster with the MPC aligner, then join the cluster MSAs by
    profile-profile alignment guided by the cluster *representatives*
    (the centroid reads), exactly Super5's structure (cluster -> align
    members -> pprog join of cluster MSAs). Every pair-HMM runs on
    ``device``. Returns (original sequence id, aligned row) pairs in input
    order."""
    from .msa.align import (
        GAP,
        _align_profiles,
        _insert_gaps,
        _profile_from_rows,
        align,
        cluster_pairs,
        mea_align,
        mea_score,
        upgma_join_order,
    )
    from .msa.pairhmm import batch_posteriors

    cl = kmer_cluster(seqs, k=k, threshold=threshold, device=device)
    groups = cl.members()
    m = len(groups)

    # per-cluster MSAs as profiles over GLOBAL sequence ids
    profiles = []
    for g in groups:
        sub = [seqs[i] for i in g]
        rows = align(sub, refine_iters=refine_iters, seed=seed, device=device) if len(sub) > 1 else [(0, sub[0])]
        byte_rows = [
            np.frombuffer(r.encode("latin1"), np.uint8).copy() for _, r in rows
        ]
        ids = [int(g[local]) for local, _ in rows]
        profiles.append(_profile_from_rows(byte_rows, ids))
    if m == 1:
        final = profiles[0]
    else:
        # representative posteriors + EA distances between clusters
        reps = [int(c) for c in cl.centroids]
        pairs = cluster_pairs(m)
        posts_list = batch_posteriors(
            [seqs[reps[i]] for i, _ in pairs], [seqs[reps[j]] for _, j in pairs], device=device
        )
        rep_posts = {}
        dist = np.zeros((m, m))
        for p, (i, j) in enumerate(pairs):
            rep_posts[(i, j)] = posts_list[p]
            ea = mea_score(posts_list[p]) / min(len(seqs[reps[i]]), len(seqs[reps[j]]))
            dist[i, j] = dist[j, i] = 1.0 - min(max(ea, 0.0), 1.0)

        # progressive join of cluster profiles along the UPGMA order,
        # scoring columns by the representatives' match posteriors
        def join(p1, rep1, p2, rep2, post_rep):
            r1 = p1.seq_ids.index(rep1)
            r2 = p2.seq_ids.index(rep2)
            c1, c2 = len(p1.rows[0]), len(p2.rows[0])
            post = np.zeros((c1, c2), np.float32)
            post[np.ix_(p1.pos_to_col[r1], p2.pos_to_col[r2])] = post_rep
            _, path = mea_align(post)
            rows = [_insert_gaps(r, path, "X") for r in p1.rows] + [
                _insert_gaps(r, path, "Y") for r in p2.rows
            ]
            return _profile_from_rows(rows, p1.seq_ids + p2.seq_ids)

        nodes = {i: (profiles[i], reps[i]) for i in range(m)}
        nid = m
        for a, b in upgma_join_order(dist):
            (pa, ra), (pb, rb) = nodes.pop(a), nodes.pop(b)
            ia, ib = reps.index(ra), reps.index(rb)
            pr = rep_posts[(ia, ib)] if ia < ib else rep_posts[(ib, ia)].T
            nodes[nid] = (join(pa, ra, pb, rb, pr), ra)
            nid += 1
        final = nodes[nid - 1][0]

    out = []
    for r in np.argsort(final.seq_ids):
        out.append((final.seq_ids[r], final.rows[r].tobytes().decode("latin1")))
    return out
