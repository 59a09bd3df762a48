"""Plain reference of the alignment of many clusters, large ones among
them, with the consistency products on the card.

``reference/msa.py``'s MUSCLE MPC alignment, step for step — the pre-
filter, the pair posteriors at rest, EA distances and the biased UPGMA
tree, two rounds of the consistency transform, progressive alignment
along the tree and refinement by the seeded bipartitions — with one
change of where the work runs: the consistency transform's products are
plain torch matrix products on ``device`` in float32 with TF32 off (the
inputs rounded to the products' precision first, accumulated in float32,
the iterate kept in float32 between the rounds, the result at rest in
the posteriors' precision), a block of members' rows at a time. In numpy
on one core the transform of a cluster of 60 reads of 136 nt takes two
products of 8,160 x 8,160 matrices, tens of seconds; on the card it takes
milliseconds, so that a check of clusters of 33-63 reads takes seconds.
The rest runs as in ``reference/msa.py``, in worker processes that load
numpy alone.

Nothing of the program is imported.
"""

from __future__ import annotations

import math
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from benchlib import recipe
from reference import msa

BLOCK_ROWS = 8192  # rows of the [n L, n L] product computed at once
PAIR_CHUNK = 4096  # pairs of the plain pair HMM a call


def rounded(x, precision: str):
    """``msa.rounded`` of a float32 torch tensor, on its device: to nearest,
    ties to even, ``float32`` as it is; ``float8_e4m3fn`` steps of 2^-9
    below 2^-6 (non-negative, finite values)."""
    import torch

    if precision == "float32":
        return x
    drop = {"tfloat32": 13, "bfloat16": 16, "float8_e4m3fn": 20}[precision]
    i = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    i = (i + ((1 << (drop - 1)) - 1) + ((i >> drop) & 1)) & ~((1 << drop) - 1) & 0xFFFFFFFF
    out = i.to(torch.int32).view(torch.float32)
    if precision == "float8_e4m3fn":
        out = torch.where(x.abs() < 2.0 ** -6, torch.round(x * 2.0 ** 9) / 2.0 ** 9, out)
    return out


def consistency(posts: dict, lens: list[int], at_rest: str, products: str, device) -> dict:
    """``msa.consistency`` with the products on ``device``: A_ij <- (2 A_ij
    + sum_z A_iz A_zj) / n where A_ij >= 0.01, else 0, two rounds; returns
    the pairs of ``posts`` at rest in ``at_rest``, as numpy."""
    import torch

    n, L = len(lens), max(lens)
    A = torch.zeros((n, n, L, L), dtype=torch.float32, device=device)
    for (i, j), p in posts.items():
        t = torch.as_tensor(p, device=device)
        A[i, j, : p.shape[0], : p.shape[1]] = t
        A[j, i, : p.shape[1], : p.shape[0]] = t.T
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for _ in range(msa.CONSISTENCY_ITERS):
            Am = rounded(A, products).permute(0, 2, 1, 3).reshape(n * L, n * L)
            S = torch.empty_like(Am)
            for lo in range(0, n * L, BLOCK_ROWS):
                S[lo : lo + BLOCK_ROWS] = Am[lo : lo + BLOCK_ROWS] @ Am
            S = S.view(n, L, n, L).permute(0, 2, 1, 3)
            A = torch.where(A < msa.MIN_PROB, 0.0, (2.0 * A + S) / n)
            del Am, S
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    A = rounded(A.contiguous(), at_rest)
    return {(i, j): A[i, j, : lens[i], : lens[j]].cpu().numpy() for (i, j) in posts}


def _tree(seqs: list[str], post: list) -> list[tuple[int, int]]:
    """The UPGMA join list from EA distances (``msa.align``'s first step)."""
    n = len(seqs)
    dist = np.zeros((n, n))
    for (i, j), p in zip(msa.pairs_of(n), post):
        e = msa.mea(p, False)[0] / min(len(seqs[i]), len(seqs[j]))
        dist[i, j] = dist[j, i] = 1.0 - min(max(e, 0.0), 1.0)
    return msa.upgma(dist)


def _progressive_refine(seqs: list[str], posts: dict, joins: list) -> list[str]:
    """``msa.align``'s progressive alignment and refinement on transformed
    ``posts``; rows in input order."""
    n = len(seqs)
    if n == 1:
        return list(seqs)
    nodes = {i: msa._Profile([np.frombuffer(s.encode("latin1"), np.uint8).copy()], [i]) for i, s in enumerate(seqs)}
    nxt = n
    for a, b in joins:
        nodes[nxt] = msa._merge(nodes.pop(a), nodes.pop(b), posts)
        nxt += 1
    final = nodes[nxt - 1]
    unchanged = 0
    for mask in msa.refine_masks(n):
        g1 = [s for s in range(n) if mask[s]]
        g2 = [s for s in range(n) if not mask[s]]
        new = msa._merge(msa._project(final, g1), msa._project(final, g2), posts)
        same = len(new.rows[0]) == len(final.rows[0]) and all(
            np.array_equal(final.rows[final.ids.index(s)], new.rows[new.ids.index(s)]) for s in range(n))
        final = new
        unchanged = unchanged + 1 if same else 0
        if unchanged >= msa.CONVERGE_AFTER:
            break
    return [final.rows[final.ids.index(s)].tobytes().decode("latin1") for s in range(n)]


def _strand_llr(seqs: list[str], quals: list[int], posts: dict, joins: list, mag: float) -> np.ndarray:
    if not seqs:
        return np.zeros(recipe.PAYLOAD_BITS)
    return msa._row_llr(_progressive_refine(seqs, posts, joins), quals, mag)


class _Workers:
    """``workers`` spawned processes (numpy only, one BLAS thread each), or
    the calling process for one."""

    def __init__(self, workers: int, n_tasks: int):
        self.pool, self.env = None, dict(os.environ)
        self.chunk = max(1, n_tasks // (4 * max(workers, 1)))
        if workers > 1:
            os.environ.update({k: "1" for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")})
            self.pool = ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing.get_context("spawn"))

    def map(self, fn, *args) -> list:
        return list(self.pool.map(fn, *args, chunksize=self.chunk)) if self.pool else list(map(fn, *args))

    def close(self) -> None:
        if self.pool is not None:
            self.pool.shutdown()
            os.environ.clear()
            os.environ.update(self.env)


def _posteriors(clusters: list[list[str]], device, at_rest: str) -> list[list[np.ndarray]]:
    """Every pair posterior of every cluster, at rest in ``at_rest``, in
    chunks of ``PAIR_CHUNK`` pairs."""
    import torch

    from reference import pairhmm

    xs, ys, spans = [], [], []
    for seqs in clusters:
        lo = len(xs)
        for i, j in msa.pairs_of(len(seqs)):
            xs.append(seqs[i])
            ys.append(seqs[j])
        spans.append((lo, len(xs)))
    post = []
    for lo in range(0, len(xs), PAIR_CHUNK):
        post += pairhmm.posteriors(xs[lo : lo + PAIR_CHUNK], ys[lo : lo + PAIR_CHUNK], device, getattr(torch, at_rest))
    return [post[lo:hi] for lo, hi in spans]


def _transformed(clusters, post, at_rest: str, products: str, device) -> list[dict]:
    out = []
    for seqs, p in zip(clusters, post):
        posts = dict(zip(msa.pairs_of(len(seqs)), p))
        out.append(consistency(posts, [len(s) for s in seqs], at_rest, products, device) if len(seqs) >= 3 else posts)
    return out


def aligned_clusters(clusters: list[list[str]], device, at_rest: str, products: str = "float32", workers: int = 1,
                     timings: dict | None = None) -> list[list[str]]:
    """The aligned rows of each cluster of reads, in input order."""
    clock = time.time()
    work = _Workers(workers, len(clusters))
    try:
        post = _posteriors(clusters, device, at_rest)
        trees = work.map(_tree, clusters, post)
        posts = _transformed(clusters, post, at_rest, products, device)
        if timings is not None:
            timings["posteriors_tree_consistency"] = round(time.time() - clock, 3)
        rows = work.map(_progressive_refine, clusters, posts, trees)
    finally:
        work.close()
    if timings is not None:
        timings["align"] = round(time.time() - clock, 3)
    return rows


def aligned_rows(strands: list, epsil: float, device, at_rest: str, workers: int = 1, products: str = "float32",
                 timings: dict | None = None) -> list[np.ndarray]:
    """``msa.aligned_rows`` with the consistency products on ``device``:
    the LLR rows of strands (each a list of (payload, quality)) whose reads
    take the pre-filter and the alignment."""
    clock = time.time()

    def lap(stage):
        nonlocal clock
        if timings is not None:
            timings[stage] = round(time.time() - clock, 3)
        clock = time.time()

    mag = math.log((1 - epsil) / epsil)
    work = _Workers(workers, len(strands))
    try:
        kept = work.map(msa._kept_reads, strands)
        lap("prefilter")
        clusters = [[reads[k][0] for k in keep] for reads, keep in zip(strands, kept)]
        quals = [[reads[k][1] for k in keep] for reads, keep in zip(strands, kept)]
        post = _posteriors(clusters, device, at_rest)
        lap("pair_posteriors")
        trees = work.map(_tree, clusters, post)
        posts = _transformed(clusters, post, at_rest, products, device)
        lap("tree_consistency")
        rows = work.map(_strand_llr, clusters, quals, posts, trees, [mag] * len(clusters))
        lap("align")
        return rows
    finally:
        work.close()
