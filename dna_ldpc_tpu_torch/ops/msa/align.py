"""MUSCLE-v5-equivalent multiple sequence alignment (MPC pipeline).

Port of ``dna_ldpc_tpu/ops/msa/align.py``: the host pieces (EA
distances, UPGMA5 join order, guide-tree permutations and Newick output,
the MEA DP with its traceback, the profile machinery), the per-cluster
``align()``, and ``align_clusters``: the fully device-resident MSA
(``_align_clusters_device``: pair-HMM kernel, consistency transform,
progressive joins and refinement with the merge kernel; only the column
maps leave the card), which hands the clusters it cannot take (more than
64 reads, reads past the column maps' bound, column overflow) to
``_align_clusters_fused``: K2 and the transform on the device, the
progressive and refine stages in the host C++ aligner. Both run K2 through
``_pairs_k2`` and the transform through ``consistency.transform_pairs``.

``align()`` takes one cluster: its posteriors from ``batch_posteriors`` on
``device`` (K2 for the default tables), EA distances and the consistency
transform on the host, then the progressive + refine stages in the host
C++ aligner (``use_native=True``) or in the numpy profile path
(``use_native=False``), both fed the same refine mask stream.

Common to all: posteriors in bf16 (the value set the JAX package's
transport carries), and EA scores (EA = MEA-score / min(LX, LY),
FixEADistMx) giving each cluster's UPGMA5 join order (biased linkage
0.1*avg + 0.9*min).

Output per cluster: [(input ordinal, aligned row)] in input order, the
aligner interface of ``pipeline.llr``.
"""

from __future__ import annotations

import functools
import itertools
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ... import native_lib
from ...utils.device import DEFAULT_DEVICE, require_device
from ...utils.profiling import HOST, count, span, tracing, wait
from .consistency import consistency_core, transform_chunk, transform_pairs, transform_work
from . import pairhmm
from .pairhmm import ReadTable, batch_posteriors, k2_posteriors, padded_lmax

CONSISTENCY_ITERS = 2   # pairhmm.h:8
REFINE_ITERS = 100      # pairhmm.h:9
CONVERGE_AFTER = 5      # refinement stops after 5 unchanged iterations
GAP = ord("-")
N_WORKERS = min(8, os.cpu_count() or 1)  # host aligner threads

# clusters of >= 2 reads align_clusters was given, and of those the clusters
# the device MSA handed to the host aligner (oversized or column overflow),
# since the last reset: process totals (a trial's record counts its own on
# the spans ``msa.batch`` and ``msa.fallback``)
msa_clusters = 0
fallback_clusters = 0


def cluster_pairs(n: int) -> list[tuple[int, int]]:
    return [(i, j) for i in range(n) for j in range(i + 1, n)]


# ---------------------------------------------------------------------------
# MEA alignment DP (CalcAlnFlat + TraceBackFlat)
# ---------------------------------------------------------------------------


def _mea_sweep(post: np.ndarray, want_tb: bool):
    """Antidiagonal max-DP sweep in numpy. The cell recurrence of
    calcalnflat.cpp (B = diag + post, X = up, Y = left; tie preference
    B >= X >= Y from Best3's argument order) depends only on the previous
    two antidiagonals, so each of the LX+LY steps is one vectorized slab
    update."""
    LX, LY = post.shape
    W = LX + 1
    NEG = np.float32(-np.inf)
    prev2 = np.full(W, NEG, np.float32)
    prev1 = np.full(W, NEG, np.float32)
    prev2[0] = 0.0       # (0,0)
    if LX >= 1:
        prev1[1] = 0.0   # (1,0)
    prev1[0] = 0.0       # (0,1) if LY >= 1
    tb = np.full((LX + 1, LY + 1), b"Y", dtype="S1") if want_tb else None
    if want_tb:
        tb[1:, 0] = b"X"
    i_all = np.arange(W)
    for d in range(2, LX + LY + 1):
        i_lo, i_hi = max(0, d - LY), min(d, LX)
        i = i_all[i_lo : i_hi + 1]
        j = d - i
        ok_b = (i >= 1) & (j >= 1)
        pB = np.where(
            ok_b,
            prev2[np.maximum(i - 1, 0)]
            + post[np.maximum(i - 1, 0), np.maximum(j - 1, 0)] * ok_b,
            NEG,
        )
        pX = np.where(i >= 1, prev1[np.maximum(i - 1, 0)], NEG)
        pY = np.where(j >= 1, prev1[i], NEG)
        # boundary cells (i==0 or j==0) have value 0
        best = np.maximum(np.maximum(pB, pX), pY)
        boundary = (i == 0) | (j == 0)
        best = np.where(boundary, 0.0, best)
        cur = np.full(W, NEG, np.float32)
        cur[i_lo : i_hi + 1] = best
        if want_tb:
            choice = np.where(
                pB >= np.maximum(pX, pY), b"B", np.where(pX >= pY, b"X", b"Y")
            )
            choice = np.where(boundary & (i > 0), b"X", choice)
            choice = np.where(boundary & (i == 0), b"Y", choice)
            tb[i, j] = choice
        prev2, prev1 = prev1, cur
    score = float(prev1[LX]) if LX + LY >= 1 else 0.0
    return score, tb


def mea_align(post: np.ndarray, use_native: bool = True) -> tuple[float, str]:
    """MEA DP + traceback; path chars 'B' (both), 'X', 'Y'. The native
    C++ DP, or with ``use_native=False`` the numpy sweep (the same
    recurrence and tie-breaks)."""
    if use_native:
        return native_lib.mea_align_native(post)
    LX, LY = post.shape
    score, tb = _mea_sweep(post, want_tb=True)
    path = []
    i, j = LX, LY
    while i or j:
        c = tb[i, j]
        path.append(c)
        if c == b"B":
            i, j = i - 1, j - 1
        elif c == b"X":
            i -= 1
        else:
            j -= 1
    return score, b"".join(reversed(path)).decode()


def mea_score(post: np.ndarray, use_native: bool = True) -> float:
    """Score-only MEA sweep (CalcAlnScoreFlat) for EA distances: native,
    or the numpy sweep with ``use_native=False``."""
    if use_native:
        return native_lib.mea_score_native(post)
    return _mea_sweep(post, want_tb=False)[0]


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


def joins_to_newick(joins: list[tuple[int, int]], labels: list[str] | None = None) -> str:
    """Serialize a UPGMA join list as a Newick tree string (MUSCLE's guide
    tree, ``MUSCLE/src/tree.cpp``). Branch lengths are omitted (join order
    is all the progressive aligner consumes)."""
    n = len(joins) + 1
    name = {i: (labels[i] if labels else f"s{i}") for i in range(n)}
    for k, (a, b) in enumerate(joins):
        name[n + k] = f"({name.pop(a)},{name.pop(b)})"
    (root,) = name.values()
    return root + ";"


def permute_join_order(
    joins: list[tuple[int, int]], perm: str
) -> list[tuple[int, int]]:
    """MUSCLE guide-tree permutations (``permutetree.cpp`` PermuteTree):
    split the tree into A (the subtree whose leaf count is closest to 1/3
    of the leaves), then split the remainder in half into B and C, and
    rejoin as ``abc``=((A,B),C), ``acb``=((A,C),B), ``bca``=((B,C),A).
    Trees with fewer than 10 leaves are returned unchanged
    (permutetree.cpp:69-75). Node ids follow upgma_join_order's
    convention: leaves 0..n-1, internal n+k for join k."""
    n = len(joins) + 1
    if perm in (None, "none") or n < 10:
        return list(joins)
    if perm not in ("abc", "acb", "bca"):
        raise ValueError(f"unknown tree permutation {perm!r}")

    # nested-tuple tree structure (children precede parents in the join list)
    node: dict[int, object] = {i: i for i in range(n)}
    for k, (a, b) in enumerate(joins):
        node[n + k] = (node[a], node[b])
    root = node[n + len(joins) - 1]

    def leaf_count(s) -> int:
        return 1 if isinstance(s, int) else leaf_count(s[0]) + leaf_count(s[1])

    def leaf_set(s) -> set:
        return {s} if isinstance(s, int) else leaf_set(s[0]) | leaf_set(s[1])

    def divide_fraction(tree, fract):
        """Split off the subtree whose leaf count best matches
        fract * total (DivideTreeFraction; first best in pre-order wins,
        the root itself excluded so the remainder is nonempty)."""
        total = leaf_count(tree)
        target = max(1, int(total * fract + 0.5))
        best, best_diff = None, None
        stack = [(tree, True)]
        while stack:
            s, is_root = stack.pop()
            if not is_root:
                diff = abs(leaf_count(s) - target)
                if best_diff is None or diff < best_diff:
                    best, best_diff = s, diff
            if not isinstance(s, int):
                stack.append((s[1], False))
                stack.append((s[0], False))
        keep = leaf_set(tree) - leaf_set(best)

        def induce(s):
            if isinstance(s, int):
                return s if s in keep else None
            left, right = induce(s[0]), induce(s[1])
            if left is None:
                return right
            if right is None:
                return left
            return (left, right)

        return best, induce(tree)

    A, BC = divide_fraction(root, 0.33)
    B, C = divide_fraction(BC, 0.5)
    permuted = {"abc": ((A, B), C), "acb": ((A, C), B), "bca": ((B, C), A)}[perm]

    out: list[tuple[int, int]] = []

    def flatten(s) -> int:  # post-order join emission
        if isinstance(s, int):
            return s
        a, b = flatten(s[0]), flatten(s[1])
        out.append((a, b))
        return n + len(out) - 1

    flatten(permuted)
    return out


def guide_tree_newick(seqs: list[str], labels: list[str] | None = None, device=DEFAULT_DEVICE) -> str:
    """The MPC guide tree of ``seqs`` (pair-HMM EA distances on ``device`` +
    UPGMA biased linkage, mpcflat.cpp:195-208) as Newick."""
    require_device(device)
    n = len(seqs)
    if n == 1:
        return (labels[0] if labels else "s0") + ";"
    pairs = cluster_pairs(n)
    posts = batch_posteriors([seqs[i] for i, _ in pairs], [seqs[j] for _, j in pairs], device=device)
    dist = _ea_dists(seqs, np.array([mea_score(p) for p in posts], np.float32))
    return joins_to_newick(upgma_join_order(dist), labels)


def _ea_dists(seqs: list[str], ea: np.ndarray) -> np.ndarray:
    """[n, n] distances 1 - clip(EA / min(LX, LY), 0, 1) from the MEA
    scores of the cluster's pairs (FixEADistMx, upgma5.cpp:423-438)."""
    n = len(seqs)
    dist = np.zeros((n, n), dtype=np.float64)
    for p, (i, j) in enumerate(cluster_pairs(n)):
        e = float(ea[p]) / min(len(seqs[i]), len(seqs[j]))
        dist[i, j] = dist[j, i] = 1.0 - min(max(e, 0.0), 1.0)
    return dist


@functools.lru_cache(maxsize=None)
def refine_mask_table(n: int, refine_iters: int = REFINE_ITERS, seed: int = 0) -> np.ndarray:
    """The bipartition mask sequence a cluster of n sequences consumes
    (``device_msa.refine_mask_table`` in both packages): rand()%2 ->
    seeded numpy draws, all-same rows removed; the same stream as the JAX
    package's align(). Returns [n_valid, n] uint8, shared by every caller
    (cached): read it, never write it."""
    if n < 3 or refine_iters <= 0:
        return np.zeros((0, n), np.uint8)
    masks = np.random.default_rng(seed).integers(0, 2, (refine_iters, n)).astype(np.uint8)
    keep = ~((masks.all(axis=1)) | (~masks.any(axis=1)))
    return masks[keep]


def _consistency_cpu(posts: list[np.ndarray], n: int, iters: int) -> list[np.ndarray]:
    """One cluster's consistency transform as one batched product on the
    CPU (align() without precomputed transformed posteriors)."""
    L = max(max(p.shape) for p in posts)
    stacked = np.zeros((1, len(posts), L, L), np.float32)
    for k, p in enumerate(posts):
        stacked[0, k, : p.shape[0], : p.shape[1]] = p
    inv_n = torch.tensor([1.0 / n], dtype=torch.float32)
    out = consistency_core(torch.from_numpy(stacked), inv_n, n, iters).numpy()
    return [out[0, k, : p.shape[0], : p.shape[1]] for k, p in enumerate(posts)]


# ---------------------------------------------------------------------------
# Profiles and gap insertion (the numpy progressive + refine path)
# ---------------------------------------------------------------------------


@dataclass
class _Profile:
    rows: list[np.ndarray]      # aligned byte rows (with gaps)
    seq_ids: list[int]          # input ordinal of each row
    pos_to_col: list[np.ndarray]  # per row: letter position -> column


def _leaf_profile(seq_bytes: np.ndarray, seq_id: int) -> _Profile:
    return _Profile(rows=[seq_bytes], seq_ids=[seq_id], pos_to_col=[np.arange(len(seq_bytes))])


def _insert_gaps(row: np.ndarray, path: str, side: str) -> np.ndarray:
    out = np.empty(len(path), dtype=np.uint8)
    p = 0
    take = ("B", side)
    for k, c in enumerate(path):
        if c in take:
            out[k] = row[p]
            p += 1
        else:
            out[k] = GAP
    return out


def _profile_from_rows(rows, seq_ids) -> _Profile:
    pos_to_col = [np.nonzero(r != GAP)[0] for r in rows]
    return _Profile(rows=list(rows), seq_ids=list(seq_ids), pos_to_col=pos_to_col)


def _align_profiles(p1: _Profile, p2: _Profile, posts: dict, use_native: bool = True) -> _Profile:
    """BuildPost (sum of the members' pair posteriors on the profiles'
    columns), MEA DP, gap insertion by the path."""
    c1 = len(p1.rows[0])
    c2 = len(p2.rows[0])
    post = np.zeros((c1, c2), dtype=np.float32)
    for r1, s1 in enumerate(p1.seq_ids):
        cols1 = p1.pos_to_col[r1]
        for r2, s2 in enumerate(p2.seq_ids):
            cols2 = p2.pos_to_col[r2]
            if s1 < s2:
                post[np.ix_(cols1, cols2)] += posts[(s1, s2)]
            else:
                post[np.ix_(cols1, cols2)] += posts[(s2, s1)].T
    _, path = mea_align(post, use_native)
    rows = [_insert_gaps(r, path, "X") for r in p1.rows] + [
        _insert_gaps(r, path, "Y") for r in p2.rows
    ]
    return _profile_from_rows(rows, p1.seq_ids + p2.seq_ids)


def _project(profile: _Profile, row_ids: list[int]) -> _Profile:
    """Subset rows and drop all-gap columns (MultiSequence::Project)."""
    rows = [profile.rows[r] for r in row_ids]
    ids = [profile.seq_ids[r] for r in row_ids]
    mat = np.stack(rows)
    keep = ~(mat == GAP).all(axis=0)
    return _profile_from_rows([r[keep] for r in mat], ids)


def _refine_split(final: _Profile, g1, g2, posts, use_native: bool = True) -> _Profile:
    # g1/g2 index into final's row order by *input ordinal*
    id_to_row = {sid: r for r, sid in enumerate(final.seq_ids)}
    p1 = _project(final, [id_to_row[s] for s in g1 if s in id_to_row])
    p2 = _project(final, [id_to_row[s] for s in g2 if s in id_to_row])
    return _align_profiles(p1, p2, posts, use_native)


def _progressive_refine_numpy(seqs, joins, posts: dict, masks: np.ndarray) -> list[tuple[int, str]]:
    """Progressive alignment along ``joins``, then one refinement split per
    row of ``masks`` until CONVERGE_AFTER splits in a row change nothing
    (MUSCLE runs a fixed 100; the clusters here converge almost at once).
    The numpy twin of ``native_lib.msa_progressive_refine_native``."""
    n = len(seqs)
    nodes = {
        i: _leaf_profile(np.frombuffer(seqs[i].encode("latin1"), np.uint8).copy(), i) for i in range(n)
    }
    next_id = n
    for a, b in joins:
        nodes[next_id] = _align_profiles(nodes.pop(a), nodes.pop(b), posts, use_native=False)
        next_id += 1
    final = nodes[next_id - 1]
    unchanged = 0
    for mask in masks.astype(bool):
        g1 = [r for r, keep in enumerate(mask) if keep]
        g2 = [r for r, keep in enumerate(mask) if not keep]
        before = final
        final = _refine_split(final, g1, g2, posts, use_native=False)
        same = len(before.rows[0]) == len(final.rows[0]) and all(
            np.array_equal(a, b)
            for a, b in zip(before.rows, (final.rows[final.seq_ids.index(s)] for s in before.seq_ids))
        )
        unchanged = unchanged + 1 if same else 0
        if unchanged >= CONVERGE_AFTER:
            break
    return [
        (final.seq_ids[r], final.rows[r].tobytes().decode("latin1")) for r in np.argsort(final.seq_ids)
    ]


def align(
    seqs: list[str],
    refine_iters: int = REFINE_ITERS,
    consistency_iters: int = CONSISTENCY_ITERS,
    seed: int = 0,
    pair_posts: list[np.ndarray] | None = None,
    hmm_params=None,
    tree_perm: str = "none",
    pair_dists: np.ndarray | None = None,
    use_native: bool = True,
    device=DEFAULT_DEVICE,
    timings: dict | None = None,
) -> list[tuple[int, str]]:
    """Align one cluster; returns [(input ordinal, aligned row)] in input
    order. A single sequence passes through unchanged.

    ``pair_posts``: precomputed match posteriors in cluster_pairs(n) order;
    otherwise ``batch_posteriors`` computes them on ``device`` (K2 for the
    default tables; ``hmm_params`` overrides the tables, as the ensemble
    replicates do), rounded through bf16.
    ``pair_dists``: the [n, n] EA distance matrix — required when
    ``pair_posts`` already had the consistency transform applied (EA
    distances come from the PRE-consistency posteriors, mpcflat.cpp
    CalcPosteriors -> m_DistMx).
    ``tree_perm``: MUSCLE's guide-tree permutation (``permute_join_order``).
    ``use_native``: the host C++ aligner (which must build) or, when False,
    the numpy profile path, every MEA DP in numpy; both draw the same
    refine masks.
    ``timings`` accumulates seconds per stage: "pairhmm" (posteriors, on
    the host when they are back), "ea" (EA scores), "consistency" and
    "progressive_refine"."""
    require_device(device)
    if timings is None:
        timings = {}
    n = len(seqs)
    if n == 0:
        return []
    if n == 1:
        return [(0, seqs[0])]
    pairs = cluster_pairs(n)
    with span("align.pairhmm", timings=timings, key="pairhmm"):
        if pair_posts is None:
            pair_posts = batch_posteriors(
                [seqs[i] for i, _ in pairs], [seqs[j] for _, j in pairs], params=hmm_params, device=device
            )
    with span("align.ea", kind=HOST, timings=timings, key="ea"):
        if pair_dists is None:
            pair_dists = _ea_dists(seqs, np.array([mea_score(p, use_native) for p in pair_posts], np.float32))
    with span("align.consistency", kind=HOST, timings=timings, key="consistency"):
        if n >= 3 and consistency_iters:
            pair_posts = _consistency_cpu(pair_posts, n, consistency_iters)
    with span("align.progressive_refine", kind=HOST, timings=timings, key="progressive_refine"):
        joins = permute_join_order(upgma_join_order(pair_dists), tree_perm)
        masks = refine_mask_table(n, refine_iters, seed)
        if not use_native:
            return _progressive_refine_numpy(seqs, joins, dict(zip(pairs, pair_posts)), masks)
        return list(enumerate(native_lib.msa_progressive_refine_native(seqs, joins, pair_posts, masks, CONVERGE_AFTER)))


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

    The fully device-resident MSA (``_align_clusters_device``), which
    hands the clusters it cannot take to the host C++ aligner
    (``_align_clusters_fused``). ``timings`` accumulates seconds per
    stage; the whole is the span ``msa``."""
    global msa_clusters
    require_device(device)
    if timings is None:
        timings = {}
    msa_clusters += sum(1 for seqs in clusters if len(seqs) >= 2)
    with span("msa"):
        return _align_clusters_device(clusters, refine_iters, consistency_iters, seed, device, timings)


def _sync(dev: torch.device) -> None:
    """Wait for the card, so that a stage's time is its own."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        wait(dev)


def _count_transform(clusters, iters: int) -> None:
    """Count, on the innermost span, the clusters given to the consistency
    transform and, while a profiler records, its FLOPs and bytes at the
    reads' true lengths (``consistency.transform_work``)."""
    count("clusters", len(clusters))
    if tracing():
        for seqs in clusters:
            flops, nbytes = transform_work([len(q) for q in seqs], iters)
            count("flops", flops)
            count("bytes", nbytes)


class _PairTable:
    """Every pair of the clusters in ``order``, by array arithmetic: the
    clusters' reads, each once, as rows of one ``ReadTable`` (cluster c's
    from row ``read_lo[c]``), and their pairs, in cluster_pairs order and
    clusters in ``order``, as rows ``span[c]`` = (lo, hi) of K2's output,
    pair p of reads ``a[p]`` and ``b[p]`` of the table."""

    def __init__(self, clusters, order: list[int], Lmax: int):
        cs = np.asarray(order, np.int64)
        sizes = np.fromiter(map(len, (clusters[c] for c in order)), np.int64, len(order))
        npairs = sizes * (sizes - 1) // 2
        read_lo, pair_lo = np.cumsum(sizes) - sizes, np.cumsum(npairs) - npairs
        self.n, self.read_lo, self.pair_lo = (np.zeros(len(clusters), np.int64) for _ in range(3))
        self.n[cs], self.read_lo[cs], self.pair_lo[cs] = sizes, read_lo, pair_lo
        self.a = np.empty(int(npairs.sum()), np.int32)
        self.b = np.empty_like(self.a)
        for n in np.unique(sizes):  # each size's upper triangle, at every cluster of that size
            sel = sizes == n
            ti, tj = np.triu_indices(n, 1)
            rows = pair_lo[sel][:, None] + np.arange(len(ti))
            self.a[rows] = read_lo[sel][:, None] + ti
            self.b[rows] = read_lo[sel][:, None] + tj
        self.span = dict(zip(order, zip(pair_lo.tolist(), (pair_lo + npairs).tolist())))
        self.table = ReadTable(list(itertools.chain.from_iterable(clusters[c] for c in order)), Lmax)

    def batch(self, batch: list[int], nb: int):
        """The device MSA's inputs of clusters ``batch`` in bucket ``nb``:
        K2's row of each pair slot (``ids``, cluster-major, slots in
        cluster_pairs(nb) order), the slots that hold a pair (``mask``),
        1/n a cluster and the reads' lengths [C, nb], grouped by size."""
        cs = np.asarray(batch, np.int64)
        ns = self.n[cs]
        npair = nb * (nb - 1) // 2
        ids = np.zeros(len(cs) * npair, np.int64)
        mask = np.zeros(len(ids), bool)
        lengths = np.zeros((len(cs), nb), np.int32)
        for n in np.unique(ns):
            bi = np.flatnonzero(ns == n)
            ti, tj = np.triu_indices(n, 1)
            slots = bi[:, None] * npair + (ti * nb - ti * (ti + 1) // 2 + tj - ti - 1)
            ids[slots] = self.pair_lo[cs[bi]][:, None] + np.arange(len(ti))
            mask[slots] = True
            lengths[bi, :n] = self.table.lengths[self.read_lo[cs[bi]][:, None] + np.arange(n)]
        return ids, mask, (1.0 / ns).astype(np.float32), lengths


def _pairs_k2(clusters, order: list[int], Lmax: int, dev: torch.device, timings: dict):
    """K2 over every pair of the clusters in ``order``, in cluster_pairs
    order: the read table and the pairs' rows (``_PairTable``; span
    ``msa.pairs``, host) and the kernel (``msa.k2``), both under the
    ``timings`` key "pairhmm". Returns (posteriors [P, Lmax, Lmax] bf16 on
    ``dev`` or None, EA scores [P], the ``_PairTable``)."""
    with span("msa.pairs", kind=HOST, timings=timings, key="pairhmm"):
        pt = _PairTable(clusters, order, Lmax)
        xs, ys = pt.table.side(pt.a), pt.table.side(pt.b)
    with span("msa.k2", timings=timings, key="pairhmm"):
        posts, ea_all = k2_posteriors(xs, ys, Lmax, dev) if xs else (None, None)
    return posts, ea_all, pt


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

    1. clusters of 2..64 reads are grouped into the device-MSA buckets
       (``device_msa.MSA_BUCKETS``, up to 64 reads, past the JAX
       package's 32), and K2 runs over every pair of them
       (buckets ascending, clusters contiguous), posteriors kept in bf16;
    2. EA distances give each cluster's UPGMA join order;
    3. per batch of a bucket (its size from the byte budget),
       ``assemble_transform`` gathers the pairs and applies the
       consistency transform, and ``start_msa_batch`` runs every
       progressive join and refinement iteration as batched merges.

    Clusters above the top bucket or whose alignment overflows the column
    budget, or all where a read passes the column maps' bound, go through
    ``_align_clusters_fused``. Spans and ``timings`` keys: "pairhmm"
    (``msa.pairs``, host: the read table and the pairs' rows; ``msa.k2``),
    per batch (``msa.batch``, which counts its ``bucket``, ``clusters``
    and ``pairs``) "consistency" (``msa.assemble``, host: the
    pair ids and masks; ``msa.consistency``: uploads, gather, transform), "msa_device" (``msa.joins``, host: UPGMA;
    ``msa.device``: the progressive and refine merges), "msa_collect"
    (``msa.collect``: the column maps' download, ``msa.rows``), plus the
    fallback flow's keys under ``msa.fallback`` (which counts its
    ``clusters`` and ``reads``) when it runs."""
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

    order = [c for nb in sorted(by_bucket) for c in by_bucket[nb]]
    posts, ea_all, pt = _pairs_k2(clusters, order, Lmax, dev, timings)
    pair_span = pt.span

    for nb in sorted(by_bucket):
        members = by_bucket[nb]
        C_cap = max(1, pairhmm.BUDGET_BYTES // cluster_bytes(nb, Lmax))
        for mlo in range(0, len(members), C_cap):
            batch = members[mlo : mlo + C_cap]
            with span("msa.batch"):
                count("bucket", nb)
                count("clusters", len(batch))
                count("pairs", int(sum(pt.n[c] * (pt.n[c] - 1) // 2 for c in batch)))
                with span("msa.assemble", kind=HOST, timings=timings, key="consistency"):
                    ids, mask, inv_n, lengths = pt.batch(batch, nb)
                with span("msa.consistency", timings=timings, key="consistency"):
                    ids_t, mask_t = torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev)
                    inv_n_t = torch.as_tensor(inv_n, device=dev)
                    wait(dev, 3)
                    P = assemble_transform(posts, ids_t, mask_t, inv_n_t, nb, consistency_iters, len(batch), Lmax,
                                           lengths)
                    if consistency_iters and nb >= 3:
                        _count_transform([clusters[c] for c in batch], consistency_iters)
                    _sync(dev)

                with span("msa.joins", kind=HOST, timings=timings, key="msa_device"):
                    joins_list = [
                        upgma_join_order(_ea_dists(clusters[c], ea_all[pair_span[c][0] : pair_span[c][1]]))
                        for c in batch
                    ]
                with span("msa.device", timings=timings, key="msa_device"):
                    job = start_msa_batch(P, [clusters[c] for c in batch], joins_list, nb, Lmax, refine_iters, seed)
                    del P
                    _sync(dev)

                with span("msa.collect", timings=timings, key="msa_collect"):
                    rows_out, _ovf = job.collect()
                    for c, rows in zip(batch, rows_out):
                        if rows is None:
                            fallback.append(c)
                        else:
                            out[c] = rows
    posts = None  # free the pair posteriors before the fallback computes its own

    if fallback:
        fallback_clusters += len(fallback)
        with span("msa.fallback"):
            count("clusters", len(fallback))
            count("reads", sum(len(clusters[c]) for c in fallback))
            rows = _align_clusters_fused([clusters[c] for c in fallback], refine_iters, consistency_iters, seed, device,
                                         timings)
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
    """The host-aligner flow, counterpart of the JAX package's
    ``_align_clusters_fused``: K2 and the consistency transform (into
    float32, clusters of one size in batches of ``transform_chunk``) on
    ``device``, the progressive and refine stages in the host C++ aligner.
    Spans and ``timings`` keys: "pairhmm" (``msa.pairs``, host; ``msa.k2``),
    "consistency" (``msa.consistency``: transform + posterior download,
    the aligner's jobs handed out) and "progressive_refine"
    (``msa.host_aligner``: waiting for the host aligner)."""
    dev = torch.device(device)
    out: list = [[(0, seqs[0])] if len(seqs) == 1 else [] for seqs in clusters]
    multi = [c for c, seqs in enumerate(clusters) if len(seqs) >= 2]
    if not multi:
        return out
    by_n: dict[int, list[int]] = {}
    for c in multi:
        by_n.setdefault(len(clusters[c]), []).append(c)

    # ---- 1. pair-HMM over every pair of every cluster -------------------
    Lmax = padded_lmax(max(len(s) for c in multi for s in clusters[c]))
    posts, ea_all, pt = _pairs_k2(clusters, multi, Lmax, dev, timings)
    pair_span = pt.span

    # ---- 2-3. consistency batches, EA distances, host aligner -----------
    futures = {}
    with ThreadPoolExecutor(max_workers=N_WORKERS) as pool:
        with span("msa.consistency", timings=timings, key="consistency"):
            for n in sorted(by_n):
                members = by_n[n]
                pairs = cluster_pairs(n)
                cap = transform_chunk(n, Lmax, consistency_iters)
                for blo in range(0, len(members), cap):
                    batch = members[blo : blo + cap]
                    ids = torch.as_tensor(np.concatenate([np.arange(*pair_span[c]) for c in batch]), device=dev)
                    inv_n = torch.full((len(batch),), 1.0 / n, dtype=torch.float32, device=dev)
                    lengths = [[len(q) for q in clusters[c]] for c in batch]
                    res = torch.zeros((len(batch), len(pairs), Lmax, Lmax), dtype=torch.float32, device=dev)
                    transform_pairs(posts, ids, inv_n, lengths, n, consistency_iters, res)
                    res = res.cpu().numpy()
                    wait(dev, 2)  # the index upload, the download
                    if n >= 3 and consistency_iters:
                        _count_transform([clusters[c] for c in batch], consistency_iters)
                    for bi, c in enumerate(batch):
                        seqs, (lo, hi) = clusters[c], pair_span[c]
                        futures[c] = pool.submit(
                            align, seqs, refine_iters, 0, seed,
                            [res[bi, k, : len(seqs[i]), : len(seqs[j])] for k, (i, j) in enumerate(pairs)],
                            pair_dists=_ea_dists(seqs, ea_all[lo:hi]), device=device,
                        )
        with span("msa.host_aligner", kind=HOST, timings=timings, key="progressive_refine"):
            for c, fut in futures.items():
                out[c] = fut.result()
    return out
