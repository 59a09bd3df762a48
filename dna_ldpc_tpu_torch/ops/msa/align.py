"""MUSCLE-v5-equivalent multiple sequence alignment (MPC pipeline).

Port of ``dna_ldpc_tpu/ops/msa/align.py``: the host pieces (EA
distances, UPGMA5 join order, guide-tree permutations and Newick output,
the MEA DP with its traceback, the profile machinery), the per-cluster
``align()``, and ``align_clusters`` in its two device configurations:

- the default, ``_align_clusters_device``: the pair-HMM kernel, the
  consistency transform, and the progressive joins and refinement
  (``device_msa.py``, with the merge kernel) all on the device; only the
  column maps leave it;
- ``DNA_LDPC_DEVICE_MSA=0``, ``_align_clusters_fused``: the pair-HMM
  kernel and the consistency transform on the device, the progressive and
  refine stages in the host C++ aligner. The device flow also hands it the
  clusters it does not take (more than 32 reads, column overflow).

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

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ... import native_lib
from ...utils.device import DEFAULT_DEVICE, require_device
from .consistency import consistency_core
from . import pairhmm
from .pairhmm import batch_posteriors, k2_posteriors, padded_lmax

CONSISTENCY_ITERS = 2   # pairhmm.h:8
REFINE_ITERS = 100      # pairhmm.h:9
CONVERGE_AFTER = 5      # refinement stops after 5 unchanged iterations
GAP = ord("-")
N_WORKERS = min(8, os.cpu_count() or 1)  # host aligner threads

# clusters of >= 2 reads align_clusters was given, and of those the clusters
# the device MSA handed to the host aligner (oversized or column overflow),
# since the last reset
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
    t0 = time.time()
    if pair_posts is None:
        pair_posts = batch_posteriors(
            [seqs[i] for i, _ in pairs], [seqs[j] for _, j in pairs], params=hmm_params, device=device
        )
    t0 = _tick(timings, "pairhmm", t0)
    if pair_dists is None:
        pair_dists = _ea_dists(seqs, np.array([mea_score(p, use_native) for p in pair_posts], np.float32))
    t0 = _tick(timings, "ea", t0)
    if n >= 3 and consistency_iters:
        pair_posts = _consistency_host(pair_posts, n, consistency_iters)
    t0 = _tick(timings, "consistency", t0)
    joins = permute_join_order(upgma_join_order(pair_dists), tree_perm)
    masks = _refine_masks(n, refine_iters, seed)
    if not use_native:
        out = _progressive_refine_numpy(seqs, joins, dict(zip(pairs, pair_posts)), masks)
    else:
        out = list(enumerate(native_lib.msa_progressive_refine_native(seqs, joins, pair_posts, masks, CONVERGE_AFTER)))
    _tick(timings, "progressive_refine", t0)
    return out


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
        posts, ea_all = k2_posteriors(xs, ys, Lmax, dev)
    _tick(timings, "pairhmm", t0)

    for nb in sorted(by_bucket):
        members = by_bucket[nb]
        npair = nb * (nb - 1) // 2
        slot_of = {pair: sl for sl, pair in enumerate(cluster_pairs(nb))}
        C_cap = max(1, pairhmm.BUDGET_BYTES // cluster_bytes(nb, Lmax))
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
    posts, ea_all = k2_posteriors(xs, ys, Lmax, dev)
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
            pair_dists=_ea_dists(clusters[c], ea_all[lo:hi]), device=device,
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
            cap = max(1, pairhmm.BUDGET_BYTES // (4 * 4 * n * n * Lmax * Lmax))
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
