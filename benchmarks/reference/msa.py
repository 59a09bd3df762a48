"""Plain reference of the LLR row of a strand whose reads are aligned.

The reference trial script (``ex_decoder/decoder.py:148-311``) with
MUSCLE v5's MPC alignment (``mpcflat.cpp``), one strand at a time:

1. pre-filter: Levenshtein distances of every pair of the strand's
   payloads; the reads that take part in a pair closer than 15 are kept,
   in read order; none kept -> the strand is an erasure (LLRs 0);
2. the kept reads' pair posteriors (``reference/pairhmm.py``), at rest in
   the configuration's precision; EA distance of a pair 1 - clip(MEA score
   / min(length), 0, 1) from them; the UPGMA guide tree with MUSCLE's
   biased linkage 0.1 average + 0.9 minimum;
3. for three or more reads, two rounds of the consistency transform:
   A_ij <- (2 A_ij + sum_z A_iz A_zj) / n where A_ij >= 0.01, else 0, the
   products' inputs read in the configuration's product precision
   (accumulated in float32, the iterate kept in float32 between the
   rounds), the result at rest in its posterior precision;
4. progressive alignment along the tree: the profiles' posterior is the
   sum of their members' pair posteriors on the members' columns, the MEA
   path maximises its sum (ties: both >= X >= Y), gaps go in by the path;
   then refinement: for each of the seeded bipartitions (``rand() % 2``
   over 100 rounds, numpy's generator with seed 0, rows of one side only
   dropped) the alignment is split, each side's all-gap columns dropped,
   and the two re-aligned; it stops after 5 splits in a row change
   nothing;
5. rows of 136 columns are counted as unaligned reads are
   (``reference/ingest.py``); if none has 136 columns, only bit 271, from
   the last character of the rows of quality above 63.

Nothing of the program is imported.
"""

from __future__ import annotations

import functools
import math
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from benchlib import recipe
from reference import ingest

PREFILTER = 15
MIN_PROB = 0.01         # the pair HMM's sparse floor (``reference/pairhmm.py``)
CONSISTENCY_ITERS = 2
REFINE_ITERS = 100
CONVERGE_AFTER = 5
GAP = ord("-")


def levenshtein(a: str, b: str) -> int:
    x = np.frombuffer(a.encode("latin1"), np.uint8)
    y = np.frombuffer(b.encode("latin1"), np.uint8)
    j = np.arange(len(y) + 1)
    row = j.copy()
    for i in range(1, len(x) + 1):
        tmp = np.empty_like(row)
        tmp[0] = i
        tmp[1:] = np.minimum(row[1:] + 1, row[:-1] + (x[i - 1] != y))
        row = np.minimum.accumulate(tmp - j) + j
    return int(row[-1])


def mea(post: np.ndarray, want_path: bool):
    """MEA max-DP over the plane ``post`` [LX, LY] in float32 (a diagonal
    step into cell (i, j) adds post[i-1, j-1]; boundary cells are 0; ties
    go both >= X >= Y), a row at a time: S(i, j) = max(S(i-1, j-1) +
    post[i-1, j-1], S(i-1, j), S(i, j-1)) is the running maximum along the
    row of the first two. (score, path of 'B', 'X', 'Y' or None)."""
    LX, LY = post.shape
    prev = np.zeros(LY + 1, np.float32)        # S(i - 1, .)
    tb = None
    if want_path:
        tb = np.zeros((LX + 1, LY + 1), np.uint8)  # 0 B, 1 X, 2 Y
        tb[1:, 0] = 1
        tb[0, :] = 2
    row = prev
    for i in range(1, LX + 1):
        b = prev[:-1] + post[i - 1]
        x = prev[1:]
        row = np.empty(LY + 1, np.float32)
        row[0] = 0.0
        np.maximum(b, x, out=row[1:])
        np.maximum.accumulate(row, out=row)
        if want_path:
            y = row[:-1]
            tb[i, 1:] = np.where((b >= x) & (b >= y), 0, np.where(x >= y, 1, 2))
        prev = row
    score = float(row[LY])
    if not want_path:
        return score, None
    path, i, j = [], LX, LY
    while i or j:
        c = tb[i, j]
        path.append("BXY"[c])
        if c == 0:
            i, j = i - 1, j - 1
        elif c == 1:
            i -= 1
        else:
            j -= 1
    return score, "".join(reversed(path))


def upgma(dist: np.ndarray) -> list[tuple[int, int]]:
    """Join list (leaves 0..n-1, join k makes node n + k)."""
    n = len(dist)
    D = dist.astype(np.float64).copy()
    np.fill_diagonal(D, np.inf)
    active = list(range(n))
    node = {i: i for i in range(n)}
    joins = []
    for k in range(n - 1):
        sub = D[np.ix_(active, active)]
        a, b = divmod(int(np.argmin(sub)), len(active))
        i, j = active[a], active[b]
        joins.append((node[i], node[j]))
        for m in active:
            if m not in (i, j):
                D[i, m] = D[m, i] = 0.1 * (D[i, m] + D[j, m]) / 2 + 0.9 * min(D[i, m], D[j, m])
        active.remove(j)
        node[i] = n + k
    return joins


@functools.lru_cache(maxsize=None)
def refine_masks(n: int) -> np.ndarray:
    if n < 3:
        return np.zeros((0, n), bool)
    m = np.random.default_rng(0).integers(0, 2, (REFINE_ITERS, n)).astype(bool)
    return m[~(m.all(1) | ~m.any(1))]


def rounded(x: np.ndarray, precision: str) -> np.ndarray:
    """float32 ``x`` rounded to ``precision`` (to nearest, ties to even)
    and read back as float32: ``float32`` as it is, ``tfloat32`` (10 bits
    of mantissa), ``bfloat16`` (7), ``float8_e4m3fn`` (3, normal from
    2^-6, steps of 2^-9 below; finite values under 448 only)."""
    x = np.ascontiguousarray(x, np.float32)
    if precision == "float32":
        return x
    drop = {"tfloat32": 13, "bfloat16": 16, "float8_e4m3fn": 20}[precision]
    i = x.view(np.uint32)
    half = np.uint32((1 << (drop - 1)) - 1)
    out = ((i + half + ((i >> np.uint32(drop)) & np.uint32(1))) & ~np.uint32((1 << drop) - 1)).view(np.float32)
    if precision == "float8_e4m3fn":
        small = np.abs(x) < 2.0 ** -6
        out = np.where(small, np.round(x * 2.0 ** 9) / np.float32(2.0 ** 9), out).astype(np.float32)
    return out


def consistency(posts: dict, lens: list[int], at_rest: str, products: str = "float32") -> dict:
    n = len(lens)
    L = max(lens)
    A = np.zeros((n, n, L, L), np.float32)
    for (i, j), p in posts.items():
        A[i, j, : p.shape[0], : p.shape[1]] = p
        A[j, i, : p.shape[1], : p.shape[0]] = p.T
    for _ in range(CONSISTENCY_ITERS):
        Am = rounded(A, products).transpose(0, 2, 1, 3).reshape(n * L, n * L)
        S = (Am @ Am).reshape(n, L, n, L).transpose(0, 2, 1, 3)
        A = np.where(A < MIN_PROB, np.float32(0.0), (np.float32(2.0) * A + S) / np.float32(n)).astype(np.float32)
    A = rounded(A, at_rest)
    return {(i, j): A[i, j, : lens[i], : lens[j]] for (i, j) in posts}


class _Profile:
    def __init__(self, rows, ids):
        self.rows, self.ids = rows, ids
        self.cols = [np.nonzero(r != GAP)[0] for r in rows]


def _merge(p1: _Profile, p2: _Profile, posts: dict) -> _Profile:
    post = np.zeros((len(p1.rows[0]), len(p2.rows[0])), np.float32)
    for c1, s1 in zip(p1.cols, p1.ids):
        for c2, s2 in zip(p2.cols, p2.ids):
            post[np.ix_(c1, c2)] += posts[(s1, s2)] if s1 < s2 else posts[(s2, s1)].T
    _, path = mea(post, True)
    path_b = np.frombuffer(path.encode(), np.uint8)

    def gapped(row, side):
        take = (path_b == ord("B")) | (path_b == ord(side))
        out = np.full(len(path_b), GAP, np.uint8)
        out[take] = row
        return out

    return _Profile([gapped(r, "X") for r in p1.rows] + [gapped(r, "Y") for r in p2.rows], p1.ids + p2.ids)


def _project(p: _Profile, ids) -> _Profile:
    rows = np.stack([p.rows[p.ids.index(s)] for s in ids])
    keep = ~(rows == GAP).all(0)
    return _Profile([r[keep] for r in rows], list(ids))


def pairs_of(n: int) -> list[tuple[int, int]]:
    return [(i, j) for i in range(n) for j in range(i + 1, n)]


def align(seqs: list[str], post: list[np.ndarray], at_rest: str, products: str = "float32") -> list[str]:
    """Aligned rows of ``seqs``, in input order; ``post`` holds the pair
    posteriors of ``pairs_of(len(seqs))``, at rest in ``at_rest``; the
    consistency products read their inputs in ``products``."""
    n = len(seqs)
    if n == 1:
        return list(seqs)
    pairs = pairs_of(n)
    posts = dict(zip(pairs, post))
    dist = np.zeros((n, n))
    for (i, j), p in posts.items():
        e = mea(p, False)[0] / min(len(seqs[i]), len(seqs[j]))
        dist[i, j] = dist[j, i] = 1.0 - min(max(e, 0.0), 1.0)
    if n >= 3:
        posts = consistency(posts, [len(s) for s in seqs], at_rest, products)
    nodes = {i: _Profile([np.frombuffer(s.encode("latin1"), np.uint8).copy()], [i]) for i, s in enumerate(seqs)}
    nxt = n
    for a, b in upgma(dist):
        nodes[nxt] = _merge(nodes.pop(a), nodes.pop(b), posts)
        nxt += 1
    final = nodes[nxt - 1]
    unchanged = 0
    for mask in refine_masks(n):
        g1 = [s for s in range(n) if mask[s]]
        g2 = [s for s in range(n) if not mask[s]]
        new = _merge(_project(final, g1), _project(final, g2), posts)
        same = len(new.rows[0]) == len(final.rows[0]) and all(
            np.array_equal(final.rows[final.ids.index(s)], new.rows[new.ids.index(s)]) for s in range(n))
        final = new
        unchanged = unchanged + 1 if same else 0
        if unchanged >= CONVERGE_AFTER:
            break
    return [final.rows[final.ids.index(s)].tobytes().decode("latin1") for s in range(n)]


def prefilter(payloads: list[str]) -> list[int]:
    """The reads that take part in a pair closer than ``PREFILTER``."""
    n = len(payloads)
    return sorted({k for i in range(n) for j in range(i + 1, n)
                   if levenshtein(payloads[i], payloads[j]) < PREFILTER for k in (i, j)})


def aligned_rows(strands: list, epsil: float, device, at_rest: str, workers: int = 1, products: str = "float32",
                 timings: dict | None = None) -> list[np.ndarray]:
    """The LLR rows of strands (each a list of (payload, quality)) whose
    reads take the pre-filter and the alignment: the pre-filters and the
    alignments in ``workers`` processes (spawned, numpy only, one BLAS
    thread each, all ended before it returns), every pair posterior of
    all the strands in one pass of ``reference/pairhmm.py`` on ``device``
    between them. ``timings``, if given, gets the seconds of each stage."""
    import torch

    from reference import pairhmm

    clock = time.time()

    def lap(stage):
        nonlocal clock
        if timings is not None:
            timings[stage] = round(time.time() - clock, 3)
        clock = time.time()

    mag = math.log((1 - epsil) / epsil)
    pool, env = None, dict(os.environ)
    if workers > 1:
        os.environ.update({k: "1" for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")})
        pool = ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing.get_context("spawn"))
    chunk = max(1, len(strands) // (4 * max(workers, 1)))

    def each(fn, *args):
        return list(pool.map(fn, *args, chunksize=chunk)) if pool else list(map(fn, *args))

    try:
        kept = each(_kept_reads, strands)
        lap("prefilter")
        xs, ys, spans = [], [], []
        for reads, keep in zip(strands, kept):
            lo = len(xs)
            for i, j in pairs_of(len(keep)):
                xs.append(reads[keep[i]][0])
                ys.append(reads[keep[j]][0])
            spans.append((lo, len(xs)))
        post = pairhmm.posteriors(xs, ys, device, getattr(torch, at_rest)) if xs else []
        lap("pair_posteriors")
        tasks = [([reads[k][0] for k in keep], [reads[k][1] for k in keep], post[lo:hi], at_rest, products, mag)
                 for reads, keep, (lo, hi) in zip(strands, kept, spans)]
        rows = each(_strand_row, *zip(*tasks)) if tasks else []
        lap("align")
        return rows
    finally:
        if pool is not None:
            pool.shutdown()
            os.environ.clear()
            os.environ.update(env)


def _kept_reads(reads) -> list[int]:
    return prefilter([p for p, _ in reads])


def _strand_row(seqs: list[str], quals: list[int], post: list, at_rest: str, products: str, mag: float) -> np.ndarray:
    if not seqs:
        return np.zeros(recipe.PAYLOAD_BITS)
    return _row_llr(align(seqs, post, at_rest, products), quals, mag)


def _row_llr(rows: list[str], q: list[int], mag: float) -> np.ndarray:
    full = [(r, qq) for r, qq in zip(rows, q) if len(r) == recipe.PAYLOAD_NT]
    if full:
        return ingest.count_rows([r for r, _ in full], [qq for _, qq in full], mag)
    llr = np.zeros(recipe.PAYLOAD_BITS)
    c0 = c1 = 0
    for r, qq in zip(rows, q):
        if qq > ingest.Q_HIGH:
            lsb = recipe.dna_bits(np.frombuffer(r[-1].encode("latin1"), np.uint8))[1]
            c0, c1 = c0 + (lsb == 0), c1 + (lsb != 0)
    llr[-1] = (c0 - c1) * mag
    return llr
