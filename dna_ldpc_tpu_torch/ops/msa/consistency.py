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

On the card the transform is one hand-written CUDA kernel per iteration
(``csrc/consistency.cu``, launched by ``transform_rounds``): it reads each
pair's true box from the pair tensor itself (A_iz for z < i as A_zi
transposed), sums only over the other true members z, and stops each z at
its read's length — no block tensor, no pad members, no zero diagonal
blocks, no lower triangle. The host hands it the members' lengths
(``lengths`` [C, nb], 0 for a pad member) and a work list of output tiles
(``work_list``), in one pinned, non-blocking upload. ``consistency_core_ref``
keeps the block product above as the plain version: CPU tensors take it.
Both MSA flows transform the pairs they name in K2's pair tensor through
one entry, ``transform_pairs``, which alone sizes the chunks.

``consistency_clusters`` is the public batched entry: numpy posteriors of
many clusters in, transformed numpy posteriors out, routed as the JAX
function routes them — sizes bucketed to ``N_BUCKETS`` (zero member
blocks are inert; the divide uses each cluster's true n), the transform
on ``device`` given each cluster's read lengths, and sizes above the top
bucket or bucket groups too small to batch through the host loop
``_consistency_host``. Left out
as TPU workarounds: padding the cluster axis to a full chunk (one
compiled program per bucket; zero blocks give the same results) and the
sparse top-k transport (``top_k``, ``cluster_sparse``).
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils.device import DEFAULT_DEVICE, full_f32_matmul, require_device
from ...utils.profiling import count, device_time, wait
from . import pairhmm
from .mea_cuda import _one_device
from .pairhmm import MIN_SPARSE_PROB

N_BUCKETS = (3, 4, 6, 8, 12, 16, 24, 32)

launches = 0  # consistency_kernel launches since import (main-path evidence)
TILE = 160  # the kernel's output tile edge (csrc/consistency.cu); a longer box takes several tiles


def consistency_core(pair_mats: torch.Tensor, inv_n: torch.Tensor, n: int, iters: int, lengths=None) -> torch.Tensor:
    """pair_mats: [C, n*(n-1)/2, L, L] float32 i<j pair posteriors of C
    clusters of up to n sequences (cluster_pairs(n) slots, zero padded);
    inv_n: [C] float32 1/n_true; ``lengths``: host ints [C, n], the
    members' read lengths, 0 for a pad member (None: n members of length
    L). Entries outside each pair's true box count as zero and come back
    zero. Returns the transformed pairs in the same layout (``iters`` = 0:
    a copy of the input): the kernel on CUDA tensors
    (``transform_rounds``), ``consistency_core_ref`` on CPU tensors."""
    dev = _one_device(pair_mats, inv_n)
    if dev.type == "cpu":
        return consistency_core_ref(pair_mats, inv_n, n, iters, lengths)
    if not iters:
        return pair_mats.clone()
    if pair_mats.dtype != torch.float32:
        raise ValueError("pair_mats must be float32")
    out = torch.zeros_like(pair_mats)
    transform_rounds(pair_mats.contiguous(), None, out, inv_n, lengths, n, iters)
    return out


def consistency_core_ref(pair_mats, inv_n, n: int, iters: int, lengths=None) -> torch.Tensor:
    """Plain torch version of ``consistency_core``: the clusters stacked
    into a block tensor A[c, i, j] (A[c,i,i] = 0, A[c,j,i] = A[c,i,j]^T),
    each iteration one batched [n*L, n*L] product in full float32 (module
    docstring). With ``lengths``, the entries outside the true boxes are
    zeroed first, which changes nothing where they are zero already. On
    the card, the work between the index uploads and the return is
    event-timed into the innermost span while a profiler records."""
    C, npair, L, _ = pair_mats.shape
    dev = pair_mats.device
    if lengths is not None:
        pair_mats = torch.where(_box_mask(lengths, n, L).to(dev), pair_mats, 0.0)
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


def _lengths(lengths, C: int, nb: int, L: int) -> np.ndarray:
    """``lengths`` as int32 [C, nb] (None: every member of length L),
    checked against the pair tensor's width L."""
    lens = np.full((C, nb), L, np.int32) if lengths is None else np.asarray(lengths, np.int32)
    if lens.shape != (C, nb) or lens.min(initial=0) < 0 or lens.max(initial=0) > L:
        raise ValueError(f"lengths must be [C={C}, nb={nb}] in 0..{L}, got {lens.shape}")
    return lens


def _box_mask(lengths, nb: int, L: int) -> torch.Tensor:
    """[C, npair, L, L] bool: inside pair (i, j)'s true box L_i x L_j."""
    lens = torch.as_tensor(np.asarray(lengths, np.int64))
    ii, jj = np.triu_indices(nb, k=1)
    pos = torch.arange(L)
    rows = pos < lens[:, ii, None]
    cols = pos < lens[:, jj, None]
    return rows[..., :, None] & cols[..., None, :]


def cluster_lengths(posts: list[np.ndarray], n: int) -> list[int]:
    """The read lengths of a cluster of n from its pair posteriors in
    cluster_pairs order (pairs (0, 1) .. (0, n-1) come first)."""
    return [posts[0].shape[0]] + [posts[s - 1].shape[1] for s in range(1, n)]


def work_list(lengths: np.ndarray, tile: int = TILE) -> np.ndarray:
    """The kernel's grid for clusters whose members have read lengths
    ``lengths`` [C, nb] (0: no member): one int32 row (c, i | j << 16,
    ti | tj << 16) per tile (ti, tj) of tile x tile that covers the true
    box L_i x L_j of each pair i < j of members, cluster-major, pairs in
    cluster_pairs(nb) order, tiles row-major."""
    lens = np.asarray(lengths, np.int64)
    C, nb = lens.shape
    ii, jj = np.triu_indices(nb, k=1)
    ti, tj = -(-lens[:, ii] // tile), -(-lens[:, jj] // tile)  # tiles a side, 0 without a member
    per = (ti * tj).ravel()
    item = np.repeat(np.arange(per.size), per)  # (c, slot) of each tile
    t = np.arange(item.size) - np.repeat(np.cumsum(per) - per, per)
    tj_of = tj.ravel()[item]
    c, slot = np.divmod(item, len(ii))
    return np.stack([c, ii[slot] | jj[slot] << 16, t // tj_of | (t % tj_of) << 16], 1).astype(np.int32)


def transform_rounds(src, ids, dst, inv_n, lengths, nb: int, iters: int) -> None:
    """``iters`` launches of the consistency kernel (``csrc/consistency.cu``)
    over C clusters of bucket ``nb`` with members' read lengths ``lengths``
    (host int32 [C, nb]). Round one reads ``src``: float32 pairs
    [C, npair, L, L] in cluster_pairs(nb) slots, or with ``ids`` (int64
    [C * npair] on the card) the bf16 posteriors src[ids[c * npair + slot]]
    of a pair tensor [P, L, L]; each later round reads the float32 iterate
    of the one before; the last writes the true boxes of ``dst`` (a
    [C, npair, L, L] view, float32 or bf16, rows and pairs strided; the
    rest of it is left as it is). The lengths and the work list reach the
    card in one pinned, non-blocking upload; the launches are event-timed
    into the innermost span while a profiler records, and counted on it as
    ``launches``."""
    global launches
    from ... import cuda_lib

    dev = src.device
    C, L = inv_n.shape[0], src.shape[-1]
    npair = nb * (nb - 1) // 2
    lengths = _lengths(lengths, C, nb, L)
    if dst.shape != (C, npair, L, L) or dst.stride(3) != 1 or dst.stride(0) != npair * dst.stride(1):
        raise ValueError(f"dst must be a [C, npair, L, L] = {(C, npair, L, L)} view with unit column stride")
    if ids is None:
        if src.dtype != torch.float32 or src.shape != (C, npair, L, L) or not src.is_contiguous():
            raise ValueError("src must be contiguous float32 [C, npair, L, L] without ids")
        src_pair, src_row = src.stride(1), src.stride(2)
    else:
        if src.dtype != torch.bfloat16 or src.dim() != 3 or not src.is_contiguous():
            raise ValueError("src must be contiguous bf16 [P, L, L] with ids")
        if ids.dtype != torch.int64 or ids.shape != (C * npair,) or not ids.is_contiguous():
            raise ValueError(f"ids must be contiguous int64 [{C * npair}]")
        src_pair, src_row = src.stride(0), src.stride(1)
    if dst.dtype not in (torch.float32, torch.bfloat16) or inv_n.dtype != torch.float32:
        raise ValueError("dst must be float32 or bf16, inv_n float32")
    work = work_list(lengths)
    meta = _upload(np.concatenate([lengths.ravel(), work.ravel()]).astype(np.int32), dev)
    lens_t, work_t = meta[: C * nb], meta[C * nb :]
    tmp = [torch.empty((C, npair, L, L), dtype=torch.float32, device=dev) for _ in range(min(iters - 1, 2))]
    inv_n = inv_n.contiguous()
    lib = cuda_lib.load()
    cur, cur_ids, cur_pair, cur_row = src, ids, src_pair, src_row
    with torch.cuda.device(dev), device_time(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for r in range(iters):
            out = dst if r == iters - 1 else tmp[r % 2]
            status = lib.consistency_launch(
                cur.data_ptr(), None if cur_ids is None else cur_ids.data_ptr(), int(cur.dtype == torch.bfloat16),
                cur_pair, cur_row, out.data_ptr(), int(out.dtype == torch.bfloat16), out.stride(1), out.stride(2),
                lens_t.data_ptr(), work_t.data_ptr(), len(work), inv_n.data_ptr(), nb, stream,
            )
            cuda_lib.check(status, "consistency_launch")
            cur, cur_ids, cur_pair, cur_row = out, None, out.stride(1), out.stride(2)
    if len(work):
        launches += iters
        count("launches", iters)


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``a`` on ``dev``: to the card in one pinned copy, without a wait."""
    t = torch.from_numpy(a)
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


def transform_chunk(nb: int, L: int, iters: int) -> int:
    """Clusters of bucket ``nb`` a chunk of the transform takes: as many as
    the kernel's float32 iterates fit in ``pairhmm.BUDGET_BYTES``."""
    iterates = max(1, min(iters - 1, 2))
    return max(1, pairhmm.BUDGET_BYTES // (iterates * (nb * (nb - 1) // 2) * L * L * 4))


def transform_pairs(posts, ids, inv_n, lengths, nb: int, iters: int, dst) -> None:
    """Write into the zeroed ``dst`` ([C, npair, L, L] view on the device,
    bf16 or float32) the transform of the pairs that ``ids`` (int64
    [C * npair]) names in the pair tensor ``posts`` [P, L, L], rounded
    through bf16; ``inv_n`` [C] float32 1/n_true. ``lengths`` (host ints
    [C, nb], 0 for a pad member) alone decides which slots are true: those
    whose members both have a length. With ``iters`` = 0 or ``nb`` < 3 the
    true slots are only gathered. On the card the kernel reads the bf16
    posteriors at ``ids`` itself (``transform_rounds``), elsewhere the
    gathered pairs go through ``consistency_core_ref``: in chunks of
    ``transform_chunk`` clusters either way."""
    C, L = inv_n.shape[0], posts.shape[-1]
    npair = nb * (nb - 1) // 2
    ii, jj = np.triu_indices(nb, k=1)
    lengths = np.asarray(lengths, np.int32)
    posts = posts.to(torch.bfloat16)
    transform = bool(iters) and nb >= 3
    ck = transform_chunk(nb, L, iters)
    for lo in range(0, C, ck):
        hi = min(C, lo + ck)
        sl, lens = slice(lo * npair, hi * npair), lengths[lo:hi]
        if transform and posts.device.type == "cuda":
            transform_rounds(posts, ids[sl].to(torch.int64), dst[lo:hi], inv_n[lo:hi], lens, nb, iters)
            continue
        true = _upload(((lens[:, ii] > 0) & (lens[:, jj] > 0)).ravel(), posts.device)
        pm = torch.where(true[:, None, None], posts[ids[sl]], 0).view(hi - lo, npair, L, L)
        dst[lo:hi] = consistency_core_ref(pm.float(), inv_n[lo:hi], nb, iters, lens) if transform else pm


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
    posteriors, the batched transform (``consistency_core``) on ``device``.

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
            lengths = np.zeros((len(batch), nb), np.int32)
            for bi, (c, n) in enumerate(batch):
                inv_n[bi] = 1.0 / n
                lengths[bi, :n] = cluster_lengths(cluster_posts[c], n)
                pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
                for (i, j), mat in zip(pairs, cluster_posts[c]):
                    stacked[bi, slot_of[(i, j)], : mat.shape[0], : mat.shape[1]] = mat
            trans = consistency_core(
                torch.from_numpy(stacked).to(dev), torch.from_numpy(inv_n).to(dev), nb, iters, lengths
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
