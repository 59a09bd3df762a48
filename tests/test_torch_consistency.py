"""``consistency_clusters`` and ``refine_mask_table`` against the JAX
package's, on the same numpy inputs.

- ``consistency_clusters(..., device="cpu")`` within atol = 2e-5,
  rtol = 1e-4 of the JAX function (the tolerance of
  ``tests/test_msa.py::test_device_consistency_matches_host_loop``: the
  batched products are full f32 on both sides, summed in another order);
  the clusters the routing passes through (fewer than 3 reads) or sends to
  the host loop (more than 32 reads, or a bucket of fewer than
  ``min_device_clusters`` clusters) bit-equal, as the two host loops are
  the same numpy code;
- the port's ``_consistency_host`` equal to the JAX one exactly;
- ``refine_mask_table`` bit-equal for n in 2..32.
"""

import os
import random
import sys

import numpy as np
import pytest
import torch

from dna_ldpc_tpu.ops.msa import consistency as j_cons
from dna_ldpc_tpu.ops.msa import device_msa as j_dm
from dna_ldpc_tpu.ops.msa.pairhmm import batch_posteriors as j_batch_posteriors
from dna_ldpc_tpu_torch.ops.msa import consistency as t_cons
from dna_ldpc_tpu_torch.ops.msa import device_msa as t_dm
from dna_ldpc_tpu_torch.ops.msa.align import cluster_pairs

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_msa import _mutate, _rand_seq  # noqa: E402

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-4


def _cluster_posts(seed, sizes, length, **mutations):
    """The JAX package's dense pair posteriors of clusters of a random
    strand and mutated copies (``tests/test_msa.py``'s clusters)."""
    rng = random.Random(seed)
    out = []
    for n in sizes:
        base = _rand_seq(rng, length)
        seqs = [base] + [_mutate(rng, base, **mutations) for _ in range(n - 1)]
        pairs = cluster_pairs(n)
        out.append(j_batch_posteriors([seqs[i] for i, _ in pairs], [seqs[j] for _, j in pairs], transport="dense"))
    return out


def _sparse_posts(seed, n, L=24):
    """Posterior-like matrices of one cluster of n reads: non-negative,
    mostly zero, shapes [len_i, len_j] of random read lengths."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(L - 4, L + 1, n)
    return [(rng.random((lens[i], lens[j])) * (rng.random((lens[i], lens[j])) < 0.2)).astype(np.float32)
            for i, j in cluster_pairs(n)]


# (clusters, min_device_clusters, indices of the clusters that pass through or take the host loop)
CASES = {
    # tests/test_msa.py:193-211: clusters of 3, 4 and 5 forced onto the batched path
    "three_four_five": (lambda: _cluster_posts(13, (3, 4, 5), 70, subs=2, dels=1, inss=1), 1, ()),
    # tests/test_msa.py:229-236: one full bucket of four clusters of 4
    "four_of_four": (lambda: _cluster_posts(17, (4, 4, 4, 4), 64, subs=1, dels=1), 4, ()),
    # every route at once: a cluster of 2 (through), 33 reads (above the top bucket), a lone
    # cluster of 5 (its bucket below min_device_clusters), a full bucket of 4
    "every_route": (lambda: ([_sparse_posts(1, 2), _sparse_posts(2, 33), _sparse_posts(3, 5)]
                             + [_sparse_posts(4 + k, 4) for k in range(4)]), 4, (0, 1, 2)),
}


@pytest.mark.parametrize("case", CASES)
def test_consistency_clusters_matches_jax(case):
    make, min_device, exact = CASES[case]
    cluster_posts = make()
    want = j_cons.consistency_clusters(cluster_posts, min_device_clusters=min_device)
    got = t_cons.consistency_clusters(cluster_posts, min_device_clusters=min_device, device="cpu")
    assert len(got) == len(want)
    for c, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w) == len(cluster_posts[c])
        for a, b, p in zip(g, w, cluster_posts[c]):
            assert a.shape == b.shape == p.shape and a.dtype == np.float32
            if c in exact:
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)
    if case == "every_route":
        assert got[0] is cluster_posts[0]  # n < 3 passes through untouched


def test_consistency_host_is_the_jax_loop():
    for posts in _cluster_posts(13, (3, 4, 5), 70, subs=2, dels=1, inss=1):
        n = int(round((1 + np.sqrt(1 + 8 * len(posts))) / 2))
        for a, b in zip(t_cons._consistency_host(posts, n, 2), j_cons._consistency_host(posts, n, 2)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("refine_iters,seed", [(0, 0), (1, 0), (100, 0), (0, 7), (1, 7), (100, 7)])
def test_refine_mask_table_matches_jax(refine_iters, seed):
    for n in range(2, 33):
        got = t_dm.refine_mask_table(n, refine_iters, seed)
        want = j_dm.refine_mask_table(n, refine_iters, seed)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The consistency kernel's host side: lengths, work list, plain version with
# lengths, and a numpy model of the kernel's addressing (csrc/consistency.cu)
# ---------------------------------------------------------------------------


def _bucket_lengths(rng, sizes, nb, lo=1, hi=160, pad_clusters=0):
    """[C, nb] read lengths of clusters of ``sizes`` reads in bucket nb
    (pad members 0), plus ``pad_clusters`` clusters without members."""
    lens = np.zeros((len(sizes) + pad_clusters, nb), np.int32)
    for c, n in enumerate(sizes):
        lens[c, :n] = rng.integers(lo, hi + 1, n)
    return lens


def _padded_pairs(rng, lens, L, garbage=False):
    """[C, npair, L, L] f32 pair posteriors in bucket slots: sparse values,
    some placed around MIN_SPARSE_PROB, zero outside each true box (random
    values there with ``garbage``)."""
    C, nb = lens.shape
    npair = nb * (nb - 1) // 2
    x = rng.random((C, npair, L, L)) * (rng.random((C, npair, L, L)) < 0.3)
    near = rng.random((C, npair, L, L)) < 0.05
    x = np.where(near, t_cons.MIN_SPARSE_PROB * rng.choice([0.999, 1.0, 1.001], x.shape), x).astype(np.float32)
    box = t_cons._box_mask(lens, nb, L).numpy()
    return np.where(box | garbage, x, 0.0).astype(np.float32)


WORK_CASES = {
    "bucket8_n5_with_pad_cluster": ((5, 3, 8, 5), 8, 1, 160, 160, 2),
    "bucket4_n3": ((3, 4, 3), 4, 140, 156, 160, 0),
    "bucket12_n9_short_reads": ((9, 12), 12, 1, 7, 160, 1),
    "multi_tile_L256": ((3, 5), 8, 150, 256, 160, 0),
    "small_tiles": ((4, 3, 6), 8, 1, 30, 7, 1),
}


@pytest.mark.parametrize("case", WORK_CASES)
def test_work_list_covers_each_true_box_once(case):
    sizes, nb, lo, hi, tile, pads = WORK_CASES[case]
    lens = _bucket_lengths(np.random.default_rng(len(case)), sizes, nb, lo, hi, pads)
    work = t_cons.work_list(lens, tile)
    assert work.dtype == np.int32 and work.shape[1] == 3
    c, i, j = work[:, 0], work[:, 1] & 0xFFFF, work[:, 1] >> 16
    ti, tj = work[:, 2] & 0xFFFF, work[:, 2] >> 16
    assert (np.diff(c) >= 0).all()  # cluster-major
    assert (i < j).all() and (lens[c, i] > 0).all() and (lens[c, j] > 0).all()
    assert (ti * tile < lens[c, i]).all() and (tj * tile < lens[c, j]).all()
    covered = {}
    for cc, a, b, r, s in zip(c, i, j, ti, tj):
        key = (int(cc), int(a), int(b))
        covered[key] = covered.get(key, 0) + min(tile, lens[cc, a] - r * tile) * min(tile, lens[cc, b] - s * tile)
    want = {(cc, a, b): int(lens[cc, a]) * int(lens[cc, b]) for cc in range(len(lens))
            for a, b in cluster_pairs(nb) if lens[cc, a] and lens[cc, b]}
    assert covered == want
    assert len({tuple(r) for r in work}) == len(work)  # no tile twice


@pytest.mark.parametrize("n", [3, 5, 9, 32])
def test_cluster_lengths_from_pair_shapes(n):
    rng = np.random.default_rng(n)
    lens = rng.integers(1, 40, n)
    posts = [np.zeros((lens[i], lens[j]), np.float32) for i, j in cluster_pairs(n)]
    assert t_cons.cluster_lengths(posts, n) == lens.tolist()


@pytest.mark.parametrize("nb,sizes,iters", [(4, (3, 4, 3), 2), (8, (5, 8, 6), 2), (8, (5, 7), 1), (12, (9,), 2)])
def test_plain_version_given_lengths_is_the_bucket_padded_result(nb, sizes, iters):
    """Given the true lengths, the plain version equals today's
    bucket-padded product bit for bit (the pads are zero), and ignores
    whatever lies outside the true boxes."""
    rng = np.random.default_rng(nb + iters)
    L = 24
    lens = _bucket_lengths(rng, sizes, nb, 1, L, pad_clusters=1)
    x = _padded_pairs(rng, lens, L)
    inv = np.array([1.0 / n for n in sizes] + [1.0], np.float32)
    want = t_cons.consistency_core(torch.from_numpy(x), torch.from_numpy(inv), nb, iters)
    got = t_cons.consistency_core(torch.from_numpy(x), torch.from_numpy(inv), nb, iters, lens)
    assert torch.equal(got, want)
    dirty = np.where(t_cons._box_mask(lens, nb, L).numpy(), x, rng.random(x.shape)).astype(np.float32)
    got = t_cons.consistency_core(torch.from_numpy(dirty), torch.from_numpy(inv), nb, iters, lens)
    assert torch.equal(got, want)


def _kernel_model(src, ids, lens, inv_n, nb, iters, tile):
    """The kernel's rounds in numpy: per work-list tile, A_iz read from the
    stored pair (z, i) transposed where z < i, A_zj from (j, z) transposed
    where z > j, each z summed to its read's length; round one reads
    src[ids[c * npair + slot]] (or the slot layout), the later ones the
    iterate."""
    C, nb_ = lens.shape
    npair, L = nb * (nb - 1) // 2, src.shape[-1]

    def slot(a, b):
        return a * nb - a * (a + 1) // 2 + b - a - 1

    for _ in range(iters):
        def pair(c, a, b, src=src, ids=ids):
            q = c * npair + slot(a, b)
            return src[ids[q]] if ids is not None else src[c, slot(a, b)]

        out = np.zeros((C, npair, L, L), np.float32)
        for c, ij, t in t_cons.work_list(lens, tile):
            i, j, ti, tj = ij & 0xFFFF, ij >> 16, t & 0xFFFF, t >> 16
            rows = slice(ti * tile, min((ti + 1) * tile, lens[c, i]))
            cols = slice(tj * tile, min((tj + 1) * tile, lens[c, j]))
            acc = np.zeros((rows.stop - rows.start, cols.stop - cols.start), np.float32)
            for z in range(nb):
                Lz = lens[c, z]
                if z in (i, j) or not Lz:
                    continue
                a = pair(c, z, i)[:Lz, rows].T if z < i else pair(c, i, z)[rows, :Lz]
                b = pair(c, z, j)[:Lz, cols] if z < j else pair(c, j, z)[cols, :Lz].T
                acc += a @ b
            aij = pair(c, i, j)[rows, cols]
            out[c, slot(i, j), rows, cols] = np.where(aij < t_cons.MIN_SPARSE_PROB, 0.0, (2 * aij + acc) * inv_n[c])
        src, ids = out, None
    return out


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("nb,sizes,tile,iters", [(4, (3, 4), 160, 2), (8, (5, 8, 3), 7, 2), (8, (6,), 5, 1),
                                                 (12, (9, 12), 16, 2)])
def test_kernel_model_matches_the_plain_version(nb, sizes, tile, iters, gather):
    """The kernel's addressing (work list, slots, transposed operands,
    per-z lengths, the gather through pair ids in round one) reproduces
    the plain version, at tiles small enough to cut every box."""
    rng = np.random.default_rng(nb * tile + iters)
    L = 24
    lens = _bucket_lengths(rng, sizes, nb, 1, L, pad_clusters=1)
    x = _padded_pairs(rng, lens, L, garbage=True)
    inv = np.array([1.0 / n for n in sizes] + [1.0], np.float32)
    want = t_cons.consistency_core(torch.from_numpy(x), torch.from_numpy(inv), nb, iters, lens).numpy()
    if gather:  # the pairs scattered through a larger tensor, pad slots pointing anywhere
        C, npair = x.shape[:2]
        perm = rng.permutation(C * npair + 5)[: C * npair]
        posts = rng.random((C * npair + 5, L, L)).astype(np.float32)
        posts[perm] = x.reshape(C * npair, L, L)
        got = _kernel_model(posts, perm, lens, inv, nb, iters, tile)
    else:
        got = _kernel_model(x, None, lens, inv, nb, iters, tile)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (want > 0).any()


@pytest.mark.parametrize("nb,iters", [(4, 2), (8, 1)])
def test_assemble_transform_with_lengths_is_unchanged(nb, iters):
    """On the CPU, ``assemble_transform`` given the members' lengths gives
    what it gives without them (the pad slots are masked either way)."""
    rng = np.random.default_rng(nb)
    L = 24
    sizes = (3, nb, nb - 1)
    lens = _bucket_lengths(rng, sizes, nb, 1, L, pad_clusters=1)
    x = _padded_pairs(rng, lens, L)
    C, npair = x.shape[:2]
    perm = rng.permutation(C * npair)
    posts = np.zeros_like(x.reshape(C * npair, L, L))
    posts[perm] = x.reshape(C * npair, L, L)
    mask = (lens[:, np.triu_indices(nb, 1)[1]] > 0).ravel()
    inv = np.array([1.0 / n for n in sizes] + [1.0], np.float32)
    args = (torch.from_numpy(posts), torch.from_numpy(perm), torch.from_numpy(mask), torch.from_numpy(inv), nb,
            iters, C, L)
    assert torch.equal(t_dm.assemble_transform(*args, lengths=lens), t_dm.assemble_transform(*args))


@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("n", [3, 5, 9])
def test_transform_pairs_is_the_host_aligner_route(n, iters):
    """``transform_pairs`` into float32, as the host-aligner flow calls it
    (clusters of exactly n reads, every slot true, the bf16 pairs scattered
    through a larger pair tensor with values outside the true boxes),
    equals the route it replaced exactly: the gathered pairs' float32
    copy through ``consistency_core`` given the lengths."""
    rng = np.random.default_rng(10 * n + iters)
    L, C = 24, 4
    npair = n * (n - 1) // 2
    lens = _bucket_lengths(rng, (n,) * C, n, 1, L)
    P = C * npair + 5
    posts = torch.from_numpy(rng.random((P, L, L)).astype(np.float32)).to(torch.bfloat16)
    ids = torch.from_numpy(rng.permutation(P)[: C * npair])
    posts[ids] = torch.from_numpy(_padded_pairs(rng, lens, L, garbage=True)).view(-1, L, L).to(torch.bfloat16)
    inv = torch.full((C,), 1.0 / n)
    want = t_cons.consistency_core(posts[ids].to(torch.float32).view(C, npair, L, L), inv, n, iters, lens)
    got = torch.zeros((C, npair, L, L))
    t_cons.transform_pairs(posts, ids, inv, lens, n, iters, got)
    assert torch.equal(got, want)
    assert (want > 0).any()


@pytest.mark.parametrize("nb,iters", [(2, 2), (4, 0), (8, 0)])
def test_transform_pairs_without_a_transform_gathers_the_true_slots(nb, iters):
    """With ``iters`` = 0 or a bucket of 2 the entry only gathers: each
    true slot's pair rounded through bf16, zero in every slot with a pad
    member or of a pad cluster, into bf16 and float32 alike."""
    rng = np.random.default_rng(nb + iters)
    L = 24
    lens = _bucket_lengths(rng, (nb, max(2, nb - 1)), nb, 1, L, pad_clusters=1)
    C, npair = lens.shape[0], nb * (nb - 1) // 2
    posts = torch.from_numpy(rng.random((C * npair + 3, L, L)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, C * npair + 3, C * npair))
    ii, jj = np.triu_indices(nb, 1)
    true = torch.from_numpy(((lens[:, ii] > 0) & (lens[:, jj] > 0)).ravel())
    want = torch.where(true[:, None, None], posts[ids].to(torch.bfloat16), 0).view(C, npair, L, L)
    for dtype in (torch.bfloat16, torch.float32):
        got = torch.zeros((C, npair, L, L), dtype=dtype)
        t_cons.transform_pairs(posts, ids, torch.ones(C), lens, nb, iters, got)
        assert torch.equal(got, want.to(dtype))
    assert true.any() and not true.all()
