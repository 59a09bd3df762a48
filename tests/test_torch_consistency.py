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
