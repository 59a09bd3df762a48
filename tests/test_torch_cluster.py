"""Twins of tests/test_ingest_cluster.py:69-113: the port's k-mer
clustering and clustered super-alignment (``ops/cluster.py``) against the
JAX package's on the same inputs. Profiles and assignments are numpy in
both packages (the CPU device keeps the similarity product in numpy, as
the JAX package does on its CPU backend) and must be equal; super-aligned
rows must be equal (the JAX pair-HMM in interpret mode, as its own tests
run it)."""

import numpy as np
import pytest
import torch

from dna_ldpc_tpu.ops import cluster as j_cl
from dna_ldpc_tpu_torch.ops import cluster as t_cl

# The suite runs in several worker processes that share the cores: one
# intra-op thread per process keeps OpenMP from oversubscribing them.
torch.set_num_threads(1)


def _mutants(seed, n_centers, per_center, length, n_subs):
    rng = np.random.default_rng(seed)
    centers = ["".join(rng.choice(list("ACGT"), length)) for _ in range(n_centers)]
    reads, truth = [], []
    for c, center in enumerate(centers):
        for _ in range(per_center):
            b = list(center)
            for pos in rng.choice(length, n_subs, replace=False):
                b[pos] = rng.choice(list("ACGT"))
            reads.append("".join(b))
            truth.append(c)
    order = rng.permutation(len(reads))
    return [reads[i] for i in order], np.array(truth)[order]


def test_kmer_profiles_counts():
    for seqs, k, norm in ((["AAAA"], 2, False), (["AANA"], 2, False), (["ACGTTGCA", "GG", "ACGNACGT"], 3, True)):
        got = t_cl.kmer_profiles(seqs, k=k, normalize=norm)
        np.testing.assert_array_equal(got, j_cl.kmer_profiles(seqs, k=k, normalize=norm))
    p = t_cl.kmer_profiles(["AAAA"], k=2, normalize=False)
    assert p.shape == (1, 16) and p[0, 0] == 3 and p[0].sum() == 3
    assert t_cl.kmer_profiles(["AANA"], k=2, normalize=False)[0].sum() == 1


@pytest.mark.parametrize("seed,n_centers,per_center,block", [(2, 6, 8, 1024), (5, 40, 6, 64)])
def test_kmer_cluster_groups_mutants(seed, n_centers, per_center, block):
    reads, truth = _mutants(seed, n_centers, per_center, 80, 3)
    cl = t_cl.kmer_cluster(reads, k=4, threshold=0.7, block=block, device="cpu")
    want = j_cl.kmer_cluster(reads, k=4, threshold=0.7, block=block)
    np.testing.assert_array_equal(cl.assignment, want.assignment)
    np.testing.assert_array_equal(cl.centroids, want.centroids)
    assert cl.n_clusters == n_centers
    for cid in range(cl.n_clusters):
        assert len(set(truth[cl.assignment == cid])) == 1
    assert [m.tolist() for m in cl.members()] == [m.tolist() for m in want.members()]
    assert t_cl.kmer_cluster([], device="cpu").n_clusters == 0


def test_similarity_product_on_the_cpu_is_numpy():
    rng = np.random.default_rng(1)
    a, b = rng.random((600, 64), np.float32), rng.random((500, 64), np.float32)  # above 2^18 products
    np.testing.assert_array_equal(t_cl._matmul(a, b, "cpu"), a @ b.T)


def test_super_align_joins_clusters(monkeypatch):
    monkeypatch.setenv("DNA_LDPC_PAIRHMM", "pallas")
    rng = np.random.default_rng(3)
    a = "".join(rng.choice(list("ACGT"), 40))
    b = "".join(rng.choice(list("ACGT"), 40))
    c = "".join(rng.choice(list("ACGT"), 40))
    seqs = [a, a[:20] + "T" + a[21:], b, b[:9] + b[10:], c, c[:30] + c[31:], a[:5] + a[6:]]  # 3 clusters
    rows = t_cl.super_align(seqs, k=4, threshold=0.6, device="cpu")
    assert rows == j_cl.super_align(seqs, k=4, threshold=0.6)
    assert sorted(i for i, _ in rows) == list(range(len(seqs)))
    assert len({len(r) for _, r in rows}) == 1
    for i, s in enumerate(seqs):
        assert dict(rows)[i].replace("-", "") == s
