"""MSA parity: the port's consistency transform against the JAX
``_consistency_core`` at HIGHEST precision (within 1e-5: the same f32
products, summed in another order), and the port's host-aligner flow
(``_align_clusters_fused``), ``align_clusters`` (its device MSA) and
``align`` against the JAX package's ``_align_clusters_fused`` (with the
Pallas pair-HMM in interpret mode) and per-cluster ``align()``. Aligned
rows must be equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dna_ldpc_tpu.ops.msa.align import _align_clusters_fused
from dna_ldpc_tpu.ops.msa.align import align as j_align
from dna_ldpc_tpu.ops.msa.align import upgma_join_order as j_upgma
from dna_ldpc_tpu.ops.msa.consistency import _consistency_core
from dna_ldpc_tpu_torch.ops.msa import pairhmm, pairhmm_cuda
from dna_ldpc_tpu_torch.ops.msa.align import _align_clusters_fused as t_fused
from dna_ldpc_tpu_torch.ops.msa.align import align, align_clusters, upgma_join_order
from dna_ldpc_tpu_torch.ops.msa.consistency import consistency_core


def _clusters(seed, sizes, length):
    """Seeded clusters: a random strand plus copies with 1-2 deletions."""
    rng = np.random.default_rng(seed)

    def noisy(s, nd):
        b = list(s)
        for _ in range(nd):
            del b[rng.integers(0, len(b))]
        return "".join(b)

    out = []
    for n in sizes:
        s = "".join("ACGT"[i] for i in rng.integers(0, 4, length))
        out.append([s] + [noisy(s, int(rng.integers(1, 3))) for _ in range(n - 1)])
    return out


@pytest.mark.parametrize("n", [3, 5])
def test_consistency_core_matches_jax(n):
    rng = np.random.default_rng(n)
    npair, L = n * (n - 1) // 2, 24
    x = (rng.random((3, npair, L, L)) * (rng.random((3, npair, L, L)) < 0.15)).astype(np.float32)
    inv = np.array([1 / n, 1 / (n + 1), 0.25], np.float32)
    want = np.asarray(_consistency_core(jnp.asarray(x), jnp.asarray(inv), n, 2))
    got = consistency_core(torch.from_numpy(x), torch.from_numpy(inv), n, 2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_upgma_join_order_matches_jax():
    rng = np.random.default_rng(2)
    for n in (2, 3, 6, 9):
        d = rng.random((n, n))
        d = (d + d.T) / 2
        assert upgma_join_order(d) == j_upgma(d)


def test_align_clusters_matches_jax_fused_and_align(monkeypatch):
    monkeypatch.setenv("DNA_LDPC_PAIRHMM", "pallas")
    clusters = _clusters(9, (1, 2, 3, 5, 6, 4, 3, 2), 30)
    fused = _align_clusters_fused(
        clusters, refine_iters=10, consistency_iters=2, seed=0, pair_chunk=160, n_workers=2
    )
    before = pairhmm_cuda.launches
    timings = {}
    port = t_fused(clusters, 10, 2, 0, "cpu", timings)  # the host-aligner flow
    assert pairhmm_cuda.launches == before  # CPU tensors: the twin ran
    assert port == fused
    assert port == [j_align(cl, refine_iters=10) for cl in clusters]
    assert port == [align(cl, refine_iters=10, device="cpu") for cl in clusters]
    assert set(timings) == {"pairhmm", "consistency", "progressive_refine"}


def test_align_clusters_small_budget_and_no_consistency(monkeypatch):
    """A byte budget that forces one pair per pair-HMM batch and one
    cluster per consistency batch gives the same rows; so does
    consistency_iters=0 (raw bf16 posteriors to the aligner)."""
    monkeypatch.setenv("DNA_LDPC_PAIRHMM", "pallas")
    clusters = _clusters(21, (2, 4, 3, 4), 24)
    single = [j_align(cl, refine_iters=5) for cl in clusters]
    with monkeypatch.context() as m:
        m.setattr(pairhmm, "BUDGET_BYTES", 1)
        assert align_clusters(clusters, refine_iters=5, device="cpu") == single
    raw = _align_clusters_fused(
        clusters, refine_iters=5, consistency_iters=0, seed=0, pair_chunk=128, n_workers=2
    )
    assert align_clusters(clusters, refine_iters=5, consistency_iters=0, device="cpu") == raw


def test_align_trial_length_cluster(monkeypatch):
    """136-nt reads with deletions, as the trial's mixed-length clusters."""
    monkeypatch.setenv("DNA_LDPC_PAIRHMM", "pallas")
    clusters = _clusters(5, (3, 2), 136)
    assert align_clusters(clusters, refine_iters=10, device="cpu") == [j_align(cl, refine_iters=10) for cl in clusters]
