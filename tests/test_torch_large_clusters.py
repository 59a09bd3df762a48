"""Clusters of more than 32 reads: the device MSA's top bucket (64) on
the CPU twin, the negative-binomial coverage that makes such clusters in
the benchmark, and the tracer's counts of the MSA's batches and fallback.

- ``align_clusters`` on clusters of 33-40 reads (bucket 64, the merge
  kernel's limit, past the JAX package's 32) gives the rows of the host
  aligner's numpy profile path (``align(..., use_native=False)``) and of
  the benchmark's plain MUSCLE reference (``benchmarks/reference/msa.py``),
  at two refinement iterations, with no cluster handed to the host
  aligner;
- ``benchmarks/benchlib/coverage.py``'s reads per oligo have the
  negative binomial's mean, variance and share of oligos with no read;
- ``msa.batch`` counts its ``bucket``, ``clusters`` and ``pairs``, and
  ``msa.fallback`` its ``clusters`` and ``reads``."""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

from dna_ldpc_tpu_torch.ops.msa import device_msa, mea_cuda
from dna_ldpc_tpu_torch.utils import profiling

t_align = importlib.import_module("dna_ldpc_tpu_torch.ops.msa.align")  # the package re-exports align()

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks"))
from benchlib import common, coverage  # noqa: E402
from reference import msa as ref_msa  # noqa: E402
from reference import pairhmm as ref_pairhmm  # noqa: E402

# The suite runs in several worker processes that share the cores: one
# intra-op thread per process keeps OpenMP from oversubscribing them.
torch.set_num_threads(1)

BASES = "ACGT"
REFINE = 2


def _reads(rng, n: int, length: int) -> list[str]:
    """``n`` reads of one random strand of ``length`` nt: a substitution
    in about one read of eight, a deletion in about one of five."""
    base = rng.integers(0, 4, length)
    out = []
    for _ in range(n):
        s = base.copy()
        if rng.random() < 0.125:
            k = int(rng.integers(0, length))
            s[k] = (s[k] + rng.integers(1, 4)) % 4
        if rng.random() < 0.2:
            s = np.delete(s, int(rng.integers(0, length)))
        out.append("".join(BASES[k] for k in s))
    return out


@pytest.fixture(scope="module")
def large_clusters():
    rng = np.random.default_rng(33)
    return [_reads(rng, 33, 22), _reads(rng, 40, 27)]


@pytest.fixture(scope="module")
def device_rows(large_clusters):
    before = (t_align.fallback_clusters, mea_cuda.merge_launches)
    with profiling.span("large-clusters", root=True):
        rows = t_align.align_clusters(large_clusters, refine_iters=REFINE, device="cpu")
    assert (t_align.fallback_clusters, mea_cuda.merge_launches) == before  # the twin, no host aligner
    return rows, profiling.recent_records("large-clusters")[-1]


def test_bucket_64_is_the_top_bucket():
    assert device_msa.MSA_BUCKETS[-1] == mea_cuda.MAX_MEMBERS == 64


def test_bucket_64_twin_equals_the_host_aligners_numpy_path(large_clusters, device_rows):
    rows, _ = device_rows
    for seqs, got in zip(large_clusters, rows):
        assert [r.replace("-", "") for _, r in got] == seqs
        assert len({len(r) for _, r in got}) == 1
        assert got == t_align.align(seqs, refine_iters=REFINE, use_native=False, device="cpu")


def test_bucket_64_twin_equals_the_plain_reference(large_clusters, device_rows, monkeypatch):
    """The plain MUSCLE MPC alignment of ``benchmarks/reference/msa.py``
    (its own pair HMM, posteriors at rest in bfloat16, float32 consistency
    products) at the same two refinement bipartitions."""
    rows, _ = device_rows
    monkeypatch.setattr(ref_msa, "REFINE_ITERS", REFINE)
    ref_msa.refine_masks.cache_clear()
    try:
        for seqs, got in zip(large_clusters, rows):
            pairs = ref_msa.pairs_of(len(seqs))
            post = ref_pairhmm.posteriors([seqs[i] for i, _ in pairs], [seqs[j] for _, j in pairs], "cpu",
                                          torch.bfloat16)
            assert [r for _, r in got] == ref_msa.align(seqs, post, "bfloat16")
    finally:
        ref_msa.refine_masks.cache_clear()


def test_batch_span_counts_its_bucket_clusters_and_pairs(large_clusters, device_rows):
    _, record = device_rows
    batches = [s for s in record if s["name"] == "msa.batch"]
    assert [s["counts"]["bucket"] for s in batches] == [64]
    assert batches[0]["counts"]["clusters"] == 2
    assert batches[0]["counts"]["pairs"] == sum(len(q) * (len(q) - 1) // 2 for q in large_clusters)
    assert not [s for s in record if s["name"] == "msa.fallback"]


def test_fallback_span_counts_its_clusters_and_reads():
    """A cluster whose alignment overflows its column budget (reads that
    overlap by half) is handed to the host aligner under ``msa.fallback``;
    the batches count each bucket they served."""
    rng = np.random.default_rng(9)
    u, v, w = ("".join(BASES[k] for k in rng.integers(0, 4, 48)) for _ in range(3))  # width 144 > 96 + 32
    clusters = [[u + v, v + w], _reads(rng, 3, 20), _reads(rng, 5, 20), _reads(rng, 6, 20)]
    before = t_align.fallback_clusters
    with profiling.span("fallback-counts", root=True):
        out = t_align.align_clusters(clusters, refine_iters=REFINE, device="cpu")
    record = profiling.recent_records("fallback-counts")[-1]
    assert t_align.fallback_clusters == before + 1
    assert len(out[0][0][1]) == 144
    fallback = [s["counts"] for s in record if s["name"] == "msa.fallback"]
    assert [(c["clusters"], c["reads"]) for c in fallback] == [(1, 2)]
    batches = sorted((s["counts"]["bucket"], s["counts"]["clusters"], s["counts"]["pairs"])
                     for s in record if s["name"] == "msa.batch")
    assert batches == [(2, 1, 1), (4, 1, 3), (8, 2, 10 + 15)]


@pytest.mark.parametrize("seed", [5, 2**33 + 1])
def test_reads_per_oligo_are_negative_binomial(seed):
    """20,000 oligos, 200,000 reads, gamma shape 3: an oligo's read count
    has mean m = 10, variance m + m^2 / 3 = 43.3 (less the share the fixed
    total takes, 1 / 20,000 of it) and no read with probability
    (3 / 13)^3 = 1.23 %."""
    n_oligos, n_reads, shape = 20_000, 200_000, 3
    picks = coverage.negative_binomial_picks(n_oligos, n_reads, shape, common.stream(seed, "reads-0"))
    counts = np.bincount(picks, minlength=n_oligos)
    m = n_reads / n_oligos
    assert counts.sum() == n_reads and counts.mean() == m
    assert counts.var() == pytest.approx(m + m * m / shape, rel=0.06)
    assert (counts == 0).mean() == pytest.approx((shape / (shape + m)) ** shape, rel=0.2)
    assert counts.max() > 3 * m  # wider than a uniform draw's Poisson(10), whose largest is ~27
