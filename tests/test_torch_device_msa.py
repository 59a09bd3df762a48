"""Device MSA parity: the port's ``ops/msa/device_msa.py`` and
``_align_clusters_device`` against the JAX package's on the same seeded
numpy inputs.

- ``mea_walk_ref`` (the twin of the ``mea_dp`` kernel) equals JAX
  ``_mea_forward`` + ``_walk`` bit for bit, on random posteriors and on
  posteriors quantised to a few values (exact ties);
- ``build_pblock`` is bit-equal; ``_build_post`` within 1e-6 relative (the
  same bf16 values summed in f32, in another order);
- ``assemble_transform`` within one bf16 ulp (the consistency products
  are summed in another order before the bf16 rounding);
- ``run_msa_batch`` and ``_align_clusters_device`` give the JAX package's
  rows and the host aligner's on the workloads of
  tests/test_device_msa.py."""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dna_ldpc_tpu.ops.msa import device_msa as j_dm
from dna_ldpc_tpu.ops.msa.align import _align_clusters_device as j_align_clusters_device
from dna_ldpc_tpu_torch.ops.msa import device_msa as t_dm
from dna_ldpc_tpu_torch.ops.msa import mea_cuda

t_align = importlib.import_module("dna_ldpc_tpu_torch.ops.msa.align")  # the package re-exports align()

# The suite runs in several worker processes that share the cores: one
# intra-op thread per process keeps OpenMP from oversubscribing them.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_device_msa import BASES, _host_reference, _mutate, _random_clusters  # noqa: E402


def _bf16_bits(x) -> np.ndarray:
    """bf16 bit patterns as int32 (non-negative values: one ulp = 1)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(x).view(np.int16).astype(np.int32)


def _block_inputs(clusters, Lpad, nb):
    """The consistency-transformed pair posteriors of tests/test_device_msa.py
    laid out [C, npair, Lpad+1, Lpad+1], the join orders and the host rows."""
    npair = nb * (nb - 1) // 2
    P = np.zeros((len(clusters), npair, Lpad + 1, Lpad + 1), np.float32)
    ii, jj = np.triu_indices(nb, k=1)
    slot = {(int(a), int(b)): s for s, (a, b) in enumerate(zip(ii, jj))}
    joins_list, host_out = [], []
    for c, seqs in enumerate(clusters):
        plist, joins, host = _host_reference(seqs)
        for p, (i, j) in enumerate(t_align.cluster_pairs(len(seqs))):
            m = plist[p]
            P[c, slot[(i, j)], : m.shape[0], : m.shape[1]] = m
        joins_list.append(joins)
        host_out.append(host)
    return P, joins_list, host_out


@pytest.mark.parametrize("kind", ["random", "quantised"])
def test_mea_walk_ref_matches_jax(kind):
    rng = np.random.default_rng(1 if kind == "random" else 2)
    C, Cmax = 12, 24
    post = rng.random((C, Cmax, Cmax)).astype(np.float32)
    if kind == "quantised":  # a few values: exact ties between B, X and Y
        post = (rng.integers(0, 3, (C, Cmax, Cmax)) * 0.5).astype(np.float32)
    wA = rng.integers(0, Cmax + 1, C).astype(np.int32)
    wB = rng.integers(0, Cmax + 1, C).astype(np.int32)
    wA[:3], wB[:3] = (0, Cmax, 5), (7, 0, Cmax)
    cd = j_dm._mea_forward(jnp.asarray(post), Cmax)
    want_codes, want_pos = (np.asarray(a) for a in j_dm._walk(cd, jnp.asarray(wA), jnp.asarray(wB), Cmax))
    before = mea_cuda.launches
    codes, pos = mea_cuda.mea_walk(torch.from_numpy(post), torch.from_numpy(wA), torch.from_numpy(wB), Cmax)
    assert mea_cuda.launches == before  # CPU tensors: the twin ran
    np.testing.assert_array_equal(codes.numpy(), want_codes)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    assert codes.dtype == torch.uint8 and pos.dtype == torch.int32
    assert (want_codes != 0).sum(1).min() > 0


def _random_merge_inputs(seed, C=6, nb=4, L=20):
    """Random posteriors in block layout plus a projected operand pair."""
    rng = np.random.default_rng(seed)
    npair = nb * (nb - 1) // 2
    P = np.zeros((C, npair, L + 1, L + 1), np.float32)
    P[:, :, :L, :L] = rng.random((C, npair, L, L)) * (rng.random((C, npair, L, L)) < 0.3)
    lens = rng.integers(L // 2, L + 1, (C, nb)).astype(np.int32)
    mA = np.zeros((C, nb), bool)
    mA[:, 0] = True
    mA[:, 1] = rng.random(C) < 0.5
    mB = ~mA
    mB[:, nb - 1] &= rng.random(C) < 0.5
    return P, lens, mA, mB


def test_build_pblock_matches_jax():
    P, *_ = _random_merge_inputs(3)
    want = j_dm.build_pblock(jnp.asarray(P), 4)
    got = t_dm.build_pblock(torch.from_numpy(P), 4)
    assert got.dtype == torch.bfloat16 and got.shape == tuple(want.shape)
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(want))


def test_build_post_matches_jax():
    P, lens, mA, mB = _random_merge_inputs(4)
    L, Cmax = 20, 28
    cpos, _ = t_dm._msa_init(torch.from_numpy(lens), Cmax, L)
    tA, tB = torch.from_numpy(mA), torch.from_numpy(mB)
    cposA, _ = t_dm._project(cpos, tA, Cmax, L)
    cposB, _ = t_dm._project(cpos, tB, Cmax, L)
    got = mea_cuda._build_post(t_dm.build_pblock(torch.from_numpy(P), 4), cposA, cposB, tA, tB, Cmax, L)
    want = j_dm._build_post(
        j_dm.build_pblock(jnp.asarray(P), 4), jnp.asarray(cposA.numpy()), jnp.asarray(cposB.numpy()),
        jnp.asarray(mA), jnp.asarray(mB), Cmax, L,
    )
    want = np.asarray(want)
    assert (want > 0).mean() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("nb,iters", [(2, 2), (4, 2), (4, 0)])
def test_assemble_transform_matches_jax(nb, iters):
    rng = np.random.default_rng(nb + iters)
    L, C = 24, 5
    npair = nb * (nb - 1) // 2
    posts = rng.random((C * npair + 3, L, L)) * (rng.random((C * npair + 3, L, L)) < 0.25)
    posts = np.where(posts < 0.01, 0.0, posts).astype(np.float32)
    ids = rng.permutation(C * npair).astype(np.int32)
    mask = rng.random(C * npair) < 0.8
    inv_n = (1.0 / rng.integers(3, nb + 1, C)).astype(np.float32) if nb >= 3 else np.ones(C, np.float32)
    want = j_dm.assemble_transform(
        (jnp.asarray(posts),), jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(inv_n), nb, iters, C, L
    )
    got = t_dm.assemble_transform(
        torch.from_numpy(posts), torch.from_numpy(ids).long(), torch.from_numpy(mask),
        torch.from_numpy(inv_n), nb, iters, C, L,
    )
    assert got.dtype == torch.bfloat16 and got.shape == tuple(want.shape)
    diff = np.abs(_bf16_bits(got) - _bf16_bits(want))
    assert diff.max() <= (1 if nb >= 3 and iters else 0)
    assert (np.asarray(want, np.float32) > 0).any()


@pytest.fixture(scope="module")
def seeded_batch():
    """The 16-cluster workload of tests/test_device_msa.py:74-108."""
    clusters = _random_clusters(seed=3, count=16)
    P, joins_list, host_out = _block_inputs(clusters, 96, 8)
    return clusters, P, joins_list, host_out


def test_run_msa_batch_matches_jax_and_host(seeded_batch):
    clusters, P, joins_list, host_out = seeded_batch
    want, want_ovf = j_dm.run_msa_batch(jnp.asarray(P), clusters, joins_list, 8, 96, 100, 0)
    got, ovf = t_dm.run_msa_batch(torch.from_numpy(P), clusters, joins_list, 8, 96, 100, 0)
    assert not ovf.any() and not want_ovf.any()
    assert got == want
    assert [dict(r) for r in got] == [dict(r) for r in host_out]
    for seqs, rows in zip(clusters, got):
        assert len({len(r) for _, r in rows}) == 1
        assert [r.replace("-", "") for _, r in rows] == seqs


def test_pad_sizes_are_inert():
    """A cluster aligned alone equals the same cluster padded into a
    larger batch (pad clusters and pad sequence slots are inert)."""
    clusters = _random_clusters(seed=11, count=3, nmax=5)
    P, joins_list, host_out = _block_inputs(clusters, 96, 4)
    padded = np.zeros((8,) + P.shape[1:], np.float32)

    def run(idx):
        padded[:] = 0
        padded[: len(idx)] = P[idx]
        rows, _ = t_dm.run_msa_batch(
            torch.from_numpy(padded), [clusters[i] for i in idx], [joins_list[i] for i in idx], 4, 96, 100, 0
        )
        return rows

    solo = [run([c])[0] for c in range(len(clusters))]
    assert run(list(range(len(clusters)))) == solo
    assert [dict(r) for r in solo] == [dict(r) for r in host_out]


def test_align_clusters_device_matches_jax(monkeypatch):
    """The whole device flow (pair-HMM, consistency, device MSA) against
    the JAX package's with its Pallas pair-HMM in interpret mode."""
    monkeypatch.setenv("DNA_LDPC_PAIRHMM", "pallas")
    clusters = _random_clusters(seed=5, count=8, nmax=7, base_len=48)
    want = j_align_clusters_device(clusters, 100, 2, 0, 64, None, {})
    timings = {}
    before = mea_cuda.launches
    got = t_align.align_clusters(clusters, device="cpu", timings=timings)
    assert mea_cuda.launches == before
    assert got == want
    assert got == [t_align.align(cl, device="cpu") for cl in clusters]
    assert set(timings) == {"pairhmm", "consistency", "msa_device", "msa_collect"}


def test_overflow_falls_back_to_host(monkeypatch):
    """Reads that overlap by half (aligned width 180, past the column
    budget Lpad + 32 = 160) are re-aligned through the host-aligner flow,
    as are clusters above the top bucket; the others stay on the device."""
    rng = np.random.default_rng(9)
    u, v, w = ("".join(BASES[i] for i in rng.integers(0, 4, 60)) for _ in range(3))
    shifted = [u + v, v + w]
    related = [_mutate("".join(BASES[i] for i in rng.integers(0, 4, 120)), rng) for _ in range(3)]
    big_base = "".join(BASES[i] for i in rng.integers(0, 4, 24))
    big = [_mutate(big_base, rng) for _ in range(33)]
    clusters = [shifted, related, big, ["ACGT"], []]
    monkeypatch.setattr(t_align, "msa_clusters", 0)
    monkeypatch.setattr(t_align, "fallback_clusters", 0)
    timings = {}
    out = t_align.align_clusters(clusters, refine_iters=5, device="cpu", timings=timings)
    assert (t_align.msa_clusters, t_align.fallback_clusters) == (3, 2)
    assert "progressive_refine" in timings and "msa_device" in timings
    assert len(out[0][0][1]) == 180
    for c, seqs in enumerate(clusters[:3]):
        rows = dict(out[c])
        assert len({len(r) for r in rows.values()}) == 1
        assert [rows[s].replace("-", "") for s in range(len(seqs))] == seqs
        assert out[c] == t_align.align(seqs, refine_iters=5, device="cpu")
    assert out[3:] == [[(0, "ACGT")], []]


def test_long_reads_take_the_host_aligner_flow():
    """Reads past the column-map bound (padded Lmax 256 > 254) send the
    whole call through the host-aligner flow, as in the JAX package."""
    rng = np.random.default_rng(4)
    clusters = [[_mutate("".join(BASES[i] for i in rng.integers(0, 4, 230)), rng) for _ in range(n)] for n in (3, 2)]
    assert max(len(s) for cl in clusters for s in cl) > 224
    timings = {}
    before = t_align.fallback_clusters
    out = t_align.align_clusters(clusters, refine_iters=5, device="cpu", timings=timings)
    assert set(timings) == {"pairhmm", "consistency", "progressive_refine"}
    assert t_align.fallback_clusters == before
    assert out == [t_align.align(cl, refine_iters=5, device="cpu") for cl in clusters]
