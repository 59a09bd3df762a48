"""K2's inputs by array arithmetic: the read table, the pairs' rows and the
device MSA's pair slots (``pairhmm.pack_reads``, ``ReadTable``,
``align._PairTable``), held against the per-pair route they replace.

- the table gathered through the pairs' rows equals the pairs' reads
  packed pair by pair (``encode_pairs``, and the loop over reads it ran
  before ``pack_reads``) exactly, codes and lengths, over clusters of
  2-32 reads in bucket order, wildcards, lower case and reads of Lmax; a
  read over Lmax raises;
- each cluster's span of K2 rows and the device MSA's slot ids, masks,
  1/n and lengths equal the per-pair loops';
- ``_pairs_k2`` on the CPU gives the per-pair route's posteriors and EA
  scores bit for bit, and ``msa.k2`` counts the table's rows as ``reads``;
- ``post_ea`` with index tensors equals ``post_ea`` on the gathered rows.

The per-pair route is written out here as it ran before the table."""

import importlib

import numpy as np
import pytest
import torch

from dna_ldpc_tpu_torch.ops.msa import pairhmm, pairhmm_cuda
from dna_ldpc_tpu_torch.ops.msa.device_msa import MSA_BUCKETS
from dna_ldpc_tpu_torch.ops.msa.pairhmm import ReadTable, encode_pairs, pack_reads
from dna_ldpc_tpu_torch.utils import profiling
from dna_ldpc_tpu_torch.utils.dna import seqs_to_matrix

t_align = importlib.import_module("dna_ldpc_tpu_torch.ops.msa.align")  # the package re-exports align()

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _read(rng, n: int, alphabet: str = "ACGT") -> str:
    return "".join(rng.choice(list(alphabet), n))


def _clusters(rng, sizes, Lmax: int, alphabet: str = "ACGTNacgtn-"):
    """Clusters of the given sizes, reads of 0..Lmax characters (one of
    exactly Lmax in each), with wildcards and lower case."""
    out = []
    for n in sizes:
        reads = [_read(rng, int(rng.integers(0, Lmax + 1)), alphabet) for _ in range(n - 1)]
        out.append(reads + [_read(rng, Lmax, alphabet)])
    return out


def _bucket_order(clusters):
    """``_align_clusters_device``'s order: buckets ascending, clusters in
    input order within a bucket."""
    by_bucket: dict = {}
    for c, seqs in enumerate(clusters):
        if 2 <= len(seqs) <= MSA_BUCKETS[-1]:
            by_bucket.setdefault(next(b for b in MSA_BUCKETS if b >= len(seqs)), []).append(c)
    return [c for nb in sorted(by_bucket) for c in by_bucket[nb]], by_bucket


def _encode_loop(xs, ys, Lmax):
    """The pair-by-pair packing through a loop over reads, as
    ``encode_pairs`` packed before ``pack_reads``."""
    lx = np.array([len(s) for s in xs], np.int32)
    ly = np.array([len(s) for s in ys], np.int32)
    table = pairhmm._ENCODE_TABLE
    return table[seqs_to_matrix(xs, pad=Lmax)], table[seqs_to_matrix(ys, pad=Lmax)], lx, ly


def _old_pairs(clusters, order):
    """The per-pair pair lists: every pair's two reads and each cluster's
    span of rows."""
    pair_span, xs, ys = {}, [], []
    for c in order:
        seqs = clusters[c]
        lo = len(xs)
        for i, j in t_align.cluster_pairs(len(seqs)):
            xs.append(seqs[i])
            ys.append(seqs[j])
        pair_span[c] = (lo, len(xs))
    return xs, ys, pair_span


def _old_assemble(clusters, batch, nb, pair_span):
    """The per-pair loop of ``msa.assemble``."""
    npair = nb * (nb - 1) // 2
    slot_of = {pair: sl for sl, pair in enumerate(t_align.cluster_pairs(nb))}
    ids = np.zeros(len(batch) * npair, np.int64)
    mask = np.zeros(len(batch) * npair, bool)
    inv_n = np.ones(len(batch), np.float32)
    lengths = np.zeros((len(batch), nb), np.int32)
    for bi, c in enumerate(batch):
        n = len(clusters[c])
        inv_n[bi] = 1.0 / n
        lengths[bi, :n] = [len(q) for q in clusters[c]]
        for pi, pair in enumerate(t_align.cluster_pairs(n)):
            sl = bi * npair + slot_of[pair]
            ids[sl] = pair_span[c][0] + pi
            mask[sl] = True
    return ids, mask, inv_n, lengths


def _old_k2(xs, ys, Lmax):
    """The per-pair route: both reads of every pair packed, the twin, the
    posteriors cast to bf16."""
    X, Y, lx, ly = _encode_loop(xs, ys, Lmax)
    post, ea = pairhmm_cuda.post_ea(*(torch.as_tensor(v) for v in (X, Y, lx, ly)), Lmax)
    return post.to(torch.bfloat16), ea.numpy()


@pytest.mark.parametrize("seed,Lmax", [(0, 32), (1, 64), (2, 160)])
def test_table_gathers_back_to_encode_pairs(seed, Lmax):
    rng = np.random.default_rng(seed)
    sizes = [2, 3, 32, 5, 4, 8, 12, 16, 9, 2, 17]
    clusters = _clusters(rng, sizes, Lmax)
    order, _ = _bucket_order(clusters)
    pt = t_align._PairTable(clusters, order, Lmax)
    xs, ys, _ = _old_pairs(clusters, order)
    codes, lengths = pt.table.codes, pt.table.lengths
    assert codes.dtype == np.int8 and lengths.dtype == np.int32 and pt.a.dtype == np.int32
    for X, Y, lx, ly in (encode_pairs(xs, ys, Lmax), _encode_loop(xs, ys, Lmax)):
        np.testing.assert_array_equal(codes[pt.a], X)
        np.testing.assert_array_equal(codes[pt.b], Y)
        np.testing.assert_array_equal(lengths[pt.a], lx)
        np.testing.assert_array_equal(lengths[pt.b], ly)
    # each read of the aligned clusters packed once
    assert len(pt.table) == sum(sizes)
    assert list(pt.table.side(pt.a)) == xs and list(pt.table.side(pt.b)) == ys


def test_pack_reads_codes_and_limits():
    codes, lengths = pack_reads(["ACGTn", "", "acgx", "N-T"], 8)
    np.testing.assert_array_equal(codes, [[0, 1, 2, 3, 4, 4, 4, 4], [4] * 8, [0, 1, 2, 4, 4, 4, 4, 4],
                                          [4, 4, 3, 4, 4, 4, 4, 4]])
    np.testing.assert_array_equal(lengths, [5, 0, 4, 3])
    assert pack_reads(["A" * 8], 8)[1].tolist() == [8]
    with pytest.raises(ValueError, match="Lmax=8"):
        pack_reads(["A", "A" * 9], 8)
    with pytest.raises(ValueError, match="Lmax=32"):
        t_align._PairTable([["A" * 33, "A"]], [0], 32)
    codes, lengths = pack_reads([], 32)
    assert codes.shape == (0, 32) and lengths.shape == (0,)


@pytest.mark.parametrize("kind", ["buckets", "fallback"])
def test_pair_span_is_the_old_loop(kind):
    rng = np.random.default_rng(5)
    sizes = [3, 2, 40, 7, 2, 33, 16, 5] if kind == "fallback" else [1, 3, 2, 32, 7, 0, 2, 16, 5]
    clusters = _clusters(rng, sizes, 40, "ACGT")
    order = [c for c, seqs in enumerate(clusters) if len(seqs) >= 2] if kind == "fallback" else \
        _bucket_order(clusters)[0]
    pt = t_align._PairTable(clusters, order, 64)
    assert pt.span == _old_pairs(clusters, order)[2]


@pytest.mark.parametrize("nb", MSA_BUCKETS)
def test_assemble_is_the_old_loop(nb):
    rng = np.random.default_rng(nb)
    lower = max([b for b in MSA_BUCKETS if b < nb], default=1)
    sizes = [int(rng.integers(lower + 1, nb + 1)) for _ in range(9)] + [nb, lower + 1]
    clusters = _clusters(rng, [2, 3] + sizes, 30, "ACGT")
    order, by_bucket = _bucket_order(clusters)
    pt = t_align._PairTable(clusters, order, 32)
    span = _old_pairs(clusters, order)[2]
    members = by_bucket[nb]
    for batch in (members, members[::-1][:4], members[:1]):
        for got, want in zip(pt.batch(batch, nb), _old_assemble(clusters, batch, nb, span)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_pairs_k2_is_the_per_pair_route():
    """Posteriors and EA scores bit-equal to the per-pair route, with the
    table's rows counted as ``reads`` on ``msa.k2``."""
    rng = np.random.default_rng(11)
    clusters = _clusters(rng, [2, 4, 3], 30, "ACGTN")
    clusters.append([_read(rng, 28) for _ in range(2)])
    order = [3, 0, 2, 1]
    with profiling.span("trial", root=True):
        posts, ea, pt = t_align._pairs_k2(clusters, order, 32, CPU, {})
    record = profiling.recent_trials()[-1]
    xs, ys, span = _old_pairs(clusters, order)
    want_posts, want_ea = _old_k2(xs, ys, 32)
    assert posts.dtype == torch.bfloat16 and torch.equal(posts, want_posts)
    np.testing.assert_array_equal(ea, want_ea)
    assert pt.span == span
    (k2,) = [s for s in record if s["name"] == "msa.k2"]
    assert k2["counts"] == {"reads": 11, "launches": 1, "pairs": len(xs)}
    with profiling.span("trial", root=True):
        assert t_align._pairs_k2(clusters, [], 32, CPU, {})[:2] == (None, None)


def test_k2_posteriors_lists_take_a_table_of_both_sides(monkeypatch):
    """Lists of reads: a table of x's reads then y's (``reads`` = 2P), in
    chunks of BUDGET_BYTES, the per-pair route's values."""
    rng = np.random.default_rng(4)
    xs = [_read(rng, int(rng.integers(0, 33)), "ACGTN") for _ in range(7)]
    ys = [x[: len(x) - 2] + _read(rng, 2) for x in xs]
    per_pair = pairhmm_cuda.kernel_layout(32)["fm_stride"] * 4 + 32 * 32 * 6
    monkeypatch.setattr(pairhmm, "BUDGET_BYTES", 3 * per_pair)  # chunks of 3, 3, 1
    with profiling.span("trial", root=True):
        posts, ea = pairhmm.k2_posteriors(xs, ys, 32, CPU)
    counts = profiling.recent_trials()[-1][0]["counts"]
    assert counts == {"reads": 14, "launches": 3, "pairs": 7}
    want_posts, want_ea = _old_k2(xs, ys, 32)
    assert torch.equal(posts, want_posts)
    np.testing.assert_array_equal(ea, want_ea)
    posts, ea = pairhmm.k2_posteriors([], [], 32, CPU)
    assert posts.shape == (0, 32, 32) and ea.shape == (0,)


def test_table_sides():
    table = ReadTable(["AC", "G", "TTT"], 32)
    side = table.side([2, 0, 0])
    assert len(side) == 3 and side[0] == "TTT" and side[-1] == "AC" and list(side) == ["TTT", "AC", "AC"]
    assert list(side[1:]) == ["AC", "AC"] and side[np.int64(0)] == "TTT"
    assert not table.side([])
    with pytest.raises(IndexError):
        table.side([3])
    with pytest.raises(IndexError):
        side[3]
    # a side of a table of another width is packed again
    got, a, b = pairhmm._pair_rows(side, table.side([1, 1, 2]), 64)
    assert got is not table and got.codes.shape == (6, 64) and a.tolist() == [0, 1, 2] and b.tolist() == [3, 4, 5]


def test_post_ea_by_index_is_post_ea_on_the_gathered_rows():
    rng = np.random.default_rng(2)
    reads = [_read(rng, int(rng.integers(0, 33)), "ACGTN") for _ in range(6)]
    codes, lengths = (torch.as_tensor(v) for v in pack_reads(reads, 32))
    a = torch.tensor([0, 5, 3, 3, 1], dtype=torch.int32)
    b = torch.tensor([1, 2, 3, 4, 0], dtype=torch.int32)
    want = pairhmm_cuda.post_ea(codes[a.long()], codes[b.long()], lengths[a.long()], lengths[b.long()], 32)
    got = pairhmm_cuda.post_ea(codes, codes, lengths, lengths, 32, a, b)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    post, ea = torch.full((5, 32, 32), 7.0), torch.full((5,), 7.0)
    out = pairhmm_cuda.post_ea(codes, codes, lengths, lengths, 32, a, b, post, ea)
    assert out[0] is post and out[1] is ea and torch.equal(post, want[0]) and torch.equal(ea, want[1])
    with pytest.raises(ValueError, match="both"):
        pairhmm_cuda.post_ea(codes, codes, lengths, lengths, 32, a)
    with pytest.raises(ValueError, match="float32"):
        pairhmm_cuda.post_ea(codes, codes, lengths, lengths, 32, a, b, post[:4])
    with pytest.raises(ValueError, match="lengths"):
        pairhmm_cuda.post_ea(codes, codes, lengths[:5], lengths, 32, a, b)
