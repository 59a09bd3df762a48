"""Edit-distance parity: the port's numpy sweep and its torch antidiagonal
DP (``edit_distance_pairs_device``, here on CPU tensors) are bit-identical
to the JAX package's ``edit_distance_pairs`` and device DP and to the
native C++ pass. Distances are integers, so the tolerance is zero."""

import numpy as np
import pytest

from dna_ldpc_tpu.ops.editdist import edit_distance_pairs as j_pairs
from dna_ldpc_tpu.ops.editdist import edit_distance_pairs_device as j_pairs_device
from dna_ldpc_tpu_torch import native_lib
from dna_ldpc_tpu_torch.ops.editdist import edit_distance_pairs, edit_distance_pairs_device
from dna_ldpc_tpu_torch.utils.dna import seqs_to_matrix


def _reads(rng, n, length, max_dels):
    """Copies of a few random strands, each with up to ``max_dels``
    deletions and ~2% substitutions, as in a mixed-length cluster."""
    bases = np.array(list("ACGT"))
    out = []
    strands = [rng.integers(0, 4, length) for _ in range(max(1, n // 4))]
    for k in range(n):
        s = strands[k % len(strands)].copy()
        sub = rng.random(len(s)) < 0.02
        s[sub] = (s[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        dels = rng.choice(len(s), int(rng.integers(0, max_dels + 1)), replace=False)
        out.append("".join(bases[np.delete(s, dels)]))
    return out


def _all_pairs(n):
    a, b = np.triu_indices(n, k=1)
    return a.astype(np.int64), b.astype(np.int64)


@pytest.mark.parametrize("n,length,max_dels,seed", [(12, 136, 3, 0), (20, 40, 8, 1), (9, 7, 6, 2)])
def test_port_matches_jax_and_native(n, length, max_dels, seed):
    rng = np.random.default_rng(seed)
    seqs = _reads(rng, n, length, max_dels)
    mat = seqs_to_matrix(seqs, fill=b"\x00")
    lens = np.array([len(s) for s in seqs], np.int64)
    pa, pb = _all_pairs(n)
    want = j_pairs(mat, lens, pa, pb)
    np.testing.assert_array_equal(edit_distance_pairs(mat, lens, pa, pb), want)
    np.testing.assert_array_equal(edit_distance_pairs_device(mat, lens, pa, pb, "cpu"), want)
    np.testing.assert_array_equal(j_pairs_device(mat, lens, pa, pb, min_pairs=8, min_reads=8), want)
    buf, offs, nat_lens = native_lib.pack_seqs(seqs)
    np.testing.assert_array_equal(native_lib.edit_distance_batch_native(buf, offs, nat_lens, pa, pb), want)


def test_edge_cases():
    """Empty strings, one-character strings, identical and disjoint reads,
    and an empty pair list."""
    seqs = ["", "A", "ACGT", "ACGT", "TTTT", "", "GATTACA", "G"]
    mat = seqs_to_matrix(seqs, fill=b"\x00")
    lens = np.array([len(s) for s in seqs], np.int64)
    pa, pb = _all_pairs(len(seqs))
    want = j_pairs(mat, lens, pa, pb)
    np.testing.assert_array_equal(edit_distance_pairs(mat, lens, pa, pb), want)
    np.testing.assert_array_equal(edit_distance_pairs_device(mat, lens, pa, pb, "cpu"), want)
    assert want[0] == 1 and want[list(zip(pa, pb)).index((2, 3))] == 0
    empty = np.zeros(0, np.int64)
    assert edit_distance_pairs_device(mat, lens, empty, empty, "cpu").shape == (0,)


def test_device_rows_subset():
    """The pre-filter calls the device DP on the reads that appear in some
    pair, re-indexed; distances do not depend on the other rows."""
    rng = np.random.default_rng(3)
    seqs = _reads(rng, 16, 60, 4)
    mat = seqs_to_matrix(seqs, fill=b"\x00")
    lens = np.array([len(s) for s in seqs], np.int64)
    pa = rng.integers(0, 16, 30)
    pb = rng.integers(0, 16, 30)
    want = j_pairs(mat, lens, pa, pb)
    np.testing.assert_array_equal(edit_distance_pairs_device(mat, lens, pa, pb, "cpu"), want)
