"""Twins of tests/test_msa_ensemble.py: the port's ensemble machinery
(``ops/msa/ensemble.py``) against the JAX package's on the same inputs.

``perturb_params`` draws from numpy's ``default_rng(seed)`` in both
packages and must be bit-equal. Replicates must be equal row for row: the
unperturbed replicate through K2's twin (the JAX package's pair-HMM in
interpret mode, as its own tests run it), the perturbed ones through the
general-table path of each package, rounded through bf16. CC values and
qscores are computed by the same numpy code and must be equal; EFA files
written by one package read back in the other."""

import numpy as np
import pytest
import torch

from dna_ldpc_tpu.ops.msa import ensemble as j_ens
from dna_ldpc_tpu.ops.msa.align import align as j_align
from dna_ldpc_tpu.ops.msa.align import permute_join_order as j_permute
from dna_ldpc_tpu.ops.msa.align import upgma_join_order as j_upgma
from dna_ldpc_tpu_torch.ops.msa import ensemble as t_ens
from dna_ldpc_tpu_torch.ops.msa.align import align as t_align
from dna_ldpc_tpu_torch.ops.msa.align import permute_join_order as t_permute
from dna_ldpc_tpu_torch.ops.msa.pairhmm import LOG_ZERO, nucleo_params

# The suite runs in several worker processes that share the cores: one
# intra-op thread per process keeps OpenMP from oversubscribing them.
torch.set_num_threads(1)

SEQS = [
    "ACGTACGTACGGTACA",
    "ACGTACTACGGTACA",     # one deletion
    "ACGTACGTACGGTTACA",   # one insertion
    "ACGTACGTACAGTACA",    # one substitution
]


def _ten_reads():
    """Ten reads of one 28-nt strand (one length bucket, Lmax 32): enough
    leaves for the guide-tree permutations of the diversified mode."""
    rng = np.random.default_rng(8)
    base = rng.integers(0, 4, 28)
    out = []
    for _ in range(10):
        s = np.delete(base, rng.choice(28, int(rng.integers(0, 3)), replace=False))
        sub = rng.random(len(s)) < 0.05
        s[sub] = (s[sub] + 1) % 4
        out.append("".join("ACGT"[k] for k in s))
    return out


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("DNA_LDPC_PAIRHMM", "pallas")


@pytest.mark.parametrize("seed,delta", [(0, 0.2), (3, 0.3), (17, 0.05)])
def test_perturb_params_preserves_mass_and_support(seed, delta):
    base = nucleo_params()
    pert = t_ens.perturb_params(seed=seed, delta=delta)
    for a, b in zip(pert, j_ens.perturb_params(seed=seed, delta=delta)):
        assert a.dtype == b.dtype and np.array_equal(a, b)  # bit-equal to the JAX package's
    for b, p in zip(base, pert):
        b2, p2 = np.atleast_2d(b), np.atleast_2d(p)
        live = b2 > LOG_ZERO / 2
        assert ((p2 > LOG_ZERO / 2) == live).all()
        for r in range(b2.shape[0]):
            if live[r].any():
                mb, mp = np.exp(b2[r][live[r]]).sum(), np.exp(p2[r][live[r]]).sum()
                assert abs(mb - mp) < 1e-4 * max(mb, 1e-9)


@pytest.mark.parametrize("mode,seqs,replicates", [
    ("perturb", SEQS, 3), ("stratified", SEQS, 3), ("diversified", SEQS, 3), ("diversified", "ten", 4),
])
def test_ensemble_modes_and_cc(mode, seqs, replicates):
    seqs = _ten_reads() if seqs == "ten" else seqs
    ens = t_ens.ensemble_align(seqs, replicates=replicates, mode=mode, refine_iters=10, device="cpu")
    assert ens == j_ens.ensemble_align(seqs, replicates=replicates, mode=mode, refine_iters=10)
    for aln in ens:
        assert sorted(o for o, _ in aln) == list(range(len(seqs)))
        assert len({len(row) for _, row in aln}) == 1
        for o, row in aln:
            assert row.replace("-", "") == seqs[o]
    cc = t_ens.column_confidence(ens)
    np.testing.assert_array_equal(cc, j_ens.column_confidence(ens))
    best, cc2 = t_ens.select_by_cc(ens)
    assert best is ens[int(np.argmax(cc2))]
    with pytest.raises(ValueError):
        t_ens.ensemble_align(seqs, replicates=2, mode="bogus", device="cpu")


def test_qscore_self_and_degraded():
    ref = t_align(SEQS, refine_iters=5, device="cpu")
    assert ref == j_align(SEQS, refine_iters=5)
    assert t_ens.qscore(ref, ref) == {"Q": 1.0, "TC": 1.0}
    width = max(len(s) for s in SEQS) + 2
    straw = [(i, s + "-" * (width - len(s))) for i, s in enumerate(SEQS)]
    scores = t_ens.qscore(straw, ref)
    assert scores == j_ens.qscore(straw, ref) and scores["Q"] < 1.0


def test_permute_join_order_small_tree_unchanged():
    joins = [(0, 1), (2, 3), (4, 5), (6, 7)]  # 5 leaves < 10
    for perm in ("none", "abc", "acb", "bca"):
        assert t_permute(joins, perm) == joins == j_permute(joins, perm)


def test_permute_join_order_valid_and_distinct():
    rng = np.random.default_rng(5)
    n = 12
    d = rng.random((n, n))
    joins = j_upgma((d + d.T) / 2)
    results = {}
    for perm in ("abc", "acb", "bca"):
        pj = t_permute(joins, perm)
        assert pj == j_permute(joins, perm)
        seen = set(range(n))
        for k, (a, b) in enumerate(pj):
            assert a in seen and b in seen and a != b
            seen.add(n + k)
        results[perm] = tuple(pj)
    assert len(set(results.values())) > 1
    with pytest.raises(ValueError):
        t_permute(joins, "xyz")


def test_efa_roundtrip(tmp_path):
    ens = t_ens.ensemble_align(SEQS, replicates=3, mode="stratified", refine_iters=4, device="cpu")
    mine, theirs = tmp_path / "port.efa", tmp_path / "jax.efa"
    t_ens.write_efa(str(mine), ens, names=["a", "b", "c"])
    j_ens.write_efa(str(theirs), ens, names=["a", "b", "c"])
    assert mine.read_text() == theirs.read_text() and mine.read_text().startswith("<a\n")
    for read in (t_ens.read_efa, j_ens.read_efa):
        names, back = read(str(mine))
        assert names == ["a", "b", "c"] and back == [sorted(a) for a in ens]
    bad = tmp_path / "bad.efa"
    bad.write_text(">s0\nACGT\n")
    with pytest.raises(ValueError):
        t_ens.read_efa(str(bad))
