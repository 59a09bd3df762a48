"""The port's host MSA surface and general-table pair-HMM against the JAX
package.

- MEA DP + traceback: the native C++ DP, the port's numpy sweep and the
  JAX package's ``mea_align`` give the same score and path (bit-exact),
  planted ties included.
- Guide trees: ``permute_join_order``, ``joins_to_newick`` and
  ``guide_tree_newick`` equal the JAX package's.
- ``align()``: the native path, the numpy profile path
  (``use_native=False``) and the JAX package's ``align`` give the same
  rows on ``tests/test_msa.py``'s workloads and under each tree
  permutation (the JAX pair-HMM in interpret mode, as its own tests run
  it).
- The general-table posteriors (``_posteriors_device``) equal the JAX
  package's under atol = rtol = 1e-4 for the default and perturbed
  tables, and K2's twin for the default tables; ``pair_fwd_bwd`` /
  ``posterior_from_sweeps`` equal the JAX package's and the scalar oracle.
"""

import importlib
import os
import random
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dna_ldpc_tpu.ops.msa import pairhmm as j_ph
from dna_ldpc_tpu.ops.msa.ensemble import perturb_params as j_perturb
from dna_ldpc_tpu_torch import native_lib
from dna_ldpc_tpu_torch.ops.msa import pairhmm as t_ph
from dna_ldpc_tpu_torch.ops.msa import pairhmm_cuda

# The suite runs in several worker processes that share the cores: one
# intra-op thread per process keeps OpenMP from oversubscribing them.
torch.set_num_threads(1)

# the packages re-export align() under the module's name
j_al = importlib.import_module("dna_ldpc_tpu.ops.msa.align")
t_al = importlib.import_module("dna_ldpc_tpu_torch.ops.msa.align")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from oracle_pairhmm import oracle_posterior  # noqa: E402

PERMS = ("none", "abc", "acb", "bca")


def _rand_seq(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def _mutate(rng, s, subs=0, dels=0, inss=0):
    s = list(s)
    for _ in range(subs):
        s[rng.randrange(len(s))] = rng.choice("ACGT")
    for _ in range(dels):
        del s[rng.randrange(len(s))]
    for _ in range(inss):
        s.insert(rng.randrange(len(s)), rng.choice("ACGT"))
    return "".join(s)


@pytest.mark.parametrize("ties", [False, True])
def test_mea_align_matches_jax_and_native(ties):
    rng = np.random.default_rng(2 + ties)
    for _ in range(12):
        LX, LY = rng.integers(1, 15, 2)
        if ties:  # few values: exact ties between B, X and Y
            post = (rng.integers(0, 3, (LX, LY)) * 0.25).astype(np.float32)
        else:
            post = (rng.random((LX, LY)) * (rng.random((LX, LY)) < 0.3)).astype(np.float32)
        want = j_al.mea_align(post)
        assert native_lib.mea_align_native(post) == want
        assert t_al.mea_align(post) == want
        assert t_al.mea_align(post, use_native=False) == want
        assert t_al.mea_score(post) == t_al.mea_score(post, use_native=False) == j_al.mea_score(post) == want[0]


def test_native_library_is_available():
    assert native_lib.available()


def test_use_native_is_not_a_fallback(monkeypatch):
    """Without the native library ``use_native=True`` raises; the numpy
    path runs on and gives the rows it gave with the library there."""
    seqs = ["ACGTACGTAAGT", "ACGTACGAAGT", "ACGTCGTAAGT", "ACGTACGTAGT"]
    want = t_al.align(seqs, refine_iters=5, device="cpu")

    def unbuilt():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(native_lib, "load", unbuilt)
    assert not native_lib.available()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        t_al.align(seqs, refine_iters=5, device="cpu")
    assert t_al.align(seqs, refine_iters=5, use_native=False, device="cpu") == want


@pytest.mark.parametrize("n", [5, 12, 17])
def test_permute_join_order_matches_jax(n):
    rng = np.random.default_rng(n)
    d = rng.random((n, n))
    d = (d + d.T) / 2
    joins = t_al.upgma_join_order(d)
    assert joins == j_al.upgma_join_order(d)
    for perm in PERMS:
        assert t_al.permute_join_order(joins, perm) == j_al.permute_join_order(joins, perm)
    if n >= 10:  # smaller trees pass through before the name is checked
        with pytest.raises(ValueError):
            t_al.permute_join_order(joins, "xyz")


def test_newick_matches_jax():
    assert t_al.joins_to_newick([(0, 1), (3, 2)], ["a", "b", "c"]) == "((a,b),c);"
    rng = np.random.default_rng(6)
    d = rng.random((9, 9))
    joins = j_al.upgma_join_order((d + d.T) / 2)
    assert t_al.joins_to_newick(joins) == j_al.joins_to_newick(joins)
    labels = [f"r{i}" for i in range(9)]
    assert t_al.joins_to_newick(joins, labels) == j_al.joins_to_newick(joins, labels)


def test_guide_tree_newick_matches_jax(monkeypatch):
    """tests/test_ingest_cluster.py:165's workload."""
    monkeypatch.setenv("DNA_LDPC_PAIRHMM", "pallas")
    rng = np.random.default_rng(4)
    base = "".join(rng.choice(list("ACGT"), 50))
    seqs = [base, base[:25] + "A" + base[26:], "".join(rng.choice(list("ACGT"), 50))]
    nw = t_al.guide_tree_newick(seqs, device="cpu")
    assert nw == j_al.guide_tree_newick(seqs)
    assert "(s0,s1)" in nw or "(s1,s0)" in nw
    assert t_al.guide_tree_newick(seqs[:1], ["x"], device="cpu") == "x;"


def _workloads():
    """tests/test_msa.py:90-132's clusters, and one of 12 reads that the
    tree permutations change."""
    r = random.Random(4)
    base = _rand_seq(r, 136)
    indel = [base] + [
        _mutate(r, base, subs=r.randint(0, 3), dels=r.randint(0, 2), inss=r.randint(0, 1)) for _ in range(4)
    ]
    r5 = random.Random(5)
    b5 = _rand_seq(r5, 50)
    r9 = random.Random(9)
    b9 = _rand_seq(r9, 40)
    twelve = [b9] + [_mutate(r9, b9, subs=r9.randint(0, 3), dels=r9.randint(0, 2)) for _ in range(11)]
    return {
        "identical": (["ACGTACGTAA"] * 3, 5),
        "indel": (indel, 20),
        "two": ([b5, _mutate(r5, b5, dels=2)], 100),
        "twelve": (twelve, 20),
    }


@pytest.mark.parametrize("name", ["identical", "indel", "two"])
def test_align_paths_match_jax(monkeypatch, name):
    monkeypatch.setenv("DNA_LDPC_PAIRHMM", "pallas")
    seqs, iters = _workloads()[name]
    want = j_al.align(seqs, refine_iters=iters)
    assert t_al.align(seqs, refine_iters=iters, device="cpu") == want
    assert t_al.align(seqs, refine_iters=iters, use_native=False, device="cpu") == want
    assert j_al.align(seqs, refine_iters=iters, use_native=False) == want
    assert sorted(r.replace("-", "") for _, r in want) == sorted(seqs)


@pytest.mark.parametrize("perm", PERMS)
def test_align_tree_permutations_match_jax(monkeypatch, perm):
    monkeypatch.setenv("DNA_LDPC_PAIRHMM", "pallas")
    seqs, iters = _workloads()["twelve"]
    want = j_al.align(seqs, refine_iters=iters, tree_perm=perm)
    assert t_al.align(seqs, refine_iters=iters, tree_perm=perm, device="cpu") == want
    assert t_al.align(seqs, refine_iters=iters, tree_perm=perm, use_native=False, device="cpu") == want


def _pairs():
    rng = np.random.default_rng(0)
    xs = ["".join("ACGT"[k] for k in rng.integers(0, 4, rng.integers(3, 30))) for _ in range(7)]
    ys = [x[:5] + x[7:] if len(x) > 8 else x for x in xs]
    ys[0] = "ACGTNNAC"  # wildcards
    xs[6], ys[6] = "", "ACG"  # an empty read
    return xs, ys


@pytest.mark.parametrize("seed", [None, 3, 11])
def test_general_posteriors_match_jax(seed):
    xs, ys = _pairs()
    params = None if seed is None else j_perturb(seed)
    X, Y, Xr, Yr, lxp, lyp, _, _, L = j_ph._encode_batch(xs, ys, None)
    pj, tj = j_ph._posteriors_device(*(jnp.asarray(a) for a in (X, Y, Xr, Yr, lxp, lyp)), L, params)
    enc = t_ph._encode_batch(xs, ys, None)
    assert enc[6] == L
    pt, tt = t_ph._posteriors_device(*(torch.as_tensor(a) for a in enc[:6]), L, params)
    P = len(xs)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj)[:P], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj)[:P], atol=1e-4, rtol=1e-4)
    if seed is None:  # the default tables: K2's twin computes the same posteriors
        pr, _ = pairhmm_cuda.post_ea_ref(*(torch.as_tensor(a) for a in (enc[0], enc[1], enc[4], enc[5])), L)
        torch.testing.assert_close(pt, pr, atol=1e-4, rtol=1e-4)


def test_batch_posteriors_routes(monkeypatch):
    """Default tables: K2's route (its twin on CPU tensors), bf16-rounded;
    other tables: the general path, equal to the JAX package's transport."""
    monkeypatch.setenv("DNA_LDPC_PAIRHMM", "pallas")
    xs, ys = _pairs()
    before = pairhmm_cuda.launches
    got = t_ph.batch_posteriors(xs, ys, device="cpu")
    assert pairhmm_cuda.launches == before
    enc = t_ph._encode_batch(xs, ys, None)
    ref = pairhmm_cuda.post_ea_ref(*(torch.as_tensor(a) for a in (enc[0], enc[1], enc[4], enc[5])), enc[6])[0]
    ref = ref.to(torch.bfloat16).float().numpy()
    for p, (x, y) in enumerate(zip(xs, ys)):
        assert got[p].shape == (len(x), len(y)) and got[p].dtype == np.float32
        np.testing.assert_array_equal(got[p], ref[p, : len(x), : len(y)])
    for want, mine in ((j_ph.batch_posteriors(xs, ys), got),
                       (j_ph.batch_posteriors(xs, ys, params=j_perturb(5)),
                        t_ph.batch_posteriors(xs, ys, params=j_perturb(5), device="cpu"))):
        for a, b in zip(want, mine):
            np.testing.assert_allclose(b, a, atol=1e-2, rtol=1e-2)  # one bf16 step
    assert [p.shape for p in t_ph.pair_posteriors(xs[:2], ys[:2], device="cpu")] == [g.shape for g in got[:2]]


def test_pair_fwd_bwd_matches_jax_and_oracle():
    """tests/test_msa.py:30-42: the full-tensor sweeps and the host
    posterior assembly."""
    rng = random.Random(0)
    xs = [_rand_seq(rng, rng.randint(4, 14)) for _ in range(6)]
    ys = [_rand_seq(rng, rng.randint(4, 14)) for _ in range(6)]
    fwd, w, lx, ly = t_ph.pair_fwd_bwd(xs, ys, device="cpu")
    fj, wj, _, _ = j_ph.pair_fwd_bwd(xs, ys)
    P = len(xs)
    np.testing.assert_allclose(fwd, fj[:, :P], rtol=1e-5, atol=0)
    np.testing.assert_allclose(w, wj[:, :P], rtol=1e-5, atol=0)
    for p in range(P):
        mp, mt = t_ph.posterior_from_sweeps(fwd, w, int(lx[p]), int(ly[p]), p)
        jp, jt = j_ph.posterior_from_sweeps(fj, wj, int(lx[p]), int(ly[p]), p)
        np.testing.assert_allclose(mp, jp, atol=1e-4, rtol=1e-4)
        assert abs(mt - jt) < 1e-4
        op, ot = oracle_posterior(xs[p], ys[p])
        assert abs(mt - ot) < 1e-3
        np.testing.assert_allclose(mp, op, atol=2e-4)


def test_encode_seq_and_tables_match_jax():
    for s in ("ACGTacgt", "NNA-x", ""):
        np.testing.assert_array_equal(t_ph.encode_seq(s), j_ph.encode_seq(s))
    trans6 = t_ph.nucleo_params()[1]
    np.testing.assert_array_equal(t_ph._reverse_trans_table(trans6), j_ph._trans_reversed())
