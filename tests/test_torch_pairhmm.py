"""Pair-HMM parity: the port's plain twin of K2 (``post_ea_ref``) against
the JAX Pallas kernel ``batch_post_ea_pallas`` run in interpret mode, as
tests/test_pairhmm_pallas.py runs it. Posteriors agree within
atol = rtol = 1e-4 (both sum log-space terms in f32, in the same order,
but through different exp/log implementations); EA scores equal, bit for
bit, the native ``mea_score`` of the bf16-rounded posterior, which UPGMA
tie-breaks depend on."""

import random

import ml_dtypes
import numpy as np
import pytest
import torch

from dna_ldpc_tpu.ops.msa.align import mea_score as j_mea_score
from dna_ldpc_tpu.ops.msa.pairhmm import nucleo_params as j_nucleo_params
from dna_ldpc_tpu.ops.msa.pairhmm_pallas import batch_post_ea_pallas
from dna_ldpc_tpu_torch.ops.msa import pairhmm_cuda
from dna_ldpc_tpu_torch.ops.msa.align import mea_score
from dna_ldpc_tpu_torch.ops.msa.pairhmm import batch_post_ea, encode_pairs, nucleo_params


def _rs(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def _mut(rng, s, k):
    s = list(s)
    for _ in range(k):
        op = rng.randrange(3)
        if op == 0 and s:
            s[rng.randrange(len(s))] = rng.choice("ACGT")
        elif op == 1 and len(s) > 1:
            del s[rng.randrange(len(s))]
        else:
            s.insert(rng.randrange(len(s)), rng.choice("ACGT"))
    return "".join(s)


def _bf16(a):
    return a.astype(ml_dtypes.bfloat16).astype(np.float32)


def _check(xs, ys, Lmax=None):
    post_j, ea_j, lx_j, ly_j, L_j = batch_post_ea_pallas(xs, ys, Lmax, interpret=True)
    post, ea, lx, ly, L = batch_post_ea(xs, ys, Lmax, device="cpu")
    assert L == L_j
    np.testing.assert_array_equal(lx, lx_j[: len(xs)])
    np.testing.assert_array_equal(ly, ly_j[: len(xs)])
    post_j = np.asarray(post_j)[: len(xs), :L, :L]
    post = post.numpy()
    np.testing.assert_allclose(post, post_j, atol=1e-4, rtol=1e-4)
    for p in range(len(xs)):
        q = _bf16(post[p, : lx[p], : ly[p]])
        host = mea_score(q) if q.size else 0.0
        assert np.float32(host) == ea[p], p
        if q.size:
            assert host == j_mea_score(q)
    np.testing.assert_allclose(ea.numpy(), np.asarray(ea_j)[: len(xs)], atol=2e-3)
    return post, ea


def test_model_constants_equal():
    for a, b in zip(j_nucleo_params(), nucleo_params()):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_twin_matches_pallas_random():
    rng = random.Random(99)
    xs, ys = [], []
    for _ in range(6):
        b = _rs(rng, rng.randint(1, 40))
        xs.append(b)
        ys.append(_mut(rng, b, rng.randint(0, 4)))
    # empty, one-sided empty, homopolymer and wildcard pathologies
    xs += ["", "A", "A" * 25, "ACGTN", _rs(rng, 12)]
    ys += [_rs(rng, 3), "", "A" * 30, "ACGTA", _rs(rng, 20)]
    post, ea = _check(xs, ys)
    assert not post[6].any() and ea[6] == 0.0  # empty x: no posterior mass


def test_twin_matches_pallas_trial_lengths():
    """The trial's shape: 136-nt payloads with indels at Lmax = 160."""
    rng = random.Random(3)
    base = _rs(rng, 136)
    xs = [base, _mut(rng, base, 3), _rs(rng, 128)]
    ys = [_mut(rng, base, 4), _mut(rng, base, 2), _rs(rng, 135)]
    _check(xs, ys, Lmax=160)


def test_encode_and_wrapper_checks():
    X, Y, lx, ly = encode_pairs(["ACGTn", ""], ["acgx", "T"], 32)
    assert X.dtype == np.int8 and X.shape == (2, 32)
    np.testing.assert_array_equal(X[0, :6], [0, 1, 2, 3, 4, 4])
    np.testing.assert_array_equal(Y[0, :4], [0, 1, 2, 4])
    np.testing.assert_array_equal(lx, [5, 0])
    np.testing.assert_array_equal(ly, [4, 1])
    with pytest.raises(ValueError):
        encode_pairs(["A" * 40], ["A"], 32)
    t = [torch.as_tensor(a) for a in (X, Y, lx, ly)]
    with pytest.raises(ValueError):
        pairhmm_cuda.post_ea(t[0][:, :16], t[1], t[2], t[3], 32)
    before = pairhmm_cuda.launches
    post, ea = pairhmm_cuda.post_ea(*t, 32)  # CPU tensors: the twin, no launch
    assert post.shape == (2, 32, 32) and pairhmm_cuda.launches == before
