"""BP parity: the port's fused-decoder twin (``bp_decode_blocked_ref``)
against the JAX Pallas kernel run in interpret mode, and the port's
generic decoder against the JAX generic decoder. Inputs are made with
numpy from a seed and handed to both packages; results must be equal
(success, unsat, iterations; bits wherever decoding succeeded). The CUDA
kernel K1 is held against the twin on the card in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dna_ldpc_tpu.models import BlockedCode, build_rs_ldpc
from dna_ldpc_tpu.models.ldpc_graph import LdpcGraph
from dna_ldpc_tpu.models.mod2 import random_codewords
from dna_ldpc_tpu.ops.bp import decode_llrs as j_decode_llrs
from dna_ldpc_tpu.ops.bp_pallas import bp_decode_blocked_pallas
from dna_ldpc_tpu_torch.models import graph_from_reference
from dna_ldpc_tpu_torch.ops import bp as t_bp
from dna_ldpc_tpu_torch.ops.bp_cuda import bp_decode_blocked, bp_decode_blocked_ref

MAG = np.log(0.98 / 0.02)


def coverage_llrs(H, n, cov_mean, eps, seed):
    """Multi-read coverage LLRs of random codewords (as
    tests/test_trace_pallas.py builds them)."""
    rng = np.random.default_rng(seed)
    cw = random_codewords(H.to_dense(), n, rng)
    cov = rng.poisson(cov_mean, cw.shape)
    errs = rng.binomial(cov, eps)
    llr = ((cov - 2 * errs) * MAG * np.where(cw == 0, 1.0, -1.0)).astype(np.float32)
    return cw, llr


@pytest.fixture(scope="module")
def small():
    H = build_rs_ldpc(4, 12, 4)  # 64 x 192, dv=4 dc=12, q=16
    jgraph = LdpcGraph.from_sparse(H)
    code = BlockedCode.detect(H)
    rng = np.random.default_rng(0)
    cw = random_codewords(H.to_dense(), 24, rng)
    cov = rng.poisson(5.0, cw.shape)
    errs = rng.binomial(cov, 0.02)
    llr = ((cov - 2 * errs) * MAG * np.where(cw == 0, 1.0, -1.0)).astype(np.float32)
    return H, code, graph_from_reference(jgraph), cw, llr


def assert_same(j, t):
    """JAX BpResult vs port BpResult: success/unsat/iterations equal,
    bits equal wherever decoding succeeded."""
    ok = np.asarray(j.success)
    np.testing.assert_array_equal(ok, t.success.cpu().numpy())
    np.testing.assert_array_equal(np.asarray(j.unsat), t.unsat.cpu().numpy())
    np.testing.assert_array_equal(np.asarray(j.iterations), t.iterations.cpu().numpy())
    np.testing.assert_array_equal(np.asarray(j.bits)[ok], t.bits.cpu().numpy()[ok])


def test_blocked_twin_matches_pallas_kernel(small):
    H, code, g, cw, llr = small
    pal = bp_decode_blocked_pallas(code, jnp.asarray(llr), max_iter=50, block_b=8, interpret=True)
    ref = bp_decode_blocked_ref(g.blocked, torch.from_numpy(llr), 50)
    assert_same(pal, ref)
    ok = ref.success.numpy()
    assert ok.all() and (ref.bits.numpy()[ok] == cw[ok]).all()


@pytest.mark.parametrize("cov_mean", [2.0, 1.5])
def test_blocked_twin_matches_pallas_kernel_hard(small, cov_mean):
    """Low coverage: some codewords fail and run to max_iter, so the
    whole message trajectory (not only converged words) must agree."""
    H, code, g, _, _ = small
    _, llr = coverage_llrs(H, 32, cov_mean, 0.05, seed=11)
    pal = bp_decode_blocked_pallas(code, jnp.asarray(llr), max_iter=50, block_b=8, interpret=True)
    ref = bp_decode_blocked_ref(g.blocked, torch.from_numpy(llr), 50)
    assert_same(pal, ref)
    np.testing.assert_array_equal(np.asarray(pal.bits), ref.bits.numpy())


def test_blocked_twin_edge_semantics(small):
    H, code, g, cw, llr = small
    # zero-LLR input: the all-zero decision satisfies H at iteration 0
    z = bp_decode_blocked_ref(g.blocked, torch.zeros((3, 192)), 20)
    assert z.success.all() and (z.iterations == 0).all() and not z.bits.any()
    # batch padding: results independent of the other rows
    p = bp_decode_blocked_ref(g.blocked, torch.from_numpy(llr[:5]), 50)
    full = bp_decode_blocked_ref(g.blocked, torch.from_numpy(llr), 50)
    assert torch.equal(p.bits, full.bits[:5]) and torch.equal(p.iterations, full.iterations[:5])
    # NaN input: NaN -> -1e-30 (bit 1), identical to the Pallas kernel
    bad = llr[:8].copy()
    bad[:, ::17] = np.nan
    pal = bp_decode_blocked_pallas(code, jnp.asarray(bad), max_iter=30, block_b=8, interpret=True)
    ref = bp_decode_blocked_ref(g.blocked, torch.from_numpy(bad), 30)
    assert_same(pal, ref)


def test_bp_decode_routes_blocked_graphs(small):
    H, code, g, cw, llr = small
    a = t_bp.bp_decode(g, torch.from_numpy(llr), 50)
    b = bp_decode_blocked(g.blocked, torch.from_numpy(llr), 50)
    assert torch.equal(a.bits, b.bits) and torch.equal(a.iterations, b.iterations)
    with pytest.raises(ValueError):
        bp_decode_blocked(g.blocked, torch.zeros((2, 100)), 5)


@pytest.mark.parametrize("cov_mean", [5.0, 2.0])
def test_generic_matches_jax(cov_mean):
    H = build_rs_ldpc(4, 12, 4)
    jg = LdpcGraph.from_sparse(H, detect_blocked=False)
    tg = graph_from_reference(jg)
    assert tg.blocked is None
    _, llr = coverage_llrs(H, 24, cov_mean, 0.03, seed=5)
    assert_same(j_decode_llrs(jg, llr, max_iter=40), t_bp.decode_llrs(tg, llr, max_iter=40, device="cpu"))


def test_generic_and_blocked_agree_on_easy_words(small):
    """Both decoders of the port recover the same codewords on clean
    coverage (different arithmetic, same decisions)."""
    H, code, g, cw, llr = small
    gen = t_bp.bp_decode_generic(graph_from_reference(LdpcGraph.from_sparse(H, detect_blocked=False)),
                                 torch.from_numpy(llr), 50)
    blk = bp_decode_blocked_ref(g.blocked, torch.from_numpy(llr), 50)
    assert gen.success.all() and blk.success.all()
    assert torch.equal(gen.bits, blk.bits)
