"""The port's decoder zoo against the JAX package's, on the same numpy
inputs: min-sum (offset, normalization), quantized min-sum (three
quantizers), Gallager A/B/majority, BEC peeling, threshold and LUT FAID,
``bp_trace``, ``bp_posteriors``, ``product_decode`` and the channel
transforms. Decoders must agree exactly (bits, success, iterations,
unsat); posteriors within atol = rtol = 1e-5 on weak LLRs, where no
message saturates at the tanh clip (there f32 rounding differences
between the two packages' exclusive products are amplified without
bound). The min-sum tie bits are passed in explicitly on both sides:
threefry and torch's generators cannot give the same bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dna_ldpc_tpu.models.ldpc_graph import LdpcGraph
from dna_ldpc_tpu.models.mod2 import random_codewords
from dna_ldpc_tpu.models.rs_ldpc import build_rs_ldpc
from dna_ldpc_tpu.ops import bp as j_bp
from dna_ldpc_tpu.ops import channels as j_ch
from dna_ldpc_tpu.ops import decoders as j_dec
from dna_ldpc_tpu.ops import faid as j_faid
from dna_ldpc_tpu.ops import product as j_prod
from dna_ldpc_tpu.ops import trace as j_trace
from dna_ldpc_tpu_torch.models.ldpc_graph import graph_from_reference
from dna_ldpc_tpu_torch.ops import bp as t_bp
from dna_ldpc_tpu_torch.ops import channels as t_ch
from dna_ldpc_tpu_torch.ops import decoders as t_dec
from dna_ldpc_tpu_torch.ops import faid as t_faid
from dna_ldpc_tpu_torch.ops import product as t_prod
from dna_ldpc_tpu_torch.ops import trace as t_trace

from oracle_faid import faid_decode_oracle

# The suite runs in several worker processes that share the cores: one
# intra-op thread per process keeps OpenMP from oversubscribing them.
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def graphs(params):
    H = build_rs_ldpc(*params)
    jg = LdpcGraph.from_sparse(H, detect_blocked=False)
    return H, jg, graph_from_reference(jg)


@pytest.fixture(scope="module")
def code():
    """(4, 8, 4): 64 x 128, dv = 4, dc = 8; 16 random codewords."""
    H, jg, tg = graphs((4, 8, 4))
    cw = random_codewords(H.to_dense(), 16, np.random.default_rng(0))
    return H, jg, tg, cw


def noisy_llr(cw, mean, sd, seed):
    rng = np.random.default_rng(seed)
    return (mean * np.where(cw == 0, 1.0, -1.0) + rng.normal(0, sd, cw.shape)).astype(np.float32)


def assert_same(j, t):
    for name in ("bits", "success", "iterations", "unsat"):
        np.testing.assert_array_equal(np.asarray(getattr(j, name)), getattr(t, name).numpy(), err_msg=name)


@pytest.mark.parametrize("offset,normalize", [(0.0, 1.0), (0.3, 1.0), (0.0, 0.75)])
def test_min_sum_matches_jax(code, offset, normalize):
    H, jg, tg, cw = code
    llr = noisy_llr(cw, 2.0, 1.5, seed=1)
    llr[:, ::13] = 0.0  # zero LLRs take the tie bits
    tie = (np.random.default_rng(2).random(llr.shape) < 0.5).astype(np.uint8)
    j = j_dec._min_sum_jit(jg, 30, offset, normalize)(jnp.asarray(llr), jnp.asarray(tie))
    t = t_dec._min_sum(tg, torch.from_numpy(llr), torch.from_numpy(tie), 30, offset, normalize)
    assert_same(j, t)
    assert 0 < t.success.sum() < len(cw)  # a mix of decoded and failed frames
    # the public entry draws its own tie bits; without zero LLRs they are unused
    llr[:, ::13] = 1.0
    assert_same(j_dec.min_sum_decode(jg, llr, 30, offset, normalize),
                t_dec.min_sum_decode(tg, torch.from_numpy(llr), 30, offset, normalize))


def test_quantizers_match_jax():
    """Exact multiples of step/2 included: both round half to even."""
    x = np.concatenate([np.arange(-12, 13) * 0.25, [0.6, 1.2, 3.0, 6.0, 12.0, 100.0, -100.0]]).astype(np.float32)
    for precision, step in ((5, 0.5), (4, 1.0), (3, 0.25)):
        np.testing.assert_array_equal(
            np.asarray(j_dec.quantize_llr(jnp.asarray(x), precision, step)),
            t_dec.quantize_llr(torch.from_numpy(x), precision, step).numpy())
        np.testing.assert_array_equal(
            np.asarray(j_dec.quantize_llr_quasi_uniform(jnp.asarray(x), precision, step)),
            t_dec.quantize_llr_quasi_uniform(torch.from_numpy(x), precision, step).numpy())
    assert not t_dec.quantize_llr_reference_stub(torch.from_numpy(x)).any()


@pytest.mark.parametrize("quantizer", ["uniform", "quasi-uniform", "reference-quasi-stub"])
def test_quantized_min_sum_matches_jax(code, quantizer):
    H, jg, tg, cw = code
    llr = noisy_llr(cw, 2.5, 2.0, seed=3)
    j = j_dec.quantized_min_sum_decode(jg, llr, precision=5, step=0.5, max_iter=30, offset=1.0, quantizer=quantizer)
    t = t_dec.quantized_min_sum_decode(tg, torch.from_numpy(llr), precision=5, step=0.5, max_iter=30, offset=1.0,
                                       quantizer=quantizer)
    # with the reference stub every level is 0: the initial decisions are
    # the (different) tie bits, then both decide the all-ones word
    assert_same(j, t)
    with pytest.raises(ValueError):
        t_dec.quantized_min_sum_decode(tg, torch.from_numpy(llr), quantizer="nonsense")


@pytest.mark.parametrize("variant", [0, 1, 2])
def test_gallager_matches_jax(code, variant):
    H, jg, tg, cw = code
    rng = np.random.default_rng(4)
    rx = (cw ^ (rng.random(cw.shape) < 0.04)).astype(np.uint8)
    assert_same(j_dec.gallager_decode(jg, rx, 30, variant), t_dec.gallager_decode(tg, torch.from_numpy(rx), 30, variant))


@pytest.mark.parametrize("p", [0.2, 0.45])
def test_bec_peel_matches_jax(code, p):
    H, jg, tg, cw = code
    vals = np.where(np.random.default_rng(5).random(cw.shape) < p, t_ch.ERASE_MARK, cw).astype(np.int8)
    t = t_dec.bec_peel(tg, torch.from_numpy(vals), 50)
    assert_same(j_dec.bec_peel(jg, vals, 50), t)
    known = vals != t_ch.ERASE_MARK
    assert np.array_equal(t.bits.numpy()[known], cw[known])


def test_threshold_faid_matches_jax(code):
    H, jg, tg, cw = code
    rx = (cw ^ (np.random.default_rng(6).random(cw.shape) < 0.06)).astype(np.uint8)
    assert_same(j_faid.faid_decode(jg, rx, 30), t_faid.faid_decode(tg, torch.from_numpy(rx), 30))
    rule = t_faid.FaidRule(levels=(1.0, 3.0), thresholds=(0.5, 3.5), channel_value=1.0, channel_weight=2.0)
    jrule = j_faid.FaidRule(levels=(1.0, 3.0), thresholds=(0.5, 3.5), channel_value=1.0, channel_weight=2.0)
    assert_same(j_faid.faid_decode(jg, rx, 30, jrule), t_faid.faid_decode(tg, torch.from_numpy(rx), 30, rule))


@pytest.mark.parametrize("name", sorted(t_faid.FAID_TABLES))
def test_lut_faid_matches_jax_and_oracle(name):
    H, jg, tg = graphs((4, 8, 3))  # every column of weight 3
    rng = np.random.default_rng(7)
    cw = random_codewords(H.to_dense(), 12, rng)
    rx = (cw ^ (rng.random(cw.shape) < 0.03)).astype(np.uint8)
    assert t_faid.FAID_TABLES[name] == j_faid.FAID_TABLES[name]
    weights = (0.5, 1.0, 1.5, 2.0)[: (len(t_faid.FAID_TABLES[name]) + 1) // 2]
    for wtype, w in ((1, None), (0, weights)):
        jr = j_faid.LutRule(j_faid.FAID_TABLES[name], j_faid.lut_rule(name, wtype).channel_value, w)
        tr = t_faid.LutRule(t_faid.FAID_TABLES[name], t_faid.lut_rule(name, wtype).channel_value, w)
        t = t_faid.faid_decode(tg, torch.from_numpy(rx), 20, tr)
        assert_same(j_faid.faid_decode(jg, rx, 20, jr), t)
        for b in range(3):
            recv = np.where(rx[b] == 0, 1, -1)
            bits, ok, n = faid_decode_oracle(H.to_dense(), recv, 20, tr.table, tr.channel_value, w)
            assert np.array_equal(t.bits[b].numpy(), bits) and bool(t.success[b]) == ok and int(t.iterations[b]) == n
    with pytest.raises(ValueError, match="weight exactly 3"):
        t_faid.faid_decode(graphs((4, 8, 4))[2], torch.from_numpy(rx[:, :128]), 5, t_faid.lut_rule())


def test_bp_trace_matches_jax(code):
    H, jg, tg, cw = code
    llr = noisy_llr(cw, 1.0, 1.0, seed=8)  # weak LLRs: no saturated message in 8 iterations
    j = j_trace.bp_trace(jg, llr, 8)
    t = t_trace.bp_trace(tg, torch.from_numpy(llr), 8)
    np.testing.assert_allclose(t.posteriors.numpy(), np.asarray(j.posteriors), **TOL)
    for name in ("bits", "check_unsat", "unsat"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)
    for b, true in ((0, None), (3, cw[3])):
        assert t_trace.format_word_state(t, b, true) == j_trace.format_word_state(j, b, true)


def test_bp_posteriors_match_jax(code):
    H, jg, tg, cw = code
    llr = noisy_llr(cw, 1.0, 1.0, seed=9)
    for iters in (0, 1, 6):
        np.testing.assert_allclose(t_bp.bp_posteriors(tg, torch.from_numpy(llr), iters).numpy(),
                                   np.asarray(j_bp.bp_posteriors(jg, jnp.asarray(llr), iters)), **TOL)


def test_generic_bp_clip_and_fixed_work_match_jax(code):
    """An explicit clip forces the gather path and sets its tanh clip; the
    fixed-work mode returns the early-stopped results."""
    H, jg, tg, cw = code
    llr = noisy_llr(cw, 2.0, 1.5, seed=10)
    for clip in (None, 1e-3):
        for early_stop in (True, False):
            assert_same(j_bp.bp_decode(jg, jnp.asarray(llr), 25, clip=clip, early_stop=early_stop),
                        t_bp.bp_decode(tg, torch.from_numpy(llr), 25, clip=clip, early_stop=early_stop))
    early = t_bp.decode_llrs(tg, llr, 25, device="cpu")
    fixed = t_bp.decode_llrs(tg, llr, 25, device="cpu", early_stop=False)
    for name in ("bits", "success", "iterations", "unsat"):
        assert torch.equal(getattr(early, name), getattr(fixed, name)), name


def test_product_code_matches_jax():
    H1 = build_rs_ldpc(3, 6, 3)   # 24 x 48
    H2 = build_rs_ldpc(3, 4, 2)   # 16 x 32
    Hp = t_prod.product_pchk(H1, H2)
    jHp = j_prod.product_pchk(H1, H2)
    np.testing.assert_array_equal(Hp.indptr, jHp.indptr)
    np.testing.assert_array_equal(Hp.indices, jHp.indices)
    for a, b in zip(t_prod.split_pchk(Hp, [32 * 24, 48 * 16]), j_prod.split_pchk(Hp, [32 * 24, 48 * 16])):
        np.testing.assert_array_equal(a.indices, b.indices)
    with pytest.raises(ValueError):
        t_prod.split_pchk(Hp, [5])
    g1, g2 = LdpcGraph.from_sparse(H1, detect_blocked=False), LdpcGraph.from_sparse(H2, detect_blocked=False)
    rng = np.random.default_rng(11)
    cw = random_codewords(Hp.to_dense(), 3, rng).reshape(3, 32, 48)
    llr = (1.5 * np.where(cw == 0, 1.0, -1.0) + rng.normal(0, 1.0, cw.shape)).astype(np.float32)
    jb, jok = j_prod.product_decode(g1, g2, llr, outer_iters=2, inner_iters=2)
    tb, tok = t_prod.product_decode(graph_from_reference(g1), graph_from_reference(g2), llr, outer_iters=2,
                                    inner_iters=2, device="cpu")
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tok, jok)


def test_channel_transforms_match_jax():
    rng = np.random.default_rng(12)
    llr = rng.normal(size=(3, 40)).astype(np.float32)
    pos = [0, 7, 39]
    for j_fn, t_fn in ((j_ch.inject_erasures, t_ch.inject_erasures), (j_ch.puncture, t_ch.puncture),
                       (j_ch.shorten, t_ch.shorten)):
        src = torch.from_numpy(llr.copy())
        np.testing.assert_array_equal(t_fn(src, pos).numpy(), np.asarray(j_fn(jnp.asarray(llr), pos)))
        assert torch.equal(src, torch.from_numpy(llr))  # input left as it was
    assert t_ch.SHORTEN_LLR == j_ch.SHORTEN_LLR and t_ch.ERASE_MARK == j_ch.ERASE_MARK
    for db, rate in ((4.25, 16572 / 18432), (2.0, 0.5)):
        assert t_ch.ebno_to_sigma(db, rate) == j_ch.ebno_to_sigma(db, rate)


def test_channel_draws():
    """The draws follow their laws and depend on the generator's seed
    and the batch's shape only, not on the bits."""
    cw = torch.from_numpy(np.random.default_rng(13).integers(0, 2, (64, 500)).astype(np.uint8))
    zeros = torch.zeros_like(cw)
    gen = lambda: torch.Generator().manual_seed(5)
    sigma = 0.8
    llr = t_ch.awgn_llr(gen(), cw, sigma)
    noise = llr * sigma**2 / 2 - (1.0 - 2.0 * cw.float())
    assert abs(noise.std().item() - sigma) < 0.02 and abs(noise.mean().item()) < 0.02
    torch.testing.assert_close(noise, t_ch.awgn_llr(gen(), zeros, sigma) * sigma**2 / 2 - 1.0, atol=1e-5, rtol=0)
    flips = t_ch.bsc_flips(gen(), cw, 0.1) ^ cw
    assert torch.equal(flips, t_ch.bsc_flips(gen(), zeros, 0.1)) and abs(flips.float().mean().item() - 0.1) < 0.01
    bsc = t_ch.bsc_llr(gen(), cw, 0.1)
    assert torch.equal(bsc < 0, (flips ^ cw).bool()) and torch.allclose(bsc.abs(), torch.tensor(np.log(9.0)).float())
    vals = t_ch.bec_values(gen(), cw, 0.3)
    erased = vals == t_ch.ERASE_MARK
    assert vals.dtype == torch.int8 and torch.equal(erased, t_ch.bec_values(gen(), zeros, 0.3) == t_ch.ERASE_MARK)
    assert torch.equal(vals[~erased], cw[~erased].to(torch.int8)) and abs(erased.float().mean().item() - 0.3) < 0.01
