"""SC-LDPC parity: the port's chain construction, window graphs, shared
peeling step and windowed decoders against the JAX package's, on one
chain carried across with ``chain_from_reference`` and the same numpy
inputs. Every BEC variant is integer-valued and must be bit-exact; the
windowed BP decoders (the f32 gather decoder on each window) must give
the JAX package's bits at 20 iterations on converging LLRs and at 5
iterations on the zoo's noisy ones (the parity contract's limit for f32
gather BP: the two packages' log/exp differ by an ulp and saturated
messages amplify it on frames that fail). The frozen +/-BIG blocks of a
window saturate messages from the first iteration, so where most frames
fail (a channel around +/-2.5 instead of the zoo's +/-6) single bits
already differ at 4-5 iterations; the pipeline is held against the
port's own sliding window there, which it equals exactly. The inputs are
those of tests/test_decoder_zoo.py."""

import numpy as np
import pytest
import torch

from dna_ldpc_tpu.models import build_rs_ldpc as j_build_rs_ldpc
from dna_ldpc_tpu.models.ldpc_graph import LdpcGraph as JGraph
from dna_ldpc_tpu.models.mod2 import random_codewords
from dna_ldpc_tpu.models.scldpc import ScChain as JChain
from dna_ldpc_tpu.models.scldpc import couple as j_couple
from dna_ldpc_tpu.ops import scldpc as j_sc
from dna_ldpc_tpu.utils.io_formats import SparseBinaryMatrix
from dna_ldpc_tpu_torch.models import LdpcGraph, build_rs_ldpc
from dna_ldpc_tpu_torch.models.scldpc import chain_from_reference, couple
from dna_ldpc_tpu_torch.ops import decoders as t_dec
from dna_ldpc_tpu_torch.ops import scldpc as t_sc

torch.set_num_threads(1)

ERASE = 2
GRAPH_FIELDS = ("check_vars", "check_mask", "var_edge_ids", "var_mask", "edge_perm")


@pytest.fixture(scope="module")
def chain():
    """The decoder zoo's chain (tests/test_decoder_zoo.py:22-25): a 24 x 48
    base block, dv=3 dc=6, L=8, w=1 — as both packages hold it."""
    j = j_couple(j_build_rs_ldpc(3, 6, 3), L=8, w=1, seed=1)
    return j, chain_from_reference(j)


def _one_way_chain(L):
    """tests/test_decoder_zoo.py's designed chain that peels only
    right-to-left through an erased x0-run (b_v=2, b_c=1, w=1)."""
    rows, cols = [], []
    for t in range(L + 1):
        if t > 0:
            rows.append(t)
            cols.append(2 * (t - 1))
        if t < L:
            rows += [t, t]
            cols += [2 * t, 2 * t + 1]
    j = JChain(H=SparseBinaryMatrix.from_coo(L + 1, 2 * L, np.array(rows), np.array(cols)), L=L, w=1, b_v=2, b_c=1)
    return j, chain_from_reference(j)


def _one_way_erasures(n_vars, rs, T):
    vals = np.zeros((1, n_vars), np.int8)
    vals[0, 2 * np.arange(rs, T + 1)] = ERASE
    vals[0, 2 * rs + 1] = ERASE
    return vals


def _erased_run(n_vars, blocks, extra=()):
    vals = np.zeros((1, n_vars), np.int8)
    vals[0, [2 * t for t in blocks] + list(extra)] = ERASE
    return vals


def _coupled_erasures(jc, n, p, seed):
    rng = np.random.default_rng(seed)
    vals = random_codewords(jc.H.to_dense(), n, rng).astype(np.int8)
    vals[rng.random(vals.shape) < p] = ERASE
    return vals


def _ra_erasures(jc, seed, p=0.12, n=2):
    rng = np.random.default_rng(seed)
    v = np.zeros((n, jc.n_vars + jc.n_checks), np.int8)
    v[rng.random(v.shape) < p] = ERASE
    return v


def _ra_parity_only(jc):
    v = np.zeros((1, jc.n_vars + jc.n_checks), np.int8)
    v[0, jc.n_vars + 5 : jc.n_vars + 12] = ERASE
    return v


# (variant, chain, values(jax chain), keyword arguments): the runs of
# tests/test_decoder_zoo.py:58-80 and :231-520, then the same variants on
# the coupled chain with random erasures of random codewords
_W3 = dict(W=3, iters=60)
_OC = dict(W=4, eta=2, iters=60)
BEC_CASES = {
    "base_coupled": ("sliding_window_bec", "coupled", lambda c: _coupled_erasures(c, 4, 0.25, 3), _W3),
    "base_one_way": ("sliding_window_bec", 16, lambda c: _one_way_erasures(c.n_vars, 9, 14), _W3),
    "two_stalled_run": ("sliding_window_bec_two", 16, lambda c: _one_way_erasures(c.n_vars, 9, 14), _W3),
    "two_termination_run": ("sliding_window_bec_two", 16, lambda c: _one_way_erasures(c.n_vars, 9, 15), _W3),
    "two_long_run": ("sliding_window_bec_two", 16, lambda c: _one_way_erasures(c.n_vars, 2, 14), _W3),
    "two_cross": ("sliding_window_bec_two_cross", 16, lambda c: _one_way_erasures(c.n_vars, 2, 14), _W3),
    "two_forward_cascade": ("sliding_window_bec_two", 16, lambda c: _erased_run(c.n_vars, range(5, 9), [19]), _W3),
    "two_indi": ("sliding_window_bec_two_indi", 16, lambda c: _erased_run(c.n_vars, range(5, 9), [19]), _W3),
    "target_window": ("sliding_window_bec_target", 16, lambda c: _erased_run(c.n_vars, [1, 12]), _W3),
    "step_eta1": ("sliding_window_bec_step", 16, lambda c: _one_way_erasures(c.n_vars, 9, 14), dict(W=3, eta=1, iters=60)),
    "step_eta3": ("sliding_window_bec_step", 16, lambda c: _one_way_erasures(c.n_vars, 9, 14), dict(W=3, eta=3, iters=60)),
    "save": ("sliding_window_bec_save", 16, lambda c: _one_way_erasures(c.n_vars, 9, 14), _W3),
    "ra_random_0": ("sliding_window_bec_ra", 16, lambda c: _ra_erasures(c, 0), _W3),
    "ra_random_1": ("sliding_window_bec_ra", 16, lambda c: _ra_erasures(c, 1), _W3),
    "ra_parity_only": ("sliding_window_bec_ra", 16, _ra_parity_only, _W3),
    "oc_run": ("sliding_window_bec_oc", 20, lambda c: _erased_run(c.n_vars, range(4, 18)), _OC),
    "oc_local_run": ("sliding_window_bec_oc", 20, lambda c: _erased_run(c.n_vars, range(12, 17)), _OC),
    "oc_batched": ("sliding_window_bec_oc", 20,
                   lambda c: np.concatenate([np.zeros((1, c.n_vars), np.int8), _erased_run(c.n_vars, range(12, 17))]),
                   _OC),
    "save_coupled": ("sliding_window_bec_save", "coupled", lambda c: _coupled_erasures(c, 4, 0.3, 11), _W3),
    "two_coupled": ("sliding_window_bec_two", "coupled", lambda c: _coupled_erasures(c, 4, 0.35, 12), _W3),
    "two_cross_coupled": ("sliding_window_bec_two_cross", "coupled", lambda c: _coupled_erasures(c, 4, 0.35, 13), _W3),
    "two_indi_coupled": ("sliding_window_bec_two_indi", "coupled", lambda c: _coupled_erasures(c, 4, 0.35, 14), _W3),
    "step_coupled": ("sliding_window_bec_step", "coupled", lambda c: _coupled_erasures(c, 4, 0.3, 15),
                     dict(W=3, eta=2, iters=60)),
    "oc_coupled": ("sliding_window_bec_oc", "coupled", lambda c: _coupled_erasures(c, 4, 0.3, 16),
                   dict(W=3, eta=2, iters=60)),
    "ra_coupled": ("sliding_window_bec_ra", "coupled", lambda c: _ra_erasures(c, 17, 0.2, 4), _W3),
    "target_coupled": ("sliding_window_bec_target", "coupled", lambda c: _coupled_erasures(c, 4, 0.3, 18), _W3),
}


def _chains(kind, chain):
    return chain if kind == "coupled" else _one_way_chain(kind)


def _assert_equal_outputs(j_out, t_out):
    if isinstance(j_out, tuple):
        assert len(j_out) == len(t_out)
        for a, b in zip(j_out, t_out):
            _assert_equal_outputs(a, b)
    else:
        a, b = np.asarray(j_out), np.asarray(t_out)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("w", [0, 1, 2])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_couple_equal(w, seed):
    j = j_couple(j_build_rs_ldpc(3, 6, 3), L=5, w=w, seed=seed)
    t = couple(build_rs_ldpc(3, 6, 3), L=5, w=w, seed=seed)
    assert (t.L, t.w, t.b_v, t.b_c, t.n_vars, t.n_checks) == (j.L, j.w, j.b_v, j.b_c, j.n_vars, j.n_checks)
    assert (t.H.n_rows, t.H.n_cols) == (j.H.n_rows, j.H.n_cols)
    np.testing.assert_array_equal(t.H.indptr, j.H.indptr)
    np.testing.assert_array_equal(t.H.indices, j.H.indices)
    assert t.window_slices(2, 3) == j.window_slices(2, 3)
    r = chain_from_reference(j)
    np.testing.assert_array_equal(r.H.to_dense(), j.H.to_dense())


@pytest.mark.parametrize("kind,W", [("coupled", 3), ("coupled", 5), (16, 3), (20, 4)])
def test_window_graph_tables_equal_and_not_blocked(chain, kind, W):
    jc, tc = _chains(kind, chain)
    for jf, tf in ((j_sc._window_graph, t_sc._window_graph), (j_sc._ra_window_graph, t_sc._ra_window_graph)):
        if jc.L < W + jc.w + (tf is t_sc._ra_window_graph):
            continue
        jg, tg = jf(jc, W), tf(tc, W)
        for name in GRAPH_FIELDS:
            np.testing.assert_array_equal(getattr(jg, name), getattr(tg, name), err_msg=name)
        assert jg.blocked is None and tg.blocked is None  # windows take the f32 gather decoder
        assert tf(tc, W) is tg  # built once per chain and width


def test_phase_chain_windows_are_not_blocked():
    """The chain of chip_smoke.py's phase 15: the (3,6)-regular base at
    lifting 64, L = 64, w = 2, windows of W = 6."""
    tc = couple(build_rs_ldpc(6, 6, 3), L=64, w=2, seed=0)
    assert (tc.H.n_rows, tc.H.n_cols) == (12672, 24576)
    g = t_sc._window_graph(tc, 6)
    assert (g.n_checks, g.n_vars, g.dc_max, g.dv_max) == (1152, 3072, 6, 3)
    assert g.blocked is None


@pytest.mark.parametrize("max_iter", [1, 3, 300])
def test_peel_values_equal(chain, max_iter):
    jc, tc = chain
    vals = _coupled_erasures(jc, 6, 0.4, 5)
    jg, tg = JGraph.from_sparse(jc.H), LdpcGraph.from_sparse(tc.H)
    got = t_dec.peel_values(tg, torch.as_tensor(vals), max_iter)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(j_sc._peel_values(jg, vals, max_iter)), got.numpy())
    assert t_sc._peel_values is t_dec.peel_values
    # bec_peel is the same rounds
    res = t_dec.bec_peel(tg, torch.as_tensor(vals), max_iter)
    np.testing.assert_array_equal(res.bits.numpy(), np.where(got.numpy() == ERASE, 0, got.numpy()))


@pytest.mark.parametrize("case", BEC_CASES, ids=str)
def test_bec_variant_bit_exact(chain, case):
    name, kind, make, kw = BEC_CASES[case]
    jc, tc = _chains(kind, chain)
    vals = make(jc)
    j_out = getattr(j_sc, name)(jc, vals.copy(), **kw)
    t_out = getattr(t_sc, name)(tc, vals.copy(), **kw, device="cpu")
    _assert_equal_outputs(j_out, t_out)


@pytest.mark.parametrize("kind", [16, "coupled"])
def test_bec_global_save_and_target_bit_exact(chain, kind):
    jc, tc = _chains(kind, chain)
    vals = _one_way_erasures(jc.n_vars, 9, 14) if kind == 16 else _coupled_erasures(jc, 4, 0.4, 21)
    jg, tg = JGraph.from_sparse(jc.H), LdpcGraph.from_sparse(tc.H)
    sizes = [jc.b_v] * jc.L
    _assert_equal_outputs(j_sc.bec_decode_save(jg, vals.copy(), sizes),
                          t_sc.bec_decode_save(tg, vals.copy(), sizes, device="cpu"))
    for target in ((29, 30), (1, 4), (1, jc.n_vars)):
        _assert_equal_outputs(j_sc.bec_decode_target(jg, vals.copy(), target),
                              t_sc.bec_decode_target(tg, vals.copy(), target, device="cpu"))
    _assert_equal_outputs(j_sc.bec_decode_save(jg, vals.copy(), sizes, max_rounds=3),
                          t_sc.bec_decode_save(tg, vals.copy(), sizes, max_rounds=3, device="cpu"))


def test_ra_extend_equal(chain):
    jc, tc = chain
    a, b = j_sc.ra_extend(jc), t_sc.ra_extend(tc)
    assert (a.n_rows, a.n_cols) == (b.n_rows, b.n_cols)
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)


def _converging_llrs(jc):
    """tests/test_decoder_zoo.py:39-45: multi-read coverage LLRs."""
    rng = np.random.default_rng(2)
    cw = random_codewords(jc.H.to_dense(), 8, rng)
    mag = np.log(0.98 / 0.02)
    cov = rng.poisson(4.0, cw.shape)
    errs = rng.binomial(cov, 0.02)
    return cw, ((cov - 2 * errs) * mag * np.where(cw == 0, 1.0, -1.0)).astype(np.float32)


def _noisy_llrs(jc, n=3, amplitude=6.0):
    """tests/test_decoder_zoo.py:202-205: a Gaussian channel around +/-6."""
    rng = np.random.default_rng(9)
    cw = random_codewords(jc.H.to_dense(), n, rng)
    return cw, (amplitude * np.where(cw == 0, 1.0, -1.0) + rng.normal(0, 2.0, cw.shape)).astype(np.float32)


@pytest.mark.parametrize("llrs,iters", [(_converging_llrs, 20), (_noisy_llrs, 5)], ids=["converging-20", "noisy-5"])
@pytest.mark.parametrize("W", [3, 4])
def test_windowed_bp_bits_equal(chain, llrs, iters, W):
    jc, tc = chain
    cw, llr = llrs(jc)
    j_sw = j_sc.sliding_window_decode(jc, llr, W=W, iters=iters)
    t_sw = t_sc.sliding_window_decode(tc, llr, W=W, iters=iters, device="cpu")
    assert t_sw.dtype == np.uint8
    np.testing.assert_array_equal(j_sw, t_sw)
    np.testing.assert_array_equal(j_sc.pipeline_decode(jc, llr, W=W, iters=iters),
                                  t_sc.pipeline_decode(tc, llr, W=W, iters=iters, device="cpu"))
    # the staged schedule reproduces per-frame sliding-window decoding exactly
    np.testing.assert_array_equal(t_sc.pipeline_decode(tc, llr, W=W, iters=iters, device="cpu"), t_sw)
    if llrs is _converging_llrs:
        np.testing.assert_array_equal(t_sw, cw)  # the window wave recovers every frame


def test_pipeline_frames_fewer_than_positions(chain):
    """Fewer frames than positions, and more: every tick decodes the frames
    in flight only, and each frame's bits equal its own sliding window."""
    jc, tc = chain
    _, llr = _noisy_llrs(jc, 11, amplitude=2.5)  # most frames fail
    for F in (1, 3, 11):
        sw = t_sc.sliding_window_decode(tc, llr[:F], W=3, iters=5, device="cpu")
        np.testing.assert_array_equal(t_sc.pipeline_decode(tc, llr[:F], W=3, iters=5, device="cpu"), sw)


def test_argument_checks(chain):
    _, tc = chain
    with pytest.raises(ValueError, match="eta"):
        t_sc.sliding_window_bec_step(tc, np.zeros((1, tc.n_vars), np.int8), W=3, eta=4, device="cpu")
    with pytest.raises(ValueError, match="non-overlapping"):
        t_sc.sliding_window_bec_oc(tc, np.zeros((1, tc.n_vars), np.int8), W=4, eta=2, device="cpu")
    with pytest.raises(ValueError, match="systematic then parity"):
        t_sc.sliding_window_bec_ra(tc, np.zeros((1, tc.n_vars), np.int8), W=3, device="cpu")
    with pytest.raises(ValueError, match="too short"):
        t_sc._window_graph(tc, 9)
    with pytest.raises(ValueError, match="block sizes"):
        t_sc.bec_decode_save(LdpcGraph.from_sparse(tc.H), np.zeros((1, tc.n_vars), np.int8), [1], device="cpu")


def _defined_names(module):
    """Functions, classes and constants a module defines (not imports)."""
    return {n for n, v in vars(module).items()
            if (n.isupper() and not callable(v))
            or (callable(v) and getattr(v, "__module__", None) == module.__name__)}


def test_top_level_names_match_the_jax_package():
    """Every name the JAX package's SC-LDPC modules define exists in the
    port, but the jit cache of the peeling step (eager torch has none)."""
    from dna_ldpc_tpu.models import scldpc as j_models
    from dna_ldpc_tpu_torch.models import scldpc as t_models

    for j, t, missing in ((j_models, t_models, set()), (j_sc, t_sc, {"_peel_values_jit"})):
        assert {n for n in _defined_names(j) if not hasattr(t, n)} == missing
