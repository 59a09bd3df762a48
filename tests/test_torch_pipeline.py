"""Trial parity: the port's ``decode_trial`` against the JAX package's on a
fabricated full-size trial (272 codewords of the deployed code, 18,432
strands), and the port's ``anneal_decode`` against the JAX one on the
tiny failing case of tests/test_pipeline_e2e.py. LLR tables are compared
bit for bit (the port's mixed-length clusters through its device MSA, the
JAX package's on the CPU through its host aligner); failure lists,
annealing rounds and decoded bits must be equal."""

import os
import sys

import numpy as np
import pytest

from dna_ldpc_tpu.models import LdpcGraph
from dna_ldpc_tpu.models.rs_ldpc import build_rs_ldpc
from dna_ldpc_tpu.pipeline import decode as j_decode
from dna_ldpc_tpu.pipeline import llr as j_llr
from dna_ldpc_tpu.pipeline.checkpoint import TrialCheckpoint as JCheckpoint
from dna_ldpc_tpu_torch.models import graph_from_reference
from dna_ldpc_tpu_torch.models.blocked import dna_storage_blocked
from dna_ldpc_tpu_torch.ops import bp_cuda
from dna_ldpc_tpu_torch.pipeline import decode as t_decode
from dna_ldpc_tpu_torch.pipeline import llr as t_llr
from dna_ldpc_tpu_torch.pipeline.checkpoint import TrialCheckpoint
from dna_ldpc_tpu_torch.pipeline.simulate import ChannelModel, group_union_codewords, simulate_reads

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_pipeline_e2e import _failing_soft, make_trial_reads  # noqa: E402


@pytest.fixture(scope="module")
def trial():
    """Codewords that satisfy the deployed H, two clean reads per strand,
    30 strands with an extra deletion read (the pre-filter + MSA path) and
    200 reads with one payload substitution (disagreeing votes)."""
    rng = np.random.default_rng(5)
    cws = group_union_codewords(dna_storage_blocked(), 272, rng)
    reads, quals = make_trial_reads(cws, coverage=2, deletion_strands=list(range(0, 3000, 100)))
    reads = list(reads)
    for k in rng.choice(len(reads), 200, replace=False):
        r = list(reads[k])
        p = int(rng.integers(16, len(r)))
        r[p] = "ACGT"[("ACGT".index(r[p]) + 1) % 4]
        reads[k] = "".join(r)
    return cws, reads, quals


def test_rs_filter_matches_jax():
    """Noisy simulated reads: the same reads survive RS-index decoding and
    the codebook, in the same order, with the same strands."""
    from dna_ldpc_tpu_torch.pipeline.simulate import encode_oligos

    oligos = encode_oligos(np.zeros((272, 18432), np.uint8))[:2000]
    reads, quals = simulate_reads(oligos, 6000, ChannelModel(0.03, 0.002, 0.01), seed=1)
    a, b = j_llr.rs_filter_reads(reads, quals), t_llr.rs_filter_reads(reads, quals)
    assert b.payloads == a.payloads
    np.testing.assert_array_equal(b.strands, a.strands)
    np.testing.assert_array_equal(b.quals, a.quals)
    assert (b.n_input, b.n_rs_pass) == (a.n_input, a.n_rs_pass)
    assert 0 < b.n_rs_pass < len(reads)


def test_decode_trial_matches_jax(trial, tmp_path):
    cws, reads, quals = trial
    jp, tp = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    want = j_decode.decode_trial(reads, quals, cws, j_decode.TrialConfig(), checkpoint_path=jp)
    before = bp_cuda.launches
    got = t_decode.decode_trial(reads, quals, cws, t_decode.TrialConfig(device="cpu"), checkpoint_path=tp)
    assert bp_cuda.launches == before  # device "cpu": the plain twins ran
    # the LLR tables the checkpoints carry are bit-equal
    lj, lt = JCheckpoint.load(jp).llr_table, TrialCheckpoint.load(tp).llr_table
    assert lt.dtype == lj.dtype and np.array_equal(lt, lj)
    assert (lt == 0).all(axis=1).sum() < 50 and (lt != np.round(lt)).any()
    assert got.fail_first == want.fail_first and got.fail_final == want.fail_final == []
    assert got.n_anneal_iters == want.n_anneal_iters
    assert got.n_erasure_strands == want.n_erasure_strands
    assert got.n_reads_kept == want.n_reads_kept == len(reads)
    np.testing.assert_array_equal(got.decoded_bits, want.decoded_bits)
    np.testing.assert_array_equal(got.decoded_bits, cws)
    for key in (
        "rs_decode", "llr", "llr_pairhmm", "llr_consistency", "llr_msa_device", "llr_msa_collect",
        "first_decode", "second_decode",
    ):
        assert key in got.phase_times
    # a second run resumes from the checkpoint: ingest and first decode skipped
    again = t_decode.decode_trial(reads, quals, cws, t_decode.TrialConfig(device="cpu"), checkpoint_path=tp)
    assert again.phase_times["llr"] == 0.0 and again.phase_times["first_decode"] == 0.0
    np.testing.assert_array_equal(again.decoded_bits, got.decoded_bits)


@pytest.mark.parametrize("strict", [False, True])
def test_anneal_decode_matches_jax(strict):
    """The tiny failing case: one codeword fails the first decode and the
    annealing loop runs to its floor."""
    jg = LdpcGraph.from_sparse(build_rs_ldpc(4, 8, 4))
    soft = _failing_soft()
    cws = np.zeros((2, 128), np.uint8)
    want = j_decode.anneal_decode(
        jg, soft, cws, j_decode.TrialConfig(strict_reference_failure_tracking=strict)
    )
    got = t_decode.anneal_decode(
        graph_from_reference(jg), soft, cws,
        t_decode.TrialConfig(strict_reference_failure_tracking=strict, device="cpu"),
    )
    assert got[1:] == want[1:]
    assert got[1] == [2] and got[3] >= 1
    np.testing.assert_array_equal(got[0], want[0])


def test_anneal_resume_equivalence():
    """Resuming from a checkpointed (dec, fail, iters) state gives the
    uninterrupted run's result."""
    g = graph_from_reference(LdpcGraph.from_sparse(build_rs_ldpc(4, 8, 4)))
    soft = _failing_soft()
    cws = np.zeros((2, 128), np.uint8)
    states = []
    cfg = t_decode.TrialConfig(device="cpu")
    full = t_decode.anneal_decode(
        g, soft, cws, cfg, save_cb=lambda d, ff, fc, it: states.append((np.array(d), list(ff), list(fc), it))
    )
    assert len(states) == full[3] + 1
    for k in (0, len(states) // 2):
        resumed = t_decode.anneal_decode(g, soft, cws, cfg, resume=states[k])
        assert resumed[1:] == full[1:]
        np.testing.assert_array_equal(resumed[0], full[0])
