"""Trial parity: the port's ``decode_trial`` against the JAX package's on a
fabricated full-size trial (272 codewords of the deployed code, 18,432
strands), and the port's ``anneal_decode`` against the JAX one on the
tiny failing case of tests/test_pipeline_e2e.py. LLR tables are compared
bit for bit (the port's mixed-length clusters through its device MSA, the
JAX package's on the CPU through its host aligner); failure lists,
annealing rounds and decoded bits must be equal. The per-cluster route
(``aligner=``): ``cluster_llr`` against the literal oracle of
tests/oracle_llr.py and the JAX package on tests/test_llr.py's cases, the
batched route equal to the per-cluster route (with and without the native
count) and to the JAX package's, bit for bit, ``use_native=False`` without
an aligner equal to the native count, and ``decode_trial(aligner=)`` on the
fabricated trial equal to the JAX package's."""

import functools
import os
import random
import sys

import numpy as np
import pytest

from dna_ldpc_tpu.models import LdpcGraph
from dna_ldpc_tpu.models.rs_ldpc import build_rs_ldpc
from dna_ldpc_tpu.pipeline import decode as j_decode
from dna_ldpc_tpu.pipeline import llr as j_llr
from dna_ldpc_tpu.ops.msa import msa_aligner as j_msa_aligner
from dna_ldpc_tpu.pipeline.checkpoint import TrialCheckpoint as JCheckpoint
from dna_ldpc_tpu_torch.models import graph_from_reference
from dna_ldpc_tpu_torch.models.blocked import dna_storage_blocked
from dna_ldpc_tpu_torch.ops import bp_cuda
from dna_ldpc_tpu_torch.ops.msa import msa_aligner, pairhmm_cuda
from dna_ldpc_tpu_torch.pipeline import decode as t_decode
from dna_ldpc_tpu_torch.pipeline import llr as t_llr
from dna_ldpc_tpu_torch.pipeline.checkpoint import TrialCheckpoint
from dna_ldpc_tpu_torch.pipeline.simulate import ChannelModel, group_union_codewords, simulate_reads

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from oracle_llr import oracle_cluster_llr  # noqa: E402
from test_pipeline_e2e import _failing_soft, make_trial_reads  # noqa: E402

EPS = 0.02
CPU_ALIGNER = functools.partial(msa_aligner, device="cpu")


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


def _rand_read(rng, length):
    return "".join(rng.choice("ACGT") for _ in range(length))


def _identity_aligner(seqs):
    """tests/test_llr.py's pretend-MSA: pad/truncate to 136 with gaps,
    output order reversed."""
    return [(i, (s + "-" * 136)[:136]) for i, s in enumerate(seqs)][::-1]


def _misaligned_aligner(seqs):
    return [(i, (s + "-" * 137)[:137]) for i, s in enumerate(seqs)]


def _llr_cases():
    """tests/test_llr.py:49-116's clusters: (reads, quals, aligner)."""
    rng = random.Random(0)
    for _ in range(10):
        k = rng.randint(2, 6)
        base = list(_rand_read(rng, 136))
        reads = []
        for _ in range(k):
            r = list(base)
            for _ in range(rng.randint(0, 8)):
                r[rng.randrange(136)] = rng.choice("ACGT")
            reads.append("".join(r))
        yield reads, [rng.choice([40, 53, 60, 63, 70]) for _ in range(k)], None
    for length in (50, 135, 136, 140):
        for q in (40, 63, 64, 70):
            yield [_rand_read(rng, length)], [q], None
    for _ in range(10):
        k = rng.randint(2, 5)
        base = _rand_read(rng, 136)
        reads = []
        for _ in range(k):
            r = list(base)
            for _ in range(rng.randint(0, 3)):
                del r[rng.randrange(len(r))]
            reads.append("".join(r))
        yield reads, [rng.choice([40, 53, 64, 70]) for _ in range(k)], _identity_aligner
    base = _rand_read(rng, 130)
    for quals in ([70, 70, 70], [40, 64, 70], [40, 40, 40]):
        yield [base, base[:-2], base[:-1] + "A"], quals, _misaligned_aligner
    yield [_rand_read(rng, 136), _rand_read(rng, 100)], [70, 70], _identity_aligner  # erasure
    yield ["A" * 136, "A" * 130], [70, 70], _identity_aligner  # gaps count as one votes
    for q271 in ((52, 70), (53, 63), (53, 62), (70, 70)):
        yield ["A" * 136, "A" * 135 + "C"], list(q271), None


def test_cluster_llr_matches_oracle_and_jax():
    n_erasures = 0
    for reads, quals, aligner in _llr_cases():
        got = t_llr.cluster_llr(list(reads), list(quals), EPS, aligner)
        want = oracle_cluster_llr(list(reads), list(quals), EPS, aligner)
        jax_llr = j_llr.cluster_llr(list(reads), list(quals), EPS, aligner)
        if want is None:
            assert got is None and jax_llr is None
            n_erasures += 1
            continue
        np.testing.assert_allclose(got, np.array(want), rtol=0, atol=1e-12)
        np.testing.assert_array_equal(got, jax_llr)
    assert n_erasures == 1
    with pytest.raises(ValueError, match="requires an aligner"):
        t_llr.cluster_llr(["A" * 136, "A" * 130], [70, 70], EPS, None)


def _mixed_trial(cls):
    """tests/test_llr.py:156-192's 25 strands of 1-4 reads, 60 % mixed."""
    rng = random.Random(7)

    def mutate(s, dels):
        s = list(s)
        for _ in range(dels):
            del s[rng.randrange(len(s))]
        for _ in range(2):
            s[rng.randrange(len(s))] = rng.choice("ACGT")
        return "".join(s)

    payloads, quals, strands = [], [], []
    strand = 0
    for _ in range(25):
        k = rng.randint(1, 4)
        base = _rand_read(rng, 136)
        mixed = rng.random() < 0.6
        for i in range(k):
            payloads.append(base if (i == 0 or not mixed) else mutate(base, rng.randint(0, 2)))
            quals.append(rng.choice([40, 53, 64, 70]))
            strands.append(strand)
        strand += rng.randint(1, 2)
    return cls(payloads=payloads, quals=np.array(quals), strands=np.array(strands),
               n_input=len(payloads), n_rs_pass=len(payloads))


def test_batched_msa_path_matches_per_cluster(monkeypatch):
    """The batched route (device MSA) equals every cluster through
    ``cluster_llr`` + ``align()``, with and without the native count, and
    the JAX package's per-cluster route, bit for bit."""
    monkeypatch.setenv("DNA_LDPC_PAIRHMM", "pallas")
    f_t, f_j = _mixed_trial(t_llr.FilteredReads), _mixed_trial(j_llr.FilteredReads)
    before = pairhmm_cuda.launches
    t_batch = t_llr.compute_trial_llrs(f_t, EPS, device="cpu")
    t_percl = t_llr.compute_trial_llrs(f_t, EPS, aligner=CPU_ALIGNER, batch_msa=False, device="cpu")
    t_python = t_llr.compute_trial_llrs(f_t, EPS, aligner=CPU_ALIGNER, use_native=False, device="cpu")
    assert pairhmm_cuda.launches == before  # device "cpu": K2's twin ran
    j_percl = j_llr.compute_trial_llrs(f_j, EPS, aligner=j_msa_aligner, batch_msa=False)
    assert np.array_equal(t_batch, t_percl)
    assert np.array_equal(t_percl, t_python)
    assert np.array_equal(t_percl, j_percl)
    assert (t_percl != 0).any(axis=1).sum() > 20


def test_use_native_false_without_aligner_counts_every_cluster(monkeypatch):
    """Without the native count and without an aligner, every cluster goes
    through ``cluster_llr`` with ``msa_aligner`` on the given device: single
    reads and all-136 clusters are counted, not erased or aligned, so the
    table equals the native count's. ``timings`` splits the per-cluster
    stages."""
    monkeypatch.setenv("DNA_LDPC_PAIRHMM", "pallas")
    f_t = _mixed_trial(t_llr.FilteredReads)
    n_reads = np.bincount(f_t.strands)
    assert (n_reads == 1).any()  # single-read clusters are in the trial
    native = t_llr.compute_trial_llrs(f_t, EPS, device="cpu")
    timings = {}
    host = t_llr.compute_trial_llrs(f_t, EPS, use_native=False, device="cpu", timings=timings)
    assert np.array_equal(host, native)
    assert set(timings) == {"native_count", "edit_prefilter", "msa", "counting"}
    split = {}
    aligner = functools.partial(msa_aligner, device="cpu", timings=split)
    assert np.array_equal(t_llr.compute_trial_llrs(f_t, EPS, aligner=aligner, batch_msa=False, device="cpu"), native)
    assert set(split) == {"pairhmm", "ea", "consistency", "progressive_refine"}


def test_decode_trial_with_aligner_matches_jax(trial, monkeypatch):
    """The per-cluster route through the whole trial: LLR tables bit-equal
    and the same outcome as the JAX package's ``decode_trial(aligner=)``."""
    monkeypatch.setenv("DNA_LDPC_PAIRHMM", "pallas")
    cws, reads, quals = trial
    tables = {}
    for name, mod in (("jax", j_llr), ("port", t_llr)):
        real = mod.compute_trial_llrs

        def capture(*args, _real=real, _name=name, **kwargs):
            tables[_name] = _real(*args, **kwargs)
            return tables[_name]

        monkeypatch.setattr(j_decode if mod is j_llr else t_decode, "compute_trial_llrs", capture)
    want = j_decode.decode_trial(reads, quals, cws, j_decode.TrialConfig(), aligner=j_msa_aligner)
    got = t_decode.decode_trial(reads, quals, cws, t_decode.TrialConfig(device="cpu"), aligner=CPU_ALIGNER)
    assert np.array_equal(tables["port"], tables["jax"])
    assert got.fail_first == want.fail_first and got.fail_final == want.fail_final == []
    assert got.n_anneal_iters == want.n_anneal_iters
    np.testing.assert_array_equal(got.decoded_bits, cws)
