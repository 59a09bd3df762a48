"""The port's tracer (``utils/profiling.py``) on one small CPU trial.

The trial is tests/test_pipeline_e2e.py's fabricated one (every strand of
the deployed code read twice), with 30 strands given one read with a
deletion (clusters of 3) and 12 strands given three reads with a deletion
or an insertion each (clusters of 5), so that the batched MSA route runs
two buckets. Held here:

- every ``phase_times`` key is the sum of the host seconds of its spans;
- the record is a tree whose children lie inside their parents;
- ``msa.k2``'s pairs and cells equal a count made from the pairs the
  trial gave K2, and ``msa.consistency``'s clusters and FLOPs a count made
  from the aligned clusters' read lengths;
- without a profiler no ``record_function`` range is opened and no span
  has device seconds; under a CPU profiler every span is a
  ``user_annotation`` range of the exported trace, nested as the record
  says;
- the ring keeps the last ``RING`` (4,096) trials;
- an SC-LDPC decode call (``ops/scldpc.py``) closes a record of its own
  root, ``scldpc.sliding_window`` or ``scldpc.pipeline``, with one
  ``scldpc.window`` span per window BP whose ``iterations``,
  ``edge_iterations`` and ``waits`` are those the window's BP ran and
  made, and leaves the trials' ring as it was.
"""

import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from dna_ldpc_tpu_torch.models import build_rs_ldpc
from dna_ldpc_tpu_torch.models.blocked import dna_storage_blocked
from dna_ldpc_tpu_torch.models.scldpc import couple
from dna_ldpc_tpu_torch.ops import bp as t_bp
from dna_ldpc_tpu_torch.ops import scldpc as t_sc
from dna_ldpc_tpu_torch.ops import window_bp
from dna_ldpc_tpu_torch.ops.msa.align import CONSISTENCY_ITERS
from dna_ldpc_tpu_torch.pipeline import decode as t_decode
from dna_ldpc_tpu_torch.pipeline.simulate import group_union_codewords
from dna_ldpc_tpu_torch.utils import profiling

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_pipeline_e2e import make_trial_reads  # noqa: E402

torch.set_num_threads(1)
t_align = importlib.import_module("dna_ldpc_tpu_torch.ops.msa.align")  # the package re-exports align() by that name

# phase_times key -> the spans whose host seconds it sums
PHASE_SPANS = {
    "rs_decode": ("trial.rs_filter",),
    "llr": ("trial.soft_information",),
    "llr_native_count": ("llr.native_count",),
    "llr_edit_prefilter": ("llr.prefilter",),
    "llr_pairhmm": ("msa.pairs", "msa.k2"),
    "llr_consistency": ("msa.assemble", "msa.consistency"),
    "llr_msa_device": ("msa.joins", "msa.device"),
    "llr_msa_collect": ("msa.collect",),
    "llr_counting": ("llr.counting",),
    "first_decode": ("bp.first",),
    "second_decode": ("bp.anneal",),
}


def _small_trial():
    rng = np.random.default_rng(5)
    cws = group_union_codewords(dna_storage_blocked(), 272, rng)
    reads, quals = make_trial_reads(cws, coverage=2, deletion_strands=list(range(0, 3000, 100)))
    for s in range(5000, 5012):
        clean = reads[2 * s]  # make_trial_reads puts a strand's clean reads first, in strand order
        for k, p in enumerate(rng.integers(20, 150, 3)):
            reads.append(clean[:p] + clean[p + 1 :] if k != 1 else clean[:p] + "A" + clean[p:])
            quals.append(chr(70))
    return cws, reads, quals


class _Seen:
    """What the trial gave K2 and the MSA (the module functions wrapped)."""

    def __init__(self, monkeypatch):
        self.k2, self.clusters = [], []
        k2, clusters = t_align.k2_posteriors, t_align.align_clusters

        def seen_k2(xs, ys, Lmax, dev):
            self.k2 += list(zip(xs, ys))
            return k2(xs, ys, Lmax, dev)

        def seen_clusters(cl, *args, **kwargs):
            self.clusters += [list(c) for c in cl]
            return clusters(cl, *args, **kwargs)

        monkeypatch.setattr(t_align, "k2_posteriors", seen_k2)
        monkeypatch.setattr(t_align, "align_clusters", seen_clusters)


def _run(traced: bool, tmp_path=None):
    cws, reads, quals = _small_trial()
    with pytest.MonkeyPatch.context() as mp:
        seen = _Seen(mp)
        if traced:
            with profiling.device_trace(str(tmp_path)):
                res = t_decode.decode_trial(reads, quals, cws, t_decode.TrialConfig(device="cpu"))
        else:
            def no_range(name):
                raise AssertionError(f"a record_function range {name!r} was opened with no profiler recording")

            mp.setattr(torch.autograd.profiler, "record_function", no_range)
            res = t_decode.decode_trial(reads, quals, cws, t_decode.TrialConfig(device="cpu"))
    assert res.fail_final == [] and np.array_equal(res.decoded_bits, cws)
    return res, profiling.recent_trials()[-1], seen


@pytest.fixture(scope="module")
def plain():
    return _run(traced=False)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    out = tmp_path_factory.mktemp("trace")
    res, record, seen = _run(traced=True, tmp_path=out)
    with open(os.path.join(out, profiling.TRACE_FILE)) as f:
        ranges = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return res, record, seen, ranges


def _depth(record, k):
    d, p = 0, record[k]["parent"]
    while p >= 0:
        d, p = d + 1, record[p]["parent"]
    return d


def test_phase_times_are_sums_of_their_spans(plain):
    res, record, _ = plain
    assert record[0]["name"] == "trial" and record[0]["parent"] == -1
    assert set(res.phase_times) == set(PHASE_SPANS)
    for key, names in PHASE_SPANS.items():
        spans = [s["host_s"] for s in record if s["name"] in names]
        assert spans, key
        assert res.phase_times[key] == pytest.approx(sum(spans), rel=1e-12, abs=0), key
    # two buckets (clusters of 3 and of 5), each one batch
    assert [s["name"] for s in record].count("msa.batch") == 2


def test_record_is_a_tree_of_nested_intervals(plain):
    _, record, _ = plain
    for k, s in enumerate(record):
        assert s["host_s"] >= 0 and s["kind"] in (profiling.HOST, profiling.DEVICE)
        p = s["parent"]
        if k == 0:
            assert p == -1
            continue
        assert 0 <= p < k
        parent = record[p]
        assert s["start_s"] >= parent["start_s"]
        assert s["start_s"] + s["host_s"] <= parent["start_s"] + parent["host_s"] + 1e-9
    assert _depth(record, next(k for k, s in enumerate(record) if s["name"] == "msa.merge")) == 6


def test_no_profiler_no_ranges_and_no_device_seconds(plain):
    _, record, _ = plain
    assert all(s["device_s"] is None for s in record)
    # counts that cost more than constant host work are taken only under a profiler
    k2 = [s for s in record if s["name"] == "msa.k2"]
    assert k2 and all("cells" not in s["counts"] for s in k2)
    assert all("flops" not in s["counts"] for s in record)
    # the CPU never makes the host wait on a card
    assert all("waits" not in s["counts"] for s in record)


def test_k2_counts_match_the_pairs_it_was_given(traced):
    _, record, seen, _ = traced
    k2 = [s["counts"] for s in record if s["name"] == "msa.k2"]
    pairs = seen.k2
    assert len(pairs) == 30 * 3 + 12 * 10
    assert sum(c["pairs"] for c in k2) == len(pairs)
    assert sum(c["launches"] for c in k2) == 1
    assert sum(c["cells"] for c in k2) == sum((len(x) + 1) * (len(y) + 1) for x, y in pairs)
    assert sum(c["residues"] for c in k2) == sum(len(x) + len(y) for x, y in pairs)


def test_consistency_flops_match_the_clusters_read_lengths(traced):
    _, record, seen, _ = traced
    cons = [s["counts"] for s in record if s["name"] == "msa.consistency"]
    clusters = [c for c in seen.clusters if len(c) >= 3]
    assert sorted(len(c) for c in clusters) == [3] * 30 + [5] * 12
    flops = nbytes = 0
    for c in clusters:
        L = [len(q) for q in c]
        n = len(L)
        for i in range(n):
            for j in range(i + 1, n):
                nbytes += 2 * 2 * L[i] * L[j]
                for z in range(n):
                    if z not in (i, j):
                        flops += CONSISTENCY_ITERS * 2 * L[i] * L[z] * L[j]
    assert sum(c["clusters"] for c in cons) == len(clusters)
    assert sum(c["flops"] for c in cons) == flops
    assert sum(c["bytes"] for c in cons) == nbytes


def test_trace_holds_every_span_nested_as_recorded(traced):
    _, record, _, ranges = traced
    assert len(ranges) == len(record)
    ranges = sorted(ranges, key=lambda e: (e["ts"], -e["dur"]))
    assert [e["name"] for e in ranges] == [s["name"] for s in record]
    for k, s in enumerate(record[1:], 1):
        outer, inner = ranges[s["parent"]], ranges[k]
        assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    # on the CPU nothing is event-timed
    assert all(s["device_s"] is None for s in record)


def test_ring_keeps_the_last_256_trials():
    for k in range(profiling.RING + 44):
        with profiling.span("trial", root=True):
            profiling.count("k", k)
    trials = profiling.recent_trials()
    assert len(trials) == profiling.RING == 4096
    assert [t[0]["counts"]["k"] for t in trials] == list(range(44, profiling.RING + 44))


def test_spans_nest_within_one_record_and_fill_timings():
    timings = {}
    with profiling.span("outside"):  # no record: only the timings
        with profiling.span("trial", root=True):
            with profiling.span("a", kind=profiling.HOST, timings=timings, key="a"):
                with profiling.span("inner", root=True):  # a record is open: not a second root
                    profiling.count("n", 2)
                    profiling.wait(torch.device("cpu"))
            with profiling.span("a", timings=timings, key="a"):
                profiling.count("n")
    (trial,) = profiling.recent_trials()[-1:]
    assert [(s["name"], s["parent"], s["counts"]) for s in trial] == [
        ("trial", -1, {}), ("a", 0, {}), ("inner", 1, {"n": 2}), ("a", 0, {"n": 1})]
    assert timings["a"] == pytest.approx(trial[1]["host_s"] + trial[3]["host_s"], rel=1e-12, abs=0)


SC_L, SC_W, SC_ITERS, SC_FRAMES = 16, 4, 20, 8


@pytest.mark.parametrize("decoder,root,windows", [("sliding_window_decode", "scldpc.sliding_window", SC_L),
                                                  ("pipeline_decode", "scldpc.pipeline", SC_L + SC_FRAMES - 1)])
def test_sc_decode_closes_a_record_of_its_windows(monkeypatch, decoder, root, windows):
    chain = couple(build_rs_ldpc(4, 6, 3), L=SC_L, w=2, seed=0)
    sigma = 0.7
    gen = torch.Generator().manual_seed(3)
    llr = (2 * (1 + sigma * torch.randn(SC_FRAMES, chain.n_vars, generator=gen)) / sigma**2).numpy()

    def on_a_card(device, n=1):   # the CPU makes no wait: count each where a card would make it
        profiling.count("waits", n)

    def no_range(name):
        raise AssertionError(f"a record_function range {name!r} was opened with no profiler recording")

    seen = []
    decode = window_bp.bp_decode_generic

    def keep(graph, x, max_iter, early_stop=True):
        res = decode(graph, x, max_iter=max_iter, early_stop=early_stop)
        seen.append((graph.n_edges, res.iterations))
        return res

    monkeypatch.setattr(t_bp, "wait", on_a_card)
    monkeypatch.setattr(t_sc, "wait", on_a_card)
    monkeypatch.setattr(window_bp, "bp_decode_generic", keep)   # the CPU's window BP
    monkeypatch.setattr(torch.autograd.profiler, "record_function", no_range)
    trials = profiling.recent_trials()
    getattr(t_sc, decoder)(chain, llr, SC_W, SC_ITERS, device="cpu")
    record = profiling.recent_records(root)[-1]
    assert profiling.recent_trials() == trials == profiling.recent_records("trial")
    assert record[0]["name"] == root and record[0]["parent"] == -1
    assert record[0]["counts"] == {"waits": 2}   # the LLRs' upload, the decisions' download
    spans = record[1:]
    assert len(spans) == len(seen) == windows
    assert all(s["name"] == "scldpc.window" and s["parent"] == 0 and s["device_s"] is None for s in spans)
    for s, (edges, iterations) in zip(spans, seen):
        n = int(iterations.max())
        # one read of the live frames an iteration, and the one that finds none live
        assert s["counts"] == {"windows": 1, "iterations": n, "edge_iterations": int(iterations.sum()) * edges,
                               "waits": n + (n < SC_ITERS)}
    assert 0 < sum(s["counts"]["iterations"] for s in spans) < windows * SC_ITERS
