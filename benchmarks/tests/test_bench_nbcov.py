"""The deep, uneven-coverage trial cell on the CPU: its coverage sampler,
its two readers, and its driver's check.

A small cell is added to a copy of the benchmark by files alone: the
configuration ``park2023-trial-nbcov`` at gamma shape 10 with a check of a
dozen aligned strands and of every large cluster (here of 12 reads and
more: a handful; every such cluster aligns as the reference does at this
size, so the cell's limit on them is 0) in one process, under a traffic of 90,000 reads with a few
deletions (1.9 % of the strands get no read, and the clusters stay within
bucket 32), so that a trial fits a CPU test. A sound run reads ``correct``
true; one large cluster's rows shuffled, or the control (``--control``),
read false."""

import importlib.util
import json
import os

import numpy as np
import pytest

from bench_helpers import BENCH_DIR, REPO, run_cell
from benchlib import common, coverage, recipe
from benchlib.records import Records

SMALL_NB = "trial-small-nb"


def _copy_with_small_nb_cell(tmp: str) -> str:
    import shutil

    bench = os.path.join(tmp, "benchmarks")
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    with open(os.path.join(bench, "configs", "park2023-trial-nbcov.json")) as f:
        cfg = json.load(f)
    cfg.update(name="small-trial-nbcov", coverage=dict(cfg["coverage"], gamma_shape=10),
               check=dict(cfg["check"], k2_pairs=64, msa_clusters=12, msa_workers=1, large_clusters=64,
                          large_min_reads=12), limits=dict(cfg["limits"], large_rows_differ=0))
    with open(os.path.join(bench, "configs", "small-trial-nbcov.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "reads-small-nb.json"), "w") as f:
        json.dump({"reads": 90000, "channel": {"substitution": 0.01, "insertion": 0.0, "deletion": 1e-5,
                                               "q_high": 70, "q_low": 40, "p_low_quality": 0.05}}, f)
    spec["configs"].append({"name": "small-trial-nbcov", "source": cfg["source"],
                            "file": "benchmarks/configs/small-trial-nbcov.json", "reduced": ["check", "coverage"],
                            "why": "test"})
    spec["workloads"].append({"name": SMALL_NB, "config": "small-trial-nbcov", "traffic": "reads-small-nb",
                              "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "trial-160k-nb3" in m.get("workloads", []):
            m["workloads"].append(SMALL_NB)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return bench


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return _copy_with_small_nb_cell(str(tmp_path_factory.mktemp("bench_nb")))


# -- the coverage sampler -----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 2**31 + 17, 2**40 + 5])
def test_picks_are_a_function_of_the_seed(seed):
    a = coverage.negative_binomial_picks(500, 4000, 3, common.stream(seed, "reads-0"))
    b = coverage.negative_binomial_picks(500, 4000, 3, common.stream(seed, "reads-0"))
    c = coverage.negative_binomial_picks(500, 4000, 3, common.stream(seed + 1, "reads-0"))
    assert len(a) == 4000 and a.min() >= 0 and a.max() < 500
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert not np.array_equal(a, np.sort(a))  # the reads come in a random order


def test_channel_reads_are_the_recipes_channel():
    """With every oligo picked once in order, the copy of the channel step
    draws what ``recipe.simulate_reads`` draws once its picks are made: the
    same bases, errors and qualities for the same generator state."""
    pool = recipe.BASES[np.random.default_rng(1).integers(0, 4, (50, 40))]
    channel = recipe.ChannelModel(substitution=0.05, insertion=0.01, deletion=0.02)
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    picks = rng_a.integers(0, len(pool), size=300)
    mine = coverage.channel_reads(pool, picks, channel, rng_a)
    theirs = recipe.simulate_reads(pool, 300, channel, rng_b)
    assert mine == theirs
    assert any(len(r) != 40 for r in mine[0])


# -- the readers -------------------------------------------------------------------

def _reader(name):
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _span(name, parent, host_s, **counts):
    return {"name": name, "parent": parent, "kind": "device", "start_s": 0.0, "host_s": host_s, "device_s": None,
            "counts": counts}


def _trial(fallback_s=None, bucket_counts=True):
    trial = [_span("trial", -1, 10.0), _span("msa", 0, 6.0)]
    for nb, secs in ((8, 0.5), (16, 0.75), (32, 2.0), (64, 1.25)):
        counts = {"bucket": nb, "clusters": 3, "pairs": 9} if bucket_counts else {}
        trial.append(_span("msa.batch", 1, secs, **counts))
    if fallback_s is not None:
        trial.append(_span("msa.fallback", 1, fallback_s, clusters=2, reads=70))
    return trial


@pytest.fixture
def program(monkeypatch):
    from dna_ldpc_tpu_torch.utils import profiling

    kept = []
    monkeypatch.setattr(profiling, "recent_trials", lambda: list(kept))
    return kept


def _rec(n_units):
    rec = Records(traced=True)
    rec.units = [{} for _ in range(n_units)]
    return rec


def test_fallback_and_large_seconds(program):
    program += [_trial(fallback_s=100.0), _trial(fallback_s=4.0), _trial()]
    assert _reader("msa_fallback_s.trial").read(_rec(2)) == pytest.approx(2.0)        # 4 and 0 over the last two
    assert _reader("msa_large_s.trial").read(_rec(2)) == pytest.approx((2.0 + 1.25 + 4.0 + 2.0 + 1.25) / 2)
    assert _reader("msa_fallback_s.trial").read(_rec(1)) == 0.0


def test_large_seconds_need_the_bucket_count(program):
    """A program whose batches do not count their bucket (the parent of
    the change that added the count) reads None; its fallback seconds are
    read all the same."""
    program += [_trial(fallback_s=3.0, bucket_counts=False)] * 2
    assert _reader("msa_large_s.trial").read(_rec(2)) is None
    assert _reader("msa_fallback_s.trial").read(_rec(2)) == pytest.approx(3.0)


@pytest.mark.parametrize("name", ["msa_fallback_s.trial", "msa_large_s.trial"])
def test_none_without_the_programs_records(program, monkeypatch, name):
    from dna_ldpc_tpu_torch.utils import profiling

    program += [_trial(1.0)]
    assert _reader(name).read(_rec(2)) is None    # fewer records than the window's trials
    assert _reader(name).read(_rec(0)) is None    # no trial in the window
    monkeypatch.delattr(profiling, "recent_trials")
    assert _reader(name).read(_rec(1)) is None    # a program that keeps no record


# -- the driver's large clusters -----------------------------------------------------

def _driver(bench_dir):
    with open(os.path.join(bench_dir, "configs", "park2023-trial-nbcov.json")) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", "reads-160k-nb3.json")) as f:
        traffic = json.load(f)
    config["check"]["msa_workers"] = 1
    spec = importlib.util.spec_from_file_location("nbcov_driver", os.path.join(bench_dir, "drivers", "trial_nbcov.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Driver(config, traffic, 5, "cpu", Records(traced=False))


def _cluster(rng, n, length):
    base = rng.integers(0, 4, length)
    out = []
    for _ in range(n):
        s = base.copy()
        sub = rng.random(length) < 0.03
        s[sub] = (s[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        s = np.delete(s, rng.choice(length, int(rng.integers(0, 3)), replace=False))
        out.append("".join("ACGT"[k] for k in s))
    return out


def test_large_rows_read_what_differs():
    """``large_rows_differ`` counts the kept clusters' rows that differ from
    the plain alignment's: 0 for the plain rows themselves, one for each
    row of a cluster whose rows were handed back in another order (past the
    limit), and 1,000,000 where the program's alignment was not seen."""
    from reference import msa_large

    d = _driver(BENCH_DIR)
    assert d.large_rows_differ()["value"] == 1_000_000
    rng = np.random.default_rng(3)
    seqs = [_cluster(rng, n, 40) for n in (34, 12)]
    rows = msa_large.aligned_clusters(seqs, "cpu", "bfloat16")
    d.large = (seqs, [list(r) for r in rows])
    assert d.large_rows_differ() == {"value": 0, "limit": d.limits["large_rows_differ"]}
    rotated = list(rows[0][1:]) + [rows[0][0]]
    moved = sum(a != b for a, b in zip(rotated, rows[0]))
    d.large = (seqs, [rotated, list(rows[1])])
    assert d.large_rows_differ()["value"] == moved > d.limits["large_rows_differ"]


@pytest.mark.parametrize("precision", ["float32", "tfloat32", "bfloat16", "float8_e4m3fn"])
def test_card_rounding_is_the_plain_rounding(precision):
    """``msa_large.rounded`` (torch, on the card in the check) rounds as
    ``msa.rounded`` (numpy) does, bit for bit, small values included."""
    import torch

    from reference import msa, msa_large

    x = np.random.default_rng(4).random(20000).astype(np.float32) ** 4
    got = msa_large.rounded(torch.from_numpy(x.copy()), precision).numpy()
    assert np.array_equal(got.view(np.int32), msa.rounded(x, precision).view(np.int32))


def test_card_reference_aligns_as_the_plain_reference():
    """``msa_large.aligned_clusters`` (the consistency products in torch, a
    block of rows at a time) gives ``msa.align``'s rows (numpy products) on
    clusters of 3, 9 and 21 reads, its transformed pairs within one bf16
    step of ``msa.consistency``'s."""
    import torch

    from reference import msa, msa_large
    from reference import pairhmm as ref_pairhmm

    rng = np.random.default_rng(12)
    seqs = [_cluster(rng, n, 40) for n in (3, 9, 21)]
    got = msa_large.aligned_clusters(seqs, "cpu", "bfloat16")
    for cl, rows in zip(seqs, got):
        pairs = msa.pairs_of(len(cl))
        post = ref_pairhmm.posteriors([cl[i] for i, _ in pairs], [cl[j] for _, j in pairs], "cpu", torch.bfloat16)
        assert rows == msa.align(cl, post, "bfloat16")
        lens = [len(q) for q in cl]
        a = msa.consistency(dict(zip(pairs, post)), lens, "bfloat16")
        b = msa_large.consistency(dict(zip(pairs, post)), lens, "bfloat16", "float32", "cpu")
        for k in pairs:
            np.testing.assert_allclose(b[k], a[k], rtol=2.0 ** -7, atol=0)


def test_sound_run_is_correct(bench, capsys):
    res = run_cell(bench, SMALL_NB, 2**35 + 11, trace=1, capsys=capsys)
    assert res["correct"], res["checks"]
    assert "large_rows_differ" in res["checks"] and "msa_rows_differ" in res["checks"]
    assert res["metrics"]["msa_fallback_s.trial"]["value"] == 0.0
    assert res["metrics"]["msa_large_s.trial"]["value"] >= 0.0


def test_large_clusters_shuffled_are_not_correct(bench, capsys, monkeypatch):
    """A fault planted in the program's alignment: the rows of the largest
    cluster of twelve reads or more whose rows are not all alike (the check
    reads every such cluster here) come back rotated by one read. One
    strand's LLRs move, so the trial still decodes at its first pass."""
    msa_align = importlib.import_module("dna_ldpc_tpu_torch.ops.msa.align")  # the package re-exports align()

    orig = msa_align.align_clusters

    def shuffled(clusters, *args, **kwargs):
        out = orig(clusters, *args, **kwargs)
        mixed = [c for c, seqs in enumerate(clusters) if len(seqs) >= 12 and len({r for _, r in out[c]}) > 1]
        if mixed:
            c = max(mixed, key=lambda c: len(clusters[c]))
            rows = [r for _, r in out[c]]
            out[c] = list(enumerate(rows[1:] + rows[:1]))
        return out

    monkeypatch.setattr(msa_align, "align_clusters", shuffled)
    res = run_cell(bench, SMALL_NB, 2**35 + 11, capsys=capsys)
    assert not res["correct"] and res["checks"]["large_rows_differ"]["value"] > 0, res["checks"]


def test_control_is_not_correct(bench, capsys):
    res = run_cell(bench, SMALL_NB, 2**35 + 12, capsys=capsys, control=True)
    assert res["control"] and not res["correct"], res["checks"]


def test_plain_large_alignment_on_the_cpu_is_torch_free_in_workers():
    """The worker side of ``reference/msa_large.py`` runs without torch
    (``consistency`` imports it only where it runs, in the caller)."""
    import subprocess
    import sys

    code = ("import sys; sys.path[:0] = [{b!r}, {r!r}]; import reference.msa_large; "
            "print('torch' in sys.modules)").format(b=BENCH_DIR, r=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.strip() == "False"
