"""The readers of the program's trial records (``benchlib/spans.py`` and
the five metrics that read it) on synthetic records: the window's trials
are the last ``len(rec.units)``, each metric's arithmetic, and None where
the program keeps no record, where fewer records than trials exist, and
where the card's seconds are missing."""

import importlib.util
import os

import pytest

from bench_helpers import BENCH_DIR
from benchlib import peaks
from benchlib.records import Records

KIND = "NVIDIA H100 80GB HBM3"
P = peaks.PEAKS[KIND]


def _reader(name):
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _span(name, parent, kind="device", host_s=0.0, device_s=None, **counts):
    return {"name": name, "parent": parent, "kind": kind, "start_s": 0.0, "host_s": host_s, "device_s": device_s,
            "counts": counts}


def _trial(scale=1.0, device=True):
    """trial > msa > {msa.pairs (host), msa.k2, msa.batch > {msa.assemble (host), msa.consistency,
    msa.joins (host), msa.device > {msa.masks (host), msa.progressive > 2 merges}}}, and a host
    span outside the MSA."""
    d = (lambda s: s * scale) if device else (lambda s: None)
    return [
        _span("trial", -1, host_s=3.0, waits=1),
        _span("trial.rs_filter", 0, "host", host_s=0.3),
        _span("msa", 0, host_s=2.0),
        _span("msa.pairs", 2, "host", host_s=0.01),
        _span("msa.k2", 2, host_s=0.05, device_s=d(0.04), launches=2, pairs=100, cells=137 * 137 * 100,
              residues=272 * 100, waits=10),
        _span("msa.batch", 2, host_s=1.5),
        _span("msa.assemble", 5, "host", host_s=0.02),
        _span("msa.consistency", 5, host_s=0.6, device_s=d(0.5), clusters=40, flops=2_000_000_000_000,
              bytes=10_000_000, waits=6),
        _span("msa.joins", 5, "host", host_s=0.1),
        _span("msa.device", 5, host_s=0.7, waits=1),
        _span("msa.masks", 9, "host", host_s=0.005),
        _span("msa.progressive", 9, host_s=0.4, merges=2, waits=4),
        _span("msa.merge", 11, host_s=0.001 * scale),
        _span("msa.merge", 11, host_s=0.003 * scale),
    ]


@pytest.fixture
def program(monkeypatch):
    from dna_ldpc_tpu_torch.utils import profiling

    kept = []
    monkeypatch.setattr(profiling, "recent_trials", lambda: list(kept))
    return kept


def _rec(n_units):
    rec = Records(traced=True)
    rec.counters["kind"] = KIND
    rec.units = [{} for _ in range(n_units)]
    return rec


def test_window_is_the_last_trials(program):
    program += [_trial(scale=100.0), _trial(1.0), _trial(2.0)]
    ms = _reader("merge_step_ms.trial").read(_rec(2))
    assert ms == pytest.approx((1 + 3 + 2 + 6) / 4)       # the first, older record is not read
    assert _reader("waits_per_trial.trial").read(_rec(2)) == pytest.approx(22.0)
    assert _reader("msa_host_s.trial").read(_rec(2)) == pytest.approx(0.01 + 0.02 + 0.1 + 0.005)


def test_rooflines(program):
    program += [_trial(1.0), _trial(2.0)]
    interior = 2 * 100 * (137 * 137 - 272 - 1)
    k2_bound = max(37 * interior / peaks.sfu_per_s(P), 108 * interior / P["fp32_flops"],
                   (2 * interior + 2 * 27200) / P["hbm_bytes_per_s"])
    assert _reader("k2_roofline.trial").read(_rec(2)) == pytest.approx(100 * k2_bound / (0.04 * 3))
    cons_bound = max(4e12 / P["fp32_flops"], 2e7 / P["hbm_bytes_per_s"])
    assert _reader("consistency_roofline.trial").read(_rec(2)) == pytest.approx(100 * cons_bound / (0.5 * 3))


@pytest.mark.parametrize("name", ["k2_roofline.trial", "consistency_roofline.trial"])
def test_rooflines_need_the_cards_seconds(program, name):
    program += [_trial(device=False)] * 2
    assert _reader(name).read(_rec(2)) is None
    rec = _rec(2)
    rec.counters["kind"] = "cpu"   # no peaks for the device
    program[:] = [_trial(), _trial()]
    assert _reader(name).read(rec) is None


@pytest.mark.parametrize("name", ["k2_roofline.trial", "consistency_roofline.trial", "msa_host_s.trial",
                                  "merge_step_ms.trial", "waits_per_trial.trial"])
def test_none_without_the_programs_records(program, monkeypatch, name):
    from dna_ldpc_tpu_torch.utils import profiling

    program += [_trial()]
    assert _reader(name).read(_rec(2)) is None    # fewer records than the window's trials
    assert _reader(name).read(_rec(0)) is None    # no trial in the window
    monkeypatch.delattr(profiling, "recent_trials")
    assert _reader(name).read(_rec(1)) is None    # a program that keeps no record
