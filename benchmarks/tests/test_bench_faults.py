"""Runs of the harness on the CPU with the timed path broken underneath:
each fault a cell can have must make ``correct`` false, and a sound run
must read true. The look for a card is skipped (``device="cpu"``); the
cells are small ones added to a copy of the benchmark by files alone.

The control — the plain reference one precision below the
configuration's in the program's place, ``run.py --control`` — must make
``correct`` false through the same check; at the cells' own sizes it is
read on the card, here at a size a test run holds."""

import dataclasses

import numpy as np
import pytest
import torch

from bench_helpers import SMALL_MSA, SMALL_SIM, SMALL_TRIAL, copy_with_small_cells, run_cell


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return copy_with_small_cells(str(tmp_path_factory.mktemp("bench")))


def test_cells_are_added_by_files_alone(bench):
    """The copy's cells came from new files and new entries: every file the
    benchmark already had is byte for byte the original."""
    import filecmp
    import os

    from bench_helpers import BENCH_DIR

    for root, dirs, files in os.walk(BENCH_DIR):
        dirs[:] = [d for d in dirs if d not in (".cache", "__pycache__", "tests")]
        for name in files:
            path = os.path.join(root, name)
            assert filecmp.cmp(path, os.path.join(bench, os.path.relpath(path, BENCH_DIR)), shallow=False), path


# -- the simulator ---------------------------------------------------------------

def _sim_fault(monkeypatch, fault):
    from dna_ldpc_tpu_torch.ops import simulation

    orig = simulation.bp_decode

    def broken(graph, llr, max_iter):
        res = orig(graph, llr, max_iter=max_iter)
        if fault == "state unchanged":       # the decoder returns its input's decisions
            return dataclasses.replace(res, bits=(llr < 0).to(torch.uint8),
                                       success=torch.zeros_like(res.success), iterations=torch.zeros_like(res.iterations))
        if fault == "half the batch left out":
            half = len(llr) // 2
            bits = res.bits.clone()
            bits[half:] = (llr[half:] < 0).to(torch.uint8)
            success = res.success.clone()
            success[half:] = False
            return dataclasses.replace(res, bits=bits, success=success)
        if fault == "answer altered":         # one decoded frame's bit flipped where it is produced
            bits = res.bits.clone()
            k = int(torch.nonzero(res.success)[0])
            bits[k, 0] ^= 1
            return dataclasses.replace(res, bits=bits)
        raise AssertionError(fault)

    monkeypatch.setattr(simulation, "bp_decode", broken)


def test_sim_sound_run_is_correct(bench, capsys):
    res = run_cell(bench, SMALL_SIM, 2**33 + 1, trace=1, capsys=capsys)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 64 and "idle_share.sim" not in res["metrics"]   # no card, no device metric


@pytest.mark.parametrize("fault", ["state unchanged", "half the batch left out", "answer altered"])
def test_sim_fault_is_not_correct(bench, capsys, monkeypatch, fault):
    _sim_fault(monkeypatch, fault)
    res = run_cell(bench, SMALL_SIM, 2**33 + 2, capsys=capsys)
    assert not res["correct"], (fault, res["checks"])


# -- the trial --------------------------------------------------------------------

def _trial_fault(monkeypatch, fault):
    from dna_ldpc_tpu_torch.pipeline import decode as trial_decode

    if fault == "soft information altered":
        orig_llrs = trial_decode.compute_trial_llrs

        def altered(*args, **kwargs):
            table = orig_llrs(*args, **kwargs)
            table[5, 3] += 1.0
            return table

        monkeypatch.setattr(trial_decode, "compute_trial_llrs", altered)
        return
    orig = trial_decode.anneal_decode

    def broken(graph, soft, codewords, config=None, phase=None, **kwargs):
        dec, ff, fail, n = orig(graph, soft, codewords, config, phase, **kwargs)
        if fault == "state unchanged":
            dec = (soft < 0).astype(np.uint8)
        elif fault == "half the batch left out":
            dec = dec.copy()
            dec[len(dec) // 2:] = (soft[len(dec) // 2:] < 0)
        elif fault == "answer altered":
            dec = dec.copy()
            dec[7, 11] ^= 1
        else:
            raise AssertionError(fault)
        return dec, ff, fail, n

    monkeypatch.setattr(trial_decode, "anneal_decode", broken)


def test_trial_sound_run_is_correct(bench, capsys):
    res = run_cell(bench, SMALL_TRIAL, 2**35 + 1, trace=1, capsys=capsys)
    assert res["correct"], res["checks"]
    assert res["checks"]["counted_rows_differ"]["value"] == 0 and res["attempted"] >= 1
    assert res["metrics"]["bp_s.trial"]["value"] > 0


@pytest.mark.parametrize("fault", ["state unchanged", "half the batch left out", "answer altered",
                                   "soft information altered"])
def test_trial_fault_is_not_correct(bench, capsys, monkeypatch, fault):
    _trial_fault(monkeypatch, fault)
    res = run_cell(bench, SMALL_TRIAL, 2**35 + 2, capsys=capsys)
    assert not res["correct"], (fault, res["checks"])


def test_trial_with_aligned_strands_is_correct(bench, capsys):
    res = run_cell(bench, SMALL_MSA, 2**35 + 3, capsys=capsys)
    assert res["correct"], res["checks"]
    assert "k2_post_maxdiff" in res["checks"]


def test_trial_without_k2_seen_is_not_correct(bench, capsys, monkeypatch):
    """A program whose pair HMM is reached by another route than
    ``ops.msa.align.k2_posteriors`` cannot pass: the cell could not tell a
    lower precision there. The route is moved by leaving the benchmark's
    capture of that call out."""
    from benchlib.records import Records

    capture = Records.capture

    def capture_but_k2(self, module, attr, hook):
        if attr != "k2_posteriors":
            capture(self, module, attr, hook)

    monkeypatch.setattr(Records, "capture", capture_but_k2)
    res = run_cell(bench, SMALL_MSA, 2**35 + 3, capsys=capsys)
    assert not res["correct"] and res["checks"]["k2_post_maxdiff"]["value"] == 1.0, res["checks"]


# -- the control ------------------------------------------------------------------

@pytest.mark.parametrize("cell", [SMALL_SIM, SMALL_MSA])
def test_control_is_not_correct(bench, capsys, cell):
    """The plain reference one precision below the configuration's in the
    program's place (``--control``) fails the unchanged check."""
    res = run_cell(bench, cell, 2**35 + 4, capsys=capsys, control=True)
    assert res["control"] and not res["correct"], res["checks"]
