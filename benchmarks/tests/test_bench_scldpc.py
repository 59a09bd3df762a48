"""The SC-LDPC cell on the CPU: the driver on a short chain of the cell's
base block reads ``correct`` true, its control (the plain reference with
bfloat16 messages) false, and each fault of the timed path makes it false;
the ``sc`` readers read the program's call records, and they and the
idle share give None where the program keeps none."""

import importlib.util
import json
import os

import pytest
import torch

from bench_helpers import BENCH_DIR, copy_with_small_cells, run_cell
from benchlib import peaks
from benchlib.records import Records

SMALL_SC = "sc-small"
KIND = "NVIDIA H100 80GB HBM3"
SC_METRICS = ["window_iter_ms.sc", "waits_per_call.sc", "idle_share.sim", "wbp_roofline.sc"]


def add_small_sc_cell(bench: str) -> None:
    """A configuration of the cell's chain cut to 8 positions and a window
    of 5, 32-frame calls, and its cell at Eb/No 3 dB (rate 3/8: about a
    third of the frames fail), added to the copy by files and entries. The
    traffic states the limits of 32 frames: on the CPU, over six seeds, sound
    runs read 0-1 outcomes and frame errors apart from the reference and
    1-4 of 256 window iteration counts, the control 7-15 of each and 35-62;
    an output left at zero 11-13 frame errors, half the batch 4-8."""
    with open(os.path.join(bench, "configs", "sc-rsldpc-3x6-awgn.json")) as f:
        cfg = json.load(f)
    L, w = 8, 2
    cfg["chain"].update(L=L, m=(L + w) * 768, n=L * 1536, edges=L * 768 * 6, rate_num=3, rate_den=8)
    cfg.update(name="small-sc", window=5, batch=32, check={"among_first_calls": 1})
    with open(os.path.join(bench, "configs", "small-sc.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "sc-small.json"), "w") as f:
        json.dump({"channel": "awgn", "ebno_db": 3.0,
                   "limits": {"outcomes_differ": 3, "frame_errors_gap": 3, "iterations_differ": 15}}, f)
    path = os.path.join(os.path.dirname(bench), "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "small-sc", "source": cfg["source"], "file": "benchmarks/configs/small-sc.json",
                            "reduced": ["chain", "window", "batch"], "why": "test"})
    spec["workloads"].append({"name": SMALL_SC, "config": "small-sc", "traffic": "sc-small", "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "sc-awgn-w6" in m.get("workloads", []):
            m["workloads"].append(SMALL_SC)
    with open(path, "w") as f:
        json.dump(spec, f)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    bench = copy_with_small_cells(str(tmp_path_factory.mktemp("bench")))
    add_small_sc_cell(bench)
    return bench


def test_sc_sound_run_is_correct(bench, capsys):
    res = run_cell(bench, SMALL_SC, 2**36 + 1, trace=1, capsys=capsys)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 32
    # no card: no device seconds, no waits on a card, no device metric
    assert res["metrics"] == {"waits_per_call.sc": {"value": 0.0, "unit": "waits/call"}}


def test_sc_control_is_not_correct(bench, capsys):
    res = run_cell(bench, SMALL_SC, 2**36 + 2, capsys=capsys, control=True)
    assert res["control"] and not res["correct"], res["checks"]


def _sc_fault(monkeypatch, fault):
    from dna_ldpc_tpu_torch.ops import bp, scldpc

    if fault == "messages rounded to bfloat16":   # both directions, in the tanh domain, as the control holds them
        def rounded(v2c, check_mask, clip):
            t = torch.tanh(v2c * 0.5).bfloat16().float()
            t = torch.where(check_mask[None], t, torch.ones_like(t))
            te = bp._exclusive_prod(t).clamp(-clip, clip)
            return (torch.log1p(te) - torch.log1p(-te)).bfloat16().float()

        monkeypatch.setattr(bp, "_check_messages", rounded)
        return
    orig = scldpc.sliding_window_decode

    def broken(chain, llr, W=4, iters=20, device="cpu", on_window=None):
        if fault == "state unchanged":        # the channel's hard decisions
            return (llr < 0).to(torch.uint8).cpu().numpy()
        dec = orig(chain, llr, W, iters, device, on_window)
        if fault == "a committed block flipped":
            dec[:, 3 * chain.b_v : 4 * chain.b_v] ^= 1
        elif fault == "decisions all zero":    # the all-zero word sent, so only the failed frames show
            dec[:] = 0
        elif fault == "half the batch returned as zeros":
            dec[: len(dec) // 2] = 0
        return dec

    monkeypatch.setattr(scldpc, "sliding_window_decode", broken)


@pytest.mark.parametrize("fault", ["state unchanged", "a committed block flipped", "messages rounded to bfloat16",
                                   "decisions all zero", "half the batch returned as zeros"])
def test_sc_fault_is_not_correct(bench, capsys, monkeypatch, fault):
    _sc_fault(monkeypatch, fault)
    res = run_cell(bench, SMALL_SC, 2**36 + 3, capsys=capsys)
    assert not res["correct"], (fault, res["checks"])


# -- the readers --------------------------------------------------------------------

def _reader(name):
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _call(device=True):
    """One call's record: the root, two windows of 3 and 2 iterations."""
    def window(iters, live_edges, device_s):
        return {"name": "scldpc.window", "parent": 0, "kind": "device", "start_s": 0.0, "host_s": 0.01,
                "device_s": device_s if device else None,
                "counts": {"windows": 1, "iterations": iters, "edge_iterations": live_edges, "waits": iters + 1}}
    root = {"name": "scldpc.sliding_window", "parent": -1, "kind": "device", "start_s": 0.0, "host_s": 0.05,
            "device_s": None, "counts": {"waits": 1}}
    return [root, window(3, 3_000_000, 0.004), window(2, 1_000_000, 0.002)]


@pytest.fixture
def program(monkeypatch):
    from dna_ldpc_tpu_torch.utils import profiling

    kept = {}
    monkeypatch.setattr(profiling, "recent_records", lambda root: list(kept.get(root, [])))
    return kept


def _rec(n_units, kind=KIND):
    rec = Records(traced=True)
    rec.counters.update(kind=kind, batch=32, window_vars=1000)
    rec.units = [{} for _ in range(n_units)]
    return rec


def test_sc_readers(program):
    program["scldpc.sliding_window"] = [[{"name": "scldpc.sliding_window", "parent": -1, "kind": "device",
                                          "start_s": 0.0, "host_s": 9.0, "device_s": None, "counts": {"waits": 99}}],
                                        _call(), _call()]
    assert _reader("window_iter_ms.sc").read(_rec(2)) == pytest.approx(1e3 * 0.012 / 10)
    assert _reader("waits_per_call.sc").read(_rec(2)) == pytest.approx(8.0)   # the first, older record is not read
    P = peaks.PEAKS[KIND]
    bound = max(2 * 8e6 / peaks.sfu_per_s(P), 5 * 8e6 / P["fp32_flops"], 5 * 4 * 32 * 1000 / P["hbm_bytes_per_s"])
    assert _reader("wbp_roofline.sc").read(_rec(2)) == pytest.approx(100 * bound / 0.012)


def test_sc_rooflines_need_the_cards_seconds(program):
    program["scldpc.sliding_window"] = [_call(device=False)] * 2
    assert _reader("wbp_roofline.sc").read(_rec(2)) is None
    assert _reader("window_iter_ms.sc").read(_rec(2)) is None
    program["scldpc.sliding_window"] = [_call()] * 2
    assert _reader("wbp_roofline.sc").read(_rec(2, kind="cpu")) is None


@pytest.mark.parametrize("name", SC_METRICS)
def test_sc_none_without_the_programs_records(program, monkeypatch, name):
    from dna_ldpc_tpu_torch.utils import profiling

    program["scldpc.sliding_window"] = [_call()]
    assert _reader(name).read(_rec(2)) is None    # fewer records than the window's calls, and no trace
    assert _reader(name).read(_rec(0)) is None    # no call in the window
    monkeypatch.delattr(profiling, "recent_records")
    assert _reader(name).read(_rec(1)) is None    # a program that keeps no record (and no trace)

