"""The port's Monte-Carlo harness (``ops/simulation.py``) against the JAX
package's.

The two packages cannot draw the same noise (threefry against torch's
generators), so the accounting is compared with ``_apply_channel``
patched in both to return the same per-batch channel outputs, on graphs
built with ``detect_blocked=False`` (on a blocked code the port's ``bp``
is the bf16 K1 twin and the JAX package's the f32 exact mode: outcome-
equal, not bit-equal). BP runs five iterations there: a BP frame that
fails runs a chaotic trajectory once its messages saturate, and the two
packages' f32 log/exp, an ulp apart, separate such trajectories within
about ten iterations. Then the port's own draws: error-case save, load
and replay on the CPU, FER falling with SNR, no undetected BEC errors.
Then K1's twin in fixed-work mode against the Pallas kernel in interpret
mode. Last, the read simulator's calibration half (``QualityModel``,
``simulate_trial``) against the JAX package's on fabricated quality files
and without them (numpy in both: equal reads and qualities)."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dna_ldpc_tpu.models.blocked import BlockedCode
from dna_ldpc_tpu.models.ldpc_graph import LdpcGraph
from dna_ldpc_tpu.models.mod2 import random_codewords
from dna_ldpc_tpu.models.rs_ldpc import build_rs_ldpc
from dna_ldpc_tpu.ops import simulation as j_sim
from dna_ldpc_tpu.ops.bp_pallas import bp_decode_blocked_pallas
from dna_ldpc_tpu.pipeline import simulate as j_reads
from dna_ldpc_tpu_torch.models.ldpc_graph import graph_from_reference
from dna_ldpc_tpu_torch.ops import channels as t_ch
from dna_ldpc_tpu_torch.ops import simulation as t_sim
from dna_ldpc_tpu_torch.ops.bp_cuda import bp_decode_blocked_ref
from dna_ldpc_tpu_torch.pipeline import simulate as t_reads

# The suite runs in several worker processes that share the cores: one
# intra-op thread per process keeps OpenMP from oversubscribing them.
torch.set_num_threads(1)

# decoder, channel, points, max_iter: each pair _apply_channel serves
CASES = [
    ("bp", "awgn", [1.0, 3.0], 5),
    ("bp", "bsc", [0.02, 0.06], 5),
    ("min_sum", "awgn", [1.5, 3.5], 20),
    ("quantized_min_sum", "awgn", [1.5, 3.5], 20),
    ("gallager_a", "bsc", [0.01, 0.04], 20),
    ("gallager_b", "bsc", [0.01, 0.04], 20),
    ("faid", "bsc", [0.01, 0.05], 20),
    ("bec", "bec", [0.2, 0.4], 20),
]


@pytest.fixture(scope="module")
def code():
    """(4, 8, 4): 64 x 128; both packages' generic gather tables."""
    H = build_rs_ldpc(4, 8, 4)
    jg = LdpcGraph.from_sparse(H, detect_blocked=False)
    return H, jg, graph_from_reference(jg)


def fake_channel(config, cws: np.ndarray, param: float, rate: float, batch_index: int) -> np.ndarray:
    """Deterministic stand-in for a channel draw, from numpy. AWGN LLRs are
    pushed 0.3 away from 0 so that no level of the quantized min-sum is 0:
    zero levels take random tie bits, which the two packages draw
    differently."""
    rng = np.random.default_rng([int(param * 1000), batch_index])
    hard = config.decoder.startswith("gallager") or config.decoder == "faid"
    if config.channel == "awgn":
        sigma = t_ch.ebno_to_sigma(param, rate)
        llr = 2.0 * (1.0 - 2.0 * cws + sigma * rng.normal(size=cws.shape)) / sigma**2
        return (llr + 0.3 * np.sign(llr)).astype(np.float32)
    flips = rng.random(cws.shape) < param
    if config.channel == "bsc":
        rx = cws.astype(bool) ^ flips
        if hard:
            return rx.astype(np.uint8)
        mag = np.log((1 - param) / param)
        return np.where(rx, -mag, mag).astype(np.float32)
    return np.where(flips, t_ch.ERASE_MARK, cws).astype(np.int8)


def patch_channels(monkeypatch):
    """Both packages' _apply_channel replaced by fake_channel, batch by
    batch in call order per package and point."""
    calls = {}

    def draw(package, config, cws, param, rate):
        k = calls[(package, param)] = calls.get((package, param), -1) + 1
        return fake_channel(config, cws, param, rate, k)

    monkeypatch.setattr(j_sim, "_apply_channel", lambda c, cws, key, p, r: draw("jax", c, np.asarray(cws), p, r))
    monkeypatch.setattr(
        t_sim, "_apply_channel",
        lambda c, cws, gen, p, r: torch.as_tensor(draw("port", c, cws.cpu().numpy(), p, r), device=cws.device),
    )


@pytest.mark.parametrize("decoder,channel,points,max_iter", CASES)
def test_harness_accounting_matches_jax(code, monkeypatch, decoder, channel, points, max_iter):
    H, jg, tg = code
    patch_channels(monkeypatch)
    kw = dict(decoder=decoder, channel=channel, max_iter=max_iter, batch=32, target_frame_errors=40, max_frames=96,
              save_error_cases=5, track_position_ber=True)
    jcfg, tcfg = j_sim.SimConfig(**kw), t_sim.SimConfig(**kw, device="cpu")
    cws = random_codewords(H.to_dense(), 40, np.random.default_rng(1))
    rate = (H.n_cols - H.n_rows) / H.n_cols
    jr = [j_sim.simulate_point(H, jg, cws, p, jcfg, rate) for p in points]
    tr = [t_sim.simulate_point(H, tg, cws, p, tcfg, rate) for p in points]
    for a, b in zip(jr, tr):
        for name in ("param", "frames", "frame_errors", "bit_errors", "undetected_errors", "mean_iters"):
            assert getattr(a, name) == getattr(b, name), name
        np.testing.assert_array_equal(a.position_bit_errors, b.position_bit_errors)
        assert [(c.param, c.slot, c.codeword_idx) for c in a.error_cases] == [
            (c.param, c.slot, c.codeword_idx) for c in b.error_cases]
        a.seconds = b.seconds = 1.25
        for block in (1, 7):
            assert t_sim.format_position_ber(b, block) == j_sim.format_position_ber(a, block)
    assert t_sim.format_report(H, tcfg, tr) == j_sim.format_report(H, jcfg, jr)
    assert sum(r.frame_errors for r in tr) > 0 and sum(r.frames - r.frame_errors for r in tr) > 0


def test_run_simulation_matches_jax(code, monkeypatch):
    """Same codewords (the carried ``random_codewords``), same channel
    outputs: the same points; puncturing and shortening included."""
    H, jg, tg = code
    patch_channels(monkeypatch)

    class Unblocked:  # the JAX package's run_simulation builds its own graph
        from_sparse = staticmethod(lambda H: LdpcGraph.from_sparse(H, detect_blocked=False))

    monkeypatch.setattr(j_sim, "LdpcGraph", Unblocked)
    kw = dict(decoder="bp", channel="awgn", max_iter=5, batch=32, target_frame_errors=20, max_frames=64)
    jr = j_sim.run_simulation(H, [1.0, 2.5], j_sim.SimConfig(**kw), n_codewords=16)
    tr = t_sim.run_simulation(H, [1.0, 2.5], t_sim.SimConfig(**kw, device="cpu"), n_codewords=16, graph=tg)
    assert [(r.frames, r.frame_errors, r.bit_errors, r.mean_iters) for r in jr] == [
        (r.frames, r.frame_errors, r.bit_errors, r.mean_iters) for r in tr]
    # puncture / shorten on the port's own channel (the patch bypasses it)
    monkeypatch.undo()
    cfg = t_sim.SimConfig(puncture_positions=(0, 5), shorten_positions=(9,), batch=4, device="cpu")
    cws = torch.zeros((4, H.n_cols), dtype=torch.uint8)
    rx = t_sim._apply_channel(cfg, cws, t_sim.batch_generator(7, 0, "cpu"), 3.0, 0.5)
    assert (rx[:, [0, 5]] == 0).all() and (rx[:, 9] == t_ch.SHORTEN_LLR).all()


def test_error_cases_save_load_replay(code, tmp_path):
    """A failure saved on the CPU replays bit for bit: the channel output
    of its slot and the decoder's result on it."""
    H, _, tg = code
    cws = random_codewords(H.to_dense(), 40, np.random.default_rng(2))
    rate = (H.n_cols - H.n_rows) / H.n_cols
    for decoder, channel, param in (("bp", "awgn", 1.5), ("gallager_b", "bsc", 0.04), ("bec", "bec", 0.4)):
        cfg = t_sim.SimConfig(decoder=decoder, channel=channel, max_iter=20, batch=24, target_frame_errors=8,
                              max_frames=72, save_error_cases=3, device="cpu")
        r = t_sim.simulate_point(H, tg, cws, param, cfg, rate)
        assert len(r.error_cases) == 3
        path = str(tmp_path / f"{decoder}.json")
        t_sim.save_error_cases(path, [r])
        with open(path) as f:
            recs = json.load(f)
        assert set(recs[0]) == {"param", "key_data", "slot", "codeword_idx", "device"}
        for case in t_sim.load_error_cases(path):
            assert case.device == "cpu" and case.key_data[0] == cfg.seed
            seed, bi = case.key_data
            idx = (bi * cfg.batch + np.arange(cfg.batch)) % len(cws)
            rx_batch = t_sim._apply_channel(cfg, torch.from_numpy(cws[idx]), t_sim.batch_generator(seed, bi, "cpu"),
                                            case.param, rate)
            full = t_sim._decode(cfg, tg, rx_batch)
            res, cw, rx = t_sim.replay_error_case(H, tg, cws, case, cfg)
            np.testing.assert_array_equal(cw, cws[case.codeword_idx])
            np.testing.assert_array_equal(rx, rx_batch[case.slot].numpy())
            # peeling's iteration count is the batch's number of passes
            for name in ("bits", "success", "unsat") + (("iterations",) if decoder != "bec" else ()):
                assert torch.equal(getattr(res, name)[0], getattr(full, name)[case.slot]), name
            assert (res.bits[0].numpy() != cw).any()
        res_short, _, _ = t_sim.replay_error_case(H, tg, cws, case, cfg, max_iter=1)
        assert int(res_short.iterations[0]) <= 1
    with pytest.raises(ValueError, match="drawn on 'cuda'"):
        t_sim.replay_error_case(H, tg, cws, dataclasses.replace(case, device="cuda"), cfg)


def test_fer_falls_with_snr_and_bec_has_no_undetected_errors():
    """The JAX package's own simulation checks, on the port's draws."""
    H = build_rs_ldpc(4, 8, 4)
    cfg = t_sim.SimConfig(decoder="bp", channel="awgn", max_iter=30, batch=64, target_frame_errors=20,
                          max_frames=512, device="cpu")
    lo, hi = t_sim.run_simulation(H, [2.0, 7.0], cfg)
    assert lo.frames > 0 and hi.fer < lo.fer
    report = t_sim.format_report(H, cfg, [lo, hi])
    assert "rate" in report and "FER" in report
    cfg = t_sim.SimConfig(decoder="bec", channel="bec", max_iter=50, batch=64, target_frame_errors=10,
                          max_frames=256, device="cpu")
    (r,) = t_sim.run_simulation(H, [0.05], cfg)
    assert r.fer < 0.5 and r.undetected_errors == 0
    with pytest.raises(ValueError, match="position"):
        t_sim.format_position_ber(r)


def test_sim_config_needs_the_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_sim.SimConfig(device="cuda")
    with pytest.raises(ValueError, match="unknown decoder"):
        t_sim._decode(t_sim.SimConfig(decoder="nope", device="cpu"), None, None)


@pytest.mark.parametrize("cov_mean", [5.0, 1.5])
def test_k1_twin_fixed_work_matches_pallas_kernel(cov_mean):
    """K1's twin with early_stop=False equals the Pallas kernel in the same
    mode (interpret mode), and the early-stopped twin word for word."""
    H = build_rs_ldpc(4, 12, 4)
    code = BlockedCode.detect(H)
    tg = graph_from_reference(LdpcGraph.from_sparse(H))
    rng = np.random.default_rng(3)
    cw = random_codewords(H.to_dense(), 16, rng)
    cov = rng.poisson(cov_mean, cw.shape)
    errs = rng.binomial(cov, 0.05)
    llr = ((cov - 2 * errs) * np.log(0.95 / 0.05) * np.where(cw == 0, 1.0, -1.0)).astype(np.float32)
    pal = bp_decode_blocked_pallas(code, jnp.asarray(llr), max_iter=12, early_stop=False, block_b=8, interpret=True)
    fixed = bp_decode_blocked_ref(tg.blocked, torch.from_numpy(llr), 12, early_stop=False)
    early = bp_decode_blocked_ref(tg.blocked, torch.from_numpy(llr), 12)
    for name in ("bits", "success", "iterations", "unsat"):
        np.testing.assert_array_equal(np.asarray(getattr(pal, name)), getattr(fixed, name).numpy(), err_msg=name)
        assert torch.equal(getattr(fixed, name), getattr(early, name)), name


def _oligos(n=40):
    rng = np.random.default_rng(11)
    return ["".join("ACGT"[k] for k in rng.integers(0, 4, 152)) for _ in range(n)]


def test_quality_model_and_simulate_trial_match_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    chars = np.array(list("C5?I#"))
    for t, n in ((0, 523), (3, 611)):
        (tmp_path / f"72000_RS_Q_{t}.txt").write_text(
            "".join(c + "\n" for c in rng.choice(chars, n, p=[0.85, 0.05, 0.05, 0.04, 0.01]))
        )
    q_dir = str(tmp_path)
    path = str(tmp_path / "72000_RS_Q_3.txt")
    fields = dataclasses.astuple  # the two packages' QualityModel classes differ; their fields must not
    assert fields(t_reads.QualityModel.from_reference(path)) == fields(j_reads.QualityModel.from_reference(path))
    counts = {"C": 7, "?": 2, "5": 1}
    qm = t_reads.QualityModel.from_counts(counts)
    assert fields(qm) == fields(j_reads.QualityModel.from_counts(counts))
    assert qm.sample(np.random.default_rng(1), 50) == j_reads.QualityModel.from_counts(counts).sample(
        np.random.default_rng(1), 50)
    assert fields(t_reads.reference_quality_model(q_dir)) == fields(j_reads.reference_quality_model(q_dir))
    assert t_reads.reference_read_count(3, q_dir) == j_reads.reference_read_count(3, q_dir) == 611
    assert t_reads.reference_read_count(5, q_dir) is None
    for mod in (t_reads, j_reads):
        monkeypatch.setattr(mod, "reference_read_count", lambda t, _f=mod.reference_read_count: _f(t, q_dir))
        monkeypatch.setattr(mod, "reference_quality_model", lambda _f=mod.reference_quality_model: _f(q_dir))
    oligos = _oligos()
    for trial, seed in ((0, None), (3, 9)):
        got = t_reads.simulate_trial(oligos, trial, seed=seed)
        assert got == j_reads.simulate_trial(oligos, trial, seed=seed)
        assert len(got[0]) == (523, 611)[trial == 3] and set(got[1]) <= set(chars.tolist())


def test_simulate_trial_falls_back_without_quality_files(tmp_path, monkeypatch):
    empty = str(tmp_path)
    for mod in (t_reads, j_reads):
        monkeypatch.setattr(mod, "reference_read_count", lambda t, _f=mod.reference_read_count: _f(t, empty))
        monkeypatch.setattr(mod, "reference_quality_model", lambda _f=mod.reference_quality_model: _f(empty))
    oligos = _oligos(8)
    got = t_reads.simulate_trial(oligos, 2)
    assert len(got[0]) == 70000 and set(got[1]) == {chr(40), chr(70)}  # the parametric qualities
    assert got == j_reads.simulate_trial(oligos, 2)
