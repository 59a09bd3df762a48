"""Monte-Carlo FER/BER simulation harness.

Port of ``dna_ldpc_tpu/ops/simulation.py``, the batched equivalent of the
reference's frame-loop simulator (``LDPC_dec/ldpc/DNA_main.cpp``:
``Run_Simulation`` :800-930, error accounting and the ``result_(...).txt``
report of ``Print_All_Result`` :965-1165): frames are drawn and decoded in
batches on ``SimConfig.device`` per channel point, with early termination
once the target frame-error count is reached. Only per-frame error counts,
success flags and iteration sums come back to the host.

Randomness: batch ``i`` of every point draws its channel noise from a
``torch.Generator`` on the device seeded from ``np.random.SeedSequence(
[seed, i])``. An :class:`ErrorCase` stores ``(seed, i)`` and the device
type (CPU and CUDA generators give different streams), so a saved failure
replays exactly on that device type. The draws cannot equal the JAX
package's threefry bits; its parity tests feed both packages the same
channel outputs.
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.ldpc_graph import LdpcGraph
from ..models.mod2 import random_codewords
from ..utils.device import DEFAULT_DEVICE, require_device
from ..utils.io_formats import SparseBinaryMatrix
from . import channels
from .bp import bp_decode
from .decoders import bec_peel, gallager_decode, min_sum_decode, quantized_min_sum_decode
from .faid import faid_decode


@dataclass
class ErrorCase:
    """Everything needed to re-create one failed frame exactly — the
    analog of the reference's saved MKL RNG stream files (``rand.cpp:
    36-60``, ``SAVE_ERROR``/``RAND_LOAD_FILE_ALL`` replay at
    ``DNA_main.cpp:84-98,1238-1276``): the batch generator's seed words
    ``(seed, batch index)``, the frame's slot in the batch, the codeword
    index and the device type the batch was drawn on."""

    param: float
    key_data: tuple           # (seed, batch index) of the batch's generator
    slot: int                 # position within the batch
    codeword_idx: int
    device: str               # device type of the generator ("cpu" / "cuda")

    def to_record(self) -> dict:
        return {
            "param": self.param,
            "key_data": list(self.key_data),
            "slot": self.slot,
            "codeword_idx": self.codeword_idx,
            "device": self.device,
        }

    @classmethod
    def from_record(cls, rec: dict) -> "ErrorCase":
        return cls(rec["param"], tuple(rec["key_data"]), rec["slot"], rec["codeword_idx"], rec["device"])


@dataclass
class PointResult:
    param: float              # EbNo dB / crossover p / erasure p
    frames: int
    frame_errors: int
    bit_errors: int
    undetected_errors: int    # decoder claimed success but bits differ
    mean_iters: float
    seconds: float
    error_cases: list = field(default_factory=list)       # [ErrorCase]
    position_bit_errors: np.ndarray | None = None         # [N] int64

    @property
    def fer(self) -> float:
        return self.frame_errors / max(self.frames, 1)

    @property
    def ber(self) -> float:
        return self.bit_errors / max(self.frames, 1)


@dataclass
class SimConfig:
    decoder: str = "bp"           # bp | min_sum | quantized_min_sum |
    #                               gallager_a | gallager_b | faid | bec
    channel: str = "awgn"         # awgn | bsc | bec
    max_iter: int = 50
    batch: int = 128
    target_frame_errors: int = 50
    max_frames: int = 20000
    seed: int = 7                 # reference default seed (def_func.py:49)
    min_sum_offset: float = 0.0
    min_sum_normalize: float = 1.0
    qms_precision: int = 5        # quantized min-sum (Cal_MSA_Q analog)
    qms_step: float = 0.5
    puncture_positions: tuple = ()   # DNA_main.cpp:1440-1470
    shorten_positions: tuple = ()    # DNA_main.cpp:1472-1520
    save_error_cases: int = 0     # keep up to this many replayable failures
    track_position_ber: bool = False  # POSITION_BER_... dumps (:1132-1160)
    device: str = DEFAULT_DEVICE  # where the channel draws and decoders run

    def __post_init__(self):
        require_device(self.device)


def batch_generator(seed: int, batch_index: int, device) -> torch.Generator:
    """The channel generator of batch ``batch_index`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, batch_index]).generate_state(1, np.uint64)[0]))
    return gen


def _decode(config: SimConfig, graph, llr_or_vals):
    if config.decoder == "bp":
        return bp_decode(graph, llr_or_vals, max_iter=config.max_iter)
    if config.decoder == "min_sum":
        return min_sum_decode(
            graph, llr_or_vals, max_iter=config.max_iter,
            offset=config.min_sum_offset, normalize=config.min_sum_normalize,
        )
    if config.decoder == "quantized_min_sum":
        return quantized_min_sum_decode(
            graph, llr_or_vals, precision=config.qms_precision,
            step=config.qms_step, max_iter=config.max_iter,
            offset=config.min_sum_offset,
        )
    if config.decoder == "gallager_a":
        return gallager_decode(graph, llr_or_vals, max_iter=config.max_iter, variant=0)
    if config.decoder == "gallager_b":
        return gallager_decode(graph, llr_or_vals, max_iter=config.max_iter, variant=1)
    if config.decoder == "faid":
        return faid_decode(graph, llr_or_vals, max_iter=config.max_iter)
    if config.decoder == "bec":
        return bec_peel(graph, llr_or_vals, max_iter=config.max_iter)
    raise ValueError(f"unknown decoder {config.decoder}")


def _apply_channel(config: SimConfig, cws: torch.Tensor, gen: torch.Generator, param: float, rate: float):
    """Channel draw for one batch (shared by the simulator and the
    error-case replay so both see identical randomness)."""
    hard_input = config.decoder.startswith("gallager") or config.decoder == "faid"
    if config.channel == "awgn":
        rx = channels.awgn_llr(gen, cws, channels.ebno_to_sigma(param, rate))
    elif config.channel == "bsc":
        if hard_input:
            return channels.bsc_flips(gen, cws, param)
        rx = channels.bsc_llr(gen, cws, param)
    elif config.channel == "bec":
        return channels.bec_values(gen, cws, param)
    else:
        raise ValueError(config.channel)
    if config.puncture_positions:
        rx = channels.puncture(rx, list(config.puncture_positions))
    if config.shorten_positions:
        rx = channels.shorten(rx, list(config.shorten_positions))
    return rx


def simulate_point(
    H: SparseBinaryMatrix,
    graph: LdpcGraph,
    codewords: np.ndarray,
    param: float,
    config: SimConfig,
    rate: float,
) -> PointResult:
    """Simulate one channel point until target_frame_errors or max_frames."""
    dev = torch.device(config.device)
    cw_dev = torch.as_tensor(np.asarray(codewords, np.uint8), device=dev)
    t0 = time.time()
    frames = fe = be = ue = 0
    iters_sum = 0
    batch_index = 0
    cases: list[ErrorCase] = []
    pos_be = torch.zeros(H.n_cols, dtype=torch.int64, device=dev) if config.track_position_ber else None
    while fe < config.target_frame_errors and frames < config.max_frames:
        gen = batch_generator(config.seed, batch_index, dev)
        idx = np.arange(frames, frames + config.batch) % len(codewords)
        cws = cw_dev[torch.as_tensor(idx, device=dev)]
        rx = _apply_channel(config, cws, gen, param, rate)
        res = _decode(config, graph, rx)
        wrong = res.bits != cws
        errs = wrong.sum(1).cpu().numpy()
        ok = res.success.cpu().numpy()
        if config.save_error_cases and len(cases) < config.save_error_cases:
            for slot in np.nonzero(errs > 0)[0]:
                if len(cases) >= config.save_error_cases:
                    break
                cases.append(ErrorCase(param, (config.seed, batch_index), int(slot), int(idx[slot]), dev.type))
        if pos_be is not None:
            pos_be += wrong.sum(0)
        frames += config.batch
        fe += int((errs > 0).sum())
        be += int(errs.sum())
        ue += int(((errs > 0) & ok).sum())
        iters_sum += int(res.iterations.sum())
        batch_index += 1
    return PointResult(
        param=param,
        frames=frames,
        frame_errors=fe,
        bit_errors=be,
        undetected_errors=ue,
        mean_iters=iters_sum / max(frames, 1),
        seconds=time.time() - t0,
        error_cases=cases,
        position_bit_errors=None if pos_be is None else pos_be.cpu().numpy(),
    )


def replay_error_case(
    H: SparseBinaryMatrix,
    graph: LdpcGraph,
    codewords: np.ndarray,
    case: ErrorCase,
    config: SimConfig,
    max_iter: int | None = None,
):
    """Re-create one saved failure exactly (same generator, same slot) and
    re-decode it on ``config.device``, which must be of the device type
    the case was drawn on. Returns (BpResult for that frame, transmitted
    codeword, channel output), the last two as numpy arrays."""
    dev = torch.device(config.device)
    if dev.type != case.device:
        raise ValueError(f"error case drawn on {case.device!r}; replay it there, not on {dev.type!r}")
    gen = batch_generator(*case.key_data, dev)
    rate = (H.n_cols - H.n_rows) / H.n_cols
    # the batch was codewords[(frames + arange(batch)) % len]: every
    # channel draws noise of the batch's shape independent of the bits, so
    # one codeword broadcast over the batch sees the frame's noise in its slot
    cw = torch.as_tensor(np.asarray(codewords[case.codeword_idx], np.uint8), device=dev)
    cws = cw.expand(config.batch, H.n_cols)
    rx = _apply_channel(config, cws, gen, case.param, rate)[case.slot : case.slot + 1]
    res = _decode(config if max_iter is None else dataclasses.replace(config, max_iter=max_iter), graph, rx)
    return res, cw.cpu().numpy(), rx[0].cpu().numpy()


def save_error_cases(path: str, results: list[PointResult]) -> None:
    """Persist replayable failures (the ``.err`` file analog)."""
    records = [c.to_record() for r in results for c in r.error_cases]
    with open(path, "w") as f:
        json.dump(records, f)


def load_error_cases(path: str) -> list[ErrorCase]:
    with open(path) as f:
        return [ErrorCase.from_record(r) for r in json.load(f)]


def run_simulation(
    H: SparseBinaryMatrix,
    params: list[float],
    config: SimConfig | None = None,
    n_codewords: int = 64,
    graph: LdpcGraph | None = None,
) -> list[PointResult]:
    """Simulate every channel point of ``params`` on ``n_codewords`` random
    codewords of H. ``graph``: H's decoding tables, by default
    ``LdpcGraph.from_sparse(H)``; the shipped deployed pchk is a column
    shuffle whose blocked structure ``from_sparse`` cannot see, so pass
    ``pipeline.decode.deployed_graph()`` to decode it with the fused BP
    decoder."""
    config = config or SimConfig()
    graph = graph if graph is not None else LdpcGraph.from_sparse(H)
    rate = (H.n_cols - H.n_rows) / H.n_cols
    rng = np.random.default_rng(config.seed)
    cws = random_codewords(H.to_dense(), n_codewords, rng)
    return [simulate_point(H, graph, cws, p, config, rate) for p in params]


def format_report(H: SparseBinaryMatrix, config: SimConfig, results: list[PointResult]) -> str:
    """Result table in the spirit of Print_All_Result (DNA_main.cpp:
    1040-1126): code parameters then per-point FER/BER rows."""
    N, M = H.n_cols, H.n_rows
    K = N - M
    lines = [
        "=" * 72,
        f"  N = {N}   K = {K}   M = {M}   rate = {K / N:.4f}",
        f"  decoder = {config.decoder}   channel = {config.channel}"
        f"   max_iter = {config.max_iter}   seed = {config.seed}",
        "=" * 72,
        f"{'param':>8} {'frames':>8} {'FER':>12} {'BER':>12} "
        f"{'undet':>6} {'iters':>7} {'sec':>8}",
    ]
    for r in results:
        lines.append(
            f"{r.param:>8.3f} {r.frames:>8d} {r.fer:>12.4e} "
            f"{r.ber / max(H.n_cols, 1):>12.4e} {r.undetected_errors:>6d} "
            f"{r.mean_iters:>7.2f} {r.seconds:>8.2f}"
        )
    return "\n".join(lines) + "\n"


def format_position_ber(result: PointResult, block: int = 1) -> str:
    """Per-position bit-error dump (the POSITION_BER_... files of
    DNA_main.cpp:1132-1160), optionally aggregated into blocks — the view
    used to see the decoding wave of windowed/SC decoders."""
    if result.position_bit_errors is None:
        raise ValueError("run with SimConfig(track_position_ber=True)")
    pb = result.position_bit_errors
    if block > 1:
        pad = (-len(pb)) % block
        pb = np.concatenate([pb, np.zeros(pad, pb.dtype)]).reshape(-1, block).sum(axis=1)
    lines = [f"param {result.param}  frames {result.frames}"]
    lines += [f"{i}\t{int(v)}\t{v / max(result.frames, 1):.6e}" for i, v in enumerate(pb)]
    return "\n".join(lines) + "\n"
