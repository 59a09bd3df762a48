"""Driver of the code-simulator configurations: ``simulate_point`` of
``dna_ldpc_tpu_torch.ops.simulation`` on the deployed graph.

Set-up: the program's kernels, the benchmark's H (checked against the
program's), ``codewords`` uniformly random codewords from the benchmark's
encoder, one warm-up call. A measured unit is one ``simulate_point`` call
of ``frames_per_call`` frames at the traffic's point, its seed drawn from
``--seed`` and the call's number; the frames are every ``frames_per_call``
frames, whatever their outcome.

``correct``: one call of the window, drawn from the seed among the first
``check.among_first_calls``, is worked out again by the plain reference: its channel outputs
drawn again from the simulator's documented generator recipe (a
``torch.Generator`` on the card per batch, seeded from
``SeedSequence([seed, batch])``, LLR = 2 (x + sigma n) / sigma^2) and
decoded by ``reference/bp.py`` in the configuration's message precision.
Compared: the frames the program calls decoded whose bits are not a
codeword (none may be), the share of the call's frames whose outcome
differs (success on one side only, or both successful with other bits),
and the gap between the call's counted frame errors and the reference's,
as a share of its frames. ``control()`` puts the plain decoder, one
precision below the configuration's, in the program's place before the
check (``run.py --control``); the check itself is the same.
"""

from __future__ import annotations

import math
import statistics
import sys
import time

import numpy as np
import torch

from benchlib import code, common
from reference import bp as ref_bp


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, rec):
        self.config, self.traffic, self.seed, self.device, self.rec = config, traffic, seed, device, rec
        self.limits = common.limits(config, traffic)
        self.attempted = 0
        self.failed = 0
        self.dev = torch.device(device)
        # the checked call is drawn from the window's first calls
        self.checked_call = int(common.stream(seed, "checked-call").integers(0, config["check"]["among_first_calls"]))
        self.capturing = False
        self.captured = []

    # -- set-up --------------------------------------------------------------
    def setup(self) -> dict:
        info = common.load_program(self.device)
        from dna_ldpc_tpu_torch.models.rs_ldpc import dna_storage_pchk
        from dna_ldpc_tpu_torch.ops import simulation
        from dna_ldpc_tpu_torch.pipeline.decode import deployed_graph

        self.sim = simulation
        info.update(self.make_inputs())
        common.check_program_h(self.checks)
        self.H = dna_storage_pchk()
        self.graph = deployed_graph()
        self.rec.counters["edges"] = int(self.checks.size)
        self.rec.counters["n_vars"] = int(self.cws.shape[1])
        self.rec.wrap(simulation, "_apply_channel", "bench.channel")
        self.rec.capture(simulation, "bp_decode", self._keep)
        self.rec.wrap(simulation, "bp_decode", "bench.bp_decode")
        t0 = time.time()
        self._point(common.sub_seed(self.seed, "warm-up", 0))
        common.sync(self.device)
        info["warm_up_call_s"] = round(time.time() - t0, 4)
        return info

    def make_inputs(self) -> dict:
        """The codewords the frames carry, from the seed."""
        self.checks = code.deployed_checks()
        enc = code.load_encoder()
        cw_dev = self.device if self.dev.type == "cuda" else None
        self.cws = enc.random_codewords(self.config["codewords"], common.stream(self.seed, "codewords"), cw_dev)
        if code.syndrome_weight(self.checks, self.cws).any():
            raise RuntimeError("the encoder gave a word that is not a codeword")
        self.rate = self.config["code"]["rate_num"] / self.config["code"]["rate_den"]
        return {"encoder_build_s": round(enc.build_s, 4)}

    def call_seed(self, k: int) -> int:
        return common.sub_seed(self.seed, "call", k)

    def _sim_config(self, seed: int):
        c = self.config
        return self.sim.SimConfig(
            decoder=c["decoder"], channel=self.traffic["channel"], max_iter=c["max_iter"], batch=c["batch"],
            target_frame_errors=c["frames_per_call"] + 1, max_frames=c["frames_per_call"], seed=seed,
            device=self.device,
        )

    def _point(self, seed: int):
        return self.sim.simulate_point(self.H, self.graph, self.cws, self.traffic["ebno_db"],
                                       self._sim_config(seed), self.rate)

    def _keep(self, orig, *args, **kwargs):
        res = orig(*args, **kwargs)
        if self.capturing:
            self.captured.append(res)
        return res

    # -- the window ------------------------------------------------------------
    def unit(self) -> None:
        k = len(self.rec.units)
        seed = self.call_seed(k)
        self.capturing = k == self.checked_call
        r = self._point(seed)
        self.capturing = False
        self.rec.units.append({"seed": seed, "frames": r.frames, "frame_errors": r.frame_errors,
                               "mean_iters": r.mean_iters, "seconds": r.seconds})

    def end_to_end(self, elapsed: float) -> dict:
        frames = sum(u["frames"] for u in self.rec.units)
        self.attempted = frames
        secs = [u["seconds"] for u in self.rec.units]
        fe = sum(u["frame_errors"] for u in self.rec.units)
        print(f"window: {len(secs)} calls, {frames} frames in {elapsed:.4f} s, FER {fe / max(frames, 1):.5f}, "
              f"mean iterations {sum(u['mean_iters'] * u['frames'] for u in self.rec.units) / max(frames, 1):.3f}, "
              f"call seconds median {statistics.median(secs):.5f} min {min(secs):.5f} max {max(secs):.5f}",
              file=sys.stderr)
        return {"sim_frames_per_s": frames / elapsed}

    def release(self) -> None:
        self.graph = None

    # -- correct -----------------------------------------------------------------
    def channel_llrs(self, seed: int, batch_index: int, cw_dev: torch.Tensor) -> torch.Tensor:
        """A batch's channel LLRs, drawn again by the documented recipe."""
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(int(np.random.SeedSequence([seed, batch_index]).generate_state(1, np.uint64)[0]))
        x = 1.0 - 2.0 * cw_dev[self.rows(batch_index)].to(torch.float32)
        sigma = math.sqrt(1.0 / (2.0 * self.rate * 10.0 ** (self.traffic["ebno_db"] / 10.0)))
        r = x + sigma * torch.randn(x.shape, generator=gen, device=self.dev)
        return 2.0 * r / (sigma * sigma)

    def rows(self, batch_index: int) -> torch.Tensor:
        """The codeword of each frame of a batch of a call."""
        b = self.config["batch"]
        return torch.as_tensor(np.arange(batch_index * b, (batch_index + 1) * b) % len(self.cws), device=self.dev)

    def reference_call(self, seed: int, msg_dtype) -> list:
        """The plain decoder's result of each batch of the call with
        ``seed``, with ``msg_dtype`` messages."""
        cw_dev = torch.as_tensor(self.cws, device=self.dev)
        checks = torch.as_tensor(self.checks, device=self.dev)
        return [ref_bp.decode_blocks(checks, self.channel_llrs(seed, b, cw_dev), self.config["max_iter"], msg_dtype)
                for b in range(self.config["frames_per_call"] // self.config["batch"])]

    def control(self) -> str:
        """Put the plain decoder, one precision below the configuration's
        messages, in the program's place for the checked call: its
        results and its counted frame errors. Returns what was lowered."""
        low = common.LOWER[self.config["precision"]["bp_messages"]]
        if self.checked_call < len(self.rec.units):
            unit = self.rec.units[self.checked_call]
            self.captured = self.reference_call(unit["seed"], getattr(torch, low))
            cw_dev = torch.as_tensor(self.cws, device=self.dev)
            unit["frame_errors"] = sum(int((r.bits != cw_dev[self.rows(b)]).any(1).sum())
                                       for b, r in enumerate(self.captured))
        return f"messages in {low}"

    def check(self) -> dict:
        limits = self.limits
        if self.checked_call >= len(self.rec.units):
            print(f"check: the drawn call {self.checked_call} did not run in the window", file=sys.stderr)
            return {"outcome_disagree_pct": {"value": 100.0, "limit": limits["outcome_disagree_pct"]}}
        unit = self.rec.units[self.checked_call]
        ref = self.reference_call(unit["seed"], getattr(torch, self.config["precision"]["bp_messages"]))
        if len(self.captured) != len(ref):
            print(f"check: {len(self.captured)} results of bp_decode captured in call {self.checked_call}, "
                  f"{len(ref)} batches run", file=sys.stderr)
            return {"outcome_disagree_pct": {"value": 100.0, "limit": limits["outcome_disagree_pct"]}}
        cw_dev = torch.as_tensor(self.cws, device=self.dev)
        checks = torch.as_tensor(self.checks, device=self.dev)
        n = dis = fe_ref = false_claims = 0
        for b, (r, p) in enumerate(zip(ref, self.captured)):
            both = p.success & r.success
            differ = (p.success != r.success) | (both & (p.bits != r.bits).any(1))
            dis += int(differ.sum())
            false_claims += int((p.success & (p.bits[:, checks].sum(-1) % 2).any(-1)).sum())
            fe_ref += int((r.bits != cw_dev[self.rows(b)]).any(1).sum())
            n += len(r.bits)
        self.failed = dis
        gap = abs(unit["frame_errors"] - fe_ref)
        print(f"check: call {self.checked_call}, {n} frames, {dis} outcomes differ from the reference, frame errors "
              f"program {unit['frame_errors']} reference {fe_ref}", file=sys.stderr)
        return {
            "claimed_not_codeword": {"value": false_claims, "limit": limits["claimed_not_codeword"]},
            "outcome_disagree_pct": {"value": 100.0 * dis / max(n, 1), "limit": limits["outcome_disagree_pct"]},
            "fer_gap_pct": {"value": 100.0 * gap / max(n, 1), "limit": limits["fer_gap_pct"]},
        }
