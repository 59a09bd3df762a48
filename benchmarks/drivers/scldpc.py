"""Driver of the SC-LDPC configurations: ``sliding_window_decode`` of
``dna_ldpc_tpu_torch.ops.scldpc`` on a coupled RS-LDPC chain under AWGN.

Set-up: the chain built by the benchmark (``reference/scldpc.py``'s
coupling of ``benchlib/code.py``'s RS-LDPC base block) and by the program
(``models.scldpc.couple`` of ``models.rs_ldpc.build_rs_ldpc``), checked
equal; the program's window graph; one warm-up call of one BP iteration
a window (every tensor of a call has its shape from the first iteration
on). The windowed decoder is eager torch: none of the program's CUDA
kernels or host library runs in this cell, so none is loaded. A measured unit is one call of ``batch`` frames:
the all-zero word under BPSK at the traffic's Eb/No (counted at the
configuration's rate), its channel LLRs drawn on the card from a
generator seeded from ``--seed`` and the call's number, then decoded by
``sliding_window_decode`` with the configuration's window and iterations.
A frame is in error when any of its decisions is 1.

``correct``: one call of the window, drawn from the seed among the first
``check.among_first_calls``, is worked out again by the plain windowed
reference (``reference/scldpc.py``) on the same LLRs, in the
configuration's message precision. Compared:

- ``outcomes_differ``: frames decoded (every decision 0) on one side
  only;
- ``frame_errors_gap``: the call's frame errors against the reference's;
- ``iterations_differ``: (window, frame) pairs whose BP iteration count
  differs from the reference's: the program hands the checked call's
  ``BpResult`` of each window to the driver (``on_window``), and a call
  that hands out none reads every pair as differing;
- ``commits_lost``: frames whose returned decisions are not the blocks
  their windows committed (each window's oldest active block of its
  ``BpResult`` bits); exact, limit 0.

The cell sends the all-zero word, so an output left at zero reads as
many frame errors apart from the reference as the reference fails frames
(16-36 of 1,024 at the cell's point): the first two limits lie below
that, ``commits_lost`` counts every frame whose output was not written
from its windows, and ``iterations_differ`` sees a decoder whose
decisions look right but whose BP ran otherwise.

``control()`` puts the plain reference with the configuration's
``control_messages`` (bfloat16) in the program's place before the same
check (``run.py --control``). ``common.LOWER`` steps float32 down to
TF32, which reaches no matrix product in this decoder, so the
configuration states its own step.
"""

from __future__ import annotations

import math
import statistics
import sys
import time

import numpy as np
import torch

from benchlib import code, common
from reference import scldpc as ref_sc


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, rec):
        self.config, self.traffic, self.seed, self.device, self.rec = config, traffic, seed, device, rec
        self.limits = common.limits(config, traffic)
        self.attempted = 0
        self.failed = 0
        self.dev = torch.device(device)
        self.checked_call = int(common.stream(seed, "checked-call").integers(0, config["check"]["among_first_calls"]))
        self.kept = None   # (LLRs, decisions, iteration counts a window, committed blocks) of the checked call

    # -- set-up --------------------------------------------------------------
    def setup(self) -> dict:
        info = {}
        from dna_ldpc_tpu_torch.models.rs_ldpc import build_rs_ldpc
        from dna_ldpc_tpu_torch.models.scldpc import couple
        from dna_ldpc_tpu_torch.ops import scldpc

        self.sc = scldpc
        c = self.config["chain"]
        t0 = time.time()
        base = code.rs_ldpc_checks(c["s"], c["rho"], c["gamma"])
        self.ref_chain = ref_sc.couple(base, c["rho"] << c["s"], c["L"], c["w"], c["coupling_seed"])
        self.chain = couple(build_rs_ldpc(c["s"], c["rho"], c["gamma"]), L=c["L"], w=c["w"], seed=c["coupling_seed"])
        H = self.chain.H
        if not (np.array_equal(H.indptr, self.ref_chain.indptr) and np.array_equal(H.indices, self.ref_chain.indices)):
            raise RuntimeError("the program's coupled chain is not the benchmark's")
        if (H.n_rows, H.n_cols, H.nnz) != (c["m"], c["n"], c["edges"]):
            raise RuntimeError(f"the chain is {H.n_rows} x {H.n_cols} with {H.nnz} edges, not the configuration's")
        graph = scldpc._window_graph(self.chain, self.config["window"])
        info["chain_and_window_graph_s"] = round(time.time() - t0, 4)
        self.rate = c["rate_num"] / c["rate_den"]
        self.rec.counters.update(batch=self.config["batch"], window_vars=graph.n_vars)
        t0 = time.time()
        self._call(common.sub_seed(self.seed, "warm-up", 0), iters=1)
        common.sync(self.device)
        info["warm_up_call_s"] = round(time.time() - t0, 4)
        return info

    def call_seed(self, k: int) -> int:
        return common.sub_seed(self.seed, "call", k)

    def channel_llrs(self, seed: int) -> torch.Tensor:
        """[batch, n] LLRs of the all-zero word under BPSK: 2 (1 + sigma n) / sigma^2."""
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(seed)
        sigma = math.sqrt(1.0 / (2.0 * self.rate * 10.0 ** (self.traffic["ebno_db"] / 10.0)))
        n = torch.randn((self.config["batch"], self.chain.n_vars), generator=gen, device=self.dev)
        return (2.0 / (sigma * sigma)) * (1.0 + sigma * n)

    def _call(self, seed: int, on_window=None, iters: int | None = None):
        with self.rec.span("bench.channel"):
            llr = self.channel_llrs(seed)
        with self.rec.span("bench.window_decode"):
            kw = {} if on_window is None else {"on_window": on_window}
            dec = self.sc.sliding_window_decode(self.chain, llr, W=self.config["window"],
                                                iters=iters or self.config["iters"], device=self.device, **kw)
        return llr, dec

    def _keep(self, its: list, commits: list):
        """The ``on_window`` hook of the checked call: each window's
        iteration counts and its committed block (the window's block w)."""
        lo, hi = self.chain.w * self.chain.b_v, (self.chain.w + 1) * self.chain.b_v

        def hook(t, res):
            its.append(res.iterations)
            commits.append(res.bits[:, lo:hi].clone())
        return hook

    # -- the window ------------------------------------------------------------
    def unit(self) -> None:
        k = len(self.rec.units)
        seed = self.call_seed(k)
        kept = ([], []) if k == self.checked_call else None
        t0 = time.time()
        llr, dec = self._call(seed, None if kept is None else self._keep(*kept))
        seconds = time.time() - t0
        wrong = dec.any(1)
        if kept is not None:
            self.kept = (llr, dec, *kept)
        self.rec.units.append({"seed": seed, "frames": len(dec), "frame_errors": int(wrong.sum()),
                               "bit_errors": int(np.count_nonzero(dec)), "seconds": seconds})

    def end_to_end(self, elapsed: float) -> dict:
        units = self.rec.units
        frames = sum(u["frames"] for u in units)
        self.attempted = frames
        secs = [u["seconds"] for u in units]
        fe = sum(u["frame_errors"] for u in units)
        be = sum(u["bit_errors"] for u in units)
        print(f"window: {len(secs)} calls, {frames} frames in {elapsed:.4f} s, FER {fe / max(frames, 1):.5f}, "
              f"BER {be / max(frames * self.chain.n_vars, 1):.3e}, call seconds median {statistics.median(secs):.5f} "
              f"min {min(secs):.5f} max {max(secs):.5f}", file=sys.stderr)
        return {"sim_frames_per_s": frames / elapsed}

    def release(self) -> None:
        pass

    # -- correct -----------------------------------------------------------------
    def reference_call(self, llr: torch.Tensor, msg_dtype) -> tuple[np.ndarray, list]:
        """The plain decoder's decisions ([B, n] numpy) on ``llr`` and its
        iteration counts ([B] tensors, one a window)."""
        dec, windows = ref_sc.sliding_window_decode(self.ref_chain, llr, self.config["window"], self.config["iters"],
                                                    msg_dtype)
        return dec.cpu().numpy(), [r.iterations for r in windows]

    def iterations_differ(self, its: list, ref_its: list) -> int:
        """(window, frame) pairs whose iteration counts differ; all of them
        where ``its`` is not one [B] count a window."""
        batch, L = self.config["batch"], self.config["chain"]["L"]
        if len(its) != L or any(tuple(x.shape) != (batch,) for x in its):
            return L * batch
        return int((torch.stack([x.cpu() for x in its]) != torch.stack([x.cpu() for x in ref_its])).sum())

    def control(self) -> str:
        """Put the plain decoder with the configuration's lower message
        precision in the program's place for the checked call: its
        decisions and its frame errors. Returns what was lowered."""
        low = self.config["control_messages"]
        if self.kept is not None:
            llr = self.kept[0]
            dec, its = self.reference_call(llr, getattr(torch, low))
            self.kept = (llr, dec, its, [torch.as_tensor(dec)])   # the plain decoder's decisions are its commits
            self.rec.units[self.checked_call]["frame_errors"] = int(dec.any(1).sum())
        return f"messages in {low}"

    def check(self) -> dict:
        limits = self.limits
        if self.kept is None:
            print(f"check: the drawn call {self.checked_call} did not run in the window", file=sys.stderr)
            return {"outcomes_differ": {"value": self.config["batch"], "limit": limits["outcomes_differ"]}}
        llr, dec, its, commits = self.kept
        unit = self.rec.units[self.checked_call]
        t0 = time.time()
        ref_dec, ref_its = self.reference_call(llr, getattr(torch, self.config["precision"]["bp_messages"]))
        ok, ref_ok = ~dec.any(1), ~ref_dec.any(1)
        differ = int((ok != ref_ok).sum())
        fe_ref = int((~ref_ok).sum())
        its_differ = self.iterations_differ(its, ref_its)
        committed = torch.cat([c.cpu() for c in commits], 1).numpy() if commits else None
        lost = len(dec) if committed is None or committed.shape != dec.shape else int((committed != dec).any(1).sum())
        self.failed = differ
        print(f"check: call {self.checked_call}, {len(dec)} frames, frame errors program {unit['frame_errors']} "
              f"reference {fe_ref}, {differ} outcomes differ, frames differing in any decision "
              f"{int((dec != ref_dec).any(1).sum())}, {its_differ} of {len(ref_its) * len(dec)} window iteration "
              f"counts differ, {lost} frames not as committed (reference {time.time() - t0:.2f} s)", file=sys.stderr)
        return {
            "outcomes_differ": {"value": differ, "limit": limits["outcomes_differ"]},
            "frame_errors_gap": {"value": abs(unit["frame_errors"] - fe_ref), "limit": limits["frame_errors_gap"]},
            "iterations_differ": {"value": its_differ, "limit": limits["iterations_differ"]},
            "commits_lost": {"value": lost, "limit": limits["commits_lost"]},
        }
