"""Driver of the trial configurations: ``decode_trial`` of
``dna_ldpc_tpu_torch.pipeline.decode`` on the default device-MSA path.

Set-up: the program's kernels, the benchmark's H (checked against the
program's), ``codewords`` uniformly random codewords of the deployed code
from the benchmark's encoder (the stored data), their oligos, and
``samples`` distinct read samples of the traffic's size drawn through its
channel; one warm-up trial on the last sample. A measured unit is one
trial; unit k decodes sample k mod ``samples``, so no two consecutive
trials decode the same reads.

``correct`` (``reference/``, nothing of the program):

- ``codewords_wrong``: the decoded codewords of every trial of the window
  that differ from the stored ones (the configuration's guarantee: every
  codeword read back), limit 0;
- ``counted_rows_differ``: the first trial's LLR rows of every strand
  whose reads need no alignment, against the plain ingest, limit 0;
- ``k2_pairs_unknown`` and ``k2_post_maxdiff``: a sample, drawn from the
  seed, of the read pairs the first trial's pair-HMM (K2) was given, each
  a pair of reads of one strand by the plain RS filter, and the widest gap
  between K2's posteriors and the plain pair HMM's, both at rest in the
  configuration's precision; where the first trial aligned strands but
  no call of K2 was seen, ``k2_post_maxdiff`` reads 1.0 and fails;
- ``msa_rows_differ``: a sample, drawn from the seed, of the first
  trial's strands whose reads are aligned, their LLR rows against the
  plain pre-filter, alignment (``reference/msa.py``, in the
  configuration's precisions) and counting.

``control()`` puts the plain reference, one precision below the
configuration's, in the program's place before the check (``run.py
--control``); the check itself is the same.
"""

from __future__ import annotations

import importlib
import statistics
import sys
import time

import numpy as np
import torch

from benchlib import code, common, recipe
from reference import ingest, msa as ref_msa, pairhmm as ref_pairhmm


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, rec):
        self.config, self.traffic, self.seed, self.device, self.rec = config, traffic, seed, device, rec
        self.limits = common.limits(config, traffic)
        self.attempted = 0
        self.failed = 0
        self.dev = torch.device(device)
        self.decoded = []
        self.table = None
        self.k2 = None
        self.first = False
        self._checked = None

    # -- set-up --------------------------------------------------------------
    def setup(self) -> dict:
        info = common.load_program(self.device)
        from dna_ldpc_tpu_torch.pipeline import decode as trial_decode

        self.td = trial_decode
        self.msa_align = importlib.import_module("dna_ldpc_tpu_torch.ops.msa.align")
        info.update(self.make_inputs())
        common.check_program_h(self.checks)
        t = self.config["trial"]
        self.trial_config = trial_decode.TrialConfig(epsil=t["epsil"], max_iter=t["max_iter"],
                                                     anneal_step=t["anneal_step"], anneal_floor=t["anneal_floor"],
                                                     device=self.device)
        self.rec.wrap(trial_decode, "rs_filter_reads", "bench.rs_filter")
        self.rec.capture(trial_decode, "compute_trial_llrs", self._keep_table)
        self.rec.wrap(trial_decode, "compute_trial_llrs", "bench.soft_information")
        self.rec.wrap(trial_decode, "anneal_decode", "bench.bp_anneal")
        self.rec.capture(self.msa_align, "k2_posteriors", self._keep_k2)
        t0 = time.time()
        res = self.td.decode_trial(*self.samples[-1], self.cws, self.trial_config)
        common.sync(self.device)
        info["warm_up_trial_s"] = round(time.time() - t0, 4)
        info["warm_up_fail_final"] = res.fail_final
        return info

    def make_inputs(self) -> dict:
        """The stored codewords and the read samples, from the seed."""
        self.checks = code.deployed_checks()
        enc = code.load_encoder()
        t0 = time.time()
        cw_dev = self.device if self.dev.type == "cuda" else None
        self.cws = enc.random_codewords(self.config["codewords"], common.stream(self.seed, "codewords"), cw_dev)
        if code.syndrome_weight(self.checks, self.cws).any():
            raise RuntimeError("the encoder gave a word that is not a codeword")
        pool = recipe.encode_oligos(self.cws)
        channel = recipe.ChannelModel(**self.traffic["channel"])
        self.samples = [recipe.simulate_reads(pool, self.traffic["reads"], channel,
                                              common.stream(self.seed, f"reads-{k}"))
                        for k in range(self.config["samples"])]
        return {"encoder_build_s": round(enc.build_s, 4), "inputs_s": round(time.time() - t0, 4)}

    def _keep_table(self, orig, *args, **kwargs):
        table = orig(*args, **kwargs)
        if self.first:
            self.table = table
        return table

    def _keep_k2(self, orig, xs, ys, Lmax, dev):
        posts, ea = orig(xs, ys, Lmax, dev)
        if self.first and self.k2 is None and len(xs):
            n = min(self.config["check"]["k2_pairs"], len(xs))
            pick = np.sort(common.stream(self.seed, "k2-pairs").choice(len(xs), n, replace=False))
            kept = posts[torch.as_tensor(pick, device=posts.device)].clone()
            self.k2 = ([xs[i] for i in pick], [ys[i] for i in pick], kept)
        return posts, ea

    # -- the window ------------------------------------------------------------
    def _counters(self):
        from dna_ldpc_tpu_torch.ops import bp_cuda
        from dna_ldpc_tpu_torch.ops.msa import mea_cuda, pairhmm_cuda

        return {"bp_blocked": bp_cuda.launches, "pairhmm": pairhmm_cuda.launches, "pairs": pairhmm_cuda.pairs,
                "merge_dp": mea_cuda.merge_launches, "msa_clusters": self.msa_align.msa_clusters,
                "fallback_clusters": self.msa_align.fallback_clusters}

    def unit(self) -> None:
        k = len(self.rec.units)
        reads, quals = self.samples[k % len(self.samples)]
        self.first = k == 0
        before = self._counters()
        t0 = time.time()
        res = self.td.decode_trial(reads, quals, self.cws, self.trial_config)
        common.sync(self.device)
        seconds = time.time() - t0
        self.first = False
        after = self._counters()
        self.decoded.append(res.decoded_bits)
        self.rec.units.append({"seconds": seconds, "phase_times": dict(res.phase_times),
                               "counters": {n: after[n] - before[n] for n in after},
                               "fail_first": res.fail_first, "fail_final": res.fail_final,
                               "anneal_rounds": res.n_anneal_iters})

    def end_to_end(self, elapsed: float) -> dict:
        secs = [u["seconds"] for u in self.rec.units]
        q = statistics.quantiles(secs, n=4) if len(secs) > 1 else [secs[0]] * 3
        print(f"window: {len(secs)} trials in {elapsed:.4f} s; trial seconds median {statistics.median(secs):.4f}, "
              f"quartiles {q[0]:.4f} {q[2]:.4f}, min {min(secs):.4f}, max {max(secs):.4f}", file=sys.stderr)
        for k, u in enumerate(self.rec.units[:3]):
            print(f"trial {k}: counters {u['counters']}, fail_first {u['fail_first']}, fail_final {u['fail_final']}, "
                  f"anneal rounds {u['anneal_rounds']}, phase_times "
                  + ", ".join(f"{n}={v:.4f}" for n, v in u["phase_times"].items()), file=sys.stderr)
        return {"trial_s": elapsed / len(secs)}

    def release(self) -> None:
        if self.k2 is not None:
            self.k2 = (self.k2[0], self.k2[1], self.k2[2].float().cpu().numpy())

    # -- correct -----------------------------------------------------------------
    def _first_sample(self):
        """The first trial's reads by strand (the plain RS filter), the
        strands whose reads are aligned, and the aligned strands the check
        works out again (drawn from the seed)."""
        if self._checked is None:
            strands = ingest.filter_reads(*self.samples[0])
            aligned = [s for s in range(recipe.N_STRANDS) if ingest.needs_alignment(strands.get(s, []))]
            n = min(self.config["check"]["msa_clusters"], len(aligned))
            pick = common.stream(self.seed, "msa-strands").choice(aligned, n, replace=False) if n else []
            self._checked = (strands, aligned, sorted(int(s) for s in pick))
        return self._checked

    def _aligned_rows(self, strands: dict, pick: list, at_rest: str, products: str, timings=None) -> list:
        c = self.config
        return ref_msa.aligned_rows([strands[s] for s in pick], c["trial"]["epsil"], self.device, at_rest,
                                    workers=c["check"]["msa_workers"], products=products, timings=timings)

    def control(self) -> str:
        """Put the plain reference, one precision below the
        configuration's, in the program's place: the first trial's LLR
        table (every counted row, and every aligned row that the check
        reads) and K2's posteriors of the pairs the check samples, which
        are the pairs the program's K2 was given. The decoded codewords
        stay the program's. Returns what was lowered."""
        prec = self.config["precision"]
        at_rest = common.LOWER[prec["msa_posteriors_at_rest"]]
        products = common.LOWER[prec["consistency_products"]]
        strands, aligned, pick = self._first_sample()
        eps = self.config["trial"]["epsil"]
        table = np.array(self.table, copy=True)
        aligned_set = set(aligned)
        for s in range(recipe.N_STRANDS):
            if s not in aligned_set:
                table[s] = ingest.counted_row(strands.get(s, []), eps)
        for s, row in zip(pick, self._aligned_rows(strands, pick, at_rest, products)):
            table[s] = row
        self.table = table
        if self.k2 is not None:
            xs, ys, prog = self.k2
            low = np.zeros_like(prog)
            for k, r in enumerate(ref_pairhmm.posteriors(xs, ys, self.device, getattr(torch, at_rest))):
                low[k, : r.shape[0], : r.shape[1]] = r
            self.k2 = (xs, ys, low)
        return f"posteriors at rest in {at_rest}, consistency products in {products}"

    def check(self) -> dict:
        limits = self.limits
        prec = self.config["precision"]
        out = {}
        wrong = [int((d != self.cws).any(axis=1).sum()) for d in self.decoded]
        self.attempted = len(wrong)
        self.failed = sum(1 for w in wrong if w)
        out["codewords_wrong"] = {"value": sum(wrong), "limit": limits["codewords_wrong"]}

        eps = self.config["trial"]["epsil"]
        strands, aligned, pick = self._first_sample()
        aligned_set = set(aligned)
        differ = sum(
            not np.array_equal(ingest.counted_row(strands.get(s, []), eps), self.table[s])
            for s in range(recipe.N_STRANDS) if s not in aligned_set
        )
        out["counted_rows_differ"] = {"value": differ, "limit": limits["counted_rows_differ"]}

        if self.k2 is not None:
            out.update(self.k2_numbers(strands, *self.k2))
        elif aligned:
            # K2 is the only stage whose posteriors the check reads directly: without them the cell could
            # not tell a lower precision there, so the number reads the widest gap two probabilities have
            print(f"check: K2's posteriors were not captured (no call of ops.msa.align.k2_posteriors in the first "
                  f"trial, which aligned {len(aligned)} strands): k2_post_maxdiff reads 1.0", file=sys.stderr)
            out["k2_post_maxdiff"] = {"value": 1.0, "limit": limits["k2_post_maxdiff"]}

        timings = {}
        rows = self._aligned_rows(strands, pick, prec["msa_posteriors_at_rest"], prec["consistency_products"], timings)
        gaps = [int((row != self.table[s]).sum()) for s, row in zip(pick, rows)]
        msa_differ = sum(1 for g in gaps if g)
        print(f"check: {len(aligned)} strands aligned, {len(pick)} of them worked out again (seconds {timings}), "
              f"{msa_differ} rows differ, entries differing in them {[g for g in gaps if g]}", file=sys.stderr)
        out["msa_rows_differ"] = {"value": msa_differ, "limit": limits["msa_rows_differ"]}
        print(f"check: {self.attempted} trials, codewords wrong per trial {wrong}; "
              f"{recipe.N_STRANDS - len(aligned)} counted rows, {differ} differ", file=sys.stderr)
        return out

    def k2_numbers(self, strands: dict, xs, ys, prog: np.ndarray) -> dict:
        """The K2 numbers of pairs ``xs``/``ys`` whose posteriors the
        program gave as ``prog`` ([P, Lmax, Lmax])."""
        limits = self.limits
        owners: dict = {}
        for s, rs in strands.items():
            for p, _ in rs:
                owners.setdefault(p, set()).add(s)
        unknown = sum(1 for x, y in zip(xs, ys) if not (owners.get(x, set()) & owners.get(y, set())))
        at_rest = getattr(torch, self.config["precision"]["msa_posteriors_at_rest"])
        ref = ref_pairhmm.posteriors(xs, ys, self.device, at_rest)
        gap = max(float(np.abs(prog[k, : len(x), : len(y)] - r).max()) for k, (x, y, r) in enumerate(zip(xs, ys, ref)))
        print(f"check: {len(xs)} K2 pairs, {unknown} not of one strand, widest posterior gap {gap!r}", file=sys.stderr)
        return {"k2_pairs_unknown": {"value": unknown, "limit": limits["k2_pairs_unknown"]},
                "k2_post_maxdiff": {"value": gap, "limit": limits["k2_post_maxdiff"]}}
