"""Driver of the deep, uneven-coverage trial configuration: the trial
driver (``drivers/trial.py``) on reads drawn with negative-binomial
coverage (``benchlib/coverage.py``).

Set-up as the trial driver's, but each read sample draws its own
per-oligo abundances from a gamma of the configuration's shape and then
exactly the traffic's number of reads by multinomial over them
(``common.stream(seed, "reads-<k>")``), through the traffic's channel. So
many strands get far more reads than a uniform draw gives them, and the
MSA's clusters reach 60 reads and more.

``correct``: every number of the trial check, with the aligned strands
of ``msa_rows_differ`` worked out by ``reference/msa_large.py`` (the
consistency products on the card: in numpy on one core a cluster of 60
reads takes tens of seconds), and

- ``large_rows_differ``: the aligned rows the first trial's MSA gave for
  up to ``large_clusters`` clusters of at least ``large_min_reads`` reads
  (drawn from the seed among those the program's ``align_clusters`` was
  given), against the plain alignment of the same reads
  (``reference/msa_large.py``, at the configuration's precisions): the
  rows that differ, summed over the clusters. Where the first trial made
  no call of ``ops.msa.align.align_clusters`` it reads 1,000,000 and
  fails.

``control()`` also puts the plain alignment of those clusters, one
precision below the configuration's, in the program's place.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import time

import numpy as np

from benchlib import code, common, coverage, recipe, spans
from reference import msa_large

NOT_SEEN = 1_000_000  # large_rows_differ where the program's alignment of the first trial was not seen


def _trial_driver():
    """``drivers/trial.py``, loaded from its file as the harness loads a driver."""
    name = "bench_driver_trial"
    if name not in sys.modules:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "trial.py")
        spec = importlib.util.spec_from_file_location(name, path)
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    return sys.modules[name]


class Driver(_trial_driver().Driver):
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, rec):
        super().__init__(config, traffic, seed, device, rec)
        self.large = None

    # -- set-up --------------------------------------------------------------
    def setup(self) -> dict:
        info = super().setup()
        self.rec.capture(self.msa_align, "align_clusters", self._keep_large)
        return info

    def make_inputs(self) -> dict:
        """The stored codewords, and the read samples with negative-binomial
        coverage, from the seed."""
        self.checks = code.deployed_checks()
        enc = code.load_encoder()
        t0 = time.time()
        cw_dev = self.device if self.dev.type == "cuda" else None
        self.cws = enc.random_codewords(self.config["codewords"], common.stream(self.seed, "codewords"), cw_dev)
        if code.syndrome_weight(self.checks, self.cws).any():
            raise RuntimeError("the encoder gave a word that is not a codeword")
        pool = recipe.encode_oligos(self.cws)
        channel = recipe.ChannelModel(**self.traffic["channel"])
        shape = self.config["coverage"]["gamma_shape"]
        self.samples = []
        for k in range(self.config["samples"]):
            rng = common.stream(self.seed, f"reads-{k}")
            picks = coverage.negative_binomial_picks(len(pool), self.traffic["reads"], shape, rng)
            per_oligo = np.bincount(picks, minlength=len(pool))
            print(f"sample {k}: reads per oligo largest {int(per_oligo.max())}, oligos with no read "
                  f"{int((per_oligo == 0).sum())}", file=sys.stderr)
            self.samples.append(coverage.channel_reads(pool, picks, channel, rng))
        return {"encoder_build_s": round(enc.build_s, 4), "inputs_s": round(time.time() - t0, 4)}

    def _keep_large(self, orig, clusters, *args, **kwargs):
        rows = orig(clusters, *args, **kwargs)
        if self.first and self.large is None:
            check = self.config["check"]
            big = [c for c, seqs in enumerate(clusters) if len(seqs) >= check["large_min_reads"]]
            n = min(check["large_clusters"], len(big))
            pick = sorted(common.stream(self.seed, "large-clusters").choice(big, n, replace=False).tolist()) if n else []
            self.large = ([list(clusters[c]) for c in pick], [[r for _, r in sorted(rows[c])] for c in pick])
        return rows

    # -- the window ------------------------------------------------------------
    def end_to_end(self, elapsed: float) -> dict:
        out = super().end_to_end(elapsed)
        trials = spans.window_trials(self.rec)
        for k, t in enumerate(trials[:3] if trials else []):
            buckets: dict = {}
            for s in spans.named(t, "msa.batch"):
                b = buckets.setdefault(s["counts"].get("bucket"), [0, 0, 0, 0.0])
                b[0] += 1
                b[1] += s["counts"].get("clusters", 0)
                b[2] += s["counts"].get("pairs", 0)
                b[3] += s["host_s"]
            fb = [(s["counts"].get("clusters"), s["counts"].get("reads"), round(s["host_s"], 4))
                  for s in spans.named(t, "msa.fallback")]
            print(f"trial {k}: MSA batches by bucket (bucket: batches, clusters, pairs, seconds) "
                  + ", ".join(f"{b}: {v[0]}, {v[1]}, {v[2]}, {v[3]:.4f}" for b, v in sorted(buckets.items(), key=str))
                  + f"; fallback (clusters, reads, seconds) {fb}", file=sys.stderr)
        return out

    # -- correct -----------------------------------------------------------------
    def _aligned_rows(self, strands: dict, pick: list, at_rest: str, products: str, timings=None) -> list:
        c = self.config
        return msa_large.aligned_rows([strands[s] for s in pick], c["trial"]["epsil"], self.device, at_rest,
                                      workers=c["check"]["msa_workers"], products=products, timings=timings)

    def _large_rows(self, at_rest: str, products: str, timings=None) -> list:
        return msa_large.aligned_clusters(self.large[0], self.device, at_rest, products,
                                          workers=self.config["check"]["msa_workers"], timings=timings)

    def control(self) -> str:
        """The trial driver's control, and the large clusters' rows of the
        plain alignment one precision below the configuration's in the
        program's place."""
        what = super().control()
        self.lower_large()
        return what

    def lower_large(self) -> None:
        """Put the plain alignment of the kept large clusters, one precision
        below the configuration's, in the place of the program's rows."""
        if self.large:
            prec = self.config["precision"]
            rows = self._large_rows(common.LOWER[prec["msa_posteriors_at_rest"]],
                                    common.LOWER[prec["consistency_products"]])
            self.large = (self.large[0], rows)

    def check(self) -> dict:
        out = super().check()
        out["large_rows_differ"] = self.large_rows_differ()
        return out

    def large_rows_differ(self) -> dict:
        """The rows of the kept large clusters that differ from the plain
        alignment's, with the limit."""
        limit = self.limits["large_rows_differ"]
        if self.large is None:
            print("check: no call of ops.msa.align.align_clusters was seen in the first trial: large_rows_differ "
                  f"reads {NOT_SEEN}", file=sys.stderr)
            return {"value": NOT_SEEN, "limit": limit}
        seqs, prog = self.large
        prec = self.config["precision"]
        timings = {}
        ref = self._large_rows(prec["msa_posteriors_at_rest"], prec["consistency_products"], timings) if seqs else []
        differ = [sum(a != b for a, b in zip(p, r)) + abs(len(p) - len(r)) for p, r in zip(prog, ref)]
        print(f"check: {len(seqs)} clusters of {[len(q) for q in seqs]} reads worked out again (seconds {timings}), "
              f"rows differing in each {differ}", file=sys.stderr)
        return {"value": sum(differ), "limit": limit}
