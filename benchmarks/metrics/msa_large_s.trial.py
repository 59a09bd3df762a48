"""Seconds per trial aligning the clusters of more than 16 reads, whatever
the route: the program's spans ``msa.batch`` whose count ``bucket`` (the
device MSA's cluster-size bucket of the batch) is above 16, plus the spans
``msa.fallback`` (the host-aligner route), summed in each trial's record,
mean over the window's trials. None where no ``msa.batch`` span counts
its bucket (a program that does not count it)."""

import statistics

from benchlib import spans

BUCKET = 16


def large_seconds(trial: list) -> float:
    return sum(s["host_s"] for s in trial
               if s["name"] == "msa.fallback" or (s["name"] == "msa.batch" and s["counts"].get("bucket", 0) > BUCKET))


def read(rec):
    trials = spans.window_trials(rec)
    if trials is None or not any("bucket" in s["counts"] for t in trials for s in spans.named(t, "msa.batch")):
        return None
    return statistics.fmean(large_seconds(t) for t in trials)
