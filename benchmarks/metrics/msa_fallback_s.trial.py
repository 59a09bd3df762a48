"""Seconds per trial in the MSA's host-aligner fallback: the program's
spans ``msa.fallback`` (the clusters the device MSA cannot take — more
reads than its top bucket, or an alignment past its column budget —
through K2, the consistency transform and the host C++ aligner), summed
in each trial's record, 0 in a trial where none ran, mean over the
window's trials."""

import statistics

from benchlib import spans


def read(rec):
    trials = spans.window_trials(rec)
    if trials is None:
        return None
    return statistics.fmean(sum(s["host_s"] for s in spans.named(t, "msa.fallback")) for t in trials)
