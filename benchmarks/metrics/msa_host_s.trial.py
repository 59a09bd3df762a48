"""Seconds per trial the MSA spends in its host spans: the program's spans
of ``kind`` "host" below its span ``msa`` (``msa.pairs``: buckets and pair
lists; ``msa.assemble``: each batch's pair ids and masks; ``msa.joins``:
UPGMA; ``msa.masks``: wave and refine masks; ``msa.rows``: the aligned
rows from the column maps; ``msa.host_aligner`` where the fallback runs),
outermost host spans only, mean over the window's trials. Their code
launches nothing on the card: the card waits unless earlier work is still
queued."""

import statistics

from benchlib import spans


def host_seconds(trial: list) -> float:
    total = 0.0
    for k, s in enumerate(trial):
        if s["kind"] != "host" or not spans.under(trial, k, "msa"):
            continue
        p, outer = s["parent"], True
        while p >= 0 and outer:
            outer = trial[p]["kind"] != "host"
            p = trial[p]["parent"]
        if outer:
            total += s["host_s"]
    return total


def read(rec):
    trials = spans.window_trials(rec)
    if trials is None or not any(spans.named(t, "msa") for t in trials):
        return None
    return statistics.fmean(host_seconds(t) for t in trials)
