"""Host milliseconds per merge of the device MSA: the program's spans
``msa.merge`` (one ``_merge_step``: the projections, ``merge_dp`` and the
gap insertion, ~183 launches; progressive waves and refine iterations
alike), mean over the window's merges. The host's clock: the time the
host takes to issue a merge, since nothing in it waits on the card."""

from benchlib import spans


def read(rec):
    trials = spans.window_trials(rec)
    if trials is None:
        return None
    ms = [s["host_s"] * 1e3 for t in trials for s in spans.named(t, "msa.merge")]
    return sum(ms) / len(ms) if ms else None
