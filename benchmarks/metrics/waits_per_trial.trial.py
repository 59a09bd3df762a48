"""Blocking waits of the host on the card per trial: the program's count
``waits`` over every span of each window trial's record (each explicit
synchronize, download, pageable upload and ``bool()`` of a device tensor
on the trial path, counted where the program's own code makes it), mean
over the window's trials."""

import statistics

from benchlib import spans


def read(rec):
    trials = spans.window_trials(rec)
    if trials is None:
        return None
    return statistics.fmean(sum(s["counts"].get("waits", 0) for s in t) for t in trials)
