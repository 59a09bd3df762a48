"""Blocking waits of the host on the card per SC-LDPC decode call: the
program's count ``waits`` over every span of each window call's record
(each window's BP loop reads the number of frames still live once an
iteration, and the call downloads its decisions once), mean over the
window's calls."""

import statistics

from benchlib import calls


def read(rec):
    records = calls.window_calls(rec)
    if records is None:
        return None
    return statistics.fmean(sum(s["counts"].get("waits", 0) for s in r) for r in records)
