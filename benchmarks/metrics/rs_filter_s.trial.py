"""Seconds per trial in the RS index filter (``pipeline/llr.py::
rs_filter_reads``): ``TrialResult.phase_times["rs_decode"]``, mean over
the window's trials."""

from benchlib.readers import mean_phase


def read(rec):
    return mean_phase(rec, ("rs_decode",))
