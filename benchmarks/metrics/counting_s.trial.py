"""Seconds per trial in the soft-information counting (the native pass
over clusters that need no alignment, ``native_lib``, and the counting
rules over the aligned rows, ``pipeline/llr.py``): the sum of
``phase_times["llr_native_count"]`` and ``["llr_counting"]``, mean over
the window's trials."""

from benchlib.readers import mean_phase


def read(rec):
    return mean_phase(rec, ("llr_native_count", "llr_counting"))
