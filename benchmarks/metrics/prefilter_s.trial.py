"""Seconds per trial in the edit-distance pre-filter (``ops/editdist.py``
on the card, with the batched route's pair building):
``phase_times["llr_edit_prefilter"]``, mean over the window's trials."""

from benchlib.readers import mean_phase


def read(rec):
    return mean_phase(rec, ("llr_edit_prefilter",))
