"""Seconds per trial in BP decoding and epsilon annealing
(``pipeline/decode.py::anneal_decode`` -> ``ops/bp.py`` -> K1): the sum of
``phase_times["first_decode"]`` and ``["second_decode"]``, mean over the
window's trials."""

from benchlib.readers import mean_phase


def read(rec):
    return mean_phase(rec, ("first_decode", "second_decode"))
