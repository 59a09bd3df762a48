"""Percent of the traced trial window in which the card ran nothing: the
window's length less the union of its kernel, copy and memset intervals."""

from benchlib.readers import idle_share


def read(rec):
    return idle_share(rec)
