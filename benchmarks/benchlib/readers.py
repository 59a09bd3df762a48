"""Arithmetic the per-layer metric readers share. Each returns None when
the run recorded nothing to read, and the harness then leaves the metric
out of the result line."""

from __future__ import annotations

import statistics


def mean_phase(rec, keys) -> float | None:
    """Mean over the window's trials of the sum of the program's phase
    times ``keys`` (``TrialResult.phase_times``, host clock, each stage on
    the card ending in a synchronize)."""
    units = [u for u in rec.units if any(k in u.get("phase_times", {}) for k in keys)]
    if not units:
        return None
    return statistics.fmean(sum(u["phase_times"].get(k, 0.0) for k in keys) for u in units)


def idle_share(rec) -> float | None:
    """Percent of the traced window in which no kernel, copy or memset ran
    on the card."""
    t = rec.trace
    if t is None or t.window_s <= 0:
        return None
    busy = t.busy_s()
    if busy <= 0:
        return None
    return 100.0 * (t.window_s - busy) / t.window_s
