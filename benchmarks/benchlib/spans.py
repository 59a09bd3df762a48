"""The program's own record of each trial, as the readers of
``program_span`` and ``program_counter`` metrics take it.

``dna_ldpc_tpu_torch.utils.profiling.recent_trials()`` holds the span
tree of the program's last trials (``decode_trial``'s root span
``trial``): each span a dict of ``name``, ``parent`` (index, -1 for the
root), ``kind`` ("host" where the span's own code launches nothing on the
card), ``host_s``, ``device_s`` (CUDA-event seconds, only where a profiler
recorded and the program timed the span's launches; else None) and
``counts``. The window's trials are the last ``len(rec.units)`` records:
no trial is decoded after the window. A program that keeps no
such record (an older one) gives None, and so does every reader."""

from __future__ import annotations


def window_trials(rec) -> list | None:
    """The records of the window's trials, or None where the program keeps
    none (or fewer than the window's trials)."""
    if not rec.units:
        return None
    try:
        from dna_ldpc_tpu_torch.utils import profiling
    except ImportError:
        return None
    recent = getattr(profiling, "recent_trials", None)
    if recent is None:
        return None
    trials = recent()
    if len(trials) < len(rec.units):
        return None
    return trials[-len(rec.units):]


def named(trial: list, name: str):
    """The spans of one trial called ``name``."""
    return [s for s in trial if s["name"] == name]


def counted(trials: list, name: str, key: str) -> int:
    """The count ``key`` summed over the spans ``name`` of ``trials``."""
    return sum(s["counts"].get(key, 0) for t in trials for s in named(t, name))


def device_seconds(trials: list, name: str) -> float | None:
    """The device seconds summed over the spans ``name`` of ``trials``;
    None where no span of that name was timed on the card."""
    timed = [s["device_s"] for t in trials for s in named(t, name) if s["device_s"] is not None]
    return sum(timed) if timed else None


def under(trial: list, index: int, name: str) -> bool:
    """Whether span ``index`` of ``trial`` lies below a span called
    ``name``."""
    p = trial[index]["parent"]
    while p >= 0:
        if trial[p]["name"] == name:
            return True
        p = trial[p]["parent"]
    return False


def roofline_share(bound_s: float, device_s: float | None) -> float | None:
    """Percent of the device time the least time would take."""
    if device_s is None or device_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / device_s
