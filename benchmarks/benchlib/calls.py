"""The program's own record of each SC-LDPC decode call, as the readers
of the ``sc`` metrics take it.

``dna_ldpc_tpu_torch.utils.profiling.recent_records(root)`` holds the
span tree of the program's last calls whose root span is ``root``
(``sliding_window_decode``'s ``scldpc.sliding_window``), in the form
``benchlib/spans.py`` describes for trials: one ``scldpc.window`` span
per window with its counts ``windows``, ``iterations``,
``edge_iterations`` and ``waits`` and, where a profiler recorded, its
device seconds (CUDA events around the window's launches). The window's
calls are the last ``len(rec.units)`` records: no call is decoded after
the window. A program that keeps no such record gives None, and so does
every reader."""

from __future__ import annotations

SLIDING_WINDOW = "scldpc.sliding_window"


def window_calls(rec, root: str = SLIDING_WINDOW) -> list | None:
    """The records of the window's decode calls, or None where the program
    keeps none (or fewer than the window's calls)."""
    if not rec.units:
        return None
    try:
        from dna_ldpc_tpu_torch.utils import profiling
    except ImportError:
        return None
    recent = getattr(profiling, "recent_records", None)
    if recent is None:
        return None
    calls = recent(root)
    if len(calls) < len(rec.units):
        return None
    return calls[-len(rec.units):]
