"""Device milliseconds per BP iteration of a window in the SC-LDPC
window: the event-timed device seconds of the program's ``scldpc.window``
spans (CUDA events around each window's launches, read while the
profiler records) over the BP iterations those windows ran (their
``iterations`` counts, each an iteration of the whole batch)."""

from benchlib import calls, spans


def read(rec):
    records = calls.window_calls(rec)
    if records is None:
        return None
    device_s = spans.device_seconds(records, "scldpc.window")
    iterations = spans.counted(records, "scldpc.window", "iterations")
    if device_s is None or iterations <= 0:
        return None
    return 1e3 * device_s / iterations
