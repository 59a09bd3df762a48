"""The windowed BP's share of its roofline in the SC-LDPC window: the
least time the card needs for the sum-product work the window's decode
calls ran, over the event-timed device seconds of the program's
``scldpc.window`` spans (CUDA events around each window's launches).

The work is counted as ``k1_roofline.sim`` counts it: per edge and
iteration 2 special-function results and 5 float32 operations; per
window 5 bytes a variable of each frame (its LLR read, its decision
written). The edge-iterations are the program's ``edge_iterations``
counts: a window's edges times the frames still live in each of its
iterations, so a frame counts the iterations it ran. The bound is the
largest of the special-function, float32 and memory times at the card's
published peaks (``benchlib/peaks.py``)."""

from benchlib import calls, peaks, spans

SFU_PER_EDGE_ITER = 2
FLOP_PER_EDGE_ITER = 5
BYTES_PER_VAR = 5


def bound_s(edge_iterations: float, window_vars: float, p: dict) -> float:
    return max(SFU_PER_EDGE_ITER * edge_iterations / peaks.sfu_per_s(p),
               FLOP_PER_EDGE_ITER * edge_iterations / p["fp32_flops"],
               BYTES_PER_VAR * window_vars / p["hbm_bytes_per_s"])


def read(rec):
    p = peaks.peaks_of(rec.counters.get("kind", ""))
    records = calls.window_calls(rec)
    if p is None or records is None:
        return None
    edge_iterations = spans.counted(records, "scldpc.window", "edge_iterations")
    windows = spans.counted(records, "scldpc.window", "windows")
    if edge_iterations <= 0:
        return None
    window_vars = windows * rec.counters["batch"] * rec.counters["window_vars"]
    return spans.roofline_share(bound_s(edge_iterations, window_vars, p),
                                spans.device_seconds(records, "scldpc.window"))
