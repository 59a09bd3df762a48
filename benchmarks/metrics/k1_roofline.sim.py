"""K1's share of its roofline in the simulator window: the least time the
card needs for the sum-product work the window's frames ran, over the
device time of every kernel launched inside the benchmark's spans around
``bp_decode`` (whatever the kernels' names).

The work is the algorithm's, not an implementation's: per edge and
iteration one tanh and one atanh (2 special-function results), the
leave-one-out products (3 multiplications), the posterior sum and the
extrinsic difference (2 additions); the bytes are each frame's channel
LLRs read once (4 B a bit) and its decisions written once (1 B a bit).
Iterations are those each frame ran (the program's ``mean_iters`` of each
call times its frames). The bound is the largest of the special-function,
float32 and memory times at the card's published peaks
(``benchlib/peaks.py``)."""

from benchlib import peaks

SFU_PER_EDGE_ITER = 2
FLOP_PER_EDGE_ITER = 5
BYTES_PER_BIT = 5


def bound_s(edge_iterations: float, frame_bits: float, p: dict) -> float:
    return max(SFU_PER_EDGE_ITER * edge_iterations / peaks.sfu_per_s(p),
               FLOP_PER_EDGE_ITER * edge_iterations / p["fp32_flops"],
               BYTES_PER_BIT * frame_bits / p["hbm_bytes_per_s"])


def read(rec):
    p = peaks.peaks_of(rec.counters.get("kind", ""))
    if rec.trace is None or p is None or not rec.units:
        return None
    device_s = rec.trace.span_device_s("bench.bp_decode")
    if device_s <= 0:
        return None
    n_vars = rec.counters["n_vars"]
    iters = sum(u["mean_iters"] * u["frames"] for u in rec.units)
    frames = sum(u["frames"] for u in rec.units)
    return 100.0 * bound_s(iters * rec.counters["edges"], frames * n_vars, p) / device_s
