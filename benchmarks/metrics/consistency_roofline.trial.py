"""The consistency transform's share of its roofline in the trial window:
the least time the card needs for the transform's products at the reads'
true lengths, over the device time of the program's ``consistency_core``
calls (CUDA events around each, the program's span ``msa.consistency``;
read while the profiler records).

The work is the program's count on ``msa.consistency``
(``ops/msa/consistency.py::transform_work``): per iteration and cluster,
for every pair i < j and every other read z, the product P_iz @ P_zj,
2 L_i L_z L_j float32 operations (padding to the bucket and the block
tensor's zero diagonal blocks not counted); bytes, every pair posterior
read once and written once at rest in bf16. The configuration states the
products in float32 with TF32 off, so the peak is ``fp32_flops``
(``benchlib/peaks.py``); the bound is the larger of the FLOP and the
memory time."""

from benchlib import peaks, spans


def read(rec):
    p = peaks.peaks_of(rec.counters.get("kind", ""))
    trials = spans.window_trials(rec)
    if p is None or trials is None:
        return None
    flops = spans.counted(trials, "msa.consistency", "flops")
    nbytes = spans.counted(trials, "msa.consistency", "bytes")
    if flops <= 0:
        return None
    bound = max(flops / p["fp32_flops"], nbytes / p["hbm_bytes_per_s"])
    return spans.roofline_share(bound, spans.device_seconds(trials, "msa.consistency"))
