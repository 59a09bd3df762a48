"""K2's share of its roofline in the trial window: the least time the card
needs for the pair-HMM work of the window's K2 pairs, over the device time
of K2's launches (CUDA events around each launch, the program's span
``msa.k2``; read while the profiler records).

The work is the algorithm's, counted from the recurrences of
``reference/pairhmm.py``, not an implementation's. Per interior cell of a
pair's lx x ly plane: the forward recurrence takes a log-sum-exp over the
five states into M and over two states (M and itself) into each of IX,
IY, JX, JY — 13 exponentials and 5 logarithms; the backward recurrence in
natural coordinates the same 18; the posterior one more exponential: 37
special-function results (the start state's terms are left out: they are
not zero only at the origin, and the reference's backward-by-reversal and
its extra log-sum-exp for B_M are one way of computing the backward M
value, which the natural recurrence already holds). Float32 operations: a
log-sum-exp of k terms is 4k - 1 (k transition adds, k - 1 maxima, k
subtractions, k - 1 adds of the exponentials, the maximum added back),
plus one emission add per state: 52 forward, 52 backward, and 4 for the
posterior (F + B, minus the total, the clamp at 0, the compare with 0.01):
108. Bytes: the two reads' codes read once (lx + ly bytes) and the lx x ly
posteriors written once at rest in bf16 (2 B each). Cells, pairs and
residues come from the program's counts on ``msa.k2``: ``cells`` =
sum of (lx + 1)(ly + 1), so the interior cells are cells - residues -
pairs. The bound is the largest of the special-function, float32 and
memory times at the card's published peaks (``benchlib/peaks.py``)."""

from benchlib import peaks, spans

SFU_PER_CELL = 37
FLOP_PER_CELL = 108
POST_BYTES = 2


def bound_s(interior: float, residues: float, p: dict) -> float:
    return max(SFU_PER_CELL * interior / peaks.sfu_per_s(p),
               FLOP_PER_CELL * interior / p["fp32_flops"],
               (POST_BYTES * interior + residues) / p["hbm_bytes_per_s"])


def read(rec):
    p = peaks.peaks_of(rec.counters.get("kind", ""))
    trials = spans.window_trials(rec)
    if p is None or trials is None:
        return None
    cells = spans.counted(trials, "msa.k2", "cells")
    residues = spans.counted(trials, "msa.k2", "residues")
    pairs = spans.counted(trials, "msa.k2", "pairs")
    if cells <= 0:
        return None
    return spans.roofline_share(bound_s(cells - residues - pairs, residues, p),
                                spans.device_seconds(trials, "msa.k2"))
