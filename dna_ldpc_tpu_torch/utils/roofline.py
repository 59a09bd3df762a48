"""The least time an NVIDIA H100 could take for the work of each of the
port's kernels: the larger of the bytes the function must move (each input
read once, each output written once) over the card's memory rate and the
operations it does on these inputs over the card's peak rate for their
type. Pure Python, no torch: ``chip_smoke.py`` and ``kernel_times.py`` call
it with the shapes and iteration counts of the run they timed.

Peaks (NVIDIA's H100 SXM data sheet): 3.35 TB/s of device memory, 67
TFLOP/s of f32 outside the tensor cores; the special-function units
(reciprocal, exp2, log2: one ``MUFU`` operation each) deliver 16 results
per clock on each of the 132 SMs, at the SM clock ``nvidia-smi`` reports
as its maximum. Every f32 machine operation is counted once against
the 67 TFLOP/s (which counts a fused multiply-add as two), so the f32 time
is a floor, not an estimate.

Operation counts, read off the recurrences with libdevice's routines
(``expf``: one exp2 and ~8 f32 operations; ``logf``: one log2 and ~12;
``tanhf``: one exp2, one reciprocal and ~12; a division: one reciprocal
and ~8):

- K1, per edge and iteration: the division, ``logf`` and ``tanhf`` give 4
  special-function operations; with the three sweep multiplies, the clip,
  the posterior add and the bf16 roundings ~40 f32 operations. The
  initial ``tanhf`` per edge adds 2 and ~15.
- K2, per cell of a pair's (lx + 1) x (ly + 1) box: forward 13 ``expf`` +
  5 ``logf``, backward 14 ``expf`` + 5 ``logf`` = 37 special-function
  operations and ~440 f32 operations.
- ``merge_dp`` (BuildPost + the MEA DP), per cell of a cluster's
  (wA + 1) x (wB + 1) box: |A| |B| adds, |B| roundings to bf16 and the
  DP's one add, two compares and the choice code (~4); its bytes are the
  wA x wB entries that the column maps address in each of the |A| x |B|
  pairs of the pair tensor that the masks select, each read once (no
  entry outside the box can reach the output).
- the window kernel (``csrc/window_bp.cu``), per edge and frame-iteration
  run: 2 special-function and 5 f32 operations, and 5 bytes a variable of
  each frame (its LLR in, its decision out): the counts of the
  benchmark's ``wbp_roofline.sc``, so that the two read alike.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SMS = 132
MUFU_PER_CLK_PER_SM = 16
DEFAULT_SM_CLOCK_MHZ = 1980.0

K1_MUFU_PER_EDGE_ITER, K1_F32_PER_EDGE_ITER = 4, 40
K1_MUFU_PER_EDGE_INIT, K1_F32_PER_EDGE_INIT = 2, 15
K2_MUFU_PER_CELL, K2_F32_PER_CELL = 37, 440
MEA_F32_PER_CELL = 4
WBP_MUFU_PER_EDGE_ITER, WBP_F32_PER_EDGE_ITER = 2, 5


def bound_ms(n_bytes: float, f32_ops: float, mufu_ops: float = 0.0,
             sm_clock_mhz: float = DEFAULT_SM_CLOCK_MHZ) -> tuple[float, str]:
    """(least milliseconds, "bytes" or "operations") for the given work."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(f32_ops / F32_OPS_PER_S, mufu_ops / (MUFU_PER_CLK_PER_SM * SMS * sm_clock_mhz * 1e6))
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k1_bound_ms(n_edges: int, n_vars: int, iterations, sm_clock_mhz: float = DEFAULT_SM_CLOCK_MHZ):
    """K1 on a batch: ``iterations`` is the number of iterations each
    codeword's block ran (the returned count when early-stopped, max_iter
    for every word in fixed-work mode). Bytes: f32 LLRs in, one byte per
    bit out, unsat and iterations out."""
    iters = [int(i) for i in iterations]
    B, total = len(iters), sum(iters)
    mufu = n_edges * (K1_MUFU_PER_EDGE_ITER * total + K1_MUFU_PER_EDGE_INIT * B)
    f32 = n_edges * (K1_F32_PER_EDGE_ITER * total + K1_F32_PER_EDGE_INIT * B)
    return bound_ms(B * (5 * n_vars + 8), f32, mufu, sm_clock_mhz)


def k2_bound_ms(lx, ly, Lmax: int, sm_clock_mhz: float = DEFAULT_SM_CLOCK_MHZ):
    """K2 on a batch of pairs with lengths ``lx``, ``ly``. Bytes: the
    codes and lengths in, the f32 posteriors [Lmax, Lmax] and the EA score
    out."""
    P = len(lx)
    cells = sum((int(a) + 1) * (int(b) + 1) for a, b in zip(lx, ly) if int(a) and int(b))
    n_bytes = P * (2 * Lmax + 8 + 4 * Lmax * Lmax + 4)
    return bound_ms(n_bytes, K2_F32_PER_CELL * cells, K2_MUFU_PER_CELL * cells, sm_clock_mhz)


def merge_bound_ms(nA, nB, wA, wB, Cmax: int, sm_clock_mhz: float = DEFAULT_SM_CLOCK_MHZ):
    """``merge_dp`` on a batch of clusters whose operands hold ``nA``,
    ``nB`` sequences and are ``wA``, ``wB`` columns wide (one entry per
    cluster). Bytes in: of each of the |A| x |B| pairs of the pair tensor
    that the masks select, the wA x wB entries (bf16) that the members' column
    maps address; the first wA (wB) entries of each member's column map
    (int32); a mask byte per member; the two widths. Bytes out: a code and
    a position per diagonal, 2 Cmax of them."""
    n_bytes = f32 = 0
    for a, b, x, y in zip(map(int, nA), map(int, nB), map(int, wA), map(int, wB)):
        n_bytes += 2 * a * b * x * y + 4 * (a * x + b * y) + a + b + 8 + 2 * Cmax * 5
        f32 += (x + 1) * (y + 1) * (a * b + b + MEA_F32_PER_CELL)
    return bound_ms(n_bytes, f32, 0.0, sm_clock_mhz)


def window_bp_bound_ms(n_edges: int, n_vars: int, iterations, sm_clock_mhz: float = DEFAULT_SM_CLOCK_MHZ):
    """The window kernel on a batch: ``iterations`` is the number of
    iterations each frame ran (the returned counts)."""
    iters = [int(i) for i in iterations]
    edge_iters = n_edges * sum(iters)
    return bound_ms(5 * n_vars * len(iters), WBP_F32_PER_EDGE_ITER * edge_iters,
                    WBP_MUFU_PER_EDGE_ITER * edge_iters, sm_clock_mhz)
