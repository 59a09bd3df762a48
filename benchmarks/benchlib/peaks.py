"""Published peaks of the cards the benchmark runs on.

NVIDIA H100 SXM5 (H100 80GB HBM3), NVIDIA's data sheet and the CUDA C++
Programming Guide's throughput table for compute capability 9.0, at the
card's maximum boost clock and its full power limit of 700 W (a card set
below it runs slower under load; the harness prints the limit beside every
share): 132 SMs at 1,980 MHz; 67 TFLOP/s in float32 outside the tensor
cores; 16 special-function results (tanh, log, exp, reciprocal: the MUFU
unit) per clock and SM; 3.35 TB/s of HBM3.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "sms": 132,
        "clock_hz": 1.98e9,
        "fp32_flops": 67e12,
        "sfu_per_clock_sm": 16,
        "hbm_bytes_per_s": 3.35e12,
        "power_w": 700.0,
    },
}


def peaks_of(kind: str) -> dict | None:
    """The peaks of the card called ``kind``, or None for a card not in
    the table (a roofline share is then not reported)."""
    return PEAKS.get(kind)


def sfu_per_s(p: dict) -> float:
    return p["sms"] * p["clock_hz"] * p["sfu_per_clock_sm"]
