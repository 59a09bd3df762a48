"""What a ``torch.profiler`` Chrome trace says about the device.

``Trace.load`` reads the trace the harness wrote for the measured window.
Device activity is every event of the categories ``kernel``,
``gpu_memcpy`` and ``gpu_memset``; the card is busy over the union of
their intervals (the arithmetic of the repository's ``trace_trial.py``),
idle over the rest of the window. A device event belongs to a host span
(a ``record_function`` range the benchmark opened around a call into the
program) when the runtime call that launched it (matched by its
``correlation`` id) started inside the span: a kernel counts for the span
that launched it, whatever its name.
"""

from __future__ import annotations

import json
from bisect import bisect_right
from dataclasses import dataclass, field

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


def union_length(intervals) -> float:
    """Total length covered by [a, b) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


@dataclass
class Trace:
    window: tuple[float, float]                      # us
    device: list = field(default_factory=list)       # (ts, end, name, category, correlation)
    launches: dict = field(default_factory=dict)     # correlation -> host ts of the runtime call
    spans: list = field(default_factory=list)        # (ts, end, name) benchmark ranges on the host

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        windows = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
                   and e.get("cat") == "user_annotation"]
        if len(windows) != 1:
            raise RuntimeError(f"expected one {WINDOW!r} range in the trace, found {len(windows)}")
        w = windows[0]
        out = cls(window=(w["ts"], w["ts"] + w["dur"]))
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATEGORIES:
                out.device.append((e["ts"], e["ts"] + e["dur"], e.get("name", "?"), cat, corr))
            elif cat == "cuda_runtime" and corr is not None:
                out.launches[corr] = e["ts"]
            elif cat == "user_annotation" and e.get("name", "").startswith("bench.") and e is not w:
                out.spans.append((e["ts"], e["ts"] + e["dur"], e["name"]))
        out.device.sort()
        return out

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def clipped(self):
        w0, w1 = self.window
        for a, b, name, cat, corr in self.device:
            a2, b2 = max(a, w0), min(b, w1)
            if b2 > a2:
                yield a2, b2, name, cat, corr

    def busy_s(self) -> float:
        return union_length((a, b) for a, b, *_ in self.clipped()) / 1e6

    def n_device_ops(self) -> int:
        return sum(1 for _ in self.clipped())

    def in_spans(self, name: str):
        """Device events launched inside the host spans called ``name``."""
        ranges = sorted((a, b) for a, b, n in self.spans if n == name)
        starts = [a for a, _ in ranges]
        for ev in self.device:
            t = self.launches.get(ev[4])
            if t is None:
                continue
            k = bisect_right(starts, t) - 1
            if k >= 0 and t <= ranges[k][1]:
                yield ev

    def span_device_s(self, name: str) -> float:
        """Summed device time of the events launched inside ``name`` spans."""
        return sum(b - a for a, b, *_ in self.in_spans(name)) / 1e6

    def top_ops(self, n: int = 10):
        """[[name, seconds]] of the device operations with most time."""
        by: dict = {}
        for a, b, name, *_ in self.clipped():
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10):
        """[[host span, seconds]]: the window's idle time on the device,
        each gap charged to the innermost benchmark span open on the host
        at its middle ("bench.window" where none is), largest first."""
        w0, w1 = self.window
        gaps, end = [], w0
        for a, b, *_ in self.clipped():
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if w1 > end:
            gaps.append((end, w1))
        named: dict = {}
        for s0, s1, name in sorted(self.spans):
            named.setdefault(name, ([], []))
            named[name][0].append(s0)
            named[name][1].append(s1)
        by: dict = {}
        for a, b in gaps:
            mid, best = (a + b) / 2, (float("inf"), WINDOW)
            for name, (starts, ends) in named.items():  # spans of one name do not overlap
                k = bisect_right(starts, mid) - 1
                if k >= 0 and mid <= ends[k]:
                    best = min(best, (ends[k] - starts[k], name))
            by[best[1]] = by.get(best[1], 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
