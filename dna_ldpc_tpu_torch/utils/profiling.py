"""The port's tracer: nested spans on the host clock, counts on them, and
the last trials' records.

Port of ``dna_ldpc_tpu/utils/profiling.py``. The reference's
observability is wall-clock prints per phase (decoder.py:47-676) plus
elapsed time in result files (DNA_main.cpp:1092-1101). Here:

- ``span(name, kind=..., timings=..., key=...)`` — a named range of the
  host clock (``time.perf_counter``), nested in the span open around it
  in the same thread. ``kind="host"`` marks a span whose code launches
  nothing on the card. With ``timings`` and ``key`` its seconds are added
  to ``timings[key]`` when it closes (how ``TrialResult.phase_times`` and
  the ``timings=`` dicts are filled). While a ``torch.profiler`` session
  records, the span also opens a ``record_function`` range of its name,
  so the program's spans sit in the device trace, nested as here, around
  the kernels they launch; otherwise it costs two clock reads and an
  append;
- a span opened with ``root=True`` where no record is open in its
  thread (``decode_trial``'s ``trial``, the SC-LDPC decoders'
  ``scldpc.sliding_window`` and ``scldpc.pipeline``) opens one: every
  span below it is kept as (name, parent, kind, start, host seconds,
  device seconds, counts), and the record joins a ring of the last
  ``RING`` records of its root's name when the root closes
  (``recent_records``; ``recent_trials`` for ``trial``);
- ``count(name, n)`` adds to the innermost open span of a record;
  ``wait(device, n)`` counts ``n`` blocking waits of the host on the card
  (a synchronize, a download, a pageable upload, ``bool()`` of a device
  tensor) where ``device`` is a CUDA device; ``tracing()`` says whether
  a count that costs more than constant host work should be taken (a
  profiler records and a record is open);
- ``device_time(device)`` — while a profiler records, a pair of CUDA
  events on the current stream around the enclosed launches; the root
  reads their elapsed time into the innermost span's device seconds when
  it closes (events are not kernels, copies or memsets);
- ``PhaseTimer`` (named-phase wall timings, reported as the JAX package
  reports them) and ``annotate`` (a named range) — names over ``span``;
- ``device_trace`` — a ``torch.profiler`` capture of the enclosed block
  (CPU activity, plus the card's kernels when CUDA is present) written as
  a Chrome trace into a directory, viewable in Perfetto or
  ``chrome://tracing``.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from dataclasses import dataclass, field

import torch

HOST, DEVICE = "host", "device"
RING = 256  # records kept per root name

_rings: dict[str, collections.deque] = {}
_local = threading.local()
_NULL = contextlib.nullcontext()


def profiling() -> bool:
    """Whether a ``torch.profiler`` session records in this process."""
    return torch._C._autograd._profiler_enabled()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Record:
    """The record open in a thread: its spans, in opening order, and
    the CUDA event pairs still to be read."""

    __slots__ = ("spans", "t0", "events")

    def __init__(self):
        self.spans: list[dict] = []
        self.t0 = 0.0  # the root's start, set when its clock is read
        self.events: list = []

    def close(self) -> list[dict]:
        for entry, start, end in self.events:
            end.synchronize()
            entry["device_s"] = (entry["device_s"] or 0.0) + start.elapsed_time(end) / 1e3
        return self.spans


class span:
    """A named span of the host clock (module docstring), used as a
    context manager."""

    __slots__ = ("name", "kind", "timings", "key", "root", "_t0", "_range", "_entry", "_index", "_record")

    def __init__(self, name: str, kind: str = DEVICE, timings: dict | None = None, key: str | None = None,
                 root: bool = False):
        self.name, self.kind, self.timings, self.key, self.root = name, kind, timings, key, root

    def __enter__(self):
        st = _stack()
        rec = getattr(_local, "record", None)
        self._record = self._entry = None
        if rec is None and self.root:
            rec = self._record = _local.record = _Record()
        if rec is not None:
            parent = st[-1]._index if st and st[-1]._entry is not None else -1
            self._index = len(rec.spans)
            self._entry = {"name": self.name, "parent": parent, "kind": self.kind, "start_s": 0.0,
                           "host_s": 0.0, "device_s": None, "counts": {}}
            rec.spans.append(self._entry)
        st.append(self)
        self._range = None
        if profiling():
            self._range = torch.autograd.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        if self._record is not None:
            rec.t0 = self._t0
        if self._entry is not None:
            self._entry["start_s"] = self._t0 - rec.t0
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        _stack().pop()
        if self._entry is not None:
            self._entry["host_s"] = dt
        if self.timings is not None and self.key is not None:
            self.timings[self.key] = self.timings.get(self.key, 0.0) + dt
        if self._record is not None:
            _local.record = None
            if exc_type is None:
                ring = _rings.setdefault(self.name, collections.deque(maxlen=RING))
                ring.append(self._record.close())
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the count ``name`` of the innermost open span of a
    record (nothing outside one)."""
    st = _stack()
    if st:
        e = st[-1]._entry
        if e is not None:
            c = e["counts"]
            c[name] = c.get(name, 0) + n


def wait(device, n: int = 1) -> None:
    """Count ``n`` blocking waits of the host on ``device`` (only a CUDA
    device makes the host wait) on the innermost open span."""
    if (device.type if isinstance(device, torch.device) else torch.device(device).type) == "cuda":
        count("waits", n)


def tracing() -> bool:
    """Whether a profiler records and this thread's record is open:
    the condition for counts that cost more than constant host work."""
    return getattr(_local, "record", None) is not None and profiling()


class _Events:
    __slots__ = ("entry", "device", "start", "end")

    def __init__(self, entry: dict, device):
        self.entry, self.device = entry, device

    def __enter__(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.start.record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc):
        self.end.record(torch.cuda.current_stream(self.device))
        _local.record.events.append((self.entry, self.start, self.end))
        return False


def device_time(device):
    """Time the enclosed launches on ``device`` with a CUDA event pair into
    the innermost span's device seconds, while a profiler records and a
    record is open; else a no-op context."""
    st = _stack()
    if not st or st[-1]._entry is None or torch.device(device).type != "cuda" or not profiling():
        return _NULL
    return _Events(st[-1]._entry, device)


def recent_records(root: str) -> list[list[dict]]:
    """The last ``RING`` records whose root span is called ``root``, oldest
    first. A record is the list of its spans in opening order (the root
    first), each a dict of ``name``, ``parent`` (index in the list, -1 for
    the root), ``kind``, ``start_s`` (host seconds after the root opened),
    ``host_s``, ``device_s`` (None where no event timed it) and
    ``counts``."""
    return list(_rings.get(root, ()))


def recent_trials() -> list[list[dict]]:
    """The records of the last ``RING`` trials (``decode_trial``'s root
    span ``trial``), oldest first, as ``recent_records`` gives them."""
    return recent_records("trial")


@dataclass
class PhaseTimer:
    times: dict = field(default_factory=dict)

    def phase(self, name: str) -> span:
        return span(name, timings=self.times, key=name)

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{name:>20}: {t:8.3f} s" for name, t in self.times.items()]
        lines.append(f"{'total':>20}: {total:8.3f} s")
        return "\n".join(lines)


TRACE_FILE = "trace.json"  # the Chrome trace device_trace writes into its log_dir


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the enclosed block with ``torch.profiler`` (CPU, and CUDA
    when a card is present) and write ``log_dir/trace.json``. Yields the
    profiler, whose ``key_averages()`` and ``events()`` hold the same
    events."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str) -> span:
    """A named range in profiler traces (a ``span``)."""
    return span(name)
