"""What one run records for its metric readers: a dict per measured unit
(the driver's own readings of the program's phase times and counters),
the host spans the benchmark opens around calls into the program, and, in
a traced run, the device trace of the measured window.

Spans: ``Records.wrap(module, attr, name)`` replaces a function of the
program by one that, in a traced run, opens a ``record_function`` range
called ``name`` (which puts the range and the kernels it launches into the
trace) around the original. Untraced runs install no span. ``capture``
wrappers, which the checks of ``correct`` need, are installed in every
run; ``restore()`` undoes both.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass, field


@dataclass
class Records:
    traced: bool
    units: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    trace: object = None            # benchlib.trace.Trace of the measured window, traced runs only
    _undo: list = field(default_factory=list)

    def span(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def wrap(self, module, attr: str, name: str) -> None:
        """Open the span ``name`` around every call of ``module.attr``
        (traced runs only)."""
        if not self.traced:
            return
        orig = getattr(module, attr)

        @functools.wraps(orig)
        def spanned(*args, **kwargs):
            with self.span(name):
                return orig(*args, **kwargs)

        setattr(module, attr, spanned)
        self._undo.append((module, attr, orig))

    def capture(self, module, attr: str, hook) -> None:
        """Replace ``module.attr`` by ``hook(orig, *args, **kwargs)``."""
        orig = getattr(module, attr)

        @functools.wraps(orig)
        def hooked(*args, **kwargs):
            return hook(orig, *args, **kwargs)

        setattr(module, attr, hooked)
        self._undo.append((module, attr, orig))

    def restore(self) -> None:
        while self._undo:
            module, attr, orig = self._undo.pop()
            setattr(module, attr, orig)
