"""Named spans of the port's host work, on the clock of a ``torch.profiler``
trace.

``span(name)`` is ``torch.profiler.record_function(name)`` while a profiler
runs, so that a span shares the trace's clock with the kernels and copies
it launched: an idle gap of the card lines up with the spans open above
it.  With no profiler running it is one shared null context, chosen on
the profiler's module flag without building a ``record_function``
(entering one costs ~10 us even with no profiler to record it).

Spans are recorded from every thread only where the profiler is started
with ``profile_all_threads`` (``utils/device.py::profiled``); otherwise
only those of the thread that started it.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

_NULL = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` in a running profiler's trace."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _NULL
