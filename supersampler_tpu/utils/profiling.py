"""Phase timers + optional device tracing.

The reference's only instrumentation is chrono wall-clock spans around
comparison and output (reference Comparator.cpp:499-509). This module
adds device-aware equivalents without touching parity output:

* ``phases`` — a process-wide accumulator of named wall-clock spans
  (`with phase("scan"): ...`); ``report()`` renders totals.
* ``device_trace`` — wraps a region in ``jax.profiler.trace`` when the
  SPSP_TRACE env var names a directory (view with TensorBoard or
  xprof); a no-op otherwise, so production paths pay nothing.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict


class PhaseTimers:
    def __init__(self):
        self._lock = threading.Lock()
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] = self.totals.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        with self._lock:
            rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
            return "\n".join(
                f"{name:24s} {tot * 1e3:10.1f} ms  x{self.counts[name]}"
                for name, tot in rows)

    def reset(self):
        with self._lock:
            self.totals.clear()
            self.counts.clear()


timers = PhaseTimers()
phase = timers.phase


@contextlib.contextmanager
def device_trace(label: str = "spsp"):
    """jax.profiler trace into $SPSP_TRACE/<label> when set."""
    out = os.environ.get("SPSP_TRACE")
    if not out:
        yield
        return
    import jax

    with jax.profiler.trace(os.path.join(out, label)):
        yield
