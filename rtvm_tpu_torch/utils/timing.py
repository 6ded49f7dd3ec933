"""Per-stage timing and host-side spans, the counterpart of
``rtvm_tpu/utils/timing.py``: ``StageTimer`` keeps each stage's total and
count for ``report()`` and a bounded ring of (name, t0, dt, thread) spans for
``write_chrome_trace()`` (chrome://tracing or Perfetto). ``stage(name,
sync=True)`` waits for the CUDA device before it stops the clock.
``jax_profile`` has no counterpart here: ``torch.profiler`` traces the card.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch


class StageTimer:
    """Aggregating stage timer and span recorder; thread-safe."""

    def __init__(self, max_spans: int = 100_000):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.spans: List[Tuple[str, float, float, int]] = []  # (name, t0, dt, tid)
        self._max_spans = max_spans
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str, sync: bool = False):
        t0 = time.perf_counter()
        yield
        if sync and torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        with self._lock:
            self.totals[name] += dt
            self.counts[name] += 1
            if len(self.spans) < self._max_spans:
                self.spans.append((name, t0 - self._epoch, dt, threading.get_ident()))

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} total {total*1e3:9.1f} ms  n={n:5d}  avg {total/n*1e3:8.2f} ms")
        return "\n".join(lines)

    def write_chrome_trace(self, path: str, process_name: str = "rtvm_tpu_torch") -> str:
        """Write the spans as Chrome trace-event JSON (complete 'X' events,
        microsecond timestamps)."""
        with self._lock:
            spans = list(self.spans)
        events = [{
            "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
            "args": {"name": process_name},
        }]
        for name, t0, dt, tid in spans:
            events.append({
                "name": name, "ph": "X", "pid": 1, "tid": tid % 2**31,
                "ts": round(t0 * 1e6, 1), "dur": round(dt * 1e6, 1), "cat": "stage",
            })
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        return path
