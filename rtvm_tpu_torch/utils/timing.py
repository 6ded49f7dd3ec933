"""The port's one recorder of spans and counters, the counterpart of
``rtvm_tpu/utils/timing.py``.

``StageTimer`` keeps each stage's total and count for ``report()`` and a
ring of the newest ``max_spans`` span records for ``write_chrome_trace()``
(chrome://tracing or Perfetto). A record holds the span's name, its start
and end, the index of the span that encloses it (its parent), the request
(the window or chunk) it belongs to, its counts and, for a window or chunk,
the time the device finished it (``done``).

``span(name)`` marks a span in ``torch.profiler``'s trace and, while a
timer is active on the thread (``with timer.active():``), records it there;
``count(name, n)`` adds to the innermost open span's counts and to the
active timer's ``counters``. Without an active timer ``span`` only marks
the profiler's trace and ``count`` does nothing. ``stage(name)`` is a span
of its own timer that also adds to ``totals`` and ``counts`` and makes the
timer active while it is open, so the driver's stages (``window``,
``detect``, ``clip``, ...) record the spans inside them;
``stage(name, sync=True)`` waits for the CUDA device before it stops the
clock.

Every span enters the profiler as a host event. ``span(name,
device_range=True)`` enters ``torch.profiler.record_function`` instead, a
user annotation, which the profiler also gives a range on the device (from
the first kernel launched inside it to the last); the window step's spans
and ``clip.detect`` take one, and every kernel launched inside them belongs
to them.

Clock: the records are ``time.perf_counter_ns`` readings. The timer reads
``perf_counter_ns`` and ``time_ns`` together when it is made, and
``unix_ns`` places a reading on the Unix clock that the profiler's events
use, so that ``write_chrome_trace``'s ``ts`` (Unix microseconds) lays over
a ``torch.profiler`` trace of the same run.

Device completion: after ``device_reference(dev)`` (one synchronize),
``mark_done(record)`` records a CUDA event behind the work queued so far,
and ``resolve_done()``, after the caller's own synchronize, sets each
marked record's ``done`` from its event. ``jax_profile`` has no
counterpart here: ``torch.profiler`` traces the card.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict, deque
from typing import Deque, Dict, List, Tuple

import torch
from torch.profiler import record_function

try:
    from torch._C._autograd import _profiler_enabled
    from torch._C._profiler import _RecordFunctionFast
except ImportError:  # an older torch: the spans stay out of the profiler's trace
    _RecordFunctionFast = None

_local = threading.local()  # .timer: the thread's active StageTimer


class SpanRecord:
    """One span: ``t0``, ``t1`` and ``done`` are ``perf_counter_ns``
    readings (``t1`` None while it is open, ``done`` None unless marked);
    ``index`` counts the timer's spans from 0, ``parent`` is the enclosing
    span's index (-1 for none)."""

    __slots__ = ("name", "index", "parent", "request", "t0", "t1", "done", "tid", "counts")

    def __init__(self, name: str, index: int, parent: int, request, t0: int, tid: int):
        self.name, self.index, self.parent, self.request = name, index, parent, request
        self.t0, self.t1, self.done, self.tid = t0, None, None, tid
        self.counts: Dict[str, int] = {}


class StageTimer:
    """Aggregating stage timer and span recorder; thread-safe."""

    def __init__(self, max_spans: int = 100_000):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, int] = defaultdict(int)
        self.records: Deque[SpanRecord] = deque(maxlen=max_spans)  # the newest, oldest first
        self.request = None  # the window or chunk that new spans belong to (set by the driver)
        self._next = 0
        self._lock = threading.Lock()
        self._open = threading.local()  # .stack: this thread's open records
        self._epoch = time.perf_counter_ns()
        self._unix_offset = time.time_ns() - self._epoch
        self._marks: List[Tuple[SpanRecord, "torch.cuda.Event"]] = []
        self._ref = None  # (CUDA event, perf_counter_ns) recorded on an idle device

    # ---------------------------------------------------------------- spans
    @contextlib.contextmanager
    def active(self):
        """Make this timer the thread's active one (``span``, ``count``)."""
        prev = getattr(_local, "timer", None)
        _local.timer = self
        try:
            yield self
        finally:
            _local.timer = prev

    def _stack(self) -> List[SpanRecord]:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack

    @contextlib.contextmanager
    def _span(self, name: str):
        stack = self._stack()
        with self._lock:
            rec = SpanRecord(name, self._next, stack[-1].index if stack else -1, self.request,
                             time.perf_counter_ns(), threading.get_ident())
            self._next += 1
            self.records.append(rec)
        stack.append(rec)
        try:
            yield rec
        finally:
            rec.t1 = time.perf_counter_ns()
            stack.pop()

    def _count(self, name: str, n: int) -> None:
        stack = self._stack()
        with self._lock:
            if stack:
                stack[-1].counts[name] = stack[-1].counts.get(name, 0) + n
            self.counters[name] += n

    @contextlib.contextmanager
    def stage(self, name: str, sync: bool = False):
        """A span of this timer that also adds to ``totals`` and ``counts``,
        with the timer active while it is open. Yields its record."""
        with _profiler_event(name, False), self.active(), self._span(name) as rec:
            yield rec
            if sync and torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
        with self._lock:
            self.totals[name] += (rec.t1 - rec.t0) / 1e9
            self.counts[name] += 1

    @property
    def spans(self) -> List[Tuple[str, float, float, int]]:
        """The closed spans as (name, t0 s since the timer was made, dt s,
        thread), oldest first."""
        with self._lock:
            recs = list(self.records)
        return [(r.name, (r.t0 - self._epoch) / 1e9, (r.t1 - r.t0) / 1e9, r.tid)
                for r in recs if r.t1 is not None]

    def unix_ns(self, t_ns: int) -> int:
        """A ``perf_counter_ns`` reading on the Unix clock (the profiler's)."""
        return t_ns + self._unix_offset

    # ---------------------------------------------------- device completion
    def device_reference(self, dev: torch.device) -> None:
        """On a CUDA device: wait for it, then record the reference event
        that ``resolve_done`` measures the marks from, with the host time
        beside it. Elsewhere nothing."""
        if dev.type != "cuda":
            return
        torch.cuda.synchronize(dev)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._ref = (ev, time.perf_counter_ns())

    def mark_done(self, rec: SpanRecord) -> None:
        """Record a CUDA event behind the work queued so far, to become
        `rec`'s ``done`` (no sync). Nothing without a device reference."""
        if self._ref is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.append((rec, ev))

    def resolve_done(self) -> None:
        """After a synchronize: set each marked record's ``done`` to the
        reference's host time plus the device time from the reference to
        its event."""
        if self._ref is None:
            return
        ref, t_ref = self._ref
        for rec, ev in self._marks:
            rec.done = t_ref + int(ref.elapsed_time(ev) * 1e6)
        self._marks = []

    # -------------------------------------------------------------- outputs
    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} total {total*1e3:9.1f} ms  n={n:5d}  avg {total/n*1e3:8.2f} ms")
        for name, n in sorted(self.counters.items()):
            lines.append(f"{name:24s} count {n}")
        return "\n".join(lines)

    def write_chrome_trace(self, path: str, process_name: str = "rtvm_tpu_torch") -> str:
        """Write the closed spans as Chrome trace-event JSON: complete 'X'
        events, ``ts`` in Unix microseconds (the clock of a
        ``torch.profiler`` trace), with each span's index, parent, request,
        counts and device completion (``done_us``) in its ``args``."""
        with self._lock:
            recs = [r for r in self.records if r.t1 is not None]
        events = [{
            "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
            "args": {"name": process_name},
        }]
        for r in recs:
            args = {"index": r.index, "parent": r.parent, "request": r.request}
            args.update(r.counts)
            if r.done is not None:
                args["done_us"] = round(self.unix_ns(r.done) / 1e3, 1)
            events.append({
                "name": r.name, "ph": "X", "pid": 1, "tid": r.tid % 2**31,
                "ts": round(self.unix_ns(r.t0) / 1e3, 1), "dur": round((r.t1 - r.t0) / 1e3, 1),
                "cat": "stage", "args": args,
            })
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        return path


class _HostEvent:
    """A host event in the profiler's trace with no range on the device (a
    record function of function scope, where ``record_function`` is a user
    annotation). Entered only while the profiler runs and left only if it
    still runs: a span that the profiler's start or stop cuts is left out."""

    __slots__ = ("_rf",)

    def __init__(self, name: str):
        on = _RecordFunctionFast is not None and _profiler_enabled()
        self._rf = _RecordFunctionFast(name) if on else None

    def __enter__(self):
        if self._rf is not None:
            self._rf.__enter__()

    def __exit__(self, *exc):
        if self._rf is not None and _profiler_enabled():
            self._rf.__exit__(*exc)


def _profiler_event(name: str, device_range: bool):
    return record_function(name) if device_range else _HostEvent(name)


@contextlib.contextmanager
def span(name: str, device_range: bool = False):
    """A span in the profiler's trace and, under an active timer, in its
    records. Yields the record, or None without an active timer."""
    timer = getattr(_local, "timer", None)
    with _profiler_event(name, device_range):
        if timer is None:
            yield None
        else:
            with timer._span(name) as rec:
                yield rec


def count(name: str, n: int = 1) -> None:
    """Add `n` to the innermost open span's count `name` and to the active
    timer's ``counters``; nothing without an active timer."""
    timer = getattr(_local, "timer", None)
    if timer is not None:
        timer._count(name, int(n))
