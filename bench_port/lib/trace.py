"""The traced run: ``torch.profiler`` over a few whole steps in the middle of
the window, and the reduction of its events to kernels, span ranges, busy
time and idle gaps.

The span attribution is a frozen copy of ``tools/profile_torch_window.py``'s
arithmetic: a ``record_function`` span has a range on the device, from its
first kernel to its last, and a kernel belongs to the span whose device
range holds its start.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

SPAN_PREFIXES = ("window.", "clip.", "bench.")


class Tracer:
    """A profiler that records steps [wait + 1, wait + 1 + active) of the
    run (step 0 is the first, ended by the first call of ``step``); it is
    started only when step ``wait`` begins, because a started profiler slows
    every step, recorded or not. The steps before it run untraced: their
    frames over their host time are the traced run's untraced rate.
    Inactive when disabled."""

    def __init__(self, enabled: bool, wait: int, active: int):
        self.enabled = enabled
        self.wait, self.active = int(wait), int(active)
        self.events = None
        self.steps = 0
        self.prof = None
        self.t_open = self.t_prof = None

    def _ready(self, prof) -> None:
        self.events = list(prof.events())

    def recording(self) -> bool:
        """Whether the step now running is one the trace keeps."""
        return self.enabled and self.wait + 1 <= self.steps < self.wait + 1 + self.active

    def start(self) -> None:
        """The window opens."""
        self.t_open = time.perf_counter()
        if self.enabled and self.wait == 0:
            self._begin()

    def _begin(self) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule

        self.t_prof = time.perf_counter()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                         else [])
        self.prof = profile(activities=acts,
                            schedule=schedule(wait=0, warmup=1, active=self.active, repeat=1),
                            on_trace_ready=self._ready)
        self.prof.start()

    def step(self) -> None:
        """Called when a step of the run has ended."""
        self.steps += 1
        if self.prof is not None:
            self.prof.step()
        elif self.enabled and self.steps == self.wait:
            self._begin()

    def untraced_rate(self, per_step: float):
        """Frames a second over the steps before the profiler started, or
        None when it never started."""
        if self.t_prof is None or self.wait == 0:
            return None
        return self.wait * per_step / (self.t_prof - self.t_open)

    def stop(self) -> None:
        if self.prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.stop()


def _is_cuda(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def reduce_events(events) -> Dict:
    """Kernels (name, start_us, end_us), span ranges on the device (name,
    start, end), busy seconds (the union of kernel and copy intervals) and
    the traced window in seconds (first event to last), with the idle gaps
    between busy intervals and the host span open at each."""
    ranges: List[Tuple[str, float, float]] = []
    kernels: List[Tuple[str, float, float]] = []
    host: List[Tuple[str, float, float]] = []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if _is_cuda(e):
            if e.name.startswith(SPAN_PREFIXES):
                ranges.append((e.name, a, b))
            elif not e.name.startswith("ProfilerStep"):
                kernels.append((e.name, a, b))
        else:
            host.append((e.name, a, b))
    if not kernels:
        return {"kernels": [], "ranges": ranges, "busy_s": 0.0, "window_s": 0.0, "gaps": []}
    t0 = min(min(k[1] for k in kernels), min((h[1] for h in host), default=float("inf")))
    t1 = max(max(k[2] for k in kernels), max((h[2] for h in host), default=float("-inf")))
    busy = 0.0
    gaps = []
    cur_a, cur_b = None, None
    for _, a, b in sorted(kernels, key=lambda k: k[1]):
        if cur_b is None:
            cur_a, cur_b = a, b
        elif a > cur_b:
            busy += cur_b - cur_a
            gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    return {"kernels": kernels, "ranges": ranges, "host": host, "busy_s": busy / 1e6,
            "window_s": (t1 - t0) / 1e6, "gaps": gaps}


def kernels_in(red: Dict, prefixes: Tuple[str, ...]) -> List[Tuple[str, float, float]]:
    """The kernels whose start lies in a device range of a span whose name
    starts with one of `prefixes` (``tools/profile_torch_window.py``'s rule)."""
    ivs = sorted((a, b) for nm, a, b in red["ranges"] if nm.startswith(prefixes))
    if not ivs:
        return []
    import bisect

    starts = [a for a, _ in ivs]
    out = []
    for k in red["kernels"]:
        i = bisect.bisect_right(starts, k[1]) - 1
        if i >= 0 and ivs[i][0] <= k[1] < ivs[i][1]:
            out.append(k)
    return out


def count_ranges(red: Dict, name: str) -> int:
    return sum(1 for nm, _, _ in red["ranges"] if nm == name)


def breakdown(red: Dict, top: int = 10) -> Dict:
    """The device operations that took the most time, and the longest idle
    gaps, each named by what the host was doing halfway through it: the
    innermost span of the port or the benchmark open then, else the
    innermost host operation, else "host, outside any span" (the driver's
    numpy drawing and JPEG export are not traced)."""
    tot: Dict[str, float] = {}
    for name, a, b in red["kernels"]:
        tot[name] = tot.get(name, 0.0) + (b - a) / 1e6
    ops = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(red["gaps"], key=lambda g: g[0] - g[1])[:top]
    named = []
    for a, b in gaps:
        mid = (a + b) / 2
        open_ = [h for h in red["host"] if h[1] <= mid < h[2] and not h[0].startswith("ProfilerStep")]
        spans = [h for h in open_ if h[0].startswith(SPAN_PREFIXES)]
        pick = max(spans or open_, key=lambda h: h[1], default=("host, outside any span", 0, 0))
        named.append([pick[0][:80], (b - a) / 1e6])
    return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": named}


def attach_recorder(module, name: str, store: List, tracer: Tracer):
    """Wrap ``module.name`` so that each call made while the trace records
    keeps its arguments' shapes and origin tensors (the patch cut's
    stacks, ys, xs), without copying them. Returns the undo function."""
    orig = getattr(module, name)

    def wrapped(stacks, ys, xs, *a, **kw):
        if tracer.recording():
            store.append(([tuple(s.shape) for s in stacks], list(ys), list(xs)))
        return orig(stacks, ys, xs, *a, **kw)

    setattr(module, name, wrapped)
    return lambda: setattr(module, name, orig)
