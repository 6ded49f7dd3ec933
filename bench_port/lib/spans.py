"""The program's own spans and counters, as the per-layer metrics of host
time and of the card's idle time by layer read them.

- The recorder (``rtvm_tpu_torch/utils/timing.py``'s ``StageTimer``, which
  the ``window_loop`` entry hands to ``run_mosaic`` and returns as
  ``out["timer"]``): the records of the windows that ran before the
  profiler started (requests below the mix's ``trace_wait``), so that the
  profiler's own cost is not in them. A program without the recorder's
  records gives nothing.
- The trace: each idle gap of the card goes to the innermost program span
  open on the host at the gap's midpoint. The benchmark's ``bench.*`` spans
  and the host's operations are looked through; a gap under no program
  span stays unattributed (``None``).
"""

from __future__ import annotations

import statistics
from typing import Callable, Dict, List, Optional

# the driver's stages and the upload; the window step's, the detection's
# and the fused call's spans by prefix
NAMES = ("window", "detect", "clip", "decode_wait", "draw", "export", "init", "prescan",
         "callback", "upload")
PREFIXES = ("window.", "detect.", "clip.")


def is_program_span(name: str) -> bool:
    return name in NAMES or name.startswith(PREFIXES)


def window_layer(name: str) -> bool:
    """The window step: the driver's window and clip stages, the upload and
    the step's window.* spans."""
    return name in ("window", "upload", "clip") or name.startswith("window.")


def detect_layer(name: str) -> bool:
    """The detection: the driver's detect stage, detect.* and clip.detect."""
    return name in ("detect", "clip.detect") or name.startswith("detect.")


def untraced(ctx: Dict, name: str) -> List:
    """The closed records named `name` of the windows before the profiler
    started; empty without the recorder's records."""
    recs = getattr(ctx["out"].get("timer"), "records", None)
    if not recs:
        return []
    wait = int(ctx["mix"].get("trace_wait", 0))
    return [r for r in recs if r.name == name and r.t1 is not None
            and isinstance(r.request, int) and r.request < wait]


def median(records: List, value: Callable) -> Optional[float]:
    """The median of value(record) over the records where it is not None,
    or None when there is none."""
    vals = [v for v in map(value, records) if v is not None]
    return float(statistics.median(vals)) if vals else None


def idle_by_span(red: Dict) -> Dict[Optional[str], float]:
    """Seconds of the card's idle gaps by the innermost program span open
    on the host at each gap's midpoint (``None``: under none)."""
    spans = sorted((h for h in red.get("host", []) if is_program_span(h[0])),
                   key=lambda h: h[1])
    out: Dict[Optional[str], float] = {}
    open_: List = []
    i = 0
    for a, b in sorted(red.get("gaps", [])):
        mid = (a + b) / 2
        while i < len(spans) and spans[i][1] <= mid:
            open_.append(spans[i])
            i += 1
        open_ = [h for h in open_ if h[2] > mid]
        # innermost: the latest start; of two that start together, the first to end
        name = max(open_, key=lambda h: (h[1], -h[2]))[0] if open_ else None
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return out


def idle_ms_per_window(red: Dict, layer: Callable[[str], bool]) -> Optional[float]:
    """Idle ms under the layer's spans per traced window (the host events
    ``window.features``), or None without a traced window."""
    n = sum(1 for h in red.get("host", []) if h[0] == "window.features")
    if not n:
        return None
    idle = idle_by_span(red)
    return 1e3 * sum(s for name, s in idle.items() if name is not None and layer(name)) / n
