"""detect_idle_ms: the card's idle time (ms) a traced window under the
detection: the gaps whose midpoint falls, on the host, innermost in the
driver's ``detect`` stage, a ``detect.*`` span or ``clip.detect``
(``lib/spans.py``)."""

from bench_port.lib import spans


def read(ctx):
    return spans.idle_ms_per_window(ctx["red"], spans.detect_layer)
