"""window_idle_ms: the card's idle time (ms) a traced window under the
window step: the gaps whose midpoint falls, on the host, innermost in the
driver's ``window`` or ``clip`` stage, the ``upload`` or a ``window.*``
span (``lib/spans.py``)."""

from bench_port.lib import spans


def read(ctx):
    return spans.idle_ms_per_window(ctx["red"], spans.window_layer)
