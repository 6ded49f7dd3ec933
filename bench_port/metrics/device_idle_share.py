"""device_idle_share: the share (%) of the traced window in which no kernel
or copy ran on the card: 1 - (the union of their intervals / the window)."""


def read(ctx):
    red = ctx["red"]
    if not red["kernels"] or red["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - red["busy_s"] / red["window_s"])
