"""step_mfu: the whole step's share (%) of the H100's bf16 dense peak
(989 TFLOP/s): the model FLOPs a frame at the letterboxed input that runs,
counted by the configuration's reference (``flops(cfg, hw)``), times the
frames a second of the traced run's steps before the profiler started
(host clock). The card's power limit is printed beside it
(``device.power``)."""

from bench_port.lib import yardstick


def read(ctx):
    yc = ctx["config"]["yolo"]
    imgsz = yc["imgsz"]
    th, tw = (imgsz, imgsz) if isinstance(imgsz, int) else imgsz
    flops = ctx["reference"].flops(yc, (th, tw))
    return 100.0 * flops * ctx["frames_per_s"] / yardstick.BF16_FLOPS_PER_S
