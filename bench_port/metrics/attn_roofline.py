"""attn_roofline: the text-guided attention's share (%) of its roofline in
the trace: the least time of the traced ``clip.detect`` calls' attention
work (the configuration's reference's ``attn_work`` for a call's frames:
its bytes at 3.35 TB/s or its FLOPs at the bf16 dense 989 TFLOP/s,
whichever takes longer; ``ConvBn_0`` runs on the tensor cores in bf16)
over the device time of the kernels under ``clip.attn``; nothing where
the trace has no ``clip.attn`` or the reference no ``attn_work``."""

from bench_port.lib import yardstick


def read(ctx):
    red, tr = ctx["red"], ctx["trace"]
    work = getattr(ctx["reference"], "attn_work", None)
    n = tr.count_ranges(red, "clip.detect")
    ks = tr.kernels_in(red, ("clip.attn",))
    if work is None or not n or not ks:
        return None
    imgsz = ctx["config"]["yolo"]["imgsz"]
    hw = (imgsz, imgsz) if isinstance(imgsz, int) else tuple(imgsz)
    nbytes, nflops = work(ctx["config"]["yolo"], hw, ctx["out"]["frames_per_detect_call"])
    least_s = max(nbytes / yardstick.HBM_BYTES_PER_S, nflops / yardstick.BF16_FLOPS_PER_S)
    device_s = sum(b - a for _, a, b in ks) / 1e6
    return 100.0 * n * least_s / device_s
