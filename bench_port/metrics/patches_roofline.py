"""patches_roofline: kernel B's share (%) of its roofline in the trace: the
least time of the recorded calls' bytes (every stack pixel that a patch
covers read once, the origins, every patch written once, at 3.35 TB/s)
over the device time of ``rtvm_patches_tma_kernel``. The calls' stacks
and origins are recorded while the trace records; the traced kernels are
given the recorded calls' mean bytes."""

from bench_port.lib import yardstick

KERNEL = "rtvm_patches_tma_kernel"


def read(ctx):
    ks = [k for k in ctx["red"]["kernels"] if KERNEL in k[0]]
    calls = ctx["patch_calls"]
    if not ks or not calls:
        return None
    per_call = sum(yardstick.patches_bytes(sh, ys, xs) for sh, ys, xs in calls) / len(calls)
    nbytes = per_call * len(ks)
    device_ms = sum(e - a for _, a, e in ks) / 1e3
    return 100.0 * yardstick.bound(nbytes, 0)[0] / device_ms
