"""One run of a cell: set-up, the window, the traced reduction, and the
check against the plain references after the window has closed.

What is particular to a model comes from the configuration's ``yolo``
block, each key optional; the detector is always the port's
``ObjectDetector`` of the configuration's ``variant``:

- ``reference``: a module of ``bench_port/reference/`` (default ``yolo``)
  with ``load(checkpoint_path, cfg, device, fp8=False) -> weights``,
  ``heads(weights, cfg, frames, imgsz) -> ((box, cls), (scale, pad_y,
  pad_x))`` with its own letterbox, ``detect(weights, cfg, frames, imgsz,
  conf, iou) -> (per-frame [{"box", "score", "cls"}], (box, cls))``,
  ``flops(cfg, hw)``, the model FLOPs of a frame at the letterboxed hw,
  and ``draw(cfg, seed, frames, imgsz) -> {leaf path: float32 array}``, a
  checkpoint drawn from the seed.
- ``weights``: a bundled checkpoint (``.npz``, its class names in the json
  beside it), or ``"seeded"``: the reference's ``draw`` from ``--seed`` on
  frames of the traffic, written by ``lib/weights.py`` under TMPDIR and
  loaded by both sides as a bundled one, with the names ``classes`` (or
  ``class_0`` ...).

The detector must load the checkpoint and name ``nc`` classes, or the run
raises.
"""

from __future__ import annotations

import importlib
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from bench_port.lib import check, entries, faults, trace, traffic, weights as seeded

ROOT = Path(__file__).resolve().parent.parent.parent
CALIB_FRAMES = 8  # frames of the orbit, evenly spaced, that a seeded draw calibrates on


class Run:
    """What an entry needs: the cell's files, the seed, the orbit, the
    port's detector, the tracer, and the set-up clock."""

    def __init__(self, spec: Dict, seed: int, seconds: float, device, tracer, t_start: float):
        self.config, self.mix, self.cell = spec["config"], spec["mix"], spec["cell"]
        self.seed, self.seconds, self.device, self.tracer = seed, seconds, device, tracer
        self.t_start = t_start
        self.setup_s = None
        self.cleanup: List[Callable] = []
        self.orbit = None
        self.detector = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self.t_start


def p95_window_ms(timer) -> float:
    """95th percentile over the window's windows of the time from the start
    of the driver's ``window`` stage to the end of its ``detect`` stage."""
    starts = [t0 for name, t0, _, _ in timer.spans if name == "window"]
    ends = [t0 + dt for name, t0, dt, _ in timer.spans if name == "detect"]
    lat = [(e - s) * 1e3 for s, e in zip(starts, ends)]
    return float(np.percentile(lat, 95)) if lat else None


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def reference_of(yc: Dict):
    """The configuration's reference module under bench_port/reference/."""
    return importlib.import_module(f"bench_port.reference.{yc.get('reference', 'yolo')}")


def build_detector(yc: Dict, weights_path: str, dev):
    """The port's detector of the configuration's variant on the checkpoint."""
    from rtvm_tpu_torch.detect.detector import ObjectDetector

    return ObjectDetector(model=yc["variant"], load_world=False, weights_path=weights_path,
                          device=dev)


def fp8_head_logits(ref, weights: str, yc: Dict, dev):
    """The detection's control: the reference model, every convolution's
    input and weight in float8 (e4m3), with the reference's letterbox, as
    the detector's ``head_logits`` (the program decodes and runs its NMS on
    what it returns)."""
    w8 = ref.load(weights, yc, dev, fp8=True)

    def head_logits(self, frames_u8, imgsz, dtype=torch.bfloat16):
        frames = torch.as_tensor(frames_u8).to(device=dev, dtype=torch.uint8)
        parts = [ref.heads(w8, yc, frames[i : i + check.DET_BLOCK], imgsz)  # in blocks, beside
                 for i in range(0, len(frames), check.DET_BLOCK)]  # the port's state
        box, cls = ([torch.cat(t) for t in zip(*(p[0][k] for p in parts))] for k in (0, 1))
        return (box, cls), parts[-1][1]

    return head_logits


CONTROLS = ("tf32", "fp8")


def run_cell(spec: Dict, seed: int, seconds: float, traced: bool, device: str, t_start: float,
             read_metric, metrics_of, control: Optional[str] = None) -> Dict:
    """One run. ``control`` (``control.py``) puts one precision below the
    configuration's in the program's place: ``"tf32"``, the program computes
    its float32 products in TF32; ``"fp8"``, the reference model in float8
    stands in for the program's bf16 model. The references never do either.
    What the run wrote (a seeded checkpoint, an export's files) is deleted
    at its end."""
    if control not in (None,) + CONTROLS:
        raise ValueError(f"no control {control!r}")
    dev = torch.device(device)
    set_tf32(control == "tf32")
    cfg, mix = spec["config"], spec["mix"]
    frame_hw = tuple(cfg["stitch"]["frame_hw"])
    tracer = trace.Tracer(traced, mix["trace_wait"], mix["trace_active"])
    run = Run(spec, seed, seconds, dev, tracer, t_start)
    try:
        return _run(run, spec, traced, control, read_metric, metrics_of)
    finally:
        for f in run.cleanup:
            f()


def _run(run: Run, spec: Dict, traced: bool, control: Optional[str], read_metric,
         metrics_of) -> Dict:
    cfg, mix, cell = spec["config"], spec["mix"], spec["cell"]
    name = spec["workload"]["name"]
    dev, tracer, yc = run.device, run.tracer, cfg["yolo"]
    frame_hw = tuple(cfg["stitch"]["frame_hw"])
    run.orbit = traffic.make_orbit(run.seed, frame_hw,
                                   dict(mix, window_size=cfg["stitch"]["window_size"]))
    ref = reference_of(yc)
    if yc["weights"] == "seeded":
        frames = run.orbit["frames"]
        calib = torch.from_numpy(frames[:: max(1, len(frames) // CALIB_FRAMES)][:CALIB_FRAMES])
        weights, remove = seeded.seeded_checkpoint(ref, yc, run.seed, calib.to(dev),
                                                   _imgsz(yc))
        run.cleanup.append(remove)
    else:
        weights = str(ROOT / yc["weights"])
    run.detector = build_detector(yc, weights, dev)
    classes = json.loads(Path(weights[: -len(".npz")] + ".json").read_text())["classes"]
    if not run.detector.weights_loaded or len(run.detector.class_names) != yc["nc"]:
        raise RuntimeError(f"{weights}: not loaded, or not {yc['nc']} classes")

    patch_calls: List = []
    undo = []
    if control == "fp8":
        patch = faults.Patch()
        patch.setattr(type(run.detector), "head_logits", fp8_head_logits(ref, weights, yc, dev))
        undo.append(patch.undo)
    if traced and cfg["stitch"]["features"] == "sift":
        from rtvm_tpu_torch.ops.features import sift

        undo.append(trace.attach_recorder(sift, "extract_patches_octaves", patch_calls, tracer))
    try:
        out = entries.ENTRIES[mix["entry"]](run)
    finally:
        for u in undo:
            u()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    frames_per_s = out["frames"] / out["window_s"]

    # ------------------------------------------------------------ metrics
    metrics = {}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {}
    if not traced:
        # a metric is named by its quantity, with the part after a dot
        # naming the cells it has a bound of its own in (frames_per_s.live)
        e2e = {"frames_per_s": frames_per_s, "setup_s": run.setup_s,
               "window_ms_p95": p95_window_ms(out["timer"]) if out["timer"] else None}
        for m in metrics_of(spec["bench"], name, "end_to_end"):
            v = e2e.get(m["name"].split(".")[0])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        red = trace.reduce_events(tracer.events or [])
        untraced = tracer.untraced_rate(out["frames_per_detect_call"])
        ctx = {"red": red, "trace": trace, "out": out, "config": cfg, "mix": mix, "reference": ref,
               "frames_per_s": untraced or frames_per_s, "frame_hw": frame_hw,
               "patch_calls": patch_calls}
        for m in metrics_of(spec["bench"], name, "per_layer"):
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info["busy_s"] = red["busy_s"]
        device_info["window_s"] = red["window_s"]
        if red["kernels"]:
            result["breakdown"] = trace.breakdown(red)

    # ------------------------------------------- the check, after the window
    set_tf32(False)
    canvas_prog = out.pop("canvas").to("cpu")
    run.detector = None
    tracer.events = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check_outputs(run, out, canvas_prog, classes, frame_hw, dev, ref, weights)
    limits = cell["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    failed = int(np.sum(~(out["ok"] & out["blended"])))
    res = {"correct": bool(correct), "attempted": int(out["frames"]), "failed": failed,
           "metrics": metrics, "device": device_info}
    res.update(result)
    res["checks"] = checks
    res["info"] = dict(numbers["info"], host=out["host"])
    return res


def _imgsz(yc: Dict):
    return yc["imgsz"] if isinstance(yc["imgsz"], int) else tuple(yc["imgsz"])


def check_outputs(run: Run, out: Dict, canvas_prog: torch.Tensor, classes: List[str],
                  frame_hw, dev, ref, weights: str) -> Dict:
    cfg = run.config
    st = cfg["stitch"]
    hc, wc = out["canvas_hw"]
    r0, c0 = out["offset_rc"]
    numbers = check.chain_numbers(out["H_abs"], out["ok"], out["blended"], run.orbit, (c0, r0),
                                  st["stabilization"], frame_hw, (hc, wc))
    with torch.no_grad():
        canvas_ref = check.repaint(run.orbit, out["H_abs"], out["blended"], (hc, wc), (r0, c0),
                                   st["window_size"], dev)
    info = numbers.pop("info")
    numbers.update(check.canvas_number(canvas_prog, canvas_ref))
    del canvas_ref

    # the detection: a sample, drawn from the seed, of the frames whose head
    # logits the timed path kept
    kept = sorted(out["heads"])
    rng = np.random.default_rng([int(run.seed) & 0xFFFFFFFF, int(run.seed) >> 32, 7])
    n = min(check.DET_FRAMES, len(kept))
    sample = sorted(rng.choice(kept, size=n, replace=False).tolist()) if n else []
    yc = cfg["yolo"]
    w = ref.load(weights, yc, dev)
    imgsz = _imgsz(yc)
    ref_dets, ref_heads = [], []
    frames = run.orbit["frames"]
    for i in range(0, len(sample), check.DET_BLOCK):
        ks = sample[i : i + check.DET_BLOCK]
        fr = torch.from_numpy(frames[[k % run.orbit["period"] for k in ks]]).to(dev)
        dets, (box, cls) = ref.detect(w, yc, fr, imgsz, yc["conf"], yc["iou"])
        for j in range(len(ks)):
            ref_heads.append(torch.cat([t[j].flatten() for t in box + cls]))
            ref_dets.append([{"box": d["box"], "cls": classes[d["cls"]]} for d in dets[j]])
    got_dets = [[{"box": np.asarray(d["bbox"], np.float64), "cls": d["class"]}
                 for d in out["dets"][k - 1]] for k in sample]
    got_heads = [out["heads"][k] for k in sample]
    numbers.update(check.detection_numbers(ref_dets, got_dets, ref_heads, got_heads))
    numbers["info"].update(info, heads_kept=len(kept))

    if out.get("det_dir"):
        with_dets = [k + 1 for k, d in enumerate(out["dets"]) if d]
        pick = sorted(rng.choice(with_dets, size=min(8, len(with_dets)), replace=False).tolist()) \
            if with_dets else []
        numbers.update(check.files_numbers(out["det_dir"], with_dets, pick, frame_hw))
        numbers["info"]["files"] = len(with_dets)
    numbers["info"].update({"frames": int(out["frames"]), "windows": int(out["windows"]),
                            "canvas_hw": [hc, wc], "offset_rc": [r0, c0]})
    return numbers
