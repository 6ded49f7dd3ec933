"""The entry calls a traffic mix names (``"entry"`` in its file): how the
benchmark drives the port, and what it keeps of the timed path's outputs
for the check.

- ``window_loop``: ``pipelines/mosaic_pipeline.py:run_mosaic`` over a frame
  source that yields the orbit round and round until the window's seconds
  have passed (then to the end of that window), with the per-frame detector
  behind a thin wrapper; with ``"export": true`` in the mix, the
  ``Detections/`` JPEGs go to a fresh directory under ``TMPDIR``.
- ``fused``: ``VideMosaic.process_clip`` on the orbit's windows as host
  uint8 arrays, ``chunk_windows`` windows a call, with ``det_fn`` the
  detector's ``_infer_fn``, on a canvas that the port's pre-scan sizes in
  set-up.

Each entry runs once in set-up on the cell's own shapes (a short call that
builds the kernels, picks cuDNN's algorithms and makes the bf16 copy of
the model) and then once for the window.
"""

from __future__ import annotations

import contextlib
import os
import resource
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from bench_port.lib.trace import Tracer

DETECT_SPAN = "bench.detect"


def _capture_rule(seed: int, call: int, share: float, n: int) -> Optional[int]:
    """Which frame of detection call `call` (n frames) keeps its head
    logits for the check, or None: drawn from (seed, call)."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, int(call)])
    if rng.random() >= share:
        return None
    return int(rng.integers(0, n))


class DetectorProbe:
    """The per-frame detector as the driver sees it: ``_run_pass`` and
    ``draw_detections`` of the port's ``ObjectDetector``, with the call
    inside the span ``bench.detect``. It keeps each frame's detections (the
    host dicts the driver gets) and, for frames drawn from the seed, the
    head logits the call computed (one flat tensor a frame, on the card);
    after each call it ends a step of the tracer."""

    def __init__(self, det, seed: int, share: float, tracer, frame0: int = 1):
        self.det, self.seed, self.share, self.tracer = det, seed, share, tracer
        self.dets: List[List[dict]] = []
        self.heads: Dict[int, torch.Tensor] = {}
        self.calls = 0
        self.next_frame = frame0
        self._want: Optional[int] = None
        orig = det.head_logits

        def head_logits(frames_u8, imgsz, dtype=torch.bfloat16):
            (box, cls), geo = orig(frames_u8, imgsz, dtype)
            if self._want is not None:
                i = self._want
                self.heads[self.next_frame + i] = torch.cat([t[i].flatten() for t in box + cls])
            return (box, cls), geo

        det.head_logits = head_logits

    def close(self) -> None:
        del self.det.head_logits  # the class's method again

    def want(self, n: int) -> None:
        self._want = _capture_rule(self.seed, self.calls, self.share, n)

    def _run_pass(self, images_u8, imgsz, conf: float, iou: float):
        self.want(len(images_u8))
        with record_function(DETECT_SPAN):
            out = self.det._run_pass(images_u8, imgsz, conf, iou)
        self._done(len(images_u8))
        self.dets.extend(out)
        return out

    def _done(self, n: int) -> None:
        self.calls += 1
        self.next_frame += n
        self._want = None
        self.tracer.step()

    def draw_detections(self, image, dets):
        return self.det.draw_detections(image, dets)


def host_usage(since: Optional[Dict] = None) -> Dict:
    """The process's CPU seconds (user and system, all threads) and the
    times it was preempted (involuntary context switches); or their growth
    since an earlier reading. Reported beside the checks (``info.host``)."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    now = {"cpu_s": r.ru_utime + r.ru_stime, "preempted": r.ru_nivcsw}
    return now if since is None else {k: now[k] - since[k] for k in now}


def orbit_source(frames: np.ndarray, window: int, deadline: List[float],
                 max_windows: Optional[int] = None):
    """Frame 0, then the orbit's frames 1, 2, ... round and round, until
    the host clock passes deadline[0] (set when the window opens), then on
    to the end of that window; or max_windows windows."""
    period = len(frames)
    yield frames[0]
    k = 0
    while True:
        for _ in range(window):
            k += 1
            yield frames[k % period]
        if max_windows is not None and k >= max_windows * window:
            return
        if max_windows is None and time.perf_counter() >= deadline[0]:
            return


@contextlib.contextmanager
def recording_aux(store: List):
    """Keep the WindowAux that each ``VideMosaic.process_window`` returns
    (references to the tensors on the card: no copy, no sync)."""
    from rtvm_tpu_torch.mosaic.stitcher import VideMosaic

    orig = VideMosaic.process_window

    def rec(self, frames, uniforms=None):
        aux = orig(self, frames, uniforms)
        store.append(aux)
        return aux

    VideMosaic.process_window = rec
    try:
        yield
    finally:
        VideMosaic.process_window = orig


def mosaic_config(cfg: Dict, **extra):
    """The port's MosaicConfig of the configuration's ``stitch`` settings."""
    from rtvm_tpu_torch.config import FeatureConfig, MosaicConfig, StabilizationConfig

    st = cfg["stitch"]
    return MosaicConfig(window_size=st["window_size"],
                        features=FeatureConfig(detector_type=st["features"],
                                               max_keypoints=st["max_keypoints"]),
                        stabilization=StabilizationConfig(**st["stabilization"]), **extra)


def window_loop(run) -> Dict:
    """run_mosaic with the per-frame detector; see the module's docstring."""
    from rtvm_tpu_torch.pipelines.mosaic_pipeline import run_mosaic
    from rtvm_tpu_torch.utils.timing import StageTimer

    cfg, mix = run.config, run.mix
    st = cfg["stitch"]
    B = st["window_size"]
    frames = run.orbit["frames"]
    mcfg = mosaic_config(cfg)
    export = bool(mix.get("export", False))
    tmp = tempfile.mkdtemp(prefix="bench_port_") if export else None
    run.cleanup.append(lambda: tmp and shutil.rmtree(tmp, ignore_errors=True))

    def drive(probe, timer, deadline, max_windows, det_dir):
        return run_mosaic(orbit_source(frames, B, deadline, max_windows), config=mcfg,
                          detector_type=st["features"], timer=timer, per_frame_detector=probe,
                          detections_dir=det_dir, device=run.device)

    # set-up: one short call on the cell's own shapes
    probe = DetectorProbe(run.detector, run.seed, 0.0, Tracer(False, 0, 0))
    drive(probe, StageTimer(), [0.0], int(mix["warmup_windows"]),
          os.path.join(tmp, "warmup") if export else None)
    probe.close()
    run.sync()
    run.setup_done()

    auxes: List = []
    timer = StageTimer()
    probe = DetectorProbe(run.detector, run.seed, float(mix["capture_share"]), run.tracer)
    det_dir = os.path.join(tmp, "Detections") if export else None
    deadline = [0.0]
    with recording_aux(auxes):
        run.tracer.start()
        h0 = host_usage()
        t0 = time.perf_counter()
        deadline[0] = t0 + run.seconds
        mosaic, _ = drive(probe, timer, deadline, None, det_dir)
        run.sync()
        t1 = time.perf_counter()
        usage = dict(host_usage(h0), stage_s=dict(timer.totals))
        run.tracer.stop()
    probe.close()
    H_abs = torch.cat([a.H_abs for a in auxes]).cpu().numpy()
    ok = torch.cat([a.ok for a in auxes]).cpu().numpy()
    blended = torch.cat([a.blended for a in auxes]).cpu().numpy()
    out = {
        "frames": len(auxes) * B, "window_s": t1 - t0, "windows": len(auxes), "timer": timer,
        "H_abs": H_abs, "ok": ok, "blended": blended,
        "canvas": mosaic.state.canvas, "canvas_hw": tuple(mosaic.canvas_shape[:2]),
        "offset_rc": (mosaic.w_offset, mosaic.h_offset),
        "dets": probe.dets, "heads": probe.heads, "frames_per_detect_call": B,
        "det_dir": det_dir, "host": usage,
    }
    return out


def fused(run) -> Dict:
    """process_clip with det_fn on a pre-scanned canvas; see the module's
    docstring."""
    from rtvm_tpu_torch.mosaic.prescan import prescan_canvas
    from rtvm_tpu_torch.mosaic.stitcher import VideMosaic

    cfg, mix = run.config, run.mix
    st, yc = cfg["stitch"], cfg["yolo"]
    B, W = st["window_size"], int(mix["chunk_windows"])
    frames = run.orbit["frames"]
    period = run.orbit["period"]
    if period % (B * W):
        raise ValueError(f"the orbit's {period} frames are not whole chunks of {W} windows")
    # the chunks as a decoder would hand them over: host uint8 [W, B, H, Wd, 3]
    seq = np.concatenate([frames[1:], frames[:1]])  # frames 1..period, the last is frame 0
    chunks = [np.ascontiguousarray(seq[c * B * W : (c + 1) * B * W].reshape(
        (W, B) + frames.shape[1:])) for c in range(period // (B * W))]
    pre = prescan_canvas(iter(np.concatenate([frames, frames[:1]])), frames.shape[1:3],
                         stride=int(st["prescan_stride"]), device=run.device)
    if pre is None:
        raise RuntimeError("the pre-scan could not track the orbit")
    mcfg = mosaic_config(cfg, canvas_hw=pre[0], seed_offset=pre[1])
    imgsz = yc["imgsz"] if isinstance(yc["imgsz"], int) else tuple(yc["imgsz"])
    det_fn = run.detector._infer_fn(imgsz, yc["conf"], yc["iou"])

    m = VideMosaic(frames[0], detector_type=st["features"], config=mcfg, device=run.device)
    m.process_clip(chunks[0], det_fn=det_fn)
    del m
    run.sync()
    m = VideMosaic(frames[0], detector_type=st["features"], config=mcfg, device=run.device)
    run.sync()
    run.setup_done()

    probe = DetectorProbe(run.detector, run.seed, float(mix["capture_share"]), run.tracer)
    auxes, detss = [], []
    run.tracer.start()
    h0 = host_usage()
    t0 = time.perf_counter()
    c = 0
    while c == 0 or time.perf_counter() < t0 + run.seconds:
        probe.want(B * W)
        aux, dets = m.process_clip(chunks[c % len(chunks)], det_fn=det_fn)
        auxes.append(aux)
        detss.append(dets)
        probe._done(B * W)
        c += 1
    run.sync()
    t1 = time.perf_counter()
    usage = host_usage(h0)
    run.tracer.stop()
    probe.close()
    H_abs = torch.cat([a.H_abs.reshape(-1, 3, 3) for a in auxes]).cpu().numpy()
    ok = torch.cat([a.ok.reshape(-1) for a in auxes]).cpu().numpy()
    blended = torch.cat([a.blended.reshape(-1) for a in auxes]).cpu().numpy()
    host = [type(d)(*(t.reshape((-1,) + t.shape[2:]).cpu().numpy() for t in d)) for d in detss]
    names = run.detector.class_names
    dets = []
    for d in host:
        for f in range(len(d.boxes)):
            dets.append([{"bbox": d.boxes[f, i].tolist(), "class": names[int(d.classes[f, i])]}
                         for i in np.flatnonzero(d.valid[f])])
    return {
        "frames": c * B * W, "window_s": t1 - t0, "windows": c * W, "timer": None,
        "H_abs": H_abs, "ok": ok, "blended": blended,
        "canvas": m.state.canvas, "canvas_hw": tuple(m.canvas_shape[:2]),
        "offset_rc": (m.w_offset, m.h_offset),
        "dets": dets, "heads": probe.heads, "frames_per_detect_call": B * W, "det_dir": None,
        "host": usage,
    }


ENTRIES = {"window_loop": window_loop, "fused": fused}
