"""The comparison that decides ``correct``: what the timed path produced,
against the plain references in ``bench_port/reference/``.

Each compared number has a limit in the cell's file (``limits``); a run is
correct when every number is at or under its limit. The numbers:

- ``h_step_p99_px``: the 99th percentile over every frame of the window of
  the step gap: the largest distance (px) between a frame's corners mapped
  by the program's H_abs and by the program's H_abs of the frame before
  composed with the truth chain's step (``reference/chain.py``); frame 1
  starts from frame 0's place. The chain is followed step by step from the
  program's own state; its drift from the truth over the window and the
  step gap's median and largest value are reported beside it (``info``).
  The largest reads alike in sound runs and in the control (a rare poor
  fit), so the 99th percentile. With ORB the TF32 control sets its limit;
  with SIFT, whose own sub-pixel error reads as high as the control's, a
  fitted homography moved by 3 px (``lib/faults.py``) does (PERF.md);
- ``flags_off``: frames whose accepted or blended flag differs from the
  truth chain's (an exact comparison);
- ``outside_px``: how far (px) any frame of the truth chain pokes out of
  the program's canvas (the pre-scan's and the default canvas's promise:
  the canvas holds the whole orbit; exact, 0);
- ``canvas_gap``: the largest |difference| (grey levels) between the
  program's final canvas and the plain paint (``reference/paint.py``)
  repainting every window from frame 0 with the program's H_abs and
  blended flags, which it reads only to judge them;
- ``head_rms``: over a sample of frames drawn from the seed, the largest
  relative RMS gap of a frame's heads' logits (box and class) from the
  float32 reference model's: ||program - reference|| / ||reference||. The
  largest single gap (``info.head_gap``) is a widest gap over some 10^6
  logits, which swings from seed to seed (PERF.md);
- ``det_unmatched``: over the same frames, 1 - the smaller of the two
  sides' shares of detections that the other side matches (same class,
  IoU >= 0.9) after NMS;
- ``files_off`` (the export mix): written ``Detections/`` files whose frame
  has no detection, plus frames with a detection that have no file;
  ``jpeg_bad``: sampled files that are not a baseline JPEG of the frame's
  size.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from bench_port.reference import chain as ref_chain
from bench_port.reference import paint as ref_paint
from bench_port.reference import yolo as ref_yolo

DET_IOU_MATCH = 0.9
DET_FRAMES = 8  # frames whose detection the reference redoes, drawn from the seed
DET_BLOCK = 4  # frames a reference call, so that YOLOv8l at 768x1280 fits beside the port


def chain_numbers(H_abs: np.ndarray, ok: np.ndarray, blended: np.ndarray, orbit: Dict,
                  origin_xy, stab: dict, frame_hw, canvas_hw) -> Dict[str, float]:
    n = len(H_abs)
    H_ref, ok_ref, bl_ref = ref_chain.truth_chain(orbit["offsets"], n, origin_xy, stab)
    start = ref_chain.translation(*origin_xy)[None]
    steps = np.linalg.inv(np.concatenate([start, H_ref[:-1]])) @ H_ref
    pred = np.concatenate([start, H_abs[:-1].astype(np.float64)]) @ steps
    step = ref_chain.corner_gap(H_abs, pred, *frame_hw)
    drift = ref_chain.corner_gap(H_abs, H_ref, *frame_hw)
    return {"h_step_p99_px": float(np.percentile(step, 99)) if n else float("inf"),
            "flags_off": float(np.sum(ok != ok_ref) + np.sum(blended != bl_ref)),
            "outside_px": ref_chain.outside(H_ref, frame_hw, canvas_hw),
            "info": {"h_drift_px": float(drift.max()) if n else None,
                     "h_drift_px_last": float(drift[-1]) if n else None,
                     "h_step_px_p50": float(np.median(step)) if n else None,
                     "h_step_px_p90": float(np.percentile(step, 90)) if n else None,
                     "h_step_px_max": float(step.max()) if n else None}}


def repaint(orbit: Dict, H_abs: np.ndarray, blended: np.ndarray, canvas_hw, offset_rc,
            window: int, device) -> torch.Tensor:
    """The plain paint of frames 1..n (n = len(H_abs), whole windows) onto a
    canvas seeded with frame 0 at offset_rc (row, col)."""
    frames = orbit["frames"]
    period = orbit["period"]
    h, w = frames.shape[1:3]
    canvas, union = ref_paint.seed_canvas(torch.from_numpy(frames[0]).to(device), canvas_hw,
                                          offset_rc)
    Ht = torch.from_numpy(H_abs.astype(np.float32)).to(device)
    bt = torch.from_numpy(blended).to(device)
    for k0 in range(0, len(H_abs), window):
        idx = [(k0 + 1 + i) % period for i in range(window)]
        fr = torch.from_numpy(frames[idx]).to(device).to(torch.float32).permute(0, 3, 1, 2)
        canvas, union = ref_paint.paint_window(canvas, union, fr.contiguous(),
                                               Ht[k0 : k0 + window], bt[k0 : k0 + window],
                                               (h, w), canvas_hw)
    return canvas


def canvas_number(canvas_prog: torch.Tensor, canvas_ref: torch.Tensor) -> Dict[str, float]:
    return {"canvas_gap": float((canvas_prog.to(canvas_ref.device) - canvas_ref).abs().max())}


def _match(ref: List[dict], got: List[dict]):
    """(matched ref, matched got) counts of one frame: same class, IoU >= 0.9."""
    if not ref or not got:
        return 0, 0
    rb = np.array([d["box"] for d in ref])
    ok = np.zeros((len(ref), len(got)), bool)
    for j, g in enumerate(got):
        iou = ref_yolo._iou(np.asarray(g["box"], np.float64), rb)
        ok[:, j] = (iou >= DET_IOU_MATCH) & (np.array([d["cls"] for d in ref]) == g["cls"])
    return int(ok.any(1).sum()), int(ok.any(0).sum())


def detection_numbers(ref_dets: List[List[dict]], got_dets: List[List[dict]],
                      ref_heads: List[torch.Tensor], got_heads: List[torch.Tensor]) -> Dict:
    """Numbers over the sampled frames: per frame, the flat logits of the
    reference and of the program, and their detections."""
    gap = rms = 0.0
    for r, g in zip(ref_heads, got_heads):
        r, g = r.to(torch.float64), g.to(r.device, torch.float64)
        gap = max(gap, float((g - r).abs().max() / r.abs().max().clamp(min=1e-12)))
        rms = max(rms, float((g - r).norm() / r.norm().clamp(min=1e-12)))
    n_ref = sum(len(d) for d in ref_dets)
    n_got = sum(len(d) for d in got_dets)
    m_ref = m_got = 0
    for r, g in zip(ref_dets, got_dets):
        a, b = _match(r, g)
        m_ref += a
        m_got += b
    share = min(m_ref / n_ref if n_ref else 1.0, m_got / n_got if n_got else 1.0)
    return {"head_rms": rms, "det_unmatched": 1.0 - share,
            "info": {"head_gap": gap, "sampled_frames": len(ref_dets), "detections_ref": n_ref,
                     "detections_prog": n_got}}


def jpeg_size(path: str):
    """(rows, cols) from a baseline JPEG's SOF0 segment; None unless the file
    starts with SOI, ends with EOI and has exactly one SOF0."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"\xff\xd8" or data[-2:] != b"\xff\xd9":
        return None
    i, size = 2, None
    while i + 4 <= len(data) and data[i] == 0xFF:
        marker = data[i + 1]
        if marker == 0xDA:  # start of scan: the headers are over
            break
        seg = int.from_bytes(data[i + 2 : i + 4], "big")
        if marker == 0xC0:
            if size is not None:
                return None
            size = (int.from_bytes(data[i + 5 : i + 7], "big"),
                    int.from_bytes(data[i + 7 : i + 9], "big"))
        elif 0xC1 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return None  # not baseline
        i += 2 + seg
    return size


def files_numbers(det_dir: str, frames_with_dets: List[int], sample: List[int],
                  frame_hw) -> Dict[str, float]:
    """The written files against the frames whose detections the program
    returned, by name (``frame_NNNNN_detected.jpg``)."""
    names = set(os.listdir(det_dir)) if os.path.isdir(det_dir) else set()
    want = {f"frame_{k:05d}_detected.jpg" for k in frames_with_dets}
    bad = sum(1 for k in sample
              if jpeg_size(os.path.join(det_dir, f"frame_{k:05d}_detected.jpg")) != tuple(frame_hw))
    return {"files_off": float(len(names ^ want)), "jpeg_bad": float(bad)}
