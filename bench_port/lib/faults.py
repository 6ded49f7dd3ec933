"""Faults planted under the timed path, to show that the check catches
them: each turns ``correct`` false through the numbers it breaks. Not part
of a benchmark run; ``control.py --fault`` reads them on the card at a
cell's own size and ``tests/test_bench_port_faults.py`` on the CPU.

A plant takes ``mp``, anything with pytest's ``monkeypatch.setattr(obj,
name, value)`` (``Patch`` here), and replaces one function of the port.
"""

from __future__ import annotations

import torch


class Patch:
    """``monkeypatch.setattr`` outside pytest, undone by ``undo()``."""

    def __init__(self):
        self._saved = []

    def setattr(self, obj, name: str, value) -> None:
        self._saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self) -> None:
        while self._saved:
            obj, name, value = self._saved.pop()
            setattr(obj, name, value)


def keep_state(mp) -> None:
    """A step that returns its state unchanged."""
    from rtvm_tpu_torch.mosaic.stitcher import VideMosaic

    orig = VideMosaic.process_window

    def step(self, frames, uniforms=None):
        before = self.state
        aux = orig(self, frames, uniforms)
        self.state = before
        return aux

    mp.setattr(VideMosaic, "process_window", step)


def half_batch(mp) -> None:
    """Half of the detection batch left out: the second half of the frames
    get the first half's outputs."""
    from rtvm_tpu_torch.detect.detector import ObjectDetector

    orig = ObjectDetector.head_logits

    def heads(self, frames_u8, imgsz, dtype=torch.bfloat16):
        n = len(frames_u8)
        (box, cls), geo = orig(self, frames_u8[: (n + 1) // 2], imgsz, dtype)
        idx = torch.arange(n, device=box[0].device) % ((n + 1) // 2)
        return ([b[idx] for b in box], [c[idx] for c in cls]), geo

    mp.setattr(ObjectDetector, "head_logits", heads)


def shifted_boxes(mp) -> None:
    """An answer altered where it is produced: every box 8 px to the right."""
    from rtvm_tpu_torch.models.yolo import postprocess

    orig = postprocess.unletterbox_boxes

    def unletterbox(boxes, scale, py, px):
        out = orig(boxes, scale, py, px)
        out[..., 0::2] += 8.0
        return out

    mp.setattr(postprocess, "unletterbox_boxes", unletterbox)


def shifted_homography(mp) -> None:
    """An answer altered where it is produced: each fitted homography moved
    by 3 px."""
    from rtvm_tpu_torch.geometry import homography

    orig = homography.ransac_homography

    def ransac(*a, **kw):
        res = orig(*a, **kw)
        H = res.H.clone()
        H[..., 0, 2] += 3.0
        return res._replace(H=H)

    mp.setattr(homography, "ransac_homography", ransac)


FAULTS = {"state_unchanged": keep_state, "half_batch": half_batch,
          "boxes_altered": shifted_boxes, "homography_altered": shifted_homography}
