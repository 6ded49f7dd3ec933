"""Motion pre-scan: size the mosaic canvas before stitching, the counterpart
of ``rtvm_tpu/mosaic/prescan.py``.

The homographies of every ``stride``-th frame are chained to find the extent
of the whole clip, so the fused ``process_clip`` path can run on a canvas
that never has to grow. The JAX package does this on the host with cv2's
ORB, ``BFMatcher(crossCheck)`` and ``findHomography(RANSAC, 3.0)``; the port
uses its own parts on the device (FAST-9 with 500 keypoints, rBRIEF, the
Hamming cross-check, RANSAC with draws from a seeded ``torch.Generator``),
batched over all strided frames and pairs in a few calls, and reads the
relative homographies back once. The chain and the canvas arithmetic run in
float64 on the host, as in the JAX package, so both size the same canvas
from the same extent; the extents themselves can differ by a few pixels
(another ORB).
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from rtvm_tpu_torch.config import FeatureConfig
from rtvm_tpu_torch.device import resolve_device
from rtvm_tpu_torch.geometry import homography as geo
from rtvm_tpu_torch.io.video import open_frames
from rtvm_tpu_torch.ops import color
from rtvm_tpu_torch.ops import match as match_ops
from rtvm_tpu_torch.ops.features import fast as fast_ops
from rtvm_tpu_torch.ops.features import orb as orb_ops

MIN_KEYPOINTS = 8  # fewer keypoints or matches than this: the clip is not tracked
REPROJ_THRESHOLD = 3.0  # cv2.findHomography(..., cv2.RANSAC, 3.0)
NUM_HYPOTHESES = 512
RANSAC_SEED = 0  # seed of the torch.Generator that draws RANSAC's samples
CHUNK = 32  # strided frames per batch of device calls


def _corners(h: int, w: int) -> np.ndarray:
    return np.array([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]], dtype=np.float64)


def _pair_stats(frames: List[np.ndarray], prev, max_keypoints: int, gen: torch.Generator,
                device: torch.device):
    """Features of a batch of strided frames, and each one matched against
    the frame before it (the last of the previous batch for the first).
    Returns ([P, 13] float32 on the device: H_rel, keypoints of the current
    and the previous frame, matches, RANSAC ok; P pairs), and the last
    frame's features."""
    f = FeatureConfig(detector_type="orb")
    gray = color.bgr2gray(torch.as_tensor(np.stack(frames)).to(device))
    kps = fast_ops.detect_fast(gray, max_keypoints, f.fast_threshold, f.border_margin,
                               f.fast_arc_length)
    desc = orb_ops.describe_orb_batch(gray, kps.xy, kps.valid, n_bits=f.brief_bits,
                                      pattern_radius=f.brief_patch_radius,
                                      blur_sigma=f.brief_blur_sigma,
                                      orientation_radius=f.orientation_radius).bits
    feats = (kps.xy, desc, kps.valid)
    if prev is not None:
        feats_all = tuple(torch.cat([p[None], x]) for p, x in zip(prev, feats))
    else:
        feats_all = feats
    last = tuple(x[-1] for x in feats)
    kp, ds, valid = feats_all
    if kp.shape[0] < 2:
        return None, last
    m = match_ops.match_hamming_crosscheck(ds[1:], valid[1:], ds[:-1], valid[:-1])
    src, dst, mvalid = match_ops.gather_correspondences(kp[1:], kp[:-1], m)
    res = geo.ransac_homography(src, dst, mvalid, generator=gen, num_hypotheses=NUM_HYPOTHESES,
                                reproj_threshold=REPROJ_THRESHOLD, min_matches=4)
    n_kp = valid.sum(dim=-1).to(torch.float32)
    stats = torch.cat([res.H.reshape(-1, 9), n_kp[1:, None], n_kp[:-1, None],
                       mvalid.sum(dim=-1).to(torch.float32)[:, None],
                       res.ok.to(torch.float32)[:, None]], dim=1)
    return stats, last


def prescan_extent(
    frames: Iterable[np.ndarray],
    stride: int = 8,
    max_keypoints: int = 500,
    device=None,
) -> Optional[Tuple[float, float, float, float]]:
    """Chain homographies over every `stride`-th frame and return the
    bounding box (min_x, min_y, max_x, max_y) of all warped frame corners in
    frame-0 pixel coordinates (frame 0's top-left is (0, 0)).

    Returns None when the motion cannot be tracked (fewer than 8 keypoints or
    matches, no homography, a chain that diverges): callers fall back to
    growing the canvas as it fills."""
    dev = resolve_device(device)
    it = iter(frames)
    first = next(it, None)
    if first is None:
        return None
    h, w = first.shape[:2]
    gen = torch.Generator(device=dev)
    gen.manual_seed(RANSAC_SEED)
    stats, batch, prev = [], [np.asarray(first)], None
    for i, frame in enumerate(it, start=1):
        if i % stride == 0:
            batch.append(np.asarray(frame))
        if len(batch) == CHUNK:
            s, prev = _pair_stats(batch, prev, max_keypoints, gen, dev)
            stats += [] if s is None else [s]
            batch = []
    if batch:
        s, prev = _pair_stats(batch, prev, max_keypoints, gen, dev)
        stats += [] if s is None else [s]
    rows = torch.cat(stats).cpu().numpy().astype(np.float64) if stats else np.zeros((0, 13))

    H = np.eye(3, dtype=np.float64)
    box = _corners(h, w)
    lo, hi = box.min(axis=0), box.max(axis=0)
    corners = np.concatenate([box, np.ones((4, 1))], axis=1).T
    for r in rows:
        H_rel, n_cur, n_prev, n_match, ok = r[:9].reshape(3, 3), r[9], r[10], r[11], r[12]
        if n_cur < MIN_KEYPOINTS or n_prev < 1 or n_match < MIN_KEYPOINTS:
            return None
        if not ok or not np.isfinite(H_rel).all():
            return None
        H = H @ H_rel
        p = H @ corners
        pts = (p[:2] / p[2]).T
        if not np.isfinite(pts).all() or np.abs(pts).max() > 64 * max(h, w):
            return None  # a diverged chain: growing the canvas is safer
        lo = np.minimum(lo, pts.min(axis=0))
        hi = np.maximum(hi, pts.max(axis=0))
    return float(lo[0]), float(lo[1]), float(hi[0]), float(hi[1])


def prescan_canvas(
    frames: Iterable[np.ndarray],
    frame_hw: Tuple[int, int],
    stride: int = 8,
    margin: int = 64,
    max_area_times: float = 24.0,
    device=None,
) -> Optional[Tuple[Tuple[int, int], Tuple[int, int]]]:
    """Turn a pre-scan extent into (canvas_hw, seed_offset) for MosaicConfig.

    The canvas is padded by `margin` px on every side (the strided scan skips
    frames whose footprint can poke past the sampled hull), rows rounded up
    to a multiple of 8 and columns to a multiple of 128, as in the JAX
    package. Returns None when tracking failed or the canvas exceeds
    `max_area_times` the frame area."""
    ext = prescan_extent(frames, stride=stride, device=device)
    if ext is None:
        return None
    min_x, min_y, max_x, max_y = ext
    h, w = frame_hw
    hc = int(math.ceil(max_y - min_y)) + 2 * margin
    wc = int(math.ceil(max_x - min_x)) + 2 * margin
    hc = max(hc, h + 2)
    wc = max(wc, w + 2)
    if hc * wc > max_area_times * h * w:
        return None
    hc = (hc + 7) // 8 * 8
    wc = (wc + 127) // 128 * 128
    seed = (margin + int(round(-min_y)), margin + int(round(-min_x)))
    return (hc, wc), seed


def prescan_canvas_from_video(
    source,
    stride: int = 8,
    margin: int = 64,
    max_frames: Optional[int] = None,
    device=None,
) -> Optional[Tuple[Tuple[int, int], Tuple[int, int]]]:
    """prescan_canvas over any source ``io.video.VideoReader`` reads (a video
    path, a uint8 array or ``.npy`` file of frames, an iterable), reading at
    most `max_frames` frames."""
    frames, _, _, release = open_frames(source)
    try:
        first = next(frames, None)
        if first is None:
            return None

        def chain():
            yield first
            for n, fr in enumerate(frames, start=1):
                if max_frames is not None and n >= max_frames:
                    return
                yield fr

        return prescan_canvas(chain(), first.shape[:2], stride=stride, margin=margin,
                              device=device)
    finally:
        release()
