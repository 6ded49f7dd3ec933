"""Visual odometry and SimpleSLAM (counterpart of ``rtvm_tpu/slam/vo.py``).

Per frame: FAST features (up to 2000), pyramidal LK tracking with the
forward-backward gate, essential-matrix RANSAC and pose recovery on the
device, then the pose chain T = T @ T_rel and the keyframe rule on the host.
Features are detected again when the tracked set falls under 500.

As in the JAX version, the host reads the tracked count and then the pose
result every frame (two device syncs a frame, by design: the keyframe rule
and the re-detection depend on them).

Random draws: frame f's RANSAC draws come from a CPU ``torch.Generator``
seeded with (seed, f) mixed as ``mosaic/stitcher.py:pair_uniforms`` mixes
them, then move to the device, so the card and the CPU draw the same
numbers (``pose_uniforms``; the tests replace it to replay JAX's draws).
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from rtvm_tpu_torch.device import resolve_device
from rtvm_tpu_torch.mosaic.stitcher import _pair_seed
from rtvm_tpu_torch.ops import color
from rtvm_tpu_torch.ops.features import fast as fast_ops
from rtvm_tpu_torch.ops.features import orb as orb_ops
from rtvm_tpu_torch.slam.epipolar import find_essential_and_pose
from rtvm_tpu_torch.slam.flow import track_lk
from rtvm_tpu_torch.utils import draw

NUM_HYPOTHESES = 256


def default_camera_matrix(w: int, h: int) -> np.ndarray:
    """The reference's intrinsics heuristic: f = 0.8 * width, centred."""
    return np.array([[0.8 * w, 0.0, w / 2.0], [0.0, 0.8 * w, h / 2.0], [0.0, 0.0, 1.0]],
                    dtype=np.float32)


def pose_uniforms(seed: int, frame: int, n: int, device) -> torch.Tensor:
    """Frame `frame`'s RANSAC draws [NUM_HYPOTHESES, n], from a CPU generator
    seeded with (seed, frame)."""
    g = torch.Generator()
    g.manual_seed(_pair_seed(seed, frame))
    return torch.rand((NUM_HYPOTHESES, n), generator=g).to(device)


def add_weighted(a: np.ndarray, alpha: float, b: np.ndarray, beta: float) -> np.ndarray:
    """cv2.addWeighted(a, alpha, b, beta, 0) for uint8 images: float32
    arithmetic, rounded half to even and saturated."""
    s = a.astype(np.float32) * np.float32(alpha) + b.astype(np.float32) * np.float32(beta)
    return np.clip(np.rint(s), 0, 255).astype(np.uint8)


def _top_down(traj: np.ndarray, size: int):
    """The trajectory's (x, z) in pixels of a size x size panel, and the
    scale that maps it there."""
    xz = traj[:, [0, 2]]
    span = max(np.abs(xz).max(), 1e-6)
    return ((xz / span) * (size * 0.45) + size / 2).astype(np.int32), span


class VisualOdometry:
    """Feature-tracking visual odometry on `device` (``cuda`` unless given)."""

    def __init__(self, camera_matrix: np.ndarray, max_features: int = 2000,
                 min_tracked_redetect: int = 500, min_tracked_reinit: int = 8, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.K = np.asarray(camera_matrix, np.float32)
        self._K = torch.from_numpy(self.K).to(self.device)
        self.max_features = max_features
        self.min_tracked_redetect = min_tracked_redetect
        self.min_tracked_reinit = min_tracked_reinit
        self.seed = int(seed)
        self.current_pose = np.eye(4, dtype=np.float64)
        self.trajectory: List[np.ndarray] = [self.current_pose[:3, 3].copy()]
        self.prev_gray: Optional[torch.Tensor] = None
        self.pts: Optional[torch.Tensor] = None
        self.pts_valid: Optional[torch.Tensor] = None
        self._frame = 0
        self.last_num_tracked = 0
        self.last_num_inliers = 0
        self.last_ok = False  # the last frame's pose was recovered (not the JAX class's)

    def _gray(self, frame_bgr) -> torch.Tensor:
        f = frame_bgr if torch.is_tensor(frame_bgr) else torch.from_numpy(np.asarray(frame_bgr))
        return color.bgr2gray(f.to(self.device))

    def detect_features(self, gray: torch.Tensor):
        kps = fast_ops.detect_fast(gray, self.max_features, 20.0, 16, 9)
        return kps.xy, kps.valid

    def process_frame(self, frame_bgr) -> np.ndarray:
        """Track one BGR uint8 frame; returns the updated 4x4 pose."""
        gray = self._gray(frame_bgr)
        if self.prev_gray is None:
            self.pts, self.pts_valid = self.detect_features(gray)
            self.prev_gray = gray
            return self.current_pose

        pts1, valid = track_lk(self.prev_gray, gray, self.pts, self.pts_valid)
        n_tracked = int(valid.sum())
        self.last_num_tracked = n_tracked
        self.last_ok = False
        if n_tracked >= self.min_tracked_reinit:
            u = pose_uniforms(self.seed, self._frame, self.pts.shape[0], self.device)
            res = find_essential_and_pose(self.pts, pts1, valid, self._K, uniforms=u,
                                          num_hypotheses=NUM_HYPOTHESES)
            host = torch.cat([res.R.reshape(9), res.t, res.num_inliers.reshape(1).to(res.t.dtype),
                              res.ok.reshape(1).to(res.t.dtype)]).cpu().numpy().astype(np.float64)
            self.last_num_inliers = int(host[12])
            self.last_ok = bool(host[13] > 0)
            if self.last_ok:
                R, t = host[:9].reshape(3, 3), host[9:12]
                # camera motion X2 = R X1 + t -> camera 2's pose in camera 1's frame
                T_rel = np.eye(4)
                T_rel[:3, :3] = R.T
                T_rel[:3, 3] = -R.T @ t
                self.current_pose = self.current_pose @ T_rel
        self.trajectory.append(self.current_pose[:3, 3].copy())

        if n_tracked < self.min_tracked_redetect:
            self.pts, self.pts_valid = self.detect_features(gray)
        else:
            self.pts, self.pts_valid = pts1, valid
        self.prev_gray = gray
        self._frame += 1
        return self.current_pose

    def draw_trajectory_overlay(self, frame: np.ndarray, size: int = 200) -> np.ndarray:
        """The frame with a top-down trajectory inset at (10, 10)."""
        out = np.array(frame, dtype=np.uint8, copy=True)
        panel = np.zeros((size, size, 3), np.uint8)
        traj = np.asarray(self.trajectory)
        if len(traj) >= 2:
            pts, _ = _top_down(traj, size)
            for a, b in zip(pts[:-1], pts[1:]):
                draw.line(panel, tuple(a), tuple(b), (0, 255, 0), 1)
            draw.circle(panel, tuple(pts[-1]), 3, (0, 0, 255), -1)
        out[10 : 10 + size, 10 : 10 + size] = add_weighted(out[10 : 10 + size, 10 : 10 + size],
                                                           0.3, panel, 0.7)
        return out


class SimpleSLAM:
    """Keyframe SLAM over VisualOdometry: a keyframe when the camera has
    moved more than 0.5 or turned more than 0.3 rad since the last one."""

    def __init__(self, camera_matrix: np.ndarray, **vo_kwargs):
        self.vo = VisualOdometry(camera_matrix, **vo_kwargs)
        self.keyframes: List[dict] = []
        self.translation_threshold = 0.5
        self.rotation_threshold = 0.3
        self.fps = 0.0

    def should_create_keyframe(self, pose: np.ndarray) -> bool:
        if not self.keyframes:
            return True
        last = self.keyframes[-1]["pose"]
        dt = np.linalg.norm(pose[:3, 3] - last[:3, 3])
        dR = pose[:3, :3] @ last[:3, :3].T
        angle = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        return dt > self.translation_threshold or angle > self.rotation_threshold

    def _add_keyframe(self, frame_bgr, pose: np.ndarray) -> None:
        gray = self.vo._gray(frame_bgr)
        kps = fast_ops.detect_fast(gray, 512, 20.0, 16, 9)
        desc = orb_ops.describe_orb_batch(gray[None], kps.xy[None], kps.valid[None])
        self.keyframes.append({"pose": pose.copy(), "kp": kps.xy.cpu().numpy(),
                               "desc": desc.bits[0].cpu().numpy(),
                               "valid": kps.valid.cpu().numpy()})

    def triangulate_points(self, kf1: dict, kf2: dict, pts1: np.ndarray,
                           pts2: np.ndarray) -> np.ndarray:
        """Linear (DLT) triangulation of matched pixels of two keyframes."""
        K = self.vo.K
        P1 = K @ np.asarray(kf1["pose"], np.float64)[:3]
        P2 = K @ np.asarray(kf2["pose"], np.float64)[:3]
        out = []
        for p1, p2 in zip(pts1, pts2):
            A = np.stack([p1[0] * P1[2] - P1[0], p1[1] * P1[2] - P1[1],
                          p2[0] * P2[2] - P2[0], p2[1] * P2[2] - P2[1]])
            X = np.linalg.svd(A)[2][-1]
            out.append(X[:3] / X[3])
        return np.asarray(out)

    def process_frame(self, frame_bgr) -> np.ndarray:
        t0 = time.perf_counter()
        pose = self.vo.process_frame(frame_bgr)
        if self.should_create_keyframe(pose):
            self._add_keyframe(frame_bgr, pose)
        dt = time.perf_counter() - t0
        self.fps = 1.0 / dt if dt > 0 else 0.0
        return pose

    def render_map(self, size: int = 400) -> np.ndarray:
        """A top-down map: the trajectory, the keyframes' dots, the current
        position and the "kf: N  fps: F" label."""
        panel = np.zeros((size, size, 3), np.uint8)
        traj = np.asarray(self.vo.trajectory)
        if len(traj) >= 2:
            pts, span = _top_down(traj, size)
            for a, b in zip(pts[:-1], pts[1:]):
                draw.line(panel, tuple(a), tuple(b), (0, 255, 0), 1)
            for kf in self.keyframes:
                p = kf["pose"][:3, 3][[0, 2]]
                q = ((p / span) * (size * 0.45) + size / 2).astype(np.int32)
                draw.circle(panel, tuple(q), 3, (255, 128, 0), -1)
            draw.circle(panel, tuple(pts[-1]), 4, (0, 0, 255), -1)
        draw.put_text(panel, f"kf: {len(self.keyframes)}  fps: {self.fps:.1f}", (8, size - 10),
                      0.45, (255, 255, 255))
        return panel
