"""Stereo depth (counterpart of ``rtvm_tpu/stereo/depth.py``): calibration
and rectification, SGM disparity with speckle suppression and the guided
filter on the device, depth, coloured point clouds, and the terrain mapper
with its obstacle mask; ``demo_stereo_depth`` is the synthetic known-
disparity pair.

The disparity runs on `device` (``cuda`` unless given) and comes back as one
[H, W] float32 array; clouds, depth and the colourings are numpy, the maps
the port's copies of cv2's JET and MAGMA (``utils/colormap.py``), and the
obstacle mask's opening and closing ``ops/filters.py``'s. Chessboard
calibration and rectification with maps are cv2 calls: they import cv2 on
that route only and raise ImportError where it is absent (the card has no
cv2); ``rectify_images`` without maps returns its inputs, as in JAX, so the
demo and ``process_stereo_frame`` need no cv2.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from rtvm_tpu_torch.device import resolve_device
from rtvm_tpu_torch.ops import color, filters
from rtvm_tpu_torch.stereo.refine import guided_refine, speckle_suppress
from rtvm_tpu_torch.stereo.sgm import disparity_to_depth, sgm_disparity
from rtvm_tpu_torch.utils.colormap import apply_colormap

NO_CV2 = ("{} needs OpenCV (cv2), which is not installed here; the disparity, the demo and "
          "process_stereo_frame on rectified pairs do not")


def _cv2(route: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(NO_CV2.format(route)) from e
    return cv2


def _normalised_u8(x: np.ndarray) -> np.ndarray:
    d = np.where(x > 0, x, 0)
    return (d / max(d.max(), 1e-6) * 255).astype(np.uint8)


class StereoDepthEstimator:
    """SGM stereo depth on `device` (``cuda`` unless given). ``use_wls`` and
    ``use_speckle`` switch the guided filter and the speckle suppression
    (the reference's SGBM+WLS mode); both off is its raw BM-like mode."""

    def __init__(
        self,
        baseline_m: float = 0.12,
        focal_px: float = 700.0,
        num_disparities: int = 128,
        use_wls: bool = True,
        use_speckle: bool = True,
        device=None,
    ):
        self.baseline = baseline_m
        self.focal = focal_px
        self.num_disparities = num_disparities
        self.use_wls = use_wls
        self.use_speckle = use_speckle
        self.device = resolve_device(device)
        self.calibrated = False
        self.maps = None  # rectification maps after calibration
        self.Q = None

    # ----------------------------------------------------------- calibration
    def calibrate_stereo_cameras(
        self,
        left_images: List[np.ndarray],
        right_images: List[np.ndarray],
        board_size: Tuple[int, int] = (9, 6),
        square_mm: float = 25.0,
    ) -> bool:
        """Chessboard stereo calibration on the host with cv2; updates focal,
        baseline and the rectification maps. False with fewer than 3 pairs
        where both boards are found."""
        cv2 = _cv2("calibrate_stereo_cameras")
        objp = np.zeros((board_size[0] * board_size[1], 3), np.float32)
        objp[:, :2] = np.mgrid[0 : board_size[0], 0 : board_size[1]].T.reshape(-1, 2)
        objp *= square_mm / 1000.0
        obj_pts, l_pts, r_pts = [], [], []
        shape = None
        crit = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-3)
        for li, ri in zip(left_images, right_images):
            gl = cv2.cvtColor(li, cv2.COLOR_BGR2GRAY)
            gr = cv2.cvtColor(ri, cv2.COLOR_BGR2GRAY)
            shape = gl.shape[::-1]
            okl, cl = cv2.findChessboardCorners(gl, board_size)
            okr, cr = cv2.findChessboardCorners(gr, board_size)
            if okl and okr:
                cl = cv2.cornerSubPix(gl, cl, (11, 11), (-1, -1), crit)
                cr = cv2.cornerSubPix(gr, cr, (11, 11), (-1, -1), crit)
                obj_pts.append(objp)
                l_pts.append(cl)
                r_pts.append(cr)
        if len(obj_pts) < 3:
            return False
        _, K1, d1, _, _ = cv2.calibrateCamera(obj_pts, l_pts, shape, None, None)
        _, K2, d2, _, _ = cv2.calibrateCamera(obj_pts, r_pts, shape, None, None)
        _, K1, d1, K2, d2, R, T, _, _ = cv2.stereoCalibrate(
            obj_pts, l_pts, r_pts, K1, d1, K2, d2, shape, flags=cv2.CALIB_FIX_INTRINSIC,
            criteria=crit)
        R1, R2, P1, P2, Q, _, _ = cv2.stereoRectify(K1, d1, K2, d2, shape, R, T)
        m1 = cv2.initUndistortRectifyMap(K1, d1, R1, P1, shape, cv2.CV_32FC1)
        m2 = cv2.initUndistortRectifyMap(K2, d2, R2, P2, shape, cv2.CV_32FC1)
        self.maps = (m1, m2)
        self.Q = Q
        self.baseline = float(abs(T[0, 0]))
        self.focal = float(P1[0, 0])
        self.calibrated = True
        return True

    def rectify_images(self, left: np.ndarray, right: np.ndarray):
        """The pair through the calibration's maps (cv2.remap); the inputs
        as they are when there are no maps."""
        if self.maps is None:
            return left, right
        cv2 = _cv2("rectify_images with calibration maps")
        (m1x, m1y), (m2x, m2y) = self.maps
        return (cv2.remap(left, m1x, m1y, cv2.INTER_LINEAR),
                cv2.remap(right, m2x, m2y, cv2.INTER_LINEAR))

    # ------------------------------------------------------------- disparity
    def compute_disparity(self, left_bgr: np.ndarray, right_bgr: np.ndarray) -> np.ndarray:
        """[H, W] float32 disparity (px, invalid -1) of a rectified BGR pair."""
        gl = color.bgr2gray(torch.as_tensor(np.asarray(left_bgr)).to(self.device))
        gr = color.bgr2gray(torch.as_tensor(np.asarray(right_bgr)).to(self.device))
        disp = sgm_disparity(gl, gr, self.num_disparities).disparity
        if self.use_speckle:
            disp = speckle_suppress(disp)
        if self.use_wls:
            disp = guided_refine(disp, gl)
        return disp.cpu().numpy()

    def disparity_to_depth(self, disparity: np.ndarray) -> np.ndarray:
        return disparity_to_depth(disparity, self.focal, self.baseline)

    # ----------------------------------------------------------- point cloud
    def create_point_cloud(self, disparity: np.ndarray, left_bgr: np.ndarray) -> np.ndarray:
        """[N, 6] XYZRGB of the valid pixels."""
        h, w = disparity.shape
        depth = self.disparity_to_depth(disparity)
        valid = (disparity > 0) & (depth > 0)
        us, vs = np.meshgrid(np.arange(w), np.arange(h))
        z = depth[valid]
        x = (us[valid] - w / 2.0) * z / self.focal
        y = (vs[valid] - h / 2.0) * z / self.focal
        rgb = left_bgr[valid][:, ::-1]
        return np.concatenate([np.stack([x, y, z], 1), rgb], axis=1).astype(np.float32)

    def save_point_cloud(self, cloud_xyzrgb: np.ndarray, path: str):
        from rtvm_tpu_torch.io.ply import write_ply_points

        write_ply_points(path, cloud_xyzrgb[:, :3], cloud_xyzrgb[:, 3:].astype(np.uint8))

    # --------------------------------------------------------- visualization
    @staticmethod
    def colorize_disparity(disparity: np.ndarray) -> np.ndarray:
        """The valid disparity scaled to 0..255 through cv2's JET map (BGR)."""
        return apply_colormap(_normalised_u8(disparity), "jet")

    @staticmethod
    def colorize_depth(depth: np.ndarray) -> np.ndarray:
        """The positive depth scaled to 0..255 through cv2's MAGMA map (BGR)."""
        return apply_colormap(_normalised_u8(depth), "magma")


class StereoTerrainMapper:
    """Per-pair terrain products: disparity, depth, cloud, colourings."""

    def __init__(self, estimator: Optional[StereoDepthEstimator] = None, device=None):
        self.est = estimator or StereoDepthEstimator(device=device)

    def process_stereo_frame(self, left_bgr: np.ndarray, right_bgr: np.ndarray) -> dict:
        left_r, right_r = self.est.rectify_images(left_bgr, right_bgr)
        disp = self.est.compute_disparity(left_r, right_r)
        depth = self.est.disparity_to_depth(disp)
        return {
            "disparity": disp,
            "depth": depth,
            "cloud": self.est.create_point_cloud(disp, left_r),
            "disparity_vis": self.est.colorize_disparity(disp),
            "depth_vis": self.est.colorize_depth(depth),
        }

    @staticmethod
    def depth_profile(depth: np.ndarray, row: Optional[int] = None) -> np.ndarray:
        r = row if row is not None else depth.shape[0] // 2
        return depth[r]

    def obstacle_mask(self, depth: np.ndarray, max_distance_m: float = 2.0) -> np.ndarray:
        """Pixels nearer than `max_distance_m`, opened then closed by a 5x5
        square (cv2's morphology: outside counts as +inf to the erosion and
        -inf to the dilation), on the estimator's device; bool [H, W]."""
        d = torch.as_tensor(np.asarray(depth)).to(self.est.device)
        m = ((d > 0) & (d < max_distance_m)).to(torch.float32)
        m = filters.morph_close(filters.morph_open(m, 5), 5)
        return (m > 0).cpu().numpy()


def demo_stereo_depth(size=(120, 160), shift_far: int = 5, shift_near: int = 20, device=None):
    """Synthetic stereo pair of two textured rectangles at known disparities
    (`shift_far`, `shift_near`) over a noise background; returns (left,
    right, disparity) with 32 disparities on `device`."""
    rng = np.random.RandomState(3)
    h, w = size
    base = (rng.rand(h, w, 3) * 60 + 40).astype(np.uint8)
    left = base.copy()
    right = base.copy()

    def put(img, x0, y0, patch):
        bh, bw = patch.shape[:2]
        img[y0 : y0 + bh, x0 : x0 + bw] = patch

    far_patch = (rng.rand(30, 40, 3) * 80 + 150).astype(np.uint8)
    near_patch = (rng.rand(35, 50, 3) * 80 + 120).astype(np.uint8)
    put(left, 90, 20, far_patch)
    put(right, 90 - shift_far, 20, far_patch)
    put(left, 40, 70, near_patch)
    put(right, 40 - shift_near, 70, near_patch)

    est = StereoDepthEstimator(num_disparities=32, device=device)
    disp = est.compute_disparity(left, right)
    return left, right, disp
