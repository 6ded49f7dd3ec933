"""Typed configuration tree, a copy of the JAX package's ``config.py``.

The port keeps its own copy instead of importing ``rtvm_tpu.config``: importing
anything under ``rtvm_tpu`` runs that package's ``__init__``, which imports the
JAX stitcher. The dataclasses and their defaults are the same, so a config
built for one package describes the same run in the other.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Feature detection/description (reference: SIFT_create(700)/ORB_create(700), main.py:33-37)."""

    detector_type: str = "sift"  # "sift" | "orb"
    max_keypoints: int = 700  # fixed K for shape-stable jit
    fast_threshold: float = 20.0  # FAST-9/16 intensity threshold (ORB path)
    fast_arc_length: int = 9
    border_margin: int = 16  # keypoints closer than this to the border are dropped
    brief_bits: int = 256  # rBRIEF descriptor length (bits)
    brief_patch_radius: int = 13  # max offset of a BRIEF test point before rotation
    brief_blur_sigma: float = 2.0
    orientation_radius: int = 15  # intensity-centroid patch radius
    # SIFT path
    sift_octaves: int = 4
    sift_scales: int = 3  # scales per octave at which extrema are found
    sift_sigma: float = 1.6
    # keypoint-budget split across octaves ~ decay^-o. cv2.SIFT's keypoint mass
    # on the drone footage sits overwhelmingly at fine scale (its 2x-upsampled
    # octave alone carries ~68%, measured frame 0/3/6/9: 485/473/467/454 of
    # 700); a steep split matches that distribution without paying the 4x
    # pyramid cost of an upsampled octave.
    sift_octave_decay: float = 4.0
    # cv2's contrastThreshold=0.04 is applied as ~0.5*0.04/nscales = 0.0067 on [0,1]
    # images; 0.008 gives comparable keypoint counts.
    sift_contrast_threshold: float = 0.008
    sift_descriptor_width: int = 4  # 4x4 spatial bins
    sift_descriptor_bins: int = 8  # 8 orientation bins -> 128-d


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Descriptor matching (reference: BFMatcher knn/crossCheck, main.py:676-708)."""

    ratio: float = 0.7  # Lowe ratio for SIFT knn2 (main.py:691)
    cross_check: bool = True  # ORB path (main.py:37)


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """RANSAC homography (reference: cv2.findHomography RANSAC, reproj 2.0, main.py:856-857)."""

    num_hypotheses: int = 256  # fixed-size hypothesis batch (vmap'd 4-point DLT solves)
    reproj_threshold: float = 2.0
    refine_iterations: int = 1  # masked-DLT refits on the best hypothesis's inliers
    min_matches: int = 4  # below this the frame is skipped (main.py:722)


@dataclasses.dataclass(frozen=True)
class StabilizationConfig:
    """Anti-shake validation + smoothing (reference main.py:94-101,761-834)."""

    enabled: bool = True
    history_size: int = 5
    translation_threshold: float = 50.0  # px
    scale_threshold: float = 0.3
    perspective_threshold: float = 1e-3


@dataclasses.dataclass(frozen=True)
class BlendConfig:
    """Warp + feathered blending (reference main.py:861-977).

    The reference recomputes two full-canvas L2 distance transforms + 31x31 Gaussian blurs
    per frame. The TPU design instead warps a static edge-distance ramp of the frame and
    carries a persistent canvas weight map, which gives the same distance-weighted feather
    without any per-frame distance transform.
    """

    # px over which the frame edge ramps 0 -> 1; 240 >= the 360p frame half-height,
    # i.e. an uncapped ramp == the reference's pure distance-transform weighting
    # (34.9 dB vs the OpenCV oracle, vs 32.1 dB at radius 32)
    feather_radius: float = 240.0
    interpolation: str = "bilinear"


@dataclasses.dataclass(frozen=True)
class MosaicConfig:
    """Canvas geometry (reference main.py:80-102)."""

    output_height_times: float = 2.0
    output_width_times: float = 1.2
    window_size: int = 16  # frames batched per jitted step
    # Growing HBM canvas (long-video / config-5 streaming): when the warped
    # footprint comes within `grow_margin` px of a canvas edge, the canvas is
    # padded on-device in `grow_quantum`-px steps (quantized so jit
    # re-specializations stay rare). Off by default — reference parity is a
    # fixed preallocated canvas (main.py:80-81).
    auto_grow: bool = False
    grow_margin: int = 48
    grow_quantum: int = 256
    # Pre-scanned canvas geometry (config-5 fused streaming): when canvas_hw
    # is set, the canvas is allocated with exactly (rows, cols) and the first
    # frame seeds at seed_offset (row, col) instead of the output_*_times
    # bottom-center heuristic. Computed by mosaic.prescan.prescan_canvas from
    # a cheap strided host-side motion scan so the fused clip path can run
    # without reactive growth.
    canvas_hw: Optional[Tuple[int, int]] = None
    seed_offset: Optional[Tuple[int, int]] = None
    features: FeatureConfig = dataclasses.field(default_factory=FeatureConfig)
    match: MatchConfig = dataclasses.field(default_factory=MatchConfig)
    ransac: RansacConfig = dataclasses.field(default_factory=RansacConfig)
    stabilization: StabilizationConfig = dataclasses.field(default_factory=StabilizationConfig)
    blend: BlendConfig = dataclasses.field(default_factory=BlendConfig)


@dataclasses.dataclass(frozen=True)
class DetectConfig:
    """Object detection (reference main.py:114-464)."""

    # The reference's primary detector is YOLO11n (main.py:44); served from
    # weights/yolo11n_aerial.npz (mosaic-scale mAP50 0.9889, person 0.9604 —
    # weights/mosaic_scale_eval_yolo11n.json, matching the v8n numbers).
    model: str = "yolo11n"
    conf: float = 0.5
    iou: float = 0.45
    imgsz: int = 640
    # open-vocab multi-pass settings (main.py:149-349)
    world_conf: float = 0.02
    world_imgsz: int = 1280
    window_size: int = 640
    window_stride: int = 400
    max_area_frac: float = 0.15
    min_area_building: float = 200.0
    min_area_other: float = 80.0


@dataclasses.dataclass(frozen=True)
class NavigationConfig:
    """Navigation-map building (reference main.py:1051-1509)."""

    grid_scale: int = 4  # occupancy grid downsample factor (main.py:1422)
    blocked_fraction: float = 0.3  # cell blocked if >30% obstacle pixels
    dilate_size: int = 15
    smooth_window: int = 5


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout for multi-chip runs (new; the reference has none, SURVEY.md 2.7)."""

    dp: int = 1  # data parallel (frame windows / image batches)
    tp: int = 1  # tensor parallel (detector channels / canvas tiles)
    mesh_axis_names: Tuple[str, ...] = ("dp", "tp")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    video_path: Optional[str] = None
    images_dir: Optional[str] = None
    output_dir: Optional[str] = None
    show_intermediate: bool = True
    mosaic: MosaicConfig = dataclasses.field(default_factory=MosaicConfig)
    detect: DetectConfig = dataclasses.field(default_factory=DetectConfig)
    navigation: NavigationConfig = dataclasses.field(default_factory=NavigationConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
