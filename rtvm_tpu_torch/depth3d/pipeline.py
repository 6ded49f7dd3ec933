"""Depth-to-3D pipelines (counterpart of ``rtvm_tpu/depth3d/pipeline.py``;
reference depth_to_3d.py:542-1175 and image_terrain_reconstruction.py:59-517):

- process_video_to_3d_model: sampled frames -> depth -> clouds -> ICP fusion ->
  filtered/voxelized cloud + mesh;
- process_single_image: one image -> cloud + mesh + depth panels;
- process_multiple_images_to_3d: multi-view fusion with ORB-based camera-angle
  estimation;
- ImageTerrainReconstructor: single-image terrain pipeline with bilateral and
  median smoothing and PNG/PLY/OBJ outputs.

DepthNet, ICP, the indicator smoothing, ORB and the two smoothing filters run
on `device` (``cuda`` unless the caller passes another); the point-cloud and
mesh steps run on the host, as in JAX. Images are read with ``io/imread.py``
and PNGs written with ``io/png.py``. The JAX package draws its depth panels
with matplotlib (axes, titles, a colour bar); the card has no matplotlib, so
the port draws the three panels itself (``save_depth_panels``).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from rtvm_tpu_torch.depth3d.estimator import MonocularDepthEstimator
from rtvm_tpu_torch.depth3d.icp import register_clouds
from rtvm_tpu_torch.depth3d.mesh import depth_grid_mesh, surface_mesh_from_points
from rtvm_tpu_torch.depth3d.pointcloud import (
    remove_statistical_outliers,
    rotate_points,
    unproject_depth,
    voxel_downsample,
)
from rtvm_tpu_torch.io.imread import imread
from rtvm_tpu_torch.io.ply import write_obj_mesh, write_ply_mesh, write_ply_points
from rtvm_tpu_torch.io.png import imwrite_png
from rtvm_tpu_torch.utils.colormap import apply_colormap

PANEL_ALPHA = 0.55  # the overlay panel's share of the depth colours, JAX's alpha
PANEL_MAX_SIDE = 640  # panels of a larger image are decimated to about this side


def process_video_to_3d_model(
    video_path,
    output_dir: Optional[str] = None,
    model: str = "depth-anything-small",
    frame_step: int = 30,
    max_frames: int = 8,
    single_frame: bool = False,
    icp_threshold: float = 0.5,
    icp_fitness_accept: float = 0.3,
    voxel: float = 0.02,
    device=None,
):
    """Video (anything ``io/video.py`` reads) -> fused point cloud (.ply) +
    mesh (.obj/.ply). Frames whose ICP fitness is below the accept gate are
    dropped (reference depth_to_3d.py:658-665)."""
    est = MonocularDepthEstimator(model, device=device)
    base = os.path.splitext(os.path.basename(os.fspath(video_path)))[0]
    out_dir = output_dir or "."
    os.makedirs(out_dir, exist_ok=True)

    samples = list(est.estimate_depth_video(video_path, frame_step, 1 if single_frame else max_frames))
    if not samples:
        raise ValueError(f"no frames decoded from {video_path}")

    merged_pts, merged_cols = None, None
    kept = 0
    for i, (frame, depth) in enumerate(samples):
        pts, cols = unproject_depth(depth, frame, stride=3)
        if merged_pts is None:
            merged_pts, merged_cols = pts, cols
            kept += 1
            continue
        res = register_clouds(pts, merged_pts, threshold=icp_threshold, device=est.device)
        fitness = float(res.fitness)
        if fitness < icp_fitness_accept:
            print(f"Кадр {i}: ICP fitness {fitness:.2f} < {icp_fitness_accept}, пропуск")
            continue
        R = res.R.cpu().numpy()
        t = res.t.cpu().numpy()
        merged_pts = np.concatenate([merged_pts, pts @ R.T + t], axis=0)
        merged_cols = np.concatenate([merged_cols, cols], axis=0)
        kept += 1

    merged_pts, merged_cols, _ = remove_statistical_outliers(merged_pts, 20, 2.0, merged_cols)
    merged_pts, merged_cols = voxel_downsample(merged_pts, voxel, merged_cols)

    cloud_path = os.path.join(out_dir, f"{base}_pointcloud.ply")
    write_ply_points(cloud_path, merged_pts, merged_cols)

    verts, faces, vcols = surface_mesh_from_points(merged_pts, merged_cols, device=est.device)
    verts = rotate_points(verts, "x", np.pi)  # reference flips the mesh upright
    mesh_obj = os.path.join(out_dir, f"{base}_mesh.obj")
    mesh_ply = os.path.join(out_dir, f"{base}_mesh.ply")
    write_obj_mesh(mesh_obj, verts, faces)
    write_ply_mesh(mesh_ply, verts, faces, vcols)
    print(f"Сохранено: {cloud_path} ({len(merged_pts)} точек), {mesh_obj} ({len(faces)} граней); "
          f"использовано кадров: {kept}/{len(samples)}")
    return {"cloud": cloud_path, "mesh_obj": mesh_obj, "mesh_ply": mesh_ply,
            "points": merged_pts, "colors": merged_cols, "frames_used": kept}


def _read(path: str) -> np.ndarray:
    img = imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img


def process_single_image(
    image_path: str,
    output_dir: Optional[str] = None,
    model: str = "depth-anything-small",
    depth_scale: float = 5.0,
    device=None,
):
    """Image -> cloud + mesh + 3-panel depth visualization (reference
    depth_to_3d.py:760-841)."""
    img = _read(image_path)
    est = MonocularDepthEstimator(model, device=device)
    depth = est.estimate_depth(img)
    base = os.path.splitext(os.path.basename(image_path))[0]
    out_dir = output_dir or "."
    os.makedirs(out_dir, exist_ok=True)

    pts, cols = unproject_depth(depth, img, depth_scale=depth_scale, stride=2)
    pts, cols, _ = remove_statistical_outliers(pts, 20, 2.0, cols)
    cloud_path = os.path.join(out_dir, f"{base}_pointcloud.ply")
    write_ply_points(cloud_path, pts, cols)

    verts, faces, vcols = depth_grid_mesh(depth, img, depth_scale=depth_scale)
    mesh_path = os.path.join(out_dir, f"{base}_mesh.obj")
    write_obj_mesh(mesh_path, verts, faces)

    vis_path = os.path.join(out_dir, f"{base}_depth_visualization.png")
    save_depth_panels(img, depth, vis_path)
    return {"cloud": cloud_path, "mesh": mesh_path, "visualization": vis_path,
            "points": pts, "depth": depth}


def depth_panels(img_bgr: np.ndarray, depth: np.ndarray) -> np.ndarray:
    """The image, its PLASMA depth and the two overlaid (depth at alpha
    PANEL_ALPHA) side by side, [h, 3w, 3] uint8 BGR; an image whose longer
    side exceeds PANEL_MAX_SIDE is decimated by a whole stride first. The
    JAX package's matplotlib figure also has titles, axes and a colour bar."""
    s = max(1, -(-max(img_bgr.shape[:2]) // PANEL_MAX_SIDE))
    img = img_bgr[::s, ::s]
    colours = apply_colormap((np.clip(depth[::s, ::s], 0.0, 1.0) * 255).astype(np.uint8))
    mix = ((1.0 - PANEL_ALPHA) * img + PANEL_ALPHA * colours + 0.5).astype(np.uint8)
    return np.concatenate([img, colours, mix], axis=1)


def save_depth_panels(img_bgr: np.ndarray, depth: np.ndarray, path: str) -> None:
    imwrite_png(path, depth_panels(img_bgr, depth))


def estimate_camera_angles_from_images(images: List[np.ndarray], fov_deg: float = 60.0,
                                       device=None) -> List[float]:
    """Heuristic yaw angles from consecutive ORB match displacement mapped through the
    FOV, cumulative and renormalized toward 360 (reference depth_to_3d.py:844-934).
    FAST, ORB and the Hamming cross-check run on `device`."""
    from rtvm_tpu_torch.device import resolve_device
    from rtvm_tpu_torch.ops import color
    from rtvm_tpu_torch.ops import match as match_ops
    from rtvm_tpu_torch.ops.features import fast as fast_ops, orb as orb_ops

    dev = resolve_device(device)
    angles = [0.0]
    feats = []
    for img in images:
        g = color.bgr2gray(torch.from_numpy(np.ascontiguousarray(img)).to(dev))
        kp = fast_ops.detect_fast(g, 300, 20.0, 16, 9)
        de = orb_ops.describe_orb_batch(g[None], kp.xy[None], kp.valid[None])
        feats.append((kp, de))
    for i in range(1, len(images)):
        kp0, d0 = feats[i - 1]
        kp1, d1 = feats[i]
        m = match_ops.match_hamming_crosscheck(d1.bits, d1.valid, d0.bits, d0.valid)
        src, dst, valid = match_ops.gather_correspondences(kp1.xy[None], kp0.xy[None], m)
        v = valid[0].cpu().numpy()
        if v.sum() < 8:
            delta = 360.0 / len(images)
        else:
            dx = float(np.median((dst - src)[0].cpu().numpy()[v][:, 0]))
            w = images[i].shape[1]
            delta = float(np.clip(dx / w * fov_deg, -90.0, 90.0))
        angles.append(angles[-1] + delta)
    total = angles[-1] if abs(angles[-1]) > 1e-6 else 360.0
    return [a * 360.0 / total for a in angles]


def process_multiple_images_to_3d(
    image_paths: List[str],
    output_dir: Optional[str] = None,
    model: str = "depth-anything-small",
    angle_mode: str = "auto",
    manual_angles: Optional[List[float]] = None,
    voxel: float = 0.02,
    device=None,
):
    """Multi-view fusion: per-image clouds rotated by estimated yaw, merged,
    filtered, meshed (reference depth_to_3d.py:936-1175)."""
    images = [imread(p) for p in image_paths]
    images = [im for im in images if im is not None]
    if not images:
        raise ValueError("no readable images")
    est = MonocularDepthEstimator(model, device=device)
    if angle_mode == "manual" and manual_angles:
        angles = manual_angles
    elif angle_mode == "uniform":
        angles = [i * 360.0 / len(images) for i in range(len(images))]
    else:
        angles = estimate_camera_angles_from_images(images, device=est.device)

    out_dir = output_dir or "."
    os.makedirs(out_dir, exist_ok=True)

    all_pts, all_cols = [], []
    for img, ang in zip(images, angles):
        depth = est.estimate_depth(img)
        pts, cols = unproject_depth(depth, img, stride=3)
        pts, cols, _ = remove_statistical_outliers(pts, 16, 2.5, cols)
        pts, cols = voxel_downsample(pts, 0.03, cols)
        pts = rotate_points(pts, "y", np.deg2rad(ang))
        all_pts.append(pts)
        all_cols.append(cols)
    merged = np.concatenate(all_pts, 0)
    mcols = np.concatenate(all_cols, 0)
    merged, mcols, _ = remove_statistical_outliers(merged, 20, 2.0, mcols)
    merged, mcols = voxel_downsample(merged, voxel, mcols)

    cloud_path = os.path.join(out_dir, "multi_view_pointcloud.ply")
    write_ply_points(cloud_path, merged, mcols)
    # 360-degree fusion clouds are not heightfields: volumetric reconstruction
    # (smoothed-indicator level set, the Poisson stand-in) unless auto detects a
    # flat scan.
    verts, faces, vcols = surface_mesh_from_points(merged, mcols, device=est.device)
    write_obj_mesh(os.path.join(out_dir, "multi_view_mesh.obj"), verts, faces)
    write_ply_mesh(os.path.join(out_dir, "multi_view_mesh.ply"), verts, faces, vcols)
    return {"cloud": cloud_path, "points": merged, "angles": angles}


class ImageTerrainReconstructor:
    """Single-image terrain 3D reconstruction (reference
    image_terrain_reconstruction.py:59-517): depth -> bilateral+median smoothing ->
    dense cloud -> mesh -> saved artifacts."""

    def __init__(self, model: str = "depth-anything-small", depth_scale: float = 10.0,
                 fast: bool = False, device=None):
        self.est = MonocularDepthEstimator(model, device=device)
        self.depth_scale = depth_scale
        self.fast = fast

    def process(self, image_path: str, output_dir: Optional[str] = None, visualize: bool = False):
        from rtvm_tpu_torch.ops.smooth import bilateral_filter_u8, median_blur_u8

        img = _read(image_path)
        base = os.path.splitext(os.path.basename(image_path))[0]
        out_dir = output_dir or "."
        os.makedirs(out_dir, exist_ok=True)

        depth = self.est.estimate_depth(img)
        # preprocessing parity: bilateral smoothing + median hole-fill
        # (image_terrain_reconstruction.py:171-183), on the estimator's device
        d8 = torch.from_numpy((depth * 255).astype(np.uint8)).to(self.est.device)
        d8 = median_blur_u8(bilateral_filter_u8(d8, 5, 50, 50), 5)
        depth = d8.cpu().numpy().astype(np.float32) / 255.0

        stride = 3 if self.fast else 1
        pts, cols = unproject_depth(depth, img, depth_scale=self.depth_scale, stride=stride)
        pts, cols, _ = remove_statistical_outliers(pts, 20, 3.0, cols)
        pts_v, cols_v = voxel_downsample(pts, 0.02, cols)

        depth_png = os.path.join(out_dir, f"{base}_depth.png")
        imwrite_png(depth_png, apply_colormap((depth * 255).astype(np.uint8)))
        cloud_path = os.path.join(out_dir, f"{base}_pointcloud.ply")
        write_ply_points(cloud_path, pts_v, cols_v)
        verts, faces, _ = depth_grid_mesh(depth, img, depth_scale=self.depth_scale,
                                          stride=2 if self.fast else 1)
        mesh_path = os.path.join(out_dir, f"{base}_mesh.obj")
        write_obj_mesh(mesh_path, verts, faces)
        if visualize:
            save_depth_panels(img, depth, os.path.join(out_dir, f"{base}_panels.png"))
        return {"depth": depth_png, "cloud": cloud_path, "mesh": mesh_path,
                "num_points": len(pts_v), "num_faces": len(faces)}
