"""The port's depth3d/ slice against the JAX package on the CPU: point clouds,
ICP, meshes, the TSDF and indicator fields, the PLY/OBJ and PNG writers,
cv2's uint8 smoothing filters and PLASMA map, the four pipelines and the
depth3d and terrain --reconstruct-3d commands."""

import os
import socket

import cv2
import numpy as np
import pytest
import torch

import rtvm_tpu.models.depthnet as jdepthnet
import rtvm_tpu_torch.device as tdevice
from rtvm_tpu.depth3d import icp as jicp, mesh as jmesh, pipeline as jpipeline
from rtvm_tpu.depth3d import pointcloud as jpc, tsdf as jtsdf
from rtvm_tpu.io import ply as jply
from rtvm_tpu_torch import cli
from rtvm_tpu_torch.depth3d import estimator as testimator, icp as ticp, mesh as tmesh
from rtvm_tpu_torch.depth3d import pipeline as tpipeline, pointcloud as tpc, tsdf as ttsdf
from rtvm_tpu_torch.io import ply as tply
from rtvm_tpu_torch.io.imread import imread
from rtvm_tpu_torch.io.png import encode_png, imwrite, imwrite_png
from rtvm_tpu_torch.ops.smooth import bilateral_filter_u8, median_blur_u8
from rtvm_tpu_torch.utils.colormap import PLASMA_BGR, apply_colormap

torch.set_num_threads(1)  # tier 1 runs several test workers at once

ICP_TOL = 1e-4
VERT_TOL = 1e-5
SMOOTH_TOL = 1e-6
TSDF_TOL = 1e-5
ANGLE_TOL_DEG = 0.5
# The pipelines run DepthNet on both sides (within 1e-4 of each other,
# tests/test_torch_depthnet.py); with depth_scale 5 a point moves by at most
# 5e-4, and the outlier and voxel steps may keep a point on one side only.
PIPE_POINT_TOL = 1e-3
PIPE_COUNT_SHARE = 0.01
# Every pipeline test runs DepthNet at this size: the JAX estimator runs its
# net op by op, and XLA compiles each op once per shape.
H, W = 48, 64


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    """The JAX estimator probes huggingface.co before its own net; make the
    probe fail, so it goes to its DepthNet without a connection."""
    def refuse(*a, **k):
        raise OSError("no network in the tests")

    monkeypatch.setattr(socket, "create_connection", refuse)


_FLAX_NET = []


@pytest.fixture(autouse=True)
def flax_net_built_once(monkeypatch):
    """Every JAX pipeline builds its estimator, and Flax initialises DepthNet
    op by op on a 240x320 example (about 12 s on a CPU); build it once for
    this file, on a small example (the parameter shapes do not depend on
    it). The checkpoint is still loaded into it on each build."""
    build = jdepthnet.build_depthnet

    def once(seed=0, example_hw=None):
        if not _FLAX_NET:
            _FLAX_NET.append(build(seed, example_hw=(32, 32)))
        return _FLAX_NET[0]

    monkeypatch.setattr(jdepthnet, "build_depthnet", once)


@pytest.fixture
def cpu_default(monkeypatch):
    """Entry points with no device run on the CPU (the CLI passes none)."""
    resolve = tdevice.resolve_device

    def cpu(device=None):
        return resolve("cpu" if device is None else device)

    for mod in (testimator, ticp, ttsdf, tdevice):
        monkeypatch.setattr(mod, "resolve_device", cpu)


@pytest.fixture
def cv2_without_ipp():
    """cv2's own bilateralFilter: the pip build's default route is Intel IPP,
    which rounds toward zero (see test_bilateral_filter_is_cv2_s_own)."""
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(was)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _image(h, w, seed=0):
    """A smooth textured BGR image (blurred noise and a few shapes)."""
    rng = np.random.RandomState(seed)
    img = cv2.GaussianBlur(rng.randint(0, 255, (h, w, 3)).astype(np.uint8), (0, 0), 2.0)
    for _ in range(6):
        x, y = rng.randint(0, w), rng.randint(0, h)
        c = tuple(int(v) for v in rng.randint(0, 255, 3))
        cv2.circle(img, (x, y), rng.randint(4, max(5, h // 5)), c, -1)
    return img


# ---------------------------------------------------------------- point clouds

def test_point_cloud_ops_are_the_jax_ones():
    rng = np.random.RandomState(7)
    depth = np.clip(rng.rand(40, 52).astype(np.float32), 0.0, 1.0)
    depth[5:9, 5:9] = 1.0  # z = 0: dropped by the validity test
    img = rng.randint(0, 255, (40, 52, 3)).astype(np.uint8)
    for kw in ({}, {"stride": 3, "depth_scale": 10.0}, {"fx": 80.0, "cx": 20.0, "invert": False}):
        jp, jc = jpc.unproject_depth(depth, img, **kw)
        tp, tc = tpc.unproject_depth(depth, img, **kw)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tc, jc)
    pts = rng.rand(3000, 3).astype(np.float32)
    cols = rng.randint(0, 255, (3000, 3)).astype(np.uint8)
    for a, b in zip(tpc.voxel_downsample(pts, 0.1, cols), jpc.voxel_downsample(pts, 0.1, cols)):
        np.testing.assert_array_equal(a, b)
    pts[:40] += 5 * rng.randn(40, 3).astype(np.float32)
    for a, b in zip(tpc.remove_statistical_outliers(pts, 20, 2.0, cols),
                    jpc.remove_statistical_outliers(pts, 20, 2.0, cols)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tpc.estimate_normals(pts, 12, np.zeros(3)),
                                  jpc.estimate_normals(pts, 12, np.zeros(3)))
    for axis in "xyz":
        np.testing.assert_array_equal(tpc.rotate_points(pts, axis, 0.7),
                                      jpc.rotate_points(pts, axis, 0.7))


# ------------------------------------------------------------------------ ICP

def test_register_clouds_matches_jax():
    """tests/test_depth3d.py's cloud: 800 points, rotated 0.15 rad about z and
    moved; both packages subsample with the same draws."""
    pts = np.random.RandomState(1234).rand(800, 3).astype(np.float32) * 2
    ang = 0.15
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                 np.float32)
    src = pts @ R.T + np.array([0.1, -0.05, 0.2], np.float32)
    for max_points in (800, 500, 1000):  # exact, subsampled and padded
        want = jicp.register_clouds(src, pts, threshold=0.5, max_points=max_points)
        got = ticp.register_clouds(src, pts, threshold=0.5, max_points=max_points, device="cpu")
        np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), rtol=0, atol=ICP_TOL)
        np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0, atol=ICP_TOL)
        assert float(got.fitness) == float(want.fitness)
        assert abs(float(got.inlier_rmse) - float(want.inlier_rmse)) < ICP_TOL
    back = src @ got.R.numpy().T + got.t.numpy()
    assert np.median(np.linalg.norm(back - pts, axis=1)) < 0.05


# ---------------------------------------------------------------------- meshes

def _faces_and_verts_close(got, want):
    (gv, gf), (wv, wf) = got[:2], want[:2]
    assert gf.shape == wf.shape
    np.testing.assert_array_equal(gf, wf)
    np.testing.assert_allclose(gv, wv, rtol=0, atol=VERT_TOL)


def _sphere(n, seed):
    v = np.random.RandomState(seed).randn(n, 3)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_meshes_match_jax():
    rng = np.random.RandomState(3)
    depth = cv2.GaussianBlur(rng.rand(48, 64).astype(np.float32), (0, 0), 3)
    depth = (depth - depth.min()) / (depth.max() - depth.min())
    img = rng.randint(0, 255, (48, 64, 3)).astype(np.uint8)
    for a, b in zip(tmesh.depth_grid_mesh(depth, img), jmesh.depth_grid_mesh(depth, img)):
        np.testing.assert_array_equal(a, b)
    xy = rng.rand(4000, 2) * 4
    terrain = np.column_stack([xy, 0.3 * np.sin(xy[:, 0]) + 0.01 * rng.randn(4000)])
    terrain = terrain.astype(np.float32)
    cols = rng.randint(0, 255, (4000, 3)).astype(np.uint8)
    assert tmesh.cloud_is_heightfield(terrain) == jmesh.cloud_is_heightfield(terrain) is True
    for a, b in zip(tmesh.heightfield_mesh_from_points(terrain, cols, grid=40),
                    jmesh.heightfield_mesh_from_points(terrain, cols, grid=40)):
        np.testing.assert_array_equal(a, b)
    g = np.linspace(-1, 1, 20, dtype=np.float32)
    field = np.sqrt(g[:, None, None] ** 2 + g[None, :, None] ** 2 + g[None, None, :] ** 2) - 0.7
    for a, b in zip(ttsdf.marching_tetrahedra(field, 0.0, (0.1, 0.2, 0.3), 0.1),
                    jtsdf.marching_tetrahedra(field, 0.0, (0.1, 0.2, 0.3), 0.1)):
        np.testing.assert_array_equal(a, b)


def test_indicator_field_and_mesh_match_jax():
    pts = _sphere(3000, 5)
    cols = (np.abs(pts) * 255).astype(np.uint8)
    interior = (np.random.RandomState(2).rand(24, 24, 24) > 0.5).astype(np.float32)
    np.testing.assert_allclose(ttsdf._smooth3d(_t(interior), 1.2).numpy(),
                               np.asarray(jtsdf._smooth3d(interior, 1.2)), rtol=0, atol=SMOOTH_TOL)
    jind = jtsdf.indicator_from_points(pts, grid=40)
    tind = ttsdf.indicator_from_points(pts, grid=40, device="cpu")
    np.testing.assert_allclose(tind.field, jind.field, rtol=0, atol=SMOOTH_TOL)
    np.testing.assert_array_equal(tind.origin, jind.origin)
    want = jtsdf.indicator_mesh_from_points(pts, cols, grid=40)
    got = ttsdf.indicator_mesh_from_points(pts, cols, grid=40, device="cpu")
    _faces_and_verts_close(got, want)
    np.testing.assert_array_equal(got[2], want[2])
    # the dispatcher routes a closed cloud to the indicator mesh
    assert not tmesh.cloud_is_heightfield(pts)
    _faces_and_verts_close(tmesh.surface_mesh_from_points(pts, grid=48, device="cpu"),
                           jmesh.surface_mesh_from_points(pts, grid=48))


def _sphere_views(n_img=48, f=60.0, r_cam=3.0, radius=0.8):
    """tests/test_tsdf.py:test_tsdf_fusion_sphere_depths' analytic depths of a
    unit sphere from 4 cameras on a circle, at half its image size."""
    K = np.array([[f, 0, n_img / 2], [0, f, n_img / 2], [0, 0, 1]], np.float32)

    def look_at_pose(angle):
        eye = np.array([r_cam * np.cos(angle), r_cam * np.sin(angle), 0.0])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
        right /= np.linalg.norm(right)
        true_up = np.cross(right, fwd)
        T = np.eye(4, dtype=np.float32)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, -true_up, fwd, eye
        return T

    def render_depth(T):
        u, v = np.meshgrid(np.arange(n_img), np.arange(n_img))
        d_cam = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1],
                          np.ones_like(u, np.float32)], -1)
        d_world = d_cam @ T[:3, :3].T
        o = T[:3, 3]
        b = (d_world * o).sum(-1)
        a = (d_world * d_world).sum(-1)
        c = (o * o).sum() - radius * radius
        disc = b * b - a * c
        t = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / a, -1.0)
        depth = np.where(t > 0, t, 0.0).astype(np.float32)
        return np.where(depth > 0, (d_cam * depth[..., None])[..., 2], 0.0).astype(np.float32)

    poses = np.stack([look_at_pose(a) for a in np.linspace(0, 2 * np.pi, 5)[:-1]])
    return np.stack([render_depth(T) for T in poses]), K, poses


def test_fuse_tsdf_matches_jax():
    depths, K, poses = _sphere_views()
    jvol = jtsdf.fuse_tsdf(jtsdf.make_tsdf((-1.2, -1.2, -1.2), 2.4, grid=40), depths, K, poses)
    tvol = ttsdf.fuse_tsdf(ttsdf.make_tsdf((-1.2, -1.2, -1.2), 2.4, grid=40), depths, K, poses,
                           device="cpu")
    np.testing.assert_allclose(tvol.tsdf, jvol.tsdf, rtol=0, atol=TSDF_TOL)
    np.testing.assert_array_equal(tvol.weight, jvol.weight)
    assert tvol.tsdf.dtype == np.float32 and tvol.voxel == jvol.voxel
    want, got = jtsdf.tsdf_mesh(jvol), ttsdf.tsdf_mesh(tvol)
    assert len(got[1]) == len(want[1]) > 100
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=VERT_TOL)


# ------------------------------------------------------------------- the files

def test_ply_and_obj_files_are_byte_identical(tmp_path):
    rng = np.random.RandomState(4)
    pts = rng.randn(50, 3).astype(np.float32)
    cols = rng.randint(0, 255, (50, 3)).astype(np.uint8)
    faces = rng.randint(0, 50, (30, 3)).astype(np.int32)
    writes = [("write_ply_points", (pts, cols), {}), ("write_ply_points", (pts,), {}),
              ("write_ply_points", (pts, cols), {"binary": False}),
              ("write_ply_points", (pts,), {"binary": False}),
              ("write_ply_mesh", (pts, faces, cols), {}), ("write_ply_mesh", (pts, faces), {}),
              ("write_obj_mesh", (pts, faces), {})]
    for i, (fn, args, kw) in enumerate(writes):
        a, b = tmp_path / f"t{i}", tmp_path / f"j{i}"
        getattr(tply, fn)(str(a), *args, **kw)
        getattr(jply, fn)(str(b), *args, **kw)
        assert a.read_bytes() == b.read_bytes(), fn
        if fn == "write_ply_points":
            for x, y in zip(tply.read_ply_points(str(a)), jply.read_ply_points(str(b))):
                np.testing.assert_array_equal(x, y)
    for x, y in zip(tply.read_obj_mesh(str(a)), jply.read_obj_mesh(str(b))):
        np.testing.assert_array_equal(x, y)


def test_png_round_trip_through_imread_and_cv2(tmp_path):
    rng = np.random.RandomState(5)
    for shape in [(31, 45), (31, 45, 3), (17, 9, 4), (1, 1, 3)]:
        img = rng.randint(0, 256, shape).astype(np.uint8)
        path = str(tmp_path / "x.png")
        assert imwrite_png(path, img)
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
        bgr = img if img.ndim == 3 else img[..., None]
        bgr = np.repeat(bgr, 3, axis=2) if bgr.shape[2] == 1 else bgr[..., :3]
        np.testing.assert_array_equal(imread(path), bgr)
        np.testing.assert_array_equal(cv2.imread(path), bgr)
    with pytest.raises(TypeError):
        encode_png(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4, 2), np.uint8))
    img = rng.randint(0, 256, (20, 30, 3)).astype(np.uint8)
    assert imwrite(str(tmp_path / "y.jpg"), img) and cv2.imread(str(tmp_path / "y.jpg")) is not None
    with pytest.raises(ValueError, match="PNG and JPEG"):
        imwrite(str(tmp_path / "y.bmp"), img)


# ------------------------------------------------------------ cv2's filters

def _u8_images():
    rng = np.random.RandomState(0)
    depth = cv2.GaussianBlur(rng.rand(120, 160).astype(np.float32), (0, 0), 8)
    depth = ((depth - depth.min()) / (depth.max() - depth.min()) * 255).astype(np.uint8)
    return {"noise": rng.randint(0, 256, (37, 53)).astype(np.uint8),
            "blurred": cv2.GaussianBlur(rng.randint(0, 256, (90, 110)).astype(np.uint8), (0, 0), 3),
            "depth": depth, "tiny": rng.randint(0, 256, (3, 4)).astype(np.uint8)}


def test_median_blur_is_cv2_s_byte_for_byte():
    for name, img in _u8_images().items():
        for k in (3, 5):
            np.testing.assert_array_equal(median_blur_u8(_t(img), k).numpy(),
                                          cv2.medianBlur(img, k), err_msg=f"{name} {k}")
    with pytest.raises(ValueError):
        median_blur_u8(_t(np.zeros((5, 5), np.float32)))


def test_bilateral_filter_is_cv2_s_own(cv2_without_ipp):
    """Byte-identical to cv2's own bilateralFilter (OpenCV's
    bilateral_filter.simd.hpp). cv2's x86 wheels call Intel IPP for it by
    default; IPP rounds toward zero, so there about half the pixels come out
    one level lower (checked below on the same images)."""
    imgs = _u8_images()
    for name, img in imgs.items():
        for args in ((5, 50, 50), (5, 20, 30), (9, 75, 75)):
            np.testing.assert_array_equal(bilateral_filter_u8(_t(img), *args).numpy(),
                                          cv2.bilateralFilter(img, *args), err_msg=f"{name} {args}")
    cv2.ipp.setUseIPP(True)
    if cv2.ipp.useIPP():
        img = imgs["depth"]
        diff = bilateral_filter_u8(_t(img)).numpy().astype(int) - cv2.bilateralFilter(img, 5, 50, 50)
        assert np.abs(diff).max() <= 1 and (diff != 0).mean() > 0.2


def test_plasma_table_is_cv2_s():
    levels = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(PLASMA_BGR, cv2.applyColorMap(levels[:, None],
                                                                cv2.COLORMAP_PLASMA)[:, 0])
    img = np.random.RandomState(1).randint(0, 256, (20, 30)).astype(np.uint8)
    np.testing.assert_array_equal(apply_colormap(img), cv2.applyColorMap(img, cv2.COLORMAP_PLASMA))


# ------------------------------------------------------------------ pipelines

def _close_clouds(got, want, tol=PIPE_POINT_TOL):
    """Clouds from DepthNet runs that agree within 1e-4: the counts within
    PIPE_COUNT_SHARE, and every point of the smaller within tol of the
    other's nearest."""
    from scipy.spatial import cKDTree

    assert abs(len(got) - len(want)) <= PIPE_COUNT_SHARE * len(want), (len(got), len(want))
    d, _ = cKDTree(want).query(got)
    assert d.max() <= tol, d.max()


def test_single_image_pipeline_matches_jax(tmp_path):
    img = _image(H, W, seed=1)
    src = str(tmp_path / "img.png")
    cv2.imwrite(src, img)
    want = jpipeline.process_single_image(src, output_dir=str(tmp_path / "j"))
    got = tpipeline.process_single_image(src, output_dir=str(tmp_path / "t"), device="cpu")
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=0, atol=1e-4)
    _close_clouds(got["points"], want["points"])
    tv, tf = tply.read_obj_mesh(got["mesh"])
    jv, jf = jply.read_obj_mesh(want["mesh"])
    assert abs(len(tf) - len(jf)) <= PIPE_COUNT_SHARE * len(jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-3)
    assert os.path.basename(got["cloud"]) == os.path.basename(want["cloud"])
    vis = imread(got["visualization"])
    assert vis.shape == (H, 3 * W, 3)
    np.testing.assert_array_equal(vis[:, :W], img)


def test_depth_panels_decimate_a_large_image():
    img = np.zeros((700, 1300, 3), np.uint8)
    panels = tpipeline.depth_panels(img, np.linspace(0, 1, 700 * 1300).reshape(700, 1300))
    assert panels.shape == (234, 3 * 434, 3)  # stride 3 = ceil(1300 / 640)
    np.testing.assert_array_equal(panels[0, 434], PLASMA_BGR[0])


def test_terrain_reconstructor_matches_jax(tmp_path, cv2_without_ipp):
    img = _image(H, W, seed=2)
    src = str(tmp_path / "terrain.png")
    cv2.imwrite(src, img)
    want = jpipeline.ImageTerrainReconstructor(fast=True).process(src, str(tmp_path / "j"))
    got = tpipeline.ImageTerrainReconstructor(fast=True, device="cpu").process(
        src, str(tmp_path / "t"), visualize=True)
    jd, td = cv2.imread(want["depth"]), imread(got["depth"])
    # (depth * 255).astype(uint8) truncates: a 1e-4 depth gap flips a level
    # at few pixels
    assert (jd != td).any(-1).mean() <= 1e-3
    assert got["num_faces"] == want["num_faces"]
    assert abs(got["num_points"] - want["num_points"]) <= PIPE_COUNT_SHARE * want["num_points"]
    _close_clouds(tply.read_ply_points(got["cloud"])[0], jply.read_ply_points(want["cloud"])[0],
                  tol=0.1)  # a level is 10/255 of depth here
    assert os.path.exists(os.path.join(tmp_path, "t", "terrain_panels.png"))


class _Capture:
    """cv2.VideoCapture over an array, so that the JAX pipeline reads the
    frames the port reads from a .npy file."""

    def __init__(self, frames):
        self.frames, self.i = frames, 0

    def read(self):
        if self.i >= len(self.frames):
            return False, None
        self.i += 1
        return True, self.frames[self.i - 1].copy()

    def release(self):
        pass


def _drifting_clip(n, h, w, step=3, seed=3):
    world = _image(h, w + n * step, seed=seed)
    return np.stack([world[:, i * step : i * step + w] for i in range(n)])


def test_video_pipeline_matches_jax(tmp_path, monkeypatch):
    frames = _drifting_clip(7, H, W)
    np.save(tmp_path / "clip.npy", frames)
    monkeypatch.setattr(cv2, "VideoCapture", lambda path: _Capture(frames))
    want = jpipeline.process_video_to_3d_model(str(tmp_path / "clip.npy"), str(tmp_path / "j"),
                                               frame_step=3, max_frames=2)
    got = tpipeline.process_video_to_3d_model(str(tmp_path / "clip.npy"), str(tmp_path / "t"),
                                              frame_step=3, max_frames=2, device="cpu")
    assert got["frames_used"] == want["frames_used"] == 2
    _close_clouds(got["points"], want["points"], tol=0.02)  # ICP moves points by up to 1e-2
    for key in ("cloud", "mesh_obj", "mesh_ply"):
        assert os.path.basename(got[key]) == os.path.basename(want[key]) == os.path.basename(
            want[key]) and os.path.exists(got[key])


def _views(tmp_path, h, w, n=3, shift=None, seed=4):
    """n overlapping views of one world, shifted right by `shift` px each."""
    shift = shift or w // 4
    world = _image(h, w + n * shift, seed=seed)
    paths = []
    for i in range(n):
        p = str(tmp_path / f"v{h}_{i}.png")
        cv2.imwrite(p, world[:, i * shift : i * shift + w])
        paths.append(p)
    return paths


def test_camera_angles_match_jax(tmp_path):
    paths = _views(tmp_path, 120, 160)
    ja = jpipeline.estimate_camera_angles_from_images([cv2.imread(p) for p in paths])
    ta = tpipeline.estimate_camera_angles_from_images([imread(p) for p in paths], device="cpu")
    np.testing.assert_allclose(ta, ja, rtol=0, atol=ANGLE_TOL_DEG)
    assert ta[-1] == pytest.approx(360.0) and 0 < ta[1] < 360.0


def test_multi_view_pipeline_matches_jax(tmp_path):
    paths = _views(tmp_path, H, W)
    want = jpipeline.process_multiple_images_to_3d(paths, str(tmp_path / "j"), angle_mode="uniform")
    got = tpipeline.process_multiple_images_to_3d(paths, str(tmp_path / "t"), angle_mode="uniform",
                                                  device="cpu")
    assert got["angles"] == want["angles"]
    _close_clouds(got["points"], want["points"], tol=0.03)  # voxel means of 0.02 cells
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))


# ------------------------------------------------------------------ the CLI

def test_depth3d_command_routes_as_jax(tmp_path, monkeypatch, cpu_default):
    monkeypatch.chdir(tmp_path)
    img = _image(48, 64, seed=5)
    imwrite_png("img.png", img)
    os.makedirs("views")
    for i in range(3):
        imwrite_png(f"views/v{i}.png", np.roll(img, 6 * i, axis=1))
    np.save("clip.npy", _drifting_clip(5, 48, 64))
    single = cli.main(["depth3d", "img.png", "--output-dir", "o1"])
    assert sorted(os.listdir("o1")) == ["img_depth_visualization.png", "img_mesh.obj",
                                        "img_pointcloud.ply"]
    assert len(tply.read_ply_points(single["cloud"])[0]) == len(single["points"])
    video = cli.main(["depth3d", "clip.npy", "--output-dir", "o2", "--frame-step", "4",
                      "--max-frames", "2"])
    assert video["frames_used"] == 2
    assert sorted(os.listdir("o2")) == ["clip_mesh.obj", "clip_mesh.ply", "clip_pointcloud.ply"]
    multi = cli.main(["depth3d", "views", "--output-dir", "o3", "--angle-mode", "uniform"])
    assert multi["angles"] == [0.0, 120.0, 240.0]
    assert sorted(os.listdir("o3")) == ["multi_view_mesh.obj", "multi_view_mesh.ply",
                                        "multi_view_pointcloud.ply"]


def test_depth3d_command_needs_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    imwrite_png(str(tmp_path / "img.png"), _image(20, 30))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["depth3d", str(tmp_path / "img.png"), "--output-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipeline.ImageTerrainReconstructor()
