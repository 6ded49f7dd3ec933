"""Parity of the port's viz/ (the z-buffer rasterizer, surfel sampling, the
offscreen PNG, the HTML viewers and the viewer routes) with the JAX package,
both on the CPU, on seeded numpy clouds and meshes."""

import os

import cv2
import numpy as np
import pytest
import torch

from rtvm_tpu.io import ply as jply
from rtvm_tpu.viz import html3d as jhtml
from rtvm_tpu.viz import pointcloud_viewer as jpv
from rtvm_tpu.viz import render as jrender
from rtvm_tpu_torch.io import ply as tply
from rtvm_tpu_torch.io.imread import imread
from rtvm_tpu_torch.viz import html3d as thtml
from rtvm_tpu_torch.viz import pointcloud_viewer as tpv
from rtvm_tpu_torch.viz import render as trender

torch.set_num_threads(1)  # tier 1 runs several test workers at once

MIN_SAME_PIXELS = 0.999  # a projection at half a pixel may round the other way


def _cloud(n=4000, seed=0):
    rng = np.random.RandomState(seed)
    pts = rng.rand(n, 3).astype(np.float32) * 2 - 1
    return pts, ((pts + 1) / 2 * 255).astype(np.uint8)


def _sphere(nt=24, nphi=48):
    th, ph = np.linspace(0, np.pi, nt), np.linspace(0, 2 * np.pi, nphi)
    t, p = np.meshgrid(th, ph, indexing="ij")
    v = np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)], -1)
    idx = np.arange(nt * nphi).reshape(nt, nphi)
    a, b, c, d = idx[:-1, :-1], idx[1:, :-1], idx[:-1, 1:], idx[1:, 1:]
    f = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                        np.stack([b, d, c], -1).reshape(-1, 3)])
    return v.reshape(-1, 3).astype(np.float32), f.astype(np.int64)


def _tie_scene(seed):
    """Points on three planes facing a camera that looks down -Z from z = 5
    (view = a translation, focal 1): most pixels get several splats at one
    depth, and the first 200 points are repeated with other colours."""
    rng = np.random.RandomState(seed)
    n = 3000
    pts = np.stack([rng.uniform(-6, 6, n), rng.uniform(-4, 4, n),
                    rng.choice([-1.0, 0.0, 0.0, 1.0], n)], -1).astype(np.float32)
    pts = np.concatenate([pts, pts[:200]])
    cols = rng.randint(0, 256, (len(pts), 3)).astype(np.uint8)
    view = np.eye(4, dtype=np.float32)
    view[2, 3] = -5.0
    return pts, cols, view


@pytest.mark.parametrize("psize", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_splat_with_equal_depth_ties_equals_jax(psize, seed):
    pts, cols, view = _tie_scene(seed)
    kw = dict(width=64, height=48, point_size=psize, view=view, focal=1.0)
    want = jrender.render_points(pts, cols, **kw)
    got = trender.render_points(pts, cols, device="cpu", **kw)
    np.testing.assert_array_equal(got, want)


def test_colour_pass_picks_the_largest_index_among_the_nearest():
    """Two points at one spot: the later one's colour; a nearer point beats
    both; a point behind the camera is culled."""
    view = np.eye(4, dtype=np.float32)
    view[2, 3] = -5.0
    pts = np.float32([[0, 0, 0], [0, 0, 0], [1, 0, 0], [1, 0, 1], [1, 0, 0], [0, 0, 10]])
    cols = np.float32([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [0, 1, 1], [1, 0, 1]])
    for pkg in (jrender, trender):
        kw = {} if pkg is jrender else {"device": "cpu"}
        img = pkg.render_points(pts, cols, 40, 20, point_size=1, view=view, focal=1.0, **kw)
        assert img[10, 20].tolist() == [0, 255, 0]  # the second of two equal points
        assert img[10, 22].tolist() == [255, 255, 0]  # z = 1 is nearer than the two at z = 0
        assert (img == 255).all(-1).sum() == 40 * 20 - 2


@pytest.mark.parametrize("psize", [1, 2, 3])
def test_render_points_matches_jax(psize):
    pts, cols = _cloud(20000)
    want = jrender.render_points(pts, cols, 320, 200, point_size=psize)
    got = trender.render_points(pts, cols, 320, 200, point_size=psize, device="cpu")
    assert got.shape == want.shape and got.dtype == np.uint8
    assert (got == want).all(-1).mean() >= MIN_SAME_PIXELS
    # no colours: the z ramp; float colours as they are
    for c in (None, cols / 255.0):
        want = jrender.render_points(pts, c, 160, 100, point_size=psize)
        got = trender.render_points(pts, c, 160, 100, point_size=psize, device="cpu")
        assert (got == want).all(-1).mean() >= MIN_SAME_PIXELS


def test_camera_and_surfels_are_the_jax_arrays():
    pts, _ = _cloud()
    for d in ((0.35, -0.65, -1.0), (0, 0, -1), (0, -1, 0)):
        tv, tf = trender.auto_camera(pts, direction=d)
        jv, jf = jrender.auto_camera(pts, direction=d)
        np.testing.assert_array_equal(tv, jv)
        assert tf == jf
    v, f = _sphere()
    vc = np.random.RandomState(3).randint(0, 256, v.shape).astype(np.uint8)
    for colours in (None, vc):
        for got, want in zip(trender.sample_mesh_surfels(v, f, 50000, colours),
                             jrender.sample_mesh_surfels(v, f, 50000, colours)):
            np.testing.assert_array_equal(got, want)


def test_render_mesh_matches_jax():
    v, f = _sphere()
    want = jrender.render_mesh(v, f, width=160, height=120, budget=200000)
    got = trender.render_mesh(v, f, width=160, height=120, budget=200000, device="cpu")
    assert (got == want).all(-1).mean() >= MIN_SAME_PIXELS
    mask = (got != 255).any(-1)
    assert mask.mean() > 0.1 and got[mask].astype(np.float32).mean(1).std() > 10  # shaded


def test_render_offscreen_png_matches_jax(tmp_path):
    pts, cols = _cloud(6000)
    ply = str(tmp_path / "cloud.ply")
    tply.write_ply_points(ply, pts, cols)
    v, f = _sphere()
    obj = str(tmp_path / "mesh.obj")
    tply.write_obj_mesh(obj, v, f)
    for src in (ply, obj):
        want = cv2.imread(jrender.render_offscreen(src, str(tmp_path / "j.png"), 256, 144))
        out = trender.render_offscreen(src, width=256, height=144, device="cpu")
        assert out == os.path.splitext(src)[0] + "_render.png"
        got = imread(out)
        assert got.shape == want.shape == (144, 256, 3)
        assert (got == want).all(-1).mean() >= MIN_SAME_PIXELS
    jpg = trender.render_offscreen(ply, str(tmp_path / "r.jpg"), 64, 32, device="cpu")
    assert imread(jpg).shape == (32, 64, 3)
    blank = trender.render_points(np.zeros((0, 3), np.float32), width=8, height=4, device="cpu")
    np.testing.assert_array_equal(blank, jrender.render_points(np.zeros((0, 3)), width=8, height=4))


def test_html_viewers_are_byte_identical(tmp_path):
    rng = np.random.RandomState(4)
    pts = rng.rand(50000, 3).astype(np.float32)  # above the 40k cap: subsampled
    cols = rng.randint(0, 256, pts.shape).astype(np.uint8)
    v, f = _sphere(120, 200)  # above the 20k face cap
    cases = [("write_cloud_html", (pts, cols)), ("write_cloud_html", (pts[:500], None)),
             ("write_mesh_html", (v, f)), ("write_side_by_side_html", (pts[:300], cols[:300], v, f))]
    for i, (name, args) in enumerate(cases):
        a, b = str(tmp_path / f"t{i}.html"), str(tmp_path / f"j{i}.html")
        getattr(thtml, name)(*args, a)
        getattr(jhtml, name)(*args, b)
        assert open(a, "rb").read() == open(b, "rb").read()


def test_viewer_routes_match_jax(tmp_path):
    pts, cols = _cloud(300)
    ply = str(tmp_path / "cloud.ply")
    tply.write_ply_points(ply, pts, cols)
    v, f = _sphere(8, 12)
    obj = str(tmp_path / "mesh.obj")
    tply.write_obj_mesh(obj, v, f)
    jply.write_ply_mesh(str(tmp_path / "mesh2.ply"), v, f)
    for got, want in zip(tpv.load_point_cloud(ply), jpv.load_point_cloud(ply)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tpv.load_point_cloud(obj)[0], jpv.load_point_cloud(obj)[0])
    assert tpv.scan_and_describe(str(tmp_path)) == jpv.scan_and_describe(str(tmp_path))
    for fn, src in (("view_interactive", ply), ("view_mesh_interactive", obj)):
        a, b = str(tmp_path / "t.html"), str(tmp_path / "j.html")
        getattr(tpv, fn)(src, a)
        getattr(jpv, fn)(src, b)
        assert open(a, "rb").read() == open(b, "rb").read()
    tpv.view_side_by_side(ply, obj, str(tmp_path / "t.html"))
    jpv.view_side_by_side(ply, obj, str(tmp_path / "j.html"))
    assert open(tmp_path / "t.html", "rb").read() == open(tmp_path / "j.html", "rb").read()
    out = tpv.view_offscreen(ply, str(tmp_path / "o.png"), 96, 64, device="cpu")
    assert imread(out).shape == (64, 96, 3)
    png = tpv.view_matplotlib(ply)
    assert png.endswith("cloud_view.png") and cv2.imread(png) is not None
    png = tpv.view_mesh_matplotlib(obj)
    assert png.endswith("mesh_mesh_view.png") and cv2.imread(png) is not None


def test_render_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    pts, cols = _cloud(10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trender.render_points(pts, cols, 16, 16)
