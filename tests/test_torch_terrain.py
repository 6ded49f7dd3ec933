"""The port's terrain and soil analysis (slam/terrain.py) against the JAX
package on tests/test_terrain.py's synthetic soil images (CPU), and the
terrain command."""

import cv2
import numpy as np
import pytest
import torch

from rtvm_tpu.slam import terrain as jterrain
from rtvm_tpu_torch import cli
from rtvm_tpu_torch.depth3d import estimator as testimator
from rtvm_tpu_torch.io.imread import imread
from rtvm_tpu_torch.io.jpeg import imwrite_jpg
from rtvm_tpu_torch.slam import terrain as tterrain

torch.set_num_threads(1)  # tier 1 runs several test workers at once

REL_TOL = 1e-4


def _soil_image(bgr, noise=8, size=(200, 260)):
    """tests/test_terrain.py's _soil_image."""
    rng = np.random.RandomState(0)
    img = np.full(size + (3,), bgr, np.float32)
    img += rng.randn(*size, 3) * noise
    return np.clip(img, 0, 255).astype(np.uint8)


def _vegetated():
    img = _soil_image((40, 60, 90))
    img[:, :130] = (40, 160, 50)
    return img


KINDS = {
    "dark": lambda: _soil_image((20, 30, 45)),
    "sand": lambda: _soil_image((150, 175, 195)),
    "vegetation": _vegetated,
    "dry": lambda: _soil_image((110, 150, 180)),
    "wet": lambda: _soil_image((25, 35, 50)),
    "loam": lambda: _soil_image((60, 90, 120)),
}


def _close(a, b, path=""):
    """Every string and list equal, every number within REL_TOL relative."""
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(b, str):
        assert a == b, path
    else:
        assert abs(a - b) <= REL_TOL * max(1.0, abs(b)), (path, a, b)


@pytest.fixture(scope="module")
def analyzers():
    return jterrain.TerrainSoilAnalyzer(), tterrain.TerrainSoilAnalyzer(device="cpu")


@pytest.mark.parametrize("kind", list(KINDS))
def test_analysis_and_report_match_jax(analyzers, kind):
    ja, ta = analyzers
    img = KINDS[kind]()
    j, t = ja.analyze_image(img), ta.analyze_image(img)
    _close(t, j)
    assert ta.report(t) == ja.report(j)


def test_the_tables_are_the_jax_tables():
    assert tterrain.SOIL_TYPES == jterrain.SOIL_TYPES
    assert set(tterrain.STAT_NAMES) == set(jterrain._image_stats(_soil_image((1, 2, 3))))


def _text_rows(result, h, size_pad=6):
    """bool [h]: the rows the panel's text may ink (each line's top to its
    size plus a margin for descenders and the shadow)."""
    rows = np.zeros(h, bool)
    for _, _, size, y in tterrain.TerrainSoilAnalyzer.panel_lines(result):
        rows[max(y - 2, 0) : min(y + size + size_pad, h)] = True
    return rows


@pytest.mark.parametrize("kind", ["vegetation", "loam"])
def test_visualize_matches_jax_outside_the_text(analyzers, kind):
    """The JAX panel writes with PIL's DejaVuSans, the port with its bitmap
    font (ROADMAP.md Queue 3): outside the text rows they are equal."""
    ja, ta = analyzers
    img = KINDS[kind]()
    j_res, t_res = ja.analyze_image(img), ta.analyze_image(img)
    jv, tv = ja.visualize(img, j_res), ta.visualize(img, t_res)
    h, w = img.shape[:2]
    assert tv.shape == jv.shape == (h, w + 360, 3)
    keep = ~_text_rows(t_res, h)
    np.testing.assert_array_equal(tv[:, :w], jv[:, :w])
    np.testing.assert_array_equal(tv[keep], jv[keep])
    # text was drawn on the panel (the recommendations start below a
    # 200-row image, as in JAX's panel)
    panel = tv[:, w:]
    assert (panel == (220, 220, 220)).all(-1).sum() > 500


def test_every_cyrillic_letter_has_a_glyph():
    from rtvm_tpu_torch.utils import draw

    alphabet = "АБВГДЕЁЖЗИЙКЛМНОПРСТУФХЦЧШЩЪЫЬЭЮЯ"
    for ch in alphabet + alphabet.lower():
        assert ch in draw._FONT, ch
    text = " ".join(l for l, *_ in tterrain.TerrainSoilAnalyzer.panel_lines(
        tterrain.TerrainSoilAnalyzer(device="cpu").analyze_image(_vegetated())))
    assert all(c in draw._FONT for c in text if c != " "), set(text) - set(draw._FONT)


def test_terrain_command(tmp_path, monkeypatch, analyzers):
    img = KINDS["loam"]()
    src = tmp_path / "soil.png"
    cv2.imwrite(str(src), img)
    monkeypatch.setattr(tterrain.TerrainSoilAnalyzer, "__init__",
                        lambda self, device=None: setattr(self, "device", torch.device("cpu")))
    out = tmp_path / "out.jpg"
    res = cli.main(["terrain", str(src), "--output", str(out)])
    _close(res, analyzers[0].analyze_image(img))
    vis = imread(str(out))
    assert vis is not None and vis.shape == (200, 260 + 360, 3)
    # --reconstruct-3d writes the depth PNG, the cloud, the mesh and the
    # panels into the working directory (DepthNet on the CPU here)
    monkeypatch.chdir(tmp_path)
    resolve = testimator.resolve_device
    monkeypatch.setattr(testimator, "resolve_device", lambda d=None: resolve(d or "cpu"))
    cli.main(["terrain", str(src), "--output", str(out), "--reconstruct-3d", "--fast"])
    for name in ("soil_depth.png", "soil_pointcloud.ply", "soil_mesh.obj", "soil_panels.png"):
        assert (tmp_path / name).exists(), name
    assert imread(str(tmp_path / "soil_depth.png")).shape == (200, 260, 3)
    # a .png picture is written as PNG, losslessly
    res = cli.main(["terrain", str(src), "--output", str(tmp_path / "x.png")])
    want = tterrain.TerrainSoilAnalyzer(device="cpu").visualize(img, res)
    np.testing.assert_array_equal(imread(str(tmp_path / "x.png")), want)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "x.png")), want)
    with pytest.raises(ValueError, match="PNG and JPEG"):
        cli.main(["terrain", str(src), "--output", str(tmp_path / "x.bmp")])
    with pytest.raises(SystemExit):
        cli.main(["terrain", str(tmp_path / "missing.jpg"), "--output", str(out)])
    imwrite_jpg(str(tmp_path / "soil.jpg"), img)
    assert cli.main(["terrain", str(tmp_path / "soil.jpg"), "--output", str(out)])["soil_type"]
