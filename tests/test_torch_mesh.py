"""The port's multi-device step (``rtvm_tpu_torch/parallel/mesh.py``) on the
CPU: 4 ranks spawned under gloo on a (2, 2) mesh, against the same steps in
one process and against the JAX package's one-device step.

The ranks are spawned once per module (``ranks4``) for every sharded case;
each rank runs with one thread."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvm_tpu.config import FeatureConfig, MosaicConfig
from rtvm_tpu.mosaic import stitcher as JS
from rtvm_tpu.parallel import mesh as JM
from rtvm_tpu_torch import entry
from rtvm_tpu_torch.config import FeatureConfig as TFeatureConfig
from rtvm_tpu_torch.config import MosaicConfig as TMosaicConfig
from rtvm_tpu_torch.parallel import mesh as M

torch.set_num_threads(1)  # tier 1 runs several test workers at once

N = 4  # ranks: a (2, 2) mesh
# The sharded canvas against the one-process canvas, in grey levels. The
# band's vertical weight blur is a banded product over fewer rows than the
# full canvas's, so its sums may round differently; measured 0 on these
# inputs.
CANVAS_TOL = 1e-4
# tests/test_multichip.py's bounds for the sharded JAX step against JAX's
# one-device step, here for the port's sharded step against JAX's step.
JAX_MEAN, JAX_MAX = 0.5, 2.0
H_ABS_TOL = 1e-3  # the port against JAX (tests/test_torch_stitcher.py)
EDGE_BAND = 3 + 16 + 15  # ROADMAP Queue 3 items 2 and 9: JAX's two-pass edge, spread
# dp detection against one process, JAX's own bounds (tests/test_multichip.py)
SCORE_TOL, BOX_RTOL, BOX_ATOL = 2e-4, 2e-3, 2e-2
# The dp training step against one process. The loss sums the same terms in
# another order. Adam's first step moves each weight by about lr * sign(g),
# so a gradient within rounding of 0 may take the other sign on one side:
# such weights part by up to 2 * lr (measured: 298 of 3,022,792 values more
# than 1e-5 apart, at most 1.81e-3; BatchNorm's statistics within 1.2e-7).
LR = 1e-3
LOSS_RTOL = 1e-6
PARAM_MAX = 2 * LR + 1e-6
PARAM_SHARE = 1e-3  # of the values more than 1e-5 apart
STATS_TOL = 1e-6


def _tiny_mosaic(rng, h=64, w=128, b=8):
    """tests/test_multichip.py:_tiny_mosaic (inputs and the JAX config)."""
    cfg = MosaicConfig(
        window_size=b,
        output_height_times=2.0,
        output_width_times=1.25,
        features=FeatureConfig(detector_type="orb", max_keypoints=64, border_margin=8),
    )
    first = rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
    base = rng.randint(0, 255, (h + b, w + b, 3), dtype=np.uint8)
    frames = np.stack([base[i : i + h, i : i + w] for i in range(b)])
    return cfg, base[0:h, 0:w].copy(), frames


def _port_cfg(**kw):
    return TMosaicConfig(features=TFeatureConfig(detector_type="orb", max_keypoints=64,
                                                 border_margin=8), **kw)


def _jax_uniforms(jm, b):
    """The RANSAC draws the JAX window step makes for its next b pairs."""
    cfg = jm.config
    f0 = int(np.asarray(jm.state.frame_idx))
    keys = [jax.random.fold_in(jm._key, f0 + i) for i in range(b)]
    shape = (cfg.ransac.num_hypotheses, cfg.features.max_keypoints)
    return np.stack([np.asarray(jax.random.uniform(k, shape)) for k in keys])


@pytest.fixture(scope="module")
def jax_tiny():
    """JAX's one-device window step on _tiny_mosaic's inputs, and the port's
    case that starts from JAX's state with JAX's draws."""
    cfg, first, frames = _tiny_mosaic(np.random.RandomState(7))
    h, w, _ = first.shape
    jm = JS.VideMosaic(first, detector_type="orb", config=cfg)
    snap = jm.checkpoint()
    uniforms = _jax_uniforms(jm, frames.shape[0])
    step_py = JS.make_window_step((h, w, 3), cfg).__wrapped__
    state, aux = jax.jit(step_py)(jm.state, jnp.asarray(frames), jm._key, jm._fweight,
                                  jm._wtable)
    case = {"first": first, "windows": frames[None], "detector": "orb", "snap": snap,
            "uniforms": uniforms[None],
            "cfg": _port_cfg(window_size=8, output_height_times=2.0, output_width_times=1.25)}
    return case, np.asarray(state.canvas, np.float32), np.asarray(aux.ok), np.asarray(aux.H_abs)


def _away_from_frame_edges(H_abs, hf, wf, hc, wc, band=EDGE_BAND):
    """tests/test_torch_stitcher.py's mask: pixels farther than `band` from
    every edge of every frame's warped rectangle and from the canvas's right
    edge."""
    ys, xs = np.mgrid[0:hc, 0:wc]
    keep = xs < wc - band
    for H in np.asarray(H_abs, np.float64):
        c = H @ np.array([[0, wf - 1, wf - 1, 0], [0, 0, hf - 1, hf - 1], [1, 1, 1, 1]], np.float64)
        x0, x1 = (c[0] / c[2]).min(), (c[0] / c[2]).max()
        y0, y1 = (c[1] / c[2]).min(), (c[1] / c[2]).max()
        in_x = (xs > x0 - band) & (xs < x1 + band)
        in_y = (ys > y0 - band) & (ys < y1 + band)
        near = ((np.abs(xs - x0) <= band) | (np.abs(xs - x1) <= band)) & in_y
        near |= ((np.abs(ys - y0) <= band) | (np.abs(ys - y1) <= band)) & in_x
        keep &= ~near
    return keep


def _tall_case():
    """The same frames onto a 320-row canvas with frame 0 across the band
    edge (row 160), so that each rank warps about 210 of the 320 rows."""
    _, first, frames = _tiny_mosaic(np.random.RandomState(7))
    return {"first": first, "windows": frames[None], "detector": "orb",
            "cfg": _port_cfg(window_size=8, canvas_hw=(320, 160), seed_offset=(128, 16))}


@pytest.fixture(scope="module")
def ranks4(jax_tiny):
    """One spawn of 4 ranks: the window cases (the tall one on the (2, 2)
    mesh and on (1, 4), where every rank fits the whole window and only the
    paint is sharded), dp detection, the dp training step; and each case in
    one process."""
    cases = {"tiny": jax_tiny[0], "tall": _tall_case(), "tall_tp4": dict(_tall_case(), tp=4),
             "detect": M.detection_case(2), "train": M.train_case(N)}
    jobs = {"tiny": M.window_job, "tall": M.window_job, "tall_tp4": M.window_job,
            "detect": M.detection_job, "train": M.train_job}
    res = M.run_ranks(N, [(jobs[k], c) for k, c in cases.items()], device="cpu")
    return cases, dict(zip(cases, res["jobs"])), res


def test_mesh_shape_is_jax_factoring():
    # JAX's make_mesh over conftest's 8 virtual CPU devices for n <= 8
    for n in range(1, 9):
        assert M.mesh_shape(n) == JM.make_mesh(n).devices.shape, n
    want = {9: (9, 1), 10: (5, 2), 11: (11, 1), 12: (6, 2), 13: (13, 1), 14: (7, 2),
            15: (15, 1), 16: (4, 4)}
    for n, shape in want.items():
        assert M.mesh_shape(n) == shape, n
    assert M.mesh_shape(8, tp=4) == (2, 4)
    with pytest.raises(ValueError):
        M.mesh_shape(8, dp=3)


class _StubMesh:
    def __init__(self, dp, coord):
        self._dp, self._coord = dp, coord

    def size(self, dim):
        return self._dp if dim == 0 else 1

    def get_coordinate(self):
        return [self._coord, 0]


def test_shard_batch_takes_the_dp_slice():
    x = torch.arange(24).reshape(8, 3)
    parts = [M.shard_batch(_StubMesh(4, r), x) for r in range(4)]
    assert torch.equal(torch.cat(parts), x)
    assert parts[2].tolist() == x[4:6].tolist()
    assert torch.equal(M.shard_batch(_StubMesh(3, 1), torch.arange(6)[None].repeat(2, 1),
                                     axis=1), torch.tensor([[2, 3], [2, 3]]))
    with pytest.raises(ValueError):
        M.shard_batch(_StubMesh(3, 0), x)


def test_canvas_bands_and_their_halos():
    for hc, tp in ((128, 2), (720, 2), (720, 4), (1080, 4), (321, 2), (130, 4)):
        bands = M.canvas_bands(hc, tp)
        assert bands[0][0] == 0 and bands[-1][1] == hc
        assert all(b0[1] == b1[0] for b0, b1 in zip(bands, bands[1:]))
        assert all(a % 4 == 0 for a, _ in bands)
        for a, b in bands:
            (l, h), (lo, hi) = M.paint_rows((a, b), hc)
            assert lo % 2 == 0 and lo <= l <= a < b <= h <= hi
            assert a - lo <= 48 and hi - b <= 50  # the halo: about 50 rows each side
            assert l == max(0, a - 15) and h == min(hc, b + 15)
    with pytest.raises(ValueError):
        M.canvas_bands(64, 8)


@pytest.mark.parametrize("name", ["tiny", "tall", "tall_tp4"])
def test_sharded_window_step_equals_one_process(ranks4, name):
    cases, out, _ = ranks4
    got = out[name][0]
    want = M.single_window_run(cases[name], device="cpu")
    for k in ("ok", "blended", "H_abs", "num_inliers", "num_matches", "H_old",
              "hbuf", "kp", "desc", "kp_valid", "union_coarse"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["frame_idx"] == want["frame_idx"] == 9 and got["hcount"] == want["hcount"]
    assert got["ok"].sum() >= 6  # the window stitches
    assert np.abs(got["canvas"] - want["canvas"]).max() <= CANVAS_TOL


def test_sharded_window_step_matches_jax(ranks4, jax_tiny):
    _, jcanvas, jok, jH = jax_tiny
    got = ranks4[1]["tiny"][0]
    np.testing.assert_array_equal(got["ok"][0], jok)
    assert np.abs(got["H_abs"][0] - jH).max() <= H_ABS_TOL
    keep = _away_from_frame_edges(jH, 64, 128, *jcanvas.shape[1:])
    assert keep.mean() > 0.15  # 0.185 of the canvas on these frames
    d = np.abs(got["canvas"] - jcanvas)[:, keep]
    assert d.mean() < JAX_MEAN and d.max() <= JAX_MAX, (d.mean(), d.max())


def test_each_rank_holds_its_band_and_halo(ranks4):
    for name, (dp, tp) in (("tiny", (2, 2)), ("tall", (2, 2)), ("tall_tp4", (1, 4))):
        ranks = ranks4[1][name]
        hc, wc = ranks[0]["canvas"].shape[1:]
        for r, res in enumerate(ranks):
            assert res["mesh"] == (dp, tp) and res["coord"] == (r // tp, r % tp)
            a, b = res["band"]
            assert (a, b) == M.canvas_bands(hc, tp)[r % tp]
            assert res["canvas_band"] == (3, b - a, wc)
            assert res["union_band"][0] == -(-b // 4) - a // 4
            (l, h), (lo, hi) = res["rows"]
            assert a - lo <= 48 and hi - b <= 50
            assert res["frames_local"][0] == 8 // dp
            # plain versions on the CPU
            assert not any(res["launches"].values()), res["launches"]
        if name.startswith("tall"):
            assert max(hi - lo for (_, _), (lo, hi) in (r["rows"] for r in ranks)) <= 0.7 * hc


def test_dp_detection_equals_one_process(ranks4):
    cases, out, _ = ranks4
    got = out["detect"][0]
    want = M.single_detection_run(cases["detect"], device="cpu")
    assert [r["batch_local"] for r in out["detect"]] == [1, 1, 1, 1]
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=SCORE_TOL, atol=SCORE_TOL)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=BOX_RTOL, atol=BOX_ATOL)
    assert want["valid"].sum() > 0


def test_dp_train_step_equals_one_process(ranks4):
    cases, out, _ = ranks4
    got = out["train"][0]
    want = M.single_train_run(cases["train"], device="cpu")
    assert [r["batch_local"] for r in out["train"]] == [1, 1, 1, 1]
    assert all(r["step"] == 1 for r in out["train"])
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    assert abs(got["num_pos"] - want["num_pos"]) <= 1e-6 * want["num_pos"]
    total = off = 0
    for k, v in want["state_dict"].items():
        d = np.abs(got["state_dict"][k] - v)
        if k.endswith((".mean", ".var")):
            assert d.max() <= STATS_TOL, k
            continue
        assert d.max() <= PARAM_MAX, (k, d.max())
        total, off = total + d.size, off + int((d > 1e-5).sum())
    assert off <= PARAM_SHARE * total, off


def test_dryrun_multichip_entry_on_the_cpu(capsys):
    out = entry.dryrun_multichip(N, device="cpu", production=False)
    text = capsys.readouterr().out
    for line in ("backend gloo", "dryrun_multichip ok: mesh=(2, 2)", "yolo train dryrun ok",
                 "dp detection dryrun ok"):
        assert line in text, line
    assert "production dryrun ok" not in text
    assert out["backend"] == "gloo" and set(out["cases"]) == {"window", "train", "detect"}
    w = out["window"][0]
    assert w["canvas"].shape == (3, 128, 160) and w["frame_idx"] == 3
    assert np.isfinite(out["train"][0]["loss"])


def test_a_failing_or_hung_rank_fails_the_call():
    bad = M.train_case(N)
    bad["images"] = bad["images"][:3]  # 3 images do not split over 2 ranks: each raises
    with pytest.raises(RuntimeError, match="failed"):
        M.run_ranks(2, [(M.train_job, bad)], device="cpu")
    t = time.perf_counter()
    with pytest.raises(TimeoutError):  # the ranks cannot even start in a second
        M.run_ranks(2, [(M.train_job, M.train_case(2))], device="cpu", timeout=1.0)
    assert time.perf_counter() - t < 30
