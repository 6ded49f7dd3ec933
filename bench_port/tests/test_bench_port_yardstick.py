"""The yardstick against published and recorded numbers: YOLOv8's GFLOPs as
Ultralytics publishes them, and the least times of kernels A and B that
PERF.md's kernel table gives (0.0449 ms and 0.0218 ms a 360p window)."""

import numpy as np
import pytest
import torch

from bench_port.lib import traffic, yardstick
from bench_port.reference import yolo

V8N = dict(depth_multiple=0.33, width_multiple=0.25, max_channels=1024, nc=80, reg_max=16)
V8L = dict(depth_multiple=1.0, width_multiple=1.0, max_channels=512, nc=80, reg_max=16)


@pytest.mark.parametrize("cfg,gflops", [(V8N, 8.7), (V8L, 165.2)])
def test_flops_match_ultralytics(cfg, gflops):
    got = yolo.flops(cfg, (640, 640)) / 1e9
    assert abs(got - gflops) / gflops < 0.02


def test_flops_scale_with_the_input():
    a = yolo.flops(dict(V8L, nc=8), (640, 640))
    b = yolo.flops(dict(V8L, nc=8), (768, 1280))
    assert b / a == pytest.approx(768 * 1280 / 640**2, rel=1e-9)


def test_warp_bound_is_perf_tables():
    ms, by = yardstick.bound(*yardstick.warp_work(16, (360, 640), 720, 768))
    assert by == "bytes" and round(ms, 4) == 0.0449


def test_patches_bound_is_perf_tables():
    """Window 1 of the clip that PERF.md's kernel B row was timed on (a
    steady (2, -4) px drift over make_world, seed 0): its SIFT origins give
    the table's 0.0218 ms."""
    from rtvm_tpu_torch.config import FeatureConfig
    from rtvm_tpu_torch.ops import color
    from rtvm_tpu_torch.ops.features.sift import detect_pyramid

    n, h, w = 1 + 16 * 3, 360, 640
    i = np.arange(n)
    xs, ys = 2 * i, -4 * i
    path = np.stack([xs - xs.min(), ys - ys.min()], -1)
    world = traffic.make_world(np.random.RandomState(0), h + int(path[:, 1].max()) + 8,
                               w + int(path[:, 0].max()) + 8)
    frames = np.stack([world[y : y + h, x : x + w] for x, y in path])
    win = torch.as_tensor(frames[1:17])
    _, _, stacks, ys_, xs_, _ = detect_pyramid(color.bgr2gray(win), FeatureConfig())
    nbytes = yardstick.patches_bytes([tuple(s.shape) for s in stacks], ys_, xs_)
    ms, _ = yardstick.bound(nbytes, 0)
    assert round(ms, 4) == 0.0218
