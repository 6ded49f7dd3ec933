"""Kernel C (csrc/union.cu), the paint's coarse union distance: its algorithm
transcribed to NumPy, held bit for bit against the plain version
(ops/warp.py:coarse_union_distance_plain) on the CPU; the wrapper's routes;
and, with a card, the kernel itself against the plain version."""

import numpy as np
import pytest
import torch

from rtvm_tpu_torch import kernels
from rtvm_tpu_torch.ops import warp as TW

torch.set_num_threads(1)  # tier 1 runs several test workers at once

A, B = np.float32(TW.CHAMFER_A), np.float32(TW.CHAMFER_B)

# name: (shape [N, Gh, Gw], occupied share, cell_px)
CASES = {
    "live_p50": ((16, 180, 192), 0.5, 4.0),
    "live_p90": ((16, 180, 192), 0.9, 4.0),
    "live_p99": ((16, 180, 192), 0.99, 4.0),
    "fused_p50": ((1, 554, 608), 0.5, 4.0),
    "fused_p90": ((1, 554, 608), 0.9, 4.0),
    "fused_p99": ((1, 554, 608), 0.99, 4.0),
    "all_empty": ((3, 7, 5), 0.0, 4.0),
    "all_full": ((2, 9, 13), 1.0, 4.0),
    "all_full_row": ((1, 1, 37), 1.0, 1.0),
    "one_row": ((2, 1, 37), 0.8, 4.0),
    "one_column": ((2, 41, 1), 0.8, 1.0),
    "tall": ((3, 23, 9), 0.7, 1.0),
    "wide": ((3, 9, 23), 0.7, 4.0),
    "odd_3x1": ((4, 3, 1), 0.5, 4.0),
    "odd_4x9": ((2, 4, 9), 0.6, 1.0),
    "odd_5x6": ((2, 5, 6), 0.9, 4.0),
    "unit": ((1, 1, 1), 1.0, 4.0),
}


def _grid(name: str) -> tuple:
    shape, share, cell_px = CASES[name]
    rng = np.random.RandomState(sorted(CASES).index(name))
    return rng.rand(*shape) < share, cell_px


def union_rows_np(occ: np.ndarray) -> np.ndarray:
    """Kernel C's row pass: per row, the distance in cells to the nearest
    empty cell, cells outside the row empty, capped at 4 * max(Gh, Gw): a
    sweep left to right for the last empty index at or before x (-1 outside),
    one right to left for the first at or after it (Gw outside)."""
    n, gh, gw = occ.shape
    big = np.float32(4 * max(gh, gw))
    f = np.empty(occ.shape, np.float32)
    e = np.full((n, gh), -1)
    for x in range(gw):
        e = np.where(occ[:, :, x], e, x)
        f[:, :, x] = x - e
    e = np.full((n, gh), gw)
    for x in range(gw - 1, -1, -1):
        e = np.where(occ[:, :, x], e, x)
        f[:, :, x] = np.minimum(np.minimum(f[:, :, x], (e - x).astype(np.float32)), big)
    return f


def union_cols_np(f: np.ndarray, cell_px: float) -> np.ndarray:
    """Kernel C's column pass: out[n, y, x] = cell_px * min over v of
    A * (max - min) + B * min of f[n, v, x] and |y - v|, each operation
    rounded to float32 on its own (no fused multiply-add)."""
    n, gh, gw = f.shape
    v = np.arange(gh, dtype=np.float32)
    out = np.empty_like(f)
    for y in range(gh):
        dy = np.abs(np.float32(y) - v)[None, :, None]
        hi, lo = np.maximum(f, dy), np.minimum(f, dy)
        out[:, y] = (A * (hi - lo) + B * lo).min(axis=1) * np.float32(cell_px)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_transcription_equals_plain_bitwise(name):
    occ, cell_px = _grid(name)
    want = TW.coarse_union_distance_plain(torch.from_numpy(occ), cell_px).numpy()
    got = union_cols_np(union_rows_np(occ), cell_px)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_row_pass_is_the_exact_row_distance():
    """The row pass against the definition: min |x - e| over the empty cells e
    of the row and the outside cells -1 and Gw."""
    occ, _ = _grid("tall")
    n, gh, gw = occ.shape
    f = union_rows_np(occ)
    for i in range(n):
        for v in range(gh):
            empties = [-1, gw] + [x for x in range(gw) if not occ[i, v, x]]
            want = [min(abs(x - e) for e in empties) for x in range(gw)]
            np.testing.assert_array_equal(f[i, v], np.float32(want))


@pytest.mark.parametrize("lead", [(), (4,), (2, 3)])
def test_wrapper_on_the_cpu_is_the_plain_version(lead):
    rng = np.random.RandomState(len(lead))
    occ = torch.from_numpy(rng.rand(*lead, 11, 14) < 0.8)
    kernels.reset_launches()
    got = TW.coarse_union_distance(occ)
    assert kernels.launches["union"] == 0
    assert got.shape == occ.shape and got.dtype == torch.float32
    assert torch.equal(got, TW.coarse_union_distance_plain(occ))
    assert torch.equal(TW.coarse_union_distance(occ.to(torch.uint8) * 7),
                       TW.coarse_union_distance_plain(occ))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    occ = torch.ones((4, 6), dtype=torch.bool)
    with pytest.raises(TypeError):
        TW.coarse_union_distance(occ.float())
    with pytest.raises(ValueError):
        TW.coarse_union_distance(occ[0])
    with pytest.raises(ValueError):
        TW.coarse_union_distance(occ.t())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel C runs only there")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CASES) + ["grown"])
def test_kernel_equals_plain_bitwise(card, name):
    if name == "grown":  # more rows than a shared-memory tile of kernel C holds
        occ, cell_px = np.random.RandomState(99).rand(2, 300, 70) < 0.97, 4.0
    else:
        occ, cell_px = _grid(name)
    want = TW.coarse_union_distance_plain(torch.from_numpy(occ), cell_px)
    kernels.reset_launches()
    got = TW.coarse_union_distance(torch.from_numpy(occ).to(card), cell_px)
    assert kernels.launches["union"] == 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.card
def test_kernel_wrapper_raises_on_float_or_strided_input(card):
    occ = torch.ones((2, 8, 8), dtype=torch.bool, device=card)
    with pytest.raises(TypeError):
        TW.coarse_union_distance(occ.float())
    with pytest.raises(ValueError):
        TW.coarse_union_distance(occ.transpose(1, 2))
