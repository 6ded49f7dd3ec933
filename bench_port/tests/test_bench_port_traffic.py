"""The orbit: the same for a seed, inside the canvas, closed on itself."""

import json
from pathlib import Path

import numpy as np
import pytest

from bench_port.lib import traffic
from bench_port.reference import chain

ROOT = Path(__file__).resolve().parents[2]
MIX = json.loads((ROOT / "bench_port/traffic/live.json").read_text())
CFG = json.loads((ROOT / "bench_port/configs/sift360-yolov8n.json").read_text())


def orbit_of(seed, hw=(360, 640)):
    return traffic.make_orbit(seed, hw, dict(MIX, window_size=16))


def test_same_seed_same_frames_other_seed_same_path():
    a, b, c = orbit_of(2**31 + 77), orbit_of(2**31 + 77), orbit_of(12)
    assert np.array_equal(a["frames"], b["frames"])
    assert not np.array_equal(a["frames"], c["frames"])
    assert np.array_equal(a["offsets"], c["offsets"])


def test_frames_are_exact_crops_at_even_offsets():
    o = orbit_of(5)
    world, off = o["world"], o["offsets"]
    x0, y0 = 8 - off[:, 0].min(), 8 - off[:, 1].min()
    for k in (0, 37, 150):
        dx, dy = off[k]
        assert np.array_equal(o["frames"][k], world[y0 + dy : y0 + dy + 360, x0 + dx : x0 + dx + 640])
    assert np.all(off % 2 == 0) and tuple(off[0]) == (0, 0)


def test_the_orbit_closes_on_itself():
    off = orbit_of(5)["offsets"]
    assert len(off) % 16 == 0
    steps = np.diff(np.concatenate([off, off[:1]]), axis=0)  # the last step returns to frame 0
    assert np.abs(steps).max() <= 6 and 2.0 <= np.hypot(*steps.T).mean() <= 6.0


@pytest.mark.parametrize("periods", [1, 3])
def test_the_orbit_stays_inside_the_default_canvas(periods):
    """Frame 0 at the bottom centre of the 2.0 x 1.2 canvas; every frame of
    the truth chain, with the smoothing's lag, stays on the canvas."""
    off = orbit_of(5)["offsets"]
    st = CFG["stitch"]["stabilization"]
    H, ok, _ = chain.truth_chain(off, periods * len(off), (64, 360), st)
    assert ok.all() and chain.outside(H, (360, 640), (720, 768)) == 0.0
