"""Kernel D (csrc/weight.cu), the paint's analytic frame weight: its order of
operations transcribed to PyTorch on the CPU (per-segment constants hoisted
and compacted, per grid point the min over the valid segments, tiles with a
halo row and column, the upsample in global coordinates), held bit for bit
against the plain version (ops/warp.py:frame_weight_eval_plain) on the CPU;
the wrapper's routes and refusals; and, with a card, the kernel itself
against the plain version run on the card."""

import numpy as np
import pytest
import torch

from rtvm_tpu_torch import kernels
from rtvm_tpu_torch.ops import warp as TW

torch.set_num_threads(1)  # tier 1 runs several test workers at once

TH, TW_ = 64, 128  # kernel D's tile of canvas rows and columns (csrc/weight.cu)
HF, WF = 60, 96  # frame size of the quads below

_T = np.array  # shorthand for the homographies


def _rot(deg, tx, ty, s=1.0):
    a = np.deg2rad(deg)
    return _T([[s * np.cos(a), -s * np.sin(a), tx], [s * np.sin(a), s * np.cos(a), ty], [0, 0, 1]])


# name: H (frame -> canvas) for a 150 x 300 canvas
QUADS = {
    "translate_inside": _T([[1, 0, 80.0], [0, 1, 40.0], [0, 0, 1]]),
    "translate_clipped": _T([[1, 0, 250.0], [0, 1, -20.0], [0, 0, 1]]),
    "translate_fraction": _T([[1, 0, 33.37], [0, 1, 51.81], [0, 0, 1]]),
    "edge_on_canvas_side": _T([[1, 0, 1.5], [0, 1, 1.5], [0, 0, 1]]),  # inflated quad on x=0, y=0
    "rotate30": _rot(30.0, 140.0, 20.0),
    "rotate90": _rot(90.0, 180.0, 30.0),
    "mirror": _T([[-1, 0, 200.0], [0, 1, 30.0], [0, 0, 1]]),
    "rot2_persp": _T([[0.99, -0.035, 90.0], [0.035, 0.99, 35.0], [2e-4, -1.5e-4, 1]]),
    "strong_persp": _T([[1.1, 0.2, 60.0], [-0.1, 0.9, 30.0], [2.5e-3, 1.8e-3, 1]]),
    "horizon": _T([[1, 0, 50.0], [0, 1, 20.0], [-1.0 / WF + 1e-6, 0, 1]]),  # corners near w=0
    "off_canvas": _T([[1, 0, 1000.0], [0, 1, 900.0], [0, 0, 1]]),
    "covers_canvas": _rot(5.0, -100.0, -80.0, 4.0),
    "tiny": _T([[1e-6, 0, 75.0], [0, 1e-6, 60.0], [0, 0, 1]]),  # segments near zero length
    "behind_camera": -np.eye(3),  # ok_orient false
    "one_corner_behind": _T([[1, 0, 50.0], [0, 1, 20.0], [-0.02, 0, 1]]),
    "nan": np.full((3, 3), np.nan),
}


def _params(names, hc=150, wc=300, dev="cpu"):
    H = torch.from_numpy(np.stack([QUADS[n] for n in names]).astype(np.float32)).to(dev)
    return TW.frame_weight_params(H, HF, WF, hc, wc)


def segment_constants(segs, seg_ok):
    """Kernel D's per-segment table of one frame: the valid segments'
    (x0, y0, ex, ey, safe_l2, nx, ny, clamped h_oct, l2 > 1e-12), compacted,
    in the plain version's order of operations, computed on the params'
    device (there a division by a Python scalar follows that device's rule)
    and returned on the CPU."""
    keep = seg_ok.nonzero()[:, 0]
    x0, y0, x1, y1 = (segs[i, keep] for i in range(4))
    ex, ey = x1 - x0, y1 - y0
    l2 = ex * ex + ey * ey
    sl2 = torch.clamp(l2, min=1e-12)
    inv_len = torch.rsqrt(sl2)
    nx, ny = ey * inv_len, -ex * inv_len
    anx, any_ = nx.abs(), ny.abs()
    h_oct = torch.maximum(torch.maximum(anx, any_) / TW.CHAMFER_A, (anx + any_) / TW.CHAMFER_B)
    table = [x0, y0, ex, ey, sl2, nx, ny, torch.clamp(h_oct, min=1e-12), l2 > 1e-12]
    return [x.cpu() for x in table]


def grid_tile(table, planes, ks, js, cap):
    """Signed grid values [len(ks), len(js)] at the global grid indices ks
    (rows) and js (columns): the min over the table's segments, one at a
    time (NaN sticks, as in torch.amin), the cap where not finite, the sign
    of the low-resolution inside test."""
    py = (ks * 2).to(torch.float32)[:, None]
    px = (js * 2).to(torch.float32)[None, :]
    m = torch.full((len(ks), len(js)), float("inf"))
    for x0, y0, ex, ey, sl2, nx, ny, hcl, l2ok in zip(*table):
        dx, dy = px - x0, py - y0
        t = (dx * ex + dy * ey) / sl2
        tc = torch.clamp(t, 0.0, 1.0)
        ax, ay = (px - (x0 + tc * ex)).abs(), (py - (y0 + tc * ey)).abs()
        big, sml = torch.maximum(ax, ay), torch.minimum(ax, ay)
        d_end = TW.CHAMFER_A * (big - sml) + TW.CHAMFER_B * sml
        d_abs = (nx * dx + ny * dy).abs()
        in_seg = (t > 0.0) & (t < 1.0) & l2ok
        one = torch.ones_like(d_end)
        m = torch.minimum(m, torch.where(in_seg, d_abs, d_end) / torch.where(in_seg, hcl, one))
    d = torch.where(torch.isfinite(m), m, torch.full_like(m, cap))
    inside = torch.ones_like(d, dtype=torch.bool)
    for h in range(4):
        inside &= -(planes[0, h] * (px - planes[2, h]) + planes[1, h] * (py - planes[3, h])) > 0.0
    return torch.where(inside, d, -d)


def frame_weight_transcribed(params, hc, wc, row0=0, rows=None):
    """Kernel D's algorithm, tile by tile: [B, rows, wc] on the CPU. The
    per-segment table comes from the params' device; every other operation
    is exactly rounded, so the CPU computes it as the card would."""
    rows = hc - row0 if rows is None else rows
    table_of = [segment_constants(s, k) for s, k in zip(params[0], params[1])]
    segs, seg_ok, planes, ok_orient = (x.cpu() for x in params)
    gh, gw = -(-hc // 2), -(-wc // 2)
    cap = float(np.float32(4.0 * (hc + wc)))
    out = torch.zeros((segs.shape[0], rows, wc))
    for b in range(segs.shape[0]):
        if not bool(ok_orient[b]):
            continue
        table, pl = table_of[b], planes[b]
        for tr0 in range(0, rows, TH):
            for c0 in range(0, wc, TW_):
                kt0, jt0 = (row0 + tr0) // 2, c0 // 2
                ks = torch.clamp(torch.arange(kt0, kt0 + TH // 2 + 1), max=gh - 1)
                js = torch.clamp(torch.arange(jt0, jt0 + TW_ // 2 + 1), max=gw - 1)
                lo = grid_tile(table, pl, ks, js, cap)
                r = torch.empty((TH, lo.shape[1]))  # rows first: odd rows average the next
                r[0::2] = lo[:-1]
                r[1::2] = 0.5 * (lo[:-1] + lo[1:])
                v = torch.empty((TH, TW_))  # then columns
                v[:, 0::2] = r[:, :-1]
                v[:, 1::2] = 0.5 * (r[:, :-1] + r[:, 1:])
                ys = torch.arange(row0 + tr0, row0 + tr0 + TH, dtype=torch.float32)[:, None]
                xs = torch.arange(c0, c0 + TW_, dtype=torch.float32)[None, :]
                inside = torch.ones((TH, TW_), dtype=torch.bool)
                for h in range(4):
                    xa = pl[0, h] * (xs - pl[2, h])
                    yb = pl[1, h] * (ys - pl[3, h])
                    inside &= -(xa + yb) > 0.0
                tile = torch.where(inside, torch.clamp(v, min=0.0), torch.zeros_like(v))
                nr, nc = min(TH, rows - tr0), min(TW_, wc - c0)
                out[b, tr0 : tr0 + nr, c0 : c0 + nc] = tile[:nr, :nc]
    return out


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


CANVASES = [(150, 300), (151, 299), (64, 128), (130, 257)]


@pytest.mark.parametrize("name", sorted(QUADS))
def test_transcription_equals_plain_bitwise(name):
    for hc, wc in CANVASES:
        params = _params([name], hc, wc)
        want = TW.frame_weight_eval_plain(params, hc, wc)
        got = frame_weight_transcribed(params, hc, wc)
        assert _same_bits(got, want), (name, hc, wc)


def test_transcription_equals_plain_on_a_window_of_16():
    names = sorted(QUADS)[:16]
    params = _params(names)
    want = TW.frame_weight_eval_plain(params, 150, 300)
    assert _same_bits(frame_weight_transcribed(params, 150, 300), want)
    assert (want > 0).float().mean() > 0.05  # the quads do cover the canvas


@pytest.mark.parametrize("row0,rows", [(0, 1), (0, 64), (2, 65), (36, 50), (64, 37), (98, 52),
                                       (148, 2), (148, 3), (150, 1)])
def test_transcribed_bands_are_the_whole_map_s_rows(row0, rows):
    names = ["rot2_persp", "rotate30", "translate_clipped", "covers_canvas"]
    hc, wc = 151, 299
    params = _params(names, hc, wc)
    whole = TW.frame_weight_eval_plain(params, hc, wc)
    band = frame_weight_transcribed(params, hc, wc, row0=row0, rows=rows)
    assert _same_bits(band, whole[:, row0 : row0 + rows])
    assert _same_bits(TW.frame_weight_eval_plain(params, hc, wc, row0=row0, rows=rows), band)


def _scalar_quotients(dev):
    x = torch.from_numpy(np.random.RandomState(3).rand(100000).astype(np.float32)).to(dev)
    inv = float(np.float32(1.0) / np.float32(TW.CHAMFER_A))
    return (x / TW.CHAMFER_A).cpu(), (x * inv).cpu()


def test_a_scalar_s_reciprocal_is_not_the_quotient():
    """The CPU divides a tensor by a Python scalar; a product with the
    float32 reciprocal differs from it in the last bit on some inputs, so
    kernel D has to follow the rule of the device it matches."""
    q, r = _scalar_quotients("cpu")
    assert not torch.equal(q, r) and torch.allclose(q, r, rtol=2e-7, atol=0.0)


@pytest.mark.parametrize("row0,rows", [(0, None), (0, 150), (36, 50), (148, 2)])
def test_wrapper_on_the_cpu_is_the_plain_version(row0, rows):
    params = _params(["rot2_persp", "rotate30", "behind_camera"])
    kernels.reset_launches()
    got = TW.frame_weight_eval(params, 150, 300, row0=row0, rows=rows)
    assert kernels.launches["weight"] == 0
    assert _same_bits(got, TW.frame_weight_eval_plain(params, 150, 300, row0=row0, rows=rows))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    params = _params(["rot2_persp", "rotate30"])
    segs, seg_ok, planes, ok = params
    with pytest.raises(ValueError, match="not even"):
        TW.frame_weight_eval(params, 150, 300, row0=3, rows=8)
    with pytest.raises(TypeError):
        TW.frame_weight_eval((segs.double(), seg_ok, planes, ok), 150, 300)
    with pytest.raises(TypeError):
        TW.frame_weight_eval((segs, seg_ok, planes.double(), ok), 150, 300)
    with pytest.raises(TypeError):
        TW.frame_weight_eval((segs, seg_ok.to(torch.uint8), planes, ok), 150, 300)
    with pytest.raises(ValueError, match="contiguous"):
        TW.frame_weight_eval((segs.transpose(0, 2).contiguous().transpose(0, 2), seg_ok, planes, ok),
                             150, 300)
    with pytest.raises(ValueError, match="contiguous"):
        TW.frame_weight_eval((segs, seg_ok, planes.transpose(1, 2), ok), 150, 300)
    with pytest.raises(ValueError, match="shapes"):
        TW.frame_weight_eval((segs[:, :3].contiguous(), seg_ok, planes, ok), 150, 300)
    with pytest.raises(ValueError, match="rows"):
        TW.frame_weight_eval(params, 150, 300, row0=140, rows=12)
    with pytest.raises(ValueError, match="no kernel"):
        TW.frame_weight_eval(tuple(x.to("meta") for x in params), 150, 300)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel D runs only there")
    return torch.device("cuda")


CARD_SHAPES = {"live": (720, 768, 360, 640), "fused": (2216, 2432, 1080, 1920)}


@pytest.mark.card
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_kernel_equals_plain_bitwise_on_a_window(card, shape):
    import chip_smoke

    hc, wc, hf, wf = CARD_SHAPES[shape]
    H = chip_smoke.weight_window(torch, 16, hc, wc, hf, wf, seed=len(shape)).to(card)
    params = TW.frame_weight_params(H, hf, wf, hc, wc)
    kernels.reset_launches()
    got = TW.frame_weight_eval(params, hc, wc)
    assert kernels.launches["weight"] == 1
    want = TW.frame_weight_eval_plain(params, hc, wc)
    assert _same_bits(got, want)
    for row0, rows in ((0, 1), (2, 63), (hc // 2, 65), (hc - 2, 2), (hc - 130, 130)):
        band = TW.frame_weight_eval(params, hc, wc, row0=row0, rows=rows)
        assert _same_bits(band, want[:, row0 : row0 + rows]), (row0, rows)


@pytest.mark.card
@pytest.mark.parametrize("hc,wc", CANVASES)
def test_kernel_equals_plain_bitwise_on_every_quad(card, hc, wc):
    params = _params(sorted(QUADS), hc, wc, dev=card)
    want = TW.frame_weight_eval_plain(params, hc, wc)
    assert _same_bits(TW.frame_weight_eval(params, hc, wc), want)
    for row0, rows in ((0, 1), (36, min(50, hc - 36)), (hc - 2 - hc % 2, 2)):
        assert _same_bits(TW.frame_weight_eval(params, hc, wc, row0=row0, rows=rows),
                          want[:, row0 : row0 + rows]), (row0, rows)


@pytest.mark.card
def test_the_card_divides_by_a_scalar_through_its_reciprocal(card):
    q, r = _scalar_quotients(card)
    assert torch.equal(q, r)


@pytest.mark.card
def test_transcription_equals_the_card_s_plain_version_bitwise(card):
    params = _params(sorted(QUADS), dev=card)
    want = TW.frame_weight_eval_plain(params, 150, 300).cpu()
    assert _same_bits(frame_weight_transcribed(params, 150, 300), want)


@pytest.mark.card
def test_kernel_wrapper_raises_on_float64_or_strided_params(card):
    segs, seg_ok, planes, ok = _params(["rotate30"], dev=card)
    with pytest.raises(TypeError):
        TW.frame_weight_eval((segs.double(), seg_ok, planes, ok), 150, 300)
    with pytest.raises(ValueError):
        TW.frame_weight_eval((segs, seg_ok, planes.transpose(1, 2), ok), 150, 300)
