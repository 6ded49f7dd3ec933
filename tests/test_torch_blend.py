"""Kernel E (csrc/blend.cu), the paint's blend-weight blur: the wrapper's CPU
route (the plain version, and the body it had before the kernel), the plain
version against a float64 stencil with the band matrix's folded edge
weights, the kernel's weight table against band_matrix's entries, its walk
over strips, segments and a ring of row-pass rows transcribed to NumPy in
float64, the wrapper's refusals; and, with a card, the kernel itself against
the plain version, bands of rows against the whole map, strided inputs
against their contiguous copies."""

import numpy as np
import pytest
import torch

from rtvm_tpu_torch import kernels
from rtvm_tpu_torch.ops import filters as TF
from rtvm_tpu_torch.ops import warp as TW

torch.set_num_threads(1)  # tier 1 runs several test workers at once

R = TW.BLEND_SMOOTH_RADIUS
# kernel E's geometry (csrc/blend.cu): strip columns, row-pass rows a step,
# ring rows, output rows a block at most
TILE_W, STEP, RING, SEG = 128, 32, 64, 256

# [..., R, W] shapes with R and W under, at and over the 31 taps
SHAPES = [(3, 20, 17), (2, 45, 70), (1, 31, 31), (2, 1, 40), (2, 40, 1), (1, 2, 2), (4, 33, 90),
          (1, 1, 1), (70, 29), (2, 3, 16, 33)]


def _maps(shape, seed):
    """(w_new, w_old) float32: distances with zeros, as the paint's weights."""
    rng = np.random.RandomState(seed)
    w_new = np.maximum(rng.rand(*shape).astype(np.float32) * 40 - 10, 0)
    w_old = np.maximum(rng.rand(*shape).astype(np.float32) * 40 - 20, 0)
    return torch.from_numpy(w_new), torch.from_numpy(w_old)


def _old_body(w_new, w_old):
    """blend_weights_smoothed as it was before kernel E."""
    s = w_new + w_old + 1e-6
    alpha = w_new / s
    region = ((w_new > 0.0) | (w_old > 0.0)).to(torch.float32)
    alpha_s = TF.gaussian_blur(alpha, TW.BLEND_SMOOTH_SIGMA, TW.BLEND_SMOOTH_RADIUS)
    beta_s = TF.gaussian_blur(region, TW.BLEND_SMOOTH_SIGMA, TW.BLEND_SMOOTH_RADIUS) - alpha_s
    return alpha_s, beta_s


def weight(tab, i, j, n):
    """rtvm_blur_weight (csrc/blend.cu): source j's weight for output i of a
    line of n."""
    if n == 1:
        return tab[4 * R + 1]
    if j == 0 and i < R:
        return tab[2 * R + 1 + i]
    if j == n - 1 and n - 1 - i < R:
        return tab[3 * R + 1 + (n - 1 - i)]
    return tab[j - i + R]


def band_of_table(n):
    """[n, n] float32: the table's weight at every (i, j) that kernel E reads."""
    tab = TW.blur_table()
    out = np.zeros((n, n), np.float32)
    for i in range(n):
        for j in range(max(0, i - R), min(n - 1, i + R) + 1):
            out[i, j] = weight(tab, i, j, n)
    return out


def _alpha_region(w_new, w_old):
    """alpha and region as float32 arrays, by the plain version's operations."""
    w_new, w_old = np.asarray(w_new), np.asarray(w_old)
    alpha = w_new / ((w_new + w_old) + np.float32(1e-6))
    return alpha, ((w_new > 0) | (w_old > 0)).astype(np.float32)


def stencil64(w_new, w_old):
    """The blend weights in float64: each pass a product with the table's
    band (the folded edge weights), rows then columns."""
    alpha, region = (x.astype(np.float64) for x in _alpha_region(w_new, w_old))
    rows, cols = alpha.shape[-2:]
    br, bc = band_of_table(rows).astype(np.float64), band_of_table(cols).astype(np.float64)

    def blur(x):
        return br @ (x @ bc.T)

    a = blur(alpha)
    return a, blur(region) - a


def kernel_walk64(w_new, w_old):
    """Kernel E's walk in float64 for [n, rows, cols] maps: per (map, row
    segment, column strip) block, steps of STEP row-pass rows (the first
    shorter, so that later steps' outputs come in whole groups of 8) into a
    ring of RING rows, each step followed by the column pass of the output
    rows whose sources the ring holds; the input columns c0 - 16 .. c0 + 143
    of a step.
    Every output is read from the ring slots and input columns the kernel
    reads, so a wrong slot, halo or segment edge shows as a wrong value."""
    alpha, region = (x.astype(np.float64) for x in _alpha_region(w_new, w_old))
    tab = TW.blur_table().astype(np.float64)
    n, rows, cols = alpha.shape
    parts = -(-rows // SEG)
    seg = (-(-rows // parts) + 7) // 8 * 8
    nseg = -(-rows // seg)
    out_a = np.full(alpha.shape, np.nan)
    out_b = np.full(alpha.shape, np.nan)
    for b in range(n):
        for sg in range(nseg):
            y0, y1 = sg * seg, min(rows, sg * seg + seg)
            g_lo, g_hi = max(0, y0 - R), min(rows, y1 + R)
            for c0 in range(0, cols, TILE_W):
                ring = np.full((2, RING, TILE_W), np.nan)
                p, e = g_lo, y0
                pc = min(STEP - 8 + (y0 + R - g_lo) % 8, g_hi - p)
                while e < y1:
                    inp = np.zeros((2, pc, 160))
                    for x in range(160):
                        gx = c0 - 16 + x
                        if 0 <= gx < cols:
                            inp[0, :, x] = alpha[b, p : p + pc, gx]
                            inp[1, :, x] = region[b, p : p + pc, gx]
                    slots = [(p + y) % RING for y in range(pc)]
                    for lc in range(TILE_W):
                        col = c0 + lc
                        acc = np.zeros((2, pc))
                        if col < cols:
                            for j in range(max(0, col - R), min(cols - 1, col + R) + 1):
                                acc += weight(tab, col, j, cols) * inp[:, :, j - c0 + 16]
                        ring[:, slots, lc] = acc
                    p += pc
                    e2 = y1 if p >= g_hi else min(y1, p - R)
                    for i in range(e, e2):
                        acc = np.zeros((2, TILE_W))
                        for j in range(max(0, i - R), min(rows - 1, i + R) + 1):
                            acc += weight(tab, i, j, rows) * ring[:, j % RING]
                        w = min(TILE_W, cols - c0)
                        out_a[b, i, c0 : c0 + w] = acc[0, :w]
                        out_b[b, i, c0 : c0 + w] = acc[1, :w] - acc[0, :w]
                    e = e2
                    pc = min(STEP, g_hi - p)
    return out_a, out_b


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_wrapper_on_the_cpu_is_the_plain_version_and_the_old_body(shape):
    w_new, w_old = _maps(shape, len(shape) + shape[-1])
    kernels.reset_launches()
    got = TW.blend_weights_smoothed(w_new, w_old)
    assert kernels.launches["blend"] == 0
    for want in (TW.blend_weights_smoothed_plain(w_new, w_old), _old_body(w_new, w_old)):
        for g, w in zip(got, want):
            assert g.shape == w_new.shape and torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_version_is_within_1e_6_of_a_float64_stencil(shape):
    w_new, w_old = _maps(shape, 7 * shape[-2] + shape[-1])
    got = TW.blend_weights_smoothed_plain(w_new, w_old)
    want = stencil64(w_new.numpy(), w_old.numpy())
    for g, w in zip(got, want):
        assert np.abs(g.numpy().astype(np.float64) - w).max() <= 1e-6
    assert float(got[0].max()) > 0.0 and float(got[1].max()) > 0.0  # the maps do blend


@pytest.mark.parametrize("n", [1, 2, 3, 14, 15, 16, 29, 30, 31, 32, 33, 46, 100])
def test_weight_table_is_band_matrix_s_nonzero_entries(n):
    taps = TF.gaussian_kernel1d(TW.BLEND_SMOOTH_SIGMA, R)
    mine = band_of_table(n)
    assert np.array_equal(TF.band_matrix(taps, n).view(np.int32), mine.view(np.int32))
    key = tuple(float(t) for t in taps)
    assert np.array_equal(TF._band_tensor(key, n, torch.device("cpu")).numpy().view(np.int32),
                          mine.view(np.int32))


def test_weight_table_folds_each_edge_in_tap_order():
    tab = TW.blur_table()
    taps = TF.gaussian_kernel1d(TW.BLEND_SMOOTH_SIGMA, R)
    assert tab.dtype == np.float32 and tab.shape == (4 * R + 2,) and not tab.flags.writeable
    assert np.array_equal(tab[: 2 * R + 1], taps)
    # the taps are symmetric, but the two edges sum them in opposite orders
    assert not np.array_equal(tab[2 * R + 1 : 3 * R + 1], tab[3 * R + 1 : 4 * R + 1])
    assert np.allclose(tab[2 * R + 1 : 3 * R + 1], tab[3 * R + 1 : 4 * R + 1], rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", [(1, 300, 300), (2, 530, 140), (1, 600, 40), (3, 40, 131),
                                   (1, 47, 5), (2, 257, 1)], ids=str)
def test_kernel_walk_is_the_float64_stencil(shape):
    w_new, w_old = (x.numpy() for x in _maps(shape, shape[1] + 3 * shape[2]))
    got = kernel_walk64(w_new, w_old)
    want = stencil64(w_new, w_old)
    for g, w in zip(got, want):
        assert not np.isnan(g).any()
        assert np.abs(g - w).max() <= 1e-12


def test_wrapper_refuses_what_the_kernel_does_not_take():
    w_new, w_old = _maps((2, 9, 11), 0)
    with pytest.raises(TypeError):
        TW.blend_weights_smoothed(w_new.double(), w_old)
    with pytest.raises(TypeError):
        TW.blend_weights_smoothed(w_new, w_old.half())
    with pytest.raises(ValueError, match="meta"):
        TW.blend_weights_smoothed(w_new, w_old.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        TW.blend_weights_smoothed(w_new.to("meta"), w_old.to("meta"))
    for a, b in ((w_new[:, :0], w_old[:, :0]), (w_new[..., :0], w_old[..., :0]),
                 (w_new, w_old[:, :8]), (w_new[0, 0], w_old[0, 0])):
        with pytest.raises(ValueError, match="one shape"):
            TW.blend_weights_smoothed(a, b)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel E runs only there")
    return torch.device("cuda")


CARD_SHAPES = {"live": (720, 768, 360, 640), "fused": (2216, 2432, 1080, 1920)}
GAP = 1e-6  # the kernel against the plain version on the card, largest |d|


def paint_weights(hc, wc, hf, wf, dev, seed):
    """(w_new, w_old) [16, hc, wc] as the paint makes them: the analytic
    frame weights of an orbit window, and of the window before it."""
    import chip_smoke

    out = []
    for s in (seed, seed + 1):
        H = chip_smoke.weight_window(torch, 16, hc, wc, hf, wf, seed=s).to(dev)
        out.append(TW.frame_weight_eval(TW.frame_weight_params(H, hf, wf, hc, wc), hc, wc))
    return out


def _gap(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.card
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_kernel_is_within_1e_6_of_the_plain_version_on_a_window(card, shape):
    hc, wc, hf, wf = CARD_SHAPES[shape]
    w_new, w_old = paint_weights(hc, wc, hf, wf, card, len(shape))
    kernels.reset_launches()
    got = TW.blend_weights_smoothed(w_new, w_old)
    assert kernels.launches["blend"] == 1
    want = TW.blend_weights_smoothed_plain(w_new, w_old)
    assert _gap(got, want) <= GAP
    assert float(got[0].max()) > 0.9  # the window does blend


@pytest.mark.card
@pytest.mark.parametrize("shape", SHAPES + [(2, 300, 769), (1, 530, 258), (3, 257, 129)], ids=str)
def test_kernel_is_within_1e_6_of_the_plain_version_at_any_size(card, shape):
    w_new, w_old = (x.to(card) for x in _maps(shape, shape[-1]))
    got = TW.blend_weights_smoothed(w_new, w_old)
    assert _gap(got, TW.blend_weights_smoothed_plain(w_new, w_old)) <= GAP
    want = stencil64(w_new.cpu().numpy(), w_old.cpu().numpy())
    assert max(float(np.abs(g.cpu().numpy() - w).max()) for g, w in zip(got, want)) <= GAP


@pytest.mark.card
@pytest.mark.parametrize("l,h", [(0, 40), (0, 300), (17, 300), (200, 720), (333, 700), (600, 720),
                                 (100, 131)])
def test_a_band_of_rows_is_the_whole_map_s_rows(card, l, h):
    w_new, w_old = paint_weights(720, 768, 360, 640, card, 5)
    whole = TW.blend_weights_smoothed(w_new, w_old)
    band = TW.blend_weights_smoothed(w_new[:, l:h], w_old[:, l:h])  # strided: no copy
    a = R if l > 0 else 0
    b = h - l - R if h < 720 else h - l
    for x, y in zip(band, whole):
        assert _same_bits(x[:, a:b], y[:, l + a : l + b])


@pytest.mark.card
def test_a_strided_input_is_its_contiguous_copy(card):
    w_new, w_old = (x.to(card) for x in _maps((4, 300, 521), 11))
    for sl in ((slice(None), slice(13, 290)), (slice(None), slice(None), slice(3, 516)),
               (slice(1, 4, 2), slice(None), slice(8, 520)), (1, slice(None), slice(None))):
        a, b = w_new[sl], w_old[sl]
        got = TW.blend_weights_smoothed(a, b)
        want = TW.blend_weights_smoothed(a.contiguous(), b.contiguous())
        for g, w in zip(got, want):
            assert g.is_contiguous() and _same_bits(g, w), sl


@pytest.mark.card
def test_kernel_wrapper_raises_on_a_column_stride(card):
    w_new, w_old = (x.to(card) for x in _maps((2, 40, 50), 2))
    with pytest.raises(ValueError, match="column stride"):
        TW.blend_weights_smoothed(w_new.transpose(1, 2), w_old.transpose(1, 2))
    with pytest.raises(TypeError):
        TW.blend_weights_smoothed(w_new.double(), w_old.double())
