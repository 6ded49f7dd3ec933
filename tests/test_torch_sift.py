"""Parity of the PyTorch port's SIFT path with the JAX package (CPU), including
kernel B's plain version against the JAX patch extractors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvm_tpu.config import FeatureConfig
from rtvm_tpu.ops import color as JC
from rtvm_tpu.ops.features import sift as JSF
from rtvm_tpu.ops.pallas_patches import extract_patches_pallas
from rtvm_tpu_torch.config import FeatureConfig as TFeatureConfig
from rtvm_tpu_torch.ops.features import sift as TSF
from rtvm_tpu_torch.ops.kernel_patches import (MAX_OCTAVES, extract_patches, extract_patches_octaves,
                                               extract_patches_octaves_plain, extract_patches_plain,
                                               tma_constraints)

torch.set_num_threads(1)  # tier 1 runs several test workers at once

POS_TOL_PX = 1e-3  # a keypoint counts as identical when its slot agrees to this
MIN_IDENTICAL = 0.98
DESC_TOL = 1e-4
# The JAX descriptor rounds the rotation-bin fraction to bfloat16, so a 1e-7
# float32 difference in the pyramid (another summation order) can move an
# identical keypoint's descriptor by one bf16 step of that fraction, ~2e-4.
# Such keypoints may be at most this share, and stay within DESC_TOL_STEP.
DESC_MAX_OVER = 0.02
DESC_TOL_STEP = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def test_octave_quotas_and_static_tables_are_the_jax_ones():
    assert TSF._octave_quotas(700, 4, 4.0) == JSF._octave_quotas(700, 4, 4.0) == [529, 131, 32, 8]
    jo, js = JSF._static_tables(12.0)
    to, ts = TSF._static_tables(12.0)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(ts, js)


def test_octave_levels_match_jax():
    base = np.random.RandomState(0).rand(90, 160).astype(np.float32)
    s = 3
    sig = np.array([1.6 * 2 ** (l / s) for l in range(s + 3)], np.float32)
    deltas = np.sqrt(np.maximum(sig**2 - sig[0] ** 2, 0.0))
    ref = np.asarray(JSF._octave_levels(jnp.asarray(base), deltas))
    out = TSF._octave_levels(_t(base)[None], deltas)[0].numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def _pallas_case():
    """The tests/test_pallas.py patch case: s=3, h=64, w=96, q=37."""
    rng = np.random.RandomState(3)
    s, h, w = 3, 64, 96
    g = rng.rand(s, h, w).astype(np.float32)
    q = 37
    xy = np.stack([rng.randint(0, w, q), rng.randint(0, h, q)], -1).astype(np.float32)
    lvl = rng.randint(1, s + 1, q).astype(np.int32)
    return g, xy, lvl


def test_patch_plain_version_is_byte_identical_to_jax_extractors():
    g, xy, lvl = _pallas_case()
    s, h, w = g.shape
    stack, ys_t, xs_t = TSF._level_patch_origins(_t(g)[None], _t(xy)[None], _t(lvl)[None])
    out = extract_patches_octaves([stack], [ys_t], [xs_t])[0].numpy()
    ref_xla = np.asarray(JSF._extract_level_patches(jnp.asarray(g), jnp.asarray(xy), jnp.asarray(lvl)))
    np.testing.assert_array_equal(out, ref_xla)
    half = JSF.PATCH // 2
    ys = np.clip(xy[:, 1].astype(np.int32) - half, 0, h - JSF.PATCH - 2) + (lvl - 1) * h
    xs = np.clip(xy[:, 0].astype(np.int32) - half, 0, w - JSF.PATCH)
    ref_pallas = np.asarray(extract_patches_pallas(
        jnp.asarray(g.reshape(s * h, w)), jnp.asarray(ys), jnp.asarray(xs), JSF.PATCH, interpret=True))
    np.testing.assert_array_equal(out, ref_pallas)
    direct = extract_patches_plain(_t(g.reshape(1, s * h, w)), _t(ys)[None], _t(xs)[None]).numpy()[0]
    np.testing.assert_array_equal(direct, ref_pallas)


def test_patch_wrapper_uses_plain_on_cpu_and_checks_its_inputs():
    g, xy, lvl = _pallas_case()
    s, h, w = g.shape
    stack = _t(g.reshape(1, s * h, w))
    ys = torch.randint(0, s * h - 32, (1, 5), dtype=torch.int32)
    xs = torch.randint(0, w - 32, (1, 5), dtype=torch.int32)
    assert torch.equal(extract_patches(stack, ys, xs), extract_patches_plain(stack, ys, xs))
    with pytest.raises(TypeError):
        extract_patches(stack.double(), ys, xs)
    with pytest.raises(TypeError):
        extract_patches(stack, ys.long(), xs)
    with pytest.raises(ValueError):
        extract_patches(stack[0], ys, xs)


def _octave_case(h, w, b=2, s=3, quotas=(21, 9, 5, 3), seed=11):
    """Per octave of an h x w frame: the levels 1..s stacked as a strided view
    of a [B, s+3, H_o, W_o] level tensor whose rows are a multiple of 4
    floats apart (as detect_pyramid passes them) and random in-range origins
    [B, Q_o]."""
    rng = np.random.RandomState(seed)
    stacks, ys, xs = [], [], []
    for o, q in enumerate(quotas):
        ho, wo = -(-h // 2**o), -(-w // 2**o)
        levels = torch.zeros(b, s + 3, ho, -(-wo // 4) * 4)[..., :wo]
        levels.copy_(_t(rng.rand(b, s + 3, ho, wo).astype(np.float32)))
        stacks.append(levels[:, 1 : s + 1].reshape(b, s * ho, wo))
        ys.append(_t(rng.randint(0, s * ho - 32 + 1, (b, q)).astype(np.int32)))
        xs.append(_t(rng.randint(0, wo - 32 + 1, (b, q)).astype(np.int32)))
    return stacks, ys, xs


@pytest.mark.parametrize("h,w", [(96, 256), (120, 320)])
def test_patch_octaves_plain_is_the_per_octave_cut_and_the_pallas_kernel(h, w):
    stacks, ys, xs = _octave_case(h, w)
    assert stacks[0].stride(0) != stacks[0].shape[1] * stacks[0].shape[2]  # a strided view
    out = extract_patches_octaves_plain(stacks, ys, xs).numpy()
    assert out.shape == (2, sum(y.shape[1] for y in ys), 32, 32)
    cat = torch.cat([extract_patches_plain(s, y, x) for s, y, x in zip(stacks, ys, xs)], 1).numpy()
    np.testing.assert_array_equal(out, cat)
    assert torch.equal(extract_patches_octaves(stacks, ys, xs), torch.from_numpy(out))  # CPU route
    col = 0
    for s, y, x in zip(stacks, ys, xs):
        q = y.shape[1]
        for bi in range(s.shape[0]):
            ref = np.asarray(extract_patches_pallas(
                jnp.asarray(s[bi].numpy()), jnp.asarray(y[bi].numpy()), jnp.asarray(x[bi].numpy()),
                32, interpret=True))
            np.testing.assert_array_equal(out[bi, col : col + q], ref)
        col += q


# frame sizes: the test's own, 360p, and the widths whose octaves are not
# all multiples of 4 floats (480p's 854, PAL's 720, 2.7K's 2704), at fewer rows
WIDTHS = [(96, 256), (96, 640), (288, 854), (288, 720), (288, 2704)]


@pytest.mark.parametrize("h,w", WIDTHS)
def test_tma_constraints_on_cpu_shapes(h, w):
    stacks, ys, xs = _octave_case(h, w)
    args = tma_constraints(stacks, ys, xs)  # the main path's layout passes
    assert args[3::8] == [s.shape[2] for s in stacks]  # the width, and beside it
    assert args[7::8] == [-(-s.shape[2] // 4) * 4 for s in stacks]  # the row pitch
    for s, y, x in zip(stacks, ys, xs):
        if s.shape[2] % 4:  # the same octave without the pitch
            with pytest.raises(ValueError, match="multiple of 4"):
                tma_constraints([s.contiguous()], [y], [x])
    dense = [(s.contiguous(), y, x) for s, y, x in zip(stacks, ys, xs) if s.shape[2] % 4 == 0]
    if dense:  # octaves of a 4-aligned width pass without the pitch as well
        tma_constraints(*(list(a) for a in zip(*dense)))
    stacks, ys, xs = _octave_case(96, 256)
    one = [s[:1] for s in stacks], [y[:1] for y in ys], [x[:1] for x in xs]
    tma_constraints(*one)
    narrow = torch.zeros(2, 96, 90)  # 90 floats a row: not a multiple of 16 bytes
    with pytest.raises(ValueError, match="multiple of 4"):
        tma_constraints([narrow], ys[:1], xs[:1])
    with pytest.raises(ValueError, match="at most"):
        tma_constraints(stacks * 3, ys * 3, xs * 3)
    assert len(stacks * 3) > MAX_OCTAVES
    with pytest.raises(ValueError, match="rows must be contiguous"):
        tma_constraints([stacks[0][:, :, ::2]], ys[:1], xs[:1])
    base = torch.zeros(2 * 96 * 64 + 1)
    with pytest.raises(ValueError, match="aligned"):
        tma_constraints([base[1:].reshape(2, 96, 64)], ys[:1], xs[:1])
    odd = torch.zeros(2, 96 * 64 + 2)[:, : 96 * 64].reshape(2, 96, 64)  # batch stride 6146 floats
    with pytest.raises(ValueError, match="batch stride"):
        tma_constraints([odd], ys[:1], xs[:1])
    with pytest.raises(ValueError, match="origins must be contiguous"):
        tma_constraints(stacks[:1], [ys[0].t().contiguous().t()], xs[:1])
    with pytest.raises(ValueError, match="32x32"):
        tma_constraints(stacks, ys, xs, patch=16)


@pytest.mark.parametrize("h,w", [(128, 256)] + WIDTHS[2:])
def test_detect_pyramid_feeds_one_patch_call_in_the_kernel_layout(h, w):
    gray = _t(np.random.RandomState(4).rand(2 if w < 2000 else 1, h, w).astype(np.float32) * 255)
    cfg = TFeatureConfig()
    xy, valid, stacks, ys, xs, _ = TSF.detect_pyramid(gray, cfg)
    assert len(stacks) == cfg.sift_octaves and xy.shape[1] == valid.shape[1] == cfg.max_keypoints
    assert [y.shape[1] for y in ys] == TSF._octave_quotas(cfg.max_keypoints, cfg.sift_octaves, 4.0)
    assert [s.shape[2] for s in stacks] == [-(-w // 2**o) for o in range(cfg.sift_octaves)]
    # every octave width, 4-aligned or not: the CUDA route takes these views
    # (the rows lie a multiple of 4 floats apart)
    args = tma_constraints(stacks, ys, xs)
    assert all(p % 4 == 0 and p - wo < 4 for p, wo in zip(args[7::8], args[3::8]))
    patches = extract_patches_octaves(stacks, ys, xs)
    np.testing.assert_array_equal(
        patches.numpy(),
        torch.cat([extract_patches_plain(s.contiguous(), y, x) for s, y, x in zip(stacks, ys, xs)],
                  1).numpy())


def test_orientation_and_descriptors_match_jax_on_the_same_patches():
    rng = np.random.RandomState(5)
    q = 200
    # smooth random patches: a few low-frequency cosines each
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32)
    patches = np.zeros((q, 32, 32), np.float32)
    for _ in range(4):
        fx, fy, ph = rng.uniform(0.05, 0.4, (3, q, 1, 1))
        patches += rng.rand(q, 1, 1).astype(np.float32) * np.cos(fx * xx + fy * yy + 6 * ph)
    valid = rng.rand(q) > 0.1
    sigma_desc = 6.0 * 2.0159
    jt, jd = jax.jit(lambda p, v: JSF._orientation_and_descriptors(p, v, sigma_desc))(
        jnp.asarray(patches), jnp.asarray(valid))
    tt, td = TSF._orientation_and_descriptors(_t(patches), _t(valid), sigma_desc)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=DESC_TOL)


@pytest.fixture(scope="module")
def sift_both(textured_image):
    gray = np.asarray(JC.bgr2gray(jnp.asarray(textured_image)))
    jfn = jax.jit(lambda g: JSF.detect_and_describe(g, FeatureConfig()))
    jxy, jd, jv = (np.asarray(a) for a in jfn(jnp.asarray(gray)))
    txy, td, tv = TSF.detect_and_describe(_t(gray)[None], TFeatureConfig())
    return (jxy, jd, jv), (txy[0].numpy(), td[0].numpy(), tv[0].numpy())


def test_detect_and_describe_keypoints_match_jax(sift_both):
    (jxy, jd, jv), (txy, td, tv) = sift_both
    assert jv.sum() > 200
    same = (np.abs(jxy - txy).max(axis=1) <= POS_TOL_PX) & (jv == tv)
    assert same.mean() >= MIN_IDENTICAL, same.mean()
    assert (same & jv).sum() >= MIN_IDENTICAL * jv.sum()


def test_detect_and_describe_descriptors_match_jax(sift_both):
    (jxy, jd, jv), (txy, td, tv) = sift_both
    same = (np.abs(jxy - txy).max(axis=1) <= POS_TOL_PX) & jv & tv
    err = np.abs(jd - td).max(axis=1)[same]
    assert (err > DESC_TOL).mean() <= DESC_MAX_OVER, np.sort(err)[-10:]
    assert err.max() <= DESC_TOL_STEP, err.max()
    # invalid slots carry zero descriptors and zero positions in both
    assert not np.any(td[~tv]) and not np.any(txy[~tv])


def _textured(h, w, seed):
    """conftest.textured_image's recipe at another size."""
    import cv2

    rng = np.random.RandomState(seed)
    img = cv2.GaussianBlur(rng.randint(0, 255, (h, w, 3)).astype(np.uint8), (0, 0), 1.2)
    for _ in range(40 * (h * w) // (320 * 440)):
        x, y = rng.randint(20, w - 20), rng.randint(20, h - 20)
        c = tuple(int(v) for v in rng.randint(0, 255, 3))
        if rng.rand() < 0.5:
            cv2.rectangle(img, (x, y), (x + rng.randint(8, 40), y + rng.randint(8, 40)), c, -1)
        else:
            cv2.circle(img, (x, y), rng.randint(4, 20), c, -1)
    return img


# The share of identical keypoints whose descriptor is more than DESC_TOL off
# (ROADMAP Queue 3 item 1: JAX's bf16 rounding of the rotation-bin fraction
# flips on a 1e-7 pyramid difference) varies from image to image: on the 8
# images below it was 0.0089-0.0267 of one image's keypoints, so one image
# can cross DESC_MAX_OVER; pooled it was 87 of 5292 (0.0164), and every one
# of them stays within DESC_TOL_STEP, a bf16 step of that fraction. The
# share of identical slots is pooled too: seed 5's is 0.9557, because
# keypoints of near-equal response swap neighbouring slots (the two sets of
# 655 positions differ in 10).
SIFT_854_SEEDS = range(8)


def test_detect_and_describe_at_480x854_matches_jax(monkeypatch):
    """480p's width 854 (octaves 854, 427, 214, 107) through the port's
    pitched levels, on 8 seeded images: the same output, bit for bit, as with
    contiguous levels, and held to JAX at the tolerances above, the share of
    descriptors over DESC_TOL pooled over the images."""
    grays = np.stack([np.asarray(JC.bgr2gray(jnp.asarray(_textured(480, 854, s))))
                      for s in SIFT_854_SEEDS])
    jfn = jax.jit(lambda g: JSF.detect_and_describe(g, FeatureConfig()))
    jxy, jd, jv = (np.stack(a) for a in zip(*[[np.asarray(x) for x in jfn(jnp.asarray(g))]
                                               for g in grays]))
    txy, td, tv = (a.numpy() for a in TSF.detect_and_describe(_t(grays), TFeatureConfig()))
    levels = TSF._octave_levels
    monkeypatch.setattr(TSF, "_octave_levels", lambda b, d: levels(b, d).contiguous())
    dense = [a.numpy() for a in TSF.detect_and_describe(_t(grays), TFeatureConfig())]
    for got, want in zip((txy, td, tv), dense):
        np.testing.assert_array_equal(got, want)
    assert jv.sum(axis=1).min() > 500
    same = (np.abs(jxy - txy).max(axis=-1) <= POS_TOL_PX) & (jv == tv)
    assert same.mean() >= MIN_IDENTICAL, same.mean(axis=1)
    held = same & jv & tv
    err_all = np.abs(jd - td).max(axis=-1)
    per_image = [float((e[k] > DESC_TOL).mean()) for e, k in zip(err_all, held)]
    err = err_all[held]
    assert (err > DESC_TOL).mean() <= DESC_MAX_OVER, (per_image, np.sort(err)[-10:])
    assert err.max() <= DESC_TOL_STEP, err.max()
