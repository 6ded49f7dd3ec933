"""The PyTorch port's ORB features against the JAX package (both on the CPU):
FAST-9, the rBRIEF tables, patches, descriptors, Hamming distances and the
cross-check, on the same numpy inputs."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvm_tpu.ops import match as JM
from rtvm_tpu.ops.features import fast as JFAST
from rtvm_tpu.ops.features import orb as JORB
from rtvm_tpu.ops.filters import gaussian_blur as jax_blur
from rtvm_tpu_torch.ops import match as TM
from rtvm_tpu_torch.ops.features import fast as TFAST
from rtvm_tpu_torch.ops.features import orb as TORB

torch.set_num_threads(1)  # tier 1 runs several test workers at once

# The FAST score, keypoint slots, tables, patches, descriptors from the same
# smoothed image, Hamming distances and matches are held exactly.
ANGLE_TOL = 1e-6  # radians: atan2 of the same exact moments in two libraries
# End to end from the float gray image, the uint8 smoothing can differ by one
# level: in flat regions the float32 blur lands a few ulp under the integer in
# one package and on it in the other, and the cast truncates. Measured on
# textured_image: 1250 of 1400 valid descriptors identical (89.29%); the other
# 150 differ in 1 bit (median) to 43. Every differing descriptor must come from
# such a smoothed-patch difference.
MIN_IDENTICAL_END_TO_END = 0.89


def _t(a):
    return torch.from_numpy(np.array(a))


def _gray(img_bgr):
    return cv2.cvtColor(img_bgr, cv2.COLOR_BGR2GRAY).astype(np.float32)


@pytest.fixture(scope="module")
def grays(textured_image):
    """textured_image and a copy shifted 5 px right, as one [2, H, W] batch."""
    g = _gray(textured_image)
    return np.stack([g, np.roll(g, 5, axis=1)])


@pytest.fixture(scope="module")
def jax_keypoints(grays):
    return jax.vmap(lambda g: JFAST.detect_fast(g, 700))(jnp.asarray(grays))


# ------------------------------------------------------------------ FAST


@pytest.mark.parametrize("threshold,arc", [(20.0, 9), (12.0, 12)])
def test_fast_score_map_matches_jax_exactly(grays, threshold, arc):
    rnd = np.random.RandomState(0).randint(0, 256, (1,) + grays.shape[1:]).astype(np.float32)
    x = np.concatenate([grays, rnd])
    ref = np.asarray(jax.vmap(lambda g: JFAST.fast_score_map(g, threshold, arc))(jnp.asarray(x)))
    out = TFAST.fast_score_map(_t(x), threshold, arc).numpy()
    assert (ref > 0).mean() > 0.01
    np.testing.assert_array_equal(out, ref)


def test_detect_fast_same_slots_as_jax(grays, jax_keypoints):
    tk = TFAST.detect_fast(_t(grays), 700)
    assert int(np.asarray(jax_keypoints.valid).sum()) == 2 * 700
    np.testing.assert_array_equal(tk.xy.numpy(), np.asarray(jax_keypoints.xy))
    np.testing.assert_array_equal(tk.valid.numpy(), np.asarray(jax_keypoints.valid))
    np.testing.assert_array_equal(tk.score.numpy(), np.asarray(jax_keypoints.score))


def test_detect_fast_few_corners_leaves_invalid_slots_zero():
    g = np.zeros((64, 96), np.float32)
    g[30:34, 40:44] = 200.0  # one bright square: a handful of corners
    ref = JFAST.detect_fast(jnp.asarray(g), 32)
    tk = TFAST.detect_fast(_t(g[None]), 32)
    np.testing.assert_array_equal(tk.xy[0].numpy(), np.asarray(ref.xy))
    np.testing.assert_array_equal(tk.valid[0].numpy(), np.asarray(ref.valid))
    assert 0 < int(tk.valid.sum()) < 32
    assert not tk.xy[0][~tk.valid[0]].any()


# ------------------------------------------------------------------ rBRIEF tables, patches


def test_brief_pattern_and_tables_equal_jax():
    np.testing.assert_array_equal(TORB.brief_pattern(256, 13), JORB.brief_pattern(256, 13))
    for a, b in zip(TORB._rotated_index_tables(256, 13), JORB._rotated_index_tables(256, 13)):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    for a, b in zip(TORB._moment_masks(15), JORB._moment_masks(15)):
        np.testing.assert_array_equal(a, b)


def test_extract_patches_byte_identical_incl_bottom_and_right_edges():
    """tests/test_features.py's edge cases on a uint8 stack, against the JAX
    extractor and a direct numpy crop."""
    rng = np.random.RandomState(3)
    h, w, patch = 64, 200, TORB.PATCH
    imgs = rng.randint(0, 255, (2, h, w)).astype(np.uint8)
    half = patch // 2
    xy = np.array(
        [[half, half], [w - half - 1, h - half - 1], [50, h - 1], [60, h - 2],
         [70, h - half], [80, half - 3], [90, 33], [w - 1, 40], [w - 2, h - 1], [0, 0]],
        np.float32,
    )
    xys = np.stack([xy, xy[::-1]])
    ref = np.asarray(JORB.extract_patches_batch(jnp.asarray(imgs), jnp.asarray(xys)))
    out = TORB.extract_patches_batch(_t(imgs), _t(xys)).numpy()
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, ref)
    for b in range(2):
        for k, (x, y) in enumerate(xys[b]):
            y0 = int(np.clip(int(y) - half, 0, h - patch))
            x0 = int(np.clip(int(x) - half, 0, w - patch))
            np.testing.assert_array_equal(out[b, k], imgs[b, y0 : y0 + patch, x0 : x0 + patch])


# ------------------------------------------------------------------ descriptors


def _jax_smooth(grays):
    return np.asarray(jax.vmap(
        lambda g: jnp.clip(jax_blur(g, 2.0), 0, 255).astype(jnp.uint8))(jnp.asarray(grays)))


@pytest.fixture(scope="module")
def jax_descriptors(grays, jax_keypoints):
    return JORB.describe_orb_batch(jnp.asarray(grays), jax_keypoints.xy, jax_keypoints.valid)


def test_descriptors_identical_on_the_same_smoothed_image(grays, jax_keypoints, jax_descriptors):
    smooth = _jax_smooth(grays)
    xy, valid = _t(jax_keypoints.xy), _t(jax_keypoints.valid)
    td = TORB.describe_smoothed(_t(smooth), xy, valid)
    ref_bits = np.asarray(jax_descriptors.bits)
    assert ref_bits.dtype == np.uint32 and td.bits.dtype == torch.int32
    assert td.bits.shape == (2, 700, 8)
    np.testing.assert_array_equal(td.bits.numpy(), ref_bits.view(np.int32))
    np.testing.assert_allclose(td.angle.numpy(), np.asarray(jax_descriptors.angle), rtol=0,
                               atol=ANGLE_TOL)
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jax_descriptors.valid))


def test_descriptors_end_to_end_from_the_gray_image(grays, jax_keypoints, jax_descriptors):
    xy, valid = _t(jax_keypoints.xy), _t(jax_keypoints.valid)
    td = TORB.describe_orb_batch(_t(grays), xy, valid)
    same = (td.bits.numpy() == np.asarray(jax_descriptors.bits).view(np.int32)).all(-1)
    v = valid.numpy()
    assert same[v].mean() >= MIN_IDENTICAL_END_TO_END, same[v].mean()
    # each differing descriptor has a patch where the two smoothed images differ
    ours = TORB.extract_patches_batch(TORB.smooth_u8(_t(grays)), xy).numpy()
    theirs = TORB.extract_patches_batch(_t(_jax_smooth(grays)), xy).numpy()
    patch_differs = (ours != theirs).any(axis=(-1, -2))
    assert np.all(patch_differs[v & ~same])
    # and the smoothed images differ by at most one level
    assert np.abs(ours.astype(np.int16) - theirs).max() <= 1


# ------------------------------------------------------------------ Hamming matching


def _popcount_distances(a, b):
    x = a[:, None, :] ^ b[None, :, :]
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1).astype(np.int32)


def _words(seed, k, n_words=8):
    return np.random.RandomState(seed).randint(0, 2**32, (k, n_words), dtype=np.uint64).astype(np.uint32)


def test_hamming_distance_matrix_exact():
    a, b = _words(0, 40), _words(1, 56)
    b[:5] = a[:5]  # some distance-0 pairs
    b[5:10] = a[5:10] ^ np.uint32(1 << 31)  # the sign bit alone
    ref = np.asarray(JM.hamming_distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    out = TM.hamming_distance_matrix(_t(a.view(np.int32)), _t(b.view(np.int32)))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), _popcount_distances(a, b))


def test_match_hamming_crosscheck_same_as_jax():
    rng = np.random.RandomState(4)
    k = 64
    t = _words(2, k)
    # queries: noisy copies of a permutation of the train set, a few random,
    # a few exact duplicates (ties go to the first index in both)
    perm = rng.permutation(k)
    flips = (rng.rand(k, 8, 32) < 0.08).astype(np.uint32) << np.arange(32, dtype=np.uint32)
    q = t[perm] ^ flips.sum(-1).astype(np.uint32)
    q[:6] = _words(3, 6)
    t[10] = t[11]
    vq, vt = rng.rand(k) > 0.1, rng.rand(k) > 0.1
    ref = JM.match_hamming_crosscheck(jnp.asarray(q), jnp.asarray(vq), jnp.asarray(t), jnp.asarray(vt))
    out = TM.match_hamming_crosscheck(_t(q.view(np.int32)), _t(vq), _t(t.view(np.int32)), _t(vt))
    np.testing.assert_array_equal(out.train_idx.numpy(), np.asarray(ref.train_idx))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    assert out.distance.dtype == torch.float32
    np.testing.assert_array_equal(out.distance.numpy(), np.asarray(ref.distance))
    assert 30 < int(out.valid.sum()) < k
    # batched over a leading axis: the same as pair by pair
    qb = _t(np.stack([q, t]).view(np.int32))
    tb = _t(np.stack([t, q]).view(np.int32))
    vqb, vtb = _t(np.stack([vq, vt])), _t(np.stack([vt, vq]))
    batched = TM.match_hamming_crosscheck(qb, vqb, tb, vtb)
    for i in range(2):
        one = TM.match_hamming_crosscheck(qb[i], vqb[i], tb[i], vtb[i])
        for f in ("train_idx", "valid", "distance"):
            np.testing.assert_array_equal(getattr(batched, f)[i].numpy(), getattr(one, f).numpy())


def test_descriptors_match_themselves_through_the_port(grays):
    """Two shifted images: the port's own features match at the shift."""
    kp = TFAST.detect_fast(_t(grays), 700)
    d = TORB.describe_orb_batch(_t(grays), kp.xy, kp.valid)
    m = TM.match_hamming_crosscheck(d.bits[1], d.valid[1], d.bits[0], d.valid[0])
    src, dst = kp.xy[1][m.valid], kp.xy[0][m.train_idx[m.valid]]
    shift = (src - dst).numpy()
    on_shift = np.all(shift == np.array([5.0, 0.0], np.float32), axis=-1)
    assert int(m.valid.sum()) > 300 and on_shift.mean() > 0.9
