"""PyTorch port, features: FAST detection, oriented BRIEF and Hamming
matching against their JAX twins on the same frame."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from online_3d_reconstruction_tpu.config import FeatureConfig
from online_3d_reconstruction_tpu.features import brief as jbrief
from online_3d_reconstruction_tpu.features import fast as jfast
from online_3d_reconstruction_tpu.features import match as jmatch
from online_3d_reconstruction_tpu.io.synthetic import nadir_pose
from online_3d_reconstruction_tpu_torch.features import brief, fast, match
from tests.test_torch_shared import port

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_brief_pattern_is_the_reference_draw():
    np.testing.assert_array_equal(brief.brief_pattern(256, 31, 7),
                                  jbrief.brief_pattern(256, 31, 7))


@pytest.mark.parametrize("threshold", [5.0, 20.0])
def test_keypoints_and_descriptors_equal(stereo_frame, threshold):
    """Score maps, keypoint xy (subpixel), validity and every descriptor
    word equal. Exact: the score sums run in the reference's order, top-k
    ties keep the lower index on both sides, and the bilinear pattern
    samples land on the same side of every comparison."""
    cfg = FeatureConfig(max_keypoints=256, fast_threshold=threshold)
    left = stereo_frame.left
    np.testing.assert_array_equal(
        fast.fast_score(_t(left), threshold / 255.0).numpy(),
        np.asarray(jfast.fast_score(jnp.asarray(left), threshold / 255.0)))
    want = jbrief.detect_and_describe(jnp.asarray(left), cfg)
    got = brief.detect_and_describe(_t(left), port(cfg))
    valid = np.asarray(want.valid)
    assert valid.sum() > 20
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.xy.numpy(), np.asarray(want.xy))
    np.testing.assert_array_equal(got.score.numpy(), np.asarray(want.score))
    np.testing.assert_array_equal(got.descriptors.numpy(),
                                  np.asarray(want.descriptors).astype(np.int64))


@pytest.mark.parametrize("total,levels", [(512, 1), (256, 2), (256, 3), (500, 4), (7, 3)])
def test_level_budgets_equal(total, levels):
    caps = brief._level_budgets(total, levels)
    assert caps == jbrief._level_budgets(total, levels)
    assert sum(caps) == total


def test_downsample2_equal(stereo_frame):
    """Bit-equal at every level of the pipeline's shapes (192x256 and its
    halvings): the row pairs are summed first, then the two sums, the order
    in which the reference's compiled mean sums a width that is a multiple
    of 8. At other widths (here 253 -> 126) XLA's CPU build sums the four
    pixels in sequence instead, so the bound there is one f32 ulp of the
    [0, 1] image per level (6e-8 at the first, accumulating to 1.8e-7 at
    the third); an odd trailing row/column is dropped on both."""
    img = stereo_frame.left
    for shape, ulp in ((img.shape, 0.0), ((img.shape[0] - 1, img.shape[1] - 3), 6e-8)):
        level_t = _t(img[:shape[0], :shape[1]])
        level_j = jnp.asarray(img[:shape[0], :shape[1]])
        for level in (1, 2, 3):
            level_t, level_j = brief._downsample2(level_t), jbrief._downsample2(level_j)
            assert level_t.shape == level_j.shape
            np.testing.assert_allclose(level_t.numpy(), np.asarray(level_j), rtol=0,
                                       atol=ulp * level)


@pytest.mark.parametrize("levels", [2, 3])
def test_pyramid_keypoints_and_descriptors_equal(stereo_frame, levels):
    """The multi-level detector (the reference's TestPyramid configuration):
    xy in full-resolution pixels, validity, octave, score and every
    descriptor word equal, exactly as the single-level case; the angle to
    1e-4 rad (its moment sums run in another order, which moves the angle
    of a keypoint with small moments by up to 3e-5 rad; no descriptor bit
    flips)."""
    cfg = FeatureConfig(max_keypoints=256, fast_threshold=5.0, num_levels=levels)
    want = jbrief.detect_and_describe(jnp.asarray(stereo_frame.left), cfg)
    got = brief.detect_and_describe(_t(stereo_frame.left), port(cfg))
    valid = np.asarray(want.valid)
    octave = np.asarray(want.octave)
    assert set(np.unique(octave[valid])) >= {0, 1}
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.octave.numpy(), octave)
    np.testing.assert_array_equal(got.xy.numpy(), np.asarray(want.xy))
    np.testing.assert_array_equal(got.score.numpy(), np.asarray(want.score))
    np.testing.assert_array_equal(got.descriptors.numpy(),
                                  np.asarray(want.descriptors).astype(np.int64))
    np.testing.assert_allclose(got.angle.numpy()[valid], np.asarray(want.angle)[valid],
                               atol=1e-4)


def test_matching_equal_on_frame_descriptors(scene, small_rig):
    """Two overlapping views: indices, distances and validity (ratio test,
    threshold, cross-check) equal on the same descriptors. Distances are
    exact integers on both sides; argmin keeps the first index on ties."""
    cfg = FeatureConfig(max_keypoints=256, fast_threshold=5.0)
    descs = []
    for x in (0.0, 1.0):
        f = scene.render_stereo(nadir_pose(x, 0.2 * x, 24.0), small_rig)
        kp = jbrief.detect_and_describe(jnp.asarray(f.left), cfg)
        descs.append((np.asarray(kp.descriptors), np.asarray(kp.valid)))
    (da, va), (db, vb) = descs
    for cross in (True, False):
        want = jmatch.match_descriptors(jnp.asarray(da), jnp.asarray(db),
                                        jnp.asarray(va), jnp.asarray(vb),
                                        max_hamming=64, ratio=0.9, cross_check=cross)
        got = match.match_descriptors(_t(da.astype(np.int64)), _t(db.astype(np.int64)),
                                      _t(va), _t(vb), max_hamming=64, ratio=0.9,
                                      cross_check=cross)
        assert np.asarray(want.valid).sum() > 10
        np.testing.assert_array_equal(got.index.numpy(), np.asarray(want.index))
        np.testing.assert_array_equal(got.distance.numpy(), np.asarray(want.distance))
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
