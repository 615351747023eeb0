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
    got = brief.detect_and_describe(_t(left), cfg)
    valid = np.asarray(want.valid)
    assert valid.sum() > 20
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.xy.numpy(), np.asarray(want.xy))
    np.testing.assert_array_equal(got.score.numpy(), np.asarray(want.score))
    np.testing.assert_array_equal(got.descriptors.numpy(),
                                  np.asarray(want.descriptors).astype(np.int64))


def test_pyramid_not_ported_raises(stereo_frame):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        brief.detect_and_describe(_t(stereo_frame.left),
                                  FeatureConfig(num_levels=2))


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
