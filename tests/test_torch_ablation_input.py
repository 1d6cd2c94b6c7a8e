"""Ablation parity, input switches: `ground.use_ours=False` (the
reference's ground rule) and `pipeline.feed_mode="points"` (int16 points
projected on the device by `project_point_cloud` instead of the range-image
feed), the port against the JAX package in both frame-step modes (see
tests/_torch_ablation.py for the drive). Measured over the 4 scans: map
8.9e-5 and 1.18e-2 m, odometry 8.7e-5 and 3.9e-2 m apart. The points
feed's grids agree (xyz and masks bit-equal, ranges within one float32
rounding), so its larger map difference is the flat-feature ties of
ROADMAP §3 reached through the last bit of the range."""

import jax.numpy as jnp
import numpy as np
import pytest

from lego_loam_tpu.ops.projection import project_point_cloud as ref_project

from _torch_ablation import assert_modes_equal, assert_parity, port_drive, reference_drive


def _runs(switch):
    d = reference_drive(switch)
    return d, {sf: port_drive(d, sync_free=sf) for sf in (False, True)}


@pytest.fixture(scope="module")
def reference_ground():
    return _runs("reference_ground")


@pytest.fixture(scope="module")
def points_feed():
    return _runs("points_feed")


def test_reference_ground(reference_ground):
    """ground.use_ours=False: the slice's bounds."""
    d, runs = reference_ground
    assert_parity(d, runs[False][1])


def test_reference_ground_sync_free(reference_ground):
    """The same for the sync_free step, bit-equal to the host-branching run."""
    d, runs = reference_ground
    assert_parity(d, runs[True][1])
    assert_modes_equal(runs[False][1], runs[True][1])


def test_points_feed(points_feed):
    """feed_mode="points": the slice's bounds."""
    d, runs = points_feed
    assert_parity(d, runs[False][1])


def test_points_feed_sync_free(points_feed):
    """The same for the sync_free step, bit-equal to the host-branching run."""
    d, runs = points_feed
    assert_parity(d, runs[True][1])
    assert_modes_equal(runs[False][1], runs[True][1])


def test_points_feed_grid(points_feed):
    """The points feed through both packages: the packed int16 points and
    masks equal, and each scan's grid from the port's `_grid` (dequantize,
    `project_point_cloud`) against the reference's `project_point_cloud`
    on the same points: xyz, valid mask and sweep times bit-equal, ranges
    within 1e-5 m (one float32 rounding of the square root at up to
    128 m is 7.6e-6 m)."""
    d, runs = points_feed
    pipe = runs[False][0]
    ref_cfg = d.ref.cfg
    ref_feed, feed = d.ref._prep_many(d.scans), pipe._prep_many(d.scans)
    assert sorted(ref_feed) == sorted(feed) == ["mask", "pts"]
    for k in feed:
        assert feed[k].dtype == ref_feed[k].dtype and np.array_equal(feed[k], ref_feed[k]), k
    xs = pipe.stage_chunk(feed)
    for c in range(len(d.scans)):
        ours = pipe._grid(xs, c)
        pts = jnp.asarray(ref_feed["pts"][c]).astype(jnp.float32) * ref_cfg.pipeline.feed_quant
        ref = ref_project(pts, jnp.asarray(ref_feed["mask"][c]), ref_cfg)
        valid = np.asarray(ref.valid)
        assert valid.sum() > 20000
        assert np.array_equal(ours.valid.numpy(), valid)
        assert np.array_equal(ours.xyz.numpy(), np.asarray(ref.xyz))
        assert np.array_equal(ours.rel_time.numpy(), np.asarray(ref.rel_time))
        assert np.abs(ours.range.numpy()[valid] - np.asarray(ref.range)[valid]).max() <= 1e-5
