"""Ablation parity, feature switches: `features.use_ours=False` (the
reference's curvature and pick rules) and `features.use_shadow_points=False`,
the port against the JAX package in both frame-step modes (see
tests/_torch_ablation.py for the drive). Measured over the 4 scans: map
4.2e-4 and 5.1e-3 m, odometry 4.5e-5 and 1.9e-2 m apart."""

import numpy as np
import pytest

from _torch_ablation import assert_modes_equal, assert_parity, port_drive, reference_drive


def _runs(switch):
    d = reference_drive(switch)
    return d, {sf: port_drive(d, sync_free=sf)[1] for sf in (False, True)}


@pytest.fixture(scope="module")
def reference_features():
    return _runs("reference_features")


@pytest.fixture(scope="module")
def no_shadow_points():
    return _runs("no_shadow_points")


def test_reference_features(reference_features):
    """features.use_ours=False: the slice's bounds."""
    d, runs = reference_features
    assert_parity(d, runs[False])


def test_reference_features_sync_free(reference_features):
    """The same for the sync_free step, bit-equal to the host-branching run."""
    d, runs = reference_features
    assert_parity(d, runs[True])
    assert_modes_equal(runs[False], runs[True])


def test_no_shadow_points(no_shadow_points):
    """use_shadow_points=False: the slice's bounds."""
    d, runs = no_shadow_points
    assert_parity(d, runs[False])


def test_no_shadow_points_sync_free(no_shadow_points):
    """The same for the sync_free step, bit-equal to the host-branching run."""
    d, runs = no_shadow_points
    assert_parity(d, runs[True])
    assert_modes_equal(runs[False], runs[True])
