"""Shared drive of the ablation parity tests (tests/test_torch_ablation_*.py):
the reference's chunk runner and the port's `run_chunked` over the same
swept scans of `small_ref_cfg` with one of the reference's ablation
switches set, the port starting from the reference's initial states
(`convert.*_from_reference`) and drawing the reference's RANSAC scores, as
tests/test_torch_pipeline.py runs the slice. The port runs twice, with the
host-branching frame step and with the `sync_free` step."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from lego_loam_tpu.pipeline import LegoLoamPipeline as RefPipeline
from lego_loam_torch.convert import backend_state_from_reference, config_from_reference, odometry_state_from_reference
from lego_loam_torch.io.synthetic import straight_trajectory, swept_scan_sequence
from lego_loam_torch.pipeline import LegoLoamPipeline

from _torch_parity import ref_scores, small_ref_cfg

N_FRAMES = 4
CHUNK = 2  # two chunks: K1's batch and the carry across chunks
# the bounds of tests/test_torch_pipeline.py: map 1.5 cm, odometry (and the
# fused pose) 8 cm
MAP_TOL, ODOM_TOL = 1.5e-2, 8e-2

_r = dataclasses.replace
SWITCHES = {
    "full_dof_odometry": lambda c: _r(c, odometry=_r(c.odometry, full_dof_odometry=True)),
    "no_map_update": lambda c: _r(c, mapping=_r(c.mapping, enable_map_update=False)),
    "reference_ground": lambda c: _r(c, ground=_r(c.ground, use_ours=False)),
    "reference_features": lambda c: _r(c, features=_r(c.features, use_ours=False)),
    "no_shadow_points": lambda c: _r(c, features=_r(c.features, use_shadow_points=False)),
    "points_feed": lambda c: _r(c, pipeline=_r(c.pipeline, feed_mode="points")),
}


@dataclasses.dataclass
class Drive:
    ref: RefPipeline
    cfg: object  # the port's config
    scans: list
    truth: np.ndarray
    start: tuple  # the reference's initial (odometry, backend) states, on the host
    ref_map: np.ndarray


def reference_drive(switch: str) -> Drive:
    """The reference's chunk runner over N_FRAMES swept scans of a straight
    drive (0.15 m a frame, 5 mm noise) with `switch` set."""
    ref_cfg = SWITCHES[switch](small_ref_cfg(max_keyframes=32))
    cfg = config_from_reference(ref_cfg)
    poses = straight_trajectory(N_FRAMES, speed=0.15)
    scans = list(swept_scan_sequence(poses, cfg, noise=0.005))
    ref = RefPipeline(ref_cfg)
    start = jax.device_get(ref.fstate), jax.device_get(ref.bstate)
    ref.process_chunk(ref._prep_many(scans))
    ref.finalize()
    return Drive(ref, cfg, scans, np.stack([t for _, t in poses]), start, np.stack(ref.trajectory["positions"]))


def port_drive(d: Drive, sync_free: bool):
    """The port from the reference's start states and draws, in chunks of
    CHUNK. Returns (pipeline, run_chunked's result)."""
    ours = LegoLoamPipeline(d.cfg, device="cpu", ground_scores=lambda i: ref_scores(d.cfg, i), sync_free=sync_free)
    ours.fstate = odometry_state_from_reference(d.start[0], "cpu")
    ours.bstate = backend_state_from_reference(d.start[1], "cpu")
    return ours, ours.run_chunked(d.scans, chunk=CHUNK)


def assert_parity(d: Drive, out, map_tol=MAP_TOL, odom_tol=ODOM_TOL):
    """Map positions within map_tol, odometry and fused within odom_tol,
    every output finite and of one pose a frame."""
    for k in ("map_positions", "odom_positions", "fused_positions"):
        a = np.asarray(out[k])
        assert a.shape == (N_FRAMES, 3) and np.isfinite(a).all(), (k, a)
    np.testing.assert_allclose(out["map_positions"], d.ref_map, atol=map_tol, rtol=0)
    np.testing.assert_allclose(out["odom_positions"], d.ref.odom_positions, atol=odom_tol, rtol=0)
    np.testing.assert_allclose(out["fused_positions"], d.ref.fused_positions, atol=odom_tol, rtol=0)


def assert_modes_equal(a, b):
    """The host-branching and sync_free runs' outputs bit-equal."""
    for k in a:
        assert np.array_equal(a[k], b[k]), k
