"""The IMU and wheel-odometry path end to end: the reference's chunk
runner and the port's `process_chunk` over five swept scans of a turning
drive with IMU windows and wheel-odometry poses (`use_imu_undistortion`,
`odom_prior_mode="init"`), then two more scans through both
`process_scan`s, so the previous odometry pose carried on the host
(`_last_odom`) crosses from one entry point to the other. Both start from
the reference's initial states and draw the reference's RANSAC scores.

Tolerances as in tests/test_torch_pipeline.py, which documents the
flat-feature tie divergence: map poses within 1.5 cm, odometry within
8 cm, map attitudes within 5e-3 rad. Over these seven frames the odometry
agrees far closer (at most 1 mm was measured), and the prior's effect on
it is larger: a port that dropped the prior differs by 2.6-5.7 cm, within
8 cm, so the odometry is also held to 5 mm."""

import dataclasses

import jax
import numpy as np
import pytest

from lego_loam_tpu.pipeline import LegoLoamPipeline as RefPipeline
from lego_loam_torch.convert import backend_state_from_reference, odometry_state_from_reference
from lego_loam_torch.io.synthetic import straight_trajectory, swept_scan_sequence
from lego_loam_torch.pipeline import LegoLoamPipeline

from _torch_parity import pair, ref_scores, small_ref_cfg

N_CHUNK, N_SCAN = 5, 2
YAW_RATE = np.deg2rad(2.0)


def imu_windows(n, cfg):
    """Ground-truth yaw ramps over each scan period, as
    tests/test_undistortion.py builds them: scan i sweeps pose i-1 to pose i
    (the window's S slots all valid)."""
    S, sp = cfg.pipeline.imu_window, cfg.laser.scan_period
    s = np.linspace(0.0, 1.0, S)
    imu = {"t": np.zeros((n, S), np.float32), "rpy": np.zeros((n, S, 3), np.float32),
           "acc": np.zeros((n, S, 3), np.float32), "mask": np.ones((n, S), bool)}
    for i in range(n):
        imu["t"][i] = s * sp
        imu["rpy"][i, :, 2] = YAW_RATE * max(i - 1, 0) * (1 - s) + YAW_RATE * i * s
        imu["acc"][i, :, 2] = 9.81
    return imu


def rows(imu, i):
    """Frame i's window as process_scan's (S, 7) rows."""
    return np.concatenate([imu["t"][i][:, None], imu["rpy"][i], imu["acc"][i]], axis=1)


@pytest.fixture(scope="module")
def runs():
    base = small_ref_cfg(max_keyframes=32)
    ref_cfg, cfg = pair(dataclasses.replace(
        base,
        pipeline=dataclasses.replace(base.pipeline, use_imu_undistortion=True, imu_window=16),
        odometry=dataclasses.replace(base.odometry, odom_prior_mode="init"),
    ))
    n = N_CHUNK + N_SCAN
    poses = straight_trajectory(n, speed=0.1, yaw_rate=YAW_RATE)
    scans = list(swept_scan_sequence(poses, cfg, noise=0.005, seed=3))
    imu = imu_windows(n, cfg)
    # wheel odometry: the truth stretched by a 1% scale error
    odom = (np.stack([R for R, _ in poses]).astype(np.float32),
            (1.01 * np.stack([t for _, t in poses])).astype(np.float32))

    ref = RefPipeline(ref_cfg)
    ours = LegoLoamPipeline(cfg, device="cpu", ground_scores=lambda i: ref_scores(cfg, i))
    ours.fstate = odometry_state_from_reference(jax.device_get(ref.fstate), "cpu")
    ours.bstate = backend_state_from_reference(jax.device_get(ref.bstate), "cpu")
    last_odom = []
    for p in (ref, ours):
        chunk_imu = {k: v[:N_CHUNK] for k, v in imu.items()}
        p.process_chunk(p._prep_many(scans[:N_CHUNK]), imu=chunk_imu, odom=(odom[0][:N_CHUNK], odom[1][:N_CHUNK]))
        last_odom.append(p._last_odom)
        for i in range(N_CHUNK, n):
            p.process_scan(scans[i], imu_samples=rows(imu, i), odom_pose=(odom[0][i], odom[1][i]))
        p.finalize()
    return ref, ours, np.stack([t for _, t in poses]), last_odom


def test_per_frame_poses(runs):
    ref, ours, truth, _ = runs
    ref_map = np.stack(ref.trajectory["positions"])
    ours_map = np.stack(ours.trajectory["positions"])
    assert ours_map.shape == ref_map.shape == truth.shape
    np.testing.assert_allclose(ours_map, ref_map, atol=1.5e-2, rtol=0)
    np.testing.assert_allclose(ours.odom_positions, ref.odom_positions, atol=8e-2, rtol=0)
    np.testing.assert_allclose(ours.odom_positions, ref.odom_positions, atol=5e-3, rtol=0)
    np.testing.assert_allclose(ours.fused_positions, ref.fused_positions, atol=8e-2, rtol=0)
    np.testing.assert_allclose(ours.trajectory["rpys"], ref.trajectory["rpys"], atol=5e-3, rtol=0)
    assert ours.trajectory["times"] == ref.trajectory["times"]
    ate = lambda p: float(np.sqrt(np.mean(np.sum((p - truth) ** 2, axis=1))))  # noqa: E731
    assert ate(ours_map) <= ate(ref_map) + 5e-3


def test_last_odom_across_entry_points(runs):
    """The chunk leaves its last wheel pose on the host; the first
    process_scan takes its motion prior from it, and each scan then leaves
    its own pose, in both packages alike."""
    ref, ours, _, (ref_after_chunk, ours_after_chunk) = runs
    for a, b in zip(ref_after_chunk, ours_after_chunk):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    for a, b in zip(ref._last_odom, ours._last_odom):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert ours.frame_idx == ref.frame_idx == N_CHUNK + N_SCAN


def test_mapping_records(runs):
    """Iteration counts equal; selected residuals within 1%."""
    ref, ours, _, _ = runs
    a, b = ref.diagnostics["records"], ours.diagnostics["records"]
    assert len(a) == len(b) == N_CHUNK + N_SCAN
    assert [r["iterations"] for r in a] == [r["iterations"] for r in b]
    for ra, rb in zip(a, b):
        assert abs(ra["n_sel"] - rb["n_sel"]) <= 0.01 * max(ra["n_sel"], 100), (ra, rb)
        assert not rb["rejected"]
