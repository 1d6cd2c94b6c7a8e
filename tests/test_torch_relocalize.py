"""Re-localization in a saved map: `lego_loam_torch.relocalize` against
`lego_loam_tpu.relocalize`.

The dense map is the world-frame union of rigid renders along a straight
drive (the cloud a HighDense map holds), at the capacities of
tests/test_relocalize.py. Tolerances: `map_state_from_cloud`'s buffers
bit-equal (the same host crop, voxel keys and `np.unique` order); the same
scan, start and RANSAC draw through both packages' `localize_scan` give
poses within 1 cm and 0.1 deg (flat-feature ties, ROADMAP §3); from a
0.3 m / 3 deg perturbed start the port recovers the true pose within
0.12 m and 1 deg (tests/test_relocalize.py:52-76)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from lego_loam_tpu.config import vlp16
from lego_loam_tpu.relocalize import localize_scan as ref_localize_scan
from lego_loam_tpu.relocalize import map_state_from_cloud as ref_map_state_from_cloud
from lego_loam_torch.convert import config_from_reference
from lego_loam_torch.io.synthetic import render_scan, straight_trajectory
from lego_loam_torch.relocalize import localize_scan, map_state_from_cloud

from _torch_parity import t as as_tensor


def _small(cfg):
    return dataclasses.replace(
        cfg,
        mapping=dataclasses.replace(
            cfg.mapping, max_submap_corner=4096, max_submap_surf=8192, surrounding_keyframe_search_num=8,
            max_keyframes=32,
        ),
        pipeline=dataclasses.replace(cfg.pipeline, rigid_scans=True),
        distributed=dataclasses.replace(cfg.distributed, shard_backend=False, use_sharded_posegraph=False),
    )


def _rot_deg(Ra, Rb):
    return float(np.rad2deg(np.arccos(np.clip((np.trace(Ra.T @ Rb) - 1) / 2, -1, 1))))


@pytest.fixture(scope="module")
def world():
    ref_cfg = _small(vlp16())
    cfg = config_from_reference(ref_cfg)
    poses = straight_trajectory(8, speed=0.3)
    clouds = []
    for i, (R, t) in enumerate(poses):
        pts = render_scan(R, t, cfg, noise=0.005, seed=50 + i)
        pts = pts[np.isfinite(pts).all(axis=1)]
        clouds.append((pts @ R.T + t).astype(np.float32))
    dense = np.concatenate(clouds)
    R_true, t_true = poses[4]
    scan = render_scan(R_true, t_true, cfg, noise=0.005, seed=99)
    yaw = np.deg2rad(3.0)
    c, s = np.cos(yaw), np.sin(yaw)
    R0 = (np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ R_true).astype(np.float32)
    t0 = (t_true + np.array([0.3, -0.2, 0.05])).astype(np.float32)
    return ref_cfg, cfg, dense, scan, R_true, t_true, R0, t0


@pytest.mark.parametrize("center", [None, "truth"])
def test_map_state_from_cloud_bit_equal(world, center):
    ref_cfg, cfg, dense, *_, t_true, _, _ = world
    c = None if center is None else t_true
    ours = map_state_from_cloud(dense, cfg, center=c, device="cpu")
    ref = jax.device_get(ref_map_state_from_cloud(dense, ref_cfg, center=c))
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name).numpy(), np.asarray(getattr(ref, f.name))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert 0 < int(ours.surf_mask.sum()) <= ours.surf_mask.numel()


def test_localize_scan_matches_reference(world):
    """The same scan, start and RANSAC draw (the reference's PRNGKey(0)
    scores) through both packages."""
    ref_cfg, cfg, dense, scan, R_true, t_true, R0, t0 = world
    H, W = cfg.laser.num_vertical_scans, cfg.laser.num_horizontal_scans
    scores = as_tensor(jax.random.uniform(jax.random.PRNGKey(0), (cfg.ground.ransac_iterations, H * W)))
    ours_map = map_state_from_cloud(dense, cfg, center=t_true, device="cpu")
    R, t, diag = localize_scan(scan, ours_map, R0, t0, cfg, scores=scores)
    rR, rt, rdiag = ref_localize_scan(scan, ref_map_state_from_cloud(dense, ref_cfg, center=t_true), R0, t0, ref_cfg)
    rR, rt = np.asarray(rR), np.asarray(rt)
    assert np.linalg.norm(t.numpy() - rt) < 0.01
    assert _rot_deg(R.numpy(), rR) < 0.1
    assert int(diag.iterations) > 0 and not bool(diag.rejected) and not bool(rdiag.rejected)


def test_localize_scan_recovers_perturbed_start(world):
    """tests/test_relocalize.py's check on the port, with its own default
    RANSAC draw; the draw is the same on every call."""
    _, cfg, dense, scan, R_true, t_true, R0, t0 = world
    submap = map_state_from_cloud(dense, cfg, center=t_true, device="cpu")
    R, t, _ = localize_scan(scan, submap, R0, t0, cfg)
    err_t = float(np.linalg.norm(t.numpy() - t_true))
    assert err_t < 0.12, f"translation error {err_t:.3f} (init {np.linalg.norm(t0 - t_true):.3f})"
    assert _rot_deg(R_true, R.numpy()) < 1.0
    R2, t2, _ = localize_scan(scan, submap, torch.from_numpy(R0), torch.from_numpy(t0), cfg)
    assert torch.equal(R, R2) and torch.equal(t, t2)
