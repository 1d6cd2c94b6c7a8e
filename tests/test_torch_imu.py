"""Parity of the port's IMU path with the reference: integration,
interpolation and undistortion of seeded (S = 64) windows, the
wheel-odometry motion prior, the prior and attitude branches of
`frontend_solve`, and one swept scan through segmentation, undistortion
and features.

Tolerances. Integration sums the reference's sequential recurrence in
closed form (cumulative sums in another order): velocity within 1e-6 m/s
and shift within 1e-7 m over a 0.1 s window. Orientations of the same
float32 angles agree to 2.4e-7 (sin and cos round differently in the last
bit), so an undistorted point moves by up to ~4e-7 of its range: 2e-5 m at
the 60 m of the random clouds. The solves agree as the plain
scan-to-scan solve does (tests/test_torch_solvers.py): 1 mm and 2e-4 in
rotation entries.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu import frontend as RFE
from lego_loam_tpu import imu as RI
from lego_loam_tpu.ops import projection as RP
from lego_loam_torch import frontend as PFE
from lego_loam_torch import imu as PI
from lego_loam_torch.convert import config_from_reference, imu_track_from_reference, odometry_state_from_reference
from lego_loam_torch.io.synthetic import straight_trajectory, swept_scan_sequence
from lego_loam_torch.types import ScanFeatures, ScanGrid

from _torch_parity import pair, port, ref_scores

S = 64
PERIOD = 0.1


def _window(kind, seed):
    """A seeded (S,) window: 'full' (64 samples over 0.1 s), 'partial'
    (the first 21 valid, the padded tail at t = 0) or 'empty' (all masked).
    Orientations wander by a few degrees, accelerations by 0.5 m/s^2."""
    rs = np.random.RandomState(seed)
    n = {"full": S, "partial": 21, "empty": 0}[kind]
    t_ = np.zeros(S, np.float32)
    t_[:n] = np.linspace(0.0, PERIOD, n)
    rpy = (rs.randn(S, 3) * 0.05).astype(np.float32)
    acc = (rs.randn(S, 3) * 0.5 + [0.0, 0.0, 9.81]).astype(np.float32)
    m = np.zeros(S, bool)
    m[:n] = True
    v0 = (rs.randn(3) * 2).astype(np.float32)
    return t_, rpy, acc, m, v0


def _tracks(kind, seed=0):
    t_, rpy, acc, m, v0 = _window(kind, seed)
    ref = RI.integrate_imu(*(jnp.asarray(x) for x in (t_, rpy, acc)), v0=jnp.asarray(v0), mask=jnp.asarray(m))
    ours = PI.integrate_imu(*(torch.from_numpy(x) for x in (t_, rpy, acc)), v0=torch.from_numpy(v0),
                            mask=torch.from_numpy(m))
    return ref, ours


@pytest.mark.parametrize("kind", ["full", "partial", "empty"])
def test_integrate_imu(kind):
    ref, ours = _tracks(kind)
    np.testing.assert_array_equal(ours.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_allclose(ours.R.numpy(), np.asarray(ref.R), atol=2.4e-7, rtol=0)
    np.testing.assert_allclose(ours.velo.numpy(), np.asarray(ref.velo), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ours.shift.numpy(), np.asarray(ref.shift), atol=1e-7, rtol=0)
    # the converter carries a reference track over unchanged
    conv = imu_track_from_reference(jax.device_get(ref), "cpu")
    np.testing.assert_array_equal(conv.shift.numpy(), np.asarray(ref.shift))
    # a batch of windows integrates each window alike
    t_, rpy, acc, m, v0 = _window(kind, 0)
    both = PI.integrate_imu(*(torch.from_numpy(np.stack([x, x])) for x in (t_, rpy, acc)),
                            v0=torch.from_numpy(v0), mask=torch.from_numpy(np.stack([m, m])))
    np.testing.assert_array_equal(both.frame(1).shift.numpy(), both.frame(0).shift.numpy())
    np.testing.assert_allclose(both.frame(1).shift.numpy(), ours.shift.numpy(), atol=1e-7, rtol=0)


def test_integrate_imu_constant_acceleration():
    """The reference's own case (tests/test_imu_odomprior.py): 1 m/s^2
    forward for 0.1 s from rest."""
    t_ = torch.linspace(0, 0.1, 11)
    acc = torch.tensor([1.0, 0.0, 9.81]).repeat(11, 1)
    track = PI.integrate_imu(t_, torch.zeros(11, 3), acc)
    np.testing.assert_allclose(track.velo[-1].numpy(), [0.1, 0, 0], atol=1e-5)
    np.testing.assert_allclose(track.shift[-1].numpy(), [0.005, 0, 0], atol=1e-4)


@pytest.mark.parametrize("kind", ["full", "partial", "empty"])
def test_interp_and_undistort(kind):
    """Track interpolation at query times inside, before and after the
    samples, and points undistorted to scan start and to scan end. A fully
    masked window gives finite output: the weight clips to 1 and the
    orientation is that of slot 1."""
    ref, _ = _tracks(kind)
    ours = imu_track_from_reference(jax.device_get(ref), "cpu")  # the same track in both
    rs = np.random.RandomState(1)
    tq = np.concatenate([rs.uniform(0, PERIOD, 200), [0.0, PERIOD, -0.01, 0.2]]).astype(np.float32)
    Rr, sr = RI._interp_track(ref, jnp.asarray(tq))
    Rp, sp = PI._interp_track(ours, torch.from_numpy(tq))
    np.testing.assert_allclose(Rp.numpy(), np.asarray(Rr), atol=1e-6, rtol=0)
    np.testing.assert_allclose(sp.numpy(), np.asarray(sr), atol=1e-7, rtol=0)
    assert np.isfinite(Rp.numpy()).all() and np.isfinite(sp.numpy()).all()

    xyz = (rs.randn(2000, 3) * 20).astype(np.float32)
    rel = rs.rand(2000).astype(np.float32)
    for ref_fn, fn in ((RI.undistort_to_start, PI.undistort_to_start),
                       (lambda *a: RI.undistort_to(*a, ref_time=1.0), lambda *a: PI.undistort_to(*a, ref_time=1.0))):
        a = np.asarray(ref_fn(jnp.asarray(xyz), jnp.asarray(rel), ref, PERIOD))
        b = fn(torch.from_numpy(xyz), torch.from_numpy(rel), ours, PERIOD).numpy()
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, a, atol=2e-5, rtol=0)
    if kind == "empty":  # no motion to undo
        np.testing.assert_allclose(b, xyz, atol=1e-5)


def test_undistort_pure_rotation():
    """The reference's own case: a yaw of 30 deg/s during the sweep maps
    every observation of one world point back to it in the start frame."""
    t_ = np.linspace(0, 0.1, 11)
    rpy = np.zeros((11, 3))
    rpy[:, 2] = np.deg2rad(30) * t_
    acc = np.tile([0.0, 0.0, 9.81], (11, 1))
    track = PI.integrate_imu(*(torch.tensor(x, dtype=torch.float32) for x in (t_, rpy, acc)))
    p_world = np.array([5.0, 2.0, 0.3])
    rel = np.linspace(0, 1, 8)
    pts = []
    for s in rel:
        c, sn = np.cos(np.deg2rad(30) * s * 0.1), np.sin(np.deg2rad(30) * s * 0.1)
        pts.append(np.array([[c, -sn, 0], [sn, c, 0], [0, 0, 1.0]]).T @ p_world)
    out = PI.undistort_to_start(torch.tensor(np.stack(pts), dtype=torch.float32),
                                torch.tensor(rel, dtype=torch.float32), track, 0.1)
    np.testing.assert_allclose(out.numpy(), np.tile(p_world, (8, 1)), atol=2e-3)


def test_odom_prior_motion():
    """Lever-arm corrected motion between two odometry poses, against the
    reference on seeded poses and against the closed form of
    tests/test_imu_odomprior.py."""
    rs = np.random.RandomState(2)
    la = (0.08, 0.0, 0.0377)

    def rot(yaw, pitch):
        cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
        return (np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]]) @ np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])).astype(np.float32)

    for _ in range(5):
        Rp, Rc = rot(*rs.randn(2)), rot(*rs.randn(2))
        tp, tc = (rs.randn(2, 3) * 10).astype(np.float32)
        ref = RI.odom_prior_motion(None, None, jnp.asarray(Rp), jnp.asarray(tp), jnp.asarray(Rc), jnp.asarray(tc), la)
        ours = PI.odom_prior_motion(None, None, *(torch.from_numpy(x) for x in (Rp, tp, Rc, tc)), la)
        np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]), atol=1e-6, rtol=0)
        np.testing.assert_allclose(ours[1].numpy(), np.asarray(ref[1]), atol=1e-5, rtol=0)
    yaw = np.deg2rad(10)
    Rz = torch.tensor([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1.0]], dtype=torch.float32)
    t_cur = torch.tensor([0.5, 0.1, 0.0])
    dR, dt = PI.odom_prior_motion(None, None, torch.eye(3), torch.zeros(3), Rz, t_cur, la)
    np.testing.assert_allclose(dR.numpy(), Rz.numpy(), atol=1e-6)
    np.testing.assert_allclose(dt.numpy(), (t_cur + Rz @ torch.tensor(la) - torch.tensor(la)).numpy(), atol=1e-6)


# -- frontend_solve: the prior and attitude branches ---------------------------

REF, CFG = pair()


def _mode(cfg, mode):
    return dataclasses.replace(cfg, odometry=dataclasses.replace(cfg.odometry, odom_prior_mode=mode))


@pytest.fixture(scope="module")
def solve_inputs():
    """Reference features of scans 0 and 1 of a swept, turning drive, the
    initial odometry state and the state after scan 0 (plain solve)."""
    poses = straight_trajectory(2, speed=0.15, yaw_rate=0.01)
    scans = swept_scan_sequence(poses, CFG, noise=0.005, seed=5)
    prep = jax.jit(lambda g, k: RFE.frontend_prepass(None, None, REF, k, grid=g))
    state0 = RFE.init_odometry_state(REF)
    feats = []
    for i in range(2):
        packed = RP.host_pack_range_image(scans[i], REF)
        grid = RP.grid_from_range_image(*[jnp.asarray(p) for p in packed], REF)
        feats.append(prep(grid, jax.random.fold_in(jax.random.PRNGKey(0), i))[2])
    state1, _ = jax.jit(lambda f, s: RFE.frontend_solve(f, s, REF))(feats[0], state0)
    # a prior near the true step (0.15 m forward, 0.01 rad of yaw), off by
    # 2 cm and 0.002 rad; an attitude 0.02 rad of yaw and 0.01 of roll
    # away from the plain pose
    prior_R = np.array(jax.device_get(RI.se3.exp_so3(jnp.asarray([0.0, 0.0, 0.012]))), np.float32)
    prior = (prior_R, np.array([0.17, 0.01, 0.0], np.float32))
    att = np.array(jax.device_get(RI.se3.exp_so3(jnp.asarray([0.01, 0.0, 0.03]))), np.float32)
    return feats, (jax.device_get(state0), jax.device_get(state1)), prior, att


@pytest.mark.parametrize("mode,with_att", [("init", False), ("init", True), ("override", False), ("override", True)])
def test_frontend_solve_prior_and_attitude(solve_inputs, mode, with_att):
    """First frame (scan 0 from the initial state) and a later frame (scan
    1 from the state after scan 0) in both packages from the same state:
    "init" seeds the GN with the prior, "override" replaces the motion with
    it (the first frame's too), the attitude anchor acts once initialized."""
    feats, states, prior, att = solve_inputs
    ref_cfg, cfg = _mode(REF, mode), _mode(CFG, mode)
    if with_att:
        ref_att, att_t = (jnp.asarray(att), jnp.bool_(True)), (torch.from_numpy(att), torch.tensor(True))
    else:
        ref_att = att_t = None
    ref_solve = jax.jit(lambda f, s, p, a: RFE.frontend_solve(f, s, ref_cfg, p, a))
    prior_t = tuple(torch.tensor(x) for x in prior)
    for frame, (f, st) in enumerate(zip(feats, states)):
        _, ref = ref_solve(f, st, tuple(jnp.asarray(x) for x in prior), ref_att)
        new, out = PFE.frontend_solve(port(f, ScanFeatures), odometry_state_from_reference(st, "cpu"), cfg,
                                      prior_t, att_t)
        assert bool(new.initialized)
        for k in ("M_t", "M_t_avg", "t_world"):
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-3, rtol=0, err_msg=f"{frame} {k}")
        for k in ("M_R", "M_R_avg", "R_world"):
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=2e-4, rtol=0, err_msg=f"{frame} {k}")
        np.testing.assert_allclose(out["map_corner"].xyz.numpy(), np.asarray(ref["map_corner"].xyz), atol=2e-2, rtol=0)
        if mode == "override":
            np.testing.assert_array_equal(out["M_t"].numpy(), prior[1])
            if frame == 0 or not with_att:
                np.testing.assert_array_equal(out["M_R"].numpy(), prior[0])
        if frame == 0:  # the deskew motion is the motion itself
            np.testing.assert_array_equal(out["M_R_avg"].numpy(), out["M_R"].numpy())
            if mode == "init":
                np.testing.assert_array_equal(out["M_R"].numpy(), np.eye(3, dtype=np.float32))


def test_attitude_anchor_moves_the_world_attitude(solve_inputs):
    """The anchor pulls the world attitude a weighted fraction of the way
    toward the IMU's: with weight 0.2 the remaining error is ~0.8 of the
    plain solve's; an invalid sample leaves the solve as it was."""
    feats, states, _, att = solve_inputs
    st = odometry_state_from_reference(states[1], "cpu")
    f = port(feats[1], ScanFeatures)
    _, plain = PFE.frontend_solve(f, st, CFG)
    _, anchored = PFE.frontend_solve(f, st, CFG, None, (torch.from_numpy(att), torch.tensor(True)))
    _, invalid = PFE.frontend_solve(f, st, CFG, None, (torch.from_numpy(att), torch.tensor(False)))
    np.testing.assert_array_equal(invalid["R_world"].numpy(), plain["R_world"].numpy())

    def err(R):
        return float(torch.linalg.norm(PI.se3.log_so3(R.T @ torch.from_numpy(att))))

    w = CFG.odometry.imu_attitude_weight
    assert abs(err(anchored["R_world"]) - (1 - w) * err(plain["R_world"])) < 1e-3 * err(plain["R_world"]) + 1e-6


# -- one swept scan through segmentation, undistortion and features ------------


def _shared(a, b, tol):
    """The share of a's points within tol of one of b's."""
    a = torch.from_numpy(np.ascontiguousarray(a))
    near = [torch.cdist(a[s:s + 1024].double(), b.double()).min(1).values <= tol for s in range(0, len(a), 1024)]
    return float(torch.cat(near).double().mean()) if near else 1.0


def test_prepass_with_imu_undistortion():
    """A scan swept through 3 deg of yaw with its IMU window (ground-truth
    yaw ramp, as tests/test_undistortion.py builds it) through the
    reference's `frontend_prepass(imu_track=...)` and the port's, from the
    same grid and RANSAC draw: segmented points undistorted within 4e-7 of
    their range + 1 micrometre (the orientations' last-bit rounding, 3e-5 m
    at 80 m), rel_time 1 on every
    valid point, feature counts within 2 and >= 98% of each feature cloud's
    points within 1 mm of one of the other's (curvature near-ties may pick
    a neighbouring point, as in tests/test_torch_frontend_ops.py)."""
    ref_cfg = dataclasses.replace(REF, pipeline=dataclasses.replace(REF.pipeline, use_imu_undistortion=True))
    cfg = config_from_reference(ref_cfg)
    yaw_rate = np.deg2rad(3.0)
    poses = straight_trajectory(3, speed=0.1, yaw_rate=yaw_rate)
    scan = swept_scan_sequence(poses, cfg, noise=0.005, seed=9)[2]
    s = np.linspace(0.0, 1.0, 16)
    t_ = np.zeros(S, np.float32)
    t_[:16] = s * PERIOD
    rpy = np.zeros((S, 3), np.float32)
    rpy[:16, 2] = yaw_rate * (1 - s) + yaw_rate * 2 * s
    acc = np.zeros((S, 3), np.float32)
    acc[:, 2] = 9.81
    m = np.zeros(S, bool)
    m[:16] = True
    ref_track = RI.integrate_imu(jnp.asarray(t_), jnp.asarray(rpy), jnp.asarray(acc), mask=jnp.asarray(m))
    track = PI.integrate_imu(*(torch.from_numpy(x) for x in (t_, rpy, acc)), mask=torch.from_numpy(m))

    packed = RP.host_pack_range_image(scan, ref_cfg)
    grid = RP.grid_from_range_image(*[jnp.asarray(p) for p in packed], ref_cfg)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 2)
    _, rseg, rfeats = jax.jit(
        lambda g, tr: RFE.frontend_prepass(None, None, ref_cfg, key, imu_track=tr, grid=g)
    )(grid, ref_track)
    _, seg, feats = PFE.frontend_prepass(port(grid, ScanGrid), cfg, ref_scores(cfg, 2), imu_track=track)

    valid = np.asarray(rseg.valid)
    np.testing.assert_array_equal(seg.valid.numpy(), valid)
    rxyz = np.asarray(rseg.xyz)[valid]
    err = np.abs(seg.xyz.numpy()[valid] - rxyz).max(1)
    assert (err <= 4e-7 * np.linalg.norm(rxyz, axis=1) + 1e-6).all(), err.max()
    assert (seg.rel_time.numpy()[valid] == 1.0).all()
    np.testing.assert_array_equal(seg.rel_time.numpy(), np.asarray(rseg.rel_time))
    # the undistortion moved the points: the sweep's 3 deg at 10 m is ~0.5 m
    plain = np.asarray(jax.jit(lambda g: RFE.frontend_prepass(None, None, REF, key, grid=g))(grid)[1].xyz)[valid]
    assert np.abs(seg.xyz.numpy()[valid] - plain).max() > 0.1
    for name in ("corner_sharp", "corner_less_sharp", "surf_flat", "surf_less_flat", "surf_ground"):
        a, b = getattr(rfeats, name), getattr(feats, name)
        na, nb = int(a.mask.sum()), int(b.mask.sum())
        assert abs(na - nb) <= 2, (name, na, nb)
        shared = _shared(np.asarray(a.xyz)[np.asarray(a.mask)], b.xyz[b.mask], 1e-3)
        assert shared >= 0.98, (name, shared)
    assert int(feats.corner_sharp.mask.sum()) > 20
