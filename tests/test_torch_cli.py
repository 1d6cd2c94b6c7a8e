"""`python -m lego_loam_torch.run`, driven in-process on the CPU over a KITTI
sequence and a rosbag2 bag rendered from the synthetic world (the
fixtures of tests/test_cli_e2e.py, written by tools/make_fixtures.py), with
the config's capacities reduced for the CPU (the CLI code is unchanged).

Checks, as tests/test_cli_e2e.py's `_check_artifacts` does: the artifact
set, finite poses moving +x. Tolerances: the CLI's pose.txt over either
input equals, as text, the one the port's own `process_scan` writes over
the same clouds; `--remap` writes the poses of the port's own
`localize_scan` loop, within 5 cm of the mid-sweep truth; the rosbag2 IMU
windows and odometry picks equal the reference CLI's
(`lego_loam_tpu/run.py:128-163`), times, accelerations and positions
exactly, roll/pitch/yaw and rotations within 1e-6 (a few float32 ulps:
the reference converts through jnp, the port batches through torch);
a run checkpointed at frame 2 and resumed in a fresh pipeline ends within
2e-2 m of the uninterrupted CLI run (tests/test_cli_e2e.py:126); the IMU
and odometry topics and --resume run. The multi-process flags reach the
group's join; the CLI refuses a missing GPU without --device cpu."""

import argparse
import json
import os
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu.math import se3 as ref_se3
from lego_loam_torch import checkpoint, run
from lego_loam_torch.convert import config_from_reference
from lego_loam_torch.io.kitti import KittiSequence
from lego_loam_torch.io.synthetic import straight_trajectory, swept_scan_sequence
from lego_loam_torch.pipeline import LegoLoamPipeline
from lego_loam_torch.utils.profiling import StageTimer

from _torch_parity import small_ref_cfg
from test_torch_io import imu_blob, odom_blob

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_fixtures import write_kitti, write_rosbag2  # noqa: E402

N = 4


def _cfg():
    return config_from_reference(small_ref_cfg())


def _main(argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(run, "get_config", lambda preset: _cfg())
        run.main(["--device", "cpu", *argv])


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    cfg = _cfg()
    poses = straight_trajectory(N + 1, speed=0.2)
    scans = swept_scan_sequence(poses, cfg, noise=0.005, seed=300)
    times = [i * cfg.laser.scan_period for i in range(N + 1)]
    write_kitti(str(d / "kitti" / "00"), scans, times)
    write_rosbag2(str(d / "bag"), scans, times)
    _main(["--kitti", str(d / "kitti" / "00"), "--out", str(d / "out_kitti"), "--max-frames", str(N),
           "--profile", "--checkpoint", str(d / "state.npz")])
    _main(["--rosbag", str(d / "bag"), "--out", str(d / "out_bag"), "--max-frames", str(N)])
    return d, np.stack([t for _, t in poses])


def _check_artifacts(out, n):
    pose = np.loadtxt(os.path.join(out, "pose.txt"))
    assert pose.shape == (n, 7) and np.isfinite(pose).all()
    assert pose[-1, 0] > 0.1 * (n - 1) * 0.2 and abs(pose[-1, 1]) < 1.0
    for name in ("mapt.txt", "MapIterTimes.txt", "LocalInfo.txt", "cornerMap.pcd", "surfaceMap.pcd"):
        assert os.path.exists(os.path.join(out, name)), name
    assert len(np.loadtxt(os.path.join(out, "MapIterTimes.txt"))) == n
    return pose


def test_cli_artifacts_and_profile(fixtures):
    d, _ = fixtures
    for out in ("out_kitti", "out_bag"):
        _check_artifacts(str(d / out), N)
    mapt = np.loadtxt(d / "out_kitti" / "mapt.txt")  # --profile: each mapped frame's time
    assert mapt.shape == (N,) and (mapt > 0).all()
    assert os.path.getsize(d / "out_bag" / "mapt.txt") == 0  # no timing without --profile
    prof = json.loads((d / "out_kitti" / "profile.json").read_text())
    assert prof["scans"] == N and prof["device"] == "cpu" and prof["launches"] == {}
    assert set(prof["stages_mean_ms"]) == {"read", "process_scan"}
    assert set(prof["device_ms_per_scan"]) == {"front_end", "odometry", "mapping", "between_steps"}
    assert all(v > 0 for v in prof["device_ms_per_scan"].values())
    assert prof["odometry_trips"]["attempted"] == 2 * _cfg().odometry.max_iterations
    assert 0 < prof["odometry_trips"]["useful_mean"] <= prof["odometry_trips"]["attempted"]
    assert checkpoint.load(LegoLoamPipeline(_cfg(), device="cpu"), str(d / "state.npz")).frame_idx == N


def test_cli_poses_equal_process_scan(fixtures):
    """Both inputs hold the same clouds and times: the KITTI run (native
    feeder) and the rosbag2 run write the pose.txt that the port's own
    process_scan writes over the KITTI files' points."""
    d, _ = fixtures
    pipe = LegoLoamPipeline(_cfg(), device="cpu")
    for i, (xyz, _t) in enumerate(KittiSequence(str(d / "kitti" / "00")).scans()):
        if i == N:
            break
        pipe.process_scan(xyz, 0.1 * i)
    pipe.save_artifacts(str(d / "direct"))
    want = (d / "direct" / "pose.txt").read_text()
    assert (d / "out_kitti" / "pose.txt").read_text() == want
    assert (d / "out_bag" / "pose.txt").read_text() == want


def test_cli_remap(fixtures):
    """--remap localizes the bag's scans in the KITTI run's dense map: the
    port's localize_scan from the origin, each scan from the previous pose,
    and within 5 cm of the mid-sweep truth (a swept scan is not deskewed
    here, so it fits best where the sensor was halfway through it)."""
    from lego_loam_torch.io.rosbag2 import Rosbag2Reader
    from lego_loam_torch.mapproducts import load_high_dense_map
    from lego_loam_torch.relocalize import localize_scan, map_state_from_cloud

    d, truth = fixtures
    _main(["--remap", str(d / "out_kitti"), "--rosbag", str(d / "bag"), "--out", str(d / "reloc"),
           "--max-frames", "3", "--profile"])
    traj = np.loadtxt(d / "reloc" / "relocalized.txt")
    assert traj.shape == (3, 3)
    assert "localize" in json.loads((d / "reloc" / "profile.json").read_text())["stages_mean_ms"]

    cfg = _cfg()
    dense, _ = load_high_dense_map(str(d / "out_kitti" / "denseCloud.pcd"))
    submap = map_state_from_cloud(dense, cfg, center=np.zeros(3, np.float32), device="cpu")
    R, t, want = torch.eye(3), torch.zeros(3), []
    rdr = Rosbag2Reader(str(d / "bag"))
    for _, (_ts, xyz) in zip(range(3), rdr.scan_stream("/velodyne_points")):
        R, t, _ = localize_scan(xyz, submap, R, t, cfg)
        want.append(t.numpy())
    rdr.close()
    np.testing.assert_array_equal(traj, np.stack(want))
    mid = np.concatenate([truth[:1], (truth[:-1] + truth[1:]) / 2])[:3]
    assert np.linalg.norm(traj - mid, axis=1).max() < 0.05


def test_cli_synthetic(tmp_path):
    _main(["--synthetic", "2", "--out", str(tmp_path), "--no-map-update"])
    pose = np.loadtxt(tmp_path / "pose.txt")
    assert pose.shape == (2, 7) and np.isfinite(pose).all()


def _ref_cli_streams(imu_msgs, odom_msgs, stamps, sp):
    """The reference CLI's IMU windows and odometry picks
    (lego_loam_tpu/run.py:128-163), message by message through jnp."""
    imu_rows = []
    for t, q, _w, acc in imu_msgs:
        R = np.asarray(ref_se3.quat_to_matrix(jnp.asarray(q)))
        r_, p_, y_ = np.asarray(ref_se3.matrix_to_euler_zyx(jnp.asarray(R)))
        imu_rows.append((t, r_, p_, y_, *acc))
    imu_rows = np.asarray(imu_rows, np.float64)
    odom_rows = [(t, np.asarray(ref_se3.quat_to_matrix(jnp.asarray(q))), np.asarray(pos))
                 for t, pos, q, _v, _w in odom_msgs]
    out = []
    for ts in stamps:
        sel = (imu_rows[:, 0] >= ts) & (imu_rows[:, 0] <= ts + sp)
        w = imu_rows[sel].copy()
        w[:, 0] -= ts
        k = min(range(len(odom_rows)), key=lambda i: abs(odom_rows[i][0] - ts))
        out.append((w.astype(np.float32), odom_rows[k][1], odom_rows[k][2]))
    return out


def test_rosbag_imu_and_odometry_streams(tmp_path):
    """The CLI's per-scan IMU window (samples within the scan period, times
    relative to its stamp, roll/pitch/yaw in float32) and nearest odometry
    pose (ties to the first) equal the reference CLI's."""
    import sqlite3

    from lego_loam_torch.io.rosbag2 import Rosbag2Reader

    rs = np.random.RandomState(8)
    xyz = rs.randn(3, 30, 3).astype(np.float32)
    stamps = [0.0, 0.1, 0.2]
    write_rosbag2(str(tmp_path), list(xyz), stamps)
    con = sqlite3.connect(str(tmp_path / "bag_0.db3"))
    con.execute("INSERT INTO topics VALUES (2, '/imu', 'sensor_msgs/msg/Imu', 'cdr', '')")
    con.execute("INSERT INTO topics VALUES (3, '/odom', 'nav_msgs/msg/Odometry', 'cdr', '')")
    for k in range(60):  # 200 Hz IMU over the three scans
        ns = 5_000_000 * k
        con.execute("INSERT INTO messages VALUES (?, 2, ?, ?)", (100 + k, ns, imu_blob(rs, 0, ns)))
    for k, ns in enumerate([20_000_000, 80_000_000, 120_000_000, 150_000_000, 190_000_000]):  # 0.08 and 0.12 straddle 0.1
        con.execute("INSERT INTO messages VALUES (?, 3, ?, ?)", (200 + k, ns, odom_blob(rs, 0, ns)))
    con.commit()
    con.close()

    args = argparse.Namespace(rosbag=str(tmp_path), topic="/velodyne_points", imu_topic="/imu", odom_topic="/odom")
    cfg = _cfg()
    got = list(run.rosbag_stream(args, cfg))
    rdr = Rosbag2Reader(str(tmp_path))
    want = _ref_cli_streams(list(rdr.messages("/imu")), list(rdr.messages("/odom")), stamps, cfg.laser.scan_period)
    rdr.close()
    assert [g[1] for g in got] == stamps
    for (pts, _t, imu, (R, p)), (w, Rw, pw), cloud in zip(got, want, xyz):
        np.testing.assert_array_equal(pts, cloud)
        assert imu.dtype == np.float32 and imu.shape == w.shape and len(w) >= 20
        np.testing.assert_array_equal(imu[:, [0, 4, 5, 6]], w[:, [0, 4, 5, 6]])
        np.testing.assert_allclose(imu[:, 1:4], w[:, 1:4], atol=1e-6, rtol=0)
        np.testing.assert_allclose(R, Rw, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(p, pw)


def test_cli_refusals(tmp_path, monkeypatch, capsys):
    """The multi-process flags parse and reach `launch.init_from_args`
    (which joins the group before any pipeline is built; --process-id alone
    joins nothing, as in the reference); without a GPU the default device
    is refused rather than replaced by the CPU."""
    from lego_loam_torch import launch

    calls = []

    class Joined(Exception):
        pass

    def init_from_args(*args, **kw):
        calls.append((args, kw))
        raise Joined

    with monkeypatch.context() as mp:
        mp.setattr(launch, "init_from_args", init_from_args)
        mp.setattr(run, "LegoLoamPipeline", None)  # never reached
        for argv in (["--coordinator", "localhost:1234", "--num-processes", "2", "--process-id", "1"],
                     ["--num-processes", "2"]):
            with pytest.raises(Joined):
                run.main(["--device", "cpu", "--synthetic", "1", "--out", str(tmp_path), *argv])
    assert calls == [(("localhost:1234", 2, 1), {"device": "cpu"}), ((None, 2, None), {"device": "cpu"})]
    assert run.parse_args(["--device", "cpu", "--synthetic", "1", "--process-id", "0"]).process_id == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run.main(["--synthetic", "1", "--out", str(tmp_path)])
    assert e.value.code != 0 and "--device cpu" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        run.main(["--device", "cpu", "--out", str(tmp_path)])
    assert e.value.code != 0
    assert not os.path.exists(tmp_path / "pose.txt")


def test_checkpoint_midrun_resume(fixtures, tmp_path):
    """tests/test_cli_e2e.py's kill-and-resume on the port: the KITTI
    fixture's scans saved after scan 2 and resumed in a fresh pipeline end
    within 2e-2 m of the uninterrupted CLI run's final map pose."""
    d, _ = fixtures
    cfg = _cfg()
    scans = [xyz for _, (xyz, _t) in zip(range(N), KittiSequence(str(d / "kitti" / "00")).scans())]
    a = LegoLoamPipeline(cfg, device="cpu")
    for i in range(2):
        a.process_scan(scans[i], 0.1 * i)
    ckpt = str(tmp_path / "state.npz")
    checkpoint.save(a, ckpt)
    del a
    b = checkpoint.load(LegoLoamPipeline(cfg, device="cpu"), ckpt)
    assert b.frame_idx == 2 and len(b.loop_factors) == 0
    for i in range(2, N):
        b.process_scan(scans[i], 0.1 * i)
    whole = np.loadtxt(d / "out_kitti" / "pose.txt")[-1, :3]
    np.testing.assert_allclose(b.bstate.t_map.numpy(), whole, atol=2e-2)


def test_stage_timer_and_device_trace():
    timer = StageTimer(sync=True)
    for _ in range(3):
        with timer.span("work", sync_on=torch.zeros(1)):
            time.sleep(0.002)
    assert timer.counts["work"] == 3 and timer.mean_ms("work") >= 2.0
    assert 0 < timer.hz("work") <= 500 and "work" in timer.report()
    assert timer.mean_ms("missing") == 0.0 and timer.hz("missing") == 0.0


def test_cli_imu_odometry_topics_and_resume(fixtures, tmp_path, capsys):
    """The rosbag2 run with --imu-topic and --odom-topic (undistortion and
    the "override" prior on) maps the fixture's scans with finite poses;
    --resume restores the KITTI run's checkpoint (frame 4) and replays the
    stream from its first scan."""
    import shutil
    import sqlite3

    d, _ = fixtures
    bag = tmp_path / "bag"
    shutil.copytree(d / "bag", bag)
    rs = np.random.RandomState(9)
    con = sqlite3.connect(str(bag / "bag_0.db3"))
    con.execute("INSERT INTO topics VALUES (2, '/imu', 'sensor_msgs/msg/Imu', 'cdr', '')")
    con.execute("INSERT INTO topics VALUES (3, '/odom', 'nav_msgs/msg/Odometry', 'cdr', '')")
    for k in range(3 * 20):  # 200 Hz over the first three scans
        con.execute("INSERT INTO messages VALUES (?, 2, ?, ?)", (100 + k, 5_000_000 * k, imu_blob(rs, 0, 5_000_000 * k)))
    for k in range(3):
        con.execute("INSERT INTO messages VALUES (?, 3, ?, ?)", (200 + k, 100_000_000 * k, odom_blob(rs, 0, 100_000_000 * k)))
    con.commit()
    con.close()
    _main(["--rosbag", str(bag), "--imu-topic", "/imu", "--odom-topic", "/odom", "--odom-prior-mode", "override",
           "--out", str(tmp_path / "imu"), "--max-frames", "3"])
    pose = np.loadtxt(tmp_path / "imu" / "pose.txt")
    assert pose.shape == (3, 7) and np.isfinite(pose).all()

    _main(["--kitti", str(d / "kitti" / "00"), "--resume", str(d / "state.npz"), "--out", str(tmp_path / "resumed"),
           "--max-frames", "1"])
    assert "resumed at frame 4" in capsys.readouterr().out
    assert np.loadtxt(tmp_path / "resumed" / "MapIterTimes.txt").size == 1
