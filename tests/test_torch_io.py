"""The port's input formats against the reference's readers, and the native
host library against its plain twins.

KITTI .bin scans and times.txt, rosbag2 PointCloud2 round trips and
hand-packed sensor_msgs/Imu and nav_msgs/Odometry CDR blobs parse to equal
values in both packages (exact: the same numpy arithmetic). The native
library (`native/lego_native.cpp`, built by the port with g++) is held
bit-equal to its plain twins: `prep_cloud`, `read_kitti_bin`,
`decode_pointcloud2` and the `ScanFeeder` stream (indices in order,
timestamps 0.1 k, None at the end)."""

import os
import struct
import sys
import time

import numpy as np
import pytest

from lego_loam_tpu.io import kitti as ref_kitti
from lego_loam_tpu.io import rosbag2 as ref_rosbag2
from lego_loam_torch import native
from lego_loam_torch.io import kitti, rosbag2

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_fixtures import make_pointcloud2_blob, write_rosbag2  # noqa: E402


def _cdr_string(s):
    b = s.encode() + b"\x00"
    return struct.pack("<I", len(b)) + b


class _Packer:
    """Little-endian CDR writer: primitives aligned to their size from the
    end of the 4-byte encapsulation header."""

    def __init__(self):
        self.buf = b"\x00\x01\x00\x00"

    def _align(self, n):
        self.buf += b"\x00" * ((-(len(self.buf) - 4)) % n)

    def header(self, sec, nsec, frame):
        self._align(4)
        self.buf += struct.pack("<iI", sec, nsec)
        self.buf += _cdr_string(frame)

    def string(self, s):
        self._align(4)
        self.buf += _cdr_string(s)

    def f64(self, *vals):
        for v in vals:
            self._align(8)
            self.buf += struct.pack("<d", v)


def imu_blob(rs, sec=3, nsec=250_000_000):
    """sensor_msgs/Imu: header, orientation (x, y, z, w), its covariance,
    angular velocity, its covariance, linear acceleration, its covariance."""
    p = _Packer()
    p.header(sec, nsec, "imu_link")
    p.f64(*rs.randn(4), *rs.randn(9), *rs.randn(3), *rs.randn(9), *rs.randn(3), *rs.randn(9))
    return p.buf


def odom_blob(rs, sec=4, nsec=5):
    """nav_msgs/Odometry: header, child_frame_id, pose (position,
    orientation x, y, z, w, 36 covariances), twist (linear, angular, 36
    covariances)."""
    p = _Packer()
    p.header(sec, nsec, "odom")
    p.string("base_link_x")  # odd length: the doubles after it need padding
    p.f64(*rs.randn(3), *rs.randn(4), *rs.randn(36), *rs.randn(3), *rs.randn(3), *rs.randn(36))
    return p.buf


def _equal_tuples(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("make, parse", [(imu_blob, "parse_imu"), (odom_blob, "parse_odometry")])
def test_cdr_messages_parse_alike(make, parse):
    """Hand-packed Imu and Odometry blobs give the same tuples in both
    packages (the reference's alignment: 9- and 36-element covariances)."""
    rs = np.random.RandomState(3)
    for _ in range(3):
        blob = make(rs)
        ours, ref = getattr(rosbag2, parse)(blob), getattr(ref_rosbag2, parse)(blob)
        _equal_tuples(ours, ref)
    want_t = 3.25 if make is imu_blob else 4 + 5e-9
    assert ours[0] == ref[0] and abs(ours[0] - want_t) < 1e-12


def _bag_with_everything(path, rs):
    """A bag with PointCloud2, Imu and Odometry topics (messages inserted out
    of time order, so ORDER BY timestamp matters)."""
    import sqlite3

    xyz = rs.randn(2, 40, 3).astype(np.float32)
    write_rosbag2(path, list(xyz), [0.0, 0.1])
    con = sqlite3.connect(os.path.join(path, "bag_0.db3"))
    con.execute("INSERT INTO topics VALUES (2, '/imu', 'sensor_msgs/msg/Imu', 'cdr', '')")
    con.execute("INSERT INTO topics VALUES (3, '/odom', 'nav_msgs/msg/Odometry', 'cdr', '')")
    con.execute("INSERT INTO topics VALUES (4, '/other', 'std_msgs/msg/String', 'cdr', '')")
    for k, ns in enumerate([30, 10, 20]):
        con.execute("INSERT INTO messages VALUES (?, 2, ?, ?)", (10 + k, ns, imu_blob(rs, 0, ns)))
        con.execute("INSERT INTO messages VALUES (?, 3, ?, ?)", (20 + k, ns, odom_blob(rs, 0, ns)))
    con.execute("INSERT INTO messages VALUES (30, 4, 7, ?)", (b"raw",))
    con.commit()
    con.close()
    return xyz


def test_rosbag2_round_trip(tmp_path):
    """A written bag reads back alike through both readers: the clouds, the
    IMU and odometry messages in time order, an unknown type as raw bytes."""
    rs = np.random.RandomState(4)
    xyz = _bag_with_everything(str(tmp_path), rs)
    ours, ref = rosbag2.Rosbag2Reader(str(tmp_path)), ref_rosbag2.Rosbag2Reader(str(tmp_path))
    try:
        assert ours.topics == ref.topics
        clouds = list(ours.scan_stream("/velodyne_points"))
        assert [t for t, _ in clouds] == [t for t, _ in ref.scan_stream("/velodyne_points")] == [0.0, 0.1]
        for (_, got), want in zip(clouds, xyz):
            np.testing.assert_array_equal(got, want)
        for topic in ("/imu", "/odom", "/other"):
            a, b = list(ours.messages(topic)), list(ref.messages(topic))
            assert len(a) == len(b) == (1 if topic == "/other" else 3)
            for x, y in zip(a, b):
                _equal_tuples(x, y)
        assert [m[0] for m in ours.messages("/imu")] == [k * 1e-9 for k in (10, 20, 30)]
    finally:
        ours.close()


def test_pointcloud2_blob_parses_alike():
    rs = np.random.RandomState(5)
    xyz = rs.randn(100, 3).astype(np.float32)
    xyz[7] = np.nan
    blob = make_pointcloud2_blob(xyz, rs.rand(100).astype(np.float32), 12, 34)
    a, b = rosbag2.parse_pointcloud2(blob), ref_rosbag2.parse_pointcloud2(blob)
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])


def test_kitti_sequence_alike(tmp_path):
    rs = np.random.RandomState(2)
    seq = tmp_path / "00"
    (seq / "velodyne").mkdir(parents=True)
    pts = rs.randn(3, 200, 4).astype(np.float32)
    for i in range(3):
        pts[i].tofile(seq / "velodyne" / f"{i:06d}.bin")
    np.savetxt(seq / "times.txt", [0.0, 0.1, 0.2])
    ours, ref = kitti.KittiSequence(str(seq)), ref_kitti.KittiSequence(str(seq))
    assert len(ours) == len(ref) == 3
    np.testing.assert_array_equal(ours.times, ref.times)
    for (a, ta), (b, tb) in zip(ours.scans(), ref.scans()):
        np.testing.assert_array_equal(a, b)
        assert ta == tb
    np.testing.assert_array_equal(ours[1], pts[1])
    os.remove(seq / "times.txt")
    assert [t for _, t in kitti.KittiSequence(str(seq)).scans()] == [0.0, 0.1, 0.2]


# -- the native library ---------------------------------------------------


def test_native_builds_from_source_not_the_tracked_library():
    assert native.available()
    assert native.LIBRARY.parent.name == "_build" and native.SOURCE.name == "lego_native.cpp"
    assert native.LIBRARY.stat().st_mtime >= native.SOURCE.stat().st_mtime


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "lib" / "libbroken.so")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        native.build()
    assert not (tmp_path / "lib" / "libbroken.so").exists()


@pytest.mark.parametrize("cap", [50, 300, 1000])
def test_prep_cloud_equals_twin(cap):
    """Rows with any non-finite coordinate are zeroed and masked off;
    truncation and padding at cap."""
    rs = np.random.RandomState(cap)
    pts = rs.randn(300, 4).astype(np.float32) * 30
    pts[3, 0], pts[9, 2], pts[11, 1], pts[12] = np.nan, np.inf, -np.inf, np.nan
    (a, am), (b, bm) = native.prep_cloud(pts, cap), native.prep_cloud_plain(pts, cap)
    assert a.dtype == b.dtype == np.float32 and am.dtype == bm.dtype == bool
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(am, bm)
    assert int(bm.sum()) == min(cap, 300) - sum(i < cap for i in (3, 9, 11, 12))


def _kitti_files(tmp_path, rs, sizes=(300, 301, 5, 0, 302)):
    files = []
    for i, n in enumerate(sizes):
        raw = (rs.randn(n, 4) * 20).astype(np.float32)
        raw[::17, 1] = np.nan
        p = tmp_path / f"{i:06d}.bin"
        raw.tofile(p)
        files.append(str(p))
    with open(files[1], "ab") as f:
        f.write(b"\x00" * 6)  # a partial record at the end is ignored
    return files


def test_read_kitti_bin_equals_twin(tmp_path):
    files = _kitti_files(tmp_path, np.random.RandomState(0))
    for f in files:
        for cap in (4, 300, 1 << 18):
            np.testing.assert_array_equal(native.read_kitti_bin(f, cap), native.read_kitti_bin_plain(f, cap))
    with pytest.raises(FileNotFoundError):
        native.read_kitti_bin(str(tmp_path / "missing.bin"))


def test_scan_feeder_equals_twin(tmp_path):
    """The feeder's stream equals the plain twin's, a missing file skipped
    (its index taken by the next readable one), then None."""
    files = _kitti_files(tmp_path, np.random.RandomState(1))
    files.insert(2, str(tmp_path / "missing.bin"))
    cap = 301
    with native.ScanFeeder(files, cap, depth=2) as feeder:
        plain = native.ScanFeederPlain(files, cap)
        n = 0
        while True:
            a, b = feeder.next(), plain.next()
            if a is None:
                assert b is None
                break
            assert a[0] == b[0] == n and a[3] == b[3] == 0.1 * n
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_array_equal(a[2], b[2])
            n += 1
        assert n == len(files) - 1
        assert feeder.next() is None
    with pytest.raises(RuntimeError, match="closed"):
        feeder.next()


def test_latest_wins_feeder_keeps_the_newest(tmp_path):
    """latest_wins drops the oldest queued scans: a consumer that starts
    after the producer finished sees the last `depth` scans, in order."""
    files = _kitti_files(tmp_path, np.random.RandomState(2), sizes=(50,) * 6)
    with native.ScanFeeder(files, 64, latest_wins=True, depth=2) as feeder:
        time.sleep(1.0)
        got = []
        while (item := feeder.next()) is not None:
            got.append(item[0])
    assert got == [4, 5]


def test_decode_pointcloud2_equals_twin_and_the_parser():
    rs = np.random.RandomState(6)
    xyz = rs.randn(64, 3).astype(np.float32)
    blob = make_pointcloud2_blob(xyz, rs.rand(64).astype(np.float32), 1, 2)
    _, want, _ = rosbag2.parse_pointcloud2(blob)
    payload = blob[-64 * 16:]
    a = native.decode_pointcloud2(payload, 64, 16, 0, 4, 8)
    np.testing.assert_array_equal(a, native.decode_pointcloud2_plain(payload, 64, 16, 0, 4, 8))
    np.testing.assert_array_equal(a, want)
    with pytest.raises(ValueError):
        native.decode_pointcloud2(payload[:-5], 64, 16, 0, 4, 8)  # z of the last record cut
