"""rosbag2 (sqlite3) reader with minimal CDR deserialization (a numpy and
sqlite3 copy of `lego_loam_tpu/io/rosbag2.py`, which the port cannot import
without jax).

Replaces the reference's live DDS subscription path: the Jackal/Stevens
datasets are ROS bags (`README.md:77-111`); rosbag2 stores messages in a
sqlite database with CDR-encoded blobs. This reader handles the message
types the pipeline consumes — sensor_msgs/PointCloud2, sensor_msgs/Imu,
nav_msgs/Odometry — without any ROS dependency.
"""

from __future__ import annotations

import os
import sqlite3
import struct
from typing import Iterator

import numpy as np


class _CDR:
    """Little-endian CDR primitive reader (ROS2 default encapsulation)."""

    def __init__(self, buf: bytes):
        # 4-byte encapsulation header: {0x00, 0x01} = CDR_LE
        self.buf = buf
        self.off = 4

    def align(self, n):
        pad = (-(self.off - 4)) % n
        self.off += pad

    def u32(self):
        self.align(4)
        v = struct.unpack_from("<I", self.buf, self.off)[0]
        self.off += 4
        return v

    def i32(self):
        self.align(4)
        v = struct.unpack_from("<i", self.buf, self.off)[0]
        self.off += 4
        return v

    def u8(self):
        v = self.buf[self.off]
        self.off += 1
        return v

    def f64(self):
        self.align(8)
        v = struct.unpack_from("<d", self.buf, self.off)[0]
        self.off += 8
        return v

    def string(self):
        n = self.u32()
        s = self.buf[self.off : self.off + n - 1].decode("utf-8", "ignore")
        self.off += n
        return s

    def bytes_(self, n):
        b = self.buf[self.off : self.off + n]
        self.off += n
        return b


def _read_header(c: _CDR):
    stamp_sec = c.i32()
    stamp_nsec = c.u32()
    frame_id = c.string()
    return stamp_sec + stamp_nsec * 1e-9, frame_id


def parse_pointcloud2(blob: bytes):
    """Returns (t, xyz (N,3) float32 with NaN kept, intensity or None)."""
    c = _CDR(blob)
    t, _ = _read_header(c)
    height = c.u32()
    width = c.u32()
    nfields = c.u32()
    fields = []
    for _ in range(nfields):
        name = c.string()
        offset = c.u32()
        dtype = c.u8()
        count = c.u32()
        fields.append((name, offset, dtype, count))
    is_bigendian = c.u8()
    point_step = c.u32()
    row_step = c.u32()
    nbytes = c.u32()
    data = c.bytes_(nbytes)

    n = height * width
    raw = np.frombuffer(data[: n * point_step], np.uint8).reshape(n, point_step)

    def field_f32(name):
        for fname, off, dt, cnt in fields:
            if fname == name and dt == 7:  # FLOAT32
                return raw[:, off : off + 4].copy().view(np.float32).reshape(-1)
        return None

    x, y, z = field_f32("x"), field_f32("y"), field_f32("z")
    if x is None:
        raise ValueError("PointCloud2 without float32 x/y/z")
    xyz = np.stack([x, y, z], axis=1)
    return t, xyz, field_f32("intensity")


def parse_imu(blob: bytes):
    """Returns (t, orientation wxyz, angular_velocity, linear_acceleration)."""
    c = _CDR(blob)
    t, _ = _read_header(c)
    qx, qy, qz, qw = (c.f64() for _ in range(4))
    c.bytes_(0)
    # orientation_covariance float64[9]
    ori_cov = [c.f64() for _ in range(9)]
    wx, wy, wz = (c.f64() for _ in range(3))
    av_cov = [c.f64() for _ in range(9)]
    ax, ay, az = (c.f64() for _ in range(3))
    return (
        t,
        np.array([qw, qx, qy, qz]),
        np.array([wx, wy, wz]),
        np.array([ax, ay, az]),
    )


def parse_odometry(blob: bytes):
    """Returns (t, position, orientation wxyz, linear vel, angular vel)."""
    c = _CDR(blob)
    t, _ = _read_header(c)
    c.string()  # child_frame_id
    px, py, pz = (c.f64() for _ in range(3))
    qx, qy, qz, qw = (c.f64() for _ in range(4))
    pose_cov = [c.f64() for _ in range(36)]
    vx, vy, vz = (c.f64() for _ in range(3))
    wx, wy, wz = (c.f64() for _ in range(3))
    return (
        t,
        np.array([px, py, pz]),
        np.array([qw, qx, qy, qz]),
        np.array([vx, vy, vz]),
        np.array([wx, wy, wz]),
    )


_PARSERS = {
    "sensor_msgs/msg/PointCloud2": parse_pointcloud2,
    "sensor_msgs/msg/Imu": parse_imu,
    "nav_msgs/msg/Odometry": parse_odometry,
}


class Rosbag2Reader:
    """Iterate messages from a rosbag2 directory or .db3 file."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            db3 = [f for f in sorted(os.listdir(path)) if f.endswith(".db3")]
            if not db3:
                raise FileNotFoundError(f"no .db3 in {path}")
            path = os.path.join(path, db3[0])
        self.db = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
        self.topics = {}
        for tid, name, typ in self.db.execute(
            "SELECT id, name, type FROM topics"
        ):
            self.topics[name] = (tid, typ)

    def close(self):
        self.db.close()

    def messages(self, topic: str) -> Iterator[tuple]:
        tid, typ = self.topics[topic]
        parser = _PARSERS.get(typ)
        for (ts, blob) in self.db.execute(
            "SELECT timestamp, data FROM messages WHERE topic_id=? ORDER BY timestamp",
            (tid,),
        ):
            if parser is None:
                yield ts * 1e-9, blob
            else:
                yield parser(blob)

    def scan_stream(self, topic: str = "/velodyne_points"):
        """Yield (t, xyz) point clouds."""
        for t, xyz, _ in self.messages(topic):
            yield t, xyz
