"""Command-line runner — the launch-layer equivalent (port of
`lego_loam_tpu/run.py`).

≙ `ros2 launch lego_loam_sr run.launch.py lidar_type:=VLP-16`
(`launch/run.launch.py`) plus the offline KITTI service
(`imageProjection.cpp:224-299`):

    python -m lego_loam_torch.run --preset VLP-16 --kitti /path/to/seq --out out/
    python -m lego_loam_torch.run --preset VLP-16 --rosbag /path/to/bag --topic /velodyne_points
    python -m lego_loam_torch.run --preset VLP-16 --synthetic 100
    python -m lego_loam_torch.run --device cpu --synthetic 4 --max-frames 4

Runs on the GPU unless --device cpu is given; without a visible GPU it
exits non-zero rather than run on the CPU. Writes the reference-parity
artifact set (pose.txt, mapt.txt, MapIterTimes.txt, LocalInfo.txt) plus the
map PCDs to --out; with --profile also each scan's mapping time (mapt.txt),
a per-stage report and profile.json (stage means, scans/s and the CUDA
kernels' launch counts of the run).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from . import cuda as kcuda
from .config import get_config
from .pipeline import LegoLoamPipeline
from .utils.profiling import StageTimer, synchronize


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="VLP-16", choices=["VLP-16", "VLP-32c", "HDL-64E"])
    p.add_argument("--kitti", help="KITTI sequence dir (velodyne/*.bin)")
    p.add_argument("--rosbag", help="rosbag2 dir or .db3 file")
    p.add_argument("--topic", default="/velodyne_points")
    p.add_argument("--imu-topic", default=None, help="IMU topic (enables scan undistortion, ≙ /imu_type)")
    p.add_argument("--odom-topic", default=None, help="wheel-odometry topic (≙ /odom2)")
    p.add_argument("--odom-prior-mode", default="init", choices=["init", "override"],
                   help="how the odom prior is used when --odom-topic is set")
    p.add_argument("--synthetic", type=int, help="run N synthetic frames")
    p.add_argument("--out", default="out")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--loop-closure", action="store_true")
    p.add_argument("--no-map-update", action="store_true", help="reference's as-committed mapping ablation")
    p.add_argument("--checkpoint", help="save final state to this npz")
    p.add_argument("--resume", help="resume from a state npz (the stream is replayed from its first scan)")
    p.add_argument("--profile", action="store_true")
    # Re-localization mode (≙ ReMapping/HighDenseMapping launch flags +
    # /initialpose): localize the stream in a previously saved dense map.
    p.add_argument("--remap", help="saved map dir (denseCloud.pcd) to re-localize in instead of mapping")
    # The reference's multi-host entry; kept so its command lines parse.
    p.add_argument("--coordinator", help="multi-host coordinator addr:port (not ported yet)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the GPU (default) or, when asked, on the CPU")
    args = p.parse_args(argv)
    if args.coordinator or args.num_processes is not None or args.process_id is not None:
        p.error("multi-process runs (--coordinator/--num-processes/--process-id) wait for the sharded keyframe "
                "store that the default config asks for (shard_backend, ROADMAP §1 item 7)")
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device is visible; pass --device cpu to run on the CPU")
    if not (args.kitti or args.rosbag or args.synthetic):
        p.error("one of --kitti/--rosbag/--synthetic required")
    return args


def build_config(args):
    cfg = get_config(args.preset)
    mapping = cfg.mapping
    if args.loop_closure:
        mapping = dataclasses.replace(mapping, enable_loop_closure=True)
    if args.no_map_update:
        mapping = dataclasses.replace(mapping, enable_map_update=False)
    cfg = dataclasses.replace(cfg, mapping=mapping)
    if args.imu_topic:
        cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(cfg.pipeline, use_imu_undistortion=True))
    if args.odom_topic:
        cfg = dataclasses.replace(
            cfg, odometry=dataclasses.replace(cfg.odometry, odom_prior_mode=args.odom_prior_mode)
        )
    return cfg


def kitti_stream(seq_dir, cfg):
    """(points, t, None, None) per scan of a KITTI sequence, read and prepped
    by the native feeder in a background thread; scan k's time is 0.1 k."""
    from .io.kitti import KittiSequence
    from .native import ScanFeeder

    with ScanFeeder(KittiSequence(seq_dir).files, cap=cfg.laser.max_points) as feeder:
        while (item := feeder.next()) is not None:
            _idx, buf, mask, ts = item
            yield np.where(mask[:, None], buf, np.float32(np.nan)), ts, None, None


def _from_quats(quats):
    """(M, 4) wxyz quaternions -> ((M, 3) roll, pitch, yaw; (M, 3, 3)
    rotations) in float32, through the port's quat_to_matrix and
    matrix_to_euler_zyx on the host."""
    from .math import se3

    R = se3.quat_to_matrix(torch.from_numpy(np.asarray(quats, np.float32).reshape(-1, 4)))
    return torch.stack(se3.matrix_to_euler_zyx(R), dim=-1).numpy(), R.numpy()


def rosbag_stream(args, cfg):
    """(points, t, imu window, odom pose) per PointCloud2 message of a
    rosbag2 bag. The IMU window holds the samples within the scan's period,
    times relative to its stamp; the odometry pose is the message nearest
    in time (the first of equals)."""
    from .io.rosbag2 import Rosbag2Reader

    rdr = Rosbag2Reader(args.rosbag)
    try:
        imu_rows = np.zeros((0, 7))
        if args.imu_topic:
            msgs = list(rdr.messages(args.imu_topic))
            if msgs:
                rpy, _ = _from_quats([q for _t, q, _w, _a in msgs])
                imu_rows = np.concatenate(
                    [np.asarray([m[0] for m in msgs])[:, None], rpy, np.asarray([m[3] for m in msgs])], axis=1
                )
        odom_t, odom_R, odom_p = np.zeros(0), None, None
        if args.odom_topic:
            msgs = list(rdr.messages(args.odom_topic))
            if msgs:
                _, odom_R = _from_quats([q for _t, _p, q, _v, _w in msgs])
                odom_t = np.asarray([m[0] for m in msgs])
                odom_p = np.asarray([m[1] for m in msgs])

        def imu_window(ts):
            if not args.imu_topic or not len(imu_rows):
                return None
            sel = (imu_rows[:, 0] >= ts) & (imu_rows[:, 0] <= ts + cfg.laser.scan_period)
            w = imu_rows[sel].copy()
            w[:, 0] -= ts  # times relative to scan start
            return w.astype(np.float32)

        def odom_at(ts):
            if not args.odom_topic or not len(odom_t):
                return None
            k = int(np.argmin(np.abs(odom_t - ts)))
            return odom_R[k], odom_p[k]

        for t, xyz in rdr.scan_stream(args.topic):
            yield xyz, t, imu_window(t), odom_at(t)
    finally:
        rdr.close()


def synthetic_stream(n, cfg):
    from .io.synthetic import render_scan, straight_trajectory

    poses = straight_trajectory(n, speed=0.15, yaw_rate=np.deg2rad(1.0))
    for i, (R, t) in enumerate(poses):
        yield render_scan(R, t, cfg, noise=0.01, seed=i), i * 0.1, None, None


def scan_stream(args, cfg):
    if args.kitti:
        return kitti_stream(args.kitti, cfg)
    if args.rosbag:
        return rosbag_stream(args, cfg)
    return synthetic_stream(args.synthetic, cfg)


def _frames(stream, max_frames, timer):
    """The stream's items, at most max_frames (all when 0), each read timed
    as the "read" span; the stream is closed at the end."""
    n = 0
    try:
        while not max_frames or n < max_frames:
            with timer.span("read"):
                item = next(stream, None)
            if item is None:
                return
            n += 1
            yield item
    finally:
        stream.close()


def _write_profile(out_dir, timer, n, dt, device):
    """profile.json: per-stage mean ms, scans/s and the CUDA kernels'
    launches (by kernel and by call site) of this run."""
    os.makedirs(out_dir, exist_ok=True)
    prof = {
        "scans": n, "seconds": dt, "scans_per_s": n / max(dt, 1e-9),
        "stages_mean_ms": {k: timer.mean_ms(k) for k in sorted(timer.totals)},
        "launches": dict(kcuda.LAUNCHES), "launches_by_site": dict(kcuda.SITES),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    with open(os.path.join(out_dir, "profile.json"), "w") as f:
        json.dump(prof, f, indent=1)
    print(timer.report())
    print(f"kernel launches {prof['launches']}, by site {prof['launches_by_site']}")


def relocalize(args, cfg, device, timer):
    """Localization-only run against the saved dense map (≙ HighDense
    re-mapping, publishHighDenseMap.cpp:13-67): one submap at the origin,
    each scan localized from the previous scan's pose; relocalized.txt."""
    from .mapproducts import load_high_dense_map
    from .relocalize import localize_scan, map_state_from_cloud

    dense, _ = load_high_dense_map(os.path.join(args.remap, "denseCloud.pcd"))
    R_cur = torch.eye(3, device=device)
    t_cur = torch.zeros(3, device=device)
    traj = []
    kcuda.reset_counts()
    t0 = time.perf_counter()
    submap = map_state_from_cloud(dense, cfg, center=np.zeros(3, np.float32), device=device)
    for pts, _ts, _imu, _odom in _frames(scan_stream(args, cfg), args.max_frames, timer):
        with timer.span("localize", sync_on=t_cur):
            R_cur, t_cur, _diag = localize_scan(pts, submap, R_cur, t_cur, cfg)
        traj.append(t_cur)
    synchronize(t_cur)
    dt = time.perf_counter() - t0
    n = len(traj)
    print(f"localized {n} scans in {dt:.3f} s ({n / max(dt, 1e-9):.3f} scans/s)")
    os.makedirs(args.out, exist_ok=True)
    if traj:
        np.savetxt(os.path.join(args.out, "relocalized.txt"), torch.stack(traj).cpu().numpy())
    if args.profile:
        _write_profile(args.out, timer, n, dt, device)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    cfg = build_config(args)
    timer = StageTimer(sync=args.profile)
    if args.remap:
        return relocalize(args, cfg, device, timer)

    pipe = LegoLoamPipeline(cfg, device=device, profile=args.profile)
    if args.resume:
        from . import checkpoint

        checkpoint.load(pipe, args.resume)
        print(f"resumed at frame {pipe.frame_idx}")

    kcuda.reset_counts()
    t0 = time.perf_counter()
    n = 0
    for pts, ts, imu, odom in _frames(scan_stream(args, cfg), args.max_frames, timer):
        with timer.span("process_scan", sync_on=pipe.bstate.t_map):
            pipe.process_scan(pts, ts, imu_samples=imu, odom_pose=odom)
        n += 1
        if n % 100 == 0:
            print(f"frame {n} ({n / (time.perf_counter() - t0):.3f} scans/s)")
    synchronize(pipe.bstate.t_map)
    dt = time.perf_counter() - t0
    print(f"processed {n} scans in {dt:.3f} s ({n / max(dt, 1e-9):.3f} scans/s)")
    if args.profile:
        _write_profile(args.out, timer, n, dt, device)

    pipe.save_artifacts(args.out)
    from .mapproducts import save_map

    save_map(pipe.bstate, args.out, cfg)
    print(f"artifacts written to {args.out}")

    if args.checkpoint:
        from . import checkpoint

        checkpoint.save(pipe, args.checkpoint)
        print(f"state saved to {args.checkpoint}")


if __name__ == "__main__":
    sys.exit(main())
