"""Where the campus course drifts (port of `tools/diag_campus.py`): N frames
of the 3-lap course through `run_chunked`, the odometry and map poses of
each frame against the truth, the error by segment (straight or turn) and
the mapping step's diagnostics.

    python -m lego_loam_torch.diag_campus [--frames 352] [--chunk 16] [--loop]
    python -m lego_loam_torch.diag_campus --device cpu --frames 40 --straight 20 --turn 5 --chunk 8

Runs on the GPU unless --device cpu is given; without a visible GPU it
exits 2 with a message. The course is `lap_trajectory(3, straight, turn)`
cut to --frames in the `campus_world` of the whole course, frame i seeded
100 + i (the bench's render seeds), rendered in up to 8 spawned processes
and cached (`io/scan_cache.py`, tag campus). The configuration is `vlp16()`
with loop closure off unless --loop; --map-search-every,
--rebuild-every (and a rebuild distance of 0), --corner-weight and
--kf-gate (keyframe_gate_always off) set the mapping fields of
tools/diag_campus.py.

Prints scans/s (first use included), every 8th frame's segment, odometry
and map error, odometry and map z, the mapping step's smallest eigenvalue,
iterations, mean correspondence cost, submap corner and surf counts and
selected points (REJ where the step was rejected), with --loop the loop
checks, then the per-frame step error of the odometry on the first
straight, the first turn and the second straight. The trajectories go to
diag_traj_torch.npz in the temporary directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np
import torch

from . import cuda as kcuda
from .campus_run import RENDER_WORKERS, render_pool, render_swept
from .config import LegoLoamConfig, vlp16
from .io.scan_cache import get_or_render
from .io.synthetic import campus_world, lap_trajectory
from .pipeline import LegoLoamPipeline


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=352)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--straight", type=int, default=150)
    ap.add_argument("--turn", type=int, default=25)
    ap.add_argument("--loop", action="store_true")
    ap.add_argument("--no-map", action="store_true")  # parsed and unused, as in tools/diag_campus.py
    ap.add_argument("--map-search-every", type=int, default=None)
    ap.add_argument("--rebuild-every", type=int, default=None)
    ap.add_argument("--corner-weight", type=float, default=None)
    ap.add_argument("--kf-gate", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the GPU (default) or, when asked, on the CPU")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device is visible; pass --device cpu to run on the CPU")
    return args


def diag_config(args, base: LegoLoamConfig | None = None) -> LegoLoamConfig:
    """`base` (default `vlp16()`) with tools/diag_campus.py's mapping fields."""
    cfg = base or vlp16()
    mkw = dict(enable_loop_closure=args.loop)
    if args.map_search_every is not None:
        mkw["search_every"] = args.map_search_every
    if args.rebuild_every is not None:
        mkw["submap_rebuild_every"] = args.rebuild_every
        mkw["submap_rebuild_dist"] = 0.0
    if args.corner_weight is not None:
        mkw["corner_weight"] = args.corner_weight
    if args.kf_gate:
        mkw["keyframe_gate_always"] = False
    return dataclasses.replace(cfg, mapping=dataclasses.replace(cfg.mapping, **mkw))


def course(args, cfg: LegoLoamConfig):
    """(poses, render jobs) of the first --frames frames of the 3-lap course."""
    full = lap_trajectory(3, args.straight, args.turn)
    world = campus_world(full)
    poses = full[: args.frames]
    return poses, [(poses[i - 1] if i else poses[i], poses[i], cfg, world, 100 + i) for i in range(len(poses))]


def segment(k: int, straight: int, turn: int) -> str:
    return "turn" if (k % (straight + turn)) >= straight else "straight"


def segments(n: int, straight: int, turn: int) -> list:
    """(name, first frame, end frame) of each segment within n frames:
    straight1, turn1, straight2, turn2, ... (`lap_trajectory`'s sides:
    `straight` frames, then `turn`)."""
    out, count, lo = [], {"straight": 0, "turn": 0}, 0
    while lo < n:
        kind = segment(lo, straight, turn)
        hi = min(lo + (straight if kind == "straight" else turn), n)
        count[kind] += 1
        out.append((f"{kind}{count[kind]}", lo, hi))
        lo = hi
    return out


def step_errors(odom, gt):
    """The odometry's per-frame motion error |d_odom - d_gt|: entry k is
    the step from frame k to k + 1."""
    return np.linalg.norm(np.diff(np.asarray(odom), axis=0) - np.diff(np.asarray(gt), axis=0), axis=1)


def segment_steps(step, lo: int, hi: int):
    """The steps of a segment's frames lo..hi - 1 (steps from frame 1 on,
    cut where the drive ends)."""
    return step[max(lo, 1) : min(hi, len(step))]


def segment_step_errors(odom, gt, straight: int, turn: int) -> dict:
    """The odometry's step errors over the first straight (frames
    1..straight), the first turn and the second straight, each as (mean,
    max) in metres; a segment the drive does not reach is left out, one it
    reaches in part is cut there."""
    step = step_errors(odom, gt)
    out = {}
    for name, lo, hi in segments(len(step) + 1, straight, turn)[:3]:
        s = segment_steps(step, lo, hi)
        if len(s):
            out[name] = (float(s.mean()), float(s.max()))
    return out


def table(odom, est, gt, records, straight: int, turn: int) -> list[str]:
    """tools/diag_campus.py's per-frame table, every 8th frame."""
    rows = ["frame  seg        odom_err   map_err   z_odom   z_map  minlam  iters cf      sm_c  sm_s   nsel"]
    blank = {"min_lambda": np.nan, "iterations": -1, "cf_mean": np.nan, "rejected": False}
    for k in range(0, len(gt), 8):
        oe = np.linalg.norm(odom[k] - gt[k])
        me = np.linalg.norm(est[k] - gt[k]) if k < len(est) else float("nan")
        r = records[k] if k < len(records) else blank
        rows.append(
            f"{k:5d}  {segment(k, straight, turn):8s}  {oe:8.3f}  {me:8.3f}  {odom[k][2]:7.3f} "
            f"{est[k][2] if k < len(est) else np.nan:7.3f} "
            f"{r['min_lambda']:8.2f} {r['iterations']:3d} {r['cf_mean']:.4f}"
            f" {r.get('n_submap_corner', -1):5d} {r.get('n_submap_surf', -1):6d}"
            f" {r.get('n_sel', -1):5d}"
            f"{' REJ' if r.get('rejected') else ''}"
        )
    return rows


def run(args, log=print) -> dict:
    """Render (or load) the course, drive it, and return the trajectories,
    the mapping records, the loop checks, the segment statistics, scans/s
    and the kernels' launches over the drive."""
    cfg = diag_config(args)
    poses, jobs = course(args, cfg)
    n = len(poses)
    log(f"rendering {n} swept scans ...")
    with render_pool(RENDER_WORKERS) as pool:
        scans = get_or_render("campus", {"n": n, "straight": args.straight, "turn": args.turn, "laps": 3},
                              lambda: render_swept(jobs, pool))
    pipe = LegoLoamPipeline(cfg, device=args.device)
    kcuda.reset_counts()
    t0 = time.perf_counter()
    pipe.run_chunked(scans, chunk=args.chunk)
    dt = time.perf_counter() - t0
    gt = np.stack([t for _, t in poses])
    return {
        "frames": n, "scans_per_sec": n / dt, "gt": gt, "odom": np.asarray(pipe.odom_positions),
        "est": np.asarray(pipe.trajectory["positions"]), "records": pipe.diagnostics["records"],
        "loop_diag": pipe.loop_diag, "launches": dict(kcuda.LAUNCHES), "launches_by_site": dict(kcuda.SITES),
        "graph_stats": dict(pipe.graph_stats),
        "segments": segment_step_errors(pipe.odom_positions, gt, args.straight, args.turn),
    }


def report(args, res, out=print):
    """Print the run as tools/diag_campus.py prints it."""
    out(f"{res['scans_per_sec']:.1f} scans/s (incl compile)")
    out("")
    for row in table(res["odom"], res["est"], res["gt"], res["records"], args.straight, args.turn):
        out(row)
    if args.loop:
        acc = [d for d in res["loop_diag"] if d.get("accepted")]
        out(f"\nloop checks: {len(res['loop_diag'])}  accepted: {len(acc)}")
        for d in res["loop_diag"]:
            if d.get("cand", -1) >= 0:
                out(f"   {({k: (round(v, 3) if isinstance(v, float) else v) for k, v in d.items() if k != 'graph_cost'})}")
    for name, (mean, mx) in res["segments"].items():
        out(f"{name}: step err mean {mean * 100:.2f} cm  max {mx * 100:.2f} cm")


def main(argv=None) -> int:
    args = parse_args(argv)
    res = run(args, log=lambda msg: print(msg, flush=True))
    report(args, res)
    np.savez(os.path.join(tempfile.gettempdir(), "diag_traj_torch.npz"), est=res["est"], odom=res["odom"],
             gt=res["gt"], minlam=np.array([r["min_lambda"] for r in res["records"]]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
