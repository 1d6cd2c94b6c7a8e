"""Throughput of the full odometry + mapping + loop-closure path on one card
(port of `bench.py`), and with --ablate its per-component breakdown (port
of `tools/ablate_bench.py`).

    python -m lego_loam_torch.bench            # both courses: one JSON line
    python -m lego_loam_torch.bench --ablate   # seven variants of the straight course
    BENCH_WARMUP_CHUNKS=1 BENCH_CHUNKS=1 python -m lego_loam_torch.bench --device cpu --laps 1 --straight 1 --turn 5

Runs on the GPU unless --device cpu is given; without a visible GPU it
exits 2 with a message. The configuration is bench.py's: `vlp16()` with
loop closure on at 20,480 keyframes. Its two courses:

- straight: `straight_trajectory(n, speed=0.15, yaw_rate=0)`, n =
  (BENCH_WARMUP_CHUNKS + BENCH_CHUNKS) x BENCH_CHUNK frames (704 at the
  defaults 2, 20 and 32), swept renders with 1 cm range noise, frame i
  seeded 11 + i. It never revisits: the loop machinery is armed and idle.
- flagship ("value"): `lap_trajectory(laps, straight, turn)` (2, 150, 25)
  cut to a multiple of the chunk (1,376 frames) in the `campus_world` of
  those poses, frame i seeded 100 + i. Its second lap revisits the first,
  so attempts, accepted closures and graph solves land inside the timed
  region.

Renders run in up to 8 spawned processes and are cached (`io/scan_cache.py`,
tags bench_straight and bench_lap). Per course, a fresh pipeline and
`warmup_loop_closure`; the scans are packed (`_prep_many`) before timing;
the first BENCH_WARMUP_CHUNKS chunks run (the CUDA graphs are captured
there) and the device is synchronized; then the rest is timed, each chunk
staged one ahead through `stage_chunk_async`, the device synchronized at
the end. `finalize()` runs after the timed region, and only then are
attempts and closures counted (bench.py counts them with work still queued).
The straight course's pipeline is released before the flagship's is built.

The line has bench.py's keys (`vs_baseline` against the C++ reference's
50.16 ms mapping step, `Result/0318_test/mapt.txt`) plus `device` (the
card's name and power limit as nvidia-smi gives them, or "cpu") and the
flagship's `ate_map_m` (per-frame map poses) and `ate_corrected_kf_m`
(keyframes after the loop corrections) against its truth, no alignment.

--ablate: tools/ablate_bench.py's seven variants of the same configuration
(baseline, loop_off, rigid_scans, map_gn4, odo_iters10, map_div2, kf4096),
each a fresh pipeline over the straight course's first (BENCH_WARMUP_CHUNKS
+ 10) x BENCH_CHUNK scans (2 + 10 chunks of 32 at the defaults), timed as
above; one line {variant: scans/s} as each finishes,
then the dict of all seven. The straight course leaves its world's room
at frame ~133; `--ablate-course flagship` (the port's addition) runs the
variants over the flagship course's first frames instead, which stay
inside the campus world.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import os
import sys
import time

import numpy as np
import torch

from . import cuda as kcuda
from .campus_run import RENDER_WORKERS, device_name, render_pool, render_swept
from .config import LegoLoamConfig, vlp16
from .io.scan_cache import get_or_render
from .io.synthetic import World, campus_world, lap_trajectory, straight_trajectory
from .pipeline import LegoLoamPipeline
from .utils.metrics import ate_rmse
from .utils.profiling import synchronize

REFERENCE_SCANS_PER_SEC = 1000.0 / 50.16
# bench.py's keys, then the port's additions
LINE_KEYS = ("metric", "value", "unit", "vs_baseline", "straight_scans_per_sec", "lap_frames", "loop_attempts",
             "loop_closures", "device", "ate_map_m", "ate_corrected_kf_m")
ABLATE_CHUNKS = 10  # timed chunks of each --ablate variant


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ablate", action="store_true", help="time tools/ablate_bench.py's seven variants instead")
    ap.add_argument("--ablate-course", default="straight", choices=["straight", "flagship"],
                    help="--ablate over the straight course (tools/ablate_bench.py's) or the flagship's first frames")
    ap.add_argument("--laps", type=int, default=2, help="laps of the flagship course")
    ap.add_argument("--straight", type=int, default=150, help="frames of each straight side of a lap")
    ap.add_argument("--turn", type=int, default=25, help="frames of each corner turn of a lap")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the GPU (default) or, when asked, on the CPU")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device is visible; pass --device cpu to run on the CPU")
    args.chunk = int(os.environ.get("BENCH_CHUNK", "32"))
    args.warm = int(os.environ.get("BENCH_WARMUP_CHUNKS", "2"))
    args.chunks = int(os.environ.get("BENCH_CHUNKS", "20"))
    return args


def bench_config(base: LegoLoamConfig | None = None) -> LegoLoamConfig:
    """`base` (default `vlp16()`) with loop closure on at 20,480 keyframes,
    the configuration of bench.py's accuracy and speed figures."""
    cfg = base or vlp16()
    return dataclasses.replace(
        cfg, mapping=dataclasses.replace(cfg.mapping, enable_loop_closure=True, max_keyframes=20480))


def straight_course(n: int, cfg: LegoLoamConfig):
    """bench.py's straight course: (poses, render jobs) of n frames, frame i
    sweeping poses[i-1] -> poses[i] in the default world, seeded 11 + i
    (`swept_scan_sequence(poses, cfg, noise=0.01, seed=11)`)."""
    poses = straight_trajectory(n, speed=0.15, yaw_rate=0.0)
    world = World()
    return poses, [(poses[i - 1] if i else poses[i], poses[i], cfg, world, 11 + i) for i in range(n)]


def flagship_course(laps: int, straight: int, turn: int, chunk: int, cfg: LegoLoamConfig):
    """bench.py's flagship course: `lap_trajectory(laps, straight, turn)`
    cut to a multiple of `chunk`, in the `campus_world` of the cut poses,
    frame i seeded 100 + i. Returns (poses, render jobs)."""
    poses = lap_trajectory(laps, straight, turn)
    poses = poses[: len(poses) - len(poses) % chunk]
    world = campus_world(poses)
    return poses, [(poses[i - 1] if i else poses[i], poses[i], cfg, world, 100 + i) for i in range(len(poses))]


def render_course(tag: str, params: dict, jobs, pool=None):
    """The course's swept scans (1 cm range noise), from the scan cache or
    rendered (in `pool` when given)."""
    return get_or_render(tag, params, lambda: render_swept(jobs, pool))


def truth(poses) -> np.ndarray:
    return np.stack([t for _, t in poses])


def build_pipe(cfg: LegoLoamConfig, device="cuda") -> LegoLoamPipeline:
    pipe = LegoLoamPipeline(cfg, device=device)
    pipe.warmup_loop_closure()
    return pipe


def run_course(pipe: LegoLoamPipeline, prepped, n_warm_chunks: int, chunk: int) -> float:
    """Run the first chunks to warm up, then time the rest. Returns scans/s."""
    for c in range(n_warm_chunks):
        pipe.process_chunk(prepped[c])
    synchronize(pipe.bstate.t_map)

    n_meas_chunks = len(prepped) - n_warm_chunks
    t0 = time.perf_counter()
    nxt = pipe.stage_chunk_async(prepped[n_warm_chunks])
    for c in range(n_warm_chunks, len(prepped)):
        cur = nxt.result()
        if c + 1 < len(prepped):
            nxt = pipe.stage_chunk_async(prepped[c + 1])
        pipe.process_chunk(cur)
    synchronize(pipe.bstate.t_map)
    return n_meas_chunks * chunk / (time.perf_counter() - t0)


def loop_attempts(pipe: LegoLoamPipeline) -> int:
    return sum(1 for d in pipe.loop_diag if "icp_fitness" in d or "coarse_score" in d)


def course_record(pipe: LegoLoamPipeline, sps: float, gt: np.ndarray) -> dict:
    """A finalized drive's figures: scans/s, attempts and closures, the map
    ATE of the mapped frames and the corrected keyframe ATE against the
    truth `gt` (no alignment; frames by their times), and whether every
    output is finite."""
    period = pipe.cfg.laser.scan_period
    frame = lambda times: np.clip(np.rint(np.asarray(times) / period).astype(int), 0, len(gt) - 1)  # noqa: E731
    est = np.asarray(pipe.trajectory["positions"])
    _, kt, ktimes = pipe.keyframe_trajectory()
    finite = bool(np.isfinite(est).all() and np.isfinite(kt).all() and np.isfinite(pipe.odom_positions).all())
    return {"scans_per_sec": sps, "frames": len(gt), "loop_attempts": loop_attempts(pipe),
            "loop_closures": len(pipe.loop_factors),
            "ate_map_m": ate_rmse(est, gt[frame(pipe.trajectory["times"])], align=False),
            "ate_corrected_kf_m": ate_rmse(kt, gt[frame(ktimes)], align=False), "finite": finite,
            "graph_stats": dict(pipe.graph_stats)}


def measure_course(cfg: LegoLoamConfig, scans, gt: np.ndarray, n_warm_chunks: int, chunk: int,
                   device="cuda") -> dict:
    """`course_record` of a fresh pipeline through `run_course` then
    `finalize`, with the kernels' launches over it (counts added since the
    pipeline was built, warm-up chunks included). The pipeline is released
    before returning."""
    pipe = build_pipe(cfg, device)
    prepped = [pipe._prep_many(scans[s: s + chunk]) for s in range(0, len(scans), chunk)]
    launches, sites = collections.Counter(kcuda.LAUNCHES), collections.Counter(kcuda.SITES)
    sps = run_course(pipe, prepped, n_warm_chunks, chunk)
    pipe.finalize()
    rec = course_record(pipe, sps, gt)
    rec["launches"] = dict(collections.Counter(kcuda.LAUNCHES) - launches)
    rec["launches_by_site"] = dict(collections.Counter(kcuda.SITES) - sites)
    del pipe, prepped
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return rec


def bench_line(straight: dict, flagship: dict, device: str) -> dict:
    """bench.py's line from the two courses' records, plus the port's keys."""
    sps = flagship["scans_per_sec"]
    return {
        "metric": "scans_per_sec_per_chip",
        "value": sps,
        "unit": "scans/s",
        "vs_baseline": sps / REFERENCE_SCANS_PER_SEC,
        "straight_scans_per_sec": straight["scans_per_sec"],
        "lap_frames": flagship["frames"],
        "loop_attempts": flagship["loop_attempts"],
        "loop_closures": flagship["loop_closures"],
        "device": device,
        "ate_map_m": flagship["ate_map_m"],
        "ate_corrected_kf_m": flagship["ate_corrected_kf_m"],
    }


def course_scans(args, cfg: LegoLoamConfig, pool=None):
    """Both courses: ((straight poses, scans), (flagship poses, scans)).
    With --ablate only the course it runs over (the other None): the
    straight course whole (mode 1's cache), or the flagship's first
    (warm + ABLATE_CHUNKS) x chunk frames."""
    flagship = not args.ablate or args.ablate_course == "flagship"
    straight = None
    if not args.ablate or args.ablate_course == "straight":
        n_straight = (args.warm + args.chunks) * args.chunk
        s_poses, jobs = straight_course(n_straight, cfg)
        straight = (s_poses, render_course("bench_straight", {"n": n_straight, "v": 2}, jobs, pool))
    if not flagship:
        return straight, None
    l_poses, jobs = flagship_course(args.laps, args.straight, args.turn, args.chunk, cfg)
    if args.ablate:
        n = (args.warm + ABLATE_CHUNKS) * args.chunk
        l_poses, jobs = l_poses[:n], jobs[:n]
    params = {"n": len(l_poses), "straight": args.straight, "turn": args.turn, "laps": args.laps, "v": 2}
    return straight, (l_poses, render_course("bench_lap", params, jobs, pool))


def run(args, log=print):
    """The bench: both courses measured. Returns (the line, the two courses'
    records)."""
    device = torch.device(args.device)
    cfg = bench_config()
    t0 = time.perf_counter()
    with render_pool(RENDER_WORKERS) as pool:
        (s_poses, s_scans), (l_poses, l_scans) = course_scans(args, cfg, pool)
    log(f"bench: {len(s_scans)} straight and {len(l_scans)} flagship scans ready in {time.perf_counter() - t0:.1f} s")
    straight = measure_course(cfg, s_scans, truth(s_poses), args.warm, args.chunk, device)
    log(f"bench: straight {straight['scans_per_sec']:.3f} scans/s, map ATE {straight['ate_map_m']:.4f} m")
    flagship = measure_course(cfg, l_scans, truth(l_poses), args.warm, args.chunk, device)
    log(f"bench: flagship {flagship['scans_per_sec']:.3f} scans/s, {flagship['loop_attempts']} attempts, "
        f"{flagship['loop_closures']} closures, graphs {flagship['graph_stats']}")
    return bench_line(straight, flagship, device_name(device)), {"straight": straight, "flagship": flagship}


def ablation_configs(base: LegoLoamConfig) -> dict:
    """tools/ablate_bench.py's seven variants of `base`, in its order."""

    def m(**kw):
        return dataclasses.replace(base, mapping=dataclasses.replace(base.mapping, **kw))

    return {
        "baseline": base,
        "loop_off": m(enable_loop_closure=False),
        "rigid_scans": dataclasses.replace(base, pipeline=dataclasses.replace(base.pipeline, rigid_scans=True)),
        "map_gn4": m(max_gn_iterations=4),
        "odo_iters10": dataclasses.replace(base, odometry=dataclasses.replace(base.odometry, max_iterations=10)),
        "map_div2": m(mapping_frequency_divider=2),
        "kf4096": m(max_keyframes=4096),
    }


def measure(cfg: LegoLoamConfig, scans, gt: np.ndarray, chunk: int = 32, warm: int = 2, meas: int = 10,
            device="cuda") -> dict:
    """tools/ablate_bench.py's measure: the first (warm + meas) x chunk
    scans through `measure_course`."""
    n = (warm + meas) * chunk
    if len(scans) < n:
        raise ValueError(f"measure: {len(scans)} scans for {warm} + {meas} chunks of {chunk}")
    return measure_course(cfg, scans[:n], gt[:n], warm, chunk, device)


def ablate(base: LegoLoamConfig, scans, gt: np.ndarray, chunk: int, warm: int, meas: int, device="cuda",
           out=print) -> dict:
    """Every variant of `ablation_configs(base)` through `measure`, a line
    {name: scans/s} printed as each finishes. Returns {name: record}."""
    results = {}
    for name, cfg in ablation_configs(base).items():
        results[name] = measure(cfg, scans, gt, chunk, warm, meas, device)
        out(json.dumps({name: results[name]["scans_per_sec"]}))
    return results


def main(argv=None) -> int:
    args = parse_args(argv)
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731 (stdout holds the JSON lines)
    out = lambda line: print(line, flush=True)  # noqa: E731
    if args.ablate:
        cfg = bench_config()
        with render_pool(RENDER_WORKERS) as pool:
            straight, flagship = course_scans(args, cfg, pool)
        poses, scans = straight or flagship
        log(f"bench --ablate over the {args.ablate_course} course on {device_name(torch.device(args.device))}")
        res = ablate(cfg, scans, truth(poses), args.chunk, args.warm, ABLATE_CHUNKS, args.device, out)
        out(json.dumps({name: r["scans_per_sec"] for name, r in res.items()}))
        return 0
    line, _ = run(args, log)
    out(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
