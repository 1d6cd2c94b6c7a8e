"""Campus-scale validation run (port of `tools/campus_run.py`): a
multi-lap, multi-revisit drive of the flagship configuration (`vlp16()`,
loop closure on, 20,480 keyframes; optionally IMU undistortion and the
wheel-odometry prior with synthetic streams) over a building-dominated
campus world.

    python -m lego_loam_torch.campus_run [--laps 3] [--imu] [--odom] [--out out_campus_torch]
    python -m lego_loam_torch.campus_run --device cpu --laps 2 --straight 10 --turn 3 --chunk 8

Runs on the GPU unless --device cpu is given. The course is
`lap_trajectory(laps, straight, turn)` in a `campus_world` sized by the
perimeter; `--render-variants` noise instances of one lap are rendered
(cached by `io/scan_cache.py`, in up to 8 spawned processes) and tiled
across the laps, frame 0 of every later lap being the wrap sweep. The drive
is the chunk path: `warmup_loop_closure`, then per chunk of `--chunk`
scans `stage_chunk_async` (packing and upload in the pipeline's stager
thread, one chunk ahead) and `process_chunk`, a device synchronization
after chunk 0 and at the end (the steady state excludes chunk 0), and
`finalize`. Then one graph solve and one loop-closure attempt at the final
graph size are timed (CUDA events around a warm call), and the closures
are counted.

--noise-seed K renders the same course with other range noise and
--host-step runs the frame steps as the CPU runs them (host branching, no
CUDA graphs): the two ways to see how far a course's accuracy moves with
the last bits of its inputs or of its arithmetic.

With --probe-at, after the chunk that reaches each of those frame counts
one graph solve and one attempt are timed at the store's size, not applied
and left out of the drive's scans/s. The Stevens-scale configuration
(STEVENS_RUN.json's course; its loop settings are not in that record, see
README.md):

    python -m lego_loam_torch.campus_run --laps 8 --straight 600 --turn 25 --imu --odom \\
        --loop-cap 256 --time-gap 150 --radius 25 --probe-at 2000,10000,20000 \\
        --out out_stevens_torch --json-out STEVENS_RUN_torch.json

Writes --json-out (default CAMPUS_RUN_torch.json) with the keys of
tools/campus_run.py's record plus `device` (the card's name and power
limit as `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
gives them, or "cpu"), `peak_device_memory_gib` over the drive (null on
the CPU) and `latency_by_keyframes` (the probes), and under --out the run
artifacts (`save_artifacts`), the map (`save_map`), loop_diag.json (one
record per loop check) and launches.json (the kernels' launch counts over
the drive and the drain, and the CUDA graphs' statistics). `failed` is set when an output is not
finite or the map ATE does not beat the odometry's (or 1 m).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import cuda as kcuda
from .config import LegoLoamConfig, vlp16
from .distributed import all_rows
from .io.scan_cache import get_or_render
from .io.synthetic import campus_world, lap_trajectory, render_scan_swept, synth_imu_windows, synth_wheel_odom
from .mapproducts import save_map
from .pipeline import LegoLoamPipeline
from .posegraph import reduced_solve
from .utils.metrics import ate_rmse, rpe_rmse
from .utils.profiling import synchronize

SPEED = 0.12  # metres a frame of lap_trajectory
RENDER_WORKERS = min(8, os.cpu_count() or 1)  # processes rendering the laps


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--laps", type=int, default=3)
    ap.add_argument("--straight", type=int, default=150)
    ap.add_argument("--turn", type=int, default=25)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--out", default="out_campus_torch")
    ap.add_argument("--max-keyframes", type=int, default=20480)
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--imu", action="store_true", help="enable IMU undistortion with a synthetic stream")
    ap.add_argument("--odom", action="store_true",
                    help="enable the wheel-odometry prior (odom_prior_mode='init') with a synthetic stream")
    ap.add_argument("--render-variants", type=int, default=3, help="noise instances of the per-lap render to tile")
    ap.add_argument("--json-out", default="CAMPUS_RUN_torch.json")
    ap.add_argument("--stride", type=int, default=None, help="override mapping.posegraph_anchor_stride")
    ap.add_argument("--loop-cap", type=int, default=None, help="override mapping.max_loop_factors")
    ap.add_argument("--radius", type=float, default=None, help="override mapping.history_keyframe_search_radius")
    ap.add_argument("--time-gap", type=float, default=None,
                    help="override mapping.loop_time_gap (candidates must be at least this many seconds older)")
    ap.add_argument("--probe-at", default="",
                    help="comma-separated frame counts: after the chunk that reaches each, time one graph solve "
                         "and one loop-closure attempt at the store's size (not applied; left out of scans/s)")
    ap.add_argument("--noise-seed", type=int, default=0,
                    help="offset every render's noise seed by 100,000 times this (0: tools/campus_run.py's course)")
    ap.add_argument("--host-step", action="store_true",
                    help="run the frame steps with host branching and no CUDA graphs (sync_free=False), as on the CPU")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the GPU (default) or, when asked, on the CPU")
    args = ap.parse_args(argv)
    args.probe_at = sorted(int(x) for x in args.probe_at.split(",") if x)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device is visible; pass --device cpu to run on the CPU")
    return args


def campus_config(args, base: LegoLoamConfig | None = None) -> LegoLoamConfig:
    """`base` (default `vlp16()`) with the run's loop-closure, capacity,
    IMU and wheel-odometry settings, as tools/campus_run.py sets them."""
    cfg = base or vlp16()
    mkw = dict(enable_loop_closure=not args.no_loop, max_keyframes=args.max_keyframes)
    if args.stride:
        mkw["posegraph_anchor_stride"] = args.stride
    if args.loop_cap:
        mkw["max_loop_factors"] = args.loop_cap
    if args.radius:
        mkw["history_keyframe_search_radius"] = args.radius
    if args.time_gap:
        mkw["loop_time_gap"] = args.time_gap
    cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(cfg.mapping, **mkw))
    if args.imu:
        cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(cfg.pipeline, use_imu_undistortion=True))
    if args.odom:
        cfg = dataclasses.replace(cfg, odometry=dataclasses.replace(cfg.odometry, odom_prior_mode="init"))
    return cfg


@dataclasses.dataclass
class Course:
    """The course's true poses and its rendered laps: `variants[v]` holds
    frames 0..lap_len of one lap (frame lap_len is the wrap sweep
    p[lap_len - 1] -> p[0]), tiled across the laps by `scan`."""

    poses: list
    lap_len: int
    variants: list

    def scan(self, i):
        lap, k = divmod(i, self.lap_len)
        var = self.variants[lap % len(self.variants)]
        return var[self.lap_len] if lap > 0 and k == 0 else var[k]

    def truth(self, n):
        return np.stack([t for _, t in self.poses[:n]])


def _render(job):
    p0, p1, cfg, world, seed = job
    return render_scan_swept(p0, p1, cfg, world, noise=0.01, seed=seed)


def render_swept(jobs, pool=None):
    """Swept scans with 1 cm range noise, one per job (pose0, pose1, cfg,
    world, seed), in this process or in `pool` (each scan is seeded, so
    the result is the same)."""
    if pool is None:
        return [_render(j) for j in jobs]
    return pool.map(_render, jobs, chunksize=8)


def render_pool(workers: int):
    """A pool of `workers` spawned processes for `render_swept`, or a
    context that gives None when workers <= 1."""
    if workers <= 1:
        return contextlib.nullcontext()
    return multiprocessing.get_context("spawn").Pool(workers)


def build_course(args, cfg: LegoLoamConfig, workers: int = 1, log=print) -> Course:
    """The course of tools/campus_run.py: ~1 building every 10 m and a
    pillar every 6 m of perimeter, 1 cm range noise, variant v's frame i
    seeded 9000 v + 100 + i (plus 100,000 times --noise-seed). With
    workers > 1 the renders not in the cache run in that many spawned
    processes."""
    poses = lap_trajectory(args.laps, args.straight, args.turn)
    n = len(poses)
    lap_len = n // args.laps
    perimeter = lap_len * SPEED
    world = campus_world(
        lap_trajectory(1, args.straight, args.turn),
        n_buildings=max(14, int(perimeter / 10)),
        n_pillars=max(22, int(perimeter / 6)),
    )
    log(f"course: {n} frames, {args.laps} laps of {lap_len} (~{perimeter:.0f} m/lap, {len(world.boxes)} buildings)")
    t0 = time.perf_counter()
    variants = []
    with render_pool(workers) as pool:
        for v in range(max(1, args.render_variants)):
            jobs = [(poses[i - 1] if i > 0 else poses[i], poses[i % n], cfg, world,
                     9000 * v + 100 + i + 100_000 * args.noise_seed) for i in range(lap_len + 1)]
            params = {"lap_len": lap_len, "straight": args.straight, "turn": args.turn, "variant": v, "v": 2}
            if args.noise_seed:
                params["noise_seed"] = args.noise_seed
            variants.append(get_or_render("campus_lap", params, lambda jobs=jobs: render_swept(jobs, pool)))
    log(f"rendered in {time.perf_counter() - t0:.1f}s")
    return Course(poses=poses, lap_len=lap_len, variants=variants)


def run_course(pipe: LegoLoamPipeline, course: Course, chunk: int, imu=None, odom=None, log=print,
               probe_at=()) -> dict:
    """`warmup_loop_closure`, then the whole chunks of the course through
    `stage_chunk_async` + `process_chunk` (the next chunk staged while this
    one runs), then `finalize`. The kernels' launch counts are set to 0
    after the warm-up, and the device's peak memory is read over the drive.
    After the chunk that reaches each frame count of `probe_at`,
    `store_probe` times a solve and an attempt at the store's size; its
    seconds and launches are left out of the drive's. Returns the frames
    run, the steady and overall scans/s, the peak memory in GiB (None on
    the CPU) and the probes."""
    n = len(course.poses)
    n_run = n - n % chunk
    n_chunks = n_run // chunk

    def stage(s0):
        kw = {}
        if imu is not None:
            kw["imu"] = {k: v[s0 : s0 + chunk] for k, v in imu.items()}
        if odom is not None:
            kw["odom"] = (odom[0][s0 : s0 + chunk], odom[1][s0 : s0 + chunk])
        return pipe.stage_chunk_async([course.scan(i) for i in range(s0, s0 + chunk)], **kw)

    log("warming loop-closure machinery ...")
    t0 = time.perf_counter()
    pipe.warmup_loop_closure()
    log(f"warmed in {time.perf_counter() - t0:.1f}s")
    cuda = pipe.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(pipe.device)
        torch.cuda.reset_peak_memory_stats(pipe.device)
    kcuda.reset_counts()
    pending = list(probe_at)
    probes, paused = [], 0.0
    t_start = time.perf_counter()
    t_warm = None
    nxt = stage(0)
    for c in range(n_chunks):
        cur = nxt.result()
        if c + 1 < n_chunks:
            nxt = stage((c + 1) * chunk)
        pipe.process_chunk(cur)
        done = (c + 1) * chunk
        if c == 0:
            synchronize(pipe.bstate.t_map)
            t_warm = time.perf_counter()
        while pending and done >= pending[0]:
            pending.pop(0)
            synchronize(pipe.bstate.t_map)  # the chunk's own work stays on the drive's clock
            t0 = time.perf_counter()
            probes.append(store_probe(pipe))
            log(f"probe at frame {done}: {probes[-1]}")
            paused += time.perf_counter() - t0
        if (c + 1) % 20 == 0:
            log(f"frame {done}/{n_run} kf={int(pipe.bstate.n_kf)} loops={len(pipe.loop_factors)} "
                f"({(done - chunk) / (time.perf_counter() - t_warm - paused):.1f} scans/s)")
    synchronize(pipe.bstate.t_map)
    t_end = time.perf_counter() - paused
    pipe.finalize()
    steady = (n_run - chunk) / (t_end - t_warm) if n_chunks > 1 else float("nan")
    peak = torch.cuda.max_memory_allocated(pipe.device) / 2 ** 30 if cuda else None
    return {"frames": n_run, "scans_per_sec": steady, "scans_per_sec_incl_compile": n_run / (t_end - t_start),
            "peak_device_memory_gib": peak, "probes": probes}


def _timed_ms(fn, device) -> float:
    """ms of one warm call of fn: CUDA events around it on the card, the
    host clock on the CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def store_probe(pipe: LegoLoamPipeline) -> dict:
    """The keyframes in the store now, and the ms of one `reduced_solve`
    over it and of one loop-closure attempt of its newest keyframe against
    its oldest (CUDA events around a warm call), neither applied. The
    kernels' launch counts are left as they were."""
    counts = (collections.Counter(kcuda.LAUNCHES), collections.Counter(kcuda.SITES))
    bs = pipe.bstate
    n_kf = int(bs.n_kf)
    oldest, newest = int(bs.ordered_slots()[0]), (n_kf - 1) % bs.capacity
    rows = [all_rows(x) for x in (bs.kf_R, bs.kf_t, bs.kf_rel_R, bs.kf_rel_t)]
    solve_ms = _timed_ms(lambda: reduced_solve(*rows, bs.n_kf, pipe._loop_buf, pipe.cfg), pipe.device)
    attempt_ms = _timed_ms(lambda: pipe._attempt(oldest, newest, n_kf), pipe.device)
    kcuda.reset_counts()
    kcuda.add(counts)
    return {"keyframes": n_kf, "solve_ms": solve_ms, "attempt_ms": attempt_ms}


def latency_probe(pipe: LegoLoamPipeline):
    """`store_probe` at the final graph size, then the solve applied once
    by its cost gate, as tools/campus_run.py applies it. Returns (solve ms,
    attempt ms)."""
    probe = store_probe(pipe)
    pipe._dispatch_solve(None)
    pipe._pickup_solve()
    return probe["solve_ms"], probe["attempt_ms"]


def course_result(pipe: LegoLoamPipeline, course: Course, args, timing: dict, latency, device_name: str) -> dict:
    """tools/campus_run.py's record: map and odometry ATE of the per-frame
    logs (each pose as it was processed) and of the corrected keyframe
    store against the truth, no alignment; RPE over ~100 m of frames. Its
    keys are the tool's plus `device`, the drive's peak device memory and
    the store probes of `run_course`."""
    cfg = pipe.cfg
    n_run = timing["frames"]
    gt = course.truth(n_run)
    est = np.asarray(pipe.trajectory["positions"])
    odom_est = np.asarray(pipe.odom_positions)
    ate_map = ate_rmse(est, gt, align=False)
    ate_odom = ate_rmse(odom_est, gt, align=False)
    _, kt, ktimes = pipe.keyframe_trajectory()
    kf_frames = np.clip(np.rint(ktimes / cfg.laser.scan_period).astype(int), 0, n_run - 1)
    ate_corrected = ate_rmse(kt, gt[kf_frames], align=False)
    d100 = max(1, int(100.0 / SPEED))
    rpe_map = rpe_rmse(est, gt, delta=min(d100, len(est) - 1))
    rpe_odom = rpe_rmse(odom_est, gt, delta=min(d100, len(odom_est) - 1))
    finite = bool(np.isfinite(est).all()) and bool(np.isfinite(kt).all())
    solve_ms, attempt_ms = latency
    return {
        "frames": n_run,
        "scans_per_sec": timing["scans_per_sec"],
        "scans_per_sec_incl_compile": timing["scans_per_sec_incl_compile"],
        "keyframes_total": int(pipe.bstate.n_kf),
        "max_keyframes": cfg.mapping.max_keyframes,
        "loop_closures": len(pipe.loop_factors),
        "rejected_frames": pipe.diagnostics.get("rejected_frames", 0),
        "ate_map_m": ate_map,
        "ate_odom_only_m": ate_odom,
        "ate_corrected_kf_m": ate_corrected,
        "rpe_100m_map": rpe_map,
        "rpe_100m_odom": rpe_odom,
        "loop_solve_ms": solve_ms,
        "loop_attempt_ms": attempt_ms,
        "imu": bool(args.imu),
        "odom_prior": bool(args.odom),
        "finite": finite,
        "failed": (not finite) or not (ate_map < max(ate_odom, 1.0)),
        "laps": args.laps,
        "device": device_name,
        "peak_device_memory_gib": timing["peak_device_memory_gib"],
        "latency_by_keyframes": timing["probes"],
    }


def device_name(device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[device.index or 0]


def launch_record(pipe: LegoLoamPipeline) -> dict:
    """The kernels' launch counts since the last reset, and the graphs'
    statistics."""
    return {"launches": dict(kcuda.LAUNCHES), "launches_by_site": dict(kcuda.SITES),
            "graph_stats": dict(pipe.graph_stats)}


def write_outputs(pipe: LegoLoamPipeline, result: dict, launches: dict, out: str, json_out: str):
    """The artifacts and the map under `out`, the record to `json_out`,
    then loop_diag.json and launches.json under `out`."""
    pipe.save_artifacts(out)
    save_map(pipe.bstate, out, pipe.cfg)
    with open(json_out, "w") as f:
        json.dump(result, f, indent=1)
    with open(os.path.join(out, "loop_diag.json"), "w") as f:
        json.dump(pipe.loop_diag, f, indent=0)
    with open(os.path.join(out, "launches.json"), "w") as f:
        json.dump(launches, f, indent=1)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    log = lambda msg: print(msg, flush=True)  # noqa: E731
    cfg = campus_config(args)
    course = build_course(args, cfg, workers=RENDER_WORKERS, log=log)
    imu = synth_imu_windows(course.poses, cfg) if args.imu else None
    odom = synth_wheel_odom(course.poses, cfg) if args.odom else None
    pipe = LegoLoamPipeline(cfg, device=device, sync_free=False if args.host_step else None)
    timing = run_course(pipe, course, args.chunk, imu=imu, odom=odom, log=log, probe_at=args.probe_at)
    launches = launch_record(pipe)  # the drive's and the drain's, not the probe's
    latency = latency_probe(pipe)
    result = course_result(pipe, course, args, timing, latency, device_name(device))
    print(json.dumps(result), flush=True)
    write_outputs(pipe, result, launches, args.out, args.json_out)
    checks = [d for d in pipe.loop_diag if d["cand"] >= 0]
    if checks:
        fits = sorted(d["icp_fitness"] for d in checks if "icp_fitness" in d)
        log(f"loop checks with candidate: {len(checks)}; icp fitness min/median: "
            f"{(fits[0], fits[len(fits) // 2]) if fits else 'n/a'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
