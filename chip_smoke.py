#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`lego_loam_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing a progress line:
  1. the card's name and power limit (nvidia-smi);
  2. build both CUDA kernels from `lego_loam_torch/csrc/` (one nvcc each,
     in parallel) and print the seconds taken and ptxas's register report,
     then the native host library from `native/lego_native.cpp` (g++);
  3. K1 (connected components) against its plain twin at the three
     presets' heights: bit-equal on full-width scans of `vlp16()` (16 x
     1800), `vlp32c()` (32 x 1800) and `hdl64e()` (64 x 1800), one more
     round of the twin changes nothing, and a comb through every pixel
     labels to 0;
  4. K2 (5-NN) against its plain twin: the three cases of
     tests/test_pallas_knn.py and the main path's shapes (d2 within 1e-3,
     index match >= 0.999, empty slots equal), including groups=16; and, the
     same way, the clouds of one real call at each of the four call sites,
     recorded in the slice's warm-up run (these clouds are ordered along
     the scan, unlike the random ones);
  5. the slice: `vlp16()` at full width over 32 swept scans of a straight
     drive through `LegoLoamPipeline.run_chunked`, its frame steps captured
     as CUDA graphs (the default): map ATE < 0.1 m, every output finite,
     both kernels launched on the path and K2 at all four call sites
     (odometry and mapping, corner and surf clouds; a captured launch
     counted at each replay), the steps captured and replayed with no
     recapture; the same scans with `graphs=False` (staged chunk by chunk,
     the second chunk of 16 under `torch.cuda.set_sync_debug_mode("error")`:
     no synchronizing call inside it): map, odometry and fused positions
     and map attitudes bit-identical; then the per-scan entry point, `run` over its
     first 4 scans through `process_scan` (float32 points projected on the
     card, the same graphs at C = 1), with the same checks;
  5b. the keyframe ring past capacity (tests/test_backend.py:182's checks):
     the slice's 32 scans with `max_keyframes=8`, loop closure on and
     anchors every 4 keyframes, graphed: 32 keyframes appended, the 8
     resident slots in time order with the newest at 3.1 s, map ATE
     < 0.15 m, K1 and K2 launched, the steps replayed across the wraps with
     no recapture, and a chain-only `_optimize_graph` moving the newest
     pose < 0.05 m;
  6. short drives of `vlp32c()` and `hdl64e()` at full width, 8 scans each
     in one chunk with loop closure off (the settings of
     tests/test_presets_e2e.py at the presets' own capacities): finite
     output, map-position error < 0.5 m at every scan, K1 launched;
  6b. the reference's ablation switches (`full_dof_odometry`,
     `enable_map_update=False`, `ground.use_ours=False`,
     `features.use_ours=False`, `use_shadow_points=False`,
     `feed_mode="points"`), each set on `vlp16()` over the slice's first 8
     scans in one chunk, graphed: finite output, K1 and K2 at the odometry
     sites launched, map ATE < 0.1 m (no map update: map equals odometry
     within 1e-5 m; full DOF: the largest odometry position error < 1.5
     m); `full_dof_odometry` again with `graphs=False`, bit-identical, and
     its graphed step's steady state beside the plain one's;
  6c. `python -m lego_loam_torch.bench` in this process, its straight
     course at BENCH_WARMUP_CHUNKS=1 BENCH_CHUNKS=1 (64 swept scans,
     `bench.measure_course`: finite output, map ATE < 0.1 m, K1 and K2
     launched, no attempt, no recapture), then `--ablate` over the same
     scans with one warm and one timed chunk (`bench.ablate`, seven
     variants, each: finite output, map ATE < 0.1 m or twice the port's
     CPU rehearsal where that is above 0.05 m, K1 and K2 launched, no
     recapture); the bench's flagship part is phase 7's drive, and the
     bench's line (bench.py's keys and the port's, at least one attempt,
     finite values) is made from the two after phase 7;
  7. the loop-closing drive: bench.py's flagship configuration (`vlp16()`,
     loop closure on, 20,480 keyframes, the rest at its defaults) over
     448 swept scans of a campus lap course (laps of 340 frames, one lap
     and 108 revisit frames; rendered in up to 8 spawned processes)
     through `warmup_loop_closure` and the bench's timed loop
     (`bench.run_course`, chunks of 32, one warm): at least one attempt, one accepted closure
     and one applied graph solve, finite output, the corrected keyframe
     ATE < 0.5 m and at most the uncorrected map ATE + 0.05 m, K1 and K2
     (also at loop_icp) launched; then K2 on one real loop_icp call's
     clouds against its twin and a float64 brute force, each tolerance
     that pair's own float32 rounding, the attempt's and the solve's
     times, and `reduced_solve` on the card against the same call on the
     CPU; then the lap's final state (`checkpoint.save`) loaded into a
     fresh pipeline, graphed and with `graphs=False`, each continued over
     the course's next 32 scans (frames 448-479, revisiting; 64 until the
     script grew by phases 5b, 6c and 7k): at least one attempt each and
     the final keyframes bit-identical (the applied solves and
     `checkpoint.load` write the state in place);
  7b. the IMU lap: the same 448 scans with the lap's configuration plus
     `use_imu_undistortion=True` and `odom_prior_mode="init"`, 200 Hz IMU
     windows and a wheel-odometry stream made from the course's poses,
     driven as tools/campus_run.py drives it (`warmup_loop_closure`, then
     `stage_chunk_async(..., imu=, odom=)` and `process_chunk` per chunk of
     32, then `finalize`): the lap's checks, and an odometry ATE below the
     plain lap's; then `integrate_imu` + `undistort_to` of one turning
     frame's window and segmented cloud on the card against the CPU;
  7c. the product entry point: tools/make_fixtures.py's course (64 swept
     scans of a straight drive at 0.2 m a scan) written as a KITTI sequence
     and a rosbag2 bag, and `python -m lego_loam_torch.run --profile` over
     each in a child process on the card (the KITTI run through the native
     feeder, with --checkpoint): exit 0, the artifact set, map ATE < 0.1 m,
     both kernels launched (counted by each run, profile.json);
  7d. checkpoint/resume through the API at full width: a run saved at scan
     32 and resumed in a fresh pipeline ends within 2e-2 m of the
     uninterrupted run; save -> load -> save bit-equal; the CLI's file
     loads;
  7e. re-localization: `--remap` on the KITTI run's map over the rosbag2
     stream (< 0.1 m from the mid-sweep truth), and `localize_scan` from a
     0.3 m / 3 deg perturbed start (< 0.12 m, < 1 deg), K1 and K2 launched;
  7f. the native library (g++ from native/lego_native.cpp) against its
     plain twins on the fixture's scans: prep_cloud and the ScanFeeder
     stream bit-equal;
  7g. the ESKF study: `run_eskf` over a generated 300-tick turn on the
     card and, in a spawned process meanwhile, on the CPU (positions
     within 1e-3 m, RMSE < 0.1 m), timed;
  7h. the multi-device solves, in a child process started through
     `launch.spawn_local(..., n_processes=1)`: rank 0 of a world of one
     over NCCL (real collectives of size 1). On the lap's final store
     (saved with `checkpoint.save` at the end of phase 7, 20,480
     keyframes, its factors assembled by the pipeline's own
     `_graph_factors`): `sharded_pose_graph_solver` against
     `solve_pose_graph` (within 1e-4), `schur_pose_graph_solver` ("auto")
     against `reduced_solve` (within 2e-2 m), and at 64 keyframes of a
     drifted circle the "dense" Schur solve against `reduced_solve`; one
     real mapping call's clouds (recorded in the slice's warm-up) through
     `sharded_map_gn_step` on the card against the same call on the CPU
     (gloo; within 1e-4 m and 1e-4 rad), K2 launched at `mapping_sharded`
     and held against its twin; each solver, `reduced_solve` and the step
     run twice, bit-identical; `build_grid` + `query_knn` over that call's
     32,768-slot surf submap with its 4,096 queries against K2 (recall
     > 0.98 where the 5th neighbour lies within the 1 m cell); the NCCL
     set-up and each solve timed; `weak_scaling.measure` (tools/
     weak_scaling.py's problem at 2,048 poses, stride 16, "pcg"): finite
     poses, its time and collective bytes, and the same solve on the CPU
     over gloo within 2e-2 m;
  7i. the sharded keyframe store, in phase 7h's NCCL rank (world size 1):
     the slice's 32 scans through `run_chunked` with the store laid out in
     row blocks right after construction (`distributed.
     shard_backend_state`): map, odometry and fused poses and map attitudes
     bit-identical to phase 5's unsharded run, map ATE < 0.1 m, K2 launched
     at mapping_corner and mapping_surf, the state's bytes on the rank
     printed; the lap's saved state loaded into a sharded pipeline and
     continued over the lap course's next 32 frames (448-479, revisiting):
     at least one attempt on the sharded store, final keyframe poses
     bit-identical to the unsharded continuation of phase 7 (graphed), K2
     launched at loop_icp; the CLI
     joining a group of one (--coordinator, --num-processes 1,
     --process-id 0) over 7c's KITTI fixture: exit 0 and 7c's pose.txt;
     each part timed;
  7j. the campus course: `python -m lego_loam_torch.campus_run --laps 2
     --render-variants 2` (tools/campus_run.py's laps of 700 frames, 1,376
     frames run in chunks of 32, loop closure on, 20,480 keyframes; 2 noise
     variants of the lap rendered in up to 8 spawned processes) in a child
     process on the card: exit 0,
     `failed` false, `finite` true, 1,376 frames, at least 2 closures, the
     corrected keyframe ATE < 0.5 m and at most the map ATE + 0.05 m, the
     record's keys CAMPUS_RUN.json's plus `device`, the peak device memory
     and the store probes, K1 and K2 (also at
     loop_icp) launched over the drive; the record printed beside the
     reference's CAMPUS_RUN.json accuracy, which gates nothing;
  7k. `python -m lego_loam_torch.diag_campus --frames 336` in this process
     (the 3-lap course's first straight, turn and second straight, chunks
     of 16, loop closure off): its table and step-error lines printed,
     finite positions, all three segments reached, K1 and K2 launched,
     no recapture;
  7l. the Stevens-scale store without its drive: the flagship
     configuration with 256 loop factors over 20,000 keyframes of a
     drifted 8-lap chain (`store_chain`, 196 true loop factors, 28 a
     revisiting lap), the pipeline's pose-graph solve (`_dispatch_solve`)
     on the card under `torch.cuda.set_sync_debug_mode("error")` against
     the same solve on the CPU (positions within 2e-2 m, both accepted,
     nearer the truth than the chain), one reduced solve timed; then a
     chain four times as far off, both solves accepted and within 0.5 m
     (ATE) of the truth;
  8. the frame step in its steady state, graphed, eager (`graphs=False`)
     and host-branching (`sync_free=False`): after warm chunks of 4 (two
     graphed, for the captures; eager: one chunk of 2, not 4, since phase 7l), one
     chunk timed, one under `set_sync_debug_mode("warn")` (host
     synchronizations a frame) and one under torch.profiler (device time
     and device kernels per scan, the device's busy share, the costliest
     kernels; "not measured" where the profiler cannot trace the card);
  9. times with CUDA events after warm-up: K1 on a 16-scan chunk at each
     height and K2 at the path's shapes (loop_icp's and mapping_sharded's
     included), a call (host included) and the
     device's time alone (the host's share hidden behind a sleep kernel),
     each beside its twin and its bound (and, for K2, torch.cdist +
     torch.topk, a yardstick the port never calls), and K2 at the mapping
     sites' row-block shapes over 2 and 4 ranks; the slice's scans/s and
     peak memory; a line of the graphs' captures, replays, recaptures and
     capture seconds and of scans/s, busy share and host synchronizations
     a frame, graphed against eager.

Prints one JSON line of kernel records, then `{"ok": true, ...}` last.
Exits non-zero on any failure, or at once when no CUDA device is visible.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores
N_SLICE = 32
CHUNK = 16
N_PRESET = 8
N_SCAN_RUN = 4  # scans of the per-scan `run`
# the paths whose launches the kernels line reports, each counted alone
PATHS = ("slice", "scan_run", "ring", "ablation", "bench", "bench_ablate", "lap", "imu_lap", "cli", "reloc", "dist",
         "shard", "campus", "diag")
N_RING = 8  # phase 5b: keyframe slots of the ring driven past capacity by the slice's scans
# phase 6c: the bench's straight course at BENCH_WARMUP_CHUNKS=1 BENCH_CHUNKS=1,
# and --ablate over the same scans, 1 warm and 1 timed chunk of 32
BENCH_WARM, BENCH_CHUNKS, BENCH_CHUNK = 1, 1, 32
# phase 6c's map-ATE bound per --ablate variant: 0.1 m, or twice the port's
# CPU rehearsal of the same drive where that rehearsal is above 0.05 m
ABLATE_ATE_BOUND = {"rigid_scans": 2 * 0.0882}  # rigid_scans' rehearsal: 0.0882 m
N_DIAG = 336  # phase 7k: diag_campus frames (>= 325: the first straight, turn and second straight)
# phase 6b: the reference's ablation switches, each over the slice's first
# N_ABLATE scans in one chunk
ABLATIONS = ("full_dof_odometry", "no_map_update", "reference_ground", "reference_features", "no_shadow_points",
             "points_feed")
N_ABLATE = 8
# phase 7j: python -m lego_loam_torch.campus_run at its defaults but 2 laps
# and 2 noise variants of the lap (3 and 3 until the script grew by phases
# 5b, 6c and 7k): 1,376 frames of 1,400
CAMPUS_LAPS, CAMPUS_VARIANTS, CAMPUS_FRAMES = 2, 2, 1376
N_CLI = 64  # swept scans of the KITTI / rosbag2 fixture (tools/make_fixtures.py's course)
# 3 s of sensor data (5,000 until the script grew by phase 7h, 3,000 until
# it grew by the graphed and eager comparisons, 1,500 until it grew by
# phases 6b and 7j, 500 until it grew by phases 5b, 6c and 7k)
ESKF_TICKS = 300
ROOT = Path(__file__).resolve().parent
K2_SITES = ("odometry_corner", "odometry_surf", "mapping_corner", "mapping_surf")
# The lap drive: bench.py's flagship configuration over a shorter campus
# lap (340 frames, 34 s, longer than the 30 s loop_time_gap), cut after one
# lap and 108 revisit frames: 14 chunks of 32.
LAP_STRAIGHT, LAP_TURN, N_LAP, LAP_CHUNK = 70, 15, 448, 32
# phases 7 and 7i: the lap's frames 448-479, continued from its saved state
# (448-511 until the script grew by phases 5b, 6c and 7k)
N_CONT = 32
# phase 7l: a full keyframe store at the Stevens-scale run's size (8 laps of
# 2,500 keyframes in 20,480 slots) with more loop factors than the default
# max_loop_factors of 128, each revisiting lap closing on the lap before
STORE_KF, STORE_LAPS, STORE_LOOPS_A_LAP, STORE_LOOP_CAP = 20000, 8, 28, 256
# the chains' yaw bias a step: the Stevens-scale run's drift and four times
# it; the second chain's solves must each end within STORE_FAR_ATE m (ATE)
# of the truth
STORE_BIAS_DEG, STORE_FAR_ATE = (2.5e-4, 1e-3), 0.5


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps=20):
    """Device time per call of `fn` without the host's share: a sleep kernel
    holds the stream while the host queues `reps` warm calls, so the CUDA
    events around them time the device running them back to back (the gaps
    between launches included). The sleep doubles until the host has queued
    every call before it ends."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 20
    while cycles <= 1 << 30:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        hidden = not start.query()  # still sleeping after the last call was queued
        torch.cuda.synchronize()
        if hidden:
            return start.elapsed_time(end) / reps
        cycles *= 2
    raise AssertionError("the host did not queue the calls within a sleep of 2^30 cycles")


def render(n, cfg):
    from lego_loam_torch.io.synthetic import straight_trajectory, swept_scan_sequence

    poses = straight_trajectory(n, speed=0.1, yaw_rate=np.deg2rad(0.5))
    return poses, list(swept_scan_sequence(poses, cfg, noise=0.005, seed=3))


def k1_inputs(scans, cfg, dev):
    """Connectivity masks of full-width scans as the main path makes them."""
    from lego_loam_torch.ops.ground import apply_ground, ransac_scores
    from lego_loam_torch.ops.projection import grid_from_range_image, host_pack_range_image
    from lego_loam_torch.ops.segmentation import _connectivity

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    masks = []
    for pts in scans:
        packed = host_pack_range_image(pts, cfg)
        r, az, el, rowe = (torch.from_numpy(np.asarray(p, np.int32 if p.dtype == np.uint16 else p.dtype)).to(dev) for p in packed)
        grid = apply_ground(grid_from_range_image(r, az, el, rowe, cfg), cfg, ransac_scores(cfg, g, dev))
        cand = grid.valid & (grid.ground != 1)
        masks.append((*_connectivity(grid, cand, cfg), cand))
    return [torch.stack(m).contiguous() for m in zip(*masks)]


def comb(H, W, dev):
    """One path through every pixel of an (H, W) scan: each column joined
    top to bottom, consecutive columns at alternate ends; labels to 0."""
    right = torch.zeros((1, H, W), dtype=torch.bool)
    right[0, 0, 0:W - 1:2] = True
    right[0, H - 1, 1:W - 1:2] = True
    down = torch.zeros_like(right)
    down[:, :-1] = True
    up = torch.roll(down, 1, dims=1)
    cand = torch.ones_like(right)
    return [m.to(dev).contiguous() for m in (torch.roll(right, 1, dims=-1), right, up, down, cand)]


def check_k1(scans, cfg, dev):
    from lego_loam_torch.ops.segmentation import _hook_step, k1_layout, label_prop, label_prop_plain

    masks = k1_inputs(scans, cfg, dev)
    H, W = masks[0].shape[-2:]
    out = label_prop(*masks)
    ref = label_prop_plain(*masks)
    torch.cuda.synchronize()
    err = int((out - ref).abs().max())
    if err:
        raise AssertionError(f"K1 at {H} rows differs from its twin at {(out != ref).sum().item()} pixels")
    for b in range(out.shape[0]):
        again = _hook_step(out[b], *(m[b] for m in masks))
        if not torch.equal(again, out[b]):
            raise AssertionError(f"K1 output of scan {b} at {H} rows is not a fixpoint")
    if not bool((label_prop(*comb(H, W, dev)) == 0).all()):
        raise AssertionError(f"K1 leaves the {H}-row comb unfinished")
    n_comp = [int(((out[b] == torch.arange(out[b].numel(), device=dev).view_as(out[b])) & masks[4][b]).sum()) for b in range(out.shape[0])]
    log(f"K1 {H}x{W}: {out.shape[0]} full-width scans bit-equal to the twin, fixpoint holds, comb labels to 0; "
        f"cluster of {k1_layout(H, W)[0]} CTAs per scan; components per scan {n_comp}")
    return masks, err


def knn_case(name, q, t, m, groups=1, t_tile=2048, rel=0.0):
    """K2 against its twin: d2 within 1e-3 + rel * (|q|^2 + max |t|^2) (rel
    covers the float32 roundings of both sums where points lie tens of
    metres from the origin), index match >= 0.999, empty slots equal."""
    from lego_loam_torch.ops.knn import top5_l2, top5_l2_plain

    idx, d2 = top5_l2(q, t, m, groups=groups, t_tile=t_tile)
    ridx, rd2 = top5_l2_plain(q, t, m, groups=groups, t_tile=t_tile)
    torch.cuda.synchronize()
    finite = rd2 < 1e29
    tt = (t * t).sum(1)[m]
    tol = 1e-3 + rel * ((q * q).sum(1, keepdim=True) + (tt.max() if tt.numel() else 0.0))
    diff = (d2 - rd2).abs()
    err = float(diff[finite].max()) if finite.any() else 0.0
    worst = float((diff / tol)[finite].max()) if finite.any() else 0.0
    match = float((idx == ridx).float().mean())
    log(f"K2 {name}: Q={q.shape[0]} T={t.shape[0]} groups={groups}: max |d2 err| {err:.3g} "
        f"({worst:.3f} of its tolerance), index match {match:.5f}")
    if not (worst <= 1.0 and match >= 0.999):
        raise AssertionError(f"K2 {name} disagrees with its twin")
    if not torch.equal(d2 >= 1e29, rd2 >= 1e29) or not torch.equal(idx < 0, ridx < 0):
        raise AssertionError(f"K2 {name}: empty slots differ")
    return idx, d2, err


def knn_exact_case(name, q, t, m, groups=1, gate_d2=math.inf):
    """K2 on one call's clouds against its twin and against float64, with
    tolerances of each pair's own float32 rounding. Where many targets lie
    closer together than float32 resolves d2 = |q|^2 + |t|^2 - 2 q.t (the
    25 overlapping keyframes of loop_icp), the kernel and the twin may rank
    them differently. One float32 d2 lies within about 2.5 eps (|q|^2 +
    |t|^2) of the exact value (eps = 2^-23), so targets a and b may trade
    places where their exact d2 differ by at most
    tol(a, b) = 8 eps (|q|^2 + |t_a|^2 + |t_b|^2) + 1e-6 m^2. Checks:
      - empty slots equal in K2, the twin and the float64 search;
      - each row's indices distinct;
      - K2's d2 within tol(idx, ridx) of the twin's, slot by slot, and
        within tol(idx, idx) of the exact d2 of its own index;
      - index match >= 0.999, a slot agreeing where the indices are equal
        or the two targets' exact d2 are within tol(idx, ridx);
      - in every slot k the exact d2 of K2's index at most the k-th
        smallest exact d2 of a float64 brute force on the card, plus
        tol(idx, b), b the farthest from the origin of the true first k
        (so a skipped target, a neighbour one slot off or a repeated
        index fails beyond a tie of that size).
    Prints, over the queries whose nearest target lies within gate_d2 (the
    ones the ICP weighs), the slot-0 tolerance beside the nearest-neighbour
    d2, and the share of slots where a kernel returning the next neighbour
    instead would exceed the tolerance (what the check can see)."""
    from lego_loam_torch.ops.knn import top5_l2, top5_l2_plain

    idx, d2 = top5_l2(q, t, m, groups=groups)
    ridx, rd2 = top5_l2_plain(q, t, m, groups=groups)
    q64, t64 = q.double(), t.double()
    qq, tt = (q64 * q64).sum(1, keepdim=True), (t64 * t64).sum(1)
    e5, j5 = [], []
    for s in range(0, q.shape[0], 128):  # float64 brute force: (128, T) at a time
        d = ((q64[s:s + 128, None, :] - t64[None]) ** 2).sum(-1).masked_fill(~m[None], math.inf)
        v, j = torch.topk(d, 6, dim=1, largest=False)
        e5.append(v)
        j5.append(j)
    e6, j6 = torch.cat(e5), torch.cat(j5)
    e5, j5 = e6[:, :5], j6[:, :5]
    torch.cuda.synchronize()

    def exact(i):
        return ((q64[:, None] - t64[i.clamp(min=0).long()]) ** 2).sum(-1)

    def tol(a, b):
        return 8 * 2.0 ** -23 * (qq + tt[a.clamp(min=0).long()] + b) + 1e-6

    full = idx >= 0
    if not (torch.equal(full, ridx >= 0) and torch.equal(full, e5 < math.inf)
            and torch.equal(d2 >= 1e29, ~full) and torch.equal(rd2 >= 1e29, ~full)):
        raise AssertionError(f"K2 {name}: empty slots differ between K2, its twin and float64")
    srt = torch.where(full, idx, -1 - torch.arange(5, device=idx.device)).sort(1).values
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        raise AssertionError(f"K2 {name}: a row repeats an index")
    ex, rex = exact(idx), exact(ridx)
    t_pair = tol(idx, tt[ridx.clamp(min=0).long()])
    t_self = tol(idx, tt[idx.clamp(min=0).long()])
    t_top = tol(idx, tt[j5].cummax(1).values)
    worst = {
        "d2 vs twin": ((d2 - rd2).abs() / t_pair)[full],
        "d2 vs exact": ((d2.double() - ex).abs() / t_self)[full],
        "exact vs float64 top-5": ((ex - e5) / t_top)[full],
    }
    worst = {k: float(v.max()) if v.numel() else 0.0 for k, v in worst.items()}
    same = idx == ridx
    exact_match = float(same.float().mean())
    match = float((same | ((ex - rex).abs() <= t_pair)).float().mean())
    used = full[:, 0] & (e5[:, 0] < gate_d2)
    seen = float(((e6[:, 1:] - e5) > t_top)[used[:, None] & full & (e6[:, 1:] < math.inf)].float().mean())
    nn, t0 = e5[:, 0][used], t_pair[:, 0][used]
    err = float((d2 - rd2).abs()[full].max()) if full.any() else 0.0
    log(f"K2 {name}: Q={q.shape[0]} T={t.shape[0]} groups={groups}: index match {exact_match:.5f} "
        f"({match:.5f} counting pairs within their float32 tolerance); worst share of the per-pair "
        f"tolerance: " + ", ".join(f"{k} {v:.3f}" for k, v in worst.items()))
    if nn.numel():
        pct = torch.tensor([0.5, 0.99], dtype=torch.float64, device=q.device)
        nq, tq = torch.quantile(nn, pct).tolist(), torch.quantile(t0, pct).tolist()
        log(f"K2 {name}: over the {nn.numel()} queries with a target within {gate_d2:.3g} m^2: "
            f"nearest-neighbour d2 median {nq[0]:.3e}, 99th percentile {nq[1]:.3e} m^2; slot-0 tolerance "
            f"median {tq[0]:.3e}, 99th percentile {tq[1]:.3e} m^2; a neighbour one slot off would exceed "
            f"its tolerance in {seen:.4f} of their slots; max |d2 - twin d2| {err:.3g}")
    if not (max(worst.values()) <= 1.0 and match >= 0.999):
        raise AssertionError(f"K2 {name} disagrees with its twin or with float64")
    return idx, d2, err


def check_k2(dev):
    f = dict(device=dev, dtype=torch.float32)
    rs = np.random.RandomState(0)
    # the three cases of tests/test_pallas_knn.py
    q = torch.tensor(rs.uniform(-10, 10, (512, 3)), **f)
    t = torch.tensor(rs.uniform(-10, 10, (4096, 3)), **f)
    m = torch.ones(4096, dtype=torch.bool, device=dev)
    m[::13] = False
    knn_case("exact vs brute force", q, t, m, t_tile=512)
    rs = np.random.RandomState(2)
    q = rs.uniform(-10, 10, (512, 3)).astype(np.float32)
    t = rs.uniform(-10, 10, (4096, 3)).astype(np.float32)
    key = np.floor((t + 15.0) / 0.4).astype(np.int64)
    t = t[np.lexsort((key[:, 2], key[:, 1], key[:, 0]))]
    qg, tg = torch.tensor(q, **f), torch.tensor(t, **f)
    idx, d2, _ = knn_case("grouped on voxel-sorted targets", qg, tg, torch.ones(4096, dtype=torch.bool, device=dev), groups=16)
    gd = ((qg[:, None, :] - tg[idx.long()]) ** 2).sum(-1)
    if not torch.allclose(d2, gd, rtol=1e-3, atol=1e-3):
        raise AssertionError("K2 grouped: d2 does not match its indices")
    rs = np.random.RandomState(1)
    q = torch.tensor(rs.randn(256, 3), **f)
    t = torch.tensor(rs.randn(512, 3), **f)
    from lego_loam_torch.ops.knn import top5_l2

    idx, d2 = top5_l2(q, t, torch.zeros(512, dtype=torch.bool, device=dev))
    if not (bool((d2 >= 1e29).all()) and bool((idx == -1).all())):
        raise AssertionError("K2 all-masked case returned neighbours")
    log("K2 all targets masked: every slot empty (d2 >= 1e29, index -1)")
    # the main path's shapes: a VLP-16 near field (+-20 m), 20% of targets masked
    shapes = {}
    for name, Q, T in (("odometry corner", 1024, 1024), ("odometry surf", 2048, 4256),
                       ("mapping corner", 1024, 8192), ("mapping surf", 4096, 32768)):
        q = torch.tensor(rs.uniform(-20, 20, (Q, 3)), **f)
        t = torch.tensor(rs.uniform(-20, 20, (T, 3)), **f)
        m = torch.tensor(rs.rand(T) > 0.2, device=dev)
        _, _, err = knn_case(name, q, t, m)
        if T % 2048 == 0:
            knn_case(name + " groups=16", q, t, m, groups=16)
        shapes[name] = (q, t, m, err)
    return shapes


def ate(est, gt):
    return float(np.sqrt(np.mean(np.sum((np.asarray(est) - gt) ** 2, axis=1))))


def recording_k2_sites(run, modules=("odometry", "mapping")):
    """Calls `run()` with K2's call sites in the named modules of the port
    (odometry, mapping, loopclosure, distributed) recording a copy of the
    last call's query, targets and mask at each site; returns ({site: (q,
    t, m, groups)}, what run() returned)."""
    import importlib

    mods = [importlib.import_module(f"lego_loam_torch.{name}") for name in modules]
    seen = {}

    def recorder(fn):
        def call(q, t, m, groups=1, t_tile=2048, site=""):
            seen[site] = (q.clone(), t.clone(), m.clone(), groups)
            return fn(q, t, m, groups=groups, t_tile=t_tile, site=site)
        return call

    saved = [mod.top5_l2 for mod in mods]
    for mod, fn in zip(mods, saved):
        mod.top5_l2 = recorder(fn)
    try:
        out = run()
    finally:
        for mod, fn in zip(mods, saved):
            mod.top5_l2 = fn
    return seen, out


def recording_map_call(run):
    """Calls `run()` with the back end's `scan_to_map` recording a copy of
    its last call's surf cloud and mask, prior pose and submap surf cloud
    and mask (a real mapping call's inputs); returns them."""
    from lego_loam_torch import backend

    rec = {}
    fn = backend.scan_to_map

    def call(c_xyz, c_m, s_xyz, s_m, R0, t0, submap, cfg, sync_free=False):
        rec.update(q=s_xyz.clone(), q_mask=s_m.clone(), R=R0.clone(), t=t0.clone(),
                   map=submap.surf_xyz.clone(), map_mask=submap.surf_mask.clone())
        return fn(c_xyz, c_m, s_xyz, s_m, R0, t0, submap, cfg, sync_free)

    backend.scan_to_map = call
    try:
        run()
    finally:
        backend.scan_to_map = fn
    return rec


def check_k2_on_path(seen):
    """K2 against its twin on the clouds recorded at each call site. The
    scans reach 80 m, so |q|^2 and |t|^2 reach 6,400 m^2, where one float32
    rounding is 4.9e-4: d2 may differ by eight roundings at that scale."""
    if sorted(seen) != sorted(K2_SITES):
        raise AssertionError(f"the warm-up run reached K2 at {sorted(seen)}, not at {K2_SITES}")
    return max(knn_case(f"path clouds at {site}", q, t, m, groups=g, rel=8 * 2.0 ** -23)[2]
               for site, (q, t, m, g) in seen.items())


def count_syncs(fn):
    """fn() under `torch.cuda.set_sync_debug_mode("warn")`: (what it
    returned, the number of synchronizing CUDA calls torch reported)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum(1 for w in caught if "synchroniz" in str(w.message))


def slice_drive(cfg, scans, no_sync_chunk=None, chunk=CHUNK, **kw):
    """A fresh pipeline (`kw`: sync_free, graphs) over the slice's scans
    through `run_chunked(chunk=chunk)`, timed, with the launch counts set to 0 just
    before and read just after. With no_sync_chunk, the same drive by
    hand (`stage_chunk` + `process_chunk` of each chunk, then the result)
    with that chunk under `torch.cuda.set_sync_debug_mode("error")`: any
    synchronizing CUDA call inside it raises. Returns (pipeline, its
    result, seconds, launches, launches by site, peak GiB)."""
    from lego_loam_torch import cuda as kcuda
    from lego_loam_torch.pipeline import LegoLoamPipeline

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pipe = LegoLoamPipeline(cfg, seed=0, **kw)
    kcuda.reset_counts()
    t0 = time.perf_counter()
    if no_sync_chunk is None:
        out = pipe.run_chunked(scans, chunk=chunk)
    else:
        for k, s in enumerate(range(0, len(scans), chunk)):
            xs = pipe.stage_chunk(scans[s:s + chunk])
            if k == no_sync_chunk:
                torch.cuda.set_sync_debug_mode("error")
            try:
                pipe.process_chunk(xs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        out = pipe._result()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return (pipe, out, dt, dict(kcuda.LAUNCHES), dict(kcuda.SITES),
            torch.cuda.max_memory_allocated() / 2 ** 30)


def run_slice(cfg, scans, gt):
    """The slice graphed (the default), then the same scans with
    `graphs=False`: the first run's checks, and the two runs' map,
    odometry and fused positions and map attitudes bit-identical."""
    from lego_loam_torch.pipeline import LegoLoamPipeline

    # warm-up on other scans: loads the kernels, fills the allocator, and
    # records the clouds of one real call at each of K2's call sites
    # (eagerly: a recording inside a captured graph would run at replay)
    seen, map_call = recording_k2_sites(
        lambda: recording_map_call(
            lambda: LegoLoamPipeline(cfg, seed=1, graphs=False).run_chunked(scans[:4], chunk=4))
    )
    torch.cuda.synchronize()
    path_err = check_k2_on_path(seen)
    pipe, out, dt, launches, sites, peak = slice_drive(cfg, scans)
    stats = dict(pipe.graph_stats)

    for k in ("map_positions", "odom_positions", "fused_positions"):
        a = np.asarray(out[k])
        if a.shape != (len(scans), 3) or not np.isfinite(a).all():
            raise AssertionError(f"{k}: shape {a.shape} or non-finite values")
    if not np.isfinite(np.asarray(pipe.trajectory["rpys"])).all():
        raise AssertionError("non-finite map attitude")
    ate_map = ate(out["map_positions"], gt)
    ate_odom = ate(out["odom_positions"], gt)
    log(f"slice: {len(scans)} scans in {dt:.3f} s = {len(scans) / dt:.3f} scans/s (graphed, first use and "
        f"captures included), peak device memory {peak:.3f} GiB")
    log(f"slice: map ATE {ate_map:.4f} m, odometry ATE {ate_odom:.4f} m (no alignment)")
    log(f"slice: graphs {stats} (capture_s: seconds spent capturing)")
    log(f"slice: launches {launches}, by site {sites} (a captured launch counted at each replay)")
    if not ate_map < 0.1:
        raise AssertionError(f"map ATE {ate_map:.4f} m >= 0.1 m")
    if not (launches.get("cc_label_prop", 0) > 0 and all(sites.get(f"knn_top5@{k}", 0) > 0 for k in K2_SITES)):
        raise AssertionError(f"a kernel of the path was not launched: {launches} {sites}")
    if not (stats["captures"] >= 3 and stats["replays"] > 0 and stats["recaptures"] == 0):
        raise AssertionError(f"slice: the steps were not captured and replayed as expected: {stats}")
    poses = {k: np.asarray(out[k]) for k in ("map_positions", "odom_positions", "fused_positions")}
    poses["map_rpys"] = np.asarray(pipe.trajectory["rpys"])
    del pipe

    # the same scans with the steps run eagerly, the second chunk under
    # set_sync_debug_mode("error")
    epipe, eout, edt, elaunches, _, epeak = slice_drive(cfg, scans, graphs=False, no_sync_chunk=1)
    log(f"no-sync: the eager run's second chunk of {CHUNK} scans ran under set_sync_debug_mode('error') with no "
        f"synchronizing call")
    eposes = {k: np.asarray(eout[k]) for k in ("map_positions", "odom_positions", "fused_positions")}
    eposes["map_rpys"] = np.asarray(epipe.trajectory["rpys"])
    same = {k: bool(np.array_equal(poses[k], eposes[k])) for k in poses}
    log(f"slice: graphs=False {len(scans) / edt:.3f} scans/s ({edt:.3f} s), peak {epeak:.3f} GiB, launches "
        f"{elaunches}; graphed and eager bit-identical: {same} (max differences "
        f"{ {k: float(np.abs(poses[k] - eposes[k]).max()) for k in poses} })")
    if not all(same.values()):
        raise AssertionError(f"slice: the graphed run differs from graphs=False: {same}")
    del epipe
    return {"scans_per_s": len(scans) / dt, "scans": len(scans), "seconds": dt, "peak_gib": peak,
            "ate_map_m": ate_map, "ate_odom_m": ate_odom, "launches_by_site": sites,
            "k2_path_max_abs_err": path_err, "graphs": stats, "eager_scans_per_s": len(scans) / edt,
            "eager_seconds": edt, "eager_peak_gib": epeak, "graphed_eager_bit_identical": same}, \
        launches, map_call, poses


def run_per_scan(cfg, scans, gt):
    """The per-scan entry point: `run` sends each scan through
    `process_scan` (float32 points, projected on the card). Finite output,
    map ATE < 0.1 m, K1 and K2 at its four sites launched."""
    from lego_loam_torch import cuda as kcuda
    from lego_loam_torch.pipeline import LegoLoamPipeline

    pipe = LegoLoamPipeline(cfg, seed=0)
    kcuda.reset_counts()
    t0 = time.perf_counter()
    out = pipe.run(scans[:N_SCAN_RUN])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, sites = dict(kcuda.LAUNCHES), dict(kcuda.SITES)
    for k in ("map_positions", "odom_positions", "fused_positions"):
        a = np.asarray(out[k])
        if a.shape != (N_SCAN_RUN, 3) or not np.isfinite(a).all():
            raise AssertionError(f"per-scan run {k}: shape {a.shape} or non-finite values")
    ate_map = ate(out["map_positions"], gt[:N_SCAN_RUN])
    log(f"per-scan run: {N_SCAN_RUN} scans through process_scan in {dt:.3f} s (first use of the points feed "
        f"included), map ATE {ate_map:.4f} m; launches {launches}, by site {sites}")
    if not ate_map < 0.1:
        raise AssertionError(f"per-scan run: map ATE {ate_map:.4f} m >= 0.1 m")
    if not (launches.get("cc_label_prop", 0) > 0 and all(sites.get(f"knn_top5@{k}", 0) > 0 for k in K2_SITES)):
        raise AssertionError(f"per-scan run: a kernel of the path was not launched: {launches} {sites}")
    return {"scans": N_SCAN_RUN, "seconds": dt, "ate_map_m": ate_map, "launches": launches,
            "launches_by_site": sites}


def run_ring(cfg, scans, gt):
    """Phase 5b: the keyframe ring past capacity, the checks of
    tests/test_backend.py:182 on the card. The slice's scans (4 times the
    ring) with `max_keyframes=N_RING`, loop closure on and anchors every 4
    keyframes, graphed (`slice_drive`): every keyframe appended (n_kf ==
    the scans, not clamped), the N_RING resident slots in time order with
    the newest at (n - 1) x the scan period, map ATE < 0.15 m, finite
    output, K1 and K2 at the four per-scan sites launched, the steps
    replayed across the wraps with no recapture; then a chain-only
    `_optimize_graph` over the wrapped window moves the newest pose
    < 0.05 m."""
    rcfg = dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, max_keyframes=N_RING, enable_loop_closure=True, posegraph_anchor_stride=4))
    pipe, out, dt, launches, sites, peak = slice_drive(rcfg, scans)
    stats = dict(pipe.graph_stats)
    n = len(scans)
    for k in ("map_positions", "odom_positions", "fused_positions"):
        a = np.asarray(out[k])
        if a.shape != (n, 3) or not np.isfinite(a).all():
            raise AssertionError(f"ring {k}: shape {a.shape} or non-finite values")
    n_kf, slots = int(pipe.bstate.n_kf), pipe.bstate.ordered_slots()
    times = pipe.bstate.kf_time.cpu().numpy()[slots]
    ate_map = ate(out["map_positions"], gt)
    t_before = pipe.bstate.t_map.cpu().numpy()
    pipe._optimize_graph()
    moved = float(np.linalg.norm(pipe.bstate.t_map.cpu().numpy() - t_before))
    newest = (n - 1) * rcfg.laser.scan_period
    log(f"ring: {n} scans through {N_RING} keyframe slots in {dt:.3f} s (graphed, first use included), {n_kf} "
        f"keyframes appended, resident slots {slots.tolist()} at times {np.round(times, 3).tolist()}; map ATE "
        f"{ate_map:.4f} m; a chain-only graph solve moved the newest pose {moved:.2e} m; graphs {stats}; launches "
        f"{launches}, by site {sites}")
    if not (n_kf == n and len(slots) == N_RING and np.all(np.diff(times) > 0) and abs(times[-1] - newest) < 1e-4):
        raise AssertionError(f"ring: {n_kf} keyframes, slots {slots}, times {times}")
    if not (ate_map < 0.15 and moved < 0.05):
        raise AssertionError(f"ring: map ATE {ate_map:.4f} m, the chain-only solve moved {moved:.4f} m")
    if not (launches.get("cc_label_prop", 0) > 0 and all(sites.get(f"knn_top5@{k}", 0) > 0 for k in K2_SITES)):
        raise AssertionError(f"ring: a kernel of the path was not launched: {launches} {sites}")
    if not (stats["captures"] >= 3 and stats["replays"] > 0 and stats["recaptures"] == 0):
        raise AssertionError(f"ring: the steps did not replay across the wrap without recapture: {stats}")
    del pipe
    return {"scans": n, "seconds": dt, "n_kf": n_kf, "slots": slots.tolist(), "times": times.tolist(),
            "ate_map_m": ate_map, "chain_solve_move_m": moved, "graphs": stats, "launches": launches,
            "launches_by_site": sites}


def preset_scans(cfg, n):
    """The rigid scans of tests/test_presets_e2e.py: a straight drive at
    0.12 m and 0.5 deg a frame, 1 cm range noise."""
    from lego_loam_torch.io.synthetic import render_scan, straight_trajectory

    poses = straight_trajectory(n, speed=0.12, yaw_rate=np.deg2rad(0.5))
    scans = [render_scan(R, t, cfg, noise=0.01, seed=40 + i) for i, (R, t) in enumerate(poses)]
    return np.stack([t for _, t in poses]), scans


def drive_preset(name, cfg, gt, scans):
    """A short drive of a 32- or 64-row preset in one chunk, with the
    settings of tests/test_presets_e2e.py except its reduced capacities."""
    import dataclasses

    from lego_loam_torch import cuda as kcuda
    from lego_loam_torch.pipeline import LegoLoamPipeline

    cfg = dataclasses.replace(
        cfg,
        mapping=dataclasses.replace(cfg.mapping, enable_loop_closure=False),
        distributed=dataclasses.replace(cfg.distributed, shard_backend=False, use_sharded_posegraph=False),
        pipeline=dataclasses.replace(cfg.pipeline, rigid_scans=True),
    )
    kcuda.reset_counts()
    t0 = time.perf_counter()
    pipe = LegoLoamPipeline(cfg, seed=0)
    out = pipe.run_chunked(scans, chunk=len(scans))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kcuda.LAUNCHES)
    est = np.asarray(out["map_positions"])
    for k in ("map_positions", "odom_positions", "fused_positions"):
        a = np.asarray(out[k])
        if a.shape != (len(scans), 3) or not np.isfinite(a).all():
            raise AssertionError(f"{name} {k}: shape {a.shape} or non-finite values")
    err = np.linalg.norm(est - gt, axis=1)
    iters = sum(pipe.diagnostics["iterations"])
    log(f"{name}: {len(scans)} full-width scans in {dt:.3f} s (first use at this height included); "
        f"map-position error max {err.max():.4f} m, per scan {np.round(err, 4).tolist()}; "
        f"map GN iterations {iters}; launches {launches}")
    if not err.max() < 0.5:
        raise AssertionError(f"{name}: map-position error {err.max():.4f} m >= 0.5 m")
    if not (launches.get("cc_label_prop", 0) > 0 and iters > 0):
        raise AssertionError(f"{name}: K1 not launched or no map iterations: {launches}")
    return {"scans": len(scans), "seconds": dt, "max_err_m": float(err.max()), "launches": launches}


def ablation_config(cfg, name):
    """`cfg` with one of the reference's ablation switches set."""
    r = dataclasses.replace
    return {
        "full_dof_odometry": lambda: r(cfg, odometry=r(cfg.odometry, full_dof_odometry=True)),
        "no_map_update": lambda: r(cfg, mapping=r(cfg.mapping, enable_map_update=False)),
        "reference_ground": lambda: r(cfg, ground=r(cfg.ground, use_ours=False)),
        "reference_features": lambda: r(cfg, features=r(cfg.features, use_ours=False)),
        "no_shadow_points": lambda: r(cfg, features=r(cfg.features, use_shadow_points=False)),
        "points_feed": lambda: r(cfg, pipeline=r(cfg.pipeline, feed_mode="points")),
    }[name]()


def run_ablations(cfg, scans, gt, plain_profile):
    """Phase 6b: each ablation switch over the slice's first N_ABLATE scans
    at full width in one chunk, graphed (`slice_drive`, the launch counts
    set to 0 just before each drive). Each drive: finite output, K1 and K2
    at the odometry sites launched, and its bound: map ATE < 0.1 m, except
    `no_map_update` (map equals odometry within 1e-5 m) and
    `full_dof_odometry` (the largest odometry position error < 1.5 m, the
    reference's own check). `full_dof_odometry` again with `graphs=False`,
    bit-identical; and its graphed step in its steady state
    (`profile_slice`, the slice's scans) beside the plain one's."""
    res, launches, sites = {}, collections.Counter(), collections.Counter()
    sub, gt = scans[:N_ABLATE], gt[:N_ABLATE]
    for name in ABLATIONS:
        acfg = ablation_config(cfg, name)
        pipe, out, dt, l, st, peak = slice_drive(acfg, sub, chunk=N_ABLATE)
        launches.update(l)
        sites.update(st)
        pos = {k: np.asarray(out[k]) for k in ("map_positions", "odom_positions", "fused_positions")}
        for k, a in pos.items():
            if a.shape != (N_ABLATE, 3) or not np.isfinite(a).all():
                raise AssertionError(f"ablation {name} {k}: shape {a.shape} or non-finite values")
        ate_map = ate(pos["map_positions"], gt)
        odom_err = float(np.linalg.norm(pos["odom_positions"] - gt, axis=1).max())
        map_odom = float(np.abs(pos["map_positions"] - pos["odom_positions"]).max())
        log(f"ablation {name}: {N_ABLATE} scans in {dt:.3f} s (graphed, first use and captures included), map ATE "
            f"{ate_map:.4f} m, largest odometry position error {odom_err:.4f} m, map - odometry up to {map_odom:.3g} m; "
            f"graphs {pipe.graph_stats}; launches {l}, by site {st}")
        if name == "no_map_update":
            ok, bound = map_odom <= 1e-5, "map equals odometry within 1e-5 m"
        elif name == "full_dof_odometry":
            ok, bound = odom_err < 1.5, "largest odometry position error < 1.5 m"
        else:
            ok, bound = ate_map < 0.1, "map ATE < 0.1 m"
        if not ok:
            raise AssertionError(f"ablation {name}: {bound} does not hold")
        if not (l.get("cc_label_prop", 0) > 0 and all(st.get(f"knn_top5@{k}", 0) > 0
                                                      for k in ("odometry_corner", "odometry_surf"))):
            raise AssertionError(f"ablation {name}: a kernel of the path was not launched: {l} {st}")
        res[name] = {"seconds": dt, "ate_map_m": ate_map, "max_odom_err_m": odom_err, "map_minus_odom_m": map_odom,
                     "bound": bound, "launches": l, "launches_by_site": st, "graphs": dict(pipe.graph_stats)}
        rpys = np.asarray(pipe.trajectory["rpys"])
        del pipe
        if name == "full_dof_odometry":
            epipe, eout, edt, _, _, _ = slice_drive(acfg, sub, chunk=N_ABLATE, graphs=False)
            same = all(np.array_equal(pos[k], np.asarray(eout[k])) for k in pos) and np.array_equal(
                rpys, np.asarray(epipe.trajectory["rpys"]))
            del epipe
            log(f"ablation {name}: graphs=False {edt:.3f} s; graphed and eager bit-identical: {same}")
            if not same:
                raise AssertionError(f"ablation {name}: the graphed run differs from graphs=False")
            prof = profile_slice(acfg, scans, f"graphed {name}")
            log(f"ablation {name}: graphed steady state {prof['scans_per_s']:.3f} scans/s and "
                f"{prof['device_kernels_per_scan']} device kernels a scan, against {plain_profile['scans_per_s']:.3f} "
                f"and {plain_profile['device_kernels_per_scan']} without the switch (profile phase)")
            res[name].update(eager_seconds=edt, graphed_eager_bit_identical=same, profile=prof)
    return {"switches": res, "launches": dict(launches), "launches_by_site": dict(sites)}



def bench_straight_scans(cfg):
    """The bench's straight course at BENCH_WARMUP_CHUNKS=1 BENCH_CHUNKS=1:
    its true positions and swept renders (in this process: for 64 scans a
    pool's start costs more than it saves; not cached)."""
    from lego_loam_torch import bench
    from lego_loam_torch.campus_run import render_swept

    poses, jobs = bench.straight_course((BENCH_WARM + BENCH_CHUNKS) * BENCH_CHUNK, cfg)
    return bench.truth(poses), render_swept(jobs)


def run_bench_straight(scans, gt, dev):
    """Phase 6c, the bench's straight course: `bench.measure_course` (a
    fresh pipeline of the bench's configuration, `warmup_loop_closure`, one
    warm chunk, one timed, `finalize`) with the launch counts set to 0 just
    before and read just after: finite output, map ATE < 0.1 m, K1 and K2
    at the four per-scan sites launched, no attempt (the course never
    revisits), the steps replayed with no recapture."""
    from lego_loam_torch import bench
    from lego_loam_torch import cuda as kcuda

    kcuda.reset_counts()
    rec = bench.measure_course(bench.bench_config(), scans, gt, BENCH_WARM, BENCH_CHUNK, dev)
    launches, sites = dict(kcuda.LAUNCHES), dict(kcuda.SITES)
    g = rec["graph_stats"]
    log(f"bench straight: {len(scans)} scans, {rec['scans_per_sec']:.3f} scans/s over the timed chunk, map ATE "
        f"{rec['ate_map_m']:.4f} m, {rec['loop_attempts']} attempts; graphs {g}; launches {launches}, by site {sites}")
    if not (rec["finite"] and rec["ate_map_m"] < 0.1 and rec["loop_attempts"] == 0):
        raise AssertionError(f"bench straight: {rec}")
    if not (launches.get("cc_label_prop", 0) > 0 and all(sites.get(f"knn_top5@{k}", 0) > 0 for k in K2_SITES)):
        raise AssertionError(f"bench straight: a kernel of the path was not launched: {launches} {sites}")
    if not (g["replays"] > 0 and g["recaptures"] == 0):
        raise AssertionError(f"bench straight: graphs {g}")
    return {**rec, "launches": launches, "launches_by_site": sites}


def run_bench_ablate(scans, gt, dev):
    """Phase 6c, `python -m lego_loam_torch.bench --ablate` in this
    process (`bench.ablate`: tools/ablate_bench.py's seven variants of the
    bench's configuration, each a fresh pipeline over the same scans, one
    warm chunk and one timed), the launch counts set to 0 just before and
    read just after. Each variant: finite output, its map-ATE bound
    (ABLATE_ATE_BOUND), K1 and K2 at the four per-scan sites launched, its
    steps replayed with no recapture."""
    from lego_loam_torch import bench
    from lego_loam_torch import cuda as kcuda

    kcuda.reset_counts()
    res = bench.ablate(bench.bench_config(), scans, gt, BENCH_CHUNK, BENCH_WARM, BENCH_CHUNKS, dev,
                       out=lambda line: log(f"bench --ablate: {line}"))
    launches, sites = dict(kcuda.LAUNCHES), dict(kcuda.SITES)
    for name, r in res.items():
        bound = ABLATE_ATE_BOUND.get(name, 0.1)
        g, l, st = r["graph_stats"], r["launches"], r["launches_by_site"]
        log(f"bench --ablate {name}: {r['scans_per_sec']:.3f} scans/s, map ATE {r['ate_map_m']:.4f} m (bound "
            f"{bound} m), graphs {g}, launches {l}")
        if not (r["finite"] and r["ate_map_m"] < bound):
            raise AssertionError(f"bench --ablate {name}: finite {r['finite']}, map ATE {r['ate_map_m']:.4f} m")
        if not (l.get("cc_label_prop", 0) > 0 and all(st.get(f"knn_top5@{k}", 0) > 0 for k in K2_SITES)):
            raise AssertionError(f"bench --ablate {name}: a kernel of the path was not launched: {l} {st}")
        if not (g["replays"] > 0 and g["recaptures"] == 0):
            raise AssertionError(f"bench --ablate {name}: graphs {g}")
    return {"variants": res, "launches": launches, "launches_by_site": sites}


def check_bench_line(straight, flagship, card):
    """The bench's line from phase 6c's straight course and phase 7's lap
    (driven through `bench.run_course`): bench.py's keys and the port's,
    at least one attempt, finite values."""
    from lego_loam_torch import bench

    line = bench.bench_line(straight, flagship, card)
    log(f"bench: line from the straight course and the lap: {json.dumps(line)}")
    nums = [v for v in line.values() if isinstance(v, (int, float))]
    if not (tuple(line) == bench.LINE_KEYS and line["loop_attempts"] >= 1 and np.isfinite(nums).all()):
        raise AssertionError(f"bench: line {line}")
    return line


def lap_course(cfg):
    """bench.py's campus course with laps of LAP_STRAIGHT/LAP_TURN frames a
    side, cut after N_LAP frames: true poses and positions and swept renders
    (1 cm noise, seed 100 + i; in RENDER_WORKERS processes), made before any
    timing."""
    from lego_loam_torch.campus_run import RENDER_WORKERS, render_pool, render_swept
    from lego_loam_torch.io.synthetic import campus_world, lap_trajectory

    poses = lap_trajectory(2, straight_frames=LAP_STRAIGHT, turn_frames=LAP_TURN)
    world = campus_world(poses[:N_LAP])
    with render_pool(RENDER_WORKERS) as pool:
        scans = render_swept([(poses[max(i - 1, 0)], poses[i], cfg, world, 100 + i) for i in range(N_LAP + N_CONT)],
                             pool)
    poses = poses[:N_LAP]
    return poses, np.stack([t for _, t in poses]), scans[:N_LAP], scans[N_LAP:]


def check_reduced_solve(pipe):
    """reduced_solve on the card against the same call on the CPU, on the
    drive's final store and loop buffer: `ok` equal, poses within 1 mm and
    1e-4 in rotation entries, the cost before within 1e-4 relative."""
    from lego_loam_torch.posegraph import Factors, reduced_solve

    bs = pipe.bstate
    args = (bs.kf_R, bs.kf_t, bs.kf_rel_R, bs.kf_rel_t, bs.n_kf)
    gR, gt_, (gok, gc0, gc1, _) = reduced_solve(*args, pipe._loop_buf, pipe.cfg)
    cR, ct, (cok, cc0, cc1, _) = reduced_solve(
        *(a.cpu() for a in args), Factors(*(x.cpu() for x in pipe._loop_buf)), pipe.cfg
    )
    dR = float((gR.cpu() - cR).abs().max())
    dt = float((gt_.cpu() - ct).abs().max())
    c0, c0_cpu = float(gc0), float(cc0)
    log(f"reduced_solve card vs CPU: ok {bool(gok)}/{bool(cok)}, cost {c0:.6g} -> {float(gc1):.6g} "
        f"(CPU {c0_cpu:.6g} -> {float(cc1):.6g}), max |R diff| {dR:.2e}, max |t diff| {dt:.2e} m")
    if not (bool(gok) == bool(cok) and dR <= 1e-4 and dt <= 1e-3
            and abs(c0 - c0_cpu) <= 1e-4 * abs(c0_cpu) + 1e-6):
        raise AssertionError("reduced_solve on the card disagrees with the CPU")
    return {"ok": bool(gok), "max_rot_diff": dR, "max_trans_diff_m": dt}


def drive_lap(cfg, gt, scans, name, drive, prepare=lambda pipe: None):
    """A loop-closing drive of the lap course: a fresh pipeline,
    `warmup_loop_closure`, `prepare(pipe)` (untimed: the scans' packing),
    then `drive(pipe, prepared)` timed with the launch counts set to 0 just
    before it and read just after. Fails unless an attempt
    ran, a closure was accepted and a graph solve applied, every output is
    finite, K1 and K2 (at the four per-scan sites and at loop_icp)
    launched, and the corrected keyframe ATE is < 0.5 m and at most the
    uncorrected map ATE + 0.05 m. Returns (pipeline, summary)."""
    from lego_loam_torch import cuda as kcuda
    from lego_loam_torch.pipeline import LegoLoamPipeline
    from lego_loam_torch.utils.metrics import rpe_rmse

    gc.collect()  # the earlier phases' pipelines, so the peak is this drive's own
    pipe = LegoLoamPipeline(cfg, seed=0)
    pipe.warmup_loop_closure()
    prepared = prepare(pipe)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kcuda.reset_counts()
    t0 = time.perf_counter()
    out = drive(pipe, prepared)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, sites = dict(kcuda.LAUNCHES), dict(kcuda.SITES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    for k in ("map_positions", "odom_positions", "fused_positions"):
        a = np.asarray(out[k])
        if a.shape != (len(scans), 3) or not np.isfinite(a).all():
            raise AssertionError(f"{name} {k}: shape {a.shape} or non-finite values")
    kR, kt, ktime = pipe.keyframe_trajectory()
    if kt.shape != gt.shape or not (np.isfinite(kR).all() and np.isfinite(kt).all() and np.isfinite(ktime).all()):
        raise AssertionError(f"{name} keyframes: shape {kt.shape} or non-finite values")
    attempts = sum(1 for d in pipe.loop_diag if "icp_fitness" in d)
    closures = len(pipe.loop_factors)
    solved = [d for d in pipe.loop_diag if "graph_accepted" in d]
    ate_kf, ate_map, ate_odom = ate(kt, gt), ate(out["map_positions"], gt), ate(out["odom_positions"], gt)
    # relative error over 100 m of frames (0.12 m a frame), or the whole drive
    delta = min(int(100.0 / 0.12), len(scans) - 1)
    rpe_map, rpe_odom = rpe_rmse(out["map_positions"], gt, delta), rpe_rmse(out["odom_positions"], gt, delta)
    log(f"{name}: {len(scans)} scans in {dt:.3f} s = {len(scans) / dt:.3f} scans/s, peak device memory {peak:.3f} GiB")
    log(f"{name}: {attempts} attempts, {closures} closures "
        f"{[(f.i, f.j, round(f.fitness, 4)) for f in pipe.loop_factors]}, "
        f"graph solves {[(d['graph_accepted'], [round(c, 3) for c in d['graph_cost']]) for d in solved]}")
    log(f"{name}: corrected keyframe ATE {ate_kf:.4f} m, uncorrected map ATE {ate_map:.4f} m, "
        f"odometry ATE {ate_odom:.4f} m (no alignment); RPE over {delta} frames: map {rpe_map:.4f} m, "
        f"odometry {rpe_odom:.4f} m")
    log(f"{name}: launches {launches}, by site {sites}")
    if not (attempts >= 1 and closures >= 1 and any(d["graph_accepted"] for d in solved)):
        raise AssertionError(f"{name}: {attempts} attempts, {closures} closures, solves {solved}")
    if not (ate_kf < 0.5 and ate_kf <= ate_map + 0.05):
        raise AssertionError(f"{name}: corrected keyframe ATE {ate_kf:.4f} m (map ATE {ate_map:.4f} m)")
    if not (launches.get("cc_label_prop", 0) > 0
            and all(sites.get(f"knn_top5@{k}", 0) > 0 for k in K2_SITES + ("loop_icp",))):
        raise AssertionError(f"{name}: a kernel of the path was not launched: {launches} {sites}")
    return pipe, {"scans_per_s": len(scans) / dt, "scans": len(scans), "seconds": dt, "peak_gib": peak,
                  "attempts": attempts, "closures": closures, "graph_solves": [d["graph_accepted"] for d in solved],
                  "ate_kf_m": ate_kf, "ate_map_m": ate_map, "ate_odom_m": ate_odom, "rpe_frames": delta,
                  "rpe_map_m": rpe_map, "rpe_odom_m": rpe_odom, "launches": launches, "launches_by_site": sites}


def run_lap(cfg, gt, scans, ckpt):
    """The flagship's loop-closing path: `vlp16()` with loop closure on at
    20,480 keyframes, through `warmup_loop_closure` and the bench's timed
    loop (`bench.run_course` over chunks of 32, one warm, then
    `finalize`), with `drive_lap`'s checks; then K2 on one real loop_icp
    call's clouds, the attempt's and the solve's times, and
    `reduced_solve` on the card against the CPU. The final state is saved
    to `ckpt` (`checkpoint.save`) for phase 7h. Returns the summary with
    the bench's record of the drive (`bench.course_record`) under
    "bench", and the loop_icp clouds."""
    from lego_loam_torch import bench

    log(f"lap: {N_LAP} frames of campus laps of {4 * (LAP_STRAIGHT + LAP_TURN)} (straight {LAP_STRAIGHT}, turn "
        f"{LAP_TURN}): one lap and {N_LAP - 4 * (LAP_STRAIGHT + LAP_TURN)} revisit frames, cut from bench.py's "
        f"1,376 frames of 700-frame laps (straight 150, turn 25)")
    timed = {}

    def prepare(p):  # packed before the clock, as the bench's measure_course packs them
        return [p._prep_many(scans[s:s + LAP_CHUNK]) for s in range(0, len(scans), LAP_CHUNK)]

    def drive(p, prepped):
        timed["sps"] = bench.run_course(p, prepped, 1, LAP_CHUNK)
        return p._result()

    pipe, summary = drive_lap(cfg, gt, scans, "lap", drive, prepare)
    summary["bench"] = bench.course_record(pipe, timed["sps"], gt)
    log(f"lap: bench.run_course {timed['sps']:.3f} scans/s over {N_LAP - LAP_CHUNK} timed frames")

    # One more attempt at the last closure's keyframes on the final store:
    # K2's clouds at loop_icp against its twin, then the attempt's time.
    last = pipe.loop_factors[-1]
    attempt = lambda: pipe._attempt(last.i, last.j, last.j + 1)  # noqa: E731 (no ring wrap: slot = id)
    seen, _ = recording_k2_sites(attempt, ("loopclosure",))
    torch.cuda.synchronize()
    q, t, m, g = seen["loop_icp"]
    # 25 overlapping keyframes of the same surfaces: many neighbours lie at
    # distances closer than float32 resolves at tens of metres
    _, _, icp_err = knn_exact_case("path clouds at loop_icp", q, t, m, groups=g,
                                   gate_d2=cfg.mapping.loop_icp_corr_dist ** 2)
    attempt_ms = time_ms(attempt, reps=5, warmup=1)
    solve_check = check_reduced_solve(pipe)
    from lego_loam_torch.posegraph import reduced_solve

    bs = pipe.bstate
    solve_ms = time_ms(lambda: reduced_solve(bs.kf_R, bs.kf_t, bs.kf_rel_R, bs.kf_rel_t, bs.n_kf,
                                             pipe._loop_buf, cfg), reps=5, warmup=1)
    log(f"lap: one attempt {attempt_ms:.3f} ms, one reduced solve {solve_ms:.3f} ms (CUDA events, "
        f"{bs.capacity} keyframes)")
    from lego_loam_torch import checkpoint

    t0 = time.perf_counter()
    checkpoint.save(pipe, ckpt)
    log(f"lap: final state saved for phase 7h in {time.perf_counter() - t0:.2f} s")
    summary.update(attempt_ms=attempt_ms, solve_ms=solve_ms, reduced_solve_check=solve_check,
                   k2_loop_icp_max_abs_err=icp_err)
    return summary, (q, t, m)


def run_imu_lap(cfg, poses, gt, scans, plain_odom_ate):
    """The IMU + wheel-odometry configuration over the lap's scans, driven as
    tools/campus_run.py drives it: per chunk of 32, `stage_chunk_async` with
    the chunk's IMU windows and wheel poses (the next chunk staged while
    this one runs), `process_chunk`, then `finalize`. `drive_lap`'s checks,
    and the odometry ATE must beat the plain lap's on the same scans (the
    prior and the attitude anchor act). Then one turning frame's window
    and segmented cloud through `integrate_imu` + `undistort_to` on the card
    and on the CPU: within 1e-4 m."""
    from lego_loam_torch.imu import integrate_imu, undistort_to
    from lego_loam_torch.io.synthetic import synth_imu_windows, synth_wheel_odom
    from lego_loam_torch.ops.ground import apply_ground
    from lego_loam_torch.ops.segmentation import segment_cloud

    imu = synth_imu_windows(poses, cfg, rate=200.0, noise=0.002, seed=0)
    odom = synth_wheel_odom(poses, cfg, seed=0, scale_err=1.005, yaw_noise=5e-4)
    log(f"IMU lap: use_imu_undistortion, odom_prior_mode {cfg.odometry.odom_prior_mode!r}; "
        f"{int(imu['mask'][0].sum())} IMU samples a scan (200 Hz, window {cfg.pipeline.imu_window}), "
        f"wheel odometry with scale error 1.005 and yaw noise 5e-4 rad a step")

    def window(s0, s1):
        return {k: v[s0:s1] for k, v in imu.items()}

    def drive(pipe, _):
        def stage(s0):
            return pipe.stage_chunk_async(pipe._prep_many(scans[s0:s0 + LAP_CHUNK]), imu=window(s0, s0 + LAP_CHUNK),
                                          odom=(odom[0][s0:s0 + LAP_CHUNK], odom[1][s0:s0 + LAP_CHUNK]))

        fut = stage(0)
        for s0 in range(0, len(scans), LAP_CHUNK):
            xs = fut.result()
            if s0 + LAP_CHUNK < len(scans):
                fut = stage(s0 + LAP_CHUNK)
            pipe.process_chunk(xs)
        pipe.finalize()
        return {"map_positions": np.asarray(pipe.trajectory["positions"]),
                "odom_positions": pipe.odom_positions, "fused_positions": pipe.fused_positions}

    pipe, summary = drive_lap(cfg, gt, scans, "IMU lap", drive)
    log(f"IMU lap: odometry ATE {summary['ate_odom_m']:.4f} m against the plain lap's {plain_odom_ate:.4f} m")
    if not summary["ate_odom_m"] < plain_odom_ate:
        raise AssertionError(f"IMU lap: odometry ATE {summary['ate_odom_m']:.4f} m is not below the plain lap's "
                             f"{plain_odom_ate:.4f} m")

    # one frame in the middle of the first turn (6 deg of yaw a scan)
    k = LAP_STRAIGHT + LAP_TURN // 2
    xs = pipe.stage_chunk(pipe._prep_many([scans[k]]), imu=window(k, k + 1))
    grid = apply_ground(pipe._grid(xs, 0), cfg, pipe._ground_scores(k))
    _, seg = segment_cloud(grid, cfg)
    im = {n: v[0] for n, v in xs["imu"].items()}
    track = integrate_imu(im["t"], im["rpy"], im["acc"], mask=im["mask"])
    card = undistort_to(seg.xyz, seg.rel_time, track, cfg.laser.scan_period)
    cpu_track = integrate_imu(im["t"].cpu(), im["rpy"].cpu(), im["acc"].cpu(), mask=im["mask"].cpu())
    cpu = undistort_to(seg.xyz.cpu(), seg.rel_time.cpu(), cpu_track, cfg.laser.scan_period)
    valid = seg.valid.cpu()
    err = float((card.cpu() - cpu).abs()[valid].max())
    moved = float((cpu - seg.xyz.cpu()).norm(dim=-1)[valid].max())
    log(f"IMU lap: integrate_imu + undistort_to of frame {k} ({int(valid.sum())} segmented points, moved up to "
        f"{moved:.3f} m) on the card against the CPU: max |diff| {err:.3g} m")
    if not (err <= 1e-4 and moved > 0.05):
        raise AssertionError(f"IMU lap: undistortion on the card differs from the CPU by {err:.3g} m "
                             f"(points moved {moved:.3f} m)")
    summary.update(undistort_card_vs_cpu_m=err, undistort_max_move_m=moved)
    return summary


def cli_fixture(cfg, d):
    """tools/make_fixtures.py's course at full width: N_CLI swept scans of a
    straight drive at 0.2 m a scan (5 mm noise, seed 300 + i), written as a
    KITTI sequence and a rosbag2 bag by that tool's writers (numpy and
    sqlite3 only). Returns (truth positions, scans, kitti dir, bag dir)."""
    from lego_loam_torch.io.synthetic import straight_trajectory, swept_scan_sequence

    sys.path.insert(0, str(ROOT / "tools"))
    from make_fixtures import write_kitti, write_rosbag2

    poses = straight_trajectory(N_CLI, speed=0.2)
    scans = swept_scan_sequence(poses, cfg, noise=0.005, seed=300)
    times = [i * cfg.laser.scan_period for i in range(N_CLI)]
    seq, bag = os.path.join(d, "kitti", "00"), os.path.join(d, "bag")
    write_kitti(seq, scans, times)
    write_rosbag2(bag, scans, times)
    return np.stack([t for _, t in poses]), scans, seq, bag


def cli(*args, out):
    """`python -m lego_loam_torch.run ... --out out --profile` in a child
    process on the card; fails on a non-zero exit. Returns its profile.json
    (scans/s and its own kernel launch counts)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "lego_loam_torch.run", *args, "--out", out, "--profile"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise AssertionError(f"lego_loam_torch.run {' '.join(args)} exited {r.returncode}:\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    for line in r.stdout.splitlines():
        if line.startswith(("processed", "localized", "resumed")):
            log(f"  run: {line}")
    with open(os.path.join(out, "profile.json")) as f:
        prof = json.load(f)
    prof["process_seconds"] = time.perf_counter() - t0
    return prof


def run_cli(truth, seq, bag, d):
    """The product entry point on the card: `python -m lego_loam_torch.run`
    over the KITTI sequence (the native feeder, with --checkpoint) and over
    the rosbag2 bag. Each exits 0 and writes pose.txt (one pose a scan,
    finite, map ATE < 0.1 m), mapt.txt (each scan's mapping time, under
    --profile), MapIterTimes.txt and cornerMap.pcd; both kernels launched."""
    runs = {}
    for name, args in (("kitti", ("--kitti", seq, "--checkpoint", os.path.join(d, "cli_state.npz"))),
                       ("rosbag", ("--rosbag", bag))):
        out = os.path.join(d, f"out_{name}")
        prof = cli(*args, out=out)
        pose = np.loadtxt(os.path.join(out, "pose.txt"))
        mapt = np.loadtxt(os.path.join(out, "mapt.txt"))
        iters = np.loadtxt(os.path.join(out, "MapIterTimes.txt"))
        if pose.shape != (N_CLI, 7) or not np.isfinite(pose).all():
            raise AssertionError(f"CLI {name}: pose.txt has shape {pose.shape} or non-finite values")
        if mapt.shape != (N_CLI,) or iters.shape != (N_CLI,) or not os.path.getsize(os.path.join(out, "cornerMap.pcd")):
            raise AssertionError(f"CLI {name}: mapt.txt {mapt.shape}, MapIterTimes.txt {iters.shape} or no cornerMap.pcd")
        ate_map = ate(pose[:, :3], truth)
        launches, sites = prof["launches"], prof["launches_by_site"]
        log(f"CLI {name}: {prof['scans']} scans in {prof['seconds']:.3f} s = {prof['scans_per_s']:.3f} scans/s "
            f"({prof['process_seconds']:.1f} s for the whole process), map ATE {ate_map:.4f} m, mapping step "
            f"{np.median(mapt):.3f} ms median (--profile, synchronized), stages {prof['stages_mean_ms']}; "
            f"launches {launches}, by site {sites}")
        if not ate_map < 0.1:
            raise AssertionError(f"CLI {name}: map ATE {ate_map:.4f} m >= 0.1 m")
        if not (launches.get("cc_label_prop", 0) > 0 and all(sites.get(f"knn_top5@{k}", 0) > 0 for k in K2_SITES)):
            raise AssertionError(f"CLI {name}: a kernel of the path was not launched: {launches} {sites}")
        runs[name] = {"scans_per_s": prof["scans_per_s"], "seconds": prof["seconds"], "ate_map_m": ate_map,
                      "mapping_ms_median": float(np.median(mapt)), "launches": launches, "launches_by_site": sites}
    total = {k: runs["kitti"]["launches"].get(k, 0) + runs["rosbag"]["launches"].get(k, 0)
             for k in ("cc_label_prop", "knn_top5")}
    sites = collections.Counter(runs["kitti"]["launches_by_site"]) + collections.Counter(runs["rosbag"]["launches_by_site"])
    return {"runs": runs, "launches": total, "launches_by_site": dict(sites)}


def run_checkpoint(cfg, scans, d):
    """Checkpoint and resume through the API at full width: the
    uninterrupted per-scan run (twice, for the card's run-to-run spread),
    then a run saved at N_CLI/2 and resumed in
    a fresh pipeline, whose final map pose lies within 2e-2 m of the
    uninterrupted run's (tests/test_cli_e2e.py:126); a save -> load -> save
    round trip gives the same keys, dtypes and bytes; the CLI's checkpoint
    loads at frame N_CLI."""
    from lego_loam_torch import checkpoint
    from lego_loam_torch.pipeline import LegoLoamPipeline

    half = N_CLI // 2
    t_whole = []
    for _ in range(2):  # twice: the card's run-to-run spread beside the resume's difference
        whole = LegoLoamPipeline(cfg)
        whole.run(scans)
        t_whole.append(whole.bstate.t_map.cpu().numpy())
        del whole
        gc.collect()
    spread = float(np.linalg.norm(t_whole[1] - t_whole[0]))
    t_whole = t_whole[0]
    a = LegoLoamPipeline(cfg)
    a.run(scans[:half])
    path = os.path.join(d, "half.npz")
    t0 = time.perf_counter()
    checkpoint.save(a, path)
    save_s = time.perf_counter() - t0
    del a
    gc.collect()
    t0 = time.perf_counter()
    b = checkpoint.load(LegoLoamPipeline(cfg), path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if b.frame_idx != half:
        raise AssertionError(f"checkpoint: resumed at frame {b.frame_idx}, not {half}")
    b.run(scans[half:])
    diff = float(np.linalg.norm(b.bstate.t_map.cpu().numpy() - t_whole))
    del b
    gc.collect()
    again = os.path.join(d, "again.npz")
    checkpoint.save(checkpoint.load(LegoLoamPipeline(cfg), path), again)
    with np.load(path) as x, np.load(again) as y:
        if sorted(x.files) != sorted(y.files):
            raise AssertionError("checkpoint round trip: the keys differ")
        for k in x.files:
            u, v = x[k], y[k]
            if u.dtype != v.dtype or u.shape != v.shape or u.tobytes() != v.tobytes():
                raise AssertionError(f"checkpoint round trip: {k} differs")
        n_keys = len(x.files)
    gc.collect()
    cli_frame = checkpoint.load(LegoLoamPipeline(cfg), os.path.join(d, "cli_state.npz")).frame_idx
    if cli_frame != N_CLI:
        raise AssertionError(f"the CLI's checkpoint resumes at frame {cli_frame}, not {N_CLI}")
    gc.collect()
    mb = os.path.getsize(path) / 2 ** 20
    log(f"checkpoint: saved at frame {half} and resumed, final map pose {diff:.2e} m from the uninterrupted run's "
        f"(two uninterrupted runs: {spread:.2e} m apart); "
        f"{n_keys} arrays, {mb:.1f} MiB compressed ({cfg.mapping.max_keyframes} keyframes), save {save_s:.2f} s, "
        f"load {load_s:.2f} s; save -> load -> save bit-equal; the CLI's checkpoint loads at frame {cli_frame}")
    if not diff < 2e-2:
        raise AssertionError(f"checkpoint: resumed run ends {diff:.4f} m from the uninterrupted run (>= 2e-2 m)")
    return {"resume_diff_m": diff, "rerun_diff_m": spread, "file_mib": mb, "save_s": save_s, "load_s": load_s}


def run_reloc(cfg, truth, kitti_out, bag, d):
    """Re-localization: `--remap` on the KITTI run's map over the rosbag2
    stream (each scan from the previous pose; a swept scan is not deskewed,
    so it is held against the truth halfway through its sweep: < 0.1 m),
    then `localize_scan` from a 0.3 m / 3 deg perturbed start as
    tests/test_relocalize.py:52-76 (error < 0.12 m and 1 deg), K1 and K2
    launched in both."""
    from lego_loam_torch import cuda as kcuda
    from lego_loam_torch.io.synthetic import render_scan, straight_trajectory
    from lego_loam_torch.mapproducts import load_high_dense_map
    from lego_loam_torch.relocalize import localize_scan, map_state_from_cloud

    out = os.path.join(d, "out_reloc")
    prof = cli("--remap", kitti_out, "--rosbag", bag, out=out)
    traj = np.loadtxt(os.path.join(out, "relocalized.txt"))
    mid = np.concatenate([truth[:1], (truth[:-1] + truth[1:]) / 2])
    if traj.shape != (N_CLI, 3):
        raise AssertionError(f"--remap wrote {traj.shape} poses")
    err = np.linalg.norm(traj - mid, axis=1)
    launches, sites = prof["launches"], prof["launches_by_site"]
    log(f"reloc --remap: {prof['scans']} scans at {prof['scans_per_s']:.3f} scans/s, error against the mid-sweep "
        f"truth max {err.max():.4f} m, mean {err.mean():.4f} m; launches {launches}, by site {sites}")
    dense, _ = load_high_dense_map(os.path.join(kitti_out, "denseCloud.pcd"))
    R_true, t_true = straight_trajectory(N_CLI, speed=0.2)[N_CLI // 2]
    scan = render_scan(R_true, t_true, cfg, noise=0.005, seed=99)
    yaw = np.deg2rad(3.0)
    R0 = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]]) @ R_true
    t0 = t_true + np.array([0.3, -0.2, 0.05])
    submap = map_state_from_cloud(dense, cfg, center=t_true)
    kcuda.reset_counts()
    R, t, diag = localize_scan(scan, submap, R0, t0, cfg)
    torch.cuda.synchronize()
    direct = dict(kcuda.LAUNCHES)
    direct_sites = dict(kcuda.SITES)
    e_t = float(np.linalg.norm(t.cpu().numpy() - t_true))
    R = R.cpu().numpy()
    e_r = float(np.rad2deg(np.arccos(np.clip((np.trace(R_true.T @ R) - 1) / 2, -1, 1))))
    log(f"reloc localize_scan from a 0.3 m / 3 deg perturbed start: error {e_t:.4f} m, {e_r:.3f} deg, "
        f"{int(diag.iterations)} GN iterations; launches {direct}, by site {direct_sites}")
    if not (err.max() < 0.1 and e_t < 0.12 and e_r < 1.0):
        raise AssertionError(f"reloc: --remap error {err.max():.4f} m, perturbed start {e_t:.4f} m / {e_r:.3f} deg")
    for what, ln, st in (("--remap", launches, sites), ("localize_scan", direct, direct_sites)):
        if not (ln.get("cc_label_prop", 0) > 0 and all(st.get(f"knn_top5@{k}", 0) > 0
                                                       for k in ("mapping_corner", "mapping_surf"))):
            raise AssertionError(f"reloc {what}: a kernel of the path was not launched: {ln} {st}")
    return {"scans_per_s": prof["scans_per_s"], "max_err_m": float(err.max()), "perturbed_err_m": e_t,
            "perturbed_err_deg": e_r, "launches": launches, "launches_by_site": sites}


def run_native(seq, scans, cfg):
    """The native host library (g++ from native/lego_native.cpp) against its
    plain twins on the fixture's real scans: prep_cloud on a rendered scan
    (NaN rows included) and the ScanFeeder stream over the KITTI files,
    bit-equal, indices 0, 1, ... in order, timestamps 0.1 k."""
    from lego_loam_torch import native
    from lego_loam_torch.io.kitti import KittiSequence

    cap = cfg.laser.max_points
    a, b = native.prep_cloud(scans[0], cap), native.prep_cloud_plain(scans[0], cap)
    if not all(np.array_equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("native prep_cloud differs from its twin")
    files = KittiSequence(seq).files
    t0 = time.perf_counter()
    with native.ScanFeeder(files, cap) as feeder:
        items = list(iter(feeder.next, None))
    feed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = native.ScanFeederPlain(files, cap)
    want = list(iter(plain.next, None))
    plain_s = time.perf_counter() - t0
    if [i[0] for i in items] != list(range(len(files))) or len(want) != len(items):
        raise AssertionError(f"native feeder indices {[i[0] for i in items]}")
    for x, y in zip(items, want):
        if not (x[0] == y[0] and x[3] == y[3] and np.array_equal(x[1], y[1]) and np.array_equal(x[2], y[2])):
            raise AssertionError(f"native feeder scan {x[0]} differs from its twin")
    log(f"native: prep_cloud bit-equal to its twin on a {len(scans[0])}-point scan ({int(a[1].sum())} finite); "
        f"ScanFeeder over {len(files)} KITTI files bit-equal to its twin, indices in order, "
        f"{1e3 * feed_s / len(files):.3f} ms a scan (plain {1e3 * plain_s / len(files):.3f} ms, host)")
    return {"feeder_ms_per_scan": 1e3 * feed_s / len(files), "plain_ms_per_scan": 1e3 * plain_s / len(files)}


def eskf_run(data_dir, device, T):
    """run_eskf over the first T ticks of the stream in data_dir on `device`:
    (positions (T, 3) as numpy, wall seconds)."""
    from lego_loam_torch import eskf as E
    from lego_loam_torch.io import eskf_data

    D = eskf_data.load(data_dir)
    qn = eskf_data.quaternion_noise_scale(D["lidar_rpy_gt"], D["lidar_rpy"])
    s0 = E.init_state(D["gt_pos"][0], D["gt_vel"][0], D["gt_att"][0], device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, hist = E.run_eskf(D["acc_mea"][:T], D["omega_mea"][:T], D["lidar_pos"], D["lidar_rpy"], D["vel_count"][:T],
                         D["steer_count"][:T], s0, qn)
    return hist["pos"].cpu().numpy(), time.perf_counter() - t0


def run_eskf_phase(d):
    """The ESKF study on the card: run_eskf over a generated ESKF_TICKS-tick
    constant-radius turn (io.synthetic.synth_eskf_fixture, in the
    reference fixtures' JSON format) on the card, and the same stream on
    the CPU in a spawned process meanwhile (both loops are host-bound):
    positions within 1e-3 m of each other, RMSE against the ground truth
    < 0.1 m (the bound of tests/test_eskf.py:91)."""
    import multiprocessing

    from lego_loam_torch.io import eskf_data
    from lego_loam_torch.io.synthetic import synth_eskf_fixture

    data_dir = os.path.join(d, "eskf")
    yaw_rate = synth_eskf_fixture(data_dir, n=ESKF_TICKS + 1, speed=1.0, steer=0.05, seed=0)
    T = ESKF_TICKS
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        cpu_job = pool.apply_async(eskf_run, (data_dir, "cpu", T))
        card, card_s = eskf_run(data_dir, "cuda", T)
        cpu, cpu_s = cpu_job.get(timeout=900)
    diff = float(np.abs(card - cpu).max())
    rmse = ate(card, eskf_data.load(data_dir)["gt_pos"][1:T + 1])
    log(f"ESKF: {T} ticks of a {yaw_rate:.4f} rad/s turn at 1 m/s; card {card_s:.2f} s "
        f"({1e3 * card_s / T:.3f} ms a tick), CPU {cpu_s:.2f} s (its own process, run meanwhile); card vs CPU "
        f"max |diff| {diff:.2e} m; RMSE against the ground truth {rmse:.4f} m")
    if not (diff <= 1e-3 and rmse < 0.1 and np.isfinite(card).all()):
        raise AssertionError(f"ESKF: card vs CPU {diff:.2e} m, RMSE {rmse:.4f} m")
    return {"ticks": T, "card_s": card_s, "cpu_s": cpu_s, "card_vs_cpu_m": diff, "rmse_m": rmse}


def lap_config():
    """bench.py's flagship configuration: `vlp16()` with loop closure on at
    20,480 keyframes."""
    from lego_loam_torch.config import vlp16

    cfg = vlp16()
    return dataclasses.replace(cfg, mapping=dataclasses.replace(cfg.mapping, enable_loop_closure=True,
                                                                max_keyframes=20480))


def drifted_circle(n, yaw_bias_deg=0.2, radius=8.0):
    """tests/test_posegraph_reduced.py's drifted circle: true poses on a
    circle, odometry rels from the truth, the estimate integrated with a
    yaw bias. Returns (R_true, t_true, rel_R, rel_t, R_est, t_est)."""
    def rz(a):
        c, s_ = np.cos(a), np.sin(a)
        return np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1]], np.float32)

    theta = np.linspace(0, 2 * np.pi, n)
    t_true = np.stack([np.cos(theta) * radius - radius, np.sin(theta) * radius, 0 * theta], 1).astype(np.float32)
    R_true = np.stack([rz(a + np.pi / 2) for a in theta])
    relR = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    relt = np.zeros((n, 3), np.float32)
    for i in range(1, n):
        relR[i] = R_true[i - 1].T @ R_true[i]
        relt[i] = R_true[i - 1].T @ (t_true[i] - t_true[i - 1])
    bias = rz(np.deg2rad(yaw_bias_deg))
    R_est, t_est = np.zeros_like(R_true), np.zeros_like(t_true)
    R_est[0], t_est[0] = R_true[0], t_true[0]
    for i in range(1, n):
        R_est[i] = R_est[i - 1] @ relR[i] @ bias
        t_est[i] = R_est[i - 1] @ relt[i] + t_est[i - 1]
    return R_true, t_true, relR, relt, R_est, t_est


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in _flat(v)]


def twice(fn):
    """fn() twice on the card: (first result, second result, ms of the
    second call by CUDA events around it, the host's queueing included)."""
    a = fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    b = fn()
    end.record()
    torch.cuda.synchronize()
    return a, b, start.elapsed_time(end)


def same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_flat(a), _flat(b), strict=True))


def rot_diff(Ra, Rb) -> float:
    """Largest angle (rad) between corresponding rotations, in float64."""
    D = Ra.double().transpose(-1, -2) @ Rb.double()
    w = torch.stack([D[..., 2, 1] - D[..., 1, 2], D[..., 0, 2] - D[..., 2, 0], D[..., 1, 0] - D[..., 0, 1]], -1) / 2
    c = (D.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2
    return float(torch.atan2(torch.linalg.norm(w, dim=-1), c).max())


def dist_phase(d) -> int:
    """Phase 7h, run as its own process by `run_dist`: rank 0 of a world of
    one over NCCL (so the process group never touches the other phases).
    Reads the lap's saved state and one mapping call's clouds from `d`,
    writes its results to d/dist.json and the mapping_sharded clouds to
    d/sharded_clouds.pt. Raises on any failed check."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from lego_loam_torch import checkpoint, launch, weak_scaling
    from lego_loam_torch import cuda as kcuda
    from lego_loam_torch import distributed as D
    from lego_loam_torch.ops.hashgrid import build_grid, query_knn
    from lego_loam_torch.ops.knn import top5_l2
    from lego_loam_torch.pipeline import LegoLoamPipeline
    from lego_loam_torch.posegraph import Factors, anchor_stride, reduced_solve, solve_pose_graph

    t0 = time.perf_counter()
    dev = launch.init_from_args(device="cuda")
    one = torch.ones(1, device=dev)
    dist.all_reduce(one)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    world = dist.get_world_size()
    mesh = D.make_mesh()
    seg_mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("seg",))
    log(f"dist: {dist.get_backend()} world of {world} on {dev}, set up in {setup_s:.3f} s (init and a first "
        f"all_reduce); mesh {tuple(mesh.mesh.shape)} {mesh.mesh_dim_names}")

    cfg = lap_config()
    t0 = time.perf_counter()
    pipe = checkpoint.load(LegoLoamPipeline(cfg, device=dev), os.path.join(d, "lap.npz"))
    bs = pipe.bstate
    K, n_kf = bs.capacity, int(bs.n_kf)
    if n_kf > K:
        raise AssertionError(f"dist: the lap's store wrapped ({n_kf} keyframes in {K} slots)")
    factors, active, _ = pipe._graph_factors()
    call = torch.load(os.path.join(d, "map_call.pt"), map_location=dev)
    S, _ = anchor_stride(cfg)
    log(f"dist: lap store loaded in {time.perf_counter() - t0:.2f} s: {n_kf} keyframes of {K}, "
        f"{len(pipe.loop_factors)} loop factors, {int(factors.mask.sum())} valid of {factors.i.shape[0]} factors")

    # The dist path, counted alone: each solve and the map step twice.
    local = D.shard_rows(factors, mesh)
    solver = D.sharded_pose_graph_solver(mesh, cfg)
    schur = D.schur_pose_graph_solver(seg_mesh, cfg, K, stride=S)
    step = D.sharded_map_gn_step(mesh, cfg)
    margs = (call["q"], call["q_mask"], D.shard_rows(call["map"], mesh), D.shard_rows(call["map_mask"], mesh),
             call["R"], call["t"])
    loop = pipe._loop_buf
    torch.cuda.synchronize()
    kcuda.reset_counts()
    pg_a, pg_b, pg_ms = twice(lambda: solver(bs.kf_R, bs.kf_t, local, active))
    sc_a, sc_b, sc_ms = twice(lambda: schur(bs.kf_R, bs.kf_t, bs.kf_rel_R, bs.kf_rel_t, bs.n_kf, loop))
    seen, (st_a, st_b, st_ms) = recording_k2_sites(lambda: twice(lambda: step(*margs)), ("distributed",))
    torch.cuda.synchronize()
    launches, sites = dict(kcuda.LAUNCHES), dict(kcuda.SITES)
    log(f"dist: launches {launches}, by site {sites}")
    if not sites.get("knn_top5@mapping_sharded", 0) > 0:
        raise AssertionError(f"dist: K2 was not launched at mapping_sharded: {sites}")

    # 1. the factor-parallel solver against solve_pose_graph
    one_a, one_b, one_ms = twice(lambda: solve_pose_graph(bs.kf_R, bs.kf_t, factors, active, cfg, gn_iters=3))
    pg_dR, pg_dt = rot_diff(pg_a[0], one_a[0]), float((pg_a[1] - one_a[1]).abs().max())
    pg_move = float((pg_a[1] - bs.kf_t).norm(dim=1).max())
    log(f"dist: sharded_pose_graph_solver ({cfg.distributed.cg_iterations} CG, 3 GN, {K} poses) {pg_ms:.3f} ms, "
        f"solve_pose_graph {one_ms:.3f} ms; apart by {pg_dt:.2e} m and {pg_dR:.2e} rad; poses moved up to "
        f"{pg_move:.4f} m")
    if not (pg_dt <= 1e-4 and pg_dR <= 1e-4):
        raise AssertionError("dist: the factor-parallel solver disagrees with solve_pose_graph")

    # 2. the Schur solver against reduced_solve, on the lap and at 64 keyframes
    rd_a, rd_b, rd_ms = twice(lambda: reduced_solve(bs.kf_R, bs.kf_t, bs.kf_rel_R, bs.kf_rel_t, bs.n_kf, loop, cfg))
    sc_dt = float((sc_a[1] - rd_a[1]).abs().max())
    log(f"dist: schur_pose_graph_solver (stride {S}, {K // S} anchors, auto) {sc_ms:.3f} ms, reduced_solve "
        f"{rd_ms:.3f} ms (its gate {'applied' if bool(rd_a[2][0]) else 'refused'}); apart by {sc_dt:.2e} m")
    if not sc_dt <= 2e-2:
        raise AssertionError(f"dist: the Schur solver is {sc_dt:.3g} m from reduced_solve")
    R_true, t_true, relR, relt, R_est, t_est = (torch.from_numpy(a).to(dev) for a in drifted_circle(64))
    c64 = dataclasses.replace(cfg, mapping=dataclasses.replace(cfg.mapping, max_keyframes=64,
                                                               posegraph_anchor_stride=8))
    L = cfg.mapping.max_loop_factors
    lb = Factors(i=torch.zeros(L, dtype=torch.int32, device=dev), j=torch.zeros(L, dtype=torch.int32, device=dev),
                 R=torch.eye(3, device=dev).repeat(L, 1, 1), t=torch.zeros(L, 3, device=dev),
                 info=torch.ones(L, 6, device=dev), mask=torch.zeros(L, dtype=torch.bool, device=dev))
    lb.i[0], lb.j[0], lb.info[0], lb.mask[0] = 1, 62, 1e4, True
    lb.R[0], lb.t[0] = R_true[1].T @ R_true[62], R_true[1].T @ (t_true[62] - t_true[1])
    sd_a, sd_b, _ = twice(lambda: D.schur_pose_graph_solver(seg_mesh, c64, 64, stride=8, reduced="dense")(
        R_est, t_est, relR, relt, 64, lb))
    r64 = reduced_solve(R_est, t_est, relR, relt, torch.tensor(64, device=dev), lb, c64)
    sd_dt = float((sd_a[1] - r64[1]).abs().max())
    d0 = float((t_est - t_true).norm(dim=1).max())
    d1 = float((sd_a[1] - t_true).norm(dim=1).max())
    log(f"dist: Schur dense at 64 keyframes (stride 8): {sd_dt:.2e} m from reduced_solve, drift {d0:.4f} -> "
        f"{d1:.4f} m")
    if not (sd_dt <= 2e-2 and d1 < 0.3 * d0):
        raise AssertionError("dist: the dense Schur solve at 64 keyframes failed")

    # 3. K2 at mapping_sharded against its twin; 4. reruns bit-identical
    q, tgt, m, _ = seen["mapping_sharded"]
    _, _, k2_err = knn_case("path clouds at mapping_sharded", q, tgt, m, rel=8 * 2.0 ** -23)
    reruns = {"sharded_pose_graph_solver": same_bits(pg_a, pg_b), "schur_pose_graph_solver": same_bits(sc_a, sc_b),
              "schur dense at 64": same_bits(sd_a, sd_b), "solve_pose_graph": same_bits(one_a, one_b),
              "reduced_solve": same_bits(rd_a, rd_b), "sharded_map_gn_step": same_bits(st_a, st_b)}
    log(f"dist: reruns bit-identical: {reruns}")
    if not all(reruns.values()):
        raise AssertionError(f"dist: a rerun on the card differs: {reruns}")

    # 5. the voxel-hash k-NN against K2 on the same clouds
    qw = call["q"] @ call["R"].T + call["t"]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    grid = build_grid(call["map"], call["map_mask"], cfg.mapping.nn_valid_dist)
    gi, gd = query_knn(grid, call["map"], call["map_mask"], qw, call["q_mask"], 5)
    end.record()
    ki, kd = top5_l2(qw, call["map"], call["map_mask"])
    torch.cuda.synchronize()
    grid_ms = start.elapsed_time(end)
    gate = call["q_mask"] & (kd[:, 4] < cfg.mapping.nn_valid_dist)
    tt = (call["map"] * call["map"]).sum(1)
    tol = 1e-3 + 8 * 2.0 ** -23 * ((qw * qw).sum(1, keepdim=True) + tt[ki.clamp(min=0).long()])
    recall = float(((gd - kd).abs() <= tol).all(dim=1)[gate].float().mean())
    masked = bool((~call["map_mask"][gi.clamp(min=0).long()] & (gi >= 0)).any())
    log(f"dist: build_grid + query_knn ({int(call['map_mask'].sum())} of {call['map'].shape[0]} submap slots, "
        f"{int(call['q_mask'].sum())} of {qw.shape[0]} queries, {cfg.mapping.nn_valid_dist} m cells) {grid_ms:.3f} "
        f"ms; recall against K2 {recall:.4f} over the {int(gate.sum())} queries whose 5th neighbour lies within "
        f"the cell; a masked point returned: {masked}")
    if not (recall > 0.98 and int(gate.sum()) > 100 and not masked):
        raise AssertionError(f"dist: the voxel-hash k-NN recall {recall:.4f} over {int(gate.sum())} queries")
    torch.save(tuple(x.cpu() for x in (q, tgt, m)), os.path.join(d, "sharded_clouds.pt"))

    # 6. python -m lego_loam_torch.weak_scaling's solve at this world size
    ws, (ws_R, ws_t) = weak_scaling.measure(dev)
    ws_move = float(np.abs(ws_t - weak_scaling.chain_problem(ws["poses"], weak_scaling.N_LOOPS)[1]).max())
    log(f"dist: weak_scaling over {world} rank: {ws['poses']} poses, {ws['factors']} factors, solve "
        f"{ws['solve_ms']:.3f} ms, {ws['factors_per_ms']:.2f} factors/ms, collective bytes "
        f"{ws['collective_bytes_per_solve']} ({ws['backend']}); poses moved up to {ws_move:.3f} m")
    if not (np.isfinite(ws_t).all() and np.isfinite(ws_R).all() and ws["solve_ms"] > 0
            and sorted(ws["collective_bytes_per_solve"]) == ["all_gather", "all_reduce", "broadcast"]):
        raise AssertionError(f"dist: weak_scaling {ws}")
    del pipe, bs, loop
    gc.collect()
    torch.cuda.empty_cache()
    shard = shard_phase(d, mesh)

    # the map step on the CPU (gloo), against the card's
    dist.destroy_process_group()
    D.init_distributed(f"127.0.0.1:{launch._free_port()}", 1, 0, device="cpu")
    cpu_R, cpu_t = D.sharded_map_gn_step(D.make_mesh(), cfg)(*(x.cpu() for x in margs))
    ws_cpu, (_, ws_cpu_t) = weak_scaling.measure("cpu")
    dist.destroy_process_group()
    ws_dt = float(np.abs(ws_t - ws_cpu_t).max())
    log(f"dist: weak_scaling solve on the card against gloo on the CPU: {ws_dt:.2e} m apart (CPU "
        f"{ws_cpu['solve_ms']:.3f} ms)")
    if not ws_dt <= 2e-2:
        raise AssertionError(f"dist: the weak-scaling solve on the card is {ws_dt:.3g} m from the CPU's")
    ws.update(device=card_line(), card_vs_cpu_m=ws_dt, cpu_solve_ms=ws_cpu["solve_ms"])
    st_dt, st_dR = float((st_a[1].cpu() - cpu_t).abs().max()), rot_diff(st_a[0].cpu(), cpu_R)
    st_move = float((st_a[1] - call["t"]).norm())
    log(f"dist: sharded_map_gn_step {st_ms:.3f} ms on the card (moved the pose {st_move:.4f} m); card vs CPU "
        f"{st_dt:.2e} m, {st_dR:.2e} rad")
    if not (st_dt <= 1e-4 and st_dR <= 1e-4):
        raise AssertionError("dist: sharded_map_gn_step on the card disagrees with the CPU")

    with open(os.path.join(d, "dist.json"), "w") as fh:
        json.dump({
            "world": world, "nccl_setup_s": setup_s, "launches": launches, "launches_by_site": sites,
            "sharded_pose_graph_ms": pg_ms, "solve_pose_graph_ms": one_ms, "sharded_vs_single_m": pg_dt,
            "sharded_vs_single_rad": pg_dR, "schur_ms": sc_ms, "reduced_solve_ms": rd_ms,
            "schur_vs_reduced_m": sc_dt, "schur_dense64_vs_reduced_m": sd_dt, "map_gn_step_ms": st_ms,
            "map_gn_card_vs_cpu_m": st_dt, "map_gn_card_vs_cpu_rad": st_dR, "k2_max_abs_err": k2_err,
            "reruns_bit_identical": reruns, "hashgrid_ms": grid_ms, "hashgrid_recall": recall, "shard": shard,
            "weak_scaling": ws,
        }, fh)
    return 0


def shard_phase(d, mesh) -> dict:
    """Phase 7i, in phase 7h's NCCL rank (world size 1): the keyframe store
    in row blocks over the mesh (`distributed.shard_backend_state`, the
    reference's `shard_backend`), each store access through its
    collectives. Three parts, each timed:

    1. the slice's 32 scans through `run_chunked(chunk=16)` with the store
       laid out right after construction: map, odometry and fused poses
       bit-identical to phase 5's unsharded run, map ATE < 0.1 m, K2
       launched at mapping_corner and mapping_surf; the store's bytes on
       this rank printed;
    2. the lap's saved state (phase 7's `checkpoint.save`) loaded into a
       pipeline whose store lies in row blocks, which runs the next N_CONT
       scans of the lap course (frames 448-479, revisiting) through
       `run_chunked(chunk=32)`: at least one loop attempt on the sharded
       store, the final keyframe poses bit-identical to the parent's
       unsharded graphed continuation (`run_lap_continuation`), K2
       launched at loop_icp;
    3. `python -m lego_loam_torch.run` over phase 7c's KITTI fixture,
       joining its own group (--coordinator/--num-processes 1/--process-id
       0): exit 0, and pose.txt equal to 7c's as text.

    The launches of parts 1 and 2's sharded runs, each counted alone, make
    the `shard` path. Returns the results; raises on a failed check."""
    from lego_loam_torch import checkpoint, launch, weak_scaling
    from lego_loam_torch import cuda as kcuda
    from lego_loam_torch import distributed as D
    from lego_loam_torch.config import vlp16
    from lego_loam_torch.pipeline import LegoLoamPipeline
    from lego_loam_torch.types import named_leaves

    def counted(fn):
        torch.cuda.synchronize()
        kcuda.reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, collections.Counter(kcuda.LAUNCHES), collections.Counter(kcuda.SITES)

    # 1. the slice
    cfg = vlp16()
    scans = list(np.load(os.path.join(d, "slice_scans.npy")))
    with np.load(os.path.join(d, "slice_poses.npz")) as f:
        want = dict(f)
    pipe = LegoLoamPipeline(cfg, seed=0)
    pipe.bstate = D.shard_backend_state(mesh, pipe.bstate)
    held = {name: isinstance(leaf, D.RowBlock) for name, leaf in named_leaves(pipe.bstate)}
    store_bytes = sum(leaf.nbytes if isinstance(leaf, D.RowBlock) else leaf.numel() * leaf.element_size()
                      for _, leaf in named_leaves(pipe.bstate))
    out, slice_s, launches, sites = counted(lambda: pipe.run_chunked(scans, chunk=CHUNK))
    got = {k: np.asarray(out[k]) for k in ("map_positions", "odom_positions", "fused_positions")}
    got["map_rpys"] = np.asarray(pipe.trajectory["rpys"])
    same = {k: bool(np.array_equal(got[k], want[k])) for k in got}
    diff = {k: float(np.abs(got[k] - want[k]).max()) for k in got}
    ate_map = ate(got["map_positions"], want["gt"])
    log(f"shard: slice, {len(scans)} scans with the store in row blocks ({sum(held.values())} of {len(held)} "
        f"leaves) over a mesh of {mesh.size()}: {store_bytes / 2 ** 30:.3f} GiB of state on this rank, "
        f"{slice_s:.3f} s = {len(scans) / slice_s:.3f} scans/s; map ATE {ate_map:.4f} m; bit-identical to phase "
        f"5's unsharded run: {same} (max differences {diff}); launches {dict(launches)}, by site {dict(sites)}")
    if not all(same.values()):
        raise AssertionError(f"shard: the sharded slice differs from phase 5's unsharded run: {diff}")
    if not ate_map < 0.1:
        raise AssertionError(f"shard: map ATE {ate_map:.4f} m >= 0.1 m")
    if not all(sites.get(f"knn_top5@{k}", 0) > 0 for k in ("mapping_corner", "mapping_surf")):
        raise AssertionError(f"shard: K2 was not launched at the mapping sites: {dict(sites)}")
    del pipe, out
    gc.collect()

    # 2. the lap's state, continued over the revisit frames 448-479
    lcfg = lap_config()
    cont = list(np.load(os.path.join(d, "lap_cont_scans.npy")))  # rendered with the lap (`lap_course`)
    ckpt = os.path.join(d, "lap.npz")
    with np.load(os.path.join(d, "lap_cont_kf.npz")) as f:  # the parent's graphed unsharded continuation
        kR_plain, kt_plain, plain_s = f["R"], f["t"], float(f["seconds"])
    lap = LegoLoamPipeline(lcfg, seed=0)
    lap.bstate = D.shard_backend_state(mesh, lap.bstate)
    checkpoint.load(lap, ckpt)  # keeps the row blocks
    if not isinstance(lap.bstate.kf_t, D.RowBlock):
        raise AssertionError("shard: checkpoint.load dropped the store's row blocks")
    _, lap_s, lap_launches, lap_sites = counted(lambda: lap.run_chunked(cont, chunk=LAP_CHUNK))
    kR, kt, _ = lap.keyframe_trajectory()
    attempts = sum(1 for r in lap.loop_diag if "icp_fitness" in r)
    kf_same = bool(np.array_equal(kR, kR_plain) and np.array_equal(kt, kt_plain))
    log(f"shard: lap state (frame {N_LAP}, {len(kt)} keyframes at the end) continued over {N_CONT} revisit "
        f"frames: unsharded (graphed, the parent's run) {plain_s:.3f} s, sharded (eager) {lap_s:.3f} s; on the sharded "
        f"store {attempts} attempts, {len(lap.loop_factors)} loop factors "
        f"{[(f.i, f.j, round(f.fitness, 4)) for f in lap.loop_factors[-3:]]}; final keyframe poses bit-identical: "
        f"{kf_same} (max |t| difference {float(np.abs(kt - kt_plain).max()):.3e} m); launches "
        f"{dict(lap_launches)}, by site {dict(lap_sites)}")
    if not (attempts >= 1 and kf_same):
        raise AssertionError(f"shard: {attempts} attempts on the sharded store, keyframes bit-identical {kf_same}")
    if not lap_sites.get("knn_top5@loop_icp", 0) > 0:
        raise AssertionError(f"shard: K2 was not launched at loop_icp: {dict(lap_sites)}")
    del lap
    gc.collect()

    # 3. the CLI joining a group of one over phase 7c's fixture
    with open(os.path.join(d, "cli.json")) as fh:
        fixture = json.load(fh)
    out_dir = os.path.join(d, "out_cli_group")
    prof = cli("--kitti", fixture["seq"], "--coordinator", f"127.0.0.1:{launch._free_port()}", "--num-processes", "1",
               "--process-id", "0", out=out_dir)
    with open(os.path.join(out_dir, "pose.txt")) as a, open(fixture["pose"]) as b:
        pose_same = a.read() == b.read()
    log(f"shard: CLI with --coordinator/--num-processes 1/--process-id 0 over phase 7c's KITTI fixture: "
        f"{prof['scans']} scans in {prof['seconds']:.3f} s ({prof['process_seconds']:.1f} s for the whole process); "
        f"pose.txt equal to 7c's: {pose_same}")
    if not pose_same:
        raise AssertionError("shard: the CLI's pose.txt in a group differs from phase 7c's")

    launches, sites = launches + lap_launches, sites + lap_sites
    return {"launches": dict(launches), "launches_by_site": dict(sites), "store_gib_per_rank": store_bytes / 2 ** 30,
            "slice_s": slice_s, "slice_ate_map_m": ate_map, "slice_bit_identical": same,
            "lap_cont_frames": N_CONT, "lap_cont_unsharded_s": plain_s, "lap_cont_sharded_s": lap_s,
            "lap_cont_attempts": attempts, "lap_cont_kf_bit_identical": kf_same,
            "cli_group_s": prof["seconds"], "cli_group_process_s": prof["process_seconds"],
            "cli_group_pose_equal": pose_same, "cli_group_launches": prof["launches"]}


def run_dist(d):
    """Phase 7h: `dist_phase` in a child process (one NCCL rank through the
    port's launcher); its output is printed here. Returns (its results,
    the mapping_sharded call's clouds on the card)."""
    from lego_loam_torch import launch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = launch.spawn_local(str(ROOT / "chip_smoke.py"), 1, extra_args=("--dist-phase", d), timeout=600)[0]
    for line in out.splitlines():
        log(f"  [rank 0] {line}")
    with open(os.path.join(d, "dist.json")) as fh:
        res = json.load(fh)
    res["phase_s"] = time.perf_counter() - t0
    log(f"dist: phase 7h took {res['phase_s']:.1f} s with its process's start")
    clouds = torch.load(os.path.join(d, "sharded_clouds.pt"))
    return res, tuple(x.cuda() for x in clouds)


def run_campus(d):
    """Phase 7j: `python -m lego_loam_torch.campus_run --laps 2
    --render-variants 2` (the campus course of tools/campus_run.py cut to 2
    laps: 1,376 frames, loop closure on, 20,480 keyframes) in a child
    process on the card, its
    record and products under `d`, its scan cache in `d`. Checks: exit 0,
    `failed` false and `finite` true, CAMPUS_FRAMES frames, at least 2
    closures (its revisit lap), the corrected keyframe ATE < 0.5 m and at most the map
    ATE + 0.05 m, the record's keys those of the reference's
    CAMPUS_RUN.json plus `device`, `peak_device_memory_gib` and
    `latency_by_keyframes`, and K1 and K2 (at the four per-scan
    sites and at loop_icp) launched over the drive (launches.json). The
    record is printed beside the reference's accuracy fields, which gate
    nothing."""
    out, rec_path = os.path.join(d, "out_campus"), os.path.join(d, "campus.json")
    env = dict(os.environ, LEGO_SCAN_CACHE=os.path.join(d, "scan_cache"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "lego_loam_torch.campus_run", "--laps", str(CAMPUS_LAPS),
                        "--render-variants", str(CAMPUS_VARIANTS), "--out", out, "--json-out", rec_path],
                       cwd=ROOT, capture_output=True, text=True, timeout=900, env=env)
    wall = time.perf_counter() - t0
    for line in r.stdout.splitlines():
        if not line.startswith("{"):
            log(f"  campus_run: {line}")
    if r.returncode != 0:
        raise AssertionError(f"lego_loam_torch.campus_run exited {r.returncode}:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    with open(rec_path) as fh:
        rec = json.load(fh)
    with open(os.path.join(out, "launches.json")) as fh:
        counts = json.load(fh)
    with open(ROOT / "CAMPUS_RUN.json") as fh:
        ref = json.load(fh)
    launches, sites = counts["launches"], counts["launches_by_site"]
    log(f"campus: {rec['frames']} frames in {wall:.1f} s of process (renders and first use included), "
        f"{rec['scans_per_sec']:.3f} scans/s steady, {rec['keyframes_total']} keyframes, {rec['loop_closures']} "
        f"closures; ATE map {rec['ate_map_m']:.4f} m, corrected keyframes {rec['ate_corrected_kf_m']:.4f} m, odometry "
        f"{rec['ate_odom_only_m']:.4f} m; RPE/100 m map {rec['rpe_100m_map']:.4f} m, odometry "
        f"{rec['rpe_100m_odom']:.4f} m; solve {rec['loop_solve_ms']:.3f} ms, attempt {rec['loop_attempt_ms']:.3f} ms "
        f"(CUDA events); peak device memory {rec['peak_device_memory_gib']:.3f} GiB; {rec['device']}; "
        f"graphs {counts['graph_stats']}")
    acc = ("keyframes_total", "loop_closures", "ate_map_m", "ate_corrected_kf_m", "ate_odom_only_m", "rpe_100m_map",
           "rpe_100m_odom")
    log("campus: the reference's CAMPUS_RUN.json (the JAX package on a TPU; accuracy only, gates nothing): "
        + ", ".join(f"{k} {ref[k]}" for k in acc))
    log(f"campus: launches {launches}, by site {sites}")
    if set(rec) != set(ref) | {"device", "peak_device_memory_gib", "latency_by_keyframes"}:
        raise AssertionError(f"campus: record keys {sorted(rec)} are not CAMPUS_RUN.json's plus device, "
                             f"peak_device_memory_gib and latency_by_keyframes")
    if rec["failed"] or not rec["finite"] or rec["frames"] != CAMPUS_FRAMES or rec["loop_closures"] < 2:
        raise AssertionError(f"campus: failed {rec['failed']}, finite {rec['finite']}, frames {rec['frames']}, "
                             f"closures {rec['loop_closures']}")
    if not (rec["ate_corrected_kf_m"] < 0.5 and rec["ate_corrected_kf_m"] <= rec["ate_map_m"] + 0.05):
        raise AssertionError(f"campus: corrected keyframe ATE {rec['ate_corrected_kf_m']:.4f} m "
                             f"(map ATE {rec['ate_map_m']:.4f} m)")
    if not (launches.get("cc_label_prop", 0) > 0
            and all(sites.get(f"knn_top5@{k}", 0) > 0 for k in K2_SITES + ("loop_icp",))):
        raise AssertionError(f"campus: a kernel of the path was not launched: {launches} {sites}")
    return {"record": rec, "process_seconds": wall, "launches": launches, "launches_by_site": sites,
            "graphs": counts["graph_stats"]}

def store_chain(n, laps, loops_a_lap, yaw_bias_deg=2.5e-4, seed=0):
    """A chain of `weak_scaling.chain_problem`'s kind at the Stevens-scale
    run's size: n poses around `laps` laps of a circle of 300 m (0.12 m a
    pose at n = 20,000), the true odometry steps, the estimate integrated
    from them with a yaw bias a step, and `loops_a_lap` true loop factors
    on every revisiting lap, each between a pose and the same phase of the
    lap before (ids drawn from the seed). The default bias puts the store
    2.41 m (ATE) from the truth, at most 4.16 m: the Stevens-scale run's
    store holds map poses 2.27 m off (its map ATE), not the odometry's
    17.36 m. A bias of 1e-3 deg puts it 9.58 m off. Returns (truth t,
    R_est, t_est, rel_R, rel_t, loops [(i, j, R, t)]) as numpy float32."""
    def rz(a):
        c, s = np.cos(a), np.sin(a)
        out = np.zeros(a.shape + (3, 3), np.float32)
        out[..., 0, 0], out[..., 0, 1], out[..., 1, 0], out[..., 1, 1], out[..., 2, 2] = c, -s, s, c, 1.0
        return out

    rs = np.random.RandomState(seed)
    lap = n // laps
    yaw = (2 * np.pi * np.arange(n) / lap).astype(np.float32)
    radius = 0.12 * lap / (2 * np.pi)
    R = rz(yaw)
    t = np.stack([np.sin(yaw) * radius, (1 - np.cos(yaw)) * radius, 0 * yaw], axis=1).astype(np.float32)
    relR = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    relt = np.zeros((n, 3), np.float32)
    relR[1:] = np.einsum("nab,nac->nbc", R[:-1], R[1:])
    relt[1:] = np.einsum("nab,na->nb", R[:-1], t[1:] - t[:-1])
    bias = rz(np.full((), np.deg2rad(yaw_bias_deg), np.float32))
    Re, te = np.zeros_like(R), np.zeros_like(t)
    Re[0], te[0] = R[0], t[0]
    for k in range(1, n):
        Re[k] = Re[k - 1] @ relR[k] @ bias
        te[k] = Re[k - 1] @ relt[k] + te[k - 1]
    loops = []
    for L in range(1, laps):
        for j in np.sort(rs.choice(lap, loops_a_lap, replace=False)) + L * lap:
            i = j - lap
            loops.append((int(i), int(j), R[i].T @ R[j], R[i].T @ (t[j] - t[i])))
    return t, Re, te, relR, relt, loops


def full_store_pipeline(cfg, chain, device):
    """A loop-closing pipeline on `device` whose keyframe store holds the
    chain's estimate and odometry steps (slot = id: no ring wrap) and
    whose loop factors are the chain's, through the pipeline's own
    `_sync_loop_buf` (information from a fitness of 0.05)."""
    from lego_loam_torch.pipeline import LegoLoamPipeline, LoopFactor

    _, Re, te, relR, relt, loops = chain
    pipe = LegoLoamPipeline(cfg, device=device)
    bs = pipe.bstate
    n = len(te)
    for leaf, a in ((bs.kf_R, Re), (bs.kf_t, te), (bs.kf_rel_R, relR), (bs.kf_rel_t, relt)):
        leaf[:n].copy_(torch.from_numpy(a))
    bs.n_kf.fill_(n)
    pipe.loop_factors = [LoopFactor(i=i, j=j, R=R, t=t, fitness=0.05) for i, j, R, t in loops]
    pipe._sync_loop_buf()
    return pipe


def solve_store_both(cfg, chain):
    """The pipeline's pose-graph solve (`_dispatch_solve`: `reduced_solve`
    and the in-place writes of the store and the map pose) over the chain's
    store on the card under `torch.cuda.set_sync_debug_mode("error")`, so
    that any read inside it raises and names its line, and on the CPU.
    Returns (the card's pipeline, accepted, cost before and after, largest
    anchor move; the CPU's accepted and costs; the card's and the CPU's
    keyframe positions; the CPU's seconds with the store's set-up)."""
    gc.collect()
    torch.cuda.empty_cache()
    gpu = full_store_pipeline(cfg, chain, "cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gpu._dispatch_solve(None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    g_diag = gpu._solve_pending[0].tolist()
    gpu._pickup_solve()
    t0 = time.perf_counter()
    cpu = full_store_pipeline(cfg, chain, "cpu")
    cpu._dispatch_solve(None)
    c_diag = cpu._solve_pending[0].tolist()
    cpu_s = time.perf_counter() - t0
    n = len(chain[0])
    return gpu, g_diag, c_diag, gpu.bstate.kf_t[:n].cpu().numpy(), cpu.bstate.kf_t[:n].numpy(), cpu_s


def run_full_store(card):
    """Phase 7l: the Stevens-scale store without the 20-minute drive. The
    flagship configuration with max_loop_factors STORE_LOOP_CAP over a
    store of STORE_KF keyframes (`store_chain`: STORE_LAPS laps, more than
    128 loop factors), solved on the card under
    `set_sync_debug_mode("error")` and on the CPU (`solve_store_both`),
    for two chains:

    - the Stevens-scale drift (STORE_BIAS_DEG[0]): the card's positions
      within 2e-2 m of the CPU's (phase 7h's bound for a reduced solve),
      both solves accepted by their cost gate and nearer the truth than
      the drifted chain. The chain asks anchor moves of 4.16 m from a cost
      of 21,198; the Stevens-scale run's largest solve moved an anchor
      3.39 m from a cost of 26,187 (its loop_diag.json, 23 solves);
    - four times that drift (STORE_BIAS_DEG[1], 9.58 m off, moves of
      16.5 m): three GN steps under the 5 m trust region do not converge
      it, and the card and the CPU stop at different points (ROADMAP
      §3). Both solves accepted and each within STORE_FAR_ATE of the
      truth (ATE; measured on an H100 80GB HBM3 at 700 W: card 0.4065 m,
      its host's CPU 0.3595 m, 6.710e-2 m apart), the difference printed.

    The solve timed with CUDA events (a pure `reduced_solve` over the first
    chain's store, before the applied one), printed beside the card's name
    and power limit."""
    from lego_loam_torch.posegraph import reduced_solve

    cfg = lap_config()
    cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(cfg.mapping, max_loop_factors=STORE_LOOP_CAP))
    out = {"keyframes": STORE_KF, "device": card}
    for k, bias in enumerate(STORE_BIAS_DEG):
        t0 = time.perf_counter()
        chain = store_chain(STORE_KF, STORE_LAPS, STORE_LOOPS_A_LAP, yaw_bias_deg=bias)
        truth, n_loops = chain[0], len(chain[-1])
        gpu, (g_ok, g_c0, g_c1, g_moved), (c_ok, c_c0, c_c1, _), g_t, c_t, cpu_s = solve_store_both(cfg, chain)
        diff = float(np.linalg.norm(g_t - c_t, axis=1).max())
        ate0, ate_g, ate_c = ate(chain[2], truth), ate(g_t, truth), ate(c_t, truth)
        log(f"store {k}: {STORE_KF} keyframes over {STORE_LAPS} laps in {gpu.bstate.capacity} slots, yaw bias "
            f"{bias:g} deg a step, {n_loops} loop factors (cap {STORE_LOOP_CAP}); the pipeline's solve on the card "
            f"under set_sync_debug_mode('error'): accepted {g_ok > 0.5}, cost {g_c0:.6g} -> {g_c1:.6g}, largest "
            f"anchor move {g_moved:.3f} m; on the CPU: accepted {c_ok > 0.5}, cost {c_c0:.6g} -> {c_c1:.6g} "
            f"({cpu_s:.1f} s with the store's set-up); card vs CPU, largest position difference {diff:.3e} m; "
            f"ATE against the truth {ate0:.4f} m before, after {ate_g:.4f} m (card) and {ate_c:.4f} m (CPU); "
            f"{time.perf_counter() - t0:.1f} s")
        accepted = g_ok > 0.5 and c_ok > 0.5
        if k == 0:
            bs = gpu.bstate
            solve_ms = time_ms(lambda: reduced_solve(bs.kf_R, bs.kf_t, bs.kf_rel_R, bs.kf_rel_t, bs.n_kf,
                                                     gpu._loop_buf, cfg), reps=5, warmup=1)
            log(f"store: one reduced solve over {STORE_KF} keyframes {solve_ms:.3f} ms (CUDA events, 5 calls), "
                f"on {card}")
            if not (accepted and diff <= 2e-2 and ate_g < ate0):
                raise AssertionError(f"store: card accepted {g_ok}, CPU accepted {c_ok}, difference {diff:.3e} m "
                                     f"(bound 2e-2), ATE {ate0:.4f} -> {ate_g:.4f} m")
            out.update(loop_factors=n_loops, solve_ms=solve_ms, card_vs_cpu_m=diff, ate_before_m=ate0,
                       ate_after_m=ate_g, cost=[g_c0, g_c1])
        else:
            if not (accepted and max(ate_g, ate_c) <= STORE_FAR_ATE):
                raise AssertionError(f"store, far chain: card accepted {g_ok}, CPU accepted {c_ok}, ATE after "
                                     f"{ate_g:.4f} (card) and {ate_c:.4f} m (CPU), bound {STORE_FAR_ATE} m")
            out["far"] = {"ate_before_m": ate0, "ate_after_m": [ate_g, ate_c], "card_vs_cpu_m": diff}
        del gpu
    return out


def run_diag(d):
    """Phase 7k: `python -m lego_loam_torch.diag_campus --frames N_DIAG` in
    this process (`diag_campus.run`, its scan cache in `d`; the launch
    counts set to 0 just before its drive), its table and segment lines
    printed: finite odometry and map positions at every frame, the
    first straight, turn and second straight all reached, K1 and K2 at
    the four per-scan sites launched, the steps replayed with no
    recapture."""
    from lego_loam_torch import diag_campus

    args = diag_campus.parse_args(["--frames", str(N_DIAG)])
    saved = os.environ.get("LEGO_SCAN_CACHE")
    os.environ["LEGO_SCAN_CACHE"] = os.path.join(d, "scan_cache")
    try:
        res = diag_campus.run(args, log=lambda msg: log(f"  diag_campus: {msg}"))
    finally:
        if saved is None:
            os.environ.pop("LEGO_SCAN_CACHE")
        else:
            os.environ["LEGO_SCAN_CACHE"] = saved
    diag_campus.report(args, res, out=lambda line: log(f"  diag_campus: {line}"))
    launches, sites, g = res["launches"], res["launches_by_site"], res["graph_stats"]
    log(f"diag: {res['frames']} frames at {res['scans_per_sec']:.3f} scans/s (first use included); graphs {g}; "
        f"launches {launches}, by site {sites}")
    finite = bool(np.isfinite(res["odom"]).all() and np.isfinite(res["est"]).all())
    if not (finite and res["odom"].shape == res["est"].shape == (N_DIAG, 3)
            and list(res["segments"]) == ["straight1", "turn1", "straight2"]):
        raise AssertionError(f"diag: finite {finite}, shapes {res['odom'].shape} {res['est'].shape}, segments "
                             f"{res['segments']}")
    if not (launches.get("cc_label_prop", 0) > 0 and all(sites.get(f"knn_top5@{k}", 0) > 0 for k in K2_SITES)):
        raise AssertionError(f"diag: a kernel of the path was not launched: {launches} {sites}")
    if not (g["replays"] > 0 and g["recaptures"] == 0):
        raise AssertionError(f"diag: graphs {g}")
    gt = res["gt"]
    return {"frames": res["frames"], "scans_per_sec": res["scans_per_sec"], "segments": res["segments"],
            "odom_err_end_m": float(np.linalg.norm(res["odom"][-1] - gt[-1])),
            "map_err_end_m": float(np.linalg.norm(res["est"][-1] - gt[-1])), "graphs": g, "launches": launches,
            "launches_by_site": sites}


def profile_slice(cfg, scans, mode, **kw):
    """One frame step (`kw`: sync_free, graphs) in its steady state: a
    fresh pipeline over chunks of 4 (graphed) or 2 of the slice's scans
    (staged before),
    chunks to warm up (first use; graphed, two for the captures), then one chunk timed, one
    under `count_syncs` (host synchronizations per frame) and one under
    torch.profiler: device time and device kernels per scan and the
    device's busy share of the timed chunk's wall time per scan (the
    profiler slows the host, not the kernels). Prints the kernels that take
    the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lego_loam_torch.pipeline import LegoLoamPipeline

    graphed = kw.get("graphs", True)
    # graphed: the prepass is captured at its second chunk. The eager steps
    # run in chunks of 2 (4 until the script grew by phase 7l): their
    # ~47,000 and ~19,000 kernels a scan make key_averages take ~90 and ~45 s
    # over 4 scans
    n, warm = (4, 2) if graphed else (2, 1)
    t_in = time.perf_counter()
    pipe = LegoLoamPipeline(cfg, seed=2, **kw)
    xs = [pipe.stage_chunk(pipe._prep_many(scans[s:s + n])) for s in range(0, (warm + 3) * n, n)]
    for x in xs[:warm]:
        pipe.process_chunk(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.process_chunk(xs[warm])
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    _, syncs = count_syncs(lambda: pipe.process_chunk(xs[warm + 1]))
    torch.cuda.synchronize()
    t_prof = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe.process_chunk(xs[warm + 2])
        torch.cuda.synchronize()
    t_trace = time.perf_counter()
    res = {"wall_ms_per_scan": wall_ms, "scans_per_s": 1e3 / wall_ms, "syncs_per_frame": syncs / n,
           "graphs": dict(pipe.graph_stats)}
    log(f"profile {mode}: {1e3 / wall_ms:.3f} scans/s in the steady state ({wall_ms:.2f} ms a scan), "
        f"{syncs / n:.2f} host synchronizations a frame, graphs {pipe.graph_stats}")
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    log(f"profile {mode}: {t_prof - t_in:.1f} s to the profiled chunk, {t_trace - t_prof:.1f} s in it (the trace "
        f"collected), {time.perf_counter() - t_trace:.1f} s in key_averages")
    if not kernels:  # the profiler may be unable to trace the card; the kernel times do not need it
        log(f"profile {mode}: the profiler saw no device kernel; device time per scan not measured")
        return {**res, "device_ms_per_scan": None, "device_kernels_per_scan": None, "device_busy": None,
                "kernel_ms_per_scan": None}
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    launches = sum(e.count for e in kernels) / n
    busy = dev_ms / wall_ms
    log(f"profile {mode}: {dev_ms:.3f} ms of device time and {launches:.0f} device kernels per scan; "
        f"device busy {100 * busy:.1f}% of the unprofiled {wall_ms:.2f} ms per scan")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    for e in top:
        log(f"  {e.self_device_time_total / 1e3 / n:8.3f} ms/scan {e.count / n:7.1f} calls/scan  {e.key[:90]}")
    ours = {k: sum(e.self_device_time_total for e in kernels if k in e.key) / 1e3 / n
            for k in ("cc_label_prop", "knn_top5")}
    log(f"profile {mode}: K1 {ours['cc_label_prop']:.4f} ms/scan, K2 {ours['knn_top5']:.4f} ms/scan of device time")
    return {**res, "device_ms_per_scan": dev_ms, "device_kernels_per_scan": launches, "device_busy": busy,
            "kernel_ms_per_scan": ours}


def run_lap_continuation(cfg, ckpt, cont, out):
    """The lap's saved state (frame N_LAP, `checkpoint.save` at the end of
    the lap) loaded into a fresh unsharded pipeline, graphed, and into one
    with `graphs=False`; each continued over the lap course's next N_CONT
    scans (frames 448-479, revisiting) through `run_chunked(chunk=32)`.
    Needs at least one loop attempt in each, and final keyframe poses and
    times bit-identical: `checkpoint.load` and the applied graph solves
    write the state in place, where the captured steps read it. The
    graphed run's final keyframes go to `out` (phase 7i's unsharded
    reference)."""
    from lego_loam_torch import checkpoint
    from lego_loam_torch.pipeline import LegoLoamPipeline

    res = {}
    for mode, kw in (("graphed", {}), ("eager", {"graphs": False})):
        gc.collect()
        pipe = checkpoint.load(LegoLoamPipeline(cfg, seed=0, **kw), ckpt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.run_chunked(cont, chunk=LAP_CHUNK)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        kf = pipe.keyframe_trajectory()
        if mode == "graphed":
            np.savez(out, R=kf[0], t=kf[1], seconds=dt)
        attempts = sum(1 for r in pipe.loop_diag if "icp_fitness" in r)
        solves = [r["graph_accepted"] for r in pipe.loop_diag if "graph_accepted" in r]
        res[mode] = {"seconds": dt, "attempts": attempts, "solves": solves, "kf": kf, "graphs": dict(pipe.graph_stats)}
        log(f"lap continuation {mode}: frames {N_LAP}-{N_LAP + N_CONT - 1} from the lap's checkpoint in {dt:.3f} s, "
            f"{attempts} attempts, graph solves {solves}, {len(kf[1])} keyframes, graphs {pipe.graph_stats}")
        del pipe
    same = all(np.array_equal(a, b) for a, b in zip(res["graphed"].pop("kf"), res["eager"].pop("kf")))
    log(f"lap continuation: final keyframe poses and times bit-identical, graphed and eager: {same}")
    if not (same and res["graphed"]["attempts"] >= 1 and res["eager"]["attempts"] >= 1):
        raise AssertionError(f"lap continuation: bit-identical {same}, {res}")
    res["kf_bit_identical"] = same
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from lego_loam_torch import cuda as kcuda
    from lego_loam_torch.config import hdl64e, vlp16, vlp32c
    from lego_loam_torch.ops.knn import top5_l2, top5_l2_plain
    from lego_loam_torch.ops.segmentation import label_prop, label_prop_plain

    t_start = time.perf_counter()

    def elapsed(phase):
        log(f"[{time.perf_counter() - t_start:.1f} s] phase {phase} done")

    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    reports = kcuda.build(force=True)
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(reports)} (nvcc, sm_90a, one process per source)")
    from lego_loam_torch import native

    t0 = time.perf_counter()
    native.build(force=True)
    log(f"build: {time.perf_counter() - t0:.2f} s for native/lego_native.cpp (g++ -O3, no -march=native)")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    cfg = vlp16()
    poses, scans = render(N_SLICE, cfg)
    gt = np.stack([t for _, t in poses])
    k1_masks, k1_err = {}, 0
    masks, err = check_k1(scans[:4], cfg, dev)
    k1_masks[16], k1_err = masks, max(k1_err, err)
    presets = {}
    for name, make in (("vlp32c", vlp32c), ("hdl64e", hdl64e)):
        pcfg = make()
        pgt, pscans = preset_scans(pcfg, N_PRESET)
        masks, err = check_k1(pscans[:4], pcfg, dev)
        k1_masks[pcfg.laser.num_vertical_scans], k1_err = masks, max(k1_err, err)
        presets[name] = (pcfg, pgt, pscans)
    shapes = check_k2(dev)
    elapsed("1-4")
    summary, launches, map_call, slice_poses = run_slice(cfg, scans, gt)
    dist_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dist_")
    dd = dist_tmp.name
    torch.save(map_call, os.path.join(dd, "map_call.pt"))
    np.save(os.path.join(dd, "slice_scans.npy"), np.stack(scans))  # phase 7i's sharded slice
    np.savez(os.path.join(dd, "slice_poses.npz"), gt=gt, **slice_poses)
    summary["scan_run"] = run_per_scan(cfg, scans, gt)
    elapsed("5")
    summary["ring"] = run_ring(cfg, scans, gt)
    elapsed("5b")
    summary["profile"] = {mode: profile_slice(cfg, scans, mode, **kw) for mode, kw in (
        ("graphed", {}), ("eager", {"graphs": False}), ("host-branching", {"sync_free": False, "graphs": False}))}
    elapsed("8 (the steady state)")
    summary["presets"] = {name: drive_preset(name, *args) for name, args in presets.items()}
    elapsed("6")
    summary["ablation"] = run_ablations(cfg, scans, gt, summary["profile"]["graphed"])
    elapsed("6b")
    t0 = time.perf_counter()
    bench_gt, bench_scans = bench_straight_scans(cfg)
    log(f"bench: rendered the straight course's {len(bench_scans)} swept scans in {time.perf_counter() - t0:.1f} s")
    summary["bench"] = run_bench_straight(bench_scans, bench_gt, dev)
    summary["bench_ablate"] = run_bench_ablate(bench_scans, bench_gt, dev)
    del bench_scans
    elapsed("6c")
    lcfg = lap_config()
    t0 = time.perf_counter()
    lap_poses, lap_gt, lap_scans, cont_scans = lap_course(lcfg)
    log(f"lap: rendered {N_LAP + N_CONT} swept scans in {time.perf_counter() - t0:.1f} s")
    np.save(os.path.join(dd, "lap_cont_scans.npy"), np.stack(cont_scans))  # phase 7i's continuation
    summary["lap"], icp_clouds = run_lap(lcfg, lap_gt, lap_scans, os.path.join(dd, "lap.npz"))
    summary["bench_line"] = check_bench_line(summary["bench"], summary["lap"]["bench"], card)
    elapsed("7")
    summary["lap_continuation"] = run_lap_continuation(lcfg, os.path.join(dd, "lap.npz"), cont_scans,
                                                       os.path.join(dd, "lap_cont_kf.npz"))
    elapsed("7, the continuation")
    icfg = dataclasses.replace(
        lcfg, pipeline=dataclasses.replace(lcfg.pipeline, use_imu_undistortion=True),
        odometry=dataclasses.replace(lcfg.odometry, odom_prior_mode="init"),
    )
    summary["imu_lap"] = run_imu_lap(icfg, lap_poses, lap_gt, lap_scans, summary["lap"]["ate_odom_m"])
    elapsed("7b")
    gc.collect()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        t0 = time.perf_counter()
        cli_truth, cli_scans, seq, bag = cli_fixture(cfg, d)
        log(f"CLI fixture: {N_CLI} swept scans rendered and written as KITTI and rosbag2 in "
            f"{time.perf_counter() - t0:.1f} s")
        summary["cli"] = run_cli(cli_truth, seq, bag, d)
        elapsed("7c")
        summary["checkpoint"] = run_checkpoint(cfg, cli_scans, d)
        summary["reloc"] = run_reloc(cfg, cli_truth, os.path.join(d, "out_kitti"), bag, d)
        summary["native"] = run_native(seq, cli_scans, cfg)
        elapsed("7d-7f")
        summary["eskf"] = run_eskf_phase(d)
        elapsed("7g")
        with open(os.path.join(dd, "cli.json"), "w") as fh:  # phase 7i's CLI over phase 7c's fixture
            json.dump({"seq": seq, "pose": os.path.join(d, "out_kitti", "pose.txt")}, fh)
        summary["dist"], sharded_clouds = run_dist(dd)
    summary["shard"] = summary["dist"].pop("shard")
    dist_tmp.cleanup()
    elapsed("7h and 7i")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_campus_") as d:
        summary["campus"] = run_campus(d)
    elapsed("7j")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_diag_") as d:
        summary["diag"] = run_diag(d)
    elapsed("7k")
    summary["store"] = run_full_store(card)
    elapsed("7l")

    # K1 times at the main path's shape: one launch per chunk of CHUNK scans
    k1_rows = []
    for H, masks in k1_masks.items():
        chunk_masks = [m.repeat(CHUNK // m.shape[0], 1, 1).contiguous() for m in masks]
        ms = time_ms(lambda: label_prop(*chunk_masks))
        dev_ms = kernel_ms(lambda: label_prop(*chunk_masks))
        plain = time_ms(lambda: label_prop_plain(*chunk_masks), reps=1, warmup=1)
        bound = chunk_masks[0].numel() * (5 + 4) / HBM_BYTES_PER_S * 1e3
        k1_rows.append({"shape": [CHUNK, H, 1800], "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
                        "bound_ms": bound, "bound_share": bound / dev_ms})
        log(f"K1 ({CHUNK}, {H}, 1800): {ms:.4f} ms a call, kernel alone {dev_ms:.4f} ms, "
            f"twin {plain:.3f} ms, "
            f"bound {bound:.6f} ms (bytes), {100 * bound / dev_ms:.2f}% of bound")
    main_k1 = k1_rows[0]
    records = [{
        "name": "cc_label_prop", "route": "cuda", "source": "lego_loam_torch/csrc/cc.cu",
        "replaces": "lego_loam_tpu/ops/pallas_cc.py:99", "launches": launches.get("cc_label_prop", 0),
        "launches_by_path": {path: summary[path]["launches"].get("cc_label_prop", 0) if path != "slice"
                             else launches.get("cc_label_prop", 0) for path in PATHS},
        "max_abs_err": k1_err, "ms": main_k1["ms"], "plain_ms": main_k1["plain_ms"],
        "bound_ms": main_k1["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "device_ms": main_k1["device_ms"], "bound_share": main_k1["bound_share"],
        "shape": main_k1["shape"],
        "heights": k1_rows,
    }]
    per_shape = []
    shapes["loop icp"] = (*icp_clouds, summary["lap"]["k2_loop_icp_max_abs_err"])
    shapes["mapping sharded"] = (*sharded_clouds, summary["dist"]["k2_max_abs_err"])
    for name, (q, t, m, err) in shapes.items():
        Q, T = q.shape[0], t.shape[0]
        ms = time_ms(lambda: top5_l2(q, t, m))
        dev_ms = kernel_ms(lambda: top5_l2(q, t, m))
        plain = time_ms(lambda: top5_l2_plain(q, t, m))
        tm = t[m].contiguous()
        lib = time_ms(lambda: torch.topk(torch.cdist(q, tm), 5, largest=False))
        # 8 fp32 operations per (query, unmasked target) pair: 3 FMAs of q.t,
        # the sum with |q|^2 + |t|^2, the clamp and the compare with the 5th best
        ops = Q * tm.shape[0] * 8 / FP32_OPS_PER_S * 1e3
        byts = (Q * 12 + T * 13 + Q * 40) / HBM_BYTES_PER_S * 1e3
        bound_by = "operations" if ops >= byts else "bytes"
        bound = max(ops, byts)
        site = "knn_top5@" + name.replace(" ", "_")
        path = {"loop icp": "lap", "mapping sharded": "dist"}.get(name, "slice")
        per_shape.append({"shape": name, "Q": Q, "T": T, "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
                          "library_ms": lib, "bound_ms": bound, "bound_by": bound_by, "bound_share": bound / dev_ms,
                          "launches": (summary[path] if path != "slice" else summary)["launches_by_site"].get(site, 0),
                          "launches_in": path, "launches_imu_lap": summary["imu_lap"]["launches_by_site"].get(site, 0),
                          "launches_ablation": summary["ablation"]["launches_by_site"].get(site, 0),
                          "launches_campus": summary["campus"]["launches_by_site"].get(site, 0),
                          "launches_by_path": {p: (summary[p] if p != "slice" else summary)["launches_by_site"].get(
                              site, 0) for p in PATHS},
                          "max_abs_err": err})
        log(f"K2 {name} Q={Q} T={T} ({tm.shape[0]} unmasked): {ms:.4f} ms a call, kernel alone {dev_ms:.4f} ms, "
            f"twin {plain:.4f} ms, cdist+topk {lib:.4f} ms, bound {bound:.5f} ms ({bound_by}), "
            f"{100 * bound / dev_ms:.1f}% of bound, "
            f"{per_shape[-1]['launches']} launches in the {path} drive")
    # K2 at the row-block shapes a store over W ranks gives the scan-to-map
    # search: the first of W blocks of the mapping clouds
    blocks = []
    for name in ("mapping corner", "mapping surf"):
        q, t, m, _ = shapes[name]
        for W in (2, 4):
            tb, mb = t[: t.shape[0] // W].contiguous(), m[: t.shape[0] // W].contiguous()
            ms = time_ms(lambda: top5_l2(q, tb, mb))
            dev_ms = kernel_ms(lambda: top5_l2(q, tb, mb))
            plain = time_ms(lambda: top5_l2_plain(q, tb, mb))
            tmb = tb[mb].contiguous()
            lib = time_ms(lambda: torch.topk(torch.cdist(q, tmb), 5, largest=False))
            ops = q.shape[0] * tmb.shape[0] * 8 / FP32_OPS_PER_S * 1e3
            byts = (q.shape[0] * 12 + tb.shape[0] * 13 + q.shape[0] * 40) / HBM_BYTES_PER_S * 1e3
            blocks.append({"shape": f"{name} block 1/{W}", "Q": q.shape[0], "T": tb.shape[0], "ms": ms,
                           "device_ms": dev_ms, "plain_ms": plain, "library_ms": lib, "bound_ms": max(ops, byts),
                           "bound_by": "operations" if ops >= byts else "bytes"})
            log(f"K2 {name} block 1/{W} Q={q.shape[0]} T={tb.shape[0]}: {ms:.4f} ms a call, kernel alone "
                f"{dev_ms:.4f} ms, twin {plain:.4f} ms, cdist+topk {lib:.4f} ms, bound {max(ops, byts):.5f} ms")
    big = next(r for r in per_shape if r["shape"] == "mapping surf")
    records.append({
        "name": "knn_top5", "route": "cuda", "source": "lego_loam_torch/csrc/knn.cu",
        "replaces": "lego_loam_tpu/ops/pallas_knn.py:118", "launches": launches.get("knn_top5", 0),
        "launches_by_path": {path: summary[path]["launches"].get("knn_top5", 0) if path != "slice"
                             else launches.get("knn_top5", 0) for path in PATHS},
        "max_abs_err": max([s["max_abs_err"] for s in per_shape] + [summary["k2_path_max_abs_err"]]),
        "ms": big["ms"],
        "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "library_ms": big["library_ms"], "device_ms": big["device_ms"],
        "bound_share": big["bound_share"],
        "shapes": per_shape, "blocks": blocks,
    })
    prof = summary["profile"]
    busy = {m: "not measured" if p["device_busy"] is None else f"{100 * p['device_busy']:.1f}%" for m, p in prof.items()}
    log(f"graphs: slice {summary['graphs']}, lap continuation {summary['lap_continuation']['graphed']['graphs']}; "
        f"slice {summary['scans_per_s']:.3f} scans/s graphed against {summary['eager_scans_per_s']:.3f} with "
        f"graphs=False (first use included); steady state " + "; ".join(
            f"{m} {p['scans_per_s']:.3f} scans/s, device busy {busy[m]}, {p['syncs_per_frame']:.2f} host "
            f"synchronizations a frame" for m, p in prof.items()))
    log(json.dumps({"slice": summary}))
    log(card_line())
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(dist_phase(sys.argv[2]) if sys.argv[1:2] == ["--dist-phase"] else main())
