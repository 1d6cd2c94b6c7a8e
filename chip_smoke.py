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
     drive through `LegoLoamPipeline.run_chunked`; map ATE < 0.1 m, every
     output finite, both kernels launched on the path and K2 at all four
     call sites (odometry and mapping, corner and surf clouds); then the
     per-scan entry point, `run` over its first 4 scans through
     `process_scan` (float32 points projected on the card), with the same
     checks;
  6. short drives of `vlp32c()` and `hdl64e()` at full width, 8 scans each
     in one chunk with loop closure off (the settings of
     tests/test_presets_e2e.py at the presets' own capacities): finite
     output, map-position error < 0.5 m at every scan, K1 launched;
  7. the loop-closing drive: bench.py's flagship configuration (`vlp16()`,
     loop closure on, 20,480 keyframes, the rest at its defaults) over
     448 swept scans of a campus lap course (laps of 340 frames, one lap
     and 108 revisit frames) through `warmup_loop_closure` and
     `run_chunked(chunk=32)`: at least one attempt, one accepted closure
     and one applied graph solve, finite output, the corrected keyframe
     ATE < 0.5 m and at most the uncorrected map ATE + 0.05 m, K1 and K2
     (also at loop_icp) launched; then K2 on one real loop_icp call's
     clouds against its twin and a float64 brute force, each tolerance
     that pair's own float32 rounding, the attempt's and the solve's
     times, and `reduced_solve` on the card against the same call on the
     CPU;
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
  7g. the ESKF study: `run_eskf` over a generated 3,000-tick turn on the
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
     set-up and each solve timed;
  8. torch.profiler over one warm chunk of 4 scans: device time and device
     kernels per scan, the device's busy share, the costliest kernels
     ("not measured" where the profiler cannot trace the card);
  9. times with CUDA events after warm-up: K1 on a 16-scan chunk at each
     height and K2 at the path's shapes (loop_icp's and mapping_sharded's
     included), a call (host included) and the
     device's time alone (the host's share hidden behind a sleep kernel),
     each beside its twin and its bound (and, for K2, torch.cdist +
     torch.topk, a yardstick the port never calls); the slice's scans/s and
     peak memory.

Prints one JSON line of kernel records, then `{"ok": true, ...}` last.
Exits non-zero on any failure, or at once when no CUDA device is visible.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

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
PATHS = ("slice", "scan_run", "lap", "imu_lap", "cli", "reloc", "dist")
N_CLI = 64  # swept scans of the KITTI / rosbag2 fixture (tools/make_fixtures.py's course)
ESKF_TICKS = 3000  # 30 s of sensor data (5,000 until the script grew by phase 7h)
ROOT = Path(__file__).resolve().parent
K2_SITES = ("odometry_corner", "odometry_surf", "mapping_corner", "mapping_surf")
# The lap drive: bench.py's flagship configuration over a shorter campus
# lap (340 frames, 34 s, longer than the 30 s loop_time_gap), cut after one
# lap and 108 revisit frames: 14 chunks of 32.
LAP_STRAIGHT, LAP_TURN, N_LAP, LAP_CHUNK = 70, 15, 448, 32


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

    def call(c_xyz, c_m, s_xyz, s_m, R0, t0, submap, cfg):
        rec.update(q=s_xyz.clone(), q_mask=s_m.clone(), R=R0.clone(), t=t0.clone(),
                   map=submap.surf_xyz.clone(), map_mask=submap.surf_mask.clone())
        return fn(c_xyz, c_m, s_xyz, s_m, R0, t0, submap, cfg)

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


def run_slice(cfg, scans, gt):
    from lego_loam_torch import cuda as kcuda
    from lego_loam_torch.pipeline import LegoLoamPipeline

    # warm-up on other scans: loads the kernels, fills the allocator, and
    # records the clouds of one real call at each of K2's call sites
    seen, map_call = recording_k2_sites(
        lambda: recording_map_call(lambda: LegoLoamPipeline(cfg, seed=1).run_chunked(scans[:4], chunk=4))
    )
    torch.cuda.synchronize()
    path_err = check_k2_on_path(seen)
    torch.cuda.reset_peak_memory_stats()
    pipe = LegoLoamPipeline(cfg, seed=0)
    kcuda.reset_counts()
    t0 = time.perf_counter()
    out = pipe.run_chunked(scans, chunk=CHUNK)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kcuda.LAUNCHES)
    sites = dict(kcuda.SITES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    for k in ("map_positions", "odom_positions", "fused_positions"):
        a = np.asarray(out[k])
        if a.shape != (len(scans), 3) or not np.isfinite(a).all():
            raise AssertionError(f"{k}: shape {a.shape} or non-finite values")
    if not np.isfinite(np.asarray(pipe.trajectory["rpys"])).all():
        raise AssertionError("non-finite map attitude")
    ate_map = ate(out["map_positions"], gt)
    ate_odom = ate(out["odom_positions"], gt)
    log(f"slice: {len(scans)} scans in {dt:.3f} s = {len(scans) / dt:.3f} scans/s, peak device memory {peak:.3f} GiB")
    log(f"slice: map ATE {ate_map:.4f} m, odometry ATE {ate_odom:.4f} m (no alignment)")
    log(f"slice: launches {launches}, by site {sites}")
    if not ate_map < 0.1:
        raise AssertionError(f"map ATE {ate_map:.4f} m >= 0.1 m")
    if not (launches.get("cc_label_prop", 0) > 0 and all(sites.get(f"knn_top5@{k}", 0) > 0 for k in K2_SITES)):
        raise AssertionError(f"a kernel of the path was not launched: {launches} {sites}")
    return {"scans_per_s": len(scans) / dt, "scans": len(scans), "seconds": dt, "peak_gib": peak,
            "ate_map_m": ate_map, "ate_odom_m": ate_odom, "launches_by_site": sites,
            "k2_path_max_abs_err": path_err}, launches, map_call


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



def lap_course(cfg):
    """bench.py's campus course with laps of LAP_STRAIGHT/LAP_TURN frames a
    side, cut after N_LAP frames: true poses and positions and swept renders
    (1 cm noise, seed 100 + i), made before any timing."""
    from lego_loam_torch.io.synthetic import campus_world, lap_trajectory, render_scan_swept

    poses = lap_trajectory(2, straight_frames=LAP_STRAIGHT, turn_frames=LAP_TURN)[:N_LAP]
    world = campus_world(poses)
    scans = [render_scan_swept(poses[max(i - 1, 0)], poses[i], cfg, world, noise=0.01, seed=100 + i)
             for i in range(N_LAP)]
    return poses, np.stack([t for _, t in poses]), scans


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


def drive_lap(cfg, gt, scans, name, drive):
    """A loop-closing drive of the lap course: a fresh pipeline,
    `warmup_loop_closure`, then `drive(pipe)` timed with the launch counts
    set to 0 just before it and read just after. Fails unless an attempt
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kcuda.reset_counts()
    t0 = time.perf_counter()
    out = drive(pipe)
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
    20,480 keyframes, through `warmup_loop_closure` and
    `run_chunked(chunk=32)`, with `drive_lap`'s checks; then K2 on one
    real loop_icp call's clouds, the attempt's and the solve's times, and
    `reduced_solve` on the card against the CPU. The final state is saved
    to `ckpt` (`checkpoint.save`) for phase 7h."""
    log(f"lap: {N_LAP} frames of campus laps of {4 * (LAP_STRAIGHT + LAP_TURN)} (straight {LAP_STRAIGHT}, turn "
        f"{LAP_TURN}): one lap and {N_LAP - 4 * (LAP_STRAIGHT + LAP_TURN)} revisit frames, cut from bench.py's "
        f"1,376 frames of 700-frame laps (straight 150, turn 25)")
    pipe, summary = drive_lap(cfg, gt, scans, "lap", lambda p: p.run_chunked(scans, chunk=LAP_CHUNK))

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

    def drive(pipe):
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
    return {"runs": runs, "launches": total}


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

    from lego_loam_torch import checkpoint, launch
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

    # the map step on the CPU (gloo), against the card's
    dist.destroy_process_group()
    D.init_distributed(f"127.0.0.1:{launch._free_port()}", 1, 0, device="cpu")
    cpu_R, cpu_t = D.sharded_map_gn_step(D.make_mesh(), cfg)(*(x.cpu() for x in margs))
    dist.destroy_process_group()
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
            "reruns_bit_identical": reruns, "hashgrid_ms": grid_ms, "hashgrid_recall": recall,
        }, fh)
    return 0


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


def profile_slice(cfg, scans, wall_ms_per_scan):
    """Device time per scan under torch.profiler over one warm chunk, and
    its share of the unprofiled wall time per scan (the profiler slows the
    host, not the kernels). Prints the kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lego_loam_torch.pipeline import LegoLoamPipeline

    pipe = LegoLoamPipeline(cfg, seed=2)
    pipe.process_chunk(scans[:4])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe.process_chunk(scans[4:8])
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not kernels:  # the profiler may be unable to trace the card; the kernel times do not need it
        log("profile: the profiler saw no device kernel; device time per scan not measured")
        return {"device_ms_per_scan": None, "device_kernels_per_scan": None, "device_busy": None,
                "kernel_ms_per_scan": None}
    n = 4
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    launches = sum(e.count for e in kernels) / n
    busy = dev_ms / wall_ms_per_scan
    log(f"profile: {dev_ms:.3f} ms of device time and {launches:.0f} device kernels per scan; "
        f"device busy {100 * busy:.1f}% of the unprofiled {wall_ms_per_scan:.1f} ms per scan")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    for e in top:
        log(f"  {e.self_device_time_total / 1e3 / n:8.3f} ms/scan {e.count / n:7.1f} calls/scan  {e.key[:90]}")
    ours = {k: sum(e.self_device_time_total for e in kernels if k in e.key) / 1e3 / n
            for k in ("cc_label_prop", "knn_top5")}
    log(f"profile: K1 {ours['cc_label_prop']:.4f} ms/scan, K2 {ours['knn_top5']:.4f} ms/scan of device time")
    return {"device_ms_per_scan": dev_ms, "device_kernels_per_scan": launches, "device_busy": busy,
            "kernel_ms_per_scan": ours}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from lego_loam_torch import cuda as kcuda
    from lego_loam_torch.config import hdl64e, vlp16, vlp32c
    from lego_loam_torch.ops.knn import top5_l2, top5_l2_plain
    from lego_loam_torch.ops.segmentation import label_prop, label_prop_plain

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
    summary, launches, map_call = run_slice(cfg, scans, gt)
    dist_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dist_")
    dd = dist_tmp.name
    torch.save(map_call, os.path.join(dd, "map_call.pt"))
    summary["scan_run"] = run_per_scan(cfg, scans, gt)
    summary.update(profile_slice(cfg, scans, 1e3 * summary["seconds"] / summary["scans"]))
    summary["presets"] = {name: drive_preset(name, *args) for name, args in presets.items()}
    lcfg = lap_config()
    t0 = time.perf_counter()
    lap_poses, lap_gt, lap_scans = lap_course(lcfg)
    log(f"lap: rendered {N_LAP} swept scans in {time.perf_counter() - t0:.1f} s")
    summary["lap"], icp_clouds = run_lap(lcfg, lap_gt, lap_scans, os.path.join(dd, "lap.npz"))
    icfg = dataclasses.replace(
        lcfg, pipeline=dataclasses.replace(lcfg.pipeline, use_imu_undistortion=True),
        odometry=dataclasses.replace(lcfg.odometry, odom_prior_mode="init"),
    )
    summary["imu_lap"] = run_imu_lap(icfg, lap_poses, lap_gt, lap_scans, summary["lap"]["ate_odom_m"])
    gc.collect()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        t0 = time.perf_counter()
        cli_truth, cli_scans, seq, bag = cli_fixture(cfg, d)
        log(f"CLI fixture: {N_CLI} swept scans rendered and written as KITTI and rosbag2 in "
            f"{time.perf_counter() - t0:.1f} s")
        summary["cli"] = run_cli(cli_truth, seq, bag, d)
        summary["checkpoint"] = run_checkpoint(cfg, cli_scans, d)
        summary["reloc"] = run_reloc(cfg, cli_truth, os.path.join(d, "out_kitti"), bag, d)
        summary["native"] = run_native(seq, cli_scans, cfg)
        summary["eskf"] = run_eskf_phase(d)
    summary["dist"], sharded_clouds = run_dist(dd)
    dist_tmp.cleanup()

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
                          "max_abs_err": err})
        log(f"K2 {name} Q={Q} T={T} ({tm.shape[0]} unmasked): {ms:.4f} ms a call, kernel alone {dev_ms:.4f} ms, "
            f"twin {plain:.4f} ms, cdist+topk {lib:.4f} ms, bound {bound:.5f} ms ({bound_by}), "
            f"{100 * bound / dev_ms:.1f}% of bound, "
            f"{per_shape[-1]['launches']} launches in the {path} drive")
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
        "shapes": per_shape,
    })
    log(json.dumps({"slice": summary}))
    log(card_line())
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(dist_phase(sys.argv[2]) if sys.argv[1:2] == ["--dist-phase"] else main())
