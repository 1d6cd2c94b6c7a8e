"""Host orchestrator: per-scan odometry and mapping over chunks of scans,
with loop closure (port of `lego_loam_tpu/pipeline.py`).

`process_chunk` runs C scans in three steps: a prepass over the chunk (the
per-scan work that depends on no earlier scan: range-image reconstruction,
ground removal, the connected components of all C scans in one K1 launch,
one cluster per scan, and the IMU integration), then per frame a front step
(segmentation and features, the two-step scan-to-scan solve, the deskew and
the fused pose) and, on a mapped frame, a map step (downsampling, the
scan-to-map solve and the keyframe append). The reference runs the frames
inside one `lax.scan` (`_build_chunk_runner`) and the per-scan path as two
jitted programs (`frontend_step_fused`, `backend_step`).

With `sync_free` (the default on a GPU) the steps make no host read: every
data-dependent branch and loop exit is decided on the device (see
`control.py`), with the early-exit path's results bit for bit. With
`graphs` (the default on a GPU) each step is captured as a CUDA graph at its
second use and replayed (`graphs.py`): the prepass once per chunk, front and
map once per frame, the inputs copied in and the outputs copied out into
(C, ...) buffers, so no host read happens inside a chunk. The state lives
in fixed buffers that every writer updates in place. A store in row blocks
or a world of more than one rank runs the same steps without capture.

Loop closure keeps the reference's asynchronous schedule (see
`_try_loop_closure`): a candidate probe after each checked chunk, read two
checks later; an attempt program (coarse align + ICP through K2), read one
check later; an anchor-segment pose-graph solve at every
`loop_solve_every_accepts`-th accepted closure and at the end of the
stream, applied on the device by its own cost gate.

With `use_imu_undistortion`, each scan's IMU window (staged with its chunk,
or packed by `process_scan`) is integrated on the device, undistorts the
segmented cloud and anchors the solved attitude; with `odom_prior_mode`,
consecutive wheel-odometry poses give the scan-to-scan solve its motion
prior. The previous odometry pose is carried on the host (`_last_odom`),
shared by the chunk and the per-scan paths as in the reference.
`publish_global_map` assembles the global map on the host every
`global_map_every_n_frames` mapped frames; `save_artifacts` writes the
reference's run artifacts.

In a process group of more than one rank (`launch.init_from_args`), with
`use_sharded_posegraph`, every graph solve is the whole-graph GN of
`distributed.sharded_pose_graph_solver` over factors assembled on the host,
each rank solving with its row block of them, as the reference does with
more than one device; its cost gate reads the result back. With
`shard_backend` the keyframe store and the submap lie in row blocks over
the ranks (`distributed.shard_backend_state`): the state carries that
layout, and each access to the store (the radius search, submap assembly
and its 5-NN, the keyframe append, loop closure, the graph solves, the
products and the checkpoint) goes through the store helpers of
`distributed.py`, which take either layout; a caller may also lay out
`bstate` itself. Every rank runs the same stream and ends with the same
bits as one unsharded process; rank 0 alone writes files. On one rank both
packages take the anchor-segment solve.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from .backend import BackendState, backend_step_ds, downsample_clouds, init_backend_state
from .config import LegoLoamConfig
from .distributed import (
    RowBlock,
    all_rows,
    assign,
    assign_state,
    gather_rows,
    is_writer,
    make_mesh,
    set_rows,
    shard_backend_state,
    shard_rows,
    sharded_pose_graph_solver,
)
from .frontend import deskew_outliers, frontend_solve, imu_attitude, init_odometry_state, segment_features
from .fusion import fuse_pose
from .graphs import StepGraphs
from .imu import ImuTrack, integrate_imu, odom_prior_motion
from .loopclosure import attempt_loop_closure, compute_loopinfo
from .mapping import MapDiag
from .math import se3
from .ops.ground import apply_ground, ransac_scores
from .ops.projection import grid_from_range_image, host_pack_range_image, project_point_cloud
from .ops.segmentation import converged_labels
from .posegraph import Factors, anchor_stride, graph_cost, reduced_solve
from .types import OdometryState, ScanGrid, named_leaves
from .utils.profiling import synchronize


@dataclasses.dataclass
class LoopFactor:
    i: int
    j: int
    R: np.ndarray
    t: np.ndarray
    fitness: float


class LegoLoamPipeline:
    """End-to-end odometry + mapping (+ loop closure) on one device
    (default: the GPU).

    ground_scores: optional callable frame_idx -> (ransac_iterations, H*W)
    tensor of uniform draws for the ground NEAR pass. By default they come
    from a `torch.Generator` on the pipeline's device seeded from (seed,
    frame); tests pass the reference's draw to compare frame by frame.

    profile: `process_scan` waits for the device before and after each
    mapping step and records the wall time between in
    diagnostics["mapping_ms"] (written to mapt.txt), as the reference's
    profile=True does; the default path adds no wait.

    sync_free: the frame steps decide every branch on the device and read
    nothing back (default: on a CUDA device). graphs: they are captured as
    CUDA graphs and replayed (default: with sync_free on a CUDA device;
    `graphs=False` runs the same steps eagerly). `graph_stats` counts the
    captures, recaptures and replays."""

    def __init__(self, cfg: LegoLoamConfig, seed: int = 0, device="cuda", ground_scores=None, profile: bool = False,
                 sync_free: bool | None = None, graphs: bool | None = None):
        if cfg.mapping.enable_loop_closure:
            anchor_stride(cfg)  # refuses a stride that leaves too many anchors, before any allocation
        # More than one rank: the reference's mesh (`len(jax.devices()) > 1`).
        self._mesh = None
        self._solve_graph_sharded = None
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1 and (
            cfg.distributed.use_sharded_posegraph or cfg.distributed.shard_backend
        ):
            self._mesh = make_mesh()
            if cfg.distributed.use_sharded_posegraph:
                self._solve_graph_sharded = sharded_pose_graph_solver(self._mesh, cfg)
        self.cfg = cfg
        self.seed = seed
        self.device = torch.device(device)
        self.profile = profile
        on_card = self.device.type == "cuda"
        self.sync_free = on_card if sync_free is None else bool(sync_free)
        self.graphs = self.sync_free and on_card if graphs is None else bool(graphs)
        if self.graphs and not (self.sync_free and on_card):
            raise ValueError("graphs=True needs sync_free and a CUDA device")
        self._graphs = StepGraphs()
        self.graph_stats = self._graphs.stats
        self._ground_scores = ground_scores or self._draw_scores
        self.fstate: OdometryState = init_odometry_state(cfg, self.device)
        self.bstate: BackendState = init_backend_state(cfg, self.device)
        if self._mesh is not None and cfg.distributed.shard_backend:
            # the keyframe store and the submap in row blocks over the ranks
            self.bstate = shard_backend_state(self._mesh, self.bstate)
        self.frame_idx = 0
        self._use_imu = cfg.pipeline.use_imu_undistortion
        self._use_odom = cfg.odometry.odom_prior_mode != "off"
        self._last_odom = None  # host (R, t) of the latest wheel-odometry pose
        self._stop_requested = False
        self._log = {k: [] for k in ("odom_t", "fused_t", "map_R", "map_t", "map_time")}
        self._diags: list[MapDiag] = []
        # mapping_ms: per mapped frame, the wall time between successive
        # process_chunk calls over the previous chunk's mapped frames (the
        # first gap, which includes first use, is dropped), as the
        # reference's chunk path fills mapt.txt
        self.diagnostics = {"mapping_ms": [], "iterations": [], "records": []}
        self._chunk_t_prev = None
        self._chunk_mapped_prev = 0
        self._chunks_timed = 0
        # global map, every global_map_every_n_frames mapped frames
        self.latest_global_map = None
        self.global_map_count = 0
        self._mapped_frames = 0
        self._next_global_map = cfg.mapping.global_map_every_n_frames
        self.trajectory = {"positions": [], "rpys": [], "times": []}
        self.odom_positions = self.fused_positions = None
        self._finalized = False
        self._stager = None  # one worker thread staging the next chunk (run_chunked)

        # Loop closure. loop_factors is the host mirror of the accepted
        # factors; _loop_buf the fixed-capacity device buffer (ABSOLUTE
        # keyframe ids) that the pose-graph solve reads, written in place.
        self.loop_factors: list[LoopFactor] = []
        self._loop_buf = self._empty_loop_buf()
        self._loop_write = 0
        # Candidate probes waiting to be read, the attempt and the solve in
        # flight (their outputs and the check they were dispatched at).
        self._linfo_q: list = []
        self._attempt_pending = None
        self._solve_pending = None
        self._check_seq = 0
        self._solved_at = 0  # len(loop_factors) at the last graph solve
        self.loop_diag: list[dict] = []  # one record per evaluated probe
        self._loop_cooldown_until = 0
        self._last_loop_check = -(10 ** 9)
        self._last_attempt = None  # (cand_slot, cur_slot, n_kf) of the last attempt

    def _draw_scores(self, frame: int):
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed << 32) + frame)
        return ransac_scores(self.cfg, g, self.device)

    # -- input prep ---------------------------------------------------------

    def _pack_points(self, scans):
        """(C, max_points, 3) float32 points with their (C, max_points)
        mask; NaN rows are misses."""
        n = self.cfg.laser.max_points
        buf = np.zeros((len(scans), n, 3), np.float32)
        m = np.zeros((len(scans), n), bool)
        for c, points in enumerate(scans):
            k = min(len(points), n)
            m[c, :k] = np.isfinite(points[:k]).all(axis=1)
            buf[c, :k] = np.nan_to_num(points[:k])
        return {"pts": buf, "mask": m}

    def _prep_many(self, scans):
        """Pack raw clouds ((N, 3), NaN rows = misses) into the chunk feed.

        feed_mode "range" (with feed_quant > 0): per scan a (H, W) range
        image with int8 azimuth/elevation residuals and per-row beam
        elevations. Otherwise: (C, max_points, 3) points (int16 at feed_quant,
        or float32) with a mask, projected on the device."""
        cfg = self.cfg
        C = len(scans)
        if cfg.pipeline.feed_mode == "range" and cfg.pipeline.feed_quant > 0:
            H, W = cfg.laser.num_vertical_scans, cfg.laser.num_horizontal_scans
            rimg = np.zeros((C, H, W), np.uint16)
            azr = np.zeros((C, H, W), np.int8)
            elr = np.zeros((C, H, W), np.int8)
            rowe = np.zeros((C, H), np.float32)
            for c, points in enumerate(scans):
                rimg[c], azr[c], elr[c], rowe[c] = host_pack_range_image(points, cfg)
            return {"rimg": rimg, "azr": azr, "elr": elr, "rowe": rowe}
        feed = self._pack_points(scans)
        q = cfg.pipeline.feed_quant
        if q > 0:
            feed["pts"] = np.clip(np.rint(feed["pts"] * (1.0 / q)), -32767, 32767).astype(np.int16)
        return feed

    def stage_chunk(self, pts, masks=None, timestamps=None, imu=None, odom=None) -> dict:
        """Move one chunk's inputs to the device without processing them.

        pts: a `_prep_many` feed, a (C, max_points, 3) array with its
        (C, max_points) masks, or a list of raw (N, 3) clouds (packed here
        by `_prep_many`). Range codes go up as int32; timestamps, when
        given, as float32. With `use_imu_undistortion`, imu is the chunk's
        sample windows {"t": (C, S), "rpy": (C, S, 3), "acc": (C, S, 3),
        "mask": (C, S)} (S = imu_window; all masked when None); with the
        wheel-odometry prior, odom is ((C, 3, 3), (C, 3)) poses (identity
        when None), kept on the host as well for `process_chunk`."""
        if isinstance(pts, dict):
            prep = pts
        elif masks is not None:
            prep = {"pts": pts, "mask": masks}
        else:
            prep = self._prep_many(pts)
        dev = self.device
        xs = {}
        for k, v in prep.items():
            v = np.asarray(v)
            if v.dtype == np.uint16:
                v = v.astype(np.int32)
            xs[k] = torch.from_numpy(v).to(dev)
        C = int(next(iter(xs.values())).shape[0])
        if timestamps is not None:
            xs["ts"] = torch.as_tensor(np.asarray(timestamps, np.float32), device=dev)
        if self._use_imu:
            S = self.cfg.pipeline.imu_window
            if imu is None:
                imu = {"t": np.zeros((C, S)), "rpy": np.zeros((C, S, 3)), "acc": np.zeros((C, S, 3)),
                       "mask": np.zeros((C, S), bool)}
            xs["imu"] = {
                k: torch.from_numpy(np.asarray(imu[k], bool if k == "mask" else np.float32)).to(dev)
                for k in ("t", "rpy", "acc", "mask")
            }
        if self._use_odom:
            if odom is None:
                R, t = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1)), np.zeros((C, 3), np.float32)
            else:
                R, t = np.array(odom[0], np.float32), np.array(odom[1], np.float32)
            xs["odom_R"], xs["odom_t"] = torch.from_numpy(R).to(dev), torch.from_numpy(t).to(dev)
            xs["odom_host"] = (R, t)
        return xs

    def stage_chunk_async(self, pts, masks=None, timestamps=None, imu=None, odom=None):
        """`stage_chunk` in a background thread; returns a Future of the
        staged feed. Call it for chunk c+1 right after dispatching chunk c,
        so the host-side packing (of a list of raw clouds) and transfer
        overlap the frame loop."""
        return self._stager_submit(self.stage_chunk, pts, masks, timestamps, imu, odom)

    # -- chunk runner ---------------------------------------------------------

    def _grid(self, xs, c) -> ScanGrid:
        cfg = self.cfg
        if "rimg" in xs:
            return grid_from_range_image(xs["rimg"][c], xs["azr"][c], xs["elr"][c], xs["rowe"][c], cfg)
        pts = xs["pts"][c]
        if not pts.is_floating_point():
            pts = pts.to(torch.float32) * cfg.pipeline.feed_quant
        return project_point_cloud(pts, xs["mask"][c], cfg)

    # The three steps. Each takes a dict of input tensors and returns a dict
    # of output tensors; the front and map steps read the state and write it
    # in place, so that a captured graph finds it where it was captured.

    def _prepass_step(self, x) -> dict:
        """The chunk's grids (range image or projection) grounded with the
        scores drawn for each scan, their connected components in one K1
        launch, and the IMU tracks: (C, ...) outputs."""
        cfg = self.cfg
        grids = [apply_ground(self._grid(x, c), cfg, x["scores"][c]) for c in range(x["scores"].shape[0])]
        out = {f"grid.{f.name}": torch.stack([getattr(g, f.name) for g in grids]) for f in dataclasses.fields(ScanGrid)}
        out["raw"], _ = converged_labels(ScanGrid(**{k[5:]: v for k, v in out.items()}), cfg)
        if self._use_imu:  # all C windows at once
            track = integrate_imu(x["imu.t"], x["imu.rpy"], x["imu.acc"], mask=x["imu.mask"])
            out.update({f"imu.{f.name}": getattr(track, f.name) for f in dataclasses.fields(ImuTrack)})
        return out

    def _front_step(self, x) -> dict:
        """One frame's segmentation, features (undistorted with its IMU
        track), scan-to-scan solve (seeded by its wheel-odometry prior), the
        deskew of its map clouds and its fused pose; the odometry state is
        written in place."""
        cfg = self.cfg
        grid = ScanGrid(**{f.name: x[f"grid.{f.name}"] for f in dataclasses.fields(ScanGrid)})
        track = ImuTrack(**{f.name: x[f"imu.{f.name}"] for f in dataclasses.fields(ImuTrack)}) if self._use_imu else None
        prior = None
        if self._use_odom:
            prior = odom_prior_motion(self.fstate.R_world, self.fstate.t_world, x["odom_prev_R"], x["odom_prev_t"],
                                      x["odom_R"], x["odom_t"], cfg.odometry.odom_lever_arm)
        _grid, seg, feats = segment_features(grid, cfg, x["raw"], track)
        imu_att = imu_attitude(track) if track is not None else None
        new_state, out = frontend_solve(feats, self.fstate, cfg, prior, imu_att, sync_free=self.sync_free)
        bs = self.bstate
        # Fused pose from the latest *available* map pose (one frame
        # stale, as the reference's asynchronous fusion node).
        Rf, tf = fuse_pose(bs.R_map, bs.t_map, bs.R_odom, bs.t_odom, out["R_world"], out["t_world"])
        assign_state(self.fstate, new_state)
        return {
            "R_odom": out["R_world"], "t_odom": out["t_world"], "R_fused": Rf, "t_fused": tf,
            "corner": out["map_corner"].xyz, "corner_mask": out["map_corner"].mask,
            "surf": out["map_surf"].xyz, "surf_mask": out["map_surf"].mask,
            "outlier": deskew_outliers(seg, out["M_R_avg"], out["M_t_avg"], cfg), "outlier_mask": seg.outlier_mask,
        }

    def _map_step(self, x) -> dict:
        """One mapped frame: its clouds downsampled, registered to the
        submap and appended as a keyframe; the back-end state is written in
        place."""
        cfg = self.cfg
        ds = downsample_clouds(x["corner"], x["corner_mask"], x["surf"], x["surf_mask"], x["outlier"],
                               x["outlier_mask"], cfg)
        new_state, (R_map, t_map), diag = backend_step_ds(
            self.bstate, *ds, x["R_odom"], x["t_odom"], x["time"], cfg, sync_free=self.sync_free
        )
        assign_state(self.bstate, new_state)
        return {"R_map": R_map, "t_map": t_map, **{f"diag.{k}": v for k, v in diag._asdict().items()}}

    _MAP_INPUTS = ("corner", "corner_mask", "surf", "surf_mask", "outlier", "outlier_mask", "R_odom", "t_odom")

    def _capturable(self) -> bool:
        """Graphs on, the store not in row blocks and one rank: the steps
        are captured; otherwise they run eagerly (capture with collectives
        is not done)."""
        if not self.graphs or any(isinstance(leaf, RowBlock) for _, leaf in named_leaves(self.bstate)):
            return False
        return not (dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1)

    def _step(self, kind, key, fn, x) -> dict:
        if not self._capturable():
            return fn(x)
        return self._graphs.run(kind, key, fn, x, (self.fstate, self.bstate))

    def _frames(self, xs, kf_ts, log_ts, odom_prev=None, timed=False):
        """Run the staged scans of `xs` as frames frame_idx, frame_idx+1, ...
        (frame_idx itself is left to the caller). kf_ts: (C,) device tensor
        of the times stored with keyframes; log_ts: the times logged per
        mapped frame (floats, or the same device tensor); odom_prev: the
        wheel-odometry pose (device R, t) before the chunk's first scan,
        with the prior on; timed: record each mapping step's wall time,
        the device synchronized before and after it. The outputs go into
        (C, ...) buffers, the counterpart of the reference's scan outputs,
        which the logs keep. Returns the last frame's poses."""
        cfg = self.cfg
        C = int(xs["rimg" if "rimg" in xs else "pts"].shape[0])
        f0 = self.frame_idx
        self._finalized = False

        feed = ("rimg", "azr", "elr", "rowe") if "rimg" in xs else ("pts", "mask")
        x = {k: xs[k] for k in feed}
        # the chunk's RANSAC draws, made before its steps
        x["scores"] = torch.stack([self._ground_scores(f0 + c) for c in range(C)]).to(self.device)
        if self._use_imu:
            x.update({f"imu.{k}": v for k, v in xs["imu"].items()})
        pre = self._step("prepass", (feed[0], str(x[feed[0]].dtype), C, self._use_imu), self._prepass_step, x)

        div = cfg.mapping.mapping_frequency_divider
        mapped = [c for c in range(C) if (f0 + c) % div == 0]
        front_buf, map_buf = {}, {}

        def keep(buf, n, i, out):
            for k, v in out.items():
                if k not in buf:
                    buf[k] = torch.empty((n, *v.shape), dtype=v.dtype, device=v.device)
                buf[k][i].copy_(v)

        for c in range(C):
            x = {k: v[c] for k, v in pre.items()}
            if self._use_odom:
                cur = (xs["odom_R"][c], xs["odom_t"][c])
                x["odom_prev_R"], x["odom_prev_t"] = odom_prev
                x["odom_R"], x["odom_t"] = cur
                odom_prev = cur
            out = self._step("front", (self._use_imu, self._use_odom), self._front_step, x)
            keep(front_buf, C, c, {k: out[k] for k in ("R_odom", "t_odom", "R_fused", "t_fused")})
            if c in mapped:
                y = {k: out[k] for k in self._MAP_INPUTS}
                y["time"] = kf_ts[c]
                if timed:
                    synchronize(out["t_odom"])
                    t0 = time.perf_counter()
                res = self._step("map", (), self._map_step, y)
                if timed:
                    synchronize(res["t_map"])
                    self.diagnostics["mapping_ms"].append((time.perf_counter() - t0) * 1e3)
                keep(map_buf, len(mapped), mapped.index(c), res)

        self._log["odom_t"].extend(front_buf["t_odom"].unbind(0))
        self._log["fused_t"].extend(front_buf["t_fused"].unbind(0))
        for i, c in enumerate(mapped):
            self._log["map_R"].append(map_buf["R_map"][i])
            self._log["map_t"].append(map_buf["t_map"][i])
            self._log["map_time"].append(log_ts[c] if isinstance(log_ts, torch.Tensor) else float(log_ts[c]))
            self._diags.append(MapDiag(*(map_buf[f"diag.{f}"][i] for f in MapDiag._fields)))
        return {
            "R_odom": front_buf["R_odom"][-1], "t_odom": front_buf["t_odom"][-1],
            "R_map": self.bstate.R_map.clone(), "t_map": self.bstate.t_map.clone(),
            "R_fused": front_buf["R_fused"][-1], "t_fused": front_buf["t_fused"][-1],
        }

    def process_chunk(self, pts, masks=None, timestamps=None, imu=None, odom=None):
        """Process C scans: pts is a staged feed from `stage_chunk`, a
        `_prep_many` feed, a (C, max_points, 3) array with its masks, or a
        list of raw (N, 3) clouds; imu and odom as `stage_chunk` takes them
        (ignored for a staged feed). Loop closure is checked once per chunk.
        The wheel-odometry prior of the chunk's first scan is from the last
        pose seen before it (none on a stream's first scan: identity).

        Without timestamps, frame i's keyframe time is float32(i) times
        scan_period in float32, as the reference's chunk runner derives it
        on the device, and its logged map time the float64 product rounded
        to float32, as that runner logs it on the host; both are computed
        here on the host and the keyframe times staged with the chunk."""
        cfg = self.cfg
        if isinstance(pts, dict) and isinstance(next(iter(pts.values())), torch.Tensor):
            xs = pts
        else:
            xs = self.stage_chunk(pts, masks, timestamps, imu, odom)
        C = int(xs["rimg" if "rimg" in xs else "pts"].shape[0])
        odom_prev = None
        if self._use_odom:
            R, t = xs["odom_host"]
            prev = self._last_odom if self._last_odom is not None else (R[0], t[0])
            odom_prev = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in prev)
            self._last_odom = (R[-1], t[-1])
        now = time.perf_counter()
        if self._chunk_t_prev is not None and self._chunk_mapped_prev:
            self._chunks_timed += 1
            if self._chunks_timed > 1:
                per = (now - self._chunk_t_prev) * 1e3 / self._chunk_mapped_prev
                self.diagnostics["mapping_ms"].extend([per] * self._chunk_mapped_prev)
        self._chunk_t_prev = now
        if "ts" in xs:
            kf_ts = log_ts = xs["ts"]
        else:
            frames = np.arange(self.frame_idx, self.frame_idx + C)
            # float32(i) * float32(scan_period), made on the device (no upload)
            period = torch.full((), float(np.float32(cfg.laser.scan_period)), device=self.device)
            kf_ts = torch.arange(self.frame_idx, self.frame_idx + C, dtype=torch.float32, device=self.device) * period
            log_ts = (frames * cfg.laser.scan_period).astype(np.float32)
        self._frames(xs, kf_ts, log_ts, odom_prev)
        f0 = self.frame_idx
        self.frame_idx += C

        if cfg.mapping.enable_loop_closure and (
            self.frame_idx - self._last_loop_check >= cfg.mapping.loop_every_n_frames
        ):
            self._last_loop_check = self.frame_idx
            self._linfo_q.append(self._loopinfo_probe())
            self._try_loop_closure()
        div = cfg.mapping.mapping_frequency_divider
        self._chunk_mapped_prev = sum(1 for f in range(f0, f0 + C) if f % div == 0)
        self._mapped_frames += self._chunk_mapped_prev
        self._maybe_publish_global_map()

    def _pack_imu(self, imu_samples):
        """(S_raw, 7) rows [t_rel, roll, pitch, yaw, ax, ay, az] -> one
        fixed (S,) window {"t", "rpy", "acc", "mask"} of numpy arrays,
        padded and masked to imu_window (rows beyond it dropped)."""
        S = self.cfg.pipeline.imu_window
        buf = np.zeros((S, 7), np.float32)
        m = np.zeros((S,), bool)
        if imu_samples is not None and len(imu_samples):
            k = min(len(imu_samples), S)
            buf[:k] = np.asarray(imu_samples, np.float32)[:k]
            m[:k] = True
        return {"t": buf[:, 0], "rpy": buf[:, 1:4], "acc": buf[:, 4:7], "mask": m}

    def _pack_odom(self, odom_pose):
        """The current wheel-odometry pose (R, t) -> {R_prev, t_prev, R_cur,
        t_cur} numpy arrays, carrying the previous pose on the host: the
        motion is identity on a stream's first scan, and a scan without a
        pose repeats the last one."""
        if odom_pose is None:
            cur = self._last_odom
        else:
            cur = (np.asarray(odom_pose[0], np.float32), np.asarray(odom_pose[1], np.float32))
        if cur is None:
            cur = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        prev = self._last_odom if self._last_odom is not None else cur
        self._last_odom = cur
        return {"R_prev": prev[0], "t_prev": prev[1], "R_cur": cur[0], "t_cur": cur[1]}

    def process_scan(self, points, timestamp=None, imu_samples=None, odom_pose=None):
        """Process one raw scan ((N, 3), NaN rows = misses) as one frame.

        The cloud goes up as float32 points, projected on the device (the
        chunk path's feed_mode and feed_quant do not apply, as in the
        reference). Its time is `timestamp`, else frame_idx * scan_period in float64,
        stored with a keyframe as float32 and logged as given, as the
        reference's process_scan does. imu_samples: optional (S, 7) rows
        [t_rel_to_scan_start, roll, pitch, yaw, ax, ay, az] over the scan
        (used with `use_imu_undistortion`); odom_pose: optional (R, t)
        wheel-odometry pose at this scan (used with the prior on). Loop
        closure is checked, and the global map published, after a mapped
        frame. Returns the frame's odometry, map and fused poses."""
        cfg = self.cfg
        t_scan = timestamp if timestamp is not None else self.frame_idx * cfg.laser.scan_period
        kw, odom_prev = {}, None
        if self._use_imu:
            kw["imu"] = {k: v[None] for k, v in self._pack_imu(imu_samples).items()}
        if self._use_odom:
            od = self._pack_odom(odom_pose)
            kw["odom"] = (od["R_cur"][None], od["t_cur"][None])
            odom_prev = tuple(torch.from_numpy(np.ascontiguousarray(od[k])).to(self.device) for k in ("R_prev", "t_prev"))
        xs = self.stage_chunk(self._pack_points([points]), timestamps=[t_scan], **kw)
        out = self._frames(xs, xs["ts"], [t_scan], odom_prev, timed=self.profile)
        if self.frame_idx % cfg.mapping.mapping_frequency_divider == 0:
            if (
                cfg.mapping.enable_loop_closure
                and self.frame_idx - self._last_loop_check >= cfg.mapping.loop_every_n_frames
            ):
                self._last_loop_check = self.frame_idx
                self._linfo_q.append(self._loopinfo_probe())
                self._try_loop_closure()
            self._mapped_frames += 1
            self._maybe_publish_global_map()
        self.frame_idx += 1
        return out

    def request_stop(self):
        """End `run` before its next scan, or `run_chunked` at its next
        chunk boundary or tail scan (the reference's /initialpose run-control
        flag, which hands over to a re-localization session)."""
        self._stop_requested = True

    def _maybe_publish_global_map(self):
        """Every `global_map_every_n_frames` mapped frames (with
        `publish_global_map`): the keyframes within
        `global_map_visualization_search_radius` of the map pose, gathered
        to the host and voxel-filtered, into `latest_global_map`."""
        cfg = self.cfg
        if not cfg.pipeline.publish_global_map or self._mapped_frames < self._next_global_map:
            return
        from .mapproducts import global_map

        self._next_global_map = self._mapped_frames + cfg.mapping.global_map_every_n_frames
        self.latest_global_map = global_map(
            self.bstate, self.bstate.t_map.cpu().numpy(), cfg.mapping.global_map_visualization_search_radius, cfg
        )
        self.global_map_count += 1

    def run(self, scans, timestamps=None):
        """Process a sequence of raw scans one by one through `process_scan`
        (until `request_stop`), then finalize; returns the trajectories
        (map, odometry, fused positions) as numpy arrays."""
        for k in range(len(scans)):
            if self._stop_requested:
                break
            self.process_scan(scans[k], None if timestamps is None else timestamps[k])
        return self._result()

    def run_chunked(self, scans, chunk: int = 16, timestamps=None):
        """Whole chunks through `process_chunk`, the next one packed and
        staged in a worker thread meanwhile; the ragged tail through
        `process_scan`. Honours `request_stop` at chunk boundaries and
        before each tail scan. Finalizes (draining loop closure) and returns
        the trajectories as `run` does. No IMU or odometry stream is taken:
        feed those through `stage_chunk` / `process_chunk`."""
        T = len(scans)

        def prep_and_stage(s0):
            ts = None if timestamps is None else np.asarray(timestamps[s0 : s0 + chunk], np.float32)
            return self.stage_chunk(scans[s0 : s0 + chunk], timestamps=ts)

        s = 0
        if T >= chunk:
            fut = self._stager_submit(prep_and_stage, 0)
            while s + chunk <= T and not self._stop_requested:
                xs = fut.result()
                if s + 2 * chunk <= T:
                    fut = self._stager_submit(prep_and_stage, s + chunk)
                self.process_chunk(xs)
                s += chunk
        for k in range(s, T):
            if self._stop_requested:
                break
            self.process_scan(scans[k], None if timestamps is None else timestamps[k])
        return self._result()

    def _stager_submit(self, fn, *args):
        if self._stager is None:
            self._stager = ThreadPoolExecutor(max_workers=1, thread_name_prefix="lego-stage")
        return self._stager.submit(fn, *args)

    def _result(self):
        self.finalize()
        return {
            "map_positions": np.asarray(self.trajectory["positions"]),
            "odom_positions": self.odom_positions,
            "fused_positions": self.fused_positions,
        }

    # -- materialization ----------------------------------------------------

    def finalize(self):
        """Drain loop closure, then pull the per-frame logs to the host in
        one pass."""
        if self._finalized:
            return
        self._drain_loop_closure()

        def host(entries, shape):
            if not entries:
                return np.zeros(shape, np.float32)
            return torch.stack([e.to(self.device) for e in entries]).cpu().numpy()

        self.odom_positions = host(self._log["odom_t"], (0, 3))
        self.fused_positions = host(self._log["fused_t"], (0, 3))
        if self._log["map_t"]:
            mR = torch.stack(self._log["map_R"])
            rpy = torch.stack(se3.matrix_to_euler_zyx(mR), dim=-1).cpu().numpy()
            # map times are floats or staged device values: read the latter at once
            on_dev = [t for t in self._log["map_time"] if isinstance(t, torch.Tensor)]
            read = iter(torch.stack(on_dev).cpu().tolist() if on_dev else ())
            self.trajectory = {
                "positions": list(host(self._log["map_t"], (0, 3))),
                "rpys": list(rpy),
                "times": [next(read) if isinstance(t, torch.Tensor) else t for t in self._log["map_time"]],
            }
            cols = {
                f: torch.stack([getattr(d, f).to(self.device).reshape(()) for d in self._diags]).cpu().numpy()
                for f in MapDiag._fields
            }
            self.diagnostics["iterations"] = [int(v) for v in cols["iterations"]]
            self.diagnostics["rejected_frames"] = int(cols["rejected"].sum())
            self.diagnostics["records"] = [
                {
                    "iterations": int(cols["iterations"][k]),
                    "min_lambda": float(cols["min_lambda"][k]),
                    "cf_mean": float(cols["cf_mean"][k]),
                    "rejected": bool(cols["rejected"][k]),
                    "n_submap_corner": int(cols["n_submap_corner"][k]),
                    "n_submap_surf": int(cols["n_submap_surf"][k]),
                    "n_sel": int(cols["n_sel"][k]),
                    "frame": k,
                }
                for k in range(len(self._diags))
            ]
        self._finalized = True

    def save_artifacts(self, out_dir: str):
        """Finalize, then write the reference's run artifacts (pose.txt,
        mapt.txt, MapIterTimes.txt, LocalInfo.txt) under out_dir; in a
        process group every rank finalizes and rank 0 writes."""
        self.finalize()
        from .utils.metrics import save_run_artifacts

        if is_writer():
            save_run_artifacts(out_dir, self.trajectory, self.diagnostics)

    def keyframe_trajectory(self):
        """Corrected keyframe poses (R (A,3,3), t (A,3), times (A,)) as
        numpy, oldest -> newest: the keyframe poses after loop-closure
        corrections, where the per-frame logs keep each pose as it was
        when its frame ran."""
        bs = self.bstate
        slots = bs.ordered_slots()
        return tuple(all_rows(x).cpu().numpy()[slots] for x in (bs.kf_R, bs.kf_t, bs.kf_time))

    # -- loop closure -------------------------------------------------------

    def _empty_loop_buf(self) -> Factors:
        L = self.cfg.mapping.max_loop_factors
        dev = self.device
        return Factors(
            i=torch.zeros(L, dtype=torch.int32, device=dev),
            j=torch.zeros(L, dtype=torch.int32, device=dev),
            R=torch.eye(3, device=dev).repeat(L, 1, 1),
            t=torch.zeros(L, 3, device=dev),
            info=torch.ones(L, 6, device=dev),
            mask=torch.zeros(L, dtype=torch.bool, device=dev),
        )

    def _loop_info(self, fitness: float) -> float:
        m = self.cfg.mapping
        return 1.0 / max(fitness * m.loop_noise_scale, m.loop_var_floor)

    def _append_loop(self, k, i, j, R, t, info, valid):
        """Write row k of the device loop-factor buffer in place."""
        buf = self._loop_buf
        buf.i[k], buf.j[k] = i, j
        buf.R[k].copy_(R)
        buf.t[k].copy_(t)
        buf.info[k] = info
        buf.mask[k] = valid

    def _sync_loop_buf(self):
        """Rebuild the device loop-factor buffer from the host mirror."""
        live = self.loop_factors[-self.cfg.mapping.max_loop_factors:]
        self._loop_buf = self._empty_loop_buf()
        for k, f in enumerate(live):
            self._append_loop(k, f.i, f.j, torch.as_tensor(f.R), torch.as_tensor(f.t), self._loop_info(f.fitness), True)
        self._loop_write = len(live)

    def _loopinfo_probe(self):
        bs = self.bstate
        return compute_loopinfo(bs.kf_t, bs.kf_time, bs.n_kf, bs.t_map, self.cfg)

    def _attempt(self, cand_slot: int, cur_slot: int, n_kf: int):
        bs = self.bstate
        return attempt_loop_closure(
            bs.kf_R, bs.kf_t, bs.kf_corner, bs.kf_corner_mask, bs.kf_surf, bs.kf_surf_mask, cand_slot, cur_slot,
            n_kf, self.cfg,
        )

    def warmup_loop_closure(self):
        """Run each loop-closure program once before the timed region: the
        candidate probe, an attempt, a masked-out buffer write and a graph
        solve (on a store whose chain is consistent the cost gate rejects
        it and the poses stay). No-op when loop closure is off."""
        if not self.cfg.mapping.enable_loop_closure:
            return
        self._loopinfo_probe()
        self._attempt(0, 0, 1)
        self._append_loop(0, 0, 0, torch.eye(3, device=self.device), torch.zeros(3, device=self.device), 1.0, False)
        self._solve(None)
        self._pickup_solve()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _try_loop_closure(self, draining: bool = False):
        """One loop-closure check, the reference's asynchronous schedule
        (a check is one call of this; `draining` handles everything at once):

        1. The candidate probe queued at the check before last is read (a
           4-float read of a result long finished); at most the two newest
           probes stay queued.
        2. A candidate within `history_keyframe_search_radius`, outside the
           attempt cooldown and with no attempt in flight, dispatches an
           attempt; its flags are read at the next check.
        3. An accepted attempt appends the loop factor and, at every
           `loop_solve_every_accepts`-th accept, dispatches the reduced
           pose-graph solve, whose cost gate applies it on the device; its
           diagnostic is read at the next check."""
        m = self.cfg.mapping
        self._check_seq += 1
        self._pickup_solve(draining)
        self._pickup_attempt(draining)

        if len(self._linfo_q) < (1 if draining else 2):
            return
        pend = self._linfo_q.pop(0)
        del self._linfo_q[:-2]  # never let the backlog grow
        cand_slot, cand_dist, n_kf, cur_slot = pend.tolist()
        n_kf = int(n_kf)
        if n_kf < 3:
            return
        has_cand = bool(np.isfinite(cand_dist))
        self.loop_diag.append({
            "n_kf": n_kf,
            "cand": int(cand_slot) if has_cand else -1,
            "dist": float(cand_dist) if has_cand else float("inf"),
        })
        if not has_cand or cand_dist >= m.history_keyframe_search_radius:
            return
        # Cooldowns budget attempts during the stream; the drain has nothing
        # left to budget.
        if not draining and self.frame_idx < self._loop_cooldown_until:
            return
        if self._attempt_pending is not None:
            return
        key = (int(cand_slot), int(cur_slot), n_kf)
        if draining and key == self._last_attempt:
            return  # the drain's final probe of an unchanged store: tried already
        self._last_attempt = key
        self._loop_cooldown_until = self.frame_idx + m.loop_attempt_cooldown
        out = self._attempt(*key)
        self._attempt_pending = (*out, self.loop_diag[-1], self._check_seq)
        if draining:
            self._pickup_attempt(True)
            self._pickup_solve(True)

    def _pickup_attempt(self, draining: bool = False):
        """Read a finished attempt; on acceptance append the factor (host
        mirror and device buffer) and, when due, dispatch the solve."""
        if self._attempt_pending is None:
            return
        flags_d, R_d, t_d, diag, seq = self._attempt_pending
        if not draining and self._check_seq < seq + 1:
            return
        self._attempt_pending = None
        flags = flags_d.tolist()
        m = self.cfg.mapping
        diag.update(
            icp_fitness=float(flags[3]),
            coarse_score=float(flags[4]),
            coarse_frac=round(float(flags[5]), 3),
            icp_iters=int(flags[6]),
            icp_inlier_frac=float(flags[7]),
        )
        if flags[0] < 0.5:
            return
        diag["accepted"] = True
        fitness = float(flags[3])
        i, j = int(flags[1]), int(flags[2])
        self.loop_factors.append(LoopFactor(i=i, j=j, R=R_d.cpu().numpy(), t=t_d.cpu().numpy(), fitness=fitness))
        k = self._loop_write % m.max_loop_factors
        self._loop_write += 1
        self._append_loop(k, i, j, R_d, t_d, self._loop_info(fitness), True)
        self._loop_cooldown_until = self.frame_idx + m.loop_accept_cooldown
        if len(self.loop_factors) % max(m.loop_solve_every_accepts, 1) and not draining:
            return  # factor accumulated; solve at the Nth accept / drain
        self._solve(diag)

    def _solve(self, diag_ref):
        """The graph solve: over several ranks the sharded whole-graph solve,
        applied at once; else the anchor-segment solve, queued."""
        if self._solve_graph_sharded is not None:
            self._optimize_graph_sharded()
        else:
            self._dispatch_solve(diag_ref)

    def _dispatch_solve(self, diag_ref):
        """Queue the reduced anchor-segment solve. Its cost gate selects on
        the device: where it holds, the store's poses are rewritten in
        place, the map pose becomes the newest keyframe's corrected pose and
        the submap cache is invalidated (so the next frame rebuilds it from
        the corrected poses); nothing is read back here. Every state tensor
        is written in place."""
        bs = self.bstate
        self._solved_at = len(self.loop_factors)
        newR, newt, (ok, c0, c1, moved) = reduced_solve(
            *(all_rows(x) for x in (bs.kf_R, bs.kf_t, bs.kf_rel_R, bs.kf_rel_t)), bs.n_kf, self._loop_buf, self.cfg
        )
        newest = torch.where(bs.n_kf > 0, (bs.n_kf - 1) % bs.capacity, 0).long().reshape(1)
        set_rows(bs.kf_R, newR)  # the input rows where the gate refused
        set_rows(bs.kf_t, newt)
        assign(bs.R_map, torch.where(ok, newR.index_select(0, newest)[0], bs.R_map))
        assign(bs.t_map, torch.where(ok, newt.index_select(0, newest)[0], bs.t_map))
        assign(bs.submap_center, torch.where(ok, torch.full_like(bs.submap_center, 1e9), bs.submap_center))
        assign(bs.submap_n_kf, torch.where(ok, torch.full_like(bs.submap_n_kf, -1), bs.submap_n_kf))
        diag = torch.stack([ok.to(c0.dtype), c0, c1, moved])
        self._solve_pending = (diag, diag_ref, self._check_seq)

    def _pickup_solve(self, draining: bool = True):
        if self._solve_pending is None:
            return
        diag_d, diag_ref, seq = self._solve_pending
        if not draining and self._check_seq < seq + 1:
            return
        self._solve_pending = None
        ok, c0, c1, moved = diag_d.tolist()
        if diag_ref is not None:
            diag_ref["graph_cost"] = [c0, c1]
            diag_ref["graph_max_move"] = moved
            diag_ref["graph_accepted"] = bool(ok > 0.5)

    def _drain_loop_closure(self):
        """End of stream: probe the last pose, evaluate every queued probe
        (the final one included) with attempts and solves completed at once,
        then solve for any factors accumulated since the last solve.

        The reference's drain evaluates only the oldest queued probe, so its
        final probe is never read; this one empties the queue. Where no
        keyframe came after the last check, the final probe repeats the
        queued one: an attempt at the same keyframes is not made twice (it
        would add the same loop factor again)."""
        if not self.cfg.mapping.enable_loop_closure or self.frame_idx == 0:
            return
        self._linfo_q.append(self._loopinfo_probe())
        while self._linfo_q:
            self._try_loop_closure(draining=True)
        if len(self.loop_factors) > self._solved_at:
            self._solve(self.loop_diag[-1] if self.loop_diag else None)
        self._pickup_solve()

    def _optimize_graph(self):
        """Whole-graph correction on demand (tests, a reloaded factor
        list): rebuild the device buffer from the host mirror, solve, and
        read the diagnostic; over more than one rank, the sharded solve."""
        if self._solve_graph_sharded is None:
            self._sync_loop_buf()
        self._solve(self.loop_diag[-1] if self.loop_diag else None)
        self._pickup_solve()

    def _graph_factors(self):
        """The whole keyframe graph as factors over ring slots, assembled on
        the host as the reference's sharded branch assembles it: K - 1
        chain rows, the pair (l-1, l) in append order measured by the
        younger keyframe's kf_rel (masked past the resident chain), then
        `max_loop_factors` rows of the newest loop factors whose keyframes
        are still resident (masked padding). Returns (factors, active (K,)
        bool, the newest keyframe's slot)."""
        bs, m, dev = self.bstate, self.cfg.mapping, self.device
        K = bs.capacity
        n_kf = int(bs.n_kf)
        slots = bs.ordered_slots()
        A = len(slots)
        base = n_kf - A  # absolute id of the oldest resident keyframe
        ci = np.zeros(K - 1, np.int32)
        cj = np.zeros(K - 1, np.int32)
        cmask = np.zeros(K - 1, bool)
        if A >= 2:
            ci[: A - 1], cj[: A - 1], cmask[: A - 1] = slots[:-1], slots[1:], True
        cap = m.max_loop_factors
        live = [f for f in self.loop_factors if f.i >= base and f.j >= base][-cap:]
        li = np.zeros(cap, np.int32)
        lj = np.zeros(cap, np.int32)
        lR = np.tile(np.eye(3, dtype=np.float32), (cap, 1, 1))
        lt = np.zeros((cap, 3), np.float32)
        info = np.zeros((K - 1 + cap, 6), np.float32)
        info[: K - 1] = [1.0 / m.chain_rot_var] * 3 + [1.0 / m.chain_trans_var] * 3
        lmask = np.zeros(cap, bool)
        for k, f in enumerate(live):
            li[k], lj[k], lR[k], lt[k] = slots[f.i - base], slots[f.j - base], f.R, f.t
            info[K - 1 + k] = self._loop_info(f.fitness)
            lmask[k] = True

        def up(a):
            return torch.from_numpy(a).to(dev)

        younger = up(cj).long()
        factors = Factors(
            i=up(np.concatenate([ci, li])), j=up(np.concatenate([cj, lj])),
            R=torch.cat([gather_rows(bs.kf_rel_R, younger), up(lR)]),
            t=torch.cat([gather_rows(bs.kf_rel_t, younger), up(lt)]),
            info=up(info), mask=up(np.concatenate([cmask, lmask])),
        )
        active = torch.arange(K, device=dev) < n_kf
        return factors, active, int(slots[-1]) if A else 0

    def _optimize_graph_sharded(self):
        """Whole-graph GN through `sharded_pose_graph_solver`: the factors
        of `_graph_factors`, padded to a multiple of the world size (masked
        identity rows), each rank solving with its row block. Applied only
        where the graph's weighted cost falls and stays finite (read back
        here); then the rotations are re-orthonormalized, the map pose
        becomes the newest keyframe's, and the submap cache is invalidated."""
        self._solved_at = len(self.loop_factors)
        factors, active, newest = self._graph_factors()
        pad = (-factors.i.shape[0]) % self._mesh.size()
        if pad:
            eye = torch.eye(3, device=self.device).expand(pad, 3, 3)
            factors = Factors(*(torch.cat([x, eye if x.dim() == 3 else x.new_zeros((pad,) + x.shape[1:])])
                                for x in factors))
        local = shard_rows(factors, self._mesh)
        bs = self.bstate
        R, t = all_rows(bs.kf_R), all_rows(bs.kf_t)
        newR, newt = self._solve_graph_sharded(R, t, local, active)
        moved = torch.max(torch.where(active, torch.linalg.norm(newt - t, dim=1), 0.0))
        c0, c1, moved = torch.stack([graph_cost(R, t, factors), graph_cost(newR, newt, factors), moved]).tolist()
        ok = bool(np.isfinite(c1)) and c1 < c0
        if self.loop_diag:
            self.loop_diag[-1].update(graph_cost=[c0, c1], graph_max_move=moved, graph_accepted=ok)
        if not ok:
            return
        newR = se3.orthonormalize(newR)
        set_rows(bs.kf_R, newR)
        set_rows(bs.kf_t, newt)
        assign(bs.R_map, newR[newest])
        assign(bs.t_map, newt[newest])
        bs.submap_center.fill_(1e9)
        bs.submap_n_kf.fill_(-1)
