"""The benchmark's plain reference: a frozen copy of the port's pipeline
(`lego_loam_torch/pipeline.py`) as the CPU runs it: host branching, no
CUDA graphs, the plain twins of both kernels, on any device.

It keeps what the benchmark's cells run and the check follows:
`process_chunk` over C raw scans in three steps, a prepass over the chunk
(range-image reconstruction or projection, ground removal, the connected
components of all C scans in one K1 launch), then per frame a front step
(segmentation and features, the two-step scan-to-scan solve, the deskew)
and a map step (downsampling, the scan-to-map solve and the keyframe
append). The check loads the port's state before a chunk and runs that
chunk's frames; what the port does between chunks (loop closure and the
pose-graph solve) is in the next state it loads, so it is left out here,
and so are the port's IMU, wheel-odometry prior, per-scan path, stager
thread, ranks and products, which no cell turns on.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .backend import backend_step_ds, downsample_clouds, init_backend_state
from .config import LegoLoamConfig
from .frontend import deskew_outliers, frontend_solve, init_odometry_state, segment_features
from .ops.ground import apply_ground, ransac_scores
from .ops.projection import grid_from_range_image, host_pack_range_image, project_point_cloud
from .ops.segmentation import converged_labels
from .store import assign_state
from .types import ScanGrid


class LegoLoamPipeline:
    """Odometry and mapping over chunks of scans on one device. The RANSAC
    draws of frame f come from a `torch.Generator` on the device seeded
    from (seed, f), as the port draws them. `_log` keeps every frame's
    odometry position and every mapped frame's map pose, on the device."""

    def __init__(self, cfg: LegoLoamConfig, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.seed = seed
        self.device = torch.device(device)
        self.fstate = init_odometry_state(cfg, self.device)
        self.bstate = init_backend_state(cfg, self.device)
        self.frame_idx = 0
        self._log = {k: [] for k in ("odom_t", "map_R", "map_t")}

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

    def stage_chunk(self, scans) -> dict:
        """One chunk's raw clouds packed (`_prep_many`) and moved to the
        device; range codes go up as int32."""
        xs = {}
        for k, v in self._prep_many(scans).items():
            v = np.asarray(v)
            if v.dtype == np.uint16:
                v = v.astype(np.int32)
            xs[k] = torch.from_numpy(v).to(self.device)
        return xs

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
    # in place.

    def _prepass_step(self, x) -> dict:
        """The chunk's grids (range image or projection) grounded with the
        scores drawn for each scan and their connected components in one K1
        launch: (C, ...) outputs."""
        cfg = self.cfg
        grids = [apply_ground(self._grid(x, c), cfg, x["scores"][c]) for c in range(x["scores"].shape[0])]
        out = {f"grid.{f.name}": torch.stack([getattr(g, f.name) for g in grids]) for f in dataclasses.fields(ScanGrid)}
        out["raw"], _ = converged_labels(ScanGrid(**{k[5:]: v for k, v in out.items()}), cfg)
        return out

    def _front_step(self, x) -> dict:
        """One frame's segmentation, features, scan-to-scan solve and the
        deskew of its map clouds; the odometry state is written in place."""
        cfg = self.cfg
        grid = ScanGrid(**{f.name: x[f"grid.{f.name}"] for f in dataclasses.fields(ScanGrid)})
        _grid, seg, feats = segment_features(grid, cfg, x["raw"])
        new_state, out = frontend_solve(feats, self.fstate, cfg)
        assign_state(self.fstate, new_state)
        return {
            "R_odom": out["R_world"], "t_odom": out["t_world"],
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
        new_state, (R_map, t_map), _diag = backend_step_ds(self.bstate, *ds, x["R_odom"], x["t_odom"], x["time"], cfg)
        assign_state(self.bstate, new_state)
        return {"R_map": R_map, "t_map": t_map}

    _MAP_INPUTS = ("corner", "corner_mask", "surf", "surf_mask", "outlier", "outlier_mask", "R_odom", "t_odom")

    _MAP_INPUTS = ("corner", "corner_mask", "surf", "surf_mask", "outlier", "outlier_mask", "R_odom", "t_odom")

    def process_chunk(self, scans):
        """Run C raw scans ((N, 3) clouds, NaN rows are misses) as frames
        frame_idx, frame_idx+1, ...; frame i's keyframe time is float32(i)
        times scan_period in float32, as the port stages it."""
        cfg = self.cfg
        xs = self.stage_chunk(scans)
        C = int(xs["rimg" if "rimg" in xs else "pts"].shape[0])
        f0 = self.frame_idx
        period = torch.full((), float(np.float32(cfg.laser.scan_period)), device=self.device)
        kf_ts = torch.arange(f0, f0 + C, dtype=torch.float32, device=self.device) * period

        feed = ("rimg", "azr", "elr", "rowe") if "rimg" in xs else ("pts", "mask")
        x = {k: xs[k] for k in feed}
        # the chunk's RANSAC draws, made before its steps
        x["scores"] = torch.stack([self._draw_scores(f0 + c) for c in range(C)]).to(self.device)
        pre = self._prepass_step(x)
        div = cfg.mapping.mapping_frequency_divider
        for c in range(C):
            out = self._front_step({k: v[c] for k, v in pre.items()})
            self._log["odom_t"].append(out["t_odom"].clone())
            if (f0 + c) % div == 0:
                y = {k: out[k] for k in self._MAP_INPUTS}
                y["time"] = kf_ts[c]
                res = self._map_step(y)
                self._log["map_R"].append(res["R_map"].clone())
                self._log["map_t"].append(res["t_map"].clone())
        self.frame_idx += C
