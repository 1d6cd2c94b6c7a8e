"""Re-localization against a saved map (≙ the reference's /initialpose +
HighDense re-mapping mode; port of `lego_loam_tpu/relocalize.py`).

The reference's flow: `/initialpose` sets a flag that terminates the mapping
run loop (`mapOptmization.cpp:437-456`, `:1922-1924`); a new run then
starts with `ReMapping:=true`, where PCDPublisher republishes the saved
`denseCloud.pcd` (`publishHighDenseMap.cpp:13-67`) and the stack localizes
inside it. Here that becomes concrete host API:

- `LegoLoamPipeline.request_stop()` ≙ the /initialpose flag (honoured by
  `run()` / `run_chunked()`),
- `map_state_from_cloud()` turns a loaded dense cloud into a fixed `MapState`
  submap on the device,
- `localize_scan()` runs the front end's feature extraction (K1 labels the
  range image) plus the scan-to-map GN (K2 at both mapping sites) against
  that fixed submap — localization without mapping.
"""

from __future__ import annotations

import numpy as np
import torch

from .backend import downsample_current_scan
from .config import LegoLoamConfig
from .frontend import frontend_prepass
from .mapping import scan_to_map
from .ops.ground import ransac_scores
from .ops.projection import project_point_cloud
from .types import MapState


def map_state_from_cloud(map_xyz: np.ndarray, cfg: LegoLoamConfig, center=None, device="cuda") -> MapState:
    """Build a fixed localization submap from a dense map cloud.

    The HighDense map is an undifferentiated point cloud (no corner/surf
    split), so the cropped cloud feeds BOTH residual channels: scan corner
    features find their lines where the dense map has edge structure (the
    line-fit eigen gate rejects non-edge neighbourhoods), scan surf features
    fit planes. Points are cropped to `surrounding_keyframe_search_radius`
    around `center` and voxel-filtered at the submap leaves on the host
    (the first point of each voxel, kept in cloud order), then uploaded
    once."""
    m = cfg.mapping
    pts = np.asarray(map_xyz, np.float32)
    if center is not None:
        d = np.linalg.norm(pts - np.asarray(center, np.float32)[None], axis=1)
        pts = pts[d < m.surrounding_keyframe_search_radius]

    def ds(cloud, leaf, cap):
        if leaf > 0 and len(cloud):
            keys = np.floor(cloud / leaf).astype(np.int64)
            _, idx = np.unique(keys, axis=0, return_index=True)
            cloud = cloud[np.sort(idx)]
        buf = np.zeros((cap, 3), np.float32)
        k = min(len(cloud), cap)
        buf[:k] = cloud[:k]
        msk = np.zeros((cap,), bool)
        msk[:k] = True
        return torch.from_numpy(buf).to(device), torch.from_numpy(msk).to(device)

    s_xyz, s_m = ds(pts, m.submap_surf_leaf, m.max_submap_surf)
    c_xyz, c_m = ds(pts, m.corner_leaf, m.max_submap_corner)
    return MapState(corner_xyz=c_xyz, corner_mask=c_m, surf_xyz=s_xyz, surf_mask=s_m)


def localize_scan(points: np.ndarray, submap: MapState, R0, t0, cfg: LegoLoamConfig, scores=None):
    """Localize one raw scan ((N, 3), NaN rows = misses) in a fixed map:
    projection -> ground -> segmentation -> features -> scan DS, then the
    scan-to-map GN against `submap` from the initial guess (R0, t0; arrays or
    tensors), on the submap's device.

    scores: the ground NEAR pass's RANSAC draw; by default the same draw on
    every call, from a `torch.Generator` seeded 0 (the reference draws from
    PRNGKey(0) on every call). Returns (R, t, MapDiag)."""
    dev = submap.corner_xyz.device
    n = cfg.laser.max_points
    buf = np.zeros((n, 3), np.float32)
    msk = np.zeros((n,), bool)
    k = min(len(points), n)
    msk[:k] = np.isfinite(points[:k]).all(axis=1)
    buf[:k] = np.nan_to_num(points[:k])
    if scores is None:
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        scores = ransac_scores(cfg, g, dev)

    grid = project_point_cloud(torch.from_numpy(buf).to(dev), torch.from_numpy(msk).to(dev), cfg)
    _grid, seg, feats = frontend_prepass(grid, cfg, scores)
    c_xyz, c_m, s_xyz, s_m = downsample_current_scan(feats, seg.outlier_xyz, seg.outlier_mask, cfg)
    return scan_to_map(c_xyz, c_m, s_xyz, s_m, _f32(R0, dev), _f32(t0, dev), submap, cfg)


def _f32(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev, torch.float32)
    return torch.from_numpy(np.array(x, np.float32)).to(dev)
