"""Feature extraction: curvature, occlusion, edge/planar picking, shadows
(port of `lego_loam_tpu/ops/features.py`).

Everything works on the per-row packed SegmentedScan layout with masks. The
reference's sequential pick-then-suppress sweeps are local-extremum
non-maximum suppression over the same windows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import LegoLoamConfig
from ..types import FeatureCloud, ScanFeatures, SegmentedScan
from .dbscan import dbscan_edge_filter
from .voxel import voxel_downsample_masked

_BIG = 1e9


def _window(seg: SegmentedScan):
    W = seg.range.shape[1]
    idx = torch.arange(W, device=seg.range.device)[None, :]
    return (idx >= 5) & (idx < seg.count[:, None] - 5) & seg.valid


def curvature_ours(seg: SegmentedScan, cfg: LegoLoamConfig):
    """3-D 11-point Laplacian norm normalized by range, /10; neighbours are
    the 5 packed points either side within the row. Returns (H, W)
    curvature and the (H, W) computable mask."""
    xyz = seg.xyz
    acc = -11.0 * xyz
    for k in range(-5, 6):
        acc = acc + torch.roll(xyz, -k, dims=1)
    diff = torch.linalg.norm(acc, dim=-1)
    rng = torch.linalg.norm(xyz, dim=-1)
    c = diff / torch.clamp(rng, min=1e-6) / 10.0
    ok = _window(seg)
    return torch.where(ok, c, 0.0), ok


def curvature_upstream(seg: SegmentedScan, cfg: LegoLoamConfig):
    """Range-difference curvature (sum of 10 neighbour ranges - 10 r_i)^2."""
    rng = seg.range
    acc = -10.0 * rng
    for k in range(-5, 6):
        if k:
            acc = acc + torch.roll(rng, -k, dims=1)
    ok = _window(seg)
    return torch.where(ok, acc * acc, 0.0), ok


def mark_occluded(seg: SegmentedScan, cfg: LegoLoamConfig):
    """Unpickable mask near depth discontinuities and parallel beams."""
    f = cfg.features
    rng, col = seg.range, seg.col
    d_next = torch.roll(rng, -1, dims=1) - rng
    near_pair = (torch.roll(col, -1, dims=1) - col).abs() < f.occlusion_column_gap
    right_block = near_pair & (-d_next > f.occlusion_depth_gap)
    left_block = near_pair & (d_next > f.occlusion_depth_gap)

    blocked = torch.zeros_like(right_block)
    for k in range(0, 6):
        blocked = blocked | torch.roll(right_block, k, dims=1)
    for k in range(1, 7):
        blocked = blocked | torch.roll(left_block, k, dims=1)

    d_prev = (rng - torch.roll(rng, 1, dims=1)).abs()
    d_nxt = (torch.roll(rng, -1, dims=1) - rng).abs()
    parallel = (d_prev > f.parallel_beam_ratio * rng) & (d_nxt > f.parallel_beam_ratio * rng)
    return (blocked | parallel) & seg.valid


def _suppression_reach(col, window: int, max_gap: int):
    """How far the pick-suppression window extends: +-window packed
    neighbours, stopping at column gaps > max_gap. Returns [(k, mask)]."""
    gaps_r = (torch.roll(col, -1, dims=1) - col).abs() > max_gap
    reach = []
    fwd = torch.ones_like(col, dtype=torch.bool)
    bwd = torch.ones_like(col, dtype=torch.bool)
    for k in range(1, window + 1):
        fwd = fwd & ~torch.roll(gaps_r, -(k - 1), dims=1)
        reach.append((k, fwd))
        bwd = bwd & ~torch.roll(gaps_r, k, dims=1)
        reach.append((-k, bwd))
    return reach


def _nms_round(score, cand, reach, mode):
    """Candidates that are the window extremum among candidates."""
    fill = -_BIG if mode == "max" else _BIG
    pick = torch.maximum if mode == "max" else torch.minimum
    filled = torch.where(cand, score, fill)
    best = filled
    for k, ok in reach:
        best = pick(best, torch.where(ok, torch.roll(filled, -k, dims=1), fill))
    is_ext = cand & (filled == best)
    # plateau tie-break: drop later duplicates within the window
    earlier = torch.zeros_like(is_ext)
    for k, ok in reach:
        if k < 0:
            nei = torch.roll(is_ext, -k, dims=1)
            same = torch.roll(filled, -k, dims=1) == filled
            earlier = earlier | (nei & same & ok)
    return is_ext & ~earlier


def _nms_extremum(score, cand, col, window=5, max_gap=10, mode="max", rounds=2):
    """Iterated local-extremum suppression: each round picks window extrema
    among the remaining candidates and removes their suppression reach."""
    reach = _suppression_reach(col, window, max_gap)
    picked = torch.zeros_like(cand)
    remaining = cand
    for _ in range(rounds):
        sel = _nms_round(score, remaining, reach, mode)
        picked = picked | sel
        blocked = sel
        for k, ok in reach:
            blocked = blocked | (torch.roll(sel, k, dims=1) & ok)
        remaining = remaining & ~blocked
    return picked


def _gather_rows(seg: SegmentedScan, pick, cap: int) -> FeatureCloud:
    """Flatten row-packed picks into a fixed-capacity FeatureCloud (row-major
    order, stable)."""
    H, W = pick.shape
    flat = pick.reshape(-1)
    order = torch.argsort((~flat).to(torch.uint8), stable=True)[:cap]
    mask = flat[order]
    ring = torch.arange(H, device=pick.device)[:, None].expand(H, W).reshape(-1)[order]
    return FeatureCloud(
        xyz=torch.where(mask[:, None], seg.xyz.reshape(-1, 3)[order], 0.0),
        ring=torch.where(mask, ring, -1).to(torch.int32),
        rel_time=torch.where(mask, seg.rel_time.reshape(-1)[order], 0.0),
        mask=mask,
    )


_SHADOW: dict = {}  # (rows, cols, device) -> the grid, uploaded once


def shadow_points(cfg: LegoLoamConfig, device="cpu") -> torch.Tensor:
    """Virtual floor grid under the robot in the lidar frame: shadow_rows x
    shadow_cols points ~8.5 cm below the sensor, FoV-shaped, offset by the
    lidar-to-body lever (0.008, 0, -0.035). Uploaded once per device and
    shared (read only): a frame step makes no upload."""
    f = cfg.features
    key = (f.shadow_rows, f.shadow_cols, str(torch.device(device)))
    if key not in _SHADOW:
        _SHADOW[key] = _shadow_grid(f).to(device)
    return _SHADOW[key]


def _shadow_grid(f) -> torch.Tensor:
    row_angle = (np.arctan2(0.120, 0.05) * 2) / (f.shadow_rows - 1)
    col_angle = (np.arctan2(0.077, 0.05) * 2) / (f.shadow_cols - 1)
    r = np.arange(f.shadow_rows)
    c = np.arange(f.shadow_cols)
    row_x = 0.05 * np.tan(((f.shadow_rows - 1) / 2.0) * row_angle - r * row_angle)
    col_y = 0.05 * np.tan(((f.shadow_cols - 1) / 2.0) * col_angle - c * col_angle)
    x = np.broadcast_to(row_x[:, None], (f.shadow_rows, f.shadow_cols)) + 0.008
    y = np.broadcast_to(col_y[None, :], (f.shadow_rows, f.shadow_cols)) + 0.0
    z = np.full_like(x, -(0.035 + 0.05) - 0.035)
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    return torch.from_numpy(pts)


def _sector_rank(score, pick, count, n_sectors, descending=True):
    """Rank picked points by score within each (row, sector): (H, W) int32
    rank (0 = best), W for unpicked."""
    H, W = score.shape
    dev = score.device
    pos = torch.arange(W, device=dev)[None, :].expand(H, W)
    sec = torch.clamp((pos * n_sectors) // torch.clamp(count[:, None], min=1), 0, n_sectors - 1)
    key_score = torch.where(pick, score if descending else -score, -_BIG)
    perm1 = torch.argsort(-key_score, dim=1, stable=True)
    sec_p = torch.gather(sec, 1, perm1)
    pick_p = torch.gather(pick, 1, perm1)
    perm2 = torch.argsort(torch.where(pick_p, sec_p, n_sectors), dim=1, stable=True)
    final = torch.gather(perm1, 1, perm2)
    sec_f = torch.gather(sec, 1, final)
    pick_f = torch.gather(pick, 1, final)
    sec_f = torch.where(pick_f, sec_f, n_sectors)
    new_seg = torch.ones((H, W), dtype=torch.bool, device=dev)
    new_seg[:, 1:] = sec_f[:, 1:] != sec_f[:, :-1]
    seg_start = torch.cummax(torch.where(new_seg, pos, 0), dim=1).values
    rank_sorted = torch.where(pick_f, pos - seg_start, W)
    rank = torch.zeros((H, W), dtype=torch.int64, device=dev)
    rank.scatter_(1, final, rank_sorted)
    return rank.to(torch.int32)


def extract_features(seg: SegmentedScan, cfg: LegoLoamConfig) -> ScanFeatures:
    """Feature picking: the fork's variant (whole-ring picking, DBSCAN-refined
    sharp corners, shadow points) when `use_ours`, else the upstream
    per-sector capped picking."""
    f = cfg.features
    dev = seg.xyz.device
    if f.use_ours:
        curv, computable = curvature_ours(seg, cfg)
    else:
        curv, computable = curvature_upstream(seg, cfg)
    pickable = computable & ~mark_occluded(seg, cfg)

    edge_cand = pickable & (curv > f.edge_threshold) & ~seg.ground
    flat_cand = pickable & (curv < f.surf_threshold) & seg.ground
    edge_pick = _nms_extremum(curv, edge_cand, seg.col, mode="max")
    flat_pick = _nms_extremum(curv, flat_cand, seg.col, mode="min")

    if not f.use_ours:
        e_rank = _sector_rank(curv, edge_pick, seg.count, f.num_sectors, True)
        f_rank = _sector_rank(curv, flat_pick, seg.count, f.num_sectors, False)
        sharp_pick = edge_pick & (e_rank < f.max_sharp_per_sector)
        edge_pick = edge_pick & (e_rank < f.max_less_sharp_per_sector)
        flat_pick = flat_pick & (f_rank < f.max_flat_per_sector)

    less_sharp = _gather_rows(seg, edge_pick, f.max_corner_less_sharp)
    flat = _gather_rows(seg, flat_pick, f.max_surf_flat)

    if f.use_ours:
        sharp = less_sharp.replace(mask=less_sharp.mask & dbscan_edge_filter(less_sharp, cfg))
    else:
        sharp = _gather_rows(seg, sharp_pick, f.max_corner_sharp)

    # Less-flat: everything not picked as an edge, voxel-downsampled with
    # ring/rel_time pooled alongside; ground and structure pooled apart.
    less_flat_src = seg.valid & ~edge_pick

    def _pool(pick, cap):
        c = _gather_rows(seg, pick, cap)
        xyz, m, (rel, ring) = voxel_downsample_masked(
            c.xyz, c.mask, f.less_flat_leaf, cfg.pipeline.local_voxel_radius,
            extras=[c.rel_time, c.ring.to(torch.float32)],
        )
        return FeatureCloud(
            xyz=xyz,
            ring=torch.where(m, torch.round(ring).to(torch.int32), -1).to(torch.int32),
            rel_time=torch.where(m, rel, 0.0),
            mask=m,
        )

    n_struct = f.max_surf_less_flat - f.surf_ground_cap
    lf_ground = _pool(less_flat_src & seg.ground, f.surf_ground_cap)
    lf_struct = _pool(less_flat_src & ~seg.ground, n_struct)
    less_flat = FeatureCloud(
        xyz=torch.cat([lf_ground.xyz, lf_struct.xyz]),
        ring=torch.cat([lf_ground.ring, lf_struct.ring]),
        rel_time=torch.cat([lf_ground.rel_time, lf_struct.rel_time]),
        mask=torch.cat([lf_ground.mask, lf_struct.mask]),
    )

    # Shadow points after the flats (rel_time 1, pseudo-ring H + 1).
    if f.use_shadow_points:
        sp = shadow_points(cfg, dev)
        nsp = sp.shape[0]
        cap = flat.xyz.shape[0]
        n_flat = torch.clamp(flat.count, max=cap - nsp)
        pos = torch.arange(cap, device=dev)
        keep = pos < n_flat
        sidx = pos - n_flat
        in_shadow = (sidx >= 0) & (sidx < nsp)
        sxyz = sp[sidx.clamp(0, nsp - 1)]
        flat = FeatureCloud(
            xyz=torch.where(in_shadow[:, None], sxyz, torch.where(keep[:, None], flat.xyz, 0.0)),
            ring=torch.where(
                in_shadow, cfg.laser.num_vertical_scans + 1, torch.where(keep, flat.ring, -1)
            ).to(torch.int32),
            rel_time=torch.where(in_shadow, 1.0, torch.where(keep, flat.rel_time, 0.0)),
            mask=keep | in_shadow,
        )

    return ScanFeatures(
        corner_sharp=sharp,
        corner_less_sharp=less_sharp,
        surf_flat=flat,
        surf_less_flat=less_flat,
        surf_ground=lf_ground,
    )
