"""Cluster segmentation on the range image (port of
`lego_loam_tpu/ops/segmentation.py`).

Connected components of the 4-neighbour graph (columns wrap) are labelled
by the plain PyTorch label propagation on every device: every pixel gets
the row-major index of its component's smallest pixel, the fixpoint of the
reference's `converged_labels`. Segment validity
(>= 30 px, or >= segment_valid_point_num px over >= segment_valid_line_num
rows) comes from segment sums over those labels.
"""

from __future__ import annotations

import math

import torch

from ..config import LegoLoamConfig
from ..types import ScanGrid, SegmentedScan

OUTLIER = 0
INVALID = -1


def _connectivity(grid: ScanGrid, candidate, cfg: LegoLoamConfig):
    """Edges to the 4 neighbours that pass the angle criterion
    d2 sin(a) / (d1 - d2 cos(a)) > tan(segment_theta). Returns bool
    [left, right, up, down] of the grid's shape (batched grids allowed;
    columns wrap)."""
    rng = grid.range
    thr = math.tan(cfg.segmentation.segment_theta)

    def edge(a_rng, b_rng, alpha):
        d1 = torch.maximum(a_rng, b_rng)
        d2 = torch.minimum(a_rng, b_rng)
        tang = d2 * math.sin(alpha) / torch.clamp(d1 - d2 * math.cos(alpha), min=1e-9)
        return tang > thr

    ax, ay = cfg.laser.ang_res_x, cfg.laser.ang_res_y
    left = candidate & torch.roll(candidate, 1, dims=-1) & edge(rng, torch.roll(rng, 1, dims=-1), ax)
    right = candidate & torch.roll(candidate, -1, dims=-1) & edge(rng, torch.roll(rng, -1, dims=-1), ax)
    vpair = candidate[..., 1:, :] & candidate[..., :-1, :] & edge(
        rng[..., 1:, :], rng[..., :-1, :], ay
    )
    up = torch.zeros_like(candidate)
    up[..., 1:, :] = vpair
    down = torch.zeros_like(candidate)
    down[..., :-1, :] = vpair
    return left, right, up, down


def _hook_step(lab, left, right, up, down, candidate):
    """One round of the plain labeller on an (H, W) grid: hook every root to
    the smallest label among its pixels' connected neighbours, then compress
    the root chains. At the fixpoint it changes nothing."""
    H, W = lab.shape
    big = H * W
    fill = torch.full_like(lab, big)
    pad = torch.full((1, W), big, dtype=lab.dtype, device=lab.device)
    nmin = torch.where(left, torch.roll(lab, 1, dims=1), fill)
    nmin = torch.minimum(nmin, torch.where(right, torch.roll(lab, -1, dims=1), fill))
    nmin = torch.minimum(nmin, torch.where(up, torch.cat([pad, lab[:-1]], 0), fill))
    nmin = torch.minimum(nmin, torch.where(down, torch.cat([lab[1:], pad], 0), fill))
    flat = lab.reshape(-1).long()
    ident = torch.arange(big + 1, dtype=lab.dtype, device=lab.device)
    table = ident.clone().scatter_reduce(0, flat, nmin.reshape(-1), "amin")
    while True:  # compress: table[x] <= x, so chains shorten to their roots
        nxt = table[table.long()]
        if torch.equal(nxt, table):
            break
        table = nxt
    return torch.where(candidate, table[flat].reshape(H, W), fill)


def label_prop_plain(left, right, up, down, candidate):
    """Plain PyTorch twin of K1: (..., H, W) bool masks -> (..., H, W) int32
    component-minimum labels, H*W for non-candidates. Runs to the fixpoint."""
    if candidate.dim() > 2:
        return torch.stack([
            label_prop_plain(*m) for m in zip(left, right, up, down, candidate)
        ])
    H, W = candidate.shape
    idx = torch.arange(H * W, dtype=torch.int32, device=candidate.device).reshape(H, W)
    lab = torch.where(candidate, idx, H * W)
    while True:
        new = _hook_step(lab, left, right, up, down, candidate)
        if torch.equal(new, lab):
            return lab
        lab = new


def label_prop(left, right, up, down, candidate):
    """Connected-component labels of (H, W) or (B, H, W) bool masks, on any
    device by the plain label propagation."""
    return label_prop_plain(left, right, up, down, candidate)


def converged_labels(grid: ScanGrid, cfg: LegoLoamConfig):
    """Connected-component root ids before the feasibility collapse:
    ((..., H, W) int32 root pixel index, H*W for non-candidates; candidate
    mask). Accepts a batch of grids stacked on a leading dim."""
    candidate = grid.valid & (grid.ground != 1)
    left, right, up, down = _connectivity(grid, candidate, cfg)
    return label_prop(left, right, up, down, candidate), candidate


def label_components(grid: ScanGrid, cfg: LegoLoamConfig, raw=None) -> torch.Tensor:
    """(H, W) int32: INVALID for non-candidates, OUTLIER for points in
    infeasible segments, else 1 + the component's root index. `raw` takes
    precomputed `converged_labels` (the pipeline labels a chunk at once)."""
    H, W = grid.range.shape
    dev = grid.range.device
    candidate = grid.valid & (grid.ground != 1)
    label = converged_labels(grid, cfg)[0] if raw is None else raw
    big = H * W
    flat = label.reshape(-1).long()
    sizes = torch.zeros(big + 1, dtype=torch.int32, device=dev).index_add_(
        0, flat, candidate.reshape(-1).to(torch.int32)
    )
    # Distinct-row count per root, one mark per (row, label) first occurrence.
    # The root pixel itself is left out: the reference's BFS marks a row only
    # for pushed neighbours, so the seed's row counts only if another pixel
    # of the component shares it.
    idx2d = torch.arange(big, dtype=label.dtype, device=dev).reshape(H, W)
    nonroot = torch.where(label == idx2d, big, label)
    lab_sorted = torch.sort(nonroot, dim=1).values
    first = torch.cat(
        [torch.ones((H, 1), dtype=torch.bool, device=dev), lab_sorted[:, 1:] != lab_sorted[:, :-1]],
        dim=1,
    ) & (lab_sorted < big)
    row_counts = torch.zeros(big + 1, dtype=torch.int32, device=dev).index_add_(
        0, lab_sorted.reshape(-1).long(), first.reshape(-1).to(torch.int32)
    )
    seg = cfg.segmentation
    feasible = (sizes >= seg.segment_large_point_num) | (
        (sizes >= seg.segment_valid_point_num) & (row_counts >= seg.segment_valid_line_num)
    )
    ok = feasible[flat].reshape(H, W)
    out = torch.where(ok, label + 1, OUTLIER)
    return torch.where(candidate, out, INVALID).to(torch.int32)


def _stable_argsort(key, dim=-1):
    return torch.argsort(key, dim=dim, stable=True)


def segment_cloud(grid: ScanGrid, cfg: LegoLoamConfig, raw=None):
    """Keep valid-segment points plus every-5th ground column (and the 5
    edge columns), pack each row's keepers to the front, and gather the
    every-5th-column outliers below the ground band into their own cloud."""
    H, W = grid.range.shape
    dev = grid.range.device
    label = label_components(grid, cfg, raw)
    grid = grid.replace(label=label)

    cols = torch.arange(W, device=dev)[None, :].expand(H, W)
    rows = torch.arange(H, device=dev)[:, None].expand(H, W)
    is_ground = grid.ground == 1
    ground_keep = is_ground & ((cols % 5 == 0) | (cols <= 5) | (cols >= W - 5))
    keep = ((label > 0) | ground_keep) & grid.valid

    order = _stable_argsort(torch.where(keep, cols, W + cols), dim=1)

    def pack(a):
        if a.dim() == 2:
            return torch.gather(a, 1, order)
        return torch.gather(a, 1, order[..., None].expand(H, W, a.shape[-1]))

    count = keep.sum(dim=1)
    packed_valid = torch.arange(W, device=dev)[None, :] < count[:, None]

    outlier = (label == OUTLIER) & (rows > cfg.laser.ground_scan_index) & (cols % 5 == 0)
    No = (H * W) // 5 + 1
    oflat = outlier.reshape(-1)
    oorder = _stable_argsort((~oflat).to(torch.uint8))[:No]
    omask = oflat[oorder]
    oxyz = grid.xyz.reshape(-1, 3)[oorder]
    orel = grid.rel_time.reshape(-1)[oorder]

    seg = SegmentedScan(
        xyz=torch.where(packed_valid[..., None], pack(grid.xyz), 0.0),
        range=torch.where(packed_valid, pack(grid.range), 0.0),
        col=torch.where(packed_valid, pack(cols), 0).to(torch.int32),
        ground=packed_valid & pack(is_ground),
        valid=packed_valid,
        count=count.to(torch.int32),
        rel_time=torch.where(packed_valid, pack(grid.rel_time), 0.0),
        outlier_xyz=torch.where(omask[:, None], oxyz, 0.0),
        outlier_mask=omask,
        outlier_rel=torch.where(omask, orel, 0.0),
    )
    return grid, seg
