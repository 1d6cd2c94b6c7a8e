"""Range-image projection: unordered cloud -> (H, W) polar grid.

Port of `lego_loam_tpu/ops/projection.py`. The default feed is the range
image: the host packs the scans (`host_pack_range_images`, numpy, several
in one pass) and the device reconstructs xyz analytically
(`grid_from_range_image`).
`project_point_cloud` is the points feed, one scatter over the padded cloud.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import LegoLoamConfig
from ..types import ScanGrid

_INF = float("inf")


def _vlp32c_rows(elev, ang_bottom, quant, max_bins=256):
    """Map quantized elevation bins to dense row indices: mark observed bins
    in a fixed table, prefix-sum for dense indices, gather."""
    bins = torch.floor((elev + ang_bottom) / quant).to(torch.int64)
    ok = bins >= 0
    clamped = bins.clamp(0, max_bins - 1)
    present = torch.zeros((max_bins,), dtype=torch.int64, device=elev.device)
    present = present.scatter_reduce(0, clamped, ok.to(torch.int64), "amax")
    dense = torch.cumsum(present, 0) - 1
    return torch.where(ok, dense[clamped], -1), ok


def _empty_codes(H, W, device):
    return (
        torch.full((H, W), -1, dtype=torch.int8, device=device),
        torch.full((H, W), -1, dtype=torch.int32, device=device),
    )


def project_point_cloud(points, mask, cfg: LegoLoamConfig) -> ScanGrid:
    """points: (N, 3) float32 lidar-frame xyz; mask: (N,) bool valid points.
    Duplicate hits on a cell resolve to the minimum range (ties: min index)."""
    laser = cfg.laser
    H, W = laser.num_vertical_scans, laser.num_horizontal_scans
    dev = points.device

    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    rng = torch.sqrt(x * x + y * y + z * z)
    ok = mask & (rng > 0.1) & torch.isfinite(rng)
    elev = torch.arcsin(torch.where(ok, z / torch.clamp(rng, min=1e-12), 0.0))
    if laser.use_vlp32c:
        row, row_ok = _vlp32c_rows(elev, laser.ang_bottom, laser.vlp32c_row_quant)
        ok = ok & row_ok
    else:
        row = torch.round((elev + laser.ang_bottom) / laser.ang_res_y).to(torch.int64)
    ok = ok & (row >= 0) & (row < H)

    az = torch.atan2(x, y)
    col = -torch.round((az - math.pi / 2.0) / laser.ang_res_x).to(torch.int64) + W // 2
    col = torch.where(col >= W, col - W, col)
    ok = ok & (col >= 0) & (col < W)

    flat = torch.where(ok, row * W + col, H * W)
    grid_rng = torch.full((H * W + 1,), _INF, dtype=torch.float32, device=dev)
    grid_rng = grid_rng.scatter_reduce(0, flat, torch.where(ok, rng, _INF), "amin")
    won = ok & (rng <= grid_rng[flat])
    idx_src = torch.where(won, torch.arange(points.shape[0], device=dev), 0)
    grid_idx = torch.zeros((H * W + 1,), dtype=torch.int64, device=dev)
    grid_idx = grid_idx.scatter_reduce(0, torch.where(won, flat, H * W), idx_src, "amax")

    valid = (grid_rng[: H * W] < _INF).reshape(H, W)
    xyz = torch.where(
        valid.reshape(H * W, 1), points[grid_idx[: H * W]], 0.0
    ).reshape(H, W, 3)
    rel = (torch.arange(W, dtype=torch.float32, device=dev) / float(W))[None, :].expand(H, W)
    ground, label = _empty_codes(H, W, dev)
    return ScanGrid(
        xyz=xyz,
        range=grid_rng[: H * W].reshape(H, W),
        valid=valid,
        ground=ground,
        label=label,
        rel_time=torch.where(valid, rel, 0.0),
    )


def nearest_per_pixel(flat, rng, ok, n_pix=None):
    """Indices of the winning points, one per hit pixel: the nearest valid
    point (`ok`; its pixel `flat`, its float32 range `rng` above 0.1), ties
    to the lowest index; fewer than 2**32 points and pixels (n_pix, the
    twin's sentinel, is not needed). Two sorts of uint64 keys, which
    release the interpreter lock (a scatter-min by `np.minimum.at` holds
    it): the valid points by (range bits << 32 | index), a positive float's
    bits ordering as its value; then their ranks in that order by (pixel <<
    32 | rank), where the first key of each pixel names its winner."""
    lo, hi = np.uint64(0xFFFFFFFF), np.uint64(32)
    near = (rng[ok].view(np.uint32).astype(np.uint64) << hi) | np.flatnonzero(ok).astype(np.uint64)
    near.sort()
    near = (near & lo).astype(np.int64)  # the valid points' indices, nearest first
    by_pix = (flat[near].astype(np.uint64) << hi) | np.arange(len(near), dtype=np.uint64)
    by_pix.sort()
    pix = by_pix >> hi
    first = np.ones(len(pix), bool)
    first[1:] = pix[1:] != pix[:-1]
    return near[(by_pix[first] & lo).astype(np.int64)]


def nearest_per_pixel_lexsort(flat, rng, ok, n_pix):
    """The twin of `nearest_per_pixel`: one lexsort by (pixel, range), the
    first of each hit pixel (winners in pixel order; `flat` is n_pix where
    not ok)."""
    order = np.lexsort((np.where(ok, rng, np.inf), flat))
    f_s = flat[order]
    first = np.concatenate([[True], f_s[1:] != f_s[:-1]]) & (f_s < n_pix)
    return order[first]


def host_pack_range_images(clouds, cfg: LegoLoamConfig, winners=nearest_per_pixel):
    """numpy: K raw clouds ((N_k, 3), NaN rows = misses) -> (rimg uint16
    (K,H,W), az_resid int8 (K,H,W), elev_resid int8 (K,H,W), row_elev
    float32 (K,H)). Same row/col formulas and min-range tie-break as
    project_point_cloud. The int8 residual planes recover each point's
    azimuth and elevation against the bin centres. The K clouds go through
    each array operation together (cloud k's pixels at k*H*W), so each gets
    the planes it would get alone, bit for bit, in fewer and longer numpy
    calls. `winners(flat, rng, ok, K * H * W)` picks each pixel's point
    (`nearest_per_pixel_lexsort` is the twin that tests hold it against).
    With use_vlp32c the row table is the cloud's own: one cloud a call."""
    laser = cfg.laser
    H, W = laser.num_vertical_scans, laser.num_horizontal_scans
    K = len(clouds)
    if laser.use_vlp32c and K != 1:
        raise ValueError("VLP-32C rows come from each cloud's own elevations: pack one cloud a call")
    q = cfg.pipeline.feed_quant or 0.004

    parts = [np.asarray(p, np.float32) for p in clouds]
    pts = parts[0] if K == 1 else np.concatenate(parts)
    base = np.repeat(np.arange(K, dtype=np.int64) * (H * W), [len(p) for p in parts])
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    with np.errstate(invalid="ignore"):
        rng = np.sqrt(x * x + y * y + z * z)
        ok = np.isfinite(rng) & (rng > 0.1)
        elev = np.arcsin(np.where(ok, z / np.maximum(rng, 1e-12), 0.0))

    if laser.use_vlp32c:
        quant = laser.vlp32c_row_quant
        bins = np.floor((elev + laser.ang_bottom) / quant).astype(np.int64)
        ok = ok & (bins >= 0)
        ubins = np.unique(bins[ok])
        lut = {b: i for i, b in enumerate(ubins)}
        row = np.array([lut.get(b, -1) for b in bins], np.int64)
        row_elev = (ubins.astype(np.float32) + 0.5) * quant - laser.ang_bottom
        row_elev = np.pad(row_elev.astype(np.float32), (0, max(0, H - len(row_elev))))[:H]
    else:
        row = np.round((elev + laser.ang_bottom) / laser.ang_res_y).astype(np.int64)
        row_elev = np.arange(H, dtype=np.float32) * laser.ang_res_y - laser.ang_bottom
    ok = ok & (row >= 0) & (row < H)

    az = np.arctan2(np.nan_to_num(x), np.nan_to_num(y))
    col = -np.round((az - np.pi / 2.0) / laser.ang_res_x).astype(np.int64) + W // 2
    col = np.where(col >= W, col - W, col)
    ok = ok & (col >= 0) & (col < W)

    flat = np.where(ok, base + row * W + col, K * H * W)
    win = winners(flat, rng, ok, K * H * W)

    rimg = np.zeros((K * H * W,), np.uint16)
    rimg[flat[win]] = np.clip(np.rint(rng[win] / q), 1, 65535).astype(np.uint16)
    # azimuth residual vs the column-centre ray, in half-bin units
    az_c = (W // 2 - col[win]) * laser.ang_res_x + np.pi / 2.0
    resid = np.arctan2(np.sin(az[win] - az_c), np.cos(az[win] - az_c))
    azr = np.zeros((K * H * W,), np.int8)
    azr[flat[win]] = np.clip(
        np.rint(resid / (laser.ang_res_x / 2.0) * 127.0), -127, 127
    ).astype(np.int8)
    # elevation residual vs the row-centre beam, in half-row-spacing units
    e_scale = (laser.vlp32c_row_quant if laser.use_vlp32c else laser.ang_res_y) / 2.0
    resid_e = elev[win] - row_elev[row[win]]
    elr = np.zeros((K * H * W,), np.int8)
    elr[flat[win]] = np.clip(np.rint(resid_e / e_scale * 127.0), -127, 127).astype(np.int8)
    return rimg.reshape(K, H, W), azr.reshape(K, H, W), elr.reshape(K, H, W), np.tile(row_elev, (K, 1))


def host_pack_range_image(points, cfg: LegoLoamConfig, winners=nearest_per_pixel):
    """numpy: (N, 3) raw cloud -> (rimg uint16 (H,W), az_resid int8 (H,W),
    elev_resid int8 (H,W), row_elev float32 (H,)): `host_pack_range_images`
    of the one cloud."""
    return tuple(a[0] for a in host_pack_range_images([points], cfg, winners))


def grid_from_range_image(rimg, az_resid, elev_resid, row_elev, cfg: LegoLoamConfig) -> ScanGrid:
    """Reconstruct a ScanGrid from the packed range image (tensors on the
    target device: uint16 or int32 range codes, int8 residuals)."""
    laser = cfg.laser
    H, W = rimg.shape
    dev = rimg.device
    q = cfg.pipeline.feed_quant or 0.004

    r = rimg.to(torch.int32)
    valid = r > 0
    rng = r.to(torch.float32) * q
    col = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    az = (
        (W // 2 - col) * laser.ang_res_x
        + math.pi / 2.0
        + az_resid.to(torch.float32) * (laser.ang_res_x / 2.0 / 127.0)
    )
    e_scale = (laser.vlp32c_row_quant if laser.use_vlp32c else laser.ang_res_y) / 2.0
    elev = row_elev[:, None] + elev_resid.to(torch.float32) * (e_scale / 127.0)
    hor = rng * torch.cos(elev)
    xyz = torch.stack([hor * torch.sin(az), hor * torch.cos(az), rng * torch.sin(elev)], dim=-1)
    rel = (col / float(W)).expand(H, W)
    ground, label = _empty_codes(H, W, dev)
    return ScanGrid(
        xyz=torch.where(valid[..., None], xyz, 0.0),
        range=torch.where(valid, rng, _INF),
        valid=valid,
        ground=ground,
        label=label,
        rel_time=torch.where(valid, rel, 0.0),
    )
