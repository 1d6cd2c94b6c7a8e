"""Ground segmentation: the upstream slope test and the fork's algorithm.

Port of `lego_loam_tpu/ops/ground.py`. The per-column reference-vector walk
is a loop over the H rows with all W columns vectorized; the sequential ADD
sweeps are boolean-semiring prefix products by doubling (log depth); the
ELEVATION carry is a running max; the near-field RANSAC scores every
hypothesis at once.

The NEAR pass takes its RANSAC scores as an argument: the pipeline draws
them from a `torch.Generator` seeded from (seed, frame), and parity tests
hand in the JAX package's threefry draw instead.

Ground codes: -1 invalid, 0 non-ground, 1 ground, 2 unknown (pending).
"""

from __future__ import annotations

import torch

from ..config import LegoLoamConfig
from ..types import ScanGrid


def _int8(v, like):
    return torch.full((), v, dtype=torch.int8, device=like.device)  # a fill: no upload


def ground_removal_upstream(grid: ScanGrid, cfg: LegoLoamConfig) -> torch.Tensor:
    """Per-column vertical-angle test between adjacent rows (rows < gsi)."""
    H, W = grid.range.shape
    gsi = cfg.laser.ground_scan_index
    xyz, valid = grid.xyz, grid.valid

    d = xyz[1:] - xyz[:-1]
    dxy = torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2 + d[..., 2] ** 2)
    vert_angle = torch.atan2(d[..., 2], dxy)
    pair_ok = valid[1:] & valid[:-1]
    is_flat = pair_ok & (
        (vert_angle - cfg.laser.sensor_mount_angle) <= cfg.ground.upstream_angle_threshold
    )
    row_in_band = (torch.arange(H - 1, device=xyz.device) < gsi)[:, None]
    flat_band = is_flat & row_in_band
    ground = torch.zeros((H, W), dtype=torch.bool, device=xyz.device)
    ground[:-1] = flat_band
    ground[1:] |= flat_band

    invalid_pair = (~pair_ok) & row_in_band
    code = ground.to(torch.int8)
    code[:-1] = torch.where(invalid_pair & (code[:-1] == 0), _int8(-1, code), code[:-1])
    return torch.where(valid, code, _int8(-1, code))


def _main_pass(grid: ScanGrid, cfg: LegoLoamConfig) -> torch.Tensor:
    """Column-wise reference-vector iteration down the rows."""
    H, W = grid.range.shape
    g = cfg.ground
    xyz, valid = grid.xyz, grid.valid
    dev = xyz.device

    rv = torch.zeros((W, 3), device=dev)
    lower = torch.zeros((W, 3), device=dev)
    seeded = torch.zeros((W,), dtype=torch.bool, device=dev)
    codes = []
    for i in range(H):
        thr = g.angle_threshold_low if (cfg.laser.use_kitti and i < 16) else g.angle_threshold
        p, ok = xyz[i], valid[i]
        depth0 = torch.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2)
        dd = torch.clamp(depth0, min=1e-9)
        init_rv = torch.stack([p[:, 0] / dd, p[:, 1] / dd, torch.zeros_like(depth0)], dim=-1)

        tv = p - lower
        tv_n = torch.linalg.norm(tv, dim=-1)
        rv_n = torch.linalg.norm(rv, dim=-1)
        cosang = torch.sum(tv * rv, dim=-1) / torch.clamp(tv_n * rv_n, min=1e-12)
        accept = torch.arccos(torch.clamp(cosang, -1.0, 1.0)) <= thr

        first = ok & ~seeded
        cont = ok & seeded
        code = torch.where(cont, accept.to(torch.int8), _int8(-1, p))
        codes.append(torch.where(first, _int8(1, p), code))

        rv = torch.where(
            first[:, None], init_rv, torch.where((cont & accept)[:, None], rv + tv, rv)
        )
        lower = torch.where(ok[:, None], p, lower)
        seeded = seeded | ok
    return torch.stack(codes)


def _filter_pass(code: torch.Tensor) -> torch.Tensor:
    """Above the first obstacle in each column, ground(1) -> unknown(2)."""
    seen = torch.cumsum((code == 0).to(torch.int32), dim=0) > 0
    return torch.where(seen & (code == 1), _int8(2, code), code)


def _add_gate(grid: ScanGrid, shift: int, cfg: LegoLoamConfig):
    """Re-admission gate vs the neighbour `shift` columns away:
    dr <= 0.061 r and dz <= 0.1."""
    g = cfg.ground
    xyz = grid.xyz
    d = xyz - torch.roll(xyz, shift, dims=1)
    dr = torch.linalg.norm(d, dim=-1)
    r = torch.linalg.norm(xyz, dim=-1)
    return (dr <= g.add_dr_ratio * r) & (d[..., 2] <= g.add_dz_max)


def _bool_affine_scan(orig1, gate, reverse):
    """s[j] = orig1[j] | (gate[j] & (s[j-1] | s[j-2])) along the columns, as
    an inclusive prefix product of 3x3 boolean-semiring matrices computed by
    doubling (state [s_j, s_{j-1}, 1])."""
    if reverse:
        orig1, gate = orig1.flip(1), gate.flip(1)
    H, W = orig1.shape
    gm = gate & ~orig1
    M = torch.zeros((H, W, 3, 3), dtype=torch.bool, device=orig1.device)
    M[..., 0, 0] = gm
    M[..., 0, 1] = gm
    M[..., 0, 2] = orig1
    M[..., 1, 0] = True
    M[..., 2, 2] = True
    d = 1
    while d < W:
        later, earlier = M[:, d:], M[:, :-d]
        prod = (later[..., :, :, None] & earlier[..., None, :, :]).any(dim=-2)
        M = torch.cat([M[:, :d], prod], dim=1)
        d *= 2
    s = M[..., 0, 2]
    return s.flip(1) if reverse else s


def _add_pass(grid: ScanGrid, code: torch.Tensor, cfg: LegoLoamConfig) -> torch.Tensor:
    """Bidirectional neighbour re-admission of unknown(2) cells."""
    is2 = code == 2
    orig1 = code == 1
    s_l = _bool_affine_scan(orig1, is2 & _add_gate(grid, 2, cfg), reverse=False)
    s_r = _bool_affine_scan(orig1, is2 & _add_gate(grid, -2, cfg), reverse=True)
    return torch.where(is2 & (s_l | s_r), _int8(1, code), code)


def _elevation_pass(grid: ScanGrid, code: torch.Tensor, cfg: LegoLoamConfig) -> torch.Tensor:
    """Height-gate unknown cells against the last column (scanning left to
    right) with at least `elevation_min_ground_count` ground cells."""
    g = cfg.ground
    H, W = code.shape
    dev = code.device
    is1 = code == 1
    gnum = is1.sum(dim=0)
    rows = torch.arange(H, device=dev)[:, None]
    top_row = torch.where(is1, rows, -1).amax(dim=0)
    cols = torch.arange(W, device=dev)
    z_top = grid.xyz[top_row.clamp(0, H - 1), cols, 2]
    has = gnum >= g.elevation_min_ground_count
    last = torch.cummax(torch.where(has, cols, -1), dim=0).values
    ele_h = torch.where(
        last >= 0, z_top[last.clamp(0, W - 1)], torch.full_like(z_top, g.elevation_init_height)
    )
    pass_gate = grid.xyz[..., 2] < (ele_h[None, :] + g.elevation_margin)
    return torch.where(code == 2, pass_gate.to(torch.int8), code)


def _plane_from_3(p):
    """p: (..., 3, 3) -> unit normal (..., 3), offset (...,)."""
    n = torch.linalg.cross(p[..., 1, :] - p[..., 0, :], p[..., 2, :] - p[..., 0, :])
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
    return n, -torch.sum(n * p[..., 0, :], dim=-1)


def ransac_scores(cfg: LegoLoamConfig, generator: torch.Generator, device) -> torch.Tensor:
    """Uniform (n_iters, H*W) scores that pick the RANSAC 3-subsets."""
    H, W = cfg.laser.num_vertical_scans, cfg.laser.num_horizontal_scans
    return torch.rand(
        (cfg.ground.ransac_iterations, H * W), generator=generator, device=device
    )


def _near_pass(grid: ScanGrid, code: torch.Tensor, cfg: LegoLoamConfig, scores) -> torch.Tensor:
    """Near-field RANSAC plane recovery: ground cells within
    `near_reset_depth` are demoted, then re-admitted if they are inliers of
    the best plane fitted to the ground cells within `near_depth_max`. Each
    hypothesis takes the 3 candidates with the highest score."""
    g = cfg.ground
    H, W = code.shape
    xyz = grid.xyz.reshape(-1, 3)
    flat_code = code.reshape(-1)
    depth = torch.sqrt(xyz[:, 0] ** 2 + xyz[:, 1] ** 2)
    cand = (flat_code == 1) & (depth <= g.near_depth_max) & grid.valid.reshape(-1)
    near = cand & (depth <= g.near_reset_depth)

    s = torch.where(cand[None, :], scores, -1.0)
    top_idx = torch.topk(s, 3, dim=1).indices  # (n_iters, 3)
    n, d = _plane_from_3(xyz[top_idx])

    dist = torch.abs(xyz @ n.T + d[None, :])  # (HW, n_iters)
    inl = (dist <= g.ransac_distance_threshold) & cand[:, None]
    best = torch.argmax(inl.sum(dim=0)).reshape(1)
    out = torch.where(near, _int8(0, code), flat_code)
    # index_select: indexing with a 0-d tensor would read it back to the host
    out = torch.where(near & inl.index_select(1, best)[:, 0], _int8(1, code), out)
    return out.reshape(H, W)


def ground_removal_ours(grid: ScanGrid, cfg: LegoLoamConfig, scores) -> torch.Tensor:
    """MAIN -> Filter -> ADD -> ELEVATION -> NEAR; codes {-1, 0, 1}."""
    code = _main_pass(grid, cfg)
    code = _filter_pass(code)
    code = _add_pass(grid, code, cfg)
    code = _elevation_pass(grid, code, cfg)
    code = _near_pass(grid, code, cfg, scores)
    return torch.where(grid.valid, code, _int8(-1, code))


def apply_ground(grid: ScanGrid, cfg: LegoLoamConfig, scores=None) -> ScanGrid:
    """scores: (ransac_iterations, H*W) uniform draws for the NEAR pass
    (required by the fork's variant, see `ransac_scores`)."""
    if cfg.ground.use_ours:
        if scores is None:
            raise ValueError("the fork's ground removal needs RANSAC scores")
        code = ground_removal_ours(grid, cfg, scores)
    else:
        code = ground_removal_upstream(grid, cfg)
    return grid.replace(ground=code)
