"""Frozen copy of the port's course: the analytic world, its ray caster,
the swept-scan renderer and the lap trajectory (`lego_loam_torch/io/
synthetic.py` as it stood when the benchmark was written), numpy only.

The benchmark keeps its own copy so that a later change to the port's
synthetic module cannot change the benchmark's inputs. `render.py` runs
the same ray caster on the device; tests hold both this copy against the
port's renderer (bit for bit) and the device renderer against this copy.
A configuration argument needs only `cfg.laser` (rings, columns, the
bottom angle and the vertical resolution).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass
class World:
    """Axis-aligned analytic scene. Units: meters, world z-up, ground z=0."""

    half_x: float = 20.0  # room half-extent in x
    half_y: float = 15.0
    wall_height: float = 3.0
    # Wall-box center (the walls sit at cx +- half_x, cy +- half_y); lets a
    # generated world enclose a trajectory that does not start at its center.
    cx: float = 0.0
    cy: float = 0.0
    # Cylindrical pillars: (cx, cy, radius, height)
    pillars: Sequence[tuple] = (
        (6.0, 4.0, 0.3, 2.5),
        (-5.0, -6.0, 0.4, 2.5),
        (10.0, -5.0, 0.25, 2.5),
        (-12.0, 7.0, 0.35, 2.5),
        (2.0, -10.0, 0.3, 2.5),
        (-8.0, 11.0, 0.3, 2.5),
        (14.0, 8.0, 0.4, 2.5),
        (-15.0, -9.0, 0.3, 2.5),
    )
    # Boxes: (cx, cy, hx, hy, height)
    boxes: Sequence[tuple] = (
        (8.0, 10.0, 1.0, 0.8, 1.2),
        (-10.0, -2.0, 1.2, 1.0, 1.5),
        (3.0, 7.0, 0.7, 0.7, 1.0),
        (-4.0, 9.0, 0.9, 1.1, 1.3),
        (12.0, 1.0, 1.1, 0.6, 1.1),
        (-14.0, 3.0, 0.8, 0.8, 0.9),
    )
    max_range: float = 80.0


def beam_directions(cfg) -> np.ndarray:
    """(H, W, 3) unit directions in the sensor frame (x fwd, y left, z up)."""
    laser = cfg.laser
    H, W = laser.num_vertical_scans, laser.num_horizontal_scans
    elev = laser.vertical_angle_bottom + np.arange(H) * laser.ang_res_y
    # Column k maps back through the projection formula: the projector assigns
    # col = -round((atan2(x,y) - pi/2)/res) + W/2, so emit azimuth
    # atan2(x,y) = pi/2 - (col - W/2) * res.
    az = np.pi / 2.0 - (np.arange(W) - W // 2) * laser.ang_res_x
    ce, se = np.cos(elev)[:, None], np.sin(elev)[:, None]
    # atan2(x, y) = az  =>  x = sin(az), y = cos(az) in the horizontal plane
    dx = ce * np.sin(az)[None, :]
    dy = ce * np.cos(az)[None, :]
    dz = np.broadcast_to(se, dx.shape)
    return np.stack([dx, dy, dz], axis=-1)


def _ray_world(origin, dirs, world: World) -> np.ndarray:
    """Min positive hit distance per ray. origin (3,) or broadcastable
    (..., 3) per-ray origins, dirs (...,3)."""
    origin = np.asarray(origin, np.float64)
    if origin.ndim == 1:
        o = origin.reshape((1,) * (dirs.ndim - 1) + (3,))
    else:
        o = np.broadcast_to(origin, dirs.shape)
    t_best = np.full(dirs.shape[:-1], world.max_range, np.float64)

    def consider(t, valid):
        nonlocal t_best
        t = np.where(valid & (t > 0.05), t, np.inf)
        t_best = np.minimum(t_best, t)

    dz = dirs[..., 2]
    # Ground plane z=0
    with np.errstate(divide="ignore", invalid="ignore"):
        t = -o[..., 2] / dz
    consider(t, dz < -1e-9)

    # Room walls: planes x=cx±half_x, y=cy±half_y with z in [0, wall_height]
    wc = (world.cx, world.cy)
    for axis, half in ((0, world.half_x), (1, world.half_y)):
        for sgn in (1.0, -1.0):
            d = dirs[..., axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (wc[axis] + sgn * half - o[..., axis]) / d
            z = o[..., 2] + t * dz
            other = 1 - axis
            u = o[..., other] + t * dirs[..., other]
            lim = world.half_y if axis == 0 else world.half_x
            consider(t, (np.abs(d) > 1e-9) & (z >= 0) & (z <= world.wall_height) & (np.abs(u - wc[other]) <= lim))

    # Pillars (vertical cylinders)
    for cx, cy, r, h in world.pillars:
        px = o[..., 0] - cx
        py = o[..., 1] - cy
        a = dirs[..., 0] ** 2 + dirs[..., 1] ** 2
        b = 2 * (px * dirs[..., 0] + py * dirs[..., 1])
        c = px * px + py * py - r * r
        disc = b * b - 4 * a * c
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a)
        z = o[..., 2] + t * dz
        consider(t, (disc > 0) & (a > 1e-12) & (z >= 0) & (z <= h))

    # Boxes (AABB slab method, z in [0, height])
    for cx, cy, hx, hy, h in world.boxes:
        lo = np.array([cx - hx, cy - hy, 0.0])
        hi = np.array([cx + hx, cy + hy, h])
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / dirs
        t0 = (lo - o) * inv
        t1 = (hi - o) * inv
        tmin = np.max(np.minimum(t0, t1), axis=-1)
        tmax = np.min(np.maximum(t0, t1), axis=-1)
        consider(tmin, (tmax >= tmin) & np.isfinite(tmin))

    return t_best


def _log_so3_np(R):
    tr = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(tr)
    if th < 1e-9:
        return np.zeros(3)
    w = (
        np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        / (2.0 * np.sin(th))
    )
    return w * th


def render_scan_swept(
    pose0,
    pose1,
    cfg,
    world: Optional[World] = None,
    noise: float = 0.0,
    seed: int = 0,
    sensor_height: float = 0.6,
) -> np.ndarray:
    """Render one scan while the sensor MOVES from pose0 to pose1 over the
    sweep — simulating real spinning-lidar motion distortion. Column k is
    captured at relative time s = k/W (matching projection.py's rel_time
    convention) from the interpolated pose; each point is returned in the
    sensor frame AT ITS CAPTURE TIME, exactly like a real driver packet.
    """
    world = world or World()
    R0, t0 = pose0
    R1, t1 = pose1
    dirs_s = beam_directions(cfg).astype(np.float64)  # (H, W, 3)
    H, W, _ = dirs_s.shape
    s = np.arange(W, dtype=np.float64) / float(W)

    dw = _log_so3_np(R0.T @ R1)
    # Vectorized Rodrigues over columns: fixed axis k, angle s*theta.
    th_total = np.linalg.norm(dw)
    if th_total < 1e-12:
        R_cols = np.broadcast_to(R0, (W, 3, 3))
    else:
        k = dw / th_total
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        th = s * th_total  # (W,)
        I = np.eye(3)
        R_rel = (
            I[None]
            + np.sin(th)[:, None, None] * K[None]
            + (1 - np.cos(th))[:, None, None] * (K @ K)[None]
        )
        R_cols = np.einsum("ij,wjk->wik", R0, R_rel)  # (W,3,3)
    t_cols = t0[None, :] * (1 - s[:, None]) + t1[None, :] * s[:, None]

    # world-frame directions per column: dirs_w[h,k] = R_cols[k] @ dirs_s[h,k]
    dirs_w = np.einsum("kij,hkj->hki", R_cols, dirs_s)
    origins = np.concatenate(
        [t_cols[None, :, :2].repeat(H, axis=0),
         np.full((H, W, 1), sensor_height)], axis=-1,
    )
    dist = _ray_world(origins, dirs_w, world)
    if noise > 0:
        rs = np.random.RandomState(seed)
        dist = dist + rs.randn(*dist.shape) * noise
    hit = np.isfinite(dist) & (dist < world.max_range)
    pts = dirs_s * dist[..., None]
    pts = np.where(hit[..., None], pts, np.nan)
    return pts.reshape(-1, 3).astype(np.float32)


def campus_world(
    poses,
    margin: float = 12.0,
    n_buildings: int = 14,
    n_pillars: int = 22,
    clearance: float = 2.0,
    wall_height: float = 4.0,
    seed: int = 7,
) -> World:
    """Build a structure-rich 'campus' World that encloses a trajectory.

    ≙ the reference's defining Stevens-campus workload (README.md:108-111):
    a building-dominated outdoor scene. Rectangular 'buildings' (boxes with
    flat walls and sharp vertical edges — the clean, view-independent edge
    features LOAM-class odometry needs) plus cylindrical 'trees/lampposts'
    are scattered around the course with a clearance corridor, and the
    perimeter wall encloses the trajectory bounding box + margin. Cylinder
    silhouette edges are view-dependent (the tangent point slides and the
    azimuth-sampled range near grazing incidence is ~10 cm noisy), so a
    pillar-only world starves the scan-to-scan corner stage; buildings fix
    the feature diet, matching real campus geometry."""
    pts = np.stack([t[:2] for _, t in poses])
    lo = pts.min(axis=0) - margin
    hi = pts.max(axis=0) + margin
    cx, cy = (lo + hi) / 2.0
    half_x, half_y = (hi - lo) / 2.0

    rs = np.random.RandomState(seed)

    def free(cand_xy, radius):
        d = np.linalg.norm(pts - np.asarray(cand_xy)[None, :], axis=1)
        return d.min() > radius + clearance

    boxes = []
    tries = 0
    while len(boxes) < n_buildings and tries < 4000:
        tries += 1
        bx = rs.uniform(lo[0] + 2, hi[0] - 2)
        by = rs.uniform(lo[1] + 2, hi[1] - 2)
        hx = rs.uniform(1.5, 3.5)
        hy = rs.uniform(1.5, 3.5)
        h = rs.uniform(2.5, 5.0)
        if free((bx, by), max(hx, hy) * 1.42):
            boxes.append((bx, by, hx, hy, h))

    pillars = []
    tries = 0
    while len(pillars) < n_pillars and tries < 4000:
        tries += 1
        px = rs.uniform(lo[0] + 1, hi[0] - 1)
        py = rs.uniform(lo[1] + 1, hi[1] - 1)
        r = rs.uniform(0.15, 0.4)
        h = rs.uniform(2.5, 3.5)
        near_box = any(
            abs(px - b[0]) < b[2] + 1 and abs(py - b[1]) < b[3] + 1
            for b in boxes
        )
        if not near_box and free((px, py), r):
            pillars.append((px, py, r, h))

    return World(
        half_x=float(half_x),
        half_y=float(half_y),
        wall_height=wall_height,
        cx=float(cx),
        cy=float(cy),
        pillars=tuple(pillars),
        boxes=tuple(boxes),
    )


def _start_at_identity(poses):
    """Re-express world poses in the frame of the first pose, so pose 0 is
    (I, 0) — the SLAM estimator's world frame. Without this, comparing an
    estimated trajectory against the generator's raw poses measures the
    arbitrary start offset, not drift."""
    R0, t0 = poses[0]
    return [(R0.T @ R, R0.T @ (t - t0)) for R, t in poses]


def lap_trajectory(
    n_laps: int = 3,
    straight_frames: int = 150,
    turn_frames: int = 25,
    speed: float = 0.12,
    half_x: float = 12.0,
    half_y: float = 8.0,
):
    """Rectangular multi-lap course (campus-style revisits for loop
    closure): straights along the rectangle sides with 90-degree corner
    turns. Returns list of (R, t) world poses starting at (-half_x, -half_y)
    heading +x."""
    poses = []
    x = np.array([-half_x, -half_y, 0.0])
    yaw = 0.0
    for _ in range(n_laps):
        for _leg in range(4):
            for _ in range(straight_frames):
                c, s = np.cos(yaw), np.sin(yaw)
                R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
                poses.append((R, x.copy()))
                x = x + R @ np.array([speed, 0.0, 0.0])
            dyaw = (np.pi / 2.0) / turn_frames
            for _ in range(turn_frames):
                c, s = np.cos(yaw), np.sin(yaw)
                R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
                poses.append((R, x.copy()))
                x = x + R @ np.array([speed, 0.0, 0.0])
                yaw += dyaw
    return _start_at_identity(poses)
