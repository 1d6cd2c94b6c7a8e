"""The swept-scan renderer of `synthetic.py` on the device, batched over
frames: one ray cast per beam of every scan in float64, the range noise
drawn from a `torch.Generator` on the same device.

`render_swept(jobs, cfg, world, gen, noise)` gives the (H*W, 3) float32
sensor-frame points of each job (pose0 -> pose1, the sweep of one scan),
NaN rows for misses, as host numpy arrays. Without noise it agrees with
`synthetic.render_scan_swept` to float64 rounding (a test holds it there).
"""

from __future__ import annotations

import numpy as np
import torch

from .synthetic import World, _log_so3_np, beam_directions

SENSOR_HEIGHT = 0.6


def column_poses(pose0, pose1, W: int):
    """(R (W, 3, 3), t (W, 3)) float64 of each column of a sweep from pose0
    to pose1 (column k at s = k / W), as `render_scan_swept` interpolates."""
    R0, t0 = pose0
    R1, t1 = pose1
    s = np.arange(W, dtype=np.float64) / float(W)
    dw = _log_so3_np(R0.T @ R1)
    th_total = np.linalg.norm(dw)
    if th_total < 1e-12:
        R_cols = np.broadcast_to(R0, (W, 3, 3))
    else:
        k = dw / th_total
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        th = s * th_total
        R_rel = np.eye(3)[None] + np.sin(th)[:, None, None] * K[None] + (1 - np.cos(th))[:, None, None] * (K @ K)[None]
        R_cols = np.einsum("ij,wjk->wik", R0, R_rel)
    t_cols = t0[None, :] * (1 - s[:, None]) + t1[None, :] * s[:, None]
    return np.ascontiguousarray(R_cols), t_cols


def ray_world(o, dirs, world: World):
    """Nearest hit distance of each ray (float64 tensors (..., 3)), at most
    world.max_range: `synthetic._ray_world` in torch."""
    t_best = torch.full(dirs.shape[:-1], world.max_range, dtype=torch.float64, device=dirs.device)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=dirs.device)

    def consider(t, valid):
        nonlocal t_best
        t_best = torch.minimum(t_best, torch.where(valid & (t > 0.05), t, inf))

    dz = dirs[..., 2]
    consider(-o[..., 2] / dz, dz < -1e-9)
    wc = (world.cx, world.cy)
    for axis, half in ((0, world.half_x), (1, world.half_y)):
        for sgn in (1.0, -1.0):
            d = dirs[..., axis]
            t = (wc[axis] + sgn * half - o[..., axis]) / d
            z = o[..., 2] + t * dz
            other = 1 - axis
            u = o[..., other] + t * dirs[..., other]
            lim = world.half_y if axis == 0 else world.half_x
            consider(t, (d.abs() > 1e-9) & (z >= 0) & (z <= world.wall_height) & ((u - wc[other]).abs() <= lim))
    for cx, cy, r, h in world.pillars:
        px = o[..., 0] - cx
        py = o[..., 1] - cy
        a = dirs[..., 0] ** 2 + dirs[..., 1] ** 2
        b = 2 * (px * dirs[..., 0] + py * dirs[..., 1])
        c = px * px + py * py - r * r
        disc = b * b - 4 * a * c
        t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2 * a)
        z = o[..., 2] + t * dz
        consider(t, (disc > 0) & (a > 1e-12) & (z >= 0) & (z <= h))
    inv = 1.0 / dirs
    for cx, cy, hx, hy, h in world.boxes:
        lo = torch.tensor([cx - hx, cy - hy, 0.0], dtype=torch.float64, device=dirs.device)
        hi = torch.tensor([cx + hx, cy + hy, h], dtype=torch.float64, device=dirs.device)
        t0 = (lo - o) * inv
        t1 = (hi - o) * inv
        tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
        tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
        consider(tmin, (tmax >= tmin) & torch.isfinite(tmin))
    return t_best


def render_swept(jobs, cfg, world: World, gen: torch.Generator | None = None, noise: float = 0.0,
                 batch: int = 32) -> list:
    """One swept scan per job (pose0, pose1) in `world`, `batch` scans per
    device pass, on the generator's device (the CPU without one). Range
    noise of `noise` metres (standard deviation) is drawn from `gen`, scan
    after scan, so the same generator state gives the same scans."""
    dev = gen.device if gen is not None else torch.device("cpu")
    dirs_s = torch.from_numpy(beam_directions(cfg).astype(np.float64)).to(dev)  # (H, W, 3)
    H, W, _ = dirs_s.shape
    out = []
    for s in range(0, len(jobs), batch):
        cols = [column_poses(p0, p1, W) for p0, p1 in jobs[s: s + batch]]
        R = torch.from_numpy(np.stack([c[0] for c in cols])).to(dev)  # (B, W, 3, 3)
        t = torch.from_numpy(np.stack([c[1] for c in cols])).to(dev)  # (B, W, 3)
        dirs_w = torch.einsum("bkij,hkj->bhki", R, dirs_s)
        origins = torch.cat([t[:, None, :, :2].expand(-1, H, -1, -1),
                             torch.full((len(cols), H, W, 1), SENSOR_HEIGHT, dtype=torch.float64, device=dev)], dim=-1)
        dist = ray_world(origins, dirs_w, world)
        if noise > 0:
            dist = dist + torch.randn(dist.shape, generator=gen, dtype=torch.float64, device=dev) * noise
        hit = torch.isfinite(dist) & (dist < world.max_range)
        pts = torch.where(hit[..., None], dirs_s * dist[..., None], float("nan"))
        out.extend(pts.reshape(len(cols), H * W, 3).to(torch.float32).cpu().numpy())
    return out
