"""How far the summation order of the plane fits moves the map-sharded GN
step, in float32 and in float64 (CPU, one thread, ~30 s).

    python tests/probe_plane_fit_order.py

Records the last mapping call of a 4-scan `vlp16()` run of the slice's
drive (the call that chip_smoke's phase 7h holds card against CPU), then
takes one GN step of `distributed.sharded_map_gn_step`'s arithmetic with
the 5-NN plane fits made two ways: `mapping.plane_fit_pca`'s covariance
and the same covariance summed in another order, each in float32 and in
float64. Near-collinear neighbourhoods leave the plane normal
ill-conditioned, so in float32 the order alone moves the step by ~1e-5 m;
in float64 by ~1e-7 m. The card sums in another order than the CPU.
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from lego_loam_torch.config import vlp16  # noqa: E402
from lego_loam_torch.io.synthetic import straight_trajectory, swept_scan_sequence  # noqa: E402
from lego_loam_torch import backend  # noqa: E402
from lego_loam_torch.math.linalg3 import eigh3x3  # noqa: E402
from lego_loam_torch.ops.knn import top5_l2  # noqa: E402
from lego_loam_torch.pipeline import LegoLoamPipeline  # noqa: E402


def fit(nbr, dtype, reorder):
    x = nbr.to(dtype)
    c = x.mean(dim=-2)
    d = x - c[..., None, :]
    if reorder:
        cov = (d[..., :, :, None] * d[..., :, None, :]).flip(-3).sum(-3)
    else:
        cov = torch.einsum("...ki,...kj->...ij", d, d)
    n = eigh3x3(cov)[1][..., :, 0]
    return n.float(), (-(n * c).sum(dim=-1)).float()


def step(call, cfg, dtype, reorder):
    """One GN step of the map-sharded step's arithmetic (one rank)."""
    q = call["q"] @ call["R"].T + call["t"]
    idx, d2 = top5_l2(q, call["map"], call["map_mask"])
    nbr = call["map"][idx.clamp(min=0).long()]
    ok = call["q_mask"] & (d2[:, 4] < cfg.mapping.nn_valid_dist)
    n, d_off = fit(nbr, dtype, reorder)
    plane_ok = torch.all(torch.abs(torch.einsum("qki,qi->qk", nbr, n) + d_off[:, None]) < cfg.mapping.plane_valid_dist, 1)
    pd = torch.sum(n * q, dim=-1) + d_off
    s = 1.0 - 0.9 * torch.abs(pd) / torch.sqrt(torch.clamp(torch.linalg.norm(q, dim=-1), min=1e-9))
    w = torch.where(ok & plane_ok & (s > 0.1), s, 0.0)
    J = torch.cat([torch.cross(q, n, dim=-1), n], dim=-1) * w[:, None]
    H, g = J.T @ J, J.T @ (pd * w)
    ev, V = torch.linalg.eigh(H)
    keep = (ev >= cfg.mapping.eigen_threshold).to(H.dtype)
    return -(V @ ((V.T @ g) * torch.where(ev > 1e-9, 1.0 / torch.clamp(ev, min=1e-9), 0.0) * keep))


def main():
    torch.set_num_threads(1)
    cfg = vlp16()
    poses = straight_trajectory(4, speed=0.1, yaw_rate=0.5 * torch.pi / 180)
    scans = list(swept_scan_sequence(poses, cfg, noise=0.005, seed=3))
    rec, fn = {}, backend.scan_to_map

    def recording(c_xyz, c_m, s_xyz, s_m, R0, t0, submap, cfg, sync_free=False):
        rec.update(q=s_xyz.clone(), q_mask=s_m.clone(), R=R0.clone(), t=t0.clone(),
                   map=submap.surf_xyz.clone(), map_mask=submap.surf_mask.clone())
        return fn(c_xyz, c_m, s_xyz, s_m, R0, t0, submap, cfg, sync_free)

    backend.scan_to_map = recording
    try:
        LegoLoamPipeline(cfg, seed=1, device="cpu").run_chunked(scans, chunk=4)
    finally:
        backend.scan_to_map = fn
    for dtype in (torch.float32, torch.float64):
        a, b = step(rec, cfg, dtype, False), step(rec, cfg, dtype, True)
        print(f"plane fits in {dtype}: the step moves {float(a[3:].norm()):.4f} m; summed in another order it "
              f"differs by {float((a - b)[3:].abs().max()):.3e} m and {float((a - b)[:3].abs().max()):.3e} rad")


if __name__ == "__main__":
    main()
