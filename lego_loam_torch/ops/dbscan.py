"""DBSCAN edge-feature refinement as dense connected components (port of
`lego_loam_tpu/ops/dbscan.py`).

The reference's sequential label merge over less-sharp corners with an
anisotropic, range-dependent epsilon equals the connected components of the
symmetrized epsilon-neighbourhood graph. The graph is one dense masked
distance matrix; components come from a fixed number of min-label sweeps
with pointer jumping. Clusters of at least `dbscan_min_cluster` survive.
"""

from __future__ import annotations

import math

import torch

from ..config import LegoLoamConfig
from ..types import FeatureCloud


def _aniso_scales(xyz, cfg: LegoLoamConfig):
    """kxy, kz per point (lidar frame)."""
    f = cfg.features
    rxy = torch.sqrt(xyz[:, 0] ** 2 + xyz[:, 1] ** 2)
    elev = torch.atan2(xyz[:, 2], torch.clamp(rxy, min=1e-9))
    kxy = rxy * math.sin(cfg.laser.ang_res_x) * f.dbscan_ratio_xy
    kz = (
        (rxy * torch.tan(elev + cfg.laser.ang_res_y) - rxy * torch.tan(elev - cfg.laser.ang_res_y))
        / 2.0
        * f.dbscan_ratio_z
    )
    return torch.clamp(kxy, min=1e-6), torch.clamp(kz.abs(), min=1e-6)


def dbscan_edge_filter(cloud: FeatureCloud, cfg: LegoLoamConfig) -> torch.Tensor:
    """Returns (N,) bool: point belongs to a cluster of >= min_cluster."""
    f = cfg.features
    xyz, mask = cloud.xyz, cloud.mask
    N = xyz.shape[0]
    dev = xyz.device

    kxy, kz = _aniso_scales(xyz, cfg)
    # normalized squared distance with the scales of the neighbour j
    dx = xyz[:, None, 0] - xyz[None, :, 0]
    dy = xyz[:, None, 1] - xyz[None, :, 1]
    dz = xyz[:, None, 2] - xyz[None, :, 2]
    d2 = (dx * dx + dy * dy) / (kxy[None, :] ** 2) + dz * dz / (kz[None, :] ** 2)
    adj = d2 <= f.dbscan_radius ** 2
    adj = (adj | adj.T) & mask[:, None] & mask[None, :]

    big = N
    label = torch.where(mask, torch.arange(N, dtype=torch.int64, device=dev), big)
    bigv = torch.full((1,), big, dtype=torch.int64, device=dev)
    iters = max(4, int(math.ceil(math.log2(max(N, 2)))))
    for _ in range(iters):
        nei = torch.where(adj, label[None, :], big).amin(dim=1)
        m = torch.minimum(label, nei)
        m = torch.cat([m, bigv])[m]
        m = torch.cat([m, bigv])[m]
        label = torch.where(mask, m, big)

    sizes = torch.zeros(N + 1, dtype=torch.int64, device=dev).index_add_(
        0, label, mask.to(torch.int64)
    )
    return mask & (sizes[label] >= f.dbscan_min_cluster)
