"""Mapping back end: keyframe store + scan-to-map step (port of
`lego_loam_tpu/backend.py`).

The keyframe store is a fixed-capacity ring of device tensors in the
reference's flat layout (a keyframe's cloud is one row [x0, y0, z0, x1,
...]). Unlike the functional reference, `backend_step_ds` writes the new
keyframe's row IN PLACE: a copy of the store per frame would move ~1.4 GB
at the default capacity. The submap is cached and rebuilt only after the
vehicle moved `submap_rebuild_dist` or `submap_rebuild_every` keyframes
landed.

The store lies on one device; its accesses go through the helpers of
`store.py`, as the port's go through its store helpers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import LegoLoamConfig
from .control import cond
from .mapping import assemble_submap, map_prior, scan_to_map
from .math import se3
from .ops.voxel import voxel_downsample_masked
from .store import assign, gather_rows, write_row
from .types import MapState, ScanFeatures, _Base, named_leaves

# Per-keyframe cloud capacities (post-voxel-DS).
KF_CORNER_CAP = 1024
KF_SURF_CAP = 4096


@dataclasses.dataclass(frozen=True)
class BackendState(_Base):
    kf_R: torch.Tensor  # (K, 3, 3)
    kf_t: torch.Tensor  # (K, 3)
    kf_time: torch.Tensor  # (K,)
    kf_corner: torch.Tensor  # (K, 3*Nc) sensor-frame corner cloud per keyframe
    kf_corner_mask: torch.Tensor  # (K, Nc)
    kf_surf: torch.Tensor  # (K, 3*Ns) sensor-frame surf+outlier cloud
    kf_surf_mask: torch.Tensor  # (K, Ns)
    kf_rel_R: torch.Tensor  # (K, 3, 3) odometry-chain step from keyframe k-1
    kf_rel_t: torch.Tensor  # (K, 3)
    n_kf: torch.Tensor  # () int32, total appended; slot(i) = i % K
    R_map: torch.Tensor  # (3,3) latest mapped pose
    t_map: torch.Tensor  # (3,)
    R_odom: torch.Tensor  # (3,3) odometry pose at latest mapping
    t_odom: torch.Tensor  # (3,)
    submap: MapState
    submap_center: torch.Tensor  # (3,) position at last rebuild
    submap_n_kf: torch.Tensor  # () n_kf at last rebuild

    @property
    def capacity(self) -> int:
        return self.kf_t.shape[0]

    def kf_corner_view(self):
        """(K, Nc, 3) view of the flat corner store."""
        return self.kf_corner.view(self.capacity, -1, 3)

    def kf_surf_view(self):
        """(K, Ns, 3) view of the flat surf store."""
        return self.kf_surf.view(self.capacity, -1, 3)

    def ordered_slots(self):
        """Host helper: resident slots oldest -> newest (numpy int array);
        reads n_kf back."""
        K = self.capacity
        n = int(self.n_kf)
        a = min(n, K)
        start = (n - a) % K if K else 0
        return (start + np.arange(a)) % K

def init_backend_state(cfg: LegoLoamConfig, device="cuda") -> BackendState:
    K = cfg.mapping.max_keyframes
    m = cfg.mapping

    def eye3(*lead):
        return torch.eye(3, device=device).repeat(*lead, 1, 1)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return BackendState(
        kf_R=eye3(K),
        kf_t=zeros(K, 3),
        kf_time=zeros(K),
        kf_corner=zeros(K, KF_CORNER_CAP * 3),
        kf_corner_mask=zeros(K, KF_CORNER_CAP, dtype=torch.bool),
        kf_surf=zeros(K, KF_SURF_CAP * 3),
        kf_surf_mask=zeros(K, KF_SURF_CAP, dtype=torch.bool),
        kf_rel_R=eye3(K),
        kf_rel_t=zeros(K, 3),
        n_kf=zeros(dtype=torch.int32),
        R_map=eye3(),
        t_map=zeros(3),
        R_odom=eye3(),
        t_odom=zeros(3),
        submap=MapState(
            corner_xyz=zeros(m.max_submap_corner, 3),
            corner_mask=zeros(m.max_submap_corner, dtype=torch.bool),
            surf_xyz=zeros(m.max_submap_surf, 3),
            surf_mask=zeros(m.max_submap_surf, dtype=torch.bool),
        ),
        submap_center=torch.full((3,), 1e9, device=device),
        submap_n_kf=torch.tensor(-1, dtype=torch.int32, device=device),
    )


def downsample_current_scan(features: ScanFeatures, outlier_xyz, outlier_mask, cfg):
    """Corners voxel-downsampled at corner_leaf (nearest first, truncated to
    max_corner_scan); surf + outliers partitioned valid-first to
    max_surf_scan (the 0.4 m leaf applies to the assembled submap)."""
    c, s = features.corner_less_sharp, features.surf_less_flat
    return downsample_clouds(c.xyz, c.mask, s.xyz, s.mask, outlier_xyz, outlier_mask, cfg)


def downsample_clouds(corner_xyz, corner_mask, surf_xyz, surf_mask, outlier_xyz, outlier_mask, cfg):
    """`downsample_current_scan` of the less-sharp corner and less-flat surf
    clouds given as (xyz, mask) pairs."""
    m = cfg.mapping
    c_xyz, c_m = voxel_downsample_masked(
        corner_xyz, corner_mask, m.corner_leaf, cfg.pipeline.local_voxel_radius, radial_pack=True,
    )
    s_all = torch.cat([surf_xyz, outlier_xyz])
    s_mask = torch.cat([surf_mask, outlier_mask])
    order = torch.argsort((~s_mask).to(torch.uint8), stable=True)[: m.max_surf_scan]
    return (
        c_xyz[: m.max_corner_scan],
        c_m[: m.max_corner_scan],
        torch.where(s_mask[order][:, None], s_all[order], 0.0),
        s_mask[order],
    )


def _select_keyframes(state: BackendState, center, cfg: LegoLoamConfig):
    """The nearest `surrounding_keyframe_search_num` resident keyframes within
    the search radius, skipping the `submap_recency_lag` newest once the
    store holds more than 2 lag + 5."""
    m = cfg.mapping
    K = state.capacity
    dev = state.kf_t.device
    sel = min(m.surrounding_keyframe_search_num, K)
    lag = torch.where(state.n_kf > 2 * m.submap_recency_lag + 5, m.submap_recency_lag, 0)
    slots = torch.arange(K, device=dev)
    age = torch.remainder(state.n_kf - 1 - slots, K)
    active = (slots < state.n_kf) & (age >= lag)
    d = torch.linalg.norm(state.kf_t - center[None, :], dim=1)
    d = torch.where(active & (d < m.surrounding_keyframe_search_radius), d, float("inf"))
    neg, idx = torch.topk(-d, sel)
    return idx, torch.isfinite(neg)


def backend_step_ds(state: BackendState, c_xyz, c_m, s_xyz, s_m, R_odom, t_odom, time, cfg, sync_free=False):
    """One mapping iteration on a pre-downsampled scan. Returns (new_state,
    (R_map, t_map), MapDiag); the store and the submap buffers are updated
    in place.

    The submap is rebuilt after the vehicle moved `submap_rebuild_dist`, after
    `submap_rebuild_every` keyframes, or while the store holds fewer than 5.
    sync_free: that test is decided on the device (the reference's
    `lax.cond`): the submap is assembled every frame and selected."""
    m = cfg.mapping
    R_prior, t_prior = map_prior(state.R_map, state.t_map, state.R_odom, state.t_odom, R_odom, t_odom)

    moved_far = torch.linalg.norm(t_prior - state.submap_center) > m.submap_rebuild_dist
    stale = (state.n_kf - state.submap_n_kf) >= m.submap_rebuild_every
    rebuild = moved_far | stale | (state.n_kf < 5)

    def assemble():
        idx, valid = _select_keyframes(state, t_prior, cfg)
        submap = assemble_submap(
            gather_rows(state.kf_corner, idx).reshape(-1, KF_CORNER_CAP, 3),
            gather_rows(state.kf_corner_mask, idx),
            gather_rows(state.kf_surf, idx).reshape(-1, KF_SURF_CAP, 3),
            gather_rows(state.kf_surf_mask, idx),
            gather_rows(state.kf_R, idx),
            gather_rows(state.kf_t, idx),
            valid,
            t_prior,
            cfg,
        )
        return submap, t_prior, state.n_kf

    new = cond(rebuild if sync_free else bool(rebuild), assemble,
               lambda: (state.submap, state.submap_center, state.submap_n_kf))
    for dst, src in zip(named_leaves(state.submap), named_leaves(new[0])):
        assign(dst[1], src[1])
    assign(state.submap_center, new[1])
    assign(state.submap_n_kf, new[2])

    R_new, t_new, diag = scan_to_map(c_xyz, c_m, s_xyz, s_m, R_prior, t_prior, state.submap, cfg, sync_free)
    R_new = se3.orthonormalize(R_new)

    # Keyframe gate; ring slot n_kf % K.
    K = state.capacity
    n = state.n_kf.long().reshape(1)
    last = torch.where(n > 0, torch.remainder(n - 1, K), 0)
    kf_R_last = gather_rows(state.kf_R, last)[0]
    kf_t_last = gather_rows(state.kf_t, last)[0]
    moved = torch.linalg.norm(kf_t_last - t_new) > m.keyframe_gate_distance
    is_kf = ((n == 0) | moved | bool(m.keyframe_gate_always))[0]
    slot = torch.remainder(n, K)
    rel_R, rel_t = se3.relative(kf_R_last, kf_t_last, R_new, t_new)
    first = n[0] == 0
    rel_R = torch.where(first, torch.eye(3, device=R_new.device), rel_R)
    rel_t = torch.where(first, torch.zeros_like(rel_t), rel_t)

    # Masked single-row writes by the slot's owner: the row is rewritten
    # with itself when the gate is closed, so no host decision is needed.
    for leaf, new in (
        (state.kf_rel_R, rel_R), (state.kf_rel_t, rel_t), (state.kf_R, R_new), (state.kf_t, t_new),
        (state.kf_time, torch.as_tensor(time, dtype=torch.float32, device=t_new.device)),
        (state.kf_corner, c_xyz[:KF_CORNER_CAP].reshape(-1)), (state.kf_corner_mask, c_m[:KF_CORNER_CAP]),
        (state.kf_surf, s_xyz[:KF_SURF_CAP].reshape(-1)), (state.kf_surf_mask, s_m[:KF_SURF_CAP]),
    ):
        write_row(leaf, slot, new, is_kf)
    state = state.replace(
        n_kf=state.n_kf + is_kf.to(state.n_kf.dtype),
        R_map=R_new, t_map=t_new, R_odom=R_odom, t_odom=t_odom,
    )
    return state, (R_new, t_new), diag
