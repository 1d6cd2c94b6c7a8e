"""Front end: range image -> ground -> segments -> features -> scan-to-scan
odometry (port of `lego_loam_tpu/frontend.py`).

`frontend_prepass` has no dependence on earlier scans; `frontend_solve` is
the sequential half that threads the OdometryState. With
`use_imu_undistortion`, the segmented cloud is undistorted to scan end from
the scan's IMU track before feature extraction, and the IMU attitude pulls
the solved world attitude toward it; `odom_prior_mode` takes a wheel-odometry
motion prior as the solve's warm start ("init") or in place of the solve
("override").
"""

from __future__ import annotations

import torch

from .config import LegoLoamConfig
from .control import cond
from .imu import ImuTrack, undistort_to
from .math import se3
from .odometry import to_scan_end, two_step_odometry
from .ops.features import extract_features, shadow_points
from .ops.ground import apply_ground
from .ops.segmentation import segment_cloud
from .types import FeatureCloud, OdometryState, ScanFeatures, SegmentedScan


def _empty_cloud(n, device):
    return FeatureCloud(
        xyz=torch.zeros((n, 3), device=device),
        ring=torch.full((n,), -1, dtype=torch.int32, device=device),
        rel_time=torch.zeros((n,), device=device),
        mask=torch.zeros((n,), dtype=torch.bool, device=device),
    )


def init_odometry_state(cfg: LegoLoamConfig, device="cuda") -> OdometryState:
    f = cfg.features
    # Odometry surf target = ground-only less-flat slice + shadow grid.
    n_surf = f.surf_ground_cap + f.shadow_rows * f.shadow_cols
    return OdometryState(
        R_prev_cur=torch.eye(3, device=device),
        t_prev_cur=torch.zeros(3, device=device),
        R_world=torch.eye(3, device=device),
        t_world=torch.zeros(3, device=device),
        last_corner=_empty_cloud(f.max_corner_less_sharp, device),
        last_surf=_empty_cloud(n_surf, device),
        initialized=torch.tensor(False, device=device),
    )


def _with_shadow(surf: FeatureCloud, cfg: LegoLoamConfig) -> FeatureCloud:
    """Append the virtual shadow grid to a padded surf cloud."""
    dev = surf.xyz.device
    sp = shadow_points(cfg, dev)
    nsp = sp.shape[0]
    return FeatureCloud(
        xyz=torch.cat([surf.xyz, sp]),
        ring=torch.cat([
            surf.ring,
            torch.full((nsp,), cfg.laser.num_vertical_scans + 1, dtype=torch.int32, device=dev),
        ]),
        rel_time=torch.cat([surf.rel_time, torch.ones((nsp,), device=dev)]),
        mask=torch.cat([
            surf.mask,
            torch.full((nsp,), cfg.features.use_shadow_points, dtype=torch.bool, device=dev),
        ]),
    )


def _rigid(feats: ScanFeatures) -> ScanFeatures:
    """All points captured at scan end (rigid-rendered synthetic clouds)."""
    def one(c):
        return c.replace(rel_time=torch.ones_like(c.rel_time))

    return ScanFeatures(
        corner_sharp=one(feats.corner_sharp),
        corner_less_sharp=one(feats.corner_less_sharp),
        surf_flat=one(feats.surf_flat),
        surf_less_flat=one(feats.surf_less_flat),
        surf_ground=one(feats.surf_ground),
    )


def frontend_prepass(grid, cfg: LegoLoamConfig, scores=None, imu_track: ImuTrack | None = None):
    """Ground removal, segmentation and feature extraction of one projected
    scan; scores: the NEAR pass's RANSAC draw. Returns (grid, seg, feats)."""
    return segment_features(apply_ground(grid, cfg, scores), cfg, imu_track=imu_track)


def segment_features(grid, cfg: LegoLoamConfig, raw_labels=None, imu_track: ImuTrack | None = None):
    """Segmentation and feature extraction of a grounded grid. raw_labels:
    its connected components if already computed (the pipeline labels all
    scans of a chunk in one K1 launch). imu_track: the scan's IMU track;
    with `use_imu_undistortion` the segmented points are moved to the
    scan-end frame in one hop and their rel_time set to 1, so the motion
    warp does not compensate them twice (the outlier cloud keeps its times
    and is deskewed by the solved motion, as in the reference)."""
    grid, seg = segment_cloud(grid, cfg, raw_labels)
    if imu_track is not None and cfg.pipeline.use_imu_undistortion:
        xyz = undistort_to(seg.xyz, seg.rel_time, imu_track, cfg.laser.scan_period, ref_time=1.0)
        seg = seg.replace(
            xyz=torch.where(seg.valid[..., None], xyz, seg.xyz),
            rel_time=torch.where(seg.valid, torch.ones_like(seg.rel_time), seg.rel_time),
        )
    feats = extract_features(seg, cfg)
    if cfg.pipeline.rigid_scans:
        feats = _rigid(feats)
    return grid, seg, feats


def imu_attitude(track: ImuTrack):
    """(R, valid) of a track's last valid sample, the IMU attitude at scan
    end; the slot is selected on the device (no host read)."""
    last = torch.clamp(track.mask.sum() - 1, min=0).reshape(1)
    return track.R.index_select(0, last)[0], track.mask.any()


def frontend_solve(feats: ScanFeatures, state: OdometryState, cfg: LegoLoamConfig, odom_prior=None, imu_att=None,
                   sync_free: bool = False):
    """Two-step scan-to-scan GN, world-pose integration and the scan-end
    target swap. Returns (new_state, outputs).

    odom_prior: optional (M_R, M_t) wheel-odometry motion: "init" mode seeds
    the GN with it, "override" mode replaces the solved motion with it (the
    first frame's identity too). imu_att: optional ((3, 3) R, () valid), the
    IMU attitude at scan end: once initialized, M is corrected so the world
    attitude moves `imu_attitude_weight` of the way toward it (where valid).

    sync_free: the branches on `state.initialized` are decided on the device
    (both sides computed, one selected, the reference's `lax.cond`): the
    first frame solves against the empty targets and takes the identity."""
    mode = cfg.odometry.odom_prior_mode
    initialized = state.initialized if sync_free else bool(state.initialized)
    dev = state.t_world.device

    def solve():
        M_R0, M_t0 = odom_prior if odom_prior is not None and mode == "init" else (state.R_prev_cur, state.t_prev_cur)
        return two_step_odometry(feats, state.last_corner, state.last_surf, M_R0, M_t0, cfg, sync_free)

    M_R, M_t = cond(initialized, solve, lambda: (torch.eye(3, device=dev), torch.zeros(3, device=dev)))
    if odom_prior is not None and mode == "override":
        M_R, M_t = odom_prior

    w_att = cfg.odometry.imu_attitude_weight
    if imu_att is not None and w_att > 0:
        # the reference weighs the first frame's anchor by 0: exp(0) = I
        def anchored():
            R_att, att_valid = imu_att
            e = se3.log_so3((state.R_world @ M_R).T @ R_att)
            return M_R @ se3.exp_so3(w_att * att_valid.to(e.dtype) * e)

        M_R = cond(initialized, anchored, lambda: M_R)

    def averaged():
        # Deskew with the two-frame SE(3) average of the motion: the raw
        # solve's error feeds the next targets and sustains a period-2
        # oscillation that the 2-tap average cancels.
        dRp, dtp = se3.relative(state.R_prev_cur, state.t_prev_cur, M_R, M_t)
        dRh, dth = se3.interp(dRp, dtp, 0.5)
        return se3.compose(state.R_prev_cur, state.t_prev_cur, dRh, dth)

    M_R_avg, M_t_avg = cond(initialized, averaged, lambda: (M_R, M_t))

    R_world, t_world = se3.compose(state.R_world, state.t_world, M_R, M_t)
    new_corner = to_scan_end(feats.corner_less_sharp, M_R_avg, M_t_avg)
    new_surf = _with_shadow(to_scan_end(feats.surf_ground, M_R_avg, M_t_avg), cfg)
    map_surf = to_scan_end(feats.surf_less_flat, M_R_avg, M_t_avg)

    new_state = OdometryState(
        R_prev_cur=M_R,
        t_prev_cur=M_t,
        R_world=R_world,
        t_world=t_world,
        last_corner=new_corner,
        last_surf=new_surf,
        initialized=torch.ones_like(state.initialized),
    )
    outputs = {
        "features": feats,
        "M_R": M_R,
        "M_t": M_t,
        "M_R_avg": M_R_avg,
        "M_t_avg": M_t_avg,
        "R_world": R_world,
        "t_world": t_world,
        "map_corner": new_corner,
        "map_surf": map_surf,
    }
    return new_state, outputs


def deskew_outliers(seg: SegmentedScan, M_R, M_t, cfg: LegoLoamConfig):
    """De-skew the outlier cloud to scan end for mapping."""
    if cfg.pipeline.rigid_scans:
        return seg.outlier_xyz
    oc = FeatureCloud(
        xyz=seg.outlier_xyz,
        ring=torch.zeros(seg.outlier_mask.shape, dtype=torch.int32, device=seg.outlier_xyz.device),
        rel_time=seg.outlier_rel,
        mask=seg.outlier_mask,
    )
    return to_scan_end(oc, M_R, M_t).xyz
