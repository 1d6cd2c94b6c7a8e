"""Scan-to-map refinement: submap assembly + 6-DoF Gauss-Newton (port of
`lego_loam_tpu/mapping.py`).

The submap is the selected keyframes' clouds transformed by their poses and
voxel-downsampled. Corner residuals use a 5-NN covariance line fit, surf
residuals a 5-NN PCA plane with the 0.2 m validity gate; the 5-NN search is
kernel K2 with groups=1 (exact, where the TPU path used groups=16). The
solver is on-manifold 6-DoF GN with eigenvalue degeneracy projection, a
per-iteration trust region and a whole-solve rejection gate.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .config import LegoLoamConfig
from .control import tree_where
from .math import se3
from .math.jacobi import jacobi_eigh
from .math.linalg3 import eigh3x3, eigvals3x3_components, eigvec_extreme_components
from .ops.knn import top5_l2
from .ops.voxel import voxel_downsample_masked
from .types import MapState


class MapDiag(NamedTuple):
    iterations: torch.Tensor
    min_lambda: torch.Tensor
    cf_mean: torch.Tensor
    degenerate: torch.Tensor
    n_corner: torch.Tensor
    n_surf: torch.Tensor
    rejected: torch.Tensor
    n_submap_corner: torch.Tensor
    n_submap_surf: torch.Tensor
    n_sel: torch.Tensor


def _nn5(q, target, t_mask, site):
    """(Q, 5, 3): the 5 nearest unmasked targets of each query, nearest
    first; an empty slot takes the target's row 0."""
    idx, _ = top5_l2(q, target, t_mask, groups=1, site=site)
    return target[idx.clamp(min=0).long()]


def assemble_submap(
    kf_corner, kf_corner_mask, kf_surf, kf_surf_mask, kf_R, kf_t, kf_valid, origin,
    cfg: LegoLoamConfig,
) -> MapState:
    """Transform + concat + voxel-downsample the selected keyframes
    ((K, N, 3) clouds, (K, N) masks, (K,3,3)/(K,3) poses, (K,) selection).
    Output is nearest-first (radial_pack), truncated to the submap caps."""
    m = cfg.mapping
    cw = torch.einsum("kij,knj->kni", kf_R, kf_corner) + kf_t[:, None, :]
    sw = torch.einsum("kij,knj->kni", kf_R, kf_surf) + kf_t[:, None, :]
    cmask = kf_corner_mask & kf_valid[:, None]
    smask = kf_surf_mask & kf_valid[:, None]
    r = cfg.pipeline.local_voxel_radius
    c_xyz, c_m = voxel_downsample_masked(
        cw.reshape(-1, 3), cmask.reshape(-1), m.corner_leaf, r, origin, radial_pack=True
    )
    s_xyz, s_m = voxel_downsample_masked(
        sw.reshape(-1, 3), smask.reshape(-1), m.submap_surf_leaf, r, origin, radial_pack=True
    )
    return MapState(
        corner_xyz=c_xyz[: m.max_submap_corner],
        corner_mask=c_m[: m.max_submap_corner],
        surf_xyz=s_xyz[: m.max_submap_surf],
        surf_mask=s_m[: m.max_submap_surf],
    )


def _neighbours(q, q_mask, nbr, cfg):
    """(Q, 5) component planes of the (Q, 5, 3) neighbours and the 5th-NN
    gate evaluated from the current query position."""
    nx, ny, nz = nbr[..., 0], nbr[..., 1], nbr[..., 2]
    d2_now = (nx - q[:, :1]) ** 2 + (ny - q[:, 1:2]) ** 2 + (nz - q[:, 2:]) ** 2
    ok = q_mask & (d2_now.amax(dim=1) < cfg.mapping.nn_valid_dist)
    c = nbr.mean(dim=1)
    return nx, ny, nz, nx - c[:, :1], ny - c[:, 1:2], nz - c[:, 2:], c, ok


def _corner_fit(q, q_mask, nbr, cfg: LegoLoamConfig):
    """Pose-independent corner fit at refresh time: 5-NN covariance line
    (centre, largest eigenvector) with the line-ratio gate.
    Returns (cx, cy, cz, vx, vy, vz, ok)."""
    _, _, _, dx, dy, dz, c, ok = _neighbours(q, q_mask, nbr, cfg)
    comps = (
        (dx * dx).mean(1), (dx * dy).mean(1), (dx * dz).mean(1),
        (dy * dy).mean(1), (dy * dz).mean(1), (dz * dz).mean(1),
    )
    lo, mid, hi = eigvals3x3_components(*comps)
    vx, vy, vz = eigvec_extreme_components(comps, lo, mid)
    return c[:, 0], c[:, 1], c[:, 2], vx, vy, vz, ok & (hi > cfg.mapping.line_ratio * mid)


def _corner_residuals(q, fit):
    """Point-to-line residual |p x v| vs the cached line, p = q - c."""
    cx, cy, cz, vx, vy, vz, ok = fit
    px, py, pz = q[:, 0] - cx, q[:, 1] - cy, q[:, 2] - cz
    crx = py * vz - pz * vy
    cry = pz * vx - px * vz
    crz = px * vy - py * vx
    dist = torch.sqrt(crx * crx + cry * cry + crz * crz)
    inv = 1.0 / torch.clamp(dist, min=1e-12)
    ux, uy, uz = crx * inv, cry * inv, crz * inv
    g = (vy * uz - vz * uy, vz * ux - vx * uz, vx * uy - vy * ux)
    s = 1.0 - 0.9 * dist.abs()
    return g, dist, torch.where(ok & (s > 0.1), s, 0.0)


def _surf_fit(q, q_mask, nbr, cfg: LegoLoamConfig):
    """Pose-independent surf fit at refresh time: 5-NN PCA plane plus the
    planarity gate. Returns (gx, gy, gz, d_off, ok)."""
    nx, ny, nz, dx, dy, dz, c, ok = _neighbours(q, q_mask, nbr, cfg)
    comps = (
        (dx * dx).sum(1), (dx * dy).sum(1), (dx * dz).sum(1),
        (dy * dy).sum(1), (dy * dz).sum(1), (dz * dz).sum(1),
    )
    lo, mid, hi = eigvals3x3_components(*comps)
    gx, gy, gz = eigvec_extreme_components(comps, mid, hi)
    d_off = -(gx * c[:, 0] + gy * c[:, 1] + gz * c[:, 2])
    fit = (gx[:, None] * nx + gy[:, None] * ny + gz[:, None] * nz + d_off[:, None]).abs()
    return gx, gy, gz, d_off, ok & (fit < cfg.mapping.plane_valid_dist).all(dim=1)


def plane_fit_pca(nbr):
    """Total-least-squares plane through (..., K, 3) neighbours: the unit
    normal n and offset d with n.p + d = 0, from the eigenvector of the
    covariance's smallest eigenvalue. Finite for degenerate neighbour sets,
    and defined for planes through the origin (the reference's `A x = -1`
    fit, mapOptmization.cpp:1390-1402, is not). Computed in float64 and
    returned in nbr's dtype: near-collinear neighbours leave the normal
    ill-conditioned, and a float32 covariance summed in another order (the
    card's against the CPU's) turns it by enough to move a GN step by
    ~1e-4 m."""
    x = nbr.to(torch.float64)
    c = x.mean(dim=-2)
    d = x - c[..., None, :]
    _, evecs = eigh3x3(torch.einsum("...ki,...kj->...ij", d, d))
    n = evecs[..., :, 0]
    return n.to(nbr.dtype), (-(n * c).sum(dim=-1)).to(nbr.dtype)


def _surf_residuals(q, fit, rn):
    """Point-to-plane residual vs the cached plane; the robust weight scales
    with the sensor-frame range rn."""
    gx, gy, gz, d_off, ok = fit
    pd = gx * q[:, 0] + gy * q[:, 1] + gz * q[:, 2] + d_off
    s = 1.0 - 0.9 * pd.abs() / torch.sqrt(torch.clamp(rn, min=1e-9))
    return (gx, gy, gz), pd, torch.where(ok & (s > 0.1), s, 0.0)


def _gn_normal_equations(q, g, d, w):
    """H (6,6) and g (6,) from residuals with Jacobian rows [q x n, n]."""
    gx, gy, gz = g
    qx, qy, qz = q[:, 0], q[:, 1], q[:, 2]
    J = torch.stack(
        [qy * gz - qz * gy, qz * gx - qx * gz, qx * gy - qy * gx, gx, gy, gz], dim=1
    ) * w[:, None]
    return J.T @ J, J.T @ (d * w)


def scan_to_map(
    corner_xyz, corner_mask, surf_xyz, surf_mask, R0, t0, submap: MapState,
    cfg: LegoLoamConfig, sync_free: bool = False,
):
    """6-DoF GN refinement from the prior (R0, t0). Returns (R, t, MapDiag).

    Stops after the first iteration when the submap is too small, after an
    iteration that converged or selected too few residuals, else after
    min(iter_count_thres, max_gn_iterations). With sync_free it makes no
    host read: every iteration runs, and a sticky device flag freezes the
    pose and every diagnostic once stopped, so the result is the early
    exit's bit for bit. The 6x6 eigenproblem is `math.jacobi` and the solve
    `solve_ex` without its error check: neither reads back on the card."""
    m = cfg.mapping
    dev = corner_xyz.device
    n_map_corner, n_map_surf = submap.corner_mask.sum(), submap.surf_mask.sum()
    enough = (n_map_corner > m.min_corner_map) & (n_map_surf > m.min_surf_map)
    if not sync_free:
        enough = bool(enough)
    surf_rn = torch.linalg.norm(surf_xyz, dim=1)
    eye6 = torch.eye(6, device=dev)

    R, t = R0, t0
    fit_c = fit_s = P_proj = None
    iterations = torch.zeros((), dtype=torch.int32, device=dev)
    min_lam = torch.zeros((), device=dev)
    cf_mean = torch.zeros((), device=dev)
    n_sel = torch.zeros((), dtype=torch.int64, device=dev)
    stopped = torch.zeros((), dtype=torch.bool, device=dev)
    for it in range(min(m.iter_count_thres, m.max_gn_iterations)):
        qc = corner_xyz @ R.T + t
        qs = surf_xyz @ R.T + t
        refresh = it % m.search_every == 0
        if refresh:
            fit_c = _corner_fit(qc, corner_mask, _nn5(qc, submap.corner_xyz, submap.corner_mask, "mapping_corner"), cfg)
            fit_s = _surf_fit(qs, surf_mask, _nn5(qs, submap.surf_xyz, submap.surf_mask, "mapping_surf"), cfg)
        nc, dc, wc = _corner_residuals(qc, fit_c)
        ns, ds_, ws = _surf_residuals(qs, fit_s, surf_rn)
        if m.corner_weight != 1.0:
            wc = wc * m.corner_weight
        Hc, gc = _gn_normal_equations(qc, nc, dc, wc)
        Hs, gs = _gn_normal_equations(qs, ns, ds_, ws)
        H, g = Hc + Hs, gc + gs
        w_all = torch.cat([wc, ws])
        r_abs = torch.cat([dc * wc, ds_ * ws]).abs()

        # Degeneracy projection, recomputed at every correspondence refresh.
        lam = min_lam
        if refresh:
            evals, evecs = jacobi_eigh(H)
            keep = (evals >= m.eigen_threshold).to(H.dtype)
            P_proj = evecs @ (evecs.T * keep[:, None])
            lam = evals[0]
        step = torch.linalg.solve_ex(H + 1e-6 * eye6, g, check_errors=False).result
        delta = -(P_proj @ step) * m.step_size

        rot_cap = m.step_clamp_rot_deg * math.pi / 180.0
        scale = torch.minimum(
            torch.clamp(rot_cap / torch.clamp(torch.linalg.norm(delta[:3]), min=1e-12), max=1.0),
            torch.clamp(m.step_clamp_trans / torch.clamp(torch.linalg.norm(delta[3:]), min=1e-12), max=1.0),
        )
        delta = delta * scale
        sel = (w_all > 0).sum()
        delta = torch.where((sel >= m.min_sel) & enough, delta, 0.0)
        if not m.enable_map_update:
            delta = torch.zeros_like(delta)
        dR, dt = se3.exp_se3(delta)
        R_new, t_new = se3.compose(dR, dt, R, t)

        rot_deg = torch.linalg.norm(delta[:3]) * 180.0 / math.pi
        trans_cm = torch.linalg.norm(delta[3:]) * 100.0
        cf = r_abs.sum() / torch.clamp(sel, min=1)
        done = ((rot_deg < m.stop_thres) & (trans_cm < m.stop_thres)) | (sel < m.min_sel)
        if sync_free:
            R, t, min_lam, cf_mean, n_sel = tree_where(
                stopped, (R, t, min_lam, cf_mean, n_sel), (R_new, t_new, lam, cf, sel))
            iterations = iterations + (~stopped).to(iterations.dtype)
            stopped = stopped | ~enough | done
        else:
            R, t, min_lam, cf_mean, n_sel = R_new, t_new, lam, cf, sel
            iterations = iterations + 1
            if not enough or bool(done):
                break

    # Whole-solve divergence gate: a correction of meters or tens of degrees
    # from the prior is divergence; keep the prior then.
    dR_corr, dt_corr = se3.relative(R0, t0, R, t)
    rejected = (torch.linalg.norm(se3.log_so3(dR_corr)) > m.reject_rot_deg * math.pi / 180.0) | (
        torch.linalg.norm(dt_corr) > m.reject_trans
    )
    R = torch.where(rejected, R0, R)
    t = torch.where(rejected, t0, t)
    diag = MapDiag(
        iterations=iterations,
        min_lambda=min_lam,
        cf_mean=cf_mean,
        degenerate=min_lam < m.eigen_threshold,
        n_corner=corner_mask.sum(),
        n_surf=surf_mask.sum(),
        rejected=rejected,
        n_submap_corner=n_map_corner.to(torch.int32),
        n_submap_surf=n_map_surf.to(torch.int32),
        n_sel=n_sel.to(torch.int32),
    )
    return R, t, diag


def map_prior(R_map_prev, t_map_prev, R_odom_prev, t_odom_prev, R_odom, t_odom):
    """Initial mapping guess: T_map_prev o (T_odom_prev^-1 o T_odom)."""
    Rd, td = se3.relative(R_odom_prev, t_odom_prev, R_odom, t_odom)
    return se3.compose(R_map_prev, t_map_prev, Rd, td)
