"""Scan-to-scan odometry: 5-NN correspondences + two-step Gauss-Newton
(port of `lego_loam_tpu/odometry.py`).

Step A solves (roll, pitch, tz) from ground flats against the previous
scan's ground surfs (5-NN PCA plane); step B solves (yaw, tx, ty) from sharp
corners against the previous less-sharp corners (5-NN covariance line).
The motion M maps current-scan-end coordinates to previous-scan-end
coordinates; a point captured at relative time s is matched after applying
exp(s log M). The search is kernel K2 (exact, groups=1), refreshed only when
the pose moved past the refresh thresholds; the line/plane fits are cached
between refreshes and the residuals re-evaluated every iteration.

Each stage runs at most `max_iterations` GN iterations. With `sync_free`
the loop makes no host read: it runs every iteration, a sticky device flag
`done` freezes the pose once converged, and the search and fit run every
iteration and are kept where the pose moved (compute and select), so the
result is the early-exit loop's bit for bit. Otherwise each iteration reads
the two flags back and exits early, as the reference's `lax.while_loop`.
"""

from __future__ import annotations

import math

import torch

from .config import LegoLoamConfig
from .control import cond
from .math import se3
from .math.jacobi import jacobi_eigh
from .math.linalg3 import eigh3x3, eigvals3x3_components, eigvec_extreme_components
from .ops.knn import top5_l2
from .types import FeatureCloud, ScanFeatures


def warp_points(M_R, M_t, xyz, s):
    """q_i = exp(s_i log M) p_i in (N,) component planes (the axis is shared
    across points, only the angle scales with s; s may be negative)."""
    xi = se3.log_se3(M_R, M_t)
    w, v = xi[:3], xi[3:]
    theta = torch.linalg.norm(w)
    safe = (theta > 1e-9).to(xyz.dtype)
    k = w / torch.clamp(theta, min=1e-12) * safe
    kx, ky, kz = k[0], k[1], k[2]
    th = s * theta
    ct, st = torch.cos(th), torch.sin(th)

    px, py, pz = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    kdotp = kx * px + ky * py + kz * pz
    cx = ky * pz - kz * py
    cy = kz * px - kx * pz
    cz = kx * py - ky * px
    one_ct = 1.0 - ct
    rx = px * ct + cx * st + kx * kdotp * one_ct
    ry = py * ct + cy * st + ky * kdotp * one_ct
    rz = pz * ct + cz * st + kz * kdotp * one_ct

    # t(s) = J_l(s w)(s v); J_l(th k) x = x + A (k x x) + B (k (k.x) - x),
    # A = (1 - cos th)/th, B = (th - sin th)/th, sign-preserving divide.
    svx, svy, svz = s * v[0], s * v[1], s * v[2]
    den = torch.where(th.abs() > 1e-12, th, torch.ones_like(th))
    A = one_ct / den * safe
    B = (th - st) / den * safe
    kxsx = ky * svz - kz * svy
    kxsy = kz * svx - kx * svz
    kxsz = kx * svy - ky * svx
    kdots = kx * svx + ky * svy + kz * svz
    tx = svx + A * kxsx + B * (kx * kdots - svx)
    ty = svy + A * kxsy + B * (ky * kdots - svy)
    tz = svz + A * kxsz + B * (kz * kdots - svz)
    return torch.stack([rx + tx, ry + ty, rz + tz], dim=-1)


def _robust_weight(dist, ok, slope):
    """Self-annealing weights 1 - (slope/scale)|d|, with the scale following
    the current mean |residual| (clipped at 1 m, floored at 1/slope)."""
    a = dist.abs()
    n = torch.clamp(ok.sum(), min=1)
    mean_r = torch.where(ok, torch.clamp(a, max=1.0), 0.0).sum() / n
    scale = torch.clamp(slope * 2.5 * mean_r, min=1.0)
    return 1.0 - (slope / scale) * a


def _nn5(q_xyz, target: FeatureCloud, site):
    """Exact 5-NN in the masked target (K2, groups=1); empty slots -> 0."""
    idx, d2 = top5_l2(q_xyz, target.xyz, target.mask, groups=1, site=site)
    return idx.clamp(min=0).long(), d2


def corner_search5(q_xyz, query: FeatureCloud, target: FeatureCloud, cfg):
    idx, d5 = _nn5(q_xyz, target, "odometry_corner")
    return idx, query.mask & (d5[:, 4] < cfg.odometry.corner_nn_max_dist ** 2)


def surf_search5(q_xyz, query: FeatureCloud, target: FeatureCloud, cfg):
    idx, d5 = _nn5(q_xyz, target, "odometry_surf")
    return idx, query.mask & (d5[:, 4] < cfg.odometry.surf_nn_max_dist ** 2)


def _centered(nbr):
    c = nbr.mean(dim=1)
    d = nbr - c[:, None, :]
    return c, d[..., 0], d[..., 1], d[..., 2]


def corner_fit5(nbr, ok):
    """Covariance line fit through (Q, 5, 3) neighbours: centre, largest
    eigenvector, eigenvalue ratio. Returns (cx,cy,cz,vx,vy,vz,ratio,ok)."""
    c, dx, dy, dz = _centered(nbr)
    comps = (
        (dx * dx).mean(1), (dx * dy).mean(1), (dx * dz).mean(1),
        (dy * dy).mean(1), (dy * dz).mean(1), (dz * dz).mean(1),
    )
    lo, mid, hi = eigvals3x3_components(*comps)
    vx, vy, vz = eigvec_extreme_components(comps, lo, mid)
    return (c[:, 0], c[:, 1], c[:, 2], vx, vy, vz, hi / torch.clamp(mid, min=1e-9), ok)


def corner_eval5(q_xyz, fit, cfg):
    """Point-to-line residual |(q - c) x v| with the collinearity gate."""
    o = cfg.odometry
    cx, cy, cz, vx, vy, vz, ratio, ok = fit
    ok = ok & (ratio > o.corner_line_ratio)
    px, py, pz = q_xyz[:, 0] - cx, q_xyz[:, 1] - cy, q_xyz[:, 2] - cz
    crx = py * vz - pz * vy
    cry = pz * vx - px * vz
    crz = px * vy - py * vx
    dist = torch.sqrt(crx * crx + cry * cry + crz * crz)
    inv = 1.0 / torch.clamp(dist, min=1e-12)
    ux, uy, uz = crx * inv, cry * inv, crz * inv
    g = (vy * uz - vz * uy, vz * ux - vx * uz, vx * uy - vy * ux)
    s = _robust_weight(dist, ok, o.weight_slope_corner)
    w = torch.where(ok & (s > o.weight_min) & (dist > 1e-9), s, 0.0)
    return g, dist, w


def surf_fit5(nbr, ok):
    """PCA plane through (Q, 5, 3) neighbours + the largest neighbour
    deviation from it. Returns (gx, gy, gz, d_off, max_dev, ok)."""
    c, dx, dy, dz = _centered(nbr)
    comps = (
        (dx * dx).sum(1), (dx * dy).sum(1), (dx * dz).sum(1),
        (dy * dy).sum(1), (dy * dz).sum(1), (dz * dz).sum(1),
    )
    lo, mid, hi = eigvals3x3_components(*comps)
    gx, gy, gz = eigvec_extreme_components(comps, mid, hi)  # smallest
    d_off = -(gx * c[:, 0] + gy * c[:, 1] + gz * c[:, 2])
    dev = (
        gx[:, None] * nbr[..., 0] + gy[:, None] * nbr[..., 1] + gz[:, None] * nbr[..., 2]
        + d_off[:, None]
    ).abs()
    return (gx, gy, gz, d_off, dev.amax(dim=1), ok)


def surf_eval5(q_xyz, fit, cfg):
    """Point-to-plane residual with the coplanarity and normal-z gates."""
    o = cfg.odometry
    gx, gy, gz, d_off, max_dev, ok = fit
    ok = ok & (max_dev < o.surf_plane_tol)
    if o.surf_normal_min_z > 0:
        ok = ok & (gz.abs() >= o.surf_normal_min_z)
    pd = gx * q_xyz[:, 0] + gy * q_xyz[:, 1] + gz * q_xyz[:, 2] + d_off
    s = _robust_weight(pd, ok, o.weight_slope_surf)
    w = torch.where(ok & (s > o.weight_min), s, 0.0)
    return (gx, gy, gz), pd, w


def _gn_step(q_xyz, n, d, w, dof_idx, cfg: LegoLoamConfig):
    """One masked-DOF Gauss-Newton step with eigenvalue degeneracy
    projection and a per-iteration trust region. Returns the 6-twist and
    its (deg, cm) norms. The Jacobian is unscaled by the sweep time, as in
    the reference. The eigenproblem runs in float64 without a read-back
    (`torch.linalg.eigh` reads its error code back on the card): a 3-DOF
    stage takes the closed form of `math/linalg3`, a 6-DOF stage
    (`full_dof_odometry`) cyclic Jacobi (`math/jacobi`). The DOFs are
    placed by a stack, not a host index."""
    o = cfg.odometry
    gx, gy, gz = n
    qx, qy, qz = q_xyz[:, 0], q_xyz[:, 1], q_xyz[:, 2]
    cols6 = (qy * gz - qz * gy, qz * gx - qx * gz, qx * gy - qy * gx, gx, gy, gz)
    J = torch.stack([cols6[i] * w for i in dof_idx], dim=1)  # (N, k), k = 3 or 6
    H = J.T @ J
    g = J.T @ (d * w)
    eigh = eigh3x3 if len(dof_idx) == 3 else jacobi_eigh
    evals, evecs = (x.to(H.dtype) for x in eigh(H.to(torch.float64)))
    keep = (evals >= o.eigen_threshold).to(H.dtype)
    ginv = torch.where(evals > 1e-12, 1.0 / torch.clamp(evals, min=1e-12), 0.0)
    step = -(evecs @ ((evecs.T @ g) * ginv * keep)) * o.step_scale
    step = torch.where((w > 0).sum() >= o.min_correspondences, step, 0.0)
    zero = torch.zeros((), dtype=H.dtype, device=H.device)
    delta = torch.stack([step[dof_idx.index(i)] if i in dof_idx else zero for i in range(6)])

    rot_cap = o.step_clamp_rot_deg * math.pi / 180.0
    rot_n = torch.linalg.norm(delta[:3])
    trans_n = torch.linalg.norm(delta[3:])
    scale = torch.minimum(
        torch.clamp(rot_cap / torch.clamp(rot_n, min=1e-12), max=1.0),
        torch.clamp(o.step_clamp_trans / torch.clamp(trans_n, min=1e-12), max=1.0),
    )
    delta = delta * scale
    return delta, torch.linalg.norm(delta[:3]) * 180.0 / math.pi, torch.linalg.norm(delta[3:]) * 100.0


def _solve_stage(M_R, M_t, query, target, search_fn, fit_fn, eval_fn, dof_mask, cfg, sync_free=False):
    """GN iterations with motion-triggered correspondence refresh, then the
    stage-level trust region around the warm start. sync_free: no host
    read (see the module docstring)."""
    o = cfg.odometry
    dof_idx = tuple(i for i, on in enumerate(dof_mask) if on)
    thr = 1.0 + 2.0 * math.cos(o.refresh_rot_deg * math.pi / 180.0)
    R, t = M_R, M_t
    R_ref, t_ref = M_R, M_t
    fit = None
    need = True  # the first iteration always searches
    done = torch.zeros((), dtype=torch.bool, device=M_t.device) if sync_free else False
    for _ in range(o.max_iterations):
        q_xyz = warp_points(R, t, query.xyz, query.rel_time)

        def refresh():
            idx, ok = search_fn(q_xyz, query, target, cfg)
            return fit_fn(target.xyz[idx], ok), R, t

        fit, R_ref, t_ref = cond(need, refresh, lambda: (fit, R_ref, t_ref))
        n, d, w = eval_fn(q_xyz, fit, cfg)
        delta, rot_deg, trans_cm = _gn_step(q_xyz, n, d, w, dof_idx, cfg)
        dR, dt = se3.exp_se3(delta)
        R_new, t_new = se3.compose(dR, dt, R, t)
        converged = (rot_deg < o.rot_converge_deg) & (trans_cm < o.trans_converge_cm)
        # trace(R_ref^T R) = 1 + 2 cos(angle between them)
        moved = (torch.trace(R_ref.T @ R_new) < thr) | (
            torch.linalg.norm(t_new - t_ref) > o.refresh_trans_m
        )
        if sync_free:
            R, t = torch.where(done, R, R_new), torch.where(done, t, t_new)
            done, need = done | converged, moved
        else:
            R, t = R_new, t_new
            converged, need = torch.stack([converged, moved]).tolist()
            if converged:
                break

    dR, dt = se3.relative(M_R, M_t, R, t)
    xi = se3.log_se3(dR, dt)
    cap_r = o.stage_cap_rot_deg * math.pi / 180.0
    s_cap = torch.minimum(
        torch.clamp(cap_r / torch.clamp(torch.linalg.norm(xi[:3]), min=1e-12), max=1.0),
        torch.clamp(o.stage_cap_trans / torch.clamp(torch.linalg.norm(xi[3:]), min=1e-12), max=1.0),
    )
    dR_c, dt_c = se3.exp_se3(xi * s_cap)
    return se3.compose(M_R, M_t, dR_c, dt_c)


SURF_DOFS = (True, True, False, False, False, True)  # roll, pitch, tz
CORNER_DOFS = (False, False, True, True, True, False)  # yaw, tx, ty
FULL_DOFS = (True,) * 6


def two_step_odometry(
    features: ScanFeatures, last_corner: FeatureCloud, last_surf: FeatureCloud,
    M_R_init, M_t_init, cfg: LegoLoamConfig, sync_free: bool = False,
):
    """Full two-step solve. Returns the refined (R, t) motion estimate."""
    o = cfg.odometry
    surf_dofs = FULL_DOFS if o.full_dof_odometry else SURF_DOFS
    corner_dofs = FULL_DOFS if o.full_dof_odometry else CORNER_DOFS
    R, t = _solve_stage(
        M_R_init, M_t_init, features.surf_flat, last_surf,
        surf_search5, surf_fit5, surf_eval5, surf_dofs, cfg, sync_free,
    )
    R, t = _solve_stage(
        R, t, features.corner_sharp, last_corner,
        corner_search5, corner_fit5, corner_eval5, corner_dofs, cfg, sync_free,
    )
    if o.accel_cap > 0:
        # Keep |t| within accel_cap of the warm start's speed, except on a
        # cold start (an exactly zero warm start).
        prev_sp = torch.linalg.norm(M_t_init)
        sp = torch.linalg.norm(t)
        tgt = torch.clamp(sp, min=prev_sp - o.accel_cap, max=prev_sp + o.accel_cap)
        tgt = torch.where(prev_sp > 1e-6, tgt, sp)
        t = t * (tgt / torch.clamp(sp, min=1e-9))
    return R, t


def to_scan_end(cloud: FeatureCloud, M_R, M_t) -> FeatureCloud:
    """Re-express feature points in the scan-end frame: exp((s - 1) log M)."""
    xyz = warp_points(M_R, M_t, cloud.xyz, cloud.rel_time - 1.0)
    return cloud.replace(
        xyz=torch.where(cloud.mask[:, None], xyz, 0.0),
        rel_time=torch.ones_like(cloud.rel_time),
    )
