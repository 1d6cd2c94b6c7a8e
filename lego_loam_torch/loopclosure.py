"""Loop-closure candidates and their geometric verification (port of
`lego_loam_tpu/loopclosure.py`).

`compute_loopinfo` picks the nearest keyframe old enough to close a loop
with; `attempt_loop_closure` verifies it: a coarse (yaw, dx, dy) search by
2-D occupancy correlation of the corner clouds, then point-to-point ICP of
the surf clouds against the candidate's history window. Each ICP iteration
finds nearest neighbours through kernel K2 (`top5_l2`, call site
"loop_icp"; exact, where the TPU path merges with `approx_min_k`).

The reference's `while_loop` runs its fixed budget here with the state
frozen once converged, and its `cond(pass1, icp, skip)` always runs the
ICP and selects, so no flag is read back to the host. Kabsch's 3x3 SVD
and determinant are library calls, as in the reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .config import LegoLoamConfig
from .distributed import all_rows, gather_rows
from .math import se3
from .ops.knn import top5_l2


def _at(x, i):
    """x[i] for a 0-d index tensor without a host read (indexing with a
    0-d tensor converts it to a Python int, which waits for the device)."""
    return x.index_select(0, i.reshape(1))[0]


def _scalar(v, device):
    """An int64 0-d tensor on `device` (made there: no host-to-device copy)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int64)
    return torch.full((), int(v), dtype=torch.int64, device=device)


class ICPResult(NamedTuple):
    R: torch.Tensor  # (3,3) source -> target alignment
    t: torch.Tensor  # (3,)
    fitness: torch.Tensor  # mean squared correspondence distance
    converged: torch.Tensor
    iterations: torch.Tensor
    # Fraction of valid source points with a correspondence inside max_corr
    # at the final iterate (partial-overlap false positives score a good
    # fitness on few points).
    inlier_frac: torch.Tensor


def kabsch_rotation(H):
    """The proper rotation R maximizing tr(R H) for a 3x3 cross-covariance
    H = sum_k p_k q_k^T (R p ~ q): Kabsch's SVD with the determinant
    correction, as the reference computes it. The SVD runs in float64:
    torch's float32 SVD of a near-planar cloud's H (mostly ground) loses
    digits that the reference's keeps, and over an attempt's 20 ICP
    iterations that moved the fitness by 1.7%."""
    U, _, Vh = torch.linalg.svd(H.double())
    d = torch.sign(torch.linalg.det(Vh.T @ U.T))
    one = torch.ones_like(d)
    return (Vh.T @ torch.diag(torch.stack([one, one, d])) @ U.T).to(H.dtype)


def icp_point2point(
    src, src_mask, tgt, tgt_mask, cfg: LegoLoamConfig, R0=None, t0=None,
    max_iters: int | None = None, max_corr: float | None = None,
) -> ICPResult:
    """Point-to-point ICP of src (S,3) onto tgt (T,3) from (R0, t0):
    nearest neighbours, Kabsch on the pairs within max_corr, until a step
    below 0.1 mm or max_iters. Runs max_iters iterations on the device with
    the state frozen from the converged one on (the reference's early exit
    gives the same values)."""
    m = cfg.mapping
    max_iters = max_iters or m.icp_max_iterations
    max_d2 = (max_corr or m.icp_max_corr_dist) ** 2
    dev = src.device
    R = torch.eye(3, device=dev) if R0 is None else R0
    t = torch.zeros(3, device=dev) if t0 is None else t0
    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    fit = torch.full((), math.inf, device=dev)
    frac = torch.zeros((), device=dev)
    n_src = torch.clamp(src_mask.sum(), min=1).to(torch.float32)
    for _ in range(max_iters):
        p = src @ R.T + t
        idx, d2 = top5_l2(p, tgt, tgt_mask, site="loop_icp")
        d2 = d2[:, 0]
        q = tgt[idx[:, 0].long()]  # index -1 (no target) reads the last row; its weight is 0
        w = (src_mask & (d2 < max_d2)).to(torch.float32)
        wsum = torch.clamp(w.sum(), min=1.0)

        mu_p = (p * w[:, None]).sum(0) / wsum
        mu_q = (q * w[:, None]).sum(0) / wsum
        dR = kabsch_rotation(((p - mu_p) * w[:, None]).T @ (q - mu_q))
        dt = mu_q - dR @ mu_p

        step = torch.linalg.norm(dt) + torch.linalg.norm(se3.log_so3(dR))
        # a 0.1 mm step is converged for 0.2 m-leaf clouds
        live = ~done
        R = torch.where(live, dR @ R, R)
        t = torch.where(live, dR @ t + dt, t)
        fit = torch.where(live, (d2 * w).sum() / wsum, fit)
        frac = torch.where(live, w.sum() / n_src, frac)
        it = it + live.to(torch.int32)
        done = done | (step < 1e-4)
    return ICPResult(
        R=R, t=t, fitness=fit, converged=fit < m.history_keyframe_fitness_score,
        iterations=it, inlier_frac=frac,
    )


def _occupancy(xy, mask, extent, cell, N):
    """(N, N) 0/1 grid of the masked points' cells over [-extent, extent)^2."""
    ij = torch.floor((xy + extent) / cell).to(torch.int64)
    ok = mask & ((ij >= 0) & (ij < N)).all(-1)
    flat = torch.where(ok, ij[:, 1] * N + ij[:, 0], N * N)
    g = torch.zeros(N * N + 1, dtype=torch.float32, device=xy.device)
    g.scatter_reduce_(0, flat, ok.to(torch.float32), "amax")
    return g[: N * N].reshape(N, N)


def _rotate_xy(xyz, yaw):
    c, s = torch.cos(yaw), torch.sin(yaw)
    xr = c * xyz[..., 0] - s * xyz[..., 1]
    yr = s * xyz[..., 0] + c * xyz[..., 1]
    return torch.stack([xr, yr], dim=-1)


def coarse_align_2d(
    src_xyz, src_mask, tgt_xyz, tgt_mask, n_yaw: int = 21,
    yaw_step: float = 1.5 * math.pi / 180.0, extent: float = 24.0,
    cell: float = 0.5, search: float = 12.0,
):
    """Coarse (yaw, dx, dy) alignment by 2-D occupancy correlation.

    Both structure clouds are centred on their keyframes and rasterized
    into occupancy grids (the target's dilated 3x3); the correlation over
    +-search metres of shift and n_yaw yaw hypotheses is one matmul of the
    target's shifted windows (im2col) with the rotated source grids.
    Scores are small integers: the first maximum wins, as `jnp.argmax`'s.

    Returns (dx, dy, yaw, score, n_src): apply Rz(yaw) about the src centre
    then translate by (dx, dy) to best overlay src onto tgt; n_src counts
    the occupied cells of the source at that yaw."""
    N = int(round(2 * extent / cell))
    S = int(round(search / cell))
    dev = src_xyz.device
    tgt_g = _occupancy(tgt_xyz[:, :2], tgt_mask, extent, cell, N)
    # 3x3 dilation (max_pool2d pads with -inf): tolerates half-cell
    # rasterization misalignment.
    tgt_g = F.max_pool2d(tgt_g[None, None], 3, 1, 1)[0, 0]

    yaws = (torch.arange(n_yaw, dtype=torch.float32, device=dev) - (n_yaw - 1) / 2.0) * yaw_step
    src_gs = torch.stack([_occupancy(_rotate_xy(src_xyz, y), src_mask, extent, cell, N) for y in yaws])

    # scores[yaw, d] = vec(tgt window at shift d) . vec(src grid at yaw),
    # the windows of the zero-padded target as the columns of one matrix
    W = F.unfold(F.pad(tgt_g, (S, S, S, S))[None, None], N)[0]  # (N*N, (2S+1)^2)
    scores = src_gs.reshape(n_yaw, N * N) @ W
    flat_idx = torch.argmax(scores.reshape(-1))
    iy = flat_idx // ((2 * S + 1) ** 2)
    rem = flat_idx % ((2 * S + 1) ** 2)
    # window (r, c) shifts src by (r - S, c - S) cells in (row=y, col=x)
    dy = (rem // (2 * S + 1) - S).to(torch.float32) * cell
    dx = (rem % (2 * S + 1) - S).to(torch.float32) * cell
    # Normalizer: occupied src cells (a whole vertical edge is ONE cell,
    # so raw scores are small; the gate is on the matched fraction).
    yaw = _at(yaws, iy)
    n_src = _occupancy(_rotate_xy(src_xyz, yaw), src_mask, extent, cell, N).sum()
    return dx, dy, yaw, _at(scores.reshape(-1), flat_idx), n_src


def compute_loopinfo(kf_t, kf_time, n_kf, t_query, cfg: LegoLoamConfig):
    """Loop-candidate detection over the keyframe ring store: the nearest
    keyframe to t_query among those more than `loop_time_gap` older than
    the newest, by one masked argmin. Returns a packed (4,) float32
    [cand_slot, cand_dist (inf if none), n_kf, cur_slot] (slots exact in
    float32 below 2^24). Store leaves in row blocks are gathered whole."""
    kf_t, kf_time = all_rows(kf_t), all_rows(kf_time)
    K = kf_t.shape[0]
    dev = kf_t.device
    n_kf = _scalar(n_kf, dev)
    active = torch.arange(K, device=dev) < n_kf
    cur_slot = torch.where(n_kf > 0, (n_kf - 1) % K, 0)
    t_now = _at(kf_time, cur_slot)
    eligible = active & ((t_now - kf_time) > cfg.mapping.loop_time_gap)
    d = torch.linalg.norm(kf_t - t_query[None, :], dim=1)
    d = torch.where(eligible, d, math.inf)
    cand_slot = torch.argmin(d)
    return torch.stack([cand_slot.float(), _at(d, cand_slot), n_kf.float(), cur_slot.float()])


def attempt_loop_closure(
    kf_R, kf_t, kf_corner, kf_corner_mask, kf_surf, kf_surf_mask,
    cand_slot, cur_slot, n_kf, cfg: LegoLoamConfig,
):
    """One loop-closure attempt: coarse 2-D align -> gates -> surf ICP ->
    gates -> relative between-factor, all on the device.

    kf_corner/kf_surf are the sensor-frame clouds, (K, Nc, 3)/(K, Ns, 3)
    or the store's flat rows; cand_slot, cur_slot and n_kf are () int
    tensors (n_kf as at detection). Only the window's, the current and the
    candidate keyframe's rows are read, in one gather per leaf
    (`distributed.gather_rows`: a store in row blocks sends them to every
    rank, and the alignment runs on each).
    Returns (flags, R_rel, t_rel): flags is a packed (8,) float32
    [accepted, i_abs, j_abs, fitness, coarse_score, coarse_frac, icp_iters,
    inlier_frac]; ids are ABSOLUTE keyframe ids (they survive ring motion)."""
    m = cfg.mapping
    K = kf_t.shape[0]
    dev = kf_t.device
    cand_slot, cur_slot, n_kf = (_scalar(v, dev) for v in (cand_slot, cur_slot, n_kf))
    A_live = torch.clamp(n_kf, max=K)
    start = torch.where(n_kf > K, n_kf % K, 0)
    li_cand = (cand_slot - start) % K
    li_cur = (cur_slot - start) % K
    h = m.history_keyframe_search_num // 2
    win = torch.minimum(
        torch.clamp(li_cand - h + torch.arange(2 * h + 1, device=dev), min=0),
        torch.clamp(A_live - 1, min=0),
    )
    idx = (start + win) % K
    n_win = idx.shape[0]
    rows = torch.cat([idx, cur_slot.reshape(1), cand_slot.reshape(1)])

    def take(leaf, cloud=False):
        """The leaf's rows: (window, current, candidate)."""
        r = gather_rows(leaf, rows)
        r = r.reshape(r.shape[0], -1, 3) if cloud else r
        return r[:n_win], r[n_win], r[n_win + 1]

    win_R, cur_R, cand_R = take(kf_R)
    win_t, c_cur, c_cand = take(kf_t)
    win_corner, cur_corner, _ = take(kf_corner, cloud=True)
    win_corner_mask, cur_corner_mask, _ = take(kf_corner_mask)
    win_surf, cur_surf, _ = take(kf_surf, cloud=True)
    win_surf_mask, cur_surf_mask, _ = take(kf_surf_mask)

    # Stage 1: global (yaw, dx, dy) from occupancy correlation of the corner
    # (structure) clouds, both centred on their keyframes.
    tgt_c = torch.einsum("kij,knj->kni", win_R, win_corner) + (win_t - c_cand[None])[:, None, :]
    src_c = torch.einsum("ij,nj->ni", cur_R, cur_corner)
    dx, dy, yaw, score, n_src = coarse_align_2d(
        src_c, cur_corner_mask, tgt_c.reshape(-1, 3), win_corner_mask.reshape(-1),
        n_yaw=m.loop_coarse_n_yaw, yaw_step=m.loop_coarse_yaw_step_deg * math.pi / 180.0,
        extent=m.loop_coarse_extent, cell=m.loop_coarse_cell, search=m.loop_coarse_search,
    )
    frac = score / torch.clamp(n_src, min=1.0)
    pass1 = (score >= m.loop_coarse_min_score) & (frac >= m.loop_coarse_min_frac)

    # Stage 2: surf ICP from the coarse init with a tight gate; it always
    # runs, and its result is kept only where stage 1 passed.
    st = max(m.loop_icp_src_stride, 1)
    src_s = torch.einsum("ij,nj->ni", cur_R, cur_surf[::st]) + c_cur[None, :]
    src_s_mask = cur_surf_mask[::st]
    tgt_s = (torch.einsum("kij,knj->kni", win_R, win_surf) + win_t[:, None, :]).reshape(-1, 3)
    tgt_s_mask = win_surf_mask.reshape(-1)
    # dz from the ground-dominated surf mean-z gap (yaw about z keeps z)
    ns = torch.clamp(src_s_mask.sum(), min=1)
    nt = torch.clamp(tgt_s_mask.sum(), min=1)
    dz = (
        torch.where(tgt_s_mask, tgt_s[:, 2], 0.0).sum() / nt
        - torch.where(src_s_mask, src_s[:, 2], 0.0).sum() / ns
    )
    z, o = torch.zeros((), device=dev), torch.ones((), device=dev)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    R0 = torch.stack([torch.stack([cy, -sy, z]), torch.stack([sy, cy, z]), torch.stack([z, z, o])])
    t0 = c_cand + torch.stack([dx, dy, dz]) - R0 @ c_cur
    icp = icp_point2point(
        src_s, src_s_mask, tgt_s, tgt_s_mask, cfg, R0, t0,
        max_iters=m.loop_icp_max_iterations, max_corr=m.loop_icp_corr_dist,
    )
    eye = torch.eye(3, device=dev)
    res_R = torch.where(pass1, icp.R, eye)
    res_t = torch.where(pass1, icp.t, 0.0)
    fitness = torch.where(pass1, icp.fitness, math.inf)
    iters = torch.where(pass1, icp.iterations, 0)
    inlier = torch.where(pass1, icp.inlier_frac, 0.0)

    gate = min(m.history_keyframe_fitness_score, m.loop_fitness_leaf_scale * cfg.features.less_flat_leaf ** 2)
    accepted = pass1 & (fitness <= gate) & (inlier >= m.loop_min_inlier_frac)

    Rc = res_R @ cur_R
    tc = res_R @ c_cur + res_t
    R_rel = torch.where(accepted, cand_R.T @ Rc, eye)
    t_rel = torch.where(accepted, cand_R.T @ (tc - c_cand), 0.0)

    base = n_kf - A_live
    flags = torch.stack([
        accepted.float(), (base + li_cand).float(), (base + li_cur).float(), fitness,
        score, frac, iters.float(), inlier,
    ])
    return flags, R_rel, t_rel
