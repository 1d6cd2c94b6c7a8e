"""Keyframe pose graph: batched factor Gauss-Newton (port of
`lego_loam_tpu/posegraph.py`).

Residual convention: for a factor (i, j) with measurement M_ij,
  r = log_se3( M_ij^{-1} ∘ T_i^{-1} ∘ T_j )            (6,)
with right-multiplicative pose increments T_k <- T_k exp(xi_k):
  J_j =  Jr_inv(r)                                      (approx I + ad(r)/2)
  J_i = -Jr_inv(r) Ad(T_j^{-1} T_i)
Pose 0 is gauge-fixed with a strong prior.

`solve_pose_graph` relinearizes the whole graph and solves the normal
equations with block-Jacobi PCG, its matvec computed factor-wise.
`reduced_solve`, the loop-closure path, cuts the keyframe chain into
segments of `posegraph_anchor_stride` keyframes, composes each segment's
odometry into one factor, solves the small anchor graph exactly (dense
normal equations, one LU per GN iteration) and blends the anchors'
corrections back over the segments. Every loop is a fixed count and every
solve an `_ex` variant, so nothing here reads a value back to the host.
Per-pose sums go through `segment_sum` in a fixed order, so a solve on the
card gives the same bits on every run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import LegoLoamConfig
from .math import se3

MAX_ANCHORS = 2048  # 6A x 6A normal equations and an (A^2, 6, 6) block grid


def adjoint(R, t):
    """SE(3) adjoint: (...,3,3),(...,3) -> (...,6,6) acting on [w, v]."""
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bot = torch.cat([se3.hat(t) @ R, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def ad_se3(xi):
    """se(3) adjoint (little ad): (...,6) -> (...,6,6)."""
    wx, vx = se3.hat(xi[..., :3]), se3.hat(xi[..., 3:])
    top = torch.cat([wx, torch.zeros_like(wx)], dim=-1)
    bot = torch.cat([vx, wx], dim=-1)
    return torch.cat([top, bot], dim=-2)


class Factors(NamedTuple):
    """Padded between-factor set over the keyframe chain + loops."""

    i: torch.Tensor  # (F,) int source pose index
    j: torch.Tensor  # (F,) int target pose index
    R: torch.Tensor  # (F, 3, 3) measured relative rotation (i frame)
    t: torch.Tensor  # (F, 3)
    info: torch.Tensor  # (F, 6) diagonal information [w_rot*3, w_trans*3]
    mask: torch.Tensor  # (F,) bool valid


def _stride(K: int, S: int) -> tuple[int, int]:
    """(S, A): the stride halved until it divides K, and the K // S anchors."""
    while S > 1 and K % S:
        S //= 2
    return S, K // S


def anchor_stride(cfg: LegoLoamConfig) -> tuple[int, int]:
    """(S, A): the segment stride `reduced_solve` uses over the store and
    the number of anchors. The stride halves until it divides
    `max_keyframes`; where that leaves more than MAX_ANCHORS anchors (a
    capacity of 2 x prime falls to S = 2) the dense anchor solve would need
    gigabytes, so the configuration is refused."""
    K = cfg.mapping.max_keyframes
    S, A = _stride(K, cfg.mapping.posegraph_anchor_stride)
    if A > MAX_ANCHORS:
        raise ValueError(
            f"posegraph_anchor_stride {cfg.mapping.posegraph_anchor_stride} falls to a stride of "
            f"{S} for max_keyframes={K}, which leaves {A} anchors (> {MAX_ANCHORS}): choose a "
            "max_keyframes that the stride divides"
        )
    return S, A


class Segments(NamedTuple):
    """A fixed order in which to sum rows into segments: `order` sorts the
    rows by segment (stably, so rows of one segment keep their order) and
    `lengths` counts the rows of each segment."""

    order: torch.Tensor  # (M,) int64
    lengths: torch.Tensor  # (n + masked rows,) int64
    n: int  # segments returned


def segments(index, n: int, valid=None) -> Segments:
    """The summation order of rows with segment ids `index` (M,) into n
    segments. Rows where `valid` is False take one segment each after the
    n returned ones, so no segment collects the padding (the segmented
    reduction runs each segment serially). Lengths come from an integer
    index_add_, exact in any order."""
    M = index.shape[0]
    key = index.long()
    n_seg = n
    if valid is not None:
        key = torch.where(valid, key, n + torch.arange(M, device=key.device))
        n_seg = n + M
    order = torch.argsort(key, stable=True)
    lengths = torch.zeros(n_seg, dtype=torch.int64, device=key.device).index_add_(0, key, torch.ones_like(key))
    return Segments(order, lengths, n)


def segment_sum(x, seg: Segments):
    """(M, ...) rows summed per segment -> (n, ...), each segment's rows
    added in their order.

    A float index_add_ on the GPU adds with atomics in whatever order they
    land, so the card's solves would differ from run to run; the segmented
    reduction over the sorted rows is bit-identical from run to run, and on
    the CPU bit-equal to index_add_ over the same rows (which also adds
    them in order). Masked rows carry zero terms there and are left out."""
    return torch.segment_reduce(x[seg.order], "sum", lengths=seg.lengths, axis=0, unsafe=True)[: seg.n]


def factor_segments(f: "Factors", n_poses: int) -> Segments:
    """The order of the i-side then the j-side terms of every factor into
    the poses: the i-side before the j-side, as two index_add_ calls add
    them."""
    return segments(torch.cat([f.i, f.j]), n_poses, torch.cat([f.mask, f.mask]))


def factor_residuals(poses_R, poses_t, f: Factors):
    """r = log(M^{-1} T_i^{-1} T_j) per factor: (F, 6)."""
    i, j = f.i.long(), f.j.long()
    R_ij, t_ij = se3.relative(poses_R[i], poses_t[i], poses_R[j], poses_t[j])
    Rm_inv, tm_inv = se3.inverse(f.R, f.t)
    return se3.log_se3(*se3.compose(Rm_inv, tm_inv, R_ij, t_ij))


def factor_jacobians(poses_R, poses_t, f: Factors, r):
    """(J_i, J_j): (F, 6, 6) each, first-order Jr_inv."""
    i, j = f.i.long(), f.j.long()
    Jr_inv = torch.eye(6, dtype=r.dtype, device=r.device)[None] + 0.5 * ad_se3(r)
    Ad = adjoint(*se3.relative(poses_R[j], poses_t[j], poses_R[i], poses_t[i]))
    return -(Jr_inv @ Ad), Jr_inv


def _weights(f: Factors):
    return f.info * f.mask[:, None].to(f.info.dtype)


def gradient(Ji, Jj, r, f: Factors, seg: Segments):
    """g = sum_f J_f^T Ω r_f per pose: (N, 6)."""
    wr = r * _weights(f)
    return segment_sum(torch.cat([torch.einsum("fba,fb->fa", Ji, wr), torch.einsum("fba,fb->fa", Jj, wr)]), seg)


def hessian_times(x, Ji, Jj, f: Factors, seg: Segments):
    """H x with H = sum_f J_f^T Ω J_f, factor-wise (no prior): (N, 6)."""
    i, j = f.i.long(), f.j.long()
    a = torch.einsum("fab,fb->fa", Ji, x[i]) + torch.einsum("fab,fb->fa", Jj, x[j])
    a = a * _weights(f)
    return segment_sum(torch.cat([torch.einsum("fba,fb->fa", Ji, a), torch.einsum("fba,fb->fa", Jj, a)]), seg)


def hessian_blocks(Ji, Jj, f: Factors, seg: Segments):
    """The 6x6 diagonal blocks of H (no prior): (N, 6, 6)."""
    w = _weights(f)
    return segment_sum(torch.cat([
        torch.einsum("fba,fb,fbc->fac", Ji, w, Ji), torch.einsum("fba,fb,fbc->fac", Jj, w, Jj),
    ]), seg)


def precond_inverse(B, prior_w):
    """The inverted block-Jacobi preconditioner from H's diagonal blocks
    (the gauge prior added on pose 0)."""
    eye6 = torch.eye(6, dtype=B.dtype, device=B.device)
    B[0] += prior_w * eye6
    return torch.linalg.inv_ex(B + 1e-6 * eye6[None]).inverse


def _trust_scale(x, max_rot, max_trans):
    rot_n = torch.linalg.norm(x[:, :3], dim=1, keepdim=True)
    trans_n = torch.linalg.norm(x[:, 3:], dim=1, keepdim=True)
    return torch.minimum(
        torch.clamp(max_rot / torch.clamp(rot_n, min=1e-12), max=1.0),
        torch.clamp(max_trans / torch.clamp(trans_n, min=1e-12), max=1.0),
    )


def _apply_update(R, t, x, keep):
    """Right-multiplicative update of the poses where `keep` holds."""
    dR, dt = se3.exp_se3(x)
    R_new = R @ dR
    t_new = torch.einsum("nij,nj->ni", R, dt) + t
    return torch.where(keep[:, None, None], R_new, R), torch.where(keep[:, None], t_new, t)


def solve_pose_graph(
    poses_R, poses_t, factors: Factors, n_poses_mask, cfg: LegoLoamConfig,
    gn_iters: int = 4, prior_w: float = 1e6,
):
    """Batch GN with PCG inner solves (`cg_iterations` each). Returns the
    corrected (poses_R, poses_t)."""
    N = poses_R.shape[0]
    active = n_poses_mask[:, None].to(poses_t.dtype)
    seg = factor_segments(factors, N)
    R, t = poses_R, poses_t
    for _ in range(gn_iters):
        r = factor_residuals(R, t, factors)
        Ji, Jj = factor_jacobians(R, t, factors, r)
        b = -gradient(Ji, Jj, r, factors, seg) * active
        Minv = precond_inverse(hessian_blocks(Ji, Jj, factors, seg), prior_w)

        def mv(v):
            y = hessian_times(v, Ji, Jj, factors, seg)
            y[0] += prior_w * v[0]  # gauge prior on pose 0
            return y * active

        def apply_M(v):
            return torch.einsum("nab,nb->na", Minv, v) * active

        x = torch.zeros_like(b)
        res = b - mv(x)
        p = apply_M(res)
        rz = torch.sum(res * p)
        for _ in range(cfg.distributed.cg_iterations):
            Ap = mv(p)
            denom = torch.sum(p * Ap)
            alpha = torch.where(torch.abs(denom) > 1e-12, rz / denom, 0.0)
            x = x + alpha * p
            res = res - alpha * Ap
            z = apply_M(res)
            rz_new = torch.sum(res * z)
            beta = torch.where(torch.abs(rz) > 1e-12, rz_new / rz, 0.0)
            p = z + beta * p
            rz = rz_new
        # Per-pose trust region: a partially converged PCG direction can
        # carry huge components; a real correction spreads over many poses.
        x = x * _trust_scale(x, 0.3, 2.0)
        R, t = _apply_update(R, t, x, n_poses_mask)
    return R, t


def graph_cost(poses_R, poses_t, factors: Factors):
    """Total weighted squared residual of the factor set (masked)."""
    r = factor_residuals(poses_R, poses_t, factors)
    return torch.sum(r * r * _weights(factors))


def solve_dense_gn(
    poses_R, poses_t, factors: Factors, active_mask, gn_iters: int = 3,
    prior_w: float = 1e6, trust_rot: float = 0.3, trust_trans: float = 5.0,
    damping: float = 1e-4,
):
    """Exact GN on a SMALL graph: dense 6Nx6N normal equations + LU.

    Inactive poses are pinned with `prior_w` (their gradient is zero, so
    their update is exactly zero); pose 0 carries the gauge prior."""
    N = poses_R.shape[0]
    dev, dt = poses_t.device, poses_t.dtype
    # pose 0's gauge prior selected on the device: a scalar written at an
    # index is a host-to-device copy, which waits for the queue
    diag_w = torch.where(active_mask & (torch.arange(N, device=dev) > 0), damping, prior_w).to(dt)
    diag = torch.diag_embed(diag_w.repeat_interleave(6))
    i, j = factors.i.long(), factors.j.long()
    seg = factor_segments(factors, N)
    # H block-wise: four 6x6 blocks per factor summed into a flat (N*N, 6, 6)
    # block grid (ii, ij, ji, jj, each over all factors), then laid out dense.
    m = factors.mask
    hseg = segments(torch.cat([i * N + i, i * N + j, j * N + i, j * N + j]), N * N, torch.cat([m, m, m, m]))
    R, t = poses_R, poses_t
    for _ in range(gn_iters):
        r = factor_residuals(R, t, factors)
        Ji, Jj = factor_jacobians(R, t, factors, r)
        w = _weights(factors)
        g = gradient(Ji, Jj, r, factors, seg)
        H = segment_sum(torch.cat([
            torch.einsum("fba,fb,fbc->fac", Ja, w, Jb) for Ja in (Ji, Jj) for Jb in (Ji, Jj)
        ]), hseg)
        H = H.reshape(N, N, 6, 6).permute(0, 2, 1, 3).reshape(6 * N, 6 * N) + diag
        x = -torch.linalg.solve_ex(H, g.reshape(-1, 1)).result.reshape(N, 6)
        # Per-pose trust region: a mis-verified loop factor must not launch
        # the graph.
        x = x * _trust_scale(x, trust_rot, trust_trans)
        R, t = _apply_update(R, t, x, active_mask)
    return R, t


def reduced_solve(kf_R, kf_t, kf_rel_R, kf_rel_t, n_kf, loop: Factors, cfg: LegoLoamConfig):
    """Anchor-segment pose-graph solve over the ring store.

    kf_R/kf_t (K,3,3)/(K,3) in slot order; kf_rel_R/kf_rel_t the odometry
    step into each slot's keyframe from its predecessor; n_kf () int the
    keyframes ever appended; loop factors with ABSOLUTE keyframe ids.
    Returns (kf_R_new, kf_t_new, (ok, cost_before, cost_after,
    max_anchor_move)); where the reduced graph's cost does not fall (or is
    not finite) the input poses come back unchanged."""
    m = cfg.mapping
    K = kf_R.shape[0]
    S, A = _stride(K, m.posegraph_anchor_stride)
    dev, f32 = kf_t.device, kf_t.dtype
    eye = torch.eye(3, dtype=f32, device=dev)
    ar = torch.arange(K, device=dev)
    n_kf = torch.as_tensor(n_kf).to(device=dev, dtype=torch.int64)

    A_live = torch.clamp(n_kf, max=K)
    start = torch.where(n_kf > K, n_kf % K, 0)
    logical = (start + ar) % K  # logical position l -> slot
    valid_l = ar < A_live
    Rl, tl = kf_R[logical], kf_t[logical]
    relR = torch.where(valid_l[:, None, None], kf_rel_R[logical], eye)
    relt = torch.where(valid_l[:, None], kf_rel_t[logical], 0.0)

    # Segment products: factor s measures anchor s -> s+1 through the rels
    # at logical (sS, (s+1)S], i.e. rel_shift[l] = rel_{l+1}.
    segR = torch.cat([relR[1:], eye[None]]).reshape(A, S, 3, 3)
    segt = torch.cat([relt[1:], relt.new_zeros(1, 3)]).reshape(A, S, 3)
    M_R, M_t = eye.expand(A, 3, 3), relt.new_zeros(A, 3)
    for s in range(S):
        M_R, M_t = se3.compose(M_R, M_t, segR[:, s], segt[:, s])

    anchor_l = torch.arange(A, device=dev) * S
    Ra, ta = Rl[anchor_l], tl[anchor_l]
    n_anchors = torch.clamp((A_live + S - 1) // S, min=1)
    active_a = torch.arange(A, device=dev) < n_anchors

    ci = torch.arange(A - 1, device=dev)
    cj = ci + 1
    chain_info = torch.cat([  # made on the device: no host-to-device copy
        torch.full((A - 1, 3), 1.0 / (m.chain_rot_var * S), dtype=f32, device=dev),
        torch.full((A - 1, 3), 1.0 / (m.chain_trans_var * S), dtype=f32, device=dev),
    ], dim=1)

    # Loop factors: absolute id -> logical -> anchor; conjugate the
    # measurement by the current intra-segment offsets O = T_anchor^{-1} T_kf
    # so that T_ai^{-1} T_aj = O_i M O_j^{-1} is the anchor-level constraint.
    base = n_kf - A_live
    li, lj = loop.i.long() - base, loop.j.long() - base
    lvalid = loop.mask & (li >= 0) & (lj >= 0) & (li < A_live) & (lj < A_live)
    li_c, lj_c = torch.clamp(li, 0, K - 1), torch.clamp(lj, 0, K - 1)
    ai = torch.minimum(li_c // S, n_anchors - 1)
    aj = torch.minimum(lj_c // S, n_anchors - 1)
    lvalid = lvalid & (ai != aj)
    OiR, Oit = se3.relative(Ra[ai], ta[ai], Rl[li_c], tl[li_c])
    OjR, Ojt = se3.relative(Ra[aj], ta[aj], Rl[lj_c], tl[lj_c])
    MR_, Mt_ = se3.compose(*se3.compose(OiR, Oit, loop.R, loop.t), *se3.inverse(OjR, Ojt))

    red = Factors(
        i=torch.cat([ci, ai]),
        j=torch.cat([cj, aj]),
        R=torch.cat([M_R[: A - 1], MR_]),
        t=torch.cat([M_t[: A - 1], Mt_]),
        info=torch.cat([chain_info, loop.info]),
        mask=torch.cat([cj < n_anchors, lvalid]),
    )
    Ra2, ta2 = solve_dense_gn(
        Ra, ta, red, active_a, gn_iters=m.posegraph_gn_iters,
        trust_rot=m.posegraph_trust_rot, trust_trans=m.posegraph_trust_trans,
    )
    c0 = graph_cost(Ra, ta, red)
    c1 = graph_cost(Ra2, ta2, red)
    moved = torch.max(torch.where(active_a, torch.linalg.norm(ta2 - ta, dim=1), 0.0))
    ok = torch.isfinite(c1) & (c1 < c0)

    # Interpolated propagation: D_a = T_a' T_a^{-1} per anchor; pose l in
    # segment a gets D_l = exp(f * log(D_{a+1} D_a^{-1})) D_a with
    # f = (l - aS)/S, so the correction blends geodesically between
    # consecutive anchors instead of jumping at each segment boundary.
    DR, Dt = se3.compose(Ra2, ta2, *se3.inverse(Ra, ta))
    a_of_l = torch.minimum(ar // S, n_anchors - 1)
    a_next = torch.minimum(a_of_l + 1, n_anchors - 1)
    frac = (ar - a_of_l * S).to(f32) / float(S)
    dRn, dtn = se3.compose(DR[a_next], Dt[a_next], *se3.inverse(DR[a_of_l], Dt[a_of_l]))
    bR, bt = se3.exp_se3(se3.log_se3(dRn, dtn) * frac[:, None])
    DRl, Dtl = se3.compose(bR, bt, DR[a_of_l], Dt[a_of_l])
    Rl_new = se3.orthonormalize(DRl @ Rl)
    tl_new = torch.einsum("nij,nj->ni", DRl, tl) + Dtl

    sel = ok & valid_l
    out_R = kf_R.clone()
    out_t = kf_t.clone()
    out_R[logical] = torch.where(sel[:, None, None], Rl_new, Rl)
    out_t[logical] = torch.where(sel[:, None], tl_new, tl)
    return out_R, out_t, (ok, c0, c1, moved)
