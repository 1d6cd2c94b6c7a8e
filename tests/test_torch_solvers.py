"""Parity of the port's scan-to-scan and scan-to-map solvers with the
reference, both fed the reference's features of two consecutive scans."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu import backend as RB
from lego_loam_tpu import frontend as RFE
from lego_loam_tpu import mapping as RM
from lego_loam_tpu import odometry as RO
from lego_loam_tpu.ops import projection as RP
from lego_loam_torch import backend as PB
from lego_loam_torch import mapping as PM
from lego_loam_torch import odometry as PO
from lego_loam_torch.types import FeatureCloud, MapState, ScanFeatures

from _torch_parity import pair, port, t
from lego_loam_torch.io.synthetic import straight_trajectory, swept_scan_sequence

REF, CFG = pair()


@pytest.fixture(scope="module")
def two_scans():
    """Reference features of scans 1 and 2 of a swept straight drive, and
    the odometry state after scan 1."""
    poses = straight_trajectory(3, speed=0.15, yaw_rate=0.01)
    scans = swept_scan_sequence(poses, CFG, noise=0.005, seed=5)
    prep = jax.jit(lambda g, k: RFE.frontend_prepass(None, None, REF, k, grid=g))
    solve = jax.jit(lambda f, s: RFE.frontend_solve(f, s, REF))
    state = RFE.init_odometry_state(REF)
    feats = []
    for i in range(3):
        packed = RP.host_pack_range_image(scans[i], REF)
        grid = RP.grid_from_range_image(*[jnp.asarray(p) for p in packed], REF)
        _, seg, f = prep(grid, jax.random.fold_in(jax.random.PRNGKey(0), i))
        feats.append((seg, f))
        if i < 2:
            state, out = solve(f, state)
    return feats, state, out


def test_gn_step_and_fits(two_scans):
    feats, state, _ = two_scans
    f = feats[2][1]
    q = f.surf_flat
    M_R, M_t = state.R_prev_cur, state.t_prev_cur
    q_xyz = RO.warp_points(M_R, M_t, q.xyz, q.rel_time)
    pq = PO.warp_points(t(M_R), t(M_t), t(q.xyz), t(q.rel_time))
    np.testing.assert_allclose(np.asarray(q_xyz), pq.numpy(), atol=2e-5)

    idx, ok = RO.surf_search5(q_xyz, q, state.last_surf, REF)
    fit = RO.surf_fit5(state.last_surf.xyz[idx], ok)
    pfit = PO.surf_fit5(t(state.last_surf.xyz[idx]), t(ok))
    n, d, w = RO.surf_eval5(q_xyz, fit, False, REF)
    pn, pd, pw = PO.surf_eval5(t(q_xyz), pfit, CFG)
    # Five neighbours along one ring are nearly collinear: their plane normal
    # is ill-conditioned and float32 rounding tilts it by up to ~1 deg. Most
    # rows are well conditioned and agree to 1e-4.
    used = np.asarray(w) > 0
    assert used.sum() > 100
    close = np.abs(np.asarray(w) - pw.numpy()) < 1e-4
    assert close.mean() > 0.9, close.mean()
    np.testing.assert_array_equal(used, pw.numpy() > 0)

    # one GN step from identical residuals: float32 normal equations summed
    # in another order, 1e-6 relative on the increment
    dof = (0, 1, 5)
    delta, rd, tc = RO._gn_step(q_xyz, q.rel_time, n, d, w, dof, REF)
    pdelta, prd, ptc = PO._gn_step(t(q_xyz), tuple(t(x) for x in n), t(d), t(w), dof, CFG)
    np.testing.assert_allclose(np.asarray(delta), pdelta.numpy(), atol=1e-6, rtol=1e-4)

    c = f.corner_sharp
    cq = RO.warp_points(M_R, M_t, c.xyz, c.rel_time)
    cidx, cok = RO.corner_search5(cq, c, state.last_corner, REF)
    pidx, pok = PO.corner_search5(t(cq), port(c, FeatureCloud), port(state.last_corner, FeatureCloud), CFG)
    np.testing.assert_array_equal(np.asarray(cok), pok.numpy())
    np.testing.assert_array_equal(np.asarray(cidx)[np.asarray(cok)], pidx.numpy()[pok.numpy()])


def test_two_step_odometry(two_scans):
    """The whole two-step solve from the same features and warm start: the
    motion agrees to 1 mm / 0.01 deg (float32 GN over up to 40 iterations)."""
    feats, state, _ = two_scans
    f = feats[2][1]
    R, tt = RO.two_step_odometry(f, state.last_corner, state.last_surf, state.R_prev_cur, state.t_prev_cur, REF)
    pR, pt, trips = PO.two_step_odometry(
        port(f, ScanFeatures), port(state.last_corner, FeatureCloud), port(state.last_surf, FeatureCloud),
        t(state.R_prev_cur), t(state.t_prev_cur), CFG,
    )
    np.testing.assert_allclose(np.asarray(tt), pt.numpy(), atol=1e-3)
    np.testing.assert_allclose(np.asarray(R), pR.numpy(), atol=2e-4)
    assert trips.dtype == torch.int32 and 2 <= int(trips) <= 2 * CFG.odometry.max_iterations
    to_end = PO.to_scan_end(port(f.corner_less_sharp, FeatureCloud), pR, pt)
    ref_end = np.asarray(RO.to_scan_end(f.corner_less_sharp, R, tt).xyz)
    # the pose tolerance carried to each point: 1 mm + 2e-4 rad x range
    err = np.linalg.norm(ref_end - to_end.xyz.numpy(), axis=1)
    assert (err <= 1e-3 + 2e-4 * np.linalg.norm(ref_end, axis=1)).all(), err.max()


@pytest.mark.parametrize("iters", [1, 8])
def test_scan_to_map(two_scans, iters):
    """Submap from scan 1's clouds, scan 2 registered from the odometry
    prior: one GN step agrees to 5e-5, the full solve to 1e-4 (float32
    normal equations summed in another order)."""
    feats, _, out = two_scans
    ref = dataclasses.replace(REF, mapping=dataclasses.replace(REF.mapping, max_gn_iterations=iters))
    cfg = dataclasses.replace(CFG, mapping=dataclasses.replace(CFG.mapping, max_gn_iterations=iters))
    seg1, f1 = feats[1]
    seg2, f2 = feats[2]
    submap = jax.jit(lambda c, cm, s, sm: RM.assemble_submap(
        c[None], cm[None], s[None], sm[None],
        jnp.eye(3)[None], jnp.zeros((1, 3)), jnp.ones(1, bool), jnp.zeros(3), ref,
    ))(f1.corner_less_sharp.xyz, f1.corner_less_sharp.mask, f1.surf_less_flat.xyz, f1.surf_less_flat.mask)
    psub = PM.assemble_submap(
        t(f1.corner_less_sharp.xyz[None]), t(f1.corner_less_sharp.mask[None]),
        t(f1.surf_less_flat.xyz[None]), t(f1.surf_less_flat.mask[None]),
        torch.eye(3)[None], torch.zeros((1, 3)), torch.ones(1, dtype=torch.bool), torch.zeros(3), cfg,
    )
    for f in ("corner_xyz", "surf_xyz"):
        m = f.replace("xyz", "mask")
        np.testing.assert_array_equal(np.asarray(getattr(submap, m)), getattr(psub, m).numpy())
    ds = jax.jit(lambda f, o, m: RB.downsample_current_scan(f, o, m, ref))(
        f2, seg2.outlier_xyz, seg2.outlier_mask
    )
    pds = PB.downsample_current_scan(port(f2, ScanFeatures), t(seg2.outlier_xyz), t(seg2.outlier_mask), cfg)
    np.testing.assert_array_equal(np.asarray(ds[1]), pds[1].numpy())
    # the reference's submap and scan in both solvers (ties in the voxel
    # sort order are the reference's own)
    R0, t0 = out["M_R"], out["M_t"]
    R, tt, diag = jax.jit(lambda ds, R0, t0, sm: RM.scan_to_map(*ds, R0, t0, sm, ref))(ds, R0, t0, submap)
    pR, pt, pdiag = PM.scan_to_map(*(t(x) for x in ds), t(R0), t(t0), port(submap, MapState), cfg)
    tol = 5e-5 if iters == 1 else 1e-4
    np.testing.assert_allclose(np.asarray(tt), pt.numpy(), atol=tol)
    np.testing.assert_allclose(np.asarray(R), pR.numpy(), atol=tol)
    assert int(diag.iterations) == int(pdiag.iterations)
    assert abs(int(diag.n_sel) - int(pdiag.n_sel)) <= 2
    assert not bool(pdiag.rejected) and int(pdiag.n_sel) > 1000
