"""Parity of the port's pose graph (`lego_loam_torch/posegraph.py`) with the
reference's, on the three anchor-segment fixtures of
tests/test_posegraph_reduced.py and the chain + loop fixture of
tests/test_backend.py, the same numpy inputs fed to both.

Tolerances: `ok` equal; poses within 1 mm in translation and 1e-4 in
rotation entries; costs within 1e-4 relative (both packages sum the same
float32 formulas in another order), or 1e-6 absolute where a consistent
chain leaves only float32 rounding (~1e-10)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu import posegraph as RG
from lego_loam_tpu.math import se3 as rse3
from lego_loam_torch import posegraph as PG
from lego_loam_torch.convert import config_from_reference, factors_from_reference, to_numpy
from lego_loam_torch.pipeline import LegoLoamPipeline

from test_posegraph_reduced import _cfg, _drifted_circle, _loop_buf

POSE_ATOL, ROT_ATOL, COST_RTOL, COST_ATOL = 1e-3, 1e-4, 1e-4, 1e-6


def _store(n_kf, K, yaw_bias_deg=0.2, est=True):
    """The ring store of a drifted circle (truth too), slot = id % K."""
    R_true, t_true, relR, relt, R_est, t_est = _drifted_circle(n_kf, yaw_bias_deg=yaw_bias_deg)
    R_src, t_src = (R_est, t_est) if est else (R_true, t_true)
    kf_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    kf_t = np.zeros((K, 3), np.float32)
    rel_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    rel_t = np.zeros((K, 3), np.float32)
    for i in range(n_kf):
        kf_R[i % K], kf_t[i % K] = R_src[i], t_src[i]
        rel_R[i % K], rel_t[i % K] = relR[i], relt[i]
    return (kf_R, kf_t, rel_R, rel_t), (R_true, t_true)


def _loop_entry(R_true, t_true, a, b):
    return (a, b, R_true[a].T @ R_true[b], R_true[a].T @ (t_true[b] - t_true[a]))


def reduced_fixture(name):
    """(reference cfg, store arrays, n_kf, loop buffer) as in
    tests/test_posegraph_reduced.py."""
    if name == "drift":
        cfg, K, n = _cfg(64, 8), 64, 50
        store, (Rt, tt) = _store(n, K)
        loops = [_loop_entry(Rt, tt, 0, n - 1)]
    elif name == "consistent_chain":
        cfg, K, n = _cfg(32, 8), 32, 20
        store, _ = _store(n, K, yaw_bias_deg=0.0, est=False)
        loops = []
    else:  # ring_wrapped: 40 keyframes through a 32-slot ring
        cfg, K, n = _cfg(32, 8), 32, 40
        store, (Rt, tt) = _store(n, K, yaw_bias_deg=0.4)
        loops = [_loop_entry(Rt, tt, n - K + 2, n - 1)]
    return cfg, store, n, _loop_buf(cfg.mapping.max_loop_factors, loops)


def backend_loop_fixture():
    """tests/test_backend.py::test_pose_graph_closes_loop: 32 poses of a
    noisy odometry chain around a circle plus one exact loop factor, the
    poses integrated from the noisy chain."""
    N = 32
    gt_R, gt_t = [np.eye(3)], [np.zeros(3)]
    for k in range(1, N):
        yaw = 2 * np.pi * k / N
        c, s = np.cos(yaw), np.sin(yaw)
        gt_R.append(np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]]))
        gt_t.append(np.array([np.sin(yaw) * 5, 5 - np.cos(yaw) * 5, 0.0]))
    gt_R, gt_t = np.stack(gt_R).astype(np.float32), np.stack(gt_t).astype(np.float32)
    rs = np.random.RandomState(1)
    mi, mj, mR, mt = [], [], [], []
    for k in range(N - 1):
        Rr = gt_R[k].T @ gt_R[k + 1]
        tr = gt_R[k].T @ (gt_t[k + 1] - gt_t[k])
        Rn = np.asarray(rse3.exp_so3(jnp.asarray(rs.randn(3) * 0.005))) @ Rr
        tn = tr + rs.randn(3) * 0.02
        mi.append(k), mj.append(k + 1), mR.append(Rn), mt.append(tn)
    mi.append(N - 1), mj.append(0)
    mR.append(gt_R[N - 1].T @ gt_R[0]), mt.append(gt_R[N - 1].T @ (gt_t[0] - gt_t[N - 1]))
    F = len(mi)
    factors = RG.Factors(
        i=np.array(mi, np.int32), j=np.array(mj, np.int32),
        R=np.stack(mR).astype(np.float32), t=np.stack(mt).astype(np.float32),
        info=np.concatenate([np.tile([[1e4] * 6], (F - 1, 1)), [[1e6] * 6]]).astype(np.float32),
        mask=np.ones(F, bool),
    )
    R, t = [gt_R[0]], [gt_t[0]]
    for k in range(N - 1):
        R.append(R[k] @ mR[k])
        t.append(R[k] @ mt[k] + t[k])
    return np.stack(R).astype(np.float32), np.stack(t).astype(np.float32), factors, np.ones(N, bool)


def graph_fixture(name):
    """(poses R, poses t, factors, active mask) of one whole graph: the
    chain + loop of tests/test_backend.py, or a reduced fixture's chain
    (from its odometry steps, logical order) and loop factors."""
    if name == "backend_loop":
        return backend_loop_fixture()
    cfg, (kf_R, kf_t, rel_R, rel_t), n, loop = reduced_fixture(name)
    K = kf_R.shape[0]
    ids = np.arange(max(0, n - K), n)
    base = ids[0]
    A = len(ids)
    lm = np.asarray(loop.mask)
    factors = RG.Factors(
        i=np.concatenate([np.arange(A - 1), np.asarray(loop.i)[lm] - base]).astype(np.int32),
        j=np.concatenate([np.arange(1, A), np.asarray(loop.j)[lm] - base]).astype(np.int32),
        R=np.concatenate([rel_R[ids[1:] % K], np.asarray(loop.R)[lm]]),
        t=np.concatenate([rel_t[ids[1:] % K], np.asarray(loop.t)[lm]]),
        info=np.concatenate([np.tile([[1e4] * 3 + [1e3] * 3], (A - 1, 1)), np.asarray(loop.info)[lm]]).astype(np.float32),
        mask=np.ones(A - 1 + lm.sum(), bool),
    )
    return kf_R[ids % K], kf_t[ids % K], factors, np.ones(A, bool)


def assert_poses(ref_R, ref_t, R, t):
    np.testing.assert_allclose(R.numpy(), np.asarray(ref_R), atol=ROT_ATOL, rtol=0)
    np.testing.assert_allclose(t.numpy(), np.asarray(ref_t), atol=POSE_ATOL, rtol=0)


def T(x):
    return torch.from_numpy(np.array(x))


def port_factors(f):
    return factors_from_reference(jax.device_get(f), "cpu")


@pytest.mark.parametrize("name", ["drift", "consistent_chain", "ring_wrapped"])
def test_reduced_solve(name):
    cfg, store, n, loop = reduced_fixture(name)
    ref_R, ref_t, (ok, c0, c1, moved) = jax.jit(lambda *a: RG.reduced_solve(*a, cfg))(*store, jnp.int32(n), loop)
    R, t, (p_ok, p_c0, p_c1, p_moved) = PG.reduced_solve(
        *map(T, store), torch.tensor(n), port_factors(loop), config_from_reference(cfg)
    )
    assert bool(p_ok) == bool(ok)
    assert_poses(ref_R, ref_t, R, t)
    np.testing.assert_allclose(float(p_c0), float(c0), rtol=COST_RTOL, atol=COST_ATOL)
    if bool(ok):
        np.testing.assert_allclose(float(p_moved), float(moved), atol=POSE_ATOL)
    if name != "consistent_chain":
        assert bool(p_ok) and float(p_c1) < float(p_c0)


GRAPHS = ["backend_loop", "drift", "consistent_chain", "ring_wrapped"]


@pytest.mark.parametrize("name", GRAPHS)
def test_residuals_jacobians_and_cost(name):
    R, t, f, _ = graph_fixture(name)
    r = RG.factor_residuals(jnp.asarray(R), jnp.asarray(t), f)
    Ji, Jj = RG.factor_jacobians(jnp.asarray(R), jnp.asarray(t), f, r)
    pf = port_factors(f)
    pr = PG.factor_residuals(T(R), T(t), pf)
    pJi, pJj = PG.factor_jacobians(T(R), T(t), pf, pr)
    np.testing.assert_allclose(pr.numpy(), np.asarray(r), atol=1e-5, rtol=0)
    np.testing.assert_allclose(pJi.numpy(), np.asarray(Ji), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(pJj.numpy(), np.asarray(Jj), atol=1e-5, rtol=0)
    cost = float(RG.graph_cost(jnp.asarray(R), jnp.asarray(t), f))
    np.testing.assert_allclose(float(PG.graph_cost(T(R), T(t), pf)), cost, rtol=COST_RTOL, atol=COST_ATOL)


@pytest.mark.parametrize("name", GRAPHS)
def test_solve_dense_gn(name):
    R, t, f, active = graph_fixture(name)
    ref_R, ref_t = jax.jit(RG.solve_dense_gn)(jnp.asarray(R), jnp.asarray(t), f, jnp.asarray(active))
    pR, pt = PG.solve_dense_gn(T(R), T(t), port_factors(f), T(active))
    assert_poses(ref_R, ref_t, pR, pt)


@pytest.mark.parametrize("name", GRAPHS)
def test_solve_pose_graph(name):
    """The PCG form, at tests/test_backend.py's 32 CG iterations."""
    ref_cfg = _cfg(64, 8)
    ref_cfg = dataclasses.replace(ref_cfg, distributed=dataclasses.replace(ref_cfg.distributed, cg_iterations=32))
    R, t, f, active = graph_fixture(name)
    ref_R, ref_t = jax.jit(lambda *a: RG.solve_pose_graph(*a, ref_cfg))(
        jnp.asarray(R), jnp.asarray(t), f, jnp.asarray(active)
    )
    pR, pt = PG.solve_pose_graph(T(R), T(t), port_factors(f), T(active), config_from_reference(ref_cfg))
    assert_poses(ref_R, ref_t, pR, pt)


def test_factors_round_trip():
    _, _, f, _ = backend_loop_fixture()
    back = to_numpy(port_factors(f))
    for k in RG.Factors._fields:
        np.testing.assert_array_equal(back[k], np.asarray(getattr(f, k)))


def _loop_cfg(K):
    from lego_loam_torch.config import vlp16

    cfg = vlp16()
    return dataclasses.replace(
        cfg, mapping=dataclasses.replace(cfg.mapping, enable_loop_closure=True, max_keyframes=K)
    )


def test_stride_fallback_refused():
    """max_keyframes = 2 x 10,007: the stride of 32 halves to 2 and leaves
    10,007 anchors, a block grid of gigabytes. Refused when the pipeline is
    built, before any state is allocated."""
    cfg = _loop_cfg(20014)
    with pytest.raises(ValueError, match="10007 anchors"):
        PG.anchor_stride(cfg)
    with pytest.raises(ValueError, match="falls to a stride of 2"):
        LegoLoamPipeline(cfg, device="cpu")


def test_default_stride_accepted():
    """The default 20,480 keyframes at stride 32: 640 anchors (only the
    check runs; no store is allocated)."""
    assert PG.anchor_stride(_loop_cfg(20480)) == (32, 640)


def _random_factor_set(N, seed):
    """Factors over N poses laid out as the pipeline pads them: N - 1 chain
    slots (the resident chain valid, the rest masked at pose 0) and 128 loop
    slots (some valid, random endpoints within the chain, the rest masked),
    with random per-factor terms, zero (of either sign) where masked."""
    rs = np.random.RandomState(seed)
    live = rs.randint(2, N + 1)
    ci, cj = np.zeros(N - 1, np.int64), np.zeros(N - 1, np.int64)
    ci[: live - 1] = np.arange(live - 1)
    cj[: live - 1] = np.arange(1, live)
    n_loop = rs.randint(1, 129)
    li, lj = np.zeros(128, np.int64), np.zeros(128, np.int64)
    li[:n_loop], lj[:n_loop] = rs.randint(0, live, n_loop), rs.randint(0, live, n_loop)
    mask = np.concatenate([np.arange(N - 1) < live - 1, np.arange(128) < n_loop])
    f = PG.Factors(i=T(np.concatenate([ci, li]).astype(np.int32)), j=T(np.concatenate([cj, lj]).astype(np.int32)),
                   R=None, t=None, info=None, mask=T(mask))

    def terms(*shape):
        x = (rs.randn(len(mask), *shape) * 10.0 ** rs.uniform(-3, 3, (len(mask),) + (1,) * len(shape)))
        return T(x.astype(np.float32)) * f.mask.reshape(-1, *(1,) * len(shape))  # 0 * negative = -0

    return f, terms


@pytest.mark.parametrize("N", [64, 640, 2048, 20480])
def test_segment_sum_equals_index_add(N):
    """The pose graph's per-pose sums (a stable sort, then segment_reduce)
    equal the float index_add_ they replace, bit for bit on the CPU: the
    i-side terms, then the j-side terms, masked padding included; and the
    four 6x6 blocks a factor adds to the dense normal equations."""
    f, terms = _random_factor_set(N, seed=N)
    i, j = f.i.long(), f.j.long()
    seg = PG.factor_segments(f, N)
    for shape in ((6,), (6, 6)):
        gi, gj = terms(*shape), terms(*shape)
        old = torch.zeros((N,) + shape).index_add_(0, i, gi).index_add_(0, j, gj)
        new = PG.segment_sum(torch.cat([gi, gj]), seg)
        assert torch.equal(new, old) and (new.view(torch.int32) == old.view(torch.int32)).all()
    if N <= 640:
        m = f.mask
        hseg = PG.segments(torch.cat([i * N + i, i * N + j, j * N + i, j * N + j]), N * N, torch.cat([m, m, m, m]))
        blocks = [terms(6, 6) for _ in range(4)]
        old = torch.zeros((N * N, 6, 6))
        for (a, b), blk in zip(((i, i), (i, j), (j, i), (j, j)), blocks):
            old.index_add_(0, a * N + b, blk)
        new = PG.segment_sum(torch.cat(blocks), hseg)
        assert (new.view(torch.int32) == old.view(torch.int32)).all()
    # no segment collects the masked padding: each masked row is its own
    assert int(seg.lengths[N:].max()) <= 1
