"""The keyframe ring past capacity, the port's counterpart of
tests/test_backend.py::test_keyframe_ring_saturation: K = 8 keyframe slots
and n = 3K + 2 frames on the reference's small test config
(tests/test_backend.py::small_cfg: CPU-sized caps, rigid renders) with the
submap held to 4,096 corner and 8,192 surf slots over the 6 nearest
keyframes, rendered as that test renders them (a 0.25 m, 1.5 deg a frame
drive, 5 mm noise, seed 3 + i), through the per-scan `run`.

Checks, as the reference's test: every keyframe appended (n_kf == n, not
clamped); the K resident slots in time order, the newest at (n - 1) x the
scan period; map ATE < 0.15 m after the ring wrapped three times; and a
chain-only `_optimize_graph` over the wrapped window moves the newest pose
< 0.05 m. Besides: the pose graph's chain and `keyframe_trajectory`
follow append order across the wrap, and the resident slots of a store
at and past capacity equal the reference's. A drive of the first wrap
(n = K + 2) against the reference's is left out: the reference's drive
alone takes ~87 s here, the whole of this file's budget.

Past `max_loop_factors`, with no drive: one list of loop factors, more
than the cap of 3 and some on keyframes the ring has retired, given to
both packages over the same store; the whole-graph factors that
`_graph_factors` assembles equal those the reference's
`_optimize_graph_sharded` hands its solver (the newest resident factors,
at most the cap), and the device loop buffer that `_sync_loop_buf`
rebuilds (the newest factors, at most the cap) equals the reference's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lego_loam_tpu.backend as ref_backend
import lego_loam_tpu.pipeline as ref_pipeline
from lego_loam_tpu.distributed import make_mesh as ref_make_mesh
from lego_loam_torch.convert import backend_state_from_reference, config_from_reference
from lego_loam_torch.io.synthetic import render_scan, straight_trajectory
from lego_loam_torch.math import se3
from lego_loam_torch.pipeline import LegoLoamPipeline, LoopFactor
from lego_loam_torch.utils.metrics import ate_rmse

from test_backend import small_cfg

K = 8


def ring_cfg():
    """The reference's test config of the ring: small_cfg at K slots."""
    cfg = small_cfg()
    return dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, max_keyframes=K, max_submap_corner=4096, max_submap_surf=8192,
        surrounding_keyframe_search_num=6))


def course(n, cfg):
    poses = straight_trajectory(n, speed=0.25, yaw_rate=np.deg2rad(1.5))
    return poses, [render_scan(R, t, cfg, noise=0.005, seed=3 + i) for i, (R, t) in enumerate(poses)]


def resident_times(bstate):
    slots = bstate.ordered_slots()
    return slots, np.asarray(bstate.kf_time.cpu())[slots]


@pytest.fixture(scope="module")
def wrapped():
    """The port over 3K + 2 frames (its own RANSAC draws), the map pose
    before and after a chain-only graph solve."""
    cfg = config_from_reference(ring_cfg())
    n = 3 * K + 2
    poses, scans = course(n, cfg)
    pipe = LegoLoamPipeline(cfg, device="cpu")
    out = pipe.run(scans)
    t_before = pipe.bstate.t_map.clone().numpy()
    pipe._optimize_graph()
    return cfg, n, poses, pipe, out, t_before, pipe.bstate.t_map.numpy()


def test_ring_wraps_three_times(wrapped):
    cfg, n, poses, pipe, out, _, _ = wrapped
    assert int(pipe.bstate.n_kf) == n  # total appended, not clamped
    slots, times = resident_times(pipe.bstate)
    assert len(slots) == K == pipe.bstate.capacity
    assert np.all(np.diff(times) > 0), "the ring's resident window must be in time order"
    assert times[-1] == pytest.approx((n - 1) * cfg.laser.scan_period)
    gt = np.stack([t for _, t in poses])
    assert ate_rmse(out["map_positions"], gt, align=False) < 0.15


def test_chain_only_solve_keeps_the_newest_pose(wrapped):
    *_, pipe, _, t_before, t_after = wrapped
    assert not pipe.loop_factors
    assert np.linalg.norm(t_after - t_before) < 0.05


def test_wrapped_graph_and_keyframes_in_logical_order(wrapped):
    """Across the wrap the pose graph's chain pairs consecutive resident
    keyframes in append order, and `keyframe_trajectory` returns the
    resident keyframes oldest to newest."""
    *_, pipe, _, _, _ = wrapped
    slots, times = resident_times(pipe.bstate)
    factors, active, newest = pipe._graph_factors()
    assert newest == slots[-1] and int(active.sum()) == K
    chain = factors.mask[: K - 1].numpy()
    assert chain.all()
    assert np.array_equal(factors.i[: K - 1].numpy(), slots[:-1]) and np.array_equal(factors.j[: K - 1].numpy(), slots[1:])
    _, kt, ktimes = pipe.keyframe_trajectory()
    assert np.array_equal(ktimes, times) and np.array_equal(kt, pipe.bstate.kf_t.numpy()[slots])


@pytest.mark.parametrize("n_kf", [0, 5, K, K + 2, 3 * K + 2])
def test_ordered_slots_match_reference(n_kf):
    """The resident slots, oldest to newest, of a store that has taken n_kf
    keyframes, against the reference's."""
    ref = ref_backend.init_backend_state(ring_cfg()).replace(n_kf=jnp.int32(n_kf))
    ours = backend_state_from_reference(jax.device_get(ref), "cpu")
    assert np.array_equal(ours.ordered_slots(), np.asarray(ref.ordered_slots()))
    assert len(ours.ordered_slots()) == min(n_kf, K)


LOOP_CAP = 3


class _Captured(Exception):
    """Raised by the stand-in solver once it has the reference's factors."""


@pytest.mark.parametrize("n_kf", [K - 1, 3 * K + 2])
def test_loop_factor_selection_past_the_cap_matches_reference(n_kf):
    """Seven loop factors, cap 3, over a store of n_kf keyframes (at 3K + 2
    the oldest factors lie on retired keyframes): the port's whole-graph
    factors and device loop buffer equal the reference's, field by field."""
    ref_cfg = ring_cfg()
    ref_cfg = dataclasses.replace(ref_cfg, mapping=dataclasses.replace(
        ref_cfg.mapping, enable_loop_closure=True, max_loop_factors=LOOP_CAP))
    rs = np.random.RandomState(7)
    ref = ref_pipeline.LegoLoamPipeline(ref_cfg)
    rel_R = se3.exp_so3(torch.from_numpy(rs.randn(K, 3).astype(np.float32) * 0.05)).numpy()
    ref.bstate = ref.bstate.replace(
        n_kf=jnp.int32(n_kf), kf_rel_R=jnp.asarray(rel_R), kf_rel_t=jnp.asarray(rs.randn(K, 3).astype(np.float32)))
    pipe = LegoLoamPipeline(config_from_reference(ref_cfg), device="cpu")
    pipe.bstate = backend_state_from_reference(jax.device_get(ref.bstate), "cpu")

    base = n_kf - min(n_kf, K)
    pairs = [(base - 3, n_kf - 1), (base + 1, base + 3), (0, n_kf - 2), (base, n_kf - 1), (base + 2, n_kf - 3),
             (base - 1, base + 4), (base + 1, n_kf - 1)]
    factors = []
    for i, j in pairs:
        i, j = max(i, 0), max(j, 0)
        R = se3.exp_so3(torch.from_numpy(rs.randn(3).astype(np.float32) * 0.1)).numpy()
        factors.append((i, j, R, rs.randn(3).astype(np.float32), float(rs.uniform(0.01, 0.3))))
    ref.loop_factors = [ref_pipeline.LoopFactor(*f) for f in factors]
    pipe.loop_factors = [LoopFactor(*f) for f in factors]
    if n_kf > K:
        assert any(min(i, j) < base for i, j, *_ in factors), "no factor on a retired keyframe"

    captured = {}

    def solver(R, t, f, active):
        captured.update(factors=f, active=active)
        raise _Captured

    ref._mesh = ref_make_mesh(1)
    ref._solve_graph_sharded = solver
    with pytest.raises(_Captured):
        ref._optimize_graph_sharded()
    ours, active, _ = pipe._graph_factors()
    for name in ("i", "j", "R", "t", "info", "mask"):
        a, b = getattr(ours, name).numpy(), np.asarray(getattr(captured["factors"], name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert np.array_equal(active.numpy(), np.asarray(captured["active"]))
    live = ours.mask[K - 1:].numpy()
    resident = [f for f in factors if f[0] >= base and f[1] >= base]
    assert len(resident) > LOOP_CAP and live.sum() == LOOP_CAP

    ref._sync_loop_buf()
    pipe._sync_loop_buf()
    for name in ("i", "j", "R", "t", "info", "mask"):
        a, b = getattr(pipe._loop_buf, name).numpy(), np.asarray(getattr(ref._loop_buf, name))
        assert np.array_equal(a, b), name
    assert pipe._loop_write == ref._loop_write == LOOP_CAP
    assert pipe._loop_buf.mask.all() and list(pipe._loop_buf.i.numpy()) == [f[0] for f in factors[-LOOP_CAP:]]
