"""Parity of the port's loop closure (`lego_loam_torch/loopclosure.py`) with
the reference's: the same numpy inputs through both on the CPU, where the
port's nearest neighbours come from K2's twin and the reference's from its
exact CPU top-k.

Tolerances: ICP on tests/test_backend.py's fixture R, t within 1e-4 and
the iteration count equal; the coarse 2-D search (integer scores) and the
candidate slots exactly equal; an attempt's accept bit and keyframe ids
exactly equal, coarse score and fraction equal, ICP fitness within 1e-3
relative, inlier fraction within 1e-3, R_rel and t_rel within 1e-3 (the ICP
stops after its 20-iteration budget or at a 0.1 mm step, so float32
differences of a few ulps carry through)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu import loopclosure as RL
from lego_loam_tpu.math import se3 as rse3
from lego_loam_torch import loopclosure as PL

from _torch_parity import loop_ref_cfg, loop_store, pair, small_ref_cfg

CUR = 39  # the store's newest keyframe, back near its first


@pytest.fixture(scope="module")
def store():
    ref_cfg, cfg = pair(loop_ref_cfg())
    st, _ = loop_store(cfg)
    return ref_cfg, cfg, st


def T(x):
    return torch.from_numpy(np.array(x))


def _views(st):
    K = st["kf_t"].shape[0]
    return st["kf_corner"].reshape(K, -1, 3), st["kf_surf"].reshape(K, -1, 3)


def test_kabsch_rotation():
    """The port's Kabsch rotation (torch's SVD in float64 with the
    determinant correction) against the reference's formula in float64
    numpy, on well- and ill-shaped clouds and reflected targets: within
    1e-5."""
    from scipy.spatial.transform import Rotation

    rs = np.random.RandomState(0)
    for k in range(60):
        P = rs.randn(64, 3) * rs.uniform(0.01, 20.0, 3)
        Q = P @ Rotation.random(random_state=k).as_matrix().T + rs.randn(64, 3) * 0.05 * (k % 3)
        if k % 5 == 0:
            Q[:, 2] *= -1.0
        H = (P - P.mean(0)).T @ (Q - Q.mean(0))
        U, _, Vt = np.linalg.svd(H)
        d = np.sign(np.linalg.det(Vt.T @ U.T))
        want = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
        got = PL.kabsch_rotation(torch.tensor(H, dtype=torch.float32)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_icp_point2point():
    """tests/test_backend.py::test_icp_recovers_offset's clouds."""
    ref_cfg, cfg = pair(small_ref_cfg())
    rs = np.random.RandomState(0)
    tgt = rs.uniform(-5, 5, (2000, 3)).astype(np.float32)
    R_true = np.asarray(rse3.exp_so3(jnp.asarray([0.02, -0.01, 0.05])))
    t_true = np.array([0.3, -0.2, 0.1], np.float32)
    src = ((tgt - t_true) @ R_true).astype(np.float32)
    ones = np.ones(2000, bool)
    ref = RL.icp_point2point(jnp.asarray(src), jnp.asarray(ones), jnp.asarray(tgt), jnp.asarray(ones), ref_cfg)
    res = PL.icp_point2point(T(src), T(ones), T(tgt), T(ones), cfg)
    np.testing.assert_allclose(res.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(res.t.numpy(), np.asarray(ref.t), atol=1e-4)
    assert int(res.iterations) == int(ref.iterations) < cfg.mapping.icp_max_iterations
    np.testing.assert_allclose(float(res.fitness), float(ref.fitness), atol=1e-6)
    assert bool(res.converged) == bool(ref.converged)


@pytest.mark.parametrize("cand, shift", [(0, (0.0, 0.0)), (2, (0.0, 0.0)), (0, (1.3, -2.1))])
def test_coarse_align_2d(store, cand, shift):
    """The current keyframe's corner cloud against a candidate's history
    window, centred as `attempt_loop_closure` centres them (and once with
    the source moved by `shift` metres): every output exactly equal."""
    ref_cfg, cfg, st = store
    m = cfg.mapping
    corner, _ = _views(st)
    h = m.history_keyframe_search_num // 2
    win = np.clip(cand - h + np.arange(2 * h + 1), 0, int(st["n_kf"]) - 1)
    tgt = np.einsum("kij,knj->kni", st["kf_R"][win], corner[win]) + (st["kf_t"][win] - st["kf_t"][cand])[:, None]
    src = corner[CUR] @ st["kf_R"][CUR].T + np.array([*shift, 0.0], np.float32)
    args = (src.astype(np.float32), st["kf_corner_mask"][CUR], tgt.reshape(-1, 3).astype(np.float32),
            st["kf_corner_mask"][win].reshape(-1))
    kw = dict(n_yaw=m.loop_coarse_n_yaw, yaw_step=m.loop_coarse_yaw_step_deg * np.pi / 180.0,
              extent=m.loop_coarse_extent, cell=m.loop_coarse_cell, search=m.loop_coarse_search)
    want = jax.jit(lambda *a: RL.coarse_align_2d(*a, **kw))(*map(jnp.asarray, args))
    got = PL.coarse_align_2d(*map(T, args), **kw)
    assert [float(v) for v in got] == [float(v) for v in want]
    assert float(want[3]) >= m.loop_coarse_min_score


@pytest.mark.parametrize("n_kf", [0, 2, 40, 100])
def test_compute_loopinfo(n_kf):
    """Keyframes on a drifting spiral through a 64-slot ring (slot = id %
    64, 0.1 s apart), the query at the newest: candidate and current slots
    and n_kf exact, the distance within 1e-6 relative."""
    ref_cfg, cfg = pair(loop_ref_cfg())
    K = cfg.mapping.max_keyframes
    kf_t = np.zeros((K, 3), np.float32)
    kf_time = np.zeros(K, np.float32)
    for i in range(n_kf):
        a = np.deg2rad(9.5 * i)
        kf_t[i % K] = (5.0 + 0.02 * i) * np.array([np.cos(a), np.sin(a), 0.0]) + [0.01 * i, 0, 0]
        kf_time[i % K] = np.float32(i * 0.1)
    q = kf_t[(n_kf - 1) % K] + np.float32(0.3)
    want = np.asarray(RL.compute_loopinfo(jnp.asarray(kf_t), jnp.asarray(kf_time), jnp.int32(n_kf), jnp.asarray(q), ref_cfg))
    got = PL.compute_loopinfo(T(kf_t), T(kf_time), torch.tensor(n_kf, dtype=torch.int32), T(q), cfg).numpy()
    np.testing.assert_array_equal(got[[0, 2, 3]], want[[0, 2, 3]])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    assert np.isfinite(want[1]) == (n_kf >= 40)


def _attempt_both(ref_cfg, cfg, st, cand, cur, n_kf):
    corner, surf = _views(st)
    arrays = (st["kf_R"], st["kf_t"], corner, st["kf_corner_mask"], surf, st["kf_surf_mask"])
    want = jax.jit(lambda *a: RL.attempt_loop_closure(*a, ref_cfg))(
        *map(jnp.asarray, arrays), jnp.int32(cand), jnp.int32(cur), jnp.int32(n_kf)
    )
    got = PL.attempt_loop_closure(*map(T, arrays), torch.tensor(cand), torch.tensor(cur), torch.tensor(n_kf), cfg)
    return [np.asarray(v) for v in want], [v.numpy() for v in got]


def test_attempt_loop_closure(store):
    """The candidate that the probe at the newest keyframe picks; the
    drifted store's loop is accepted by both."""
    ref_cfg, cfg, st = store
    n_kf = int(st["n_kf"])
    probe = RL.compute_loopinfo(jnp.asarray(st["kf_t"]), jnp.asarray(st["kf_time"]), jnp.int32(n_kf),
                                jnp.asarray(st["kf_t"][CUR]), ref_cfg)
    cand = int(probe[0])
    (flags, R_rel, t_rel), (pflags, pR, pt) = _attempt_both(ref_cfg, cfg, st, cand, CUR, n_kf)
    assert flags[0] == 1.0
    np.testing.assert_array_equal(pflags[[0, 1, 2, 4, 5]], flags[[0, 1, 2, 4, 5]])
    np.testing.assert_allclose(pflags[3], flags[3], rtol=1e-3)
    np.testing.assert_allclose(pflags[7], flags[7], atol=1e-3)
    np.testing.assert_allclose(pR, R_rel, atol=1e-3)
    np.testing.assert_allclose(pt, t_rel, atol=1e-3)


def test_attempt_rejected_at_coarse_stage(store):
    """A current keyframe with an empty corner cloud fails the coarse gate:
    both return the skipped attempt (fitness inf, 0 iterations, identity)."""
    ref_cfg, cfg, st = store
    st = dict(st, kf_corner_mask=st["kf_corner_mask"].copy())
    st["kf_corner_mask"][CUR] = False
    (flags, R_rel, t_rel), (pflags, pR, pt) = _attempt_both(ref_cfg, cfg, st, 1, CUR, int(st["n_kf"]))
    assert flags[0] == 0.0 and np.isinf(flags[3])
    np.testing.assert_array_equal(pflags, flags)
    np.testing.assert_array_equal(pR, R_rel)
    np.testing.assert_array_equal(pt, t_rel)
