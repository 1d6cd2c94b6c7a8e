"""The loop-closure flow of the port's `LegoLoamPipeline` against the
reference's, and the timestamps stored with keyframes.

Both pipelines start from the same keyframe store (tests/_torch_parity.py's
drifted circle) and the same loop-factor buffer, carried across by
`lego_loam_torch.convert`, and see the same sequence of checks with
injected candidate probes: the schedule (pickups two checks late,
cooldowns, the solve at an accept) must produce the same diagnostics,
factors and corrected poses. Tolerances: ids, flags and gate decisions
exact; ICP fitness and graph costs within 1e-3 relative; factor and
keyframe poses within 1e-3 (translations in metres, rotation entries).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu.pipeline import LegoLoamPipeline as RefPipeline
from lego_loam_tpu.pipeline import LoopFactor as RefLoopFactor
from lego_loam_torch.backend import backend_step_ds
from lego_loam_torch.convert import (
    backend_state_from_reference,
    factors_from_reference,
    odometry_state_from_reference,
)
from lego_loam_torch.io.synthetic import circle_trajectory, straight_trajectory, swept_scan_sequence
from lego_loam_torch.pipeline import LegoLoamPipeline, LoopFactor

from _torch_parity import loop_ref_cfg, loop_store, pair, ref_scores, small_ref_cfg

CUR = 39
TOL = 1e-3


def _pair_from_store():
    """(reference pipeline, port pipeline) holding the drifted store, the
    map pose at its newest keyframe, a submap cache marked as just built
    there, and one loop factor (keyframes 5 -> 30, from the truth)."""
    ref_cfg, cfg = pair(loop_ref_cfg())
    st, _ = loop_store(cfg)
    ref = RefPipeline(ref_cfg)
    ref.bstate = ref.bstate.replace(
        **{k: jnp.asarray(v) for k, v in st.items()},
        R_map=jnp.asarray(st["kf_R"][CUR]), t_map=jnp.asarray(st["kf_t"][CUR]),
        submap_center=jnp.asarray(st["kf_t"][CUR]), submap_n_kf=jnp.int32(st["n_kf"]),
    )
    poses = circle_trajectory(int(st["n_kf"]), radius=5.0, step_deg=9.5)
    (Ri, ti), (Rj, tj) = poses[5], poses[30]
    ref.loop_factors = [RefLoopFactor(5, 30, (Ri.T @ Rj).astype(np.float32), (Ri.T @ (tj - ti)).astype(np.float32), 0.05)]
    ref._sync_loop_buf()

    ours = LegoLoamPipeline(cfg, device="cpu")
    ours.bstate = backend_state_from_reference(jax.device_get(ref.bstate), "cpu")
    ours.loop_factors = [LoopFactor(f.i, f.j, f.R, f.t, f.fitness) for f in ref.loop_factors]
    ours._loop_buf = factors_from_reference(jax.device_get(ref._loop_buf), "cpu")
    ours._loop_write = ref._loop_write
    return ref, ours


def _check(pipes, frame, probe):
    """One check on both pipelines at `frame` with an injected probe
    [cand_slot, cand_dist, n_kf, cur_slot]."""
    ref, ours = pipes
    for p, arr in ((ref, jnp.asarray(probe, jnp.float32)), (ours, torch.tensor(probe, dtype=torch.float32))):
        p.frame_idx = frame
        p._linfo_q.append(arr)
        p._try_loop_closure()


def _assert_diags_equal(a, b):
    assert len(a) == len(b)
    for da, db in zip(a, b):
        assert sorted(da) == sorted(db)
        for k, va in da.items():
            vb = db[k]
            if isinstance(va, list):
                np.testing.assert_allclose(vb, va, rtol=TOL)
            elif isinstance(va, float) and k not in ("dist", "coarse_score", "coarse_frac"):
                np.testing.assert_allclose(vb, va, rtol=TOL, atol=TOL if k == "graph_max_move" else 0)
            else:
                assert vb == va or (isinstance(va, float) and math.isclose(vb, va, rel_tol=1e-6)), (k, va, vb)


def _assert_states_equal(ref, ours):
    rb = jax.device_get(ref.bstate)
    for k in ("kf_R", "kf_t", "R_map", "t_map"):
        np.testing.assert_allclose(getattr(ours.bstate, k).numpy(), np.asarray(getattr(rb, k)), atol=TOL, err_msg=k)
    for k in ("submap_center", "submap_n_kf", "n_kf"):
        np.testing.assert_array_equal(getattr(ours.bstate, k).numpy(), np.asarray(getattr(rb, k)), err_msg=k)


NONE = [0.0, math.inf, 40.0, float(CUR)]
FAR = [5.0, 7.0, 40.0, float(CUR)]  # beyond history_keyframe_search_radius
CAND = [1.0, 1.2, 40.0, float(CUR)]
CAND2 = [2.0, 1.3, 40.0, float(CUR)]


@pytest.fixture(scope="module")
def flow():
    """Both pipelines through eight checks, 4 frames apart:
    check 1 queues; 2 reads NONE; 3 reads FAR (out of radius); 4 reads CAND
    and dispatches an attempt; 5 picks it up (accepted: factor, solve
    dispatched, accept cooldown) and reads CAND2 inside the cooldown; 6
    picks up the solve and reads CAND (cooldown); 7 reads NONE; 8 reads
    CAND2, still inside the cooldown."""
    pipes = _pair_from_store()
    before = jax.device_get(pipes[0].bstate.kf_t).copy()
    for k, probe in enumerate([NONE, FAR, CAND, CAND2, CAND, NONE, CAND2, NONE]):
        _check(pipes, 100 + 4 * k, probe)
    return pipes, before


def test_flow_diagnostics_and_factors(flow):
    (ref, ours), _ = flow
    _assert_diags_equal(ref.loop_diag, ours.loop_diag)
    assert [d.get("accepted", False) for d in ours.loop_diag] == [False, False, True, False, False, False, False]
    assert ours.loop_diag[2]["graph_accepted"] is True
    assert len(ours.loop_factors) == len(ref.loop_factors) == 2
    for fa, fb in zip(ref.loop_factors, ours.loop_factors):
        assert (fa.i, fa.j) == (fb.i, fb.j)
        np.testing.assert_allclose(fb.fitness, fa.fitness, rtol=TOL)
        np.testing.assert_allclose(fb.R, np.asarray(fa.R), atol=TOL)
        np.testing.assert_allclose(fb.t, np.asarray(fa.t), atol=TOL)
    rb = jax.device_get(ref._loop_buf)
    for k in ("i", "j", "mask"):
        np.testing.assert_array_equal(getattr(ours._loop_buf, k).numpy(), np.asarray(getattr(rb, k)))
    np.testing.assert_allclose(ours._loop_buf.info.numpy(), np.asarray(rb.info), rtol=TOL)
    assert ours._check_seq == ref._check_seq == 8
    assert ours._loop_cooldown_until == ref._loop_cooldown_until


def test_flow_corrected_store(flow):
    """The applied solve: corrected keyframe poses, the map pose at the
    newest keyframe's corrected pose, and the submap cache invalidated."""
    (ref, ours), before = flow
    _assert_states_equal(ref, ours)
    moved = np.linalg.norm(ours.bstate.kf_t.numpy()[:40] - before[:40], axis=1).max()
    assert moved > 0.05, moved
    np.testing.assert_array_equal(ours.bstate.R_map.numpy(), ours.bstate.kf_R[CUR].numpy())
    assert float(ours.bstate.submap_center[0]) == 1e9 and int(ours.bstate.submap_n_kf) == -1


def test_next_frame_rebuilds_submap(flow):
    """After the applied solve the next mapping step rebuilds the submap
    from the corrected poses; with the cache left as it was (built at the
    newest keyframe, whose correction is smaller than
    `submap_rebuild_dist`) the same step would have kept the stale one."""
    (ref, ours), before = flow
    bs = ours.bstate
    scan = (bs.kf_corner_view()[CUR], bs.kf_corner_mask[CUR], bs.kf_surf_view()[CUR], bs.kf_surf_mask[CUR])

    def step(state):
        new, _, _ = backend_step_ds(state, *scan, bs.R_odom, bs.t_odom, torch.tensor(4.0), ours.cfg)
        return new

    rebuilt = step(bs)
    assert int(rebuilt.submap_n_kf) == int(bs.n_kf) == 40
    np.testing.assert_array_equal(rebuilt.submap_center.numpy(), bs.t_map.numpy())
    stale_center = torch.from_numpy(before[CUR])
    kept = step(bs.replace(submap_center=stale_center, submap_n_kf=bs.n_kf.clone()))
    np.testing.assert_array_equal(kept.submap_center.numpy(), before[CUR])


def test_drain_evaluates_final_probe():
    """At the end of the stream the port reads every queued probe, the
    final one at the last pose included; the reference reads only the
    oldest, so a revisit in the last frames is missed there. Here the
    queued probe has no candidate and the final probe (at the newest
    keyframe, back near the first) has one."""
    ref, ours = _pair_from_store()
    for p in (ref, ours):
        p.frame_idx = 200
    ref._linfo_q.append(jnp.asarray(NONE, jnp.float32))
    ours._linfo_q.append(torch.tensor(NONE))
    ref._drain_loop_closure()
    ours._drain_loop_closure()
    assert len(ref.loop_diag) == 1 and "icp_fitness" not in ref.loop_diag[0]
    assert len(ref.loop_factors) == 1
    assert len(ours.loop_diag) == 2 and ours.loop_diag[0]["cand"] == -1
    final = ours.loop_diag[1]
    assert final["accepted"] and final["graph_accepted"]
    assert len(ours.loop_factors) == 2 and ours.loop_factors[1].j == CUR
    assert not ours._linfo_q and ours._attempt_pending is None and ours._solve_pending is None


# -- timestamps ----------------------------------------------------------------

FRAMES = (9, 13)  # float32(i) * float32(0.1) != float32(i * 0.1) for i = 9, 13, 18, ...


def _fresh(ref_cfg, cfg):
    ref = RefPipeline(ref_cfg)
    ours = LegoLoamPipeline(cfg, device="cpu", ground_scores=lambda i: ref_scores(cfg, i))
    ours.fstate = odometry_state_from_reference(jax.device_get(ref.fstate), "cpu")
    ours.bstate = backend_state_from_reference(jax.device_get(ref.bstate), "cpu")
    return ref, ours


def test_keyframe_and_log_times():
    """Frames 9-13 through both chunk runners and frame 18 through both
    `process_scan`s: the keyframe times equal bit for bit, the logged map
    times equal. The reference's chunk runner stores float32(i) *
    scan_period computed in float32 and logs the float64 product rounded to
    float32; its process_scan stores that rounded product and logs the
    float64 value."""
    ref_cfg, cfg = pair(small_ref_cfg(max_keyframes=8))
    assert cfg.mapping.keyframe_gate_always and cfg.mapping.mapping_frequency_divider == 1
    poses = straight_trajectory(6, speed=0.15)
    scans = list(swept_scan_sequence(poses, cfg, noise=0.005))
    period = np.float32(cfg.laser.scan_period)
    for i in FRAMES + (18,):
        assert np.float32(i) * period != np.float32(i * cfg.laser.scan_period)

    ref, ours = _fresh(ref_cfg, cfg)
    for p in (ref, ours):
        p.frame_idx = 9
    ref.process_chunk(ref._prep_many(scans[1:]))
    ours.process_chunk(ours._prep_many(scans[1:]))
    ref.finalize()
    ours.finalize()
    want = np.asarray(jax.device_get(ref.bstate.kf_time))[:5]
    np.testing.assert_array_equal(ours.bstate.kf_time.numpy()[:5], want)
    np.testing.assert_array_equal(want, np.arange(9, 14).astype(np.float32) * period)
    assert ours.trajectory["times"] == ref.trajectory["times"]
    assert ref.trajectory["times"][0] == float(np.float32(0.9))

    ref, ours = _fresh(ref_cfg, cfg)
    for p in (ref, ours):
        p.frame_idx = 18
        p.process_scan(scans[0])
        p.finalize()
    want = np.asarray(jax.device_get(ref.bstate.kf_time))[0]
    assert ours.bstate.kf_time.numpy()[0] == want == np.float32(18 * cfg.laser.scan_period)
    assert ours.trajectory["times"] == ref.trajectory["times"] == [18 * cfg.laser.scan_period]


def test_drain_does_not_repeat_an_attempt():
    """A stream that ends on a checked chunk: the final probe sees the
    store the queued probe saw. The drain attempts that candidate once and
    adds its factor once."""
    _, ours = _pair_from_store()
    ours.frame_idx = 200
    ours._linfo_q.append(ours._loopinfo_probe())
    ours._drain_loop_closure()
    assert len(ours.loop_diag) == 2
    assert ours.loop_diag[0]["accepted"] and "icp_fitness" not in ours.loop_diag[1]
    assert ours.loop_diag[1]["cand"] == ours.loop_diag[0]["cand"]
    assert len(ours.loop_factors) == 2


def test_optimize_graph_from_host_factors():
    """The manual whole-graph correction: the device buffer rebuilt from
    the host list of loop factors, then one solve, as the reference's
    single-device `_optimize_graph` does."""
    ref, ours = _pair_from_store()
    ours._loop_buf = ours._empty_loop_buf()  # only the host list holds the factor
    ref._optimize_graph()
    ours._optimize_graph()
    _assert_states_equal(ref, ours)
    assert float(ours.bstate.submap_center[0]) == 1e9
    np.testing.assert_array_equal(ours._loop_buf.mask.numpy(), np.asarray(ref._loop_buf.mask))
