"""The device-resident frame step: `LegoLoamPipeline(sync_free=True)`
decides every branch and loop exit on the device (no host read) and must
give the host-branching step's results bit for bit. Port against port, on
the CPU, for each of: a straight drive with loop closure on (injected
probes and an injected loop factor whose graph solve rewrites the store and
the map pose in place between chunks), a chunk with IMU undistortion and
the wheel-odometry prior, `mapping_frequency_divider=2`, and the per-scan
`process_scan`. Compared exactly: map, odometry and fused poses, map
attitudes and times, the mapping records (`MapDiag`), and every leaf of
the odometry state and the keyframe store.

A guard makes every host read of a tensor (`bool`, `int`, `float`,
`index`, `item`, `tolist`, `cpu`, `numpy`) raise inside the sync_free
frame steps, so a read added later fails here on the CPU; on the card,
`chip_smoke.py` runs a chunk under `torch.cuda.set_sync_debug_mode("error")`.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from lego_loam_torch.io.synthetic import (
    straight_trajectory,
    swept_scan_sequence,
    synth_imu_windows,
    synth_wheel_odom,
)
from lego_loam_torch.pipeline import LegoLoamPipeline, LoopFactor
from lego_loam_torch.types import named_leaves

from _torch_parity import loop_ref_cfg, pair, small_ref_cfg

HOST_READS = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "cpu", "numpy")


@contextlib.contextmanager
def no_host_reads():
    """Every host read of a tensor raises while the context is open."""
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}

    def deny(name):
        def read(self, *args, **kwargs):
            raise AssertionError(f"host read inside a sync_free frame step: Tensor.{name}")
        return read

    for name in HOST_READS:
        setattr(torch.Tensor, name, deny(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def guarded(pipe):
    """The pipeline with its three frame steps run under `no_host_reads`."""
    for name in ("_prepass_step", "_front_step", "_map_step"):
        step = getattr(pipe, name)

        def run(x, step=step):
            with no_host_reads():
                return step(x)

        setattr(pipe, name, run)
    return pipe


def small(cfg, **sections):
    """`cfg` with the CPU-sized clouds of this test: fewer feature and
    submap slots and at most 8 GN iterations a stage (the sync_free step runs
    every iteration and searches in each: the early-exit step converges in
    3-6 here, so both the frozen iterations and the cap are exercised).
    `sections`: further {section: {field: value}} replacements."""
    repl = {
        "features": dict(max_surf_flat=512, max_surf_less_flat=2048, max_surf_ground=1024),
        "odometry": dict(max_iterations=8),
        "mapping": dict(max_submap_surf=4096, max_submap_corner=2048),
    }
    for name, kw in sections.items():
        repl[name] = {**repl.get(name, {}), **kw}
    return dataclasses.replace(cfg, **{name: dataclasses.replace(getattr(cfg, name), **kw) for name, kw in repl.items()})


def scans_of(cfg, n, speed=0.15, yaw_rate=0.0):
    poses = straight_trajectory(n, speed=speed, yaw_rate=yaw_rate)
    return poses, list(swept_scan_sequence(poses, cfg, noise=0.005))


def result(pipe):
    """Everything compared between the two modes, as numpy arrays."""
    pipe.finalize()
    out = {
        "odom": pipe.odom_positions, "fused": pipe.fused_positions,
        "map_t": np.asarray(pipe.trajectory["positions"]), "map_rpy": np.asarray(pipe.trajectory["rpys"]),
        "map_time": np.asarray(pipe.trajectory["times"]),
    }
    for k, rec in enumerate(pipe.diagnostics["records"]):
        out.update({f"diag{k}.{f}": np.asarray(v) for f, v in rec.items()})
    for prefix, state in (("f.", pipe.fstate), ("b.", pipe.bstate)):
        out.update({prefix + name: leaf.numpy() for name, leaf in named_leaves(state)})
    return out


def assert_same_bits(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def both_modes(cfg, drive):
    """drive(pipe) with a host-branching and a sync_free pipeline (the
    latter guarded), each starting from its own initial state; returns
    their results."""
    runs = []
    for sync_free in (False, True):
        pipe = LegoLoamPipeline(cfg, seed=3, device="cpu", sync_free=sync_free)
        assert pipe.sync_free is sync_free and not pipe.graphs
        drive(guarded(pipe) if sync_free else pipe)
        runs.append(result(pipe))
    return runs


def test_loop_closure_drive_bit_identical():
    """Two chunks of 2 with loop closure on: the candidate probes injected
    (no candidate, so the schedule runs without an ICP attempt), and
    between the chunks a loop factor from keyframe 0 to the newest,
    disagreeing with the chain by 5 cm and 0.5 deg, solved (an anchor at
    every keyframe) and applied in place: the store's poses move, the map
    pose becomes the newest keyframe's and the submap cache is invalidated,
    so the second chunk rebuilds its submap from the corrected store."""
    cfg = small(pair(loop_ref_cfg(max_keyframes=32))[1], mapping=dict(posegraph_anchor_stride=1))
    _, scans = scans_of(cfg, 4)
    none = torch.tensor([-1.0, float("inf"), 0.0, 0.0])
    moved = []

    def drive(pipe):
        pipe._loopinfo_probe = lambda: none.clone()
        pipe.process_chunk(scans[:2])
        kR, kt, _ = pipe.keyframe_trajectory()
        a = np.deg2rad(0.5)
        Rz = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]])
        j = len(kt) - 1
        rel_R = (kR[0].T @ kR[j] @ Rz).astype(np.float32)
        rel_t = (kR[0].T @ (kt[j] - kt[0]) + np.array([0.05, 0.0, 0.0])).astype(np.float32)
        pipe.loop_factors.append(LoopFactor(0, j, rel_R, rel_t, 0.05))
        pipe.loop_diag.append({"injected": True})
        pipe._optimize_graph()
        assert pipe.loop_diag[-1]["graph_accepted"] and int(pipe.bstate.submap_n_kf) == -1
        moved.append(np.abs(pipe.keyframe_trajectory()[1] - kt).max())
        pipe.process_chunk(scans[2:])

    a, b = both_modes(cfg, drive)
    assert_same_bits(a, b)
    assert a["map_t"].shape == (4, 3) and moved[0] == moved[1] > 0.01


def test_imu_and_prior_chunk_bit_identical():
    """One chunk of 2 turning scans with IMU undistortion and the
    wheel-odometry prior ("init"), staged with their IMU windows and wheel
    poses."""
    cfg = small(pair(small_ref_cfg(max_keyframes=32))[1], pipeline=dict(use_imu_undistortion=True, imu_window=16),
                odometry=dict(odom_prior_mode="init"))
    poses, scans = scans_of(cfg, 2, yaw_rate=np.deg2rad(2.0))
    imu, odom = synth_imu_windows(poses, cfg), synth_wheel_odom(poses, cfg)

    def drive(pipe):
        pipe.process_chunk(pipe._prep_many(scans), imu=imu, odom=odom)

    a, b = both_modes(cfg, drive)
    assert_same_bits(a, b)


def test_mapping_divider_bit_identical():
    """`mapping_frequency_divider=2`: frames 0 and 2 of a chunk of 3 map,
    frame 1 only runs the front step."""
    cfg = small(pair(small_ref_cfg(max_keyframes=32))[1], mapping=dict(mapping_frequency_divider=2))
    _, scans = scans_of(cfg, 3)

    def drive(pipe):
        pipe.process_chunk(scans)

    a, b = both_modes(cfg, drive)
    assert_same_bits(a, b)
    assert a["map_t"].shape == (2, 3) and a["odom"].shape == (3, 3)


def test_process_scan_bit_identical():
    """Two scans through the per-scan `process_scan` (float32 points,
    C = 1), returned poses included."""
    cfg = small(pair(small_ref_cfg(max_keyframes=32))[1])
    _, scans = scans_of(cfg, 2)
    returned = {False: [], True: []}

    def drive(pipe):
        for s in scans:
            out = pipe.process_scan(s)
            returned[pipe.sync_free].append({k: v.clone() for k, v in out.items()})

    a, b = both_modes(cfg, drive)
    assert_same_bits(a, b)
    for x, y in zip(returned[False], returned[True]):
        assert_same_bits({k: v.numpy() for k, v in x.items()}, {k: v.numpy() for k, v in y.items()})


def test_guard_catches_host_reads():
    """The guard itself: it stops the host-branching step at its first read
    (`bool(state.initialized)`), and any read inside a guarded step."""
    _, cfg = pair(small_ref_cfg(max_keyframes=32))
    _, scans = scans_of(cfg, 1)
    with pytest.raises(AssertionError, match="host read inside a sync_free frame step: Tensor.__bool__"):
        guarded(LegoLoamPipeline(cfg, device="cpu", sync_free=False)).process_chunk(scans)
    pipe = LegoLoamPipeline(cfg, device="cpu", sync_free=True)
    pipe._map_step = lambda x: {"n": int(x["n"]), "t": x["t"].tolist()}
    guarded(pipe)
    with pytest.raises(AssertionError, match="Tensor.__int__"):
        pipe._map_step({"n": torch.ones((), dtype=torch.int32), "t": torch.zeros(3)})


def test_mode_defaults():
    """sync_free and graphs default to on for a CUDA device and off on the
    CPU; graphs need both."""
    _, cfg = pair(small_ref_cfg(max_keyframes=32))
    pipe = LegoLoamPipeline(cfg, device="cpu")
    assert not pipe.sync_free and not pipe.graphs
    assert LegoLoamPipeline(cfg, device="cpu", sync_free=True).sync_free
    with pytest.raises(ValueError, match="graphs=True"):
        LegoLoamPipeline(cfg, device="cpu", sync_free=True, graphs=True)


def test_step_graphs_capture_replay_recapture(monkeypatch):
    """The capture schedule of `graphs.StepGraphs`, with a stand-in for the
    CUDA capture (the CPU has none): a step's first use runs eagerly, its
    second is captured and replayed, later uses replay; a state tensor
    replaced since the capture is seen before the replay and the step is
    captured again, never replayed against the old buffer."""
    from lego_loam_torch import graphs
    from lego_loam_torch.types import FeatureCloud

    class Captured:
        def __init__(self, name, fn, x, states):
            self.fn, self.ptrs, self.seconds = fn, graphs.state_ptrs(states), 0.0

        def replay(self, x):
            return self.fn(x)

    monkeypatch.setattr(graphs, "CapturedStep", Captured)
    state = FeatureCloud(xyz=torch.zeros(4, 3), ring=torch.zeros(4, dtype=torch.int32),
                         rel_time=torch.zeros(4), mask=torch.zeros(4, dtype=torch.bool))
    runs = graphs.StepGraphs()

    def step(x):
        return {"y": x["x"] + 1}

    outs = [runs.run("front", (), step, {"x": torch.full((), float(i))}, (state,))["y"] for i in range(3)]
    assert [float(y) for y in outs] == [1.0, 2.0, 3.0]
    assert runs.stats == {"captures": 1, "recaptures": 0, "replays": 2, "capture_s": 0.0}
    state = state.replace(xyz=torch.ones(4, 3))  # a caller replaced a state tensor
    runs.run("front", (), step, {"x": torch.zeros(())}, (state,))
    assert runs.stats["captures"] == 2 and runs.stats["recaptures"] == 1 and runs.stats["replays"] == 3
    runs.run("map", (), step, {"x": torch.zeros(())}, (state,))  # another kind starts with its eager use
    assert runs.stats["captures"] == 2 and runs.stats["replays"] == 3


def test_capture_failure_names_the_operation():
    """A failed capture is reported at the operation that broke it (the
    first error of the chain, with its innermost line in the package), not
    at the error that ending the capture raises after it."""
    from lego_loam_torch import graphs
    from lego_loam_torch.math.jacobi import jacobi_eigh

    def capture():
        try:
            jacobi_eigh(torch.zeros(3, 3))  # raises inside the package
        except ValueError:
            raise RuntimeError("operation failed due to a previous error during capture")

    with pytest.raises(RuntimeError) as caught:
        capture()
    msg = graphs.failing_op(caught.value)
    assert msg.startswith("ValueError: jacobi_eigh takes one (n, n) matrix with n even"), msg
    assert "at lego_loam_torch/math/jacobi.py:" in msg and "(jacobi_eigh)" in msg, msg
    assert "previous error" not in msg
