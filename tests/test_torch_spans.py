"""The frame steps' span marks and the odometry's useful-trip counter: the
marks are ordered within each step, the per-frame layer times are positive
and fit inside the chunk's wall time, the trips agree bit for bit between
the two `sync_free` modes, and `_step` is still called once per step. On
an NVIDIA GPU only: a graphed chunk with its marks makes no host read, and
graphs count the same trips as eager steps.

This file imports no JAX, so the card's machine runs it as it is:

    python -m pytest --noconftest -o addopts="" -q tests/test_torch_spans.py
"""

import dataclasses
import inspect
import time

import numpy as np
import pytest
import torch

from lego_loam_torch.config import vlp16
from lego_loam_torch.io.synthetic import straight_trajectory, swept_scan_sequence
from lego_loam_torch.pipeline import LAYERS, LegoLoamPipeline, layer_ms


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the span marks are CUDA kernels there")
    return torch.device("cuda", 0)


def small_cfg():
    """The VLP-16 preset with CPU-sized feature, submap and keyframe caps, one
    device, loop closure off."""
    cfg = vlp16()
    return dataclasses.replace(
        cfg,
        features=dataclasses.replace(cfg.features, max_surf_flat=512, max_surf_less_flat=2048, max_surf_ground=1024),
        mapping=dataclasses.replace(cfg.mapping, max_keyframes=32, max_submap_surf=4096, max_submap_corner=2048),
        distributed=dataclasses.replace(cfg.distributed, shard_backend=False, use_sharded_posegraph=False),
    )


def scans_of(cfg, n):
    return list(swept_scan_sequence(straight_trajectory(n, speed=0.15), cfg, noise=0.005))


def marks(pipe):
    """The logged marks as int64 numpy arrays: prepass (K, 2), front (N, 3)
    and map (per frame, or None)."""
    log = pipe._log
    as_np = lambda ts: torch.stack(ts).cpu().numpy()  # noqa: E731
    return (as_np(log["prepass_span"]), as_np(log["front_span"]),
            [None if m is None else m.cpu().numpy() for m in log["map_span"]])


def assert_ordered(pipe):
    pre, front, maps = marks(pipe)
    assert (pre[:, 0] <= pre[:, 1]).all()
    assert (front[:, 0] <= front[:, 1]).all() and (front[:, 1] <= front[:, 2]).all()
    for m in maps:
        assert m is None or m[0] <= m[1]


def test_span_marks_ordered_and_layer_times_fit_the_chunk():
    """Two chunks of 2 on the CPU (marks on the host clock): each step's
    marks in order, every layer time of every frame positive (mapping: every
    frame is mapped), one chunk's layers no longer than its call's wall
    time, both chunks' no longer than both calls'."""
    cfg = small_cfg()
    scans = scans_of(cfg, 4)
    pipe = LegoLoamPipeline(cfg, seed=3, device="cpu")
    t0 = time.perf_counter()
    pipe.process_chunk(scans[:2])
    t1 = time.perf_counter()
    pipe.process_chunk(scans[2:])
    t2 = time.perf_counter()
    pipe.finalize()
    assert_ordered(pipe)
    layers = pipe.diagnostics["layer_ms"]
    assert sorted(layers) == sorted(LAYERS) and all(len(v) == 4 for v in layers.values())
    for k in LAYERS:
        assert all(v > 0 for v in layers[k]), (k, layers[k])
    per_frame = np.sum([layers[k] for k in LAYERS], axis=0)
    assert per_frame[:2].sum() <= 1e3 * (t1 - t0)
    assert per_frame.sum() <= 1e3 * (t2 - t0)
    assert pipe.diagnostics["mapping_ms"] == layers["mapping"]  # the chunk path's frames are all timed


def test_odom_trips_equal_in_both_modes():
    """The useful GN trips a frame, host-branching against sync_free on the
    same scans: equal, none on the first frame (no solve), and between 2
    (one trip a stage) and the 2 x max_iterations attempted after it."""
    cfg = small_cfg()
    scans = scans_of(cfg, 3)
    trips = {}
    for sync_free in (False, True):
        pipe = LegoLoamPipeline(cfg, seed=3, device="cpu", sync_free=sync_free)
        pipe.process_chunk(scans)
        pipe.finalize()
        trips[sync_free] = pipe.diagnostics["odom_trips"]
        assert_ordered(pipe)
    assert trips[False] == trips[True]
    assert trips[True][0] == 0
    assert all(2 <= n <= 2 * cfg.odometry.max_iterations for n in trips[True][1:]), trips


def test_step_called_once_per_step():
    """`_step(kind, key, fn, x)` keeps its signature and is called once for
    each step: a wrapper as the benchmark puts one in its place counts one
    prepass, a front step a frame and a map step a mapped frame."""
    assert list(inspect.signature(LegoLoamPipeline._step).parameters) == ["self", "kind", "key", "fn", "x"]
    cfg = dataclasses.replace(small_cfg(), mapping=dataclasses.replace(small_cfg().mapping,
                                                                       mapping_frequency_divider=2))
    scans = scans_of(cfg, 3)
    pipe = LegoLoamPipeline(cfg, seed=3, device="cpu")
    calls = []
    run = pipe._step

    def step(kind, key, fn, x):
        calls.append(kind)
        return run(kind, key, fn, x)

    pipe._step = step
    pipe.process_chunk(scans)
    assert calls == ["prepass", "front", "map", "front", "front", "map"]
    pipe.finalize()
    assert pipe.diagnostics["layer_ms"]["mapping"][1] == 0.0 and len(pipe.diagnostics["mapping_ms"]) == 2


def test_layer_ms_from_marks():
    """`layer_ms` on hand-made marks (ns): two chunks, the first of 2 frames
    (frame 1 not mapped), the second of 1; the prepass and the gap before
    it are shared evenly by the chunk's frames."""
    pre = [(0, 1_000_000), (20_000_000, 22_000_000)]
    front = [(2_000_000, 3_000_000, 7_000_000), (10_000_000, 11_000_000, 14_000_000),
             (23_000_000, 25_000_000, 30_000_000)]
    maps = [(8_000_000, 9_000_000), None, (31_000_000, 34_000_000)]
    got = layer_ms(pre, [2, 1], front, maps)
    assert got["front_end"] == pytest.approx([1.5, 1.5, 4.0])
    assert got["odometry"] == pytest.approx([4.0, 3.0, 5.0])
    assert got["mapping"] == pytest.approx([1.0, 0.0, 3.0])
    assert got["between_steps"] == pytest.approx([1.0 + 1.0, 1.0, 6.0 + 1.0 + 1.0])
    assert sum(map(sum, got.values())) == pytest.approx(34.0)  # first mark to last


def test_profile_mapt_only_with_profile():
    """`process_scan` records its map steps' device time in mapping_ms with
    `profile` and not without; the layer times are there either way."""
    cfg = small_cfg()
    scans = scans_of(cfg, 2)
    for profile in (False, True):
        pipe = LegoLoamPipeline(cfg, seed=3, device="cpu", profile=profile)
        for s in scans:
            pipe.process_scan(s)
        pipe.finalize()
        assert len(pipe.diagnostics["layer_ms"]["mapping"]) == 2
        assert pipe.diagnostics["mapping_ms"] == (pipe.diagnostics["layer_ms"]["mapping"] if profile else [])


@pytest.mark.cuda
def test_graphed_chunk_makes_no_host_read(gpu):
    """Loop closure off, two warm chunks (graphs captured), then a chunk
    already staged runs under `set_sync_debug_mode("error")`: the marks add
    no host read; every frame's marks are in order."""
    cfg = dataclasses.replace(vlp16(), mapping=dataclasses.replace(vlp16().mapping, max_keyframes=512))
    scans = scans_of(cfg, 12)
    pipe = LegoLoamPipeline(cfg, seed=3, device=gpu)
    assert pipe.graphs and not cfg.mapping.enable_loop_closure
    for k in range(2):
        pipe.process_chunk(pipe.stage_chunk(scans[4 * k: 4 * k + 4]))
    xs = pipe.stage_chunk(scans[8:])
    torch.cuda.synchronize(gpu)
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipe.process_chunk(xs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert pipe.graph_stats["replays"] > 0
    pipe.finalize()
    assert_ordered(pipe)
    assert all(v > 0 for v in pipe.diagnostics["layer_ms"]["odometry"])


@pytest.mark.cuda
def test_graphed_trips_equal_eager(gpu):
    """Graphed steps count the eager steps' useful trips, frame by frame."""
    cfg = dataclasses.replace(vlp16(), mapping=dataclasses.replace(vlp16().mapping, max_keyframes=512))
    scans = scans_of(cfg, 8)
    trips = {}
    for graphs in (True, False):
        pipe = LegoLoamPipeline(cfg, seed=3, device=gpu, graphs=graphs)
        for k in range(2):
            pipe.process_chunk(scans[4 * k: 4 * k + 4])
        pipe.finalize()
        trips[graphs] = pipe.diagnostics["odom_trips"]
    assert trips[True] == trips[False] and trips[True][0] == 0
