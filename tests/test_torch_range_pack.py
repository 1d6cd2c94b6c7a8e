"""The chunk stager: the range-image packing's winner selection against its
lexsort twin, bit for bit, on rendered scans of the three sensors and on
clouds built for the edge cases; clouds packed together against each
alone; the pooled `_prep_many` against a serial loop; `stage_chunk`'s
feeds as they went up before the pinned path, and the stager's record
(diagnostics["stage_ms"], profile.json). On an NVIDIA GPU
only: the pinned side-stream upload equals a pageable upload bit for bit,
and chunks staged either way, also while the previous chunk still runs,
give the same poses.

This file imports no JAX, so the card's machine runs it as it is:

    python -m pytest --noconftest -o addopts="" -q tests/test_torch_range_pack.py
"""

import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from lego_loam_torch import feed
from lego_loam_torch.config import hdl64e, vlp16, vlp32c
from lego_loam_torch.io.synthetic import (
    render_scan_swept,
    straight_trajectory,
    swept_scan_sequence,
    synth_imu_windows,
)
from lego_loam_torch.ops.projection import (
    host_pack_range_image,
    host_pack_range_images,
    nearest_per_pixel,
    nearest_per_pixel_lexsort,
)
from lego_loam_torch.pipeline import LegoLoamPipeline

SENSORS = {"vlp16": vlp16, "hdl64e": hdl64e, "vlp32c": vlp32c}


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the pinned upload runs on a CUDA stream")
    return torch.device("cuda", 0)


def small(cfg, **pipeline):
    """cfg with CPU-sized feature, submap and keyframe caps, one device,
    loop closure off; `pipeline` replaces fields of cfg.pipeline."""
    return dataclasses.replace(
        cfg,
        features=dataclasses.replace(cfg.features, max_surf_flat=512, max_surf_less_flat=2048, max_surf_ground=1024),
        mapping=dataclasses.replace(cfg.mapping, max_keyframes=32, max_submap_surf=4096, max_submap_corner=2048,
                                    enable_loop_closure=False),
        distributed=dataclasses.replace(cfg.distributed, shard_backend=False, use_sharded_posegraph=False),
        pipeline=dataclasses.replace(cfg.pipeline, **pipeline),
    )


def scans_of(cfg, n, noise=0.005):
    return list(swept_scan_sequence(straight_trajectory(n, speed=0.15), cfg, noise=noise))


def assert_same_pack(points, cfg):
    """The packing with `nearest_per_pixel` equals the lexsort twin's, bit
    for bit and dtype for dtype, and both pick the same points."""
    new = host_pack_range_image(points, cfg)
    old = host_pack_range_image(points, cfg, winners=nearest_per_pixel_lexsort)
    for a, b in zip(new, old):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    return new


def select_inputs(points, cfg):
    """(flat, rng, ok, H*W) as `host_pack_range_image` hands them to its
    winner selection (the plain VLP-16 row formula)."""
    laser = cfg.laser
    H, W = laser.num_vertical_scans, laser.num_horizontal_scans
    pts = np.asarray(points, np.float32)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    with np.errstate(invalid="ignore"):
        rng = np.sqrt(x * x + y * y + z * z)
        ok = np.isfinite(rng) & (rng > 0.1)
        elev = np.arcsin(np.where(ok, z / np.maximum(rng, 1e-12), 0.0))
    row = np.round((elev + laser.ang_bottom) / laser.ang_res_y).astype(np.int64)
    az = np.arctan2(np.nan_to_num(x), np.nan_to_num(y))
    col = -np.round((az - np.pi / 2.0) / laser.ang_res_x).astype(np.int64) + W // 2
    col = np.where(col >= W, col - W, col)
    ok = ok & (row >= 0) & (row < H) & (col >= 0) & (col < W)
    return np.where(ok, row * W + col, H * W), rng, ok, H * W


@pytest.mark.parametrize("shuffled", [False, True], ids=["beam_order", "shuffled"])
@pytest.mark.parametrize("sensor", list(SENSORS))
def test_pack_matches_lexsort_on_rendered_scans(sensor, shuffled):
    """A swept scan with range noise and a pose-to-pose sweep, in the
    renderer's beam order and shuffled (ranges that arrive in no order are
    what makes the lexsort slow)."""
    cfg = SENSORS[sensor]()
    R1 = np.array([[np.cos(0.05), -np.sin(0.05), 0.0], [np.sin(0.05), np.cos(0.05), 0.0], [0.0, 0.0, 1.0]])
    pts = render_scan_swept((np.eye(3), np.zeros(3)), (R1, np.array([0.3, 0.05, 0.0])), cfg, noise=0.01, seed=5)
    if shuffled:
        pts = pts[np.random.default_rng(1).permutation(len(pts))]
    rimg = assert_same_pack(pts, cfg)[0]
    assert (rimg > 0).sum() > 0.5 * rimg.size


def _duplicates(cfg, rng):
    """Each point of a scan two to four times over, in no order: exact
    copies, equal keys in one pixel that still leave one winner."""
    pts = scans_of(cfg, 1)[0]
    pts = pts[np.isfinite(pts).all(axis=1)][:4000]
    reps = np.repeat(pts, rng.integers(2, 5, len(pts)), axis=0)
    return reps[rng.permutation(len(reps))]


def _near_ties(cfg, rng):
    """Pairs of points mirrored across a column centre (az = pi/2: y -> -y;
    az = pi/4: x <-> y; az = 0: x -> -x), so both have the same float32
    range in one pixel, first or second at random: the residual planes show
    which one won, and the lower index has to."""
    laser = cfg.laser
    n = 600
    el = (np.round(rng.uniform(-12, 12, n) * np.pi / 180 / laser.ang_res_y) + rng.uniform(-0.4, 0.4, n))
    el = el * laser.ang_res_y
    r = rng.uniform(3.0, 30.0, n)
    out = []
    for centre, mirror in ((np.pi / 2, lambda p: p * np.float32([1, -1, 1])),
                           (np.pi / 4, lambda p: p[:, [1, 0, 2]]),
                           (0.0, lambda p: p * np.float32([-1, 1, 1]))):
        az = centre + rng.uniform(0.05, 0.45, n) * laser.ang_res_x
        p = np.stack([r * np.cos(el) * np.sin(az), r * np.cos(el) * np.cos(az), r * np.sin(el)], 1).astype(np.float32)
        q = mirror(p)
        swap = (rng.random(n) < 0.5)[:, None]
        out += [np.where(swap, q, p), np.where(swap, p, q)]
    return np.concatenate(out)


def _nan_rows(cfg, rng):
    pts = scans_of(cfg, 1)[0].copy()
    pts[rng.random(len(pts)) < 0.3] = np.nan
    pts[rng.integers(0, len(pts), 50), rng.integers(0, 3, 50)] = np.inf
    return pts


def _out_of_range(cfg, rng):
    """Beams above and below the field of view, points inside 0.1 m, and
    points straight up and down."""
    pts = scans_of(cfg, 1)[0].copy()
    k = len(pts) // 4
    pts[:k, 2] = np.abs(pts[:k, 2]) * 5 + 20.0
    pts[k:2 * k, 2] = -np.abs(pts[k:2 * k, 2]) * 5 - 20.0
    pts[2 * k:2 * k + 100] *= 1e-3
    pts[2 * k + 100:2 * k + 110] = [[0.0, 0.0, 5.0]] * 5 + [[0.0, 0.0, -5.0]] * 5
    return pts


def _beyond_max_points(cfg, rng):
    """A cloud half as large again as max_points, noisy copies piling up in
    the pixels."""
    pts = scans_of(cfg, 1)[0]
    n = cfg.laser.max_points * 3 // 2
    extra = pts[rng.integers(0, len(pts), n - len(pts))]
    extra = extra + rng.normal(0, 0.02, extra.shape).astype(np.float32)
    return np.concatenate([pts, extra]).astype(np.float32)


def _one_pixel(cfg, rng):
    """Thousands of points in one pixel, nearest last."""
    d = np.array([0.0, 1.0, 0.0], np.float32)
    return (d[None] * np.linspace(30.0, 2.0, 5000, dtype=np.float32)[:, None]).astype(np.float32)


EDGE_CASES = {"duplicates": _duplicates, "near_ties": _near_ties, "nan_rows": _nan_rows,
              "out_of_range": _out_of_range, "beyond_max_points": _beyond_max_points, "one_pixel": _one_pixel,
              "empty": lambda cfg, rng: np.zeros((0, 3), np.float32),
              "all_nan": lambda cfg, rng: np.full((100, 3), np.nan, np.float32)}


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_pack_matches_lexsort_on_edge_cases(case):
    for sensor in ("vlp16", "vlp32c"):
        cfg = SENSORS[sensor]()
        assert_same_pack(EDGE_CASES[case](cfg, np.random.default_rng(7)), cfg)


def test_ties_go_to_the_lowest_index():
    """Equal ranges in one pixel: the lowest index wins, whatever the order
    of the rest; winners are the twin's, one per hit pixel."""
    cfg = vlp16()
    pts = _near_ties(cfg, np.random.default_rng(3))
    flat, rng, ok, n_pix = select_inputs(pts, cfg)
    win = nearest_per_pixel(flat, rng, ok)
    assert np.array_equal(np.sort(win), np.sort(nearest_per_pixel_lexsort(flat, rng, ok, n_pix)))
    assert len(np.unique(flat[win])) == len(win)
    for p in np.unique(flat[ok]):
        members = np.flatnonzero(ok & (flat == p))
        best = members[rng[members] == rng[members].min()].min()
        assert best in win


@pytest.mark.parametrize("sensor", ["vlp16", "hdl64e"])
def test_clouds_packed_together_equal_each_alone(sensor):
    """Clouds of different sizes (an edge case's, a rendered scan, none)
    through one `host_pack_range_images` call: each cloud's planes are
    those it gets alone, bit for bit, with either winner selection."""
    cfg = SENSORS[sensor]()
    rng = np.random.default_rng(11)
    clouds = [_nan_rows(cfg, rng), _near_ties(cfg, rng), np.zeros((0, 3), np.float32), _beyond_max_points(cfg, rng),
              _one_pixel(cfg, rng)]
    for winners in (nearest_per_pixel, nearest_per_pixel_lexsort):
        together = host_pack_range_images(clouds, cfg, winners)
        for k, cloud in enumerate(clouds):
            alone = host_pack_range_image(cloud, cfg, winners)
            for a, b in zip(together, alone):
                assert a[k].dtype == b.dtype and np.array_equal(a[k], b)


def test_vlp32c_packs_one_cloud_a_call():
    cfg = vlp32c()
    with pytest.raises(ValueError, match="one cloud a call"):
        host_pack_range_images([np.zeros((0, 3), np.float32)] * 2, cfg)


@pytest.mark.parametrize("sensor", list(SENSORS))
def test_pooled_prep_many_equals_the_serial_loop(sensor, monkeypatch):
    """`_prep_many` on four workers (groups of scans packed in pool
    threads; VLP-32C one scan a group) gives the arrays of a
    serial loop over the lexsort twin, dtypes included; into int32 arrays
    of `out` too."""
    monkeypatch.setattr(feed, "PACK_WORKERS", 4)
    monkeypatch.setattr(feed, "_pool", None)
    calls = []
    pack = feed.host_pack_range_images

    def spy(clouds, cfg):
        calls.append((threading.current_thread().name, len(clouds)))
        return pack(clouds, cfg)

    monkeypatch.setattr(feed, "host_pack_range_images", spy)
    cfg = small(SENSORS[sensor]())
    scans = scans_of(cfg, 6)
    pipe = LegoLoamPipeline(cfg, device="cpu")
    got = pipe._prep_many(scans)
    assert all(name.startswith("lego-pack") for name, _ in calls)
    assert sorted(n for _, n in calls) == ([1] * 6 if sensor == "vlp32c" else [2, 2, 2])
    serial = [host_pack_range_image(s, cfg, winners=nearest_per_pixel_lexsort) for s in scans]
    for i, k in enumerate(feed.RANGE_FEED):
        want = np.stack([p[i] for p in serial])
        assert got[k].dtype == want.dtype and np.array_equal(got[k], want)
    out = {k: np.full(v.shape, -5, np.int32 if k == "rimg" else v.dtype) for k, v in got.items()}
    pipe._prep_many(scans, out=out)
    for k in feed.RANGE_FEED:
        assert np.array_equal(out[k], got[k])


def old_stage(prep, dev, timestamps=None, imu=None, odom=None):
    """What `stage_chunk` uploaded before the pinned path: each array as it
    is, uint16 widened to int32, then the timestamps, IMU windows and the
    wheel-odometry poses."""
    xs = {}
    for k, v in prep.items():
        v = np.asarray(v)
        xs[k] = torch.from_numpy(v.astype(np.int32) if v.dtype == np.uint16 else v).to(dev)
    if timestamps is not None:
        xs["ts"] = torch.as_tensor(np.asarray(timestamps, np.float32), device=dev)
    if imu is not None:
        xs["imu"] = {k: torch.from_numpy(np.asarray(imu[k], bool if k == "mask" else np.float32)).to(dev)
                     for k in ("t", "rpy", "acc", "mask")}
    if odom is not None:
        xs["odom_R"], xs["odom_t"] = (torch.from_numpy(np.array(a, np.float32)).to(dev) for a in odom)
    return xs


def leaves(xs):
    """(name, tensor) of a staged feed, the IMU windows by name."""
    for k, v in xs.items():
        if isinstance(v, dict):
            yield from ((f"{k}.{j}", t) for j, t in v.items())
        elif isinstance(v, torch.Tensor):
            yield k, v


def assert_same_feed(got, want):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.device == w.device and torch.equal(g.cpu(), w.cpu()), k


def stage_inputs(cfg, scans):
    """The three forms `stage_chunk` takes: raw clouds, a `_prep_many` dict,
    and (C, max_points, 3) points with their masks."""
    pipe = LegoLoamPipeline(cfg, device="cpu")
    pts = pipe._pack_points(scans)
    return {"raw": (scans, None), "dict": (pipe._prep_many(scans), None), "array": (pts["pts"], pts["mask"])}


@pytest.mark.parametrize("form", ["raw", "dict", "array"])
def test_stage_chunk_feeds_as_before_on_the_cpu(form):
    """Each form with timestamps, IMU windows and wheel-odometry poses goes
    up on the CPU as it did; the stager records one chunk."""
    cfg = small(vlp16(), use_imu_undistortion=True)
    cfg = dataclasses.replace(cfg, odometry=dataclasses.replace(cfg.odometry, odom_prior_mode="init"))
    scans = scans_of(cfg, 3)
    pts, masks = stage_inputs(cfg, scans)[form]
    ts = [0.1, 0.2, 0.3]
    imu = synth_imu_windows(straight_trajectory(3, speed=0.15), cfg)
    odom = (np.tile(np.eye(3), (3, 1, 1)), np.arange(9.0).reshape(3, 3))
    pipe = LegoLoamPipeline(cfg, device="cpu")
    got = pipe.stage_chunk(pts, masks, timestamps=ts, imu=imu, odom=odom)
    prep = {"pts": pts, "mask": masks} if form == "array" else pipe._prep_many(scans) if form == "raw" else pts
    assert_same_feed(got, old_stage(prep, torch.device("cpu"), ts, imu, odom))
    assert [a.dtype for a in got["odom_host"]] == [np.float32, np.float32]
    pipe.finalize()
    stage = pipe.diagnostics["stage_ms"]
    assert len(stage["pack"]) == len(stage["upload"]) == 1
    assert stage["pack"][0] > 0 and stage["upload"][0] >= 0


def test_stage_record_reaches_profile_json(tmp_path):
    """Two chunks on the CPU, one staged in the stager thread: one record
    a staged chunk in diagnostics["stage_ms"], their means in profile.json."""
    from lego_loam_torch.run import _write_profile
    from lego_loam_torch.utils.profiling import StageTimer

    cfg = small(vlp16())
    scans = scans_of(cfg, 4)
    pipe = LegoLoamPipeline(cfg, device="cpu")
    fut = pipe.stage_chunk_async(scans[:2])
    second = pipe.stage_chunk(scans[2:])
    pipe.process_chunk(fut.result())
    pipe.process_chunk(second)
    pipe.finalize()
    stage = pipe.diagnostics["stage_ms"]
    assert len(stage["pack"]) == len(stage["upload"]) == 2
    assert all(v > 0 for v in stage["pack"]) and all(v >= 0 for v in stage["upload"])
    _write_profile(str(tmp_path), StageTimer(), 4, 1.0, torch.device("cpu"), pipe)
    prof = json.loads((tmp_path / "profile.json").read_text())
    assert prof["stage_ms_per_chunk"]["chunks"] == 2
    assert prof["stage_ms_per_chunk"]["pack"] == pytest.approx(float(np.mean(stage["pack"])))


@pytest.mark.cuda
@pytest.mark.parametrize("sensor", ["vlp16", "hdl64e"])
def test_pinned_upload_equals_pageable_on_the_card(gpu, sensor):
    """Raw clouds, a `_prep_many` dict and points with masks, each staged
    three times through its set of pinned buffers: as `stage_chunk`
    returns, the tensors equal a pageable upload of the same arrays, bit
    for bit, read on another stream than the one they were staged for."""
    cfg = small(SENSORS[sensor]())
    scans = scans_of(cfg, 4)
    pipe = LegoLoamPipeline(cfg, device=gpu)
    for form, (pts, masks) in stage_inputs(cfg, scans).items():
        prep = {"pts": pts, "mask": masks} if form == "array" else pipe._prep_many(scans) if form == "raw" else pts
        want = old_stage(prep, gpu, timestamps=[0.0, 0.1, 0.2, 0.3])
        torch.cuda.default_stream(gpu).synchronize()  # the pageable copies
        for _ in range(3):
            got = pipe.stage_chunk(pts, masks, timestamps=[0.0, 0.1, 0.2, 0.3])
            with torch.cuda.stream(torch.cuda.Stream(gpu)):
                assert_same_feed(got, want)
    pipe.finalize()
    assert len(pipe.diagnostics["stage_ms"]["upload"]) == 9
    assert all(v > 0 for v in pipe.diagnostics["stage_ms"]["upload"])


@pytest.mark.cuda
def test_pinned_stage_gives_the_same_poses_on_the_card(gpu):
    """Three chunks of 4, graphed: staged by a pageable upload (tensors
    handed to `process_chunk`), through the pinned path one after the other,
    and each next chunk staged (also in the stager thread) while the device
    still runs the chunk before, queued behind a sleep: the same poses, bit
    for bit."""
    cfg = small(vlp16())
    scans = scans_of(cfg, 12)
    chunks = [scans[s:s + 4] for s in range(0, 12, 4)]

    def poses(pipe):
        pipe.finalize()
        return np.asarray(pipe.trajectory["positions"]), pipe.odom_positions, pipe.fused_positions

    ref = LegoLoamPipeline(cfg, seed=1, device=gpu)
    for ch in chunks:
        ref.process_chunk(old_stage(ref._prep_many(ch), gpu))
    want = poses(ref)
    assert ref.graph_stats["replays"] > 0

    seq = LegoLoamPipeline(cfg, seed=1, device=gpu)
    for ch in chunks:
        seq.process_chunk(seq.stage_chunk(ch))
    for a, b in zip(poses(seq), want):
        assert np.array_equal(a, b)

    for use_thread in (False, True):
        pipe = LegoLoamPipeline(cfg, seed=1, device=gpu)
        cur, overlapped = pipe.stage_chunk(chunks[0]), 0
        for c in range(3):
            torch.cuda._sleep(int(1e9))  # device time queued ahead of chunk c
            pipe.process_chunk(cur)
            if c + 1 < 3:
                nxt = pipe.stage_chunk_async(chunks[c + 1]).result() if use_thread else pipe.stage_chunk(chunks[c + 1])
                overlapped += not torch.cuda.current_stream(gpu).query()
                cur = nxt
        assert overlapped >= 1, "no chunk was staged while the one before was still running"
        for a, b in zip(poses(pipe), want):
            assert np.array_equal(a, b)
