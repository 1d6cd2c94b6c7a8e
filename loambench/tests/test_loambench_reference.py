"""The plain reference (`loambench/reference/lego`) against the port's CPU
path at a small size: on the CPU both run the same plain twins with host
branching, so every output must agree bit for bit. The check's own
mechanics (a snapshot of the port's state loaded into the reference,
the store's rows taken from the final store) are held the same way."""

import types

import numpy as np
import torch

from lego_loam_torch.config import LegoLoamConfig
from lego_loam_torch.pipeline import LegoLoamPipeline
from loambench import check, harness
from loambench.drivers import replay
from loambench.course import lap
from loambench.reference.lego.config import LegoLoamConfig as RefConfig

SMALL = {"mapping": {"max_keyframes": 64, "max_submap_corner": 4096, "max_submap_surf": 8192,
                     "history_keyframe_search_num": 4, "loop_icp_src_stride": 4, "posegraph_anchor_stride": 8}}
CPU = torch.device("cpu")


def configs():
    entry = harness.config_entry(harness.load_bench(), "vlp16")
    return harness.lego_config(LegoLoamConfig, entry, SMALL), harness.lego_config(RefConfig, entry, SMALL)


def course():
    return lap.build({"laps": 1, "straight": 6, "turn": 3, "render_variants": 1, "noise_m": 0.01},
                     configs()[0], seed=2 ** 32 + 3, device=CPU)


def logs(pipe):
    return {k: torch.stack(pipe._log[k]).numpy() for k in ("odom_t", "map_R", "map_t")}


def test_reference_follows_the_port_bit_for_bit_on_the_cpu():
    torch.set_num_threads(1)
    cfg, cfg_ref = configs()
    c = course()
    port = LegoLoamPipeline(cfg, seed=5, device=CPU)
    ref = check.reference_pipeline(cfg_ref, 5, CPU)
    scans = [c.scan(i) for i in range(10)]
    for p in (port, ref):
        p.process_chunk(scans[:4])
        p.process_chunk(scans[4:8])
        p.process_chunk(scans[8:])
    a, b = logs(port), logs(ref)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    for (name, x), (_, y) in zip(check.leaves(port.bstate), check.leaves(ref.bstate)):
        assert torch.equal(x, y), name
    for (name, x), (_, y) in zip(check.leaves(port.fstate), check.leaves(ref.fstate)):
        assert torch.equal(x, y), name


def test_the_check_follows_the_port_from_a_snapshot():
    """Snapshots before frames inside a chunk, the port runs on, the
    reference restarts from each with the final store's clouds: no gap;
    and one of the port's map poses moved shows the gap."""
    torch.set_num_threads(1)
    cfg, cfg_ref = configs()
    c = course()
    port = LegoLoamPipeline(cfg, seed=7, device=CPU)
    frames = replay.FrameSnapshots(port, 4, lambda k: [4 * k + 1, 4 * k + 3])
    chunk = lambda k: [c.scan(i) for i in range(4 * k, 4 * k + 4)]  # noqa: E731
    port.process_chunk(chunk(0))
    frames.on = True
    port.process_chunk(chunk(1))
    frames.on = False
    port.process_chunk(chunk(2))
    port.finalize()
    assert sorted(frames.snaps) == [5, 7]
    log = check.port_log(port)
    clouds = {k: getattr(port.bstate, k) for k in check.STORE_CLOUDS}
    r = types.SimpleNamespace(cfg_ref=cfg_ref, pipe_seed=7, device=CPU, control=False, free=lambda: None)
    run = lambda ref, scans: ref.process_chunk(scans)  # noqa: E731
    one = lambda f: [c.scan(f)]  # noqa: E731
    readings, control = check.follow(r, frames.snaps, clouds, log, one, run)
    assert control is None
    assert set(readings) == {f"{name}_{stat}_{unit}" for _, name, unit in check.NUMBERS for stat, _ in check.STATS}
    assert all(v == 0.0 for v in readings.values()), readings
    log["map_t"][7] += [0.0, 0.02, 0.0]
    readings, _ = check.follow(r, frames.snaps, clouds, log, one, run)
    assert abs(readings["map_pos_gap_max_m"] - 0.02) < 1e-9
    assert abs(readings["map_pos_gap_p80_m"] - 0.8 * 0.02) < 1e-9


def test_drawn_frames_lie_one_in_each_part_of_the_chunk():
    for seed in (0, 7, 2 ** 33 + 5):
        for k in range(3):
            got = replay.drawn_frames(seed, k, 32, 2)
            assert got == replay.drawn_frames(seed, k, 32, 2)
            assert 32 * k <= got[0] < 32 * k + 16 <= got[1] < 32 * (k + 1)
