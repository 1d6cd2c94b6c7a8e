"""The benchmark's frozen course against the port's: the copied renderer
bit for bit, the device renderer against the copy, and the lap tiling."""

import dataclasses

import numpy as np
import pytest
import torch

from loambench.course import lap, render, synthetic
from lego_loam_torch.config import hdl64e, vlp16
from lego_loam_torch.io import synthetic as port_synthetic


@pytest.mark.parametrize("preset", [vlp16, hdl64e])
def test_copied_renderer_is_the_ports_bit_for_bit(preset):
    cfg = preset()
    poses = synthetic.lap_trajectory(1, 20, 5)
    port_poses = port_synthetic.lap_trajectory(1, 20, 5)
    world = synthetic.campus_world(poses, n_buildings=14, n_pillars=22)
    port_world = port_synthetic.campus_world(port_poses, n_buildings=14, n_pillars=22)
    assert dataclasses.astuple(world) == dataclasses.astuple(port_world)
    for i, seed in ((0, 5), (1, 2 ** 31 + 7), (22, 123)):
        a = synthetic.render_scan_swept(poses[i - 1] if i else poses[i], poses[i], cfg, world, noise=0.01, seed=seed % 2 ** 32)
        b = port_synthetic.render_scan_swept(port_poses[i - 1] if i else port_poses[i], port_poses[i], cfg, port_world,
                                             noise=0.01, seed=seed % 2 ** 32)
        assert np.array_equal(a, b, equal_nan=True)


def test_device_renderer_matches_the_copy_without_noise():
    cfg = vlp16()
    poses = synthetic.lap_trajectory(1, 20, 5)
    world = lap.world_of(20, 5)
    jobs = [(poses[i - 1] if i else poses[i], poses[i]) for i in (0, 1, 21, 23)]
    got = render.render_swept(jobs, cfg, world, batch=3)
    for (p0, p1), g in zip(jobs, got):
        want = synthetic.render_scan_swept(p0, p1, cfg, world)
        assert g.shape == want.shape and g.dtype == np.float32
        assert np.array_equal(np.isnan(g), np.isnan(want))
        assert np.nanmax(np.abs(g - want)) <= 1e-6


def test_device_renderer_noise_follows_the_generator():
    cfg = vlp16()
    poses = synthetic.lap_trajectory(1, 20, 5)
    world = lap.world_of(20, 5)
    jobs = [(poses[0], poses[0]), (poses[0], poses[1])]

    def draw(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return render.render_swept(jobs, cfg, world, g, noise=0.01)

    a, b, c = draw(2 ** 33 + 1), draw(2 ** 33 + 1), draw(2 ** 33 + 2)
    assert all(np.array_equal(x, y, equal_nan=True) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1], equal_nan=True)
    clean = render.render_swept(jobs, cfg, world)
    hit = ~np.isnan(clean[1]).any(1) & ~np.isnan(a[1]).any(1)
    d = np.linalg.norm(a[1][hit], axis=1) - np.linalg.norm(clean[1][hit], axis=1)
    assert 0.008 < d.std() < 0.012


def test_lap_tiling_wraps_with_the_sweep_into_the_next_lap():
    mix = {"laps": 3, "straight": 4, "turn": 2, "render_variants": 2, "noise_m": 0.01}
    course = lap.build(mix, vlp16(), seed=9, device=torch.device("cpu"))
    L = course.lap_len
    assert L == 24 and len(course) == 3 * L and all(len(v) == L + 1 for v in course.variants)
    assert course.scan(0) is course.variants[0][0]
    assert course.scan(L) is course.variants[1][L]  # lap 2 starts with the wrap sweep
    assert course.scan(L + 1) is course.variants[1][1]
    assert course.scan(2 * L + 3) is course.variants[0][3]
    np.testing.assert_allclose(course.truth([0, L]), np.zeros((2, 3)), atol=1e-9)
