"""The lap course of a traffic mix: `lap_trajectory(laps, straight, turn)`
in a campus world sized by one lap's perimeter (the port's `campus_run`
sizing: a building every 10 m and a pillar every 6 m, at least 14 and 22),
with `variants` noisy renders of one lap tiled across the laps (`campus_
run.Course`'s tiling: frame 0 of every later lap is the wrap sweep)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .render import render_swept
from .synthetic import campus_world, lap_trajectory

SPEED = 0.12  # metres a frame of lap_trajectory


@dataclasses.dataclass
class LapCourse:
    poses: list
    lap_len: int
    variants: list  # variants[v][k]: frame k of one lap (k = lap_len: the wrap sweep)

    def scan(self, i: int) -> np.ndarray:
        lap, k = divmod(i, self.lap_len)
        var = self.variants[lap % len(self.variants)]
        return var[self.lap_len] if lap > 0 and k == 0 else var[k]

    def truth(self, frames) -> np.ndarray:
        return np.stack([self.poses[i][1] for i in frames])

    def __len__(self) -> int:
        return len(self.poses)


def world_of(straight: int, turn: int):
    lap = lap_trajectory(1, straight, turn)
    perimeter = len(lap) * SPEED
    return campus_world(lap, n_buildings=max(14, int(perimeter / 10)), n_pillars=max(22, int(perimeter / 6)))


def build(mix: dict, cfg, seed: int, device) -> LapCourse:
    """The mix's course for `cfg`'s sensor: its renders drawn on `device`
    from a generator seeded with `seed` (the same seed, the same scans)."""
    poses = lap_trajectory(mix["laps"], mix["straight"], mix["turn"])
    lap_len = len(poses) // mix["laps"]
    world = world_of(mix["straight"], mix["turn"])
    jobs = [(poses[i - 1] if i else poses[i], poses[i % len(poses)]) for i in range(lap_len + 1)]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    variants = [render_swept(jobs, cfg, world, gen, mix["noise_m"]) for _ in range(mix["render_variants"])]
    return LapCourse(poses=poses, lap_len=lap_len, variants=variants)
