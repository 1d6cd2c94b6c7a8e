"""KITTI velodyne .bin loader — the reference's offline data source
(a numpy copy of `lego_loam_tpu/io/kitti.py`, which the port cannot import
without jax).

≙ `KittiLoader` + `offlineKittiService` (`imageProjection.h:127-219`,
`imageProjection.cpp:224-299`): reads `NNNNNN.bin` float32 (x, y, z,
reflectance) scans and the sequence `times.txt`, replacing the Twist-triggered
replay loop with a plain iterator.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np


def read_bin(path: str) -> np.ndarray:
    """(N, 4) float32: x, y, z, reflectance."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def read_times(seq_dir: str) -> Optional[np.ndarray]:
    p = os.path.join(seq_dir, "times.txt")
    if not os.path.isfile(p):
        return None
    return np.loadtxt(p)


class KittiSequence:
    """A KITTI odometry sequence directory (velodyne/*.bin [+ times.txt])."""

    def __init__(self, seq_dir: str):
        self.seq_dir = seq_dir
        vel = os.path.join(seq_dir, "velodyne")
        self.files = sorted(
            os.path.join(vel, f) for f in os.listdir(vel) if f.endswith(".bin")
        )
        self.times = read_times(seq_dir)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int) -> np.ndarray:
        return read_bin(self.files[i])

    def scans(self) -> Iterator[tuple[np.ndarray, float]]:
        for i, f in enumerate(self.files):
            t = float(self.times[i]) if self.times is not None else i * 0.1
            yield read_bin(f)[:, :3], t
