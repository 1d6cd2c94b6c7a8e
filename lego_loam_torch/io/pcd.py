"""Minimal PCD reader/writer (replaces pcl::io::savePCDFile / loadPCDFile);
a numpy copy of `lego_loam_tpu/io/pcd.py`, which the port cannot import
without jax.

Covers the formats the reference actually produces/consumes
(`mapOptmization.cpp:344-434`, `publishHighDenseMap.cpp:13-67`): XYZ /
XYZI clouds in ascii or binary little-endian layout.
"""

from __future__ import annotations

import os

import numpy as np

_HEADER = """# .PCD v0.7 - Point Cloud Data file format
VERSION 0.7
FIELDS {fields}
SIZE {sizes}
TYPE {types}
COUNT {counts}
WIDTH {width}
HEIGHT 1
VIEWPOINT 0 0 0 1 0 0 0
POINTS {width}
DATA {data}
"""


def save_pcd(path: str, xyz: np.ndarray, intensity=None, binary: bool = True):
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    if intensity is not None:
        fields, sizes, types, counts = "x y z intensity", "4 4 4 4", "F F F F", "1 1 1 1"
        data = np.concatenate(
            [xyz, np.asarray(intensity, np.float32).reshape(-1, 1)], axis=1
        )
    else:
        fields, sizes, types, counts = "x y z", "4 4 4", "F F F", "1 1 1"
        data = xyz
    hdr = _HEADER.format(
        fields=fields, sizes=sizes, types=types, counts=counts,
        width=n, data="binary" if binary else "ascii",
    )
    with open(path, "wb") as f:
        f.write(hdr.encode())
        if binary:
            f.write(np.ascontiguousarray(data, np.float32).tobytes())
        else:
            np.savetxt(f, data, fmt="%.6f")


def load_pcd(path: str):
    """Returns (xyz (N,3), intensity (N,) or None)."""
    with open(path, "rb") as f:
        header = {}
        fields = []
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            if line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key] = val
            if key == "FIELDS":
                fields = val.split()
            if key == "DATA":
                mode = val
                break
        n = int(header["POINTS"])
        ncols = len(fields)
        if mode == "binary":
            raw = np.frombuffer(f.read(n * ncols * 4), np.float32).reshape(n, ncols)
        else:
            raw = np.loadtxt(f, dtype=np.float32, max_rows=n).reshape(n, ncols)
    ix = [fields.index(c) for c in ("x", "y", "z")]
    xyz = raw[:, ix]
    inten = raw[:, fields.index("intensity")] if "intensity" in fields else None
    return xyz, inten
