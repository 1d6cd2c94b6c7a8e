"""The yardstick's arithmetic, frozen with the benchmark: the H100's
data-sheet peaks, the bytes kernel K1 must move, and the union of device
intervals from which the device's busy time and its idle gaps are taken.

Peaks are NVIDIA's H100 SXM data sheet at its 700 W limit: 3.35 TB/s of
HBM3 and 67 TFLOP/s of float32 outside the tensor cores. A run prints the
card's power limit beside every share (`device.power_limit`).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

# K1 (connected components, `cc_label_prop`): per pixel it reads the
# candidate mask and the right and down link masks (1 byte each), writes
# the int32 label (4 bytes) and keeps 2 bytes of row state: 9 bytes, for
# every pixel whatever the data.
K1_BYTES_PER_PIXEL = 9


def k1_bytes(rows: int, cols: int, scans: int) -> int:
    """Bytes K1 must move for `scans` scans of rows x cols pixels."""
    return K1_BYTES_PER_PIXEL * rows * cols * scans


def union(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy(intervals) -> float:
    """Length of the union of the intervals."""
    return sum(e - s for s, e in union(intervals))


def gaps(intervals) -> list:
    """(start, end) of each idle gap between the union's intervals."""
    u = union(intervals)
    return [(a[1], b[0]) for a, b in zip(u, u[1:])]
