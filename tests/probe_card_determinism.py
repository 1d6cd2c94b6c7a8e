"""Probe (on an NVIDIA GPU; not a test): are runs of the per-scan path
reproducible on the card?

    python3 tests/probe_card_determinism.py

Renders chip_smoke.py's CLI course (64 swept scans of a straight drive at
0.2 m a scan, `vlp16()` at full width) and runs it three times through
`LegoLoamPipeline.run`, first with the voxel centroids summed as the port
sums them (`torch.segment_reduce` over the sorted runs), then with the
same sums through a float `index_add_` (atomics, as before), and prints
how far the runs' map positions lie apart, their map ATE and scans/s.
"""

import gc
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lego_loam_torch.config import vlp16  # noqa: E402
from lego_loam_torch.io.synthetic import straight_trajectory, swept_scan_sequence  # noqa: E402
from lego_loam_torch.pipeline import LegoLoamPipeline  # noqa: E402


def atomic_segment_sum(data, reduce, lengths, axis=0, unsafe=False):
    """`torch.segment_reduce(..., "sum")` through a float index_add_."""
    index = torch.repeat_interleave(torch.arange(len(lengths), device=data.device), lengths)
    return torch.zeros((len(lengths),) + data.shape[1:], dtype=data.dtype, device=data.device).index_add_(0, index, data)


def runs(name, cfg, scans, truth, n=3):
    out = []
    for k in range(n):
        pipe = LegoLoamPipeline(cfg)
        t0 = time.perf_counter()
        pos = np.asarray(pipe.run(scans)["map_positions"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ate = float(np.sqrt(np.mean(np.sum((pos - truth) ** 2, axis=1))))
        print(f"{name} run {k}: {len(scans) / dt:.3f} scans/s, map ATE {ate:.5f} m", flush=True)
        out.append(pos)
        del pipe
        gc.collect()
    for k in range(1, n):
        d = np.abs(out[k] - out[0]).max(axis=1)
        first = int(np.argmax(d > 0)) if d.max() > 0 else None
        print(f"{name}: run {k} against run 0: max |diff| {d.max():.4e} m, first frame apart {first}", flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    cfg = vlp16()
    poses = straight_trajectory(64, speed=0.2)
    scans = swept_scan_sequence(poses, cfg, noise=0.005, seed=300)
    truth = np.stack([t for _, t in poses])
    seg = runs("segment_reduce", cfg, scans, truth)
    segment_reduce = torch.segment_reduce
    torch.segment_reduce = atomic_segment_sum
    try:
        atomic = runs("index_add_", cfg, scans, truth)
    finally:
        torch.segment_reduce = segment_reduce
    print(f"segment_reduce run 0 against index_add_ run 0: max |diff| {np.abs(seg[0] - atomic[0]).max():.4e} m")


if __name__ == "__main__":
    main()
