"""Per-stage timing spans and throughput counters (port of
`lego_loam_tpu/utils/profiling.py`).

≙ the reference's hand-rolled chrono instrumentation (`TicToc`
include/lego_loam/tictoc.h:12-59; per-stage running means
imageProjection.cpp:200-221, featureAssociation.cpp:2798-2816,
mapOptmization.cpp:1877-1908) plus a torch.profiler hook for device traces.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


def synchronize(t):
    """Wait for the queued work of tensor t's CUDA device (nothing for a CPU
    tensor, whose values are ready when it is returned)."""
    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class StageTimer:
    """Running-average wall-clock spans per named stage. With sync, a span
    waits at its end for the device of its `sync_on` tensor, so the span
    covers the device work queued inside it."""

    def __init__(self, sync: bool = False):
        self.sync = sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.last: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        yield
        if self.sync:
            synchronize(sync_on)
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1
        self.last[name] = dt

    def mean_ms(self, name: str) -> float:
        c = self.counts.get(name, 0)
        return 1e3 * self.totals[name] / c if c else 0.0

    def hz(self, name: str) -> float:
        m = self.mean_ms(name)
        return 1000.0 / m if m > 0 else 0.0

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            lines.append(
                f"{name:>24s}: {self.mean_ms(name):8.2f} ms/frame "
                f"({self.hz(name):7.1f} Hz, n={self.counts[name]})"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """torch.profiler over a region (the CPU, and the GPU where one is
    visible), written as a Chrome trace `trace.json` into log_dir (view it
    in chrome://tracing or Perfetto). Yields the profiler, or None without
    log_dir."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
