"""Per-stage timing spans and throughput counters (port of
`lego_loam_tpu/utils/profiling.py`).

≙ the reference's hand-rolled chrono instrumentation (`TicToc`
include/lego_loam/tictoc.h:12-59; per-stage running means
imageProjection.cpp:200-221, featureAssociation.cpp:2798-2816,
mapOptmization.cpp:1877-1908), and the span marks that the frame steps
take on the device (`span_mark`).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch

from .. import cuda

# The step boundaries a mark records, in the order of `csrc/mark.cu`'s
# kernels (lego_span_<boundary>).
BOUNDARIES = ("front_end", "odometry", "mapping", "step_end")


def synchronize(t):
    """Wait for the queued work of tensor t's CUDA device (nothing for a CPU
    tensor, whose values are ready when it is returned)."""
    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def span_mark(out, slot: int, boundary: str):
    """Write the time at `boundary` (one of BOUNDARIES) into out[slot], an
    int64 tensor, in nanoseconds. On a CUDA device it is a kernel queued in
    stream order (the card's %globaltimer where it runs, also inside a
    captured graph, at every replay; no host read); on the CPU, which runs
    each operation when it is called, the host's `perf_counter_ns`."""
    if out.device.type != "cuda":
        out[slot] = time.perf_counter_ns()
        return
    err = cuda.library("mark").span_mark_launch(BOUNDARIES.index(boundary), out.data_ptr(), slot,
                                               cuda.stream_ptr(out.device))
    cuda.check(err, f"span mark {boundary} launch")


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
