"""A bounded device trace: `torch.profiler` over a sub-window of the run,
read back as plain intervals. Each device operation (kernels, copies and
sets) is (name, start, end) in seconds on the profiler's clock, and so is
each of the benchmark's own host spans (`Spans` with profiler marks, names
"loambench.<span>"). The raw events are read once, without the profiler's
per-name tables, which take minutes over the graphed step's ~47,000
kernels a scan."""

from __future__ import annotations

import torch
from torch.profiler import ProfilerActivity, profile

COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


class DeviceTrace:
    """The profiler over one sub-window: `start()` before its first call,
    `stop()` after its last (and a synchronize), then `ops` and `marks`."""

    def __init__(self):
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.ops: list = []
        self.marks: list = []

    def start(self):
        self.prof.start()
        return self

    def stop(self):
        self.prof.stop()
        self._read()

    def _read(self):
        for e in self.prof.profiler.kineto_results.events():
            start, dur = e.start_ns(), e.duration_ns()
            iv = (e.name(), start * 1e-9, (start + dur) * 1e-9)
            mark = e.name().startswith("loambench.")
            if e.device_type() == torch.autograd.DeviceType.CUDA and not mark and not e.is_user_annotation():
                self.ops.append(iv)
            elif mark and e.device_type() == torch.autograd.DeviceType.CPU:
                self.marks.append((e.name()[len("loambench."):], iv[1], iv[2]))


def is_kernel(name: str) -> bool:
    return not name.startswith(COPY_PREFIXES)


def summary(ops: list, marks: list, top: int = 10) -> dict:
    """The breakdown of a trace: the device operations that took the most
    time by name, and the longest idle gaps labelled by the benchmark span
    that was open on the host when each began ("none" outside them)."""
    from .roofline import gaps

    by_name: dict = {}
    for name, s, e in ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    longest = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    labelled = []
    for s, e in sorted(gaps([(s, e) for _, s, e in ops]), key=lambda g: g[0] - g[1])[:top]:
        open_ = [m for m in marks if m[1] <= s < m[2]]
        labelled.append([min(open_, key=lambda m: m[2] - m[1])[0] if open_ else "none", e - s])
    return {"device_ops": [[n, t] for n, t in longest], "idle_gaps": labelled}
