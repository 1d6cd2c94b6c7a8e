"""Replay of a recorded drive in a closed loop, as a user maps a log: the
course's scans in chunks, each chunk packed and uploaded one ahead in the
pipeline's stager thread (`stage_chunk_async`) while the previous one runs
(`process_chunk`), as `lego_loam_torch/bench.py` times its courses.

Set-up: the course rendered on the card from the seed, a pipeline built
with `warmup_loop_closure`, and the mix's first `setup_chunks` chunks run
(the CUDA graphs are captured there), the device synchronized. The window
then dispatches chunks until `--seconds` have passed on the host clock and
ends with a synchronize: scans/s is every scan of the window over the
window's time. A course that runs out fails the run.

With --trace 1 one chunk of the window (`trace_chunk` after the window's
start) runs under the profiler, after a synchronize, and ends with one;
the window then runs on for as long as that chunk and its reading took,
so the host spans see a whole window of untraced chunks.

The check: in every chunk of the window, `check_frames` frames drawn
from the seed, one in each equal part of the chunk (`drawn_frames`); the
port's state is cloned before each one's front step (`FrameSnapshots`,
queued on the device, no wait), and after the window the reference runs
each of those frames again from its clone (see `check.py`).
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from .. import check
from ..course import lap
from ..trace import DeviceTrace


def _sites():
    from lego_loam_torch import cuda as kcuda

    return collections.Counter(kcuda.SITES)


def drawn_frames(seed: int, chunk_idx: int, C: int, n: int) -> list:
    """The frames of chunk `chunk_idx` (C frames) that the check runs again:
    one drawn from the seed in each of n equal parts of the chunk."""
    rng = np.random.default_rng([abs(seed), chunk_idx])
    return [chunk_idx * C + i * C // n + int(rng.integers(C // n)) for i in range(n)]


class FrameSnapshots:
    """Clones of the pipeline's state before the front step of the frames
    that `want(chunk_idx)` names, taken where the pipeline runs each step
    (its `_step`, called once per step of each frame; the port offers no
    other place between the frames of a chunk). Each chunk's clones are
    taken while `on`."""

    def __init__(self, pipe, C: int, want):
        self.pipe, self.C, self.want = pipe, C, want
        self.snaps: dict = {}
        self.on = False
        self._run = pipe._step
        self._frames: set = set()
        self._c = 0
        pipe._step = self.step

    def step(self, kind, key, fn, x):
        p = self.pipe
        if kind == "prepass":
            self._c = 0
            self._frames = set(self.want(p.frame_idx // self.C)) if self.on else set()
        elif kind == "front":
            f = p.frame_idx + self._c
            if f in self._frames:
                self.snaps[f] = check.snapshot(p, f)
            self._c += 1
        return self._run(kind, key, fn, x)


def run(r) -> dict:
    from lego_loam_torch.pipeline import LegoLoamPipeline

    mix, cfg, dev = r.mix, r.cfg, r.device
    C = mix["chunk"]
    if cfg.mapping.mapping_frequency_divider != 1:
        raise ValueError("the check pairs each frame with its map pose: every frame has to be mapped")
    course = lap.build(mix, cfg, r.seed, dev)
    r.log(f"course: {len(course)} frames, {len(course.variants)} renders of a {course.lap_len}-frame lap")
    n_chunks = len(course) // C
    chunk_scans = lambda c: [course.scan(i) for i in range(c * C, (c + 1) * C)]  # noqa: E731
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    pipe = LegoLoamPipeline(cfg, seed=r.pipe_seed, device=dev)
    frames = FrameSnapshots(pipe, C, lambda c: drawn_frames(r.seed, c, C, mix["check_frames"]))
    pipe.warmup_loop_closure()
    for c in range(mix["setup_chunks"]):
        pipe.process_chunk(pipe.stage_chunk(chunk_scans(c)))
    r.sync()
    setup_s = time.perf_counter() - r.t_start
    r.log(f"set-up {setup_s:.3f} s: {len(course)} frames rendered, {mix['setup_chunks']} chunks run, "
          f"graphs {dict(pipe.graph_stats)}")

    c0 = mix["setup_chunks"]
    traced = c0 + mix["trace_chunk"] if r.trace else -1
    trace, paused = None, 0.0
    sites0 = _sites()
    frames.on = True
    t0 = time.perf_counter()
    fut = pipe.stage_chunk_async(chunk_scans(c0))
    c = c0
    while True:
        if c >= n_chunks:
            raise RuntimeError(f"the course ran out after {c} chunks inside a {r.seconds} s window")
        with r.spans("stage_wait"):
            cur = fut.result()
        fut = pipe.stage_chunk_async(chunk_scans(c + 1)) if c + 1 < n_chunks else None
        if c == traced:
            r.sync()
            r.spans.profiler_marks = True
            trace = DeviceTrace().start()
            trace_t = time.perf_counter()
        with r.spans("process_chunk" if c != traced else "traced_chunk"):
            pipe.process_chunk(cur)
        if c == traced:
            r.sync()
            trace.stop()
            r.spans.profiler_marks = False
            paused = time.perf_counter() - trace_t
            r.log(f"traced chunk {c}: {len(trace.ops)} device operations, {paused:.1f} s with the trace read")
        c += 1
        if time.perf_counter() - t0 - paused >= r.seconds:
            break
    r.sync()
    window_s = time.perf_counter() - t0
    frames.on = False
    if fut is not None:
        fut.result()
    n_win = (c - c0) * C
    sites = _sites() - sites0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    r.log(f"window {window_s:.3f} s: {c - c0} chunks, {n_win} scans")

    # What the check needs from the port, then the port freed.
    pipe.finalize()
    port = check.port_log(pipe)
    failed = int((~np.isfinite(port["map_t"][c0 * C: c * C]).all(axis=1)).sum())
    gt = course.truth(range(c * C))
    info = {"loop_attempts": sum(1 for d in pipe.loop_diag if "icp_fitness" in d),
            "loop_closures": len(pipe.loop_factors), "graph_stats": dict(pipe.graph_stats),
            "map_ate_m": float(np.sqrt(np.mean(np.sum((port["map_t"] - gt) ** 2, 1))))}
    clouds = {k: getattr(pipe.bstate, k) for k in check.STORE_CLOUDS}
    snaps = frames.snaps
    del pipe, fut, cur, frames
    r.free()

    expected = sum(len(drawn_frames(r.seed, k, C, mix["check_frames"])) for k in range(c0, c))
    if len(snaps) != expected:
        raise RuntimeError(f"{len(snaps)} of the {expected} frames drawn for the check were cloned: "
                           "the pipeline no longer runs a step per frame where the benchmark looks for it")
    t_ref = time.perf_counter()
    readings, control = check.follow(r, snaps, clouds, port, lambda f: [course.scan(f)],
                                     lambda ref, scans: ref.process_chunk(scans))
    r.log(f"reference: {len(snaps)} frames in {time.perf_counter() - t_ref:.1f} s")
    return {"setup_s": setup_s, "window_s": window_s, "scans": n_win, "attempted": n_win, "failed": failed,
            "sites": dict(sites), "trace": trace, "trace_scans": C, "rows": cfg.laser.num_vertical_scans,
            "cols": cfg.laser.num_horizontal_scans, "chunk": C, "memory_peak_bytes": peak,
            "readings": readings, "control": control, "info": info}
