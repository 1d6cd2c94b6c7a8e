"""The pipeline's frame steps captured as CUDA graphs and replayed.

A step is a function of a dict of input tensors that reads the pipeline's
state, writes it in place and returns a dict of output tensors. `StepGraphs`
runs each kind of step (keyed by what changes its shapes or branches) once
eagerly, which creates the libraries' handles, the kernels' set-up and the
allocator's blocks, then captures it at its next use and from then on
replays it: the inputs are copied into the graph's own input buffers
(device to device), the graph runs, and its output buffers hold the
outputs until the next replay of the same step.

The graph reads and writes the state tensors it was captured with. Before a
replay the state's tensors are compared with those (`data_ptr`); where a
caller replaced one, the step is captured again and the recapture counted,
never replayed against stale buffers. A capture that fails raises.
"""

from __future__ import annotations

import time
import traceback
from pathlib import Path

import torch

from . import cuda
from .types import named_leaves


def failing_op(error: BaseException) -> str:
    """Where a failed capture stopped: the first error of the chain (the
    operation that broke the capture; ending the capture raises after it)
    and the innermost line of this package that ran it."""
    first = error
    while first.__context__ is not None:
        first = first.__context__
    package = Path(__file__).resolve().parent
    frames = [f for f in traceback.extract_tb(first.__traceback__) if Path(f.filename).resolve().is_relative_to(package)]
    where = ""
    if frames:
        f = frames[-1]
        where = f" at {Path(f.filename).resolve().relative_to(package.parent)}:{f.lineno} ({f.name}): {f.line}"
    return f"{type(first).__name__}: {first}{where}"


def state_ptrs(states) -> tuple:
    """The addresses of every tensor leaf of the given states."""
    return tuple(leaf.data_ptr() for s in states for _, leaf in named_leaves(s))


class CapturedStep:
    """One step captured into a CUDA graph with its own input buffers (a
    copy of `x`), output buffers and memory pool, and the kernel launches
    it holds (counted at each replay)."""

    def __init__(self, name: str, fn, x: dict, states):
        self.inputs = {k: v.clone() for k, v in x.items()}
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with cuda.capturing() as self.launches:
                # thread_local: a stager thread may upload the next chunk meanwhile
                with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                    self.outputs = fn(self.inputs)
        except Exception as e:
            raise RuntimeError(f"capturing the pipeline's {name} step as a CUDA graph failed: {failing_op(e)}") from e
        self.seconds = time.perf_counter() - t0
        self.ptrs = state_ptrs(states)

    def replay(self, x: dict) -> dict:
        for k, v in x.items():
            dst = self.inputs[k]
            if dst is not v:
                dst.copy_(v)
        self.graph.replay()
        cuda.add(self.launches)
        return self.outputs


class StepGraphs:
    """The captured steps of one pipeline and their counts: captures,
    recaptures (state replaced since the capture), replays, and the
    seconds spent capturing."""

    def __init__(self):
        self.steps: dict = {}
        self.warm: set = set()
        self.stats = {"captures": 0, "recaptures": 0, "replays": 0, "capture_s": 0.0}

    def run(self, kind: str, key, fn, x: dict, states) -> dict:
        k = (kind, key)
        step = self.steps.get(k)
        if step is None and k not in self.warm:
            self.warm.add(k)
            return fn(x)
        if step is not None and step.ptrs != state_ptrs(states):
            self.stats["recaptures"] += 1
            step = None
        if step is None:
            step = self.steps[k] = CapturedStep(f"{kind} {key}", fn, x, states)
            self.stats["captures"] += 1
            self.stats["capture_s"] += step.seconds
        self.stats["replays"] += 1
        return step.replay(x)
