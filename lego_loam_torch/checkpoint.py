"""Full-pipeline checkpoint/resume (port of `lego_loam_tpu/checkpoint.py`).

The reference's only persistence is the /save_map PCD dump + HighDense map
reload (`mapOptmization.cpp:344-434`, `publishHighDenseMap.cpp`) — a crash
restarts from an empty map (SURVEY.md §5). Here the complete SLAM state
(front-end odometry state, keyframe store, loop factors, frame counter)
round-trips through one compressed npz, so a run can resume mid-trajectory.

The layout is the JAX package's, so a file saved by either package loads
into the other: `f0, f1, ...` are the odometry state's leaves and `b0, ...`
the backend state's, in field-declaration order with nested states
(`FeatureCloud`, `MapState`) expanded in place, which is the order
`jax.tree.flatten` gives for the reference's flax structs; `__meta__` is
the JSON of `frame_idx` and the loop factors. Map products (PCDs,
trajectory) are separate, via `save_artifacts` + `mapproducts.save_map`.

A file holds whole leaves whatever the layout that saved it: `save`
gathers a store in row blocks (every rank calls it; rank 0 writes), and
`load` reads the whole arrays and keeps this rank's block under the
layout of the state it replaces, so a run resumes on another number of
ranks (the reference's reshard onto the loading process's mesh).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .distributed import all_rows, assign_state, is_writer, laid_out_as
from .pipeline import LegoLoamPipeline, LoopFactor
from .types import map_leaves, named_leaves


def _flatten(prefix, state) -> dict:
    """Each leaf whole, under its key (a leaf in row blocks is gathered)."""
    return {f"{prefix}{i}": all_rows(leaf) for i, (_, leaf) in enumerate(named_leaves(state))}


def save(pipe: LegoLoamPipeline, path: str):
    """Write the pipeline's state to `path` (numpy appends `.npz` when the
    name lacks it). In a process group every rank calls it and rank 0
    writes."""
    leaves = {**_flatten("f", pipe.fstate), **_flatten("b", pipe.bstate)}
    if not is_writer():
        return
    meta = {
        "frame_idx": pipe.frame_idx,
        "loop_factors": [
            {"i": f.i, "j": f.j, "R": f.R.tolist(), "t": f.t.tolist(), "fitness": f.fitness}
            for f in pipe.loop_factors
        ],
    }
    np.savez_compressed(path, __meta__=json.dumps(meta), **{k: v.detach().cpu().numpy() for k, v in leaves.items()})


def load(pipe: LegoLoamPipeline, path: str) -> LegoLoamPipeline:
    """Restore state saved by `save` (by either package, on any number of
    ranks) into a freshly constructed pipeline of the same config, on the
    pipeline's device, each leaf laid out as the pipeline's own (this
    rank's rows of a leaf in row blocks), written in place into the
    pipeline's state tensors (a captured frame step reads them there).
    Raises ValueError where a leaf's
    shape or dtype differs from the pipeline's. The port keeps its frame
    numbers on the host, so there is no device frame counter to re-sync
    (the reference's `_idx_dev`)."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))

        def unflatten(prefix, template):
            index = {name: i for i, (name, _) in enumerate(named_leaves(template))}

            def read(name, leaf):
                key = f"{prefix}{index[name]}"
                a = data[key]
                want = str(leaf.dtype).removeprefix("torch.")
                if a.shape != tuple(leaf.shape) or a.dtype != np.dtype(want):
                    raise ValueError(f"{path}: {key} is {a.dtype}{list(a.shape)}, the pipeline's is "
                                     f"{want}{list(leaf.shape)}")
                return torch.from_numpy(np.array(a)).to(pipe.device)

            return laid_out_as(template, map_leaves(template, read))

        assign_state(pipe.fstate, unflatten("f", pipe.fstate))
        assign_state(pipe.bstate, unflatten("b", pipe.bstate))
    pipe.frame_idx = int(meta["frame_idx"])
    pipe.loop_factors = [
        LoopFactor(
            i=int(f["i"]), j=int(f["j"]), R=np.asarray(f["R"], np.float32),
            t=np.asarray(f["t"], np.float32), fitness=float(f["fitness"]),
        )
        for f in meta["loop_factors"]
    ]
    pipe._sync_loop_buf()  # the device loop-factor buffer mirrors the host list
    return pipe
