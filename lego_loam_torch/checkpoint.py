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
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .pipeline import LegoLoamPipeline, LoopFactor


def _leaves(state) -> list:
    out = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        out.extend(_leaves(v) if dataclasses.is_dataclass(v) else [v])
    return out


def _rebuild(template, leaves):
    """`template`'s dataclass tree with its tensors taken in order from the
    iterator `leaves`."""
    kw = {}
    for f in dataclasses.fields(template):
        v = getattr(template, f.name)
        kw[f.name] = _rebuild(v, leaves) if dataclasses.is_dataclass(v) else next(leaves)
    return dataclasses.replace(template, **kw)


def _flatten(prefix, state) -> dict:
    return {f"{prefix}{i}": leaf.detach().cpu().numpy() for i, leaf in enumerate(_leaves(state))}


def save(pipe: LegoLoamPipeline, path: str):
    """Write the pipeline's state to `path` (numpy appends `.npz` when the
    name lacks it)."""
    meta = {
        "frame_idx": pipe.frame_idx,
        "loop_factors": [
            {"i": f.i, "j": f.j, "R": f.R.tolist(), "t": f.t.tolist(), "fitness": f.fitness}
            for f in pipe.loop_factors
        ],
    }
    np.savez_compressed(path, __meta__=json.dumps(meta), **_flatten("f", pipe.fstate), **_flatten("b", pipe.bstate))


def load(pipe: LegoLoamPipeline, path: str) -> LegoLoamPipeline:
    """Restore state saved by `save` (by either package) into a freshly
    constructed pipeline of the same config, on the pipeline's device.
    Raises ValueError where a leaf's shape or dtype differs from the
    pipeline's own. The port keeps its frame numbers on the host, so there
    is no device frame counter to re-sync (the reference's `_idx_dev`)."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))

        def unflatten(prefix, template):
            new = []
            for i, leaf in enumerate(_leaves(template)):
                a = data[f"{prefix}{i}"]
                want = str(leaf.dtype).removeprefix("torch.")
                if a.shape != tuple(leaf.shape) or a.dtype != np.dtype(want):
                    raise ValueError(
                        f"{path}: {prefix}{i} is {a.dtype}{list(a.shape)}, the pipeline's is {want}{list(leaf.shape)}"
                    )
                new.append(torch.from_numpy(np.array(a)).to(pipe.device))
            return _rebuild(template, iter(new))

        pipe.fstate = unflatten("f", pipe.fstate)
        pipe.bstate = unflatten("b", pipe.bstate)
    # Resharding onto a sharded keyframe store (the reference's
    # shard_backend_state) waits for its port (ROADMAP §1 item 7).
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
