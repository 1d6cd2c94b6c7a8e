"""Rank programs of the port's multi-rank tests on the CPU (gloo), started by
`lego_loam_torch.launch.spawn_local`:

    python tests/_torch_ranks.py IN_DIR OUT_DIR CASE [CASE ...]

Each rank joins the group from the variables spawn_local sets, reads its
inputs from IN_DIR/inputs.npz and the port's configs from
IN_DIR/configs.pkl (both written by the test), runs the cases in order and
writes its results to OUT_DIR/r<rank>.npz. Cases: `pose_graph` (the
factor-parallel solver; rank 0 adds the port's single-process solve),
`schur` (the segment-reduction solver on a 1-D mesh: dense, pcg and a
second loop factor across ranks), `map_gn` (one sharded mapping GN step),
`pipeline` (the pipeline's sharded branch from a reference checkpoint,
then one scan, and a store laid out in row blocks); the sharded keyframe
store's cases `store_layout` (each leaf's kind), `store_drive` (process_scan
and run_chunked over the drive), `store_loop` (the graph solve and a loop
attempt on a sharded store), `store_save` and `store_resume` (a run saved
mid-way in one world and resumed in another).

A rank is a fresh interpreter, so this module imports torch, numpy and the
port only; the parity helpers (`_torch_parity.py`) import jax.
"""

import dataclasses
import os
import pickle
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from lego_loam_torch import launch  # noqa: E402
from lego_loam_torch.distributed import (  # noqa: E402
    make_mesh,
    schur_pose_graph_solver,
    shard_rows,
    sharded_map_gn_step,
    sharded_pose_graph_solver,
)
from lego_loam_torch.posegraph import Factors, solve_pose_graph  # noqa: E402

SCHUR_CASES = {"dense": "dense", "pcg": "pcg", "cross": "dense"}  # case -> reduced solver


def _t(a):
    return torch.from_numpy(np.array(a))


def _factors(data, prefix):
    return Factors(*(_t(data[prefix + k]) for k in Factors._fields))


def pose_graph(data, cfgs, out, in_dir):
    mesh = make_mesh()
    f = _factors(data, "pg_")
    R0, t0 = _t(data["pg_R0"]), _t(data["pg_t0"])
    active = torch.ones(R0.shape[0], dtype=torch.bool)
    solve = sharded_pose_graph_solver(mesh, cfgs["vlp16"], gn_iters=3)
    out["pg_R"], out["pg_t"] = solve(R0, t0, shard_rows(f, mesh), active)
    if dist.get_rank() == 0:
        out["pg_single_R"], out["pg_single_t"] = solve_pose_graph(R0, t0, f, active, cfgs["vlp16"], gn_iters=3)


def schur(data, cfgs, out, in_dir):
    from torch.distributed.device_mesh import init_device_mesh

    n, r = dist.get_world_size(), dist.get_rank()
    mesh = init_device_mesh("cpu", (n,), mesh_dim_names=("seg",))
    N = data["schur_R"].shape[0]
    rows = slice(r * N // n, (r + 1) * N // n)
    args = [_t(data[k][rows]) for k in ("schur_R", "schur_t", "schur_relR", "schur_relt")]
    for case, reduced in SCHUR_CASES.items():
        solve = schur_pose_graph_solver(mesh, cfgs["schur"], N, stride=8, reduced=reduced)
        out[f"schur_{case}_R"], out[f"schur_{case}_t"] = solve(*args, N, _factors(data, f"schur_{case}_"))


def map_gn(data, cfgs, out, in_dir):
    mesh = make_mesh()
    q = _t(data["map_q"])
    step = sharded_map_gn_step(mesh, cfgs["vlp16"])
    out["map_R"], out["map_t"] = step(
        q, torch.ones(q.shape[0], dtype=torch.bool), shard_rows(_t(data["map_tgt"]), mesh),
        shard_rows(torch.ones(data["map_tgt"].shape[0], dtype=torch.bool), mesh), torch.eye(3), torch.zeros(3),
    )


def pipeline(data, cfgs, out, in_dir):
    from lego_loam_torch import checkpoint
    from lego_loam_torch.pipeline import LegoLoamPipeline

    cfg = cfgs["pipeline"]
    pipe = LegoLoamPipeline(cfg, device="cpu")
    if pipe._mesh is None:
        raise AssertionError("no mesh over the world")
    checkpoint.load(pipe, os.path.join(in_dir, "ref_ckpt.npz"))
    pipe._optimize_graph()
    out["pipe_kf_R"], out["pipe_kf_t"] = pipe.bstate.kf_R, pipe.bstate.kf_t
    scan = pipe.process_scan(data["pipe_scan"])
    for k, v in scan.items():
        out[f"pipe_scan_{k}"] = v
    sharded_store = dataclasses.replace(cfg, distributed=dataclasses.replace(cfg.distributed, shard_backend=True))
    kf_t = LegoLoamPipeline(sharded_store, device="cpu").bstate.kf_t
    out["pipe_store_rows"] = np.array([kf_t.local.shape[0], kf_t.shape[0]])


def _store_pipeline(data, cfgs):
    from lego_loam_torch.pipeline import LegoLoamPipeline

    scores = data["store_scores"]
    return LegoLoamPipeline(cfgs["store"], device="cpu", ground_scores=lambda i: torch.from_numpy(scores[i]))


def store_layout(data, cfgs, out, in_dir):
    """The store's layout over this world: each leaf's kind, and the rows a
    row-blocked leaf holds here."""
    from lego_loam_torch.distributed import RowBlock, backend_state_shardings

    pipe = _store_pipeline(data, cfgs)
    kinds = backend_state_shardings(make_mesh(), pipe.bstate)
    out["layout_names"] = np.array(list(kinds))
    out["layout_rows"] = np.array([v == "rows" for v in kinds.values()])
    out["layout_held"] = np.array([pipe.bstate.kf_t.local.shape[0] if isinstance(pipe.bstate.kf_t, RowBlock) else -1])


def store_drive(data, cfgs, out, in_dir):
    """The drive's scans through process_scan, then through run_chunked
    (chunk=2) in a second pipeline; the poses, and the corrected keyframes."""
    scans = list(data["store_drive"])
    for name in ("scan", "chunk"):
        pipe = _store_pipeline(data, cfgs)
        res = pipe.run(scans) if name == "scan" else pipe.run_chunked(scans, chunk=2)
        for k, v in res.items():
            out[f"drive_{name}_{k}"] = v
        out[f"drive_{name}_kf_t"] = pipe.keyframe_trajectory()[1]


def store_loop(data, cfgs, out, in_dir):
    """The drifted circle's reference checkpoint loaded into a pipeline with
    a sharded store and the sharded graph solve, solved; then one attempt
    at the rendered circle's revisit pair on that store laid out over the
    world."""
    from lego_loam_torch import checkpoint
    from lego_loam_torch.backend import init_backend_state
    from lego_loam_torch.distributed import shard_backend_state
    from lego_loam_torch.pipeline import LegoLoamPipeline

    pipe = checkpoint.load(LegoLoamPipeline(cfgs["store_loop"], device="cpu"), os.path.join(in_dir, "ref_ckpt.npz"))
    pipe._optimize_graph()
    out["loop_kf_R"], out["loop_kf_t"] = pipe.keyframe_trajectory()[:2]
    out["loop_sharded"] = np.array(pipe.bstate.kf_t.local.shape[0])
    pipe = LegoLoamPipeline(cfgs["store_attempt"], device="cpu")
    st = init_backend_state(cfgs["store_attempt"], "cpu")
    st = st.replace(**{k[len("attempt_"):]: _t(data[k]) for k in data.files if k.startswith("attempt_")})
    pipe.bstate = shard_backend_state(make_mesh(), st)
    out["attempt_probe"] = pipe._loopinfo_probe()
    out["attempt_flags"], out["attempt_R"], out["attempt_t"] = pipe._attempt(*ATTEMPT)


def store_save(data, cfgs, out, in_dir):
    """The resume course: 6 scans, the state saved, 4 more."""
    from lego_loam_torch import checkpoint

    scans = list(data["store_resume"])
    pipe = _store_pipeline(data, cfgs)
    for s in scans[:6]:
        pipe.process_scan(s)
    checkpoint.save(pipe, os.path.join(in_dir, "store_ckpt.npz"))
    for s in scans[6:]:
        pipe.process_scan(s)
    out["resume_t_map"] = pipe.bstate.t_map


def store_resume(data, cfgs, out, in_dir):
    """The saved state (from another world) resumed for the last 4 scans."""
    from lego_loam_torch import checkpoint

    pipe = checkpoint.load(_store_pipeline(data, cfgs), os.path.join(in_dir, "store_ckpt.npz"))
    out["resume_frame"] = np.array(pipe.frame_idx)
    out["resume_held"] = np.array(pipe.bstate.kf_t.local.shape[0])
    for s in list(data["store_resume"])[6:]:
        pipe.process_scan(s)
    out["resume_t_map"] = pipe.bstate.t_map


ATTEMPT = (1, 39, 40)  # (candidate slot, current slot, n_kf) of the rendered circle's revisit
CASES = {"pose_graph": pose_graph, "schur": schur, "map_gn": map_gn, "pipeline": pipeline,
         "store_layout": store_layout, "store_drive": store_drive, "store_loop": store_loop,
         "store_save": store_save, "store_resume": store_resume}


def main():
    in_dir, out_dir, *cases = sys.argv[1:]
    torch.set_num_threads(1)
    launch.init_from_args(device="cpu")
    try:
        with open(os.path.join(in_dir, "configs.pkl"), "rb") as fh:
            cfgs = pickle.load(fh)  # written by the test that started this rank
        out = {}
        with np.load(os.path.join(in_dir, "inputs.npz")) as data:
            for case in cases:
                CASES[case](data, cfgs, out, in_dir)
        out = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in out.items()}
        np.savez(os.path.join(out_dir, f"r{dist.get_rank()}.npz"), **out)
        # rank 0 hosts the group's store: a rank still creating a group
        # (a mesh needs no collective) must not find it gone
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
