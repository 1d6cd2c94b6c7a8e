"""Weak scaling of the segment-reduction pose-graph solve (port of
`tools/weak_scaling.py`).

    python -m lego_loam_torch.weak_scaling                # the card: world size 1 over NCCL
    python -m lego_loam_torch.weak_scaling --device cpu   # gloo ranks 1, 2, 4 (and 8 with 8 cores)

Runs on the GPU unless --device cpu is given; without a visible GPU it
exits 2 with a message. Each world size is its own group of processes
started by `launch.spawn_local` (NCCL puts no two ranks on one GPU, so the
card runs world size 1 only; a gloo rank runs torch on one thread). Per
world size W the problem grows with the ranks: `chain_problem(2048 W,
16)`, a drifted chain of 2,048 poses a rank around three laps of a 20 m
circle with 16 loop factors, solved by
`distributed.schur_pose_graph_solver(mesh, cfg, N, stride=N // 128,
reduced="pcg")` over a 1-D mesh: the reduced system stays 128 anchors.

Per world size: the solve's ms (mean of 5 after one warm solve; the
device synchronized around them), factors/ms, and the bytes each kind of
torch.distributed collective moves in one solve, counted by wrapping the
collectives for one solve (each rank's contribution: the tensor it sends).
The reference reads its bytes from compiled HLO; the port's solver uses an
`all_gather` where the reference has a `ppermute` and a `broadcast` where
it has a `psum`, so the two records differ by design.

Writes --json-out (default WEAK_SCALING_torch.json): {"results": [...]}
with tools/weak_scaling.py's keys plus `device` (the card's name and power
limit; for gloo "cpu", the core count and the host's card) and `backend`
for each world size. Results of the other backend already in the file are kept, so
one file holds the CPU's gloo ranks and the card's NCCL rank.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

POSES_PER_RANK = 2048  # weak scaling: the keyframes are sharded over the ranks
# A fixed anchor budget: the reduced system stays 128 anchors whatever the
# world size (segments grow instead), so the solve's serial part stays flat.
ANCHOR_BUDGET = 128
N_LOOPS = 16
REPS = 5


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="NCCL on the GPU (default) or, when asked, gloo on the CPU")
    ap.add_argument("--ranks", type=int, nargs="*", default=None,
                    help="world sizes (default: 1 on the card; 1, 2, 4 and, with 8 cores, 8 on the CPU)")
    ap.add_argument("--json-out", default="WEAK_SCALING_torch.json")
    ap.add_argument("--rank-out", default=None, help=argparse.SUPPRESS)  # set in the spawned ranks
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device is visible; pass --device cpu to run on the CPU")
    if args.ranks is None:
        args.ranks = [1] if args.device == "cuda" else [w for w in (1, 2, 4, 8) if w < 8 or (os.cpu_count() or 1) >= 8]
    return args


def chain_problem(N: int, n_loops: int, seed: int = 0):
    """A noisy lap trajectory (tools/weak_scaling.py's draw): N poses around
    three laps of a 20 m circle, the true odometry steps, the estimate
    integrated from them with a 0.02 deg yaw bias a step, and max(n_loops, 1)
    true loop factors between same-phase revisits. Returns (R_est, t_est,
    relR, relt, loops) as numpy, loops a dict of Factors' fields."""
    rs = np.random.RandomState(seed)
    yaw = np.linspace(0, 6 * np.pi, N).astype(np.float32)

    def rz(a):
        c, s = np.cos(a), np.sin(a)
        out = np.zeros(a.shape + (3, 3), np.float32)
        out[..., 0, 0] = c
        out[..., 0, 1] = -s
        out[..., 1, 0] = s
        out[..., 1, 1] = c
        out[..., 2, 2] = 1.0
        return out

    R = rz(yaw)
    t = np.stack([np.sin(yaw) * 20, (1 - np.cos(yaw)) * 20, 0 * yaw], axis=1).astype(np.float32)
    relR = np.tile(np.eye(3, dtype=np.float32), (N, 1, 1))
    relt = np.zeros((N, 3), np.float32)
    relR[1:] = np.einsum("nab,nac->nbc", R[:-1], R[1:])
    relt[1:] = np.einsum("nab,na->nb", R[:-1], t[1:] - t[:-1])
    bias = rz(np.full((), np.deg2rad(0.02), np.float32))
    Re = np.zeros_like(R)
    te = np.zeros_like(t)
    Re[0], te[0] = R[0], t[0]
    for i in range(1, N):
        Re[i] = Re[i - 1] @ relR[i] @ bias
        te[i] = Re[i - 1] @ relt[i] + te[i - 1]
    L = max(n_loops, 1)
    li = rs.randint(0, N // 3, size=L).astype(np.int32)
    lj = (li + (N * 2) // 3).astype(np.int32) % N
    lR = np.einsum("nab,nac->nbc", R[li], R[lj])
    lt = np.einsum("nab,na->nb", R[li], t[lj] - t[li])
    loops = {"i": li, "j": lj, "R": lR, "t": lt, "info": np.full((L, 6), 1e4, np.float32), "mask": np.ones((L,), bool)}
    return Re, te, relR, relt, loops


@contextlib.contextmanager
def counting_collectives():
    """Counts, by kind, the bytes each torch.distributed collective call
    sends from this rank while the context is open: all_gather and
    all_reduce their input tensor, broadcast its tensor."""
    import torch.distributed as dist

    counts: dict = {}
    saved = {k: getattr(dist, k) for k in ("all_gather", "all_reduce", "broadcast")}

    def wrap(kind, fn, arg):
        def call(*a, **kw):
            x = a[arg] if len(a) > arg else kw["tensor"]
            counts[kind] = counts.get(kind, 0) + x.numel() * x.element_size()
            return fn(*a, **kw)
        return call

    dist.all_gather = wrap("all_gather", saved["all_gather"], 1)
    dist.all_reduce = wrap("all_reduce", saved["all_reduce"], 0)
    dist.broadcast = wrap("broadcast", saved["broadcast"], 0)
    try:
        yield counts
    finally:
        for k, fn in saved.items():
            setattr(dist, k, fn)


def measure(device, cfg=None, reps: int = REPS):
    """One world size, in a process group that is already joined: this
    rank's block of `chain_problem(2048 W, 16)` solved by the Schur solver
    (stride N // 128, reduced "pcg"). Returns (the record, the whole
    solution (R, t) gathered in rank order as numpy)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from .config import vlp16
    from .distributed import _all_gather, schur_pose_graph_solver
    from .posegraph import Factors

    cfg = cfg or vlp16()
    device = torch.device(device)
    W, r = dist.get_world_size(), dist.get_rank()
    mesh = init_device_mesh(device.type, (W,), mesh_dim_names=("seg",))
    N = POSES_PER_RANK * W
    solver = schur_pose_graph_solver(mesh, cfg, N, stride=N // ANCHOR_BUDGET, reduced="pcg")
    Re, te, relR, relt, loops = chain_problem(N, N_LOOPS)
    rows = slice(r * POSES_PER_RANK, (r + 1) * POSES_PER_RANK)
    args = [torch.from_numpy(np.ascontiguousarray(a[rows])).to(device) for a in (Re, te, relR, relt)]
    loop = Factors(**{k: torch.from_numpy(v).to(device) for k, v in loops.items()})

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.barrier()

    with counting_collectives() as coll:
        out = solver(*args, N, loop)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = solver(*args, N, loop)
    sync()
    ms = (time.perf_counter() - t0) / reps * 1e3
    F = N - 1 + N_LOOPS
    rec = {"devices": W, "factors": F, "poses": N, "solve_ms": ms, "factors_per_ms": F / ms,
           "collective_bytes_per_solve": coll, "backend": dist.get_backend()}
    R, t = (_all_gather(x.contiguous(), dist.group.WORLD, W).cpu().numpy() for x in out)
    return rec, (R, t)


def rank_main(args) -> int:
    """One rank of a spawned group: join, measure, and (rank 0) write the
    record and the solution under --rank-out."""
    import torch.distributed as dist

    from . import launch

    if args.device == "cpu":
        torch.set_num_threads(1)  # a gloo rank is one core: no oversubscription up to one rank a core
    dev = launch.init_from_args(device=args.device)
    rec, (R, t) = measure(dev)
    if dist.get_rank() == 0:
        np.savez(os.path.join(args.rank_out, "poses.npz"), R=R, t=t)
        with open(os.path.join(args.rank_out, "record.json"), "w") as f:
            json.dump(rec, f)
    dist.destroy_process_group()
    return 0


def run_world(W: int, device: str, out_dir: str, timeout: float = 600.0) -> dict:
    """World size W through `launch.spawn_local` (each rank `python -m
    lego_loam_torch.weak_scaling --rank-out out_dir`, the package's
    directory on PYTHONPATH); returns rank 0's record."""
    from . import launch

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    saved = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(paths)
    try:
        launch.spawn_local("-m", W, extra_args=("lego_loam_torch.weak_scaling", "--device", device,
                                                "--rank-out", out_dir), timeout=timeout)
    finally:
        if saved is None:
            os.environ.pop("PYTHONPATH")
        else:
            os.environ["PYTHONPATH"] = saved
    with open(os.path.join(out_dir, "record.json")) as f:
        return json.load(f)


def merge(path: str, results: list) -> dict:
    """The record at `path` with its results of the new results' backend
    replaced by them, ordered by backend then world size."""
    old = []
    if os.path.exists(path):
        with open(path) as f:
            old = json.load(f).get("results", [])
    backends = {r["backend"] for r in results}
    keep = [r for r in old if r.get("backend") not in backends]
    return {"results": sorted(keep + results, key=lambda r: (r["backend"], r["devices"]))}


def host_name(device: str) -> str:
    """The card's name and power limit (nvidia-smi), or for the CPU its
    core count and, where the host has a card, that card's line."""
    from .campus_run import device_name

    if device == "cuda":
        return device_name(torch.device("cuda"))
    beside = f", host of {device_name(torch.device('cuda'))}" if torch.cuda.is_available() else ""
    return f"cpu, {os.cpu_count()} cores{beside}"


def run_worlds(ranks, device: str, out_dir: str) -> list:
    """Each world size of `ranks` through `run_world`, its rank 0 writing
    under out_dir/W; the records, each with its `device`, printed as they
    come."""
    name = host_name(device)
    results = []
    for W in ranks:
        out = os.path.join(out_dir, str(W))
        os.makedirs(out)
        rec = run_world(W, device, out)
        rec["device"] = name
        results.append(rec)
        print(json.dumps(rec), flush=True)
    return results


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.rank_out:
        return rank_main(args)
    with tempfile.TemporaryDirectory(prefix="weak_scaling_") as d:
        results = run_worlds(args.ranks, args.device, d)
    if len(results) > 1:
        ratio = results[1]["factors_per_ms"] / results[0]["factors_per_ms"]
        print(f"weak-scaling throughput ratio {results[1]['devices']}/{results[0]['devices']} ranks = {ratio:.2f}",
              flush=True)
    record = merge(args.json_out, results)
    with open(args.json_out, "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
