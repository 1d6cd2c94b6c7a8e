"""Parity of the port's multi-device solves (`lego_loam_torch/distributed.py`)
with the reference's, and of its launcher (`lego_loam_torch/launch.py`).

The port runs in gloo ranks on the CPU, started once per world size by
`launch.spawn_local` (tests/_torch_ranks.py); the reference runs in this
process on the conftest's virtual CPU devices, as tests/test_distributed.py
runs it. The same numpy inputs go to both.

Tolerances: the factor-parallel solver within 1e-4 (the reference's own
bound against its single-device solve, tests/test_distributed.py:80-83), in
4 ranks and in 1, and the port's 4 ranks within 1e-4 of its single-process
`solve_pose_graph`; the segment-reduction solver within 1e-4 m in
translation and 1e-4 in rotation entries, dense and pcg, and with a second
loop factor whose endpoints lie on different ranks, the drift below 0.3x
the start; the mapping GN step within 1e-5, in 2 and 4 ranks, t_z below
-0.02 (tests/test_distributed.py:86)."""

import pickle
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lego_loam_tpu import distributed as RD
from lego_loam_tpu.config import vlp16 as ref_vlp16
from lego_loam_torch import launch
from lego_loam_torch.convert import config_from_reference

from test_distributed import _loop_problem
from test_posegraph_reduced import _cfg, _drifted_circle, _loop_buf

RANKS = str(Path(__file__).with_name("_torch_ranks.py"))
SCHUR_LOOPS = {"dense": [(1, 62)], "pcg": [(1, 62)], "cross": [(1, 62), (21, 45)]}
SCHUR_REDUCED = {"dense": "dense", "pcg": "pcg", "cross": "dense"}


def _map_problem():
    """tests/test_distributed.py:86's plane: 1,024 targets on z = 0, 1,024
    queries 5 cm above it."""
    rs = np.random.RandomState(3)
    T = 1024
    tgt = np.concatenate([rs.uniform(-10, 10, (T, 2)), np.zeros((T, 1))], axis=1).astype(np.float32)
    q = np.concatenate([rs.uniform(-8, 8, (1024, 2)), np.full((1024, 1), 0.05)], axis=1).astype(np.float32)
    return q, tgt


def _schur_problem():
    """tests/test_posegraph_reduced.py's drifted circle (64 keyframes) with
    the loop buffer of each case."""
    R_true, t_true, relR, relt, R_est, t_est = _drifted_circle(64)
    cfg = _cfg(64, 8)
    loops = {
        case: _loop_buf(cfg.mapping.max_loop_factors,
                        [(a, b, R_true[a].T @ R_true[b], R_true[a].T @ (t_true[b] - t_true[a])) for a, b in pairs])
        for case, pairs in SCHUR_LOOPS.items()
    }
    return cfg, (R_true, t_true, relR, relt, R_est, t_est), loops


def _spawn(in_dir, tmp, n, *cases):
    out = tmp / f"out{n}"
    out.mkdir()
    launch.spawn_local(RANKS, n, extra_args=(str(in_dir), str(out), *cases), timeout=300)
    return [dict(np.load(out / f"r{r}.npz")) for r in range(n)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Inputs written once; the port's ranks at world sizes 4 (every case),
    2 (the mapping step) and 1 (the factor-parallel solver)."""
    tmp = tmp_path_factory.mktemp("dist")
    (_, _), (R0, t0), factors = _loop_problem()
    q, tgt = _map_problem()
    scfg, (_, _, relR, relt, R_est, t_est), loops = _schur_problem()
    inputs = {"pg_R0": R0, "pg_t0": t0, "map_q": q, "map_tgt": tgt, "schur_R": R_est, "schur_t": t_est,
              "schur_relR": relR, "schur_relt": relt}
    inputs.update({f"pg_{k}": np.asarray(v) for k, v in factors._asdict().items()})
    for case, buf in loops.items():
        inputs.update({f"schur_{case}_{k}": np.asarray(v) for k, v in buf._asdict().items()})
    np.savez(tmp / "inputs.npz", **inputs)
    with open(tmp / "configs.pkl", "wb") as fh:
        pickle.dump({"vlp16": config_from_reference(ref_vlp16()), "schur": config_from_reference(scfg)}, fh)
    worlds = {4: ("pose_graph", "schur", "map_gn"), 2: ("map_gn",), 1: ("pose_graph",)}
    with ThreadPoolExecutor(len(worlds)) as pool:  # the three worlds side by side
        jobs = {n: pool.submit(_spawn, tmp, tmp, n, *cases) for n, cases in worlds.items()}
        return {n: job.result() for n, job in jobs.items()}


def _ref_pose_graph(n):
    (_, _), (R0, t0), factors = _loop_problem()
    mesh = RD.make_mesh(n)
    spec, rep = NamedSharding(mesh, P(("graph", "map"))), NamedSharding(mesh, P())
    R, t = RD.sharded_pose_graph_solver(mesh, ref_vlp16(), gn_iters=3)(
        jax.device_put(jnp.asarray(R0), rep), jax.device_put(jnp.asarray(t0), rep),
        jax.tree.map(lambda x: jax.device_put(x, spec), factors),
        jax.device_put(jnp.ones(R0.shape[0], bool), rep),
    )
    return np.asarray(R), np.asarray(t)


@pytest.mark.parametrize("n", [4, 1])
def test_factor_parallel_solver(runs, n):
    ref_R, ref_t = _ref_pose_graph(n)
    ranks = runs[n]
    for r in ranks[1:]:  # replicated output: every rank ends bit-equal
        np.testing.assert_array_equal(r["pg_R"], ranks[0]["pg_R"])
        np.testing.assert_array_equal(r["pg_t"], ranks[0]["pg_t"])
    np.testing.assert_allclose(ranks[0]["pg_t"], ref_t, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ranks[0]["pg_R"], ref_R, atol=1e-4, rtol=0)
    single = runs[4][0]  # the port's single-process solve, made by rank 0 of the 4-rank run
    np.testing.assert_allclose(ranks[0]["pg_t"], single["pg_single_t"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(ranks[0]["pg_R"], single["pg_single_R"], atol=1e-4, rtol=0)
    # the solve moved the perturbed poses toward the truth
    (_, t_true), (_, t0), _ = _loop_problem()
    assert np.abs(ranks[0]["pg_t"] - t_true).max() < 0.5 * np.abs(t0 - t_true).max()


@pytest.mark.parametrize("case", list(SCHUR_LOOPS))
def test_schur_solver(runs, case):
    cfg, (R_true, t_true, relR, relt, R_est, t_est), loops = _schur_problem()
    mesh = Mesh(np.array(jax.devices()[:4]), ("seg",))
    shard = NamedSharding(mesh, P("seg"))
    solve = RD.schur_pose_graph_solver(mesh, cfg, 64, stride=8, reduced=SCHUR_REDUCED[case])
    ref_R, ref_t = solve(*(jax.device_put(a, shard) for a in (R_est, t_est, relR, relt)), jnp.int32(64), loops[case])
    R = np.concatenate([r[f"schur_{case}_R"] for r in runs[4]])
    t = np.concatenate([r[f"schur_{case}_t"] for r in runs[4]])
    np.testing.assert_allclose(t, np.asarray(ref_t), atol=1e-4, rtol=0)
    np.testing.assert_allclose(R, np.asarray(ref_R), atol=1e-4, rtol=0)
    d0 = np.linalg.norm(t_est - t_true, axis=1).max()
    d1 = np.linalg.norm(t - t_true, axis=1).max()
    assert d1 < 0.3 * d0, (d0, d1)


@pytest.mark.parametrize("n", [2, 4])
def test_map_gn_step(runs, n):
    q, tgt = _map_problem()
    mesh = RD.make_mesh(n)
    spec = NamedSharding(mesh, P(("graph", "map")))
    ref_R, ref_t = RD.sharded_map_gn_step(mesh, ref_vlp16())(
        jnp.asarray(q), jnp.ones(len(q), bool), jax.device_put(jnp.asarray(tgt), spec),
        jax.device_put(jnp.ones(len(tgt), bool), spec), jnp.eye(3), jnp.zeros(3),
    )
    ranks = runs[n]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["map_t"], ranks[0]["map_t"])
    np.testing.assert_allclose(ranks[0]["map_t"], np.asarray(ref_t), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ranks[0]["map_R"], np.asarray(ref_R), atol=1e-5, rtol=0)
    assert ranks[0]["map_t"][2] < -0.02 and np.isfinite(ranks[0]["map_t"]).all()


_RANK_SCRIPT = """
import os, sys
from lego_loam_torch import launch
dev = launch.init_from_args(device="cpu")
import torch.distributed as dist
rank = dist.get_rank()
x = __import__("torch").ones(1) * (rank + 1)
dist.all_reduce(x)
print("rank", rank, "of", dist.get_world_size(), "sum", int(x), "local", os.environ["LOCAL_RANK"], dev)
dist.destroy_process_group()
sys.exit(int(sys.argv[1]) if rank == 1 else 0)
"""


def test_spawn_local(tmp_path):
    """spawn_local starts N ranks with the torch launch variables set; a rank
    that exits non-zero raises with its output; a rank drives one device."""
    script = tmp_path / "rank.py"
    script.write_text(f"import sys; sys.path.insert(0, {str(Path(__file__).parents[1])!r})\n" + _RANK_SCRIPT)
    outs = launch.spawn_local(str(script), 3, extra_args=("0",), timeout=120)
    for r, out in enumerate(outs):
        assert f"rank {r} of 3 sum 6 local {r} cpu" in out
    with pytest.raises(RuntimeError, match="rank 1 exited 3"):
        launch.spawn_local(str(script), 2, extra_args=("3",), timeout=120)
    with pytest.raises(ValueError, match="one device"):
        launch.spawn_local(str(script), 2, devices_per_process=4)


def test_refusals(monkeypatch):
    """No card: the CUDA route raises instead of falling back; a mesh over
    fewer ranks than the world is refused (torch meshes span the group)."""
    import torch
    import torch.distributed as dist

    from lego_loam_torch import distributed as D

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.init_distributed("127.0.0.1:1", 1, 0, device="cuda")
    assert not dist.is_initialized()
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    with pytest.raises(ValueError, match="whole world of 4"):
        D.make_mesh(2)
