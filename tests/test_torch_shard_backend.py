"""The sharded keyframe store (`shard_backend`) of the port against the
port's unsharded store and the reference's sharded one.

The reference runs once, in a subprocess with two virtual devices (a Mesh
in this process would disturb later programs, tests/test_sharded_pipeline.py
notes): its per-leaf layout (`backend_state_shardings`), the drive's four
swept scans through `process_scan` and through `run_chunked(chunk=2)` with
the store sharded, and tests/test_torch_sharded_pipeline.py's drifted
circle saved and solved with the sharded graph solve. The port runs in gloo
ranks (tests/_torch_ranks.py through `launch.spawn_local`) at 4, 2 and 3
ranks, and unsharded in this process; both draw the reference's RANSAC
scores.

Tolerances. Gathers are exact and the merged 5-NN keeps the lower global
row on equal distances, so the sharded port is held BIT-equal to every
other rank and to its unsharded run. Against the reference's sharded run,
the bounds tests/test_torch_pipeline.py holds the unsharded pair to: map
positions 1.5e-2 m, odometry and fused 8e-2 m, map ATE at most the
reference's + 5e-3 m (its 1e-4 m check of the first two scans does not
carry over: the reference's GSPMD sums in another order, so its own
sharded run moves ~2.7e-4 m from its unsharded one; the gap is printed).
The circle's solved poses within 1e-4 of the reference's (the bound of
tests/test_torch_sharded_pipeline.py). A run saved at 4 ranks and resumed
at 2 and at 1 within 5e-3 m of the uninterrupted run
(tests/test_elastic_reshard.py's bound; bit-equal expected). The CLI over
two processes writes the single process's pose.txt, from rank 0 only."""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lego_loam_tpu import checkpoint as ref_checkpoint
from lego_loam_tpu.pipeline import LegoLoamPipeline as RefPipeline
from lego_loam_torch import checkpoint, launch
from lego_loam_torch.backend import init_backend_state
from lego_loam_torch.convert import config_from_reference
from lego_loam_torch.io.synthetic import render_scan, straight_trajectory, swept_scan_sequence
from lego_loam_torch.pipeline import LegoLoamPipeline

from _torch_parity import loop_ref_cfg, loop_store, ref_scores, small_ref_cfg

TESTS = Path(__file__).resolve().parent
N_DRIVE = 4
ATTEMPT = (1, 39, 40)  # tests/_torch_ranks.py's revisit pair of the rendered circle


def _store(cfg, posegraph=False):
    return dataclasses.replace(cfg, distributed=dataclasses.replace(
        cfg.distributed, shard_backend=True, use_sharded_posegraph=posegraph))


def ref_cfg():
    return _store(small_ref_cfg(64))


def _drive_poses():
    return straight_trajectory(N_DRIVE, speed=0.15)


def _reference_side(in_dir, out_dir):
    """In a process with two virtual devices: the layout, the drive (per
    scan and by chunks of 2) and the circle's solve of the reference with
    a sharded store; writes ref_layout.json, ref_drive.npz, ref_ckpt.npz
    and ref_loop.npz."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from lego_loam_tpu import checkpoint as rc
    from lego_loam_tpu.distributed import backend_state_shardings
    from lego_loam_tpu.pipeline import LegoLoamPipeline as Ref, LoopFactor
    from test_torch_sharded_pipeline import LOOPS
    from test_posegraph_reduced import _drifted_circle

    assert len(jax.devices()) == 2
    cfg = ref_cfg()
    with np.load(os.path.join(in_dir, "inputs.npz")) as data:
        scans = list(data["store_drive"])
    out = {}
    for name in ("scan", "chunk"):
        pipe = Ref(cfg)
        assert pipe._mesh is not None
        if name == "scan":
            specs = backend_state_shardings(pipe._mesh, pipe.bstate)
            layout = {".".join(str(getattr(p, "name", p)) for p in path): s.spec == P(("graph", "map"))
                      for path, s in jax.tree_util.tree_flatten_with_path(specs)[0]}
            with open(os.path.join(out_dir, "ref_layout.json"), "w") as fh:
                json.dump(layout, fh)
            for s in scans:
                pipe.process_scan(s)
            pipe.finalize()
        else:
            pipe.run_chunked(scans, chunk=2)
        out[f"{name}_map"] = np.stack(pipe.trajectory["positions"])
        out[f"{name}_odom"] = np.asarray(pipe.odom_positions)
        out[f"{name}_fused"] = np.asarray(pipe.fused_positions)
    np.savez(os.path.join(out_dir, "ref_drive.npz"), **out)

    # the drifted circle of tests/test_torch_sharded_pipeline.py, its store sharded
    lcfg = _store(small_ref_cfg(64), posegraph=True)
    R_true, t_true, relR, relt, R_est, t_est = _drifted_circle(64)
    pipe = Ref(lcfg)
    pipe.bstate = pipe.bstate.replace(
        kf_R=jnp.asarray(R_est), kf_t=jnp.asarray(t_est), kf_rel_R=jnp.asarray(relR), kf_rel_t=jnp.asarray(relt),
        kf_time=jnp.asarray(np.arange(64, dtype=np.float32) * 0.1), n_kf=jnp.int32(64),
        R_map=jnp.asarray(R_est[-1]), t_map=jnp.asarray(t_est[-1]),
    )
    pipe.frame_idx = 64
    pipe.loop_factors = [
        LoopFactor(i=a, j=b, R=R_true[a].T @ R_true[b], t=R_true[a].T @ (t_true[b] - t_true[a]), fitness=f)
        for a, b, f in LOOPS
    ]
    path = os.path.join(out_dir, "ref_ckpt.npz")
    rc.save(pipe, path)
    fresh = rc.load(Ref(lcfg), path)
    fresh.bstate = jax.tree.map(jnp.asarray, fresh.bstate)  # as tests/test_torch_sharded_pipeline.py does
    fresh._optimize_graph()
    np.savez(os.path.join(out_dir, "ref_loop.npz"), kf_R=np.asarray(fresh.bstate.kf_R),
             kf_t=np.asarray(fresh.bstate.kf_t), t_est=t_est, t_true=t_true)


def _spawn(tmp, n, *cases):
    out = tmp / f"out{n}"
    out.mkdir()
    launch.spawn_local(str(TESTS / "_torch_ranks.py"), n, extra_args=(str(tmp), str(out), *cases), timeout=600)
    return [dict(np.load(out / f"r{r}.npz")) for r in range(n)]


def _reference(tmp):
    code = (
        "import os; os.environ['JAX_PLATFORMS'] = 'cpu'; "
        "os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=2'; "
        "import jax; jax.config.update('jax_platforms', 'cpu'); "
        "jax.config.update('jax_compilation_cache_dir', '/tmp/jaxcache'); "
        "jax.config.update('jax_persistent_cache_min_entry_size_bytes', -1); "
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 2.0); "
        f"import sys; sys.path[:0] = [{str(TESTS)!r}, {str(TESTS.parent)!r}]; "
        f"from test_torch_shard_backend import _reference_side; _reference_side({str(tmp)!r}, {str(tmp)!r})"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]


def _unsharded(cfg, scores, scans, attempt_store):
    """The port's single unsharded process: the drive per scan and by
    chunks, and the attempt on the rendered circle."""
    out = {}
    for name in ("scan", "chunk"):
        pipe = LegoLoamPipeline(cfg, device="cpu", ground_scores=lambda i: torch.from_numpy(scores[i]))
        res = pipe.run(scans) if name == "scan" else pipe.run_chunked(scans, chunk=2)
        out.update({f"drive_{name}_{k}": v for k, v in res.items()})
        out[f"drive_{name}_kf_t"] = pipe.keyframe_trajectory()[1]
    acfg = config_from_reference(_store(loop_ref_cfg(64)))
    pipe = LegoLoamPipeline(acfg, device="cpu")
    pipe.bstate = init_backend_state(acfg, "cpu").replace(**{k: torch.from_numpy(np.array(v))
                                                             for k, v in attempt_store.items()})
    out["attempt_probe"] = pipe._loopinfo_probe().numpy()
    out["attempt_flags"], out["attempt_R"], out["attempt_t"] = (x.numpy() for x in pipe._attempt(*ATTEMPT))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Inputs written once; the reference and the port's 4 ranks side by
    side, then the port's 2 and 3 ranks (the 2 resume the 4-rank file)
    beside its unsharded process."""
    tmp = tmp_path_factory.mktemp("shard_backend")
    rcfg = ref_cfg()
    cfg = config_from_reference(rcfg)
    scans = list(swept_scan_sequence(_drive_poses(), cfg, noise=0.005))
    scores = np.stack([ref_scores(cfg, i).numpy() for i in range(N_DRIVE + 6)])
    resume = [render_scan(R, t, cfg, noise=0.005, seed=800 + i)
              for i, (R, t) in enumerate(straight_trajectory(10, speed=0.25))]
    store, _ = loop_store(config_from_reference(loop_ref_cfg(64)), n_kf=40)
    np.savez(tmp / "inputs.npz", store_drive=np.stack(scans), store_scores=scores, store_resume=np.stack(resume),
             **{f"attempt_{k}": v for k, v in store.items()})
    with open(tmp / "configs.pkl", "wb") as fh:
        pickle.dump({"store": cfg, "store_loop": config_from_reference(_store(small_ref_cfg(64), posegraph=True)),
                     "store_attempt": config_from_reference(_store(loop_ref_cfg(64)))}, fh)
    with ThreadPoolExecutor(3) as pool:
        ref = pool.submit(_reference, tmp)
        four = pool.submit(_spawn, tmp, 4, "store_layout", "store_drive", "store_save")
        ranks = {4: four.result()}
        ref.result()  # the 2 ranks load the reference's circle
        two = pool.submit(_spawn, tmp, 2, "store_layout", "store_drive", "store_loop", "store_resume")
        three = pool.submit(_spawn, tmp, 3, "store_layout", "store_drive")
        single = _unsharded(cfg, scores, scans, store)
        ranks[2], ranks[3] = two.result(), three.result()
    with open(tmp / "ref_layout.json") as fh:
        layout = json.load(fh)
    return {"tmp": tmp, "ranks": ranks, "single": single, "layout": layout,
            "ref": dict(np.load(tmp / "ref_drive.npz")), "ref_loop": dict(np.load(tmp / "ref_loop.npz")),
            "truth": np.stack([t for _, t in _drive_poses()])}


def test_layout_matches_reference(runs):
    """Leaf by leaf, the port's row-blocked or replicated over 2 ranks is
    the reference's over 2 devices; at 4 ranks the same leaves, each rank
    holding 16 of the 64 keyframe rows; at 3 ranks nothing divides, so
    every leaf is replicated."""
    ranks = runs["ranks"]
    for n, held in ((2, 32), (4, 16)):
        for r in ranks[n]:
            got = dict(zip(r["layout_names"].tolist(), r["layout_rows"].tolist()))
            assert got == runs["layout"], (n, got)
            assert int(r["layout_held"][0]) == held
    assert sum(runs["layout"].values()) == 13  # the 9 kf_* leaves and the submap's 4
    for r in ranks[3]:
        assert not r["layout_rows"].any() and int(r["layout_held"][0]) == -1


@pytest.mark.parametrize("n", [2, 3, 4])
def test_sharded_drive_bit_equal(runs, n):
    """Per scan and by chunks: every rank, and the unsharded process, give
    the same bits for the map, odometry and fused poses and the keyframes."""
    single = runs["single"]
    keys = [k for k in single if k.startswith("drive_")]
    assert len(keys) == 8
    for r in runs["ranks"][n]:
        for k in keys:
            np.testing.assert_array_equal(r[k], single[k], err_msg=f"{n} ranks: {k}")


@pytest.mark.parametrize("path", ["scan", "chunk"])
def test_sharded_drive_matches_reference(runs, path):
    """The sharded port (2 ranks) against the reference's sharded run."""
    ref, ours, truth = runs["ref"], runs["ranks"][2][0], runs["truth"]
    m = ours[f"drive_{path}_map_positions"]
    assert m.shape == ref[f"{path}_map"].shape == (N_DRIVE, 3)
    print(f"{path}: map position gap at the first two scans "
          f"{np.abs(m[:2] - ref[f'{path}_map'][:2]).max():.3e} m")
    np.testing.assert_allclose(m, ref[f"{path}_map"], atol=1.5e-2, rtol=0)
    np.testing.assert_allclose(ours[f"drive_{path}_odom_positions"], ref[f"{path}_odom"], atol=8e-2, rtol=0)
    np.testing.assert_allclose(ours[f"drive_{path}_fused_positions"], ref[f"{path}_fused"], atol=8e-2, rtol=0)
    ate = lambda p: float(np.sqrt(np.mean(np.sum((p - truth) ** 2, axis=1))))  # noqa: E731
    assert ate(m) <= ate(ref[f"{path}_map"]) + 5e-3


def test_sharded_store_loop_closure(runs):
    """The circle's graph solve on a store in row blocks (2 ranks, the
    sharded solve) within 1e-4 of the reference's, ranks bit-equal, the
    drift taken out; an attempt at the revisit pair on the sharded store
    bit-equal to the unsharded one's, and accepted."""
    ranks, ref = runs["ranks"][2], runs["ref_loop"]
    for r in ranks:
        assert int(r["loop_sharded"]) == 32
        for k in ("loop_kf_R", "loop_kf_t"):
            np.testing.assert_array_equal(r[k], ranks[0][k])
    np.testing.assert_allclose(ranks[0]["loop_kf_t"], ref["kf_t"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(ranks[0]["loop_kf_R"], ref["kf_R"], atol=1e-4, rtol=0)
    before = np.linalg.norm(ref["t_est"] - ref["t_true"], axis=1).max()
    after = np.linalg.norm(ranks[0]["loop_kf_t"] - ref["t_true"], axis=1).max()
    assert after < 0.5 * before, (before, after)
    single = runs["single"]
    for r in ranks:
        for k in ("attempt_probe", "attempt_flags", "attempt_R", "attempt_t"):
            np.testing.assert_array_equal(r[k], single[k], err_msg=k)
    assert single["attempt_flags"][0] == 1.0, single["attempt_flags"]


def test_reshard_on_resume(runs):
    """Saved at frame 6 of 10 over 4 ranks; resumed at 2 ranks (16 -> 32
    rows a rank) and in one unsharded process: the final map pose within
    5e-3 m of the uninterrupted 4-rank run (bit-equal expected). The file
    loads in the reference's `checkpoint.load` with its own leaves' shapes
    and dtypes."""
    whole = runs["ranks"][4][0]["resume_t_map"]
    for r in runs["ranks"][4]:
        np.testing.assert_array_equal(r["resume_t_map"], whole)
    path = str(runs["tmp"] / "store_ckpt.npz")
    for r in runs["ranks"][2]:
        assert int(r["resume_frame"]) == 6 and int(r["resume_held"]) == 32
        np.testing.assert_allclose(r["resume_t_map"], whole, atol=5e-3, rtol=0)
        np.testing.assert_array_equal(r["resume_t_map"], whole)
    cfg = config_from_reference(ref_cfg())
    with np.load(runs["tmp"] / "inputs.npz") as data:
        scores, scans = data["store_scores"], list(data["store_resume"])
    pipe = checkpoint.load(LegoLoamPipeline(cfg, device="cpu", ground_scores=lambda i: torch.from_numpy(scores[i])),
                           path)
    for s in scans[6:]:
        pipe.process_scan(s)
    got = pipe.bstate.t_map.numpy()
    np.testing.assert_allclose(got, whole, atol=5e-3, rtol=0)
    np.testing.assert_array_equal(got, whole)

    ref = RefPipeline(small_ref_cfg(64))
    want = [(a.shape, a.dtype) for a in jax.tree.leaves(jax.device_get((ref.fstate, ref.bstate)))]
    ref = ref_checkpoint.load(ref, path)
    assert ref.frame_idx == 6
    assert [(np.shape(a), np.asarray(a).dtype) for a in jax.tree.leaves((ref.fstate, ref.bstate))] == want


def test_cli_two_processes(tmp_path):
    """`python -m lego_loam_torch.run --device cpu --synthetic 4` as two
    gloo ranks (--coordinator/--num-processes/--process-id): both exit 0,
    rank 0 writes the artifacts and rank 1 nothing, and pose.txt equals the
    single process's, as text."""
    port = launch._free_port()
    base = [sys.executable, "-m", "lego_loam_torch.run", "--device", "cpu", "--synthetic", "4"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(base + ["--out", str(tmp_path / f"rank{r}"), "--coordinator", f"127.0.0.1:{port}",
                                      "--num-processes", "2", "--process-id", str(r)],
                              cwd=TESTS.parent, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    procs.append(subprocess.Popen(base + ["--out", str(tmp_path / "single")], cwd=TESTS.parent, env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    assert not (tmp_path / "rank1").exists()
    assert (tmp_path / "rank0" / "pose.txt").read_text() == (tmp_path / "single" / "pose.txt").read_text()
    assert sorted(os.listdir(tmp_path / "rank0")) == sorted(os.listdir(tmp_path / "single"))
