"""The pipeline's sharded pose-graph branch (`use_sharded_posegraph` over
more than one rank) against the reference's, from one reference checkpoint.

No scan is processed to build the state: a 64-keyframe drifted circle
(tests/test_posegraph_reduced.py) with two loop factors is written into the
reference's pipeline and saved with the reference's `checkpoint.save`. The
reference loads it and runs `_optimize_graph()` in a subprocess with two
virtual devices (a Mesh in this process would disturb later programs, as
tests/test_sharded_pipeline.py notes); the port loads the same file in two
gloo ranks (tests/_torch_ranks.py) and does the same, then processes one
scan, and a pipeline with `shard_backend` on lays its store out in row
blocks. Tolerances: the ranks bit-equal; the keyframe poses within 1e-4 of
the reference's (its own bound between mesh and single-device solves)."""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from lego_loam_torch import launch
from lego_loam_torch.convert import config_from_reference
from lego_loam_torch.io.synthetic import render_scan

from _torch_parity import small_ref_cfg

TESTS = Path(__file__).resolve().parent
LOOPS = ((1, 62, 0.05), (5, 40, 0.08))  # (i, j, ICP fitness)


def ref_cfg():
    cfg = small_ref_cfg(64)
    return dataclasses.replace(
        cfg, distributed=dataclasses.replace(cfg.distributed, use_sharded_posegraph=True, shard_backend=False)
    )


def _reference_side(out_dir):
    """In a process with two virtual devices: the reference state written
    and saved, then loaded into a fresh pipeline and solved; writes
    ref_ckpt.npz and ref_out.npz to out_dir."""
    import jax
    import jax.numpy as jnp

    from lego_loam_tpu import checkpoint
    from lego_loam_tpu.pipeline import LegoLoamPipeline, LoopFactor
    from test_posegraph_reduced import _drifted_circle

    assert len(jax.devices()) == 2
    cfg = ref_cfg()
    R_true, t_true, relR, relt, R_est, t_est = _drifted_circle(64)
    pipe = LegoLoamPipeline(cfg)
    assert pipe._mesh is not None
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
    checkpoint.save(pipe, path)
    fresh = checkpoint.load(LegoLoamPipeline(cfg), path)
    # The reference's load leaves numpy leaves, whose missing `.sharding`
    # its sharded branch reads; its chunk runner would have made them
    # device arrays first.
    fresh.bstate = jax.tree.map(jnp.asarray, fresh.bstate)
    fresh._optimize_graph()
    np.savez(os.path.join(out_dir, "ref_out.npz"), kf_R=np.asarray(fresh.bstate.kf_R),
             kf_t=np.asarray(fresh.bstate.kf_t), t_est=t_est, t_true=t_true)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_pipeline")
    code = (
        "import os; os.environ['JAX_PLATFORMS'] = 'cpu'; "
        "os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=2'; "
        "import jax; jax.config.update('jax_platforms', 'cpu'); "
        f"import sys; sys.path[:0] = [{str(TESTS)!r}, {str(TESTS.parent)!r}]; "
        f"from test_torch_sharded_pipeline import _reference_side; _reference_side({str(tmp)!r})"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]

    cfg = config_from_reference(ref_cfg())
    with open(tmp / "configs.pkl", "wb") as fh:
        pickle.dump({"pipeline": cfg}, fh)
    ref = dict(np.load(tmp / "ref_out.npz"))
    # one scan from the true pose of the last keyframe
    from test_posegraph_reduced import _drifted_circle

    R_true, t_true = _drifted_circle(64)[:2]
    np.savez(tmp / "inputs.npz", pipe_scan=render_scan(R_true[-1], t_true[-1], cfg, noise=0.005, seed=7))
    out = tmp / "out"
    out.mkdir()
    launch.spawn_local(str(TESTS / "_torch_ranks.py"), 2, extra_args=(str(tmp), str(out), "pipeline"), timeout=300)
    return ref, [dict(np.load(out / f"r{r}.npz")) for r in range(2)]


def test_sharded_optimize_graph_matches_reference(sides):
    ref, ranks = sides
    for k in ("pipe_kf_R", "pipe_kf_t"):
        np.testing.assert_array_equal(ranks[1][k], ranks[0][k])
    np.testing.assert_allclose(ranks[0]["pipe_kf_t"], ref["kf_t"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(ranks[0]["pipe_kf_R"], ref["kf_R"], atol=1e-4, rtol=0)
    # the cost gate applied the solve, and it brought the chain toward the truth
    before = np.linalg.norm(ref["t_est"] - ref["t_true"], axis=1).max()
    after = np.linalg.norm(ranks[0]["pipe_kf_t"] - ref["t_true"], axis=1).max()
    assert after < 0.5 * before, (before, after)


def test_sharded_pipeline_runs_on(sides):
    """One more scan after the sharded solve: finite, the ranks bit-equal."""
    _, ranks = sides
    keys = [k for k in ranks[0] if k.startswith("pipe_scan_")]
    assert {"pipe_scan_t_map", "pipe_scan_R_map", "pipe_scan_t_odom"} <= set(keys)
    for k in keys:
        assert np.isfinite(ranks[0][k]).all(), k
        np.testing.assert_array_equal(ranks[1][k], ranks[0][k])


def test_shard_backend_refused(sides):
    """Two ranks with shard_backend on, which the port refused until its
    sharded keyframe store: now the store lies in row blocks, each rank
    holding 32 of its 64 rows."""
    _, ranks = sides
    for r in ranks:
        assert r["pipe_store_rows"].tolist() == [32, 64]
